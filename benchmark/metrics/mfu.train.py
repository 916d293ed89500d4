"""The training step's share of the chip's float32 peak: forward and
backward of every record trained in the window at its real node count,
and AdamW (``counts.train_step_flops``), over the window, over 67 TFLOP/s."""

import counts


def read(w):
    tr, cfg, batches = w["trace"], w["config"], w.get("batches", [])
    if not batches or tr.window_s <= 0:
        return None
    flops = sum(counts.train_step_flops(nodes, cfg) for nodes in batches)
    return 100.0 * flops / tr.window_s / counts.PEAK_F32_FLOPS
