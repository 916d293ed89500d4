"""The model step's share of the chip's float32 peak: the RG GNN and
fusion forward operations of every image completed, at its real node
count, over the traced window, over 67 TFLOP/s."""

import counts


def read(w):
    tr, cfg = w["trace"], w["config"]
    nodes = [n for batch in w.get("batches", []) for n in batch]
    if not nodes or tr.window_s <= 0:
        return None
    flops = sum(counts.gnn_forward_flops(n, cfg) + counts.fusion_forward_flops(n, cfg)
                for n in nodes)
    return 100.0 * flops / tr.window_s / counts.PEAK_F32_FLOPS
