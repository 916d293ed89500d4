"""The fusion forward's share of its roofline: the least time for each
batch's fusion call at its images' real node counts (``counts``: the
products of the cross-attention detector, its weights read once a call)
over the device time of the kernels launched from the program's
``cmt::fusion`` ranges."""

import counts


def read(w):
    tr, cfg = w["trace"], w["config"]
    device_s = tr.device_s(tr.launched_in("cmt::fusion"))
    batches = w.get("batches", [])
    if not batches or device_s <= 0:
        return None
    least = sum(counts.bound_s(sum(counts.fusion_forward_flops(n, cfg) for n in nodes),
                               counts.fusion_forward_bytes(nodes, cfg)) for nodes in batches)
    return 100.0 * least / device_s
