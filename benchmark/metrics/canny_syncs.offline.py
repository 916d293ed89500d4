"""Canny's host synchronisations a batch: the program's
``cmt::sync.canny`` spans (one a hysteresis convergence test, every 8
dilations) over the batches completed."""


def read(w):
    batches, tr = len(w.get("batches") or ()), w["trace"]
    if not batches or not tr.count("cmt::sync.canny"):
        return None
    return tr.count("cmt::sync.canny") / batches
