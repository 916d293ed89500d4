"""Connectivity's host synchronisations a batch: the program's
``cmt::sync.components`` (one a components test, every 2 sweeps) and
``cmt::sync.merge`` spans (one a merge round) over the batches completed."""

NAMES = ("cmt::sync.components", "cmt::sync.merge")


def read(w):
    batches, tr = len(w.get("batches") or ()), w["trace"]
    syncs = sum(tr.count(n) for n in NAMES)
    if not batches or not syncs:
        return None
    return syncs / batches
