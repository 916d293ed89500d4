"""Share of the RG build's host-free stage ranges that replayed a CUDA
graph: the program's ``cmt::graph.replay`` spans over its ``cmt::slic``,
``cmt::canny``, ``cmt::region_features`` and ``cmt::rag`` ranges in the
window, in %. None without stage ranges, or with no ``cmt::graph.*`` span
at all (a program that has no stage graphs)."""

STAGES = ("cmt::slic", "cmt::canny", "cmt::region_features", "cmt::rag")


def read(w):
    tr = w["trace"]
    stages = sum(tr.count(s) for s in STAGES)
    replays = tr.count("cmt::graph.replay")
    if not stages or not (replays or tr.count("cmt::graph.capture")):
        return None
    return 100.0 * replays / stages
