"""Host ms a predictor call of the region-graph build: the program's five
``cmt::`` build ranges over the ``bench::predict`` calls."""

STAGES = ("cmt::slic", "cmt::connectivity", "cmt::canny", "cmt::region_features", "cmt::rag")


def read(w):
    tr = w["trace"]
    calls = tr.count("bench::predict")
    if not calls or not tr.count("cmt::slic"):
        return None
    return 1000.0 * tr.host_s(*STAGES) / calls
