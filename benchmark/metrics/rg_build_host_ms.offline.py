"""Host ms an image of the region-graph build: the program's five
``cmt::`` build ranges (SLIC, connectivity, Canny, region features, RAG),
over the images completed."""

STAGES = ("cmt::slic", "cmt::connectivity", "cmt::canny", "cmt::region_features", "cmt::rag")


def read(w):
    images, tr = w.get("images", 0), w["trace"]
    if not images or not any(tr.count(s) for s in STAGES):
        return None
    return 1000.0 * tr.host_s(*STAGES) / images
