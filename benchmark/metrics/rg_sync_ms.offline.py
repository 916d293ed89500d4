"""Host ms an image that the RG build spends blocked in its host
synchronisations: the program's ``cmt::sync.*`` spans (Canny's hysteresis
tests, connectivity's component and merge-round tests, and the constants
copied from pageable host memory, which wait for the card's queue too),
over the images completed."""

PREFIX = "cmt::sync."


def read(w):
    images, tr = w.get("images", 0), w["trace"]
    names = [n for n in tr.ranges if n.startswith(PREFIX)]
    if not images or not any(tr.count(n) for n in names):
        return None
    return 1000.0 * tr.host_s(*names) / images
