"""Host ms an image of Canny: the program's ``cmt::canny`` range, whose
hysteresis synchronises with the host every few dilations."""


def read(w):
    images, tr = w.get("images", 0), w["trace"]
    if not images or not tr.count("cmt::canny"):
        return None
    return 1000.0 * tr.host_s("cmt::canny") / images
