"""Host ms an image that the directory walk's compute thread waits: the
program's ``cmt::walk.wait_input`` (for a decoded, uploaded chunk) and
``cmt::walk.wait_output`` spans (for the previous chunk's download), over
the images completed."""

NAMES = ("cmt::walk.wait_input", "cmt::walk.wait_output")


def read(w):
    images, tr = w.get("images", 0), w["trace"]
    if not images or not any(tr.count(n) for n in NAMES):
        return None
    return 1000.0 * tr.host_s(*NAMES) / images
