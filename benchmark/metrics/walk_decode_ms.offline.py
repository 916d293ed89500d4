"""Host ms an image of the directory walk's decode: the program's
``cmt::walk.decode`` span around each chunk's decode on the decode worker
(overlapped with compute), over the images completed; the program-side
twin of ``decode_ms.offline``."""


def read(w):
    images, tr = w.get("images", 0), w["trace"]
    if not images or not tr.count("cmt::walk.decode"):
        return None
    return 1000.0 * tr.host_s("cmt::walk.decode") / images
