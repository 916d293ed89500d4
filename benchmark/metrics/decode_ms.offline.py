"""Host ms an image of the program's native decode: the benchmark's
``bench::decode`` span around each ``native.load_batch_u8`` call (on the
decode worker, overlapped with compute), over the images completed."""


def read(w):
    images = w.get("images", 0)
    tr = w["trace"]
    if not images or not tr.count("bench::decode"):
        return None
    return 1000.0 * tr.host_s("bench::decode") / images
