"""SLIC's share of its roofline: the least time the chip could take for
the SLIC stage of the images completed (``counts.slic_stage`` at the
configuration's shapes) over the device time of the kernels launched from
the program's ``cmt::slic`` ranges."""

import counts


def read(w):
    images, tr, cfg = w.get("images", 0), w["trace"], w["config"]
    device_s = tr.device_s(tr.launched_in("cmt::slic"))
    if not images or device_s <= 0:
        return None
    work = counts.slic_stage(cfg["image_size"], cfg["image_size"], cfg)
    return 100.0 * images * counts.bound_s(work["flops"], work["bytes"]) / device_s
