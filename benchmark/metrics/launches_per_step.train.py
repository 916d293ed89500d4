"""Device operations (kernels and copies) a training step: those of the
traced window over its steps."""


def read(w):
    steps = w.get("steps", 0)
    if not steps or not w["trace"].gpu:
        return None
    return len(w["trace"].gpu) / steps
