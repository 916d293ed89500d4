"""Host ms a step of AdamW: the profiler's ``Optimizer.step#AdamW.step``
range (``train.state.apply_updates``' ``optimizer.step()``)."""


def read(w):
    tr, steps = w["trace"], w.get("steps", 0)
    names = [n for n in tr.ranges if n.startswith("Optimizer.step#AdamW")]
    if not steps or not names:
        return None
    return 1000.0 * tr.host_s(*names) / steps
