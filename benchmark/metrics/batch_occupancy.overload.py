"""Requests a predictor call: the change in the ``MicroBatcher``'s
``requests`` over the change in its ``batches`` across the window."""


def read(w):
    calls = w.get("calls", 0)
    if not calls:
        return None
    return w["requests"] / calls
