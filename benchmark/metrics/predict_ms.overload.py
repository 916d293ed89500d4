"""Host ms of a predictor call: the benchmark's ``bench::predict`` span
around the batcher's ``predict_fn`` (``MultimodalPredictor.predict_batch``:
upload, pipeline, the copy of every output to the host)."""


def read(w):
    tr = w["trace"]
    calls = tr.count("bench::predict")
    if not calls:
        return None
    return 1000.0 * tr.host_s("bench::predict") / calls
