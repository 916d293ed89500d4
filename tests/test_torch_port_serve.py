"""The port's serving layer (``camouflage_multimodal_tpu_torch/serve.py``)
on the CPU: the JAX ``tests/test_serve.py`` stub-predictor cases run against
the port's ``MicroBatcher``, ``InferenceService`` and ``make_server``, the
warmup-before-drain rule, and one parity case of the two services on the
committed full-width weights.

Bars of the parity case: the ints and the classification band equal, the
probabilities and the score within the slice's output bar and the heatmap
PNG within its MAE bar (tests/test_torch_port_pipeline.py).
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu import api as J_api  # noqa: E402
from camouflage_multimodal_tpu import serve as J_serve  # noqa: E402
from camouflage_multimodal_tpu_torch import api as T_api  # noqa: E402
from camouflage_multimodal_tpu_torch.serve import (  # noqa: E402
    InferenceService, MicroBatcher, make_server)
from test_torch_port_pipeline import (  # noqa: E402, F401
    ARTIFACTS, OUT_TOL, _compare_slice, few_threads, synthetic_images)

pytestmark = pytest.mark.usefixtures("few_threads")

S = 32  # stub image size


class StubPredictor:
    """Looks like api.MultimodalPredictor to InferenceService."""

    def __init__(self, batch_size_seen):
        self.batch_size_seen = batch_size_seen
        self.rg_pipeline = type("P", (), {"image_size": S})()

    def predict_batch(self, images):
        assert images.dtype == np.uint8
        B = images.shape[0]
        self.batch_size_seen.append(B)
        brightness = images.reshape(B, -1).mean(axis=1) / 255.0
        logits = np.stack([1.0 - brightness, brightness], axis=1)
        return {
            "mask_logits": logits,
            "mask_prob": logits / logits.sum(axis=1, keepdims=True),
            "instance_logits": logits.copy(),
            "instance_prob": logits / logits.sum(axis=1, keepdims=True),
            "edge_prob": brightness[:, None],
            "score": brightness[:, None],
            "heatmap": np.broadcast_to(brightness[:, None, None],
                                       (B, S, S)).copy(),
            "attention": {"rg2kg": np.zeros((B, 4, 13))},  # nested dict
        }


def test_microbatcher_coalesces_and_pads():
    seen = []
    stub = StubPredictor(seen)
    b = MicroBatcher(stub.predict_batch, batch_size=4, max_wait_ms=60.0)
    try:
        imgs = [np.full((S, S, 3), 40 * i, np.uint8) for i in range(6)]
        futs = [b.submit(im) for im in imgs]
        outs = [f.result(timeout=10) for f in futs]
        assert all(n in (1, 2, 4) for n in seen), seen
        assert len(seen) <= 3
        for i, out in enumerate(outs):
            expected = imgs[i].mean() / 255.0
            np.testing.assert_allclose(float(out["score"][0]), expected, atol=1e-6)
            assert out["attention"]["rg2kg"].shape == (4, 13)
        st = b.stats()
        assert st["requests"] == 6 and st["batches"] == len(seen)
        assert st["p50_latency_ms"] is not None
        reference = J_serve.MicroBatcher(stub.predict_batch)
        reference.close()
        assert set(st) == set(reference.stats())
    finally:
        b.close()


def test_microbatcher_pads_with_the_last_image():
    """A group of 3 runs the bucket of 4, its fourth row a copy of the
    third image (the JAX padding)."""
    batches = []
    release = threading.Event()

    def record(images):
        release.wait(timeout=10)
        batches.append(images.copy())
        return {"score": images.reshape(len(images), -1)[:, :1].astype(np.float32)}

    b = MicroBatcher(record, batch_size=4, max_wait_ms=200.0, start=False)
    try:
        futs = [b.submit(np.full((S, S, 3), v, np.uint8)) for v in (10, 20, 30)]
        b.start()
        release.set()
        assert [float(f.result(timeout=10)["score"][0]) for f in futs] == [10.0, 20.0, 30.0]
        assert [len(x) for x in batches] == [4]
        np.testing.assert_array_equal(batches[0][3], batches[0][2])
    finally:
        b.close()


def test_microbatcher_bucketed_light_load():
    seen = []
    b = MicroBatcher(StubPredictor(seen).predict_batch, batch_size=8, max_wait_ms=1.0)
    try:
        assert b.buckets == [1, 2, 4, 8]
        reference = J_serve.MicroBatcher(lambda x: x, batch_size=8)
        reference.close()
        assert b.buckets == reference.buckets
        out = b.submit(np.zeros((S, S, 3), np.uint8)).result(timeout=10)
        assert seen == [1]
        assert float(out["score"][0]) == 0.0
        assert b.stats()["bucket_sizes"] == [1, 2, 4, 8]
    finally:
        b.close()

    seen2 = []
    b2 = MicroBatcher(StubPredictor(seen2).predict_batch, batch_size=8,
                      max_wait_ms=1.0, bucketed=False)
    try:
        b2.submit(np.zeros((S, S, 3), np.uint8)).result(timeout=10)
        assert seen2 == [8]
    finally:
        b2.close()


def test_microbatcher_propagates_failures():
    def boom(images):
        raise RuntimeError("device exploded")

    b = MicroBatcher(boom, batch_size=2, max_wait_ms=1.0)
    try:
        fut = b.submit(np.zeros((S, S, 3), np.uint8))
        with pytest.raises(RuntimeError, match="device exploded"):
            fut.result(timeout=10)
        fut2 = b.submit(np.zeros((S, S, 3), np.uint8))
        with pytest.raises(RuntimeError):
            fut2.result(timeout=10)
    finally:
        b.close()


def test_microbatcher_close_fails_pending_and_rejects_submit():
    release = threading.Event()
    entered = threading.Event()

    def slow(images):
        entered.set()
        release.wait(timeout=10)
        return {"score": np.zeros((images.shape[0], 1), np.float32)}

    b = MicroBatcher(slow, batch_size=1, max_wait_ms=1.0)
    first = b.submit(np.zeros((S, S, 3), np.uint8))
    entered.wait(timeout=10)
    stranded = b.submit(np.zeros((S, S, 3), np.uint8))
    closer = threading.Thread(target=b.close)
    closer.start()
    release.set()
    closer.join(timeout=10)
    assert not closer.is_alive()
    assert first.result(timeout=10)["score"].shape == (1,)
    with pytest.raises(RuntimeError, match="closed"):
        stranded.result(timeout=10)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.zeros((S, S, 3), np.uint8))


def test_service_drains_nothing_before_warmup():
    """A request that arrives before ``warmup()`` waits in the queue: the
    predictor first sees every bucket once (the warmup's own calls), and
    only then the request. Closing a service that never warmed up fails
    what is queued instead of hanging."""
    seen = []
    service = InferenceService(StubPredictor(seen), batch_size=4, max_wait_ms=1.0)
    try:
        early = service.batcher.submit(np.full((S, S, 3), 200, np.uint8))
        time.sleep(0.3)
        assert seen == [] and not early.done()
        service.warmup()
        assert float(early.result(timeout=10)["score"][0]) == pytest.approx(200 / 255)
        assert seen[:3] == [1, 2, 4]
        assert all(n in (1, 2, 4) for n in seen[3:]) and len(seen) >= 4
    finally:
        service.close()

    cold = InferenceService(StubPredictor([]), batch_size=2, max_wait_ms=1.0)
    stranded = cold.batcher.submit(np.zeros((S, S, 3), np.uint8))
    closer = threading.Thread(target=cold.close)
    closer.start()
    closer.join(timeout=10)
    assert not closer.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        stranded.result(timeout=1)


def _serve(service):
    server = make_server(service, host="127.0.0.1", port=0)  # ephemeral port
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture()
def http_service():
    service = InferenceService(StubPredictor([]), batch_size=2, max_wait_ms=1.0)
    service.warmup()
    server, url = _serve(service)
    yield url
    server.shutdown()
    server.server_close()
    service.close()


def _png_bytes(value: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((S, S, 3), value, np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body, timeout=30):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_http_predict_health_stats(http_service):
    url = http_service
    with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["image_size"] == S
    assert health["backend"] == "cpu"

    resp = _post(url + "/predict?heatmap=1", _png_bytes(200))
    assert resp["mask_pred"] == 1
    assert 0.0 <= resp["score"] <= 1.0
    assert resp["classification"]
    assert "heatmap_png_base64" in resp and resp["latency_ms"] > 0

    resp = _post(url + "/predict", _png_bytes(10))
    assert resp["mask_pred"] == 0 and "heatmap_png_base64" not in resp

    with urllib.request.urlopen(url + "/stats", timeout=10) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 2

    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _post(url + "/predict", b"not an image")
    assert exc_info.value.code == 400

    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(url + "/nope", timeout=10)
    assert exc_info.value.code == 404


def test_http_inference_failure_is_500_not_400():
    def boom(images):
        raise RuntimeError("device exploded")

    service = InferenceService(StubPredictor([]), batch_size=1, max_wait_ms=1.0)
    service.warmup()
    service.batcher.predict_fn = boom
    server, url = _serve(service)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post(url + "/predict", _png_bytes(100), timeout=15)
        assert exc_info.value.code == 500
        assert "device exploded" in json.loads(exc_info.value.read())["error"]
    finally:
        server.shutdown()
        server.server_close()
        service.close()


def test_http_concurrent_requests_share_batches(http_service):
    url = http_service
    results = [None] * 4
    errors = []

    def hit(i):
        try:
            results[i] = _post(url + "/predict", _png_bytes(60 * i), timeout=20)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    scores = [r["score"] for r in results]
    assert scores == sorted(scores) and len(set(scores)) == 4


def _both(service, bodies):
    """Responses to ``bodies`` sent together from one thread each, with
    the heatmap."""
    out = [None] * len(bodies)

    def ask(i):
        out[i] = service.predict_bytes(bodies[i], include_heatmap=True)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


def _capture(predict, served):
    """``predict`` that also records each batch it is given and answers."""
    def run(images):
        out = predict(images)
        served.append((images.copy(), out))
        return out
    return run


def _rows(served, images):
    """The recorded outputs of ``images``, one row each, from the one
    recorded batch that holds them all."""
    (batch, out), = served
    order = [next(k for k in range(len(batch)) if np.array_equal(batch[k], im))
             for im in images]

    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return np.asarray(tree)[order]
    return take(out)


def test_service_matches_jax_on_committed_weights():
    """The same PNG bytes of 2 seeded 256² images through the JAX service
    over the JAX predictor and the port's over the port's (CPU), both at
    batch size 2 with a wait long enough that the pair shares one batch.
    Each service answers what its predictor gave for that batch; the two
    batches meet the slice's bars (``_compare_slice``), so the response
    floats are held to the output bar where an image's segment maps agree —
    a pixel that changes superpixel moves the fusion inputs."""
    from PIL import Image

    images = synthetic_images(23, 2, 256)
    bodies = []
    for img in images:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        bodies.append(buf.getvalue())
    j_pred = J_api.MultimodalPredictor(*ARTIFACTS)
    t_pred = T_api.MultimodalPredictor(*ARTIFACTS, device="cpu")
    j_service = J_serve.InferenceService(j_pred, batch_size=2, max_wait_ms=2000.0)
    t_service = InferenceService(t_pred, batch_size=2, max_wait_ms=2000.0)
    j_served, t_served = [], []
    j_service.batcher.predict_fn = _capture(j_pred.predict_batch, j_served)
    try:
        t_service.warmup()
        t_service.batcher.predict_fn = _capture(t_pred.predict_batch, t_served)
        want, got = _both(j_service, bodies), _both(t_service, bodies)
        t_stats = t_service.stats()
        for service in (t_service, j_service):
            np.testing.assert_array_equal(np.stack([service.decode(b) for b in bodies]), images)
    finally:
        j_service.close()
        t_service.close()
    assert t_stats["backend"] == "cpu" and t_stats["image_size"] == 256
    assert t_stats["requests"] == 3 and t_stats["mean_batch_occupancy"] == 1.5
    j_out, t_out = _rows(j_served, images), _rows(t_served, images)
    _compare_slice(j_out, t_out)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for key in ("mask_pred", "instance_pred", "classification"):
            assert g[key] == w[key], key
            assert type(g[key]) is type(w[key])
        for key in ("mask_prob", "edge_prob", "score"):
            assert type(g[key]) is type(w[key])
            for r, out in ((g, t_out), (w, j_out)):
                np.testing.assert_allclose(np.ravel(r[key]), np.ravel(out[key][i]),
                                           rtol=0, atol=1e-6, err_msg=key)
            if (j_out["segments"][i] == t_out["segments"][i]).all():
                np.testing.assert_allclose(g[key], w[key], **OUT_TOL, err_msg=key)
        heat = [np.asarray(Image.open(io.BytesIO(base64.b64decode(r["heatmap_png_base64"]))),
                           np.float64) / 255.0 for r in (g, w)]
        assert heat[0].shape == (256, 256)
        assert np.abs(heat[0] - heat[1]).mean() <= 1e-2 + 1 / 255
