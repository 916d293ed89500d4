"""Inference serving: a micro-batching HTTP front-end over the port's
``MultimodalPredictor``; port of ``camouflage_multimodal_tpu/serve.py``.

* ``MicroBatcher`` — a queue + worker thread that drains up to
  ``batch_size`` requests (waiting at most ``max_wait_ms`` after the first),
  pads the group with its last image to the smallest power-of-two bucket
  that holds it, runs the predictor ONCE, and fulfills each request's
  future. Occupancy/latency counters included.
* ``InferenceService`` — decodes image bytes with PIL, runs the batcher and
  shapes each response like the reference's prediction dict
  (``test_multimodal.py:141-150``) plus the RG 4-band classification
  (``region_graph/test.py:257-268``). Its batcher drains nothing before
  :meth:`InferenceService.warmup` has run every bucket once: on the card
  the first call builds the kernels with nvcc (:mod:`core.kernels`), and a
  request that raced that build would wait for it.
* ``make_server`` / ``serve_forever`` / CLI ``serve`` — a stdlib
  ``ThreadingHTTPServer`` with ``POST /predict`` (image bytes → JSON,
  optional base64-PNG heatmap), ``GET /healthz`` and ``GET /stats``.

Example::

    python -m camouflage_multimodal_tpu_torch.cli serve \\
        --checkpoint artifacts/checkpoints_balanced/multimodal_best_fixed.ckpt \\
        --rg-model artifacts/rg_model.ckpt \\
        --kg-embeddings artifacts/kg_embeddings/all_embeddings.npz \\
        --port 8000

    curl -s -X POST --data-binary @test.jpg \\
        'http://localhost:8000/predict?heatmap=1' | jq .classification
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch


class MicroBatcher:
    """Coalesce concurrent single-item requests into fixed-shape batches.

    ``predict_fn`` receives a padded uint8 batch and must return a dict of
    arrays with a leading batch axis (nested dicts allowed). Short groups
    are padded to the smallest power-of-two bucket that covers them (1, 2,
    4, …, batch_size), so a lone request under light load runs batch 1;
    ``bucketed=False`` always pads to ``batch_size``.

    The worker starts draining at construction; ``start=False`` holds it
    until :meth:`start`, and requests submitted meanwhile wait in the queue.
    """

    def __init__(self, predict_fn: Callable[[np.ndarray], Dict],
                 batch_size: int = 8, max_wait_ms: float = 5.0,
                 bucketed: bool = True, start: bool = True) -> None:
        self.predict_fn = predict_fn
        self.batch_size = int(batch_size)
        if bucketed:
            self.buckets = [b for b in (1 << i for i in range(16))
                            if b < self.batch_size] + [self.batch_size]
        else:
            self.buckets = [self.batch_size]
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.batched_items = 0
        self._latencies: List[float] = []  # ring buffer, seconds
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="microbatch-worker")
        if start:
            self.start()

    def start(self) -> None:
        """Start draining (once; later calls do nothing)."""
        with self._stats_lock:
            if self._worker.ident is None:
                self._worker.start()

    def submit(self, image_u8: np.ndarray) -> Future:
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._queue.put((image_u8, fut, time.perf_counter()))
        return fut

    def close(self) -> None:
        self._stop.set()
        self._queue.put(None)  # wake the worker
        if self._worker.ident is not None:
            self._worker.join(timeout=5.0)
        # Fail anything still queued (submitted in the shutdown race, stuck
        # behind the sentinel or never drained) so no caller waits for the
        # full result timeout.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("MicroBatcher closed"))

    # -- worker ----------------------------------------------------------
    def _drain_batch(self):
        first = self._queue.get()
        if first is None:
            return []
        items = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(items) < self.batch_size:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                nxt = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _run(self) -> None:
        while not self._stop.is_set():
            items = self._drain_batch()
            if not items:
                continue
            imgs = [it[0] for it in items]
            futs = [it[1] for it in items]
            t_submit = [it[2] for it in items]
            n = len(imgs)
            bucket = next(b for b in self.buckets if b >= n)
            while len(imgs) < bucket:
                imgs.append(imgs[-1])
            try:
                out = self.predict_fn(np.stack(imgs))
            except Exception as exc:  # per-batch fault tolerance
                for fut in futs:
                    if not fut.cancelled():
                        fut.set_exception(exc)
                continue
            now = time.perf_counter()
            with self._stats_lock:
                self.requests += n
                self.batches += 1
                self.batched_items += n
                self._latencies.extend(now - t for t in t_submit)
                if len(self._latencies) > 4096:
                    self._latencies = self._latencies[-2048:]
            for i, fut in enumerate(futs):
                if not fut.cancelled():
                    fut.set_result(_index_tree(out, i))

    def stats(self) -> Dict:
        with self._stats_lock:
            lat = sorted(self._latencies)
            return {
                "requests": self.requests,
                "batches": self.batches,
                "mean_batch_occupancy": (self.batched_items / self.batches
                                         if self.batches else 0.0),
                "batch_size": self.batch_size,
                "bucket_sizes": list(self.buckets),
                "p50_latency_ms": (1000.0 * lat[len(lat) // 2]) if lat else None,
                "p95_latency_ms": (1000.0 * lat[int(len(lat) * 0.95)]
                                   if lat else None),
            }


def _index_tree(out, i: int):
    if isinstance(out, dict):
        return {k: _index_tree(v, i) for k, v in out.items()}
    return np.asarray(out)[i]


class InferenceService:
    """Bytes-in / JSON-out inference over a ``MultimodalPredictor``. Its
    batcher drains only once :meth:`warmup` has run."""

    def __init__(self, predictor, batch_size: int = 8,
                 max_wait_ms: float = 5.0) -> None:
        self.predictor = predictor
        self.image_size = predictor.rg_pipeline.image_size
        self.batcher = MicroBatcher(predictor.predict_batch,
                                    batch_size=batch_size,
                                    max_wait_ms=max_wait_ms, start=False)

    def close(self) -> None:
        self.batcher.close()

    def decode(self, body: bytes) -> np.ndarray:
        from PIL import Image

        img = Image.open(io.BytesIO(body)).convert("RGB")
        img = img.resize((self.image_size, self.image_size))
        return np.asarray(img, dtype=np.uint8)

    def warmup(self) -> None:
        """Run EVERY bucket once — on the card the first call builds the
        kernels — then start the batcher; the final submit proves the
        worker loop end to end."""
        one = np.zeros((self.image_size, self.image_size, 3), np.uint8)
        for b in self.batcher.buckets:
            self.predictor.predict_batch(np.zeros((b,) + one.shape, np.uint8))
        self.batcher.start()
        self.batcher.submit(one).result(timeout=600)

    def predict_bytes(self, body: bytes, include_heatmap: bool = False) -> Dict:
        return self.predict_image(self.decode(body),
                                  include_heatmap=include_heatmap)

    def predict_image(self, image: np.ndarray,
                      include_heatmap: bool = False) -> Dict:
        t0 = time.perf_counter()
        out = self.batcher.submit(image).result(timeout=120)
        # response schema follows the reference prediction dict
        # (test_multimodal.py:141-150) + RG bands (test.py:257-268)
        from camouflage_multimodal_tpu_torch.api import classification_bands

        heatmap = np.asarray(out["heatmap"], np.float32)
        band, _color = classification_bands(float(heatmap.mean()))
        resp = {
            "mask_pred": int(np.argmax(out["mask_logits"])),
            "mask_prob": [float(p) for p in np.asarray(out["mask_prob"])],
            "instance_pred": int(np.argmax(out["instance_logits"])),
            "edge_prob": float(np.asarray(out["edge_prob"]).ravel()[0]),
            "score": float(np.asarray(out["score"]).ravel()[0]),
            "classification": band,
            "latency_ms": round(1000.0 * (time.perf_counter() - t0), 3),
        }
        if include_heatmap:
            resp["heatmap_png_base64"] = _png_b64(heatmap)
        return resp

    def stats(self) -> Dict:
        """The batcher's counters, the predictor's device type as
        ``backend`` (``"cuda"`` or ``"cpu"``; the card's name beside it) and
        the image size."""
        s = self.batcher.stats()
        device = torch.device(getattr(self.predictor, "device", "cpu"))
        s["backend"] = device.type
        if device.type == "cuda":
            s["device_name"] = torch.cuda.get_device_name(device)
        s["image_size"] = self.image_size
        return s


def _png_b64(heatmap: np.ndarray) -> str:
    from PIL import Image

    arr = np.clip(heatmap * 255.0, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode="L").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def make_server(service: InferenceService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, payload: Dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send(200, {"status": "ok", **service.stats()})
            elif path == "/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/predict":
                self._send(404, {"error": f"unknown path {parsed.path}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._send(400, {"error": "empty body; POST image bytes"})
                return
            body = self.rfile.read(length)
            q = parse_qs(parsed.query)
            include_heatmap = q.get("heatmap", ["0"])[0] in ("1", "true")
            try:
                image = service.decode(body)
            except Exception as exc:  # client's fault: undecodable payload
                self._send(400, {"error": f"bad image: {exc}"})
                return
            try:
                resp = service.predict_image(
                    image, include_heatmap=include_heatmap)
            except Exception as exc:  # server/device fault: retryable 5xx
                self._send(500, {"error": str(exc)})
                return
            self._send(200, resp)

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(fusion_checkpoint: str, rg_checkpoint: str,
                  kg_embeddings_path: str, host: str = "0.0.0.0",
                  port: int = 8000, batch_size: int = 8,
                  max_wait_ms: float = 5.0, n_segments: int = 500,
                  device: str | torch.device = "cuda", log_fn=print) -> None:
    """Load the predictor on ``device`` (``"cuda"`` raises without a card),
    warm every bucket, then serve until interrupted."""
    from camouflage_multimodal_tpu_torch.api import MultimodalPredictor

    predictor = MultimodalPredictor(fusion_checkpoint, rg_checkpoint,
                                    kg_embeddings_path, n_segments=n_segments,
                                    device=device)
    service = InferenceService(predictor, batch_size=batch_size,
                               max_wait_ms=max_wait_ms)
    log_fn(f"warming buckets {service.batcher.buckets} on {predictor.device} …")
    service.warmup()
    server = make_server(service, host=host, port=port)
    log_fn(f"serving on http://{host}:{server.server_address[1]}  "
           f"(POST /predict, GET /healthz, GET /stats)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
