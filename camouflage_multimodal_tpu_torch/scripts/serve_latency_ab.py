"""A/B the serve path's light-load latency: bucketed vs fixed-batch padding.

Port of the JAX system's ``scripts/serve_latency_ab.py``: measures the
port's real ``serve.MicroBatcher`` path (submit → coalesce → padded batch
→ fan-out) with sequential single requests on ``api.MultimodalPredictor``
over the committed artifacts. With ``bucketed=False`` every lone request
pays the full batch-``SERVE_BATCH`` forward; bucketed, it runs batch 1.
Every bucket a mode can hit is warmed first (on the card the first call
builds the kernels). Each request's ``future.result()`` holds rows already
pulled to numpy, so it is the device→host completion barrier.

Knobs, as the JAX script's: ``SERVE_IMAGE_SIZE`` (256), ``SERVE_BATCH`` (8);
``--n-requests`` (40, the JAX script's count). Images: the first 4
``*.jpg`` of ``--image-dir`` through the port's decode, else the bench's
seeded images. Prints and returns the JAX record's layout
(``artifacts/serve_latency_ab.json``) plus ``device_name``, and per mode
``forwards`` (predictor calls) and ``kernel_launches``; writes it to
``--out`` when given.

    SERVE_IMAGE_SIZE=256 SERVE_BATCH=8 python -m \\
        camouflage_multimodal_tpu_torch.scripts.serve_latency_ab \\
        [--device cuda|cpu] [--image-dir DIR] [--n-requests 40] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.api import MultimodalPredictor
from camouflage_multimodal_tpu_torch.bench import fallback_images, image_paths
from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.data.cod10k import load_image_u8
from camouflage_multimodal_tpu_torch.serve import MicroBatcher

ARTIFACTS = ("artifacts/checkpoints_balanced/multimodal_best_fixed.ckpt",
             "artifacts/rg_model.ckpt",
             "artifacts/kg_embeddings/all_embeddings.npz")
N_REQUESTS = 40
N_IMAGES = 4
MAX_WAIT_MS = 2.0


def request_images(image_dir: Optional[str], size: int) -> np.ndarray:
    """(4, size, size, 3) uint8: the first 4 ``*.jpg`` of ``image_dir``,
    else the bench's seeded images."""
    paths = image_paths(image_dir, N_IMAGES)
    if paths:
        return np.stack([load_image_u8(p, size) for p in paths])
    return (fallback_images(N_IMAGES, size) * 255).round().astype(np.uint8)


def run_mode(pred: MultimodalPredictor, images: np.ndarray, batch: int, bucketed: bool,
             n_requests: int) -> Tuple[Dict, List[Dict[str, np.ndarray]]]:
    """One mode: its record (the JAX script's fields, plus ``forwards`` and
    ``kernel_launches`` over the mode's warm-up and requests) and the
    heatmap and score of each timed response."""
    forwards = [0]

    def predict(batch_u8):
        forwards[0] += 1
        return pred.predict_batch(batch_u8)

    size = images.shape[1]
    kernels.reset_launches()
    b = MicroBatcher(predict, batch_size=batch, max_wait_ms=MAX_WAIT_MS, bucketed=bucketed)
    try:
        for bs in b.buckets:        # warm every shape this mode can hit
            predict(np.zeros((bs, size, size, 3), np.uint8))
        b.submit(images[0]).result(timeout=600)
        lats, responses = [], []
        for i in range(n_requests):
            t0 = time.perf_counter()
            res = b.submit(images[i % len(images)]).result(timeout=120)
            lats.append(time.perf_counter() - t0)
            responses.append({"heatmap": res["heatmap"], "score": res["score"]})
        lats.sort()
        st = b.stats()
    finally:
        b.close()
    record = {
        "p50_ms": round(1e3 * lats[len(lats) // 2], 2),
        "p95_ms": round(1e3 * lats[int(len(lats) * 0.95)], 2),
        "stats_p50_ms": st["p50_latency_ms"],
        "mean_batch_occupancy": st["mean_batch_occupancy"],
        "buckets": st["bucket_sizes"],
        "forwards": forwards[0],
        "kernel_launches": dict(kernels.LAUNCHES),
    }
    return record, responses


def run(size: int = 256, batch: int = 8, n_requests: int = N_REQUESTS, device: str = "cuda",
        image_dir: Optional[str] = None, predictor: Optional[MultimodalPredictor] = None
        ) -> Tuple[Dict, Dict[str, List[Dict[str, np.ndarray]]], np.ndarray]:
    """(the record, each mode's responses, the request images); request
    ``i`` is image ``i % 4``. ``predictor`` defaults to the committed
    artifacts on ``device``."""
    pred = predictor or MultimodalPredictor(*ARTIFACTS, device=device)
    images = request_images(image_dir, size)
    modes, responses = {}, {}
    for bucketed in (True, False):
        name = "bucketed" if bucketed else "fixed_batch"
        modes[name], responses[name] = run_mode(pred, images, batch, bucketed, n_requests)
    dev = pred.device
    out = {"image_size": size, "batch_size": batch, "n_sequential_requests": n_requests,
           "modes": modes,
           "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    return out, responses, images


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--image-dir", default=None,
                    help="directory of *.jpg (default: none, the seeded images)")
    ap.add_argument("--n-requests", type=int, default=N_REQUESTS)
    ap.add_argument("--out", default=None, help="write the JSON record here")
    args = ap.parse_args(argv)
    out, _, _ = run(int(os.environ.get("SERVE_IMAGE_SIZE", 256)),
                    int(os.environ.get("SERVE_BATCH", 8)), args.n_requests, args.device,
                    args.image_dir)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
