"""Benchmark: end-to-end multimodal inference throughput on one card.

Port of the JAX system's ``bench.py``: the FULL per-image pipeline (JPEG
decode → resize → SLIC superpixels → connectivity → Canny → 15-dim segment
features → RAG → ``RegionGraphGNN`` → cross-attention fusion → 4 heads and
the per-pixel heatmap), measured three ways:

* **device only**: two resident batches, alternated, two deep — dispatch
  batch i + 1, then pull batch i's ``score[0, 0]`` to the host; the drain
  pulls the last one, so every timed batch ends in a device→host pull;
* **batch-1 p50**: one image a call, each call ending in the pull;
* **end to end**: decode ∥ upload ∥ compute as three stages — the native
  threaded decode (:mod:`native`, PIL's bytes) on one worker thread that
  fans each batch out over up to 8 threads of the library's own, the
  host→device copy from pinned memory on a second
  worker and a CUDA stream of its own (the compute stream waits on its
  event), the pipeline on the caller's thread. Best and median of
  ``BENCH_E2E_PASSES`` passes, and the best pass with draft JPEG decode.

The pipeline synchronises with the host inside a batch (connectivity's
fixed points test for convergence on the host), so on
the port "dispatch" returns late and the two-deep loop does not overlap as
it does under XLA: the loop is kept as the JAX bench runs it, and what it
measures is written down beside it (PERF.md).

Knobs, as the JAX bench's (same defaults): ``BENCH_BATCH`` (16),
``BENCH_ITERS`` (30), ``BENCH_E2E_ITERS`` (8), ``BENCH_E2E_PASSES`` (4),
``BENCH_IMAGE_SIZE`` (352), ``BENCH_N_SEGMENTS`` (500),
``BENCH_WINDOW_RADIUS`` (3). Models are randomly initialised from a
``torch.Generator`` seeded 0 (timing does not depend on the weights), the
fusion on the fused-attention kernel as inference always runs it, with a
13 × 128 normal KG matrix from the same generator. Images: the ``*.jpg`` of
``--image-dir`` when it is given (COD10K's ``images/`` for the JAX bench's
figures); without any, the device-only images are the JAX bench's seeded
noise, bit for bit, the end-to-end fields are left out and ``value`` is the
device-only rate.

    python -m camouflage_multimodal_tpu_torch.bench [--device cuda|cpu] [--image-dir DIR]

Prints ONE JSON line with the JAX bench's keys, ``backend`` ``"cuda"`` (or
``"cpu"``), plus ``device_name``, ``kernel_launches`` (each hand kernel's
launches over the run) and ``forwards`` (pipeline calls over the run).
``vs_baseline`` is against the reference's CPU anchor of 2.2161 s/image.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from camouflage_multimodal_tpu_torch import native
from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.data.cod10k import load_image_rgb, load_image_u8
from camouflage_multimodal_tpu_torch.models.fusion import MultimodalCamouflageDetector
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN
from camouflage_multimodal_tpu_torch.pipeline import (
    MultimodalPipeline, RegionGraphPipeline, padded_nodes)

WARMUP = 5
REFERENCE_SECONDS_PER_IMAGE = 2.2161  # the reference's embedding_summary.json (CPU)
KG_SHAPE = (13, 128)


@dataclass(frozen=True)
class BenchConfig:
    """The JAX bench's knobs, with its defaults."""

    batch: int = 16
    iters: int = 30
    e2e_iters: int = 8
    e2e_passes: int = 4
    image_size: int = 352
    n_segments: int = 500
    window_radius: int = 3

    @classmethod
    def from_env(cls, environ: Mapping[str, str] = os.environ) -> "BenchConfig":
        d = cls()

        def knob(name, default):
            return int(environ.get(name, default))

        return cls(batch=knob("BENCH_BATCH", d.batch), iters=knob("BENCH_ITERS", d.iters),
                   e2e_iters=knob("BENCH_E2E_ITERS", d.e2e_iters),
                   e2e_passes=knob("BENCH_E2E_PASSES", d.e2e_passes),
                   image_size=knob("BENCH_IMAGE_SIZE", d.image_size),
                   n_segments=knob("BENCH_N_SEGMENTS", d.n_segments),
                   window_radius=knob("BENCH_WINDOW_RADIUS", d.window_radius))


def image_paths(image_dir: Optional[str], n: int) -> List[str]:
    """The first ``n`` ``*.jpg`` of ``image_dir`` in sorted order (none
    when the directory is absent)."""
    if not image_dir:
        return []
    return sorted(glob.glob(os.path.join(image_dir, "*.jpg")))[:n]


def cycled(items: Sequence, n: int) -> list:
    """``items`` repeated to exactly ``n`` entries."""
    return (list(items) * (n // len(items) + 1))[:n]


def fallback_images(n: int, size: int) -> np.ndarray:
    """The JAX bench's images when no file is there: seeded noise."""
    return np.random.default_rng(0).random((n, size, size, 3)).astype(np.float32)


def load_images(paths: Sequence[str], n: int, size: int) -> np.ndarray:
    """(n, size, size, 3) float32 in [0, 1]: the decoded ``paths`` (cycled
    up to ``n``), else :func:`fallback_images`."""
    if not paths:
        return fallback_images(n, size)
    return np.stack([load_image_rgb(p, size) for p in cycled(paths, n)])


def decode_batch_u8(paths: Sequence[str], size: int, draft: bool = False,
                    use_native: bool = True) -> np.ndarray:
    """(len(paths), size, size, 3) uint8 through the native threaded
    decoder, or PIL with ``use_native=False`` (draft JPEG decode with
    ``draft``). A file that does not decode raises."""
    if not use_native:
        return np.stack([load_image_u8(p, size, draft=draft) for p in paths])
    batch, ok = native.load_batch_u8(paths, size, draft=draft)
    if not ok.all():
        raise IOError(f"native decode failed for {[p for p, g in zip(paths, ok) if not g]}")
    return batch


def build_models(cfg: BenchConfig, device: torch.device):
    """(``MultimodalPipeline``, KG tensor) at full width, weights from a
    generator seeded 0, on ``device``."""
    g = torch.Generator().manual_seed(0)
    rg_model = RegionGraphGNN()
    rg_model.reset_parameters(g)
    fusion_model = MultimodalCamouflageDetector(use_pallas=True)
    fusion_model.reset_parameters(g)
    kg = torch.randn(*KG_SHAPE, generator=g)
    rg_pipe = RegionGraphPipeline(rg_model.to(device), n_segments=cfg.n_segments,
                                  image_size=cfg.image_size,
                                  max_nodes=padded_nodes(cfg.n_segments, cfg.image_size),
                                  window_radius=cfg.window_radius)
    return MultimodalPipeline(rg_pipe, fusion_model.to(device)), kg.to(device)


def first_tensor(out) -> torch.Tensor:
    """``out`` itself, else its first tensor (in a dict, a tuple or a list)."""
    if isinstance(out, torch.Tensor):
        return out
    values = out.values() if isinstance(out, dict) else out
    return first_tensor(next(iter(values)))


def pull(out) -> float:
    """The device→host copy of one scalar, the call's completion proof: a
    pipeline output's ``score[0, 0]``, else the first tensor's first
    element."""
    if isinstance(out, dict) and "score" in out:
        return float(out["score"][0, 0])
    return float(first_tensor(out).reshape(-1)[0])


def device_only_times(dispatch: Callable[[int], Dict], warmup: int, iters: int
                      ) -> Tuple[List[float], float]:
    """The two-deep device-only loop: dispatch batch i + 1, then pull batch
    i; ``warmup`` untimed batches first, and the drain's pull is added to
    the last time. Returns (seconds of each of the ``iters`` timed batches,
    the process's CPU seconds over them and the drain)."""
    pending = dispatch(0)
    for i in range(warmup):
        nxt = dispatch(i + 1)
        pull(pending)
        pending = nxt
    times = []
    cpu0 = time.process_time()
    for i in range(iters):
        t0 = time.perf_counter()
        nxt = dispatch(i)
        pull(pending)
        pending = nxt
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    pull(pending)                     # drain: the final batch's own proof
    times[-1] += time.perf_counter() - t0
    return times, time.process_time() - cpu0


class Uploader:
    """Host→device copies of uint8 batches for the end-to-end stages: on
    the card, each batch goes into the next of ``depth`` pinned buffers and
    is copied from there on a stream of this object's own; its event is
    what the compute stream waits on. A buffer is refilled only after its
    last copy's event has completed, so no copy reads a half-overwritten
    batch. On the CPU the host array is the batch."""

    def __init__(self, device: torch.device, shape, depth: int = 3) -> None:
        self.device = device
        self.depth = depth
        self.turn = 0
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            self.buffers = [torch.empty(shape, dtype=torch.uint8).pin_memory()
                            for _ in range(depth)]
            self.done: List[Optional[torch.cuda.Event]] = [None] * depth

    def __call__(self, batch: np.ndarray):
        """(device tensor, event to wait on or None)."""
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type != "cuda":
            return host, None
        i = self.turn % self.depth
        self.turn += 1
        if self.done[i] is not None:
            self.done[i].synchronize()
        self.buffers[i].copy_(host)
        with torch.cuda.stream(self.stream):
            dev = self.buffers[i].to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.done[i] = event
        return dev, event


def on_compute_stream(uploaded):
    """The uploaded batch, ordered before the kernels the caller's stream
    enqueues next (and kept alive for them by the caching allocator)."""
    dev, event = uploaded
    if event is not None:
        stream = torch.cuda.current_stream(dev.device)
        stream.wait_event(event)
        dev.record_stream(stream)
    return dev


def run_e2e(forward: Callable, path_batches: Sequence[Sequence[str]], cfg: BenchConfig,
            device: torch.device, draft: bool, use_native: bool = True) -> float:
    """One pass of decode ∥ upload ∥ compute over ``cfg.e2e_iters``
    batches; images per second. Batch i's scalar is pulled after batch
    i + 1 is dispatched; the last one in the drain."""
    upload = Uploader(device, (cfg.batch, cfg.image_size, cfg.image_size, 3))

    def decode(pb):
        return decode_batch_u8(pb, cfg.image_size, draft=draft, use_native=use_native)

    pull(forward(on_compute_stream(upload(decode(path_batches[0])))))   # warm
    n = len(path_batches)
    with ThreadPoolExecutor(max_workers=1) as dec_ex, \
            ThreadPoolExecutor(max_workers=1) as up_ex:
        dec_fut = dec_ex.submit(decode, path_batches[0])
        up_fut = up_ex.submit(upload, dec_fut.result())
        dec_fut = dec_ex.submit(decode, path_batches[1 % n])
        t0 = time.perf_counter()
        prev = None
        for i in range(cfg.e2e_iters):
            uploaded = up_fut.result()
            up_fut = up_ex.submit(upload, dec_fut.result())
            dec_fut = dec_ex.submit(decode, path_batches[(i + 2) % n])
            out = forward(on_compute_stream(uploaded))
            if prev is not None:
                pull(prev)
            prev = out
        pull(prev)
        elapsed = time.perf_counter() - t0
        up_fut.result()
        dec_fut.result()
    return cfg.e2e_iters * cfg.batch / elapsed


def run(cfg: BenchConfig, device: str = "cuda", image_dir: Optional[str] = None) -> Dict:
    """The bench's result line as a dict."""
    dev = resolve_device(device)
    pipe, kg = build_models(cfg, dev)
    B = cfg.batch
    forwards = [0]

    def forward(images):
        forwards[0] += 1
        return pipe(images, kg)

    kernels.reset_launches()

    # --- device only: two distinct resident batches, alternated ----------
    raw = load_images(image_paths(image_dir, 2 * B), 2 * B, cfg.image_size)
    batches = [torch.from_numpy(raw[:B]).to(dev), torch.from_numpy(raw[B:2 * B]).to(dev)]

    times, _ = device_only_times(lambda i: forward(batches[i % 2]), WARMUP, cfg.iters)
    med = float(np.median(times))
    device_imgs_per_sec = B / med
    p50_latency_ms = med / B * 1000.0
    baseline_imgs_per_sec = 1.0 / REFERENCE_SECONDS_PER_IMAGE

    # --- batch-1 latency ---------------------------------------------------
    one = [batches[0][:1].clone(), batches[1][:1].clone()]

    def run1(i):
        pull(forward(one[i % 2]))

    for i in range(WARMUP):
        run1(i)
    t1 = []
    for i in range(cfg.iters):
        t0 = time.perf_counter()
        run1(i)
        t1.append(time.perf_counter() - t0)
    p50_batch1_ms = float(np.median(t1)) * 1000.0

    # --- end to end: decode ∥ upload ∥ compute -----------------------------
    e2e_best = e2e_median = e2e_draft = None
    paths = image_paths(image_dir, 4 * B)
    if paths:
        paths = cycled(paths, 4 * B)
        path_batches = [paths[i * B:(i + 1) * B] for i in range(4)]
        e2e_all = sorted(run_e2e(forward, path_batches, cfg, dev, draft=False)
                         for _ in range(cfg.e2e_passes))
        e2e_best = e2e_all[-1]
        e2e_median = float(np.median(e2e_all))
        e2e_draft = max(run_e2e(forward, path_batches, cfg, dev, draft=True)
                        for _ in range(cfg.e2e_passes))

    headline = e2e_best if e2e_best is not None else device_imgs_per_sec
    scope = "host decode + " if e2e_best is not None else ""
    S = cfg.image_size
    result = {
        "metric": (f"images/sec/chip end-to-end multimodal inference {S}x{S} "
                   f"({scope}SLIC+features+RAG+GNN+fusion+heatmap)"),
        "value": round(headline, 3),
        "unit": "images/sec",
        "vs_baseline": round(headline / baseline_imgs_per_sec, 2),
        "device_only_imgs_per_sec": round(device_imgs_per_sec, 3),
        "device_only_vs_baseline": round(device_imgs_per_sec / baseline_imgs_per_sec, 2),
        "p50_per_image_ms": round(p50_latency_ms, 3),
        "p50_batch1_ms": round(p50_batch1_ms, 3),
        "batch": B,
        "backend": dev.type,
    }
    if e2e_median is not None:
        result["e2e_median_imgs_per_sec"] = round(e2e_median, 3)
        result["e2e_median_vs_baseline"] = round(e2e_median / baseline_imgs_per_sec, 2)
    if e2e_draft is not None:
        result["draft_decode_imgs_per_sec"] = round(e2e_draft, 3)
        result["draft_decode_vs_baseline"] = round(e2e_draft / baseline_imgs_per_sec, 2)
    result["device_name"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result["kernel_launches"] = dict(kernels.LAUNCHES)
    result["forwards"] = forwards[0]
    return result


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--image-dir", default=None,
                    help="directory of *.jpg (default: none, the seeded images)")
    args = ap.parse_args(argv)
    result = run(BenchConfig.from_env(), args.device, args.image_dir)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
