"""Differential breakdown of the connectivity stage.

Port of the JAX system's ``scripts/profile_connectivity.py``: splits the
connectivity pass (``ops.connectivity.enforce_label_connectivity``) on a
real SLIC label batch (16 × 352², ``n_segments=500``) into its two halves:

  - ``connected_components`` alone (the segmented-min sweeps to a fixed
    point), with the number of sweeps each image needs;
  - the merge + relabel epilogue, by difference.

Raw labels come from ``slic(..., backend="exact", enforce_connectivity=False)``
(kernel B1 on the card). Each time is the median of ``ITERS`` (6) host-clock
calls, each ending in a device→host pull of one element. The sweep count
is an instrumented copy of the port's loop that tests every sweep and
counts each image's own sweeps up to and including the first one that
changes nothing in it, as the JAX script's ``vmap`` of its ``while_loop``
counts them, though the batch loop runs until its slowest image converges.
On the card each half also gets its device-busy ms and its five longest
device kernels (``core.profiling.device_profile``, ``torch.profiler``).

    python -m camouflage_multimodal_tpu_torch.scripts.profile_connectivity \\
        [--batch 16] [--image-size 352] [--n-segments 500] \\
        [--device cuda|cpu] [--image-dir DIR]

Images: the ``*.jpg`` of ``--image-dir``, else the bench's seeded noise
(which fragments SLIC far more than real scenes do, and so inflates the
sweeps and the merge rounds). Prints the JAX script's lines, then one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.bench import image_paths, load_images, pull
from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.core.profiling import device_profile
from camouflage_multimodal_tpu_torch.ops.connectivity import (
    _run_ids, _seg_min_scan, connected_components, enforce_label_connectivity)
from camouflage_multimodal_tpu_torch.ops.slic import slic
from camouflage_multimodal_tpu_torch.pipeline import padded_nodes

ITERS = 6                  # timed calls per half, as the JAX script
BUSY_CALLS = 3             # calls under the profiler per half
TOP_KERNELS = 5


def timed(fn: Callable, raw: torch.Tensor, name: str, batch: int) -> float:
    """Median ms of ``ITERS`` calls of ``fn(raw)``, each ending in a pull
    (one warm-up call first); prints the JAX script's line."""
    pull(fn(raw))
    ts = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        pull(fn(raw))
        ts.append(time.perf_counter() - t0)
    ms = float(np.median(ts)) * 1000.0
    print(f"{name:34s} {ms:8.2f} ms/batch  {ms / batch:6.2f} ms/img", flush=True)
    return ms


def cc_sweeps(labels: torch.Tensor) -> torch.Tensor:
    """(B,) int64: each image's sweeps of the ``connected_components`` loop
    up to and including the first that leaves it unchanged (a host test
    every sweep)."""
    B, H, W = labels.shape
    HW = H * W
    comp = torch.arange(HW, device=labels.device).reshape(1, H, W).expand(B, H, W)
    s_cols = _run_ids(labels, 2)
    s_rows = _run_ids(labels, 1)
    n = torch.zeros(B, dtype=torch.long, device=labels.device)
    active = torch.ones(B, dtype=torch.bool, device=labels.device)
    while bool(active.any()):
        new = _seg_min_scan(comp, s_cols, 2, HW)
        new = _seg_min_scan(new, s_rows, 1, HW)
        n += active
        active &= (new != comp).flatten(1).any(1)
        comp = new
    return n


def busy_and_top(fn: Callable) -> Dict:
    """Device-busy ms a call and the five longest device kernels (ms a call)."""
    prof = device_profile(fn, BUSY_CALLS)
    if prof is None:
        return {"device_busy_ms": "not measured", "top_kernels": "not measured"}
    busy, by_name = prof
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {"device_busy_ms": round(busy, 4),
            "top_kernels": [{"kernel": k[:80], "ms": round(v, 4)} for k, v in top]}


@torch.inference_mode()
def profile(batch: int = 16, image_size: int = 352, n_segments: int = 500,
            device: str = "cuda", image_dir: Optional[str] = None) -> Dict:
    dev = resolve_device(device)
    imgs = torch.from_numpy(load_images(image_paths(image_dir, batch), batch,
                                        image_size)).to(dev)
    raw = slic(imgs, n_segments=n_segments, backend="exact", enforce_connectivity=False)
    pull(raw)
    print("raw labels ready", tuple(raw.shape), raw.dtype, flush=True)
    K = padded_nodes(n_segments, image_size)

    def full(labels):
        return enforce_label_connectivity(labels, n_segments, max_labels=K)

    m_cc = timed(connected_components, raw, "connected_components", batch)
    m_full = timed(full, raw, "enforce_label_connectivity", batch)
    m_merge = m_full - m_cc
    print(f"{'merge+relabel (diff)':34s} {m_merge:8.2f} ms/batch  "
          f"{m_merge / batch:6.2f} ms/img", flush=True)
    sweeps = cc_sweeps(raw).cpu().numpy()
    print("CC sweeps per image:", sweeps, flush=True)
    out = {"cc_ms": round(m_cc, 4), "full_ms": round(m_full, 4),
           "merge_relabel_ms": round(m_merge, 4),
           "cc_sweeps_per_image": [int(s) for s in sweeps]}
    if dev.type == "cuda":
        out["device"] = {"connected_components": busy_and_top(lambda: connected_components(raw)),
                         "enforce_label_connectivity": busy_and_top(lambda: full(raw))}
        for half, rec in out["device"].items():
            print(f"{half:34s} device busy {rec['device_busy_ms']} ms/batch", flush=True)
    else:
        out["device"] = "not measured"
    out["_config"] = {"batch": batch, "image_size": image_size, "n_segments": n_segments,
                      "max_labels": K, "iters": ITERS, "backend": dev.type,
                      "device_name": (torch.cuda.get_device_name(dev)
                                      if dev.type == "cuda" else "cpu"),
                      "images": image_dir if image_paths(image_dir, 1) else "seeded"}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image-size", type=int, default=352)
    ap.add_argument("--n-segments", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image-dir", default=None)
    args = ap.parse_args(argv)
    out = profile(args.batch, args.image_size, args.n_segments, args.device, args.image_dir)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
