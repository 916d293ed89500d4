"""Host-side ceiling analysis for the bench's end-to-end rate.

Port of the JAX system's ``scripts/host_ceiling.py``. The bench runs
decode ∥ upload ∥ compute as three stages; its end-to-end rate is bounded
by the slowest stage and, where the stages share the host's cores and its
interpreter lock, by the host CPU work they add up to. This script
measures each stage alone at the bench's shapes:

* ``decode_{full,draft}_ms_per_img`` — the native decode + resize of a
  batch (:mod:`native`) as the bench's decode worker runs it, at the
  library's default thread count (``decode_threads``), full and draft
  JPEG decode (wall ms an image of the batch);
* ``transfer_ms_per_img`` — a uint8 batch into a pinned buffer and onto
  the device on the upload stream, ending in that copy's event
  (``transfer_host_cpu_ms_per_img``: the process's CPU time for it);
* ``compute_ms_per_img`` — the bench's device-only loop
  (``bench.device_only_times`` with its warm-up and ``BENCH_ITERS``);
  ``compute_host_cpu_ms_per_img`` the process's CPU time for it: the
  pipeline synchronises with the host inside a batch, so compute is host
  work too;
* ``max_stage_ms_per_img`` (the bound when every stage has a core of its
  own) and ``cpu_sum_ms_per_img`` (decode + the transfer's host CPU time,
  as the JAX script sums it: the bound when those two time-share one core
  with dispatch), with the rates they allow. Add
  ``compute_host_cpu_ms_per_img`` to ``cpu_sum_ms_per_img`` for the bound
  when compute's host work shares that core too.

    BENCH_IMAGE_SIZE=352 BENCH_BATCH=16 python -m \\
        camouflage_multimodal_tpu_torch.scripts.host_ceiling --image-dir DIR \\
        [--device cuda|cpu] [--out PATH]

Needs at least one ``*.jpg`` in ``--image-dir``. Prints one JSON line and
writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from camouflage_multimodal_tpu_torch import native
from camouflage_multimodal_tpu_torch.bench import (
    WARMUP, BenchConfig, Uploader, build_models, cycled, decode_batch_u8,
    device_only_times, image_paths)
from camouflage_multimodal_tpu_torch.core.device import resolve_device

PASSES = 6


def med_of(f: Callable, passes: int = PASSES) -> float:
    ts = []
    for _ in range(passes):
        t0 = time.perf_counter()
        f()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@torch.inference_mode()
def measure(cfg: BenchConfig, device: str, image_dir: str) -> Dict:
    dev = resolve_device(device)
    B, S = cfg.batch, cfg.image_size
    paths = image_paths(image_dir, 2 * B)
    if not paths:
        raise FileNotFoundError(f"no *.jpg in {image_dir!r}: the decode stage needs files")
    paths = cycled(paths, 2 * B)
    pb = [paths[:B], paths[B:]]

    # --- decode stage (the native decoder, as the bench's decode worker) ---
    arrs = [decode_batch_u8(p, S) for p in pb]          # warms the page cache
    dec_full = med_of(lambda: decode_batch_u8(pb[0], S)) / B
    dec_draft = med_of(lambda: decode_batch_u8(pb[0], S, draft=True)) / B

    # --- transfer stage ----------------------------------------------------
    upload = Uploader(dev, arrs[0].shape)
    turn = [0]

    def tx_once():
        _, event = upload(arrs[turn[0] % 2])
        turn[0] += 1
        if event is not None:
            event.synchronize()

    tx_once()
    tx_ms = med_of(tx_once) / B
    t_cpu0, t_wall0 = time.process_time(), time.perf_counter()
    for _ in range(4):
        tx_once()
    tx_cpu_ms = (time.process_time() - t_cpu0) / 4 / B * 1e3
    tx_wall_check = (time.perf_counter() - t_wall0) / 4 / B * 1e3

    # --- compute stage (the bench's device-only loop) -----------------------
    pipe, kg = build_models(cfg, dev)
    dev_batches = [torch.from_numpy(a).to(dev) for a in arrs]
    times, compute_cpu_s = device_only_times(lambda j: pipe(dev_batches[j % 2], kg),
                                             WARMUP, cfg.iters)
    compute_cpu_ms = compute_cpu_s / cfg.iters / B * 1e3
    compute_ms = float(np.median(times)) / B * 1e3

    stages_ms = {"decode_full": dec_full * 1e3, "transfer": tx_ms * 1e3,
                 "compute": compute_ms}
    binding = max(stages_ms, key=stages_ms.get)
    max_stage = max(stages_ms.values())
    cpu_sum = dec_full * 1e3 + tx_cpu_ms      # as the JAX script: excludes dispatch
    return {
        "batch": B, "image_size": S,
        "decode_full_ms_per_img": round(dec_full * 1e3, 3),
        "decode_draft_ms_per_img": round(dec_draft * 1e3, 3),
        "decode_threads": native.default_threads(),
        "transfer_ms_per_img": round(tx_ms * 1e3, 3),
        "transfer_host_cpu_ms_per_img": round(tx_cpu_ms, 3),
        "transfer_wall_check_ms_per_img": round(tx_wall_check, 3),
        "compute_ms_per_img": round(compute_ms, 3),
        "compute_host_cpu_ms_per_img": round(compute_cpu_ms, 3),
        "max_stage_ms_per_img": round(max_stage, 3),
        "cpu_sum_ms_per_img": round(cpu_sum, 3),
        "binding_stage_infinite_cores": binding,
        "ceiling_imgs_per_sec_stage_bound": round(1e3 / max_stage, 2),
        "ceiling_imgs_per_sec_single_core_cpu_bound": round(1e3 / max(cpu_sum, max_stage), 2),
        "host_cores": os.cpu_count(),
        "backend": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image-dir", required=True, help="directory of *.jpg")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = measure(BenchConfig.from_env(), args.device, args.image_dir)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
