#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--batches N] [--profile TRACE_JSON]

Phases, each failing the run (nonzero exit, no result line) when it fails:

1. build every CUDA kernel of ``camouflage_multimodal_tpu_torch/csrc`` with
   nvcc (one process per source, all started together);
2. kernel B1 ``slic_assign`` against its plain PyTorch version at the main
   path's shapes (4 images of 256², K = 529 centers, step 11), on the seed
   centers, on centers from a real SLIC state and on jittered centers:
   labels must be equal (both compute the same float32 operations in the
   same order, so there are no ties to excuse);
3. kernel B2 ``fused_mha`` against its plain version with the committed
   fusion weights in both directions of the main path (4 × 640 queries ×
   13 keys and 4 × 13 queries × 640 keys, partial key masks): out within
   rtol/atol 1e-4, probabilities within rtol 1e-3 / atol 2e-3;
4. the main path: ``MultimodalPredictor`` built from the three committed
   artifacts answers ``--batches`` batches of 4 seeded uint8 images at
   256². Launch counters are zeroed just before and read just after: B1
   must have launched 10 times and B2 twice per batch. Outputs must be
   finite and the first image must agree with the CPU port (segment maps
   ≥ 99 % equal, heatmap MAE ≤ 1e-2);
5. timings after ``torch.cuda.synchronize()`` with CUDA events: each kernel,
   its plain version, ``torch.nn.functional.multi_head_attention_forward``
   as B2's library yardstick (the port never calls it), and the slice's
   ms per batch and images per second. ``--profile`` adds a
   ``torch.profiler`` breakdown of one batch and writes its Chrome trace
   to the path given.

Prints JSON lines per phase, then the card's name and power limit, the
kernel table line, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. TF32 is disabled for
matmuls and cuDNN: every reference number is float32.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS = ("artifacts/checkpoints_balanced/multimodal_best_fixed.ckpt",
             "artifacts/rg_model.ckpt",
             "artifacts/kg_embeddings/all_embeddings.npz")
BATCH = 4
SIZE = 256
SLIC_ITERS = 10
# Published peaks of one H100 SXM (NVIDIA data sheet): float32 on the CUDA
# cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def synthetic_images(seed: int, n: int, size: int):
    """(n, size, size, 3) uint8: smooth colour blobs + a sine texture + noise
    (the generator of tests/test_torch_port_*.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(n):
        img = np.zeros((size, size, 3)) + 0.5 * rng.random(3)
        for _ in range(6):
            cy, cx = rng.random(2)
            r = 0.05 + 0.2 * rng.random()
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
            img += blob[..., None] * (rng.random(3) - 0.3)
        f = rng.uniform(4, 20, 2)
        img += 0.08 * np.sin(2 * np.pi * (f[0] * yy + f[1] * xx))[..., None] * rng.random(3)
        img += 0.04 * rng.standard_normal(img.shape)
        out.append(np.clip(img, 0, 1))
    return (np.stack(out) * 255).round().astype(np.uint8)


def cuda_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean device time of ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / reps)
    per.sort()
    return per[len(per) // 2]


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build(kernels):
    t0 = time.perf_counter()
    reports = kernels.build_all()
    for name in kernels.KERNELS:
        kernels.library(name)
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in reports.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": ptxas})


def slic_state(torch, slic_mod, images_u8, iters: int):
    """Pixel features and the center/label state after ``iters`` plain
    assign + update rounds (a real SLIC state)."""
    imgs = torch.from_numpy(images_u8).cuda().float() / 255.0
    pix, centers, step, ratio = slic_mod.slic_features(imgs, 500)
    labels = torch.zeros(pix.shape[:2], dtype=torch.int32, device=pix.device)
    for _ in range(iters):
        labels = slic_mod.slic_assign_plain(pix, centers, labels, ratio, step)
        centers = slic_mod.update_centers(pix, labels, centers)
    return pix, centers, labels, step, ratio


def in_box_pairs(torch, pix, centers, step) -> int:
    """Pixel-center pairs inside the ±step box: the distances the
    assignment needs for these inputs."""
    fy = torch.floor(centers[..., 3])[:, None, :]
    fx = torch.floor(centers[..., 4])[:, None, :]
    total = 0
    for s in range(0, pix.shape[1], 4096):
        p = pix[:, s:s + 4096, None, :]
        ok = (torch.abs(p[..., 3] - fy) <= step) & (torch.abs(p[..., 4] - fx) <= step)
        total += int(ok.sum())
    return total


def phase_slic_assign(torch, slic_mod, images_u8):
    pix, c0, _, step, ratio = slic_state(torch, slic_mod, images_u8, 0)
    _, c5, prev5, _, _ = slic_state(torch, slic_mod, images_u8, 5)
    g = torch.Generator(device="cuda").manual_seed(0)
    jitter = c5.clone()
    jitter[..., 3:] += (torch.rand(c5[..., 3:].shape, generator=g, device="cuda") - 0.5) * 2 * step
    zeros = torch.zeros_like(prev5)
    K = c0.shape[1]
    gh, gw = slic_mod.grid_shape(500, SIZE, SIZE)
    if pix.shape != (BATCH, SIZE * SIZE, 5) or K != gh * gw or step != 11:
        fail(f"B1 shapes {tuple(pix.shape)}, K={K}, step={step} are not the main path's")
    worst = 0
    for name, centers, prev in (("seed", c0, zeros), ("iter5", c5, prev5),
                                ("jitter", jitter, prev5)):
        got = slic_mod.slic_assign(pix, centers.contiguous(), prev, ratio, step)
        torch.cuda.synchronize()
        want = slic_mod.slic_assign_plain(pix, centers, prev, ratio, step)
        bad = int((got != want).sum())
        worst = max(worst, int((got - want).abs().max()))
        emit({"phase": "slic_assign_check", "centers": name, "mismatched_labels": bad,
              "pixels": int(got.numel())})
        if bad:
            fail(f"B1 disagrees with its plain version on {bad} labels ({name})")
    return {"pix": pix, "centers": c5, "prev": prev5, "step": step, "ratio": ratio,
            "max_abs_err": worst}


def mha_inputs(torch, fusion_model, nq, nk, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    E = 256
    q = torch.relu(torch.randn(BATCH, nq, E, generator=g, device="cuda"))
    k = torch.randn(BATCH, nk, E, generator=g, device="cuda") * 0.5
    lens = torch.tensor([nk, nk - 3, max(1, nk // 2), max(1, nk - 100)], device="cuda")
    mask = torch.arange(nk, device="cuda")[None] < lens[:, None]
    attn = (fusion_model.fusion.cross_attn_rg2kg if nq > nk
            else fusion_model.fusion.cross_attn_kg2rg)
    from camouflage_multimodal_tpu_torch.ops.attention import PARAM_NAMES

    params = {n: getattr(attn, n).detach() for n in PARAM_NAMES}
    return params, q, k, mask


def phase_fused_mha(torch, attention_mod, fusion_model):
    worst_out = worst_p = 0.0
    cases = {}
    for name, nq, nk in (("rg2kg", 640, 13), ("kg2rg", 13, 640)):
        params, q, k, mask = mha_inputs(torch, fusion_model, nq, nk, seed=nq)
        got_out, got_p = attention_mod.fused_mha(params, q, k, k, 8, mask)
        torch.cuda.synchronize()
        want_out, want_p = attention_mod.multihead_attention(params, q, k, k, 8, mask)
        e_out = float((got_out - want_out).abs().max())
        e_p = float((got_p - want_p).abs().max())
        ok = (torch.allclose(got_out, want_out, rtol=1e-4, atol=1e-4)
              and torch.allclose(got_p, want_p, rtol=1e-3, atol=2e-3)
              and bool(torch.isfinite(got_out).all()))
        emit({"phase": "fused_mha_check", "direction": name, "nq": nq, "nk": nk,
              "max_abs_err_out": e_out, "max_abs_err_probs": e_p, "ok": ok})
        if not ok:
            fail(f"B2 disagrees with its plain version ({name})")
        worst_out, worst_p = max(worst_out, e_out), max(worst_p, e_p)
        cases[name] = (params, q, k, mask)
    return cases, max(worst_out, worst_p)


def phase_slice(torch, np, kernels, api, n_batches):
    """Drive the main path; returns (predictor, batches, main-path launches)."""
    predictor = api.MultimodalPredictor(*ARTIFACTS, device="cuda")
    batches = [synthetic_images(100 + i, BATCH, SIZE) for i in range(n_batches)]
    predictor.predict_batch(batches[0])                 # warm-up
    torch.cuda.synchronize()

    kernels.reset_launches()
    outs = [predictor.predict_batch(b) for b in batches]
    launches = dict(kernels.LAUNCHES)

    want = {"slic_assign": SLIC_ITERS * n_batches, "fused_mha": 2 * n_batches}
    emit({"phase": "slice", "batches": n_batches, "batch": BATCH, "size": SIZE,
          "launches": launches, "expected_launches": want,
          "window_drift": [float(x) for o in outs for x in o["window_drift"]],
          "nodes": [int(x) for o in outs for x in o["node_mask"].sum(-1)],
          "score": [float(x) for o in outs for x in o["score"][:, 0]]})
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times on the main path, expected {n}")
    for o in outs:
        for key in ("heatmap", "mask_prob", "instance_prob", "edge_prob", "score"):
            if not np.isfinite(o[key]).all():
                fail(f"non-finite {key}")
        if o["segments"].shape != (BATCH, SIZE, SIZE) or o["attention"]["rg2kg"].shape != (BATCH, 640, 13):
            fail("unexpected output shapes")

    cpu = api.MultimodalPredictor(*ARTIFACTS, device="cpu").predict_batch(batches[0][:1])
    gpu = outs[0]
    seg_eq = float((cpu["segments"][0] == gpu["segments"][0]).mean())
    heat_mae = float(np.abs(cpu["heatmap"][0] - gpu["heatmap"][0]).mean())
    diffs = {k: float(np.abs(cpu[k][0] - gpu[k][0]).max())
             for k in ("mask_logits", "instance_logits", "edge_logits", "score")}
    emit({"phase": "slice_vs_cpu", "segments_equal": seg_eq, "heatmap_mae": heat_mae,
          "max_abs_diff": diffs})
    if seg_eq < 0.99 or heat_mae > 1e-2:
        fail(f"GPU slice disagrees with the CPU port: segments {seg_eq}, heatmap MAE {heat_mae}")
    return predictor, batches, launches


def phase_times(torch, slic_mod, attention_mod, b1, b2_cases, predictor, batches, trace):
    F = torch.nn.functional
    pix, centers, prev = b1["pix"], b1["centers"].contiguous(), b1["prev"]
    step, ratio = b1["step"], b1["ratio"]
    B, HW, _ = pix.shape
    K = centers.shape[1]
    b1_ms = cuda_ms(lambda: slic_mod.slic_assign(pix, centers, prev, ratio, step))
    b1_plain = cuda_ms(lambda: slic_mod.slic_assign_plain(pix, centers, prev, ratio, step),
                       reps=3, rounds=3)
    pairs = in_box_pairs(torch, pix, centers, step)
    b1_bound = bound_ms(B * HW * (5 * 4 + 4 + 4) + B * K * 5 * 4, pairs * 16)

    b2 = {}
    for name, (params, q, k, mask) in b2_cases.items():
        E = q.shape[-1]
        w_in = torch.cat([params["wq"].T, params["wk"].T, params["wv"].T]).contiguous()
        b_in = torch.cat([params["bq"], params["bk"], params["bv"]])
        w_out = params["wo"].T.contiguous()
        qt, kt = q.transpose(0, 1), k.transpose(0, 1)

        def library():
            return F.multi_head_attention_forward(
                qt, kt, kt, E, 8, w_in, b_in, None, None, False, 0.0, w_out,
                params["bo"], training=False, key_padding_mask=~mask,
                need_weights=True, average_attn_weights=True)

        lib_out, lib_p = library()
        ref_out, ref_p = attention_mod.multihead_attention(params, q, k, k, 8, mask)
        Bq, Nq, _ = q.shape
        Nk = k.shape[1]
        flops = Bq * (2 * Nq * E * E + 4 * Nk * E * E + 2 * Nq * E * E
                      + 4 * Nq * Nk * E) + Bq * 8 * Nq * Nk * 5
        nbytes = 4 * (Bq * Nq * E + 2 * Bq * Nk * E + 4 * E * E + 4 * E
                      + Bq * Nq * E + Bq * Nq * Nk) + Bq * Nk
        b2[name] = {
            "ms": cuda_ms(lambda: attention_mod.fused_mha(params, q, k, k, 8, mask)),
            "plain_ms": cuda_ms(lambda: attention_mod.multihead_attention(params, q, k, k, 8, mask)),
            "library_ms": cuda_ms(library),
            "library_max_abs_err_out": float((lib_out.transpose(0, 1) - ref_out).abs().max()),
            "library_max_abs_err_probs": float((lib_p - ref_p).abs().max()),
            "flops": flops, "bytes": nbytes,
        }
        emit({"phase": "fused_mha_time", "direction": name, **b2[name]})
    b2_bound = bound_ms(sum(v["bytes"] for v in b2.values()),
                        sum(v["flops"] for v in b2.values()))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        predictor.predict_batch(b)
    slice_s = (time.perf_counter() - t0) / len(batches)
    emit({"phase": "slice_time", "ms_per_batch": slice_s * 1e3,
          "images_per_second": BATCH / slice_s, "batch": BATCH, "size": SIZE,
          "slic_assign_ms": b1_ms, "slic_assign_plain_ms": b1_plain,
          "slic_assign_in_box_pairs": pairs})
    if trace:
        phase_profile(torch, predictor, batches[0], trace)
    return (b1_ms, b1_plain, b1_bound, pairs), (b2, b2_bound)


def busy_us(spans, lo=float("-inf"), hi=float("inf")) -> float:
    """Length of the union of sorted (start, end) intervals, clipped to
    [lo, hi]: overlapping device activity counts once."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if cur_end is None or start > cur_end:
            total += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total + (0.0 if cur_end is None else cur_end - cur_start)


def phase_profile(torch, predictor, batch, trace):
    """One batch under ``torch.profiler``: device time by kernel, device busy
    and idle share of the batch's wall time, and each pipeline stage's host
    time, device span and device busy time (the ``cmt::`` ranges of
    pipeline.py)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(trace), exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace)
    # A cmt:: range appears on the host and, as an annotation from the
    # stage's first to its last device activity, on the card's timeline.
    # Every other event on the card is a kernel or a copy.
    events = prof.events()
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in events
                   if ev.device_type == DeviceType.CUDA and not ev.name.startswith("cmt::"))
    by_kernel = {}
    stages = {}
    for ev in events:
        ms = ev.time_range.elapsed_us() / 1e3
        if ev.name.startswith("cmt::"):
            stage = stages.setdefault(ev.name[5:], {})
            if ev.device_type == DeviceType.CUDA:
                stage["device_span_ms"] = ms
                stage["device_busy_ms"] = busy_us(spans, ev.time_range.start,
                                                  ev.time_range.end) / 1e3
            else:
                stage["host_ms"] = ms
        elif ev.device_type == DeviceType.CUDA:
            t, n = by_kernel.get(ev.name, (0.0, 0))
            by_kernel[ev.name] = (t + ms, n + 1)
    busy_ms = busy_us(spans) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    emit({"phase": "profile", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if spans else "not measured",
          "device_idle_share": 1 - busy_ms / wall_ms if spans else "not measured",
          "device_events": len(spans), "stages": stages,
          "top_kernels": [{"kernel": k[:80], "ms": t, "calls": n}
                          for k, (t, n) in top]})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--profile", metavar="TRACE_JSON",
                    help="also profile one batch and write its Chrome trace here")
    args = ap.parse_args()
    trace = os.path.abspath(args.profile) if args.profile else None

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    # Full float32 everywhere: the JAX references are float32 HIGHEST.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    try:
        from camouflage_multimodal_tpu_torch import api
        from camouflage_multimodal_tpu_torch.core import kernels
        from camouflage_multimodal_tpu_torch.ops import attention as attention_mod
        from camouflage_multimodal_tpu_torch.ops import slic as slic_mod
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    for path in ARTIFACTS:
        if not os.path.exists(os.path.join(REPO, path)):
            fail(f"missing artifact {path}")
    os.chdir(REPO)

    phase_build(kernels)
    b1 = phase_slic_assign(torch, slic_mod, synthetic_images(7, BATCH, SIZE))
    fusion_model, _ = api.load_multimodal_model(ARTIFACTS[0], device="cuda")
    b2_cases, b2_err = phase_fused_mha(torch, attention_mod, fusion_model)
    predictor, batches, launches = phase_slice(torch, np, kernels, api, args.batches)
    (b1_ms, b1_plain, b1_bound, _), (b2, b2_bound) = phase_times(
        torch, slic_mod, attention_mod, b1, b2_cases, predictor, batches, trace)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"kernels": [
        {"name": "slic_assign", "route": "cuda",
         "source": "camouflage_multimodal_tpu_torch/csrc/slic_assign.cu",
         "replaces": "camouflage_multimodal_tpu/ops/pallas_slic.py:33",
         "per": "1 launch: one SLIC assignment of 4 images of 256^2 against K=529",
         "launches": launches["slic_assign"], "max_abs_err": b1["max_abs_err"],
         "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound[0],
         "bound_by": b1_bound[1], "library_ms": None},
        {"name": "fused_mha", "route": "cuda",
         "source": "camouflage_multimodal_tpu_torch/csrc/fused_mha.cu",
         "replaces": "camouflage_multimodal_tpu/ops/pallas_attention.py:30",
         "per": "2 launches: rg2kg (4x640 q, 13 k) + kg2rg (4x13 q, 640 k), E=256, 8 heads",
         "launches": launches["fused_mha"], "max_abs_err": b2_err,
         "ms": sum(v["ms"] for v in b2.values()),
         "plain_ms": sum(v["plain_ms"] for v in b2.values()),
         "bound_ms": b2_bound[0], "bound_by": b2_bound[1],
         "library_ms": sum(v["library_ms"] for v in b2.values())},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
