#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--batches N] [--profile TRACE_JSON]
    python3 chip_smoke.py --b2-digest
    python3 chip_smoke.py --rg-lr-probe
    python3 chip_smoke.py --build-cost

Five paths of the port are driven: multimodal inference
(``MultimodalPredictor``), fusion training (``FusionTrainer``),
region-graph training (``RGTrainer``), knowledge-graph training with its
embedding factory (``KGTrainer``) and the workflow that joins them
(extraction → matched fusion dataset → fusion epoch, directory evaluation
and directory testing).

Phases, each failing the run (nonzero exit, no result line) when it fails:

1. build every CUDA kernel of ``camouflage_multimodal_tpu_torch/csrc`` with
   nvcc (one process per source, all started together);
2. kernel B1 ``slic_assign`` against its plain PyTorch version at the main
   path's shapes (4 images of 256², K = 529 centers, step 11), on the seed
   centers, on centers from a real SLIC state and on jittered centers, with
   every center collapsed into one pixel tile (the candidate list holds all
   K), with half of the centers pushed off the image, on a ragged 97 × 131
   image at 60 segments and at 352² and 416² with 500 segments: labels must
   be equal (both compute the same float32 operations in the same order, so
   there are no ties to excuse). Prints the mean and the largest length of
   the kernel's per-tile candidate lists;
3. kernel B2 ``fused_mha`` against its plain version with the committed
   fusion weights in both directions of the main path (4 × 640 queries ×
   13 keys and 4 × 13 queries × 640 keys, partial key masks), the same at
   batch 8 as directory testing calls it, at the training shapes (576) and on a ragged case (37 queries × 75 keys, one
   batch row with every key masked): out within rtol/atol 1e-4,
   probabilities within rtol 1e-3 / atol 2e-3, a repeat bit-equal, and
   what it keeps for B3 (projected q, k, v, the context, the split pass's
   softmax max and sum) against plain products;
4. kernel B3 ``fused_mha_bwd``, the gradient of B2, against its plain
   backward through ``torch.autograd`` on the card: the training shapes
   (4 × 576 × 13 and 4 × 13 × 576), the inference ones (640) and a ragged
   case (37 queries × 101 keys), partial key masks plus one batch row with
   every key masked, with a non-zero cotangent for the attention maps and
   once with none. Each of d_q, d_k, d_v and the 8 parameter gradients
   within rtol = atol = 1e-4, all finite; two runs on the same inputs
   bit-equal; one wrapper launch per call, and the number of CUDA kernels
   that call launched; the plain statement of the kernel's algorithm
   (``multihead_attention_backward_tiled``) within the same bar;
5. the inference path: ``MultimodalPredictor`` built from the three committed
   artifacts answers ``--batches`` batches of 4 seeded uint8 images at
   256². Launch counters are zeroed just before and read just after: B1
   must have launched 10 times and B2 twice per batch. Outputs must be
   finite and the first image must agree with the CPU port (segment maps
   ≥ 99 % equal, heatmap MAE ≤ 1e-2);
6. the training path: ``FusionTrainer.fit`` with device-resident epochs on
   64 seeded synthetic records shaped like real ones (380–560 nodes and one
   of 600 that the 576-node bucket truncates, 128-d, the committed KG
   embeddings, separable labels), the full-width model with
   ``dropout = 0, use_pallas = True``, batch 4, 2 epochs. Launch counters
   are zeroed just before and read just after: B2 must have launched twice
   per train and per eval step and B3 twice per train step, exactly. Every
   loss finite, the last epoch's train loss under the first's, the best
   checkpoint written and loaded back by ``api.load_multimodal_model``. The
   same run on the CPU with the same seeds: epoch-0 train loss within 1e-3
   relative, final parameters within 1e-3. A short run at ``dropout = 0.3``
   with on-device augmentation: train steps launch neither kernel, eval
   steps launch B2;
7. region-graph training: ``RGTrainer.fit`` of the full-width model (GAT
   15 → 4 × 128, 3 × GCN 128) from seed-0 weights at dropout 0 on 32 seeded
   synthetic 256² images with blob masks (instance = mask, an edge ring),
   500 segments into the 640-node bucket, 10 SLIC iterations, batch 4, 2
   epochs (25 train samples in 7 steps with the tail window, 7 validation
   samples in 2). First B1 against its plain version at the build's shape
   (the first 16 images, K = 529, seed and fifth-iteration centers): labels
   equal. Launch counters are zeroed just before the fit and read just
   after, and once at the end of the graph build: B1 must have launched 20
   times, all in the build (two build batches of 16), B2 and B3 never.
   Every loss finite; the best checkpoint reloaded by ``api.load_rg_model``
   and a ``RegionGraphPipeline`` on it answering one batch with finite
   heatmaps; the same training again on the card and on the CPU, both from
   the card-built graphs at lr 1e-4: epoch-0 train loss within 1e-3
   relative, final parameters within 3·lr = 3e-4 (the biases ahead of a
   BatchNorm, whose gradient is zero, and the running means within
   2·lr·steps), and the distance of the two runs' trained parameters at
   most 0.05 of how far the CPU's moved from the initial weights (a card
   run that never moved reads 1); one build batch of 4 on both
   devices: segment maps ≥ 99 % equal and node labels equal on every node
   whose pixels agree;
8. knowledge-graph training: seeded synthetic annotations (the 13
   categories of the committed KG embeddings, 40 each) ingested into the
   port's ``CamouflageKnowledgeStore``, ``create_dataset_from_store``, then
   ``KGTrainer.fit`` of the full-width model (3 × GCN 32 → 128, embedding
   128, MLP 128 → 64 → 1) at dropout 0, 64-node bucket, batch 32, 3
   epochs: no kernel launched, every loss finite, the same CPU comparison;
   ``batch_extract_embeddings`` → ``save_kg_embeddings`` →
   ``load_kg_embeddings`` gives 13 finite (1, 128) vectors; the committed
   ``kg_gnn_model.ckpt`` through ``api.load_kg_model`` embeds 8 subgraphs
   on the card within 1e-5 of the CPU port;
9. the workflow, on 32 seeded 256² images written as COD10K-named JPEGs
   over the 13 committed KG categories with object, instance and edge GT
   PNGs (``BlobDataset``'s disc and ring), through the directory walks (PIL
   decode): ``batch_extract_embeddings`` with ``rg_model.ckpt`` at batch 16
   (B1 exactly 20 launches), the store read back by
   ``load_rg_embeddings``, a 4-image subset on the card and the CPU
   (segment maps ≥ 99 % equal, graph embeddings within 1e-2);
   ``EmbeddingMatcher`` on that store and ``all_embeddings.npz`` (every
   organism matched) → ``FusionDataset`` from the GT files → one
   ``FusionTrainer`` epoch at full width (B2 twice per train and eval step,
   B3 twice per train step, finite losses); ``evaluate_directory`` at batch
   16 (B1 20 launches), the metric and curve functions on the card's
   heatmaps within 1e-5 of the same functions on the CPU and the report of
   a 4-image subset within 1e-2 of the CPU's; ``test_image_directory`` at
   batch 8 with the cross-attention and the late checkpoint (first B1
   against its plain version on its first batch of 8, seed and
   fifth-iteration centers: labels equal; then B1 40 launches each, B2 8
   and 0), both ``batch_results.json`` whole; a
   predictor from the reference's ``.pth`` pair answering one batch; two
   card builds of 16 images equal to the bit (segments, features,
   adjacency, edge weights, node embeddings, heatmap). Every step's launch
   counts are zeroed just before it and read just after. Prints extraction
   and evaluation images per second end to end (decode threads included)
   and ms per build of 16. Then 96 more such files are extracted and
   evaluated at batch 16 with the four-stage overlap and with the stages
   run one after another, in turns, and the images per second of each run
   are printed with the serial runs' seconds per stage;
10. timings after ``torch.cuda.synchronize()`` with CUDA events: each kernel
   (B1 at each pixel-tile shape), the host time to enqueue one call, its
   plain version, ``torch.nn.functional.multi_head_attention_forward``
   (and its autograd backward) as B2's and B3's library yardstick (the port
   never calls it), the inference slice's ms per batch and images per
   second, and the ms per train step and steps per second; ms per RG
   graph-build batch of 16, ms per RG train step (batch 4, 640 nodes) and
   per KG train step (batch 32, 64 nodes) with steps per second (the
   seconds per epoch of each trainer are in phases 6-8). ``--profile``
   adds ``torch.profiler`` breakdowns of one inference batch, of three
   fusion, three RG and three KG train steps, of one RG graph-build batch
   and of 20 calls of B1, B2 and B3 (device time of each sub-kernel; B3
   without and with a cotangent for the attention maps) and writes the
   batch's Chrome trace to the path given.

``--b2-digest`` builds B2 alone, runs it on the seven shapes of phase 3 and
prints the SHA-256 of ``out`` and ``probs`` per shape, then stops: copied
into a checkout of another commit and run there, the script shows whether
two versions of the kernel give the same bits.

``--build-cost`` builds the kernels and times only the RG graph build of
16 images and the inference batch of 4 (three rounds of five), then
stops: copied into a checkout of another commit, it compares the two.

``--rg-lr-probe`` runs phase 7's card-vs-CPU comparison alone on five data
seeds, at the recipe's learning rate 1e-3 and at the comparison's 1e-4,
and prints per seed and rate the epoch-0 losses, the distance of the two
runs over how far the CPU's moved, and the entries furthest apart: their
difference, how far each device moved them from the initial weights, and
Adam's moments there on each device; then stops.

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
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS = ("artifacts/checkpoints_balanced/multimodal_best_fixed.ckpt",
             "artifacts/rg_model.ckpt",
             "artifacts/kg_embeddings/all_embeddings.npz")
BATCH = 4
SIZE = 256
SLIC_ITERS = 10
HEADS = 8
TRAIN_NODES = 576          # FusionDataset's default node bucket
TRAIN_RECORDS = 64
TRAIN_EPOCHS = 2
GRAD_NAMES = ("d_q", "d_k", "d_v", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
# (name, batch, queries, keys) of B2's checks: both directions at the
# inference bucket (batch 4, and batch 8 as directory testing calls it) and
# at the training bucket, and a ragged case.
B2_SHAPES = (("rg2kg", BATCH, 640, 13), ("kg2rg", BATCH, 13, 640),
             ("rg2kg_b8", 8, 640, 13), ("kg2rg_b8", 8, 13, 640),
             ("rg2kg_576", BATCH, TRAIN_NODES, 13), ("kg2rg_576", BATCH, 13, TRAIN_NODES),
             ("ragged_37x75", BATCH, 37, 75))
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


def host_ms(fn, reps: int = 50) -> float:
    """Mean host time to enqueue one call (no wait for the card inside the
    window): where it nears ``cuda_ms`` of the same call, the host and not
    the card sets that time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


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


def slic_state(torch, slic_mod, images_u8, iters: int, n_segments: int = 500):
    """Pixel features and the center/label state after ``iters`` plain
    assign + update rounds (a real SLIC state)."""
    imgs = torch.from_numpy(images_u8).cuda().float() / 255.0
    pix, centers, step, ratio = slic_mod.slic_features(imgs, n_segments)
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


def center_cases(torch, centers, step, height, width):
    """Center states that stress B1's per-tile candidate lists: jittered by
    up to a step, all collapsed into one 16 × 16 tile, half pushed off the
    image."""
    g = torch.Generator(device="cuda").manual_seed(0)
    jitter = centers.clone()
    jitter[..., 3:] += (torch.rand(centers[..., 3:].shape, generator=g, device="cuda") - 0.5) * 2 * step
    collapsed = centers.clone()
    collapsed[..., 3] = 20.0 + 9.0 * torch.rand(centers.shape[:2], generator=g, device="cuda")
    collapsed[..., 4] = 36.0 + 9.0 * torch.rand(centers.shape[:2], generator=g, device="cuda")
    off = torch.rand(centers.shape[:2], generator=g, device="cuda") < 0.5
    outside = centers.clone()
    outside[..., 3] = torch.where(off, centers[..., 3] - height - 3.5 * step, centers[..., 3])
    outside[..., 4] = torch.where(~off, centers[..., 4] + width + 0.5 * step, centers[..., 4])
    return {"jitter": jitter, "collapsed": collapsed, "outside": outside}


def list_lengths(slic_mod, centers, step, height, width):
    """Mean and largest length of B1's candidate lists over the pixel tiles."""
    tile = (256 // slic_mod.TILE_WIDTH, slic_mod.TILE_WIDTH)
    n = slic_mod.tile_candidates(centers, step, height, width, tile).sum(-1)
    return {"tile_rows_x_cols": list(tile), "tiles": int(n.numel()),
            "mean": float(n.float().mean()), "max": int(n.max())}


def phase_slic_assign(torch, slic_mod, images_u8):
    pix, c0, _, step, ratio = slic_state(torch, slic_mod, images_u8, 0)
    _, c5, prev5, _, _ = slic_state(torch, slic_mod, images_u8, 5)
    zeros = torch.zeros_like(prev5)
    K = c0.shape[1]
    gh, gw = slic_mod.grid_shape(500, SIZE, SIZE)
    if pix.shape != (BATCH, SIZE * SIZE, 5) or K != gh * gw or step != 11:
        fail(f"B1 shapes {tuple(pix.shape)}, K={K}, step={step} are not the main path's")
    stress = center_cases(torch, c5, step, SIZE, SIZE)
    cases = [("seed", SIZE, SIZE, pix, c0, zeros, step, ratio),
             ("iter5", SIZE, SIZE, pix, c5, prev5, step, ratio)]
    cases += [(name, SIZE, SIZE, pix, c, prev5, step, ratio) for name, c in stress.items()]
    # Other sizes: a ragged image (no side a multiple of any tile) and the
    # two larger resolutions the models are served at.
    for name, h, w, n_segments in (("ragged_97x131", 97, 131, 60), ("352", 352, 352, 500),
                                   ("416", 416, 416, 500)):
        imgs = synthetic_images(7 + h, 2, max(h, w))[:, :h, :w]
        p, c, prev, st, ra = slic_state(torch, slic_mod, imgs, 2, n_segments)
        cases.append((name, h, w, p, center_cases(torch, c, st, h, w)["jitter"], prev, st, ra))
    return {"pix": pix, "centers": c5, "prev": prev5, "step": step, "ratio": ratio,
            "max_abs_err": check_slic_cases(torch, slic_mod, cases)}


def check_slic_cases(torch, slic_mod, cases) -> int:
    """Hold B1 to its plain version, label for label, on each case; fails
    the run on any mismatch. Returns the largest label difference."""
    worst = 0
    for name, h, w, p, centers, prev, st, ra in cases:
        centers = centers.contiguous()
        got = slic_mod.slic_assign(p, centers, prev, ra, st, width=w)
        torch.cuda.synchronize()
        want = slic_mod.slic_assign_plain(p, centers, prev, ra, st)
        bad = int((got != want).sum())
        worst = max(worst, int((got - want).abs().max()))
        emit({"phase": "slic_assign_check", "centers": name, "batch": int(p.shape[0]),
              "height": h, "width": w, "step": st, "k": int(centers.shape[1]),
              "mismatched_labels": bad, "pixels": int(got.numel()),
              "candidate_list": list_lengths(slic_mod, centers, st, h, w)})
        if bad:
            fail(f"B1 disagrees with its plain version on {bad} labels ({name})")
    return worst


def check_slic_batch(torch, slic_mod, images_u8, what: str) -> int:
    """B1 held to its plain version at the shape a path gives it: a batch
    of 256² images against K=529, at the seed and the fifth-iteration
    centers."""
    n = len(images_u8)
    pix, c0, _, step, ratio = slic_state(torch, slic_mod, images_u8, 0)
    _, c5, prev5, _, _ = slic_state(torch, slic_mod, images_u8, 5)
    if pix.shape != (n, SIZE * SIZE, 5) or c0.shape[1] != 529 or step != 11:
        fail(f"B1 shapes {tuple(pix.shape)}, K={c0.shape[1]}, step={step} are not {what}'s")
    return check_slic_cases(torch, slic_mod, [
        (f"{what}_{n}_seed", SIZE, SIZE, pix, c0, torch.zeros_like(prev5), step, ratio),
        (f"{what}_{n}_iter5", SIZE, SIZE, pix, c5, prev5, step, ratio)])


def mha_inputs(torch, fusion_model, nq, nk, seed, batch=BATCH):
    g = torch.Generator(device="cuda").manual_seed(seed)
    E = 256
    q = torch.relu(torch.randn(batch, nq, E, generator=g, device="cuda"))
    k = torch.randn(batch, nk, E, generator=g, device="cuda") * 0.5
    lens = [nk, nk - 3, max(1, nk // 2), max(1, nk - 100)]
    lens = torch.tensor([lens[i % 4] for i in range(batch)], device="cuda")
    mask = torch.arange(nk, device="cuda")[None] < lens[:, None]
    attn = (fusion_model.fusion.cross_attn_rg2kg if nq > nk
            else fusion_model.fusion.cross_attn_kg2rg)
    from camouflage_multimodal_tpu_torch.ops.attention import PARAM_NAMES

    params = {n: getattr(attn, n).detach() for n in PARAM_NAMES}
    return params, q, k, mask


def phase_fused_mha(torch, kernels, attention_mod, fusion_model):
    worst_out = worst_p = 0.0
    cases = {}
    for name, batch, nq, nk in B2_SHAPES:
        params, q, k, mask = mha_inputs(torch, fusion_model, nq, nk, seed=nq + batch - BATCH,
                                        batch=batch)
        if name.startswith("ragged"):
            mask = mask.clone()
            mask[2] = False            # a batch row with every key masked
        before = kernels.LAUNCHES["fused_mha"]
        got_out, got_p = attention_mod.fused_mha(params, q, k, k, 8, mask)
        torch.cuda.synchronize()
        launched = kernels.LAUNCHES["fused_mha"] - before
        again_out, again_p = attention_mod.fused_mha(params, q, k, k, 8, mask)
        want_out, want_p = attention_mod.multihead_attention(params, q, k, k, 8, mask)
        e_out = float((got_out - want_out).abs().max())
        e_p = float((got_p - want_p).abs().max())
        repeat = torch.equal(got_out, again_out) and torch.equal(got_p, again_p)
        # What the call keeps for the backward kernel (projected q, k, v and
        # the context), read off the autograd node, against plain products.
        grad_out, _ = attention_mod.fused_mha(params, q.clone().requires_grad_(), k, k, 8, mask)
        repeat = repeat and torch.equal(grad_out.detach(), got_out)
        _, _, v_heads, p_heads, _ = attention_mod._head_probs(params, q, k, k, 8, mask)
        plain_saved = (q @ params["wq"] + params["bq"], k @ params["wk"] + params["bk"],
                       k @ params["wv"] + params["bv"],
                       attention_mod._merge_heads(p_heads @ v_heads))
        names = attention_mod.SAVED_NAMES
        saved = dict(zip(names, grad_out.grad_fn.saved_tensors[-len(names):]))
        e_saved = {n: float((saved[n] - b).abs().max()) for n, b in zip(names, plain_saved)}
        if saved["stats"].numel():      # the split pass: each row's softmax max and sum
            q_heads, k_heads, _, _, _ = attention_mod._head_probs(params, q, k, k, 8, mask)
            logits = torch.where(mask[:, None, None, :], q_heads @ k_heads.transpose(-1, -2),
                                 attention_mod._NEG_INF)
            row_max = logits.amax(-1)
            row_sum = torch.exp(logits - row_max[..., None]).sum(-1)
            stats = saved["stats"].view(*row_max.shape, 2)
            e_saved["stats_max"] = float((stats[..., 0] - row_max).abs().max())
            e_saved["stats_sum_rel"] = float(((stats[..., 1] - row_sum) / row_sum).abs().max())
        ok = (torch.allclose(got_out, want_out, rtol=1e-4, atol=1e-4)
              and torch.allclose(got_p, want_p, rtol=1e-3, atol=2e-3)
              and bool(torch.isfinite(got_out).all()) and bool(torch.isfinite(got_p).all())
              and repeat and launched == 1 and max(e_saved.values()) <= 1e-4)
        emit({"phase": "fused_mha_check", "direction": name, "batch": batch, "nq": nq, "nk": nk,
              "max_abs_err_out": e_out, "max_abs_err_probs": e_p,
              "max_abs_err_saved": e_saved, "bit_equal_repeat": repeat, "launches": launched, "ok": ok})
        if not ok:
            fail(f"B2 disagrees with its plain version ({name})")
        worst_out, worst_p = max(worst_out, e_out), max(worst_p, e_p)
        if name in ("rg2kg", "kg2rg"):
            cases[name] = (params, q, k, mask)
    return cases, max(worst_out, worst_p)


def b2_digest(torch, attention_mod, fusion_model):
    """SHA-256 of B2's ``out`` and ``probs`` on the shapes and inputs of
    ``phase_fused_mha``: equal lines from two checkouts mean equal bits."""
    import hashlib

    for name, batch, nq, nk in B2_SHAPES:
        params, q, k, mask = mha_inputs(torch, fusion_model, nq, nk, seed=nq + batch - BATCH,
                                        batch=batch)
        if name.startswith("ragged"):
            mask = mask.clone()
            mask[2] = False
        out, probs = attention_mod.fused_mha(params, q, k, k, 8, mask)
        torch.cuda.synchronize()
        emit({"b2_digest": name, "batch": batch, "nq": nq, "nk": nk,
              "out": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest(),
              "probs": hashlib.sha256(probs.cpu().numpy().tobytes()).hexdigest()})


def mha_bwd_case(torch, attention_mod, fusion_model, nq, nk):
    """Inputs of one B3 check: ``mha_inputs`` with values of their own, the
    third batch row's keys all masked, leaves that require grad, and seeded
    cotangents for both outputs."""
    params, q, k, mask = mha_inputs(torch, fusion_model, nq, nk, seed=1000 + nq)
    g = torch.Generator(device="cuda").manual_seed(2000 + nq)
    v = torch.randn(k.shape, generator=g, device="cuda") * 0.5
    mask = mask.clone()
    mask[2] = False
    d_out = torch.randn(q.shape, generator=g, device="cuda")
    d_probs = torch.randn(BATCH, nq, nk, generator=g, device="cuda")
    leaves = [t.clone().requires_grad_() for t in
              (q, k, v, *(params[n] for n in attention_mod.PARAM_NAMES))]
    return leaves, mask, d_out, d_probs


def kernel_grads(torch, attention_mod, leaves, mask, d_out, d_probs):
    """The 11 gradients through ``fused_mha`` (B2 forward, B3 backward)."""
    q, k, v, *weights = leaves
    params = dict(zip(attention_mod.PARAM_NAMES, weights))
    out, probs = attention_mod.fused_mha(params, q, k, v, HEADS, mask)
    if d_probs is None:
        return torch.autograd.grad([out], leaves, [d_out])
    return torch.autograd.grad([out, probs], leaves, [d_out, d_probs])


def plain_grads(torch, attention_mod, leaves, mask, d_out, d_probs):
    q, k, v, *weights = (t.detach() for t in leaves)
    params = dict(zip(attention_mod.PARAM_NAMES, weights))
    d_params, d_q, d_k, d_v = attention_mod.multihead_attention_backward(
        params, q, k, v, HEADS, mask, d_out, d_probs)
    return (d_q, d_k, d_v, *(d_params[n] for n in attention_mod.PARAM_NAMES))


def phase_fused_mha_bwd(torch, kernels, attention_mod, fusion_model):
    worst = 0.0
    cases = {}
    for name, nq, nk in (("rg2kg", TRAIN_NODES, 13), ("kg2rg", 13, TRAIN_NODES),
                         ("rg2kg_640", 640, 13), ("kg2rg_640", 13, 640),
                         ("ragged_37x101", 37, 101)):
        leaves, mask, d_out, d_probs = mha_bwd_case(torch, attention_mod, fusion_model, nq, nk)
        for with_probs in (True, False):
            dp = d_probs if with_probs else None
            before = kernels.LAUNCHES["fused_mha_bwd"]
            on_card = kernels.device_launches("fused_mha_bwd")
            got = kernel_grads(torch, attention_mod, leaves, mask, d_out, dp)
            torch.cuda.synchronize()
            launched = kernels.LAUNCHES["fused_mha_bwd"] - before
            kernel_launches = kernels.device_launches("fused_mha_bwd") - on_card
            again = kernel_grads(torch, attention_mod, leaves, mask, d_out, dp)
            want = plain_grads(torch, attention_mod, leaves, mask, d_out, dp)
            errs = {n: float((a - b).abs().max()) for n, a, b in zip(GRAD_NAMES, got, want)}
            close = all(torch.allclose(a, b, rtol=1e-4, atol=1e-4) for a, b in zip(got, want))
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            # The kernel's algorithm stated in plain PyTorch, on the same inputs.
            q, k, v, *weights = (t.detach() for t in leaves)
            d_params, *d_inputs = attention_mod.multihead_attention_backward_tiled(
                dict(zip(attention_mod.PARAM_NAMES, weights)), q, k, v, HEADS, mask, d_out, dp)
            tiled = (*d_inputs, *(d_params[n] for n in attention_mod.PARAM_NAMES))
            tiled_close = all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                              for a, b in zip(tiled, want))
            ok = (close and finite and repeat and launched == 1 and tiled_close
                  and 0 < kernel_launches < 7)
            emit({"phase": "fused_mha_bwd_check", "direction": name, "nq": nq, "nk": nk,
                  "d_probs": with_probs, "max_abs_err": errs, "within_1e-4": close,
                  "finite": finite, "bit_equal_repeat": repeat, "launches": launched,
                  "kernel_launches_per_call": kernel_launches,
                  "plain_tiled_within_1e-4": tiled_close, "ok": ok})
            if not ok:
                fail(f"B3 fails its check ({name}, d_probs={with_probs})")
            worst = max(worst, *errs.values())
        cases[name] = (leaves, mask, d_out, d_probs)
    return cases, worst


def train_records(np, seed: int = 11):
    """Seeded records shaped like extracted ones: 380–560 nodes of 128 dims
    (one of 600, which the 576-node bucket truncates), the committed KG
    embeddings, and labels a linear probe separates."""
    rng = np.random.default_rng(seed)
    with np.load(ARTIFACTS[2]) as z:
        kg = np.stack([z[k].reshape(-1) for k in sorted(z.files)]).astype(np.float32)
    counts = rng.integers(380, 561, TRAIN_RECORDS)
    counts[5] = 600
    records = []
    for i, n in enumerate(counts):
        label = i % 2
        base = np.full((int(n), 128), 2.0 * label - 1.0, np.float32)
        records.append({
            "image_name": f"synthetic{i}.jpg",
            "rg_node_embeddings": base + rng.standard_normal((int(n), 128)).astype(np.float32) * 0.1,
            "kg_embeddings": kg, "label": label, "confidence": 1.0,
            "edge_label": float(label), "score_label": float(label)})
    return records


def fit_fusion(train_mod, records, device, dropout, epochs, out_dir=None, augment=False):
    """(trainer, model, history, wall seconds of each epoch) of one
    device-resident ``FusionTrainer.fit``."""
    ds = train_mod.FusionDataset.from_samples(records, augment=augment,
                                              log_fn=lambda *_: None)
    trainer = train_mod.FusionTrainer(model_config={"dropout": dropout, "use_pallas": True})
    stamps = [time.perf_counter()]
    model, history = trainer.fit(ds, epochs=epochs, batch_size=BATCH, seed=0,
                                 checkpoint_dir=out_dir, device_resident=True,
                                 device=device,
                                 log_fn=lambda *_: stamps.append(time.perf_counter()))
    return trainer, ds, model, history, [b - a for a, b in zip(stamps, stamps[1:])]


def phase_train_slice(torch, np, kernels, api, train_mod, out_dir):
    """Drive the training path; returns (trainer, dataset, its launches)."""
    records = train_records(np)
    n_train = int(0.8 * TRAIN_RECORDS)
    train_steps = max(n_train // BATCH, 1)
    eval_steps = max((TRAIN_RECORDS - n_train) // BATCH, 1)

    kernels.reset_launches()
    trainer, ds, model, history, epoch_s = fit_fusion(
        train_mod, records, "cuda", 0.0, TRAIN_EPOCHS, out_dir)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {"slic_assign": 0,
            "fused_mha": 2 * (train_steps + eval_steps) * TRAIN_EPOCHS,
            "fused_mha_bwd": 2 * train_steps * TRAIN_EPOCHS}
    emit({"phase": "train_slice", "records": TRAIN_RECORDS, "batch": BATCH,
          "epochs": TRAIN_EPOCHS, "train_steps_per_epoch": train_steps,
          "eval_steps_per_epoch": eval_steps, "bucket": ds.max_rg_nodes,
          "truncated_nodes": ds.truncated_nodes, "launches": launches,
          "expected_launches": want, "epoch_seconds": epoch_s, "history": history})
    if launches != want:
        fail(f"training launched {launches}, expected {want}")
    losses = history["train_loss"] + history["val_loss"]
    if len(history["train_loss"]) != TRAIN_EPOCHS or not np.isfinite(losses).all():
        fail(f"training losses are not finite: {losses}")
    if not history["train_loss"][-1] < history["train_loss"][0]:
        fail(f"train loss did not fall: {history['train_loss']}")
    if ds.max_rg_nodes != TRAIN_NODES or ds.truncated_nodes == 0:
        fail("the 600-node record did not go through the truncation path")

    ckpt = os.path.join(out_dir, "multimodal_best_fixed.ckpt")
    if not os.path.exists(ckpt):
        fail("no best checkpoint was written")
    loaded, config = api.load_multimodal_model(ckpt, device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in ds.collate([0, 1, 2, 3]).items()}
    with torch.no_grad():
        out = loaded(batch["rg"], batch["kg"], rg_mask=batch["rg_mask"])
    preds = out["mask_logits"].argmax(-1).cpu().numpy()
    emit({"phase": "train_checkpoint", "config": config, "predictions": preds.tolist(),
          "labels": batch["y"].cpu().numpy().tolist()})
    if out["mask_logits"].shape != (4, 2) or not bool(torch.isfinite(out["mask_logits"]).all()):
        fail("the reloaded checkpoint does not predict")

    _, _, cpu_model, cpu_history, cpu_epoch_s = fit_fusion(
        train_mod, records, "cpu", 0.0, TRAIN_EPOCHS)
    rel = abs(history["train_loss"][0] - cpu_history["train_loss"][0]) / abs(cpu_history["train_loss"][0])
    cpu_sd = cpu_model.state_dict()
    param_diff = max(float((v.cpu() - cpu_sd[k]).abs().max())
                     for k, v in model.state_dict().items())
    emit({"phase": "train_vs_cpu", "epoch0_train_loss_rel_diff": rel,
          "final_param_max_abs_diff": param_diff, "cpu_history": cpu_history,
          "cpu_epoch_seconds": cpu_epoch_s})
    if rel > 1e-3 or param_diff > 1e-3:
        fail(f"GPU training disagrees with the CPU port: loss {rel}, parameters {param_diff}")

    kernels.reset_launches()
    _, _, _, drop_history, _ = fit_fusion(train_mod, records, "cuda", 0.3, 1, augment=True)
    drop_launches = dict(kernels.LAUNCHES)
    drop_want = {"slic_assign": 0, "fused_mha": 2 * eval_steps, "fused_mha_bwd": 0}
    emit({"phase": "train_dropout", "dropout": 0.3, "augment": True,
          "launches": drop_launches, "expected_launches": drop_want,
          "history": drop_history})
    if drop_launches != drop_want:
        fail(f"dropout training launched {drop_launches}, expected {drop_want}")
    if not np.isfinite(drop_history["train_loss"] + drop_history["val_loss"]).all():
        fail("dropout training losses are not finite")
    return trainer, ds, launches


# ---------------------------------------------------------------------------
# Region-graph and knowledge-graph training
# ---------------------------------------------------------------------------

RG_IMAGES = 32             # two graph-build batches of 16
RG_EPOCHS = 2
RG_COMPARE_LR = 1e-4
# Adam's first step is lr·sign(g): an entry whose early gradient is near
# zero can step lr one way on the card and the other way on the CPU and
# keep that 2·lr offset (``--rg-lr-probe`` reads 1.95e-4 on data seed 23).
# Entries are held to 3·lr, where a run that never moved reads about
# lr · 14 steps; the distance of the two runs over how far the CPU's moved
# (RG_MOVED_BAR) tells such a run apart at any lr: it reads 1.
RG_PARAM_BAR = 3 * RG_COMPARE_LR
RG_MOVED_BAR = 0.05
KG_PER_CATEGORY = 40
KG_EPOCHS = 3
KG_BATCH = 32
KG_NODES = 64
# Biases ahead of a BatchNorm have an exact gradient of zero in train mode:
# float32 rounding leaves ~1e-8 there, which Adam turns into steps of about
# lr in unrelated directions on each device. They and the running means
# that follow them are held to 2·lr·steps; every other parameter to 1e-3
# (RG_PARAM_BAR for RG).
RG_GRADIENT_FREE = ("conv1.bias", "convs.0.bias", "convs.1.bias", "convs.2.bias")
KG_GRADIENT_FREE = ("convs.0.bias", "convs.1.bias", "convs.2.bias")


class BlobDataset:
    """Seeded stand-in for ``CODDataset`` at full size: the smooth synthetic
    images with one object disc painted in (its own colour and texture),
    the disc as mask and instance map and a ring around it as edge map,
    uint8 like decoded files."""

    def __init__(self, np, n: int, size: int = SIZE, seed: int = 21) -> None:
        rng = np.random.default_rng(seed)
        images = synthetic_images(seed, n, size)
        yy, xx = np.mgrid[0:size, 0:size]
        self.items = []
        for img in images:
            cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
            r = rng.uniform(0.12, 0.25) * size
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            mask = d2 < r * r
            colour = rng.integers(40, 216, 3)
            stripes = (np.sin(xx / rng.uniform(3, 9)) > 0)[..., None] * 25
            img = np.where(mask[..., None], np.clip(colour + stripes + rng.integers(-12, 13, img.shape),
                                                    0, 255), img).astype(np.uint8)
            ring = (d2 >= (r - 2) ** 2) & (d2 < (r + 2) ** 2)
            self.items.append((img, (mask * 255).astype(np.uint8), (ring * 255).astype(np.uint8)))
        self.np = np

    def __len__(self) -> int:
        return len(self.items)

    def load_batch(self, indices):
        np = self.np
        return {"image": np.stack([self.items[i][0] for i in indices]),
                "mask": np.stack([self.items[i][1] for i in indices]),
                "instance": np.stack([self.items[i][1] for i in indices]),
                "edge": np.stack([self.items[i][2] for i in indices])}


def synthetic_annotations(np, categories, per_category: int, seed: int = 31):
    """(file name, annotation JSON) pairs in the schema of the reference's
    annotation files; vocabulary colours and textures so that colour and
    texture nodes appear, organisms repeated across files."""
    colours = ("green", "brown", "sandy brown", "olive green", "gray", "blue-grey", "white",
               "dark green", "beige", "orange", "black", "red", "yellow")
    textures = ("rough", "smooth", "scaly", "gravel", "rocky", "vegetation", "coral",
                "root-like", "bumpy", "fuzzy", "soft")
    places = ("an underwater coral reef", "a sandy seabed", "a forest floor of dark leaves",
              "desert rocks in shadow", "open grassland", "murky blue water", "a tree trunk")
    patterns = ("Disruptive pattern", "spotted", "striped", "uniform", "mottled", "None")
    levels = ("high", "medium", "low", "very high", "very low")
    rng = np.random.default_rng(seed)
    out = []
    for cat in categories:
        for i in range(per_category):
            c, t, b = (rng.choice(colours, 2, replace=False), rng.choice(textures, 2, replace=False),
                       rng.choice(colours, 2, replace=False))
            out.append((f"{cat.lower()}_{i:03d}.json", {
                "object_name": f"{cat}{int(rng.integers(0, 8))}", "object_category": cat,
                "background_description": f"{rng.choice(places)} with {b[0]} and {b[1]} patches",
                "explanation": f"Its {c[0]} and {c[1]} body has a {t[0]}, {t[1]} surface",
                "camouflage_type": str(rng.choice(patterns)),
                "camouflage_presence": "Camouflage" if rng.random() < 0.7 else "None",
                "color_similarity": str(rng.choice(levels)),
                "texture_similarity": str(rng.choice(levels)),
                "contrast_difference": str(rng.choice(levels)),
                "camouflage_score": float(np.round(rng.random(), 3)),
                "confidence": float(np.round(0.5 + 0.5 * rng.random(), 3))}))
    return out


def trained_keys(model):
    """Names of the RG parameters that have a gradient."""
    return [k for k, _ in model.named_parameters() if k not in RG_GRADIENT_FREE]


def param_diffs(torch, a_sd, b_sd, gradient_free, drift, bar=1e-3):
    """(largest difference of the parameters held to ``bar``, of those held
    to ``drift``, per-key differences, ok) of two state dicts."""
    diffs = {k: float((v.cpu() - b_sd[k].cpu()).abs().max()) for k, v in a_sd.items()}
    loose = {k for k in diffs if k in gradient_free or k.endswith("running_mean")}
    tight_max = max(v for k, v in diffs.items() if k not in loose)
    loose_max = max(v for k, v in diffs.items() if k in loose)
    return tight_max, loose_max, diffs, tight_max <= bar and loose_max <= drift


def rg_model(torch, model_mod):
    """The full-width RG model from seed-0 weights at dropout 0."""
    model = model_mod.RegionGraphGNN(dropout=0.0, head_dropout=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def moved_ratio(torch, model_mod, a_sd, b_sd, keys) -> float:
    """‖a − b‖ / ‖b − initial weights‖ over ``keys``: 0 for two equal runs,
    1 for a run ``a`` that never moved."""
    init = rg_model(torch, model_mod).state_dict()
    num = sum(float(((a_sd[k].cpu() - b_sd[k].cpu()) ** 2).sum()) for k in keys)
    den = sum(float(((b_sd[k].cpu() - init[k]) ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def fit_rg(torch, train_rg, model_mod, ds, device, out=None, cached=None, lr=1e-3):
    """(trainer, history, build launches, build seconds, epoch seconds) of
    one ``RGTrainer.fit`` of ``rg_model``. ``cached`` replaces the graph
    build with given graphs."""
    from camouflage_multimodal_tpu_torch.core import kernels

    trainer = train_rg.RGTrainer(model=rg_model(torch, model_mod), learning_rate=lr)
    build = trainer.build_cached_dataset
    seen = {}

    def timed_build(*a, **k):
        t0 = time.perf_counter()
        data = cached if cached is not None else build(*a, **k)
        if device == "cuda":
            torch.cuda.synchronize()
        seen.update(launches=dict(kernels.LAUNCHES), seconds=time.perf_counter() - t0,
                    end=time.perf_counter())
        return data

    trainer.build_cached_dataset = timed_build
    stamps = []
    _, history = trainer.fit(ds, epochs=RG_EPOCHS, batch_size=BATCH, seed=0,
                             checkpoint_path=out, device=device,
                             log_fn=lambda *_: stamps.append(time.perf_counter()))
    epochs = [b - a for a, b in zip([seen["end"]] + stamps, stamps)]
    return trainer, history, seen["launches"], seen["seconds"], epochs


def agreeing_nodes(np, seg_a, seg_b, K):
    """(B, K) True where node k covers the same pixels in both maps."""
    B = seg_a.shape[0]
    a, b = seg_a.reshape(B, -1), seg_b.reshape(B, -1)
    out = np.zeros((B, K), bool)
    for i in range(B):
        for k in range(K):
            out[i, k] = np.array_equal(a[i] == k, b[i] == k)
    return out


def phase_train_rg(torch, np, kernels, api, out_dir):
    """Drive RG training; returns (trainer, dataset, its launches)."""
    from camouflage_multimodal_tpu_torch.models import region_graph as model_mod
    from camouflage_multimodal_tpu_torch.ops import slic as slic_mod
    from camouflage_multimodal_tpu_torch.pipeline import RegionGraphPipeline
    from camouflage_multimodal_tpu_torch.train import train_rg

    ds = BlobDataset(np, RG_IMAGES)
    n_train = int(0.8 * RG_IMAGES)
    ckpt = os.path.join(out_dir, "rg_best.ckpt")

    # B1 at the shape the build gives it: the first build batch of 16.
    check_slic_batch(torch, slic_mod, ds.load_batch(list(range(16)))["image"], "rg_build")

    kernels.reset_launches()
    trainer, history, build_launches, build_s, epoch_s = fit_rg(
        torch, train_rg, model_mod, ds, "cuda", out=ckpt)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {"slic_assign": SLIC_ITERS * -(-RG_IMAGES // 16), "fused_mha": 0, "fused_mha_bwd": 0}
    steps = {"train": len(train_rg.epoch_order(np.random.default_rng(0), range(n_train), BATCH, False)),
             "eval": len(train_rg.epoch_order(np.random.default_rng(0), range(RG_IMAGES - n_train),
                                              BATCH, False))}
    emit({"phase": "train_rg", "images": RG_IMAGES, "size": SIZE, "bucket": trainer.max_nodes,
          "batch": BATCH, "epochs": RG_EPOCHS, "steps_per_epoch": steps,
          "launches": launches, "launches_in_graph_build": build_launches,
          "expected_launches": want, "graph_build_seconds": build_s, "epoch_seconds": epoch_s,
          "nodes": [int(x) for x in trainer.data["node_mask"].sum(-1)], "history": history})
    if launches != want or build_launches != want:
        fail(f"RG training launched {launches} ({build_launches} in the graph build), "
             f"expected {want}, all in the build")
    if len(history["train_loss"]) != RG_EPOCHS or not np.isfinite(
            history["train_loss"] + history["val_loss"]).all():
        fail(f"RG training losses are not finite: {history}")
    if trainer.max_nodes != 640 or trainer.data["features"].shape != (RG_IMAGES, 640, 15):
        fail("RG training did not run at the 640-node bucket")

    if not os.path.exists(ckpt):
        fail("RG training wrote no best checkpoint")
    loaded = api.load_rg_model(ckpt, device="cuda")
    images = torch.from_numpy(ds.load_batch([0, 1, 2, 3])["image"]).cuda()
    heat = RegionGraphPipeline(loaded)(images)["heatmap"]
    emit({"phase": "train_rg_checkpoint", "heatmap_shape": list(heat.shape),
          "heatmap_mean": float(heat.mean())})
    if heat.shape != (4, SIZE, SIZE) or not bool(torch.isfinite(heat).all()):
        fail("the reloaded RG checkpoint does not predict")

    # The comparison trains both devices on the card's graphs at lr 1e-4,
    # which keeps the bars (RG_PARAM_BAR) under the recipe's 1e-3.
    gpu_trainer, gpu_history, _, _, _ = fit_rg(
        torch, train_rg, model_mod, ds, "cuda", cached=trainer.data, lr=RG_COMPARE_LR)
    cpu_data = {k: v.cpu() for k, v in trainer.data.items()}
    cpu_trainer, cpu_history, _, _, cpu_epoch_s = fit_rg(
        torch, train_rg, model_mod, ds, "cpu", cached=cpu_data, lr=RG_COMPARE_LR)
    rel = abs(gpu_history["train_loss"][0] - cpu_history["train_loss"][0]) / abs(cpu_history["train_loss"][0])
    drift = 2 * RG_COMPARE_LR * steps["train"] * RG_EPOCHS
    g_sd, c_sd = gpu_trainer.model.state_dict(), cpu_trainer.model.state_dict()
    tight, loose, diffs, ok = param_diffs(torch, g_sd, c_sd, RG_GRADIENT_FREE, drift, RG_PARAM_BAR)
    moved = moved_ratio(torch, model_mod, g_sd, c_sd, trained_keys(cpu_trainer.model))
    emit({"phase": "train_rg_vs_cpu", "learning_rate": RG_COMPARE_LR, "param_bar": RG_PARAM_BAR,
          "distance_over_moved": moved, "distance_over_moved_bar": RG_MOVED_BAR,
          "epoch0_train_loss_rel_diff": rel, "gpu_history": gpu_history,
          "final_param_max_abs_diff": tight, "gradient_free_and_running_mean_max_abs_diff": loose,
          "gradient_free_bound": drift, "per_key": diffs, "cpu_history": cpu_history,
          "cpu_epoch_seconds": cpu_epoch_s})
    if rel > 1e-3 or not ok or moved > RG_MOVED_BAR:
        fail(f"GPU RG training disagrees with the CPU port: loss {rel}, parameters {tight} / "
             f"{loose}, distance over moved {moved}")

    raw = ds.load_batch([4, 5, 6, 7])
    built = {dev: trainer.build_graphs(raw["image"], raw["mask"], raw["instance"], raw["edge"],
                                       device=dev) for dev in ("cuda", "cpu")}
    seg_g, seg_c = (built[d][0].segments.cpu().numpy() for d in ("cuda", "cpu"))
    agree = agreeing_nodes(np, seg_g, seg_c, trainer.max_nodes)
    valid = built["cpu"][0].node_mask.numpy()
    label_diff = {k: int((built["cuda"][1][k].cpu().numpy() != built["cpu"][1][k].numpy())[agree].sum())
                  for k in train_rg.LABEL_KEYS}
    seg_eq = float((seg_g == seg_c).mean())
    emit({"phase": "rg_build_vs_cpu", "segments_equal": seg_eq,
          "agreeing_node_share": float(agree[valid].mean()),
          "labels_differing_on_agreeing_nodes": label_diff})
    if seg_eq < 0.99 or any(label_diff.values()):
        fail(f"the RG graph build disagrees with the CPU port: segments {seg_eq}, labels {label_diff}")
    return trainer, ds, launches


def rg_lr_probe(torch, np, seeds=(21, 22, 23, 24, 25)):
    """Phase 7's card-vs-CPU comparison on other data seeds, at the recipe's
    learning rate and at the comparison's (``--rg-lr-probe``)."""
    from camouflage_multimodal_tpu_torch.models import region_graph as model_mod
    from camouflage_multimodal_tpu_torch.train import train_rg

    init = rg_model(torch, model_mod).state_dict()
    for seed in seeds:
        ds = BlobDataset(np, RG_IMAGES, seed=seed)
        data = None
        for lr in (1e-3, RG_COMPARE_LR):
            gpu, g_hist, _, _, _ = fit_rg(torch, train_rg, model_mod, ds, "cuda", cached=data, lr=lr)
            data = gpu.data
            cpu, c_hist, _, _, _ = fit_rg(torch, train_rg, model_mod, ds, "cpu",
                                          cached={k: v.cpu() for k, v in data.items()}, lr=lr)
            params = {d: dict(t.model.named_parameters()) for d, t in (("gpu", gpu), ("cpu", cpu))}
            g_sd, c_sd = gpu.model.state_dict(), cpu.model.state_dict()
            tight, _, diffs, _ = param_diffs(torch, g_sd, c_sd, RG_GRADIENT_FREE, 0.0)
            loose = [k for k in diffs if k in RG_GRADIENT_FREE or k.endswith("running_mean")]
            by_diff = sorted(diffs, key=diffs.get, reverse=True)
            worst = []
            for key in [k for k in by_diff if k not in loose][:3] + [k for k in by_diff if k in loose][:2]:
                a, b = g_sd[key].cpu().flatten(), c_sd[key].cpu().flatten()
                i = int((a - b).abs().argmax())
                start = init[key].flatten()[i]
                entry = {"key": key, "max_diff": diffs[key],
                         "moved_max": float((b - init[key].flatten()).abs().max()),
                         "moved_at_worst_gpu": float(a[i] - start),
                         "moved_at_worst_cpu": float(b[i] - start)}
                if key in params["gpu"]:
                    st = {d: t.optimizer.state[params[d][key]] for d, t in (("gpu", gpu), ("cpu", cpu))}
                    entry.update({f"m_{d}_at_worst": float(st[d]["exp_avg"].flatten()[i])
                                  for d in st})
                    entry.update({f"sqrt_v_{d}_at_worst": float(st[d]["exp_avg_sq"].flatten()[i].sqrt())
                                  for d in st})
                    entry["sqrt_v_median"] = float(st["cpu"]["exp_avg_sq"].sqrt().median())
                worst.append(entry)
            emit({"phase": "rg_lr_probe", "data_seed": seed, "learning_rate": lr,
                  "epoch0_train_loss": [g_hist["train_loss"][0], c_hist["train_loss"][0]],
                  "max_diff_held_to_bar": tight, "distance_over_moved": moved_ratio(
                      torch, model_mod, g_sd, c_sd, trained_keys(cpu.model)),
                  "worst": worst})


def fit_kg(torch, train_kg, model_mod, subgraphs, device, out=None):
    model = model_mod.KnowledgeGraphGNN(dropout=0.0)
    model.head_drop.p = 0.0
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = train_kg.KGTrainer(model=model, max_nodes=KG_NODES)
    stamps = [time.perf_counter()]
    _, history = trainer.fit(subgraphs, epochs=KG_EPOCHS, batch_size=KG_BATCH, seed=0,
                             checkpoint_path=out, device=device,
                             log_fn=lambda *_: stamps.append(time.perf_counter()))
    return trainer, history, [b - a for a, b in zip(stamps, stamps[1:])]


def phase_train_kg(torch, np, kernels, api, out_dir):
    """Drive KG training and the embedding factory; returns (trainer,
    subgraphs)."""
    from camouflage_multimodal_tpu_torch import data as data_mod
    from camouflage_multimodal_tpu_torch.kg.featurize import pad_subgraphs
    from camouflage_multimodal_tpu_torch.kg.store import CamouflageKnowledgeStore
    from camouflage_multimodal_tpu_torch.models import knowledge_graph as model_mod
    from camouflage_multimodal_tpu_torch.train import train_kg

    with np.load(ARTIFACTS[2]) as z:
        categories = list(z.files)
    store = CamouflageKnowledgeStore()
    for name, obj in synthetic_annotations(np, categories, KG_PER_CATEGORY):
        store.ingest_annotation(obj, name)
    subgraphs = train_kg.create_dataset_from_store(store)
    nodes = [int(sg["x"].shape[0]) for sg in subgraphs]

    kernels.reset_launches()
    trainer, history, epoch_s = fit_kg(torch, train_kg, model_mod, subgraphs, "cuda",
                                       out=os.path.join(out_dir, "kg_best.ckpt"))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_train = int(0.8 * len(subgraphs))
    emit({"phase": "train_kg", "categories": len(store.categories()), "subgraphs": len(subgraphs),
          "nodes_min_max": [min(nodes), max(nodes)], "bucket": KG_NODES, "batch": KG_BATCH,
          "epochs": KG_EPOCHS, "train_steps_per_epoch": -(-n_train // KG_BATCH),
          "launches": launches, "epoch_seconds": epoch_s, "history": history})
    if any(launches.values()):
        fail(f"KG training launched {launches}: no kernel is on its path")
    if len(history["train_loss"]) != KG_EPOCHS or not np.isfinite(
            history["train_loss"] + history["val_loss"]).all():
        fail(f"KG training losses are not finite: {history}")
    if max(nodes) > KG_NODES:
        fail(f"a subgraph of {max(nodes)} nodes does not fit the {KG_NODES}-node bucket")

    cpu_trainer, cpu_history, cpu_epoch_s = fit_kg(torch, train_kg, model_mod, subgraphs, "cpu")
    rel = abs(history["train_loss"][0] - cpu_history["train_loss"][0]) / abs(cpu_history["train_loss"][0])
    drift = 2 * trainer.base_lr * -(-n_train // KG_BATCH) * KG_EPOCHS
    tight, loose, diffs, ok = param_diffs(torch, trainer.model.state_dict(),
                                          cpu_trainer.model.state_dict(), KG_GRADIENT_FREE, drift)
    emit({"phase": "train_kg_vs_cpu", "epoch0_train_loss_rel_diff": rel,
          "final_param_max_abs_diff": tight, "gradient_free_and_running_mean_max_abs_diff": loose,
          "gradient_free_bound": drift, "per_key": diffs, "cpu_history": cpu_history,
          "cpu_epoch_seconds": cpu_epoch_s})
    if rel > 1e-3 or not ok:
        fail(f"GPU KG training disagrees with the CPU port: loss {rel}, parameters {tight} / {loose}")

    embeddings, _ = trainer.batch_extract_embeddings(trainer.model, store)
    path = os.path.join(out_dir, "kg_embeddings", "all_embeddings.npz")
    data_mod.save_kg_embeddings(path, embeddings)
    back = data_mod.load_kg_embeddings(path)
    shapes_ok = all(v.shape == (1, 128) and np.isfinite(v).all() for v in back.values())
    emit({"phase": "kg_embeddings", "categories": sorted(back), "all_finite_1x128": shapes_ok})
    if len(back) != len(categories) or not shapes_ok:
        fail(f"expected {len(categories)} finite (1, 128) KG embeddings, got {len(back)}")

    x, adj, mask, _, _ = pad_subgraphs(subgraphs[:8], KG_NODES)
    embs = {}
    for dev in ("cuda", "cpu"):
        model = api.load_kg_model("artifacts/kg_gnn_model.ckpt", device=dev)
        with torch.no_grad():
            embs[dev] = model(*(torch.from_numpy(a).to(dev) for a in (x, adj, mask)))["embedding"]
    err = float((embs["cuda"].cpu() - embs["cpu"]).abs().max())
    emit({"phase": "kg_checkpoint_vs_cpu", "subgraphs": 8, "max_abs_diff_embedding": err})
    if err > 1e-5:
        fail(f"the committed KG checkpoint's embeddings differ on the card by {err}")
    return trainer, subgraphs


# ---------------------------------------------------------------------------
# The workflow: extraction → matcher → fusion epoch → evaluation → testing
# ---------------------------------------------------------------------------

WORKFLOW_IMAGES = 32       # two extraction / evaluation batches of 16
WORKFLOW_BATCH = 16
TEST_DIR_BATCH = 8
WORKFLOW_SUBSET = 4        # images compared with the CPU
ENVIRONMENTS = ("Aquatic", "Terrestrial", "Flying", "Amphibian")
REFERENCE_PTH = ("artifacts/fidelity/multimodal_best.pth", "artifacts/fidelity/best_model.pth")
LATE_CKPT = "artifacts/checkpoints_late/multimodal_best_fixed.ckpt"


def write_workflow_dataset(np, root: str, n: int = WORKFLOW_IMAGES):
    """``n`` seeded 256² images of ``BlobDataset`` (a disc in a smooth scene)
    as COD10K-named JPEGs over the 13 committed KG categories, with the disc
    as object and instance GT and its ring as edge GT (PNGs). Returns the
    directories and the image names in the directory walks' (sorted) order."""
    from PIL import Image

    with np.load(ARTIFACTS[2]) as z:
        categories = sorted(z.files)
    dirs = {k: os.path.join(root, k) for k in ("images", "gt_object", "gt_instance", "gt_edge")}
    for d in dirs.values():
        os.makedirs(d)
    names = []
    for i, (img, mask, ring) in enumerate(BlobDataset(np, n, seed=41).items):
        base = f"COD10K-CAM-{1 + i % 4}-{ENVIRONMENTS[i % 4]}-{1 + i // 4}-{categories[i % 13]}-{100 + i}"
        names.append(base + ".jpg")
        Image.fromarray(img).save(os.path.join(dirs["images"], base + ".jpg"), quality=95)
        for key, gt in (("gt_object", mask), ("gt_instance", mask), ("gt_edge", ring)):
            Image.fromarray(gt).save(os.path.join(dirs[key], base + ".png"))
    return dirs, sorted(names)


def counted(torch, kernels, fn):
    """(fn(), seconds, launches) with the launch counts zeroed just before
    and read just after, the card synchronised."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def expect(launches, want, what):
    emit({"phase": "workflow_launches", "of": what, "launches": launches,
          "expected_launches": want})
    if launches != want:
        fail(f"{what} launched {launches}, expected {want}")


def phase_workflow(torch, np, kernels, api, out_dir):
    """Drive extraction, the matched fusion dataset, one fusion epoch,
    directory evaluation and directory testing at full width on seeded
    files; returns (the launches of each step, their sum)."""
    import PIL

    from camouflage_multimodal_tpu_torch import data as data_mod
    from camouflage_multimodal_tpu_torch.eval import curves as curves_mod
    from camouflage_multimodal_tpu_torch.eval import metrics as metrics_mod
    from camouflage_multimodal_tpu_torch.extract import batch_extract_embeddings, load_image_u8
    from camouflage_multimodal_tpu_torch.ops import slic as slic_mod
    from camouflage_multimodal_tpu_torch.pipeline import RegionGraphPipeline, build_region_graphs
    from camouflage_multimodal_tpu_torch.train import train_fusion as train_mod

    dirs, names = write_workflow_dataset(np, os.path.join(out_dir, "workflow"))
    subset = os.path.join(out_dir, "workflow", "subset")
    os.makedirs(subset)
    for name in names[:WORKFLOW_SUBSET]:
        os.symlink(os.path.join(dirs["images"], name), os.path.join(subset, name))
    emit({"phase": "workflow_data", "route": f"directory walk, PIL {PIL.__version__} decode",
          "images": len(names), "size": SIZE, "first": names[0]})
    steps = {}
    batches = -(-WORKFLOW_IMAGES // WORKFLOW_BATCH)

    # Extraction through the directory walk; the store read back.
    card_pipe = RegionGraphPipeline(api.load_rg_model(ARTIFACTS[1], device="cuda"))
    store_dir = os.path.join(out_dir, "workflow", "rg")
    (store, _), extract_s, steps["extract"] = counted(torch, kernels, lambda: batch_extract_embeddings(
        card_pipe, dirs["images"], store_dir, batch_size=WORKFLOW_BATCH, log_fn=lambda *_: None))
    expect(steps["extract"], {"slic_assign": SLIC_ITERS * batches, "fused_mha": 0,
                              "fused_mha_bwd": 0}, "extraction")
    store_path = os.path.join(store_dir, "all_rg_embeddings.npz")
    back = data_mod.load_rg_embeddings(store_path)
    if list(back) != names or not all(np.isfinite(r["node_embeddings"]).all() for r in back.values()):
        fail("the extracted store does not read back whole and finite")
    sub = {}
    for dev in ("cuda", "cpu"):
        pipe = card_pipe if dev == "cuda" else RegionGraphPipeline(api.load_rg_model(ARTIFACTS[1], device="cpu"))
        batch_extract_embeddings(pipe, subset, os.path.join(out_dir, "workflow", f"sub_{dev}"),
                                 batch_size=WORKFLOW_SUBSET, save_individual=True, log_fn=lambda *_: None)
        sub[dev] = {}
        for name in names[:WORKFLOW_SUBSET]:
            path = os.path.join(out_dir, "workflow", f"sub_{dev}", name[:-4] + "_embedding.npz")
            with np.load(path) as z:
                sub[dev][name] = (z["segments"], z["graph_embedding"])
    seg_eq = min(float((sub["cuda"][n][0] == sub["cpu"][n][0]).mean()) for n in sub["cpu"])
    graph_err = max(float(np.abs(sub["cuda"][n][1] - sub["cpu"][n][1]).max()) for n in sub["cpu"])
    store_err = max(float(np.abs(sub["cuda"][n][1] - back[n]["graph_embedding"]).max()) for n in sub["cpu"])
    emit({"phase": "workflow_extract", "images": len(store), "batch": WORKFLOW_BATCH,
          "seconds": extract_s, "nodes": [r["num_nodes"] for r in back.values()],
          "subset_vs_cpu": {"images": WORKFLOW_SUBSET, "segments_equal_min": seg_eq,
                            "graph_embedding_max_abs_diff": graph_err},
          "subset_vs_full_run_graph_embedding_max_abs_diff": store_err})
    if seg_eq < 0.99 or graph_err > 1e-2:
        fail(f"card extraction disagrees with the CPU: segments {seg_eq}, graph embeddings {graph_err}")

    # The matched fusion dataset and one epoch trained from it.
    matcher = data_mod.EmbeddingMatcher(store_path, ARTIFACTS[2])
    matched = matcher.create_matched_dataset(True)
    organisms = [matcher.extract_category_from_filename(n) for n in names]
    ds = train_mod.FusionDataset(matched, dirs["gt_object"], dirs["gt_instance"], dirs["gt_edge"],
                                 log_fn=lambda *_: None)
    trainer = train_mod.FusionTrainer(model_config={"dropout": 0.0, "use_pallas": True})
    (_, history), train_s, steps["fusion_epoch"] = counted(torch, kernels, lambda: trainer.fit(
        ds, epochs=1, batch_size=BATCH, seed=0, device_resident=True, device="cuda",
        checkpoint_dir=os.path.join(out_dir, "workflow", "fusion"), log_fn=lambda *_: None))
    n_train = int(0.8 * len(ds))
    train_steps, eval_steps = max(n_train // BATCH, 1), max((len(ds) - n_train) // BATCH, 1)
    emit({"phase": "workflow_fusion_epoch", "records": len(ds), "bucket": ds.max_rg_nodes,
          "truncated_nodes": ds.truncated_nodes, "labels": ds.get_labels(),
          "organisms_matched": sum(o is not None for o in organisms),
          "kg_categories": int(matched[0]["num_kg_categories"]), "seconds": train_s,
          "history": history})
    expect(steps["fusion_epoch"], {"slic_assign": 0, "fused_mha": 2 * (train_steps + eval_steps),
                                   "fused_mha_bwd": 2 * train_steps}, "fusion epoch")
    if len(ds) != WORKFLOW_IMAGES or None in organisms or not np.isfinite(
            history["train_loss"] + history["val_loss"]).all():
        fail(f"the matched dataset or its epoch is wrong: {len(ds)} records, losses {history}")

    # Evaluation: the report, the metrics on the card's heatmaps, the CPU.
    report, eval_s, steps["evaluate"] = counted(torch, kernels, lambda: api.evaluate_directory(
        ARTIFACTS[1], dirs["images"], dirs["gt_object"], batch_size=WORKFLOW_BATCH, device="cuda"))
    expect(steps["evaluate"], {"slic_assign": SLIC_ITERS * batches, "fused_mha": 0,
                               "fused_mha_bwd": 0}, "evaluation")
    images = np.stack([load_image_u8(os.path.join(dirs["images"], n), SIZE)
                       for n in names[:WORKFLOW_BATCH]])
    gts = np.stack([data_mod.load_mask(os.path.join(dirs["gt_object"], n[:-4] + ".png"), SIZE)
                    for n in names[:WORKFLOW_BATCH]])
    heat = card_pipe(torch.from_numpy(images).cuda())["heatmap"]
    gt = torch.from_numpy(gts).cuda()
    metric_err = 0.0
    for fn in (metrics_mod.evaluate_segmentation, metrics_mod.batch_evaluate,
               curves_mod.threshold_curves):
        card, plain = fn(heat, gt), fn(heat.cpu(), gt.cpu())
        metric_err = max(metric_err, *(float((card[k].cpu() - plain[k]).abs().max()) for k in plain))
    sub_reports = {dev: api.evaluate_directory(ARTIFACTS[1], dirs["images"], dirs["gt_object"],
                                               files=names[:WORKFLOW_SUBSET],
                                               batch_size=WORKFLOW_SUBSET, device=dev)
                   for dev in ("cuda", "cpu")}
    report_err = max(abs(sub_reports["cuda"][k] - sub_reports["cpu"][k]) for k in sub_reports["cpu"])
    emit({"phase": "workflow_evaluate", "images": WORKFLOW_IMAGES, "seconds": eval_s,
          "report": report, "card_metrics_vs_plain_max_abs_diff": metric_err,
          "subset_report_vs_cpu_max_abs_diff": report_err})
    if metric_err > 1e-5 or report_err > 1e-2 or not all(np.isfinite(v) for v in report.values()):
        fail(f"evaluation disagrees: metrics {metric_err}, subset report {report_err}")

    # Directory testing with both committed fusion checkpoints; B1 first held
    # to its plain version on its first batch of 8 (B2's batch-8 shapes are
    # among phase_fused_mha's).
    check_slic_batch(torch, slic_mod, images[:TEST_DIR_BATCH], "test_dir")
    tests = {}
    for kind, ckpt in (("cross_attention", ARTIFACTS[0]), ("late", LATE_CKPT)):
        predictor = api.MultimodalPredictor(ckpt, *ARTIFACTS[1:], device="cuda")
        out = os.path.join(out_dir, "workflow", f"test_{kind}")
        results, test_s, steps[f"test_dir_{kind}"] = counted(torch, kernels, lambda: api.test_image_directory(
            predictor, dirs["images"], out, batch_size=TEST_DIR_BATCH))
        test_batches = -(-WORKFLOW_IMAGES // TEST_DIR_BATCH)
        expect(steps[f"test_dir_{kind}"], {
            "slic_assign": SLIC_ITERS * test_batches,
            "fused_mha": 2 * test_batches if kind == "cross_attention" else 0,
            "fused_mha_bwd": 0}, f"directory testing ({kind})")
        with open(os.path.join(out, "batch_results.json")) as f:
            written = json.load(f)
        tests[kind] = {"seconds": test_s, "camouflaged": sum(r["pred_label"] for r in results)}
        if written != results or len(results) != WORKFLOW_IMAGES or not all(
                np.isfinite(r["score"]) for r in results):
            fail(f"directory testing ({kind}) wrote {len(written)} records")
    emit({"phase": "workflow_test_dir", "batch": TEST_DIR_BATCH, **tests})

    # The reference's .pth pair in a predictor.
    predictor = api.MultimodalPredictor(*REFERENCE_PTH, ARTIFACTS[2], device="cuda")
    out, _, steps["reference_pth_batch"] = counted(
        torch, kernels, lambda: predictor.predict_batch(images[:BATCH]))
    expect(steps["reference_pth_batch"], {"slic_assign": SLIC_ITERS, "fused_mha": 2,
                                          "fused_mha_bwd": 0}, "the reference .pth predictor")
    emit({"phase": "workflow_reference_pth", "score": out["score"][:, 0].tolist(),
          "attention_rg2kg_shape": list(out["attention"]["rg2kg"].shape)})
    if not all(np.isfinite(out[k]).all() for k in ("heatmap", "mask_prob", "score")):
        fail("the reference .pth predictor gives non-finite outputs")

    # The graph build repeats to the bit; ms per build of 16.
    imgs = torch.from_numpy(images).cuda()
    first = build_region_graphs(imgs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = build_region_graphs(imgs)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    outs = [card_pipe(imgs) for _ in range(2)]
    equal = {k: torch.equal(getattr(first, k), getattr(again, k))
             for k in ("segments", "features", "adjacency", "edge_weights", "node_mask")}
    equal.update({k: torch.equal(outs[0][k], outs[1][k]) for k in ("node_embeddings", "heatmap")})
    emit({"phase": "workflow_determinism", "images": WORKFLOW_BATCH, "bit_equal": equal})
    if not all(equal.values()):
        fail(f"two card builds of the same images differ: {equal}")

    emit({"phase": "workflow_time", "extraction_images_per_second": WORKFLOW_IMAGES / extract_s,
          "evaluation_images_per_second": WORKFLOW_IMAGES / eval_s,
          "rg_build_ms_per_batch_of_16": build_ms, "fusion_epoch_seconds": train_s,
          "test_dir_images_per_second": {k: WORKFLOW_IMAGES / v["seconds"] for k, v in tests.items()},
          "note": "end to end from the files: PIL decode threads, uploads and downloads included; "
                  "first use of each entry point in this process"})
    total = {k: sum(s[k] for s in steps.values()) for k in kernels.LAUNCHES}
    return steps, total


OVERLAP_IMAGES = 96        # six batches of 16 for the overlap timing


def phase_overlap(torch, np, api, out_dir):
    """Extraction and evaluation of 96 seeded files at batch 16, each with
    the directory walks' four-stage overlap (``stages.run_overlapped``) and
    with the same stages run one after another (each waited for, timed
    alone), in the order overlapped, serial, serial, overlapped; prints the
    img/s of each run and the serial runs' seconds per stage."""
    from camouflage_multimodal_tpu_torch.core import stages
    from camouflage_multimodal_tpu_torch.extract import batch_extract_embeddings
    from camouflage_multimodal_tpu_torch.pipeline import RegionGraphPipeline

    dirs, _ = write_workflow_dataset(np, os.path.join(out_dir, "overlap"), OVERLAP_IMAGES)
    pipe = RegionGraphPipeline(api.load_rg_model(ARTIFACTS[1], device="cuda"))
    overlapped = stages.run_overlapped
    clock = {}

    def serial(chunks, decode, upload_fn, compute, download_fn, record):
        def timed(name, fn, x):
            t0 = time.perf_counter()
            y = fn(x)
            torch.cuda.synchronize()
            clock[name] = clock.get(name, 0.0) + time.perf_counter() - t0
            return y

        for chunk in chunks:
            out = timed("compute", compute, timed("upload", upload_fn, timed("decode", decode, chunk)))
            if out is not None:
                t0 = time.perf_counter()
                record(timed("download", download_fn, out))
                clock["record"] = clock.get("record", 0.0) + time.perf_counter() - t0

    walks = {
        "extraction": lambda: batch_extract_embeddings(
            pipe, dirs["images"], os.path.join(out_dir, "overlap", "rg"),
            batch_size=WORKFLOW_BATCH, log_fn=lambda *_: None),
        "evaluation": lambda: api.evaluate_directory(
            ARTIFACTS[1], dirs["images"], dirs["gt_object"], batch_size=WORKFLOW_BATCH,
            device="cuda"),
    }
    rates = {}
    for what, walk in walks.items():
        clock.clear()
        rates[what] = {"overlapped": [], "serial": []}
        for mode in ("overlapped", "serial", "serial", "overlapped"):
            stages.run_overlapped = overlapped if mode == "overlapped" else serial
            try:
                t0 = time.perf_counter()
                walk()
                torch.cuda.synchronize()
                rates[what][mode].append(OVERLAP_IMAGES / (time.perf_counter() - t0))
            finally:
                stages.run_overlapped = overlapped
        rates[what]["serial_seconds_per_stage"] = {k: v / 2 for k, v in clock.items()}
    emit({"phase": "workflow_overlap", "images": OVERLAP_IMAGES, "batch": WORKFLOW_BATCH,
          "images_per_second": rates,
          "note": "end to end from the files, PIL decode included; serial runs wait for "
                  "each stage; evaluation loads its checkpoint in every run"})


def build_cost(torch, np, api, reps: int = 5):
    """``--build-cost``: ms per RG graph build of 16 images and per
    inference batch of 4 at 256², three rounds of each; runs on any
    checkout whose port has ``build_region_graphs`` and
    ``MultimodalPredictor``."""
    from camouflage_multimodal_tpu_torch.pipeline import build_region_graphs

    imgs = torch.from_numpy(BlobDataset(np, 16).load_batch(list(range(16)))["image"]).cuda()
    predictor = api.MultimodalPredictor(*ARTIFACTS, device="cuda")
    batches = [synthetic_images(100 + i, BATCH, SIZE) for i in range(reps)]

    def rounds(fn):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) / reps * 1e3)
        return out

    emit({"phase": "build_cost", "checkout": REPO,
          "rg_build_ms_per_batch_of_16": rounds(lambda i=0: build_region_graphs(imgs)),
          "inference_ms_per_batch_of_4": rounds(lambda i=0: predictor.predict_batch(batches[i]))})


def phase_times_graph_training(torch, np, rg_trainer, rg_ds, kg_trainer, kg_subgraphs, profile):
    """ms per RG graph-build batch of 16, per RG and per KG train step."""
    raw = rg_ds.load_batch(list(range(16)))

    def build():
        rg_trainer.build_graphs(raw["image"], raw["mask"], raw["instance"], raw["edge"],
                                device="cuda")

    build()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        build()
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) / 3 * 1e3

    def time_steps(trainer, batches):
        def run(some):
            for batch in some:
                trainer.train_step(batch, 1e-5)
        run(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(batches)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / len(batches) * 1e3, run

    g = torch.Generator().manual_seed(0)
    rg_batches = [rg_trainer.gather(rg_trainer.data, torch.randperm(RG_IMAGES, generator=g)[:BATCH].cuda())
                  for _ in range(12)]
    rg_ms, rg_run = time_steps(rg_trainer, rg_batches)
    kg_data = kg_trainer.device_dataset(kg_subgraphs, KG_NODES, torch.device("cuda"))
    kg_batches = [{k: kg_data[k].index_select(0, torch.randperm(len(kg_subgraphs), generator=g)[:KG_BATCH].cuda())
                   for k in ("x", "adj", "mask", "y")} for _ in range(12)]
    kg_ms, kg_run = time_steps(kg_trainer, kg_batches)
    emit({"phase": "graph_training_time", "rg_graph_build_ms_per_batch_of_16": build_ms,
          "rg_ms_per_train_step": rg_ms, "rg_steps_per_second": 1e3 / rg_ms,
          "rg_batch": BATCH, "rg_nodes": rg_trainer.max_nodes,
          "kg_ms_per_train_step": kg_ms, "kg_steps_per_second": 1e3 / kg_ms,
          "kg_batch": KG_BATCH, "kg_nodes": KG_NODES, "steps_timed": 12})
    if profile:
        phase_profile(torch, "three RG train steps", lambda: rg_run(rg_batches[:3]))
        phase_profile(torch, "three KG train steps", lambda: kg_run(kg_batches[:3]))
        phase_profile(torch, "one RG graph-build batch of 16", build)


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
    def b1():
        return slic_mod.slic_assign(pix, centers, prev, ratio, step, width=SIZE)

    # Pixel-tile shapes in turns inside this one run; 256 x 1 is a run of
    # 256 pixels, what the kernel takes when it is given no width.
    main_tile = slic_mod.TILE_WIDTH
    tiles = {}
    for tile_w in (16, 32, 256, 256, 32, 16):
        slic_mod.TILE_WIDTH = tile_w
        tiles.setdefault(f"{tile_w}x{256 // tile_w}", []).append(cuda_ms(b1, reps=50))
        lengths = list_lengths(slic_mod, centers, step, SIZE, SIZE)
        tiles[f"{tile_w}x{256 // tile_w}_list"] = [lengths["mean"], lengths["max"]]
    slic_mod.TILE_WIDTH = main_tile
    b1_ms = cuda_ms(b1)
    b1_host = host_ms(b1)
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
            "host_ms": host_ms(lambda: attention_mod.fused_mha(params, q, k, k, 8, mask)),
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
          "slic_assign_ms": b1_ms, "slic_assign_host_ms": b1_host,
          "slic_assign_plain_ms": b1_plain, "slic_assign_in_box_pairs": pairs,
          "slic_assign_tile": [main_tile, 256 // main_tile],
          "slic_assign_ms_by_tile_width_x_height": tiles})
    if trace:
        phase_profile(torch, "one inference batch",
                      lambda: predictor.predict_batch(batches[0]), trace)

        def kernel_calls():
            for _ in range(20):
                b1()
                for params, q, k, mask in b2_cases.values():
                    attention_mod.fused_mha(params, q, k, k, 8, mask)

        phase_profile(torch, "20 calls of B1 and of B2 in each direction", kernel_calls)
    return (b1_ms, b1_host, b1_plain, b1_bound, pairs), (b2, b2_bound)


def phase_times_train(torch, kernels, attention_mod, b3_cases, trainer, ds, profile):
    """B3, its plain backward and the library's backward per direction at
    the training shapes, B2 there too, and the train step."""
    F = torch.nn.functional
    names = attention_mod.PARAM_NAMES
    b3 = {}
    b3_calls = {}
    for name in ("rg2kg", "kg2rg"):
        leaves, mask, d_out, d_probs = b3_cases[name]
        q, k, v, *weights = leaves
        params = dict(zip(names, weights))
        E = q.shape[-1]
        Bq, Nq, _ = q.shape
        Nk = k.shape[1]

        out, probs = attention_mod.fused_mha(params, q, k, v, HEADS, mask)

        # Defaults bind this direction's tensors: the calls outlive the loop.
        def kernel(out=out, probs=probs, leaves=leaves, d_out=d_out, d_probs=d_probs):
            return torch.autograd.grad([out, probs], leaves, [d_out, d_probs],
                                       retain_graph=True)

        def kernel_no_probs(out=out, leaves=leaves, d_out=d_out):
            """What a train step calls: no cotangent for the attention maps."""
            return torch.autograd.grad([out], leaves, [d_out], retain_graph=True)

        on_card = kernels.device_launches("fused_mha_bwd")
        kernel_no_probs()
        kernel_launches = kernels.device_launches("fused_mha_bwd") - on_card

        detached = {n: w.detach() for n, w in params.items()}
        qd, kd, vd = q.detach(), k.detach(), v.detach()

        def plain():
            return attention_mod.multihead_attention_backward(
                detached, qd, kd, vd, HEADS, mask, d_out, d_probs)

        w_in = torch.cat([params["wq"].T, params["wk"].T, params["wv"].T]).detach().requires_grad_()
        b_in = torch.cat([params["bq"], params["bk"], params["bv"]]).detach().requires_grad_()
        w_out = params["wo"].T.detach().contiguous().requires_grad_()
        b_out = params["bo"].detach().requires_grad_()
        lib_leaves = [t.detach().transpose(0, 1).contiguous().requires_grad_()
                      for t in (q, k, v)]
        lib_out, lib_p = F.multi_head_attention_forward(
            *lib_leaves, E, HEADS, w_in, b_in, None, None, False, 0.0, w_out, b_out,
            training=False, key_padding_mask=~mask, need_weights=True,
            average_attn_weights=True)
        lib_inputs = lib_leaves + [w_in, b_in, w_out, b_out]
        lib_d_out = d_out.transpose(0, 1).contiguous()

        def library():
            return torch.autograd.grad([lib_out, lib_p], lib_inputs, [lib_d_out, d_probs],
                                       retain_graph=True)

        ref = plain()
        lib = library()
        flops = Bq * (8 * Nq * E * E + 8 * Nk * E * E + 10 * Nq * Nk * E)
        nbytes = 4 * (3 * Bq * Nq * E          # q, ctx, d_out
                      + Bq * Nq * E            # qp
                      + 4 * Bq * Nk * E        # k, v, kp, vp
                      + Bq * Nq * Nk           # d_probs
                      + 4 * E * E              # the four weights
                      + Bq * Nq * E + 2 * Bq * Nk * E      # d_q, d_k, d_v
                      + 4 * E * E + 4 * E) + Bq * Nk       # parameter gradients, mask
        b3_calls[name] = (kernel_no_probs, kernel)
        b3[name] = {
            "ms": cuda_ms(kernel), "host_ms": host_ms(kernel),
            "ms_no_d_probs": cuda_ms(kernel_no_probs),
            "host_ms_no_d_probs": host_ms(kernel_no_probs),
            "kernel_launches_per_call": kernel_launches,
            "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
            "fused_mha_ms": cuda_ms(lambda: attention_mod.fused_mha(detached, qd, kd, vd, HEADS, mask)),
            # Batch row 2 has every key masked: the library call masks with
            # -inf and gives NaN there, so its gradient is compared elsewhere.
            "library_max_abs_err_d_q": float(
                (lib[0].transpose(0, 1) - ref[1])[[0, 1, 3]].abs().max()),
            "flops": flops, "bytes": nbytes,
        }
        emit({"phase": "fused_mha_bwd_time", "direction": name, "nq": Nq, "nk": Nk, **b3[name]})
    b3_bound = bound_ms(sum(v["bytes"] for v in b3.values()),
                        sum(v["flops"] for v in b3.values()))

    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                ds.collate(list(range(i, i + BATCH))).items()}
               for i in range(0, 12 * BATCH, BATCH)]

    def steps(some):
        for batch in some:
            trainer.train_step(batch, 1e-5)

    steps(batches)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(batches)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / len(batches)
    emit({"phase": "train_step_time", "ms_per_step": step_s * 1e3,
          "steps_per_second": 1.0 / step_s, "samples_per_second": BATCH / step_s,
          "batch": BATCH, "nodes": ds.max_rg_nodes, "steps_timed": len(batches),
          "fused_mha_ms_per_step": sum(v["fused_mha_ms"] for v in b3.values()),
          "fused_mha_bwd_ms_per_step": sum(v["ms"] for v in b3.values())})
    # Where a step's time goes: host clock with a wait for the card after
    # each part (so the parts add up to more than an unsynchronised step).
    from camouflage_multimodal_tpu_torch.train.state import apply_updates

    parts = {"forward_ms": 0.0, "backward_ms": 0.0, "optimizer_ms": 0.0}
    trainer.model.train()
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.model(batch["rg"], batch["kg"], rg_mask=batch["rg_mask"])
        loss = trainer.batch_loss(out, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        apply_updates(trainer.optimizer, 1e-5)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key] += dt * 1e3 / len(batches)
    emit({"phase": "train_step_parts", **parts})
    if profile:
        phase_profile(torch, "three train steps", lambda: steps(batches[:3]))
        for i, what in enumerate(("no d_probs (as a train step calls it)", "with d_probs")):
            def b3_twenty():
                for _ in range(20):
                    for calls in b3_calls.values():
                        calls[i]()

            phase_profile(torch, f"20 calls of B3 in each direction, {what}", b3_twenty)
    return b3, b3_bound


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


def hand_kernel_names():
    """Names of the kernels in the port's CUDA sources (each ends in
    ``_kernel``)."""
    import re

    csrc = os.path.join(REPO, "camouflage_multimodal_tpu_torch", "csrc")
    names = set()
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name)) as f:
            names.update(re.findall(r"\b(\w+_kernel)\b", f.read()))
    return names


def phase_profile(torch, what, fn, trace=None):
    """``fn()`` under ``torch.profiler``: device time by kernel, device busy
    and idle share of its wall time, and each pipeline stage's host time,
    device span and device busy time (the ``cmt::`` ranges of pipeline.py).
    Writes the Chrome trace to ``trace`` when given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def on_card(ev):
        """A kernel or a copy: not a host range mirrored onto the card's
        timeline (the cmt:: stages, the optimizer's step annotation)."""
        return (ev.device_type == DeviceType.CUDA and not ev.name.startswith("cmt::")
                and not getattr(ev, "is_user_annotation", False)
                and not ev.name.startswith("Optimizer."))

    # A short window now and then comes back without one device record;
    # it is then taken again, up to three times in all.
    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # A cmt:: range appears on the host and, as an annotation from the
        # stage's first to its last device activity, on the card's timeline.
        # Every other event on the card is a kernel or a copy.
        events = prof.events()
        spans = sorted((ev.time_range.start, ev.time_range.end) for ev in events if on_card(ev))
        if spans:
            break
    if trace:
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        prof.export_chrome_trace(trace)
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
        elif on_card(ev):
            t, n = by_kernel.get(ev.name, (0.0, 0))
            by_kernel[ev.name] = (t + ms, n + 1)
    busy_ms = busy_us(spans) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    host_top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    emit({"phase": "profile", "of": what, "attempts": attempt, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if spans else "not measured",
          "device_idle_share": 1 - busy_ms / wall_ms if spans else "not measured",
          "device_events": len(spans), "stages": stages,
          "top_kernels": [{"kernel": k[:80], "ms": t, "calls": n}
                          for k, (t, n) in top],
          "hand_written_kernels": {k: v for k, v in (
              (k.split("::")[1].split("(")[0], {"ms": t, "calls": n})
              for k, (t, n) in by_kernel.items() if "(anonymous namespace)::" in k)
              if k.split("<")[0] in hand_kernel_names()},
          "top_host_ops": [{"op": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3,
                            "calls": e.count} for e in host_top]})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--profile", metavar="TRACE_JSON",
                    help="also profile one batch and write its Chrome trace here")
    ap.add_argument("--b2-digest", action="store_true",
                    help="print SHA-256 digests of B2's outputs on its check shapes and stop")
    ap.add_argument("--rg-lr-probe", action="store_true",
                    help="run the RG card-vs-CPU comparison on five data seeds and stop")
    ap.add_argument("--build-cost", action="store_true",
                    help="time the RG graph build of 16 and an inference batch of 4 and stop")
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
        from camouflage_multimodal_tpu_torch.train import train_fusion as train_mod
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    for path in ARTIFACTS:
        if not os.path.exists(os.path.join(REPO, path)):
            fail(f"missing artifact {path}")
    os.chdir(REPO)

    if args.rg_lr_probe:
        phase_build(kernels)
        rg_lr_probe(torch, np)
        return
    if args.build_cost:
        phase_build(kernels)
        build_cost(torch, np, api)
        return
    if args.b2_digest:
        fusion_model, _ = api.load_multimodal_model(ARTIFACTS[0], device="cuda")
        b2_digest(torch, attention_mod, fusion_model)
        return
    phase_build(kernels)
    b1 = phase_slic_assign(torch, slic_mod, synthetic_images(7, BATCH, SIZE))
    fusion_model, _ = api.load_multimodal_model(ARTIFACTS[0], device="cuda")
    b2_cases, b2_err = phase_fused_mha(torch, kernels, attention_mod, fusion_model)
    b3_cases, b3_err = phase_fused_mha_bwd(torch, kernels, attention_mod, fusion_model)
    predictor, batches, launches = phase_slice(torch, np, kernels, api, args.batches)
    with tempfile.TemporaryDirectory() as out_dir:
        trainer, train_ds, train_launches = phase_train_slice(
            torch, np, kernels, api, train_mod, out_dir)
        rg_trainer, rg_ds, rg_launches = phase_train_rg(torch, np, kernels, api, out_dir)
        kg_trainer, kg_subgraphs = phase_train_kg(torch, np, kernels, api, out_dir)
        _, workflow_launches = phase_workflow(torch, np, kernels, api, out_dir)
        phase_overlap(torch, np, api, out_dir)
    (b1_ms, b1_host, b1_plain, b1_bound, _), (b2, b2_bound) = phase_times(
        torch, slic_mod, attention_mod, b1, b2_cases, predictor, batches, trace)
    b3, b3_bound = phase_times_train(torch, kernels, attention_mod, b3_cases, trainer,
                                     train_ds, bool(trace))
    phase_times_graph_training(torch, np, rg_trainer, rg_ds, kg_trainer, kg_subgraphs,
                               bool(trace))

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
         "launches": launches["slic_assign"],
         "launches_rg_training": rg_launches["slic_assign"],
         "launches_workflow": workflow_launches["slic_assign"],
         "per_rg_training": "1 launch: one SLIC assignment of 16 images of 256^2 against K=529",
         "max_abs_err": b1["max_abs_err"],
         "ms": b1_ms, "host_ms": b1_host, "plain_ms": b1_plain, "bound_ms": b1_bound[0],
         "bound_by": b1_bound[1], "library_ms": None},
        {"name": "fused_mha", "route": "cuda",
         "source": "camouflage_multimodal_tpu_torch/csrc/fused_mha.cu",
         "replaces": "camouflage_multimodal_tpu/ops/pallas_attention.py:30",
         "per": "2 launches: rg2kg (4x640 q, 13 k) + kg2rg (4x13 q, 640 k), E=256, 8 heads",
         "launches": launches["fused_mha"] + train_launches["fused_mha"],
         "launches_inference": launches["fused_mha"],
         "launches_training": train_launches["fused_mha"],
         "launches_workflow": workflow_launches["fused_mha"],
         "ms_training_shapes": sum(v["fused_mha_ms"] for v in b3.values()),
         "max_abs_err": b2_err,
         "ms": sum(v["ms"] for v in b2.values()),
         "host_ms": sum(v["host_ms"] for v in b2.values()),
         "plain_ms": sum(v["plain_ms"] for v in b2.values()),
         "bound_ms": b2_bound[0], "bound_by": b2_bound[1],
         "library_ms": sum(v["library_ms"] for v in b2.values())},
        {"name": "fused_mha_bwd", "route": "cuda",
         "source": "camouflage_multimodal_tpu_torch/csrc/fused_mha_bwd.cu",
         "replaces": "camouflage_multimodal_tpu/ops/pallas_attention.py:128",
         "per": "2 launches: rg2kg (4x576 q, 13 k) + kg2rg (4x13 q, 576 k), E=256, 8 heads",
         "launches": train_launches["fused_mha_bwd"], "max_abs_err": b3_err,
         "launches_workflow": workflow_launches["fused_mha_bwd"],
         "ms": sum(v["ms"] for v in b3.values()),
         "host_ms": sum(v["host_ms"] for v in b3.values()),
         "ms_no_d_probs": sum(v["ms_no_d_probs"] for v in b3.values()),
         "host_ms_no_d_probs": sum(v["host_ms_no_d_probs"] for v in b3.values()),
         "kernel_launches_per_call": {n: v["kernel_launches_per_call"] for n, v in b3.items()},
         "plain_ms": sum(v["plain_ms"] for v in b3.values()),
         "bound_ms": b3_bound[0], "bound_by": b3_bound[1],
         "library_ms": sum(v["library_ms"] for v in b3.values())},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
