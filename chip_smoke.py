#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--batches N] [--profile TRACE_JSON]
    python3 chip_smoke.py --b2-digest
    python3 chip_smoke.py --rg-lr-probe
    python3 chip_smoke.py --build-cost

Seven paths of the port are driven: multimodal inference
(``MultimodalPredictor``), fusion training (``FusionTrainer``),
region-graph training (``RGTrainer``), knowledge-graph training with its
embedding factory (``KGTrainer``), the workflow that joins them
(extraction → matched fusion dataset → fusion epoch, directory evaluation
and directory testing), serving through the CLI (``InferenceService``
behind ``make_server``, ``cli serve`` and six more subcommands), RG
training, fusion training and directory evaluation data-parallel over
``torch.distributed`` ranks, and fusion training tensor-parallel over the
mesh's ``model`` axis with the multimodal pipeline's image rows split over
it (spatial sharding), and the JAX package's top-level API on the port
(``detect_camouflage`` and ``MultimodalPredictor`` through the package's
lazy names) with the optional Neo4j export, the port's bench, bench
sweep, stage profile and host ceiling at the JAX bench's four
configurations, and the JAX system's last entry points on the port: the
serve latency A/B, the connectivity profile, the checkpoint migration and
the graft entry with its multichip dry run, and the JAX package's native
host data path on the port (the threaded C++ decoder under the bench's end
to end, and the C++ graph builder).

Phases, each failing the run (nonzero exit, no result line) when it fails:

0. the versions of the host packages PIL, matplotlib and PyYAML (``null``
   for a missing one); the figure and config steps of phase 9c run only
   where their package is present, and a skipped step prints a line of its
   own;
1. build every CUDA kernel of ``camouflage_multimodal_tpu_torch/csrc`` with
   nvcc (one process per source, all started together) and, beside them,
   the two host libraries of ``csrc/host`` with g++ (``native.py``), each
   one's seconds printed;
2. kernel B1 ``slic_assign`` against its plain PyTorch version at the main
   path's shapes (4 images of 256², K = 529 centers, step 11), on the seed
   centers, on centers from a real SLIC state and on jittered centers, with
   every center collapsed into one pixel tile (the candidate list holds all
   K), with half of the centers pushed off the image, on a ragged 97 × 131
   image at 60 segments and at 352² and 416² with 500 segments: labels must
   be equal (both compute the same float32 operations in the same order, so
   there are no ties to excuse). Prints the mean and the largest length of
   the kernel's per-tile candidate lists;
2b. the ops library at the JAX package's contract (``ops_surface``): B1
   against its plain version at K = 10,816 (416², 12,000 segments) and
   K = 7,744 (352², 8,000), beyond one 1,024-center chunk of its candidate
   list, on seed and fifth-iteration centers, with its time, device time a
   launch (``torch.profiler``), plain time and bound; B1 at the main path's
   K = 529 (4 × 256²) giving the digests of the kernel before its list was
   chunked, with the same times; ``slic`` with each backend (``"window"``,
   ``"exact"``) on the card against the CPU on one 352² image at
   compactness 20 with RGB features: ≥ 99.5 % of labels equal; the
   connectivity dispatcher against the per-pixel path on raw maps of 4 ×
   256², 16 × 352² and 16 × 416² seeded images (500 segments): labels equal
   to the bit, the fallback flag, the runs path's labels and counts, rounds
   and raw components equal to the CPU's per-pixel path, and the per-pixel
   and runs paths' host ms and event ms (each call ending in a device→host
   pull) and device busy ms (``torch.profiler``);
   Canny at thresholds (0.05, 0.15) and (0.2, 0.4) on contrast-stretched
   images, card vs CPU: at most 0.1 % of pixels differ;
3. kernel B2 ``fused_mha`` against its plain version with the committed
   fusion weights in both directions of the main path (4 × 640 queries ×
   13 keys and 4 × 13 queries × 640 keys, partial key masks), the same at
   batch 8 as directory testing calls it and at batches 1 and 2 (the
   serving buckets below 4), at the training shapes (576; at batch 4, and
   at batches 2 and 1, the per-rank blocks of a batch of 4 over two and
   four ranks), at the bench's 512-node bucket (352² and 416², 500
   segments) in both directions at batches 16 and 32, and on a ragged case
   (37 queries × 75 keys, one batch row with every key masked): out within
   rtol/atol 1e-4, probabilities within rtol 1e-3 / atol 2e-3, a repeat
   bit-equal, and
   what it keeps for B3 (projected q, k, v, the context, the split pass's
   softmax max and sum) against plain products;
4. kernel B3 ``fused_mha_bwd``, the gradient of B2, against its plain
   backward through ``torch.autograd`` on the card: the training shapes
   (4 × 576 × 13 and 4 × 13 × 576, and at batches 2 and 1, a rank's block
   of batch 4 over two and four ranks), the inference ones (640) and a
   ragged case (37 queries × 101 keys), partial key masks plus, from batch
   3 up, one batch row with every key masked, with a non-zero cotangent for the attention maps and
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
5b. the top-level API (``surface``): a seeded 256² PNG through
   ``camouflage_multimodal_tpu_torch.detect_camouflage`` (the package's
   lazy name; ``rg_model.ckpt``, 500 segments, no figures): B1 exactly 10
   launches, B2 none; ``camouflage_multimodal_tpu_torch.MultimodalPredictor``
   on the three committed artifacts, ``predict_batch`` on the same image at
   batch 1: B1 10, B2 2; the two heatmaps and mean scores within 1e-5. Then
   ``kg.neo4j_compat.export_to_neo4j`` of phase 8's synthetic annotations
   through a ``neo4j`` stub put in ``sys.modules`` for the call alone,
   which counts what it is sent: 8 constraints, one write transaction, one
   statement per node and per organism link, the write count equal to the
   store's nodes, the driver closed; without a driver the export's
   ``RuntimeError``. Launch counts are zeroed just before each call and
   read just after;
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
9b. serving: B1 against its plain version at buckets 1 and 2 (seed and
   fifth-iteration centers: labels equal); ``InferenceService`` over the
   committed weights at batch 8 and 5 ms wait, warmed (every bucket run
   once before the batcher drains), behind ``make_server`` on port 0; 64
   seeded 256² PNGs from 16 client threads (every fourth with
   ``?heatmap=1``). Launch counters zeroed just before the burst and read
   just after: B1 exactly 10 and B2 2 per batch, B3 never. Then 8
   sequential requests, which must each run at bucket 1. Every response
   has the JAX keys; its ints and band equal, and its floats within 1e-5
   of, ``predict_batch`` on its image alone (after the server is closed),
   its heatmap PNG within one level. Prints /stats (requests, batches,
   occupancy, p50 / p95), the burst's requests per second, the
   sequential p50 and ``predict_batch``'s own ms at each bucket. Then ``python -m camouflage_multimodal_tpu_torch.cli
   serve`` as a subprocess: /healthz polled until its warmup ends, 4 PNGs
   answered as in-process (same bars), start-up seconds printed;
9c. the CLI in-process (``cli.main``): ``detect`` (figures, where
   matplotlib is present; else ``api.detect_camouflage(save_figures=False)``),
   ``test-multimodal --image-dir`` and ``evaluate`` on 32 files of the
   workflow's kind, ``ingest-kg``, ``train-kg`` (one epoch) and
   ``extract-kg`` on phase 8's synthetic annotations: seconds and files of
   each, the files checked; ``load_config`` of the committed YAML (where
   PyYAML is present);
9d. data parallelism (``parallel/``): phase 7's RG fit and phase 6's
   fusion fit (dropout 0, lr 1e-3 and 5e-4) without a mesh and with a
   world-1 mesh under NCCL in this process (``parallel.distributed.initialize``
   on 127.0.0.1 and a free port, ``make_mesh``): histories and parameters
   equal to the bit, or within the bars of (b), with the fits' seconds
   (fusion as ms per step); launch counts zeroed just before each fit and
   read just after: B1 20 in the RG fit (all in its build), B2 and B3 as
   in phase 6. Then (b): two processes of this script on this one card
   (``--dp-rank``, gloo, ``LOCAL_RANK=0``), each running both fits with a
   two-rank mesh and ``evaluate_directory(data_parallel=True)`` on the
   workflow's 32 files at batch 16: both ranks end equal to the bit;
   histories against (a) within 1e-4 relative (the validation losses
   1e-3),
   parameters within 3·lr (RG's BatchNorm-fed biases and running means
   2·lr·steps); the report within 1e-6 of one process's. Each rank's
   launches: its half of the RG build (B1 10 each, 20 together), B2 and
   B3 as one rank's fusion fit (each step on half the batch), B1 20 in
   evaluation (its half of every batch). A rank that fails or takes more
   than 420 s fails the run;
9e. the model axis and spatial sharding (``parallel.sharding``): B2 and B3
   on each model rank's 4 of the 8 heads (E_in 256, E_loc 128, no bo,
   probabilities over the 8 heads) in both directions of the training
   bucket at batches 4 and 2 against their plain versions at the bars of
   phases 3 and 4 (the maps at 1e-3 relative / 1e-5 absolute, below a
   rank's entries), with and without a cotangent for the maps, repeats
   bit-equal, one launch a call, the two ranks' outputs plus bo within 1e-4
   of the whole attention and their maps summed within the maps' bar of
   the whole map; their device times, plain times and bounds at
   the (1, 2) fit's shapes. Then phase 6's fusion fit (lr 5e-4, with a best
   checkpoint) and the multimodal pipeline over the committed weights at
   batches 1 and 4 (256², 500 segments, 640-node bucket, 10 SLIC
   iterations) in this process, and two processes of this script on this
   card (``--mp-rank``, gloo, ``LOCAL_RANK=0``) on a (1, 2) mesh, each
   running the fit with the heads and FFN columns split over the model axis
   and the pipeline with ``spatial=True`` (128 rows each): both ranks equal
   to the bit; the fit's histories and parameters within phase 9d's bars
   of the one-process fit, its gathered best checkpoint the one-process
   file's layout within 3·lr, loaded by ``api.load_multimodal_model``; each
   batch's segments ≥ 99.5 % equal to the unsharded pipeline's, heatmaps
   within 1e-4 where they agree, equal live-node counts, the fusion's
   probabilities and score within 1e-3. Each rank's launches: B2 and B3 as
   one process's fit, B1 10 and B2 2 per pipeline batch. Per-rank seconds
   are printed (two ranks on one card show correctness, not speed). A rank
   that fails or takes more than 420 s fails the run;
9f. the port's bench (``python -m camouflage_multimodal_tpu_torch.bench``)
   at the JAX bench sweep's four rows (256² / 16, 352² / 16, 352² / 32,
   416² / 16) through the port's sweep (``scripts/bench_sweep.py``, a
   process a row) with ``BENCH_ITERS=10`` and ``BENCH_E2E_PASSES=2``, on 64
   seeded 1024 × 768 JPEGs written for it: each row's JSON line printed
   with every key of the JAX bench's line (``BENCH_r05.json``), backend
   ``cuda``, and exactly 10 B1 and 2 B2 launches per pipeline forward of
   the row's run (B3 none). Then one 352² batch of 16 on the bench's models
   (launch counts zeroed just before, read just after: B1 10, B2 2), its
   ``torch.profiler`` breakdown (device busy and idle share, the stages'
   host and device ms), its first 4 images against the CPU (segment maps
   ≥ 99 % equal, heatmap MAE ≤ 1e-2, the fusion outputs — mask, instance
   and edge logits, score, mask probability — within 1e-3 as in serving);
   then the stage profile (``scripts/profile_stages.py``) and the host
   ceiling (``scripts/host_ceiling.py``) at 352² / 16, their lines printed;
9g. the JAX system's last runnable entry points on the port, on 9f's JPEG
   scenes (``scripts``): the serve latency A/B
   (``scripts/serve_latency_ab.py``) in both modes at 256², batch 8, 40
   sequential requests through ``MicroBatcher`` on the committed artifacts,
   its p50 and p95, exactly 10 B1 and 2 B2 launches per forward, every
   response within 1e-5 of ``predict_batch`` on its image alone; the
   connectivity profile (``scripts/profile_connectivity.py``) at 16 × 352²
   and 500 segments: CC ms, full ms, merge + relabel by difference, CC
   sweeps per image, each half's device-busy ms and five longest kernels,
   B1 10 launches for the raw labels; the checkpoint migration
   (``scripts/migrate_checkpoints.py``) as a subprocess on a temporary
   directory with one legacy pickle, one npz file and one pickle naming
   ``os.system``: 1 migrated, 1 skipped, 1 refused, exit code 1, the
   migrated file's leaves equal to the bit under the port's loader, the
   refused file unchanged; the graft entry (``graft_entry.entry``) on the
   card: finite outputs, B1 4 and B2 2 launches a call, its ms; then
   ``graft_entry.dryrun_multichip(2)`` and ``(4)`` on this card (gloo
   ranks sharing it): the ``ok`` lines with meshes (2, 1) and (2, 2), per
   rank B2 2 and B3 2 in the fusion step and B1 2 in each RG forward, every
   rank's fusion loss within 1e-5 of one CPU process's step, and seconds;
9h. the native host data path (``native``), on 9f's JPEG scenes: the
   threaded decoder's uint8 batch of all 64 scenes at 352² equal to the
   bit to PIL's (``data.load_image_u8``), and its float gray batch of 8
   seeded 1024 × 768 PNG masks equal to the bit to ``data.load_mask``; the
   decode ms an image of a batch of 16 at 352² with 1, 2, 4 and 8 threads
   and the host's core count, full and draft, beside PIL's on one thread;
   the bench's end to end (``bench.run_e2e``, its decode ∥ upload ∥
   compute loop) at 352² / 16 on the bench's models, native and PIL in
   turns, two passes each, full and draft: ``value``, e2e median and draft
   rate for each decoder, exactly 10 B1 and 2 B2 launches per forward of
   each, native batches counted in the native runs and none in the PIL
   runs; the C++ graph builder on one 256² scene (500 segments, the
   640-node bucket) against the card's ``pipeline.build_region_graphs``:
   SLIC agreement > 0.97, Canny IoU > 0.95 (the card's ``ops.canny``), and
   the card's ``region_features`` on the builder's own segmentation within
   rtol 5e-3 / atol 5e-4 of its features on the nodes both keep;
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

Prints JSON lines per phase and the script's total seconds, then the card's name and power limit, the
kernel table line, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. TF32 is disabled for
matmuls and cuDNN: every reference number is float32.
"""

from __future__ import annotations

import argparse
import importlib
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
# inference bucket (batch 4, batch 8 as directory testing calls it, and
# batches 1 and 2, the serving buckets below 4), at the training bucket
# (batch 4, and batches 2 and 1, a rank's block of it over two and four
# ranks) and at the bench's 512-node bucket (352² and 416², 500 segments)
# at its batches 16 and 32, and a ragged case.
B2_SHAPES = (("rg2kg", BATCH, 640, 13), ("kg2rg", BATCH, 13, 640),
             ("rg2kg_b8", 8, 640, 13), ("kg2rg_b8", 8, 13, 640),
             ("rg2kg_b1", 1, 640, 13), ("kg2rg_b1", 1, 13, 640),
             ("rg2kg_b2", 2, 640, 13), ("kg2rg_b2", 2, 13, 640),
             ("rg2kg_576", BATCH, TRAIN_NODES, 13), ("kg2rg_576", BATCH, 13, TRAIN_NODES),
             ("rg2kg_576_b2", 2, TRAIN_NODES, 13), ("kg2rg_576_b2", 2, 13, TRAIN_NODES),
             ("rg2kg_576_b1", 1, TRAIN_NODES, 13), ("kg2rg_576_b1", 1, 13, TRAIN_NODES),
             ("rg2kg_512_b16", 16, 512, 13), ("kg2rg_512_b16", 16, 13, 512),
             ("rg2kg_512_b32", 32, 512, 13), ("kg2rg_512_b32", 32, 13, 512),
             ("ragged_37x75", BATCH, 37, 75))
# (name, batch, queries, keys) of B3's checks: both directions at the
# training bucket (batch 4, and a rank's block of it over two and four
# ranks) and at the inference bucket, and a ragged case.
B3_SHAPES = (("rg2kg", BATCH, TRAIN_NODES, 13), ("kg2rg", BATCH, 13, TRAIN_NODES),
             ("rg2kg_b2", 2, TRAIN_NODES, 13), ("kg2rg_b2", 2, 13, TRAIN_NODES),
             ("rg2kg_b1", 1, TRAIN_NODES, 13), ("kg2rg_b1", 1, 13, TRAIN_NODES),
             ("rg2kg_640", BATCH, 640, 13), ("kg2rg_640", BATCH, 13, 640),
             ("ragged_37x101", BATCH, 37, 101))
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

NATIVE_BUILD = {}          # host library → seconds its build took (phase 1)


def build_native():
    """Build (or load) the port's two host libraries with g++, timing each."""
    from camouflage_multimodal_tpu_torch import native

    for name in native.LIBRARIES:
        t0 = time.perf_counter()
        cached = native.library_path(name).exists()
        native.library(name)
        NATIVE_BUILD[name] = {"seconds": time.perf_counter() - t0, "cached": cached}


def phase_build(kernels):
    """nvcc for every CUDA kernel and, in a thread beside it, g++ for the
    host libraries."""
    import threading

    t0 = time.perf_counter()
    errors = []

    def host():
        try:
            build_native()
        except RuntimeError as e:
            errors.append(str(e))

    thread = threading.Thread(target=host)
    thread.start()
    reports = kernels.build_all()
    for name in kernels.KERNELS:
        kernels.library(name)
    thread.join()
    if errors:
        fail(f"the host libraries did not build: {errors[0]}")
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in reports.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": ptxas, "host_libraries": NATIVE_BUILD})


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


# The ops library at the JAX package's contract (phase 2b).
OPS_LARGE_K = ((416, 12000), (352, 8000))          # K = 10,816 and 7,744
# SHA-256 (first 16 hex digits) of B1's labels at the main path's K = 529 on
# phase 2b's inputs (4 images ``synthetic_images(263, 4, 256)``, seed and
# fifth-iteration centers) from the kernel before its candidate list was
# chunked (the whole list in shared memory), on an H100: the chunked kernel
# must give the same bits.
B1_K529_DIGESTS = {"seed": "041cc9ea8daf47fb", "iter5": "1dee6b7cb9e61633"}
CONN_SIZES = ((4, 256), (16, 352), (16, 416))      # (batch, size) of the raw maps
CONN_REPS = 5
SLIC_BACKEND_SIZE = 352
CANNY_THRESHOLDS = ((0.05, 0.15), (0.2, 0.4))


def device_ms_per_launch(torch, fn, kernel: str, calls: int = 20):
    """Mean device time of one launch of the CUDA kernel named ``kernel``
    over ``calls`` calls of ``fn`` under ``torch.profiler`` ("not measured"
    when three windows come back without a record of it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and kernel in ev.name]
        if us:
            return sum(us) / len(us) / 1e3
    return "not measured"


def b1_times(torch, slic_mod, pix, centers, prev, step, ratio, width):
    """B1's time as called, its device time a launch, its plain version's
    time and its bound on these inputs."""
    def call():
        return slic_mod.slic_assign(pix, centers, prev, ratio, step, width=width)

    B, HW, _ = pix.shape
    pairs = in_box_pairs(torch, pix, centers, step)
    bound = bound_ms(B * HW * (5 * 4 + 4 + 4) + B * centers.shape[1] * 5 * 4, pairs * 16)
    return {"ms": cuda_ms(call, reps=50),
            "device_ms": device_ms_per_launch(torch, call, "slic_assign_kernel"),
            "plain_ms": cuda_ms(lambda: slic_mod.slic_assign_plain(pix, centers, prev, ratio, step),
                                reps=2, rounds=3),
            "bound_ms": bound[0], "bound_by": bound[1], "in_box_pairs": pairs}


def label_digest(labels) -> str:
    import hashlib

    return hashlib.sha256(labels.cpu().numpy().tobytes()).hexdigest()[:16]


def timed_path(torch, fn, reps: int = CONN_REPS):
    """Median host ms and event ms of ``fn()``, each call ending in a
    device→host pull of its output, and its device busy ms a call. The
    events are recorded around host-synchronising code, so their interval
    is wall time between enqueues, close to the host ms whatever the card
    does; the busy time (``torch.profiler``) is the card's own."""
    from camouflage_multimodal_tpu_torch.core.profiling import device_busy_ms

    host, dev = [], []
    out = fn()
    torch.cuda.synchronize()
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        labels = out[0] if isinstance(out, tuple) else out
        labels.reshape(-1)[-1].item()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    return sorted(host)[reps // 2], sorted(dev)[reps // 2], device_busy_ms(fn, reps)


def phase_ops_surface(torch, slic_mod):
    """Phase 2b: B1 at large K and unchanged at K = 529, ``slic``'s two
    backends, the connectivity dispatcher against the per-pixel path, and
    Canny's thresholds, each on the card against the plain or CPU result."""
    conn = importlib.import_module("camouflage_multimodal_tpu_torch.ops.connectivity")
    canny_mod = importlib.import_module("camouflage_multimodal_tpu_torch.ops.canny")
    from camouflage_multimodal_tpu_torch.ops.image import rgb_to_gray
    from camouflage_multimodal_tpu_torch.pipeline import padded_nodes

    # (a) B1 at large K: one chunk of the list is 1,024 centers.
    large_k = []
    for size, n_segments in OPS_LARGE_K:
        imgs = synthetic_images(7 + size, 1, size)
        pix, c0, _, step, ratio = slic_state(torch, slic_mod, imgs, 0, n_segments)
        _, c5, prev5, _, _ = slic_state(torch, slic_mod, imgs, 5, n_segments)
        err = check_slic_cases(torch, slic_mod, [
            (f"large_k_{size}_seed", size, size, pix, c0, torch.zeros_like(prev5), step, ratio),
            (f"large_k_{size}_iter5", size, size, pix, c5, prev5, step, ratio)])
        rec = {"size": size, "n_segments": n_segments, "k": int(c0.shape[1]), "step": step,
               "max_abs_err": err,
               **b1_times(torch, slic_mod, pix, c5.contiguous(), prev5, step, ratio, size)}
        large_k.append(rec)
        emit({"phase": "ops_surface_b1_large_k", **rec})

    # (b) B1 at the main path's K = 529: the unchunked kernel's bits, its time.
    imgs = synthetic_images(7 + SIZE, BATCH, SIZE)
    pix, c0, _, step, ratio = slic_state(torch, slic_mod, imgs, 0)
    _, c5, prev5, _, _ = slic_state(torch, slic_mod, imgs, 5)
    digests = {}
    for name, c, prev in (("seed", c0, torch.zeros_like(prev5)), ("iter5", c5, prev5)):
        got = slic_mod.slic_assign(pix, c.contiguous(), prev, ratio, step, width=SIZE)
        digests[name] = label_digest(got)
    k529 = {"k": int(c0.shape[1]), "digests": digests,
            "digests_equal_unchunked": digests == B1_K529_DIGESTS,
            **b1_times(torch, slic_mod, pix, c5.contiguous(), prev5, step, ratio, SIZE)}
    emit({"phase": "ops_surface_b1_k529", **k529})
    if digests != B1_K529_DIGESTS:
        fail(f"B1 at K = 529 changed its bits: {digests} != {B1_K529_DIGESTS}")

    # (c) slic on the card vs the CPU, both backends, one 352² image.
    img = torch.from_numpy(synthetic_images(31, 1, SLIC_BACKEND_SIZE)[0]).float() / 255.0
    for backend in ("window", "exact"):
        kw = dict(compactness=20.0, convert_lab=False, backend=backend,
                  enforce_connectivity=False, return_drift=True)
        got, drift = slic_mod.slic(img.cuda(), **kw)
        want, want_drift = slic_mod.slic(img, **kw)
        equal = float((got.cpu() == want).float().mean())
        emit({"phase": "ops_surface_slic", "backend": backend, "size": SLIC_BACKEND_SIZE,
              "labels_equal": equal, "drift": float(drift), "cpu_drift": float(want_drift)})
        if equal < 0.995 or got.shape != want.shape:
            fail(f"slic(backend={backend!r}) on the card agrees on {equal} of the labels")

    # (d) the connectivity dispatcher against the per-pixel path.
    times = {}
    for batch, size in CONN_SIZES:
        images = torch.from_numpy(synthetic_images(40 + size, batch, size)).cuda().float() / 255.0
        raw = slic_mod.slic(images, backend="exact", enforce_connectivity=False)
        kw = dict(n_segments=500, max_labels=padded_nodes(500, size))
        out, fallback = conn.enforce_label_connectivity_batched(raw, return_fallback=True, **kw)
        pixel = conn.enforce_label_connectivity(raw, **kw)
        # The runs path's telemetry against the CPU's per-pixel path, with a
        # bucket that holds every row-run (so it is exact whatever the count).
        flags = dict(return_count=True, return_rounds=True, return_raw_count=True)
        runs = conn.enforce_label_connectivity_runs(raw, run_bucket=size * size, **kw, **flags)
        cpu = conn.enforce_label_connectivity(raw.cpu(), **kw, **flags)
        counts_equal = all(torch.equal(a.cpu(), b) for a, b in zip(runs[1:], cpu[1:]))
        rec = {"batch": batch, "size": size, "fallback": fallback,
               "equal_to_per_pixel": bool(torch.equal(out, pixel)),
               "runs_equal_to_cpu": bool(torch.equal(runs[0].cpu(), cpu[0])),
               "counts_rounds_raw_equal_to_cpu": counts_equal,
               "rounds": [int(x) for x in runs[2]], "raw_components_max": int(runs[3].max()),
               "row_runs_max": int(conn._row_run_starts(raw).sum(dim=(1, 2)).max()),
               "run_bucket": size * size // 4}
        # The dispatcher is the per-pixel path; the runs path is timed as the
        # record of why it is not dispatched.
        paths = {"per_pixel": lambda: conn.enforce_label_connectivity(raw, **kw)}
        if not fallback:
            paths["runs"] = lambda: conn.enforce_label_connectivity_runs(raw, **kw)
        for name, fn in paths.items():
            (rec[f"{name}_host_ms"], rec[f"{name}_event_ms"],
             rec[f"{name}_device_busy_ms"]) = timed_path(torch, fn)
        times[f"{batch}x{size}"] = rec
        emit({"phase": "ops_surface_connectivity", **rec})
        if not (rec["equal_to_per_pixel"] and rec["runs_equal_to_cpu"] and counts_equal):
            fail(f"connectivity paths disagree at {batch} x {size}^2: {rec}")

    # (e) Canny at the non-default thresholds, card vs CPU, on contrast-
    # stretched images (edges above both thresholds).
    gray = rgb_to_gray(torch.from_numpy(synthetic_images(50, BATCH, SIZE)).float() / 255.0)
    gray = torch.clamp(0.5 + 4.0 * (gray - gray.mean()), 0.0, 1.0)
    for low, high in CANNY_THRESHOLDS:
        got = canny_mod.canny(gray.cuda(), 2.0, low, high).cpu()
        want = canny_mod.canny(gray, 2.0, low, high)
        differ = float((got != want).float().mean())
        emit({"phase": "ops_surface_canny", "low": low, "high": high,
              "pixels_differing": differ, "edge_pixels": int(want.sum())})
        if differ > 1e-3 or not want.any():
            fail(f"Canny ({low}, {high}) differs on {differ} of the pixels")
    return {"large_k": large_k, "k529": k529, "connectivity": times}


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


def mha_bwd_case(torch, attention_mod, fusion_model, nq, nk, batch=BATCH):
    """Inputs of one B3 check: ``mha_inputs`` with values of their own, the
    third batch row's keys all masked (where there is one), leaves that
    require grad, and seeded cotangents for both outputs."""
    params, q, k, mask = mha_inputs(torch, fusion_model, nq, nk, seed=1000 + nq + batch - BATCH,
                                    batch=batch)
    g = torch.Generator(device="cuda").manual_seed(2000 + nq + batch - BATCH)
    v = torch.randn(k.shape, generator=g, device="cuda") * 0.5
    mask = mask.clone()
    if batch > 2:
        mask[2] = False
    d_out = torch.randn(q.shape, generator=g, device="cuda")
    d_probs = torch.randn(batch, nq, nk, generator=g, device="cuda")
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
    for name, batch, nq, nk in B3_SHAPES:
        leaves, mask, d_out, d_probs = mha_bwd_case(torch, attention_mod, fusion_model, nq, nk,
                                                    batch)
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
            emit({"phase": "fused_mha_bwd_check", "direction": name, "batch": batch,
                  "nq": nq, "nk": nk,
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
    slic_mod = importlib.import_module("camouflage_multimodal_tpu_torch.ops.slic")
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
    slic_mod = importlib.import_module("camouflage_multimodal_tpu_torch.ops.slic")
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
          "note": "end to end from the files: native decode threads, uploads and downloads included; "
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
          "note": "end to end from the files, native decode included; serial runs wait for "
                  "each stage; evaluation loads its checkpoint in every run"})


# ---------------------------------------------------------------------------
# Serving and the CLI
# ---------------------------------------------------------------------------

SERVE_BATCH = 8            # MicroBatcher buckets 1, 2, 4, 8
SERVE_WAIT_MS = 5.0
SERVE_REQUESTS = 64
SERVE_CLIENTS = 16
SERVE_SEQUENTIAL = 8
CLI_SERVE_REQUESTS = 4
CONFIG = "configs/multimodal_config.yaml"


def phase_host_packages():
    """Versions of the host packages the figures (matplotlib), ``--config``
    (PyYAML) and decoding (PIL) need; ``None`` for a missing one."""
    versions = {}
    for name, module in (("PIL", "PIL"), ("matplotlib", "matplotlib"), ("PyYAML", "yaml")):
        try:
            versions[name] = importlib.import_module(module).__version__
        except ImportError:
            versions[name] = None
    emit({"phase": "host_packages", "versions": versions})
    if versions["PIL"] is None:
        fail("PIL is missing: the serving path decodes images with it")
    return versions


def skipped(step, package):
    emit({"phase": "skipped", "step": step, "reason": f"{package} is not installed"})


def png_bytes(image) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def post(url, body, timeout=120):
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def get(url, timeout=10):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def percentile_ms(seconds, q):
    s = sorted(seconds)
    return 1e3 * s[min(int(len(s) * q), len(s) - 1)]


def response_diffs(np, got, want):
    """(fields whose ints or band differ, largest float difference) of two
    ``/predict`` responses."""
    bad = [k for k in ("mask_pred", "instance_pred", "classification") if got[k] != want[k]]
    if "latency_ms" not in got or set(got) - {"latency_ms"} != set(want) - {"latency_ms"}:
        bad.append("keys")
    err = max(float(np.abs(np.subtract(got[k], want[k])).max())
              for k in ("mask_prob", "edge_prob", "score"))
    return bad, err


def phase_serve(torch, np, kernels, api, slic_mod):
    """The serving path in-process: B1 first held to its plain version at
    buckets 1 and 2; ``InferenceService`` over the committed weights at batch 8 and
    5 ms wait, warmed, behind ``make_server`` on port 0; 64 seeded PNGs from
    16 client threads (every fourth with ``?heatmap=1``), then 8 sequential
    requests; every response against ``predict_batch`` of its image alone,
    run after the server is closed. Times ``predict_batch`` alone at each
    bucket first. Returns (the burst's launches, the responses by image
    index, the images)."""
    import base64
    import io
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from camouflage_multimodal_tpu_torch.serve import InferenceService, make_server

    images = synthetic_images(300, SERVE_REQUESTS + SERVE_SEQUENTIAL, SIZE)
    for b in (1, 2):                               # the buckets below 4
        check_slic_batch(torch, slic_mod, images[:b], "serve")
    bodies = [png_bytes(img) for img in images]
    predictor = api.MultimodalPredictor(*ARTIFACTS, device="cuda")
    service = InferenceService(predictor, batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS)
    if not np.array_equal(service.decode(bodies[0]), images[0]):
        fail("the service does not decode a 256² PNG losslessly")
    t0 = time.perf_counter()
    service.warmup()
    warmup_s = time.perf_counter() - t0
    bucket_ms = {}                                 # predict_batch alone, median of 3
    for b in service.batcher.buckets:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            predictor.predict_batch(images[:b])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        bucket_ms[str(b)] = sorted(times)[1]
    buckets = []                                   # batch size of every predictor call
    predict = service.batcher.predict_fn

    def recorded(batch):
        buckets.append(int(batch.shape[0]))
        return predict(batch)

    service.batcher.predict_fn = recorded
    server = make_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    responses = {}
    try:
        before = get(url + "/stats")
        torch.cuda.synchronize()
        kernels.reset_launches()

        def ask(i):
            t = time.perf_counter()
            resp = post(url + ("/predict?heatmap=1" if i % 4 == 0 else "/predict"), bodies[i])
            return i, resp, time.perf_counter() - t

        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            burst = list(pool.map(ask, range(SERVE_REQUESTS)))
        burst_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        after = get(url + "/stats")
        burst_buckets = list(buckets)
        sequential = [ask(i) for i in range(SERVE_REQUESTS, SERVE_REQUESTS + SERVE_SEQUENTIAL)]
        final = get(url + "/stats")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    for i, resp, _ in burst + sequential:
        responses[i] = resp
    batches = after["batches"] - before["batches"]
    emit({"phase": "serve_burst", "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
          "batch_size": SERVE_BATCH, "max_wait_ms": SERVE_WAIT_MS, "warmup_seconds": warmup_s,
          "predict_batch_ms_by_bucket": bucket_ms,
          "stats": after, "burst_batches": batches,
          "burst_mean_occupancy": (after["requests"] - before["requests"]) / max(batches, 1),
          "buckets_run": {str(b): burst_buckets.count(b) for b in sorted(set(burst_buckets))},
          "requests_per_second": SERVE_REQUESTS / burst_s,
          "client_p50_ms": percentile_ms([s for _, _, s in burst], 0.5),
          "client_p95_ms": percentile_ms([s for _, _, s in burst], 0.95),
          "launches": launches,
          "note": "/stats latencies are submit to result inside the server, over every request "
                  "since warmup (its one request included); client times are the HTTP round trip"})
    want = {"slic_assign": SLIC_ITERS * batches, "fused_mha": 2 * batches, "fused_mha_bwd": 0}
    if launches != want:
        fail(f"the serving burst launched {launches}, expected {want} for {batches} batches")
    if (after["requests"] - before["requests"] != SERVE_REQUESTS or len(burst_buckets) != batches
            or sum(burst_buckets) < SERVE_REQUESTS):
        fail(f"the burst answered {after['requests'] - before['requests']} requests")
    seq_buckets = buckets[len(burst_buckets):]
    emit({"phase": "serve_sequential", "requests": SERVE_SEQUENTIAL, "buckets_run": seq_buckets,
          "client_p50_ms": percentile_ms([s for _, _, s in sequential], 0.5),
          "server_p50_ms": percentile_ms([r["latency_ms"] / 1e3 for _, r, _ in sequential], 0.5),
          "stats": final})
    if seq_buckets != [1] * SERVE_SEQUENTIAL:
        fail(f"sequential single requests ran at buckets {seq_buckets}, expected bucket 1")

    worst, bad_ints, heat_levels = 0.0, [], 0
    for i, resp in sorted(responses.items()):
        alone = predictor.predict_batch(images[i:i + 1])
        heatmap = alone["heatmap"][0]
        band, _ = api.classification_bands(float(heatmap.mean()))
        want_resp = {"mask_pred": int(np.argmax(alone["mask_logits"][0])),
                     "mask_prob": [float(p) for p in alone["mask_prob"][0]],
                     "instance_pred": int(np.argmax(alone["instance_logits"][0])),
                     "edge_prob": float(alone["edge_prob"][0, 0]),
                     "score": float(alone["score"][0, 0]), "classification": band}
        if "heatmap_png_base64" in resp:
            got = np.asarray(Image.open(io.BytesIO(base64.b64decode(resp["heatmap_png_base64"]))),
                             np.int32)
            heat_levels = max(heat_levels, int(np.abs(
                got - np.clip(heatmap * 255.0, 0, 255).astype(np.int32)).max()))
            want_resp["heatmap_png_base64"] = None
        bad, err = response_diffs(np, resp, want_resp)
        worst = max(worst, err)
        if bad:
            bad_ints.append((i, bad))
    emit({"phase": "serve_vs_alone", "responses": len(responses),
          "mismatched_ints_or_band": bad_ints, "max_abs_diff_floats": worst,
          "heatmap_png_max_level_diff": heat_levels})
    if bad_ints or worst > 1e-5 or heat_levels > 1 or len(responses) != len(images):
        fail(f"served responses disagree with predict_batch alone: {bad_ints}, floats {worst}, "
             f"heatmap levels {heat_levels}")
    return launches, responses, images


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_cli_serve(np, served, images):
    """``python -m camouflage_multimodal_tpu_torch.cli serve`` as a
    subprocess on the committed weights: /healthz polled until warmup ends,
    4 PNGs posted and compared with the in-process responses."""
    import signal
    import urllib.error

    port = free_port()
    cmd = [sys.executable, "-m", "camouflage_multimodal_tpu_torch.cli", "serve",
           "--checkpoint", ARTIFACTS[0], "--rg-model", ARTIFACTS[1], "--kg-embeddings", ARTIFACTS[2],
           "--host", "127.0.0.1", "--port", str(port), "--device", "cuda"]
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        while True:
            if proc.poll() is not None:
                fail(f"cli serve exited with {proc.returncode}: {proc.stdout.read()[-2000:]}")
            if time.perf_counter() - t0 > 300:
                fail("cli serve did not answer /healthz within 300 s")
            try:
                health = get(url + "/healthz", timeout=2)
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                time.sleep(0.25)
        startup_s = time.perf_counter() - t0
        worst, bad_ints = 0.0, []
        for i in range(CLI_SERVE_REQUESTS):
            resp = post(url + "/predict", png_bytes(images[i]))
            want = {k: v for k, v in served[i].items() if k != "heatmap_png_base64"}
            bad, err = response_diffs(np, resp, want)
            worst = max(worst, err)
            if bad:
                bad_ints.append((i, bad))
        stats = get(url + "/stats")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            log, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
    emit({"phase": "cli_serve", "command": " ".join(cmd[1:]), "startup_seconds": startup_s,
          "health": health, "stats": stats, "responses": CLI_SERVE_REQUESTS,
          "mismatched_ints_or_band": bad_ints, "max_abs_diff_floats_vs_in_process": worst,
          "exit_code": proc.returncode, "log": log.strip().splitlines()[-3:]})
    if bad_ints or worst > 1e-5 or stats["requests"] < CLI_SERVE_REQUESTS:
        fail(f"cli serve answers differ from the in-process service: {bad_ints}, floats {worst}")
    if health.get("backend") != "cuda":
        fail(f"cli serve reports backend {health.get('backend')}, not cuda")


def phase_cli(torch, np, cli, packages, out_dir):
    """The CLI in-process through ``cli.main``: ``detect``,
    ``test-multimodal --image-dir`` and ``evaluate`` on the workflow's 32
    files, then ``ingest-kg``, ``train-kg`` and ``extract-kg`` at one epoch
    on the KG phase's synthetic annotations; seconds and files of each."""
    import contextlib
    import io

    from camouflage_multimodal_tpu_torch import api

    root = os.path.join(out_dir, "cli")
    dirs, names = write_workflow_dataset(np, os.path.join(root, "data"))
    annot = os.path.join(root, "annotations")
    os.makedirs(annot)
    with np.load(ARTIFACTS[2]) as z:
        categories = list(z.files)
    for name, obj in synthetic_annotations(np, categories, KG_PER_CATEGORY):
        with open(os.path.join(annot, name), "w") as f:
            json.dump(obj, f)
    image, mask = os.path.join(dirs["images"], names[0]), os.path.join(
        dirs["gt_object"], names[0][:-4] + ".png")
    out = {k: os.path.join(root, k) for k in ("detect", "test", "kg")}
    steps = [
        ("detect", ["detect", "--image", image, "--model", ARTIFACTS[1], "--mask", mask,
                    "--output", out["detect"], "--device", "cuda"],
         [os.path.join(out["detect"], f"{p}_{names[0]}") for p in ("detection", "mask")]),
        ("test-multimodal", ["test-multimodal", "--checkpoint", ARTIFACTS[0], "--rg-model",
                             ARTIFACTS[1], "--kg-embeddings", ARTIFACTS[2], "--image-dir",
                             dirs["images"], "--output", out["test"], "--device", "cuda"],
         [os.path.join(out["test"], "batch_results.json")]),
        ("evaluate", ["evaluate", "--model", ARTIFACTS[1], "--image-dir", dirs["images"],
                      "--gt-dir", dirs["gt_object"], "--device", "cuda"], []),
        ("ingest-kg", ["ingest-kg", "--annotations", annot, "--output",
                       os.path.join(out["kg"], "kg_store.json"), "--processed-log",
                       os.path.join(out["kg"], "processed.txt")],
         [os.path.join(out["kg"], f) for f in ("kg_store.json", "processed.txt")]),
        ("train-kg", ["train-kg", "--store", os.path.join(out["kg"], "kg_store.json"),
                      "--epochs", "1", "--output", os.path.join(out["kg"], "kg.ckpt"),
                      "--device", "cuda"], [os.path.join(out["kg"], "kg.ckpt")]),
        ("extract-kg", ["extract-kg", "--model", os.path.join(out["kg"], "kg.ckpt"), "--store",
                        os.path.join(out["kg"], "kg_store.json"), "--output",
                        os.path.join(out["kg"], "emb"), "--device", "cuda"],
         [os.path.join(out["kg"], "emb", f) for f in
          ("all_embeddings.npz", "embedding_stats.json", "summary.json")]),
    ]
    os.makedirs(out["kg"])
    for what, argv, files in steps:
        if what == "detect" and packages["matplotlib"] is None:
            skipped("cli detect figures: api.detect_camouflage(save_figures=False) instead",
                    "matplotlib")
            t0 = time.perf_counter()
            _, mean_score, band, _ = api.detect_camouflage(image, ARTIFACTS[1], out["detect"], mask,
                                                           save_figures=False, device="cuda")
            torch.cuda.synchronize()
            emit({"phase": "cli", "command": "api.detect_camouflage(save_figures=False)",
                  "seconds": time.perf_counter() - t0, "mean_score": mean_score, "band": band})
            continue
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        lines = printed.getvalue().strip().splitlines()
        missing = [f for f in files if not os.path.exists(f)]
        emit({"phase": "cli", "command": what, "seconds": seconds,
              "files": [os.path.relpath(f, root) for f in files], "missing": missing,
              "printed": lines[-3:] if what != "evaluate" else None})
        if missing:
            fail(f"cli {what} did not write {missing}")
        if what == "evaluate":
            report = json.loads(printed.getvalue())
            if not all(np.isfinite(v) for v in report.values()):
                fail(f"cli evaluate printed non-finite metrics: {report}")
        if what == "test-multimodal":
            with open(files[0]) as f:
                if len(json.load(f)) != WORKFLOW_IMAGES:
                    fail("cli test-multimodal did not test every image")

    if packages["PyYAML"] is None:
        skipped(f"load_config({CONFIG})", "PyYAML")
        return
    from camouflage_multimodal_tpu_torch.core.config import default_config, load_config

    cfg = load_config(CONFIG)
    emit({"phase": "config", "path": CONFIG, "model": cfg["model"],
          "differs_from_defaults": sorted(k for k, v in cfg.items() if default_config()[k] != v)})
    if cfg["model"]["hidden_dim"] != 256 or cfg["checkpoint_dir"] != "checkpoints":
        fail(f"{CONFIG} did not load over the defaults")


# ---------------------------------------------------------------------------
# The JAX package's top-level API on the port
# ---------------------------------------------------------------------------

SURFACE_SEED = 41
SURFACE_SEGMENTS = 500
SURFACE_BAR = 1e-5         # the serving phase's bar against predict_batch
NEO4J_CONSTRAINTS = 8


def neo4j_stub():
    """(module, counts): a ``neo4j`` module whose driver counts what an
    export sends it and writes nothing anywhere."""
    import types

    counts = {"constraints": 0, "statements": 0, "transactions": 0, "closed": 0}

    class Tx:
        def run(self, query, **params):
            counts["statements"] += 1

    class Session:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def run(self, query):
            counts["constraints"] += 1

        def execute_write(self, fn):
            counts["transactions"] += 1
            return fn(Tx())

    class Driver:
        def session(self, database):
            return Session()

        def close(self):
            counts["closed"] += 1

    mod = types.ModuleType("neo4j")
    mod.GraphDatabase = types.SimpleNamespace(driver=lambda uri, auth: Driver())
    return mod, counts


def phase_surface(torch, np, kernels):
    """The top-level names of the package, resolved lazily as the JAX
    package's are: ``detect_camouflage`` on a seeded 256² PNG (B1 10
    launches) and ``MultimodalPredictor.predict_batch`` on the same image at
    batch 1 (B1 10, B2 2), heatmap and mean score within 1e-5 of each
    other; then ``kg.neo4j_compat.export_to_neo4j`` of the KG phase's
    annotations through a counting ``neo4j`` stub, and its ``RuntimeError``
    without a driver."""
    import camouflage_multimodal_tpu_torch as cm
    from camouflage_multimodal_tpu_torch.data import load_image_rgb
    from camouflage_multimodal_tpu_torch.kg import CamouflageKnowledgeStore
    from camouflage_multimodal_tpu_torch.kg.neo4j_compat import export_to_neo4j

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "surface.png")
        with open(png, "wb") as f:
            f.write(png_bytes(synthetic_images(SURFACE_SEED, 1, SIZE)[0]))
        (heatmap, mean_score, band, _), detect_s, detect_launches = counted(
            torch, kernels, lambda: cm.detect_camouflage(
                png, ARTIFACTS[1], tmp, n_segments=SURFACE_SEGMENTS, save_figures=False,
                device="cuda"))
        t0 = time.perf_counter()
        predictor = cm.MultimodalPredictor(*ARTIFACTS, n_segments=SURFACE_SEGMENTS,
                                           device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        image = load_image_rgb(png, SIZE)
        out, predict_s, predict_launches = counted(
            torch, kernels, lambda: predictor.predict_batch(image[None]))
    diffs = {"heatmap": float(np.abs(heatmap - out["heatmap"][0]).max()),
             "mean_score": abs(mean_score - float(out["heatmap"][0].mean()))}

    with np.load(ARTIFACTS[2]) as z:
        categories = list(z.files)
    store = CamouflageKnowledgeStore()
    for name, obj in synthetic_annotations(np, categories, KG_PER_CATEGORY):
        store.ingest_annotation(obj, name)
    nodes = sum(len(getattr(store, t)) for t in (
        "organisms", "environments", "assessments", "similarities", "observations"))
    links = sum(len(o["colors"]) + len(o["textures"]) + len(o["patterns"])
                for o in store.organisms.values())
    stub, counts = neo4j_stub()
    sys.modules["neo4j"] = stub
    try:
        t0 = time.perf_counter()
        writes = export_to_neo4j(store, "bolt://localhost:7687", "neo4j", "unused")
        export_s = time.perf_counter() - t0
    finally:
        del sys.modules["neo4j"]
    # ``None`` in ``sys.modules`` makes ``import neo4j`` fail whether or not
    # a driver is installed, so the export never reaches for a server.
    sys.modules["neo4j"] = None
    try:
        export_to_neo4j(store, "bolt://localhost:7687", "neo4j", "unused")
        missing_driver = None
    except RuntimeError as err:
        missing_driver = str(err)
    finally:
        del sys.modules["neo4j"]

    want_detect = {"slic_assign": SLIC_ITERS, "fused_mha": 0, "fused_mha_bwd": 0}
    want_predict = {"slic_assign": SLIC_ITERS, "fused_mha": 2, "fused_mha_bwd": 0}
    emit({"phase": "surface", "size": SIZE, "segments": SURFACE_SEGMENTS, "band": band,
          "detect_camouflage": {"launches": detect_launches, "expected_launches": want_detect,
                                "host_ms": 1e3 * detect_s},
          "predictor_build_host_ms": 1e3 * build_s,
          "predict_batch": {"batch": 1, "launches": predict_launches,
                            "expected_launches": want_predict, "host_ms": 1e3 * predict_s},
          "max_abs_diff": diffs, "bar": SURFACE_BAR,
          "neo4j_export": {"writes": writes, "store_nodes": nodes, **counts,
                           "host_ms": 1e3 * export_s},
          "missing_driver_error": missing_driver})
    if detect_launches != want_detect:
        fail(f"detect_camouflage launched {detect_launches}, expected {want_detect}")
    if predict_launches != want_predict:
        fail(f"predict_batch at batch 1 launched {predict_launches}, expected {want_predict}")
    if heatmap.shape != (SIZE, SIZE) or not np.isfinite(heatmap).all() \
            or not np.isfinite(out["heatmap"]).all():
        fail("detect_camouflage or predict_batch gave a non-finite or misshapen heatmap")
    if max(diffs.values()) > SURFACE_BAR:
        fail(f"detect_camouflage differs from predict_batch: {diffs}")
    if writes != nodes or counts != {"constraints": NEO4J_CONSTRAINTS,
                                     "statements": nodes + links, "transactions": 1,
                                     "closed": 1}:
        fail(f"export_to_neo4j wrote {writes} of {nodes} nodes with {counts}")
    if missing_driver is None or "neo4j driver not installed" not in missing_driver:
        fail(f"export_to_neo4j without a driver did not raise its RuntimeError: {missing_driver}")
    return {"detect_camouflage": detect_launches, "predict_batch": predict_launches}


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_RANK_TIMEOUT = 420      # seconds a rank of the two-rank run may take
DP_HISTORY_RTOL = 1e-4
# The validation losses are held to 1e-3 relative. RG's moves with the
# BatchNorm-fed biases (RG_GRADIENT_FREE), whose steps differ by up to
# 2·lr·steps between two runs that differ in the last bits
# (tests/test_torch_port_parallel.py holds it the same way). The fusion
# fit's is a saturated cross entropy on separable records (~7e-5, then
# ~2e-6 per sample), about exp(-margin): its relative change is the
# absolute shift of the logit margins, which parameters ~1e-4 apart move
# by a few 1e-4.
DP_VAL_RTOL = 1e-3
DP_RG_LR = 1e-3            # RGTrainer's and FusionTrainer's defaults
DP_FUSION_LR = 5e-4


def dp_fits(torch, np, kernels, mesh):
    """{"rg": ..., "fusion": ...}: phase 7's ``RGTrainer.fit`` on its 32
    images and phase 6's ``FusionTrainer.fit`` (device-resident, dropout
    0, the kernels on) on its 64 records, both with ``mesh``; each with its
    history, final state on the host, launch counts (zeroed just before the
    fit, read just after) and wall seconds."""
    from camouflage_multimodal_tpu_torch.models import region_graph as model_mod
    from camouflage_multimodal_tpu_torch.train import train_fusion as train_mod
    from camouflage_multimodal_tpu_torch.train import train_rg

    quiet = dict(log_fn=lambda *_: None)
    out = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer = train_rg.RGTrainer(model=rg_model(torch, model_mod), learning_rate=DP_RG_LR)
    model, history = trainer.fit(BlobDataset(np, RG_IMAGES), epochs=RG_EPOCHS, batch_size=BATCH,
                                 seed=0, checkpoint_path=None, mesh=mesh, device="cuda", **quiet)
    torch.cuda.synchronize()
    out["rg"] = {"seconds": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES),
                 "history": history}
    out["rg"]["state"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    ds = train_mod.FusionDataset.from_samples(train_records(np), **quiet)
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer = train_mod.FusionTrainer(model_config={"dropout": 0.0, "use_pallas": True},
                                      learning_rate=DP_FUSION_LR)
    model, history = trainer.fit(ds, epochs=TRAIN_EPOCHS, batch_size=BATCH, seed=0,
                                 device_resident=True, mesh=mesh, device="cuda", **quiet)
    torch.cuda.synchronize()
    out["fusion"] = {"seconds": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES),
                     "history": history}
    out["fusion"]["state"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return out


def dp_steps(np):
    """(RG train + eval steps, fusion train + eval steps) of one fit."""
    from camouflage_multimodal_tpu_torch.train import train_rg

    n_rg = int(0.8 * RG_IMAGES)
    rg = sum(len(train_rg.epoch_order(np.random.default_rng(0), range(k), BATCH, False))
             for k in (n_rg, RG_IMAGES - n_rg))
    n_fu = int(0.8 * TRAIN_RECORDS)
    return rg * RG_EPOCHS, (n_fu // BATCH + (TRAIN_RECORDS - n_fu) // BATCH) * TRAIN_EPOCHS


def dp_expected(np):
    """The launches of one world-1 fit: B1 only in the RG graph build (two
    build batches of 16), B2 twice per fusion train and eval step, B3 twice
    per fusion train step."""
    n_fu = int(0.8 * TRAIN_RECORDS)
    train, evals = n_fu // BATCH, (TRAIN_RECORDS - n_fu) // BATCH
    return ({"slic_assign": SLIC_ITERS * -(-RG_IMAGES // 16), "fused_mha": 0, "fused_mha_bwd": 0},
            {"slic_assign": 0, "fused_mha": 2 * (train + evals) * TRAIN_EPOCHS,
             "fused_mha_bwd": 2 * train * TRAIN_EPOCHS})


def dp_diffs(torch, np, got, want, fits=("rg", "fusion")):
    """(history and parameter differences, within the bars) of two fits of
    ``dp_fits`` (of those named in ``fits``): histories within rtol 1e-4
    (the validation losses 1e-3); parameters 3·lr, RG's BatchNorm-fed
    biases and running means 2·lr·(train steps)."""
    from camouflage_multimodal_tpu_torch.train import train_rg

    rg_steps = RG_EPOCHS * len(train_rg.epoch_order(
        np.random.default_rng(0), range(int(0.8 * RG_IMAGES)), BATCH, False))
    out, ok = {}, True
    for fit, lr in (("rg", DP_RG_LR), ("fusion", DP_FUSION_LR)):
        if fit not in fits:
            continue
        rel, absolute = {}, {}
        for key, want_h in want[fit]["history"].items():
            a, b = np.asarray(got[fit]["history"][key]), np.asarray(want_h)
            absolute[key] = float(np.max(np.abs(a - b)))
            rel[key] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
            rtol = DP_VAL_RTOL if key == "val_loss" else DP_HISTORY_RTOL
            ok = ok and bool(np.all(np.abs(a - b) <= rtol * np.abs(b)))
        params = {}
        for key, b in want[fit]["state"].items():
            params[key] = float((got[fit]["state"][key].double() - b.double()).abs().max())
            loose = fit == "rg" and (key in RG_GRADIENT_FREE or key.endswith("running_mean"))
            ok = ok and params[key] <= (2 * lr * rg_steps if loose else 3 * lr)
        out[fit] = {"history_max_rel_diff": rel, "history_max_abs_diff": absolute,
                    "param_max_abs_diff": max(params.values()),
                    "param_max_abs_diff_key": max(params, key=params.get)}
    return out, ok


def dp_equal(torch, got, want) -> dict:
    """Per fit: are history and every parameter and buffer equal to the bit?"""
    return {fit: got[fit]["history"] == want[fit]["history"] and all(
        torch.equal(got[fit]["state"][k], v) for k, v in want[fit]["state"].items())
        for fit in ("rg", "fusion")}


def dp_rank_main(torch, np, api, kernels, args):
    """One rank of the two-rank run (``--dp-rank``): both fits and
    directory evaluation over a gloo group of two processes on this card;
    writes its results to ``--dp-work``."""
    from camouflage_multimodal_tpu_torch.parallel import distributed, sharding

    # The two ranks share the host's cores; oversubscribed, gloo's threads
    # starve behind the other rank's spinning intra-op threads.
    torch.set_num_threads(max(1, (os.cpu_count() or DP_WORLD) // DP_WORLD))
    distributed.initialize(f"127.0.0.1:{args.dp_port}", DP_WORLD, args.dp_rank,
                           backend="gloo", timeout_s=DP_RANK_TIMEOUT, device="cuda")
    try:
        mesh = sharding.make_mesh("cuda")
        res = dp_fits(torch, np, kernels, mesh)
        kernels.reset_launches()
        t0 = time.perf_counter()
        report = api.evaluate_directory(
            ARTIFACTS[1], os.path.join(args.dp_work, "images"),
            os.path.join(args.dp_work, "gt_object"), batch_size=WORKFLOW_BATCH,
            data_parallel=True, device="cuda")
        torch.cuda.synchronize()
        res["evaluate"] = {"seconds": time.perf_counter() - t0,
                           "launches": dict(kernels.LAUNCHES), "report": report}
    finally:
        distributed.shutdown()
    states = {f"{fit}/{k}": v.numpy() for fit in ("rg", "fusion")
              for k, v in res[fit].pop("state").items()}
    np.savez(os.path.join(args.dp_work, f"rank{args.dp_rank}.npz"), **states)
    with open(os.path.join(args.dp_work, f"rank{args.dp_rank}.json"), "w") as f:
        json.dump(res, f)


def phase_data_parallel(torch, np, kernels, api, out_dir):
    """(a) The two fits without a mesh and with a world-1 NCCL mesh in this
    process: equal to the bit, or within the bars of ``dp_diffs``; exact
    launches. (b) Two processes on this one card joined by gloo, each
    running both fits and ``evaluate_directory(data_parallel=True)`` on the
    workflow's 32 files: histories and parameters against (a) within the
    bars, the evaluation report against one process's at 1e-6, launches
    per rank. Returns {"world1": launches of (a), "ranks": [per rank]}."""
    from camouflage_multimodal_tpu_torch.parallel import distributed, sharding

    want_rg, want_fusion = dp_expected(np)
    rg_steps, fusion_steps = dp_steps(np)
    alone = dp_fits(torch, np, kernels, None)
    t0 = time.perf_counter()
    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                           timeout_s=DP_RANK_TIMEOUT, device="cuda")
    try:
        mesh = sharding.make_mesh("cuda")
        # NCCL sets its communicator up at the first collective: once per
        # process, timed apart from the fits.
        torch.distributed.all_reduce(torch.zeros(1, device="cuda"),
                                     group=sharding.data_group(mesh))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        world1 = dp_fits(torch, np, kernels, mesh)
    finally:
        distributed.shutdown()
    equal = dp_equal(torch, world1, alone)
    diffs, close = dp_diffs(torch, np, world1, alone)
    times = {"rg_fit_seconds": {"no_mesh": alone["rg"]["seconds"],
                                "world1_mesh": world1["rg"]["seconds"]},
             "fusion_ms_per_step": {"no_mesh": alone["fusion"]["seconds"] * 1e3 / fusion_steps,
                                    "world1_mesh": world1["fusion"]["seconds"] * 1e3 / fusion_steps},
             "rg_steps": rg_steps, "fusion_steps": fusion_steps,
             "group_and_mesh_setup_seconds": setup_s}
    launches = {fit: world1[fit]["launches"] for fit in ("rg", "fusion")}
    emit({"phase": "data_parallel_world1", "backend": "nccl", "bit_equal_to_no_mesh": equal,
          "diffs_to_no_mesh": diffs, "launches": launches,
          "expected_launches": {"rg": want_rg, "fusion": want_fusion}, **times,
          "note": "fit seconds include the RG graph build and the fusion dataset upload"})
    if not all(equal.values()) and not close:
        fail(f"a world-1 mesh moves the fits beyond the bars: {diffs}")
    if launches != {"rg": want_rg, "fusion": want_fusion} or any(
            world1[fit]["launches"] != alone[fit]["launches"] for fit in ("rg", "fusion")):
        fail(f"world-1 data-parallel fits launched {launches}")

    work = os.path.join(out_dir, "data_parallel")
    os.makedirs(work)
    for k in ("images", "gt_object"):
        os.symlink(os.path.join(out_dir, "workflow", k), os.path.join(work, k))
    one_report = api.evaluate_directory(ARTIFACTS[1], os.path.join(work, "images"),
                                        os.path.join(work, "gt_object"),
                                        batch_size=WORKFLOW_BATCH, device="cuda")
    port = free_port()
    t0 = time.perf_counter()
    try:
        distributed.run_ranks([[sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
                                "--dp-port", str(port), "--dp-work", work]
                               for r in range(DP_WORLD)],
                              [{**os.environ, "LOCAL_RANK": "0"}] * DP_WORLD, DP_RANK_TIMEOUT)
    except RuntimeError as err:
        fail(f"the two-rank run: {err}")
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            res = json.load(f)
        with np.load(os.path.join(work, f"rank{r}.npz")) as z:
            for fit in ("rg", "fusion"):
                res[fit]["state"] = {k.split("/", 1)[1]: torch.from_numpy(z[k])
                                     for k in z.files if k.startswith(fit + "/")}
        ranks.append(res)
    diffs2, close2 = dp_diffs(torch, np, ranks[0], world1)
    same_ranks = dp_equal(torch, ranks[1], ranks[0])
    report_err = max(max(abs(res["evaluate"]["report"][k] - v) for k, v in one_report.items())
                     for res in ranks)
    per_rank = [{what: res[what]["launches"] for what in ("rg", "fusion", "evaluate")}
                for res in ranks]
    rank_times = [{"rg_fit_seconds": res["rg"]["seconds"],
                   "fusion_ms_per_step": res["fusion"]["seconds"] * 1e3 / fusion_steps,
                   "evaluate_seconds": res["evaluate"]["seconds"]} for res in ranks]
    emit({"phase": "data_parallel_two_ranks", "backend": "gloo",
          "setup": "two processes sharing one card (cuda:0)", "ranks_equal_to_the_bit": same_ranks,
          "diffs_to_world1": diffs2, "evaluate_report_max_abs_diff_to_one_process": report_err,
          "launches_per_rank": per_rank, "times_per_rank": rank_times,
          "wall_seconds_both_ranks": wall})
    if not close2 or not all(same_ranks.values()) or report_err > 1e-6:
        fail(f"the two-rank run disagrees: {diffs2}, ranks equal {same_ranks}, "
             f"evaluation {report_err}")
    build = [pr["rg"]["slic_assign"] for pr in per_rank]
    eval_b1 = SLIC_ITERS * -(-WORKFLOW_IMAGES // WORKFLOW_BATCH)
    for r, pr in enumerate(per_rank):
        if (pr["fusion"] != want_fusion or pr["rg"]["fused_mha"] or pr["rg"]["fused_mha_bwd"]
                or pr["evaluate"] != {"slic_assign": eval_b1, "fused_mha": 0, "fused_mha_bwd": 0}):
            fail(f"rank {r} launched {pr}")
    if sum(build) != want_rg["slic_assign"] or 0 in build:
        fail(f"the two ranks' graph builds launched B1 {build} times, expected "
             f"{want_rg['slic_assign']} in all, on both")
    return {"world1": launches, "ranks": per_rank}


# ---------------------------------------------------------------------------
# The model axis and spatial sharding
# ---------------------------------------------------------------------------

MP_WORLD = 2               # model ranks of the (1, 2) mesh
MP_HEADS = HEADS // MP_WORLD
# (name, batch, queries, keys) of B2's and B3's checks on a rank's heads:
# both directions at the training bucket, at the batch of a (1, 2) fit and at
# a rank's block of it over a (2, 2) mesh.
MP_SHAPES = (("rg2kg", BATCH, TRAIN_NODES, 13), ("kg2rg", BATCH, 13, TRAIN_NODES),
             ("rg2kg_b2", 2, TRAIN_NODES, 13), ("kg2rg_b2", 2, 13, TRAIN_NODES))
# A rank's map is its heads' share of the mean over all 8, entries of about
# 1 / Nk / 2 (9e-4 at 576 keys): the absolute bar stays well below that, so a
# map divided by the rank's 4 heads instead of the 8 (twice as large) fails.
MP_PROBS_ATOL = 1e-5


def rank_params(torch, attention_mod, params, rank, world=MP_WORLD):
    """Model rank ``rank``'s share of whole attention parameters, as
    ``parallel.sharding.shard_fusion_params`` cuts it: columns of wq, wk,
    wv and their biases, rows of wo, no bo."""
    E = params["wq"].shape[1]
    cols = slice(rank * E // world, (rank + 1) * E // world)
    out = {n: (t[:, cols] if n in ("wq", "wk", "wv") else t[cols] if n != "bo" else None)
           for n, t in params.items()}
    return {n: (None if t is None else t.contiguous()) for n, t in out.items()}


def mp_flops_bytes(Bq, Nq, Nk, e_in, e, e_out, heads, backward):
    """Operations and bytes of one B2 (or B3) call on a rank's heads, counted
    as phases 10's do for the whole heads."""
    if not backward:
        flops = Bq * (2 * Nq * e_in * e + 4 * Nk * e_in * e + 2 * Nq * e * e_out
                      + 4 * Nq * Nk * e) + Bq * heads * Nq * Nk * 5
        nbytes = 4 * (Bq * Nq * e_in + 2 * Bq * Nk * e_in + 3 * e_in * e + e * e_out + 3 * e
                      + Bq * Nq * e_out + Bq * Nq * Nk) + Bq * Nk
        return flops, nbytes
    flops = Bq * (Nq * (4 * e * e_out + 4 * e_in * e) + 8 * Nk * e_in * e + 10 * Nq * Nk * e)
    nbytes = 4 * (Bq * Nq * (e_in + 2 * e + e_out)       # q, ctx, qp, d_out
                  + 2 * Bq * Nk * (e_in + e)              # k, v, kp, vp
                  + Bq * Nq * Nk                          # d_probs
                  + 2 * (3 * e_in * e + e * e_out)        # weights and their gradients
                  + Bq * Nq * e_in + 2 * Bq * Nk * e_in   # d_q, d_k, d_v
                  + 3 * e + e_out) + Bq * Nk              # bias gradients, mask
    return flops, nbytes


def phase_model_axis_kernels(torch, kernels, attention_mod, fusion_model):
    """B2 and B3 on each model rank's 4 of the 8 heads (E_in 256, E_loc 128)
    against their plain versions at the bars of phases 3 and 4 (the maps at
    ``MP_PROBS_ATOL``), repeats bit-equal, one launch a call; the ranks'
    outputs summed with bo, and their maps summed, against the whole plain
    attention. Then the device times at the (1, 2) fit's
    shapes with their bounds. Returns {"max_abs_err", "times"}."""
    names = attention_mod.PARAM_NAMES
    worst = 0.0
    for name, batch, nq, nk in MP_SHAPES:
        params, q, k, mask = mha_inputs(torch, fusion_model, nq, nk, seed=nq + batch - BATCH,
                                        batch=batch)
        want_whole, want_whole_p = attention_mod.multihead_attention(params, q, k, k, HEADS,
                                                                     mask)
        leaves, bwd_mask, d_out, d_probs = mha_bwd_case(torch, attention_mod, fusion_model,
                                                        nq, nk, batch)
        summed, summed_p = params["bo"].clone(), torch.zeros_like(want_whole_p)
        for rank in range(MP_WORLD):
            part = rank_params(torch, attention_mod, params, rank)
            before = kernels.LAUNCHES["fused_mha"]
            out, probs = attention_mod.fused_mha(part, q, k, k, MP_HEADS, mask, total_heads=HEADS)
            torch.cuda.synchronize()
            launched = kernels.LAUNCHES["fused_mha"] - before
            again = attention_mod.fused_mha(part, q, k, k, MP_HEADS, mask, total_heads=HEADS)
            want_out, want_p = attention_mod.multihead_attention(part, q, k, k, MP_HEADS, mask,
                                                                 total_heads=HEADS)
            summed, summed_p = summed + out, summed_p + probs
            e_out = float((out - want_out).abs().max())
            e_p = float((probs - want_p).abs().max())
            ok = (torch.allclose(out, want_out, rtol=1e-4, atol=1e-4)
                  and torch.allclose(probs, want_p, rtol=1e-3, atol=MP_PROBS_ATOL)
                  and torch.equal(again[0], out) and torch.equal(again[1], probs)
                  and launched == 1)
            # B3 on the rank's heads, with and without a cotangent for the maps.
            q_l, k_l, v_l, *w = leaves
            whole = dict(zip(names, w))
            part_leaves = [t.detach().clone().requires_grad_() for t in (q_l, k_l, v_l)] + [
                t.detach().clone().requires_grad_()
                for t in rank_params(torch, attention_mod, whole, rank).values() if t is not None]
            rank_names = [n for n in names if n != "bo"]
            errs = {}
            for with_probs in (True, False):
                dp = d_probs if with_probs else None

                def grads():
                    qq, kk, vv, *ww = part_leaves
                    o, pr = attention_mod.fused_mha(dict(zip(rank_names, ww), bo=None), qq, kk,
                                                    vv, MP_HEADS, bwd_mask, total_heads=HEADS)
                    if dp is None:
                        return torch.autograd.grad([o], part_leaves, [d_out])
                    return torch.autograd.grad([o, pr], part_leaves, [d_out, dp])

                before = kernels.LAUNCHES["fused_mha_bwd"]
                got = grads()
                torch.cuda.synchronize()
                launched_bwd = kernels.LAUNCHES["fused_mha_bwd"] - before
                repeat = all(torch.equal(a, b) for a, b in zip(got, grads()))
                qq, kk, vv, *ww = (t.detach() for t in part_leaves)
                d_params, *d_in = attention_mod.multihead_attention_backward(
                    dict(zip(rank_names, ww), bo=None), qq, kk, vv, MP_HEADS, bwd_mask, d_out,
                    dp, total_heads=HEADS)
                want = (*d_in, *(d_params[n] for n in rank_names))
                e = {n: float((a - b).abs().max())
                     for n, a, b in zip(GRAD_NAMES[:3] + tuple(rank_names), got, want)}
                errs[f"d_probs={with_probs}"] = e
                ok = (ok and repeat and launched_bwd == 1
                      and all(bool(torch.isfinite(a).all()) for a in got)
                      and all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                              for a, b in zip(got, want)))
                worst = max(worst, *e.values())
            emit({"phase": "model_axis_kernel_check", "direction": name, "batch": batch,
                  "nq": nq, "nk": nk, "rank": rank, "heads": MP_HEADS, "total_heads": HEADS,
                  "e_in": q.shape[-1], "e_loc": part["wq"].shape[1],
                  "max_abs_err_out": e_out, "max_abs_err_probs": e_p,
                  "b3_max_abs_err": errs, "ok": ok})
            if not ok:
                fail(f"B2 or B3 on rank {rank}'s heads disagrees with its plain version ({name})")
            worst = max(worst, e_out, e_p)
        e_sum = float((summed - want_whole).abs().max())
        e_sum_p = float((summed_p - want_whole_p).abs().max())
        emit({"phase": "model_axis_partials_sum", "direction": name, "batch": batch,
              "max_abs_err_vs_whole": e_sum, "max_abs_err_probs_vs_whole": e_sum_p})
        if not torch.allclose(summed, want_whole, rtol=1e-4, atol=1e-4):
            fail(f"the ranks' B2 outputs plus bo miss the whole attention ({name}): {e_sum}")
        if not torch.allclose(summed_p, want_whole_p, rtol=1e-3, atol=MP_PROBS_ATOL):
            fail(f"the ranks' B2 maps do not sum to the whole map ({name}): {e_sum_p}")

    times = {}
    for name, batch, nq, nk in MP_SHAPES[:2]:
        leaves, mask, d_out, _ = mha_bwd_case(torch, attention_mod, fusion_model, nq, nk, batch)
        q, k, v, *w = leaves
        part = rank_params(torch, attention_mod, dict(zip(names, w)), 0)
        part = {n: (None if t is None else t.detach().requires_grad_()) for n, t in part.items()}
        out, _ = attention_mod.fused_mha(part, q, k, v, MP_HEADS, mask, total_heads=HEADS)
        inputs = [q, k, v] + [t for t in part.values() if t is not None]
        detached = {n: (None if t is None else t.detach()) for n, t in part.items()}
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        e_in, e_loc = q.shape[-1], part["wq"].shape[1]
        f2, b2 = mp_flops_bytes(batch, nq, nk, e_in, e_loc, e_in, MP_HEADS, False)
        f3, b3 = mp_flops_bytes(batch, nq, nk, e_in, e_loc, e_in, MP_HEADS, True)
        times[name] = {
            "batch": batch, "nq": nq, "nk": nk, "e_in": e_in, "e_loc": e_loc, "heads": MP_HEADS,
            "fused_mha_ms": cuda_ms(lambda: attention_mod.fused_mha(
                detached, qd, kd, vd, MP_HEADS, mask, total_heads=HEADS)),
            "fused_mha_plain_ms": cuda_ms(lambda: attention_mod.multihead_attention(
                detached, qd, kd, vd, MP_HEADS, mask, total_heads=HEADS)),
            "fused_mha_flops": f2, "fused_mha_bytes": b2,
            "fused_mha_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
                [out], inputs, [d_out], retain_graph=True)),
            "fused_mha_bwd_plain_ms": cuda_ms(lambda: attention_mod.multihead_attention_backward(
                detached, qd, kd, vd, MP_HEADS, mask, d_out, None, total_heads=HEADS)),
            "fused_mha_bwd_flops": f3, "fused_mha_bwd_bytes": b3,
        }
        for what in ("fused_mha", "fused_mha_bwd"):
            times[name][f"{what}_bound"] = bound_ms(times[name][f"{what}_bytes"],
                                                    times[name][f"{what}_flops"])
        emit({"phase": "model_axis_kernel_time", "direction": name, **times[name]})
    return {"max_abs_err": worst, "times": times}


MP_RANK_TIMEOUT = 420      # seconds a rank of the (1, 2) run may take
MP_BATCHES = (1, BATCH)    # the spatial pipeline's batches


def mp_fit(torch, np, kernels, mesh, checkpoint_dir):
    """Phase 6's ``FusionTrainer.fit`` (device-resident, dropout 0, the
    kernels on, lr 5e-4) on its 64 records with ``mesh``, writing its best
    checkpoint: history, final state on the host, launches (zeroed just
    before, read just after) and seconds."""
    from camouflage_multimodal_tpu_torch.train import train_fusion as train_mod

    quiet = dict(log_fn=lambda *_: None)
    ds = train_mod.FusionDataset.from_samples(train_records(np), **quiet)
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer = train_mod.FusionTrainer(model_config={"dropout": 0.0, "use_pallas": True},
                                      learning_rate=DP_FUSION_LR)
    model, history = trainer.fit(ds, epochs=TRAIN_EPOCHS, batch_size=BATCH, seed=0,
                                 device_resident=True, mesh=mesh, device="cuda",
                                 checkpoint_dir=checkpoint_dir, **quiet)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES),
            "history": history,
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def mp_spatial(torch, np, kernels, api, mesh):
    """The multimodal pipeline over the committed weights (256², 500
    segments, the 640-node bucket, 10 SLIC iterations) with ``mesh`` and
    ``spatial=True`` (none: the unsharded pipeline) at batches 1 and 4:
    per batch the outputs on the host, the launches and the seconds."""
    from camouflage_multimodal_tpu_torch.pipeline import MultimodalPipeline, RegionGraphPipeline

    pred = api.MultimodalPredictor(*ARTIFACTS, device="cuda")
    rg = RegionGraphPipeline(pred.rg_pipeline.model, n_segments=500, mesh=mesh,
                             spatial=mesh is not None)
    pipe = MultimodalPipeline(rg, pred.fusion_model)
    images = torch.from_numpy(synthetic_images(300, BATCH, SIZE)).cuda()
    pipe(images[:1], pred.kg_tensor)                   # warm-up
    torch.cuda.synchronize()
    out = {}
    for b in MP_BATCHES:
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = pipe(images[:b], pred.kg_tensor)
        torch.cuda.synchronize()
        out[b] = {"seconds": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES),
                  "outputs": {k: res[k].cpu().numpy() for k in (
                      "segments", "heatmap", "node_mask", "mask_prob", "instance_prob",
                      "edge_prob", "score")}}
    return out


def mp_rank_main(torch, np, api, kernels, args):
    """One rank of the (1, 2) run (``--mp-rank``): the fusion fit over the
    model axis and the spatial pipeline, in a gloo group of two processes on
    this card; writes its results to ``--mp-work``."""
    from camouflage_multimodal_tpu_torch.parallel import distributed, sharding

    torch.set_num_threads(max(1, (os.cpu_count() or MP_WORLD) // MP_WORLD))
    distributed.initialize(f"127.0.0.1:{args.mp_port}", MP_WORLD, args.mp_rank,
                           backend="gloo", timeout_s=MP_RANK_TIMEOUT, device="cuda")
    try:
        mesh = sharding.make_mesh("cuda", model_axis=MP_WORLD)
        fit = mp_fit(torch, np, kernels, mesh, os.path.join(args.mp_work, "ckpt"))
        spatial = mp_spatial(torch, np, kernels, api, mesh)
    finally:
        distributed.shutdown()
    arrays = {f"fit/{k}": v.numpy() for k, v in fit.pop("state").items()}
    for b, res in spatial.items():
        arrays.update({f"spatial{b}/{k}": v for k, v in res.pop("outputs").items()})
    np.savez(os.path.join(args.mp_work, f"rank{args.mp_rank}.npz"), **arrays)
    with open(os.path.join(args.mp_work, f"rank{args.mp_rank}.json"), "w") as f:
        json.dump({"fit": fit, "spatial": {str(b): v for b, v in spatial.items()}}, f)


def spatial_diffs(np, got, want):
    """The JAX spatial test's bars on one batch: segments ≥ 99.5 % equal,
    heatmaps within 1e-4 where they agree, equal live-node counts; the
    fusion outputs' largest differences (held to 1e-3)."""
    same = got["segments"] == want["segments"]
    out = {"segments_equal": float(same.mean()),
           "heatmap_max_abs_diff_where_equal": float(np.abs(
               got["heatmap"] - want["heatmap"])[same].max()),
           "live_nodes": [int(x) for x in got["node_mask"].sum(-1)],
           "live_nodes_unsharded": [int(x) for x in want["node_mask"].sum(-1)]}
    out.update({f"{k}_max_abs_diff": float(np.abs(got[k] - want[k]).max())
                for k in ("mask_prob", "instance_prob", "edge_prob", "score")})
    ok = (out["segments_equal"] >= 0.995 and out["heatmap_max_abs_diff_where_equal"] <= 1e-4
          and out["live_nodes"] == out["live_nodes_unsharded"]
          and all(out[f"{k}_max_abs_diff"] <= 1e-3
                  for k in ("mask_prob", "instance_prob", "edge_prob", "score")))
    return out, ok


def phase_model_axis(torch, np, kernels, api, out_dir):
    """Phase 9e, after ``phase_model_axis_kernels``: (b) the one-process
    references in this process: phase 6's fusion fit with a best checkpoint, and the unsharded
    multimodal pipeline at batches 1 and 4. (c) Two processes of this
    script on this one card (``--mp-rank``, gloo, ``LOCAL_RANK=0``) on a
    (1, 2) mesh, each running the fit over the model axis (4 of the 8
    heads, E_in 256, E_loc 128) and the spatial pipeline (128 rows each):
    both ranks equal to the bit; the fit against (b) within phase 9d's bars
    and its gathered checkpoint the one-process file within them (loaded by
    ``api.load_multimodal_model``); the spatial outputs against (b) within
    ``spatial_diffs``; launches per rank as stated. Returns the per-rank
    launches."""
    from camouflage_multimodal_tpu_torch.core.checkpoint import load_checkpoint
    from camouflage_multimodal_tpu_torch.parallel.distributed import run_ranks

    _, want_fusion = dp_expected(np)
    _, fusion_steps = dp_steps(np)
    work = os.path.join(out_dir, "model_axis")
    os.makedirs(work)
    alone_fit = mp_fit(torch, np, kernels, None, os.path.join(work, "ckpt_alone"))
    alone_spatial = mp_spatial(torch, np, kernels, api, None)
    port = free_port()
    t0 = time.perf_counter()
    try:
        run_ranks([[sys.executable, os.path.abspath(__file__), "--mp-rank", str(r),
                    "--mp-port", str(port), "--mp-work", work] for r in range(MP_WORLD)],
                  [{**os.environ, "LOCAL_RANK": "0"}] * MP_WORLD, MP_RANK_TIMEOUT)
    except RuntimeError as err:
        fail(f"the (1, 2) run: {err}")
    wall = time.perf_counter() - t0
    ranks, arrays = [], []
    for r in range(MP_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        with np.load(os.path.join(work, f"rank{r}.npz")) as z:
            arrays.append({k: z[k] for k in z.files})
    same_ranks = all(np.array_equal(arrays[1][k], v) for k, v in arrays[0].items())
    got = {"fusion": {"history": ranks[0]["fit"]["history"],
                      "state": {k[4:]: torch.from_numpy(v) for k, v in arrays[0].items()
                                if k.startswith("fit/")}}}
    want = {"fusion": {"history": alone_fit["history"], "state": alone_fit["state"]}}
    diffs, close = dp_diffs(torch, np, got, want, fits=("fusion",))
    ckpt = load_checkpoint(os.path.join(work, "ckpt", "multimodal_best_fixed.ckpt"))
    ckpt_alone = load_checkpoint(os.path.join(work, "ckpt_alone", "multimodal_best_fixed.ckpt"))
    ckpt_diff = {}
    for part in ("params", "opt_state"):
        a, b = flat_tree(ckpt[part]), flat_tree(ckpt_alone[part])
        if set(a) != set(b) or any(np.shape(a[k]) != np.shape(b[k]) for k in b):
            fail(f"the gathered checkpoint's {part} differ in layout from the one-process file")
        ckpt_diff[part] = max(float(np.abs(np.asarray(a[k], np.float64)
                                           - np.asarray(b[k], np.float64)).max()) for k in b)
    api.load_multimodal_model(os.path.join(work, "ckpt", "multimodal_best_fixed.ckpt"),
                              device="cuda")
    spatial = {}
    spatial_ok = True
    for b in MP_BATCHES:
        mine = {k.split("/", 1)[1]: v for k, v in arrays[0].items()
                if k.startswith(f"spatial{b}/")}
        spatial[b], ok = spatial_diffs(np, mine, alone_spatial[b]["outputs"])
        spatial_ok = spatial_ok and ok
    fit_b1 = {"slic_assign": 0, "fused_mha": want_fusion["fused_mha"],
              "fused_mha_bwd": want_fusion["fused_mha_bwd"]}
    spatial_want = {"slic_assign": SLIC_ITERS, "fused_mha": 2, "fused_mha_bwd": 0}
    per_rank = [{"fit": res["fit"]["launches"],
                 **{f"spatial_batch{b}": res["spatial"][str(b)]["launches"] for b in MP_BATCHES}}
                for res in ranks]
    times = [{"fit_seconds": res["fit"]["seconds"],
              "fusion_ms_per_step": res["fit"]["seconds"] * 1e3 / fusion_steps,
              **{f"spatial_batch{b}_seconds": res["spatial"][str(b)]["seconds"]
                 for b in MP_BATCHES}} for res in ranks]
    emit({"phase": "model_axis_two_ranks", "backend": "gloo", "mesh": [1, MP_WORLD],
          "setup": "two processes sharing one card (cuda:0)", "ranks_equal_to_the_bit": same_ranks,
          "fit_diffs_to_one_process": diffs["fusion"], "checkpoint_max_abs_diff": ckpt_diff,
          "spatial_vs_unsharded": {str(b): v for b, v in spatial.items()},
          "launches_per_rank": per_rank,
          "expected_launches_per_rank": {"fit": fit_b1, "spatial_per_batch": spatial_want},
          "times_per_rank": times,
          "one_process_times": {"fit_seconds": alone_fit["seconds"],
                                "fusion_ms_per_step": alone_fit["seconds"] * 1e3 / fusion_steps,
                                **{f"spatial_batch{b}_seconds": alone_spatial[b]["seconds"]
                                   for b in MP_BATCHES}},
          "wall_seconds_both_ranks": wall})
    if not same_ranks:
        fail("the two ranks of the (1, 2) run end with different results")
    if not close or ckpt_diff["params"] > 3 * DP_FUSION_LR:
        fail(f"the (1, 2) fit disagrees with one process: {diffs['fusion']}, "
             f"checkpoint {ckpt_diff}")
    if not spatial_ok:
        fail(f"the spatial pipeline disagrees with the unsharded one: {spatial}")
    for r, pr in enumerate(per_rank):
        if pr["fit"] != fit_b1 or any(pr[f"spatial_batch{b}"] != spatial_want
                                      for b in MP_BATCHES):
            fail(f"rank {r} of the (1, 2) run launched {pr}")
    return per_rank


def mp_rank_shapes(mp_kernels, what):
    """The kernel line's numbers at a model rank's shapes (4 of 8 heads, E_in
    256, E_loc 128, batch 4, both directions of the training bucket)."""
    times = mp_kernels["times"].values()
    return {"rank_shapes": "2 launches per step on each of two model ranks: rg2kg (4x576 q, "
                           "13 k) + kg2rg (4x13 q, 576 k), E_in=256, E_loc=128, 4 of 8 heads",
            "ms_rank_shapes": sum(v[f"{what}_ms"] for v in times),
            "plain_ms_rank_shapes": sum(v[f"{what}_plain_ms"] for v in times),
            "bound_ms_rank_shapes": bound_ms(sum(v[f"{what}_bytes"] for v in times),
                                             sum(v[f"{what}_flops"] for v in times))[0],
            "max_abs_err_rank_shapes": mp_kernels["max_abs_err"]}


def flat_tree(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            out.update(flat_tree(node, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = node
    return out


def dp_total(steps, name) -> int:
    """The launches of kernel ``name`` summed over the steps of a run."""
    return sum(s[name] for s in steps.values())


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


BENCH_ENV = {"BENCH_ITERS": "10", "BENCH_E2E_PASSES": "2"}
BENCH_JPEGS = 64           # 4 batches of 16, cycled at batch 32
BENCH_JPEG_SIZE = (1024, 768)
BENCH_CPU_SIZE, BENCH_CPU_BATCH, BENCH_CPU_IMAGES = 352, 16, 4
BENCH_TIMEOUT = 600        # seconds a row's process may take
BENCH_FUSION_BAR = 1e-3    # the card's fusion outputs against the CPU's (as serving)


def write_bench_jpegs(np, root: str, n: int = BENCH_JPEGS):
    """``n`` seeded smooth scenes (the tests' generator) as 1024 × 768
    JPEGs, which the bench decodes and resizes to each row's size."""
    from PIL import Image

    os.makedirs(root)
    w, h = BENCH_JPEG_SIZE
    for i, img in enumerate(synthetic_images(200, n, h)):
        Image.fromarray(img).resize((w, h), Image.BICUBIC).save(
            os.path.join(root, f"bench_{i:03d}.jpg"), quality=90)
    return root


def phase_bench(torch, np, kernels, out_dir):
    """Phase 9f: the port's bench at the JAX sweep's four rows through the
    sweep (a process each), its launches per forward, the card's 352²
    batch against the CPU's, then the stage profile and the host ceiling
    at 352² / 16. Returns {row: the bench's launches}."""
    from camouflage_multimodal_tpu_torch import bench
    from camouflage_multimodal_tpu_torch.scripts import bench_sweep, host_ceiling, profile_stages

    t0 = time.perf_counter()
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        keys = set(json.load(f)["parsed"])
    image_dir = write_bench_jpegs(np, os.path.join(out_dir, "bench_images"))
    env = dict(os.environ, **BENCH_ENV)
    launches = {}
    for size, batch in bench_sweep.ROWS:
        r0 = time.perf_counter()
        line = bench_sweep.bench_line(size, batch, device="cuda", image_dir=image_dir,
                                      env=env, timeout=BENCH_TIMEOUT)
        row = bench_sweep.row_of(size, batch, line)
        n = line["forwards"]
        want = {"slic_assign": SLIC_ITERS * n, "fused_mha": 2 * n, "fused_mha_bwd": 0}
        emit({"phase": "bench_row", **row, "seconds": time.perf_counter() - r0,
              "line": line, "expected_launches": want})
        missing = keys - set(line)
        if missing:
            fail(f"bench at {size}/{batch} lacks {sorted(missing)}")
        if line["backend"] != "cuda" or line["kernel_launches"] != want:
            fail(f"bench at {size}/{batch}: backend {line['backend']}, launches "
                 f"{line['kernel_launches']}, expected {want}")
        if not all(line[k] > 0 and np.isfinite(line[k]) for k in (
                "value", "device_only_imgs_per_sec", "p50_per_image_ms", "p50_batch1_ms",
                "e2e_median_imgs_per_sec", "draft_decode_imgs_per_sec")):
            fail(f"bench at {size}/{batch}: a rate is not a positive number")
        launches[f"{size}/{batch}"] = line["kernel_launches"]

    # One 352² batch of 16 on the card, its first images on the CPU.
    cfg = bench.BenchConfig(batch=BENCH_CPU_BATCH, image_size=BENCH_CPU_SIZE)
    images = bench.load_images(bench.image_paths(image_dir, cfg.batch), cfg.batch,
                               cfg.image_size)
    pipe, kg = bench.build_models(cfg, torch.device("cuda"))
    x = torch.from_numpy(images).cuda()
    pipe(x, kg)
    torch.cuda.synchronize()
    kernels.reset_launches()
    gpu = pipe(x, kg)
    torch.cuda.synchronize()
    got = dict(kernels.LAUNCHES)
    want = {"slic_assign": SLIC_ITERS, "fused_mha": 2, "fused_mha_bwd": 0}
    if got != want:
        fail(f"a 352^2 bench batch launched {got}, expected {want}")
    phase_profile(torch, "one bench batch of 16 at 352^2", lambda: pipe(x, kg))
    cpu_pipe, cpu_kg = bench.build_models(cfg, torch.device("cpu"))
    cpu = cpu_pipe(torch.from_numpy(images[:BENCH_CPU_IMAGES]), cpu_kg)
    n = BENCH_CPU_IMAGES
    g = {k: v[:n].cpu().numpy() for k, v in gpu.items() if isinstance(v, torch.Tensor)}
    c = {k: v.numpy() for k, v in cpu.items() if isinstance(v, torch.Tensor)}
    seg_eq = float((g["segments"] == c["segments"]).mean())
    heat_mae = float(np.abs(g["heatmap"] - c["heatmap"]).mean())
    diffs = {k: float(np.abs(g[k] - c[k]).max()) for k in (
        "mask_logits", "instance_logits", "edge_logits", "score", "mask_prob")}
    emit({"phase": "bench_vs_cpu", "size": cfg.image_size, "batch": cfg.batch,
          "images_compared": n, "launches": got, "segments_equal": seg_eq,
          "heatmap_mae": heat_mae, "max_abs_diff": diffs,
          "nodes": [int(v) for v in g["node_mask"].sum(-1)],
          "max_nodes": pipe.rg.max_nodes})
    if seg_eq < 0.99 or heat_mae > 1e-2 or max(diffs.values()) > BENCH_FUSION_BAR:
        fail(f"the bench's 352^2 batch disagrees with the CPU: segments {seg_eq}, "
             f"heatmap MAE {heat_mae}, fusion outputs {diffs} (bar {BENCH_FUSION_BAR})")
    if not all(np.isfinite(g[k]).all() for k in ("heatmap", "score", "mask_prob")):
        fail("non-finite bench outputs")

    stages = profile_stages.main(["--image-size", "352", "--batch", "16", "--iters", "10",
                                  "--device", "cuda", "--image-dir", image_dir])
    missing = set(profile_stages.STAGES) - set(stages)
    if missing or not isinstance(stages["_device_busy_ms_per_img"], dict):
        fail(f"stage profile: missing {sorted(missing)} or no device-busy times")
    ceiling = host_ceiling.main(["--device", "cuda", "--image-dir", image_dir])
    if ceiling["backend"] != "cuda" or not ceiling["compute_ms_per_img"] > 0:
        fail("host ceiling did not measure the card")
    emit({"phase": "bench", "seconds": time.perf_counter() - t0})
    return launches


NATIVE_THREADS = (1, 2, 4, 8)
NATIVE_DECODE_REPS = 3     # median of this many decodes of a batch of 16
NATIVE_MASKS = 8           # seeded PNG masks for the float gray decode
NATIVE_E2E_PASSES = 2      # bench end-to-end passes a decoder, in turns
NATIVE_GRAPH_SIZE, NATIVE_GRAPH_SEGMENTS = 256, 500


def phase_native(torch, np, kernels, out_dir):
    """Phase 9h: the native host data path (module docstring). Returns the
    launches of its two bench end-to-end runs."""
    from PIL import Image

    from camouflage_multimodal_tpu_torch import bench, native
    from camouflage_multimodal_tpu_torch.data.cod10k import load_image_u8, load_mask
    from camouflage_multimodal_tpu_torch.ops.canny import canny
    from camouflage_multimodal_tpu_torch.ops.image import rgb_to_gray
    from camouflage_multimodal_tpu_torch.ops.regions import region_features
    from camouflage_multimodal_tpu_torch.pipeline import build_region_graphs, padded_nodes

    t_phase = time.perf_counter()
    image_dir = os.path.join(out_dir, "bench_images")     # phase 9f's scenes
    paths = bench.image_paths(image_dir, BENCH_JPEGS)
    S, B = BENCH_CPU_SIZE, BENCH_CPU_BATCH

    # (b) bytes and floats against PIL.
    got, ok = native.load_batch_u8(paths, S)
    want = np.stack([load_image_u8(p, S) for p in paths])
    u8_diff = int((got != want).sum())
    rng = np.random.default_rng(47)
    w, h = BENCH_JPEG_SIZE
    masks = []
    for i in range(NATIVE_MASKS):
        cy, cx, r = rng.integers(h // 4, 3 * h // 4), rng.integers(w // 4, 3 * w // 4), h // 5
        yy, xx = np.mgrid[0:h, 0:w]
        masks.append(os.path.join(out_dir, f"native_mask_{i}.png"))
        Image.fromarray((((yy - cy) ** 2 + (xx - cx) ** 2 < r * r) * 255).astype(np.uint8)
                        ).save(masks[-1])
    got_m, ok_m = native.load_batch(masks, S, gray=True)
    mask_diff = int((got_m != np.stack([load_mask(p, S) for p in masks])).sum())
    emit({"phase": "native_equal", "jpegs": len(paths), "size": S, "all_ok": bool(ok.all()),
          "u8_pixels_differing": u8_diff, "masks": len(masks), "masks_ok": bool(ok_m.all()),
          "mask_floats_differing": mask_diff})
    if not (ok.all() and ok_m.all()) or u8_diff or mask_diff:
        fail(f"native decode differs from PIL: {u8_diff} bytes over {len(paths)} JPEGs, "
             f"{mask_diff} floats over {len(masks)} masks")

    # (c) decode ms an image of a batch of 16, by thread count.
    batch = paths[:B]
    counts = sorted(set(NATIVE_THREADS + (os.cpu_count() or 1,)))
    decode = {}
    for draft in (False, True):
        for n in counts:
            ts = []
            for _ in range(NATIVE_DECODE_REPS):
                t0 = time.perf_counter()
                native.load_batch_u8(batch, S, n_threads=n, draft=draft)
                ts.append(time.perf_counter() - t0)
            decode[f"{'draft' if draft else 'full'}_{n}"] = sorted(ts)[len(ts) // 2] / B * 1e3
    pil = {}
    for draft in (False, True):
        t0 = time.perf_counter()
        bench.decode_batch_u8(batch, S, draft=draft, use_native=False)
        pil["draft" if draft else "full"] = (time.perf_counter() - t0) / B * 1e3
    emit({"phase": "native_decode_ms_per_image", "size": S, "batch": B,
          "cpu_count": os.cpu_count(), "default_threads": native.default_threads(),
          "native": decode, "pil_one_thread": pil})

    # (d) the bench's end to end at 352² / 16, native and PIL in turns.
    cfg = bench.BenchConfig(batch=B, image_size=S)
    dev = torch.device("cuda")
    pipe, kg = bench.build_models(cfg, dev)
    forwards = [0]

    def forward(images):
        forwards[0] += 1
        return pipe(images, kg)

    cyc = bench.cycled(paths, 4 * B)
    path_batches = [cyc[i * B:(i + 1) * B] for i in range(4)]
    rates = {True: {False: [], True: []}, False: {False: [], True: []}}
    launches = {True: dict.fromkeys(kernels.LAUNCHES, 0), False: dict.fromkeys(kernels.LAUNCHES, 0)}
    decoded = {True: 0, False: 0}
    fwd = {True: 0, False: 0}
    for draft in (False, True):
        for _ in range(NATIVE_E2E_PASSES):
            for use_native in (True, False):
                kernels.reset_launches()
                native.reset_counts()
                forwards[0] = 0
                rates[use_native][draft].append(
                    bench.run_e2e(forward, path_batches, cfg, dev, draft, use_native))
                for k, v in kernels.LAUNCHES.items():
                    launches[use_native][k] += v
                decoded[use_native] += native.DECODED["batches"]
                fwd[use_native] += forwards[0]
    e2e = {}
    for use_native, name in ((True, "native"), (False, "pil")):
        full = sorted(rates[use_native][False])
        e2e[name] = {"value": full[-1], "e2e_median_imgs_per_sec": float(np.median(full)),
                     "draft_decode_imgs_per_sec": max(rates[use_native][True]),
                     "passes_full": rates[use_native][False],
                     "passes_draft": rates[use_native][True], "forwards": fwd[use_native],
                     "launches": launches[use_native],
                     "native_batches": decoded[use_native]}
    emit({"phase": "native_bench_e2e", "size": S, "batch": B, "e2e_iters": cfg.e2e_iters,
          "passes_per_decoder": NATIVE_E2E_PASSES, **e2e})
    for name in ("native", "pil"):
        rec = e2e[name]
        want = per_forward(rec["forwards"], SLIC_ITERS, 2)
        if rec["launches"] != want:
            fail(f"native phase, {name} end to end: launches {rec['launches']}, expected {want}")
        if not all(np.isfinite(rec[k]) and rec[k] > 0 for k in (
                "value", "e2e_median_imgs_per_sec", "draft_decode_imgs_per_sec")):
            fail(f"native phase, {name} end to end: a rate is not a positive number")
    if e2e["native"]["native_batches"] == 0 or e2e["pil"]["native_batches"] != 0:
        fail(f"native batches: {e2e['native']['native_batches']} in the native run, "
             f"{e2e['pil']['native_batches']} in the PIL run")

    # (e) the C++ graph builder against the card's graph build.
    G, n_seg = NATIVE_GRAPH_SIZE, NATIVE_GRAPH_SEGMENTS
    K = padded_nodes(n_seg, G)
    img = load_image_u8(paths[0], G).astype(np.float32) / 255.0
    t0 = time.perf_counter()
    host = native.build_region_graph(img, n_segments=n_seg, max_nodes=K)
    host_ms = (time.perf_counter() - t0) * 1e3
    x = torch.from_numpy(img).cuda()
    card = build_region_graphs(x[None], n_segments=n_seg, max_nodes=K)
    agree = float((card.segments[0].cpu().numpy() == host["segments"]).mean())
    edges = canny(rgb_to_gray(x), sigma=2.0).cpu().numpy()
    iou = float((edges & host["canny"]).sum() / max((edges | host["canny"]).sum(), 1))
    seg = torch.from_numpy(host["segments"]).long().cuda()
    reg = region_features(x[None], seg[None], torch.from_numpy(host["canny"]).cuda()[None], K)
    both = host["node_mask"] & reg["node_mask"][0].cpu().numpy()
    f_card, f_host = reg["features"][0].cpu().numpy()[both], host["features"][both]
    feat_ok = bool(np.allclose(f_host, f_card, rtol=5e-3, atol=5e-4))
    emit({"phase": "native_graph", "size": G, "n_segments": n_seg, "max_nodes": K,
          "host_ms": host_ms, "clusters": host["num_clusters"], "slic_agreement": agree,
          "canny_iou": iou, "nodes_compared": int(both.sum()),
          "features_max_abs_diff": float(np.abs(f_host - f_card).max()),
          "features_within_bar": feat_ok})
    if agree <= 0.97 or iou <= 0.95 or not feat_ok:
        fail(f"native graph builder vs the card: SLIC {agree}, Canny IoU {iou}, "
             f"features within rtol 5e-3 / atol 5e-4: {feat_ok}")
    emit({"phase": "native", "seconds": time.perf_counter() - t_phase})
    return {name: e2e[name]["launches"] for name in ("native", "pil")}


SCRIPTS_SERVE = dict(size=256, batch=8, n_requests=40)
SCRIPTS_CONN = ["--batch", "16", "--image-size", "352", "--n-segments", "500"]
SCRIPTS_ENTRY_CALLS = 5
SCRIPTS_SERVED_BAR = 1e-5  # served floats against predict_batch alone (as phase 9a)
SCRIPTS_DRY_LOSS_BAR = 1e-5  # the dry runs' loss against one CPU process's step (itself
                             # held within 1e-5 of the JAX step by tests/test_torch_port_scripts.py)


class _NamesSystem:
    """Pickles as a call of ``os.system``; the migration must refuse it."""

    def __reduce__(self):
        return os.system, ("true",)


def per_forward(forwards: int, b1: int, b2: int, b3: int = 0) -> dict:
    return {"slic_assign": b1 * forwards, "fused_mha": b2 * forwards,
            "fused_mha_bwd": b3 * forwards}


def phase_scripts(torch, np, kernels, api, out_dir):
    """Phase 9g: the serve latency A/B, the connectivity profile, the
    checkpoint migration and the graft entry with its dry runs (module
    docstring). Returns each path's launches."""
    import pickle

    from camouflage_multimodal_tpu_torch import graft_entry
    from camouflage_multimodal_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
    from camouflage_multimodal_tpu_torch.scripts import (
        migrate_checkpoints, profile_connectivity, serve_latency_ab)

    t_phase = time.perf_counter()
    image_dir = os.path.join(out_dir, "bench_images")     # phase 9f's scenes
    launches = {}

    # Serve latency A/B.
    pred = api.MultimodalPredictor(*ARTIFACTS, device="cuda")
    t0 = time.perf_counter()
    ab, responses, images = serve_latency_ab.run(device="cuda", image_dir=image_dir,
                                                 predictor=pred, **SCRIPTS_SERVE)
    seconds = time.perf_counter() - t0
    alone = [pred.predict_batch(images[i:i + 1]) for i in range(len(images))]
    worst = {}
    for mode, served in responses.items():
        worst[mode] = max(float(np.abs(res[k] - alone[i % len(images)][k][0]).max())
                          for i, res in enumerate(served) for k in ("heatmap", "score"))
    emit({"phase": "serve_latency_ab", "seconds": seconds, "record": ab,
          "max_abs_diff_vs_alone": worst})
    for mode, rec in ab["modes"].items():
        want = per_forward(rec["forwards"], SLIC_ITERS, 2)
        if rec["kernel_launches"] != want:
            fail(f"serve_latency_ab {mode}: launches {rec['kernel_launches']}, expected {want}")
        if rec["mean_batch_occupancy"] != 1.0 or not 0 < rec["p50_ms"] <= rec["p95_ms"]:
            fail(f"serve_latency_ab {mode}: occupancy or latencies wrong: {rec}")
        if worst[mode] > SCRIPTS_SERVED_BAR:
            fail(f"serve_latency_ab {mode}: a response is {worst[mode]} from predict_batch "
                 f"alone (bar {SCRIPTS_SERVED_BAR})")
        launches[f"serve_latency_ab_{mode}"] = rec["kernel_launches"]
    if (ab["modes"]["bucketed"]["buckets"], ab["modes"]["fixed_batch"]["buckets"]) != (
            [1, 2, 4, 8], [8]):
        fail(f"serve_latency_ab buckets: {ab['modes']}")

    # Connectivity profile.
    kernels.reset_launches()
    t0 = time.perf_counter()
    conn = profile_connectivity.main(SCRIPTS_CONN + ["--device", "cuda",
                                                     "--image-dir", image_dir])
    got = dict(kernels.LAUNCHES)
    emit({"phase": "profile_connectivity", "seconds": time.perf_counter() - t0,
          "launches": got, **conn})
    if got != per_forward(1, SLIC_ITERS, 0):
        fail(f"profile_connectivity launched {got}, expected B1 {SLIC_ITERS} alone")
    if not (isinstance(conn["device"], dict) and all(
            isinstance(v["device_busy_ms"], float) and len(v["top_kernels"]) == 5
            for v in conn["device"].values())):
        fail(f"profile_connectivity has no device breakdown: {conn['device']}")
    if not (conn["cc_ms"] > 0 and conn["full_ms"] > conn["cc_ms"]
            and len(conn["cc_sweeps_per_image"]) == 16 and min(conn["cc_sweeps_per_image"]) > 0):
        fail(f"profile_connectivity: implausible numbers {conn}")
    launches["profile_connectivity"] = got

    # Checkpoint migration, as a subprocess on a directory of its own.
    work = os.path.join(out_dir, "migrate")
    os.makedirs(work)
    rng = np.random.default_rng(3)
    payload = {"epoch": 2, "params": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
               "history": [0.5, 0.25], "name": "fusion"}
    with open(os.path.join(work, "legacy.ckpt"), "wb") as f:
        pickle.dump(payload, f, protocol=4)
    save_checkpoint(os.path.join(work, "npz.ckpt"), {"epoch": 1})
    with open(os.path.join(work, "refused.ckpt"), "wb") as f:
        pickle.dump({"hook": _NamesSystem()}, f)
    with open(os.path.join(work, "refused.ckpt"), "rb") as f:
        refused_bytes = f.read()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m",
                          "camouflage_multimodal_tpu_torch.scripts.migrate_checkpoints", work],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    lines = res.stdout.splitlines()
    counts = {k: sum(ln.startswith(k + " ") for ln in lines)
              for k in ("migrated", "already npz", "refused")}
    back = load_checkpoint(os.path.join(work, "legacy.ckpt"))
    want_leaves = dict(migrate_checkpoints._leaves(payload))
    got_leaves = dict(migrate_checkpoints._leaves(back))
    same = got_leaves.keys() == want_leaves.keys() and all(
        np.array_equal(np.asarray(got_leaves[p]), np.asarray(v)) for p, v in want_leaves.items())
    with open(os.path.join(work, "refused.ckpt"), "rb") as f:
        untouched = f.read() == refused_bytes
    emit({"phase": "migrate_checkpoints", "seconds": time.perf_counter() - t0,
          "returncode": res.returncode, "counts": counts, "output": lines,
          "migrated_equal": same, "refused_untouched": untouched})
    if (res.returncode, counts) != (1, {"migrated": 1, "already npz": 1, "refused": 1}) \
            or not same or not untouched:
        fail(f"migrate_checkpoints: exit {res.returncode}, counts {counts}, equal {same}, "
             f"refused file untouched {untouched}\n{res.stderr[-2000:]}")

    # Graft entry and the multichip dry runs.
    fn, args = graft_entry.entry("cuda")
    fn(*args)
    torch.cuda.synchronize()
    kernels.reset_launches()
    ms = []
    for _ in range(SCRIPTS_ENTRY_CALLS):
        t0 = time.perf_counter()
        outs = fn(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    got = dict(kernels.LAUNCHES)
    finite = all(bool(torch.isfinite(t).all()) for t in outs)
    emit({"phase": "graft_entry", "ms": sorted(ms)[len(ms) // 2], "calls": len(ms),
          "launches": got, "shapes": [list(t.shape) for t in outs], "finite": finite})
    if got != per_forward(SCRIPTS_ENTRY_CALLS, 4, 2) or not finite:
        fail(f"graft_entry: launches {got} over {SCRIPTS_ENTRY_CALLS} calls "
             f"(expected B1 4, B2 2 a call), finite {finite}")
    launches["graft_entry"] = got
    cpu_loss = graft_entry.fusion_step(2, None, "cpu")   # data axis 2 in both dry runs
    for n, mesh in ((2, [2, 1]), (4, [2, 2])):
        t0 = time.perf_counter()
        dry = graft_entry.dryrun_multichip(n, device="cuda")
        emit({"phase": "dryrun_multichip", "n_devices": n,
              "seconds": time.perf_counter() - t0, "cpu_fusion_loss": cpu_loss,
              "fusion_loss_abs_diff_to_cpu": abs(dry["fusion_loss"] - cpu_loss), **dry})
        if dry["mesh"] != mesh or not abs(dry["fusion_loss"] - cpu_loss) <= SCRIPTS_DRY_LOSS_BAR:
            fail(f"dryrun_multichip({n}): mesh {dry['mesh']}, loss {dry['fusion_loss']} "
                 f"against one CPU process's {cpu_loss} (bar {SCRIPTS_DRY_LOSS_BAR})")
        for rank in dry["ranks"]:
            want = {"fusion_step": per_forward(1, 0, 2, 2),
                    "data_parallel": per_forward(1, 2, 0)}
            if mesh[1] > 1:
                want["spatial"] = per_forward(1, 2, 0)
            got = {k: rank[k]["launches"] for k in want}
            if got != want or ("spatial" in rank) != (mesh[1] > 1):
                fail(f"dryrun_multichip({n}) rank {rank['rank']}: launches {got}, "
                     f"expected {want}")
            if rank["fusion_loss"] != dry["fusion_loss"] or not rank["data_parallel"]["finite"]:
                fail(f"dryrun_multichip({n}) rank {rank['rank']} disagrees with rank 0")
        launches[f"dryrun_multichip_{n}"] = [
            {k: rank[k]["launches"] for k in ("fusion_step", "data_parallel", "spatial")
             if k in rank} for rank in dry["ranks"]]
    emit({"phase": "scripts", "seconds": time.perf_counter() - t_phase})
    return launches


def scripts_launches(launches, name):
    """One kernel's launches of each phase-9g path (per rank for the dry
    runs)."""
    out = {}
    for path, got in launches.items():
        if isinstance(got, list):
            out[path] = [sum(part[name] for part in rank.values()) for rank in got]
        else:
            out[path] = got[name]
    return out


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


def hand_kernel_names():
    """Names of the kernels in the port's CUDA sources (each ends in
    ``_kernel``)."""
    import re

    csrc = os.path.join(REPO, "camouflage_multimodal_tpu_torch", "csrc")
    names = set()
    for name in os.listdir(csrc):
        if not name.endswith((".cu", ".cuh")):
            continue                                   # csrc/host: the C++ host libraries
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

    from camouflage_multimodal_tpu_torch.core.profiling import busy_us, is_card_event

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
        spans = sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events if is_card_event(ev))
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
        elif is_card_event(ev):
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
    ap.add_argument("--dp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-work", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mp-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mp-work", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    trace = os.path.abspath(args.profile) if args.profile else None
    t_start = time.perf_counter()

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
        from camouflage_multimodal_tpu_torch import cli as cli_mod
        from camouflage_multimodal_tpu_torch.core import kernels
        from camouflage_multimodal_tpu_torch.ops import attention as attention_mod
        slic_mod = importlib.import_module("camouflage_multimodal_tpu_torch.ops.slic")
        from camouflage_multimodal_tpu_torch.train import train_fusion as train_mod
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    for path in ARTIFACTS:
        if not os.path.exists(os.path.join(REPO, path)):
            fail(f"missing artifact {path}")
    os.chdir(REPO)

    if args.dp_rank is not None:
        dp_rank_main(torch, np, api, kernels, args)
        return
    if args.mp_rank is not None:
        mp_rank_main(torch, np, api, kernels, args)
        return
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
    packages = phase_host_packages()
    phase_build(kernels)
    b1 = phase_slic_assign(torch, slic_mod, synthetic_images(7, BATCH, SIZE))
    ops_surface = phase_ops_surface(torch, slic_mod)
    fusion_model, _ = api.load_multimodal_model(ARTIFACTS[0], device="cuda")
    b2_cases, b2_err = phase_fused_mha(torch, kernels, attention_mod, fusion_model)
    b3_cases, b3_err = phase_fused_mha_bwd(torch, kernels, attention_mod, fusion_model)
    predictor, batches, launches = phase_slice(torch, np, kernels, api, args.batches)
    surface_launches = phase_surface(torch, np, kernels)
    with tempfile.TemporaryDirectory() as out_dir:
        trainer, train_ds, train_launches = phase_train_slice(
            torch, np, kernels, api, train_mod, out_dir)
        rg_trainer, rg_ds, rg_launches = phase_train_rg(torch, np, kernels, api, out_dir)
        kg_trainer, kg_subgraphs = phase_train_kg(torch, np, kernels, api, out_dir)
        _, workflow_launches = phase_workflow(torch, np, kernels, api, out_dir)
        phase_overlap(torch, np, api, out_dir)
        serve_launches, served, serve_images = phase_serve(torch, np, kernels, api, slic_mod)
        phase_cli_serve(np, served, serve_images)
        phase_cli(torch, np, cli_mod, packages, out_dir)
        dp_launches = phase_data_parallel(torch, np, kernels, api, out_dir)
        mp_kernels = phase_model_axis_kernels(torch, kernels, attention_mod, fusion_model)
        mp_launches = phase_model_axis(torch, np, kernels, api, out_dir)
        bench_launches = phase_bench(torch, np, kernels, out_dir)
        script_launches = phase_scripts(torch, np, kernels, api, out_dir)
        native_launches = phase_native(torch, np, kernels, out_dir)
    (b1_ms, b1_host, b1_plain, b1_bound, _), (b2, b2_bound) = phase_times(
        torch, slic_mod, attention_mod, b1, b2_cases, predictor, batches, trace)
    b3, b3_bound = phase_times_train(torch, kernels, attention_mod, b3_cases, trainer,
                                     train_ds, bool(trace))
    phase_times_graph_training(torch, np, rg_trainer, rg_ds, kg_trainer, kg_subgraphs,
                               bool(trace))

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
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
         "launches_serving": serve_launches["slic_assign"],
         "launches_surface": {k: v["slic_assign"] for k, v in surface_launches.items()},
         "launches_data_parallel_world1": dp_total(dp_launches["world1"], "slic_assign"),
         "launches_data_parallel_per_rank": [dp_total(r, "slic_assign")
                                             for r in dp_launches["ranks"]],
         "launches_model_axis_per_rank": [dp_total(r, "slic_assign") for r in mp_launches],
         "launches_bench": {row: v["slic_assign"] for row, v in bench_launches.items()},
         "launches_scripts": scripts_launches(script_launches, "slic_assign"),
         "launches_native_e2e": {k: v["slic_assign"] for k, v in native_launches.items()},
         "per_rg_training": "1 launch: one SLIC assignment of 16 images of 256^2 against K=529",
         "max_abs_err": b1["max_abs_err"],
         "ms": b1_ms, "host_ms": b1_host, "plain_ms": b1_plain, "bound_ms": b1_bound[0],
         "bound_by": b1_bound[1], "library_ms": None,
         "device_ms_k529": ops_surface["k529"]["device_ms"],
         "digests_k529_equal_unchunked": ops_surface["k529"]["digests_equal_unchunked"],
         "large_k": [{key: rec[key] for key in (
             "size", "k", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}
             for rec in ops_surface["large_k"]]},
        {"name": "fused_mha", "route": "cuda",
         "source": "camouflage_multimodal_tpu_torch/csrc/fused_mha.cu",
         "replaces": "camouflage_multimodal_tpu/ops/pallas_attention.py:30",
         "per": "2 launches: rg2kg (4x640 q, 13 k) + kg2rg (4x13 q, 640 k), E=256, 8 heads",
         "launches": launches["fused_mha"] + train_launches["fused_mha"],
         "launches_inference": launches["fused_mha"],
         "launches_training": train_launches["fused_mha"],
         "launches_workflow": workflow_launches["fused_mha"],
         "launches_serving": serve_launches["fused_mha"],
         "launches_surface": {k: v["fused_mha"] for k, v in surface_launches.items()},
         "launches_data_parallel_world1": dp_total(dp_launches["world1"], "fused_mha"),
         "launches_data_parallel_per_rank": [dp_total(r, "fused_mha")
                                             for r in dp_launches["ranks"]],
         "launches_model_axis_per_rank": [dp_total(r, "fused_mha") for r in mp_launches],
         "launches_bench": {row: v["fused_mha"] for row, v in bench_launches.items()},
         "launches_scripts": scripts_launches(script_launches, "fused_mha"),
         "launches_native_e2e": {k: v["fused_mha"] for k, v in native_launches.items()},
         **mp_rank_shapes(mp_kernels, "fused_mha"),
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
         "launches_serving": serve_launches["fused_mha_bwd"],
         "launches_surface": {k: v["fused_mha_bwd"] for k, v in surface_launches.items()},
         "launches_data_parallel_world1": dp_total(dp_launches["world1"], "fused_mha_bwd"),
         "launches_data_parallel_per_rank": [dp_total(r, "fused_mha_bwd")
                                             for r in dp_launches["ranks"]],
         "launches_model_axis_per_rank": [dp_total(r, "fused_mha_bwd") for r in mp_launches],
         "launches_bench": {row: v["fused_mha_bwd"] for row, v in bench_launches.items()},
         "launches_scripts": scripts_launches(script_launches, "fused_mha_bwd"),
         "launches_native_e2e": {k: v["fused_mha_bwd"] for k, v in native_launches.items()},
         **mp_rank_shapes(mp_kernels, "fused_mha_bwd"),
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
