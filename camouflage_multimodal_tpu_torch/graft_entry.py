"""Entry points of the port; counterpart of the JAX system's
``__graft_entry__.py``.

* :func:`entry` — the flagship model's forward step (the full multimodal
  pipeline: SLIC → features → RAG → RG-GNN → cross-attention fusion heads)
  with example arguments, at the JAX entry's shapes.
* :func:`dryrun_multichip` — ``n_devices`` ranks on a ``(data, model)``
  mesh, each a subprocess of this module joined over localhost, run one
  fusion training step with the batch split over ``data`` (and, at
  ``model > 1``, the attention and FFN weights over ``model``), then a
  data-parallel region-graph forward and, at ``model > 1``, its spatially
  sharded variant (image rows over ``model``).

Unlike the JAX dry run, there is no fallback to virtual CPU devices when
there are fewer cards than ranks: with ``device="cuda"`` rank r computes
on ``cuda:(r % device_count)`` — ranks that share a card join over gloo,
ranks with a card each over NCCL — and a rank that finds no card raises;
``device="cpu"`` runs gloo ranks on the CPU.

The dry run's fusion has dropout 0 and the fused attention on, so its step
runs kernels B2 forward and B3 backward (the JAX dry run trains with the
default dropout of 0.3 through plain attention).

    python -m camouflage_multimodal_tpu_torch.graft_entry [--n-devices 4] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.models.fusion import MultimodalCamouflageDetector
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN
from camouflage_multimodal_tpu_torch.pipeline import MultimodalPipeline, RegionGraphPipeline

_IMAGE_SIZE = 128
_N_SEGMENTS = 128
_MAX_NODES = 256
_N_KG = 13
_SLIC_ITERS = 4
_DRY_NODES = 64            # the dry run's fusion node bucket
_DRY_IMAGE = 32            # the dry run's RG forward: 32², 32 segments, 64 nodes, 2 iterations
_DRY_SLIC_ITERS = 2
_DRY_LR = 1e-3
RANK_TIMEOUT = 600         # seconds a rank may take, the rendezvous included


def _seeded(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` initialised from a generator seeded 0 (the JAX entry's
    ``PRNGKey(0)`` for each model)."""
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def entry_pipeline(rg_model: RegionGraphGNN, fusion_model: MultimodalCamouflageDetector
                   ) -> MultimodalPipeline:
    """The pipeline :func:`entry`'s step runs: 128², 128 segments, the
    256-node bucket, 4 SLIC iterations."""
    rg_pipe = RegionGraphPipeline(rg_model, n_segments=_N_SEGMENTS, image_size=_IMAGE_SIZE,
                                  max_nodes=_MAX_NODES, slic_iters=_SLIC_ITERS)
    return MultimodalPipeline(rg_pipe, fusion_model)


def entry(device: str = "cuda") -> Tuple[Callable, Tuple]:
    """(fn, example_args): ``fn(rg_model, fusion_model, images, kg)`` is the
    multimodal forward step at 128², 128 segments, the 256-node bucket and 4
    SLIC iterations, returning ``(mask_logits, score, heatmap)``; the
    example arguments are the seeded models, 2 images and a 13 × 128 KG
    matrix on ``device``. The pipeline is built once, for the example
    models, as the JAX entry builds it outside its step; ``fn`` builds
    another only when it is handed other models."""
    dev = resolve_device(device)
    rg_model = _seeded(RegionGraphGNN())
    fusion_model = _seeded(MultimodalCamouflageDetector(use_pallas=True))
    g = torch.Generator().manual_seed(0)
    images = torch.rand((2, _IMAGE_SIZE, _IMAGE_SIZE, 3), generator=g).to(dev)
    kg = torch.randn((_N_KG, 128), generator=g).to(dev)

    rg_model, fusion_model = rg_model.to(dev), fusion_model.to(dev)
    pipe = entry_pipeline(rg_model, fusion_model)

    def fn(rg_model, fusion_model, images, kg):
        nonlocal pipe
        if pipe.rg.model is not rg_model or pipe.fusion_model is not fusion_model:
            pipe = entry_pipeline(rg_model, fusion_model)
        out = pipe(images, kg)
        return out["mask_logits"], out["score"], out["heatmap"]

    return fn, (rg_model, fusion_model, images, kg)


def mesh_axes(n_devices: int) -> Tuple[int, int]:
    """(data, model) of the dry run's mesh: model 2 for an even count of at
    least 4, else 1."""
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return n_devices // model_axis, model_axis


def dry_batch(data_axis: int) -> Tuple[Dict[str, np.ndarray], np.random.Generator]:
    """The JAX dry run's batch of ``2 · data_axis`` records (K = 64, 13 KG
    rows) from ``default_rng(0)``, and the generator after it (the RG
    forward's images come next)."""
    B = 2 * data_axis
    rng = np.random.default_rng(0)
    batch = {
        "rg": rng.standard_normal((B, _DRY_NODES, 128)).astype(np.float32),
        "rg_mask": np.ones((B, _DRY_NODES), bool),
        "kg": rng.standard_normal((B, _N_KG, 128)).astype(np.float32),
        "y": rng.integers(0, 2, B),
        "edge": rng.integers(0, 2, B).astype(np.float32),
        "score": rng.random(B).astype(np.float32),
    }
    return batch, rng


def dry_fusion_model() -> MultimodalCamouflageDetector:
    """The dry run's fusion model: seed 0, dropout 0, the fused attention."""
    return _seeded(MultimodalCamouflageDetector(dropout=0.0, use_pallas=True))


def fusion_step(data_axis: int, mesh=None, device: str = "cuda") -> float:
    """The dry run's fusion train step (lr 1e-3, focal alpha 0.75) on the
    seed-0 fusion model, with ``mesh`` (this rank's block of the batch,
    the weights sharded over ``model``) or in one process; returns the
    whole batch's summed loss."""
    from camouflage_multimodal_tpu_torch.models.layers import set_data_group
    from camouflage_multimodal_tpu_torch.parallel.sharding import (
        all_reduce_sum, block, data_group, replicate, set_model_group, shard_fusion_params)
    from camouflage_multimodal_tpu_torch.train.state import make_adamw
    from camouflage_multimodal_tpu_torch.train.train_fusion import FusionTrainer

    dev = resolve_device(device)
    model = dry_fusion_model()
    trainer = FusionTrainer(model=model.to(dev), learning_rate=_DRY_LR)
    batch, _ = dry_batch(data_axis)
    group = data_group(mesh)
    rows = block(len(batch["y"]), group)
    local = {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch.items()}
    if mesh is not None:
        replicate(model, mesh)
        shard_fusion_params(model, mesh)
    set_data_group(model, group)
    try:
        trainer.optimizer = make_adamw(model.parameters(), trainer.weight_decay)
        loss, _ = trainer.train_step(local, _DRY_LR, group)
        return float(all_reduce_sum(loss, group).cpu())
    finally:
        set_data_group(model, None)
        set_model_group(model, None)


def _rank(args) -> None:
    """One rank of :func:`dryrun_multichip`: join the group, run the step and
    the RG forwards, write this rank's record; rank 0 prints the ok line."""
    from camouflage_multimodal_tpu_torch.parallel import distributed, sharding

    on_card = args.device == "cuda"
    backend = "gloo" if not on_card or args.shared else "nccl"
    distributed.initialize(f"127.0.0.1:{args.port}", args.world, args.rank, backend=backend,
                           timeout_s=RANK_TIMEOUT, device=args.device)
    data_axis, model_axis = mesh_axes(args.world)
    record: Dict = {"rank": args.rank, "backend": backend}
    try:
        mesh = sharding.make_mesh(args.device, model_axis=model_axis)
        kernels.reset_launches()
        t0 = time.perf_counter()
        loss = fusion_step(data_axis, mesh, args.device)
        record["fusion_step"] = {"seconds": time.perf_counter() - t0,
                                 "launches": dict(kernels.LAUNCHES)}

        dev = resolve_device(args.device)
        rg_model = _seeded(RegionGraphGNN()).to(dev)
        _, rng = dry_batch(data_axis)
        images = torch.from_numpy(rng.random((data_axis, _DRY_IMAGE, _DRY_IMAGE, 3))
                                  .astype(np.float32)).to(dev)
        variants = [("data_parallel", False)] + ([("spatial", True)] if model_axis > 1 else [])
        for name, spatial in variants:
            pipe = RegionGraphPipeline(rg_model, n_segments=_DRY_IMAGE, image_size=_DRY_IMAGE,
                                       max_nodes=_DRY_NODES, slic_iters=_DRY_SLIC_ITERS,
                                       mesh=mesh, spatial=spatial)
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = pipe(images)
            heatmap = out["heatmap"].cpu()
            record[name] = {"seconds": time.perf_counter() - t0,
                            "launches": dict(kernels.LAUNCHES),
                            "heatmap_shape": list(heatmap.shape),
                            "finite": bool(torch.isfinite(heatmap).all())}
    finally:
        distributed.shutdown()
    record["fusion_loss"] = loss
    if not np.isfinite(loss):
        raise RuntimeError("multichip fusion step produced NaN")
    with open(os.path.join(args.work, f"rank{args.rank}.json"), "w") as f:
        json.dump(record, f)
    if args.rank == 0:
        print(f"dryrun_multichip ok: mesh=({data_axis},{model_axis}) "
              f"fusion_loss={loss:.4f} "
              f"heatmap_shape={tuple(record['data_parallel']['heatmap_shape'])}", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict:
    """Run the dry run over ``n_devices`` ranks (module docstring); relays
    rank 0's ``dryrun_multichip ok`` line and returns {"mesh", "fusion_loss",
    "ranks": each rank's record}. Raises when a rank fails or outlives
    ``RANK_TIMEOUT`` seconds."""
    from camouflage_multimodal_tpu_torch.parallel.distributed import run_ranks

    dev = resolve_device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as work:
        argv = [sys.executable, "-m", "camouflage_multimodal_tpu_torch.graft_entry",
                "--world", str(n_devices), "--port", str(_free_port()), "--work", work,
                "--device", dev.type]
        if dev.type == "cuda" and n_devices > count:
            argv.append("--shared")
        try:
            logs = run_ranks([argv + ["--rank", str(r)] for r in range(n_devices)],
                             [{**env, "LOCAL_RANK": str(r % count) if count else "0"}
                              for r in range(n_devices)], RANK_TIMEOUT, cwd=root)
        except RuntimeError as err:
            raise RuntimeError(f"dryrun_multichip: {err}") from None
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for ln in logs[0].splitlines():
        if ln.startswith("dryrun_multichip ok"):
            print(ln, flush=True)
    return {"mesh": list(mesh_axes(n_devices)), "fusion_loss": ranks[0]["fusion_loss"],
            "ranks": ranks}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-devices", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--shared", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        torch.set_num_threads(1)
        _rank(args)
        return
    fn, example = entry(args.device)
    mask_logits, score, heatmap = fn(*example)
    print(f"entry ok: mask_logits={tuple(mask_logits.shape)} score={tuple(score.shape)} "
          f"heatmap={tuple(heatmap.shape)}", flush=True)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
