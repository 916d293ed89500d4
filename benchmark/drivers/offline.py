"""Offline directory inference: the program's four-stage walk (decode ∥
upload ∥ compute ∥ download, ``core.stages.run_overlapped``) over JPEG
scenes, closed loop, for ``--seconds``. The scenes are the mix's fixed set
(``scene_seed``); ``--seed`` orders them and draws the weights.

Decode is the program's native threaded loader, compute
``MultimodalPipeline.__call__`` on the seeded KG matrix, download
``stages.download`` of what a directory user keeps. The scenes are cycled
as one long directory; no batch is decoded after the window's end, and the
window closes when the last batch decoded before it is on the host.
``images_per_s`` is every image completed over that whole window.

``correct``: batches drawn from the seed are compared, once the window has
closed and the program is freed, with the plain reference run on the same
JPEG files decoded by PIL.
"""

from __future__ import annotations

import threading
import time
from collections.abc import Sequence
from typing import Dict, List

import numpy as np
import torch

import scenes
import weights
from harness import Check, Outcome
from reference.pipeline import predict as reference_predict
from tracing import span

KEYS = ("heatmap", "mask_prob", "instance_prob", "edge_prob", "score", "node_mask")


class WindowClosed(Exception):
    """Raised by decode once the window's time is up: no new batch starts."""


class Directory(Sequence):
    """The scenes cycled as one long directory, in chunks of ``batch`` paths."""

    def __init__(self, paths: List[str], batch: int, length: int = 10 ** 7) -> None:
        self.paths, self.batch, self.length = paths, batch, length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int):
        n = len(self.paths)
        return i, [self.paths[(i * self.batch + j) % n] for j in range(self.batch)]


def build_program(ctx, rg_state, fusion_state):
    """The program's pipeline with the seeded weights."""
    from camouflage_multimodal_tpu_torch.models.fusion import build_multimodal_model
    from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN
    from camouflage_multimodal_tpu_torch.pipeline import MultimodalPipeline, RegionGraphPipeline

    cfg, g, f, s = ctx.config, ctx.config["rg_gnn"], ctx.config["fusion"], ctx.config["slic"]
    rg = RegionGraphGNN(g["in_channels"], g["hidden_channels"], g["num_classes"],
                        g["gat_heads"], g["dropout"], g["head_dropout"])
    rg.load_state_dict(rg_state)
    fusion = build_multimodal_model({**{k: f[k] for k in ("rg_dim", "kg_dim", "hidden_dim",
                                                          "num_heads", "num_classes", "dropout",
                                                          "fusion_type")}, "use_pallas": True})
    fusion.load_state_dict(fusion_state)
    rg_pipe = RegionGraphPipeline(rg.to(ctx.device), n_segments=s["n_segments"],
                                  image_size=cfg["image_size"], max_nodes=cfg["max_nodes"],
                                  slic_iters=s["iterations"], window_radius=s["window_radius"])
    return MultimodalPipeline(rg_pipe, fusion.to(ctx.device))


def run(ctx) -> Outcome:
    from camouflage_multimodal_tpu_torch import native
    from camouflage_multimodal_tpu_torch.core import stages

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    size, batch = cfg["image_size"], tr["batch"]
    width, height = tr["scene_size"]
    blobs = scenes.jpeg_bytes(scenes.scenes(ctx.fixed_generator(tr["scene_seed"]), tr["scenes"],
                                            width, height), tr["jpeg_quality"])
    rng = np.random.default_rng(ctx.seed)
    # The seed orders the directory: the batches (fixed groups of scenes) in
    # another order, and the scenes inside each; every seed does the same work.
    groups = np.arange(tr["scenes"]).reshape(-1, batch)[rng.permutation(tr["scenes"] // batch)]
    order = np.concatenate([rng.permutation(g) for g in groups])
    files = scenes.write_jpegs(f"{ctx.tmp}/scenes", blobs)
    paths = [files[i] for i in order]
    ctx.phase("inputs")
    ref_rg, ref_fusion, rg_state, fusion_state, kg = weights.models(cfg, ctx.generator(1))
    pipe = build_program(ctx, rg_state, fusion_state)
    kg_program = kg.clone()
    ctx.phase("models")
    rng = np.random.default_rng(ctx.seed)
    sampled = set(rng.choice(tr["sample_pool"], tr["sample_batches"], replace=False).tolist())

    lock = threading.Lock()
    done: List[float] = []                 # completion time of each batch on the host
    nodes: List[List[int]] = []            # real node counts of each completed batch
    kept: Dict[int, Dict] = {}             # sampled batches: device outputs + host copies
    deadline = [float("inf")]

    def decode(chunk):
        i, files = chunk
        if time.perf_counter() > deadline[0]:
            raise WindowClosed
        with span("decode"):
            images, ok = native.load_batch_u8(files, size)
        if not ok.all():
            raise IOError(f"native decode failed for {[p for p, g in zip(files, ok) if not g]}")
        return i, images

    def upload(decoded):
        i, images = decoded
        return i, stages.upload(images, dev)

    compute_fn = ctx.wrapped("predict", lambda images: pipe(images, kg_program))

    def compute(uploaded):
        i, images = uploaded
        out = compute_fn(images)
        if i in sampled:
            kept[i] = {"device": out}
        return i, out

    def download(computed):
        i, out = computed
        host = stages.download(out, KEYS)
        with lock:
            done.append(time.perf_counter())
            nodes.append(host["node_mask"].sum(1).tolist())
            if i in kept:
                kept[i]["host"] = host
        return None

    def walk(n_batches: int, seconds: float) -> float:
        """Run the walk; returns the window's start time."""
        deadline[0] = float("inf")
        chunks = Directory(paths, batch, n_batches)
        t0 = time.perf_counter()
        deadline[0] = t0 + seconds
        try:
            stages.run_overlapped(chunks, decode, upload, compute, download, lambda _: None)
        except WindowClosed:
            pass
        return t0

    # Warm-up: one batch of the window's shape through every stage (the
    # first run in a checkout builds the kernels and the host libraries).
    walk(1, float("inf"))
    ctx.synchronize()
    done.clear(), nodes.clear(), kept.clear()
    ctx.setup_done()

    with ctx.tracer.window():
        t0 = walk(Directory(paths, batch).length, ctx.seconds)
    window_s = done[-1] - t0
    n_images = batch * len(done)
    memory = ctx.memory_peak()
    del pipe, compute_fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = compare(ctx, kept, paths, ref_rg, ref_fusion, kg)
    return Outcome(attempted=n_images, failed=0,
                   end_to_end={"images_per_s": n_images / window_s},
                   checks=checks, memory_peak_bytes=memory,
                   window={"images": n_images, "batches": nodes})


def compare(ctx, kept: Dict[int, Dict], paths: List[str], ref_rg, ref_fusion, kg) -> List[Check]:
    """The sampled batches against the plain reference, a block of images
    at a time."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    limits = tr["limits"]
    batch, size = tr["batch"], cfg["image_size"]
    worst = {"segments_differ": 0.0, "heatmap_gap": 0.0, "fusion_gap": 0.0}
    compared, missing = 0, 0
    for i, got in sorted(kept.items()):
        if "host" not in got:          # computed, never on the host
            missing += 1
            continue
        files = Directory(paths, batch)[i][1]
        images = torch.from_numpy(np.stack([scenes.decode_file(p, size) for p in files])).to(dev)
        for lo in range(0, batch, tr["reference_block"]):
            hi = min(batch, lo + tr["reference_block"])
            ref = reference_predict(images[lo:hi], ref_rg, ref_fusion, kg,
                                    cfg["slic"]["n_segments"], cfg["max_nodes"],
                                    cfg["slic"]["iterations"])
            gap = outputs_gap(got, ref, lo, hi)
            for k, v in gap.items():
                worst[k] = max(worst[k], v) if k != "segments_differ" else worst[k] + v
            compared += hi - lo
    checks = [Check(k, v, limits[k]) for k, v in worst.items()]
    checks.append(Check("batches_missing", float(missing), 0.0))
    checks.append(Check("nothing_compared", float(compared == 0), 0.0))
    return checks


def outputs_gap(got: Dict, ref: Dict, lo: int, hi: int) -> Dict[str, float]:
    """The numbers compared for images ``lo:hi`` of one batch."""
    dev_out, host = got["device"], got["host"]

    def h(key):
        return torch.from_numpy(np.asarray(host[key][lo:hi])).to(ref[key].device)

    seg = dev_out["segments"][lo:hi].to(ref["segments"].device)
    fusion = 0.0
    for key in ("mask_prob", "instance_prob", "edge_prob", "score"):
        fusion = max(fusion, float((h(key) - ref[key]).abs().max()))
    for key in ("rg2kg", "kg2rg"):
        got_attn = dev_out["attention"][key][lo:hi].to(ref[key].device)
        fusion = max(fusion, float((got_attn - ref[key]).abs().max()))
    return {
        "segments_differ": float((seg != ref["segments"]).sum()),
        "heatmap_gap": float((h("heatmap") - ref["heatmap"]).abs().max()),
        "fusion_gap": fusion,
    }


# ---------------------------------------------------------------------------
# The control and the faults (readings.py, tests/test_benchmark_controls.py)
# ---------------------------------------------------------------------------

def _reference_in_place(ctx, tf32: bool):
    """The plain reference as the compute stage, TF32 on or off."""
    ref_rg, ref_fusion, _, _, kg = weights.models(ctx.config, ctx.generator(1))
    cfg = ctx.config

    def predict(images):
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            out = reference_predict(images, ref_rg, ref_fusion, kg, cfg["slic"]["n_segments"],
                                    cfg["max_nodes"], cfg["slic"]["iterations"])
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        out["attention"] = {"rg2kg": out.pop("rg2kg"), "kg2rg": out.pop("kg2rg")}
        return out

    ctx.wraps["predict"] = lambda _: predict


def control(ctx) -> None:
    """The reference in the program's place, matrix products in TF32: the
    nearest precision below the configuration's float32."""
    _reference_in_place(ctx, tf32=True)


def _altered(fn):
    def predict(images):
        out = fn(images)
        out["mask_prob"] = out["mask_prob"].clone()
        out["mask_prob"][0] = out["mask_prob"][0].flip(-1)      # one image's answer swapped
        return out
    return predict


def _half_batch(fn):
    def predict(images):
        half = images.shape[0] // 2
        out = fn(images[:half])
        return {k: (torch.cat([v, v]) if isinstance(v, torch.Tensor) else
                    {a: torch.cat([b, b]) for a, b in v.items()} if isinstance(v, dict) else v)
                for k, v in out.items()}
    return predict


FAULTS = {
    "answer_altered": lambda ctx: ctx.wraps.__setitem__("predict", _altered),
    "half_batch": lambda ctx: ctx.wraps.__setitem__("predict", _half_batch),
}
