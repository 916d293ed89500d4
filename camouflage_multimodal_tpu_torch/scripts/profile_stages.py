"""Per-stage wall-clock profile of the inference pipeline with real barriers.

Port of the JAX system's ``scripts/profile_stages.py``: times each stage of
the port's pipeline (SLIC's iterations through kernel B1, connectivity,
Canny, segment features, adjacency, RAG weights, the GNN, the fusion
through kernel B2 and the paint-back) as its own call at bench shapes, on the
bench's models (``bench.build_models``). Each time is the median over
``--iters`` host-clock iterations, each ending in a device→host pull of one
element; ``_dispatch_floor_ms_per_img`` is a trivial op timed the same way.
On the card, ``_device_busy_ms_per_img`` gives each stage's device-busy
time from ``torch.profiler`` (``core.profiling.device_busy_ms``: the union
of its kernels' and copies' spans), so host time and card time can be told
apart. ``_total_ms_per_img`` sums the stages.

    python -m camouflage_multimodal_tpu_torch.scripts.profile_stages \\
        --image-size 352 --batch 16 --iters 20 [--device cuda|cpu] [--image-dir DIR]

Images: the ``*.jpg`` of ``--image-dir`` when given, else the bench's
seeded images. Prints a line per stage, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.bench import (
    BenchConfig, build_models, image_paths, load_images, pull)
from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.core.profiling import device_busy_ms
from camouflage_multimodal_tpu_torch.ops.canny import canny
from camouflage_multimodal_tpu_torch.ops.connectivity import enforce_label_connectivity
from camouflage_multimodal_tpu_torch.ops.image import rgb_to_gray
from camouflage_multimodal_tpu_torch.ops.rag import rag_edge_weights, region_adjacency
from camouflage_multimodal_tpu_torch.ops.regions import region_features
from camouflage_multimodal_tpu_torch.ops.slic import slic
from camouflage_multimodal_tpu_torch.pipeline import paint_segments

# The JAX script's stages but its run-structured connectivity, which the
# port does not have, then the two its docstring lists that it does not time.
STAGES = ("slic_iterations", "connectivity", "canny", "segment_features", "adjacency",
          "rag_weights", "rg_gnn", "fusion", "paint")
SLIC_ITERS = 10
BUSY_CALLS = 3             # calls under the profiler per stage


def timed(fn: Callable, iters: int, warmup: int = 3) -> float:
    """Median seconds of ``fn()`` followed by a pull of its output."""
    for _ in range(warmup):
        pull(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        pull(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def stage_calls(pipe, kg: torch.Tensor, imgs: torch.Tensor, n_segments: int
                ) -> Dict[str, Callable]:
    """Each stage as a call on the previous stages' outputs (computed here
    once), in the pipeline's order and with its arguments."""
    K = pipe.rg.max_nodes
    B = imgs.shape[0]
    model, fusion_model = pipe.rg.model, pipe.fusion_model

    def slic_raw():
        return slic(imgs, n_segments=n_segments, num_iters=SLIC_ITERS, backend="exact",
                    enforce_connectivity=False, return_drift=True,
                    window_radius=pipe.rg.window_radius)

    labels_raw = slic_raw()[0]

    def conn():
        return enforce_label_connectivity(labels_raw, n_segments, max_labels=K)

    labels = conn()
    gray = rgb_to_gray(imgs)
    edges = canny(gray, sigma=2.0)

    def feats_f():
        return region_features(imgs, labels, edges, K)

    reg = feats_f()
    feats, node_mask = reg["features"], reg["node_mask"]
    adj = region_adjacency(labels, K)
    w = rag_edge_weights(feats, adj)

    def gnn():
        return model(feats, adj, w, node_mask)

    rg_out = gnn()
    kg_b = kg[None].expand(B, *kg.shape)

    def paint():
        probs = torch.softmax(rg_out["mask_logits"], dim=-1)[..., 1]
        return paint_segments(torch.where(node_mask, probs, 0.0), labels,
                              pipe.rg.paint_mapping)

    return {
        "slic_iterations": slic_raw,
        "connectivity": conn,
        "canny": lambda: canny(gray, sigma=2.0),
        "segment_features": lambda: feats_f()["features"],
        "adjacency": lambda: region_adjacency(labels, K),
        "rag_weights": lambda: rag_edge_weights(feats, adj),
        "rg_gnn": gnn,
        "fusion": lambda: fusion_model(rg_out["node_embeddings"], kg_b, rg_mask=node_mask,
                                       return_attention=True),
        "paint": paint,
    }


@torch.inference_mode()
def profile(image_size: int = 352, batch: int = 16, n_segments: int = 500,
            iters: int = 20, device: str = "cuda", image_dir: Optional[str] = None) -> Dict:
    dev = resolve_device(device)
    cfg = BenchConfig(batch=batch, image_size=image_size, n_segments=n_segments)
    pipe, kg = build_models(cfg, dev)
    imgs = torch.from_numpy(load_images(image_paths(image_dir, batch), batch,
                                        image_size)).to(dev)
    calls = stage_calls(pipe, kg, imgs, n_segments)

    one = torch.zeros((), device=dev)
    floor_ms = timed(lambda: one + 1.0, iters) * 1000.0 / batch
    out: Dict = {}
    busy: Dict = {}
    for name in STAGES:
        ms = timed(calls[name], iters) * 1000.0 / batch
        out[name] = round(ms, 4)
        if dev.type == "cuda":
            b = device_busy_ms(calls[name], BUSY_CALLS)
            busy[name] = round(b / batch, 4) if isinstance(b, float) else b
        print(f"{name:20s} {ms:8.3f} ms/img", flush=True)
    out["_dispatch_floor_ms_per_img"] = round(floor_ms, 4)
    out["_total_ms_per_img"] = round(
        sum(v for k, v in out.items() if not k.startswith("_")), 4)
    out["_device_busy_ms_per_img"] = busy if dev.type == "cuda" else "not measured"
    out["_config"] = {"image_size": image_size, "batch": batch, "n_segments": n_segments,
                      "max_nodes": pipe.rg.max_nodes, "iters": iters,
                      "backend": dev.type,
                      "device_name": (torch.cuda.get_device_name(dev)
                                      if dev.type == "cuda" else "cpu"),
                      "images": image_dir if image_paths(image_dir, 1) else "seeded"}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image-size", type=int, default=352)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n-segments", type=int, default=500)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image-dir", default=None)
    args = ap.parse_args(argv)
    out = profile(args.image_size, args.batch, args.n_segments, args.iters, args.device,
                  args.image_dir)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
