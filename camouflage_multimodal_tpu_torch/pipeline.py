"""Image → region graph → GNN → multimodal fusion, batched.

Port of ``camouflage_multimodal_tpu/pipeline.py``. The JAX package jits
the whole chain into one program and ``vmap``s it; here it runs eagerly
with a real batch axis, on the device of the input images and the models'
weights. Stages, in order: uint8 → float, SLIC (Lab, blur, all-K
assignment through kernel B1, drift telemetry), connectivity, Canny,
region features, 8-connected adjacency, RAG weights, ``RegionGraphGNN``,
softmax + paint-back, then cross-attention fusion (kernel B2) and its four
heads. :func:`build_region_graphs_with_labels` is the training variant of
the graph build, with per-node GT labels. Data-parallel meshes and spatial
sharding are not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from camouflage_multimodal_tpu_torch.models.fusion import MultimodalCamouflageDetector
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN
from camouflage_multimodal_tpu_torch.ops.canny import canny
from camouflage_multimodal_tpu_torch.ops.connectivity import enforce_label_connectivity
from camouflage_multimodal_tpu_torch.ops.image import rgb_to_gray
from camouflage_multimodal_tpu_torch.ops.rag import rag_edge_weights, region_adjacency
from camouflage_multimodal_tpu_torch.ops.regions import region_features, region_label_means
from camouflage_multimodal_tpu_torch.ops.slic import grid_shape, slic


class RegionGraphBatch(NamedTuple):
    """Fixed-shape padded region-graph batch."""

    segments: torch.Tensor      # (B, H, W) int64
    features: torch.Tensor      # (B, K, 15) float32
    adjacency: torch.Tensor     # (B, K, K) bool
    edge_weights: torch.Tensor  # (B, K, K) float32
    node_mask: torch.Tensor     # (B, K) bool
    # (B,) float32 SLIC drift ratio: max center drift over the safe bound of
    # the JAX package's candidate window; < 1 means that window equals the
    # all-K sweep this port runs (ops/slic.py).
    window_drift: torch.Tensor


def padded_nodes(n_segments: int, image_size: int, multiple: int = 128) -> int:
    """Node bucket: the SLIC grid size rounded up to a multiple of 128."""
    gh, gw = grid_shape(n_segments, image_size, image_size)
    return -(-(gh * gw) // multiple) * multiple


def build_region_graphs(images: torch.Tensor, n_segments: int = 500,
                        max_nodes: Optional[int] = None, slic_iters: int = 10,
                        window_radius: int = 3,
                        feature_norm: Optional[int] = None) -> RegionGraphBatch:
    """(B, H, W, 3) uint8 or float RGB in [0, 1] → padded graph batch.

    ``max_nodes`` defaults to :func:`padded_nodes`; the connectivity pass
    clamps surplus survivors into the last in-bucket label. ``feature_norm``
    None normalizes positions by the image size, 256 reproduces the
    reference's hard-coded /256."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    if max_nodes is None:
        max_nodes = padded_nodes(n_segments, images.shape[1])
    # cmt:: ranges name the stages in a torch.profiler trace (chip_smoke.py
    # --profile); without a profiler each costs about a microsecond.
    with record_function("cmt::slic"):
        raw, drift = slic(images, n_segments=n_segments, num_iters=slic_iters,
                          window_radius=window_radius)
    with record_function("cmt::connectivity"):
        seg = enforce_label_connectivity(raw, n_segments, max_labels=max_nodes)
    with record_function("cmt::canny"):
        edges = canny(rgb_to_gray(images), sigma=2.0)
    with record_function("cmt::region_features"):
        reg = region_features(images, seg, edges, max_nodes, norm_size=feature_norm)
    with record_function("cmt::rag"):
        adj = region_adjacency(seg, max_nodes)
        w = rag_edge_weights(reg["features"], adj)
    return RegionGraphBatch(seg, reg["features"], adj, w, reg["node_mask"], drift)


def build_region_graphs_with_labels(
        images: torch.Tensor, masks: torch.Tensor, instances: torch.Tensor,
        edges_gt: torch.Tensor, n_segments: int = 500,
        max_nodes: Optional[int] = None, slic_iters: int = 10,
        window_radius: int = 3) -> Tuple[RegionGraphBatch, Dict[str, torch.Tensor]]:
    """The training variant of :func:`build_region_graphs`: also the
    per-node GT labels with the reference's thresholds on the per-segment
    means of the (B, H, W) maps (uint8, or float in [0, 1]): mask > 0.5,
    instance > 0.5, edge > 0.3. Labels: ``mask_labels`` and
    ``instance_labels`` int64, ``edge_labels`` float32, each (B, K)."""
    if max_nodes is None:
        max_nodes = padded_nodes(n_segments, images.shape[1])
    batch = build_region_graphs(images, n_segments, max_nodes, slic_iters, window_radius)

    def to01(x):
        return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()

    with record_function("cmt::labels"):
        maps = torch.stack([to01(masks), to01(instances), to01(edges_gt)], dim=-1)
        means = region_label_means(maps, batch.segments, max_nodes)
        labels = {
            "mask_labels": (means[..., 0] > 0.5).long(),
            "instance_labels": (means[..., 1] > 0.5).long(),
            "edge_labels": (means[..., 2] > 0.3).float(),
        }
    return batch, labels


def paint_segments(segment_values: torch.Tensor, segments: torch.Tensor,
                   mapping: str = "corrected") -> torch.Tensor:
    """Per-segment values (B, K) → per-pixel maps (B, H, W).

    ``"corrected"`` paints each pixel with its own region's value;
    ``"verbatim"`` reproduces the reference's off-by-one
    (``region_graph/test.py:241-244``): every pixel shows the NEXT region's
    value and the last region 0."""
    if mapping == "verbatim":
        segment_values = torch.cat(
            [segment_values[..., 1:], torch.zeros_like(segment_values[..., :1])], dim=-1)
    elif mapping != "corrected":
        raise ValueError(f"mapping must be 'corrected' or 'verbatim', got {mapping!r}")
    B = segments.shape[0]
    flat = segments.reshape(B, -1).long()
    return torch.gather(segment_values, 1, flat).reshape(segments.shape)


class RegionGraphPipeline:
    """Images → region-graph GNN predictions, for a model on one device."""

    def __init__(self, model: RegionGraphGNN, n_segments: int = 500,
                 image_size: int = 256, max_nodes: Optional[int] = None,
                 slic_iters: int = 10, paint_mapping: str = "corrected",
                 window_radius: int = 3,
                 feature_norm: Optional[int] = None) -> None:
        self.model = model.eval()
        self.n_segments = n_segments
        self.image_size = image_size
        self.max_nodes = max_nodes or padded_nodes(n_segments, image_size)
        self.slic_iters = slic_iters
        self.window_radius = window_radius
        self.feature_norm = feature_norm
        self.paint_mapping = paint_mapping

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        batch = build_region_graphs(images, self.n_segments, self.max_nodes,
                                    self.slic_iters, self.window_radius,
                                    self.feature_norm)
        with record_function("cmt::gnn"):
            out = self.model(batch.features, batch.adjacency, batch.edge_weights,
                             batch.node_mask)
            probs = torch.softmax(out["mask_logits"], dim=-1)[..., 1]
            probs = torch.where(batch.node_mask, probs, 0.0)
            heatmap = paint_segments(probs, batch.segments, self.paint_mapping)
        return {
            "heatmap": heatmap,
            "segments": batch.segments,
            "node_mask": batch.node_mask,
            "region_features": batch.features,
            "mask_logits": out["mask_logits"],
            "instance_logits": out["instance_logits"],
            "edge_logits": out["edge_logits"],
            "node_embeddings": out["node_embeddings"],
            "graph_embedding": out["graph_embedding"],
            "window_drift": batch.window_drift,
        }


class MultimodalPipeline:
    """Images + KG category embeddings → 4-head multimodal predictions."""

    def __init__(self, rg_pipeline: RegionGraphPipeline,
                 fusion_model: MultimodalCamouflageDetector) -> None:
        self.rg = rg_pipeline
        self.fusion_model = fusion_model.eval()

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor, kg_tensor: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        rg_out = self.rg(images)
        B = images.shape[0]
        kg = kg_tensor[None].expand(B, *kg_tensor.shape)
        with record_function("cmt::fusion"):
            out = self.fusion_model(rg_out["node_embeddings"], kg,
                                    rg_mask=rg_out["node_mask"], return_attention=True)
        if out["attention"] is None:
            del out["attention"]      # late fusion exposes no attention maps
        out["mask_prob"] = torch.softmax(out["mask_logits"], dim=-1)
        out["instance_prob"] = torch.softmax(out["instance_logits"], dim=-1)
        out["edge_prob"] = torch.sigmoid(out["edge_logits"])
        out["segments"] = rg_out["segments"]
        out["heatmap"] = rg_out["heatmap"]
        out["node_mask"] = rg_out["node_mask"]
        out["window_drift"] = rg_out["window_drift"]
        return out
