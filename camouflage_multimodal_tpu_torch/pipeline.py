"""Image → region graph → GNN → multimodal fusion, batched.

Port of ``camouflage_multimodal_tpu/pipeline.py``. The JAX package jits
the whole chain into one program and ``vmap``s it; here it runs eagerly
with a real batch axis, on the device of the input images and the models'
weights (on the card the graph build's host-free stages replay as CUDA
graphs, :func:`build_region_graphs`). Stages, in order: uint8 → float, SLIC (Lab, blur, all-K
assignment through kernel B1, drift telemetry), connectivity, Canny,
region features, 8-connected adjacency, RAG weights, ``RegionGraphGNN``,
softmax + paint-back, then cross-attention fusion (kernel B2) and its four
heads. :func:`build_region_graphs_with_labels` is the training variant of
the graph build, with per-node GT labels. Under a mesh (``mesh=``,
:func:`parallel.sharding.make_mesh`) each rank runs its block of the batch
and the outputs are gathered, so every rank gets the whole batch, as the
JAX call returns a global array; the ranks of a ``model`` axis larger than
1 repeat their data rank's work (JAX's ``P("data")`` layout). With
``spatial=True`` they split the image rows instead
(:func:`parallel.sharding.shard_spatial`): the graph build runs on each
rank's rows (``row_group`` of the ops), the GNN and the fusion run on the
replicated graphs on every rank, each paints its rows, and the heatmap and
the segment map are gathered whole.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from camouflage_multimodal_tpu_torch.core import graphs
from camouflage_multimodal_tpu_torch.core.profiling import annotate
from camouflage_multimodal_tpu_torch.models.fusion import MultimodalCamouflageDetector
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN
from camouflage_multimodal_tpu_torch.ops.canny import canny
from camouflage_multimodal_tpu_torch.ops.connectivity import enforce_label_connectivity
from camouflage_multimodal_tpu_torch.ops.image import rgb_to_gray
from camouflage_multimodal_tpu_torch.ops.rag import rag_edge_weights, region_adjacency
from camouflage_multimodal_tpu_torch.ops.regions import region_features, region_label_means
from camouflage_multimodal_tpu_torch.ops.slic import grid_shape, slic
from camouflage_multimodal_tpu_torch.parallel.sharding import (
    data_group, gather_batch, gather_dim, model_group, shard_batch, shard_spatial,
    spatial_rows)


class RegionGraphBatch(NamedTuple):
    """Fixed-shape padded region-graph batch."""

    segments: torch.Tensor      # (B, H, W) int64
    features: torch.Tensor      # (B, K, 15) float32
    adjacency: torch.Tensor     # (B, K, K) bool
    edge_weights: torch.Tensor  # (B, K, K) float32
    node_mask: torch.Tensor     # (B, K) bool
    # (B,) float32 SLIC drift ratio: max center drift over the safe bound of
    # the JAX package's candidate window; < 1 means that window equals the
    # all-K sweep this port runs (ops/slic.py). None for a batch that no
    # SLIC of this package built (graphs read from files), as in JAX.
    window_drift: Optional[torch.Tensor] = None


def padded_nodes(n_segments: int, image_size: int, multiple: int = 128) -> int:
    """Node bucket: the SLIC grid size rounded up to a multiple of 128."""
    gh, gw = grid_shape(n_segments, image_size, image_size)
    return -(-(gh * gw) // multiple) * multiple


# Keys (shapes and settings) whose stage graphs the card keeps: a
# directory walk's batch and its short last one, serving's four buckets.
_GRAPH_KEYS = 8
_GRAPHS = graphs.GraphCache(_GRAPH_KEYS)


def build_region_graphs(images: torch.Tensor, n_segments: int = 500,
                        max_nodes: Optional[int] = None, slic_iters: int = 10,
                        window_radius: int = 3,
                        feature_norm: Optional[int] = None,
                        row_group=None) -> RegionGraphBatch:
    """(B, H, W, 3) uint8 or float RGB in [0, 1] → padded graph batch.

    ``max_nodes`` defaults to :func:`padded_nodes`; the connectivity pass
    clamps surplus survivors into the last in-bucket label. ``feature_norm``
    None normalizes positions by the image size, 256 reproduces the
    reference's hard-coded /256. Under a ``row_group`` (spatial sharding)
    ``images`` is this rank's block of rows and so is ``segments``; the
    rest is the whole image's, the same on every rank.

    On the card with no ``row_group``, the four stages that make no host
    synchronisation (SLIC, Canny, region features, RAG) replay as CUDA
    graphs (``core.graphs``), captured on the first call of each key:
    the device, the images' shape and dtype and the settings. Connectivity
    runs eagerly between them. Every tensor returned is the caller's own,
    not a graph's buffer. CPU tensors and a ``row_group`` (its gathers and
    all-reduces) run every stage eagerly."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    if max_nodes is None:
        max_nodes = padded_nodes(n_segments, spatial_rows(images.shape[1], row_group)[1])
    settings = (n_segments, max_nodes, slic_iters, window_radius, feature_norm)
    if images.is_cuda and row_group is None:
        key = (images.device, tuple(images.shape), images.dtype) + settings
        return _replayed(_GRAPHS.get(key, images.device), images, settings)
    return _build_stages(images, *settings, _eager_stage, row_group)


def _replayed(g: graphs.StageGraphs, images: torch.Tensor, settings: tuple) -> RegionGraphBatch:
    """The build through one key's stage graphs, every output the caller's."""
    with g.build():
        batch = _build_stages(images, *settings, g.stage)
        return RegionGraphBatch(*(g.fresh(t) for t in batch))


def _eager_stage(span, fn, *inputs):
    with span:
        return fn(*inputs)


def _build_stages(images, n_segments, max_nodes, slic_iters, window_radius, feature_norm,
                  stage, row_group=None) -> RegionGraphBatch:
    """The build's stages in order, each but connectivity through
    ``stage(its cmt:: range, fn, *inputs)``, which runs ``fn(*inputs)``
    inside that range: eagerly, or as a CUDA graph."""
    # cmt:: ranges name the stages in a torch.profiler trace (chip_smoke.py
    # --profile, the benchmark's --trace 1). A record_function call costs
    # 9-11 us on the host of an H100 80GB HBM3 machine (PyTorch 2.11, Python
    # 3.12; a loop of empty ranges), so with no profiler running annotate
    # opens none and costs one flag test.
    raw, drift = stage(annotate("cmt::slic"), lambda im: slic(
        im, n_segments=n_segments, num_iters=slic_iters, backend="exact",
        enforce_connectivity=False, return_drift=True, window_radius=window_radius,
        row_group=row_group), images)
    with annotate("cmt::connectivity"):
        seg = enforce_label_connectivity(raw, n_segments, max_labels=max_nodes,
                                         row_group=row_group)
    edges = stage(annotate("cmt::canny"), lambda im: canny(rgb_to_gray(im), sigma=2.0,
                                                           row_group=row_group), images)

    def features(im, sg, ed):
        reg = region_features(im, sg, ed, max_nodes, norm_size=feature_norm,
                              row_group=row_group)
        return reg["features"], reg["node_mask"]

    def rag(sg, feats):
        adj = region_adjacency(sg, max_nodes, row_group=row_group)
        return adj, rag_edge_weights(feats, adj)

    feats, node_mask = stage(annotate("cmt::region_features"), features, images, seg, edges)
    adj, w = stage(annotate("cmt::rag"), rag, seg, feats)
    return RegionGraphBatch(seg, feats, adj, w, node_mask, drift)


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

    with annotate("cmt::labels"):
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
    """Images → region-graph GNN predictions, for a model on one device, or
    on every rank of a ``mesh`` (each rank's block of the batch, the outputs
    gathered whole; the batch must divide), with ``spatial=True`` also each
    rank's block of image rows over the ``model`` axis (the height must
    divide; module docstring)."""

    def __init__(self, model: RegionGraphGNN, n_segments: int = 500,
                 image_size: int = 256, max_nodes: Optional[int] = None,
                 slic_iters: int = 10, paint_mapping: str = "corrected",
                 window_radius: int = 3,
                 feature_norm: Optional[int] = None,
                 mesh=None, spatial: bool = False) -> None:
        data_group(mesh)   # TypeError for anything but a make_mesh mesh
        self.mesh = mesh
        self.spatial = spatial
        self.model = model.eval()
        self.n_segments = n_segments
        self.image_size = image_size
        self.max_nodes = max_nodes or padded_nodes(n_segments, image_size)
        self.slic_iters = slic_iters
        self.window_radius = window_radius
        self.feature_norm = feature_norm
        self.paint_mapping = paint_mapping

    def row_group(self):
        """The ``model`` group whose ranks split the image rows (None unless
        ``spatial`` and the mesh's ``model`` axis is larger than 1)."""
        return model_group(self.mesh) if self.spatial else None

    def run_sharded(self, forward, images: torch.Tensor, *args) -> Dict[str, torch.Tensor]:
        """``forward(images, *args, row_group=...)`` on this rank's share of
        ``images`` (the batch over ``data``, the rows over ``model`` when
        spatial), the per-pixel maps gathered over ``model`` and every
        output over ``data``."""
        if self.mesh is None:
            return forward(images, *args)
        group = self.row_group()
        if group is None:
            return gather_batch(forward(shard_batch(images, self.mesh), *args), self.mesh)
        out = forward(shard_spatial(images, self.mesh), *args, row_group=group)
        for key in ("heatmap", "segments"):
            out[key] = gather_dim(out[key], 1, group)
        return gather_batch(out, self.mesh)

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.run_sharded(self.forward, images)

    @torch.inference_mode()
    def forward(self, images: torch.Tensor, row_group=None) -> Dict[str, torch.Tensor]:
        """The predictions of the images this process holds (under a
        ``row_group``, its block of their rows: ``heatmap`` and ``segments``
        are its rows, the rest the whole images')."""
        return self.predict_graphs(build_region_graphs(
            images, self.n_segments, self.max_nodes, self.slic_iters, self.window_radius,
            self.feature_norm, row_group))

    @torch.inference_mode()
    def predict_graphs(self, batch: RegionGraphBatch) -> Dict[str, torch.Tensor]:
        """The GNN's predictions and the painted heatmap of a built batch
        (``window_drift`` passes through, None included)."""
        with annotate("cmt::gnn"):
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
    """Images + KG category embeddings → 4-head multimodal predictions,
    over the RG pipeline's mesh when it has one (and spatially sharded when
    it is; the fusion runs whole on every rank)."""

    def __init__(self, rg_pipeline: RegionGraphPipeline,
                 fusion_model: MultimodalCamouflageDetector) -> None:
        self.rg = rg_pipeline
        self.fusion_model = fusion_model.eval()

    def __call__(self, images: torch.Tensor, kg_tensor: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        return self.rg.run_sharded(self.forward, images, kg_tensor)

    @torch.inference_mode()
    def forward(self, images: torch.Tensor, kg_tensor: torch.Tensor,
                row_group=None) -> Dict[str, torch.Tensor]:
        """The predictions of the images this process holds (of its block
        of their rows under a ``row_group``, as ``RegionGraphPipeline.forward``)."""
        rg_out = self.rg.forward(images, row_group)
        B = images.shape[0]
        kg = kg_tensor[None].expand(B, *kg_tensor.shape)
        with annotate("cmt::fusion"):
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
