"""The plain reference of inference: image → region graph → GNN →
heatmap → fusion, on images of one batch at a time."""

from __future__ import annotations

from typing import Dict

import torch

from reference.models import paint
from reference.ops import build_graphs


@torch.no_grad()
def predict(images_u8: torch.Tensor, rg_model, fusion_model, kg: torch.Tensor,
            n_segments: int, max_nodes: int, slic_iters: int = 10) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) uint8 on the device → the outputs a user keeps."""
    g = build_graphs(images_u8, n_segments, max_nodes, slic_iters)
    out = rg_model(g["features"], g["adjacency"], g["edge_weights"], g["node_mask"])
    probs = torch.where(g["node_mask"], torch.softmax(out["mask_logits"], -1)[..., 1], 0.0)
    B = images_u8.shape[0]
    fo = fusion_model(out["node_embeddings"], kg[None].expand(B, *kg.shape), g["node_mask"])
    return {"segments": g["segments"], "node_mask": g["node_mask"],
            "heatmap": paint(probs, g["segments"]),
            "node_embeddings": out["node_embeddings"],
            "mask_logits": fo["mask_logits"], "instance_logits": fo["instance_logits"],
            "mask_prob": torch.softmax(fo["mask_logits"], -1),
            "instance_prob": torch.softmax(fo["instance_logits"], -1),
            "edge_prob": torch.sigmoid(fo["edge_logits"]), "score": fo["score"],
            "rg2kg": fo["attention"]["rg2kg"], "kg2rg": fo["attention"]["kg2rg"]}
