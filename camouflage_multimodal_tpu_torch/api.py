"""Public inference API: load the models, predict from images.

Port of the inference part of ``camouflage_multimodal_tpu/api.py``
(``load_rg_model``, ``load_multimodal_model``, ``MultimodalPredictor``),
and ``load_kg_model`` for the knowledge-graph GNN's checkpoint (the JAX
package reads it inline in its ``extract-kg`` command).
Checkpoints are this repo's ``.ckpt`` files; the reference's ``.pth`` route
is not ported yet. Everything runs on ``device`` — ``"cuda"`` by default,
which raises when no card is visible; ``"cpu"`` runs the plain versions.
Results come back as numpy arrays, as from the JAX API.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.convert import (
    fusion_state_dict, knowledge_graph_state_dict, region_graph_state_dict)
from camouflage_multimodal_tpu_torch.core.checkpoint import load_checkpoint, scalar
from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.data import (
    build_ordered_kg_tensor, load_image_rgb, load_kg_embeddings)
from camouflage_multimodal_tpu_torch.models.fusion import (
    MultimodalCamouflageDetector, build_multimodal_model)
from camouflage_multimodal_tpu_torch.models.knowledge_graph import KnowledgeGraphGNN
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN
from camouflage_multimodal_tpu_torch.pipeline import MultimodalPipeline, RegionGraphPipeline


def _require_ckpt(path: str) -> None:
    if os.path.splitext(path)[1].lower() in (".pth", ".pt"):
        raise NotImplementedError(
            f"{path}: reference .pth checkpoints are not supported by the port "
            "yet; convert them to .ckpt with the JAX package first")


def load_rg_model(checkpoint_path: str, device: str | torch.device = "cuda"
                  ) -> RegionGraphGNN:
    """``RegionGraphGNN`` with a ``.ckpt``'s weights, in eval mode on ``device``."""
    _require_ckpt(checkpoint_path)
    dev = resolve_device(device)
    ckpt = load_checkpoint(checkpoint_path)
    cfg = ckpt.get("model_config", {})
    model = RegionGraphGNN(
        in_channels=int(scalar(cfg.get("in_channels", 15))),
        hidden_channels=int(scalar(cfg.get("hidden_channels", 128))),
        num_classes=int(scalar(cfg.get("num_classes", 2))),
    )
    model.load_state_dict(region_graph_state_dict(ckpt["params"], ckpt["batch_stats"]))
    return model.to(dev).eval()


def load_kg_model(checkpoint_path: str, device: str | torch.device = "cuda"
                  ) -> KnowledgeGraphGNN:
    """``KnowledgeGraphGNN`` with a ``.ckpt``'s weights (the layout
    ``KGTrainer`` writes in both packages), in eval mode on ``device``."""
    _require_ckpt(checkpoint_path)
    dev = resolve_device(device)
    ckpt = load_checkpoint(checkpoint_path)
    model = KnowledgeGraphGNN(embedding_dim=int(scalar(ckpt.get("embedding_dim", 128))))
    model.load_state_dict(knowledge_graph_state_dict(ckpt["params"], ckpt["batch_stats"]))
    return model.to(dev).eval()


def load_multimodal_model(checkpoint_path: str, device: str | torch.device = "cuda"
                          ) -> Tuple[MultimodalCamouflageDetector, Dict[str, Any]]:
    """(fusion model in eval mode on ``device``, training config) from a
    ``.ckpt`` whose config travels inside. Whatever ``use_pallas`` the model
    was trained with, inference runs its attention through the fused kernel."""
    _require_ckpt(checkpoint_path)
    dev = resolve_device(device)
    ckpt = load_checkpoint(checkpoint_path)
    config = ckpt.get("config", {})
    model = build_multimodal_model({**config.get("model", config), "use_pallas": True})
    model.load_state_dict(fusion_state_dict(ckpt["params"]))
    return model.to(dev).eval(), config


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x.cpu().numpy()


class MultimodalPredictor:
    """RG pipeline + fusion model + KG tensor bundled for repeated calls."""

    def __init__(self, fusion_checkpoint: str, rg_checkpoint: str,
                 kg_embeddings_path: str, n_segments: int = 500,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        rg_model = load_rg_model(rg_checkpoint, self.device)
        self.fusion_model, self.config = load_multimodal_model(fusion_checkpoint,
                                                               self.device)
        self.rg_pipeline = RegionGraphPipeline(rg_model, n_segments=n_segments)
        self.pipeline = MultimodalPipeline(self.rg_pipeline, self.fusion_model)
        kg, self.kg_ordered = build_ordered_kg_tensor(
            load_kg_embeddings(kg_embeddings_path))
        self.kg_tensor = torch.from_numpy(kg).to(self.device)

    def predict_batch(self, images: np.ndarray) -> Dict[str, Any]:
        """(B, H, W, 3) uint8 — or float in [0, 1] — images → numpy outputs."""
        if images.dtype != np.uint8:
            images = (np.asarray(images) * 255.0).round().astype(np.uint8)
        batch = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        return _to_numpy(self.pipeline(batch, self.kg_tensor))

    def predict_single_image(self, image_path: str):
        """(predictions, attention, kg_ordered) like the reference's
        ``test_multimodal.predict_single_image``."""
        image = load_image_rgb(image_path, self.rg_pipeline.image_size)
        out = self.predict_batch(image[None])
        node_mask = out["node_mask"][0]
        attn = {
            "rg2kg": out["attention"]["rg2kg"][0][node_mask],
            "kg2rg": out["attention"]["kg2rg"][0][:, node_mask],
        }
        predictions = {
            "mask_logits": out["mask_logits"][0],
            "mask_prob": out["mask_prob"][0],
            "mask_pred": int(np.argmax(out["mask_logits"][0])),
            "instance_prob": out["instance_prob"][0],
            "instance_pred": int(np.argmax(out["instance_logits"][0])),
            "edge_prob": float(out["edge_prob"][0, 0]),
            "score": float(out["score"][0, 0]),
            "segments": out["segments"][0],
            "heatmap": out["heatmap"][0],
        }
        return predictions, attn, self.kg_ordered
