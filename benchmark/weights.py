"""Seeded weights and model inputs, made on the device in one draw each.

The tensors are laid out by the reference modules' ``state_dict`` (whose
names are the program's), so the same tensors load into both sides:
matrices normal with standard deviation 1/sqrt(fan-in), biases normal with
0.02, norm scales and running variances 1, running means 0.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from reference.models import FusionDetector, RegionGraphGNN


def _fan_in(name: str, shape) -> int:
    leaf = name.rsplit(".", 1)[-1]
    if leaf.startswith("att_"):
        return shape[-1]
    if leaf == "weight":                    # torch layout (out, in)
        return shape[1]
    return shape[0]                         # (in, ...) layouts: GAT kernel, attention


def seeded_state(module: torch.nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A state dict for ``module`` drawn from ``generator`` in one call."""
    entries = list(module.state_dict().items())
    total = sum(t.numel() for _, t in entries)
    flat = torch.randn(total, generator=generator, device=generator.device)
    out, at = {}, 0
    for name, t in entries:
        draw = flat[at:at + t.numel()].reshape(t.shape)
        at += t.numel()
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            out[name] = torch.zeros_like(draw)
        elif leaf == "running_var" or (t.dim() == 1 and leaf == "weight"):
            out[name] = torch.ones_like(draw)
        elif t.dim() == 1:
            out[name] = draw * 0.02
        else:
            out[name] = draw / float(_fan_in(name, t.shape)) ** 0.5
    return out


def models(cfg: Dict, generator: torch.Generator, dropout: bool = False):
    """(reference RG GNN, reference fusion detector, their seeded state
    dicts, KG matrix (categories, kg_dim)), all on the generator's device.
    The models carry the configuration's dropout rates, used in training
    mode only."""
    dev = generator.device
    g, f = cfg["rg_gnn"], cfg["fusion"]
    rg = RegionGraphGNN(g["in_channels"], g["hidden_channels"], g["num_classes"],
                        g["gat_heads"], g["dropout"], g["head_dropout"]).to(dev)
    fusion = FusionDetector(f["rg_dim"], f["kg_dim"], f["hidden_dim"], f["num_heads"],
                            f["num_classes"], f["dropout"]).to(dev)
    rg_state, fusion_state = seeded_state(rg, generator), seeded_state(fusion, generator)
    rg.load_state_dict(rg_state)
    fusion.load_state_dict(fusion_state)
    kg = torch.randn((f["kg_categories"], f["kg_dim"]), generator=generator, device=dev)
    return rg.eval(), fusion.eval(), rg_state, fusion_state, kg


def write_checkpoints(root: str, cfg: Dict, rg_state, fusion_state, kg: torch.Tensor):
    """The seeded weights as the files a deployment loads: the RG and
    fusion ``.ckpt`` files, written through the program's own converters
    and writer, and the KG embeddings ``.npz`` (one category a key, in
    sorted order). Returns (fusion path, RG path, KG path)."""
    from camouflage_multimodal_tpu_torch.convert import (
        fusion_params_from_state_dict, region_graph_params_from_state_dict)
    from camouflage_multimodal_tpu_torch.core.checkpoint import save_checkpoint

    g, f = cfg["rg_gnn"], cfg["fusion"]
    params, stats = region_graph_params_from_state_dict(rg_state)
    rg_path = os.path.join(root, "rg_model.ckpt")
    save_checkpoint(rg_path, {"params": params, "batch_stats": stats, "model_config": {
        "in_channels": g["in_channels"], "hidden_channels": g["hidden_channels"],
        "num_classes": g["num_classes"]}})
    fusion_path = os.path.join(root, "multimodal.ckpt")
    model_cfg = {k: f[k] for k in ("rg_dim", "kg_dim", "hidden_dim", "num_heads",
                                    "num_classes", "dropout", "fusion_type")}
    save_checkpoint(fusion_path, {"params": fusion_params_from_state_dict(fusion_state),
                                  "config": {"model": model_cfg}})
    kg_path = os.path.join(root, "kg_embeddings.npz")
    host = kg.cpu().numpy().astype(np.float32)
    np.savez(kg_path, **{f"category_{i:02d}": host[i][None] for i in range(len(host))})
    return fusion_path, rg_path, kg_path
