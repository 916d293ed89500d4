"""Multimodal fusion: bidirectional cross-attention + 4-head detector
(inference).

Port of ``camouflage_multimodal_tpu/models/fusion.py``:

* :class:`MultiheadAttention` (the JAX ``_MHA``) holds its weights in the
  JAX layout and always calls :func:`ops.attention.fused_mha`, so on a CUDA
  tensor every attention runs through kernel B2;
* :class:`CrossAttentionFusion`: RG↔KG cross-attention (8 heads), residual
  LayerNorm, residual FFN, masked mean pools, 2-layer fusion MLP; returns
  the head-averaged attention maps ``{'rg2kg', 'kg2rg'}``;
* :class:`MultimodalCamouflageDetector`: fusion + mask / instance / edge
  heads and a sigmoid score head;
* :func:`build_multimodal_model`: the config factory with the same keys.

LayerNorm uses ε = 1e-6, flax's default (torch's is 1e-5). Dropout is the
identity at inference and is left out. Late fusion is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from camouflage_multimodal_tpu_torch.core.checkpoint import scalar
from camouflage_multimodal_tpu_torch.ops.attention import PARAM_NAMES, fused_mha
from camouflage_multimodal_tpu_torch.ops.graph import masked_mean_pool

LAYER_NORM_EPS = 1e-6


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        for name in PARAM_NAMES:
            shape = (embed_dim, embed_dim) if name.startswith("w") else (embed_dim,)
            p = nn.Parameter(torch.zeros(shape))
            if name.startswith("w"):
                nn.init.xavier_uniform_(p)
            self.register_parameter(name, p)

    def forward(self, q, k, v, key_mask=None):
        params = {name: getattr(self, name) for name in PARAM_NAMES}
        return fused_mha(params, q.contiguous(), k.contiguous(), v.contiguous(),
                         self.num_heads, key_mask)


class FFN(nn.Module):
    def __init__(self, hidden_dim: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(hidden_dim, hidden_dim * 2)
        self.fc2 = nn.Linear(hidden_dim * 2, hidden_dim)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class CrossAttentionFusion(nn.Module):
    def __init__(self, rg_dim: int = 128, kg_dim: int = 128,
                 hidden_dim: int = 256, num_heads: int = 8) -> None:
        super().__init__()
        self.rg_proj = nn.Linear(rg_dim, hidden_dim) if rg_dim != hidden_dim else nn.Identity()
        self.kg_proj = nn.Linear(kg_dim, hidden_dim) if kg_dim != hidden_dim else nn.Identity()
        self.cross_attn_rg2kg = MultiheadAttention(hidden_dim, num_heads)
        self.cross_attn_kg2rg = MultiheadAttention(hidden_dim, num_heads)
        self.ln_rg = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.ln_kg = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.ffn_rg = FFN(hidden_dim)
        self.ffn_kg = FFN(hidden_dim)
        self.fusion_1 = nn.Linear(2 * hidden_dim, hidden_dim)
        self.fusion_2 = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, rg, kg, rg_mask=None, kg_mask=None):
        """rg (B, Nrg, rg_dim), kg (B, Nkg, kg_dim), masks (B, N) bool
        (default all valid) → (fused (B, hidden), {'rg2kg', 'kg2rg'})."""
        B, Nrg, _ = rg.shape
        Nkg = kg.shape[1]
        if rg_mask is None:
            rg_mask = torch.ones(B, Nrg, dtype=torch.bool, device=rg.device)
        if kg_mask is None:
            kg_mask = torch.ones(B, Nkg, dtype=torch.bool, device=kg.device)
        rg_p = self.rg_proj(rg)
        kg_p = self.kg_proj(kg)

        rg_att, w_rg2kg = self.cross_attn_rg2kg(rg_p, kg_p, kg_p, kg_mask)
        rg_att = self.ln_rg(rg_p + rg_att)
        rg_att = rg_att + self.ffn_rg(rg_att)

        kg_att, w_kg2rg = self.cross_attn_kg2rg(kg_p, rg_p, rg_p, rg_mask)
        kg_att = self.ln_kg(kg_p + kg_att)
        kg_att = kg_att + self.ffn_kg(kg_att)

        combined = torch.cat([masked_mean_pool(rg_att, rg_mask),
                              masked_mean_pool(kg_att, kg_mask)], dim=-1)
        fused = self.fusion_2(torch.relu(self.fusion_1(combined)))
        return fused, {"rg2kg": w_rg2kg, "kg2rg": w_kg2rg}


def _head(in_dim: int, out_dim: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(in_dim, in_dim // 2), nn.ReLU(),
                         nn.Linear(in_dim // 2, out_dim))


class MultimodalCamouflageDetector(nn.Module):
    def __init__(self, rg_dim: int = 128, kg_dim: int = 128, hidden_dim: int = 256,
                 num_heads: int = 8, fusion_type: str = "cross_attention",
                 num_classes: int = 2) -> None:
        super().__init__()
        if fusion_type != "cross_attention":
            raise NotImplementedError(
                f"fusion_type={fusion_type!r} is not ported yet "
                "(only 'cross_attention')")
        self.fusion = CrossAttentionFusion(rg_dim, kg_dim, hidden_dim, num_heads)
        self.mask_head = _head(hidden_dim, num_classes)
        self.instance_head = _head(hidden_dim, num_classes)
        self.edge_head = _head(hidden_dim, 1)
        self.score_head = _head(hidden_dim, 1)

    def forward(self, rg, kg, rg_mask=None, kg_mask=None,
                return_attention: bool = False) -> Dict[str, Any]:
        fused, attn = self.fusion(rg, kg, rg_mask, kg_mask)
        out = {
            "mask_logits": self.mask_head(fused),
            "instance_logits": self.instance_head(fused),
            "edge_logits": self.edge_head(fused),
            "score": torch.sigmoid(self.score_head(fused)),
        }
        if return_attention:
            out["attention"] = attn
        return out


def build_multimodal_model(config: Dict[str, Any]) -> MultimodalCamouflageDetector:
    """Factory with the reference's config keys and defaults
    (``fusion_model.py:249-259``); ``dropout`` is read by training only."""
    get = lambda key, default: scalar(config.get(key, default))  # noqa: E731
    return MultimodalCamouflageDetector(
        rg_dim=int(get("rg_dim", 128)),
        kg_dim=int(get("kg_dim", 128)),
        hidden_dim=int(get("hidden_dim", 256)),
        num_heads=int(get("num_heads", 8)),
        fusion_type=str(get("fusion_type", "cross_attention")),
        num_classes=int(get("num_classes", 2)),
    )
