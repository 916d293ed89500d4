"""Multimodal fusion: cross-attention / late fusion + 4-head detector.

Port of ``camouflage_multimodal_tpu/models/fusion.py``:

* :class:`MultiheadAttention` (the JAX ``_MHA``) holds its weights in the
  JAX layout. With ``use_pallas`` (the JAX package's name for "use the fused
  kernel", kept so configs carry over) and either eval mode or
  ``dropout == 0`` it calls :func:`ops.attention.fused_mha`: kernel B2
  forward and, under autograd, kernel B3 backward on CUDA tensors. Else it
  runs the plain version with attention-probability dropout.
  ``use_pallas`` defaults to False as in the JAX package; models loaded for
  inference by :mod:`api` always take the kernel path;
* :class:`CrossAttentionFusion`: RG↔KG cross-attention (8 heads), residual
  LayerNorm, residual FFN, masked mean pools, 2-layer fusion MLP; returns
  the head-averaged attention maps ``{'rg2kg', 'kg2rg'}``. 2-D inputs get a
  token axis and 4-D ones are collapsed, as in the JAX module;
* :class:`LateFusion`: masked mean pools, concat, 3-layer MLP;
* :class:`MultimodalCamouflageDetector`: fusion + mask / instance / edge
  heads and a sigmoid score head;
* :func:`build_multimodal_model`: the config factory with the same keys.

LayerNorm uses ε = 1e-6, flax's default (torch's is 1e-5). Dropout draws
from the ``torch.Generator`` given to
:meth:`MultimodalCamouflageDetector.set_generator` (the global generator
when none was given) and is the identity in eval mode.

Under tensor parallelism (:func:`parallel.sharding.shard_fusion_params`)
each :class:`MultiheadAttention` holds its rank's heads and each
:class:`FFN` its rank's hidden columns: the input enters through
``copy_to_model``, the partial outputs and head-summed probabilities leave
through ``reduce_from_model``, and ``bo`` and ``fc2``'s bias are added once
after that. The kernels then run on the rank's heads (or raise: there is no
plain fallback for CUDA tensors); dropout on the sharded activations draws
for the whole activation and keeps the rank's block. Everything else is
replicated and computes the same bits on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from camouflage_multimodal_tpu_torch.core.checkpoint import scalar
from camouflage_multimodal_tpu_torch.models.layers import Dropout, glorot_, lecun_
from camouflage_multimodal_tpu_torch.ops.attention import (
    PARAM_NAMES, fused_mha, multihead_attention)
from camouflage_multimodal_tpu_torch.ops.graph import masked_mean_pool
from camouflage_multimodal_tpu_torch.parallel.sharding import (
    block_of, copy_to_model, reduce_from_model)

LAYER_NORM_EPS = 1e-6


class ModelShard:
    """A module whose parameters named in ``SHARD_DIMS`` (local name → the
    axis split over a ``model`` group; the others are replicated) can be
    cut into shares by :func:`parallel.sharding.shard_fusion_params`.
    ``shards`` is how many shares its weights are cut into (1: whole),
    ``model_group`` the group it computes its share over."""

    SHARD_DIMS: Dict[str, int] = {}
    shards = 1
    model_group = None

    def set_model_group(self, group, shards: Optional[int] = None) -> None:
        """Compute over ``group`` (None: no group); ``shards``, when given,
        is how many shares the weights are now cut into."""
        self.model_group = group
        if shards is not None:
            self.shards = shards

    def share_group(self):
        """The group to compute over (None: whole). Raises ``RuntimeError``
        for weights cut into shares with no group to sum them over, which a
        sharded fit that ended early leaves behind: computing a share as if
        it were whole would give another function, silently."""
        if self.shards != 1 and self.model_group is None:
            raise RuntimeError(
                f"{type(self).__name__} holds 1/{self.shards} of its weights and no model "
                "group: a sharded fit ended before it gathered them; load the weights again")
        return self.model_group


class MultiheadAttention(ModelShard, nn.Module):
    # Rank r of m keeps heads [r·H/m, (r+1)·H/m): the columns of wq, wk, wv
    # and their biases, the rows of wo; bo stays whole, added after the sum.
    SHARD_DIMS = {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0, "wo": 0}

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 use_pallas: bool = False) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.dropout = float(dropout)
        self.use_pallas = use_pallas
        self.generator: Optional[torch.Generator] = None
        self.data_group = None
        for name in PARAM_NAMES:
            shape = (embed_dim, embed_dim) if name.startswith("w") else (embed_dim,)
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Xavier-uniform weights, zero biases (flax ``glorot_uniform``)."""
        for name in PARAM_NAMES:
            p = getattr(self, name)
            if name.startswith("w"):
                glorot_(p, p.shape[0], p.shape[1], generator)
            else:
                with torch.no_grad():
                    p.zero_()

    def forward(self, q, k, v, key_mask=None):
        params = {name: getattr(self, name) for name in PARAM_NAMES}
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        group, heads, total = self.share_group(), self.num_heads, None
        if group is not None:
            same = v is k
            q, k = copy_to_model(q, group), copy_to_model(k, group)
            v = k if same else copy_to_model(v, group)
            part = block_of(heads, group)
            heads, total = part.stop - part.start, self.num_heads
            params["bo"] = None
        if self.use_pallas and (not self.training or self.dropout == 0.0):
            out, probs = fused_mha(params, q, k, v, heads, key_mask, total_heads=total)
        else:
            rate = self.dropout if self.training else 0.0
            out, probs = multihead_attention(params, q, k, v, heads, key_mask,
                                             dropout_rate=rate, generator=self.generator,
                                             data_group=self.data_group, total_heads=total,
                                             head_group=group)
        if group is None:
            return out, probs
        return reduce_from_model(out, group) + self.bo, reduce_from_model(probs, group)


class FFN(ModelShard, nn.Module):
    # Rank r keeps its block of the hidden columns: fc1's output features
    # (torch's (out, in) weight by rows, and its bias), fc2's input features
    # (weight columns); fc2's bias stays whole, added after the sum.
    SHARD_DIMS = {"fc1.weight": 0, "fc1.bias": 0, "fc2.weight": 1}

    def __init__(self, hidden_dim: int, dropout: float = 0.0) -> None:
        super().__init__()
        self.fc1 = nn.Linear(hidden_dim, hidden_dim * 2)
        self.drop = Dropout(dropout)
        self.fc2 = nn.Linear(hidden_dim * 2, hidden_dim)

    def set_model_group(self, group, shards: Optional[int] = None) -> None:
        super().set_model_group(group, shards)
        self.drop.model_group = group

    def forward(self, x):
        group = self.share_group()
        if group is None:
            return self.fc2(self.drop(torch.relu(self.fc1(x))))
        h = self.drop(torch.relu(self.fc1(copy_to_model(x, group))))
        return reduce_from_model(torch.nn.functional.linear(h, self.fc2.weight),
                                 group) + self.fc2.bias


def collapse_to_3d(t: torch.Tensor) -> torch.Tensor:
    """2-D → add a token axis; 4-D → squeeze a singleton axis or merge the
    two middle ones (the reference's shim, JAX ``models/fusion.py:108-120``)."""
    if t.ndim == 2:
        return t[:, None, :]
    if t.ndim == 4:
        b, a, c, d = t.shape
        if a == 1:
            return t[:, 0]
        if c == 1:
            return t[:, :, 0]
        return t.reshape(b, a * c, d)
    return t


class CrossAttentionFusion(nn.Module):
    def __init__(self, rg_dim: int = 128, kg_dim: int = 128,
                 hidden_dim: int = 256, num_heads: int = 8,
                 dropout: float = 0.3, use_pallas: bool = False) -> None:
        super().__init__()
        self.rg_proj = nn.Linear(rg_dim, hidden_dim) if rg_dim != hidden_dim else nn.Identity()
        self.kg_proj = nn.Linear(kg_dim, hidden_dim) if kg_dim != hidden_dim else nn.Identity()
        self.cross_attn_rg2kg = MultiheadAttention(hidden_dim, num_heads, dropout, use_pallas)
        self.cross_attn_kg2rg = MultiheadAttention(hidden_dim, num_heads, dropout, use_pallas)
        self.ln_rg = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.ln_kg = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.ffn_rg = FFN(hidden_dim, dropout)
        self.ffn_kg = FFN(hidden_dim, dropout)
        self.fusion_1 = nn.Linear(2 * hidden_dim, hidden_dim)
        self.drop = Dropout(dropout)
        self.fusion_2 = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, rg, kg, rg_mask=None, kg_mask=None):
        """rg (B, Nrg, rg_dim), kg (B, Nkg, kg_dim) (2-D and 4-D inputs are
        collapsed to 3-D), masks (B, N) bool (default all valid) →
        (fused (B, hidden), {'rg2kg', 'kg2rg'})."""
        rg = collapse_to_3d(rg)
        kg = collapse_to_3d(kg)
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
        fused = self.fusion_2(self.drop(torch.relu(self.fusion_1(combined))))
        return fused, {"rg2kg": w_rg2kg, "kg2rg": w_kg2rg}


class LateFusion(nn.Module):
    """Mean-pool both streams, concat, 3-layer MLP → (B, hidden // 2); no
    attention maps."""

    def __init__(self, rg_dim: int = 128, kg_dim: int = 128,
                 hidden_dim: int = 256, dropout: float = 0.3) -> None:
        super().__init__()
        self.fc1 = nn.Linear(rg_dim + kg_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.fc3 = nn.Linear(hidden_dim // 2, hidden_dim // 2)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    @staticmethod
    def _pool(x, mask):
        if x.ndim != 3:
            return x
        if mask is None:
            mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        return masked_mean_pool(x, mask)

    def forward(self, rg, kg, rg_mask=None, kg_mask=None):
        x = torch.cat([self._pool(rg, rg_mask), self._pool(kg, kg_mask)], dim=-1)
        x = self.drop1(torch.relu(self.fc1(x)))
        x = self.drop2(torch.relu(self.fc2(x)))
        return self.fc3(x), None


class Head(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.0) -> None:
        super().__init__()
        self.fc1 = nn.Linear(in_dim, in_dim // 2)
        self.drop = Dropout(dropout)
        self.fc2 = nn.Linear(in_dim // 2, out_dim)

    def forward(self, x):
        return self.fc2(self.drop(torch.relu(self.fc1(x))))


class MultimodalCamouflageDetector(nn.Module):
    def __init__(self, rg_dim: int = 128, kg_dim: int = 128, hidden_dim: int = 256,
                 num_heads: int = 8, fusion_type: str = "cross_attention",
                 num_classes: int = 2, dropout: float = 0.3,
                 use_pallas: bool = False) -> None:
        super().__init__()
        if fusion_type == "cross_attention":
            self.fusion = CrossAttentionFusion(rg_dim, kg_dim, hidden_dim, num_heads,
                                               dropout, use_pallas)
            final_dim = hidden_dim
        elif fusion_type == "late":
            self.fusion = LateFusion(rg_dim, kg_dim, hidden_dim, dropout)
            final_dim = hidden_dim // 2
        else:
            raise ValueError(f"Unknown fusion_type: {fusion_type}")
        self.mask_head = Head(final_dim, num_classes, dropout)
        self.instance_head = Head(final_dim, num_classes, dropout)
        self.edge_head = Head(final_dim, 1, dropout)
        self.score_head = Head(final_dim, 1, dropout)

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Every dropout of the model draws from ``generator`` from now on."""
        for m in self.modules():
            if isinstance(m, (Dropout, MultiheadAttention)):
                m.generator = generator

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter from ``generator`` with the JAX modules'
        initialisers: LeCun-normal ``Linear`` weights (flax ``Dense``), zero
        biases, Xavier-uniform attention weights, unit LayerNorm."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_(m, generator)
            elif isinstance(m, MultiheadAttention):
                m.reset_parameters(generator)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()

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
    (``fusion_model.py:249-259``) plus the JAX package's ``use_pallas``."""
    get = lambda key, default: scalar(config.get(key, default))  # noqa: E731
    return MultimodalCamouflageDetector(
        rg_dim=int(get("rg_dim", 128)),
        kg_dim=int(get("kg_dim", 128)),
        hidden_dim=int(get("hidden_dim", 256)),
        num_heads=int(get("num_heads", 8)),
        fusion_type=str(get("fusion_type", "cross_attention")),
        num_classes=int(get("num_classes", 2)),
        dropout=float(get("dropout", 0.3)),
        use_pallas=bool(get("use_pallas", False)),
    )
