"""Plain PyTorch reference of the two models: the region-graph GNN (GAT
then three GCN layers, masked BatchNorm, shared FC, three heads) and the
cross-attention fusion detector (RG ↔ KG attention, LayerNorm, FFN, masked
pools, fusion MLP, four heads).

A frozen copy of the single-device plain paths of
``camouflage_multimodal_tpu_torch/models/`` and ``ops/graph.py`` /
``ops/attention.py`` (attention written out, no kernel), with the parameter
names of the program's ``state_dict`` so that one set of seeded tensors
loads into both. Dropout draws ``torch.rand`` from the generator handed to
:func:`set_generator`, in forward order, as the program's modules do, so a
training step here sees the masks the program's step saw.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

_NEG_INF = -1e30
LAYER_NORM_EPS = 1e-6
MHA_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")


# ---------------------------------------------------------------------------
# Graph primitives
# ---------------------------------------------------------------------------

def normalize_adjacency(adj, node_mask):
    K = adj.shape[-1]
    eye = torch.eye(K, dtype=adj.dtype, device=adj.device)
    m = node_mask.to(adj.dtype)
    a = adj + eye * m[..., None, :] * m[..., :, None]
    deg = torch.sum(a, dim=-1)
    dinv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)), 0.0)
    return a * dinv[..., :, None] * dinv[..., None, :]


def gat_layer(x, adj, node_mask, kernel, att_src, att_dst, bias):
    K = x.shape[-2]
    h = torch.einsum("bkc,chd->bkhd", x, kernel)
    a_src = torch.einsum("bkhd,hd->bkh", h, att_src)
    a_dst = torch.einsum("bkhd,hd->bkh", h, att_dst)
    logits = F.leaky_relu(a_dst[:, :, None, :] + a_src[:, None, :, :], 0.2)
    eye = torch.eye(K, dtype=torch.bool, device=x.device)
    allow = (adj | eye) & node_mask[:, None, :] & node_mask[:, :, None]
    logits = torch.where(allow[..., None], logits, _NEG_INF)
    alpha = torch.where(allow[..., None], torch.softmax(logits, dim=-2), 0.0)
    out = torch.einsum("bijh,bjhd->bihd", alpha, h).mean(dim=-2) + bias
    return torch.where(node_mask[..., None], out, 0.0)


def masked_mean_pool(x, node_mask):
    m = node_mask.to(x.dtype)
    return torch.sum(x * m[..., None], dim=-2) / torch.clamp(torch.sum(m, -1, keepdim=True), min=1.0)


class Dropout(nn.Module):
    def __init__(self, p: float) -> None:
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5) -> None:
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, mask):
        if self.training:
            m = mask.to(x.dtype)[..., None]
            dims = tuple(range(x.ndim - 1))
            n = torch.clamp(torch.sum(m), min=1.0)
            mean = torch.sum(x * m, dim=dims) / n
            var = torch.sum((x - mean) ** 2 * m, dim=dims) / n
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.copy_((1 - self.momentum) * self.running_mean + self.momentum * mean)
                self.running_var.copy_((1 - self.momentum) * self.running_var + self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[..., None], y, 0.0)


class GCNConv(nn.Module):
    def __init__(self, cin: int, cout: int) -> None:
        super().__init__()
        self.lin = nn.Linear(cin, cout, bias=False)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, adj_norm):
        return adj_norm @ (x @ self.lin.weight.T) + self.bias


class GATConv(nn.Module):
    def __init__(self, cin: int, cout: int, heads: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, heads, cout))
        self.att_src = nn.Parameter(torch.zeros(heads, cout))
        self.att_dst = nn.Parameter(torch.zeros(heads, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, adjacency, node_mask):
        return gat_layer(x, adjacency, node_mask, self.kernel, self.att_src, self.att_dst,
                         self.bias)


class RegionGraphGNN(nn.Module):
    def __init__(self, in_channels: int = 15, hidden_channels: int = 128,
                 num_classes: int = 2, gat_heads: int = 4, dropout: float = 0.3,
                 head_dropout: float = 0.2) -> None:
        super().__init__()
        H = hidden_channels
        self.conv1 = GATConv(in_channels, H, gat_heads)
        self.convs = nn.ModuleList([GCNConv(H, H) for _ in range(3)])
        self.bns = nn.ModuleList([MaskedBatchNorm(H) for _ in range(4)])
        self.drop = Dropout(dropout)
        self.head_drop = Dropout(head_dropout)
        self.fc_shared = nn.Linear(H, H)
        self.heads = nn.ModuleDict({
            name: nn.Sequential(nn.Linear(H, H // 2), nn.ReLU(), nn.Linear(H // 2, out))
            for name, out in (("mask", num_classes), ("instance", num_classes), ("edge", 1))})

    def forward(self, x, adjacency, edge_weights, node_mask) -> Dict[str, torch.Tensor]:
        h = self.drop(torch.relu(self.bns[0](self.conv1(x, adjacency, node_mask), node_mask)))
        adj_norm = normalize_adjacency(edge_weights, node_mask)
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns[1:])):
            h = torch.relu(bn(conv(h, adj_norm), node_mask))
            if i < 2:
                h = self.drop(h)
        emb = torch.where(node_mask[..., None], torch.relu(self.fc_shared(h)), 0.0)
        shared = self.head_drop(emb)
        out = {f"{name}_logits": head[2](self.head_drop(head[1](head[0](shared))))
               for name, head in self.heads.items()}
        out["node_embeddings"] = emb
        return out


# ---------------------------------------------------------------------------
# Fusion
# ---------------------------------------------------------------------------

class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float) -> None:
        super().__init__()
        self.num_heads, self.dropout = num_heads, float(dropout)
        self.generator: Optional[torch.Generator] = None
        for name in MHA_NAMES:
            shape = (embed_dim, embed_dim) if name.startswith("w") else (embed_dim,)
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def forward(self, query, key, value, key_mask):
        B, Nq, E = query.shape
        Hh, hd = self.num_heads, E // self.num_heads
        scale = (1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))).item()

        def split(x):
            return x.reshape(B, x.shape[1], Hh, hd).transpose(1, 2)

        q = split(query @ self.wq + self.bq) * scale
        k = split(key @ self.wk + self.bk)
        v = split(value @ self.wv + self.bv)
        logits = torch.where(key_mask[:, None, None, :], q @ k.transpose(-1, -2), _NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        attn = probs
        if self.training and self.dropout > 0.0:
            keep = torch.rand(probs.shape, generator=self.generator, device=probs.device) \
                < 1.0 - self.dropout
            attn = torch.where(keep, probs / (1.0 - self.dropout), 0.0)
        ctx = (attn @ v).transpose(1, 2).reshape(B, Nq, E)
        return ctx @ self.wo + self.bo, probs.mean(dim=1)


class FFN(nn.Module):
    def __init__(self, hidden: int, dropout: float) -> None:
        super().__init__()
        self.fc1 = nn.Linear(hidden, hidden * 2)
        self.drop = Dropout(dropout)
        self.fc2 = nn.Linear(hidden * 2, hidden)

    def forward(self, x):
        return self.fc2(self.drop(torch.relu(self.fc1(x))))


class CrossAttentionFusion(nn.Module):
    def __init__(self, rg_dim: int, kg_dim: int, hidden: int, heads: int, dropout: float) -> None:
        super().__init__()
        self.rg_proj = nn.Linear(rg_dim, hidden) if rg_dim != hidden else nn.Identity()
        self.kg_proj = nn.Linear(kg_dim, hidden) if kg_dim != hidden else nn.Identity()
        self.cross_attn_rg2kg = MultiheadAttention(hidden, heads, dropout)
        self.cross_attn_kg2rg = MultiheadAttention(hidden, heads, dropout)
        self.ln_rg = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)
        self.ln_kg = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)
        self.ffn_rg = FFN(hidden, dropout)
        self.ffn_kg = FFN(hidden, dropout)
        self.fusion_1 = nn.Linear(2 * hidden, hidden)
        self.drop = Dropout(dropout)
        self.fusion_2 = nn.Linear(hidden, hidden)

    def forward(self, rg, kg, rg_mask, kg_mask):
        rg_p, kg_p = self.rg_proj(rg), self.kg_proj(kg)
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


class Head(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dropout: float) -> None:
        super().__init__()
        self.fc1 = nn.Linear(in_dim, in_dim // 2)
        self.drop = Dropout(dropout)
        self.fc2 = nn.Linear(in_dim // 2, out_dim)

    def forward(self, x):
        return self.fc2(self.drop(torch.relu(self.fc1(x))))


class FusionDetector(nn.Module):
    """The cross-attention ``MultimodalCamouflageDetector``."""

    def __init__(self, rg_dim: int = 128, kg_dim: int = 128, hidden_dim: int = 256,
                 num_heads: int = 8, num_classes: int = 2, dropout: float = 0.3) -> None:
        super().__init__()
        self.fusion = CrossAttentionFusion(rg_dim, kg_dim, hidden_dim, num_heads, dropout)
        self.mask_head = Head(hidden_dim, num_classes, dropout)
        self.instance_head = Head(hidden_dim, num_classes, dropout)
        self.edge_head = Head(hidden_dim, 1, dropout)
        self.score_head = Head(hidden_dim, 1, dropout)

    def forward(self, rg, kg, rg_mask, kg_mask=None) -> Dict[str, torch.Tensor]:
        if kg_mask is None:
            kg_mask = torch.ones(kg.shape[:2], dtype=torch.bool, device=kg.device)
        fused, attn = self.fusion(rg, kg, rg_mask, kg_mask)
        return {"mask_logits": self.mask_head(fused),
                "instance_logits": self.instance_head(fused),
                "edge_logits": self.edge_head(fused),
                "score": torch.sigmoid(self.score_head(fused)),
                "attention": attn}


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    for m in model.modules():
        if isinstance(m, (Dropout, MultiheadAttention)):
            m.generator = generator


def paint(values: torch.Tensor, segments: torch.Tensor) -> torch.Tensor:
    """Per-segment values (B, K) → per-pixel maps (B, H, W)."""
    B = segments.shape[0]
    return torch.gather(values, 1, segments.reshape(B, -1).long()).reshape(segments.shape)
