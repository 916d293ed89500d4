"""Region-graph GNN over padded superpixel graphs (inference).

Port of ``camouflage_multimodal_tpu/models/region_graph.py``: GAT (4 heads,
averaged) → 3× edge-weighted GCN, each followed by masked BatchNorm and
ReLU, a shared FC (the 128-d node-embedding hook) and mask / instance /
edge heads. Dropout is the identity at inference and is left out; the
training port will add it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from camouflage_multimodal_tpu_torch.models.layers import MaskedBatchNorm
from camouflage_multimodal_tpu_torch.ops.graph import (
    gat_layer, gcn_layer, masked_mean_pool, normalize_adjacency)


class GATConv(nn.Module):
    """Dense multi-head GAT, heads averaged (PyG ``concat=False``). The
    projection keeps the JAX layout (in, heads, out)."""

    def __init__(self, in_channels: int, out_channels: int, heads: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_channels, heads, out_channels))
        self.att_src = nn.Parameter(torch.empty(heads, out_channels))
        self.att_dst = nn.Parameter(torch.empty(heads, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        for p in (self.kernel, self.att_src, self.att_dst):
            nn.init.xavier_uniform_(p.view(p.shape[0], -1))

    def forward(self, x, adjacency, node_mask):
        return gat_layer(x, adjacency, node_mask, self.kernel, self.att_src,
                         self.att_dst, self.bias)


class GCNConv(nn.Module):
    """Dense GCN layer on a pre-normalized adjacency; bias after propagation."""

    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__()
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, adj_norm):
        return gcn_layer(x, adj_norm, self.lin.weight.T, self.bias)


class RegionGraphGNN(nn.Module):
    def __init__(self, in_channels: int = 15, hidden_channels: int = 128,
                 num_classes: int = 2, gat_heads: int = 4) -> None:
        super().__init__()
        H = hidden_channels
        self.conv1 = GATConv(in_channels, H, gat_heads)
        self.convs = nn.ModuleList([GCNConv(H, H) for _ in range(3)])
        self.bns = nn.ModuleList([MaskedBatchNorm(H) for _ in range(4)])
        self.fc_shared = nn.Linear(H, H)
        self.heads = nn.ModuleDict({
            name: nn.Sequential(nn.Linear(H, H // 2), nn.ReLU(), nn.Linear(H // 2, out))
            for name, out in (("mask", num_classes), ("instance", num_classes),
                              ("edge", 1))
        })

    def forward(self, x: torch.Tensor, adjacency: torch.Tensor,
                edge_weights: torch.Tensor, node_mask: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """x (B, K, in), adjacency (B, K, K) bool, edge_weights (B, K, K),
        node_mask (B, K) → mask_logits (B, K, 2), instance_logits (B, K, 2),
        edge_logits (B, K, 1), node_embeddings (B, K, H), graph_embedding
        (B, H)."""
        h = torch.relu(self.bns[0](self.conv1(x, adjacency, node_mask), node_mask))
        adj_norm = normalize_adjacency(edge_weights, node_mask)
        for conv, bn in zip(self.convs, self.bns[1:]):
            h = torch.relu(bn(conv(h, adj_norm), node_mask))
        node_embeddings = torch.relu(self.fc_shared(h))
        node_embeddings = torch.where(node_mask[..., None], node_embeddings, 0.0)
        out = {f"{name}_logits": head(node_embeddings)
               for name, head in self.heads.items()}
        out["node_embeddings"] = node_embeddings
        out["graph_embedding"] = masked_mean_pool(node_embeddings, node_mask)
        return out
