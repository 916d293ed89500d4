"""Region-graph GNN over padded superpixel graphs.

Port of ``camouflage_multimodal_tpu/models/region_graph.py``: GAT (4 heads,
averaged) → 3× edge-weighted GCN, each followed by masked BatchNorm and
ReLU, with dropout (``dropout``, 0.3) after the first three; a shared FC
(the 128-d node-embedding hook, taken before dropout) and mask / instance /
edge heads, with ``head_dropout`` (0.2) on the shared embedding and inside
each head. Dropout draws from the generator given to
:meth:`RegionGraphGNN.set_generator` and is the identity in eval mode.

The heads stay ``nn.Sequential(Linear, ReLU, Linear)``: their keys
``heads.{name}.0`` / ``.2`` are what ``convert.py`` writes, so the head
dropout is applied in ``forward`` and not as a module inside them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from camouflage_multimodal_tpu_torch.models.layers import (
    Dropout, GCNConv, MaskedBatchNorm, glorot_, lecun_, set_dropout_generator)
from camouflage_multimodal_tpu_torch.ops.graph import (
    gat_layer, masked_mean_pool, normalize_adjacency)


class GATConv(nn.Module):
    """Dense multi-head GAT, heads averaged (PyG ``concat=False``). The
    projection keeps the JAX layout (in, heads, out)."""

    def __init__(self, in_channels: int, out_channels: int, heads: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_channels, heads, out_channels))
        self.att_src = nn.Parameter(torch.empty(heads, out_channels))
        self.att_dst = nn.Parameter(torch.empty(heads, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for p in (self.kernel, self.att_src, self.att_dst):
            fan_in, fan_out = p.shape[0], p[0].numel()
            glorot_(p, fan_in, fan_out, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, adjacency, node_mask):
        return gat_layer(x, adjacency, node_mask, self.kernel, self.att_src,
                         self.att_dst, self.bias)


class RegionGraphGNN(nn.Module):
    def __init__(self, in_channels: int = 15, hidden_channels: int = 128,
                 num_classes: int = 2, gat_heads: int = 4, dropout: float = 0.3,
                 head_dropout: float = 0.2) -> None:
        super().__init__()
        H = hidden_channels
        self.in_channels = in_channels
        self.hidden_channels = hidden_channels
        self.num_classes = num_classes
        self.conv1 = GATConv(in_channels, H, gat_heads)
        self.convs = nn.ModuleList([GCNConv(H, H) for _ in range(3)])
        self.bns = nn.ModuleList([MaskedBatchNorm(H) for _ in range(4)])
        self.drop = Dropout(dropout)
        self.head_drop = Dropout(head_dropout)
        self.fc_shared = nn.Linear(H, H)
        self.heads = nn.ModuleDict({
            name: nn.Sequential(nn.Linear(H, H // 2), nn.ReLU(), nn.Linear(H // 2, out))
            for name, out in (("mask", num_classes), ("instance", num_classes),
                              ("edge", 1))
        })

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Every dropout of the model draws from ``generator`` from now on."""
        set_dropout_generator(self, generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter from ``generator`` with the JAX module's
        initialisers' laws: Xavier-uniform GAT and GCN kernels, LeCun-normal
        ``Linear`` weights, zero biases, unit BatchNorm with fresh running
        statistics."""
        self.conv1.reset_parameters(generator)
        for conv in self.convs:
            conv.reset_parameters(generator)
        for layer in (self.fc_shared, *(head[i] for head in self.heads.values() for i in (0, 2))):
            lecun_(layer, generator)
        for bn in self.bns:
            bn.reset_parameters()

    def forward(self, x: torch.Tensor, adjacency: torch.Tensor,
                edge_weights: torch.Tensor, node_mask: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """x (B, K, in), adjacency (B, K, K) bool, edge_weights (B, K, K),
        node_mask (B, K) → mask_logits (B, K, 2), instance_logits (B, K, 2),
        edge_logits (B, K, 1), node_embeddings (B, K, H), graph_embedding
        (B, H)."""
        h = torch.relu(self.bns[0](self.conv1(x, adjacency, node_mask), node_mask))
        h = self.drop(h)
        adj_norm = normalize_adjacency(edge_weights, node_mask)
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns[1:])):
            h = torch.relu(bn(conv(h, adj_norm), node_mask))
            if i < 2:
                h = self.drop(h)
        node_embeddings = torch.relu(self.fc_shared(h))
        node_embeddings = torch.where(node_mask[..., None], node_embeddings, 0.0)
        shared = self.head_drop(node_embeddings)
        out = {f"{name}_logits": head[2](self.head_drop(head[1](head[0](shared))))
               for name, head in self.heads.items()}
        out["node_embeddings"] = node_embeddings
        out["graph_embedding"] = masked_mean_pool(node_embeddings, node_mask)
        return out
