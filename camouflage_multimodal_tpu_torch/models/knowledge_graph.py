"""Knowledge-graph GNN over padded semantic subgraphs.

Port of ``camouflage_multimodal_tpu/models/knowledge_graph.py``: 3× GCN
(32 → 128), each with masked BatchNorm and ReLU, dropout (0.3) after the
first two; masked mean pool; an embedding layer Linear + ReLU + dropout
(0.2), whose output is the 128-d fusion embedding; and a regression MLP
128 → 64 → 1 on the camouflage score (dropout 0.2 between). Both 0.2
rates are fixed, as in the JAX module; a comparison at rate 0 sets
``model.head_drop.p = 0.0``. Inputs are the padded buckets of
:mod:`kg.featurize`: (B, N, 32) node features, (B, N, N)
bool adjacency and a (B, N) node mask. Dropout draws from the generator
given to :meth:`KnowledgeGraphGNN.set_generator` and is the identity in
eval mode.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from camouflage_multimodal_tpu_torch.models.layers import (
    Dropout, GCNConv, MaskedBatchNorm, lecun_, set_dropout_generator)
from camouflage_multimodal_tpu_torch.ops.graph import masked_mean_pool, normalize_adjacency


class KnowledgeGraphGNN(nn.Module):
    def __init__(self, in_channels: int = 32, hidden_channels: int = 128,
                 embedding_dim: int = 128, out_channels: int = 1,
                 dropout: float = 0.3) -> None:
        super().__init__()
        H = hidden_channels
        self.in_channels = in_channels
        self.embedding_dim = embedding_dim
        self.convs = nn.ModuleList([GCNConv(in_channels if i == 0 else H, H)
                                    for i in range(3)])
        self.bns = nn.ModuleList([MaskedBatchNorm(H) for _ in range(3)])
        self.drop = Dropout(dropout)
        self.head_drop = Dropout(0.2)
        self.embedding = nn.Linear(H, embedding_dim)
        self.classifier_1 = nn.Linear(embedding_dim, 64)
        self.classifier_2 = nn.Linear(64, out_channels)

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """Every dropout of the model draws from ``generator`` from now on."""
        set_dropout_generator(self, generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter from ``generator`` with the JAX module's
        initialisers' laws: Xavier-uniform GCN kernels, LeCun-normal
        ``Linear`` weights, zero biases, unit BatchNorm with fresh running
        statistics."""
        for conv in self.convs:
            conv.reset_parameters(generator)
        for layer in (self.embedding, self.classifier_1, self.classifier_2):
            lecun_(layer, generator)
        for bn in self.bns:
            bn.reset_parameters()

    def forward(self, x: torch.Tensor, adjacency: torch.Tensor,
                node_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """→ ``score`` (B, 1) and ``embedding`` (B, embedding_dim)."""
        adj_norm = normalize_adjacency(adjacency.float(), node_mask)
        h = x
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            h = torch.relu(bn(conv(h, adj_norm), node_mask))
            if i < 2:
                h = self.drop(h)
        emb = self.head_drop(torch.relu(self.embedding(masked_mean_pool(h, node_mask))))
        y = self.head_drop(torch.relu(self.classifier_1(emb)))
        return {"score": self.classifier_2(y), "embedding": emb}
