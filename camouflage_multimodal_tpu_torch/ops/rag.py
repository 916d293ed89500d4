"""Region adjacency graph as dense batched tensors.

Port of ``camouflage_multimodal_tpu/ops/rag.py``: 8-connected label
transitions give a symmetric (K, K) adjacency without self loops
(``rag_mean_color``'s ``connectivity=2``), and the reference's Gaussian
product gives the edge weights (``region_graph/train.py:199-206``).

Under spatial sharding (``row_group``: each rank holds a block of rows) a
rank takes the pairs whose first pixel lies in its rows, reading one row of
the block below (the forward maps look one row down), and the K×K maps are
OR-ed over the ranks (an all-reduce MAX); the edge weights then come from
the replicated features.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from camouflage_multimodal_tpu_torch.parallel.sharding import all_reduce_, halo_rows


def _forward_neighbor_maps(s: torch.Tensor):
    """Forward 8-connectivity neighbours (→, ↓, ↘, ↙) of (B, H, W) maps.
    Border fills repeat the edge row/column, so a fill only ever pairs a
    label with itself or with a pair the →/↓ maps already hold."""
    right = torch.cat([s[:, :, 1:], s[:, :, -1:]], dim=2)
    down = torch.cat([s[:, 1:], s[:, -1:]], dim=1)
    dr = torch.cat([right[:, 1:], right[:, -1:]], dim=1)
    left = torch.cat([s[:, :, :1], s[:, :, :-1]], dim=2)
    dl = torch.cat([left[:, 1:], left[:, -1:]], dim=1)
    return right, down, dr, dl


def region_adjacency(segments: torch.Tensor, num_segments: int,
                     row_group=None) -> torch.Tensor:
    """(B, K, K) bool symmetric adjacency of (B, H, W) label maps (under a
    ``row_group``, this rank's block of rows of them; module docstring).

    Labels outside [0, K) are dropped, as the JAX one-hot form drops them."""
    B, H = segments.shape[:2]
    K = num_segments
    K1 = K + 1
    s = segments.long()
    s = torch.where((s >= 0) & (s < K), s, K)
    ext, top = halo_rows(s, 1, row_group)
    s = ext[:, top:top + H]
    base = (torch.arange(B, device=s.device) * K1 * K1).reshape(B, 1, 1)
    adj = torch.zeros(B * K1 * K1, dtype=torch.bool, device=s.device)
    for n in _forward_neighbor_maps(ext):
        n = n[:, top:top + H]
        n = torch.where((n >= 0) & (n < K), n, K)
        # index_fill_ takes True as a kernel argument; ``adj[idx] = True``
        # would copy it from pageable host memory, a wait for the card.
        adj.index_fill_(0, (base + s * K1 + n).reshape(-1), True)
    if row_group is not None:
        adj = all_reduce_(adj.view(torch.uint8), row_group, dist.ReduceOp.MAX).view(torch.bool)
    adj = adj.reshape(B, K1, K1)[:, :K, :K]
    adj = adj | adj.transpose(1, 2)
    return adj & ~torch.eye(K, dtype=torch.bool, device=s.device)


def rag_edge_weights(features: torch.Tensor, adjacency: torch.Tensor) -> torch.Tensor:
    """Dense (B, K, K) weights
    ``exp(−‖Δmean_rgb‖/0.15)·exp(−|Δf6|/0.08)·exp(−|Δf12|/0.1)`` on the
    adjacency, zero elsewhere (f6 = texture mean, f12 = boundary contrast)."""
    color = features[..., 0:3]
    tex = features[..., 6]
    ctr = features[..., 12]
    dcolor = torch.sqrt(torch.sum((color[..., :, None, :] - color[..., None, :, :]) ** 2,
                                  dim=-1))
    dtex = torch.abs(tex[..., :, None] - tex[..., None, :])
    dctr = torch.abs(ctr[..., :, None] - ctr[..., None, :])
    w = torch.exp(-dcolor / 0.15) * torch.exp(-dtex / 0.08) * torch.exp(-dctr / 0.1)
    return torch.where(adjacency, w, 0.0)
