"""Dense, masked graph-neural-network primitives over padded node buckets.

Port of ``camouflage_multimodal_tpu/ops/graph.py``: node features (B, K, C),
a validity mask (B, K) and a dense adjacency (B, K, K) stand in for
torch-geometric's sparse batches, with the same semantics:

* GCN: x' = D̂^{-1/2}(A + I)D̂^{-1/2} x W + b, self-loop weight 1,
* GAT (concat=False): per head e_ij = LeakyReLU₀.₂(a_dst·Wx_i + a_src·Wx_j)
  over j ∈ N(i) ∪ {i}, softmax over the senders j (masked at −1e30), heads
  averaged, plus bias,
* global mean pool over valid nodes,
* BatchNorm statistics over the valid nodes of the whole batch (of every
  rank's block under data parallelism).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from camouflage_multimodal_tpu_torch.parallel.sharding import all_reduce_sum

_NEG_INF = -1e30


def normalize_adjacency(adj: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """D̂^{-1/2}(A + I_valid)D̂^{-1/2} of a (..., K, K) weighted adjacency."""
    K = adj.shape[-1]
    eye = torch.eye(K, dtype=adj.dtype, device=adj.device)
    m = node_mask.to(adj.dtype)
    a = adj + eye * m[..., None, :] * m[..., :, None]
    deg = torch.sum(a, dim=-1)
    dinv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)), 0.0)
    return a * dinv[..., :, None] * dinv[..., None, :]


def gcn_layer(x: torch.Tensor, adj_norm: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., K, Cin), adj_norm (..., K, K), weight (Cin, Cout) as x @ W."""
    out = adj_norm @ (x @ weight)
    return out + bias if bias is not None else out


def gat_layer(x: torch.Tensor, adj: torch.Tensor, node_mask: torch.Tensor,
              kernel: torch.Tensor, att_src: torch.Tensor, att_dst: torch.Tensor,
              bias: torch.Tensor | None = None,
              negative_slope: float = 0.2) -> torch.Tensor:
    """Multi-head graph attention, heads averaged.

    x (B, K, Cin); adj (B, K, K) bool (self loops added here); kernel
    (Cin, H, C); att_src/att_dst (H, C); bias (C,)."""
    K = x.shape[-2]
    h = torch.einsum("bkc,chd->bkhd", x, kernel)
    a_src = torch.einsum("bkhd,hd->bkh", h, att_src)     # sender j
    a_dst = torch.einsum("bkhd,hd->bkh", h, att_dst)     # receiver i
    logits = F.leaky_relu(a_dst[:, :, None, :] + a_src[:, None, :, :],
                          negative_slope)                # (B, i, j, H)
    eye = torch.eye(K, dtype=torch.bool, device=x.device)
    allow = (adj | eye) & node_mask[:, None, :] & node_mask[:, :, None]
    logits = torch.where(allow[..., None], logits, _NEG_INF)
    alpha = torch.softmax(logits, dim=-2)
    alpha = torch.where(allow[..., None], alpha, 0.0)
    out = torch.einsum("bijh,bjhd->bihd", alpha, h).mean(dim=-2)
    if bias is not None:
        out = out + bias
    return torch.where(node_mask[..., None], out, 0.0)


def masked_mean_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """(..., K, C), (..., K) → (..., C) mean over valid nodes."""
    m = node_mask.to(x.dtype)
    s = torch.sum(x * m[..., None], dim=-2)
    n = torch.sum(m, dim=-1, keepdim=True)
    return s / torch.clamp(n, min=1.0)


def masked_batch_stats(x: torch.Tensor, mask: torch.Tensor, group=None):
    """(mean, population variance, count n) over every valid position of a
    (..., C) tensor with mask (...,): the statistics torch's BatchNorm1d
    sees on the reference's block-diagonal node batch. ``n`` is a 0-d
    tensor, at least 1. Under a data-parallel ``group`` the three sums
    span every rank's block (what GSPMD computes over the global batch),
    with the gradient flowing through the all-reduces; the two passes stay
    two passes, so a world of 1 gives the bits of no group."""
    m = mask.to(x.dtype)[..., None]
    dims = tuple(range(x.ndim - 1))
    n = torch.clamp(all_reduce_sum(torch.sum(m), group), min=1.0)
    mean = all_reduce_sum(torch.sum(x * m, dim=dims), group) / n
    var = all_reduce_sum(torch.sum((x - mean) ** 2 * m, dim=dims), group) / n
    return mean, var, n
