"""Multi-head cross-attention with head-averaged probabilities.

Port of ``camouflage_multimodal_tpu/ops/attention.py`` (torch
``nn.MultiheadAttention`` semantics with ``need_weights=True,
average_attn_weights=True``). Parameters keep the JAX package's layout — a
dict of ``wq, wk, wv, wo`` (E, E) applied as ``x @ w`` and ``bq, bk, bv,
bo`` (E,) — because that is the layout kernel B2 reads.

:func:`fused_mha` is kernel B2 (``csrc/fused_mha.cu``), the port of the
Pallas kernel ``ops/pallas_attention.py:_mha_kernel``: it launches the
kernel for CUDA tensors and runs :func:`multihead_attention`, its plain
version, for CPU tensors. Inference only; the gradient (the JAX custom VJP,
B3) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from camouflage_multimodal_tpu_torch.core import kernels

_NEG_INF = -1e30
_MAX_SMEM_BYTES = 232448   # a Hopper block's dynamic shared memory, opted in
PARAM_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")


def _scale(head_dim: int) -> torch.Tensor:
    """1/sqrt(head_dim) rounded in float32, as the JAX version computes it."""
    return 1.0 / torch.sqrt(torch.tensor(head_dim, dtype=torch.float32))


def multihead_attention(params: Dict[str, torch.Tensor], query: torch.Tensor,
                        key: torch.Tensor, value: torch.Tensor, num_heads: int,
                        key_mask: torch.Tensor | None = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. query (B, Nq, E), key/value (B, Nk, E),
    key_mask (B, Nk) bool (True = valid). Returns out (B, Nq, E) and the
    head-averaged probabilities (B, Nq, Nk)."""
    B, Nq, E = query.shape
    Nk = key.shape[1]
    hd = E // num_heads
    scale = _scale(hd).to(query.device)

    def proj(x, w, b, n):
        y = x @ w + b
        return y.reshape(B, n, num_heads, hd).transpose(1, 2)

    q = proj(query, params["wq"], params["bq"], Nq) * scale
    k = proj(key, params["wk"], params["bk"], Nk)
    v = proj(value, params["wv"], params["bv"], Nk)
    logits = q @ k.transpose(-1, -2)
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = (probs @ v).transpose(1, 2).reshape(B, Nq, E)
    out = out @ params["wo"] + params["bo"]
    return out, probs.mean(dim=1)


def fused_mha(params: Dict[str, torch.Tensor], query: torch.Tensor,
              key: torch.Tensor, value: torch.Tensor, num_heads: int,
              key_mask: torch.Tensor | None = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention forward (kernel B2) on CUDA; the plain version on CPU."""
    if query.device.type == "cpu":
        return multihead_attention(params, query, key, value, num_heads, key_mask)
    if query.device.type != "cuda":
        raise ValueError(f"fused_mha: unsupported device {query.device}")
    B, Nq, E = query.shape
    Nk = key.shape[1]
    if key.shape != (B, Nk, E) or value.shape != (B, Nk, E):
        raise ValueError(f"fused_mha: key {tuple(key.shape)} / value "
                         f"{tuple(value.shape)} do not match query {tuple(query.shape)}")
    if E % num_heads or E // num_heads > 32 or num_heads > 32:
        raise ValueError(f"fused_mha: E={E} must split into {num_heads} heads "
                         "of at most 32 dims, with at most 32 heads")
    if (E + num_heads * Nk) * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"fused_mha: {num_heads} heads x Nk={Nk} probabilities "
                         "exceed a block's shared memory")
    if key_mask is None:
        key_mask = torch.ones(B, Nk, dtype=torch.bool, device=query.device)
    if key_mask.shape != (B, Nk) or key_mask.dtype != torch.bool:
        raise ValueError("fused_mha: key_mask must be a (B, Nk) bool tensor")
    tensors = {"query": query, "key": key, "value": value,
               **{n: params[n] for n in PARAM_NAMES}}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mha: {name} must be float32, got {t.dtype}")
    for n in ("wq", "wk", "wv", "wo"):
        if params[n].shape != (E, E):
            raise ValueError(f"fused_mha: {n} must be ({E}, {E})")
    for n in ("bq", "bk", "bv", "bo"):
        if params[n].shape != (E,):
            raise ValueError(f"fused_mha: {n} must be ({E},)")
    kernels.require_cuda_inputs("fused_mha", query.device, key_mask=key_mask,
                                **tensors)

    qp = torch.empty_like(query)
    kp = torch.empty_like(key)
    vp = torch.empty_like(value)
    ctx = torch.empty_like(query)
    out = torch.empty_like(query)
    probs = torch.empty(B, Nq, Nk, dtype=torch.float32, device=query.device)
    scale = _scale(E // num_heads).item()
    lib = kernels.library("fused_mha")
    p = kernels.ptr
    rc = lib.fused_mha(p(query), p(key), p(value), p(key_mask),
                       *(p(params[n]) for n in PARAM_NAMES),
                       p(qp), p(kp), p(vp), p(ctx), p(out), p(probs),
                       B, Nq, Nk, E, num_heads, scale,
                       kernels.stream_of(query))
    kernels.check(lib, rc, "fused_mha")
    kernels.LAUNCHES["fused_mha"] += 1
    return out, probs
