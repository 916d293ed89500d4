"""Multi-head cross-attention with head-averaged probabilities.

Port of ``camouflage_multimodal_tpu/ops/attention.py`` (torch
``nn.MultiheadAttention`` semantics with ``need_weights=True,
average_attn_weights=True``). Parameters keep the JAX package's layout — a
dict of ``wq, wk, wv, wo`` (E, E) applied as ``x @ w`` and ``bq, bk, bv,
bo`` (E,) — because that is the layout the kernels read.

:func:`fused_mha` is the trainable fused attention, the port of
``ops/pallas_attention.py``:

* forward: kernel B2 (``csrc/fused_mha.cu``, the Pallas ``_mha_kernel``);
  its plain version is :func:`multihead_attention`;
* backward: kernel B3 (``csrc/fused_mha_bwd.cu``, the custom VJP
  ``pallas_multihead_attention_trainable``); its plain version is
  :func:`multihead_attention_backward`, written out with tensor ops.

:class:`FusedMHA` ties the two into one ``torch.autograd.Function``. For
CUDA tensors both directions launch their kernel or raise; the plain
versions run only for CPU tensors (and as the yardstick of the checks).
Attention-probability dropout exists in the plain forward alone, as in the
JAX package: a model that trains with dropout > 0 does not use the kernels.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from camouflage_multimodal_tpu_torch.core import kernels

_NEG_INF = -1e30
_MAX_SMEM_BYTES = 232448   # a Hopper block's dynamic shared memory, opted in
PARAM_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
_WEIGHT_NAMES = ("wq", "wk", "wv", "wo")
# B2's attention pass: up to _SHORT_KEYS keys go through the short-key kernel,
# more are split into chunks of _KEY_CHUNK keys (csrc/fused_mha.cu).
_SHORT_KEYS = 32
_KEY_CHUNK = 64
# Query splits of B3's per-key reduction: warps = heads * splits <= 32.
_BWD_KEY_SPLITS = 4
# Row splits of B3's weight-gradient GEMMs (partials summed in split order).
_BWD_WEIGHT_SPLITS = 8

Params = Dict[str, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _scale(head_dim: int) -> float:
    """1/sqrt(head_dim) rounded in float32, as the JAX version computes it."""
    return (1.0 / torch.sqrt(torch.tensor(head_dim, dtype=torch.float32))).item()


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, n, E = x.shape
    return x.reshape(B, n, num_heads, E // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, n, hd = x.shape
    return x.transpose(1, 2).reshape(B, n, H * hd)


def _head_probs(params: Params, query, key, value, num_heads, key_mask):
    """Scaled per-head queries, keys, values and softmax probabilities."""
    scale = _scale(query.shape[-1] // num_heads)
    q = _split_heads(query @ params["wq"] + params["bq"], num_heads) * scale
    k = _split_heads(key @ params["wk"] + params["bk"], num_heads)
    v = _split_heads(value @ params["wv"] + params["bv"], num_heads)
    logits = q @ k.transpose(-1, -2)
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, None, :], logits, _NEG_INF)
    return q, k, v, torch.softmax(logits, dim=-1), scale


def multihead_attention(params: Params, query: torch.Tensor,
                        key: torch.Tensor, value: torch.Tensor, num_heads: int,
                        key_mask: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. query (B, Nq, E), key/value (B, Nk, E),
    key_mask (B, Nk) bool (True = valid). Returns out (B, Nq, E) and the
    head-averaged probabilities (B, Nq, Nk).

    ``dropout_rate`` > 0 drops attention probabilities (kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``) with draws
    from ``generator``; the probabilities returned are the pre-dropout ones,
    like torch's return value."""
    _, _, v, probs, _ = _head_probs(params, query, key, value, num_heads, key_mask)
    attn = probs
    if dropout_rate > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_rate
        attn = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = _merge_heads(attn @ v) @ params["wo"] + params["bo"]
    return out, probs.mean(dim=1)


def multihead_attention_backward(params: Params, query: torch.Tensor,
                                 key: torch.Tensor, value: torch.Tensor,
                                 num_heads: int,
                                 key_mask: Optional[torch.Tensor],
                                 d_out: Optional[torch.Tensor],
                                 d_probs: Optional[torch.Tensor]
                                 ) -> Tuple[Params, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B3: the exact vector-Jacobian product
    of :func:`multihead_attention` (no dropout), written out.

    ``d_out`` (B, Nq, E) and ``d_probs`` (B, Nq, Nk) are the cotangents of
    the two outputs; either may be ``None`` (zero). Returns
    ``(d_params, d_query, d_key, d_value)``. A masked logit gets no
    gradient — also in a row whose keys are all masked, where the
    probabilities are uniform and not zero."""
    E = query.shape[-1]
    if d_out is None:
        d_out = torch.zeros_like(query)
    q, k, v, p, scale = _head_probs(params, query, key, value, num_heads, key_mask)
    ctx = _merge_heads(p @ v)

    flat = lambda x: x.reshape(-1, E)  # noqa: E731
    d_ctx = _split_heads(d_out @ params["wo"].T, num_heads)
    d_p = d_ctx @ v.transpose(-1, -2)
    if d_probs is not None:
        d_p = d_p + d_probs[:, None] / num_heads
    d_s = p * (d_p - (d_p * p).sum(dim=-1, keepdim=True))
    if key_mask is not None:
        d_s = torch.where(key_mask[:, None, None, :], d_s, 0.0)
    d_qp = _merge_heads(d_s @ k) * scale          # q already carries the scale
    d_kp = _merge_heads(d_s.transpose(-1, -2) @ q)
    d_vp = _merge_heads(p.transpose(-1, -2) @ d_ctx)

    d_params = {
        "wo": flat(ctx).T @ flat(d_out), "bo": flat(d_out).sum(dim=0),
        "wq": flat(query).T @ flat(d_qp), "bq": flat(d_qp).sum(dim=0),
        "wk": flat(key).T @ flat(d_kp), "bk": flat(d_kp).sum(dim=0),
        "wv": flat(value).T @ flat(d_vp), "bv": flat(d_vp).sum(dim=0),
    }
    return (d_params, d_qp @ params["wq"].T, d_kp @ params["wk"].T,
            d_vp @ params["wv"].T)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _check_cuda_inputs(params: Params, query, key, value, num_heads, key_mask,
                       backward: bool = False):
    """What the kernels take: float32, contiguous, 16-byte aligned, one CUDA
    device, at most 32 heads of at most 32 dims with E and the head size
    multiples of 4 (16-byte loads), (B, Nk) bool mask, and a block's shared
    memory holding one row (two for the backward) of E floats and of every
    head's Nk probabilities. Returns the data pointers of query, key, value
    and the parameters in ``PARAM_NAMES`` order."""
    B, Nq, E = query.shape
    Nk = key.shape[1]
    if key.shape != (B, Nk, E) or value.shape != (B, Nk, E):
        raise ValueError(f"fused_mha: key {tuple(key.shape)} / value "
                         f"{tuple(value.shape)} do not match query {tuple(query.shape)}")
    if E % num_heads or E // num_heads > 32 or num_heads > 32:
        raise ValueError(f"fused_mha: E={E} must split into {num_heads} heads "
                         "of at most 32 dims, with at most 32 heads")
    if E % 4 or (E // num_heads) % 4:
        raise ValueError(f"fused_mha: E={E} and the head size {E // num_heads} "
                         "must be multiples of 4")
    if (1 + backward) * (E + num_heads * Nk) * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"fused_mha: {num_heads} heads x Nk={Nk} probabilities "
                         "exceed a block's shared memory")
    if key_mask.shape != (B, Nk) or key_mask.dtype != torch.bool:
        raise ValueError("fused_mha: key_mask must be a (B, Nk) bool tensor")
    index = query.get_device()
    weights = [params[n] for n in PARAM_NAMES]
    for n, t in zip(PARAM_NAMES, weights):
        want = (E, E) if n in _WEIGHT_NAMES else (E,)
        if t.shape != want:
            raise ValueError(f"fused_mha: {n} must be {want}")
    pointers = []
    for n, t in zip(("query", "key", "value") + PARAM_NAMES, [query, key, value] + weights):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mha: {n} must be float32, got {t.dtype}")
        if t.get_device() != index:
            raise ValueError(f"fused_mha: {n} is on {t.device}, expected {query.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_mha: {n} must be contiguous")
        pointers.append(t.data_ptr())
        if pointers[-1] % 16:
            raise ValueError(f"fused_mha: {n} must be 16-byte aligned")
    if key_mask.get_device() != index or not key_mask.is_contiguous():
        raise ValueError(f"fused_mha: key_mask must be contiguous on {query.device}")
    return pointers


def _key_chunks(Nk: int, E: int, num_heads: int) -> int:
    """How kernel B2 takes the keys: 0 = the short-key pass (every key and
    value of a batch row, projected, in one block's shared memory beside the
    rows of its 8 warps); otherwise the number of ``_KEY_CHUNK``-key chunks
    of the split pass."""
    padded = num_heads * (E // num_heads + 1)
    short_floats = Nk * (E + padded) + 8 * (padded + Nk * num_heads)
    if Nk <= _SHORT_KEYS and short_floats * 4 <= _MAX_SMEM_BYTES:
        return 0
    return -(-Nk // _KEY_CHUNK)


def _launch_forward(params: Params, query, key, value, num_heads, key_mask,
                    keep_saved: bool = True):
    """Kernel B2. Returns (out, probs, (qp, kp, vp, ctx)): the projected
    queries, keys, values and the head-concatenated context it wrote on the
    way, which the backward reuses; ``()`` instead when ``keep_saved`` is
    false. Those four and the split pass's scratch share one allocation
    that the call owns."""
    pointers = _check_cuda_inputs(params, query, key, value, num_heads, key_mask)
    B, Nq, E = query.shape
    Nk = key.shape[1]
    dev = query.device
    chunks = _key_chunks(Nk, E, num_heads)
    n_q, n_k = B * Nq * E, B * Nk * E                 # multiples of 4: the parts stay aligned
    n_attn = B * num_heads * Nq * (Nk + chunks * (2 + E // num_heads)) if chunks else 0
    buf = torch.empty(2 * n_q + 2 * n_k + n_attn, dtype=torch.float32, device=dev)
    out = torch.empty_like(query)
    probs = torch.empty((B, Nq, Nk), dtype=torch.float32, device=dev)
    qp = buf.data_ptr()
    ctx, kp, vp = qp + 4 * n_q, qp + 8 * n_q, qp + 8 * n_q + 4 * n_k
    lib = kernels.library("fused_mha")
    rc = lib.fused_mha(*pointers[:3], key_mask.data_ptr(), *pointers[3:],
                       qp, kp, vp, ctx, out.data_ptr(), probs.data_ptr(),
                       vp + 4 * n_k if chunks else None,
                       B, Nq, Nk, E, num_heads, chunks, _scale(E // num_heads),
                       kernels.stream_handle(query))
    if rc:
        kernels.check(lib, rc, "fused_mha")
    kernels.LAUNCHES["fused_mha"] += 1
    if not keep_saved:
        return out, probs, ()
    parts = buf.split_with_sizes([n_q, n_q, n_k, n_k, n_attn])
    return out, probs, (parts[0].view(B, Nq, E), parts[2].view(B, Nk, E),
                        parts[3].view(B, Nk, E), parts[1].view(B, Nq, E))


def _launch_backward(params: Params, query, key, value, num_heads, key_mask,
                     saved, d_out, d_probs):
    """Kernel B3 on what B2 saved. Returns (d_params, d_q, d_k, d_v)."""
    _check_cuda_inputs(params, query, key, value, num_heads, key_mask,
                       backward=True)
    B, Nq, E = query.shape
    Nk = key.shape[1]
    dev = query.device
    qp, kp, vp, ctx = saved
    d_out = torch.zeros_like(query) if d_out is None else d_out.contiguous()
    cotangents = {"d_out": d_out}
    if d_probs is not None:
        cotangents["d_probs"] = d_probs = d_probs.contiguous()
        if d_probs.shape != (B, Nq, Nk):
            raise ValueError(f"fused_mha_bwd: d_probs must be {(B, Nq, Nk)}")
    if d_out.shape != query.shape:
        raise ValueError(f"fused_mha_bwd: d_out must be {tuple(query.shape)}")
    for name, t in cotangents.items():
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mha_bwd: {name} must be float32, got {t.dtype}")
    kernels.require_cuda_inputs("fused_mha_bwd", dev, qp=qp, kp=kp, vp=vp,
                                ctx=ctx, **cotangents)

    def empty(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)

    d_ctx, d_qp = torch.empty_like(query), torch.empty_like(query)
    d_kp, d_vp = torch.empty_like(key), torch.empty_like(key)
    p_heads, ds_heads = empty(B, num_heads, Nq, Nk), empty(B, num_heads, Nq, Nk)
    w_partial = empty(4, _BWD_WEIGHT_SPLITS, E, E)
    d_q, d_k, d_v = torch.empty_like(query), torch.empty_like(key), torch.empty_like(value)
    d_params = {n: torch.empty_like(params[n]) for n in PARAM_NAMES}
    key_splits = max(1, min(_BWD_KEY_SPLITS, 32 // num_heads, Nq))

    lib = kernels.library("fused_mha_bwd")
    p = kernels.ptr
    rc = lib.fused_mha_bwd(
        p(query), p(key), p(value), p(key_mask),
        *(p(params[n]) for n in _WEIGHT_NAMES),
        p(qp), p(kp), p(vp), p(ctx), p(d_out),
        None if d_probs is None else p(d_probs),
        p(d_ctx), p(d_qp), p(d_kp), p(d_vp), p(p_heads), p(ds_heads), p(w_partial),
        p(d_q), p(d_k), p(d_v), *(p(d_params[n]) for n in PARAM_NAMES),
        B, Nq, Nk, E, num_heads, key_splits, _BWD_WEIGHT_SPLITS,
        _scale(E // num_heads), kernels.stream_handle(query))
    kernels.check(lib, rc, "fused_mha_bwd")
    kernels.LAUNCHES["fused_mha_bwd"] += 1
    return d_params, d_q, d_k, d_v


class FusedMHA(torch.autograd.Function):
    """Fused attention with its gradient: forward = kernel B2, backward =
    kernel B3 (the plain versions for CPU tensors). Arguments: query, key,
    value, key_mask, num_heads, then the eight parameters in
    ``PARAM_NAMES`` order. The mask has no gradient."""

    @staticmethod
    def forward(ctx, query, key, value, key_mask, num_heads, *weights):
        params = dict(zip(PARAM_NAMES, weights))
        saved = ()
        if query.device.type == "cpu":
            out, probs = multihead_attention(params, query, key, value,
                                             num_heads, key_mask)
        else:
            out, probs, saved = _launch_forward(params, query, key, value,
                                                num_heads, key_mask)
        ctx.save_for_backward(query, key, value, key_mask, *weights, *saved)
        ctx.num_heads = num_heads
        ctx.set_materialize_grads(False)   # an unused output's cotangent stays None
        return out, probs

    @staticmethod
    def backward(ctx, d_out, d_probs):
        query, key, value, key_mask, *rest = ctx.saved_tensors
        params = dict(zip(PARAM_NAMES, rest[:len(PARAM_NAMES)]))
        saved = rest[len(PARAM_NAMES):]
        if query.device.type == "cpu":
            d_params, d_q, d_k, d_v = multihead_attention_backward(
                params, query, key, value, ctx.num_heads, key_mask, d_out, d_probs)
        else:
            d_params, d_q, d_k, d_v = _launch_backward(
                params, query, key, value, ctx.num_heads, key_mask, saved,
                d_out, d_probs)
        return (d_q, d_k, d_v, None, None, *(d_params[n] for n in PARAM_NAMES))


def fused_mha(params: Params, query: torch.Tensor, key: torch.Tensor,
              value: torch.Tensor, num_heads: int,
              key_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention (kernel B2, with kernel B3 as its gradient) on CUDA;
    the plain versions on CPU."""
    if query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mha: unsupported device {query.device}")
    if key_mask is None:
        key_mask = torch.ones(key.shape[:2], dtype=torch.bool, device=query.device)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (query, key, value, *params.values()))
    if needs_grad:
        return FusedMHA.apply(query, key, value, key_mask, num_heads,
                              *(params[n] for n in PARAM_NAMES))
    if query.device.type == "cpu":
        return multihead_attention(params, query, key, value, num_heads, key_mask)
    out, probs, _ = _launch_forward(params, query, key, value, num_heads, key_mask,
                                    keep_saved=False)
    return out, probs
