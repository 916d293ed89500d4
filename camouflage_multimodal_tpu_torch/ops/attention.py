"""Multi-head cross-attention with head-averaged probabilities.

Port of ``camouflage_multimodal_tpu/ops/attention.py`` (torch
``nn.MultiheadAttention`` semantics with ``need_weights=True,
average_attn_weights=True``). Parameters keep the JAX package's layout — a
dict of ``wq, wk, wv, wo`` (E, E) applied as ``x @ w`` and ``bq, bk, bv,
bo`` (E,) — because that is the layout the kernels read.

Every function here also takes a rank's share of the heads under tensor
parallelism (:mod:`parallel.sharding`): ``wq, wk, wv`` (E_in, E_loc) with
E_loc = ``num_heads`` · head_dim, ``wo`` (E_loc, E_out), ``bo`` ``None``
(added once after the ranks' outputs are summed) and ``total_heads``, the
heads of all ranks, by which the probabilities are divided: the sum over
the ranks of their outputs plus ``bo`` is the whole attention's output, and
the sum of their probabilities its head mean. With square weights and
``total_heads`` left out, each computes what it computed before.

:func:`fused_mha` is the trainable fused attention, the port of
``ops/pallas_attention.py``:

* forward: kernel B2 (``csrc/fused_mha.cu``, the Pallas ``_mha_kernel``);
  its plain version is :func:`multihead_attention`;
* backward: kernel B3 (``csrc/fused_mha_bwd.cu``, the custom VJP
  ``pallas_multihead_attention_trainable``); its plain version is
  :func:`multihead_attention_backward`, written out with tensor ops.
  :func:`multihead_attention_backward_tiled` and :func:`bwd_tile_plan` state
  the kernel's own rules (query-row groups, key chunks with the row-sum
  identity, the flat tile grid with row-chunk partials) in plain PyTorch for
  the tests and ``chip_smoke.py``; the port never calls them.

:class:`FusedMHA` ties the two into one ``torch.autograd.Function``. For
CUDA tensors both directions launch their kernel or raise; the plain
versions run only for CPU tensors (and as the yardstick of the checks).
Attention-probability dropout exists in the plain forward alone, as in the
JAX package: a model that trains with dropout > 0 does not use the kernels.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.parallel.sharding import rand_block

_NEG_INF = -1e30
_MAX_SMEM_BYTES = 232448   # a Hopper block's dynamic shared memory, opted in
PARAM_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
# B2's attention pass: up to _SHORT_KEYS keys go through the short-key kernel,
# more are split into chunks of _KEY_CHUNK keys (csrc/fused_mha.cu).
_SHORT_KEYS = 32
_KEY_CHUNK = 64
# B3 (csrc/fused_mha_bwd.cu): query rows of one group of its attention
# passes, the most blocks per batch row of the short-key pass, and the rows of
# one partial of a weight gradient (partials are added in chunk order).
_BWD_ROWS = 16
_BWD_MAX_SHORT_BLOCKS = 64
_BWD_ROW_CHUNK = 256
# What an autograd node of FusedMHA keeps of the forward, after the inputs.
SAVED_NAMES = ("qp", "kp", "vp", "ctx", "stats")

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
    scale = _scale(params["wq"].shape[1] // num_heads)
    q = _split_heads(query @ params["wq"] + params["bq"], num_heads) * scale
    k = _split_heads(key @ params["wk"] + params["bk"], num_heads)
    v = _split_heads(value @ params["wv"] + params["bv"], num_heads)
    logits = q @ k.transpose(-1, -2)
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, None, :], logits, _NEG_INF)
    return q, k, v, torch.softmax(logits, dim=-1), scale


def _head_mean(probs: torch.Tensor, total_heads: Optional[int]) -> torch.Tensor:
    """(B, H, Nq, Nk) → the sum over the heads divided by ``total_heads``
    (the mean over these heads when it is None)."""
    if total_heads is None or total_heads == probs.shape[1]:
        return probs.mean(dim=1)
    return probs.sum(dim=1) / total_heads


def multihead_attention(params: Params, query: torch.Tensor,
                        key: torch.Tensor, value: torch.Tensor, num_heads: int,
                        key_mask: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        data_group=None, total_heads: Optional[int] = None,
                        head_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. query (B, Nq, E_in), key/value (B, Nk, E_in),
    key_mask (B, Nk) bool (True = valid). Returns out (B, Nq, E_out) and the
    head-averaged probabilities (B, Nq, Nk) (module docstring for a rank's
    share of the heads).

    ``dropout_rate`` > 0 drops attention probabilities (kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``) with draws
    from ``generator``; the probabilities returned are the pre-dropout ones,
    like torch's return value. Under a ``data_group`` the draw is the
    global batch's and this rank keeps its rows; under a ``head_group`` it
    is drawn for all ``total_heads`` heads and this rank keeps its own."""
    _, _, v, probs, _ = _head_probs(params, query, key, value, num_heads, key_mask)
    attn = probs
    if dropout_rate > 0.0:
        keep = rand_block(probs.shape, generator, probs.device, data_group,
                          head_group, dim=1) < 1.0 - dropout_rate
        attn = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = _merge_heads(attn @ v) @ params["wo"]
    if params["bo"] is not None:
        out = out + params["bo"]
    return out, _head_mean(probs, total_heads)


def init_mha_params(generator: torch.Generator, embed_dim: int,
                    device: Optional[torch.device | str] = None) -> Params:
    """``wq, wk, wv, wo`` (E, E) Xavier-uniform, U(-a, a) with a =
    sqrt(6 / (2E)), drawn from ``generator`` in that order, and zero ``bq,
    bk, bv, bo`` (E,), float32: the JAX ``init_mha_params`` (torch
    ``MultiheadAttention``'s in-projection law; the draws are torch's). The
    draws are made on the generator's device and moved to ``device``."""
    bound = math.sqrt(6.0 / (2 * embed_dim))
    params = {name: ((torch.rand((embed_dim, embed_dim), generator=generator,
                                 device=generator.device) * 2 - 1) * bound).to(device)
              for name in ("wq", "wk", "wv", "wo")}
    for name in ("bq", "bk", "bv", "bo"):
        params[name] = torch.zeros(embed_dim, device=device or generator.device)
    return params


def multihead_attention_backward(params: Params, query: torch.Tensor,
                                 key: torch.Tensor, value: torch.Tensor,
                                 num_heads: int,
                                 key_mask: Optional[torch.Tensor],
                                 d_out: Optional[torch.Tensor],
                                 d_probs: Optional[torch.Tensor],
                                 total_heads: Optional[int] = None
                                 ) -> Tuple[Params, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B3: the exact vector-Jacobian product
    of :func:`multihead_attention` (no dropout), written out.

    ``d_out`` (B, Nq, E_out) and ``d_probs`` (B, Nq, Nk) are the cotangents
    of the two outputs; either may be ``None`` (zero). Returns
    ``(d_params, d_query, d_key, d_value)`` (``d_params["bo"]`` also when
    ``bo`` is None: the sum of ``d_out``). A masked logit gets no
    gradient — also in a row whose keys are all masked, where the
    probabilities are uniform and not zero."""
    total_heads = num_heads if total_heads is None else total_heads
    if d_out is None:
        d_out = query.new_zeros(query.shape[:-1] + (params["wo"].shape[1],))
    q, k, v, p, scale = _head_probs(params, query, key, value, num_heads, key_mask)
    ctx = _merge_heads(p @ v)

    flat = lambda x: x.reshape(-1, x.shape[-1])  # noqa: E731
    d_ctx = _split_heads(d_out @ params["wo"].T, num_heads)
    d_p = d_ctx @ v.transpose(-1, -2)
    if d_probs is not None:
        d_p = d_p + d_probs[:, None] / total_heads
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
# Kernel B3's rules in plain PyTorch (tests and chip_smoke.py only)
# ---------------------------------------------------------------------------

def multihead_attention_backward_tiled(params: Params, query: torch.Tensor,
                                       key: torch.Tensor, value: torch.Tensor,
                                       num_heads: int, key_mask: torch.Tensor,
                                       d_out: torch.Tensor,
                                       d_probs: Optional[torch.Tensor]
                                       ) -> Tuple[Params, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The algorithm of ``csrc/fused_mha_bwd.cu`` step by step, with the
    results of :func:`multihead_attention_backward`.

    Up to ``_SHORT_KEYS`` keys: blocks of ``_BWD_ROWS`` query rows (at most
    ``_BWD_MAX_SHORT_BLOCKS`` blocks per batch row, a block then takes
    several groups) recompute P, take dS and dQp row by row and sum dKp, dVp
    over their rows; the blocks' partials are added in block order. More
    keys: chunks of ``_KEY_CHUNK`` keys, each from the forward's softmax max
    and sum per row and from ``rowsum(dP * P) = d_ctx_h . ctx_h +
    (1/H) sum_j d_probs_j P_hj`` (the chunks' shares of the second term
    added in chunk order), write their partial of dQp, added in chunk order,
    and sum dKp, dVp over the query-row groups in order. Weight and bias
    gradients are summed over chunks of ``_BWD_ROW_CHUNK`` rows in chunk
    order."""
    B, Nq, E = query.shape
    Nk = key.shape[1]
    q, k, v, p_full, scale = _head_probs(params, query, key, value, num_heads, key_mask)
    logits = torch.where(key_mask[:, None, None, :], q @ k.transpose(-1, -2), _NEG_INF)
    ctx = p_full @ v                                     # what the forward saved
    d_ctx = _split_heads(d_out @ params["wo"].T, num_heads)
    live = key_mask[:, None, None, :]
    d_qp = torch.zeros_like(q)
    d_kp, d_vp = torch.zeros_like(k), torch.zeros_like(v)
    chunks = _key_chunks(Nk, E, num_heads)
    if chunks == 0:
        blocks = min(-(-Nq // _BWD_ROWS), _BWD_MAX_SHORT_BLOCKS)
        for x in range(blocks):
            part_k, part_v = torch.zeros_like(k), torch.zeros_like(v)
            for q0 in range(x * _BWD_ROWS, Nq, blocks * _BWD_ROWS):
                rows = slice(q0, q0 + _BWD_ROWS)
                p = torch.softmax(logits[:, :, rows], dim=-1)
                d_p = d_ctx[:, :, rows] @ v.transpose(-1, -2)
                if d_probs is not None:
                    d_p = d_p + d_probs[:, None, rows] / num_heads
                d_s = torch.where(live, p * (d_p - (d_p * p).sum(-1, keepdim=True)), 0.0)
                d_qp[:, :, rows] = d_s @ k * scale
                part_k += d_s.transpose(-1, -2) @ q[:, :, rows]
                part_v += p.transpose(-1, -2) @ d_ctx[:, :, rows]
            d_kp += part_k
            d_vp += part_v
    else:
        row_max = logits.amax(-1, keepdim=True)          # the forward's statistics
        row_sum = torch.exp(logits - row_max).sum(-1, keepdim=True)
        key_chunks = [slice(c * _KEY_CHUNK, (c + 1) * _KEY_CHUNK) for c in range(chunks)]
        probs = [torch.exp(logits[..., c] - row_max) / row_sum for c in key_chunks]
        row_dot = (d_ctx * ctx).sum(-1, keepdim=True)
        if d_probs is not None:
            share = torch.zeros_like(row_dot)
            for c, p in zip(key_chunks, probs):
                share += (d_probs[:, None, :, c] * p).sum(-1, keepdim=True)
            row_dot = row_dot + share / num_heads
        for c, p in zip(key_chunks, probs):
            d_p = d_ctx @ v[:, :, c].transpose(-1, -2)
            if d_probs is not None:
                d_p = d_p + d_probs[:, None, :, c] / num_heads
            d_s = torch.where(live[..., c], p * (d_p - row_dot), 0.0)
            d_qp += d_s @ k[:, :, c] * scale
            for q0 in range(0, Nq, _BWD_ROWS):
                rows = slice(q0, q0 + _BWD_ROWS)
                d_kp[:, :, c] += d_s[:, :, rows].transpose(-1, -2) @ q[:, :, rows]
                d_vp[:, :, c] += p[:, :, rows].transpose(-1, -2) @ d_ctx[:, :, rows]
    d_qp, d_kp, d_vp = _merge_heads(d_qp), _merge_heads(d_kp), _merge_heads(d_vp)

    def by_row_chunks(x, dy):
        x, dy = x.reshape(-1, E), dy.reshape(-1, E)
        d_w, d_b = torch.zeros_like(params["wq"]), torch.zeros_like(params["bq"])
        for r0 in range(0, x.shape[0], _BWD_ROW_CHUNK):
            d_w += x[r0:r0 + _BWD_ROW_CHUNK].T @ dy[r0:r0 + _BWD_ROW_CHUNK]
            d_b += dy[r0:r0 + _BWD_ROW_CHUNK].sum(dim=0)
        return d_w, d_b

    d_params = {}
    for n, x, dy in (("q", query, d_qp), ("k", key, d_kp), ("v", value, d_vp),
                     ("o", _merge_heads(ctx), d_out)):
        d_params["w" + n], d_params["b" + n] = by_row_chunks(x, dy)
    return (d_params, d_qp @ params["wq"].T, d_kp @ params["wk"].T,
            d_vp @ params["wv"].T)


def bwd_tile_plan(products, E: int):
    """The flat tile grid of B3's ``gemm_kernel``: ``products`` is a list of
    ``("nt", rows)`` (y (rows, E) = a @ b^T) and ``("tn", rows)`` (y (E, E) =
    a^T b summed over ``rows`` rows in chunks of ``_BWD_ROW_CHUNK``). Returns
    the tile width (64, or 32 when 64-wide tiles would not give each of the
    132 SMs one) and, for each block index in order, ``(product, row chunk,
    first row, first column)`` of the 32-row tile that block owns."""
    def count(width):
        return sum(-(-rows // 32) * -(-E // width) if form == "nt" else
                   -(-E // 32) * -(-E // width) * -(-rows // _BWD_ROW_CHUNK)
                   for form, rows in products)

    width = 64 if count(64) >= 132 else 32
    tiles_n = -(-E // width)
    plan = []
    for z, (form, rows) in enumerate(products):
        row_tiles = -(-rows // 32) if form == "nt" else -(-E // 32)
        for chunk in range(1 if form == "nt" else -(-rows // _BWD_ROW_CHUNK)):
            plan += [(z, chunk, (t // tiles_n) * 32, (t % tiles_n) * width)
                     for t in range(row_tiles * tiles_n)]
    return width, plan


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _widths(params: Params) -> Tuple[int, int, int]:
    """(E_in, E_loc, E_out) of the projections: ``wq`` (E_in, E_loc), ``wo``
    (E_loc, E_out)."""
    return params["wq"].shape[0], params["wq"].shape[1], params["wo"].shape[1]


def _check_cuda_inputs(params: Params, query, key, value, num_heads, key_mask):
    """What the kernels take: float32, contiguous, 16-byte aligned, one CUDA
    device, at most 32 heads of at most 32 dims with the three widths and
    the head size multiples of 4 (16-byte loads) and a (B, Nk) bool mask.
    Returns the data pointers of query, key, value and the parameters in
    ``PARAM_NAMES`` order (``None`` for a ``bo`` of ``None``)."""
    B, Nq, E_in = query.shape
    Nk = key.shape[1]
    if key.shape != (B, Nk, E_in) or value.shape != (B, Nk, E_in):
        raise ValueError(f"fused_mha: key {tuple(key.shape)} / value "
                         f"{tuple(value.shape)} do not match query {tuple(query.shape)}")
    _, E, E_out = _widths(params)
    if E % num_heads or E // num_heads > 32 or num_heads > 32:
        raise ValueError(f"fused_mha: E={E} must split into {num_heads} heads "
                         "of at most 32 dims, with at most 32 heads")
    if E % 4 or E_in % 4 or E_out % 4 or (E // num_heads) % 4:
        raise ValueError(f"fused_mha: E={E}, E_in={E_in}, E_out={E_out} and the head "
                         f"size {E // num_heads} must be multiples of 4")
    if key_mask.shape != (B, Nk) or key_mask.dtype != torch.bool:
        raise ValueError("fused_mha: key_mask must be a (B, Nk) bool tensor")
    index = query.get_device()
    shapes = {"wq": (E_in, E), "wk": (E_in, E), "wv": (E_in, E), "wo": (E, E_out),
              "bq": (E,), "bk": (E,), "bv": (E,), "bo": (E_out,)}
    names = [n for n in PARAM_NAMES if params[n] is not None]
    weights = [params[n] for n in names]
    for n, t in zip(names, weights):
        if t.shape != shapes[n]:
            raise ValueError(f"fused_mha: {n} must be {shapes[n]}")
    pointers = []
    for n, t in zip(("query", "key", "value", *names), [query, key, value] + weights):
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
    return pointers if params["bo"] is not None else pointers + [None]


def _key_chunks(Nk: int, E: int, num_heads: int) -> int:
    """How kernels B2 and B3 take the keys: 0 = the short-key pass (every key
    and value of a batch row, projected, in one block's shared memory beside
    the rows of its 8 warps in B2, of its 16 query rows in B3); otherwise the
    number of ``_KEY_CHUNK``-key chunks of the split pass. One rule for both
    directions: only the split pass saves the softmax statistics that B3's
    key chunks need."""
    padded = num_heads * (E // num_heads + 1)
    short_floats = Nk * (E + padded) + 8 * (padded + Nk * num_heads)
    short_floats_bwd = 2 * Nk * padded + _BWD_ROWS * 2 * (padded + Nk * num_heads)
    if Nk <= _SHORT_KEYS and max(short_floats, short_floats_bwd) * 4 <= _MAX_SMEM_BYTES:
        return 0
    return -(-Nk // _KEY_CHUNK)


def _bwd_scratch_floats(B: int, Nq: int, Nk: int, E: int, num_heads: int, chunks: int,
                        e_in: int, e_out: int) -> int:
    """Floats of kernel B3's one scratch allocation (the launcher in
    ``csrc/fused_mha_bwd.cu`` lays it out and checks this size): d_ctx, d_qp,
    d_kp, d_vp; the row-chunk partials of the four weight and bias gradients;
    the short pass's block partials of d_kp, d_vp or the split pass's chunk
    partials of d_qp and chunk shares of ``d_probs * P``. ``E`` is the
    width of the heads (E_loc), ``e_in`` and ``e_out`` the widths of the
    inputs and of the output."""
    n_q, n_k = B * Nq * E, B * Nk * E
    s_q, s_k = -(-B * Nq // _BWD_ROW_CHUNK), -(-B * Nk // _BWD_ROW_CHUNK)
    total = (2 * n_q + 2 * n_k + (s_q + 2 * s_k) * (e_in * E + E)
             + s_q * (E * e_out + e_out))
    if chunks == 0:
        blocks = min(-(-Nq // _BWD_ROWS), _BWD_MAX_SHORT_BLOCKS)
        return total + (2 * blocks * n_k if blocks > 1 else 0)
    return total + (chunks * n_q if chunks > 1 else 0) + B * num_heads * Nq * chunks


def _launch_forward(params: Params, query, key, value, num_heads, key_mask,
                    keep_saved: bool = True, total_heads: Optional[int] = None):
    """Kernel B2. Returns (out, probs, (qp, kp, vp, ctx, stats)): the
    projected queries, keys, values and the head-concatenated context it
    wrote on the way, and the split pass's softmax max and sum per (batch
    row, head, query row) — empty after the short-key pass — which the
    backward reuses; ``()`` instead when ``keep_saved`` is false. Those five
    and the split pass's scratch share one allocation that the call owns."""
    pointers = _check_cuda_inputs(params, query, key, value, num_heads, key_mask)
    B, Nq, E_in = query.shape
    _, E, E_out = _widths(params)
    Nk = key.shape[1]
    dev = query.device
    chunks = _key_chunks(Nk, E, num_heads)
    n_q, n_k = B * Nq * E, B * Nk * E                 # multiples of 4: the parts stay aligned
    n_attn = B * num_heads * Nq * (Nk + chunks * (2 + E // num_heads)) if chunks else 0
    n_stats = 2 * B * num_heads * Nq if chunks else 0
    buf = torch.empty(2 * n_q + 2 * n_k + n_stats + n_attn, dtype=torch.float32, device=dev)
    out = torch.empty((B, Nq, E_out), dtype=torch.float32, device=dev)
    probs = torch.empty((B, Nq, Nk), dtype=torch.float32, device=dev)
    qp = buf.data_ptr()
    ctx, kp, vp = qp + 4 * n_q, qp + 8 * n_q, qp + 8 * n_q + 4 * n_k
    stats = vp + 4 * n_k
    lib = kernels.library("fused_mha")
    rc = lib.fused_mha(*pointers[:3], key_mask.data_ptr(), *pointers[3:],
                       qp, kp, vp, ctx, out.data_ptr(), probs.data_ptr(),
                       stats + 4 * n_stats if chunks else None, stats if chunks else None,
                       B, Nq, Nk, E_in, E, E_out, num_heads,
                       num_heads if total_heads is None else total_heads, chunks,
                       _scale(E // num_heads), kernels.stream_handle(query))
    if rc:
        kernels.check(lib, rc, "fused_mha")
    kernels.LAUNCHES["fused_mha"] += 1
    if not keep_saved:
        return out, probs, ()
    parts = buf.split_with_sizes([n_q, n_q, n_k, n_k, n_stats, n_attn])
    return out, probs, (parts[0].view(B, Nq, E), parts[2].view(B, Nk, E),
                        parts[3].view(B, Nk, E), parts[1].view(B, Nq, E), parts[4])


def _check_cotangents(query, Nk: int, d_out, d_probs, e_out: int):
    """What kernel B3 takes for the cotangents: float32 on the query's device,
    (B, Nq, E_out) and (B, Nq, Nk) or ``None``, contiguous (copied when
    autograd hands over a strided one), ``d_out`` 16-byte aligned. Returns
    the pair, ``d_out`` zero-filled when it was ``None``."""
    B, Nq, _ = query.shape
    if d_out is None:
        d_out = query.new_zeros((B, Nq, e_out))
    for name, t, shape in (("d_out", d_out, (B, Nq, e_out)), ("d_probs", d_probs, (B, Nq, Nk))):
        if t is None:
            continue
        if t.shape != shape:
            raise ValueError(f"fused_mha_bwd: {name} must be {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mha_bwd: {name} must be float32, got {t.dtype}")
        if t.device != query.device:
            raise ValueError(f"fused_mha_bwd: {name} is on {t.device}, expected {query.device}")
    if not d_out.is_contiguous():
        d_out = d_out.contiguous()
    if d_probs is not None and not d_probs.is_contiguous():
        d_probs = d_probs.contiguous()
    if d_out.data_ptr() % 16:
        raise ValueError("fused_mha_bwd: d_out must be 16-byte aligned")
    return d_out, d_probs


def _launch_backward(query, key, value, key_mask, weights, saved, num_heads,
                     d_out, d_probs, total_heads: Optional[int] = None):
    """Kernel B3 on what B2 checked and saved: ``weights`` in ``PARAM_NAMES``
    order (``bo`` may be None), ``saved`` in ``SAVED_NAMES`` order. Only the
    cotangents are checked here. Returns the 11 gradients (d_q, d_k, d_v,
    then the parameters' in ``PARAM_NAMES`` order, ``bo``'s also when it is
    None) as views of one allocation, which lives as long as any of them
    does; a second allocation is the kernel's scratch."""
    B, Nq, E_in = query.shape
    _, E, E_out = _widths(dict(zip(PARAM_NAMES, weights)))
    Nk = key.shape[1]
    dev = query.device
    d_out, d_probs = _check_cotangents(query, Nk, d_out, d_probs, E_out)
    chunks = _key_chunks(Nk, E, num_heads)
    n_qi, n_ki = B * Nq * E_in, B * Nk * E_in         # multiples of 4: the parts stay aligned
    n_scratch = _bwd_scratch_floats(B, Nq, Nk, E, num_heads, chunks, E_in, E_out)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    sizes = (n_qi, n_ki, n_ki) + (E_in * E, E) * 3 + (E * E_out, E_out)
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    base = grads.data_ptr()
    out_ptrs = []
    for n in sizes:
        out_ptrs.append(base)
        base += 4 * n
    stats = saved[4]
    lib = kernels.library("fused_mha_bwd")
    rc = lib.fused_mha_bwd(
        query.data_ptr(), key.data_ptr(), value.data_ptr(), key_mask.data_ptr(),
        *(w.data_ptr() for w in weights[::2]),
        *(t.data_ptr() for t in saved[:4]), stats.data_ptr() if chunks else None,
        d_out.data_ptr(), None if d_probs is None else d_probs.data_ptr(),
        scratch.data_ptr(), n_scratch, *out_ptrs,
        B, Nq, Nk, E_in, E, E_out, num_heads,
        num_heads if total_heads is None else total_heads, chunks, _scale(E // num_heads),
        kernels.stream_handle(query))
    if rc:
        kernels.check(lib, rc, "fused_mha_bwd")
    kernels.LAUNCHES["fused_mha_bwd"] += 1
    parts = grads.split_with_sizes(sizes)
    shapes = ((B, Nq, E_in), (B, Nk, E_in), (B, Nk, E_in)) + ((E_in, E), (E,)) * 3 + (
        (E, E_out), (E_out,))
    return tuple(g.view(shape) for g, shape in zip(parts, shapes))


class FusedMHA(torch.autograd.Function):
    """Fused attention with its gradient: forward = kernel B2, backward =
    kernel B3 (the plain versions for CPU tensors). Arguments: query, key,
    value, key_mask, num_heads, total_heads, then the eight parameters in
    ``PARAM_NAMES`` order (``bo`` may be None). The mask has no
    gradient."""

    @staticmethod
    def forward(ctx, query, key, value, key_mask, num_heads, total_heads, *weights):
        params = dict(zip(PARAM_NAMES, weights))
        saved = ()
        if query.device.type == "cpu":
            out, probs = multihead_attention(params, query, key, value, num_heads, key_mask,
                                             total_heads=total_heads)
        else:
            out, probs, saved = _launch_forward(params, query, key, value, num_heads,
                                                key_mask, total_heads=total_heads)
        ctx.save_for_backward(query, key, value, key_mask, *weights, *saved)
        ctx.num_heads, ctx.total_heads = num_heads, total_heads
        ctx.has_bo = weights[-1] is not None
        ctx.set_materialize_grads(False)   # an unused output's cotangent stays None
        return out, probs

    @staticmethod
    def backward(ctx, d_out, d_probs):
        query, key, value, key_mask, *rest = ctx.saved_tensors
        weights, saved = rest[:len(PARAM_NAMES)], rest[len(PARAM_NAMES):]
        if query.device.type == "cpu":
            d_params, d_q, d_k, d_v = multihead_attention_backward(
                dict(zip(PARAM_NAMES, weights)), query, key, value, ctx.num_heads,
                key_mask, d_out, d_probs, ctx.total_heads)
            d_weights = [d_params[n] for n in PARAM_NAMES]
        else:
            d_q, d_k, d_v, *d_weights = _launch_backward(
                query, key, value, key_mask, weights, saved, ctx.num_heads, d_out, d_probs,
                ctx.total_heads)
        if not ctx.has_bo:
            d_weights[-1] = None
        return (d_q, d_k, d_v, None, None, None, *d_weights)


def fused_mha(params: Params, query: torch.Tensor, key: torch.Tensor,
              value: torch.Tensor, num_heads: int,
              key_mask: Optional[torch.Tensor] = None,
              total_heads: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention (kernel B2, with kernel B3 as its gradient) on CUDA;
    the plain versions on CPU. ``num_heads`` heads of ``params`` (a rank's
    share of ``total_heads`` when given; module docstring)."""
    if query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mha: unsupported device {query.device}")
    if key_mask is None:
        key_mask = torch.ones(key.shape[:2], dtype=torch.bool, device=query.device)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (query, key, value, *params.values()))
    if needs_grad:
        return FusedMHA.apply(query, key, value, key_mask, num_heads, total_heads,
                              *(params[n] for n in PARAM_NAMES))
    if query.device.type == "cpu":
        return multihead_attention(params, query, key, value, num_heads, key_mask,
                                   total_heads=total_heads)
    out, probs, _ = _launch_forward(params, query, key, value, num_heads, key_mask,
                                    keep_saved=False, total_heads=total_heads)
    return out, probs
