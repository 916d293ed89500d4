"""What the designs of the port's CUDA kernels B1, B2 and B3 rest on, checked in
plain PyTorch and numpy on the CPU (the kernels themselves run only on a
card, ``tests/test_torch_port_cuda.py``):

* B1 (``csrc/slic_assign.cu``) prunes the K centers per 2-D pixel tile before
  the per-pixel loop. ``ops.slic.tile_candidates`` states the rule; here every
  in-box (pixel, center) pair must lie in its tile's list, and the assignment
  restricted to the lists must equal ``slic_assign_plain`` bit for bit.
* B2's projections (``csrc/gemm_3xtf32.cuh``) run on the tensor cores in
  TF32 with an error-compensated three-term split. An emulation of TF32
  rounding shows why: three terms stay within 1e-5 relative of the float64
  product of the committed fusion weights, one term errs over 100 times more.
* B2's attention pass over many keys (``csrc/fused_mha.cu``) splits the keys
  into chunks of 64 and joins the chunks afterwards; a plain version of that
  join must equal ``multihead_attention``.
* B3 (``csrc/fused_mha_bwd.cu``) takes the attention gradient by groups of 16
  query rows (few keys) or by chunks of 64 keys that work alone, from the
  forward's softmax statistics and a row-sum identity (many keys);
  ``ops.attention.multihead_attention_backward_tiled`` states that algorithm
  and must equal ``multihead_attention_backward``. Its eight products run on
  the same tensor-core GEMM in two transposed forms; the weight gradients
  are summed by chunks of 256 rows in chunk order over a flat tile grid
  (``ops.attention.bwd_tile_plan``), whatever order the tiles run in.
"""

import importlib

import numpy as np
import pytest
import torch

from camouflage_multimodal_tpu_torch import api
from camouflage_multimodal_tpu_torch.ops import attention as A

S = importlib.import_module("camouflage_multimodal_tpu_torch.ops.slic")   # ops.slic is the function

FUSION_CKPT = "artifacts/checkpoints_balanced/multimodal_best_fixed.ckpt"


# ---------------------------------------------------------------------------
# B1: candidate lists per pixel tile
# ---------------------------------------------------------------------------

def _slic_case(height, width, n_segments, case, seed=0):
    """(pix (1, HW, 5), centers (1, K, 5), prev, ratio, step) with seeded
    colours, pixel positions on the image grid and one of four center
    states."""
    rng = np.random.default_rng(seed)
    step = S.slic_step(n_segments, height, width)
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    color = rng.uniform(-40, 60, (height, width, 3))
    pix = np.concatenate([color, yy[..., None], xx[..., None]], -1).reshape(1, -1, 5)
    sy, sx = np.arange(step // 2, height, step), np.arange(step // 2, width, step)
    cy, cx = (g.reshape(-1).astype(np.float64) for g in np.meshgrid(sy, sx, indexing="ij"))
    K = cy.size
    if case == "jittered":
        cy = cy + rng.uniform(-step, step, K)
        cx = cx + rng.uniform(-step, step, K)
    elif case == "collapsed":       # every center inside one tile: its list holds all K
        cy, cx = rng.uniform(20, 29, K), rng.uniform(36, 45, K)
    elif case == "outside":         # half of the centers off the image
        off = rng.random(K) < 0.5
        cy = np.where(off, cy - height - 3.5 * step, cy)
        cx = np.where(~off, cx + width + 0.5 * step, cx)
    centers = np.concatenate([rng.uniform(-40, 60, (K, 3)), cy[:, None], cx[:, None]], -1)[None]
    prev = rng.integers(0, K, (1, height * width))
    return (torch.from_numpy(pix.astype(np.float32)), torch.from_numpy(centers.astype(np.float32)),
            torch.from_numpy(prev.astype(np.int32)), (S.COMPACTNESS / step) ** 2, step)


def _tile_of_pixel(height, width, tile):
    th, tw = tile
    tiles_x = -(-width // tw)
    yy, xx = torch.meshgrid(torch.arange(height), torch.arange(width), indexing="ij")
    return ((yy // th) * tiles_x + xx // tw).reshape(-1)


@pytest.mark.parametrize("tile", [(16, 16), (8, 32)])
@pytest.mark.parametrize("case", ["seeded", "jittered", "collapsed", "outside"])
@pytest.mark.parametrize("height,width,n_segments", [(256, 256, 500), (352, 352, 500),
                                                     (416, 416, 500), (97, 131, 60)])
def test_tile_candidates_hold_every_in_box_center(height, width, n_segments, case, tile):
    """No pixel of a tile has a center in its ±step box that the tile's list
    lacks, at any tile shape and center state, ragged edges included."""
    pix, centers, _, _, step = _slic_case(height, width, n_segments, case)
    cand = S.tile_candidates(centers, step, height, width, tile)[0]      # (tiles, K)
    tile_of = _tile_of_pixel(height, width, tile)
    assert cand.shape == (int(tile_of.max()) + 1, centers.shape[1])
    fy, fx = torch.floor(centers[0, :, 3]), torch.floor(centers[0, :, 4])
    needed = torch.zeros(cand.shape, dtype=torch.int32)
    for s in range(0, height * width, 8192):
        p = pix[0, s:s + 8192]
        ok = ((p[:, 3:4] - fy).abs() <= step) & ((p[:, 4:5] - fx).abs() <= step)
        needed.index_add_(0, tile_of[s:s + 8192], ok.int())
    assert not ((needed > 0) & ~cand).any()
    if case == "collapsed":
        assert int(cand.sum(-1).max()) == centers.shape[1]
    if case == "seeded" and tile == (16, 16):
        assert cand.sum(-1).float().mean() < 20     # a list is a few of the K centers


@pytest.mark.parametrize("case", ["seeded", "jittered", "collapsed", "outside"])
@pytest.mark.parametrize("height,width,n_segments", [(256, 256, 500), (352, 352, 500),
                                                     (416, 416, 500), (97, 131, 60)])
def test_assignment_from_tile_lists_equals_plain(height, width, n_segments, case):
    """The kernel's algorithm, tile by tile in plain PyTorch: each tile's
    pixels scored against its list alone (ids ascending along the list, so
    the lowest id still wins a tie) give the labels of the all-K plain
    version, bit for bit."""
    pix, centers, prev, ratio, step = _slic_case(height, width, n_segments, case, seed=1)
    want = S.slic_assign_plain(pix, centers, prev, ratio, step)
    cand = S.tile_candidates(centers, step, height, width, (16, 16))[0]
    tile_of = _tile_of_pixel(height, width, (16, 16))
    order = torch.argsort(tile_of, stable=True)
    bounds = torch.searchsorted(tile_of[order], torch.arange(cand.shape[0] + 1))
    got = prev.clone()
    for t in range(cand.shape[0]):
        ids = torch.nonzero(cand[t])[:, 0]
        if ids.numel() == 0:
            continue                                  # nothing listed: the pixels keep prev
        px = order[bounds[t]:bounds[t + 1]]
        local = S.slic_assign_plain(pix[:, px], centers[:, ids], torch.full((1, px.numel()), -1,
                                                                           dtype=torch.int32),
                                    ratio, step)[0]
        got[0, px] = torch.where(local >= 0, ids[local.clamp(min=0).long()].int(), prev[0, px])
    assert torch.equal(got, want)


def test_tile_candidates_batch_and_default_tile():
    """Batched centers give one list set per image; the default tile is the
    kernel's 16 × 16."""
    _, c0, _, _, step = _slic_case(64, 80, 30, "seeded")
    _, c1, _, _, _ = _slic_case(64, 80, 30, "jittered", seed=3)
    both = S.tile_candidates(torch.cat([c0, c1]), step, 64, 80)
    assert both.shape == (2, 4 * 5, c0.shape[1]) and both.dtype == torch.bool
    assert torch.equal(both[0], S.tile_candidates(c0, step, 64, 80, (16, 16))[0])
    assert torch.equal(both[1], S.tile_candidates(c1, step, 64, 80, (16, 16))[0])


def test_slic_assign_ignores_width_on_cpu():
    """CPU tensors take the plain version, with or without the width."""
    pix, centers, prev, ratio, step = _slic_case(40, 56, 20, "jittered")
    want = S.slic_assign_plain(pix, centers, prev, ratio, step)
    assert torch.equal(S.slic_assign(pix, centers, prev, ratio, step, width=56), want)
    assert torch.equal(S.slic_assign(pix, centers, prev, ratio, step), want)


# ---------------------------------------------------------------------------
# B2: the three-term TF32 split of the projections
# ---------------------------------------------------------------------------

def _tf32_round(x: np.ndarray) -> np.ndarray:
    """float32 → TF32 (10 mantissa bits), round to nearest, ties away from
    zero: add half a unit of the 13 dropped bits, then clear them. This is
    the kernel's integer form of ``cvt.rna.tf32.f32``."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tf32_truncate(x: np.ndarray) -> np.ndarray:
    """What the tensor core reads of a float32 operand: its upper 19 bits."""
    return (x.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.fixture(scope="module")
def fusion_weights():
    model, _ = api.load_multimodal_model(FUSION_CKPT, device="cpu")
    return {(d, n): getattr(getattr(model.fusion, f"cross_attn_{d}"), n).detach().numpy()
            for d in ("rg2kg", "kg2rg") for n in ("wq", "wk", "wv", "wo")}


@pytest.mark.parametrize("name", ["wq", "wk", "wv", "wo"])
@pytest.mark.parametrize("direction", ["rg2kg", "kg2rg"])
def test_three_term_tf32_product_is_float32_grade(fusion_weights, direction, name):
    """x @ W at depth 256 with the committed fusion weights and seeded
    activations. Products of TF32 values are exact in the tensor core and
    are summed here in float64, so what is measured is the split alone:
    head·head + head·tail + tail·head stays within 1e-5 of the float64
    product, relative to its largest entry (seen: 1e-7); head·head alone,
    plain TF32, errs at least 100 times more (seen: 3,000 times)."""
    w = fusion_weights[direction, name]
    assert w.shape == (256, 256)
    rng = np.random.default_rng(len(direction) + ord(name[1]))
    x = np.maximum(rng.standard_normal((96, 256)), 0).astype(np.float32)   # post-ReLU like
    exact = x.astype(np.float64) @ w.astype(np.float64)

    x_hi, w_hi = _tf32_round(x), _tf32_round(w)
    x_lo, w_lo = _tf32_truncate(x - x_hi), _tf32_truncate(w - w_hi)
    f64 = lambda a: a.astype(np.float64)  # noqa: E731
    three = f64(x_lo) @ f64(w_hi) + f64(x_hi) @ f64(w_lo) + f64(x_hi) @ f64(w_hi)
    one = f64(x_hi) @ f64(w_hi)

    scale = np.abs(exact).max()
    err_three = np.abs(three - exact).max() / scale
    err_one = np.abs(one - exact).max() / scale
    assert err_three <= 1e-5
    assert err_one >= 100 * err_three
    # float32 throughout (what the plain version does) is no better than the split.
    assert err_three <= 4 * np.abs(x @ w - exact).max() / scale


# ---------------------------------------------------------------------------
# B2: the key-split attention pass
# ---------------------------------------------------------------------------

def _chunked_attention(params, query, key, value, num_heads, key_mask, chunk=64):
    """The split pass of ``csrc/fused_mha.cu`` in plain PyTorch: per chunk of
    keys the unnormalised exponentials against the chunk's own max, their
    sum and their product with V; then the chunks joined in chunk order with
    ``exp(chunk max − row max) / row sum``."""
    q, k, v, _, _ = A._head_probs(params, query, key, value, num_heads, key_mask)
    logits = q @ k.transpose(-1, -2)
    logits = torch.where(key_mask[:, None, None, :], logits, A._NEG_INF)
    parts = []
    for s in range(0, key.shape[1], chunk):
        sl = logits[..., s:s + chunk]
        m = sl.amax(-1, keepdim=True)
        e = torch.exp(sl - m)
        parts.append((m, e, e.sum(-1, keepdim=True), e @ v[:, :, s:s + chunk]))
    row_max = torch.cat([m for m, _, _, _ in parts], -1).amax(-1, keepdim=True)
    row_sum = sum(l * torch.exp(m - row_max) for m, _, l, _ in parts)
    factors = [torch.exp(m - row_max) / row_sum for m, _, _, _ in parts]
    ctx = sum(o * f for (_, _, _, o), f in zip(parts, factors))
    probs = torch.cat([e * f for (_, e, _, _), f in zip(parts, factors)], -1)
    out = A._merge_heads(ctx) @ params["wo"] + params["bo"]
    return out, probs.mean(dim=1)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-6), (torch.float32, 2e-5)])
@pytest.mark.parametrize("nq,nk,e,heads", [(13, 640, 256, 8), (13, 576, 256, 8),
                                           (37, 75, 256, 8), (5, 33, 32, 8)])
def test_chunked_softmax_combine_equals_plain(nq, nk, e, heads, dtype, tol):
    """Chunks of 64 keys joined afterwards equal the one-pass softmax: 1e-6
    in float64 (the algorithm), 2e-5 in float32 (its rounding). Batch row 1
    is partly masked, so its last chunks are fully masked beside live ones;
    batch row 2 has every key masked and gets uniform weights."""
    rng = np.random.default_rng(nq * nk)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape)).to(dtype)  # noqa: E731
    params = {n: (t(e, e) / e ** 0.5 if n[0] == "w" else 0.1 * t(e)) for n in A.PARAM_NAMES}
    q, k, v = t(3, nq, e), t(3, nk, e), t(3, nk, e)
    mask = torch.arange(nk)[None] < torch.tensor([[nk], [max(1, nk // 3)], [0]])
    want_out, want_p = A.multihead_attention(params, q, k, v, heads, mask)
    got_out, got_p = _chunked_attention(params, q, k, v, heads, mask)
    torch.testing.assert_close(got_out, want_out, rtol=tol, atol=tol)
    torch.testing.assert_close(got_p, want_p, rtol=tol, atol=tol)
    torch.testing.assert_close(got_p[2], torch.full_like(got_p[2], 1.0 / nk), rtol=tol, atol=tol)


def test_key_chunk_rule_matches_the_main_path():
    """Which attention pass the wrapper picks: the 13 KG categories go
    through the short-key kernel, 576 or 640 region nodes through 9 or 10
    chunks of 64, and the boundary sits at 32 keys."""
    assert A._key_chunks(13, 256, 8) == 0
    assert A._key_chunks(32, 256, 8) == 0
    assert A._key_chunks(33, 256, 8) == 1
    assert A._key_chunks(576, 256, 8) == 9
    assert A._key_chunks(640, 256, 8) == 10
    # 32 keys of a 1,024-wide model no longer fit one block's shared memory.
    assert A._key_chunks(32, 1024, 32) == 1


# ---------------------------------------------------------------------------
# B3: the tiled attention backward, the transposed products, the tile grid
# ---------------------------------------------------------------------------

def _bwd_case(nq, nk, e, dtype, with_probs, seed):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape)).to(dtype)  # noqa: E731
    params = {n: (t(e, e) / e ** 0.5 if n[0] == "w" else 0.1 * t(e)) for n in A.PARAM_NAMES}
    q, k, v = t(3, nq, e), t(3, nk, e), t(3, nk, e)
    mask = torch.arange(nk)[None] < torch.tensor([[nk], [max(1, nk // 3)], [0]])
    return params, q, k, v, mask, t(3, nq, e), (t(3, nq, nk) if with_probs else None)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-6), (torch.float32, 1e-4)])
@pytest.mark.parametrize("with_probs", [True, False])
@pytest.mark.parametrize("nq,nk,e,heads", [(576, 13, 256, 8), (13, 576, 256, 8),
                                           (640, 13, 256, 8), (13, 640, 256, 8),
                                           (37, 101, 64, 4), (1100, 20, 64, 4)])
def test_tiled_backward_equals_plain(nq, nk, e, heads, with_probs, dtype, tol):
    """B3's algorithm in plain PyTorch against the plain backward: 1e-6 in
    float64 (the algorithm: row groups, key chunks that work alone through
    the saved softmax statistics and ``rowsum(dP * P) = d_ctx . ctx +
    sum(d_probs * P) / H``, partials joined in order, weight gradients by
    row chunks), the kernel's 1e-4 bar in float32. Batch row 1 is partly
    masked, batch row 2 has every key masked (uniform P, dS = 0)."""
    params, q, k, v, mask, d_out, d_probs = _bwd_case(nq, nk, e, dtype, with_probs, nq * nk)
    want = A.multihead_attention_backward(params, q, k, v, heads, mask, d_out, d_probs)
    got = A.multihead_attention_backward_tiled(params, q, k, v, heads, mask, d_out, d_probs)
    for n in A.PARAM_NAMES:
        torch.testing.assert_close(got[0][n], want[0][n], rtol=tol, atol=tol, msg=lambda m: f"{n}: {m}")
    for n, a, b in zip(("d_q", "d_k", "d_v"), got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=lambda m: f"{n}: {m}")
    # The all-masked batch row gives its queries and keys no gradient, its values some.
    assert float(got[1][2].abs().max()) == 0.0 and float(got[2][2].abs().max()) == 0.0
    assert float(got[3][2].abs().max()) > 0.0


def _split(x):
    hi = _tf32_round(x)
    return hi.astype(np.float64), _tf32_truncate(x - hi).astype(np.float64)


def _three_and_one(a, b):
    """a @ b from TF32 heads and tails, summed in float64: the three-term
    split and plain TF32."""
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi, a_hi @ b_hi


@pytest.mark.parametrize("name", ["wq", "wk", "wv", "wo"])
@pytest.mark.parametrize("direction", ["rg2kg", "kg2rg"])
def test_three_term_tf32_transposed_products(fusion_weights, direction, name):
    """B3's two transposed products with the committed fusion weights, as
    the extended GEMM header takes them. ``dy @ W^T`` (an input gradient):
    three terms within 1e-5 of the float64 product relative to its largest
    entry, one term at least 100 times worse. ``x^T dy`` over 2,304 rows (a
    weight gradient, dy = g @ W^T) in chunks of 256 rows whose float32
    partials are added in chunk order in float32, as the kernel adds them:
    the same two bars."""
    w = fusion_weights[direction, name]
    rng = np.random.default_rng(7 + len(direction) + ord(name[1]))
    g = rng.standard_normal((2304, 256)).astype(np.float32)
    exact = g.astype(np.float64) @ w.astype(np.float64).T
    three, one = _three_and_one(g, np.ascontiguousarray(w.T))
    scale = np.abs(exact).max()
    err_three, err_one = np.abs(three - exact).max() / scale, np.abs(one - exact).max() / scale
    assert err_three <= 1e-5 and err_one >= 100 * err_three

    x = np.maximum(rng.standard_normal((2304, 256)), 0).astype(np.float32)   # post-ReLU like
    dy = exact.astype(np.float32)
    exact_w = x.astype(np.float64).T @ dy.astype(np.float64)
    sum_three = np.zeros((256, 256), np.float32)
    sum_one = np.zeros((256, 256), np.float32)
    for r0 in range(0, 2304, A._BWD_ROW_CHUNK):
        rows = slice(r0, r0 + A._BWD_ROW_CHUNK)
        three, one = _three_and_one(np.ascontiguousarray(x[rows].T), dy[rows])
        sum_three += three.astype(np.float32)
        sum_one += one.astype(np.float32)
    scale = np.abs(exact_w).max()
    err_three = np.abs(sum_three - exact_w).max() / scale
    err_one = np.abs(sum_one - exact_w).max() / scale
    assert err_three <= 1e-5 and err_one >= 100 * err_three


def _run_plan(plan, width, products, operands, e, order):
    """Execute the tiles of ``plan`` in ``order``: a "tn" tile adds its 256
    rows one at a time in float32 (elementwise, so the bits do not depend on
    the tile's shape) into its chunk's slab; then the slabs are added in
    chunk order."""
    slabs = [np.full((-(-rows // A._BWD_ROW_CHUNK), e, e), np.nan, np.float32)
             for _, rows in products]
    for i in order:
        z, chunk, row0, col0 = plan[i]
        x, dy = operands[z]
        rs, cs = slice(row0, row0 + 32), slice(col0, col0 + width)
        acc = np.zeros((len(range(e)[rs]), len(range(e)[cs])), np.float32)
        for r in range(chunk * A._BWD_ROW_CHUNK, min(x.shape[0], (chunk + 1) * A._BWD_ROW_CHUNK)):
            acc += x[r, rs, None] * dy[r, None, cs]
        assert np.isnan(slabs[z][chunk, rs, cs]).all()          # no tile is written twice
        slabs[z][chunk, rs, cs] = acc
    out = []
    for slab in slabs:
        assert not np.isnan(slab).any()                         # every tile was written
        total = slab[0].copy()
        for part in slab[1:]:
            total += part
        out.append(total)
    return out


def test_row_chunk_partials_do_not_depend_on_the_tile_assignment():
    """Weight gradients over a flat tile grid: whatever order the tiles run
    in, and whichever tile width the grid takes, every (product, row chunk,
    tile) is computed exactly once and the chunk-ordered float32 sums are
    bit-equal."""
    e = 72
    rng = np.random.default_rng(5)
    products = [("tn", 600), ("tn", 52), ("tn", 257)]
    operands = [(rng.standard_normal((rows, e)).astype(np.float32),
                 rng.standard_normal((rows, e)).astype(np.float32)) for _, rows in products]
    width, plan = A.bwd_tile_plan(products, e)
    assert width == 32 and len(plan) == (3 + 1 + 2) * 3 * 3
    want = _run_plan(plan, width, products, operands, e, range(len(plan)))
    for z, (x, dy) in enumerate(operands):
        np.testing.assert_allclose(want[z], x.T.astype(np.float64) @ dy, rtol=1e-4, atol=1e-4)
    for order in (range(len(plan) - 1, -1, -1), rng.permutation(len(plan))):
        for a, b in zip(_run_plan(plan, width, products, operands, e, order), want):
            assert np.array_equal(a, b)
    # 64-wide tiles of the same products: other tiles, the same bits.
    plan64 = [(z, chunk, row0, col0) for z, chunk, row0, col0 in plan if col0 % 64 == 0]
    for a, b in zip(_run_plan(plan64, 64, products, operands, e, range(len(plan64))), want):
        assert np.array_equal(a, b)


def test_bwd_tile_plan_matches_the_training_shapes():
    """The two GEMM launches of one B3 call at the training shapes: the
    counts of tiles, the tile width (64, or 32 when 64-wide tiles would leave
    SMs idle) and the order product after product, chunk after chunk."""
    rq, rk = 4 * 576, 4 * 13
    for first, second in (([("nt", rq), ("tn", rq)],
                           [("nt", rq), ("nt", rk), ("nt", rk), ("tn", rq), ("tn", rk), ("tn", rk)]),
                          ([("nt", rk), ("tn", rk)],
                           [("nt", rk), ("nt", rq), ("nt", rq), ("tn", rk), ("tn", rq), ("tn", rq)])):
        width, plan = A.bwd_tile_plan(first, 256)
        tiles = {(z, c) for z, c, _, _ in plan}
        if first[0][1] == rq:
            assert width == 64 and len(plan) == 72 * 4 + 9 * 8 * 4
            assert tiles == {(0, 0)} | {(1, c) for c in range(9)}
        else:
            assert width == 32 and len(plan) == 2 * 8 + 8 * 8      # 40 tiles of 64: under 132
            assert tiles == {(0, 0), (1, 0)}
        assert plan == sorted(plan)                                 # product, chunk, row, column
        width, plan = A.bwd_tile_plan(second, 256)
        big = sum(form == "nt" and rows == rq for form, rows in second)     # 1 or 2 of 3
        assert width == 64 and len(plan) == (
            (72 * big + 2 * (3 - big)) * 4 + (9 * big + (3 - big)) * 8 * 4)
        assert len(set(plan)) == len(plan)


def test_bwd_scratch_covers_every_part():
    """The one scratch allocation of a B3 call at the training shapes, part by
    part (the launcher checks the same sum)."""
    n_q, n_k, ee = 4 * 576 * 256, 4 * 13 * 256, 256 * 256 + 256
    assert A._bwd_scratch_floats(4, 576, 13, 256, 8, 0, 256, 256) == (
        2 * n_q + 2 * n_k + (2 * 9 + 2 * 1) * ee + 2 * 36 * n_k)
    n_q, n_k = n_k, n_q
    assert A._bwd_scratch_floats(4, 13, 576, 256, 8, 9, 256, 256) == (
        2 * n_q + 2 * n_k + (2 * 1 + 2 * 9) * ee + 9 * n_q + 4 * 8 * 13 * 9)
    # One group of rows, one chunk of keys: no partials beside the chunk shares.
    assert A._bwd_scratch_floats(1, 5, 40, 32, 8, 1, 32, 32) == (
        2 * 5 * 32 + 2 * 40 * 32 + 4 * (32 * 32 + 32) + 8 * 5)
    # More groups of query rows than the short pass has blocks.
    assert A._bwd_scratch_floats(1, 2000, 8, 32, 8, 0, 32, 32) == (
        2 * 2000 * 32 + 2 * 8 * 32 + (2 * 8 + 2) * (32 * 32 + 32) + 2 * 64 * 8 * 32)
