"""What the designs of the port's CUDA kernels B1 and B2 rest on, checked in
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
"""

import numpy as np
import pytest
import torch

from camouflage_multimodal_tpu_torch import api
from camouflage_multimodal_tpu_torch.ops import attention as A
from camouflage_multimodal_tpu_torch.ops import slic as S

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
