"""Parity of the PyTorch port's image, SLIC, connectivity, Canny, region and
RAG stages with the JAX package, on the CPU.

Inputs are seeded synthetic images (smooth blobs, a texture, noise) made
with numpy; each stage gets the SAME inputs on both sides (JAX's outputs of
the previous stage), so a difference points at the stage itself. Every
assertion states its tolerance and why.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# The JAX reference runs on the CPU here, like the rest of the suite.
jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu import pipeline as J_pipeline  # noqa: E402
from camouflage_multimodal_tpu.ops.pallas_slic import pallas_slic_assign  # noqa: E402

# The JAX ``ops`` package re-exports functions under its module names
# (``ops.slic`` is the function), so take the modules themselves.
J_canny, J_conn, J_image, J_rag, J_regions, J_slic = (
    importlib.import_module(f"camouflage_multimodal_tpu.ops.{m}")
    for m in ("canny", "connectivity", "image", "rag", "regions", "slic"))
from camouflage_multimodal_tpu_torch import pipeline as T_pipeline  # noqa: E402
from camouflage_multimodal_tpu_torch.ops import connectivity as T_conn  # noqa: E402
from camouflage_multimodal_tpu_torch.ops import image as T_image  # noqa: E402
from camouflage_multimodal_tpu_torch.ops import rag as T_rag  # noqa: E402
from camouflage_multimodal_tpu_torch.ops import regions as T_regions  # noqa: E402
T_canny, T_slic = (importlib.import_module(f"camouflage_multimodal_tpu_torch.ops.{m}")
                   for m in ("canny", "slic"))   # the port's ``ops`` exports the same way

SIZE = 112
N_SEG = 80


def synthetic_images(seed: int, n: int, size: int) -> np.ndarray:
    """(n, size, size, 3) uint8: smooth colour blobs + a sine texture + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(n):
        img = np.zeros((size, size, 3)) + 0.5 * rng.random(3)
        for _ in range(6):
            cy, cx = rng.random(2)
            r = 0.05 + 0.2 * rng.random()
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
            img += blob[..., None] * (rng.random(3) - 0.3)
        f = rng.uniform(4, 20, 2)
        img += 0.08 * np.sin(2 * np.pi * (f[0] * yy + f[1] * xx))[..., None] * rng.random(3)
        img += 0.04 * rng.standard_normal(img.shape)
        out.append(np.clip(img, 0, 1))
    return (np.stack(out) * 255).round().astype(np.uint8)


@pytest.fixture(scope="module")
def images():
    """Two float32 images in [0, 1], as the pipeline makes them from uint8."""
    return synthetic_images(0, 2, SIZE).astype(np.float32) / np.float32(255.0)


@pytest.fixture(scope="module")
def jax_stages(images):
    """The JAX main path's per-stage outputs on ``images``."""
    raw, drift = jax.vmap(lambda im: J_slic.slic(
        im, n_segments=N_SEG, enforce_connectivity=False, window_radius=3,
        return_drift=True))(jnp.asarray(images))
    K = J_pipeline.padded_nodes(N_SEG, SIZE)
    seg = J_conn.enforce_label_connectivity_batched(raw, N_SEG, max_labels=K)
    gray = J_image.rgb_to_gray(jnp.asarray(images))
    edges = jax.vmap(lambda g: J_canny.canny(g, sigma=2.0))(gray)
    reg = jax.vmap(lambda im, s, e: J_regions.region_features(im, s, e, K))(
        jnp.asarray(images), seg, edges)
    adj = jax.vmap(lambda s: J_rag.region_adjacency(s, K))(seg)
    w = jax.vmap(J_rag.rag_edge_weights)(reg["features"], adj)
    out = dict(raw=raw, drift=drift, seg=seg, gray=gray, edges=edges,
               features=reg["features"], node_mask=reg["node_mask"], adj=adj, w=w)
    out = {k: np.asarray(v) for k, v in out.items()}
    out["K"] = K
    return out


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Image ops
# ---------------------------------------------------------------------------

def test_image_ops_match_jax(images):
    """gray/blur/Sobel: 1e-5 abs (summation order differs: XLA fuses the
    3-term dot into FMAs and orders its convolution sums its own way, a few
    float32 ulps on values ≤ ~4). Lab: 1e-4 abs (torch has no cbrt; pow(t,
    1/3) is a few ulps off jnp.cbrt, scaled by up to 500 in a/b)."""
    img = images[0]
    gray = np.asarray(J_image.rgb_to_gray(jnp.asarray(img)))
    np.testing.assert_allclose(T_image.rgb_to_gray(t(img)).numpy(), gray, atol=1e-5, rtol=0)
    np.testing.assert_allclose(T_image.rgb_to_lab(t(img)).numpy(),
                               np.asarray(J_image.rgb_to_lab(jnp.asarray(img))),
                               atol=1e-4, rtol=0)
    for sigma, mode in ((1.0, "reflect"), (2.0, "constant"), (1.5, "reflect")):
        np.testing.assert_allclose(
            T_image.gaussian_blur(t(gray), sigma, mode).numpy(),
            np.asarray(J_image.gaussian_blur(jnp.asarray(gray), sigma, mode)),
            atol=1e-5, rtol=0, err_msg=f"{sigma} {mode}")
    np.testing.assert_allclose(
        T_image.gaussian_blur(t(img), 1.0, channels_last=True).numpy(),
        np.asarray(J_image.gaussian_blur(jnp.asarray(img), 1.0)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(T_image.sobel_h(t(gray)).numpy(),
                               np.asarray(J_image.sobel_h(jnp.asarray(gray))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(T_image.sobel_v(t(gray)).numpy(),
                               np.asarray(J_image.sobel_v(jnp.asarray(gray))),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Kernel B1's plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _pallas_assign(pix, centers, prev, ratio, step):
    """The JAX package's Pallas assign, as ``slic(backend="pallas")`` calls it."""
    s = np.sqrt(ratio)
    scale = jnp.asarray([1, 1, 1, s, s], jnp.float32)
    p = jnp.asarray(pix)
    c = jnp.asarray(centers)
    return np.asarray(pallas_slic_assign(
        p * scale, c * scale, p[:, 3].astype(jnp.int32), p[:, 4].astype(jnp.int32),
        c[:, 3], c[:, 4], step, jnp.asarray(prev), interpret=True))


def test_slic_assign_plain_bit_equal_on_integer_features():
    """Integer-valued features with ratio 1: both distance formulations are
    exact in float32, so labels must be bit-equal (including the lowest-id
    tie rule and the uncovered-pixel fallback to ``prev``)."""
    rng = np.random.default_rng(1)
    H = W = 48
    step = 8
    yy, xx = np.mgrid[0:H, 0:W]
    pix = np.concatenate([rng.integers(0, 60, (H, W, 3)), yy[..., None], xx[..., None]],
                         -1).reshape(-1, 5).astype(np.float32)
    sy, sx = np.meshgrid(np.arange(4, H, step), np.arange(4, W, step), indexing="ij")
    K = sy.size
    centers = np.concatenate([rng.integers(0, 60, (K, 3)),
                              (sy.reshape(-1, 1) + rng.integers(-6, 7, (K, 1))),
                              (sx.reshape(-1, 1) + rng.integers(-6, 7, (K, 1)))],
                             -1).astype(np.float32)
    centers[:3, 3:] = [[200, 200]] * 3          # far-away centers cover nothing
    prev = rng.integers(0, K, H * W).astype(np.int32)
    want = _pallas_assign(pix, centers, prev, 1.0, step)
    got = T_slic.slic_assign(t(pix)[None], t(centers)[None], t(prev)[None], 1.0, step)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_slic_assign_plain_matches_pallas_on_real_state(images):
    """Real SLIC state (Lab features, centers after 3 iterations): the
    Pallas kernel's ‖c‖²−2p·c expansion cancels in float32 where the plain
    version takes direct differences, so near-ties may flip: ≥ 99.9 % equal."""
    pix, centers, step, ratio = T_slic.slic_features(t(images), N_SEG)
    labels = torch.zeros(pix.shape[:2], dtype=torch.int32)
    for _ in range(3):
        labels = T_slic.slic_assign(pix, centers, labels, ratio, step)
        centers = T_slic.update_centers(pix, labels, centers)
    for b in range(pix.shape[0]):
        want = _pallas_assign(pix[b].numpy(), centers[b].numpy(), labels[b].numpy(),
                              ratio, step)
        got = T_slic.slic_assign(pix[b:b + 1], centers[b:b + 1], labels[b:b + 1],
                                 ratio, step)[0].numpy()
        assert (got == want).mean() >= 0.999


def test_slic_matches_jax_windowed(images, jax_stages):
    """Port SLIC (all-K sweep) vs the JAX main path's 7×7 window: equal
    while the drift ratio < 1, up to center-update summation order — the
    repo's own bar, ≥ 99.5 % of raw labels (tests/test_pallas.py:72). The
    drift ratio is a max of float32 center moves: 1e-4 abs."""
    raw, drift = T_slic.slic(t(images), n_segments=N_SEG, backend="exact",
                             enforce_connectivity=False, return_drift=True, window_radius=3)
    assert raw.shape == jax_stages["raw"].shape
    assert (raw.numpy() == jax_stages["raw"]).mean() >= 0.995
    assert (jax_stages["drift"] < 1).all()
    np.testing.assert_allclose(drift.numpy(), jax_stages["drift"], atol=1e-4, rtol=0)


def test_slic_grid_helpers_match_jax():
    for n, h, w in ((500, 256, 256), (80, 112, 112), (64, 96, 128), (500, 352, 352)):
        assert T_slic.grid_shape(n, h, w) == J_slic.grid_shape(n, h, w)
        step = T_slic.slic_step(n, h, w)
        for r in (2, 3):
            assert T_slic.window_drift_bound(step, r) == J_slic.window_drift_bound(step, r)
        assert T_pipeline.padded_nodes(n, h) == J_pipeline.padded_nodes(n, h)


# ---------------------------------------------------------------------------
# Connectivity, Canny, regions, RAG, paint-back: same inputs on both sides
# ---------------------------------------------------------------------------

def test_connectivity_bit_identical(jax_stages):
    """Integer algorithm: bit-identical to the JAX batched path."""
    got = T_conn.enforce_label_connectivity(t(jax_stages["raw"]), N_SEG,
                                            max_labels=jax_stages["K"])
    np.testing.assert_array_equal(got.numpy(), jax_stages["seg"])


def test_connectivity_fragments_and_clamps(jax_stages):
    """Fragment-heavy maps (3 % of pixels salted with random labels, ~475
    raw components per image), also under a tight ``max_labels`` and with
    18 segments, whose 288-entry component table overflows: bit-identical
    to the JAX per-pixel path."""
    rng = np.random.default_rng(2)
    raw = jax_stages["raw"].copy()
    salt = rng.random(raw.shape) < 0.03
    raw[salt] = rng.integers(0, raw.max() + 1, salt.sum())
    for n_seg, max_labels in ((N_SEG, None), (N_SEG, 40), (18, None)):
        want = np.stack([np.asarray(J_conn.enforce_label_connectivity(
            jnp.asarray(r), n_seg, max_labels=max_labels)) for r in raw])
        got = T_conn.enforce_label_connectivity(t(raw), n_seg, max_labels=max_labels)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{n_seg} {max_labels}")


def _engineered_map(name: str) -> np.ndarray:
    """Worst cases of ``tests/test_connectivity_gate.py``."""
    if name == "checker":        # one component per pixel: bucket overflow
        yy, xx = np.mgrid[:48, :48]
        return (yy + xx) % 2
    if name == "rows":           # 64 single-row stripes, 8 wide
        return np.mgrid[:64, :8][0] % 2
    yy, xx = np.mgrid[:32, :32]  # quadrants with a 1-px checker corner
    base = (yy >= 16) * 2 + (xx >= 16)
    base[:8, :8] = np.indices((8, 8)).sum(0) % 2 + 4
    return base


@pytest.mark.parametrize("name,n_seg,max_labels", [
    ("checker", 4, None),        # 2,304 components into a 64-entry table
    ("checker", 200, None),      # table of 2,304: no clamp, min_size 6
    ("rows", 1, 64),             # 64 components into 16 entries
    ("quadrants", 2, 64),        # ~70 components into 32 entries
])
def test_connectivity_engineered_maps(name, n_seg, max_labels):
    """Engineered maps where the compact table (16·n_segments) overflows or
    every fragment merges: bit-identical to the JAX per-pixel path."""
    lab = _engineered_map(name).astype(np.int32)
    want = J_conn.enforce_label_connectivity(jnp.asarray(lab), n_seg,
                                             max_labels=max_labels)
    got = T_conn.enforce_label_connectivity(t(lab)[None], n_seg, max_labels=max_labels)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_canny_on_same_gray(jax_stages):
    """Same gray image in: the blur's float32 sums run in another order
    than XLA's, which can flip a pixel sitting exactly on an NMS or
    threshold tie; allowed ≤ 0.1 % of pixels (0 on these images today)."""
    got = T_canny.canny(t(jax_stages["gray"]), sigma=2.0).numpy()
    assert got.dtype == np.bool_
    assert (got != jax_stages["edges"]).mean() <= 1e-3


STD_FEATURES = [3, 4, 5, 7]


def assert_features_close(got: np.ndarray, want: np.ndarray, atol: float = 1e-5):
    """Region features at ``atol`` abs. The four std features (3-5, 7) are
    sqrt(E[x²] − E[x]²): float32 segment sums carry ~1e-6 relative error on
    BOTH sides (the JAX one-hot matmul and the port's index_add_ add in
    different orders), and the square root amplifies it by 1/(2·std) to
    ~2e-5 at std ≈ 0.05. They are compared as variances (their squares),
    the well-conditioned quantity, at the same ``atol``."""
    other = [i for i in range(got.shape[-1]) if i not in STD_FEATURES]
    np.testing.assert_allclose(got[..., other], want[..., other], atol=atol, rtol=0)
    np.testing.assert_allclose(got[..., STD_FEATURES] ** 2, want[..., STD_FEATURES] ** 2,
                               atol=atol, rtol=0)


def test_region_features_match_jax(images, jax_stages):
    """Same image, segments and edges: 1e-5 abs (see
    :func:`assert_features_close`), node mask exact; also the reference's
    hard-coded /256 normalization."""
    reg = T_regions.region_features(t(images), t(jax_stages["seg"]),
                                    t(jax_stages["edges"]), jax_stages["K"])
    np.testing.assert_array_equal(reg["node_mask"].numpy(), jax_stages["node_mask"])
    assert_features_close(reg["features"].numpy(), jax_stages["features"])
    compat = T_regions.region_features(t(images), t(jax_stages["seg"]),
                                       t(jax_stages["edges"]), jax_stages["K"],
                                       norm_size=256)
    want = np.asarray(jax.vmap(lambda im, s, e: J_regions.region_features(
        im, s, e, jax_stages["K"], norm_size=256)["features"])(
        jnp.asarray(images), jnp.asarray(jax_stages["seg"]),
        jnp.asarray(jax_stages["edges"])))
    assert_features_close(compat["features"].numpy(), want)


@pytest.mark.parametrize("rows,channels,bins", [(65536 * 2, 17, 2 * 641), (4096, 6, 529 * 4),
                                                 (1000, 3, 7)])
def test_index_sum_sorted_equals_index_add(rows, channels, bins):
    """The card's fixed-order segment sum (stable sort + ``segment_reduce``)
    run here on the CPU: equal to ``index_add_`` to the bit (both add a
    bin's rows in row order), empty bins 0, and within float32 rounding of
    ``jax.ops.segment_sum``."""
    rng = np.random.default_rng(rows)
    vals = rng.standard_normal((rows, channels)).astype(np.float32)
    idx = rng.integers(0, bins - 1, rows)            # the last bin stays empty
    got = T_regions.index_sum_sorted(t(vals), t(idx), bins)
    want = T_regions.index_sum(t(vals), t(idx), bins)
    assert torch.equal(got, want) and not got[-1].any()
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(idx), bins))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-5)


def test_adjacency_and_rag_weights(jax_stages):
    """Adjacency is a boolean function of the labels: exact. Weights from
    the same features: 1e-5 abs (exp/sqrt ulps)."""
    adj = T_rag.region_adjacency(t(jax_stages["seg"]), jax_stages["K"])
    np.testing.assert_array_equal(adj.numpy(), jax_stages["adj"])
    w = T_rag.rag_edge_weights(t(jax_stages["features"]), t(jax_stages["adj"]))
    np.testing.assert_allclose(w.numpy(), jax_stages["w"], atol=1e-5, rtol=0)


def test_adjacency_drops_out_of_range_labels():
    seg = np.array([[0, 1, 7], [2, 1, 7]], np.int32)
    want = np.asarray(J_rag.region_adjacency(jnp.asarray(seg), 4))
    got = T_rag.region_adjacency(t(seg)[None], 4)[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mapping", ["corrected", "verbatim"])
def test_paint_segments(jax_stages, mapping):
    """A gather: exact in both mappings."""
    rng = np.random.default_rng(3)
    vals = rng.random((2, jax_stages["K"])).astype(np.float32)
    want = np.asarray(J_pipeline.paint_segments(jnp.asarray(vals),
                                                jnp.asarray(jax_stages["seg"]), mapping))
    got = T_pipeline.paint_segments(t(vals), t(jax_stages["seg"]), mapping)
    np.testing.assert_array_equal(got.numpy(), want)
