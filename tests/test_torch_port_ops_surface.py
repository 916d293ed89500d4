"""The PyTorch port's ``ops`` package at the JAX ``ops`` package's full
contract, on the CPU: image ops with every border mode and truncation,
both dilations, Canny's thresholds, the connectivity pass and its
telemetry, and ``slic`` with both backends and every parameter.

Inputs are seeded with numpy and go through the JAX function and the
port's. Every assertion states its tolerance and why. ``ops.slic`` and
``ops.canny`` are functions in both packages (their ``__init__`` exports),
so the modules are taken with ``importlib``.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from test_torch_port_pipeline import few_threads, synthetic_images  # noqa: E402,F401

J_ops, J_canny, J_conn, J_image, J_morph, J_slic = (
    importlib.import_module(f"camouflage_multimodal_tpu.ops{m}")
    for m in ("", ".canny", ".connectivity", ".image", ".morphology", ".slic"))
T_ops, T_canny, T_conn, T_image, T_morph, T_slic = (
    importlib.import_module(f"camouflage_multimodal_tpu_torch.ops{m}")
    for m in ("", ".canny", ".connectivity", ".image", ".morphology", ".slic"))

pytestmark = pytest.mark.usefixtures("few_threads")

SIZE = 64
N_SEG = 40


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def images():
    """Two float32 64² images in [0, 1], as the pipeline makes them."""
    return synthetic_images(0, 2, SIZE).astype(np.float32) / np.float32(255.0)


@pytest.fixture(scope="module")
def gray(images):
    return np.asarray(J_image.rgb_to_gray(jnp.asarray(images[0])))


# ---------------------------------------------------------------------------
# Image ops, morphology, Canny
# ---------------------------------------------------------------------------

def test_imagenet_normalize_round_trip(images):
    """Elementwise: 1e-6 abs (a subtraction and a division per value, both
    sides in float32; values ≤ ~2.7)."""
    img = images[0]
    want = np.asarray(J_image.imagenet_normalize(jnp.asarray(img)))
    got = T_image.imagenet_normalize(t(img))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    back = np.asarray(J_image.imagenet_denormalize(jnp.asarray(want * 1.5)))
    np.testing.assert_allclose(T_image.imagenet_denormalize(t(want * 1.5)).numpy(), back,
                               atol=1e-6, rtol=0)
    assert back.min() == 0.0 and back.max() == 1.0      # the clip engaged


@pytest.mark.parametrize("truncate", [2.0, 3.0, 4.0])
def test_gaussian_blur_truncate_and_modes(gray, images, truncate):
    """Blur at each truncation in each border mode: 1e-5 abs (the sums run
    in another order than XLA's convolution, a few float32 ulps on values
    ≤ 1). The radius is ``int(truncate·σ + 0.5)`` on both sides."""
    for sigma, mode in ((1.0, "reflect"), (2.0, "nearest"), (1.5, "constant"), (1.0, "mirror")):
        np.testing.assert_allclose(
            T_image.gaussian_blur(t(gray), sigma, mode, truncate).numpy(),
            np.asarray(J_image.gaussian_blur(jnp.asarray(gray), sigma, mode, truncate)),
            atol=1e-5, rtol=0, err_msg=f"{sigma} {mode}")
        assert T_image.blur_radius(sigma, truncate) == int(truncate * sigma + 0.5)
    np.testing.assert_allclose(
        T_image.gaussian_blur(t(images[0]), 1.0, "nearest", truncate, channels_last=True).numpy(),
        np.asarray(J_image.gaussian_blur(jnp.asarray(images[0]), 1.0, "nearest", truncate)),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["reflect", "nearest", "constant", "mirror"])
def test_sobel_modes(gray, mode):
    """Both derivatives in each border mode: 1e-5 abs (as the blur)."""
    for name in ("sobel_h", "sobel_v"):
        np.testing.assert_allclose(
            getattr(T_image, name)(t(gray), mode=mode).numpy(),
            np.asarray(getattr(J_image, name)(jnp.asarray(gray), mode=mode)),
            atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_dilations(iterations):
    """Boolean maps: bit-equal, the 4- and 8-connected dilations."""
    rng = np.random.default_rng(iterations)
    mask = rng.random((2, 48, 56)) < 0.03
    for name in ("binary_dilation_cross", "binary_dilation_full"):
        want = np.stack([np.asarray(getattr(J_morph, name)(jnp.asarray(m), iterations))
                         for m in mask])
        got = getattr(T_morph, name)(t(mask), iterations=iterations).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("low,high", [(0.05, 0.15), (0.2, 0.4)])
def test_canny_thresholds(gray, low, high):
    """Non-default thresholds on a contrast-stretched image (edges above
    both): at most 0.1 % of pixels differ (a pixel on an NMS or threshold
    tie may flip with the blur's summation order), and the thresholds
    change the map."""
    img = np.clip(0.5 + 4.0 * (gray - gray.mean()), 0.0, 1.0).astype(np.float32)
    want = np.asarray(J_canny.canny(jnp.asarray(img), 2.0, low, high))
    got = T_canny.canny(t(img), 2.0, low, high).numpy()
    assert want.any() and (got != want).mean() <= 1e-3
    assert (got != T_canny.canny(t(img), 2.0).numpy()).any()


# ---------------------------------------------------------------------------
# Connectivity: the one path, held against both of JAX's
# ---------------------------------------------------------------------------

def _salted(seed: int, frac: float = 0.03) -> np.ndarray:
    """(2, 64, 64) raw SLIC maps of the JAX windowed path, a fraction of the
    pixels salted with random labels (fragment-heavy maps)."""
    imgs = synthetic_images(seed, 2, SIZE).astype(np.float32) / np.float32(255.0)
    raw = np.array(jax.vmap(lambda im: J_slic.slic(
        im, n_segments=N_SEG, enforce_connectivity=False))(jnp.asarray(imgs)))
    rng = np.random.default_rng(seed)
    salt = rng.random(raw.shape) < frac
    raw[salt] = rng.integers(0, raw.max() + 1, salt.sum())
    return raw


def _connectivity_case(name: str):
    """(labels (B, H, W) int32, n_segments, keyword arguments) of the
    equality cases: tests/test_connectivity_gate.py's engineered maps, the
    checkerboard, salted raw maps and a map that trips the packing guard."""
    if name.startswith("stripes"):           # 8 runs a row, 64 in all
        return (np.mgrid[:8, :16][1] // 2 % 2)[None], 4, dict(
            max_labels=64, run_bucket=int(name.split("_")[1]))
    if name == "rows":                       # 64 components into 16 entries
        return (np.mgrid[:64, :8][0] % 2)[None], 4, dict(
            max_labels=64, run_bucket=128, max_components=16)
    if name == "quadrants":                  # ~70 components into 32 entries
        base = (np.mgrid[:32, :32][0] >= 16) * 2 + (np.mgrid[:32, :32][1] >= 16)
        base[:8, :8] = np.indices((8, 8)).sum(0) % 2 + 4
        return base[None], 4, dict(max_labels=64, run_bucket=512, max_components=32)
    if name == "checker":                    # one component a pixel, runs = HW
        yy, xx = np.mgrid[:48, :48]
        return ((yy + xx) % 2)[None], 4, dict(run_bucket=48 * 48)
    if name == "checker_bucket":             # the same under the default bucket: falls back
        yy, xx = np.mgrid[:48, :48]
        return ((yy + xx) % 2)[None], 200, {}
    if name == "salted":
        return _salted(5), N_SEG, dict(max_labels=64)
    if name == "salted_tight":               # a 90-entry table: C overflows
        return _salted(6, 0.05), N_SEG, dict(max_components=90, max_labels=40)
    if name == "raw":
        return _salted(7, 0.0), N_SEG, {}
    # 64 × 2048 at 8,192 segments: C = 131,072 needs 18 bits, and
    # 2048 << 20 reaches 2**31, so JAX's int32 packing guard takes the
    # per-pixel path.
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[:64, :2048]
    lab = (yy // 4) * 512 + xx // 4
    salt = rng.random(lab.shape) < 0.02
    lab[salt] = rng.integers(0, lab.max() + 1, salt.sum())
    return lab[None], 8192, {}


CONNECTIVITY_CASES = ["stripes_64", "stripes_63", "stripes_8", "rows", "quadrants",
                      "checker", "checker_bucket", "salted", "salted_tight", "raw",
                      "packing_guard"]


@pytest.mark.parametrize("name", CONNECTIVITY_CASES)
def test_connectivity_paths_bit_equal(name):
    """Integer algorithm: the port's ``enforce_label_connectivity`` equals
    JAX's ``enforce_label_connectivity_batched(..., return_fallback=True)``
    in labels, bit for bit, whichever of its two paths JAX takes (its flag,
    asserted where the case is built to pick one)."""
    labels, n_seg, kw = _connectivity_case(name)
    labels = labels.astype(np.int32)
    want, want_fb = J_conn.enforce_label_connectivity_batched(
        jnp.asarray(labels), n_seg, return_fallback=True, **kw)
    pixel_kw = {k: v for k, v in kw.items() if k != "run_bucket"}
    got = T_conn.enforce_label_connectivity(t(labels), n_seg, **pixel_kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    expected_fb = {"stripes_64": False, "stripes_63": True, "stripes_8": True,
                   "rows": False, "quadrants": False, "checker": False,
                   "checker_bucket": True, "packing_guard": True}
    if name in expected_fb:
        assert bool(want_fb) == expected_fb[name]


@pytest.mark.parametrize("shape,n_seg,max_components", [
    ((1, 1 << 15, 1 << 15), 4, None),      # H·W = 2**30 pixels
    ((1, 1 << 12, 1 << 12), 4, 1 << 24)])  # a 2**24-entry compact table
def test_connectivity_refuses_what_int32_cannot_pack(shape, n_seg, max_components):
    """The port keeps the JAX formulation's int32 bounds: H·W < 2**30 and
    C < 2**24, else ``ValueError`` before any work. The maps are a 1×1 map
    expanded with zero strides, so nothing of their size is allocated."""
    labels = torch.zeros(1, 1, 1, dtype=torch.int32).expand(*shape)
    with pytest.raises(ValueError, match="int32 packing"):
        T_conn.enforce_label_connectivity(labels, n_seg, max_components=max_components)


def _corner_map() -> np.ndarray:
    """A map that needs two merge rounds: a small block in the corner (the
    lowest id, no large contact, no smaller-id neighbour) stays in round 1,
    while the small L-shape around it joins the large background; round 2
    merges the block into the background it now touches."""
    lab = np.full((48, 48), 2)
    lab[:2, :4] = 0
    lab[:3, 4] = 1
    lab[2, :4] = 1
    return lab


@pytest.mark.parametrize("min_size_factor,max_components", [
    (0.25, None), (1.0, None), (0.5, 64), (1.0, 30)])
def test_connectivity_telemetry(min_size_factor, max_components):
    """``min_size_factor``, ``max_components`` and the three counts
    (survivors, merge rounds, raw components), per image: equal to the JAX
    per-pixel path's. The batch holds a salted map, a checkerboard (2,304
    raw components) and a map that needs two rounds, so each image's rounds
    are its own."""
    salted = _salted(8)[:1, :48, :48]
    yy, xx = np.mgrid[:48, :48]
    batch = np.concatenate([salted, ((yy + xx) % 2)[None], _corner_map()[None]])
    batch = batch.astype(np.int32)
    kw = dict(min_size_factor=min_size_factor, max_components=max_components, max_labels=50)
    flags = dict(return_count=True, return_rounds=True, return_raw_count=True)
    want = [jax.device_get(J_conn.enforce_label_connectivity(jnp.asarray(m), 12, **kw, **flags))
            for m in batch]
    out, count, rounds, raw = T_conn.enforce_label_connectivity(t(batch), 12, **kw, **flags)
    np.testing.assert_array_equal(out.numpy(), np.stack([w[0] for w in want]))
    for got, i in ((count, 1), (rounds, 2), (raw, 3)):
        assert got.dtype == torch.int64 and got.shape == (3,)
        np.testing.assert_array_equal(got.numpy(), [int(w[i]) for w in want])
    assert [int(w[2]) for w in want][::2] == [1, 2]     # the images' own rounds


# ---------------------------------------------------------------------------
# SLIC: the windowed and exact backends
# ---------------------------------------------------------------------------

def _jax_slic(images, **kw):
    fn = lambda im: J_slic.slic(im, enforce_connectivity=False, return_drift=True, **kw)  # noqa: E731
    if images.ndim == 3:
        raw, drift = fn(jnp.asarray(images))
    else:
        raw, drift = jax.vmap(fn)(jnp.asarray(images))
    return np.asarray(raw), np.asarray(drift)


@pytest.mark.parametrize("kw", [
    dict(window_radius=2, compactness=5.0),
    dict(window_radius=3, compactness=20.0),
    dict(window_radius=2, sigma=0.0),
    dict(window_radius=3, convert_lab=False),
], ids=["r2_c5", "r3_c20", "sigma0", "rgb"])
def test_slic_window_matches_jax_xla(images, kw):
    """``backend="window"`` vs JAX ``"xla"``, batched and single: raw labels
    ≥ 99.5 % equal (the repo's bar: the one-hot moment products add in
    another order than XLA's, so a center may move by an ulp and flip a
    near-tie), drift within 1e-4 (a max of float32 center moves)."""
    want, want_d = _jax_slic(images, n_segments=N_SEG, **kw)
    got, drift = T_slic.slic(t(images), n_segments=N_SEG, backend="window",
                             enforce_connectivity=False, return_drift=True, **kw)
    assert got.shape == want.shape and got.dtype == torch.int64 and drift.shape == (2,)
    assert (got.numpy() == want).mean() >= 0.995
    np.testing.assert_allclose(drift.numpy(), want_d, atol=1e-4, rtol=0)
    single, single_d = T_slic.slic(t(images[1]), n_segments=N_SEG, enforce_connectivity=False,
                                   return_drift=True, **kw)
    assert single.shape == (SIZE, SIZE) and single_d.shape == ()
    assert (single.numpy() == want[1]).mean() >= 0.995


def test_slic_window_ragged_bands():
    """A ragged 97 × 131 image at 60 segments (step 15: the trailing row
    band folds into the last seed row, the update's band folding), both
    radii: raw labels ≥ 99.5 % equal to JAX ``"xla"``, drift within 1e-4."""
    img = synthetic_images(3, 1, 131)[0, :97].astype(np.float32) / np.float32(255.0)
    step = T_slic.slic_step(60, 97, 131)
    assert -(-97 // step) > T_slic.grid_shape(60, 97, 131)[0]
    for r in (2, 3):
        want, want_d = _jax_slic(img, n_segments=60, window_radius=r)
        got, drift = T_slic.slic(t(img), n_segments=60, enforce_connectivity=False,
                                 return_drift=True, window_radius=r)
        assert (got.numpy() == want).mean() >= 0.995
        np.testing.assert_allclose(float(drift), float(want_d), atol=1e-4, rtol=0)


def _mosaic(seed: int, size: int = SIZE, cells: int = 40) -> np.ndarray:
    """A Voronoi mosaic of flat random colours with faint noise: its centers
    drift far from their seeds."""
    rng = np.random.default_rng(seed)
    pts = rng.random((cells, 2)) * size
    yy, xx = np.mgrid[:size, :size]
    d = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
    img = rng.random((cells, 3))[d.argmin(-1)] + 0.02 * rng.standard_normal((size, size, 3))
    return np.clip(img, 0, 1).astype(np.float32)


def test_slic_debug_window_check_raises_on_drift():
    """A seeded mosaic whose drift ratio at radius 2 is ≥ 1: both packages
    report the same ratio (1e-4) and both ``debug_window_check`` raise;
    at radius 3 the ratio is below 1 and neither raises. ``"exact"`` never
    checks."""
    img = _mosaic(150)
    _, want_d = _jax_slic(img, n_segments=N_SEG, compactness=1.0)
    _, drift = T_slic.slic(t(img), n_segments=N_SEG, compactness=1.0,
                           enforce_connectivity=False, return_drift=True)
    assert float(want_d) >= 1.0
    np.testing.assert_allclose(float(drift), float(want_d), atol=1e-4, rtol=0)
    with pytest.raises(RuntimeError, match="center drift"):
        J_slic.slic(jnp.asarray(img), n_segments=N_SEG, compactness=1.0,
                    debug_window_check=True)
    with pytest.raises(RuntimeError, match="center drift"):
        T_slic.slic(t(img), n_segments=N_SEG, compactness=1.0, debug_window_check=True)
    r3 = T_slic.slic(t(img), n_segments=N_SEG, compactness=1.0, window_radius=3,
                     debug_window_check=True, return_drift=True)[1]
    assert float(r3) < 1.0
    T_slic.slic(t(img), n_segments=N_SEG, compactness=1.0, backend="exact",
                debug_window_check=True)


@pytest.mark.parametrize("caller_tf32", [True, False])
def test_windowed_update_scopes_float32(images, caller_tf32, monkeypatch):
    """The windowed update's moment product runs with TF32 off, and the
    caller's matmul setting is the same after ``slic`` as before it."""
    seen = []
    einsum = torch.einsum

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return einsum(*args)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", caller_tf32)
    monkeypatch.setattr(torch, "einsum", spy)
    T_slic.slic(t(images), n_segments=N_SEG, num_iters=2, backend="window",
                enforce_connectivity=False)
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32 == caller_tf32


def test_slic_argument_errors(images):
    """``window_radius < 2`` on the windowed path raises in both packages;
    an unknown backend names both pairs of names; the windowed path refuses
    a ``row_group``."""
    with pytest.raises(ValueError, match="window_radius"):
        J_slic.slic(jnp.asarray(images[0]), n_segments=N_SEG, window_radius=1)
    with pytest.raises(ValueError, match="window_radius"):
        T_slic.slic(t(images[0]), n_segments=N_SEG, window_radius=1)
    with pytest.raises(ValueError, match="'xla'.*'exact'.*'pallas'"):
        T_slic.slic(t(images[0]), n_segments=N_SEG, backend="xla")
    with pytest.raises(ValueError, match="backend='exact'"):
        T_slic.slic(t(images[0]), n_segments=N_SEG, row_group=object())


def test_slic_exact_matches_jax_xla(images):
    """``backend="exact"`` (B1's plain version here) vs JAX ``"xla"`` at
    radius 3, where the drift ratio stays below 1 and the window equals the
    all-K sweep: raw labels ≥ 99.5 % equal, drift within 1e-4."""
    want, want_d = _jax_slic(images, n_segments=N_SEG, window_radius=3)
    assert (want_d < 1).all()
    got, drift = T_slic.slic(t(images), n_segments=N_SEG, backend="exact",
                             enforce_connectivity=False, return_drift=True, window_radius=3)
    assert (got.numpy() == want).mean() >= 0.995
    np.testing.assert_allclose(drift.numpy(), want_d, atol=1e-4, rtol=0)


@pytest.mark.parametrize("backend", ["window", "exact"])
def test_slic_connectivity_composition(images, backend):
    """``enforce_connectivity=True`` is ``enforce_label_connectivity`` on
    the port's own raw map, bit for bit; ``max_labels`` clamps."""
    raw = T_slic.slic(t(images), n_segments=N_SEG, backend=backend,
                      enforce_connectivity=False)
    for max_labels in (None, 20):
        seg = T_slic.slic(t(images), n_segments=N_SEG, backend=backend,
                          max_labels=max_labels)
        want = T_conn.enforce_label_connectivity(raw, N_SEG, max_labels=max_labels)
        np.testing.assert_array_equal(seg.numpy(), want.numpy())
    assert int(seg.max()) <= 19


def test_slic_composed_matches_jax(images):
    """The whole default ``slic`` (windowed, connectivity on) against JAX's
    on the image whose raw maps agree everywhere: labels bit-equal (the
    sequential relabel shifts every later id after one differing raw
    label, so composed maps are held only where the raw maps are equal)."""
    want_raw, _ = _jax_slic(images, n_segments=N_SEG)
    got_raw = T_slic.slic(t(images), n_segments=N_SEG, enforce_connectivity=False).numpy()
    same = [b for b in range(2) if (want_raw[b] == got_raw[b]).all()]
    assert same
    want = np.asarray(jax.vmap(lambda im: J_slic.slic(im, n_segments=N_SEG))(
        jnp.asarray(images)))
    got = T_slic.slic(t(images), n_segments=N_SEG).numpy()
    np.testing.assert_array_equal(got[same], want[same])


# ---------------------------------------------------------------------------
# Exports and signatures
# ---------------------------------------------------------------------------

# Parameters the port adds: its batch/sharding options and the
# connectivity entry point's ``row_group``.
PORT_ONLY = {"row_group", "channels_last"}


def _params(fn):
    return {n: p.default for n, p in inspect.signature(fn).parameters.items()}


def test_ops_exports_every_jax_name():
    """Every name of the JAX ``ops`` package is exported by the port's, with
    JAX's parameters and defaults (the backend names map as the port's
    docstring says), and the connectivity entry point with its own."""
    names = [n for n in dir(J_ops) if not n.startswith("_") and callable(getattr(J_ops, n))]
    assert len(names) == 13
    pairs = [(getattr(J_ops, n), getattr(T_ops, n)) for n in names]
    pairs += [(J_conn.enforce_label_connectivity, T_conn.enforce_label_connectivity)]
    for j_fn, t_fn in pairs:
        want, got = _params(j_fn), _params(t_fn)
        name = j_fn.__name__
        for extra in set(got) - set(want):
            assert extra in PORT_ONLY, (name, extra)
        for p, default in want.items():
            assert p in got, (name, p)
            if name == "slic" and p == "backend":
                assert T_slic.BACKENDS[got[p]] == default
            elif default is not inspect.Parameter.empty:
                assert got[p] == default, (name, p)
    assert set(T_slic.BACKENDS) == {"window", "exact"}
