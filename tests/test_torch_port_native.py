"""The port's native host data path (``camouflage_multimodal_tpu_torch.native``)
on the CPU: the threaded decoder and the CPU graph builder, built from the
port's own sources.

Inputs are seeded numpy scenes written here as JPEG and PNG at small
sizes; no model runs except in the one directory walk. Bars: decoded bytes
and floats equal to the bit to PIL and to the JAX package's ``native``
module (where it builds), the draft decode equal to the bit to the JAX
draft decode; ``build_region_graph`` equal to the JAX one (segments, Canny
and node mask equal, features and edge weights within 1e-5), and against
the port's CPU ops at tests/test_native_graph.py's bars (SLIC agreement
> 0.97, Canny IoU > 0.95, features within rtol 5e-3 / atol 5e-4 on the
same segmentation, RAG weights within rtol 5e-3 / atol 1e-4 where both
are nonzero). The walk's reports with native and with PIL decode equal.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu import native as J_native  # noqa: E402
from camouflage_multimodal_tpu_torch import api as T_api  # noqa: E402
from camouflage_multimodal_tpu_torch import bench as T_bench  # noqa: E402
from camouflage_multimodal_tpu_torch import native  # noqa: E402
from camouflage_multimodal_tpu_torch.data import cod10k as T_cod10k  # noqa: E402
from camouflage_multimodal_tpu_torch.ops.canny import canny  # noqa: E402
from camouflage_multimodal_tpu_torch.ops.image import rgb_to_gray  # noqa: E402
from camouflage_multimodal_tpu_torch.ops.rag import rag_edge_weights, region_adjacency  # noqa: E402
from camouflage_multimodal_tpu_torch.ops.regions import region_features  # noqa: E402
from camouflage_multimodal_tpu_torch.pipeline import build_region_graphs  # noqa: E402
from test_torch_port_pipeline import ARTIFACTS, few_threads, synthetic_images  # noqa: E402,F401
from test_torch_port_walks import _write_dataset  # noqa: E402

pytestmark = pytest.mark.usefixtures("few_threads")

SIZES = (24, 64, 100)          # down, down and up from the files' 48-90 px sides


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded scenes: RGB JPEGs at two qualities, a gray JPEG, RGB and gray
    PNGs of other shapes, and a file that is not an image."""
    from PIL import Image

    root = tmp_path_factory.mktemp("native")
    scenes = synthetic_images(5, 6, 90)
    out = {"jpg": [], "png": [], "gray": [], "broken": str(root / "broken.jpg")}
    for i, img in enumerate(scenes):
        crop = img[: 60 + 5 * i, : 48 + 7 * i]
        p = str(root / f"rgb_{i}.jpg")
        Image.fromarray(crop).save(p, quality=75 + 4 * i)
        out["jpg"].append(p)
        p = str(root / f"rgb_{i}.png")
        Image.fromarray(img[: 50 + 6 * i]).save(p)
        out["png"].append(p)
        p = str(root / f"gray_{i}.{'jpg' if i % 2 else 'png'}")
        Image.fromarray(crop[..., 1]).save(p)
        out["gray"].append(p)
    with open(out["broken"], "wb") as f:
        f.write(b"not an image")
    return out


def _jax_native():
    if not J_native.available():
        pytest.skip("the JAX package's native library does not build here")
    return J_native


@pytest.mark.parametrize("size", SIZES)
def test_load_batch_u8_equals_pil(files, size):
    paths = files["jpg"] + files["png"] + files["gray"]
    got, ok = native.load_batch_u8(paths, size)
    assert ok.all() and got.dtype == np.uint8 and got.shape == (len(paths), size, size, 3)
    want = np.stack([T_cod10k.load_image_u8(p, size) for p in paths])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gray", [False, True])
def test_load_batch_and_load_image_equal_pil(files, gray):
    """Floats in [0, 1]: RGB against ``load_image_rgb`` on every file, gray
    against ``load_mask`` on the single-channel files (the GT maps' kind);
    ``load_image`` alone against its batch row."""
    paths = files["gray"] if gray else files["png"] + files["gray"] + files["jpg"]
    pil = T_cod10k.load_mask if gray else T_cod10k.load_image_rgb
    for size in (32, 96):
        got, ok = native.load_batch(paths, size, gray=gray)
        assert ok.all() and got.dtype == np.float32
        np.testing.assert_array_equal(got, np.stack([pil(p, size) for p in paths]))
        np.testing.assert_array_equal(native.load_image(paths[0], size, gray=gray), got[0])


def test_gray_of_rgb_truncates_as_the_jax_loader(files):
    """An RGB file decoded gray takes the JAX loader's integer luma, which
    truncates where PIL's ``convert("L")`` rounds: at most two levels apart
    after the bicubic resize."""
    got, ok = native.load_batch_u8(files["png"] + files["jpg"], 48, gray=True)
    assert ok.all() and got.shape == (12, 48, 48)
    want = np.stack([np.asarray(T_cod10k.load_mask(p, 48) * 255).round().astype(np.uint8)
                     for p in files["png"] + files["jpg"]])
    assert np.abs(got.astype(int) - want).max() <= 2
    if J_native.available():
        np.testing.assert_array_equal(got, J_native.load_batch_u8(files["png"] + files["jpg"],
                                                                   48, gray=True)[0])


def test_thread_counts_agree(files):
    paths = files["jpg"] * 3 + files["png"]
    one, ok1 = native.load_batch_u8(paths, 64, n_threads=1)
    eight, ok8 = native.load_batch_u8(paths, 64, n_threads=8)
    assert ok1.all() and ok8.all()
    np.testing.assert_array_equal(one, eight)
    with pytest.raises(ValueError):
        native.load_batch_u8(paths, 64, n_threads=0)


@pytest.mark.parametrize("draft", [False, True])
def test_decode_equals_jax_native(files, draft):
    """Full decode to the bit, and the draft DCT-scaled decode to the bit,
    against the JAX package's library; the float batch too."""
    jn = _jax_native()
    paths = files["jpg"] + files["png"] + files["gray"]
    for size in SIZES:
        got, ok = native.load_batch_u8(paths, size, draft=draft)
        want, jok = jn.load_batch_u8(paths, size, draft=draft)
        np.testing.assert_array_equal(ok, jok)
        np.testing.assert_array_equal(got, want)
    if not draft:
        got, _ = native.load_batch(paths, 40, gray=True)
        np.testing.assert_array_equal(got, jn.load_batch(paths, 40, gray=True)[0])


def test_draft_decode_covers_size_and_stays_close(files):
    """Draft pixels are not PIL's, but a JPEG decoded at a reduced DCT
    scale stays close to the full decode (PNGs are unaffected)."""
    full, _ = native.load_batch_u8(files["jpg"] + files["png"], 24)
    draft, ok = native.load_batch_u8(files["jpg"] + files["png"], 24, draft=True)
    assert ok.all()
    n = len(files["jpg"])
    np.testing.assert_array_equal(draft[n:], full[n:])
    assert np.abs(draft[:n].astype(int) - full[:n]).mean() < 8


def test_broken_file_is_not_ok(files):
    paths = [files["jpg"][0], files["broken"], files["png"][0], "/no/such/file.png"]
    for load in (native.load_batch_u8, native.load_batch):
        batch, ok = load(paths, 32)
        assert ok.tolist() == [True, False, True, False]
        np.testing.assert_array_equal(batch[2], load(paths[2:3], 32)[0][0])
    with pytest.raises(IOError):
        native.load_image(files["broken"], 32)
    with pytest.raises(IOError):
        T_bench.decode_batch_u8(paths[:2], 32)


def test_counts_batches_from_many_threads(files):
    """``DECODED`` under 16 threads with a short switch interval: no lost
    update."""
    native.reset_counts()
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(10):
                native.load_batch_u8(files["png"][:2], 16, n_threads=1)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    assert native.DECODED == {"batches": 160, "images": 320}


def test_build_lands_in_build_dir_by_hash(monkeypatch, tmp_path):
    """A build goes under the build directory, named by a hash of its
    sources and flags (a changed flag is a new library), with no temporary
    file left behind; a library that cannot be built raises with the
    compiler's message."""
    from camouflage_multimodal_tpu_torch.core import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    first = native.library_path("cmtgraph")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-DCMT_FLAG_CHANGED"])
    second = native.library_path("cmtgraph")
    assert first != second and first.parent == second.parent == tmp_path
    native.get_graph_lib()
    assert sorted(os.listdir(tmp_path)) == [second.name]
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-include", "no_such.h"])
    with pytest.raises(RuntimeError, match="(?s)building libcmtgraph failed.*no_such.h"):
        native.get_graph_lib()
    assert sorted(os.listdir(tmp_path)) == [second.name]


def test_missing_compiler_raises_and_never_falls_back(monkeypatch, files, tmp_path):
    """Without the compiler the library, the dataset, the bench's decode and
    the walks raise ``RuntimeError``; nothing turns to PIL."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_libs", {})
    assert not native.available()
    dirs = [str(tmp_path)] * 4
    img_dir, gt_dir, _ = _write_dataset(tmp_path, 1, 32)
    for call in (native.get_lib, native.get_graph_lib,
                 lambda: native.load_batch_u8(files["png"], 32),
                 lambda: T_bench.decode_batch_u8(files["png"], 32),
                 lambda: T_cod10k.CODDataset(*dirs),
                 lambda: T_api.evaluate_directory(ARTIFACTS[1], str(img_dir), str(gt_dir),
                                                  n_segments=16, image_size=32,
                                                  device="cpu")):
        with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
            call()
    assert T_cod10k.CODDataset(*dirs, use_native=False).use_native is False
    np.testing.assert_array_equal(
        T_bench.decode_batch_u8(files["png"], 32, use_native=False),
        np.stack([T_cod10k.load_image_u8(p, 32) for p in files["png"]]))


def test_system_libraries_build_equally(monkeypatch, files, tmp_path):
    """Where Pillow carries no libjpeg / libpng the decoder links the
    system's, and decodes the same bytes."""
    import subprocess

    for lib in ("libjpeg.so", "libpng.so"):
        found = subprocess.run([native.CXX, f"-print-file-name={lib}"], capture_output=True,
                               text=True).stdout.strip()
        if not os.path.isabs(found):
            pytest.skip(f"no system {lib} to link here")
    from camouflage_multimodal_tpu_torch.core import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_pillow_libs", lambda: tmp_path)      # holds none
    assert native._image_libs() == ["-ljpeg", "-lpng", "-lpthread"]
    paths = files["jpg"] + files["png"]
    got, ok = native.load_batch_u8(paths, 64)
    assert ok.all()
    np.testing.assert_array_equal(got, np.stack([T_cod10k.load_image_u8(p, 64) for p in paths]))


@pytest.fixture(scope="module")
def scene():
    img = synthetic_images(9, 1, 128)[0].astype(np.float32) / 255.0
    return img, native.build_region_graph(img, n_segments=128, max_nodes=256, num_iters=6)


def test_graph_builder_equals_jax(scene):
    jn = _jax_native()
    img, got = scene
    want = jn.build_region_graph(img, n_segments=128, max_nodes=256, num_iters=6)
    assert set(got) == set(want) and got["num_clusters"] == want["num_clusters"]
    for key in ("segments", "canny", "node_mask"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("features", "edge_weights"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)
    with pytest.raises(ValueError):
        native.build_region_graph(img, n_segments=128, max_nodes=8)


def test_graph_builder_agrees_with_port_ops(scene):
    """The C++ builder against the port's CPU graph build: SLIC and Canny
    at the JAX cross-check's bars, features and RAG weights from the port's
    ops on the builder's own segmentation."""
    img, out = scene
    x = torch.from_numpy(img)
    batch = build_region_graphs(x[None], n_segments=128, max_nodes=256, slic_iters=6)
    agree = (batch.segments[0].numpy() == out["segments"]).mean()
    assert agree > 0.97, f"SLIC agreement {agree:.3f}"
    edges = canny(rgb_to_gray(x), sigma=2.0).numpy()
    iou = (edges & out["canny"]).sum() / (edges | out["canny"]).sum()
    assert iou > 0.95, f"Canny IoU {iou:.3f}"
    seg = torch.from_numpy(out["segments"]).long()
    reg = region_features(x[None], seg[None], torch.from_numpy(out["canny"])[None], 256)
    mask = out["node_mask"] & reg["node_mask"][0].numpy()
    np.testing.assert_allclose(out["features"][mask], reg["features"][0].numpy()[mask],
                               rtol=5e-3, atol=5e-4)
    w = rag_edge_weights(reg["features"], region_adjacency(seg[None], 256))[0].numpy()
    w_nat = out["edge_weights"]
    assert ((w > 0) == (w_nat > 0)).mean() > 0.999
    both = (w > 0) & (w_nat > 0)
    np.testing.assert_allclose(w_nat[both], w[both], rtol=5e-3, atol=1e-4)


def _cod_dataset(root, n=4, size=40):
    """``n`` COD-style quadruples: JPEG images and PNG maps; image 1 is a
    BMP under a ``.jpg`` name, which only PIL decodes."""
    from PIL import Image

    dirs = [root / d for d in ("images", "mask", "instance", "edge")]
    for d in dirs:
        d.mkdir()
    scenes = synthetic_images(13, n, 2 * size)
    rng = np.random.default_rng(13)
    for i, img in enumerate(scenes):
        name = f"COD10K-CAM-1-Aquatic-{i}-Crab-{i}"
        Image.fromarray(img).save(dirs[0] / f"{name}.jpg", format="BMP" if i == 1 else "JPEG")
        for d in dirs[1:]:
            Image.fromarray((rng.random((2 * size, 2 * size)) > 0.5).astype(np.uint8) * 255
                            ).save(d / f"{name}.png")
    return [str(d) for d in dirs]


def test_cod_dataset_native_equals_pil(tmp_path):
    """Native and PIL batches equal; a batch with a file only PIL decodes
    falls through to PIL, as the JAX dataset does."""
    dirs = _cod_dataset(tmp_path)
    nat = T_cod10k.CODDataset(*dirs, image_size=32, use_native=True)
    pil = T_cod10k.CODDataset(*dirs, image_size=32, use_native=False)
    default = T_cod10k.CODDataset(*dirs, image_size=32)
    assert nat.use_native and default.use_native and not pil.use_native and len(nat) == 4
    native.reset_counts()
    for idx in ([0, 2, 3], [3, 1]):
        got, want = nat.load_batch(idx), pil.load_batch(idx)
        assert got["image_name"] == want["image_name"]
        for key in ("image", "mask", "instance", "edge"):
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert native.DECODED["batches"] == 8          # four loads a batch, both batches


def test_evaluate_directory_native_equals_pil(tmp_path):
    """A port walk at 96², 3 images, RG only: the same report with native
    and with PIL decode, and the native run decoded natively."""
    img_dir, gt_dir, _ = _write_dataset(tmp_path, 3, 96)
    kw = dict(n_segments=60, batch_size=2, image_size=96, device="cpu")
    native.reset_counts()
    got = T_api.evaluate_directory(ARTIFACTS[1], str(img_dir), str(gt_dir), **kw)
    assert native.DECODED == {"batches": 2, "images": 3}
    want = T_api.evaluate_directory(ARTIFACTS[1], str(img_dir), str(gt_dir), use_native=False,
                                    **kw)
    assert native.DECODED["batches"] == 2
    assert got == want
