"""The port's directory walks against the JAX package, on the CPU: RG
embedding extraction, directory evaluation, the late-fusion predictor and
single-image detection (directory testing is in
tests/test_torch_port_walks_testdir.py, so that the two long files run on
different workers).

Inputs come from numpy seeds and the committed artifacts. Bars: the
pipeline outputs at the slice's bars of tests/test_torch_port_pipeline.py
(segment maps ≥ 99 % equal, heatmap MAE ≤ 1e-2, and where an image's
segments are equal, outputs at the stage tolerances); metrics within 1e-3
of the JAX report (1e-5 for one image).
"""

import json
import os

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu import api as J_api  # noqa: E402
from camouflage_multimodal_tpu import extract as J_extract  # noqa: E402
from camouflage_multimodal_tpu import pipeline as J_pipeline  # noqa: E402
from camouflage_multimodal_tpu.core import artifacts as J_artifacts  # noqa: E402
from camouflage_multimodal_tpu_torch import api as T_api  # noqa: E402
from camouflage_multimodal_tpu_torch import extract as T_extract  # noqa: E402
from camouflage_multimodal_tpu_torch import pipeline as T_pipeline  # noqa: E402
from camouflage_multimodal_tpu_torch.core import artifacts as T_artifacts  # noqa: E402
from test_torch_port_pipeline import (  # noqa: E402,F401
    ARTIFACTS, GNN_TOL, OUT_TOL, _compare_slice, few_threads, synthetic_images)

pytestmark = pytest.mark.usefixtures("few_threads")

LATE_CKPT = "artifacts/checkpoints_late/multimodal_best_fixed.ckpt"
EXACT = dict(rtol=1e-5, atol=1e-5)


CATEGORIES = ("Crab", "Owl", "Cat", "Frog")


def _write_dataset(root, n, size, seed=17):
    """``n`` seeded images with COD10K names (image 2 an undecodable file)
    and a GT mask per image (a disc)."""
    from PIL import Image

    images = synthetic_images(seed, n, size)
    img_dir, gt_dir = root / "images", root / "gt"
    img_dir.mkdir()
    gt_dir.mkdir()
    yy, xx = np.mgrid[0:size, 0:size]
    rng = np.random.default_rng(seed)
    names = []
    for i, img in enumerate(images):
        name = f"COD10K-CAM-1-Aquatic-{i}-{CATEGORIES[i % 4]}-{i}"
        names.append(name + ".png")
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < (0.2 * size) ** 2
        Image.fromarray((mask * 255).astype(np.uint8)).save(gt_dir / (name + ".png"))
        Image.fromarray(img).save(img_dir / (name + ".png"))
    (img_dir / "broken.jpg").write_bytes(b"not an image")
    return img_dir, gt_dir, names


def _load_schema(path):
    with open(path) as f:
        return json.load(f)


def test_batch_extract_embeddings_matches_jax(tmp_path):
    """5 seeded 96² images (and one undecodable file) at batch 2 with the
    committed RG weights: the same records, stores and summary keys; where
    an image's segments agree, node counts equal and embeddings at the
    pipeline test's bar (5e-4); the store read back by both packages."""
    img_dir, _, names = _write_dataset(tmp_path, 5, 96)
    jmodel, jvars = J_api.load_rg_model(ARTIFACTS[1])
    jpipe = J_pipeline.RegionGraphPipeline(jmodel, n_segments=60, image_size=96)
    tpipe = T_pipeline.RegionGraphPipeline(T_api.load_rg_model(ARTIFACTS[1], device="cpu"),
                                           n_segments=60, image_size=96)
    logs = []
    want, want_sum = J_extract.batch_extract_embeddings(
        jpipe, jvars, str(img_dir), str(tmp_path / "jax"), batch_size=2,
        save_individual=True, log_fn=lambda *_: None)
    got, got_sum = T_extract.batch_extract_embeddings(
        tpipe, str(img_dir), str(tmp_path / "port"), batch_size=2, save_individual=True,
        log_fn=logs.append)
    assert list(got) == list(want) == names and len(logs) == 3
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert got_sum["processing_time"]["failed_images"] == 1
    for s in (got_sum, want_sum):
        del s["processing_time"]["total_seconds"], s["processing_time"]["avg_per_image"]
    on_disk = _load_schema(tmp_path / "port" / "embedding_summary.json")
    assert set(on_disk) == set(_load_schema(tmp_path / "jax" / "embedding_summary.json"))
    equal_seg = 0
    for name in names:
        base = os.path.splitext(name)[0]
        with np.load(tmp_path / "port" / f"{base}_embedding.npz") as a, \
                np.load(tmp_path / "jax" / f"{base}_embedding.npz") as b:
            assert set(a.files) == set(b.files)
            seg_eq = (a["segments"] == b["segments"]).mean()
            assert seg_eq >= 0.99
            if seg_eq < 1:
                continue
            equal_seg += 1
            assert got[name]["num_nodes"] == want[name]["num_nodes"]
            assert got_sum["images"][name] == want_sum["images"][name]
            for key in ("node_embeddings", "graph_embedding"):
                np.testing.assert_allclose(got[name][key], want[name][key], rtol=0, atol=5e-4)
    assert equal_seg >= 3
    stores = [loader(str(tmp_path / "port" / "all_rg_embeddings.npz"))
              for loader in (T_artifacts.load_rg_embeddings, J_artifacts.load_rg_embeddings)]
    for name in names:
        np.testing.assert_array_equal(stores[0][name]["node_embeddings"],
                                      got[name]["node_embeddings"])
        np.testing.assert_array_equal(stores[1][name]["node_embeddings"],
                                      got[name]["node_embeddings"])
    one = T_extract.extract_embeddings_from_image(tpipe, str(img_dir / names[0]))
    j_one = J_extract.extract_embeddings_from_image(jpipe, jvars, str(img_dir / names[0]))
    np.testing.assert_array_equal(one[2], j_one[2])
    for g, w, batched in zip(one[:2], j_one[:2], (got[names[0]]["node_embeddings"],
                                                  got[names[0]]["graph_embedding"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-4)
        np.testing.assert_allclose(g, batched, **EXACT)      # alone vs in a batch of 2
    assert T_extract.format_time(42) == "42.0s" and T_extract.format_time(7200) == "2.00h"


def test_evaluate_directory_matches_jax(tmp_path):
    """5 seeded 96² images with GT discs (one undecodable file, which the
    GT filter skips; one image without GT), batch 2, skipping the first
    file: the same report keys, every metric within 1e-3 of the JAX
    report (the heatmaps agree at the slice's bars)."""
    img_dir, gt_dir, names = _write_dataset(tmp_path, 6, 96)
    os.remove(gt_dir / names[4])
    kwargs = dict(n_segments=60, batch_size=2, image_size=96, skip_images=1)
    want = J_api.evaluate_directory(ARTIFACTS[1], str(img_dir), str(gt_dir), **kwargs)
    got = T_api.evaluate_directory(ARTIFACTS[1], str(img_dir), str(gt_dir), device="cpu",
                                   **kwargs)
    assert set(got) == set(want) and "e_adaptive" in got and "s_measure_std" in got
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    chosen = T_api.evaluate_directory(ARTIFACTS[1], str(img_dir), str(gt_dir), device="cpu",
                                      files=names[:2], n_segments=60, batch_size=2,
                                      image_size=96, threshold=0.3, feature_norm=256)
    assert set(chosen) == set(want)


def test_late_fusion_predictor_matches_jax(tmp_path):
    """The late-fusion checkpoint through ``MultimodalPredictor``: no
    ``"attention"`` key and ``attn=None``, as from the JAX predictor, and
    every output at the slice's bars, on the image of the cross-attention
    test in tests/test_torch_port_pipeline.py."""
    from PIL import Image

    images = synthetic_images(3, 1, 256)
    jpred = J_api.MultimodalPredictor(LATE_CKPT, *ARTIFACTS[1:])
    tpred = T_api.MultimodalPredictor(LATE_CKPT, *ARTIFACTS[1:], device="cpu")
    want, got = jpred.predict_batch(images), tpred.predict_batch(images)
    assert "attention" not in got and "attention" not in want
    want["attention"] = got["attention"] = {"rg2kg": np.zeros(1), "kg2rg": np.zeros(1)}
    _compare_slice(want, got)

    path = str(tmp_path / "img.png")
    Image.fromarray(images[0]).save(path)
    want_p, want_a, want_kg = jpred.predict_single_image(path)
    got_p, got_a, got_kg = tpred.predict_single_image(path)
    assert got_a is None and want_a is None and list(got_kg) == list(want_kg)
    assert set(got_p) == set(want_p)
    for key in ("mask_pred", "instance_pred"):
        assert got_p[key] == want_p[key]
    np.testing.assert_array_equal(got_p["segments"], want_p["segments"])
    for key in ("mask_logits", "mask_prob", "instance_prob", "edge_prob", "score"):
        np.testing.assert_allclose(got_p[key], want_p[key], **OUT_TOL, err_msg=key)
    np.testing.assert_allclose(got_p["heatmap"], want_p["heatmap"], **GNN_TOL)


def test_detect_camouflage_matches_jax(tmp_path):
    """One seeded 128² image with a GT disc, 100 segments, both paint
    mappings: the heatmap at the GNN bar where segments agree, the same
    band, metrics within 1e-5; the figures under the JAX file names."""
    img_dir, gt_dir, names = _write_dataset(tmp_path, 1, 128)
    image, mask = str(img_dir / names[0]), str(gt_dir / names[0])
    for mapping in ("corrected", "verbatim"):
        kw = dict(mask_path=mask, n_segments=100, image_size=128, paint_mapping=mapping,
                  save_figures=False)
        w_heat, w_mean, w_cls, w_metrics = J_api.detect_camouflage(image, ARTIFACTS[1], **kw)
        g_heat, g_mean, g_cls, g_metrics = T_api.detect_camouflage(image, ARTIFACTS[1],
                                                                   device="cpu", **kw)
        np.testing.assert_allclose(g_heat, w_heat, **GNN_TOL)
        assert g_cls == w_cls and g_mean == pytest.approx(w_mean, abs=1e-5)
        assert set(g_metrics) == set(w_metrics)
        assert all(abs(g_metrics[k] - w_metrics[k]) <= 1e-5 for k in w_metrics), g_metrics
    _, _, _, none = T_api.detect_camouflage(image, ARTIFACTS[1], n_segments=100,
                                            image_size=128, save_figures=False, device="cpu")
    assert none is None
    assert [T_api.classification_bands(s) for s in (0.4, 0.3, 0.15, 0.05)] == \
        [J_api.classification_bands(s) for s in (0.4, 0.3, 0.15, 0.05)]
    T_api.detect_camouflage(image, ARTIFACTS[1], str(tmp_path / "figs"), n_segments=100,
                            image_size=128, device="cpu")
    assert sorted(os.listdir(tmp_path / "figs")) == [f"detection_{names[0]}", f"mask_{names[0]}"]
    predictions = {"segments": np.zeros((128, 128), np.int32), "mask_prob": np.array([0.6, 0.4]),
                   "mask_pred": 0, "instance_pred": 0, "score": 0.3}
    T_api.visualize_prediction(image, predictions, None, {}, str(tmp_path / "v.png"))
    assert os.path.getsize(tmp_path / "v.png") > 1000
