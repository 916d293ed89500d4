"""The PyTorch port's multimodal inference slice end to end against the JAX
``MultimodalPipeline``, on the CPU: seeded uint8 images in, the same
carried-over weights on both sides.

Bars: final segment maps ≥ 99 % equal and heatmap MAE ≤ 1e-2 (the slice's
own bars); where an image's segment maps are equal, every output within the
stage tolerances of tests/test_torch_port_models.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu import api as J_api  # noqa: E402
from camouflage_multimodal_tpu import pipeline as J_pipeline  # noqa: E402
from camouflage_multimodal_tpu.models.fusion import (  # noqa: E402
    MultimodalCamouflageDetector as JDetector)
from camouflage_multimodal_tpu.models.region_graph import RegionGraphGNN as JGNN  # noqa: E402
from camouflage_multimodal_tpu_torch import pipeline as T_pipeline  # noqa: E402
from camouflage_multimodal_tpu_torch.api import MultimodalPredictor  # noqa: E402
from camouflage_multimodal_tpu_torch.convert import (  # noqa: E402
    fusion_state_dict, region_graph_state_dict)
from camouflage_multimodal_tpu_torch.models.fusion import (  # noqa: E402
    MultimodalCamouflageDetector as TDetector)
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN as TGNN  # noqa: E402

ARTIFACTS = ("artifacts/checkpoints_balanced/multimodal_best_fixed.ckpt",
             "artifacts/rg_model.ckpt",
             "artifacts/kg_embeddings/all_embeddings.npz")

OUT_TOL = dict(rtol=1e-4, atol=1e-4)     # logits, score (tests/test_pallas.py:30)
PROB_TOL = dict(rtol=1e-3, atol=2e-3)    # attention maps (tests/test_pallas.py:32)
GNN_TOL = dict(rtol=2e-4, atol=2e-5)     # RG outputs (tests/test_torch_compat.py:34)


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads while a module runs (modules ask for it with
    ``pytest.mark.usefixtures``): the suite runs a file per worker, and 8
    threads in each of 6 workers on 8 cores wait on each other — the three
    serving, CLI and figure files took 595 s instead of 2,192 in a 6-worker
    run with it, and the files beside them half their time."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


def _compare_slice(want, got):
    """``want``/``got``: numpy output dicts of the JAX and port pipelines."""
    seg_eq = want["segments"] == got["segments"]
    assert seg_eq.mean() >= 0.99
    assert np.abs(want["heatmap"] - got["heatmap"]).mean() <= 1e-2
    same = [b for b in range(seg_eq.shape[0]) if seg_eq[b].all()]
    assert same, "no image with identical segment maps to compare outputs on"
    np.testing.assert_array_equal(got["node_mask"][same], want["node_mask"][same])
    np.testing.assert_allclose(got["heatmap"][same], want["heatmap"][same], **GNN_TOL)
    for key in ("mask_logits", "instance_logits", "edge_logits", "score",
                "mask_prob", "instance_prob", "edge_prob"):
        np.testing.assert_allclose(got[key][same], want[key][same], **OUT_TOL, err_msg=key)
    for key in ("rg2kg", "kg2rg"):
        np.testing.assert_allclose(got["attention"][key][same],
                                   want["attention"][key][same], **PROB_TOL, err_msg=key)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_multimodal_slice_small():
    """Two 112² images, 80 segments, RG hidden 32, fusion hidden 64 × 4
    heads, JAX-initialized weights carried over."""
    rng = np.random.default_rng(9)
    images = synthetic_images(1, 2, 112)
    kg = rng.standard_normal((13, 32)).astype(np.float32)
    K = J_pipeline.padded_nodes(80, 112)

    jgnn = JGNN(hidden_channels=32)
    z = jnp.zeros((1, K, 15))
    zk = jnp.zeros((1, K, K))
    rg_vars = jgnn.init(jax.random.PRNGKey(3), z, zk.astype(bool), zk,
                        jnp.ones((1, K), bool))
    jdet = JDetector(rg_dim=32, kg_dim=32, hidden_dim=64, num_heads=4)
    fu_params = jdet.init(jax.random.PRNGKey(4), jnp.zeros((1, K, 32)),
                          jnp.asarray(kg[None]))["params"]

    jrg = J_pipeline.RegionGraphPipeline(jgnn, n_segments=80, image_size=112)
    want = _numpy(J_pipeline.MultimodalPipeline(jrg, jdet)(
        rg_vars, {"params": fu_params}, jnp.asarray(images), jnp.asarray(kg)))

    tgnn = TGNN(hidden_channels=32)
    tgnn.load_state_dict(region_graph_state_dict(rg_vars["params"], rg_vars["batch_stats"]))
    tdet = TDetector(rg_dim=32, kg_dim=32, hidden_dim=64, num_heads=4)
    tdet.load_state_dict(fusion_state_dict(fu_params))
    trg = T_pipeline.RegionGraphPipeline(tgnn, n_segments=80, image_size=112)
    out = T_pipeline.MultimodalPipeline(trg, tdet)(torch.from_numpy(images),
                                                   torch.from_numpy(kg))
    got = {k: ({a: b.numpy() for a, b in v.items()} if isinstance(v, dict) else v.numpy())
           for k, v in out.items()}
    _compare_slice(want, got)
    assert got["window_drift"].shape == (2,) and (got["window_drift"] < 1).all()


@pytest.mark.parametrize("mapping", ["corrected", "verbatim"])
def test_region_graph_pipeline_paint_mappings(mapping):
    """``RegionGraphPipeline`` alone with the committed RG weights, in both
    paint-back mappings: segments and node masks equal; heatmaps and logits
    at the GNN bar; region features at 1e-5 (the std features 3-5 and 7 as
    variances, see tests/test_torch_port_ops.py). The 128-d embeddings get
    5e-4 abs: their inputs already differ by up to 1e-5 (float32 segment
    sums in another order) and the trained GAT/GCN stack has a gain of ~10
    on such differences; the GNN's own arithmetic is held to 2e-4/2e-5 on
    identical inputs in tests/test_torch_port_models.py."""
    images = synthetic_images(2, 1, 128)
    jmodel, jvars = J_api.load_rg_model(ARTIFACTS[1])
    want = _numpy(J_pipeline.RegionGraphPipeline(
        jmodel, n_segments=100, image_size=128, paint_mapping=mapping)(
        jvars, jnp.asarray(images)))
    from camouflage_multimodal_tpu_torch.api import load_rg_model

    got = T_pipeline.RegionGraphPipeline(
        load_rg_model(ARTIFACTS[1], device="cpu"), n_segments=100, image_size=128,
        paint_mapping=mapping)(torch.from_numpy(images))
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["segments"], want["segments"])
    np.testing.assert_array_equal(got["node_mask"], want["node_mask"])
    for key in ("heatmap", "mask_logits", "instance_logits", "edge_logits"):
        np.testing.assert_allclose(got[key], want[key], **GNN_TOL, err_msg=key)
    for key in ("node_embeddings", "graph_embedding"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=5e-4, err_msg=key)
    std = [3, 4, 5, 7]
    rest = [i for i in range(15) if i not in std]
    feats, want_f = got["region_features"], want["region_features"]
    np.testing.assert_allclose(feats[..., rest], want_f[..., rest], atol=1e-5, rtol=0)
    np.testing.assert_allclose(feats[..., std] ** 2, want_f[..., std] ** 2, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["window_drift"], want["window_drift"], atol=1e-4)


def test_multimodal_predictor_committed_checkpoints(tmp_path):
    """The full-width model of the committed artifacts (image 256², 500
    segments, 640-node bucket, fusion hidden 256 × 8 heads) through both
    ``MultimodalPredictor``s on one seeded image, by ``predict_batch`` and
    by ``predict_single_image`` from a PNG file."""
    from PIL import Image

    images = synthetic_images(3, 1, 256)
    jpred = J_api.MultimodalPredictor(*ARTIFACTS)
    tpred = MultimodalPredictor(*ARTIFACTS, device="cpu")
    want = jpred.predict_batch(images)
    got = tpred.predict_batch(images)
    assert got["segments"].shape == (1, 256, 256)
    assert got["attention"]["rg2kg"].shape == (1, 640, 13)
    assert got["attention"]["kg2rg"].shape == (1, 13, 640)
    _compare_slice(want, got)

    path = str(tmp_path / "img.png")
    Image.fromarray(images[0]).save(path)
    want_p, want_a, want_kg = jpred.predict_single_image(path)
    got_p, got_a, got_kg = tpred.predict_single_image(path)
    assert list(got_kg) == list(want_kg)
    assert set(got_p) == set(want_p)
    for key in ("mask_pred", "instance_pred"):
        assert got_p[key] == want_p[key]
    np.testing.assert_array_equal(got_p["segments"], want_p["segments"])
    for key in ("mask_logits", "mask_prob", "instance_prob", "edge_prob", "score"):
        np.testing.assert_allclose(got_p[key], want_p[key], **OUT_TOL, err_msg=key)
    for key in ("rg2kg", "kg2rg"):
        assert got_a[key].shape == want_a[key].shape
        np.testing.assert_allclose(got_a[key], want_a[key], **PROB_TOL, err_msg=key)


def test_batch_without_window_drift_from_committed_graphs():
    """A ``RegionGraphBatch`` built from the five fields of the committed
    reference graphs (``artifacts/fidelity/graphs_352``, which hold no
    drift), as the JAX package accepts it: ``predict_graphs`` on the
    committed RG weights gives the JAX model's painted heatmap at the GNN
    bar and passes ``window_drift`` on as None."""
    import os

    from camouflage_multimodal_tpu_torch.api import load_rg_model

    d = "artifacts/fidelity/graphs_352"
    graphs = [np.load(os.path.join(d, f)) for f in sorted(os.listdir(d))[:2]]
    K = max(g["features"].shape[0] for g in graphs)
    seg = np.zeros((len(graphs), 352, 352), np.int32)
    x = np.zeros((len(graphs), K, 15), np.float32)
    adj = np.zeros((len(graphs), K, K), bool)
    w = np.zeros((len(graphs), K, K), np.float32)
    mask = np.zeros((len(graphs), K), bool)
    for i, g in enumerate(graphs):
        k = g["features"].shape[0]
        seg[i] = np.searchsorted(g["id_map_keys"], g["segments"])   # label → node index
        x[i, :k], adj[i, :k, :k], w[i, :k, :k], mask[i, :k] = (
            g["features"], g["adjacency"], g["weights"], True)
    fields = (seg, x, adj, w, mask)

    jbatch = J_pipeline.RegionGraphBatch(*(jnp.asarray(a) for a in fields))
    assert jbatch.window_drift is None
    jmodel, jvars = J_api.load_rg_model(ARTIFACTS[1])
    out = jmodel.apply(jvars, jbatch.features, jbatch.adjacency, jbatch.edge_weights,
                       jbatch.node_mask)
    probs = jnp.where(jbatch.node_mask, jax.nn.softmax(out["mask_logits"], axis=-1)[..., 1], 0.0)
    want = np.asarray(J_pipeline.paint_segments(probs, jbatch.segments))

    tbatch = T_pipeline.RegionGraphBatch(*(torch.from_numpy(a) for a in fields))
    assert tbatch.window_drift is None
    got = T_pipeline.RegionGraphPipeline(load_rg_model(ARTIFACTS[1], device="cpu"),
                                         image_size=352).predict_graphs(tbatch)
    assert got["window_drift"] is None
    np.testing.assert_allclose(got["heatmap"].numpy(), want, **GNN_TOL)
