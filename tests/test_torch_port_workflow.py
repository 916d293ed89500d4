"""The port's workflow slice against the JAX package, on the CPU: the
reference's ``.pth`` / ``.pt`` files, the embedding stores, the RG ↔ KG
matcher and the metric and curve functions. The directory walks
(extraction, evaluation, directory testing, detection and the late-fusion
predictor) are in tests/test_torch_port_walks.py and
tests/test_torch_port_walks_testdir.py.

Inputs come from numpy seeds or the committed artifacts. Bars: converted
weights and store contents equal to the bit; models loaded from ``.pth``
within 1e-5 of the JAX models on the same inputs; metrics and curves
within 1e-5, confusion counts equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from camouflage_multimodal_tpu import api as J_api  # noqa: E402
from camouflage_multimodal_tpu.core import artifacts as J_artifacts  # noqa: E402
from camouflage_multimodal_tpu.core import torch_compat as J_compat  # noqa: E402
from camouflage_multimodal_tpu.core.checkpoint import load_checkpoint as j_load_checkpoint  # noqa: E402
from camouflage_multimodal_tpu.data.matcher import EmbeddingMatcher as JMatcher  # noqa: E402
from camouflage_multimodal_tpu.eval import curves as J_curves  # noqa: E402
from camouflage_multimodal_tpu.eval import metrics as J_metrics  # noqa: E402
from camouflage_multimodal_tpu.models.knowledge_graph import KnowledgeGraphGNN as JKG  # noqa: E402
from camouflage_multimodal_tpu.utils import metrics as J_umetrics  # noqa: E402
from camouflage_multimodal_tpu_torch import api as T_api  # noqa: E402
from camouflage_multimodal_tpu_torch.core import artifacts as T_artifacts  # noqa: E402
from camouflage_multimodal_tpu_torch.core import torch_compat as T_compat  # noqa: E402
from camouflage_multimodal_tpu_torch.data import EmbeddingMatcher as TMatcher  # noqa: E402
from camouflage_multimodal_tpu_torch.eval import curves as T_curves  # noqa: E402
from camouflage_multimodal_tpu_torch.eval import metrics as T_metrics  # noqa: E402
from camouflage_multimodal_tpu_torch.utils import metrics as T_umetrics  # noqa: E402

LATE_CKPT = "artifacts/checkpoints_late/multimodal_best_fixed.ckpt"
FIDELITY = "artifacts/fidelity"
PTH_FILES = ("best_model.pth", "best_model_352.pth", "best_model_416.pth",
             "region_graph_model.pth", "multimodal_best.pth")
EXACT = dict(rtol=1e-5, atol=1e-5)


def _assert_same_tree(got, want, path="root"):
    """Same keys and, at every leaf, the same float32 array to the bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    else:
        want = np.asarray(want)
        assert got.dtype == np.float32 and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# Reference checkpoints (core/torch_compat.py) and the loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PTH_FILES)
def test_committed_pth_converts_like_jax(name):
    """All five committed ``.pth`` files: the port's JAX-layout arrays equal
    the JAX ``load_torch_checkpoint``'s to the bit, the metadata too, and
    the api loaders accept them."""
    path = os.path.join(FIDELITY, name)
    got, meta = T_compat.load_torch_checkpoint(path)
    want, want_meta = J_compat.load_torch_checkpoint(path)
    _assert_same_tree(got, want)
    assert meta == want_meta
    if meta["kind"] == "region_graph":
        model = T_api.load_rg_model(path, device="cpu")
        assert (model.in_channels, model.hidden_channels) == (15, 128)
    else:
        assert meta["kind"] == "fusion" and "val_f1_class_1" in meta
        model, config = T_api.load_multimodal_model(path, device="cpu")
        assert config == meta["config"] and model.fusion.cross_attn_rg2kg.use_pallas


def _fidelity_batch(size, n=3):
    """The first ``n`` committed reference graphs at ``size``, padded to one
    node bucket."""
    d = os.path.join(FIDELITY, f"graphs_{size}")
    graphs = [np.load(os.path.join(d, f)) for f in sorted(os.listdir(d))[:n]]
    K = max(g["features"].shape[0] for g in graphs)
    x = np.zeros((n, K, 15), np.float32)
    adj = np.zeros((n, K, K), bool)
    w = np.zeros((n, K, K), np.float32)
    mask = np.zeros((n, K), bool)
    for i, g in enumerate(graphs):
        k = g["features"].shape[0]
        x[i, :k], adj[i, :k, :k], w[i, :k, :k], mask[i, :k] = (
            g["features"], g["adjacency"], g["weights"], True)
    return x, adj, w, mask


@pytest.mark.parametrize("size", [352, 416])
def test_rg_pth_model_on_reference_graphs(size):
    """``best_model_{size}.pth`` through ``api.load_rg_model`` on the
    committed reference graphs of that size: every output within 1e-5 of
    the JAX model loaded from the same file."""
    path = os.path.join(FIDELITY, f"best_model_{size}.pth")
    x, adj, w, mask = _fidelity_batch(size)
    jmodel, variables = J_api.load_rg_model(path)
    want = jmodel.apply(variables, *(jnp.asarray(a) for a in (x, adj, w, mask)))
    with torch.no_grad():
        got = T_api.load_rg_model(path, device="cpu")(
            *(torch.from_numpy(a) for a in (x, adj, w, mask)))
    for key in want:
        np.testing.assert_allclose(got[key].numpy()[mask] if got[key].ndim == 3
                                   else got[key].numpy(),
                                   np.asarray(want[key])[mask] if got[key].ndim == 3
                                   else np.asarray(want[key]), **EXACT, err_msg=key)


def _fusion_inputs(rng, dim=128, B=2, N=96):
    rg = np.maximum(rng.standard_normal((B, N, dim)), 0).astype(np.float32)
    kg = (rng.standard_normal((B, 13, dim)) * 0.3).astype(np.float32)
    rg_mask = np.arange(N)[None] < np.array([[N], [N // 2]])
    return np.where(rg_mask[..., None], rg, 0).astype(np.float32), kg, rg_mask


def _fusion_vs_jax(path, rng):
    """The port's model from ``path`` against the JAX model from the same
    file, on seeded embeddings: every output within 1e-5."""
    jmodel, variables, config = J_api.load_multimodal_model(path)
    tmodel, t_config = T_api.load_multimodal_model(path, device="cpu")
    assert t_config == config
    rg, kg, rg_mask = _fusion_inputs(rng)
    want = jmodel.apply(variables, jnp.asarray(rg), jnp.asarray(kg),
                        rg_mask=jnp.asarray(rg_mask), return_attention=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(rg), torch.from_numpy(kg),
                     rg_mask=torch.from_numpy(rg_mask), return_attention=True)
    for key in ("mask_logits", "instance_logits", "edge_logits", "score"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **EXACT,
                                   err_msg=key)
    if want.get("attention") is None:
        assert got["attention"] is None
    else:
        for key in ("rg2kg", "kg2rg"):
            np.testing.assert_allclose(got["attention"][key].numpy(),
                                       np.asarray(want["attention"][key]), **EXACT,
                                       err_msg=key)


def test_multimodal_best_pth_matches_jax():
    _fusion_vs_jax(os.path.join(FIDELITY, "multimodal_best.pth"), np.random.default_rng(11))


def _late_reference_state_dict():
    """The committed late-fusion weights under the reference's key names
    (``fusion.fusion.{0,3,6}``, ``<head>.{0,3}``; torch's (out, in))."""
    params = j_load_checkpoint(LATE_CKPT)["params"]
    sd = {}

    def dense(prefix, p):
        sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(p["kernel"]).T))
        sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(p["bias"]))

    for idx, name in ((0, "fc1"), (3, "fc2"), (6, "fc3")):
        dense(f"fusion.fusion.{idx}", params["fusion"][name])
    for head in ("mask_head", "instance_head", "edge_head", "score_head"):
        dense(f"{head}.0", params[f"{head}_1"])
        dense(f"{head}.3", params[f"{head}_2"])
    return sd


@pytest.mark.parametrize("generation", ["old_val_acc", "new_f1"])
@pytest.mark.parametrize("fusion_type", ["cross_attention", "late"])
def test_fusion_pth_generations(tmp_path, generation, fusion_type):
    """Both checkpoint generations of both fusion types, written with the
    reference's key names: equal arrays and metadata in both packages, and
    models within 1e-5 of each other; a file with numpy metrics loads
    through the ``weights_only`` unpickler with numpy scalars allowed."""
    if fusion_type == "late":
        sd = _late_reference_state_dict()
    else:
        sd = torch.load(os.path.join(FIDELITY, "multimodal_best.pth"),
                        weights_only=True)["model_state_dict"]
    config = {"rg_dim": 128, "kg_dim": 128, "hidden_dim": 256, "num_heads": 8,
              "fusion_type": fusion_type, "num_classes": 2, "dropout": 0.3}
    # The old generation's metrics as numpy scalars, as a metric library
    # returns them: torch's weights_only unpickler alone refuses such a file.
    extra = ({"val_acc": np.float64(81.2), "balanced_acc": np.float64(74.0)}
             if generation == "old_val_acc"
             else {"val_f1_class_1": 0.61, "val_f1_avg": 0.58, "val_acc_0": 55.0,
                   "val_acc_1": 88.0})
    path = str(tmp_path / "multimodal_best.pth")
    torch.save({"epoch": 7, "model_state_dict": sd, "optimizer_state_dict": {},
                "val_loss": 0.4, "config": {"model": config}, **extra}, path)
    got, meta = T_compat.load_torch_checkpoint(path)
    want, want_meta = J_compat.load_torch_checkpoint(path)
    _assert_same_tree(got, want)
    assert meta == want_meta and meta["epoch"] == 7
    _fusion_vs_jax(path, np.random.default_rng(12))


class _RunsCode:
    """An object whose unpickling would call a function of the file's choice."""

    def __reduce__(self):
        return (os.getenv, ("HOME",))


@pytest.mark.parametrize("payload", ["object", "array"])
def test_torch_load_refuses_what_weights_only_refuses(tmp_path, payload):
    """A checkpoint holding anything beyond tensors, containers and scalars
    (an object that runs code when unpickled, a numpy array) is refused with
    its path named, and never unpickled in full."""
    path = str(tmp_path / "untrusted.pth")
    extra = _RunsCode() if payload == "object" else np.zeros(3)
    torch.save({"model_state_dict": {}, "extra": extra}, path)
    with pytest.raises(ValueError, match="untrusted.pth"):
        T_compat.load_torch_checkpoint(path)


def test_kg_pth_matches_jax(tmp_path):
    """A KG ``.pth`` in the reference's wrapped format, from the reference
    model's own key names: equal arrays, and ``api.load_kg_model`` within
    1e-5 of the JAX model."""
    from reference_impl import RefKnowledgeGraphGNN

    torch.manual_seed(2)
    ref = RefKnowledgeGraphGNN().eval()
    for bn in (ref.bn1, ref.bn2, ref.bn3):
        bn.running_mean.uniform_(-0.5, 0.5)
        bn.running_var.uniform_(0.5, 2.0)
    path = str(tmp_path / "kg_gnn_model.pth")
    torch.save({"model_state_dict": ref.state_dict(), "embedding_dim": 128,
                "val_loss": 0.1}, path)
    got, meta = T_compat.load_torch_checkpoint(path)
    want, want_meta = J_compat.load_torch_checkpoint(path)
    _assert_same_tree(got, want)
    assert meta == want_meta and meta["kind"] == "knowledge_graph"

    rng = np.random.default_rng(13)
    K = 12
    x = rng.standard_normal((2, K, 32)).astype(np.float32)
    a = rng.random((2, K, K)) < 0.3
    adj = a | a.transpose(0, 2, 1)
    mask = np.arange(K)[None] < np.array([[K], [7]])
    adj &= mask[:, None, :] & mask[:, :, None]
    ref_out = JKG().apply(want, *(jnp.asarray(v) for v in (x, adj, mask)))
    with torch.no_grad():
        out = T_api.load_kg_model(path, device="cpu")(
            *(torch.from_numpy(v) for v in (x, adj, mask)))
    for key in ("score", "embedding"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref_out[key]), **EXACT,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# Embedding stores (core/artifacts.py)
# ---------------------------------------------------------------------------

def _rg_store(rng, names):
    return {n: {"node_embeddings": rng.standard_normal((int(rng.integers(5, 30)), 128)
                                                       ).astype(np.float32),
                "graph_embedding": rng.standard_normal((1, 128)).astype(np.float32)}
            for n in names}


def test_stores_npz_and_pt_read_alike(tmp_path):
    """``.npz`` stores written by the port and ``.pt`` stores written with
    ``torch.save`` in the reference's schema read back by both packages
    alike: same names in the same order, equal arrays."""
    rng = np.random.default_rng(14)
    names = ["COD10K-CAM-1-Aquatic-3-Crab-52.jpg", "b.jpg", "a.jpg"]
    store = _rg_store(rng, names)
    npz = str(tmp_path / "rg" / "all_rg_embeddings.npz")
    T_artifacts.save_rg_embeddings(npz, store)
    pt = str(tmp_path / "all_rg_embeddings.pt")
    torch.save({n: {"node_embeddings": torch.from_numpy(r["node_embeddings"]),
                    "graph_embedding": torch.from_numpy(r["graph_embedding"]),
                    "num_nodes": len(r["node_embeddings"])} for n, r in store.items()}, pt)
    for path in (npz, pt):
        got, want = T_artifacts.load_rg_embeddings(path), J_artifacts.load_rg_embeddings(path)
        assert list(got) == list(want) == names
        for n in names:
            assert got[n]["num_nodes"] == want[n]["num_nodes"] == len(store[n]["node_embeddings"])
            for key in ("node_embeddings", "graph_embedding"):
                np.testing.assert_array_equal(got[n][key], want[n][key])
                np.testing.assert_array_equal(got[n][key], store[n][key])

    kg = {c: rng.standard_normal((1, 128)).astype(np.float32) for c in ("Owl", "Crab", "Fish")}
    kg_pt = str(tmp_path / "all_embeddings.pt")
    torch.save({c: torch.from_numpy(v[0]) for c, v in kg.items()}, kg_pt)
    kg_npz = str(tmp_path / "kg" / "all_embeddings.npz")
    T_artifacts.save_kg_embeddings(kg_npz, kg)
    for path in (kg_pt, kg_npz):
        got, want = T_artifacts.load_kg_embeddings(path), J_artifacts.load_kg_embeddings(path)
        assert list(got) == list(want) == list(kg)
        for c in kg:
            assert got[c].shape == (1, 128) and got[c].dtype == np.float32
            np.testing.assert_array_equal(got[c], want[c])
            np.testing.assert_array_equal(got[c], kg[c])


# ---------------------------------------------------------------------------
# EmbeddingMatcher (data/matcher.py)
# ---------------------------------------------------------------------------

def test_embedding_matcher_matches_jax(tmp_path):
    """Records equal to the bit and in the same order, in both modes and
    from ``save_matched_dataset``, on stores with an exact match, a
    substring match either way, an organism the KG store lacks (the mean
    fallback) and a name that is no COD10K name."""
    rng = np.random.default_rng(15)
    names = ["COD10K-CAM-2-Terrestrial-23-Cat-1441.jpg",        # exact (KG 'Cat')
             "COD10K-CAM-1-Aquatic-6-Fish-142.jpg",             # 'Fish' in 'ScorpionFish'
             "COD10K-CAM-3-Flying-55-Owlet-3329.jpg",           # 'Owl' in 'Owlet'
             "COD10K-CAM-4-Amphibian-67-Frog-4710.jpg",         # no such category
             "sunset.jpg"]                                      # not a COD10K name
    rg_path = str(tmp_path / "all_rg_embeddings.npz")
    T_artifacts.save_rg_embeddings(rg_path, _rg_store(rng, names))
    kg_path = str(tmp_path / "all_embeddings.npz")
    T_artifacts.save_kg_embeddings(kg_path, {
        c: rng.standard_normal((1, 128)).astype(np.float32)
        for c in ("ScorpionFish", "Cat", "Owl", "Crab")})
    jm, tm = JMatcher(rg_path, kg_path), TMatcher(rg_path, kg_path)
    assert tm.category_to_id == jm.category_to_id == {"ScorpionFish": 0, "Cat": 1, "Owl": 2,
                                                       "Crab": 3}
    assert ([tm.extract_category_from_filename(n) for n in names]
            == [jm.extract_category_from_filename(n) for n in names]
            == ["Cat", "ScorpionFish", "Owl", None, None])
    for use_all in (True, False):
        got = tm.create_matched_dataset(use_all)
        want = jm.create_matched_dataset(use_all)
        assert [r["image_name"] for r in got] == [r["image_name"] for r in want] == names
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                if isinstance(w[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                else:
                    assert g[k] == w[k], k
    saved = tm.save_matched_dataset(str(tmp_path / "out" / "matched.npy"), False)
    back = np.load(str(tmp_path / "out" / "matched.npy"), allow_pickle=True)
    assert [r["category_ids"] for r in back] == [r["category_ids"] for r in saved] \
        == [[1], [0], [2], [0], [0]]


# ---------------------------------------------------------------------------
# Metrics (eval/metrics.py, utils/metrics.py) and curves (eval/curves.py)
# ---------------------------------------------------------------------------

def _metric_cases(size=48):
    """(B, H, W) heatmaps and GTs: random maps, an empty GT, a full GT, a
    perfect prediction, a prediction of all zeros and an off-centre blob."""
    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[0:size, 0:size]
    blob = (((yy - 30) ** 2 + (xx - 14) ** 2) < 80).astype(np.float32)
    gts = [(rng.random((size, size)) > 0.7), np.zeros((size, size)), np.ones((size, size)),
           blob, blob, blob]
    preds = [rng.random((size, size)), rng.random((size, size)), rng.random((size, size)),
             blob, np.zeros((size, size)),
             np.clip(blob + rng.normal(0, 0.3, blob.shape), 0, 1)]
    return np.stack(preds).astype(np.float32), np.stack(gts).astype(np.float32)


def test_metrics_match_jax():
    """Every metric per image and ``batch_evaluate``'s means and stds within
    1e-5 of the JAX functions; the float wrappers likewise."""
    pred, gt = _metric_cases()
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    want = _numpy(J_metrics.evaluate_segmentation(jnp.asarray(pred), jnp.asarray(gt)))
    got = _numpy(T_metrics.evaluate_segmentation(tp, tg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **EXACT, err_msg=k)
    np.testing.assert_allclose(got["iou"][3], 1.0, atol=1e-6)          # perfect prediction
    np.testing.assert_allclose(got["s_measure"][1], 1 - pred[1].mean(), atol=1e-5)  # empty GT
    want_b = _numpy(J_metrics.batch_evaluate(jnp.asarray(pred), jnp.asarray(gt), 0.4))
    got_b = _numpy(T_metrics.batch_evaluate(tp, tg, 0.4))
    assert set(got_b) == set(want_b)
    for k in want_b:
        np.testing.assert_allclose(got_b[k], want_b[k], **EXACT, err_msg=k)
    for i in range(pred.shape[0]):
        w = J_umetrics.evaluate_segmentation(pred[i], gt[i])
        g = T_umetrics.evaluate_segmentation(pred[i], gt[i], device="cpu")
        assert all(abs(g[k] - w[k]) <= 1e-5 for k in w), (i, g, w)
        assert T_umetrics.calculate_iou(pred[i], gt[i], device="cpu") == pytest.approx(
            J_umetrics.calculate_iou(pred[i], gt[i]), abs=1e-6)
        assert T_umetrics.calculate_precision_recall_f1(pred[i], gt[i], device="cpu") == \
            pytest.approx(J_umetrics.calculate_precision_recall_f1(pred[i], gt[i]), abs=1e-6)
    for fn in ("calculate_dice", "calculate_mae"):
        assert getattr(T_umetrics, fn)(pred[0], gt[0], device="cpu") == pytest.approx(
            getattr(J_umetrics, fn)(pred[0], gt[0]), abs=1e-6)
    assert T_umetrics.calculate_accuracy(gt[0], gt[3]) == J_umetrics.calculate_accuracy(gt[0], gt[3])
    got_l = T_umetrics.batch_evaluate(list(pred), list(gt), device="cpu")
    want_l = J_umetrics.batch_evaluate(list(pred), list(gt))
    assert all(abs(got_l[k] - want_l[k]) <= 1e-5 for k in want_l)


def test_curves_match_jax():
    """Confusion counts equal; every curve and scalar within 1e-5."""
    pred, gt = _metric_cases()
    tp, fp = T_curves._confusion_curves(torch.from_numpy(pred), torch.from_numpy(gt))
    j_tp, j_fp = J_curves._confusion_curves(jnp.asarray(pred), jnp.asarray(gt))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(j_tp))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(j_fp))
    want = _numpy(J_curves.threshold_curves(jnp.asarray(pred), jnp.asarray(gt)))
    got = _numpy(T_curves.threshold_curves(torch.from_numpy(pred), torch.from_numpy(gt)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **EXACT, err_msg=k)
    want_b = _numpy(J_curves.batch_curve_metrics(jnp.asarray(pred), jnp.asarray(gt)))
    got_b = _numpy(T_curves.batch_curve_metrics(torch.from_numpy(pred), torch.from_numpy(gt)))
    assert set(got_b) == set(want_b)
    for k in want_b:
        np.testing.assert_allclose(got_b[k], want_b[k], **EXACT, err_msg=k)
