"""The port's quality anchor, real-data RG training, SLIC node
cross-validation and fusion quality anchor against the JAX system's
scripts, on the CPU, on seeded trees in COD10K's layout
(``tests/torch_port_cod10k.py``) and ``tmp_path``.

The JAX scripts are loaded by path; their module constants (``REF_DATA``,
``OUT_DIR``, ``IMG_DIR``, ``REF_SUMMARY``, ``OUT_PATH``, ``REPO``) point
at the tree and at ``tmp_path``, their ``sys.argv`` is set where their
``main`` reads it, and they run in a working directory of their own. The
port's scripts write under their ``--out`` root.

The RG trainers of both packages start from the same weights (the JAX
trainer's initialisation at seed 0, carried over by ``convert``) at
dropout 0: the two frameworks cannot share dropout draws. The trainers
themselves are held step by step in ``tests/test_torch_port_train_rg.py``.

Bars: ``quality_anchor``'s table metrics within 1e-2 and per-epoch losses
within 1e-2 relative; ``train_rg_real.main``: equal report keys, metrics
within 1e-2; ``slic_node_crossval``: per-image counts equal on ≥ 95 % of
the images and within 2 nodes on all, the numpy side's summary equal;
``fusion_quality_anchor``: ``jax_best_row`` equal on the committed
histories, ``build_dataset`` equal samples and labels, the reference
recipe's ``best`` row and history equal.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from test_torch_port_pipeline import few_threads  # noqa: E402,F401
from torch_port_cod10k import (  # noqa: E402
    link_kg_embeddings, rg_store, stand_in_fusion_module, write_tree)

import camouflage_multimodal_tpu.train.train_rg as J_train_rg  # noqa: E402
import camouflage_multimodal_tpu_torch.train.train_rg as T_train_rg  # noqa: E402
from camouflage_multimodal_tpu.models.region_graph import RegionGraphGNN as JRG  # noqa: E402
from camouflage_multimodal_tpu_torch.convert import region_graph_state_dict  # noqa: E402
from camouflage_multimodal_tpu_torch.core.artifacts import save_rg_embeddings  # noqa: E402
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN  # noqa: E402
from camouflage_multimodal_tpu_torch.scripts import (  # noqa: E402
    fidelity_gate as T_gate, fusion_quality_anchor as T_fqa, quality_anchor as T_qa,
    slic_node_crossval as T_cross, train_rg_real as T_rgreal)

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
METRIC_BAR = 1e-2


def _by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


J_qa = _by_path("jax_quality_anchor", "scripts/quality_anchor.py")
J_qa_gate = sys.modules["fidelity_gate"]          # the gate module J_qa imported
J_rgreal = _by_path("jax_train_rg_real", "scripts/train_rg_real.py")
J_cross = _by_path("jax_slic_node_crossval", "scripts/slic_node_crossval.py")
J_fqa = _by_path("jax_fusion_quality_anchor", "scripts/fusion_quality_anchor.py")


def _shared_init(mp):
    """Both packages' ``RGTrainer`` start from the JAX trainer's weights at
    ``PRNGKey(0)`` with dropout 0."""

    class JTrainer(J_train_rg.RGTrainer):
        def __init__(self, model=None, **kw):
            super().__init__(model=JRG(dropout=0.0, head_dropout=0.0), **kw)

    init = JTrainer().init_state(jax.random.PRNGKey(0))
    state_dict = region_graph_state_dict(init.params, init.batch_stats)

    class TTrainer(T_train_rg.RGTrainer):
        def __init__(self, model=None, **kw):
            model = RegionGraphGNN(dropout=0.0, head_dropout=0.0)
            model.load_state_dict(state_dict)
            super().__init__(model=model, **kw)

    mp.setattr(J_train_rg, "RGTrainer", JTrainer)
    mp.setattr(T_train_rg, "RGTrainer", TTrainer)


def _assert_metrics_close(got, want, what):
    assert set(got) == set(want), what
    for key, value in want.items():
        assert abs(got[key] - value) <= METRIC_BAR, (what, key, got[key], value)


# ---------------------------------------------------------------------------
# quality_anchor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def anchor(tmp_path_factory):
    """Both ``quality_anchor`` stages on one tree, with the same probe
    weights and gate report in both output roots; returns the histories
    and tables."""
    base = tmp_path_factory.mktemp("anchor")
    tree, work, port = str(base / "tree"), base / "jax", str(base / "port")
    write_tree(tree, n_cam=7, n_noncam=1, size=SIZE)
    j_fid = work / "artifacts" / "fidelity"
    j_fid.mkdir(parents=True)
    os.makedirs(T_gate.fidelity_dir(port))
    torch.manual_seed(3)
    T_gate.reference_side()
    from reference_impl import RefRegionGraphGNN

    probe = RefRegionGraphGNN().eval().state_dict()
    gate_report = {"iou_vs_gt_cam_only": {"ref": 0.25, "jax": 0.5}}
    for fid, root in ((str(j_fid), str(work / "artifacts")), (T_gate.fidelity_dir(port), port)):
        torch.save(probe, os.path.join(fid, f"best_model_{SIZE}.pth"))
        with open(os.path.join(root, f"fidelity_report_{SIZE}.json"), "w") as f:
            json.dump(gate_report, f)
    with pytest.MonkeyPatch.context() as mp:
        for module in (J_qa_gate, J_qa, T_gate):
            mp.setattr(module, "REF_DATA", tree)
        mp.setattr(J_qa, "OUT_DIR", str(j_fid))
        mp.chdir(work)
        _shared_init(mp)
        train, test = J_qa.quadruples(4, 4)
        assert (train, test) == T_gate.quadruples(4, 4)
        J_qa.stage_train(train, epochs=1, size=SIZE)
        T_qa.stage_train(train, epochs=1, size=SIZE, out=port, device="cpu")
        J_qa.stage_eval(test, size=SIZE)
        t_table = T_qa.stage_eval(test, size=SIZE, out=port, device="cpu")
    with open(work / "artifacts" / f"quality_table_{SIZE}.json") as f:
        j_table = json.load(f)
    with open(work / "artifacts" / "quality" / f"rg_jax_anchor_history_{SIZE}.json") as f:
        j_hist = json.load(f)
    with open(os.path.join(port, "quality", f"rg_jax_anchor_history_{SIZE}.json")) as f:
        t_hist = json.load(f)
    return {"port": port, "tables": (j_table, t_table), "histories": (j_hist, t_hist)}


def test_quality_anchor_train(anchor):
    """The train stage's history: same keys and epochs, losses within 1e-2
    relative, the anchor checkpoint where the eval stage reads it."""
    want, got = anchor["histories"]
    assert set(got) == set(want)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=METRIC_BAR, err_msg=key)
    assert os.path.exists(T_qa._ckpt(SIZE, anchor["port"]))


def test_quality_anchor_eval(anchor):
    """The table: the same rows and keys, every metric within 1e-2."""
    want, got = anchor["tables"]
    assert set(got) == set(want)
    assert (got["image_size"], got["n_held_out"]) == (want["image_size"], want["n_held_out"])
    rows_w, rows_g = want["rows"], got["rows"]
    assert set(rows_g) == set(rows_w) == {
        "reference_torch_trained_weights_in_jax_pipeline", "jax_trained",
        "reference_composed_pipeline_iou"}
    assert rows_g["reference_composed_pipeline_iou"] == rows_w["reference_composed_pipeline_iou"]
    for row in ("reference_torch_trained_weights_in_jax_pipeline", "jax_trained"):
        _assert_metrics_close(rows_g[row], rows_w[row], row)


# ---------------------------------------------------------------------------
# train_rg_real
# ---------------------------------------------------------------------------

def test_train_rg_real_main(monkeypatch, tmp_path):
    """``main`` with ``--eval-stride``: eight CAM images and one NonCAM,
    every fourth held out (the NonCAM one among them, so ``cam_only`` is a
    subset); the same files, report keys and metrics within 1e-2."""
    tree = str(tmp_path / "tree")
    write_tree(tree, n_cam=8, n_noncam=1, size=SIZE, seed=7)
    argv = ["--images", "6", "--eval-images", "3", "--eval-stride", "4", "--epochs", "1",
            "--batch-size", "4", "--image-size", str(SIZE), "--n-segments", "30",
            "--data-root", tree]
    _shared_init(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["train_rg_real.py"] + argv
                        + ["--out", str(tmp_path / "jax")])
    J_rgreal.main()
    got = T_rgreal.main(argv + ["--out", str(tmp_path / "port")], device="cpu")
    for name in ("rg_model.ckpt", "rg_training_history.json", "rg_eval_metrics.json"):
        assert (tmp_path / "jax" / name).exists() and (tmp_path / "port" / name).exists(), name
    with open(tmp_path / "jax" / "rg_eval_metrics.json") as f:
        want = json.load(f)
    assert set(got) == set(want) == {"protocol", "all", "cam_only"}
    assert got["protocol"] == want["protocol"]
    for part in ("all", "cam_only"):
        _assert_metrics_close(got[part], want[part], part)
    with open(tmp_path / "jax" / "rg_training_history.json") as f:
        j_hist = json.load(f)
    with open(tmp_path / "port" / "rg_training_history.json") as f:
        t_hist = json.load(f)
    assert set(t_hist) == set(j_hist)
    np.testing.assert_allclose(t_hist["train_loss"], j_hist["train_loss"], rtol=METRIC_BAR)


# ---------------------------------------------------------------------------
# slic_node_crossval
# ---------------------------------------------------------------------------

def test_slic_node_crossval_main(monkeypatch, tmp_path):
    """Both ``main``s against one summary in the reference's format over
    four scenes (counted at 256², 500 segments): the same report keys,
    per-image counts equal on ≥ 95 % of the images and within 2 nodes on
    all, the numpy reference port's summary equal."""
    tree = str(tmp_path / "tree")
    bases = write_tree(tree, n_cam=3, n_noncam=1, size=SIZE, seed=9)
    names = [b + ".jpg" for b in bases]
    summary = tmp_path / "embedding_summary.json"
    summary.write_text(json.dumps(
        {"images": {n: {"num_nodes": 470 + 9 * i} for i, n in enumerate(names)}}))
    img_dir = os.path.join(tree, "images")
    recorded = {}

    def recording(side, fn):
        def run(*args, **kw):
            recorded[side] = fn(*args, **kw)
            return recorded[side]
        return run

    for module, fn in ((J_cross, "jax_counts"), (T_cross, "counts")):
        monkeypatch.setattr(module, "REF_SUMMARY", str(summary))
        monkeypatch.setattr(module, "IMG_DIR", img_dir)
        monkeypatch.setattr(module, fn, recording(module.__name__, getattr(module, fn)))
    monkeypatch.setattr(J_cross, "OUT_PATH", str(tmp_path / "jax" / "slic_node_crossval.json"))
    argv = ["--np-sample", "1", "--batch-size", "2"]
    monkeypatch.setattr(sys, "argv", ["slic_node_crossval.py"] + argv)
    J_cross.main()
    got = T_cross.main(argv + ["--out", str(tmp_path / "port")], device="cpu")
    with open(tmp_path / "jax" / "slic_node_crossval.json") as f:
        want = json.load(f)
    assert set(got) == set(want)
    assert set(got["jax_vs_skimage"]) == set(want["jax_vs_skimage"])
    assert got["npport_vs_skimage"] == want["npport_vs_skimage"]
    j_counts, t_counts = recorded[J_cross.__name__], recorded[T_cross.__name__]
    assert list(t_counts) == list(j_counts) == names
    equal = np.mean([t_counts[n] == j_counts[n] for n in names])
    assert equal >= 0.95, (t_counts, j_counts)
    assert all(abs(t_counts[n] - j_counts[n]) <= 2 for n in names), (t_counts, j_counts)


# ---------------------------------------------------------------------------
# fusion_quality_anchor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("history", ["checkpoints", "checkpoints_balanced"])
def test_jax_best_row_on_the_committed_histories(history):
    path = os.path.join(REPO, "artifacts", history, "training_history_fixed.json")
    assert T_fqa.jax_best_row(path) == J_fqa.jax_best_row(path) is not None
    assert T_fqa.jax_best_row(path + ".missing") is None


@pytest.fixture
def fusion_tree(monkeypatch, tmp_path):
    """A tree, a seeded RG store of its images and the committed KG
    embeddings under a stand-in repo root the JAX script reads
    (``REPO/artifacts/...``), the committed FusionTrainer histories beside
    them, the stand-in fusion model."""
    tree = str(tmp_path / "tree")
    bases = write_tree(tree, n_cam=8, n_noncam=2, size=32, seed=11)
    root = tmp_path / "repo"
    link_kg_embeddings(root)
    rg = root / "artifacts" / "rg_embeddings" / "all_rg_embeddings.npz"
    save_rg_embeddings(str(rg), rg_store(np.random.default_rng(4), [b + ".jpg" for b in bases]))
    for history in ("checkpoints", "checkpoints_balanced"):
        dst = root / "artifacts" / history / "training_history_fixed.json"
        dst.parent.mkdir(parents=True)
        dst.symlink_to(os.path.join(REPO, "artifacts", history, "training_history_fixed.json"))
    monkeypatch.setattr(J_fqa, "REPO", str(root))
    for module in (J_fqa, T_gate):
        monkeypatch.setattr(module, "REF_DATA", tree)
    monkeypatch.setattr(T_fqa, "RG_EMBEDDINGS", str(rg))
    stand_in_fusion_module(monkeypatch, tmp_path)
    return {"root": root, "rg": str(rg)}


def test_fusion_build_dataset(fusion_tree):
    """Equal samples (names, embeddings, labels, confidences, edge and
    score labels) in the same order."""
    want = J_fqa.build_dataset()
    got = T_fqa.build_dataset()
    assert len(got.samples) == len(want.samples) == 10
    for g, w in zip(got.samples, want.samples):
        assert set(g) == set(w) and g["image_name"] == w["image_name"]
        for key, value in w.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(g[key], value, err_msg=key)
            else:
                assert g[key] == value, key
    assert got.get_aggressive_sample_weights() == want.get_aggressive_sample_weights()


def test_fusion_quality_anchor_main(monkeypatch, fusion_tree, tmp_path):
    """One epoch of the reference recipe with the stand-in model through
    both ``main``s: the same ``fusion`` table and history."""
    monkeypatch.setattr(sys, "argv", ["fusion_quality_anchor.py", "--epochs", "1"])
    monkeypatch.setattr(T_fqa, "HISTORIES", {
        k: os.path.join(fusion_tree["root"], "artifacts", d, "training_history_fixed.json")
        for k, d in (("jax_trainer_default", "checkpoints"),
                     ("jax_trainer_balanced", "checkpoints_balanced"))})
    J_fqa.main()
    got = T_fqa.main(["--epochs", "1", "--out", str(tmp_path / "port")])
    art = fusion_tree["root"] / "artifacts"
    with open(art / "quality_table.json") as f:
        want = json.load(f)
    assert got["fusion"] == want["fusion"]
    assert got["fusion"]["rows"]["jax_trainer_default"] is not None
    with open(art / "fusion_anchor_history.json") as f:
        j_hist = json.load(f)
    with open(tmp_path / "port" / "fusion_anchor_history.json") as f:
        assert json.load(f) == j_hist
