"""Where the port's quality and fidelity scripts write, on the CPU.

Each of ``fidelity_gate``, ``quality_anchor``, ``train_rg_real``,
``slic_node_crossval`` and ``fusion_quality_anchor`` of
``camouflage_multimodal_tpu_torch.scripts`` runs its ``main`` once, small,
on a seeded tree in COD10K's layout (``tests/torch_port_cod10k.py``) with
``--out`` in ``tmp_path``: its outputs land under that root with the JAX
script's names, and no file under the repo's ``artifacts/`` (where the
JAX scripts write their committed reports) is added, removed or touched.
The default root is the repo's ``artifacts/torch_port/``, which git
ignores. Their agreement with the JAX scripts is held in
``tests/test_torch_port_fidelity.py`` and ``tests/test_torch_port_quality.py``.
"""

import json
import os

import numpy as np
import pytest

from test_torch_port_pipeline import few_threads  # noqa: F401
from torch_port_cod10k import rg_store, snapshot, stand_in_fusion_module, write_tree

from camouflage_multimodal_tpu_torch.core.artifacts import save_rg_embeddings
from camouflage_multimodal_tpu_torch.scripts import (
    fidelity_gate, fusion_quality_anchor, quality_anchor, slic_node_crossval, train_rg_real)

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"fidelity_gate": fidelity_gate, "quality_anchor": quality_anchor,
           "train_rg_real": train_rg_real, "slic_node_crossval": slic_node_crossval,
           "fusion_quality_anchor": fusion_quality_anchor}
OUTPUTS = {
    "fidelity_gate": ["fidelity/graphs_32", "fidelity/best_model_32.pth",
                      "fidelity/best_model_32.pth.config.json", "fidelity_report_32.json"],
    "quality_anchor": ["quality/rg_jax_anchor_32.ckpt",
                       "quality/rg_jax_anchor_history_32.json", "quality_table_32.json"],
    "train_rg_real": ["rg_model.ckpt", "rg_training_history.json", "rg_eval_metrics.json"],
    "slic_node_crossval": ["slic_node_crossval.json"],
    "fusion_quality_anchor": ["quality_table.json", "fusion_anchor_history.json"],
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mains") / "tree")
    return root, write_tree(root, n_cam=7, n_noncam=1, size=32, seed=13)


def _small_run(script, root, bases, tmp_path, monkeypatch):
    """(argv, keyword arguments) of a small run of ``script`` on the tree."""
    monkeypatch.setattr(fidelity_gate, "REF_DATA", root)
    cpu = {"device": "cpu"}
    if script in ("fidelity_gate", "quality_anchor"):
        return ["--size", "32", "--n-train", "4", "--n-test", "4", "--epochs", "1"], cpu
    if script == "train_rg_real":
        return ["--data-root", root, "--images", "5", "--eval-images", "3", "--epochs", "1",
                "--batch-size", "4", "--image-size", "32", "--n-segments", "16"], cpu
    if script == "slic_node_crossval":
        summary = tmp_path / "summary.json"
        summary.write_text(json.dumps({"images": {b + ".jpg": {"num_nodes": 500}
                                                  for b in bases[:2]}}))
        monkeypatch.setattr(slic_node_crossval, "REF_SUMMARY", str(summary))
        monkeypatch.setattr(slic_node_crossval, "IMG_DIR", os.path.join(root, "images"))
        return ["--np-sample", "1", "--batch-size", "2"], cpu
    rg = str(tmp_path / "all_rg_embeddings.npz")
    save_rg_embeddings(rg, rg_store(np.random.default_rng(5), [b + ".jpg" for b in bases]))
    monkeypatch.setattr(fusion_quality_anchor, "RG_EMBEDDINGS", rg)
    stand_in_fusion_module(monkeypatch, tmp_path)
    return ["--epochs", "1"], {}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_main_writes_only_under_out(monkeypatch, tmp_path, tree, script):
    """The script's outputs under ``--out`` with the JAX names; the repo's
    ``artifacts/`` unchanged (paths, sizes and modification times)."""
    argv, kw = _small_run(script, *tree, tmp_path, monkeypatch)
    artifacts = os.path.join(REPO, "artifacts")
    before = snapshot(artifacts)
    out = str(tmp_path / "out")
    SCRIPTS[script].main(argv + ["--out", out], **kw)
    assert snapshot(artifacts) == before
    for rel in OUTPUTS[script]:
        assert os.path.exists(os.path.join(out, rel)), rel


def test_default_output_root_is_ignored():
    """The scripts' default root is the repo's ``artifacts/torch_port/``,
    which ``.gitignore`` lists."""
    assert fidelity_gate.OUT == os.path.join(REPO, "artifacts", "torch_port")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "artifacts/torch_port/" in f.read().split()
