"""The port's fidelity gate (``camouflage_multimodal_tpu_torch.scripts.
fidelity_gate``) against the JAX system's ``scripts/fidelity_gate.py``, on
the CPU, stage by stage on one seeded tree in COD10K's layout (seven CAM
scenes and one NonCAM scene of 64², ``tests/torch_port_cod10k.py``).

The JAX script is loaded by path; its module constants (``REF_DATA``,
``OUT_DIR``, ``CACHE``) point at the tree and at ``tmp_path``, and it runs
in a working directory of its own, where it writes its ``artifacts/``.
The port writes under its ``out`` root. The fusion stages load a stand-in
for the reference's ``fusion_model.py`` through the loader both scripts
call.

Bars: both sides' ``quadruples`` give the same splits; ``graphs`` writes
equal npz files; ``train`` equal state dicts; ``compare``: the pipelines'
segment maps ≥ 99 % equal with heatmap MAE ≤ 1e-2 (``_compare_slice``'s
bars) and the reports' pixel agreements and model-only agreement within
1e-2; ``fusion-train`` equal state dicts; ``fusion-compare``: the
``composed`` and ``fusion_model_only`` fields within 1e-3.
"""

import glob
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from test_torch_port_pipeline import few_threads  # noqa: E402,F401
from torch_port_cod10k import link_kg_embeddings, stand_in_fusion_module, write_tree  # noqa: E402

import camouflage_multimodal_tpu.pipeline as J_pipeline  # noqa: E402
import camouflage_multimodal_tpu_torch.pipeline as T_pipeline  # noqa: E402
from camouflage_multimodal_tpu_torch.scripts import fidelity_gate as T_gate  # noqa: E402

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SEGMENTS = 64, 100            # the gate's graphs / train / compare stages
N_TRAIN, N_TEST = 4, 4
FUSION_TRAIN, FUSION_TEST = 3, 2    # images of the 256² fusion stages
AGREEMENT_BAR = 1e-2
FUSION_BAR = 1e-3
REPORT_AGREEMENTS = ("pixel_agreement_vs_reference_verbatim_paintback",
                     "pixel_agreement_vs_reference_corrected_paintback",
                     "model_only_node_agreement")


def _by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


J_gate = _by_path("jax_fidelity_gate", "scripts/fidelity_gate.py")


def _recording(cls, calls):
    """A subclass of a pipeline class that keeps every call's outputs."""

    class Recording(cls):
        def __call__(self, *args):
            out = super().__call__(*args)
            calls.append(out)
            return out

    return Recording


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every stage of both scripts on one tree: (JAX side root, port out
    root, the splits, the pipelines' recorded outputs, the reports)."""
    base = tmp_path_factory.mktemp("gate")
    tree, jax_work, port_out = str(base / "tree"), base / "jax", str(base / "port")
    write_tree(tree, n_cam=7, n_noncam=1, size=SIZE)
    jax_out = jax_work / "artifacts" / "fidelity"
    jax_out.mkdir(parents=True)
    link_kg_embeddings(jax_work)
    j_calls, t_calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J_gate, "REF_DATA", tree)
        mp.setattr(J_gate, "OUT_DIR", str(jax_out))
        mp.setattr(J_gate, "CACHE", str(jax_out / "graphs"))
        mp.setattr(T_gate, "REF_DATA", tree)
        mp.chdir(jax_work)
        stand_in_fusion_module(mp, base)
        mp.setattr(J_pipeline, "RegionGraphPipeline",
                   _recording(J_pipeline.RegionGraphPipeline, j_calls))
        mp.setattr(T_pipeline, "RegionGraphPipeline",
                   _recording(T_pipeline.RegionGraphPipeline, t_calls))

        splits = {s: (J_gate.quadruples(N_TRAIN, N_TEST, s), T_gate.quadruples(N_TRAIN, N_TEST, s))
                  for s in ("stratified", "sorted")}
        train, test = splits["stratified"][1]
        J_gate.stage_graphs(train + test, n_segments=SEGMENTS, size=SIZE)
        T_gate.stage_graphs(train + test, n_segments=SEGMENTS, size=SIZE, out=port_out)
        J_gate.stage_train(train, epochs=2, size=SIZE, pos_weight=2.0)
        T_gate.stage_train(train, epochs=2, size=SIZE, pos_weight=2.0, out=port_out)
        J_gate.stage_compare(test, n_segments=SEGMENTS, size=SIZE)
        t_report = T_gate.stage_compare(test, n_segments=SEGMENTS, size=SIZE, out=port_out,
                                        device="cpu")
        with open(jax_work / "artifacts" / f"fidelity_report_{SIZE}.json") as f:
            j_report = json.load(f)

        # The fusion stages: 256² graphs built once by the port and shared.
        f_train, f_test = train[:FUSION_TRAIN], test[-FUSION_TEST:]
        T_gate.stage_graphs(f_train + f_test, size=256, out=port_out)
        shutil.copytree(T_gate.cache_dir(256, port_out), J_gate.CACHE)
        J_gate.stage_train(f_train, epochs=2)
        T_gate.stage_train(f_train, epochs=2, out=port_out)
        J_gate.stage_fusion_train(f_train, epochs=2)
        T_gate.stage_fusion_train(f_train, epochs=2, out=port_out)
        J_gate.stage_fusion_compare(f_test)
        t_fusion = T_gate.stage_fusion_compare(f_test, out=port_out, device="cpu")
        with open(jax_work / "artifacts" / "fidelity_fusion_report.json") as f:
            j_fusion = json.load(f)
    return {"jax": str(jax_out), "port": port_out, "splits": splits, "test": test,
            "calls": (j_calls, t_calls), "reports": (j_report, t_report),
            "fusion": (j_fusion, t_fusion)}


@pytest.mark.parametrize("split", ["stratified", "sorted"])
def test_quadruples_give_the_same_split(runs, split):
    """Both ``quadruples`` give the same (base, image, GT) lists; the
    stratified split spans every environment and the NonCAM image."""
    (j_train, j_test), (t_train, t_test) = runs["splits"][split]
    assert (t_train, t_test) == (j_train, j_test)
    assert len(t_train) == N_TRAIN and len(t_test) == N_TEST
    assert not {b for b, *_ in t_train} & {b for b, *_ in t_test}
    if split == "stratified":
        cats = {T_gate.category_of(b) for b, *_ in t_train + t_test}
        assert cats == {"Aquatic", "Terrestrial", "Flying", "Amphibian", "NonCAM"}


def test_graphs_write_equal_npz(runs):
    """The same files with equal arrays under both caches."""
    j_dir = os.path.join(runs["jax"], f"graphs_{SIZE}")
    t_dir = T_gate.cache_dir(SIZE, runs["port"])
    names = sorted(os.listdir(j_dir))
    assert names == sorted(os.listdir(t_dir)) and len(names) == N_TRAIN + N_TEST
    for name in names:
        with np.load(os.path.join(j_dir, name)) as a, np.load(os.path.join(t_dir, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", [f"best_model_{SIZE}.pth", "best_model.pth",
                                  "region_graph_model.pth"])
def test_train_gives_equal_state_dicts(runs, name):
    """The reference recipe on both sides: equal weights and probe config."""
    a = torch.load(os.path.join(runs["jax"], name), weights_only=True)
    b = torch.load(os.path.join(T_gate.fidelity_dir(runs["port"]), name), weights_only=True)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    if name.startswith("best_model"):
        with open(os.path.join(runs["jax"], name + ".config.json")) as f:
            want = json.load(f)
        with open(os.path.join(T_gate.fidelity_dir(runs["port"]), name + ".config.json")) as f:
            assert json.load(f) == want


def test_compare_pipelines_agree(runs):
    """The compare stages' own pipeline outputs: segment maps ≥ 99 % equal
    and heatmap MAE ≤ 1e-2 on the held-out images (the JAX batch is padded
    to 10, the port's is not)."""
    j_calls, t_calls = runs["calls"]
    assert len(j_calls) == len(t_calls) == 1
    n = len(runs["test"])
    want = {k: np.asarray(j_calls[0][k])[:n] for k in ("segments", "heatmap")}
    got = {k: t_calls[0][k].numpy() for k in ("segments", "heatmap")}
    assert got["segments"].shape == want["segments"].shape == (n, SIZE, SIZE)
    assert (got["segments"] == want["segments"]).mean() >= 0.99
    assert np.abs(got["heatmap"] - want["heatmap"]).mean() <= 1e-2


def test_compare_reports_agree(runs):
    """The same report keys; pixel agreements and model-only agreement
    within 1e-2, per image too; the same images, categories and probe
    config; the NonCAM image left out of the IoU."""
    want, got = runs["reports"]
    assert set(got) == set(want)
    assert set(got["gate"]) == set(want["gate"])
    for key in REPORT_AGREEMENTS:
        assert abs(got[key] - want[key]) <= AGREEMENT_BAR, key
    assert abs(got["heatmap_mae_vs_reference"] - want["heatmap_mae_vs_reference"]) <= 1e-2
    assert got["probe_training_config"] == want["probe_training_config"]
    assert list(got["per_category"]) == list(want["per_category"])
    assert "NonCAM" in got["per_category"]
    for g, w in zip(got["per_image"], want["per_image"]):
        assert (g["image"], g["category"]) == (w["image"], w["category"])
        for key in ("pixel_agreement_corrected", "model_node_agreement"):
            assert abs(g[key] - w[key]) <= AGREEMENT_BAR, (g["image"], key)
    for t, rec in want["agreement_by_threshold"].items():
        assert abs(got["agreement_by_threshold"][t]["pixel_agreement"]
                   - rec["pixel_agreement"]) <= AGREEMENT_BAR, t


def test_fusion_train_gives_equal_state_dicts(runs):
    """The reference's fusion recipe on both sides: equal weights."""
    a = torch.load(os.path.join(runs["jax"], "multimodal_best.pth"), weights_only=True)
    b = torch.load(os.path.join(T_gate.fidelity_dir(runs["port"]), "multimodal_best.pth"),
                   weights_only=True)
    assert a["config"] == b["config"] and a["epoch"] == b["epoch"]
    assert a["model_state_dict"].keys() == b["model_state_dict"].keys()
    for key, value in a["model_state_dict"].items():
        assert torch.equal(value, b["model_state_dict"][key]), key


def test_fusion_compare_reports_agree(runs):
    """The same report keys; every ``composed`` and ``fusion_model_only``
    field within 1e-3."""
    want, got = runs["fusion"]
    assert set(got) == set(want) and got["n_test_images"] == FUSION_TEST
    for part in ("composed", "fusion_model_only"):
        assert set(got[part]) == set(want[part])
        for key, value in want[part].items():
            assert abs(got[part][key] - value) <= FUSION_BAR, (part, key)
    assert [r["image"] for r in got["per_image"]] == [r["image"] for r in want["per_image"]]


@pytest.mark.parametrize("stage", ["fusion-train", "fusion-compare"])
def test_fusion_stages_refuse_another_size(monkeypatch, tmp_path, stage):
    """``--stage fusion-*`` with ``--size`` other than 256 is a usage error
    on both sides, before any stage runs."""
    write_tree(str(tmp_path / "tree"), n_cam=2, n_noncam=0, size=32)
    monkeypatch.setattr(J_gate, "REF_DATA", str(tmp_path / "tree"))
    monkeypatch.setattr(T_gate, "REF_DATA", str(tmp_path / "tree"))
    argv = ["--stage", stage, "--size", "64", "--n-train", "1", "--n-test", "1"]
    monkeypatch.setattr(sys, "argv", ["fidelity_gate.py"] + argv)
    with pytest.raises(SystemExit) as j_exit:
        J_gate.main()
    with pytest.raises(SystemExit) as t_exit:
        T_gate.main(argv + ["--out", str(tmp_path / "port")], device="cpu")
    assert t_exit.value.code == j_exit.value.code == 2
    assert not glob.glob(str(tmp_path / "port" / "*"))
