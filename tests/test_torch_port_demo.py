"""The port's full-chain demo (``camouflage_multimodal_tpu_torch/scripts/
full_pipeline_demo.py``, the JAX system's ``scripts/full_pipeline_demo.sh``)
on the CPU: one run on a seeded reference tree in COD10K's layout (8 CAM
and 1 NonCAM images at 64², 24 annotations, 3 test images; one epoch each,
two test images), every stage held against the JAX CLI on the same inputs.

Bars: ``extract-rg`` segment maps ≥ 99 % equal and, where an image's maps
are equal, node counts equal and embeddings within 1e-2 (the bar of
``chip_smoke.py``'s workflow phase: these smooth scenes leave segments
whose colour std is a few thousandths, where float32 variances in another
summation order move the std features by 1e-4 and the trained GNN carries
that to about 5e-3; tests/test_torch_port_walks.py holds 5e-4 on textured
96² scenes); ``ingest-kg`` store and log equal;
``extract-kg`` of the JAX CLI on the port's KG checkpoint within 1e-5;
the port's fusion checkpoint read by the JAX loader to the same arrays;
``test-multimodal`` of the JAX CLI on the port's fusion checkpoint and KG
embeddings: classes equal, scores within 1e-3 where the segment maps agree.
The segment maps come from spies on the extraction (``save_individual``)
and on ``MultimodalPredictor.predict_batch`` of both packages.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu import api as J_api  # noqa: E402
from camouflage_multimodal_tpu import cli as J_cli  # noqa: E402
from camouflage_multimodal_tpu_torch import api as T_api  # noqa: E402
from camouflage_multimodal_tpu_torch import cli  # noqa: E402
from camouflage_multimodal_tpu_torch import extract as T_extract  # noqa: E402
from camouflage_multimodal_tpu_torch.convert import fusion_state_dict  # noqa: E402
from camouflage_multimodal_tpu_torch.core.artifacts import load_rg_embeddings  # noqa: E402
from camouflage_multimodal_tpu_torch.scripts import full_pipeline_demo as demo  # noqa: E402
from test_torch_port_cli import _annotation  # noqa: E402
from test_torch_port_pipeline import ARTIFACTS, few_threads  # noqa: E402,F401
from torch_port_cod10k import REPO, categories, snapshot, write_tree  # noqa: E402

pytestmark = pytest.mark.usefixtures("few_threads")

TEST_IMAGES = 2               # of 3 in test_images: the cut is exercised
SCORE_BAR = 1e-3              # chip_smoke.py's BENCH_FUSION_BAR
EMBEDDING_BAR = 1e-2          # chip_smoke.py's workflow phase, card vs CPU (module docstring)
BANNERS = ["=== [1/6] extract RG embeddings (256 images, trained model) ===",
           "=== [2/6] ingest full KG ===", "=== [3/6] train KG GNN ===",
           "=== [4/6] extract KG category embeddings ===", "=== [5/6] train fusion ===",
           "=== [6/6] batch multimodal inference on test images ===", "=== DONE ==="]


def write_reference(root):
    """The reference's layout under ``root``: COD10K, annotations over four
    of the tree's organisms, test images. Returns the tree's image bases."""
    bases = write_tree(os.path.join(root, "data", "COD10K"), n_cam=8, n_noncam=1, size=64)
    annotations = os.path.join(root, "models", "knowledge_graph", "annotations")
    os.makedirs(annotations)
    rng = np.random.default_rng(5)
    for category in categories()[:4]:
        for i in range(6):
            with open(os.path.join(annotations, f"{category.lower()}_{i:02d}.json"), "w") as f:
                json.dump(_annotation(rng, category, i), f)
    extra = os.path.join(root, "extra")
    write_tree(extra, n_cam=3, n_noncam=0, size=64, seed=9)
    os.rename(os.path.join(extra, "images"), os.path.join(root, "test_images"))
    return bases


def watched(root):
    """What the demo must leave alone: the reference tree, the repo's
    top-level files and its committed ``artifacts/`` (the shell script
    wrote into the latter)."""
    top = sorted((n, os.stat(REPO / n).st_mtime_ns) for n in os.listdir(REPO)
                 if (REPO / n).is_file())
    arts = [s for s in snapshot(REPO / "artifacts")
            if not s[0].startswith(str(REPO / "artifacts" / "torch_port"))]
    return snapshot(root), top, arts, os.path.exists(demo.OUT)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One demo run on the CPU with spies on the extraction and the
    predictor; returns its paths, printed lines, the segment maps step 6
    computed and the watched state before and after."""
    root = tmp_path_factory.mktemp("reference")
    bases = write_reference(str(root))
    out = str(tmp_path_factory.mktemp("demo"))
    segments = []
    extract, predict = T_extract.batch_extract_embeddings, T_api.MultimodalPredictor.predict_batch

    def spy_predict(self, images):
        result = predict(self, images)
        segments.append(result["segments"])
        return result

    before = watched(root)
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T_extract, "batch_extract_embeddings",
                   lambda *a, **k: extract(*a, **{**k, "save_individual": True}))
        mp.setattr(T_api.MultimodalPredictor, "predict_batch", spy_predict)
        with contextlib.redirect_stdout(printed):
            demo.main(["--reference", str(root), "--out", out, "--kg-epochs", "1",
                       "--fusion-epochs", "1", "--test-images", str(TEST_IMAGES)], device="cpu")
    return {"root": str(root), "out": out, "bases": bases, "segments": np.concatenate(segments),
            "printed": printed.getvalue().splitlines(), "before": before,
            "after": watched(root)}


def _jax(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        J_cli.main(argv)


def test_demo_runs_the_six_steps_in_order(run):
    """The banners in the shell script's order, and every step's files."""
    assert [ln for ln in run["printed"] if ln.startswith("===")] == BANNERS
    out = run["out"]
    for path in ("rg_embeddings/all_rg_embeddings.npz", "rg_embeddings/embedding_summary.json",
                 "kg_store.pkl", "processed_files.txt", "kg_gnn_model.ckpt",
                 "kg_embeddings/all_embeddings.npz", "kg_embeddings/summary.json",
                 "fusion_config.yaml", "checkpoints/multimodal_best_fixed.ckpt",
                 "checkpoints/training_history_fixed.json", "results/batch_results.json"):
        assert os.path.exists(os.path.join(out, path)), path
    tested = sorted(os.listdir(os.path.join(run["root"], "test_images")))[:TEST_IMAGES]
    assert sorted(f for f in os.listdir(os.path.join(out, "results"))
                  if f.startswith("pred_")) == [f"pred_{n}" for n in tested]


def test_demo_writes_only_under_out(run):
    assert run["after"] == run["before"]


def test_extract_rg_matches_jax(run, tmp_path):
    """Step 1's store against the JAX CLI's ``extract-rg`` on the same files."""
    jax_dir = str(tmp_path / "rg")
    _jax(["extract-rg", "--model", ARTIFACTS[1], "--image-dir",
          os.path.join(run["root"], "data", "COD10K", "images"), "--output", jax_dir,
          "--max-images", "256", "--batch-size", "16", "--save-individual"])
    port_dir = os.path.join(run["out"], "rg_embeddings")
    stores = [load_rg_embeddings(os.path.join(d, "all_rg_embeddings.npz"))
              for d in (port_dir, jax_dir)]
    names = [b + ".jpg" for b in run["bases"]]
    assert list(stores[0]) == list(stores[1]) == names
    equal = 0
    for name in names:
        base = os.path.splitext(name)[0]
        with np.load(os.path.join(port_dir, f"{base}_embedding.npz")) as a, \
                np.load(os.path.join(jax_dir, f"{base}_embedding.npz")) as b:
            seg_eq = (a["segments"] == b["segments"]).mean()
        assert seg_eq >= 0.99, name
        if seg_eq < 1:
            continue
        equal += 1
        got, want = stores[0][name], stores[1][name]
        assert got["num_nodes"] == want["num_nodes"]
        for key in ("node_embeddings", "graph_embedding"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=EMBEDDING_BAR,
                                       err_msg=key)
    assert equal >= len(names) // 2


def test_ingest_kg_matches_jax(run, tmp_path):
    """Step 2's store and log equal to the JAX CLI's."""
    store, log = str(tmp_path / "kg_store.pkl"), str(tmp_path / "processed_files.txt")
    _jax(["ingest-kg", "--annotations",
          os.path.join(run["root"], "models", "knowledge_graph", "annotations"),
          "--output", store, "--processed-log", log])
    for ours, theirs in ((os.path.join(run["out"], "kg_store.pkl"), store),
                         (os.path.join(run["out"], "processed_files.txt"), log)):
        with open(ours) as a, open(theirs) as b:
            assert a.read() == b.read()


def test_extract_kg_matches_jax(run, tmp_path):
    """The JAX CLI's ``extract-kg`` on step 3's checkpoint and step 2's store:
    step 4's embeddings within 1e-5, the same summary."""
    out = run["out"]
    _jax(["extract-kg", "--model", os.path.join(out, "kg_gnn_model.ckpt"), "--store",
          os.path.join(out, "kg_store.pkl"), "--output", str(tmp_path)])
    with np.load(os.path.join(out, "kg_embeddings", "all_embeddings.npz")) as a, \
            np.load(tmp_path / "all_embeddings.npz") as b:
        assert a.files == b.files and len(a.files) == 4
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)
    with open(os.path.join(out, "kg_embeddings", "summary.json")) as a, \
            open(tmp_path / "summary.json") as b:
        assert json.load(a) == json.load(b)


def test_fusion_checkpoint_reads_in_jax(run):
    """Step 5's best checkpoint: the JAX loader gives the port's arrays and
    config, with the shell script's epochs and batch size."""
    ckpt = os.path.join(run["out"], "checkpoints", "multimodal_best_fixed.ckpt")
    _, variables, config = J_api.load_multimodal_model(ckpt)
    model, t_config = T_api.load_multimodal_model(ckpt, "cpu")
    assert t_config == config and (config["epochs"], config["batch_size"]) == (1, 8)
    want = fusion_state_dict(variables["params"])
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], torch.as_tensor(np.asarray(want[k])), rtol=0, atol=0)


def test_test_multimodal_matches_jax(run, tmp_path, monkeypatch):
    """The JAX CLI's ``test-multimodal`` on step 5's checkpoint and step 4's
    embeddings: the same images and classes; scores within 1e-3 where the
    segment maps agree."""
    out = run["out"]
    segments = []
    predict = J_api.MultimodalPredictor.predict_batch

    def spy(self, images):
        result = predict(self, images)
        segments.append(result["segments"])
        return result

    monkeypatch.setattr(J_api.MultimodalPredictor, "predict_batch", spy)
    _jax(["test-multimodal", "--checkpoint",
          os.path.join(out, "checkpoints", "multimodal_best_fixed.ckpt"),
          "--rg-model", ARTIFACTS[1], "--kg-embeddings",
          os.path.join(out, "kg_embeddings", "all_embeddings.npz"),
          "--image-dir", os.path.join(run["root"], "test_images"),
          "--max-images", str(TEST_IMAGES), "--output", str(tmp_path)])
    with open(os.path.join(out, "results", "batch_results.json")) as a, \
            open(tmp_path / "batch_results.json") as b:
        got, want = json.load(a), json.load(b)
    assert [r["image"] for r in got] == [r["image"] for r in want] and len(got) == TEST_IMAGES
    agree = (np.concatenate(segments) == run["segments"]).reshape(
        len(run["segments"]), -1).all(axis=1)
    assert agree[:TEST_IMAGES].any()
    for g, w, same in zip(got, want, agree):
        assert (g["prediction"], g["pred_label"]) == (w["prediction"], w["pred_label"])
        if same:
            for k in ("camo_prob", "not_camo_prob", "score"):
                assert abs(g[k] - w[k]) <= SCORE_BAR, (g["image"], k, g[k], w[k])


def test_demo_stops_at_the_first_failing_step(run, tmp_path):
    """Without annotations the run raises in step 2 (the script's ``set
    -e``) and writes nothing of steps 2-6."""
    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "data").symlink_to(os.path.join(run["root"], "data"))
    out = tmp_path / "out"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), pytest.raises(FileNotFoundError):
        demo.main(["--reference", str(ref), "--out", str(out), "--max-images", "1"],
                  device="cpu")
    assert [ln for ln in printed.getvalue().splitlines() if ln.startswith("===")] == [
        "=== [1/6] extract RG embeddings (1 images, trained model) ===", BANNERS[1]]
    assert sorted(os.listdir(out)) == ["rg_embeddings"]


def test_demo_help_shows_the_script_defaults(capsys):
    with pytest.raises(SystemExit):
        demo.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    for flag, default in (("--reference", "."), ("--max-images", "256"), ("--kg-epochs", "20"),
                          ("--fusion-epochs", "12"), ("--test-images", "8"),
                          ("--device", "cuda"), ("--out", demo.OUT)):
        assert flag in text and f"(default: {default})" in text, flag


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the card's absence")
def test_demo_on_cuda_raises_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="is_available"):
        demo.main(["--out", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")


def test_ingest_kg_rerun_keeps_the_store(tmp_path, capsys):
    """A second ``ingest-kg`` with the same log and output (the demo run
    again into one ``--out``) skips every logged file and keeps the store
    it wrote; it started empty before, so step 3 of a rerun found no
    samples."""
    annotations = tmp_path / "annotations"
    annotations.mkdir()
    rng = np.random.default_rng(2)
    for i in range(4):
        with open(annotations / f"bird_{i}.json", "w") as f:
            json.dump(_annotation(rng, "Bird", i), f)
    argv = ["ingest-kg", "--annotations", str(annotations), "--output",
            str(tmp_path / "store.pkl"), "--processed-log", str(tmp_path / "log.txt")]
    cli.main(argv)
    first = (tmp_path / "store.pkl").read_text()
    cli.main(argv)
    assert "Success: 0, Failed: 0" in capsys.readouterr().out.splitlines()[-1]
    assert (tmp_path / "store.pkl").read_text() == first
    assert len(json.loads(first)["organisms"]) > 0
