"""The port's ten CLI subcommands (``camouflage_multimodal_tpu_torch/cli.py``)
through ``cli.main([..., "--device", "cpu"])`` at a small size, held against
the JAX CLI where its CPU run is cheap.

Bars: ``ingest-kg`` stores equal; ``extract-kg`` embeddings within 1e-5 on
the same checkpoint; ``evaluate`` metrics within the workflow tests' 1e-3
(tests/test_torch_port_workflow.py); the checkpoints that ``train-rg``,
``train-kg`` and ``train-fusion`` write read by the JAX package's loaders
to the same arrays as by the port's.
"""

import io
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu import api as J_api  # noqa: E402
from camouflage_multimodal_tpu import cli as J_cli  # noqa: E402
from camouflage_multimodal_tpu_torch import api as T_api  # noqa: E402
from camouflage_multimodal_tpu_torch import cli  # noqa: E402
from camouflage_multimodal_tpu_torch import serve as T_serve  # noqa: E402
from camouflage_multimodal_tpu_torch.convert import (  # noqa: E402
    fusion_state_dict, region_graph_state_dict)
from test_torch_port_pipeline import (  # noqa: E402, F401
    ARTIFACTS, few_threads, synthetic_images)

pytestmark = pytest.mark.usefixtures("few_threads")

SIZE = 64
N_IMAGES = 4
CATEGORIES = ("Crustacean", "Bird", "Fish", "Insect")
RESPONSE_KEYS = {"mask_pred", "mask_prob", "instance_pred", "edge_prob", "score",
                 "classification", "latency_ms"}


def _annotation(rng, category, i):
    colours = ("green", "brown", "gray", "white", "dark green", "orange")
    textures = ("rough", "smooth", "scaly", "rocky", "bumpy")
    levels = ("high", "medium", "low")
    c, t = rng.choice(colours, 2, replace=False), rng.choice(textures, 2, replace=False)
    return {"object_name": f"{category}{i % 3}", "object_category": category,
            "background_description": f"a forest floor with {c[1]} patches",
            "explanation": f"Its {c[0]} body has a {t[0]}, {t[1]} surface",
            "camouflage_type": "mottled",
            "camouflage_presence": "Camouflage" if rng.random() < 0.7 else "None",
            "color_similarity": str(rng.choice(levels)),
            "texture_similarity": str(rng.choice(levels)),
            "contrast_difference": str(rng.choice(levels)),
            "camouflage_score": float(np.round(rng.random(), 3)),
            "confidence": float(np.round(0.5 + 0.5 * rng.random(), 3))}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A small COD10K-shaped directory (images over KG categories with
    object / instance / edge GT discs), seeded annotations and the configs
    of the trainers."""
    root = tmp_path_factory.mktemp("cli")
    dirs = {k: root / k for k in ("images", "gt_object", "gt_instance", "gt_edge", "annot")}
    for d in dirs.values():
        d.mkdir()
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    names = []
    for i, img in enumerate(synthetic_images(37, N_IMAGES, SIZE)):
        base = f"COD10K-CAM-1-Aquatic-{i + 1}-{CATEGORIES[i]}-{100 + i}"
        names.append(base + ".png")
        r2 = (yy - SIZE / 2) ** 2 + (xx - SIZE / 2) ** 2
        disc = ((r2 < (0.3 * SIZE) ** 2) * 255).astype(np.uint8)
        ring = (((r2 > (0.28 * SIZE) ** 2) & (r2 < (0.32 * SIZE) ** 2)) * 255).astype(np.uint8)
        Image.fromarray(img).save(dirs["images"] / (base + ".png"))
        for key, gt in (("gt_object", disc), ("gt_instance", disc), ("gt_edge", ring)):
            Image.fromarray(gt).save(dirs[key] / (base + ".png"))
    rng = np.random.default_rng(5)
    for category in CATEGORIES:
        for i in range(6):
            with open(dirs["annot"] / f"{category.lower()}_{i:02d}.json", "w") as f:
                json.dump(_annotation(rng, category, i), f)
    rg_cfg = root / "rg.yaml"
    rg_cfg.write_text(f"rg:\n  image_size: {SIZE}\n  n_segments: 60\n  max_nodes: 128\n"
                      "train_split: 0.5\n")
    return {"root": root, "names": names, **{k: str(v) for k, v in dirs.items()},
            "rg_cfg": str(rg_cfg)}


def _main(capsys, argv, module=cli):
    module.main(argv)
    return capsys.readouterr().out


def test_train_rg_checkpoint_reads_in_jax(ws, capsys):
    out = str(ws["root"] / "rg.ckpt")
    printed = _main(capsys, ["train-rg", "--config", ws["rg_cfg"], "--image-dir", ws["images"],
                             "--mask-dir", ws["gt_object"], "--instance-dir", ws["gt_instance"],
                             "--edge-dir", ws["gt_edge"], "--epochs", "1", "--batch-size", "2",
                             "--output", out, "--device", "cpu"])
    assert f"Found {N_IMAGES} valid image-mask-instance-edge quadruples" in printed
    _, variables = J_api.load_rg_model(out)
    want = region_graph_state_dict(variables["params"], variables["batch_stats"])
    got = T_api.load_rg_model(out, "cpu").state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], torch.as_tensor(np.asarray(want[k])), rtol=0, atol=0)


def _data_parallel_argv(ws, command):
    """``command`` with ``--data-parallel`` on the workspace: train-rg on the
    images, train-fusion on a seeded RG store of the same names."""
    out = ws["root"] / f"dp_{command}"
    if command == "train-rg":
        return ["train-rg", "--config", ws["rg_cfg"], "--image-dir", ws["images"],
                "--mask-dir", ws["gt_object"], "--instance-dir", ws["gt_instance"],
                "--edge-dir", ws["gt_edge"], "--epochs", "1", "--batch-size", "2",
                "--output", str(out) + ".ckpt", "--data-parallel"]
    from camouflage_multimodal_tpu_torch.core.artifacts import save_rg_embeddings

    rng = np.random.default_rng(3)
    store = str(out) + "_rg.npz"
    save_rg_embeddings(store, {n: {"node_embeddings": rng.standard_normal((16, 128)),
                                   "graph_embedding": rng.standard_normal((1, 128))}
                               for n in ws["names"]})
    cfg = ws["root"] / f"dp_{command}.yaml"
    cfg.write_text("\n".join([
        f"rg_embeddings_path: {store}", f"kg_embeddings_path: {ARTIFACTS[2]}",
        f"mask_dir: {ws['gt_object']}", f"instance_dir: {ws['gt_instance']}",
        f"edge_dir: {ws['gt_edge']}", f"checkpoint_dir: {out}",
        "epochs: 1", "batch_size: 2", "train_split: 0.5",
        "model:", "  hidden_dim: 64", "  num_heads: 4", ""]))
    return ["train-fusion", "--config", str(cfg), "--data-parallel"]


@pytest.mark.parametrize("command", ["train-rg", "train-fusion"])
def test_data_parallel_raises(ws, capsys, command):
    """``--data-parallel`` raises without a card on the default ``cuda``
    device; with ``--device cpu`` and no launcher it trains over a world
    of one, prints the JAX CLI's mesh line and tears its process group
    down. Data-parallel training itself is held in
    tests/test_torch_port_parallel.py."""
    argv = _data_parallel_argv(ws, command)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(argv)
    printed = _main(capsys, argv + ["--device", "cpu"])
    assert "data-parallel over 1 device(s): mesh {'data': 1, 'model': 1}" in printed
    assert not torch.distributed.is_initialized()


def test_model_commands_default_to_the_card(ws):
    """Every subcommand that runs a model parses ``--device`` with the
    default ``cuda``, which raises where there is no card."""
    parser = cli.build_parser()
    for argv in (["train-rg"], ["extract-rg", "--image-dir", "d"], ["train-kg"], ["extract-kg"],
                 ["train-fusion"], ["detect", "--image", "x"],
                 ["test-multimodal", "--checkpoint", "c"],
                 ["evaluate", "--image-dir", "d", "--gt-dir", "g"], ["serve", "--checkpoint", "c"]):
        assert parser.parse_args(argv).device == "cuda", argv
    assert not hasattr(parser.parse_args(["ingest-kg", "--annotations", "a"]), "device")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["evaluate", "--model", ARTIFACTS[1], "--image-dir", ws["images"],
                      "--gt-dir", ws["gt_object"]])


def test_extract_rg_and_train_fusion(ws, capsys):
    """``extract-rg`` on the committed RG checkpoint, then ``train-fusion``
    from a config over that store and the committed KG embeddings; the
    fusion checkpoint reads in the JAX loader to the same arrays."""
    rg_dir = ws["root"] / "rg_embeddings"
    printed = _main(capsys, ["extract-rg", "--model", ARTIFACTS[1], "--image-dir", ws["images"],
                             "--output", str(rg_dir), "--batch-size", str(N_IMAGES),
                             "--n-segments", "100", "--device", "cpu"])
    assert f"done: {N_IMAGES} images" in printed
    assert (rg_dir / "all_rg_embeddings.npz").exists()

    ckpt_dir = ws["root"] / "fusion"
    cfg = ws["root"] / "fusion.yaml"
    cfg.write_text("\n".join([
        f"rg_embeddings_path: {rg_dir / 'all_rg_embeddings.npz'}",
        f"kg_embeddings_path: {ARTIFACTS[2]}",
        f"mask_dir: {ws['gt_object']}", f"instance_dir: {ws['gt_instance']}",
        f"edge_dir: {ws['gt_edge']}", f"checkpoint_dir: {ckpt_dir}",
        "epochs: 1", "batch_size: 2", "train_split: 0.5", "model:", "  dropout: 0.0", ""]))
    printed = _main(capsys, ["train-fusion", "--config", str(cfg), "--device", "cpu"])
    assert f"Dataset: {N_IMAGES} samples" in printed
    assert (ckpt_dir / "training_history_fixed.json").exists()
    ckpt = str(ckpt_dir / "multimodal_best_fixed.ckpt")
    _, variables, config = J_api.load_multimodal_model(ckpt)
    model, t_config = T_api.load_multimodal_model(ckpt, "cpu")
    assert t_config == config and config["epochs"] == 1
    want = fusion_state_dict(variables["params"])
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], torch.as_tensor(np.asarray(want[k])), rtol=0, atol=0)


def test_kg_commands_match_jax(ws, capsys):
    """``ingest-kg`` writes the JAX CLI's store and log; ``train-kg`` writes
    a checkpoint that ``extract-kg`` of both CLIs reads, with embeddings
    within 1e-5 and the same summary."""
    files = {}
    for tag, module in (("jax", J_cli), ("port", cli)):
        store, log = ws["root"] / f"store_{tag}.json", ws["root"] / f"log_{tag}.txt"
        printed = _main(capsys, ["ingest-kg", "--annotations", ws["annot"], "--output",
                                 str(store), "--processed-log", str(log)], module)
        assert "Complete! Success: 24, Failed: 0" in printed
        files[tag] = (json.loads(store.read_text()), log.read_text())
    assert files["port"] == files["jax"]

    store = str(ws["root"] / "store_port.json")
    ckpt = str(ws["root"] / "kg.ckpt")
    printed = _main(capsys, ["train-kg", "--store", store, "--epochs", "1", "--batch-size", "8",
                             "--limit", "6", "--output", ckpt, "--device", "cpu"])
    assert "Created 24 samples" in printed and os.path.exists(ckpt)

    out = {}
    for tag, module, extra in (("jax", J_cli, []), ("port", cli, ["--device", "cpu"])):
        out_dir = ws["root"] / f"kg_embeddings_{tag}"
        printed = _main(capsys, ["extract-kg", "--model", ckpt, "--store", store, "--output",
                                 str(out_dir), "--limit", "4"] + extra, module)
        assert "Average embedding similarity" in printed
        with np.load(out_dir / "all_embeddings.npz") as z:
            emb = {k: z[k] for k in z.files}
        summary = json.loads((out_dir / "summary.json").read_text())
        stats = json.loads((out_dir / "embedding_stats.json").read_text())
        out[tag] = emb, summary, stats
    (t_emb, t_sum, t_stats), (j_emb, j_sum, j_stats) = out["port"], out["jax"]
    assert t_sum == j_sum and t_sum["num_categories"] == len(CATEGORIES)
    assert list(t_emb) == list(j_emb)
    for k in j_emb:
        assert t_emb[k].shape == j_emb[k].shape == (1, 128)
        np.testing.assert_allclose(t_emb[k], j_emb[k], rtol=0, atol=1e-5)
        assert t_stats[k]["organism_count"] == j_stats[k]["organism_count"]


def test_detect_and_test_multimodal(ws, capsys):
    name = ws["names"][0]
    image = os.path.join(ws["images"], name)
    out = ws["root"] / "detect"
    printed = _main(capsys, ["detect", "--image", image, "--model", ARTIFACTS[1], "--mask",
                             os.path.join(ws["gt_object"], name), "--output", str(out),
                             "--image-size", "96", "--n-segments", "60", "--device", "cpu"])
    assert "Mean score:" in printed and "  iou:" in printed and "  e_measure:" in printed
    assert sorted(os.listdir(out)) == [f"detection_{name}", f"mask_{name}"]

    out = ws["root"] / "test_multimodal"
    printed = _main(capsys, ["test-multimodal", "--checkpoint", ARTIFACTS[0], "--rg-model",
                             ARTIFACTS[1], "--kg-embeddings", ARTIFACTS[2], "--image", image,
                             "--output", str(out), "--device", "cpu"])
    assert "Prediction:" in printed and "Camouflaged Prob:" in printed and "Score:" in printed
    assert os.listdir(out) == [f"prediction_{name}"]
    with pytest.raises(SystemExit):
        cli.main(["test-multimodal", "--checkpoint", ARTIFACTS[0], "--rg-model", ARTIFACTS[1],
                  "--kg-embeddings", ARTIFACTS[2], "--output", str(out), "--device", "cpu"])


def test_evaluate_matches_jax(ws, capsys):
    reports = {}
    for tag, module, extra in (("jax", J_cli, []), ("port", cli, ["--device", "cpu"])):
        printed = _main(capsys, ["evaluate", "--model", ARTIFACTS[1], "--image-dir",
                                 ws["images"], "--gt-dir", ws["gt_object"], "--max-images", "1",
                                 "--batch-size", "1"] + extra, module)
        reports[tag] = json.loads(printed)
    assert set(reports["port"]) == set(reports["jax"])
    for k, v in reports["jax"].items():
        assert abs(reports["port"][k] - v) <= 1e-3, (k, reports["port"][k], v)


def test_serve_parser_and_server(ws, monkeypatch):
    """``serve`` parses into ``serve_forever``'s arguments; a service built
    from them answers over ``make_server`` on port 0 with the JAX keys."""
    called = {}
    monkeypatch.setattr(T_serve, "serve_forever",
                        lambda *args, **kwargs: called.update(args=args, kwargs=kwargs))
    cli.main(["serve", "--checkpoint", ARTIFACTS[0], "--rg-model", ARTIFACTS[1],
              "--kg-embeddings", ARTIFACTS[2], "--port", "0", "--batch-size", "1",
              "--max-wait-ms", "2", "--n-segments", "100", "--device", "cpu"])
    kwargs = called["kwargs"]
    assert called["args"] == ARTIFACTS
    assert kwargs == {"host": "0.0.0.0", "port": 0, "batch_size": 1, "max_wait_ms": 2.0,
                      "n_segments": 100, "device": "cpu"}

    predictor = T_api.MultimodalPredictor(*called["args"], n_segments=kwargs["n_segments"],
                                          device=kwargs["device"])
    service = T_serve.InferenceService(predictor, batch_size=kwargs["batch_size"],
                                       max_wait_ms=kwargs["max_wait_ms"])
    service.warmup()
    server = T_serve.make_server(service, host="127.0.0.1", port=kwargs["port"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        Image.open(os.path.join(ws["images"], ws["names"][1])).save(buf, format="PNG")
        url = f"http://127.0.0.1:{server.server_address[1]}"
        req = urllib.request.Request(url + "/predict?heatmap=1", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            resp = json.loads(r.read())
        with urllib.request.urlopen(url + "/stats", timeout=10) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    assert set(resp) == RESPONSE_KEYS | {"heatmap_png_base64"}
    assert stats["bucket_sizes"] == [1] and stats["requests"] == 2 and stats["backend"] == "cpu"
