"""The port's host-side modules against the JAX package's on the CPU: the
figure panels (``viz.py``) and report plots (``utils/visualization.py``)
pixel for pixel, the figures ``api.py`` writes under the JAX file names,
and the config loader.

Bars: decoded PNGs equal; configs equal; the written file names equal; the
heatmap PNGs at the slice's heatmap bar (tests/test_torch_port_pipeline.py).
"""

import os
import sys

import numpy as np
import pytest
from PIL import Image

import jax

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu import api as J_api  # noqa: E402
from camouflage_multimodal_tpu import viz as J_viz  # noqa: E402
from camouflage_multimodal_tpu.core import config as J_config  # noqa: E402
from camouflage_multimodal_tpu.utils import visualization as J_vis  # noqa: E402
from camouflage_multimodal_tpu_torch import api as T_api  # noqa: E402
from camouflage_multimodal_tpu_torch import utils as T_utils  # noqa: E402
from camouflage_multimodal_tpu_torch import viz as T_viz  # noqa: E402
from camouflage_multimodal_tpu_torch.core import config as T_config  # noqa: E402
from test_torch_port_pipeline import (  # noqa: E402, F401
    ARTIFACTS, few_threads, synthetic_images)

pytestmark = pytest.mark.usefixtures("few_threads")

CONFIG = "configs/multimodal_config.yaml"


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def _figure_args(name):
    """The arguments of one figure on seeded numpy inputs, the output path
    as ``None``."""
    rng = np.random.default_rng(4)
    img = rng.random((64, 64, 3))
    seg = rng.integers(0, 50, (64, 64))
    if name == "detection_panel":
        return [img, seg, rng.random((64, 64)), "HIGHLY CAMOUFLAGED", "red", 0.4, 12.0,
                     None, "x.jpg"]
    if name.startswith("multimodal_panel"):
        predictions = {"segments": seg, "mask_prob": np.array([0.3, 0.7]), "mask_pred": 1,
                       "instance_pred": 0, "score": 0.42}
        attn = None if name.endswith("late") else {"rg2kg": rng.random((50, 13))}
        return [img, predictions, attn, {f"cat{i}": None for i in range(13)}, None,
                     "x.jpg"]
    if name == "plot_training_history":
        return [{"train_loss": [1.0, 0.8, 0.7], "val_loss": [1.1, 0.9, 0.85],
                      "train_f1_class_1": [0.2, 0.4, 0.5],
                      "val_f1_class_1": [0.1, 0.3, 0.45]}, None]
    if name == "plot_attention_heatmap":
        return [rng.random((30, 13)), [f"cat{i}" for i in range(13)], None]
    if name == "plot_comparison":
        return [img, rng.random((64, 64)), (rng.random((64, 64)) > 0.5).astype(float), None]
    return [{"iou": 0.7, "dice": 0.85, "mae": 0.1, "f1": 0.55}, None]


@pytest.mark.parametrize("name", ["detection_panel", "multimodal_panel",
                                  "multimodal_panel_late", "plot_training_history",
                                  "plot_attention_heatmap", "plot_comparison",
                                  "plot_metrics_summary"])
def test_figures_pixel_equal_to_jax(tmp_path, name):
    """The same numpy inputs through both packages' figure functions give
    PNGs that decode to the same pixels."""
    args = _figure_args(name)
    fn = name.replace("_late", "")
    paths = []
    for tag, module in (("jax", J_viz if "panel" in fn else J_vis),
                        ("port", T_viz if "panel" in fn else T_utils)):
        path = str(tmp_path / tag / f"{name}.png")
        getattr(module, fn)(*[path if a is None else a for a in args])
        paths.append(path)
    assert os.path.getsize(paths[1]) > 1000
    np.testing.assert_array_equal(_pixels(paths[1]), _pixels(paths[0]))


def _write_images(root, n):
    root.mkdir()
    names = []
    for i, img in enumerate(synthetic_images(29, n, 256)):
        name = f"COD10K-CAM-1-Aquatic-{i}-Crab-{i}.png"
        Image.fromarray(img).save(root / name)
        names.append(name)
    return names


def test_detect_camouflage_default_arguments_write_jax_names(tmp_path, monkeypatch):
    """``detect_camouflage`` with its defaults (figures on, ``results/``,
    256², 500 segments) writes ``detection_<name>`` and ``mask_<name>`` as
    the JAX function does; the mask PNGs agree at the heatmap bar."""
    names = _write_images(tmp_path / "images", 1)
    image = str(tmp_path / "images" / names[0])
    ckpt = os.path.abspath(ARTIFACTS[1])
    for tag in ("jax", "port"):
        (tmp_path / tag).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    J_api.detect_camouflage(image, ckpt)
    monkeypatch.chdir(tmp_path / "port")
    heatmap, _, _, metrics = T_api.detect_camouflage(image, ckpt, device="cpu")
    assert metrics is None and heatmap.shape == (256, 256)
    written = sorted(os.listdir(tmp_path / "port" / "results"))
    assert written == sorted(os.listdir(tmp_path / "jax" / "results"))
    assert written == sorted([f"detection_{names[0]}", f"mask_{names[0]}"])
    masks = [np.asarray(Image.open(tmp_path / tag / "results" / f"mask_{names[0]}"), np.float64)
             for tag in ("jax", "port")]
    np.testing.assert_array_equal(masks[1], (heatmap * 255).astype(np.uint8))
    assert np.abs(masks[0] - masks[1]).mean() / 255 <= 1e-2 + 1 / 255


def test_test_image_directory_figures_write_jax_names(tmp_path):
    """``test_image_directory(save_figures=True)`` on a seeded 256² image
    writes ``pred_<name>`` beside ``batch_results.json``, the JAX
    function's files; ``visualize_prediction`` draws the same pixels as the
    JAX one from the same predictions."""
    names = _write_images(tmp_path / "images", 1)
    for tag, api, device in (("jax", J_api, {}), ("port", T_api, {"device": "cpu"})):
        pred = api.MultimodalPredictor(*ARTIFACTS, **device)
        api.test_image_directory(pred, str(tmp_path / "images"), str(tmp_path / tag),
                                 batch_size=1, save_figures=True)
    written = sorted(os.listdir(tmp_path / "port"))
    assert written == sorted(os.listdir(tmp_path / "jax"))
    assert written == ["batch_results.json", f"pred_{names[0]}"]

    image = str(tmp_path / "images" / names[0])
    rng = np.random.default_rng(6)
    predictions = {"segments": rng.integers(0, 60, (256, 256)), "mask_prob": np.array([0.2, 0.8]),
                   "mask_pred": 1, "instance_pred": 1, "score": 0.61}
    attn = {"rg2kg": rng.random((60, 13))}
    kg = {f"cat{i}": None for i in range(13)}
    for tag, api in (("jax", J_api), ("port", T_api)):
        api.visualize_prediction(image, predictions, attn, kg, str(tmp_path / f"vis_{tag}.png"))
    np.testing.assert_array_equal(_pixels(tmp_path / "vis_port.png"),
                                  _pixels(tmp_path / "vis_jax.png"))


@pytest.mark.parametrize("path", [None, CONFIG])
def test_load_config_equals_jax(path):
    assert T_config.load_config(path) == J_config.load_config(path)
    assert T_config.default_config() == J_config.default_config()
    assert T_config.default_config() is not T_config.default_config()


def test_load_config_names_missing_pyyaml(monkeypatch):
    """Without PyYAML the defaults still load; a config file raises an
    error that names the package."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert T_config.load_config() == J_config.default_config()
    with pytest.raises(ImportError, match="PyYAML"):
        T_config.load_config(CONFIG)


def test_port_imports_without_matplotlib_or_pyyaml():
    """The API, the server and the CLI import, and the default config
    loads, where neither matplotlib nor PyYAML can be imported: both are
    loaded only when a figure is drawn or a config file read."""
    import subprocess

    code = """
import sys
sys.modules["matplotlib"] = None
sys.modules["yaml"] = None
import camouflage_multimodal_tpu_torch.api, camouflage_multimodal_tpu_torch.cli
import camouflage_multimodal_tpu_torch.serve, camouflage_multimodal_tpu_torch.utils
from camouflage_multimodal_tpu_torch.core.config import load_config
assert load_config()["rg"]["image_size"] == 256
print("IMPORTED")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "IMPORTED" in res.stdout
