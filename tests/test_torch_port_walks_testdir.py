"""The port's directory testing (``api.test_image_directory``) against the
JAX package, on the CPU, with both committed fusion checkpoints: a file of
its own, the suite's longest, so that it runs on a worker of its own.
Bars as in tests/test_torch_port_walks.py.
"""

import os

import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu import api as J_api  # noqa: E402
from camouflage_multimodal_tpu_torch import api as T_api  # noqa: E402
from test_torch_port_pipeline import ARTIFACTS, OUT_TOL, few_threads  # noqa: E402,F401
from test_torch_port_walks import LATE_CKPT, _load_schema, _write_dataset  # noqa: E402

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.mark.parametrize("fusion", ["cross_attention", "late"])
def test_test_image_directory_matches_jax(tmp_path, fusion):
    """Three seeded 256² images and an undecodable file at batch 2 through
    both predictors of the committed full-width artifacts:
    ``batch_results.json`` with the same records (labels equal,
    probabilities and scores at the slice's output bar)."""
    img_dir, _, names = _write_dataset(tmp_path, 3, 256)
    ckpt = ARTIFACTS[0] if fusion == "cross_attention" else LATE_CKPT
    jpred = J_api.MultimodalPredictor(ckpt, *ARTIFACTS[1:])
    tpred = T_api.MultimodalPredictor(ckpt, *ARTIFACTS[1:], device="cpu")
    want = J_api.test_image_directory(jpred, str(img_dir), str(tmp_path / "jax"), batch_size=2)
    got = T_api.test_image_directory(tpred, str(img_dir), str(tmp_path / "port"), batch_size=2)
    assert _load_schema(tmp_path / "port" / "batch_results.json") == got
    assert [r["image"] for r in got] == [r["image"] for r in want] == names
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["prediction"], g["pred_label"]) == (w["prediction"], w["pred_label"])
        for k in ("camo_prob", "not_camo_prob", "score"):
            assert g[k] == pytest.approx(w[k], rel=OUT_TOL["rtol"], abs=OUT_TOL["atol"]), k
    T_api.test_image_directory(tpred, str(img_dir), str(tmp_path / "f"), max_images=1,
                               batch_size=1, save_figures=True)
    assert sorted(os.listdir(tmp_path / "f")) == ["batch_results.json", f"pred_{names[0]}"]
