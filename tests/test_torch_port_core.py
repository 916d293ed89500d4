"""The PyTorch port's checkpoint reader, host helpers, device policy and
import isolation."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu.core.artifacts import (  # noqa: E402
    load_kg_embeddings as j_load_kg)
from camouflage_multimodal_tpu.core.checkpoint import load_checkpoint as j_load  # noqa: E402
from camouflage_multimodal_tpu.data.cod10k import load_image_rgb as j_load_image  # noqa: E402
from camouflage_multimodal_tpu.data.matcher import (  # noqa: E402
    build_ordered_kg_tensor as j_order_kg)
from camouflage_multimodal_tpu_torch import data as T_data  # noqa: E402
from camouflage_multimodal_tpu_torch.core.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint)
from camouflage_multimodal_tpu_torch.core.device import resolve_device  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KG_PATH = "artifacts/kg_embeddings/all_embeddings.npz"


def _assert_same_tree(got, want, path="root"):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("path", [
    "artifacts/rg_model.ckpt",
    "artifacts/checkpoints_balanced/multimodal_best_fixed.ckpt",
    "artifacts/kg_gnn_model.ckpt",
])
def test_checkpoint_reader_matches_jax_loader(path):
    """Every array and scalar of the committed checkpoints, exactly."""
    _assert_same_tree(load_checkpoint(path), j_load(path))


class _RunsCode:
    """Unpickles into a call of ``os.system``: what a pickle may name."""

    def __reduce__(self):
        return os.system, ("true",)


def test_checkpoint_reader_refuses_legacy_pickle(tmp_path):
    """A legacy pickle that names a global other than containers, scalars
    and numpy arrays is refused before that global is looked up."""
    p = tmp_path / "old.ckpt"
    with open(p, "wb") as f:
        pickle.dump({"params": {}, "hook": _RunsCode()}, f)
    with pytest.raises(ValueError, match="legacy pickle.*migrate_checkpoints"):
        load_checkpoint(str(p))


def test_save_checkpoint_round_trip_and_jax_reader(tmp_path):
    """What the port writes, the port and the JAX package read back alike;
    a crash mid-write cannot truncate a live file (temp file + rename)."""
    rng = np.random.default_rng(3)
    payload = {
        "epoch": 4, "val_loss": 0.25, "name": "fusion", "none": None, "flag": True,
        "params": {"fusion": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                              "b": np.zeros(5, np.float32)}},
        "history": {"loss": [1.5, 0.5], "f1": []},
        "shape": (2, 3), "np_scalar": np.float32(0.5), "big": 2 ** 100,
        "rng": np.random.default_rng(1).bit_generator.state,
        "bytes": np.arange(7, dtype=np.uint8), "ids": np.arange(4),
    }
    path = str(tmp_path / "sub" / "model.ckpt")
    save_checkpoint(path, payload)
    assert os.listdir(tmp_path / "sub") == ["model.ckpt"]
    want = dict(payload, np_scalar=0.5)
    _assert_same_tree(load_checkpoint(path), want)
    _assert_same_tree(j_load(path), want)
    save_checkpoint(path, {"epoch": 5})                      # overwrite in place
    assert load_checkpoint(path) == {"epoch": 5}
    for bad in ({"x": object()}, {1: 2}, {"t": torch.zeros(2)}):
        with pytest.raises(TypeError):
            save_checkpoint(path, bad)
    assert load_checkpoint(path) == {"epoch": 5}


def test_kg_helpers_match_jax():
    got_raw = T_data.load_kg_embeddings(KG_PATH)
    want_raw = j_load_kg(KG_PATH)
    _assert_same_tree(got_raw, want_raw)
    got, got_ordered = T_data.build_ordered_kg_tensor(got_raw)
    want, want_ordered = j_order_kg(want_raw)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (13, 128) and got.dtype == np.float32
    assert list(got_ordered) == list(want_ordered)


def test_load_image_rgb_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(8)
    p = str(tmp_path / "img.png")
    Image.fromarray(rng.integers(0, 256, (80, 120, 3), dtype=np.uint8)).save(p)
    for size in (64, 256):
        np.testing.assert_array_equal(T_data.load_image_rgb(p, size), j_load_image(p, size))


def test_cuda_requested_without_a_card_raises():
    """No silent CPU fallback: asking for CUDA where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA is not available|is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_port_imports_no_jax():
    """Importing every module of the port, and loading its host libraries,
    leaves jax, flax and the JAX package out of ``sys.modules`` and maps no
    file of the JAX package's ``native/`` directory."""
    code = r"""
import importlib, os, pkgutil, sys
import camouflage_multimodal_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from camouflage_multimodal_tpu_torch import native
native.get_lib(), native.get_graph_lib()
jax_native = os.path.join(os.getcwd(), "native") + os.sep
with open("/proc/self/maps") as f:
    mapped = {line.split()[-1] for line in f if "/" in line}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "camouflage_multimodal_tpu"))
bad += sorted(p for p in mapped if p.startswith(jax_native))
bad += [str(native.library_path(n)) for n in native.LIBRARIES
        if not str(native.library_path(n)).startswith(os.path.join(pkg.__path__[0], "_build"))]
assert len(names) >= 50, names
for needed in ("train.train_fusion", "train.losses", "train.schedules", "train.state",
               "train.train_rg", "train.train_kg", "models.knowledge_graph", "kg.store",
               "kg.neo4j_compat",
               "kg.featurize", "kg.normalize", "core.torch_compat", "core.artifacts",
               "core.stages", "data.cod10k", "data.labels", "data.matcher", "extract",
               "eval.metrics", "eval.curves", "utils.metrics", "parallel",
               "parallel.distributed", "parallel.sharding", "bench", "scripts.bench_sweep",
               "scripts.profile_stages", "scripts.host_ceiling", "scripts.migrate_checkpoints",
               "scripts.serve_latency_ab", "scripts.profile_connectivity", "graft_entry",
               "native"):
    assert pkg.__name__ + "." + needed in names, needed
print("BAD", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
