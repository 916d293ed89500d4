"""Legacy pickle checkpoints and ``init_mha_params`` of the PyTorch port
against the JAX package, on the CPU.

A pre-npz ``.ckpt`` is a bare pickle. The JAX ``load_checkpoint`` unpickles
it in full; the port reads the same files when they hold containers,
scalars and numpy arrays alone, and refuses any other global with
``ValueError``. ``checkpoint_format`` tells the two formats apart by the
file's first two bytes in both packages."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu.core import checkpoint as J_ckpt  # noqa: E402
from camouflage_multimodal_tpu.ops.attention import (  # noqa: E402
    init_mha_params as j_init_mha_params)
from camouflage_multimodal_tpu_torch.core import checkpoint as T_ckpt  # noqa: E402
from camouflage_multimodal_tpu_torch.ops.attention import init_mha_params  # noqa: E402

E = 256
BOUND = (6.0 / (2 * E)) ** 0.5


def _assert_same_tree(got, want, path="root"):
    """Same container types, keys and order; arrays bit-equal with their
    dtype and shape; scalars equal with their type."""
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
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert got == want, path


def _legacy_payload():
    """A pre-npz checkpoint's kind of content: nested dicts, lists and
    tuples of numpy arrays (several dtypes, a Fortran-ordered and a
    non-contiguous one, 0-d) and of Python and numpy scalars."""
    rng = np.random.default_rng(5)
    return {
        "epoch": 3,
        "params": {
            "conv1": {"kernel": rng.standard_normal((15, 128)).astype(np.float32),
                      "bias": np.zeros(128, np.float32)},
            "layers": [rng.standard_normal((4, 4)), np.asfortranarray(
                rng.standard_normal((3, 5)).astype(np.float32))],
        },
        "batch_stats": ({"mean": rng.standard_normal(8).astype(np.float32)[::2],
                         "count": np.array(7, np.int64)},),
        "config": {"hidden_dim": 256, "dropout": 0.3, "name": "fusion", "flag": True,
                   "none": None, "heads": (8, 4)},
        "metrics": {"val_loss": np.float64(0.25), "f1": np.float32(0.5),
                    "step": np.int32(12), "best": np.bool_(True), "nan": float("nan")},
        "history": {"loss": [1.5, 0.5], "labels": np.array([0, 1, 1], np.uint8)},
    }


@pytest.mark.parametrize("protocol", [2, 4, 5])
@pytest.mark.parametrize("payload", ["epoch_only", "nested"])
def test_legacy_pickle_read_like_jax(tmp_path, payload, protocol):
    """The JAX package's own legacy case (a pickled ``{"epoch": 3}``) and a
    nested payload of numpy arrays and scalars come back from both readers
    alike, under the pickle protocols of old and new Pythons."""
    obj = {"epoch": 3} if payload == "epoch_only" else _legacy_payload()
    path = str(tmp_path / "old.ckpt")
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=protocol)
    got, want = T_ckpt.load_checkpoint(path), J_ckpt.load_checkpoint(path)
    _assert_same_tree(got, want)
    _assert_same_tree(got, obj)
    assert got["epoch"] == 3


def test_checkpoint_format_agrees(tmp_path):
    npz, legacy = str(tmp_path / "new.ckpt"), str(tmp_path / "old.ckpt")
    T_ckpt.save_checkpoint(npz, {"epoch": 1, "w": np.ones(3, np.float32)})
    with open(legacy, "wb") as f:
        pickle.dump({"epoch": 3}, f)
    for path, want in ((npz, "npz"), (legacy, "pickle"),
                       ("artifacts/rg_model.ckpt", "npz")):
        assert T_ckpt.checkpoint_format(path) == J_ckpt.checkpoint_format(path) == want


class _CallsSystem:
    def __reduce__(self):
        return os.system, ("true",)


class _PortClass:
    """A class of an importable module: the reader must not build it either."""

    def __init__(self):
        self.w = np.zeros(2)


@pytest.mark.parametrize("blob", ["os_system", "module_class"])
def test_legacy_pickle_other_globals_refused(tmp_path, blob, monkeypatch):
    """``os.system`` (and any class that is not a container, scalar or numpy
    array) is refused with ``ValueError`` naming the migration script, and
    never called. The JAX reader is not run on these files."""
    path = str(tmp_path / "bad.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"epoch": 3, "x": _CallsSystem() if blob == "os_system" else _PortClass()}, f)
    calls = []
    monkeypatch.setattr(os, "system", lambda *a: calls.append(a) or 0)
    assert T_ckpt.checkpoint_format(path) == "pickle"
    with pytest.raises(ValueError, match="scripts/migrate_checkpoints.py"):
        T_ckpt.load_checkpoint(path)
    assert calls == []


def test_init_mha_params_matches_jax_contract():
    """JAX's keys in its order, shapes and dtype; zero biases; weights in
    ±a with a = sqrt(6 / 2E) and a variance within 5 % of a²/3; equal
    generators give equal bits, another seed other draws."""
    want = j_init_mha_params(jax.random.PRNGKey(0), E)
    got = init_mha_params(torch.Generator().manual_seed(0), E)
    assert list(got) == list(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
        assert got[name].device.type == "cpu"
    for name in ("bq", "bk", "bv", "bo"):
        assert not got[name].any(), name
    for name in ("wq", "wk", "wv", "wo"):
        w = got[name].double()
        assert w.abs().max().item() <= BOUND, name
        assert abs(w.var().item() / (BOUND ** 2 / 3) - 1) < 0.05, name
        # JAX's draws obey the same law (its own variance, same bar).
        assert abs(np.asarray(want[name], np.float64).var() / (BOUND ** 2 / 3) - 1) < 0.05
    again = init_mha_params(torch.Generator().manual_seed(0), E)
    for name in got:
        assert torch.equal(got[name], again[name]), name
    other = init_mha_params(torch.Generator().manual_seed(1), E)
    assert not torch.equal(got["wq"], other["wq"])
    assert len({got[n].data_ptr() for n in ("wq", "wk", "wv", "wo")}) == 4
    assert not torch.equal(got["wq"], got["wk"])
