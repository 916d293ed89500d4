"""Reader and writer for the ``.ckpt`` checkpoint format, with numpy alone.

The format (that of ``camouflage_multimodal_tpu/core/checkpoint.py``) is
an ``np.savez`` zip holding every array leaf as a ``.npy`` entry plus one
``__meta__`` entry: a UTF-8 JSON skeleton of the nested structure whose
nodes are ``{"t": "d"|"l"|"tu", "v": ...}`` containers, ``{"t": "s", "v":
scalar}`` scalars and ``{"t": "a", "v": "aN"}`` array references
(``{"t": "sd"}`` wraps a flattened structured node; the writer here takes
plain dict / list / tuple / scalar / array nodes and never emits it).
Either package reads what the other writes.

Pre-npz pickle checkpoints are read as the JAX package reads them (told
apart by the first two bytes, :func:`checkpoint_format`), through an
unpickler that builds containers, Python and numpy scalars and numpy arrays
and nothing else: a file that names any other global (a jax, flax or optax
class, a callable of the file's choosing) is refused with ``ValueError``
before that global is looked up. The JAX package unpickles such files in
full; this reader is stricter on purpose.

:func:`save_resume_checkpoint` / :func:`load_resume_checkpoint` snapshot a
trainer of the port mid-run in the same format.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict

import numpy as np

_META_KEY = "__meta__"
# The globals a pickle of containers, scalars and numpy arrays refers to
# under any protocol (numpy 1.x and 2.x spellings): none of them runs code
# of the file's choosing.
_PICKLE_GLOBALS = frozenset(
    [("builtins", n) for n in ("dict", "list", "tuple", "set", "frozenset", "int",
                               "float", "complex", "bool", "str", "bytes", "bytearray")]
    + [("_codecs", "encode"), ("numpy", "ndarray"), ("numpy", "dtype")]
    + [(f"numpy.{core}.{mod}", name) for core in ("core", "_core")
       for mod, name in (("multiarray", "_reconstruct"), ("multiarray", "scalar"),
                         ("numeric", "_frombuffer"))])


class _LegacyUnpickler(pickle.Unpickler):
    """Unpickler of pre-npz checkpoints that looks up only
    :data:`_PICKLE_GLOBALS`."""

    def __init__(self, f, path: str) -> None:
        super().__init__(f)
        self.path = path

    def find_class(self, module: str, name: str) -> Any:
        # Protocols 0-2 spell Python 2's ``__builtin__``.
        if ("builtins" if module == "__builtin__" else module, name) not in _PICKLE_GLOBALS:
            raise ValueError(
                f"{self.path}: legacy pickle checkpoint refers to {module}.{name}, which "
                "this reader does not build; re-save it in the npz .ckpt format "
                "(scripts/migrate_checkpoints.py) before loading it here")
        return super().find_class(module, name)


def _decode(node: Any, arrays: Dict[str, np.ndarray]) -> Any:
    t, v = node["t"], node["v"]
    if t == "sd":
        return _decode(v, arrays)
    if t == "d":
        return {k: _decode(x, arrays) for k, x in v.items()}
    if t == "l":
        return [_decode(x, arrays) for x in v]
    if t == "tu":
        return tuple(_decode(x, arrays) for x in v)
    if t == "s":
        return v
    if t == "a":
        return arrays[v]
    raise ValueError(f"unknown checkpoint node type {t!r}")


def _encode(obj: Any, arrays: Dict[str, np.ndarray]) -> Any:
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be str, got {k!r}")
        return {"t": "d", "v": {k: _encode(v, arrays) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"t": "l" if isinstance(obj, list) else "tu",
                "v": [_encode(v, arrays) for v in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "s", "v": obj}
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return {"t": "s", "v": obj.item()}
    if isinstance(obj, np.ndarray):
        key = f"a{len(arrays)}"
        arrays[key] = obj
        return {"t": "a", "v": key}
    raise TypeError(f"cannot checkpoint object of type {type(obj)!r}: convert "
                    "it to dicts, lists, scalars and numpy arrays first")


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` (nested dict / list / tuple of scalars and numpy
    arrays) to ``path``, atomically: a crash never truncates a live file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    meta = _encode(payload, arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays,
                 **{_META_KEY: np.frombuffer(json.dumps(meta).encode("utf-8"),
                                             dtype=np.uint8)})
    os.replace(tmp, path)


def checkpoint_format(path: str) -> str:
    """``"npz"`` for the durable format, ``"pickle"`` for legacy files."""
    with open(path, "rb") as f:
        return "npz" if f.read(2) == b"PK" else "pickle"


def load_checkpoint(path: str) -> Any:
    """Nested dict/list/tuple structure with numpy array leaves."""
    if checkpoint_format(path) == "pickle":
        with open(path, "rb") as f:
            return _LegacyUnpickler(f, path).load()
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
    return _decode(meta, arrays)


def scalar(x: Any) -> Any:
    """Checkpoint configs store scalars as 0-d arrays; unwrap them."""
    return x.item() if isinstance(x, np.ndarray) and x.ndim == 0 else x


def save_resume_checkpoint(path: str, *, model_state: Dict[str, np.ndarray],
                           optimizer_state: Dict[str, Any], epoch: int,
                           numpy_rng: np.random.Generator,
                           generator_state: np.ndarray,
                           history: Dict[str, Any], best_val: float,
                           **extra: Any) -> None:
    """Everything a trainer of the port needs to continue bit-exactly: the
    model's ``state_dict`` and the optimizer's moments and step count (as
    numpy), the epoch counter, the state of the trainer's host numpy RNG,
    the state of the torch generator that drives dropout and on-device
    augmentation, the running history and the best validation score, plus
    the trainer's own ``extra`` entries (the fusion trainer's dataset RNG
    state and early-stop counter, the KG trainer's learning rate and
    plateau counter)."""
    save_checkpoint(path, {
        "model_state": model_state,
        "optimizer_state": optimizer_state,
        "epoch": int(epoch),
        "numpy_rng_state": numpy_rng.bit_generator.state,
        "generator_state": generator_state,
        "history": history,
        "best_val": float(best_val),
        **extra,
    })


def load_resume_checkpoint(path: str) -> Dict[str, Any]:
    """Inverse of :func:`save_resume_checkpoint`. The caller MUST restore
    the numpy RNG states and the torch generator's state before the first
    epoch after the resume."""
    blob = load_checkpoint(path)
    missing = {"model_state", "optimizer_state", "epoch", "numpy_rng_state",
               "generator_state", "history", "best_val"} - set(blob)
    if missing:
        raise ValueError(f"{path}: not a resume checkpoint of the port "
                         f"(missing {sorted(missing)})")
    return blob
