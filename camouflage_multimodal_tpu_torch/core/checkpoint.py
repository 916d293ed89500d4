"""Reader for the ``.ckpt`` checkpoint format, with numpy alone.

The format (written by ``camouflage_multimodal_tpu/core/checkpoint.py``) is
an ``np.savez`` zip holding every array leaf as a ``.npy`` entry plus one
``__meta__`` entry: a UTF-8 JSON skeleton of the nested structure whose
nodes are ``{"t": "d"|"l"|"tu", "v": ...}`` containers, ``{"t": "s", "v":
scalar}`` scalars and ``{"t": "a", "v": "aN"}`` array references
(``{"t": "sd"}`` wraps a flattened structured node). Pre-npz pickle
checkpoints are refused: unpickling them needs the JAX package's classes.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

_META_KEY = "__meta__"


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


def load_checkpoint(path: str) -> Any:
    """Nested dict/list/tuple structure with numpy array leaves."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":
        raise ValueError(
            f"{path}: legacy pickle checkpoint; re-save it in the npz .ckpt "
            "format (scripts/migrate_checkpoints.py) before loading it here")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
    return _decode(meta, arrays)


def scalar(x: Any) -> Any:
    """Checkpoint configs store scalars as 0-d arrays; unwrap them."""
    return x.item() if isinstance(x, np.ndarray) and x.ndim == 0 else x
