"""Embedding stores: RG per-image embeddings and KG category embeddings.

Port of ``camouflage_multimodal_tpu/core/artifacts.py``. Both packages
write the same ``.npz`` archives — the RG store keeps each image's arrays
under ``<name>|node_embeddings`` and ``<name>|graph_embedding``, the KG
store one ``(1, dim)`` array per category — and both read the reference's
``torch.save`` dicts (``.pt``): ``all_rg_embeddings.pt`` (image name →
{node_embeddings, graph_embedding, num_nodes}) and ``all_embeddings.pt``
(category → embedding).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from camouflage_multimodal_tpu_torch.core.torch_compat import torch_load

_NODE_SUFFIX = "|node_embeddings"
_GRAPH_SUFFIX = "|graph_embedding"


def _array(x) -> np.ndarray:
    """A stored tensor or array as float32 numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def save_rg_embeddings(path: str, store: Dict[str, Dict[str, np.ndarray]]) -> None:
    """store: image name → {node_embeddings (N, 128), graph_embedding (1, 128)}."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for name, rec in store.items():
        arrays[name + _NODE_SUFFIX] = np.asarray(rec["node_embeddings"], np.float32)
        arrays[name + _GRAPH_SUFFIX] = np.asarray(rec["graph_embedding"], np.float32)
    np.savez_compressed(path, **arrays)


def load_rg_embeddings(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """image name → {node_embeddings, graph_embedding, num_nodes}, from an
    ``.npz`` store or the reference's ``.pt``, in the file's order."""
    if path.endswith(".pt"):
        raw = torch_load(path)
        return {
            name: {
                "node_embeddings": _array(rec["node_embeddings"]),
                "graph_embedding": _array(rec["graph_embedding"]),
                "num_nodes": int(rec.get("num_nodes", len(rec["node_embeddings"]))),
            }
            for name, rec in raw.items()
        }
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as z:
        for key in z.files:
            if key.endswith(_NODE_SUFFIX):
                out.setdefault(key[: -len(_NODE_SUFFIX)], {})["node_embeddings"] = z[key]
            elif key.endswith(_GRAPH_SUFFIX):
                out.setdefault(key[: -len(_GRAPH_SUFFIX)], {})["graph_embedding"] = z[key]
    for rec in out.values():
        rec["num_nodes"] = int(rec["node_embeddings"].shape[0])
    return out


def save_kg_embeddings(path: str, store: Dict[str, np.ndarray]) -> None:
    """category → (1, dim) embedding, as a compressed ``.npz``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v, np.float32) for k, v in store.items()})


def load_kg_embeddings(path: str) -> Dict[str, np.ndarray]:
    """category → (1, dim) embedding from an ``.npz`` store or the
    reference's ``.pt``, in the file's order."""
    if path.endswith(".pt"):
        return {k: _array(v).reshape(1, -1) for k, v in torch_load(path).items()}
    with np.load(path) as z:
        return {k: z[k].reshape(1, -1) for k in z.files}
