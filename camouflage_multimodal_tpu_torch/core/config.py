"""Config schema, port of ``camouflage_multimodal_tpu/core/config.py``.

The same YAML keys and defaults as the JAX package, which keeps the keys of
the reference's ``configs/multimodal_config.yaml`` with portable paths, an
honoured ``train_split`` and ``task_weights.mask`` defaulting to the code
value 3.0 the reference trained with. PyYAML is imported only when a file
is read, so every command that is given no ``--config`` runs without it.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict

_DEFAULT: Dict[str, Any] = {
    # Paths (relative to repo root by default)
    "rg_embeddings_path": "artifacts/rg_embeddings/all_rg_embeddings.npz",
    "kg_embeddings_path": "artifacts/kg_embeddings/all_embeddings.npz",
    "image_dir": "data/COD10K/images",
    "mask_dir": "data/COD10K/gt_object",
    "instance_dir": "data/COD10K/gt_instance",
    "edge_dir": "data/COD10K/gt_edge",
    "annotation_dir": "annotations",
    "checkpoint_dir": "checkpoints",
    # Model (same keys as reference `model:` block)
    "model": {
        "rg_dim": 128,
        "kg_dim": 128,
        "hidden_dim": 256,
        "num_heads": 8,
        "fusion_type": "cross_attention",  # "cross_attention" | "late"
        "num_classes": 2,
        "dropout": 0.3,
    },
    # Region-graph pipeline
    "rg": {
        "in_channels": 15,
        "hidden_channels": 128,
        "num_classes": 2,
        "n_segments": 500,
        "image_size": 256,
        "max_nodes": 640,       # padded node bucket (fixed shape for jit; 23x23 SLIC grid = 529 -> 640)
        "slic_iters": 10,
        "slic_compactness": 10.0,
        "slic_sigma": 1.0,
    },
    # Knowledge-graph pipeline
    "kg": {
        "in_channels": 32,
        "hidden_channels": 128,
        "embedding_dim": 128,
        "max_nodes": 64,        # padded subgraph node bucket
        "subgraph_limit": 50,   # reference train_model.py:365
        "embed_limit": 10,      # reference extract_kg_embeddings.py:29
    },
    # Training (same keys as reference)
    "epochs": 30,
    "batch_size": 4,
    "learning_rate": 5.0e-4,
    "weight_decay": 1.0e-4,
    "use_all_kg_categories": True,
    "task_weights": {"mask": 3.0, "instance": 1.0, "edge": 0.5, "score": 0.3},
    "train_split": 0.8,
    "val_split": 0.2,
    "seed": 0,
}


def default_config() -> Dict[str, Any]:
    """A deep copy of the default config dict."""
    return copy.deepcopy(_DEFAULT)


def _deep_update(base: Dict[str, Any], upd: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(path: str | None = None) -> Dict[str, Any]:
    """Load a YAML config over the defaults (reference: yaml.safe_load at
    ``train_multimodal.py:500-501``)."""
    cfg = default_config()
    if path is not None:
        try:
            import yaml
        except ImportError as e:
            raise ImportError(f"reading the config file {path} needs PyYAML (the "
                              "'pyyaml' package), which is not installed") from e
        with open(os.path.expanduser(path), "r") as f:
            user = yaml.safe_load(f) or {}
        _deep_update(cfg, user)
    return cfg
