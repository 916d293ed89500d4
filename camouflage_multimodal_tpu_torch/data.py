"""Host-side helpers of the inference path (numpy and PIL only).

The port's own copies of ``camouflage_multimodal_tpu/data/cod10k.py:
load_image_rgb``, ``data/matcher.py:build_ordered_kg_tensor`` and the
``.npz`` branch of ``core/artifacts.py:load_kg_embeddings``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from PIL import Image


def load_image_rgb(path: str, size: int = 256) -> np.ndarray:
    """Decode + resize an RGB image → (size, size, 3) float32 in [0, 1]."""
    img = Image.open(path).convert("RGB").resize((size, size))
    return np.asarray(img, dtype=np.float32) / 255.0


def load_kg_embeddings(path: str) -> Dict[str, np.ndarray]:
    """category → (1, dim) embedding from an ``.npz`` store."""
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: only .npz KG embedding stores are supported")
    with np.load(path) as z:
        return {k: z[k].reshape(1, -1) for k in z.files}


def build_ordered_kg_tensor(kg_embeddings: Dict[str, np.ndarray]
                            ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Categories stacked in sorted order → ((num_kg, dim) float32, ordered
    dict category → embedding), as ``test_multimodal.build_ordered_kg_tensor``."""
    keys = sorted(kg_embeddings)
    ordered = {k: np.asarray(kg_embeddings[k], np.float32).reshape(-1) for k in keys}
    return np.stack([ordered[k] for k in keys]), ordered
