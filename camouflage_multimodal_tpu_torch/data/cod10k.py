"""COD10K naming, image decode and the RG training dataset.

The port's own copy of ``camouflage_multimodal_tpu/data/cod10k.py``
(``parse_cod10k_name``, ``load_image_rgb``, ``load_mask``, ``CODDataset``
with its PIL decode; the JAX package's native loader is bit-identical to
PIL by its own docstring and is not ported). PIL is imported where it is
used.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg")


def parse_cod10k_name(filename: str) -> Dict[str, Optional[str]]:
    """COD10K's ``COD10K-CAM-{id}-{Env}-{seq}-{Organism}-{n}`` naming split
    into its fields; fields a shorter (NonCAM) name lacks are None."""
    parts = os.path.splitext(os.path.basename(filename))[0].split("-")
    keys = ("cam", "cam_id", "environment", "seq", "organism", "index")
    return {key: parts[i + 1] if len(parts) > i + 1 else None
            for i, key in enumerate(keys)}


def load_image_rgb(path: str, size: int = 256) -> np.ndarray:
    """Decode + resize an RGB image → (size, size, 3) float32 in [0, 1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size))
    return np.asarray(img, dtype=np.float32) / 255.0


def load_mask(path: str, size: int = 256) -> np.ndarray:
    """Decode + resize a grayscale GT mask → (size, size) float32 in [0, 1]."""
    from PIL import Image

    img = Image.open(path).convert("L").resize((size, size))
    return np.asarray(img, dtype=np.float32) / 255.0


@dataclass
class CODSample:
    image_name: str
    image_path: str
    mask_path: str
    instance_path: str
    edge_path: str


class CODDataset:
    """The images of ``img_dir`` that have all three GT maps (object,
    instance, edge: ``{base}.png`` in each directory), decoded with PIL and
    resized to ``image_size`` (bicubic, ``Image.resize``'s default)."""

    def __init__(self, img_dir: str, mask_dir: str, instance_dir: str,
                 edge_dir: str, image_size: int = 256) -> None:
        self.img_dir = img_dir
        self.image_size = image_size
        self.samples: List[CODSample] = []
        for img_name in sorted(f for f in os.listdir(img_dir)
                               if f.lower().endswith(IMAGE_EXTS)):
            base = os.path.splitext(img_name)[0]
            paths = [os.path.join(d, base + ".png") for d in (mask_dir, instance_dir, edge_dir)]
            if all(os.path.exists(p) for p in paths):
                self.samples.append(CODSample(img_name, os.path.join(img_dir, img_name), *paths))

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        """One sample: float32 image (S, S, 3) and three maps (S, S) in [0, 1]."""
        s = self.samples[idx]
        return {
            "image": load_image_rgb(s.image_path, self.image_size),
            "mask": load_mask(s.mask_path, self.image_size),
            "instance": load_mask(s.instance_path, self.image_size),
            "edge": load_mask(s.edge_path, self.image_size),
            "image_name": s.image_name,
        }

    def load_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        items = [self.load(i) for i in indices]
        out = {k: np.stack([it[k] for it in items]) for k in ("image", "mask", "instance", "edge")}
        out["image_name"] = [it["image_name"] for it in items]
        return out
