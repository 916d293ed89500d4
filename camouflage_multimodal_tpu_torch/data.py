"""Host-side helpers of the inference and training paths.

The port's own copies of ``camouflage_multimodal_tpu/data/cod10k.py``
(``parse_cod10k_name``, ``load_image_rgb``, ``load_mask``, ``CODDataset``
with its PIL decode; the JAX package's native loader is bit-identical to
PIL by its own docstring and is not ported), ``data/matcher.py:
build_ordered_kg_tensor``, the ``.npz`` branches of ``core/artifacts.py:
save_kg_embeddings`` / ``load_kg_embeddings`` and ``data/labels.py:
extract_label_from_mask``. PIL, cv2 and scipy are imported where they are
used: sample records that already carry their labels need none of them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

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


def save_kg_embeddings(path: str, store: Dict[str, np.ndarray]) -> None:
    """category → (1, dim) embedding, as a compressed ``.npz``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v, np.float32) for k, v in store.items()})


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


def _mask_stats(mask: np.ndarray) -> Tuple[float, int]:
    """(Canny edge ratio, external contour count) of a uint8 mask: with cv2
    where it is installed (the reference's own calls), else the port's
    Canny on the normalised mask and an 8-connected component count (what
    ``RETR_EXTERNAL`` counts, holes excluded)."""
    try:
        import cv2
    except ImportError:
        import scipy.ndimage as ndi
        import torch

        from camouflage_multimodal_tpu_torch.ops.canny import canny

        edges = canny(torch.from_numpy(mask.astype(np.float32) / 255.0), sigma=1.0)
        _, complexity = ndi.label(mask > 10, structure=np.ones((3, 3)))
        return float(edges.sum()) / mask.size, int(complexity)
    edges = cv2.Canny(mask, 50, 150)
    _, binary = cv2.threshold(mask, 10, 255, cv2.THRESH_BINARY)
    contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    return (edges > 0).sum() / mask.size, len(contours)


def _read_gray(path: str):
    """uint8 grayscale image, or None when it cannot be read; decoded by cv2
    where it is installed, as the reference does, else by PIL."""
    try:
        import cv2
    except ImportError:
        from PIL import Image

        try:
            return np.asarray(Image.open(path).convert("L"))
        except OSError:
            return None
    return cv2.imread(path, cv2.IMREAD_GRAYSCALE)


def extract_label_from_mask(mask_or_path, threshold: float = 0.1) -> Tuple[int, float]:
    """Image-level (label, confidence) from a GT mask path or uint8 array:
    the reference's thresholds on mean intensity, non-zero ratio, edge ratio
    and contour count (``train_multimodal.py:62-92``)."""
    if isinstance(mask_or_path, str):
        mask = _read_gray(mask_or_path)
        if mask is None:
            return 0, 0.0
    else:
        mask = np.asarray(mask_or_path, dtype=np.uint8)

    mean_intensity = (mask.astype(float) / 255.0).mean()
    non_zero_ratio = (mask > 10).sum() / mask.size
    edge_ratio, complexity = _mask_stats(mask)

    if mean_intensity > threshold and non_zero_ratio > 0.05:
        simple = edge_ratio < 0.02 or complexity > 10
        return 1, float(min(mean_intensity * 2, 1.0) if simple else mean_intensity)
    return 0, float(1.0 - mean_intensity)
