"""COD10K naming, image decode and the RG training dataset.

The port's own copy of ``camouflage_multimodal_tpu/data/cod10k.py``
(``parse_cod10k_name``, ``load_image_rgb``, ``load_mask``, ``CODDataset``):
the single-image loaders decode with PIL (``load_image_u8`` gives the uint8
bytes, with a ``draft`` decode through ``Image.draft``), and
``CODDataset.load_batch`` decodes through the port's native threaded loader
(:mod:`native`, bit-identical to PIL) unless asked for PIL. PIL is imported
where it is used.
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


def load_image_u8(path: str, size: int = 256, draft: bool = False) -> np.ndarray:
    """Decode + resize an RGB image → (size, size, 3) uint8 (PIL's bytes).

    ``draft=True`` lets libjpeg decode a JPEG at a reduced DCT scale
    (``Image.draft``: 1/2, 1/4 or 1/8, the smallest that still covers
    ``size`` on both axes) before the resize, as the JAX package's native
    loader does with ``draft=True`` (which also takes the M/8 scales between
    them); other formats decode in full. Draft pixels differ slightly from
    the full decode: for throughput, not parity."""
    from PIL import Image

    img = Image.open(path)
    if draft:
        img.draft("RGB", (size, size))
    return np.array(img.convert("RGB").resize((size, size)))


def load_image_rgb(path: str, size: int = 256) -> np.ndarray:
    """Decode + resize an RGB image → (size, size, 3) float32 in [0, 1]."""
    return load_image_u8(path, size).astype(np.float32) / 255.0


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
    instance, edge: ``{base}.png`` in each directory), resized to
    ``image_size`` (bicubic, ``Image.resize``'s default).

    ``use_native`` (``None`` or ``True``, the default) decodes each batch
    with four threaded calls of the native loader (:mod:`native`: libjpeg /
    libpng and PIL's fixed-point bicubic, the same bytes as PIL); the
    library is built here and a failed build raises. A batch with a file
    the native decoder rejects is decoded again with PIL, as the JAX
    dataset does. ``False`` decodes with PIL."""

    def __init__(self, img_dir: str, mask_dir: str, instance_dir: str,
                 edge_dir: str, image_size: int = 256,
                 use_native: Optional[bool] = None) -> None:
        self.img_dir = img_dir
        self.image_size = image_size
        self.use_native = use_native is not False
        if self.use_native:
            from camouflage_multimodal_tpu_torch import native

            native.get_lib()
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
        samples = [self.samples[i] for i in indices]
        names = [s.image_name for s in samples]
        if self.use_native:
            from camouflage_multimodal_tpu_torch import native

            S = self.image_size
            images, ok = native.load_batch([s.image_path for s in samples], S)
            out = {"image": images}
            for key, attr in (("mask", "mask_path"), ("instance", "instance_path"),
                              ("edge", "edge_path")):
                out[key], ok_k = native.load_batch([getattr(s, attr) for s in samples], S,
                                                   gray=True)
                ok &= ok_k
            if ok.all():
                out["image_name"] = names
                return out
            # a file the native decoder rejected: the batch through PIL
        items = [self.load(i) for i in indices]
        out = {k: np.stack([it[k] for it in items]) for k in ("image", "mask", "instance", "edge")}
        out["image_name"] = names
        return out
