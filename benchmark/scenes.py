"""Seeded inputs: natural-looking scenes with a camouflaged object, made on
the device in a few large calls and written as JPEG files.

The law is that of the program's own seeded stand-ins for COD10K
(``chip_smoke.py``'s ``synthetic_images`` and ``BlobDataset``, copied here
so the yardstick does not move with the program): a base colour, six soft
colour blobs, a sine texture and noise, with one disc of its own colour and
stripes painted in, at COD10K's 1024 × 768.
"""

from __future__ import annotations

import io
import math
import os
from typing import List, Tuple

import numpy as np
import torch


def scenes(generator: torch.Generator, n: int, width: int, height: int,
           chunk: int = 8) -> torch.Tensor:
    """(n, height, width, 3) uint8 scenes on the generator's device."""
    dev = generator.device
    yy = torch.arange(height, device=dev, dtype=torch.float32)[:, None] / height
    xx = torch.arange(width, device=dev, dtype=torch.float32)[None, :] / width
    out = []
    for start in range(0, n, chunk):
        m = min(chunk, n - start)

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        img = (0.5 * rand(m, 1, 1, 3)).expand(m, height, width, 3).clone()
        centre, radius, colour = rand(m, 6, 2), 0.05 + 0.2 * rand(m, 6), rand(m, 6, 3) - 0.3
        for b in range(6):
            d2 = ((yy[None] - centre[:, b, 0, None, None]) ** 2
                  + (xx[None] - centre[:, b, 1, None, None]) ** 2)
            blob = torch.exp(-d2 / (2 * radius[:, b, None, None] ** 2))
            img += blob[..., None] * colour[:, b, None, None, :]
        freq = 4 + 16 * rand(m, 2)
        wave = torch.sin(2 * math.pi * (freq[:, 0, None, None] * yy[None]
                                        + freq[:, 1, None, None] * xx[None]))
        img += 0.08 * wave[..., None] * rand(m, 1, 1, 3)
        img += 0.04 * torch.randn((m, height, width, 3), generator=generator, device=dev)
        # The object: a disc of its own colour with stripes, the middle half.
        oc = 0.25 + 0.5 * rand(m, 2)
        orad = (0.12 + 0.13 * rand(m)) * min(height, width)
        py = torch.arange(height, device=dev, dtype=torch.float32)[:, None]
        px = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
        inside = ((py[None] - oc[:, 0, None, None] * height) ** 2
                  + (px[None] - oc[:, 1, None, None] * width) ** 2) < orad[:, None, None] ** 2
        period = 3 + 6 * rand(m)
        stripes = (torch.sin(px[None] / period[:, None, None]) > 0).float() * (25 / 255)
        obj = (40 + 176 * rand(m, 1, 1, 3)) / 255 + stripes[..., None] \
            + (24 * rand(m, height, width, 3) - 12) / 255
        img = torch.where(inside[..., None], obj, img)
        out.append((img.clamp(0, 1) * 255).round().to(torch.uint8))
    return torch.cat(out)


def jpeg_bytes(images: torch.Tensor, quality: int = 90) -> List[bytes]:
    """Each (H, W, 3) uint8 image of ``images`` as a JPEG file's bytes."""
    from PIL import Image

    host = images.cpu().numpy()
    out = []
    for img in host:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=quality)
        out.append(buf.getvalue())
    return out


def write_jpegs(root: str, blobs: List[bytes]) -> List[str]:
    os.makedirs(root, exist_ok=True)
    paths = []
    for i, b in enumerate(blobs):
        path = os.path.join(root, f"scene_{i:04d}.jpg")
        with open(path, "wb") as f:
            f.write(b)
        paths.append(path)
    return paths


def decode(blob: bytes, size: int) -> np.ndarray:
    """A JPEG's bytes → (size, size, 3) uint8, as a user's upload is read:
    PIL's decode, RGB, PIL's default resize (bicubic)."""
    from PIL import Image

    img = Image.open(io.BytesIO(blob)).convert("RGB").resize((size, size))
    return np.asarray(img, dtype=np.uint8)


def decode_file(path: str, size: int) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read(), size)


def node_counts(generator: torch.Generator, n: int, lo: int, hi: int) -> torch.Tensor:
    """(n,) node counts drawn uniformly from [lo, hi]."""
    return torch.randint(lo, hi + 1, (n,), generator=generator, device=generator.device)


def disc_labels(generator: torch.Generator, n: int, size: int) -> Tuple[torch.Tensor, ...]:
    """Image-level labels of ``n`` seeded GT discs (radius 0.12–0.25 of the
    side, a 4-pixel ring as edge map), as the fusion dataset derives them:
    the object's share of the image as score, label 1 where it exceeds
    10 %, edge 1 where the ring's mean grey level exceeds 10."""
    dev = generator.device
    r = (0.12 + 0.13 * torch.rand(n, generator=generator, device=dev)) * size
    share = math.pi * r ** 2 / size ** 2
    ring = 2 * math.pi * r * 4 / size ** 2
    return (share > 0.1).long(), (ring * 255 > 10).float(), share.float()
