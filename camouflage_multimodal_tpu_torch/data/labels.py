"""Image-level labels from GT masks.

The port's own copy of ``camouflage_multimodal_tpu/data/labels.py``
(``extract_label_from_mask``). cv2 and scipy are imported where they are
used: sample records that already carry their labels need neither.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
