"""Binary morphology as shifted ORs.

Port of ``camouflage_multimodal_tpu/ops/morphology.py``: the zero-filled
shift and the iterated 4-connected (scipy's default cross) and 8-connected
(3×3) dilations, over the last two axes. The plain version of Canny's
hysteresis (CPU tensors) runs one 8-connected dilation a step.
"""

from __future__ import annotations

import torch


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y − dy, x − dx], zero outside the image."""
    H, W = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        x[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)]
    return out


def binary_dilation_cross(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """4-connected binary dilation, iterated: ``scipy.ndimage.binary_dilation
    (mask, iterations=n)``."""
    out = mask.bool()
    for _ in range(iterations):
        out = (out | _shift(out, 1, 0) | _shift(out, -1, 0)
               | _shift(out, 0, 1) | _shift(out, 0, -1))
    return out


def binary_dilation_full(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """8-connected (3×3 square) binary dilation, iterated."""
    out = mask.bool()
    for _ in range(iterations):
        acc = out
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    acc = acc | _shift(out, dy, dx)
        out = acc
    return out
