"""Binary morphology as shifted ORs.

Port of the part of ``camouflage_multimodal_tpu/ops/morphology.py`` the
inference path runs: the zero-filled shift and the 8-connected 3×3 dilation
of Canny's hysteresis, over the last two axes.
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


def binary_dilation_full(mask: torch.Tensor) -> torch.Tensor:
    """One 8-connected (3×3 square) binary dilation."""
    out = mask.bool()
    acc = out
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                acc = acc | _shift(out, dy, dx)
    return acc
