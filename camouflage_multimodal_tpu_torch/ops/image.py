"""Elementwise and separable image ops, in float32 on any device.

Port of ``camouflage_multimodal_tpu/ops/image.py``. Images are channels-last
``(..., H, W, 3)`` tensors like the JAX package's. The blur and Sobel filters
are separable sums of shifted slices, not cuDNN convolutions (which run in
TF32 on Hopper by default). Border modes are scipy's, as the JAX package
pads them: "reflect" is numpy's ``symmetric`` (edge value repeated), which
``torch.nn.functional.pad`` does not offer, "mirror" numpy's ``reflect``,
"nearest" the edge value and "constant" zeros; :func:`_pad_axis` builds
each from slices.

A constant built from a host list on the card (``torch.tensor(...,
device=)``) is a copy from pageable memory, which waits for the card's
queue to drain: each such copy on the graph build's path lies in a
``cmt::sync.<site>`` span (``core.profiling``).
"""

from __future__ import annotations

import torch

from camouflage_multimodal_tpu_torch.core.profiling import annotate

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

GRAY_WEIGHTS = (0.2989, 0.5870, 0.1140)

_XYZ_FROM_RGB = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_D65_WHITE = (0.95047, 1.0, 1.08883)


def _dot3(img: torch.Tensor, w) -> torch.Tensor:
    """``img @ w`` over a trailing axis of 3, summed left to right."""
    return img[..., 0] * w[0] + img[..., 1] * w[1] + img[..., 2] * w[2]


def imagenet_normalize(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) float image in [0, 1] → ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def imagenet_denormalize(img: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`imagenet_normalize`, clipped to [0, 1] as the
    reference does."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return torch.clamp(img * std + mean, 0.0, 1.0)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) → (..., H, W) with the reference's weights."""
    with annotate("cmt::sync.gray"):
        w = torch.tensor(GRAY_WEIGHTS, dtype=img.dtype, device=img.device)
    return _dot3(img, w)


def blur_radius(sigma: float, truncate: float = 4.0) -> int:
    """Rows (and columns) that :func:`gaussian_blur` reads on each side of a
    pixel: scipy's ``int(truncate·σ + 0.5)``, 0 for ``sigma <= 0`` (no
    blur)."""
    return int(truncate * sigma + 0.5) if sigma > 0 else 0


def _gaussian_kernel1d(sigma: float, device, truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage._gaussian_kernel1d weights (radius ``int(truncate·σ +
    0.5)``)."""
    radius = blur_radius(sigma, truncate)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _pad_axis(x: torch.Tensor, pad: int, dim: int, mode: str) -> torch.Tensor:
    """Pad ``dim`` by ``pad`` on both sides in a scipy border mode:
    "reflect" (numpy 'symmetric': b a | a b c ...), "mirror" (numpy
    'reflect': c b | a b c ..., the edge not repeated), "nearest" (the edge
    value) or "constant" (zeros)."""
    n = x.shape[dim]
    if mode == "mirror":
        if pad >= n:
            raise ValueError(f"pad {pad} needs an axis longer than {n} in mode 'mirror'")
    elif pad > n:
        raise ValueError(f"pad {pad} exceeds axis length {n}")
    if mode == "constant":
        shape = list(x.shape)
        shape[dim] = pad
        head = tail = x.new_zeros(shape)
    elif mode == "reflect":
        head = x.narrow(dim, 0, pad).flip(dim)
        tail = x.narrow(dim, n - pad, pad).flip(dim)
    elif mode == "mirror":
        head = x.narrow(dim, 1, pad).flip(dim)
        tail = x.narrow(dim, n - 1 - pad, pad).flip(dim)
    elif mode == "nearest":
        head = x.narrow(dim, 0, 1).expand_as(x.narrow(dim, 0, pad))
        tail = x.narrow(dim, n - 1, 1).expand_as(head)
    else:
        raise ValueError(f"unknown pad mode {mode!r}: use 'reflect', 'mirror', "
                         "'nearest' or 'constant'")
    return torch.cat([head, x, tail], dim=dim)


def _correlate_valid(x: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    """Valid-mode correlation along ``dim``: out[n] = Σᵢ k[i]·x[n+i],
    accumulated in tap order."""
    taps = k.shape[0]
    n = x.shape[dim] - taps + 1
    out = x.narrow(dim, 0, n) * k[0]
    for i in range(1, taps):
        out = out + x.narrow(dim, i, n) * k[i]
    return out


def gaussian_blur(img: torch.Tensor, sigma: float, mode: str = "reflect",
                  truncate: float = 4.0, channels_last: bool = False) -> torch.Tensor:
    """Separable Gaussian blur matching ``scipy.ndimage.gaussian_filter``
    (kernel radius ``int(truncate·σ + 0.5)``, :func:`blur_radius`).

    ``img`` is (..., H, W), or (..., H, W, C) with ``channels_last``. Rows
    are filtered first, then columns, like the JAX version."""
    if sigma <= 0:
        return img
    if channels_last:
        return gaussian_blur(img.movedim(-1, -3), sigma, mode, truncate).movedim(-3, -1)
    k = _gaussian_kernel1d(sigma, img.device, truncate).to(img.dtype)
    pad = (k.shape[0] - 1) // 2
    x = _pad_axis(_pad_axis(img, pad, -2, mode), pad, -1, mode)
    x = _correlate_valid(x, k, dim=-1)   # rows (along W)
    x = _correlate_valid(x, k, dim=-2)   # columns (along H)
    return x


def _sobel(img: torch.Tensor, dim: int, mode: str) -> torch.Tensor:
    """scipy.ndimage.sobel: [-1, 0, 1] along ``dim``, then [1, 2, 1] along
    the other of the last two axes, each padded in ``mode``."""
    other = -1 if dim == -2 else -2
    with annotate("cmt::sync.sobel"):
        deriv = torch.tensor([-1.0, 0.0, 1.0], dtype=img.dtype, device=img.device)
        smooth = torch.tensor([1.0, 2.0, 1.0], dtype=img.dtype, device=img.device)
    x = _correlate_valid(_pad_axis(img, 1, dim, mode), deriv, dim)
    return _correlate_valid(_pad_axis(x, 1, other, mode), smooth, other)


def sobel_h(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """scipy.ndimage.sobel(img, axis=0, mode=mode): derivative along rows (y)."""
    return _sobel(img, dim=-2, mode=mode)


def sobel_v(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """scipy.ndimage.sobel(img, axis=1, mode=mode): derivative along cols (x)."""
    return _sobel(img, dim=-1, mode=mode)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0,1] → CIELAB (D65), skimage.color.rgb2lab.

    The cube root is ``pow(t, 1/3)``: torch has no ``cbrt``, and the two
    differ by a few float32 ulps, which is why Lab is held to 1e-4 abs."""
    srgb = torch.clamp(rgb, 0.0, 1.0)
    linear = torch.where(srgb > 0.04045, ((srgb + 0.055) / 1.055) ** 2.4,
                         srgb / 12.92)
    with annotate("cmt::sync.lab"):
        m = torch.tensor(_XYZ_FROM_RGB, dtype=rgb.dtype, device=rgb.device)
        white = torch.tensor(_D65_WHITE, dtype=rgb.dtype, device=rgb.device)
    xyz = torch.stack([_dot3(linear, m[i]) for i in range(3)], dim=-1)
    t = xyz / white
    delta = 6.0 / 29.0
    f = torch.where(t > delta ** 3, torch.pow(t, 1.0 / 3.0),
                    t / (3 * delta ** 2) + 4.0 / 29.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([L, a, b], dim=-1)
