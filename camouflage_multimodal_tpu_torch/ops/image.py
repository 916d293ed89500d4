"""Elementwise and separable image ops, in float32 on any device.

Port of ``camouflage_multimodal_tpu/ops/image.py``. Images are channels-last
``(..., H, W, 3)`` tensors like the JAX package's. The blur and Sobel filters
are separable sums of shifted slices, not cuDNN convolutions (which run in
TF32 on Hopper by default); "reflect" padding is scipy's, i.e. numpy's
``symmetric`` mode (edge value repeated), which ``torch.nn.functional.pad``
does not offer, so :func:`_pad_axis` builds it from slices.
"""

from __future__ import annotations

import torch

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


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) → (..., H, W) with the reference's weights."""
    w = torch.tensor(GRAY_WEIGHTS, dtype=img.dtype, device=img.device)
    return _dot3(img, w)


def _gaussian_kernel1d(sigma: float, device) -> torch.Tensor:
    """scipy.ndimage._gaussian_kernel1d weights (radius = 4·σ + 0.5, scipy's
    default truncation)."""
    radius = int(4.0 * sigma + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _pad_axis(x: torch.Tensor, pad: int, dim: int, mode: str) -> torch.Tensor:
    """Pad ``dim`` by ``pad`` on both sides: scipy "reflect" (numpy
    'symmetric': a b c | c b a) or zeros ("constant")."""
    n = x.shape[dim]
    if pad > n:
        raise ValueError(f"pad {pad} exceeds axis length {n}")
    if mode == "constant":
        shape = list(x.shape)
        shape[dim] = pad
        head = tail = x.new_zeros(shape)
    elif mode == "reflect":
        head = x.narrow(dim, 0, pad).flip(dim)
        tail = x.narrow(dim, n - pad, pad).flip(dim)
    else:
        raise ValueError(f"unknown pad mode {mode!r}: use 'reflect' or 'constant'")
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
                  channels_last: bool = False) -> torch.Tensor:
    """Separable Gaussian blur matching ``scipy.ndimage.gaussian_filter``.

    ``img`` is (..., H, W), or (..., H, W, C) with ``channels_last``. Rows
    are filtered first, then columns, like the JAX version."""
    if sigma <= 0:
        return img
    if channels_last:
        return gaussian_blur(img.movedim(-1, -3), sigma, mode).movedim(-3, -1)
    k = _gaussian_kernel1d(sigma, img.device).to(img.dtype)
    pad = (k.shape[0] - 1) // 2
    x = _pad_axis(_pad_axis(img, pad, -2, mode), pad, -1, mode)
    x = _correlate_valid(x, k, dim=-1)   # rows (along W)
    x = _correlate_valid(x, k, dim=-2)   # columns (along H)
    return x


def _sobel(img: torch.Tensor, dim: int) -> torch.Tensor:
    """scipy.ndimage.sobel (mode "reflect"): [-1, 0, 1] along ``dim``, then
    [1, 2, 1] along the other of the last two axes."""
    other = -1 if dim == -2 else -2
    deriv = torch.tensor([-1.0, 0.0, 1.0], dtype=img.dtype, device=img.device)
    smooth = torch.tensor([1.0, 2.0, 1.0], dtype=img.dtype, device=img.device)
    x = _correlate_valid(_pad_axis(img, 1, dim, "reflect"), deriv, dim)
    return _correlate_valid(_pad_axis(x, 1, other, "reflect"), smooth, other)


def sobel_h(img: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.sobel(img, axis=0): derivative along rows (y)."""
    return _sobel(img, dim=-2)


def sobel_v(img: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.sobel(img, axis=1): derivative along cols (x)."""
    return _sobel(img, dim=-1)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0,1] → CIELAB (D65), skimage.color.rgb2lab.

    The cube root is ``pow(t, 1/3)``: torch has no ``cbrt``, and the two
    differ by a few float32 ulps, which is why Lab is held to 1e-4 abs."""
    srgb = torch.clamp(rgb, 0.0, 1.0)
    linear = torch.where(srgb > 0.04045, ((srgb + 0.055) / 1.055) ** 2.4,
                         srgb / 12.92)
    m = torch.tensor(_XYZ_FROM_RGB, dtype=rgb.dtype, device=rgb.device)
    xyz = torch.stack([_dot3(linear, m[i]) for i in range(3)], dim=-1)
    white = torch.tensor(_D65_WHITE, dtype=rgb.dtype, device=rgb.device)
    t = xyz / white
    delta = 6.0 / 29.0
    f = torch.where(t > delta ** 3, torch.pow(t, 1.0 / 3.0),
                    t / (3 * delta ** 2) + 4.0 / 29.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([L, a, b], dim=-1)
