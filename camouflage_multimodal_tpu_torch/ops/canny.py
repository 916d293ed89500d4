"""Canny edge detection (``skimage.feature.canny``), batched.

Port of ``camouflage_multimodal_tpu/ops/canny.py``: border-compensated
Gaussian smoothing, Sobel gradients, bilinear non-maximum suppression and
double-threshold hysteresis run to a fixed point. The gradient magnitude
uses JAX's ``hypot`` formula (``max·sqrt(1 + (min/max)²)``), so it rounds
like the reference.

The hysteresis (:func:`canny_hysteresis`) is one CUDA kernel on the card,
``csrc/canny_hysteresis.cu``: the whole fixed point in one launch, with no
host synchronisation, as the JAX package's ``lax.while_loop`` runs inside
one program. CPU tensors take the plain version, :func:`_hysteresis`, a
masked 8-connected dilation tested for convergence on the host.

Under spatial sharding (``row_group``: each rank holds a block of rows) the
stencils run on the rank's rows extended by ``radius + 2`` rows of each
neighbour (the blur's radius ``image.blur_radius(sigma)``, one row for Sobel and one for the
non-maximum suppression), so each pads only at the image's global top and
bottom and the rank's rows come out as without sharding, to the bit. The
hysteresis is a fixed point over the whole image that runs many dilation
rounds: rather than a halo exchange per round (a collective each, ~30 ms
apiece for gloo on CUDA tensors, PERF.md §5), the low and high masks are
gathered over the ranks once (a byte-exact gather), the fixed point runs
on the whole image on every rank, and each keeps its rows. A distributed
form waits for a benchmark that shows this gather matters.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.core.profiling import annotate
from camouflage_multimodal_tpu_torch.ops.image import blur_radius, gaussian_blur, sobel_h, sobel_v
from camouflage_multimodal_tpu_torch.ops.morphology import _shift, binary_dilation_full
from camouflage_multimodal_tpu_torch.parallel.sharding import gather_dim, halo_rows

_STEPS_PER_CHECK = 8   # hysteresis dilations between convergence tests
# Shared memory a block of the H100 may take (227 KB): an image whose two
# packed masks (8 bytes a 32-pixel word of a row) need more runs the
# kernel's fixed point over a scratch buffer in device memory.
_SHARED_BYTES = 232448


def _preprocess(image: torch.Tensor, sigma: float):
    """Smoothed image and eroded border mask (skimage ``_preprocess``)."""
    H, W = image.shape[-2:]
    smoothed = gaussian_blur(image, sigma, mode="constant")
    bleed = gaussian_blur(torch.ones(H, W, dtype=image.dtype, device=image.device),
                          sigma, mode="constant")
    smoothed = smoothed / (bleed + 1e-12)
    eroded = torch.zeros(H, W, dtype=torch.bool, device=image.device)
    eroded[1:-1, 1:-1] = True
    return smoothed, eroded


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.abs(a), torch.abs(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    return torch.where(hi == 0, hi, hi * torch.sqrt(1 + torch.square(lo / safe)))


def _nonmax_suppression(gy, gx, mag, mask):
    """Bilinear-interpolated NMS along the gradient direction."""
    ay, ax = torch.abs(gy), torch.abs(gx)
    sy = torch.where(gy >= 0, 1, -1)
    sx = torch.where(gx >= 0, 1, -1)

    def nb(dy_sign, dx_sign):
        """Magnitude at (y + dy_sign·sy, x + dx_sign·sx), signs per pixel."""
        out = None
        for cy in ((0,) if dy_sign == 0 else (1, -1)):
            for cx in ((0,) if dx_sign == 0 else (1, -1)):
                shifted = _shift(mag, -cy, -cx)         # value at (y+cy, x+cx)
                cond = torch.ones_like(mag, dtype=torch.bool)
                if dy_sign != 0:
                    cond = cond & (sy * dy_sign == cy)
                if dx_sign != 0:
                    cond = cond & (sx * dx_sign == cx)
                term = shifted * cond
                out = term if out is None else out + term
        return out

    w_a = torch.where(ax > 0, ay / torch.clamp(ax, min=1e-20), 0.0)
    a_plus = (1 - w_a) * nb(0, +1) + w_a * nb(+1, +1)
    a_minus = (1 - w_a) * nb(0, -1) + w_a * nb(-1, -1)
    keep_a = (mag >= a_plus) & (mag >= a_minus)

    w_b = torch.where(ay > 0, ax / torch.clamp(ay, min=1e-20), 0.0)
    b_plus = (1 - w_b) * nb(+1, 0) + w_b * nb(+1, +1)
    b_minus = (1 - w_b) * nb(-1, 0) + w_b * nb(-1, -1)
    keep_b = (mag >= b_plus) & (mag >= b_minus)

    keep = torch.where(ax >= ay, keep_a, keep_b)
    return keep & mask & (mag > 0)


def _hysteresis(low_mask: torch.Tensor, high_mask: torch.Tensor) -> torch.Tensor:
    """Low-threshold pixels 8-connected to a strong pixel: dilate within the
    low mask to a fixed point (steps past it are no-ops, so convergence is
    tested every ``_STEPS_PER_CHECK`` steps to spare host syncs; each test
    is one ``cmt::sync.canny`` span). The plain version of
    :func:`canny_hysteresis`, which takes it for CPU tensors."""
    cur = high_mask & low_mask
    while True:
        prev = cur
        for _ in range(_STEPS_PER_CHECK):
            cur = binary_dilation_full(cur) & low_mask
        with annotate("cmt::sync.canny"):
            converged = torch.equal(cur, prev)
        if converged:
            return cur


def canny_hysteresis(low_mask: torch.Tensor, high_mask: torch.Tensor,
                     return_rounds: bool = False):
    """Canny's hysteresis on bool (..., H, W) masks: the pixels of
    ``low_mask`` 8-connected, through pixels of ``low_mask``, to a pixel of
    ``high_mask & low_mask``.

    CPU tensors take :func:`_hysteresis`; CUDA tensors launch the kernel
    (one launch, no host synchronisation); any other device raises. With
    ``return_rounds`` (CUDA only) it also returns the int32 rounds each
    image took, shaped like the leading dimensions: reading them waits for
    the card, so the main path does not ask."""
    kind = low_mask.device.type
    if kind == "cpu":
        if return_rounds:
            raise ValueError("canny_hysteresis: rounds are counted by the kernel (CUDA tensors)")
        return _hysteresis(low_mask, high_mask)
    if kind != "cuda":
        raise ValueError(f"canny_hysteresis: unsupported device {low_mask.device}")
    if low_mask.dtype != torch.bool or high_mask.dtype != torch.bool:
        raise TypeError("canny_hysteresis: the masks must be bool")
    if low_mask.dim() < 2 or low_mask.shape != high_mask.shape:
        raise ValueError(f"canny_hysteresis: bad shapes low {tuple(low_mask.shape)}, "
                         f"high {tuple(high_mask.shape)}")
    if high_mask.device != low_mask.device:
        raise ValueError(f"canny_hysteresis: high must be on {low_mask.device}")
    if not (low_mask.is_contiguous() and high_mask.is_contiguous()):
        raise ValueError("canny_hysteresis: the masks must be contiguous")
    if not low_mask.numel():
        raise ValueError("canny_hysteresis: the masks hold no pixel")
    H, W = low_mask.shape[-2:]
    B = low_mask.numel() // (H * W)
    words = H * -(-W // 32)
    scratch = (None if 8 * words <= _SHARED_BYTES else
               torch.empty(2 * B * words, dtype=torch.int32, device=low_mask.device))
    out = torch.empty_like(low_mask)
    rounds = torch.empty(low_mask.shape[:-2], dtype=torch.int32, device=low_mask.device)
    lib = kernels.library("canny_hysteresis")
    rc = lib.canny_hysteresis(low_mask.data_ptr(), high_mask.data_ptr(), out.data_ptr(),
                              rounds.data_ptr(), None if scratch is None else scratch.data_ptr(),
                              B, H, W, kernels.stream_handle(low_mask))
    if rc:
        kernels.check(lib, rc, "canny_hysteresis")
    kernels.LAUNCHES["canny_hysteresis"] += 1
    return (out, rounds) if return_rounds else out


def canny(gray: torch.Tensor, sigma: float = 2.0, low_threshold: float = 0.1,
          high_threshold: float = 0.2, row_group=None) -> torch.Tensor:
    """Canny edges of float (..., H, W) images in [0, 1] → bool maps. The
    default thresholds are skimage's for float images. Under a
    ``row_group``, ``gray`` is this rank's block of rows and so is the
    result (module docstring)."""
    thresholds = (low_threshold, high_threshold)
    if row_group is None:
        return canny_hysteresis(*_threshold_masks(gray, sigma, *thresholds))
    rows = gray.shape[-2]
    ext, top = halo_rows(gray, blur_radius(sigma) + 2, row_group, dim=-2)
    low, high = (m.narrow(-2, top, rows) for m in _threshold_masks(ext, sigma, *thresholds))
    whole = gather_dim(torch.stack([low, high]), low.ndim - 1, row_group)
    return canny_hysteresis(whole[0], whole[1]).narrow(-2, rows * dist.get_rank(row_group), rows)


def _threshold_masks(gray: torch.Tensor, sigma: float, low_threshold: float = 0.1,
                     high_threshold: float = 0.2):
    """Canny's low and high masks: local maxima of the gradient magnitude
    at or above the two thresholds."""
    smoothed, eroded = _preprocess(gray, sigma)
    gy = sobel_h(smoothed)
    gx = sobel_v(smoothed)
    mag = _hypot(gy, gx)
    local_max = _nonmax_suppression(gy, gx, mag, eroded)
    return local_max & (mag >= low_threshold), local_max & (mag >= high_threshold)
