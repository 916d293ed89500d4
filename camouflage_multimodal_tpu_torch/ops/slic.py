"""SLIC superpixels, batched, with the assignment step in a CUDA kernel.

Port of ``camouflage_multimodal_tpu/ops/slic.py`` (skimage's contract:
seed grid ``step = round(sqrt(H·W/K))`` with seeds at ``step//2 + i·step``,
Lab + Gaussian blur, ±step search box around each center's current floor
position, lowest id wins ties, uncovered pixels keep their label).

The assignment is kernel B1 (``csrc/slic_assign.cu``), the port of the
Pallas kernel ``ops/pallas_slic.py:_assign_kernel``: every pixel scores ALL
K centers under the box mask, which is exact at any center drift. The JAX
main path runs a (2·radius+1)² candidate window instead; the two agree
whenever the drift ratio this function returns is < 1 (see
:func:`window_drift_bound`), so the port computes what the JAX main path
computes and its ``window_drift`` output stays comparable. Because the
assignment sweeps all K centers, the center update is the scatter form
(``index_add_`` of ``[pix, 1]``, then divide, keeping empty centers) of the
JAX package's Pallas backend (``ops/slic.py:234-241``); the blocked one-hot
update of its windowed path is only valid inside the window.

One SLIC call of ``num_iters`` iterations launches B1 ``num_iters`` times
(``num_iters - 1`` assign + update rounds, then a final assign), each launch
covering the whole batch.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.ops.image import gaussian_blur, rgb_to_lab


def slic_step(n_segments: int, height: int, width: int) -> int:
    """skimage's seed spacing."""
    return max(1, int(round(math.sqrt(height * width / n_segments))))


def grid_shape(n_segments: int, height: int, width: int) -> Tuple[int, int]:
    """Rows/cols of the seed grid (gh, gw); K = gh·gw clusters."""
    step = slic_step(n_segments, height, width)
    return len(range(step // 2, height, step)), len(range(step // 2, width, step))


def window_drift_bound(step: int, radius: int = 2) -> int:
    """Max per-axis drift of a center from its seed under which the JAX
    package's (2·radius+1)² candidate window provably covers every center a
    pixel's ±step box can reach: ``(radius−1)·step + step//2 − 1`` (the
    derivation is in the JAX docstring, ``ops/slic.py:83-99``)."""
    return (radius - 1) * step + step // 2 - 1


# ---------------------------------------------------------------------------
# Kernel B1 and its plain version
# ---------------------------------------------------------------------------

_CHUNK = 4096        # pixels per (B, chunk, K) distance block of the plain version
COMPACTNESS = 10.0   # skimage's SLIC parameters, as the reference calls it
SIGMA = 1.0


def slic_assign_plain(pix: torch.Tensor, centers: torch.Tensor,
                      prev: torch.Tensor, ratio: float, step: int) -> torch.Tensor:
    """Plain PyTorch twin of kernel B1, op for op in the kernel's rounding.

    pix (B, HW, 5) float32 (L, a, b, y, x); centers (B, K, 5) float32;
    prev (B, HW) int32. Returns (B, HW) int32 labels. Pixels are processed
    in chunks so the distance block stays small."""
    B, HW, _ = pix.shape
    K = centers.shape[1]
    r = torch.tensor(ratio, dtype=torch.float32, device=pix.device)
    c = centers[:, None, :, :]                         # (B, 1, K, 5)
    fy = torch.floor(c[..., 3])
    fx = torch.floor(c[..., 4])
    ids = torch.arange(K, dtype=torch.int32, device=pix.device)
    big = torch.tensor(K, dtype=torch.int32, device=pix.device)
    out = torch.empty_like(prev)
    for s in range(0, HW, _CHUNK):
        p = pix[:, s:s + _CHUNK, None, :]               # (B, T, 1, 5)
        py, px = p[..., 3], p[..., 4]
        ey = py - c[..., 3]
        ex = px - c[..., 4]
        d = r * (ey * ey + ex * ex)
        for ch in range(3):
            e = p[..., ch] - c[..., ch]
            d = d + e * e
        ok = (torch.abs(py - fy) <= step) & (torch.abs(px - fx) <= step)
        d = torch.where(ok, d, torch.inf)
        best = d.amin(dim=-1, keepdim=True)
        lab = torch.where(d == best, ids, big).amin(dim=-1)
        out[:, s:s + _CHUNK] = torch.where(best[..., 0] < torch.inf, lab,
                                           prev[:, s:s + _CHUNK])
    return out


def slic_assign(pix: torch.Tensor, centers: torch.Tensor, prev: torch.Tensor,
                ratio: float, step: int) -> torch.Tensor:
    """SLIC assignment over all K centers with the ±step box (kernel B1).

    CPU tensors take :func:`slic_assign_plain`; CUDA tensors launch the
    kernel; any other device raises."""
    if pix.device.type == "cpu":
        return slic_assign_plain(pix, centers, prev, ratio, step)
    if pix.device.type != "cuda":
        raise ValueError(f"slic_assign: unsupported device {pix.device}")
    B, HW, C = pix.shape
    if C != 5 or centers.dim() != 3 or centers.shape[0] != B or centers.shape[2] != 5:
        raise ValueError(f"slic_assign: bad shapes pix {tuple(pix.shape)}, "
                         f"centers {tuple(centers.shape)}")
    if prev.shape != (B, HW):
        raise ValueError(f"slic_assign: prev {tuple(prev.shape)} != {(B, HW)}")
    if pix.dtype != torch.float32 or centers.dtype != torch.float32 or prev.dtype != torch.int32:
        raise TypeError("slic_assign: pix/centers must be float32, prev int32")
    kernels.require_cuda_inputs("slic_assign", pix.device, pix=pix,
                                centers=centers, prev=prev)
    K = centers.shape[1]
    out = torch.empty_like(prev)
    lib = kernels.library("slic_assign")
    rc = lib.slic_assign(kernels.ptr(pix), kernels.ptr(centers),
                         kernels.ptr(prev), kernels.ptr(out),
                         B, HW, K, float(ratio), int(step),
                         kernels.stream_of(pix))
    kernels.check(lib, rc, "slic_assign")
    kernels.LAUNCHES["slic_assign"] += 1
    return out


# ---------------------------------------------------------------------------
# SLIC
# ---------------------------------------------------------------------------

def slic_features(images: torch.Tensor, n_segments: int = 500):
    """The SLIC state before the first assignment.

    images (B, H, W, 3) float RGB in [0, 1]. Returns ``(pix (B, HW, 5),
    centers0 (B, K, 5), step, ratio)``: pixel features (L, a, b, y, x) of
    the blurred Lab image, centers seeded on skimage's grid, and the spatial
    weight ``ratio = (compactness / step)²``."""
    B, H, W, _ = images.shape
    step = slic_step(n_segments, H, W)
    sy = torch.arange(step // 2, H, step, device=images.device)
    sx = torch.arange(step // 2, W, step, device=images.device)
    gh, gw = len(sy), len(sx)
    feat = gaussian_blur(rgb_to_lab(images), SIGMA, mode="reflect", channels_last=True)

    yy = torch.arange(H, dtype=torch.float32, device=images.device)
    xx = torch.arange(W, dtype=torch.float32, device=images.device)
    pos = torch.stack(torch.meshgrid(yy, xx, indexing="ij"), dim=-1)
    pix = torch.cat([feat, pos.expand(B, H, W, 2)], dim=-1).reshape(B, H * W, 5)

    init_color = feat[:, sy][:, :, sx]                                 # (B, gh, gw, 3)
    seed = torch.stack(torch.meshgrid(sy.float(), sx.float(), indexing="ij"), dim=-1)
    centers0 = torch.cat([init_color, seed.expand(B, gh, gw, 2)], dim=-1)
    ratio = (COMPACTNESS / step) ** 2
    return pix.contiguous(), centers0.reshape(B, gh * gw, 5).contiguous(), step, ratio


def update_centers(pix: torch.Tensor, labels: torch.Tensor,
                   centers: torch.Tensor) -> torch.Tensor:
    """Scatter-form center update: mean (L, a, b, y, x) of each cluster's
    pixels; clusters with no pixel keep their center."""
    B, HW, _ = pix.shape
    K = centers.shape[1]
    ones = torch.ones(B, HW, 1, dtype=pix.dtype, device=pix.device)
    idx = (labels.long() + K * torch.arange(B, device=pix.device)[:, None]).reshape(-1)
    moments = torch.zeros(B * K, 6, dtype=pix.dtype, device=pix.device)
    moments.index_add_(0, idx, torch.cat([pix, ones], dim=-1).reshape(-1, 6))
    moments = moments.reshape(B, K, 6)
    count = moments[..., 5:6]
    new = moments[..., :5] / torch.clamp(count, min=1.0)
    return torch.where(count > 0, new, centers)


def slic(images: torch.Tensor, n_segments: int = 500, num_iters: int = 10,
         window_radius: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw SLIC cluster ids of (B, H, W, 3) float RGB images in [0, 1].

    Returns ``(labels (B, H, W) int64 in [0, gh·gw), drift (B,) float32)``,
    what the JAX ``slic(..., enforce_connectivity=False, return_drift=True)``
    returns: ``drift`` is ``max_k |c_k − seed_k|_∞ /
    window_drift_bound(step, window_radius)`` over every center state an
    assignment saw (``window_radius`` sets only that bound here: B1 sweeps
    all K). Connectivity is a separate pass (:mod:`ops.connectivity`)."""
    B, H, W, _ = images.shape
    pix, centers, step, ratio = slic_features(images, n_segments)
    seed_pos = centers[..., 3:5]
    # step == 1 makes the bound 0 at small radii: report raw drift against a
    # floor of 1 px, as the JAX package does.
    inv_bound = 1.0 / float(max(1, window_drift_bound(step, window_radius)))

    labels = torch.zeros(B, H * W, dtype=torch.int32, device=images.device)
    maxd = torch.zeros(B, dtype=torch.float32, device=images.device)
    if num_iters > 0:
        for _ in range(num_iters - 1):
            labels = slic_assign(pix, centers, labels, ratio, step)
            centers = update_centers(pix, labels, centers)
            drift = torch.abs(centers[..., 3:5] - seed_pos).amax(dim=(1, 2))
            maxd = torch.maximum(maxd, drift * inv_bound)
        labels = slic_assign(pix, centers, labels, ratio, step)
    return labels.reshape(B, H, W).long(), maxd
