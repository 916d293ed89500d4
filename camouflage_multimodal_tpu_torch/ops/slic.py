"""SLIC superpixels, batched, with the assignment step in a CUDA kernel.

Port of ``camouflage_multimodal_tpu/ops/slic.py`` (skimage's contract:
seed grid ``step = round(sqrt(H·W/K))`` with seeds at ``step//2 + i·step``,
Lab + Gaussian blur, ±step search box around each center's current floor
position, lowest id wins ties, uncovered pixels keep their label).

The assignment is kernel B1 (``csrc/slic_assign.cu``), the port of the
Pallas kernel ``ops/pallas_slic.py:_assign_kernel``: every pixel scores ALL
K centers under the box mask, which is exact at any center drift (the
kernel first prunes, per 2-D pixel tile, the centers no pixel of the tile
can have in its box, which changes no result). The JAX
main path runs a (2·radius+1)² candidate window instead; the two agree
whenever the drift ratio this function returns is < 1 (see
:func:`window_drift_bound`), so the port computes what the JAX main path
computes and its ``window_drift`` output stays comparable. Because the
assignment sweeps all K centers, the center update is the scatter form
(a fixed-order sum of ``[pix, 1]``, ``ops.regions.index_sum``, then divide,
keeping empty centers) of the
JAX package's Pallas backend (``ops/slic.py:234-241``); the blocked one-hot
update of its windowed path is only valid inside the window.

One SLIC call of ``num_iters`` iterations launches B1 ``num_iters`` times
(``num_iters - 1`` assign + update rounds, then a final assign), each launch
covering the whole batch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.ops.image import gaussian_blur, rgb_to_lab
from camouflage_multimodal_tpu_torch.ops.regions import index_sum


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
_BLOCK = 256         # pixels (threads) of one block of kernel B1
TILE_WIDTH = 16      # B1's pixel tile is TILE_WIDTH x (_BLOCK // TILE_WIDTH); divides _BLOCK
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


def tile_candidates(centers: torch.Tensor, step: int, height: int, width: int,
                    tile: Tuple[int, int] = (16, 16)) -> torch.Tensor:
    """Which centers kernel B1 lists for each pixel tile, in plain PyTorch.

    centers (B, K, 5). ``tile`` is (rows, columns); tiles run row-major over
    the (height, width) image, ragged at the far edges. Returns a
    (B, tiles, K) bool tensor: center k is listed for a tile when its
    floored position lies within the tile's pixel rectangle grown by
    ``step`` on every side — a superset of every center that any pixel of
    the tile has in its ±step box. The checks and the list-length report use
    it; the kernel builds the same lists itself."""
    th, tw = tile
    dev = centers.device
    y0 = torch.arange(0, height, th, device=dev)
    x0 = torch.arange(0, width, tw, device=dev)
    y1 = torch.clamp(y0 + th, max=height) - 1
    x1 = torch.clamp(x0 + tw, max=width) - 1
    fy = torch.floor(centers[..., 3])[:, None, None, :]       # (B, 1, 1, K)
    fx = torch.floor(centers[..., 4])[:, None, None, :]
    in_y = (fy >= (y0 - step)[None, :, None, None]) & (fy <= (y1 + step)[None, :, None, None])
    in_x = (fx >= (x0 - step)[None, None, :, None]) & (fx <= (x1 + step)[None, None, :, None])
    return (in_y & in_x).reshape(centers.shape[0], len(y0) * len(x0), centers.shape[1])


def slic_assign(pix: torch.Tensor, centers: torch.Tensor, prev: torch.Tensor,
                ratio: float, step: int, width: Optional[int] = None) -> torch.Tensor:
    """SLIC assignment over all K centers with the ±step box (kernel B1).

    CPU tensors take :func:`slic_assign_plain`; CUDA tensors launch the
    kernel; any other device raises. ``width`` is the image width when pixel
    ``p`` of ``pix`` lies at row ``p // width``, column ``p % width``: the
    kernel then prunes the centers per ``TILE_WIDTH`` × ``256 //
    TILE_WIDTH`` pixel tile. It shapes the tiles only — the result is the
    same for any ``width`` that divides HW, and without one the kernel takes
    runs of 256 pixels. The plain version has no use for it."""
    kind = pix.device.type
    if kind == "cpu":
        return slic_assign_plain(pix, centers, prev, ratio, step)
    if kind != "cuda":
        raise ValueError(f"slic_assign: unsupported device {pix.device}")
    B, HW, C = pix.shape
    if C != 5 or centers.dim() != 3 or centers.shape[0] != B or centers.shape[2] != 5:
        raise ValueError(f"slic_assign: bad shapes pix {tuple(pix.shape)}, "
                         f"centers {tuple(centers.shape)}")
    if prev.shape != (B, HW):
        raise ValueError(f"slic_assign: prev {tuple(prev.shape)} != {(B, HW)}")
    if pix.dtype != torch.float32 or centers.dtype != torch.float32 or prev.dtype != torch.int32:
        raise TypeError("slic_assign: pix/centers must be float32, prev int32")
    if width is None:
        height, width, tile_w = 1, HW, _BLOCK
    elif width <= 0 or HW % width:
        raise ValueError(f"slic_assign: width {width} does not divide HW = {HW}")
    else:
        height, tile_w = HW // width, TILE_WIDTH
    index = pix.get_device()
    if centers.get_device() != index or prev.get_device() != index:
        raise ValueError(f"slic_assign: centers and prev must be on {pix.device}")
    if not (pix.is_contiguous() and centers.is_contiguous() and prev.is_contiguous()):
        raise ValueError("slic_assign: pix, centers and prev must be contiguous")
    out = torch.empty_like(prev)
    lib = kernels.library("slic_assign")
    rc = lib.slic_assign(pix.data_ptr(), centers.data_ptr(), prev.data_ptr(),
                         out.data_ptr(), B, height, width, tile_w,
                         centers.shape[1], float(ratio), int(step),
                         kernels.stream_handle(pix))
    if rc:
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
    moments = index_sum(torch.cat([pix, ones], dim=-1).reshape(-1, 6), idx, B * K)
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
            labels = slic_assign(pix, centers, labels, ratio, step, width=W)
            centers = update_centers(pix, labels, centers)
            drift = torch.abs(centers[..., 3:5] - seed_pos).amax(dim=(1, 2))
            maxd = torch.maximum(maxd, drift * inv_bound)
        labels = slic_assign(pix, centers, labels, ratio, step, width=W)
    return labels.reshape(B, H, W).long(), maxd
