"""SLIC superpixels, batched, with two assignment backends.

Port of ``camouflage_multimodal_tpu/ops/slic.py`` (skimage's contract:
seed grid ``step = round(sqrt(H·W/K))`` with seeds at ``step//2 + i·step``,
Lab (or ``image·255``) + Gaussian blur, ±step search box around each
center's current floor position, lowest id wins ties, uncovered pixels keep
their label). :func:`slic` takes JAX's parameters and defaults. Its two
backends are the JAX package's two, under names of their own: the JAX
names ``"xla"`` and ``"pallas"`` name TPU toolchains, which the port does
not use.

``backend="window"`` (JAX's ``"xla"``, its default and main path) is the
blocked windowed assignment in plain PyTorch: the image is cut into
step × step seed blocks, each pixel scores the (2·radius+1)² centers of its
block's candidate window, and the centers are updated by the one-hot moment
product of each block with its window, placed on the seed grid by static
shifts (JAX ``ops/slic.py:246-372``). It equals the all-K sweep while the
drift ratio stays below 1 (:func:`window_drift_bound`); the one-hot update
is only valid inside the window.

``backend="exact"`` (JAX's ``"pallas"``) is kernel B1
(``csrc/slic_assign.cu``), the port of the Pallas kernel
``ops/pallas_slic.py:_assign_kernel``: every pixel scores ALL K centers
under the box mask, which is exact at any center drift (the kernel first
prunes, per 2-D pixel tile, the centers no pixel of the tile can have in
its box, which changes no result). Because it sweeps all K centers, the
center update is the scatter form (a fixed-order sum of ``[pix, 1]``,
``ops.regions.index_sum``, then divide, keeping empty centers) of the JAX
package's Pallas backend (``ops/slic.py:234-241``). The port's pipeline
runs this backend: its drift output stays comparable to the JAX main
path's windowed one, whose labels it equals while that ratio is < 1.

One ``"exact"`` call of ``num_iters`` iterations launches B1 ``num_iters``
times (``num_iters - 1`` assign + update rounds, then a final assign), each
launch covering the whole batch.

Under spatial sharding (``row_group``, the mesh's ``model`` group, each rank
holding a block of image rows; :func:`parallel.sharding.shard_spatial`;
``"exact"`` only) the blur reads the blur radius's halo rows of each
neighbour and reflects only at the image's global top and bottom, pixel
features carry global y, the centers are replicated (the seeds' colours
gathered from the ranks that hold their rows), B1 assigns this rank's
pixels (its candidate lists come from the features' positions, so global y
needs no change there), and the center update sums each rank's moments and
all-reduces them: every rank holds the same centers and drift.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.core import kernels
from camouflage_multimodal_tpu_torch.ops.connectivity import enforce_label_connectivity
from camouflage_multimodal_tpu_torch.ops.image import blur_radius, gaussian_blur, rgb_to_lab
from camouflage_multimodal_tpu_torch.ops.regions import index_sum
from camouflage_multimodal_tpu_torch.parallel.sharding import (
    all_reduce_, combine_, halo_rows, spatial_rows)


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
# On the CPU the block is held to about this many elements (4 MB of float32)
# so that it stays in cache: at 256² a (9, 4096, 529) block ran several
# times slower an image.
_CPU_BLOCK = 1 << 20
_BLOCK = 256         # pixels (threads) of one block of kernel B1
TILE_WIDTH = 16      # B1's pixel tile is TILE_WIDTH x (_BLOCK // TILE_WIDTH); divides _BLOCK
COMPACTNESS = 10.0   # skimage's SLIC parameters, as the reference calls it (the defaults)
SIGMA = 1.0
BACKENDS = {"window": "xla", "exact": "pallas"}   # the port's names → the JAX package's


def slic_assign_plain(pix: torch.Tensor, centers: torch.Tensor,
                      prev: torch.Tensor, ratio: float, step: int) -> torch.Tensor:
    """Plain PyTorch twin of kernel B1, op for op in the kernel's rounding.

    pix (B, HW, 5) float32 (L, a, b, y, x); centers (B, K, 5) float32;
    prev (B, HW) int32. Returns (B, HW) int32 labels. Pixels are processed
    in chunks so the distance block stays small. On the CPU a chunk also
    leaves out the centers whose row lies more than ``step`` from all of its
    pixels' rows (the box test rejects them; the labels are the same)."""
    B, HW, _ = pix.shape
    K = centers.shape[1]
    band = not pix.is_cuda
    chunk = max(1, _CPU_BLOCK // (B * K)) if band else _CHUNK
    r = torch.tensor(ratio, dtype=torch.float32, device=pix.device)
    every = centers[:, None, :, :]                     # (B, 1, K, 5)
    floors = torch.floor(every[..., 3:5])              # (B, 1, K, 2): fy, fx
    ids_every = torch.arange(K, dtype=torch.int32, device=pix.device)
    big = torch.tensor(K, dtype=torch.int32, device=pix.device)
    out = torch.empty_like(prev)
    for s in range(0, HW, chunk):
        p = pix[:, s:s + chunk, None, :]                # (B, T, 1, 5)
        py, px = p[..., 3], p[..., 4]
        c, f, ids = every, floors, ids_every
        if band:
            rows = floors[:, 0, :, 0]
            near = ((rows >= py.min() - step) & (rows <= py.max() + step)).any(0)
            if not near.any():         # no center in reach: every pixel keeps its label
                out[:, s:s + chunk] = prev[:, s:s + chunk]
                continue
            c, f, ids = every[:, :, near], floors[:, :, near], ids_every[near]
        fy, fx = f[..., 0], f[..., 1]
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
        out[:, s:s + chunk] = torch.where(best[..., 0] < torch.inf, lab,
                                          prev[:, s:s + chunk])
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

def slic_features(images: torch.Tensor, n_segments: int = 500, row_group=None, *,
                  compactness: float = COMPACTNESS, sigma: float = SIGMA,
                  convert_lab: bool = True):
    """The SLIC state before the first assignment.

    images (B, H, W, 3) float RGB in [0, 1] — under a ``row_group`` this
    rank's block of rows of (B, H·m, W, 3) images. Returns ``(pix (B, HW,
    5), centers0 (B, K, 5), step, ratio)``: pixel features (L, a, b, y, x)
    of the blurred Lab image (``image·255`` with ``convert_lab=False``; no
    blur for ``sigma <= 0``; global y), centers seeded on skimage's grid of
    the whole image, and the spatial weight ``ratio = (compactness /
    step)²``."""
    B, H, W, _ = images.shape
    rows, H_all = spatial_rows(H, row_group)
    step = slic_step(n_segments, H_all, W)
    sy = torch.arange(step // 2, H_all, step, device=images.device)
    sx = torch.arange(step // 2, W, step, device=images.device)
    gh, gw = len(sy), len(sx)
    ext, top = halo_rows(images, blur_radius(sigma), row_group)
    feat = rgb_to_lab(ext) if convert_lab else ext * 255.0
    feat = gaussian_blur(feat, sigma, mode="reflect", channels_last=True)[:, top:top + H]

    yy = torch.arange(rows.start, rows.stop, dtype=torch.float32, device=images.device)
    xx = torch.arange(W, dtype=torch.float32, device=images.device)
    pos = torch.stack(torch.meshgrid(yy, xx, indexing="ij"), dim=-1)
    pix = torch.cat([feat, pos.expand(B, H, W, 2)], dim=-1).reshape(B, H * W, 5)

    # The seed rows this rank holds: grid rows [i0, i1), all of them unsharded.
    i0, i1 = (min(gh, max(0, -(-(r - step // 2) // step))) for r in (rows.start, rows.stop))
    init_color = feat[:, sy[i0:i1] - rows.start][:, :, sx]              # (B, i1 - i0, gw, 3)
    if row_group is not None:                                           # (B, gh, gw, 3) everywhere
        whole = torch.zeros(B, gh, gw, 3, dtype=feat.dtype, device=feat.device)
        whole[:, i0:i1] = init_color
        init_color = combine_(whole, row_group)
    seed = torch.stack(torch.meshgrid(sy.float(), sx.float(), indexing="ij"), dim=-1)
    centers0 = torch.cat([init_color, seed.expand(B, gh, gw, 2)], dim=-1)
    ratio = (compactness / step) ** 2
    return pix.contiguous(), centers0.reshape(B, gh * gw, 5).contiguous(), step, ratio


def update_centers(pix: torch.Tensor, labels: torch.Tensor,
                   centers: torch.Tensor, row_group=None) -> torch.Tensor:
    """Scatter-form center update: mean (L, a, b, y, x) of each cluster's
    pixels; clusters with no pixel keep their center. Under a
    ``row_group`` the moments of every rank's pixels are summed."""
    B, HW, _ = pix.shape
    K = centers.shape[1]
    ones = torch.ones(B, HW, 1, dtype=pix.dtype, device=pix.device)
    idx = (labels.long() + K * torch.arange(B, device=pix.device)[:, None]).reshape(-1)
    moments = index_sum(torch.cat([pix, ones], dim=-1).reshape(-1, 6), idx, B * K)
    moments = all_reduce_(moments.reshape(B, K, 6), row_group)
    count = moments[..., 5:6]
    new = moments[..., :5] / torch.clamp(count, min=1.0)
    return torch.where(count > 0, new, centers)


# ---------------------------------------------------------------------------
# The windowed backend (JAX's "xla")
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _float32_matmuls():
    """TF32 off for the matrix products inside, the caller's setting
    restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class WindowedSLIC:
    """The blocked windowed assignment and its one-hot center update on
    (B, H, W) images, JAX ``ops/slic.py:246-372`` with a batch axis.

    The image is zero-padded to whole step × step blocks ``(B, NB, P, ·)``.
    A block's (2·radius+1)² candidate centers depend only on its seed cell
    ``min(block row, gh − 1)`` (and column), so they are one static table
    per block, in ascending id order (the lowest id wins a tie); slots off
    the seed grid are masked and carry id −1. Every label a pixel can hold
    lies in its own block's window (the JAX docstring's proof), so the
    center moments decompose into one-hot products per block — a batched
    float32 matrix product, TF32 off (:func:`_float32_matmuls`) since
    the moments reach ~1e4 — placed on the seed grid by static shifts, with
    the trailing bands of an image that is no multiple of step folded into
    the last seed row and column."""

    def __init__(self, pix: torch.Tensor, H: int, W: int, step: int, gh: int, gw: int,
                 radius: int):
        if radius < 2:
            raise ValueError("window_radius must be >= 2 (the one-hot update's "
                             "own-window membership proof needs the pixel's seed "
                             "cell plus one ring)")
        B = pix.shape[0]
        dev = pix.device
        self.step, self.gh, self.gw, self.radius = step, gh, gw, radius
        self.nbh, self.nbw = -(-H // step), -(-W // step)
        self.H, self.W = H, W
        NB, P = self.nbh * self.nbw, step * step
        span = range(-radius, radius + 1)
        self.offsets = [(dy, dx) for dy in span for dx in span]
        dys = np.array([o[0] for o in self.offsets])
        dxs = np.array([o[1] for o in self.offsets])
        iy = np.minimum(np.arange(self.nbh), gh - 1)[:, None] + dys[None, :]   # (nbh, NW)
        jx = np.minimum(np.arange(self.nbw), gw - 1)[:, None] + dxs[None, :]   # (nbw, NW)
        in_grid = ((iy[:, None, :] >= 0) & (iy[:, None, :] < gh)
                   & (jx[None, :, :] >= 0) & (jx[None, :, :] < gw))
        iyc, jxc = np.clip(iy, 0, gh - 1), np.clip(jx, 0, gw - 1)
        cand = np.where(in_grid, iyc[:, None, :] * gw + jxc[None, :, :], -1)
        gpad = (iyc + radius)[:, None, :] * (gw + 2 * radius) + (jxc + radius)[None, :, :]
        NW = len(self.offsets)
        self.cand_id = torch.from_numpy(cand.reshape(NB, NW)).to(dev)
        self.gpad_idx = torch.from_numpy(gpad.reshape(NB, NW)).to(dev)
        self.in_grid = torch.from_numpy(in_grid.reshape(NB, NW)).to(dev)
        self.K = gh * gw
        valid = torch.ones(B, H, W, 1, dtype=pix.dtype, device=dev)
        # 6th channel: 1 on image pixels, 0 on the padding, so pad pixels
        # weigh nothing in the moments (their labels are cropped).
        self.pix6 = self.to_blocks(torch.cat([pix.reshape(B, H, W, 5), valid], -1))
        self.ch = [self.pix6[..., c] for c in range(5)]                     # (B, NB, P) each

    def to_blocks(self, a: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) zero-padded → (B, NB, P, C)."""
        B, _, _, C = a.shape
        s = self.step
        a = torch.nn.functional.pad(a, (0, 0, 0, self.nbw * s - self.W, 0, self.nbh * s - self.H))
        return (a.reshape(B, self.nbh, s, self.nbw, s, C).permute(0, 1, 3, 2, 4, 5)
                .reshape(B, self.nbh * self.nbw, s * s, C))

    def unblock(self, lab: torch.Tensor) -> torch.Tensor:
        """(B, NB, P) → (B, H, W)."""
        B, s = lab.shape[0], self.step
        return (lab.reshape(B, self.nbh, self.nbw, s, s).permute(0, 1, 3, 2, 4)
                .reshape(B, self.nbh * s, self.nbw * s)[:, :self.H, :self.W])

    def assign(self, centers: torch.Tensor, prev: torch.Tensor, ratio: float) -> torch.Tensor:
        """Each pixel's nearest window candidate under the ±step box, the
        JAX term order; uncovered pixels keep ``prev``. (B, NB, P) int64."""
        B, r = centers.shape[0], self.radius
        g = centers.reshape(B, self.gh, self.gw, 5)
        gpad = torch.nn.functional.pad(g, (0, 0, r, r, r, r)).reshape(B, -1, 5)
        cc = gpad[:, self.gpad_idx]                                  # (B, NB, NW, 5)
        cy, cx = cc[..., 3][:, :, None, :], cc[..., 4][:, :, None, :]
        py, px = self.ch[3][..., None], self.ch[4][..., None]
        dist = ratio * ((py - cy) ** 2 + (px - cx) ** 2)
        for c in range(3):
            dist = dist + (self.ch[c][..., None] - cc[..., c][:, :, None, :]) ** 2
        ok = (self.in_grid[None, :, None, :]
              & (torch.abs(py - torch.floor(cy)) <= self.step)
              & (torch.abs(px - torch.floor(cx)) <= self.step))
        dist = torch.where(ok, dist, torch.inf)
        best = dist.amin(dim=-1)
        lab = torch.where(dist == best[..., None], self.cand_id[None, :, None, :],
                          self.K).amin(dim=-1)
        return torch.where(best < torch.inf, lab, prev)

    def update(self, labels: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        """The one-hot moment update (no scatter)."""
        B, gh, gw, r = labels.shape[0], self.gh, self.gw, self.radius
        onehot = (labels[..., None] == self.cand_id[None, :, None, :]).to(self.pix6.dtype)
        with _float32_matmuls():
            mom = torch.einsum("xbpo,xbpc->xboc", onehot, self.pix6)    # (B, NB, NW, 6)
        mb = mom.reshape(B, self.nbh, self.nbw, len(self.offsets), 6)
        if self.nbh > gh:    # clamped trailing bands fold into the last seed row
            mb = torch.cat([mb[:, :gh - 1], (mb[:, gh - 1] + mb[:, gh:].sum(1))[:, None]], 1)
        if self.nbw > gw:
            mb = torch.cat([mb[:, :, :gw - 1], (mb[:, :, gw - 1] + mb[:, :, gw:].sum(2))[:, :, None]], 2)
        grid = torch.zeros(B, gh + 2 * r, gw + 2 * r, 6, dtype=mb.dtype, device=mb.device)
        for o, (dy, dx) in enumerate(self.offsets):   # offset (dy, dx) feeds center (i+dy, j+dx)
            grid[:, r + dy:r + dy + gh, r + dx:r + dx + gw] += mb[:, :, :, o]
        grid = grid[:, r:r + gh, r:r + gw].reshape(B, gh * gw, 6)
        count = grid[..., 5:6]
        new = grid[..., :5] / torch.clamp(count, min=1.0)
        return torch.where(count > 0, new, centers)


# ---------------------------------------------------------------------------
# SLIC
# ---------------------------------------------------------------------------

def _raise_on_window_drift(maxd: torch.Tensor, radius: int) -> None:
    """``debug_window_check``: one host read of the drift ratios."""
    worst = float(maxd.max()) if maxd.numel() else 0.0
    if worst >= 1.0:
        n = 2 * int(radius) + 1
        raise RuntimeError(
            f"SLIC center drift {worst:.2f}x the safe window bound: the "
            f"{n}x{n} candidate window no longer provably covers the all-K "
            "sweep — rerun with a larger window_radius or backend='exact' "
            "(both exact at any drift) or inspect the input.")


def slic(image: torch.Tensor, n_segments: int = 500, compactness: float = COMPACTNESS,
         sigma: float = SIGMA, num_iters: int = 10, convert_lab: bool = True,
         backend: str = "window", enforce_connectivity: bool = True,
         max_labels: Optional[int] = None, return_drift: bool = False,
         debug_window_check: bool = False, window_radius: int = 2,
         row_group=None):
    """Segment (H, W, 3) or (B, H, W, 3) float RGB images in [0, 1].

    Returns (H, W) or (B, H, W) int64 labels: sequential raster-ordered
    component ids when ``enforce_connectivity`` (the per-pixel
    :func:`ops.connectivity.enforce_label_connectivity`, clamped to
    ``max_labels``), else raw cluster ids in [0, gh·gw). With
    ``return_drift`` also the drift ratio, () or (B,) float32:
    ``max_k |c_k − seed_k|_∞ / window_drift_bound(step, window_radius)``
    over every center state an assignment saw; below 1 the windowed
    assignment provably equals the all-K sweep.

    ``backend`` is ``"window"`` (the JAX package's ``"xla"``) or
    ``"exact"`` (its ``"pallas"``); the port does not reuse the JAX names,
    which name TPU toolchains (module docstring). ``"window"`` needs
    ``window_radius >= 2`` and takes no ``row_group`` (the JAX ``slic`` has
    no row split; the port's spatial pipeline runs ``"exact"``). On
    ``"exact"``, kernel B1 on the card and its plain version on the CPU,
    ``window_radius`` only sets the drift bound. ``debug_window_check``
    raises ``RuntimeError`` after the loop when the windowed path's drift
    ratio reached 1 (one host read); a no-op on ``"exact"``. Under a
    ``row_group`` (spatial sharding) ``image`` is this rank's block of rows
    and so are the labels (module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be 'window' (the JAX package's 'xla') or "
                         f"'exact' (its 'pallas'), got {backend!r}")
    windowed = backend == "window"
    if windowed and row_group is not None:
        raise ValueError("slic(backend='window') takes no row_group: spatial sharding "
                         "runs backend='exact'")
    single = image.dim() == 3
    images = image[None] if single else image
    B, H, W, _ = images.shape
    pix, centers, step, ratio = slic_features(images, n_segments, row_group,
                                              compactness=compactness, sigma=sigma,
                                              convert_lab=convert_lab)
    seed_pos = centers[..., 3:5]
    # step == 1 makes the bound 0 at small radii: report raw drift against a
    # floor of 1 px, as the JAX package does.
    inv_bound = 1.0 / float(max(1, window_drift_bound(step, window_radius)))
    if windowed:
        gh, gw = grid_shape(n_segments, H, W)
        win = WindowedSLIC(pix, H, W, step, gh, gw, window_radius)
        labels = torch.zeros(win.ch[0].shape, dtype=torch.long, device=images.device)

        def assign(c, prev):
            return win.assign(c, prev, ratio)

        update = win.update
    else:
        labels = torch.zeros(B, H * W, dtype=torch.int32, device=images.device)

        def assign(c, prev):
            return slic_assign(pix, c, prev, ratio, step, width=W)

        def update(lab, c):
            return update_centers(pix, lab, c, row_group)

    maxd = torch.zeros(B, dtype=torch.float32, device=images.device)
    if num_iters > 0:
        for _ in range(num_iters - 1):
            labels = assign(centers, labels)
            centers = update(labels, centers)
            drift = torch.abs(centers[..., 3:5] - seed_pos).amax(dim=(1, 2))
            maxd = torch.maximum(maxd, drift * inv_bound)
        labels = assign(centers, labels)
    labels = win.unblock(labels) if windowed else labels.reshape(B, H, W).long()
    if debug_window_check and windowed:
        _raise_on_window_drift(maxd, window_radius)
    if enforce_connectivity:
        labels = enforce_label_connectivity(labels, n_segments, max_labels=max_labels,
                                            row_group=row_group)
    if single:
        labels, maxd = labels[0], maxd[0]
    return (labels, maxd) if return_drift else labels
