"""Plain PyTorch reference of the region-graph build: SLIC, connectivity,
Canny, region features and the region adjacency graph.

A frozen copy of the plain single-device paths of
``camouflage_multimodal_tpu_torch/ops/`` (``image.py``, ``morphology.py``,
``slic.py``'s plain assignment and scatter update, ``connectivity.py``'s
per-pixel path, ``canny.py``, ``regions.py``, ``rag.py``) as they stood when
the benchmark was written, with the sharding removed. It imports nothing of
the program: the program may change, this stays the yardstick. On a CUDA
tensor it runs the same PyTorch operations the plain paths run there (the
segment sums through a stable sort and ``segment_reduce``), so a build on
the card is held to the labels, features and adjacency these give.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

GRAY_WEIGHTS = (0.2989, 0.5870, 0.1140)
_XYZ_FROM_RGB = ((0.412453, 0.357580, 0.180423),
                 (0.212671, 0.715160, 0.072169),
                 (0.019334, 0.119193, 0.950227))
_D65_WHITE = (0.95047, 1.0, 1.08883)
COMPACTNESS = 10.0
SIGMA = 1.0
_CHUNK = 4096               # pixels per distance block of the plain assignment
_MAX_MERGE_ROUNDS = 64
_SMALL_BIT = 1 << 24


# ---------------------------------------------------------------------------
# Image ops
# ---------------------------------------------------------------------------

def _dot3(img, w):
    return img[..., 0] * w[0] + img[..., 1] * w[1] + img[..., 2] * w[2]


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(GRAY_WEIGHTS, dtype=img.dtype, device=img.device)
    return _dot3(img, w)


def _blur_radius(sigma: float, truncate: float = 4.0) -> int:
    return int(truncate * sigma + 0.5) if sigma > 0 else 0


def _gaussian_kernel1d(sigma: float, device, truncate: float = 4.0) -> torch.Tensor:
    radius = _blur_radius(sigma, truncate)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _pad_axis(x: torch.Tensor, pad: int, dim: int, mode: str) -> torch.Tensor:
    """scipy border modes: "reflect" (b a | a b c), "constant" (zeros)."""
    n = x.shape[dim]
    if mode == "constant":
        shape = list(x.shape)
        shape[dim] = pad
        head = tail = x.new_zeros(shape)
    elif mode == "reflect":
        head = x.narrow(dim, 0, pad).flip(dim)
        tail = x.narrow(dim, n - pad, pad).flip(dim)
    else:
        raise ValueError(mode)
    return torch.cat([head, x, tail], dim=dim)


def _correlate_valid(x: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    taps = k.shape[0]
    n = x.shape[dim] - taps + 1
    out = x.narrow(dim, 0, n) * k[0]
    for i in range(1, taps):
        out = out + x.narrow(dim, i, n) * k[i]
    return out


def gaussian_blur(img: torch.Tensor, sigma: float, mode: str = "reflect",
                  channels_last: bool = False) -> torch.Tensor:
    """Separable blur, ``scipy.ndimage.gaussian_filter``; rows, then columns."""
    if sigma <= 0:
        return img
    if channels_last:
        return gaussian_blur(img.movedim(-1, -3), sigma, mode).movedim(-3, -1)
    k = _gaussian_kernel1d(sigma, img.device).to(img.dtype)
    pad = (k.shape[0] - 1) // 2
    x = _pad_axis(_pad_axis(img, pad, -2, mode), pad, -1, mode)
    x = _correlate_valid(x, k, dim=-1)
    return _correlate_valid(x, k, dim=-2)


def _sobel(img: torch.Tensor, dim: int) -> torch.Tensor:
    other = -1 if dim == -2 else -2
    deriv = torch.tensor([-1.0, 0.0, 1.0], dtype=img.dtype, device=img.device)
    smooth = torch.tensor([1.0, 2.0, 1.0], dtype=img.dtype, device=img.device)
    x = _correlate_valid(_pad_axis(img, 1, dim, "reflect"), deriv, dim)
    return _correlate_valid(_pad_axis(x, 1, other, "reflect"), smooth, other)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] → CIELAB (D65), ``skimage.color.rgb2lab``."""
    srgb = torch.clamp(rgb, 0.0, 1.0)
    linear = torch.where(srgb > 0.04045, ((srgb + 0.055) / 1.055) ** 2.4, srgb / 12.92)
    m = torch.tensor(_XYZ_FROM_RGB, dtype=rgb.dtype, device=rgb.device)
    xyz = torch.stack([_dot3(linear, m[i]) for i in range(3)], dim=-1)
    white = torch.tensor(_D65_WHITE, dtype=rgb.dtype, device=rgb.device)
    t = xyz / white
    delta = 6.0 / 29.0
    f = torch.where(t > delta ** 3, torch.pow(t, 1.0 / 3.0), t / (3 * delta ** 2) + 4.0 / 29.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y − dy, x − dx], zero outside the image."""
    H, W = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        x[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)]
    return out


def _dilate8(mask: torch.Tensor) -> torch.Tensor:
    acc = mask
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                acc = acc | _shift(mask, dy, dx)
    return acc


# ---------------------------------------------------------------------------
# SLIC (all-K assignment under the ±step box, scatter update)
# ---------------------------------------------------------------------------

def slic_step(n_segments: int, height: int, width: int) -> int:
    return max(1, int(round(math.sqrt(height * width / n_segments))))


def grid_shape(n_segments: int, height: int, width: int) -> Tuple[int, int]:
    step = slic_step(n_segments, height, width)
    return len(range(step // 2, height, step)), len(range(step // 2, width, step))


def padded_nodes(n_segments: int, image_size: int, multiple: int = 128) -> int:
    gh, gw = grid_shape(n_segments, image_size, image_size)
    return -(-(gh * gw) // multiple) * multiple


def slic_assign(pix, centers, prev, ratio: float, step: int) -> torch.Tensor:
    """Each pixel's nearest center under the ±step box (lowest id wins a
    tie; uncovered pixels keep ``prev``), in the assignment's rounding."""
    B, HW, _ = pix.shape
    K = centers.shape[1]
    r = torch.tensor(ratio, dtype=torch.float32, device=pix.device)
    every = centers[:, None, :, :]
    floors = torch.floor(every[..., 3:5])
    ids = torch.arange(K, dtype=torch.int32, device=pix.device)
    big = torch.tensor(K, dtype=torch.int32, device=pix.device)
    out = torch.empty_like(prev)
    for s in range(0, HW, _CHUNK):
        p = pix[:, s:s + _CHUNK, None, :]
        py, px = p[..., 3], p[..., 4]
        fy, fx = floors[..., 0], floors[..., 1]
        ey = py - every[..., 3]
        ex = px - every[..., 4]
        d = r * (ey * ey + ex * ex)
        for ch in range(3):
            e = p[..., ch] - every[..., ch]
            d = d + e * e
        ok = (torch.abs(py - fy) <= step) & (torch.abs(px - fx) <= step)
        d = torch.where(ok, d, torch.inf)
        best = d.amin(dim=-1, keepdim=True)
        lab = torch.where(d == best, ids, big).amin(dim=-1)
        out[:, s:s + _CHUNK] = torch.where(best[..., 0] < torch.inf, lab, prev[:, s:s + _CHUNK])
    return out


def index_sum(vals: torch.Tensor, idx: torch.Tensor, nbins: int) -> torch.Tensor:
    """Rows summed into bins in row order: ``index_add_`` on the CPU, a
    stable sort and ``segment_reduce`` elsewhere (no float atomics)."""
    if vals.device.type == "cpu":
        return torch.zeros(nbins, vals.shape[1], dtype=vals.dtype).index_add_(0, idx, vals)
    order = torch.argsort(idx, stable=True)
    bounds = torch.searchsorted(idx[order], torch.arange(nbins + 1, device=idx.device))
    return torch.segment_reduce(vals[order], "sum", offsets=bounds, axis=0, unsafe=True)


def _update_centers(pix, labels, centers):
    B, HW, _ = pix.shape
    K = centers.shape[1]
    ones = torch.ones(B, HW, 1, dtype=pix.dtype, device=pix.device)
    idx = (labels.long() + K * torch.arange(B, device=pix.device)[:, None]).reshape(-1)
    moments = index_sum(torch.cat([pix, ones], dim=-1).reshape(-1, 6), idx, B * K).reshape(B, K, 6)
    count = moments[..., 5:6]
    new = moments[..., :5] / torch.clamp(count, min=1.0)
    return torch.where(count > 0, new, centers)


def slic_raw(images: torch.Tensor, n_segments: int, num_iters: int = 10) -> torch.Tensor:
    """(B, H, W, 3) float RGB in [0, 1] → (B, H, W) int64 raw cluster ids."""
    B, H, W, _ = images.shape
    step = slic_step(n_segments, H, W)
    sy = torch.arange(step // 2, H, step, device=images.device)
    sx = torch.arange(step // 2, W, step, device=images.device)
    gh, gw = len(sy), len(sx)
    feat = gaussian_blur(rgb_to_lab(images), SIGMA, mode="reflect", channels_last=True)
    yy = torch.arange(H, dtype=torch.float32, device=images.device)
    xx = torch.arange(W, dtype=torch.float32, device=images.device)
    pos = torch.stack(torch.meshgrid(yy, xx, indexing="ij"), dim=-1)
    pix = torch.cat([feat, pos.expand(B, H, W, 2)], dim=-1).reshape(B, H * W, 5).contiguous()
    init_color = feat[:, sy][:, :, sx]
    seed = torch.stack(torch.meshgrid(sy.float(), sx.float(), indexing="ij"), dim=-1)
    centers = torch.cat([init_color, seed.expand(B, gh, gw, 2)], dim=-1).reshape(B, gh * gw, 5)
    ratio = (COMPACTNESS / step) ** 2
    labels = torch.zeros(B, H * W, dtype=torch.int32, device=images.device)
    for _ in range(num_iters - 1):
        labels = slic_assign(pix, centers, labels, ratio, step)
        centers = _update_centers(pix, labels, centers)
    labels = slic_assign(pix, centers, labels, ratio, step)
    return labels.reshape(B, H, W).long()


# ---------------------------------------------------------------------------
# Connectivity (skimage's enforce_connectivity contract, per-pixel form)
# ---------------------------------------------------------------------------

def _neighbor_shifts(x, fill):
    row = torch.full_like(x[:, :1], fill)
    col = torch.full_like(x[:, :, :1], fill)
    return (torch.cat([row, x[:, :-1]], dim=1), torch.cat([x[:, 1:], row], dim=1),
            torch.cat([col, x[:, :, :-1]], dim=2), torch.cat([x[:, :, 1:], col], dim=2))


def _run_ids(labels, dim):
    reset = labels != torch.roll(labels, 1, dims=dim)
    reset.narrow(dim, 0, 1).fill_(True)
    return torch.cumsum(reset.long(), dim=dim)


def _seg_min_scan(comp, run_ids, dim, offset):
    off = run_ids * offset
    fwd = torch.cummin(comp - off, dim=dim).values + off
    bwd = torch.cummin((comp + off).flip(dim), dim=dim).values.flip(dim) - off
    return torch.minimum(fwd, bwd)


def _components(labels):
    """Per-pixel root (min raster index) of each 4-connected component."""
    B, H, W = labels.shape
    HW = H * W
    comp = torch.arange(HW, device=labels.device).reshape(1, H, W).expand(B, H, W)
    s_cols, s_rows = _run_ids(labels, 2), _run_ids(labels, 1)
    while True:
        prev = comp
        comp = _seg_min_scan(comp, s_cols, 2, HW)
        comp = _seg_min_scan(comp, s_rows, 1, HW)
        if torch.equal(comp, prev):
            return comp


def _ring_best(comp, small, nbr_idx, big, none):
    best = torch.full_like(comp, none)
    for cn, sn, ni in zip(_neighbor_shifts(comp, -1), _neighbor_shifts(small, True), nbr_idx):
        ok = (cn >= 0) & (cn != comp)
        cand = torch.where(ok & ~sn, ni, torch.where(ok & sn & (cn < comp), ni + big, none))
        best = torch.minimum(best, cand)
    return torch.where(small, best, none)


def _resolve(target, flat, ident, cur, size, big, none, n_jumps):
    ring = torch.where(target < big, target, target - big)
    safe = torch.clamp(ring, 0, big - 1)
    absorb = torch.where(target < none, torch.gather(flat, 1, safe), ident)
    for _ in range(n_jumps):
        absorb = torch.gather(absorb, 1, absorb)
    return torch.gather(absorb, 1, cur), torch.zeros_like(size).scatter_add_(1, absorb, size)


def enforce_connectivity(labels: torch.Tensor, n_segments: int, max_labels: int,
                         min_size_factor: float = 0.5) -> torch.Tensor:
    """Split clusters into 4-connected components, merge those under
    ``min_size`` into the component of their raster-first large ring pixel
    (a smaller-id small neighbour otherwise) to a fixed point, relabel in
    raster order, clamped to ``max_labels − 1``."""
    B, H, W = labels.shape
    HW = H * W
    C = min(16 * n_segments, HW)
    dev = labels.device
    min_size = round(min_size_factor * H * W / n_segments)
    big, none = HW, 2 * HW
    idx = torch.arange(HW, device=dev)
    flatroot = _components(labels).reshape(B, HW)
    is_root = flatroot == idx
    ranks = torch.cumsum(is_root.long(), dim=1) - 1
    ones = torch.ones(B, HW, dtype=torch.long, device=dev)
    size_t = torch.zeros(B, HW, dtype=torch.long, device=dev).scatter_add_(1, flatroot, ones)
    small_t = (size_t > 0) & (size_t < min_size)
    packed_t = torch.clamp(ranks, max=C - 1) + torch.where(small_t, _SMALL_BIT, 0)
    g0 = torch.gather(packed_t, 1, flatroot)
    flat0 = g0 & (_SMALL_BIT - 1)
    small0 = (g0 >= _SMALL_BIT).reshape(B, H, W)
    size0 = torch.zeros(B, C, dtype=torch.long, device=dev).scatter_add_(1, flat0, ones)
    ident = torch.arange(C, device=dev).expand(B, C)
    nbr_idx = _neighbor_shifts(idx.reshape(1, H, W), big)
    n_jumps = max(int(C - 1).bit_length(), 1)

    def absorb_pass(comp, small, cur, size):
        best = _ring_best(comp, small, nbr_idx, big, none)
        flat = comp.reshape(B, HW)
        target = torch.full((B, C), none, dtype=torch.long, device=dev)
        target.scatter_reduce_(1, flat, best.reshape(B, HW), reduce="amin")
        return _resolve(target, flat, ident, cur, size, big, none, n_jumps)

    cur, size = absorb_pass(flat0.reshape(B, H, W), small0, ident, size0)
    for _ in range(_MAX_MERGE_ROUNDS - 1):
        small_c = (size > 0) & (size < min_size)
        if not bool(small_c.any()):
            break
        packed_c = cur + torch.where(torch.gather(small_c, 1, cur), _SMALL_BIT, 0)
        g = torch.gather(packed_c, 1, flat0).reshape(B, H, W)
        cur, size = absorb_pass(g & (_SMALL_BIT - 1), g >= _SMALL_BIT, cur, size)
    rank = torch.clamp(torch.cumsum((size > 0).long(), dim=1) - 1, max=max_labels - 1)
    return torch.gather(torch.gather(rank, 1, cur), 1, flat0).reshape(B, H, W)


# ---------------------------------------------------------------------------
# Canny (skimage.feature.canny)
# ---------------------------------------------------------------------------

def _hypot(a, b):
    a, b = torch.abs(a), torch.abs(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    return torch.where(hi == 0, hi, hi * torch.sqrt(1 + torch.square(lo / safe)))


def _nonmax_suppression(gy, gx, mag, mask):
    ay, ax = torch.abs(gy), torch.abs(gx)
    sy = torch.where(gy >= 0, 1, -1)
    sx = torch.where(gx >= 0, 1, -1)

    def nb(dy_sign, dx_sign):
        out = None
        for cy in ((0,) if dy_sign == 0 else (1, -1)):
            for cx in ((0,) if dx_sign == 0 else (1, -1)):
                shifted = _shift(mag, -cy, -cx)
                cond = torch.ones_like(mag, dtype=torch.bool)
                if dy_sign != 0:
                    cond = cond & (sy * dy_sign == cy)
                if dx_sign != 0:
                    cond = cond & (sx * dx_sign == cx)
                term = shifted * cond
                out = term if out is None else out + term
        return out

    w_a = torch.where(ax > 0, ay / torch.clamp(ax, min=1e-20), 0.0)
    keep_a = ((mag >= (1 - w_a) * nb(0, +1) + w_a * nb(+1, +1))
              & (mag >= (1 - w_a) * nb(0, -1) + w_a * nb(-1, -1)))
    w_b = torch.where(ay > 0, ax / torch.clamp(ay, min=1e-20), 0.0)
    keep_b = ((mag >= (1 - w_b) * nb(+1, 0) + w_b * nb(+1, +1))
              & (mag >= (1 - w_b) * nb(-1, 0) + w_b * nb(-1, -1)))
    return torch.where(ax >= ay, keep_a, keep_b) & mask & (mag > 0)


def canny(gray: torch.Tensor, sigma: float = 2.0, low: float = 0.1,
          high: float = 0.2) -> torch.Tensor:
    H, W = gray.shape[-2:]
    smoothed = gaussian_blur(gray, sigma, mode="constant")
    bleed = gaussian_blur(torch.ones(H, W, dtype=gray.dtype, device=gray.device), sigma,
                          mode="constant")
    smoothed = smoothed / (bleed + 1e-12)
    eroded = torch.zeros(H, W, dtype=torch.bool, device=gray.device)
    eroded[1:-1, 1:-1] = True
    gy, gx = _sobel(smoothed, -2), _sobel(smoothed, -1)
    mag = _hypot(gy, gx)
    local_max = _nonmax_suppression(gy, gx, mag, eroded)
    low_mask, cur = local_max & (mag >= low), local_max & (mag >= high)
    while True:                       # hysteresis: 8-connected growth in the low mask
        nxt = _dilate8(cur) & low_mask
        if torch.equal(nxt, cur):
            return cur
        cur = nxt


# ---------------------------------------------------------------------------
# Region features and adjacency
# ---------------------------------------------------------------------------

_DIAMOND_1 = [(-1, 0), (1, 0), (0, -1), (0, 1)]
_DIAMOND_2 = _DIAMOND_1 + [(-2, 0), (2, 0), (0, -2), (0, 2), (-1, -1), (-1, 1), (1, -1), (1, 1)]


def _distinct_foreign_neighbors(seg, offsets):
    B, H, W = seg.shape
    labs, keep = [], []
    for dy, dx in offsets:
        lab = torch.roll(seg, shifts=(-dy, -dx), dims=(1, 2))
        ok = torch.ones(H, W, dtype=torch.bool, device=seg.device)
        if dy > 0:
            ok[H - dy:, :] = False
        elif dy < 0:
            ok[:-dy, :] = False
        if dx > 0:
            ok[:, W - dx:] = False
        elif dx < 0:
            ok[:, :-dx] = False
        labs.append(lab)
        keep.append(ok & (lab != seg))
    for i in range(1, len(offsets)):
        dup = torch.zeros_like(keep[i])
        for j in range(i):
            dup = dup | (keep[j] & (labs[j] == labs[i]))
        keep[i] = keep[i] & ~dup
    return torch.stack(keep, dim=-1)


def _segment_sum(vals, seg, K):
    B, N, C = vals.shape
    seg = torch.where((seg >= 0) & (seg < K), seg, K)
    idx = (seg + (K + 1) * torch.arange(B, device=seg.device)[:, None]).reshape(-1)
    return index_sum(vals.reshape(-1, C), idx, B * (K + 1)).reshape(B, K + 1, C)[:, :K]


def region_features(image, seg, edges, K: int) -> Dict[str, torch.Tensor]:
    """15 features per segment (mean / std RGB, texture mean / std, centre,
    size, compactness, boundary contrast, edge density, local variance)."""
    B, H, W, _ = image.shape
    dev = image.device
    img, seg = image.float(), seg.long()
    gray = rgb_to_gray(img)
    keep2 = _distinct_foreign_neighbors(seg, _DIAMOND_2).float()
    nb_acc = torch.zeros(seg.shape + (5,), dtype=torch.float32, device=dev)
    for i, (dy, dx) in enumerate(_DIAMOND_2):
        w = keep2[..., i:i + 1]
        is_r1 = 1.0 if i < len(_DIAMOND_1) else 0.0
        pay = torch.cat([img * w, w, is_r1 * w], dim=-1)
        nb_acc = nb_acc + torch.roll(pay, shifts=(dy, dx), dims=(1, 2))
    yy = torch.arange(H, dtype=torch.float32, device=dev)
    xx = torch.arange(W, dtype=torch.float32, device=dev)
    pos = torch.stack(torch.meshgrid(yy, xx, indexing="ij"), dim=-1).expand(B, H, W, 2)
    vals = torch.cat([img, img ** 2, gray[..., None], (gray ** 2)[..., None], pos,
                      edges.float()[..., None], torch.ones(B, H, W, 1, device=dev), nb_acc],
                     dim=-1).reshape(B, H * W, 17)
    m = _segment_sum(vals, seg.reshape(B, H * W), K)
    count = m[..., 11]
    node_mask = count > 0
    safe = torch.clamp(count, min=1.0)[..., None]
    mean_rgb = m[..., 0:3] / safe
    std_rgb = torch.sqrt(torch.clamp(m[..., 3:6] / safe - mean_rgb ** 2, min=0.0))
    mean_gray = m[..., 6:7] / safe
    var_gray = torch.clamp(m[..., 7:8] / safe - mean_gray ** 2, min=0.0)
    std_gray = torch.sqrt(var_gray)
    center_y = (m[..., 8:9] / safe) / H
    center_x = (m[..., 9:10] / safe) / W
    region_size = count[..., None] / (H * W)
    edge_density = m[..., 10:11] / safe
    nb = m[..., 12:17]
    compactness = nb[..., 4:5] ** 2 / (4.0 * math.pi * count[..., None] + 1e-10)
    nb_mean = nb[..., :3] / torch.clamp(nb[..., 3], min=1.0)[..., None]
    contrast = torch.where((nb[..., 3] > 0)[..., None],
                           torch.sqrt(torch.sum((mean_rgb - nb_mean) ** 2, dim=-1, keepdim=True)),
                           0.0)
    features = torch.cat([mean_rgb, std_rgb, mean_gray, std_gray, center_x, center_y,
                          region_size, compactness, contrast, edge_density, var_gray], dim=-1)
    features = torch.nan_to_num(torch.where(node_mask[..., None], features, 0.0), nan=0.0)
    return {"features": features, "node_mask": node_mask}


def region_adjacency(segments: torch.Tensor, K: int) -> torch.Tensor:
    """(B, K, K) symmetric 8-connected label adjacency, no self loops."""
    B = segments.shape[0]
    K1 = K + 1
    s = segments.long()
    s = torch.where((s >= 0) & (s < K), s, K)
    right = torch.cat([s[:, :, 1:], s[:, :, -1:]], dim=2)
    down = torch.cat([s[:, 1:], s[:, -1:]], dim=1)
    dr = torch.cat([right[:, 1:], right[:, -1:]], dim=1)
    left = torch.cat([s[:, :, :1], s[:, :, :-1]], dim=2)
    dl = torch.cat([left[:, 1:], left[:, -1:]], dim=1)
    base = (torch.arange(B, device=s.device) * K1 * K1).reshape(B, 1, 1)
    adj = torch.zeros(B * K1 * K1, dtype=torch.bool, device=s.device)
    for n in (right, down, dr, dl):
        n = torch.where((n >= 0) & (n < K), n, K)
        adj[(base + s * K1 + n).reshape(-1)] = True
    adj = adj.reshape(B, K1, K1)[:, :K, :K]
    adj = adj | adj.transpose(1, 2)
    return adj & ~torch.eye(K, dtype=torch.bool, device=s.device)


def rag_edge_weights(features: torch.Tensor, adjacency: torch.Tensor) -> torch.Tensor:
    color, tex, ctr = features[..., 0:3], features[..., 6], features[..., 12]
    dcolor = torch.sqrt(torch.sum((color[..., :, None, :] - color[..., None, :, :]) ** 2, dim=-1))
    dtex = torch.abs(tex[..., :, None] - tex[..., None, :])
    dctr = torch.abs(ctr[..., :, None] - ctr[..., None, :])
    w = torch.exp(-dcolor / 0.15) * torch.exp(-dtex / 0.08) * torch.exp(-dctr / 0.1)
    return torch.where(adjacency, w, 0.0)


def build_graphs(images_u8: torch.Tensor, n_segments: int, max_nodes: int,
                 slic_iters: int = 10) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) uint8 → segments, features, adjacency, weights, node mask."""
    images = images_u8.float() / 255.0
    seg = enforce_connectivity(slic_raw(images, n_segments, slic_iters), n_segments, max_nodes)
    edges = canny(rgb_to_gray(images))
    reg = region_features(images, seg, edges, max_nodes)
    adj = region_adjacency(seg, max_nodes)
    return {"segments": seg, "features": reg["features"], "node_mask": reg["node_mask"],
            "adjacency": adj, "edge_weights": rag_edge_weights(reg["features"], adj)}
