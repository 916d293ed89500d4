"""Per-superpixel features as one batched segment reduction.

Port of ``camouflage_multimodal_tpu/ops/regions.py`` (``region_features``,
``region_label_means``).
Feature layout (index → meaning):

  0-2 mean RGB | 3-5 std RGB | 6 texture_mean | 7 texture_std
  8 center_x | 9 center_y | 10 region_size | 11 compactness
  12 contrast | 13 edge_density | 14 local_variance

Perimeter (|dilate₁(R) \\ R|, 4-connected cross) and boundary contrast
(mean colour of dilate₂(R) \\ R) come from the JAX package's reindexing
trick: every pixel contributes once to each DISTINCT foreign label in its
radius-2 diamond, and the contributions are rolled back onto the receiving
pixel so all statistics share one index array — seventeen channels summed
into K bins by a single :func:`index_sum` (labels ≥ K are dropped), whose
order is fixed on the card too.

Under spatial sharding (``row_group``: each rank holds a block of rows) the
per-pixel channels of a rank's rows are computed on its block extended by 4
rows of each neighbour's segment map and image (the diamond's 2 rows, and 2
more for the foreign labels of the pixels that give to a receiving pixel),
so they come out as without sharding; each rank sums its rows into the K
bins and the bins are all-reduced (SUM: the features use moments and counts
only), so every rank holds the same features.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from camouflage_multimodal_tpu_torch.ops.image import rgb_to_gray
from camouflage_multimodal_tpu_torch.parallel.sharding import all_reduce_, halo_rows, spatial_rows

_DIAMOND_1 = [(-1, 0), (1, 0), (0, -1), (0, 1)]
_DIAMOND_2 = _DIAMOND_1 + [(-2, 0), (2, 0), (0, -2), (0, 2),
                           (-1, -1), (-1, 1), (1, -1), (1, 1)]


def _distinct_foreign_neighbors(seg: torch.Tensor, offsets) -> torch.Tensor:
    """(B, H, W, n_off) weights: 1 where offset i's label is in the image,
    differs from the pixel's own, and first occurs at slot i."""
    B, H, W = seg.shape
    labs, keep = [], []
    for dy, dx in offsets:
        lab = torch.roll(seg, shifts=(-dy, -dx), dims=(1, 2))   # seg[y+dy, x+dx]
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


def index_sum_sorted(vals: torch.Tensor, idx: torch.Tensor, nbins: int) -> torch.Tensor:
    """:func:`index_sum` without atomics: a stable sort of the rows by bin,
    then ``segment_reduce``, which adds each bin's rows one after another
    in the sorted order — row order within a bin, as ``index_add_`` on
    the CPU adds them. Any device; the card's route."""
    order = torch.argsort(idx, stable=True)
    bounds = torch.searchsorted(idx[order], torch.arange(nbins + 1, device=idx.device))
    return torch.segment_reduce(vals[order], "sum", offsets=bounds, axis=0, unsafe=True)


def index_sum(vals: torch.Tensor, idx: torch.Tensor, nbins: int) -> torch.Tensor:
    """(M, C) rows summed into (nbins, C) bins by (M,) int64 ids in
    [0, nbins), in a fixed order. On the CPU ``index_add_``; on the card
    ``index_add_`` adds with float atomics whose order changes from run to
    run, so a graph build would differ in its last bits between runs:
    :func:`index_sum_sorted` gives the same bits on every run."""
    if vals.device.type == "cpu":
        out = torch.zeros(nbins, vals.shape[1], dtype=vals.dtype)
        return out.index_add_(0, idx, vals)
    return index_sum_sorted(vals, idx, nbins)


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, K: int) -> torch.Tensor:
    """(B, N, C) values summed into (B, K, C) bins by (B, N) labels; labels
    outside [0, K) are dropped."""
    B, N, C = vals.shape
    seg = torch.where((seg >= 0) & (seg < K), seg, K)
    idx = (seg + (K + 1) * torch.arange(B, device=seg.device)[:, None]).reshape(-1)
    out = index_sum(vals.reshape(-1, C), idx, B * (K + 1))
    return out.reshape(B, K + 1, C)[:, :K]


_HALO = 4   # rows of a neighbour's block that a rank's per-pixel channels read


def region_features(image: torch.Tensor, segments: torch.Tensor,
                    edges: torch.Tensor, num_segments: int,
                    norm_size: int | None = None, row_group=None) -> Dict[str, torch.Tensor]:
    """15-dim node features of every segment.

    image (B, H, W, 3) float RGB in [0, 1]; segments (B, H, W) integer
    labels; edges (B, H, W) Canny map; ``num_segments`` the padded node
    bucket K. ``norm_size=None`` normalizes positions by the actual W/H;
    ``norm_size=256`` reproduces the reference's hard-coded /256 and
    /(256·256) (``region_graph/train.py:130-132``) for reference-recipe
    weights at other sizes. Returns features (B, K, 15), node_mask (B, K)
    and count (B, K). Under a ``row_group`` the three maps are this rank's
    block of rows and the results are the whole image's (module
    docstring)."""
    B, H, W, _ = image.shape
    K = num_segments
    dev = image.device
    rows, H_all = spatial_rows(H, row_group)
    img, top = halo_rows(image.float(), _HALO, row_group)
    seg = halo_rows(segments.long(), _HALO, row_group)[0]
    gray = rgb_to_gray(img)

    keep2 = _distinct_foreign_neighbors(seg, _DIAMOND_2).float()
    nb_acc = torch.zeros(seg.shape + (5,), dtype=torch.float32, device=dev)
    for i, (dy, dx) in enumerate(_DIAMOND_2):
        w = keep2[..., i:i + 1]
        is_r1 = 1.0 if i < len(_DIAMOND_1) else 0.0
        pay = torch.cat([img * w, w, is_r1 * w], dim=-1)
        nb_acc = nb_acc + torch.roll(pay, shifts=(dy, dx), dims=(1, 2))
    img, seg, gray, nb_acc = (t[:, top:top + H] for t in (img, seg, gray, nb_acc))

    yy = torch.arange(rows.start, rows.stop, dtype=torch.float32, device=dev)
    xx = torch.arange(W, dtype=torch.float32, device=dev)
    pos = torch.stack(torch.meshgrid(yy, xx, indexing="ij"), dim=-1).expand(B, H, W, 2)
    vals = torch.cat([
        img,                                   # 0:3   sum rgb
        img ** 2,                              # 3:6   sum rgb²
        gray[..., None],                       # 6     sum gray
        (gray ** 2)[..., None],                # 7     sum gray²
        pos,                                   # 8, 9  sum y, sum x
        edges.float()[..., None],              # 10    sum edge
        torch.ones(B, H, W, 1, device=dev),    # 11    count
        nb_acc,                                # 12:15 nb rgb, 15 nb count, 16 perimeter
    ], dim=-1).reshape(B, H * W, 17)
    m = all_reduce_(segment_sum(vals, seg.reshape(B, H * W), K), row_group)

    count = m[..., 11]
    node_mask = count > 0
    safe = torch.clamp(count, min=1.0)[..., None]
    mean_rgb = m[..., 0:3] / safe
    var_rgb = torch.clamp(m[..., 3:6] / safe - mean_rgb ** 2, min=0.0)
    std_rgb = torch.sqrt(var_rgb)
    mean_gray = m[..., 6:7] / safe
    var_gray = torch.clamp(m[..., 7:8] / safe - mean_gray ** 2, min=0.0)
    std_gray = torch.sqrt(var_gray)
    norm_h = norm_size if norm_size is not None else H_all
    norm_w = norm_size if norm_size is not None else W
    center_y = (m[..., 8:9] / safe) / norm_h
    center_x = (m[..., 9:10] / safe) / norm_w
    region_size = count[..., None] / (norm_h * norm_w)
    edge_density = m[..., 10:11] / safe

    nb = m[..., 12:17]
    peri = nb[..., 4:5]
    compactness = peri ** 2 / (4.0 * math.pi * count[..., None] + 1e-10)
    nb_sum, nb_cnt = nb[..., :3], nb[..., 3]
    nb_mean = nb_sum / torch.clamp(nb_cnt, min=1.0)[..., None]
    contrast = torch.where(
        (nb_cnt > 0)[..., None],
        torch.sqrt(torch.sum((mean_rgb - nb_mean) ** 2, dim=-1, keepdim=True)),
        0.0)

    features = torch.cat([mean_rgb, std_rgb, mean_gray, std_gray,
                          center_x, center_y, region_size, compactness,
                          contrast, edge_density, var_gray], dim=-1)
    features = torch.where(node_mask[..., None], features, 0.0)
    features = torch.nan_to_num(features, nan=0.0)
    return {"features": features, "node_mask": node_mask, "count": count}


def region_label_means(maps: torch.Tensor, segments: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Per-segment means of (B, H, W, C) maps — or (B, H, W), one channel —
    over (B, H, W) labels → (B, K, C), the pixel count clamped at 1. The
    counterpart of ``ops/regions.py:region_label_means`` with a batch axis:
    the GT labels threshold these means of the object / instance / edge
    maps."""
    if maps.ndim == 3:
        maps = maps[..., None]
    B, H, W, C = maps.shape
    vals = torch.cat([maps.reshape(B, H * W, C).float(),
                      torch.ones(B, H * W, 1, device=maps.device)], dim=-1)
    m = segment_sum(vals, segments.reshape(B, H * W).long(), num_segments)
    return m[..., :C] / torch.clamp(m[..., C:], min=1.0)
