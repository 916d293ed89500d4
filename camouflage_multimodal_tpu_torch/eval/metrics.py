"""Segmentation metrics as batched torch reductions, on the device of their
inputs.

Port of ``camouflage_multimodal_tpu/eval/metrics.py``: IoU / Dice / P / R /
F1 / MAE / pixel accuracy with the reference's eps constants, plus the
S-measure (Fan et al., ICCV'17; object and region terms, the region split
at the GT centroid) and the single-threshold E-measure (Fan et al.,
IJCAI'18). Inputs are (..., H, W) maps in [0, 1]; every metric reduces over
the last two axes, so :func:`batch_evaluate` scores a whole split in a few
launches with no host round trip. No kernel: these are a handful of
elementwise passes and sums over each map, far below anything a hand
kernel would change.
"""

from __future__ import annotations

from typing import Dict

import torch

_EPS = 1e-8
_HW = (-2, -1)


def _binarize(x: torch.Tensor, threshold: float) -> torch.Tensor:
    return (x > threshold).float()


def iou(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    p, g = _binarize(pred, threshold), _binarize(gt, threshold)
    inter = torch.sum(p * g, dim=_HW)
    union = torch.sum(p, dim=_HW) + torch.sum(g, dim=_HW) - inter
    return inter / (union + _EPS)


def dice(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    p, g = _binarize(pred, threshold), _binarize(gt, threshold)
    inter = torch.sum(p * g, dim=_HW)
    return (2.0 * inter) / (torch.sum(p, dim=_HW) + torch.sum(g, dim=_HW) + _EPS)


def precision_recall_f1(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.5):
    p, g = _binarize(pred, threshold), _binarize(gt, threshold)
    tp = torch.sum(p * g, dim=_HW)
    fp = torch.sum(p * (1.0 - g), dim=_HW)
    fn = torch.sum((1.0 - p) * g, dim=_HW)
    precision = tp / (tp + fp + _EPS)
    recall = tp / (tp + fn + _EPS)
    f1 = 2.0 * precision * recall / (precision + recall + _EPS)
    return precision, recall, f1


def mae(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt), dim=_HW)


def pixel_accuracy(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    p, g = _binarize(pred, threshold), _binarize(gt, threshold)
    return torch.mean((p == g).float(), dim=_HW)


def _s_object(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Object-aware structural similarity."""
    def obj(score_map, mask):
        w = torch.sum(mask, dim=_HW)
        mean = torch.sum(score_map * mask, dim=_HW) / (w + _EPS)
        var = torch.sum(((score_map - mean[..., None, None]) * mask) ** 2, dim=_HW) / (w + _EPS)
        return 2.0 * mean / (mean ** 2 + 1.0 + torch.sqrt(var) + _EPS)

    u = torch.mean(gt, dim=_HW)
    return u * obj(pred, gt) + (1.0 - u) * obj(1.0 - pred, 1.0 - gt)


def _ssim_masked(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """SSIM-style score of the two maps inside a boolean region mask."""
    m = mask.to(pred.dtype)
    n = torch.sum(m, dim=_HW)
    safe_n = torch.clamp(n, min=1.0)
    mx = torch.sum(pred * m, dim=_HW) / safe_n
    my = torch.sum(gt * m, dim=_HW) / safe_n
    dx = (pred - mx[..., None, None]) * m
    dy = (gt - my[..., None, None]) * m
    denom = torch.clamp(n - 1.0, min=1.0)
    sx = torch.sum(dx ** 2, dim=_HW) / denom
    sy = torch.sum(dy ** 2, dim=_HW) / denom
    sxy = torch.sum(dx * dy, dim=_HW) / denom
    alpha = 4.0 * mx * my * sxy
    beta = (mx ** 2 + my ** 2) * (sx + sy)
    return torch.where(alpha != 0, alpha / (beta + _EPS),
                       torch.where(beta == 0, 1.0, 0.0))


def _s_region(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Region-aware structural similarity: the four quadrants around the GT
    centroid (rounded half to even; the image center for an empty GT),
    each scored by :func:`_ssim_masked` and weighted by its area."""
    H, W = pred.shape[-2], pred.shape[-1]
    yy = torch.arange(H, dtype=torch.float32, device=pred.device)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=pred.device)[None, :].expand(H, W)
    total = torch.sum(gt, dim=_HW)
    safe = torch.clamp(total, min=_EPS)
    cy = torch.where(total > 0, torch.sum(yy * gt, dim=_HW) / safe, H / 2.0)
    cx = torch.where(total > 0, torch.sum(xx * gt, dim=_HW) / safe, W / 2.0)
    top = yy < torch.round(cy)[..., None, None]
    left = xx < torch.round(cx)[..., None, None]
    score = 0.0
    for q in (top & left, top & ~left, ~top & left, ~top & ~left):
        wq = torch.sum(q.float(), dim=_HW) / (H * W)
        score = score + wq * _ssim_masked(pred, gt, q)
    return score


def s_measure(pred: torch.Tensor, gt: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """S = alpha·S_object + (1 − alpha)·S_region; 1 − mean(pred) for an
    empty GT and mean(pred) for a full one, as in the original."""
    gt_b = (gt > 0.5).float()
    y = torch.mean(gt_b, dim=_HW)
    s = alpha * _s_object(pred, gt_b) + (1.0 - alpha) * _s_region(pred, gt_b)
    mean_pred = torch.mean(pred, dim=_HW)
    s = torch.where(y == 0, 1.0 - mean_pred, s)
    s = torch.where(y == 1, mean_pred, s)
    return torch.clamp(s, 0.0, 1.0)


def e_measure(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Enhanced-alignment measure on the binarized prediction."""
    p, g = _binarize(pred, threshold), _binarize(gt, threshold)
    n = p.shape[-2] * p.shape[-1]
    ap = p - torch.mean(p, dim=_HW, keepdim=True)
    ag = g - torch.mean(g, dim=_HW, keepdim=True)
    align = 2.0 * ap * ag / (ap ** 2 + ag ** 2 + _EPS)
    em = torch.sum((align + 1.0) ** 2 / 4.0, dim=_HW) / (n - 1 + _EPS)
    gt_sum = torch.sum(g, dim=_HW)
    pred_sum = torch.sum(p, dim=_HW)
    em = torch.where(gt_sum == 0, 1.0 - pred_sum / n, em)
    return torch.where(gt_sum == n, pred_sum / n, em)


def evaluate_segmentation(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
                          threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """Per-image metrics under the reference's keys plus ``s_measure`` and
    ``e_measure``."""
    precision, recall, f1 = precision_recall_f1(pred_mask, gt_mask, threshold)
    return {
        "iou": iou(pred_mask, gt_mask, threshold),
        "dice": dice(pred_mask, gt_mask, threshold),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "mae": mae(pred_mask, gt_mask),
        "accuracy": pixel_accuracy(pred_mask, gt_mask, threshold),
        "s_measure": s_measure(pred_mask, gt_mask),
        "e_measure": e_measure(pred_mask, gt_mask, threshold),
    }


def batch_evaluate(pred_masks: torch.Tensor, gt_masks: torch.Tensor,
                   threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """``<key>`` mean and ``<key>_std`` (population std) of every metric
    over the batch."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in evaluate_segmentation(pred_masks, gt_masks, threshold).items():
        out[k] = torch.mean(v)
        out[f"{k}_std"] = torch.std(v, correction=0)
    return out
