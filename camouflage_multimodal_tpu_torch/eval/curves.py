"""Threshold-curve metrics: adaptive / mean / max E-measure, F-measure
(beta² = 0.3) and IoU over 256 thresholds.

Port of ``camouflage_multimodal_tpu/eval/curves.py``. For a binary GT every
curve point depends only on the 2×2 confusion counts at that threshold,
and all 256 come from one 256-level histogram of the quantised prediction
split by GT: reversed cumulative sums give tp / fp per threshold. The
histogram is counted in integers (an integer ``scatter_add_``, exact and
the same on every run, where a weighted float ``bincount`` would add with
atomics on the card); the counts, exact in float32 below 2²⁴ pixels, then
go through the JAX package's closed forms.
"""

from __future__ import annotations

from typing import Dict

import torch

_EPS = 1e-8
_LEVELS = 256  # thresholds k/255 for k = 0..255, matching uint8 quantization


def _confusion_curves(pred: torch.Tensor, gt: torch.Tensor):
    """(tp, fp), each (..., 256) float32: index k counts the pixels with
    round(pred·255) ≥ k, i.e. the binarization pred ≥ k/255."""
    lead = pred.shape[:-2]
    q = torch.clamp(torch.round(pred * 255.0), 0, 255).long().reshape(-1, pred.shape[-2] * pred.shape[-1])
    g = (gt > 0.5).reshape(q.shape).long()
    hist = torch.zeros(q.shape[0], 2 * _LEVELS, dtype=torch.long, device=pred.device)
    hist.scatter_add_(1, g * _LEVELS + q, torch.ones_like(q))
    # reversed cumsum: count of pixels with quantized value >= k
    counts = torch.flip(torch.cumsum(torch.flip(hist.reshape(-1, 2, _LEVELS), (-1,)), -1), (-1,))
    fp = counts[:, 0].float().reshape(lead + (_LEVELS,))
    tp = counts[:, 1].float().reshape(lead + (_LEVELS,))
    return tp, fp


def _e_from_counts(tp, fp, n_fg, n_px):
    """Enhanced-alignment measure as a closed form of confusion counts."""
    fn = n_fg - tp
    tn = n_px - n_fg - fp
    mu_p = (tp + fp) / n_px
    mu_g = n_fg / n_px

    def phi(ap, ag, sp, sg):
        align = 2.0 * ap * ag / (sp + sg + _EPS)
        return (align + 1.0) ** 2 / 4.0

    one_p, one_g = 1.0 - mu_p, 1.0 - mu_g
    em = (tp * phi(one_p, one_g, one_p ** 2, one_g ** 2)
          + fp * phi(one_p, -mu_g, one_p ** 2, mu_g ** 2)
          + fn * phi(-mu_p, one_g, mu_p ** 2, one_g ** 2)
          + tn * phi(mu_p, mu_g, mu_p ** 2, mu_g ** 2)) / (n_px - 1 + _EPS)
    # Degenerate GT per the original implementation: empty GT scores the
    # complement of the prediction area, full GT scores the area itself.
    pred_area = tp + fp
    em = torch.where(n_fg == 0, 1.0 - pred_area / n_px, em)
    return torch.where(n_fg == n_px, pred_area / n_px, em)


def _f_from_counts(tp, fp, n_fg, beta2: float = 0.3):
    precision = tp / (tp + fp + _EPS)
    recall = tp / (n_fg + _EPS)
    return (1.0 + beta2) * precision * recall / (beta2 * precision + recall + _EPS)


def _adaptive_index(pred: torch.Tensor) -> torch.Tensor:
    """The adaptive threshold 2·mean(pred) as an index into the curve: the
    curve at k binarizes with pred ≥ k/255, so the original's strict '>'
    maps to floor(t·255) + 1."""
    t = torch.clamp(2.0 * torch.mean(pred, dim=(-2, -1)), max=1.0)
    return torch.clamp(torch.floor(t * 255.0).long() + 1, 0, 255)


def threshold_curves(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per image (leading axes kept): ``e_curve`` / ``f_curve`` /
    ``iou_curve`` (..., 256) and the adaptive, mean and max scalars."""
    n_px = float(pred.shape[-2] * pred.shape[-1])
    tp, fp = _confusion_curves(pred, gt)
    n_fg = tp[..., 0:1]  # threshold 0 binarizes everything to 1 -> tp = |fg|
    e_curve = _e_from_counts(tp, fp, n_fg, n_px)
    f_curve = _f_from_counts(tp, fp, n_fg)
    iou_curve = tp / (n_fg + fp + _EPS)  # union = |fg| + fp
    idx = _adaptive_index(pred)[..., None]

    def at(curve):
        return torch.gather(curve, -1, idx)[..., 0]

    return {
        "e_curve": e_curve,
        "f_curve": f_curve,
        "iou_curve": iou_curve,
        "e_adaptive": at(e_curve),
        "e_mean": torch.mean(e_curve, dim=-1),
        "e_max": torch.amax(e_curve, dim=-1),
        "f_adaptive": at(f_curve),
        "f_mean": torch.mean(f_curve, dim=-1),
        "f_max": torch.amax(f_curve, dim=-1),
        "iou_adaptive": at(iou_curve),
        "iou_max": torch.amax(iou_curve, dim=-1),
    }


def batch_curve_metrics(pred_masks: torch.Tensor, gt_masks: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    """Split means of the adaptive / mean / max scalars (curves dropped)."""
    per = threshold_curves(pred_masks, gt_masks)
    return {k: torch.mean(v) for k, v in per.items() if not k.endswith("_curve")}
