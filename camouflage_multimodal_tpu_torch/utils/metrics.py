"""Float-returning metric wrappers with the reference's signatures.

Port of ``camouflage_multimodal_tpu/utils/metrics.py``, backed by
:mod:`eval.metrics`. Numpy inputs (or lists of them) are put on
``device`` — the card by default, which raises without one; tensors stay
where they are.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.eval import metrics as tm


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def calculate_iou(pred, gt, threshold: float = 0.5, device="cuda") -> float:
    return float(tm.iou(_as_f32(pred, device), _as_f32(gt, device), threshold))


def calculate_dice(pred, gt, threshold: float = 0.5, device="cuda") -> float:
    return float(tm.dice(_as_f32(pred, device), _as_f32(gt, device), threshold))


def calculate_precision_recall_f1(pred, gt, threshold: float = 0.5,
                                  device="cuda") -> Tuple[float, float, float]:
    p, r, f1 = tm.precision_recall_f1(_as_f32(pred, device), _as_f32(gt, device), threshold)
    return float(p), float(r), float(f1)


def calculate_mae(pred, gt, device="cuda") -> float:
    return float(tm.mae(_as_f32(pred, device), _as_f32(gt, device)))


def calculate_accuracy(pred, gt) -> float:
    """Pixel accuracy on already-binarized inputs (the reference compares
    with ``==``); numpy on the host."""
    pred = np.asarray(pred)
    return float(np.sum(pred == np.asarray(gt)) / pred.size)


def evaluate_segmentation(pred_mask, gt_mask, threshold: float = 0.5,
                          device="cuda") -> Dict[str, float]:
    out = tm.evaluate_segmentation(_as_f32(pred_mask, device), _as_f32(gt_mask, device),
                                   threshold)
    return {k: float(v) for k, v in out.items()}


def batch_evaluate(pred_masks: Sequence, gt_masks: Sequence, threshold: float = 0.5,
                   device="cuda") -> Dict[str, float]:
    preds = torch.stack([_as_f32(p, device) for p in pred_masks])
    gts = torch.stack([_as_f32(g, device) for g in gt_masks])
    return {k: float(v) for k, v in tm.batch_evaluate(preds, gts, threshold).items()}
