"""Loss functions, port of ``camouflage_multimodal_tpu/train/losses.py``.

* :func:`weighted_cross_entropy` — ``nn.CrossEntropyLoss(weight=...)``:
  weighted mean, normalised by the sum of the per-sample class weights;
* :func:`bce_with_logits` — ``nn.BCEWithLogitsLoss(pos_weight=...)``;
* :func:`focal_loss` — the reference's ``AggressiveFocalLoss(alpha=0.75,
  gamma=3.0)``: CE-based, alpha on class 1;
* :func:`mse`.

All take an optional validity mask, so padded nodes or samples drop out of
the reduction as they would under unpadded batches. The masked means and
the weighted cross-entropy also take a data-parallel ``group``: each rank
then returns its share of the global batch's loss, its own sum over the
global denominator (all-reduced, without a gradient: it depends on no
parameter), so the shares add up to the one-rank loss. The ``*_terms``
functions are the unreduced per-element losses, for trainers that sum over
the samples of a batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from camouflage_multimodal_tpu_torch.parallel.sharding import all_reduce_sum


def cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element negative log-likelihood, unreduced."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def _masked_mean(loss: torch.Tensor, mask: Optional[torch.Tensor],
                 group=None) -> torch.Tensor:
    if mask is None:
        if group is None:
            return loss.mean()
        mask = torch.ones_like(loss, dtype=torch.bool)
    loss = torch.where(mask, loss, 0.0)
    return loss.sum() / torch.clamp(all_reduce_sum(mask.sum().to(loss.dtype), group), min=1.0)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Optional[Sequence[float]] = None,
                           mask: Optional[torch.Tensor] = None,
                           group=None) -> torch.Tensor:
    """logits (..., C), labels (...,) int64, mask (...,) bool."""
    nll = cross_entropy_terms(logits, labels)
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=logits.dtype, device=logits.device)[labels]
    else:
        w = torch.ones_like(nll)
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    return (w * nll).sum() / torch.clamp(all_reduce_sum(w.sum(), group), min=1e-12)


def bce_terms(logits: torch.Tensor, targets: torch.Tensor,
              pos_weight: float = 1.0) -> torch.Tensor:
    """Per-element pos-weighted binary cross-entropy, unreduced."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: float = 1.0,
                    mask: Optional[torch.Tensor] = None,
                    group=None) -> torch.Tensor:
    """Per-element pos-weighted BCE, mean over the (valid) elements."""
    return _masked_mean(bce_terms(logits, targets, pos_weight), mask, group)


def focal_terms(logits: torch.Tensor, labels: torch.Tensor, alpha=0.75,
                gamma: float = 3.0) -> torch.Tensor:
    """Per-sample alpha_t · (1 − p_t)^gamma · CE, unreduced."""
    ce = cross_entropy_terms(logits, labels)
    pt = torch.exp(-ce)
    alpha_t = torch.where(labels == 1, alpha, 1.0 - alpha)
    return alpha_t * (1.0 - pt) ** gamma * ce


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha=0.75,
               gamma: float = 3.0, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over samples of alpha_t · (1 − p_t)^gamma · CE, alpha_t = alpha
    for class 1 else 1 − alpha."""
    return _masked_mean(focal_terms(logits, labels, alpha, gamma), mask)


def mse(pred: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean((pred - target) ** 2, mask)
