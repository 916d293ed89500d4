"""The plain reference of a fusion training step: the summed per-sample
loss (3·focal + CE + 0.5·BCE + 0.3·MSE), its gradient, the global-norm
clip to 1 (divided by the norm itself) and AdamW (betas 0.9 / 0.999,
eps 1e-8, decoupled decay)."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

WEIGHTS = {"mask": 3.0, "instance": 1.0, "edge": 0.5, "score": 0.3}
FOCAL_ALPHA, FOCAL_GAMMA = 0.75, 3.0


def _ce(logits, labels):
    return -torch.gather(torch.log_softmax(logits, -1), -1, labels[..., None])[..., 0]


def batch_loss(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    y = batch["y"]
    ce = _ce(out["mask_logits"], y)
    alpha = torch.where(y == 1, FOCAL_ALPHA, 1.0 - FOCAL_ALPHA)
    focal = alpha * (1.0 - torch.exp(-ce)) ** FOCAL_GAMMA * ce
    e, t = out["edge_logits"][:, 0], batch["edge"]
    bce = -(t * F.logsigmoid(e) + (1.0 - t) * F.logsigmoid(-e))
    per_sample = (WEIGHTS["mask"] * focal + WEIGHTS["instance"] * _ce(out["instance_logits"], y)
                  + WEIGHTS["edge"] * bce + WEIGHTS["score"] * (out["score"][:, 0] - batch["score"]) ** 2)
    return per_sample.sum()


def run_steps(model, batches: List[Dict[str, torch.Tensor]], lr: float, weight_decay: float):
    """Train ``model`` over ``batches``. Returns (losses, the clipped
    gradient of the first step by parameter name, the parameters after the
    last step by name)."""
    model.train()
    params = dict(model.named_parameters())
    opt = torch.optim.AdamW(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, foreach=False)
    losses, first = [], None
    for batch in batches:
        out = model(batch["rg"], batch["kg"], batch["rg_mask"])
        loss = batch_loss(out, batch)
        loss.backward()
        grads = [p.grad for p in params.values()]
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)).float()
        if norm >= 1.0:
            for g in grads:
                g.div_(norm)
        if first is None:
            first = {n: p.grad.detach().clone() for n, p in params.items()}
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    return losses, first, {n: p.detach().clone() for n, p in params.items()}
