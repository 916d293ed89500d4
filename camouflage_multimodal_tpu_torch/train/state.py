"""Optimizer step of the port's trainers: AdamW with decoupled decay,
global-norm gradient clipping and a learning rate applied per step.

Counterpart of ``camouflage_multimodal_tpu/train/state.py``
(``make_adamw_tx`` + ``apply_updates``): optax's ``clip_by_global_norm`` →
``scale_by_adam`` → ``add_decayed_weights`` → ``−lr`` is what
``torch.optim.AdamW`` (eps 1e-8, betas 0.9 / 0.999) computes, in another
order of float32 operations. The clip is written out here because
``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` where optax
divides by ``norm``.
"""

from __future__ import annotations

from typing import Iterable, List

import torch


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """In place: scale ``grads`` to a global L2 norm of ``max_norm`` where
    it is larger (``g / norm * max_norm``, as optax). Batched over the list
    and decided on the device: no launch per tensor, no host sync. Returns
    the norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


def make_adamw(params: Iterable[torch.nn.Parameter], weight_decay: float
               ) -> torch.optim.AdamW:
    """The optimizer of :func:`apply_updates`; its learning rate is set at
    every step."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def apply_updates(optimizer: torch.optim.Optimizer, lr: float,
                  clip_norm: float = 1.0) -> None:
    """One step on the gradients the parameters hold: clip them to
    ``clip_norm``, step with learning rate ``lr``, clear them."""
    grads = [p.grad for group in optimizer.param_groups for p in group["params"]
             if p.grad is not None]
    clip_by_global_norm_(grads, clip_norm)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
