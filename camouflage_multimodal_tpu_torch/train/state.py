"""Optimizer step of the port's trainers: AdamW with decoupled decay or
Adam with L2, global-norm gradient clipping and a learning rate applied per
step.

Counterpart of ``camouflage_multimodal_tpu/train/state.py``
(``make_adamw_tx``, ``make_adam_l2_tx`` + ``apply_updates``): optax's
``clip_by_global_norm`` → ``scale_by_adam`` → ``add_decayed_weights`` →
``−lr`` is what ``torch.optim.AdamW`` (eps 1e-8, betas 0.9 / 0.999)
computes, in another order of float32 operations. The clip is written out
here because ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``
where optax divides by ``norm``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Optional[Sequence[bool]] = None,
                         model_group=None) -> torch.Tensor:
    """In place: scale ``grads`` to a global L2 norm of ``max_norm`` where
    it is larger (``g / norm * max_norm``, as optax). Batched over the list
    and decided on the device: no launch per tensor, no host sync. Returns
    the norm before clipping.

    Under tensor parallelism the gradients flagged in ``sharded`` are this
    rank's shares of gradients split over ``model_group``: their squared
    norms are summed over the group, the others (replicated, equal on every
    rank) counted once, so every rank clips by the whole model's norm."""
    norms = torch.stack(torch._foreach_norm(grads))
    if model_group is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        flags = torch.tensor(list(sharded), dtype=torch.bool, device=norms.device)
        squares = torch.square(norms)
        shared = torch.where(flags, squares, 0.0).sum()
        dist.all_reduce(shared, group=model_group)
        norm = torch.sqrt(torch.where(flags, 0.0, squares).sum() + shared)
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


def make_adam_l2(params: Iterable[torch.nn.Parameter], weight_decay: float
                 ) -> torch.optim.Adam:
    """The counterpart of ``make_adam_l2_tx`` (optax ``clip_by_global_norm``
    → ``add_decayed_weights`` → ``scale_by_adam``: the L2 term joins the
    clipped gradient before the moments). ``torch.optim.Adam`` with
    ``weight_decay`` adds ``wd · p`` to the gradient it is given before its
    moments, so :func:`apply_updates` (clip, then step) computes exactly
    that; ``tests/test_torch_port_train_kg.py::test_adam_l2_matches_optax``
    holds five steps against optax at 1e-6."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def optimizer_arrays(model: torch.nn.Module, optimizer: torch.optim.Optimizer
                     ) -> Dict[str, Any]:
    """The optimizer's moments and step counts by parameter name, as numpy
    (what a resume snapshot holds)."""
    out: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p)
        if st:
            out[name] = {k: v.detach().cpu().numpy() for k, v in st.items()}
    return out


def load_optimizer_arrays(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          arrays: Dict[str, Any]) -> None:
    """Inverse of :func:`optimizer_arrays`."""
    state = {i: {k: torch.from_numpy(np.array(v)) for k, v in arrays[name].items()}
             for i, (name, _) in enumerate(model.named_parameters()) if name in arrays}
    optimizer.load_state_dict(
        {"state": state, "param_groups": optimizer.state_dict()["param_groups"]})


def apply_updates(optimizer: torch.optim.Optimizer, lr: float,
                  clip_norm: float = 1.0, model_group=None,
                  sharded_params: Iterable[torch.nn.Parameter] = ()) -> None:
    """One step on the gradients the parameters hold: clip them to
    ``clip_norm``, step with learning rate ``lr``, clear them. Under a
    ``model_group``, ``sharded_params`` are the parameters split over it
    (:func:`clip_by_global_norm_`)."""
    params = [p for group in optimizer.param_groups for p in group["params"]
              if p.grad is not None]
    ids = {id(p) for p in sharded_params}
    clip_by_global_norm_([p.grad for p in params], clip_norm,
                         [id(p) in ids for p in params], model_group)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
