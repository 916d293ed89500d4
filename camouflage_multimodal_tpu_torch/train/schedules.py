"""Learning-rate schedules (the port's own copy of
``camouflage_multimodal_tpu/train/schedules.py``).

:func:`cosine_warm_restarts` mirrors
``torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(T_0, T_mult)``
stepped once per epoch.
"""

from __future__ import annotations

import math


def cosine_warm_restarts(epoch: int, base_lr: float, T_0: int = 10,
                         T_mult: int = 2, eta_min: float = 0.0) -> float:
    """LR at integer ``epoch`` (restarts at epoch T_0, T_0 + T_0·T_mult, ...)."""
    t_cur = epoch
    t_i = T_0
    while t_cur >= t_i:
        t_cur -= t_i
        t_i *= T_mult
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2
