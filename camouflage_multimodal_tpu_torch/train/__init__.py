"""Training of the port: losses, schedule, optimizer step, the fusion, RG
and KG trainers. Exports the names of ``camouflage_multimodal_tpu/train/__init__.py``."""

from camouflage_multimodal_tpu_torch.train.losses import (  # noqa: F401
    weighted_cross_entropy,
    bce_with_logits,
    focal_loss,
)
from camouflage_multimodal_tpu_torch.train.schedules import cosine_warm_restarts  # noqa: F401
