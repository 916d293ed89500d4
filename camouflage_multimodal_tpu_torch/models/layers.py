"""Shared modules for the padded-graph models."""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid nodes of a padded node batch, inference
    only: normalizes with the running statistics (ε = 1e-5, torch's and the
    JAX module's default) and zeroes padded nodes. Port of
    ``camouflage_multimodal_tpu/models/layers.py:MaskedBatchNorm``; the
    masked training statistics come with the training port."""

    def __init__(self, features: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = ((x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
             * self.weight + self.bias)
        return torch.where(mask[..., None], y, 0.0)
