"""Shared modules of the port's models: masked BatchNorm, dropout with an
explicit generator and the dense GCN layer."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from camouflage_multimodal_tpu_torch.ops.graph import gcn_layer, masked_batch_stats
from camouflage_multimodal_tpu_torch.parallel.sharding import rand_block


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid nodes of a padded node batch. Port of
    ``camouflage_multimodal_tpu/models/layers.py:MaskedBatchNorm``.

    In training mode it normalizes with the population statistics of every
    valid node of the whole batch (:func:`ops.graph.masked_batch_stats`;
    gradients flow through them, as under ``jax.grad``) and moves the
    running estimates by ``momentum`` toward the batch mean and the unbiased
    variance ``var·n/max(n−1, 1)``; in eval mode it uses the running
    estimates. Padded nodes come out zero. ε = 1e-5, torch's and the JAX
    module's default. The buffer names are the ones ``convert.py`` writes.
    Under a data-parallel group the statistics are the global batch's, so
    the running estimates are the same on every rank."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5) -> None:
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        # The data-parallel group whose blocks make up the batch (None: this
        # process holds the whole batch); see :func:`set_data_group`.
        self.data_group = None

    def reset_parameters(self) -> None:
        """Unit scale, zero bias, fresh running statistics."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var, n = masked_batch_stats(x, mask, self.data_group)
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.copy_((1 - self.momentum) * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_((1 - self.momentum) * self.running_var
                                       + self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[..., None], y, 0.0)


class Dropout(nn.Module):
    """Inverted dropout with an explicit generator (``nn.Dropout`` can only
    draw from the global one, which a resumable trainer cannot snapshot
    without touching every other consumer). The identity in eval mode and
    at rate 0, where it draws nothing. Under a data-parallel group it
    draws the global batch's mask and keeps its own rows; on an activation
    whose last axis is split over a ``model_group`` (set by the FFN that
    holds it) it draws the whole axis and keeps its columns
    (:func:`parallel.sharding.rand_block`)."""

    def __init__(self, p: float) -> None:
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None
        self.data_group = None
        self.model_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = rand_block(x.shape, self.generator, x.device, self.data_group,
                          self.model_group, dim=-1) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every :class:`Dropout` of ``model`` draws from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_data_group(model: nn.Module, group) -> None:
    """Every module of ``model`` with batch-wide state — BatchNorm
    statistics, dropout and attention-dropout draws — treats its input as
    this rank's block of a batch spread over ``group`` (None: the whole
    batch)."""
    for m in model.modules():
        if hasattr(m, "data_group"):
            m.data_group = group


class GCNConv(nn.Module):
    """Dense GCN layer on a pre-normalized adjacency; bias after propagation."""

    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__()
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Xavier-uniform kernel, zero bias (the JAX kernels' ``glorot_uniform``)."""
        glorot_(self.lin.weight, self.lin.in_features, self.lin.out_features, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, adj_norm):
        return gcn_layer(x, adj_norm, self.lin.weight.T, self.bias)


def glorot_(weight: torch.Tensor, fan_in: int, fan_out: int,
            generator: Optional[torch.Generator]) -> None:
    """Xavier-uniform draw in place (flax ``glorot_uniform``'s law)."""
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.copy_((torch.rand(weight.shape, generator=generator) * 2 - 1) * bound)


def lecun_(linear: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """LeCun-normal weight and zero bias (flax ``Dense``'s defaults)."""
    with torch.no_grad():
        std = 1.0 / math.sqrt(linear.in_features)
        linear.weight.copy_(torch.randn(linear.weight.shape, generator=generator) * std)
        linear.bias.zero_()
