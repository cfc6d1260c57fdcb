"""Trajectory value function for classifier-guided sampling.

Counterpart of the JAX package's models/value_net.py: ValueNet :30,
value_loss :68 and make_value_guide_fn :91. V(x_t, t) regresses the
discounted return of the clean trajectory from its noised version at
diffusion time t, so its gradient steers every step of the reverse chain.
The net is the denoiser's encoder half: time-conditioned residual blocks
(models/temporal_unet.py's) with a stride-2 conv between levels, the
horizon pooled by its mean, then a two-layer head.

Module names follow the Flax tree: ``time_mlp.1``/``.3`` are
``time_dense1``/``2``, ``blocks.{i}`` is ``enc_{i}_res``, ``downs.{i}`` is
``enc_{i}_down`` and ``head1``/``head2`` keep their names
(io/torch_compat.py ``value_params_from_jax``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dadiff_tpu_torch.models.diffusion import q_sample
from dadiff_tpu_torch.models.temporal_unet import (
    ResidualTemporalBlock,
    SinusoidalPosEmb,
)


class ValueNet(nn.Module):
    """``forward(x (B, H, transition_dim), t (B,)) -> (B,)`` value
    estimates (value_net.py:30-65)."""

    def __init__(self, transition_dim: int, dim: int = 32,
                 dim_mults: Sequence[int] = (1, 2, 4), kernel_size: int = 5):
        super().__init__()
        self.transition_dim = transition_dim
        self.dim = dim
        self.dim_mults = tuple(dim_mults)
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(dim), nn.Linear(dim, dim * 4), nn.Mish(),
            nn.Linear(dim * 4, dim))
        widths = [dim * m for m in self.dim_mults]
        self.blocks = nn.ModuleList(
            ResidualTemporalBlock(cin, cout, dim, kernel_size)
            for cin, cout in zip([transition_dim] + widths[:-1], widths))
        # stride 2, Flax padding [(1, 1)]
        self.downs = nn.ModuleList(nn.Conv1d(w, w, 3, 2, 1)
                                   for w in widths[:-1])
        self.head1 = nn.Linear(widths[-1], dim * 4)
        self.head2 = nn.Linear(dim * 4, 1)

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        t = self.time_mlp(time)
        x = x.to(torch.float32)
        for i, block in enumerate(self.blocks):
            x = block(x, t)
            if i < len(self.downs):
                x = self.downs[i](x.transpose(1, 2)).transpose(1, 2)
        x = x.mean(dim=1)
        return self.head2(F.mish(self.head1(x)))[..., 0]


def value_loss(value_net: ValueNet, schedule, batch, t: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
    """MSE between V(q_sample(x0, t, noise), t) and the window's normalized
    return (value_net.py:68-88); the caller draws ``t`` (B,) in [0, T) and
    ``noise`` like ``batch['conditions']``."""
    x0 = batch["conditions"]
    pred = value_net(q_sample(schedule, x0, t, noise), t)
    return torch.mean((pred - batch["returns"]) ** 2)


def make_value_guide_fn(value_net: ValueNet):
    """``guide_fn(x, t) -> (B,)`` for the sampler: the value estimate whose
    gradient steers the reverse chain (value_net.py:91-102)."""

    def guide_fn(x, t):
        return value_net(x, t)

    return guide_fn
