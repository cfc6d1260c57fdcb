"""Composable training objectives.

Counterpart of the JAX package's losses/__init__.py: BaseLoss :23,
DiffusionLoss :39, ProjectionLoss :53, ComposedLoss :91 and build_loss :113.
The weights live in the diffusion module, so a loss is a callable
``(batch, generator) -> (weighted loss, {name: value})`` and the composed
objective ``(batch, generators) -> (total, metrics)``. Randomness is explicit:
one ``torch.Generator`` per component, where the JAX side folds the step's
key with the component's index (:106); :func:`make_generators` seeds them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from dadiff_tpu_torch.ops.projection import NormStats, projection_residual


class BaseLoss:
    """Weighted loss base (losses/__init__.py:23-36)."""

    name = "loss"

    def __init__(self, weight: float = 1.0):
        self.weight = weight

    def compute(self, batch, generator) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, batch, generator=None):
        value = self.compute(batch, generator)
        return self.weight * value, {self.name: value}


class DiffusionLoss(BaseLoss):
    """Standard denoising loss on batch['conditions']
    (losses/__init__.py:39-50)."""

    name = "diffusion"

    def __init__(self, diffusion, weight: float = 1.0):
        super().__init__(weight)
        self.diffusion = diffusion

    def compute(self, batch, generator):
        return self.diffusion.loss(batch["conditions"], generator=generator)


class ProjectionLoss(BaseLoss):
    """Soft dynamics penalty ||tau - P tau||^2 in physical space
    (losses/__init__.py:53-88). ``P`` and the stats move to the batch's
    device on first use."""

    name = "projection"

    def __init__(self, projection_matrix, normalizer, state_dim: int,
                 action_dim: int, observation_dim: int, horizon: int,
                 weight: float = 0.1):
        super().__init__(weight)
        self.P = torch.as_tensor(projection_matrix, dtype=torch.float32)
        self.stats = NormStats.from_normalizer(normalizer)
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.observation_dim = observation_dim
        self.horizon = horizon

    def compute(self, batch, generator):
        x = batch["conditions"]
        if self.P.device != x.device:
            self.P = self.P.to(x.device)
            self.stats = NormStats(*(v.to(x.device) for v in self.stats))
        return projection_residual(
            x, self.P, self.stats, observation_dim=self.observation_dim,
            action_dim=self.action_dim, state_dim=self.state_dim)


class ComposedLoss:
    """Weighted sum of losses returning (total, breakdown)
    (losses/__init__.py:91-110)."""

    def __init__(self, losses: Sequence[BaseLoss]):
        self.losses = list(losses)

    @property
    def names(self) -> List[str]:
        return [loss.name for loss in self.losses]

    def __call__(self, batch, generators: Optional[Sequence] = None):
        if generators is None:
            generators = [None] * len(self.losses)
        if len(generators) != len(self.losses):
            raise ValueError("ComposedLoss needs one generator per component")
        total = None
        metrics: Dict[str, torch.Tensor] = {}
        for loss, generator in zip(self.losses, generators):
            value, sub = loss(batch, generator)
            total = value if total is None else total + value
            metrics.update(sub)
        metrics["total"] = total
        return total, metrics


def make_generators(n: int, seed: int, device) -> List[torch.Generator]:
    """One generator per loss component on ``device``, component i seeded
    ``seed + i``."""
    return [torch.Generator(device=device).manual_seed(seed + i)
            for i in range(n)]


def build_loss(diffusion, *, projection_weight: float = 0.0,
               projection_matrix=None, normalizer=None,
               state_dim: Optional[int] = None) -> Tuple[Callable, List[str]]:
    """Compose the training objective (losses/__init__.py:113-141)."""
    losses: List[BaseLoss] = [DiffusionLoss(diffusion)]
    if projection_weight > 0:
        if projection_matrix is None or normalizer is None or state_dim is None:
            raise ValueError(
                "projection loss requires projection_matrix, normalizer, "
                "state_dim")
        losses.append(ProjectionLoss(
            projection_matrix, normalizer, state_dim=state_dim,
            action_dim=diffusion.action_dim,
            observation_dim=diffusion.observation_dim,
            horizon=diffusion.horizon, weight=projection_weight))
    composed = ComposedLoss(losses)
    return composed, composed.names
