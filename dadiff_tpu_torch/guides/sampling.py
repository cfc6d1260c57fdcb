"""The DDPM sampling engine: conditioning and per-step dynamics projection.

Counterpart of the JAX package's guides/sampling.py: Conditions :33,
conditions_for_initial_obs(_np) :48-80, ProjectionSpec :83 and the DDPM
branch of make_sampler :114 (its body :361-393: DDPM update, projection
after each step, then the conditions re-imposed). This sampler is also the
plain version of the planner chain (ops/planner.py). Guidance, warm start,
DDIM and DPM++ are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dadiff_tpu_torch.models.diffusion import (
    GaussianDiffusion,
    default_timesteps,
    p_mean_variance,
)
from dadiff_tpu_torch.ops.projection import (
    NormStats,
    apply_projection,
    projection_alpha,
)


class Conditions(NamedTuple):
    """Inpainting conditions: rows where ``mask`` is set take ``values``."""

    values: torch.Tensor  # (H, D) or (B, H, D)
    mask: torch.Tensor    # (H,) bool

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        values = torch.as_tensor(self.values, dtype=x.dtype, device=x.device)
        if values.dim() == x.dim() - 1:
            values = values[None]
        mask = torch.as_tensor(self.mask, device=x.device)
        return torch.where(mask[None, :, None], values, x)


def conditions_for_initial_obs(normed_obs: torch.Tensor, observation_dim: int,
                               horizon: int, transition_dim: int) -> Conditions:
    """Row 0 conditioned on the observation with its action slot zeroed
    (sampling.py:48-62)."""
    normed_obs = torch.atleast_2d(torch.as_tensor(normed_obs,
                                                  dtype=torch.float32))
    batch = normed_obs.shape[0]
    values = torch.zeros(batch, horizon, transition_dim, dtype=torch.float32,
                         device=normed_obs.device)
    values[:, 0, :observation_dim] = normed_obs
    mask = torch.zeros(horizon, dtype=torch.bool, device=normed_obs.device)
    mask[0] = True
    return Conditions(values=values, mask=mask)


def conditions_for_initial_obs_np(normed_obs, observation_dim: int,
                                  horizon: int, transition_dim: int
                                  ) -> Conditions:
    """Numpy twin of :func:`conditions_for_initial_obs` for the policy's
    replan path (sampling.py:65-80)."""
    normed_obs = np.atleast_2d(np.asarray(normed_obs, np.float32))
    batch = normed_obs.shape[0]
    values = np.zeros((batch, horizon, transition_dim), np.float32)
    values[:, 0, :observation_dim] = normed_obs
    mask = np.zeros((horizon,), bool)
    mask[0] = True
    return Conditions(values=values, mask=mask)


@dataclasses.dataclass(frozen=True)
class ProjectionSpec:
    """Static projection configuration (sampling.py:83-111)."""

    state_dim: int
    schedule: str = "noise_schedule"
    strength: float = 1.0
    wall_grid: Optional[Tuple[Tuple[int, ...], ...]] = None
    wall_margin: Optional[float] = None


def make_sampler(diffusion: GaussianDiffusion, *,
                 projection: Optional[ProjectionSpec] = None,
                 sampling_timesteps: Optional[int] = None):
    """Build ``plan(generator, conditions, P=None, stats=None, *,
    init_noise=None, step_noise=None) -> (B, H, D)``, the DDPM reverse chain
    with projection after each step and the conditions re-imposed
    (sampling.py:114-433, DDPM branch). ``init_noise`` (B, H, D) and
    ``step_noise`` (T, B, H, D) fix the randomness for parity checks."""
    schedule = diffusion.schedule
    device = diffusion.device
    ts = default_timesteps(diffusion.n_timesteps, sampling_timesteps, device)
    H, D = diffusion.horizon, diffusion.transition_dim
    use_projection = projection is not None
    wall_grid = (
        torch.as_tensor(projection.wall_grid, dtype=torch.int32, device=device)
        if use_projection and projection.wall_grid is not None else None
    )
    alphas = (
        projection_alpha(ts, diffusion.n_timesteps, projection.schedule,
                         projection.strength, schedule.betas)
        if use_projection else None
    )

    @torch.no_grad()
    def plan(generator: Optional[torch.Generator], conditions: Conditions,
             P=None, stats: Optional[NormStats] = None, *,
             init_noise: Optional[torch.Tensor] = None,
             step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        values = np.asarray(conditions.values) if not torch.is_tensor(
            conditions.values) else conditions.values
        batch = values.shape[0] if values.ndim == 3 else 1
        shape = (batch, H, D)
        x = (torch.randn(shape, generator=generator, device=device)
             if init_noise is None else init_noise.to(device))
        if step_noise is None:
            step_noise = torch.randn((len(ts),) + shape, generator=generator,
                                     device=device)
        x = conditions.apply(x)
        if use_projection:
            P = torch.as_tensor(P, dtype=torch.float32, device=device)
        for i, t in enumerate(ts):
            t_b = t.expand(batch)
            mean, log_var = p_mean_variance(
                diffusion.model(x, t_b), schedule, x, t_b,
                clip_denoised=diffusion.clip_denoised,
                predict_epsilon=diffusion.predict_epsilon,
            )
            x = mean + (t != 0).to(x.dtype) * torch.exp(0.5 * log_var) \
                * step_noise[i].to(device)
            if use_projection:
                x = apply_projection(
                    x, P, alphas[i], stats,
                    observation_dim=diffusion.observation_dim,
                    action_dim=diffusion.action_dim,
                    state_dim=projection.state_dim,
                    wall_grid=wall_grid, wall_margin=projection.wall_margin,
                )
            x = conditions.apply(x)
        return x

    plan.timesteps = ts
    return plan
