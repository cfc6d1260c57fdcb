"""Dynamics projection of a normalized interleaved trajectory.

Counterpart of the JAX package's ops/projection.py: NormStats :23,
to_concatenated/from_concatenated :50-72 (the duplicated final state is kept
on purpose), projection_alpha :75, wall_violation_mask :98,
apply_projection :130 and projection_residual :197. Projection runs in
physical (unnormalized) space.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class NormStats(NamedTuple):
    """Normalization statistics as tensors (from a DatasetNormalizer)."""

    obs_mean: torch.Tensor
    obs_std: torch.Tensor
    action_mean: torch.Tensor
    action_std: torch.Tensor

    @classmethod
    def from_normalizer(cls, normalizer, device=None,
                        dtype=torch.float32) -> "NormStats":
        return cls(*(torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
                     for v in (normalizer.obs_mean, normalizer.obs_std,
                               normalizer.action_mean, normalizer.action_std)))

    @classmethod
    def identity(cls, observation_dim: int, action_dim: int, device=None,
                 dtype=torch.float32) -> "NormStats":
        """Zero means and unit deviations (projection.py:41-47)."""
        def full(n, v):
            return torch.full((n,), v, dtype=dtype, device=device)

        return cls(full(observation_dim, 0.0), full(observation_dim, 1.0),
                   full(action_dim, 0.0), full(action_dim, 1.0))



def to_concatenated(states: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """(B, H, n), (B, H, m) -> (B, (H+1)n + Hm) with the final state
    duplicated (projection.py:50-60)."""
    batch = states.shape[0]
    states_ext = torch.cat([states, states[:, -1:, :]], dim=1)
    return torch.cat([states_ext.reshape(batch, -1),
                      actions.reshape(batch, -1)], dim=1)


def from_concatenated(x_concat: torch.Tensor, horizon: int, state_dim: int,
                      action_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`to_concatenated`, dropping the duplicated final
    state (projection.py:63-72)."""
    batch = x_concat.shape[0]
    n_states = (horizon + 1) * state_dim
    states = x_concat[:, :n_states].reshape(batch, horizon + 1, state_dim)[:, :-1]
    actions = x_concat[:, n_states:].reshape(batch, horizon, action_dim)
    return states, actions


def projection_alpha(t: torch.Tensor, n_timesteps: int,
                     schedule: str = "constant", strength: float = 1.0,
                     betas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blend strength at diffusion timestep t (projection.py:75-95)."""
    progress = t.to(torch.float32) / n_timesteps
    if schedule == "constant":
        return strength * torch.ones_like(progress)
    if schedule == "linear":
        return strength * (1.0 - progress)
    if schedule == "quadratic":
        return strength * (1.0 - progress) ** 2
    if schedule == "noise_schedule":
        if betas is None:
            raise ValueError("noise_schedule requires betas")
        return torch.sqrt(1.0 - betas[t]) * strength
    raise ValueError(f"Unknown projection schedule: {schedule}")


def xy_to_cell(xy: torch.Tensor, H: int, W: int):
    """Physical xy -> (row, col) grid cell: origin at the maze center, y up,
    rows down (the JAX package's envs/pointmaze_jax.py:74-83)."""
    col = torch.floor(xy[..., 0] + W / 2.0).long().clamp(0, W - 1)
    row = torch.floor(H / 2.0 - xy[..., 1]).long().clamp(0, H - 1)
    return row, col


def wall_violation_mask(positions: torch.Tensor, wall_grid: torch.Tensor,
                        margin: Optional[float] = None) -> torch.Tensor:
    """(..., 2) physical xy -> bool, True inside a wall cell; a non-zero
    ``margin`` probes the four offset corners (projection.py:98-127)."""
    Hm, Wm = wall_grid.shape
    if not margin:
        row, col = xy_to_cell(positions, Hm, Wm)
        return wall_grid[row, col] == 1
    hit = torch.zeros(positions.shape[:-1], dtype=torch.bool,
                      device=positions.device)
    for dx in (-margin, margin):
        for dy in (-margin, margin):
            off = torch.tensor([dx, dy], dtype=positions.dtype,
                               device=positions.device)
            row, col = xy_to_cell(positions + off, Hm, Wm)
            hit = hit | (wall_grid[row, col] == 1)
    return hit


def apply_projection(x: torch.Tensor, P: torch.Tensor, alpha, stats: NormStats,
                     *, observation_dim: int, action_dim: int, state_dim: int,
                     wall_grid: Optional[torch.Tensor] = None,
                     wall_margin: Optional[float] = None) -> torch.Tensor:
    """Project (B, H, obs+act) onto the dynamics subspace and blend by alpha
    in physical space; with ``wall_grid``, rows the projection moved into a
    wall revert to their unprojected values (projection.py:130-194)."""
    horizon = x.shape[1]
    obs_norm = x[..., :observation_dim]
    act_norm = x[..., observation_dim:]
    states_norm = obs_norm[..., :state_dim]
    rest_obs = obs_norm[..., state_dim:]

    s_mean, s_std = stats.obs_mean[:state_dim], stats.obs_std[:state_dim]
    states_phys = states_norm * s_std + s_mean
    actions_phys = act_norm * stats.action_std + stats.action_mean

    xc = to_concatenated(states_phys, actions_phys)
    xc = alpha * (xc @ P) + (1.0 - alpha) * xc
    new_states, new_actions = from_concatenated(xc, horizon, state_dim,
                                                action_dim)
    if wall_grid is not None:
        keep = ~wall_violation_mask(new_states[..., :2], wall_grid,
                                    margin=wall_margin)
        new_states = torch.where(keep[..., None], new_states, states_phys)
        new_actions = torch.where(keep[..., None], new_actions, actions_phys)

    states_norm = (new_states - s_mean) / s_std
    act_norm = (new_actions - stats.action_mean) / stats.action_std
    return torch.cat([states_norm, rest_obs, act_norm], dim=-1)


def projection_residual(x: torch.Tensor, P: torch.Tensor, stats: NormStats, *,
                        observation_dim: int, action_dim: int,
                        state_dim: int) -> torch.Tensor:
    """Mean-squared dynamics violation ||tau - P tau||^2 in physical space,
    the ProjectionLoss integrand (projection.py:197-217)."""
    states_norm = x[..., :state_dim]
    act_norm = x[..., observation_dim:]
    states_phys = states_norm * stats.obs_std[:state_dim] \
        + stats.obs_mean[:state_dim]
    actions_phys = act_norm * stats.action_std + stats.action_mean
    xc = to_concatenated(states_phys, actions_phys)
    return ((xc - xc @ P) ** 2).mean()
