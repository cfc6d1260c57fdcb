"""Env-facing planning policies with action buffering.

Counterpart of the JAX package's guides/policies.py: goal_distance_scorer :36,
make_goal_distance_scorer :52, the core of GuidedPolicy :131
(``_process_observation`` :285, ``plan`` :301, ``_fill_action_buffer`` :381,
``get_action`` :436, ``reset`` :457) and DynamicsAwarePolicy :514. The
executed action of every replan starts at row 0, whose action the
conditioning zeroed (policies.py:381-421), as in the reference. Warm start,
inverse dynamics, deviation replanning and value guidance are not ported
yet.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from dadiff_tpu_torch.datasets.sources import flatten_observation
from dadiff_tpu_torch.guides.sampling import (
    ProjectionSpec,
    conditions_for_initial_obs_np,
    make_sampler,
)
from dadiff_tpu_torch.ops.projection import NormStats


def goal_distance_scorer(trajs: torch.Tensor, normed_obs: torch.Tensor
                         ) -> torch.Tensor:
    """Normalized-space distance from the plan's final position (obs 0:2)
    to the goal (last two obs dims) (policies.py:36-49)."""
    obs_dim = normed_obs.shape[-1]
    goal = normed_obs[obs_dim - 2: obs_dim]
    return torch.linalg.norm(trajs[:, -1, 0:2] - goal[None], dim=-1)


def make_goal_distance_scorer(obs_mean, obs_std):
    """Physical-space goal distance, each block unnormalized with its own
    stats (policies.py:52-70)."""
    mean = torch.as_tensor(np.asarray(obs_mean), dtype=torch.float32)
    std = torch.as_tensor(np.asarray(obs_std), dtype=torch.float32)

    def scorer(trajs: torch.Tensor, normed_obs: torch.Tensor) -> torch.Tensor:
        m, s = mean.to(trajs.device), std.to(trajs.device)
        obs_dim = normed_obs.shape[-1]
        final_pos = trajs[:, -1, 0:2] * s[0:2] + m[0:2]
        goal = (normed_obs[obs_dim - 2: obs_dim] * s[obs_dim - 2: obs_dim]
                + m[obs_dim - 2: obs_dim])
        return torch.linalg.norm(final_pos - goal[None], dim=-1)

    return scorer


class GuidedPolicy:
    """Conditioned sampling with action buffering (policies.py:131-461), on
    the diffusion module's device; ``seed`` seeds the policy's own
    ``torch.Generator`` there."""

    def __init__(self, diffusion, normalizer, action_horizon: Optional[int] = None,
                 sampling_timesteps: Optional[int] = None, seed: int = 0,
                 projection: Optional[ProjectionSpec] = None,
                 n_candidates: int = 1):
        self.diffusion = diffusion
        self.normalizer = normalizer
        self.device = diffusion.device
        self.horizon = diffusion.horizon
        self.observation_dim = diffusion.observation_dim
        self.action_dim = diffusion.action_dim
        self.transition_dim = diffusion.transition_dim
        self.action_horizon = action_horizon if action_horizon is not None else 1
        self.action_buffer: List[np.ndarray] = []
        self._actions_taken = 0
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._sampler_config = dict(projection=projection,
                                    sampling_timesteps=sampling_timesteps)
        self._plan = make_sampler(diffusion, projection=projection,
                                  sampling_timesteps=sampling_timesteps)
        self.n_candidates = max(1, n_candidates)
        if normalizer is not None:
            self.candidate_scorer = make_goal_distance_scorer(
                normalizer.obs_mean, normalizer.obs_std)
        else:
            self.candidate_scorer = goal_distance_scorer
        self._P = None
        self._stats = None

    def _process_observation(self, observation) -> np.ndarray:
        """Flatten to (1, obs_dim) float32 (policies.py:285-298)."""
        if isinstance(observation, dict):
            if "observation" in observation and "desired_goal" in observation:
                state = np.ravel(observation["observation"])
                goal = np.ravel(observation["desired_goal"])
                expected = self.normalizer.obs_mean.shape[0]
                if expected == len(state) + len(goal):
                    observation = np.concatenate([state, goal])
                else:
                    observation = state
            else:
                observation = flatten_observation(observation)
        return np.asarray(observation, dtype=np.float32).reshape(1, -1)

    def plan(self, observation) -> np.ndarray:
        """One plan from the current observation, best of ``n_candidates``;
        the normalized trajectory (1, H, D) (policies.py:301-339)."""
        normed_obs = self.normalizer.normalize_observations(
            self._process_observation(observation))
        n = self.n_candidates
        tiled = np.repeat(normed_obs, n, axis=0) if n > 1 else normed_obs
        conditions = conditions_for_initial_obs_np(
            tiled, self.observation_dim, self.horizon, self.transition_dim)
        trajs = self._plan(self._generator, conditions, self._P, self._stats)
        if n > 1:
            scores = self.candidate_scorer(
                trajs, torch.as_tensor(normed_obs[0], device=trajs.device))
            trajs = trajs[torch.argmin(scores)][None]
        return trajs.detach().cpu().numpy()

    def _fill_action_buffer(self, trajectory: np.ndarray) -> None:
        """Buffer the plan's actions from row 0, whose action the
        conditioning zeroed (policies.py:381-421)."""
        traj = trajectory[0]
        a0, a1 = self.observation_dim, self.observation_dim + self.action_dim
        for t in range(min(self.action_horizon + 1, self.horizon)):
            action = self.normalizer.unnormalize_actions(traj[t, a0:a1].reshape(1, -1))
            self.action_buffer.append(np.ravel(action))

    def get_action(self, observation, **kwargs) -> np.ndarray:
        """Pop the buffer, replanning when it is empty (policies.py:436-455)."""
        if not self.action_buffer:
            self._fill_action_buffer(self.plan(observation))
        self._actions_taken += 1
        return self.action_buffer.pop(0)

    def reset(self) -> None:
        self.action_buffer.clear()
        self._actions_taken = 0


class DynamicsAwarePolicy(GuidedPolicy):
    """Trajectories projected onto the dynamics-consistent subspace at every
    denoise step (policies.py:514-609)."""

    def __init__(self, diffusion, projection_matrix, normalizer,
                 state_dim: int = 4, projection_schedule: str = "constant",
                 projection_strength: float = 1.0,
                 action_horizon: Optional[int] = None,
                 sampling_timesteps: Optional[int] = None, wall_grid=None,
                 wall_margin: Optional[float] = None, seed: int = 0,
                 n_candidates: int = 1):
        if action_horizon is None:
            action_horizon = diffusion.horizon
        if wall_grid is not None:
            wall_grid = tuple(tuple(int(v) for v in row) for row in wall_grid)
        spec = ProjectionSpec(
            state_dim=state_dim, schedule=projection_schedule,
            strength=projection_strength, wall_grid=wall_grid,
            wall_margin=wall_margin,
        )
        super().__init__(diffusion, normalizer, action_horizon=action_horizon,
                         sampling_timesteps=sampling_timesteps, seed=seed,
                         projection=spec, n_candidates=n_candidates)
        self.state_dim = state_dim
        self.projection_matrix = projection_matrix
        self._P = torch.as_tensor(np.asarray(projection_matrix),
                                  dtype=torch.float32, device=self.device)
        self._stats = NormStats.from_normalizer(normalizer, self.device)
