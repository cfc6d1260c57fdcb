"""Env-facing planning policies with action buffering.

Counterpart of the JAX package's guides/policies.py: the scorers
goal_distance_scorer :36, make_goal_distance_scorer :52,
make_wall_penalty_scorer :73, make_velocity_scorer :106 and
velocity_scorer_for_env :123; GuidedPolicy :131 (the samplers, guidance
and warm start of ``__init__`` :135-282, ``_process_observation`` :285,
``plan`` :301, the warm-start depth ``_k_from_drift`` / ``_auto_warm_k`` /
``_auto_warm_sampler`` :341-362, ``_warm_init`` :364,
``_fill_action_buffer`` :381 with ``skip_conditioned_action``, inverse
dynamics and ``track_planned_states``, ``_deviated_from_plan`` and
``get_action`` :423-455 with ``replan_deviation``, ``reset`` :457);
MPCPolicy :464, ValueGuidedPolicy :476 (both guide flavours) and
DynamicsAwarePolicy :514 with ``parity_mode``. By default the executed
action of every replan starts at row 0, whose action the conditioning
zeroed (policies.py:381-421), as in the reference.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from dadiff_tpu_torch.datasets.sources import flatten_observation
from dadiff_tpu_torch.guides.sampling import (
    ProjectionSpec,
    conditions_for_initial_obs_np,
    make_sampler,
)
from dadiff_tpu_torch.ops.projection import NormStats, wall_violation_mask


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


def make_wall_penalty_scorer(obs_mean, obs_std, wall_grid,
                             penalty: float = 5.0,
                             margin: Optional[float] = None):
    """Physical-space goal distance plus ``penalty`` times the share of plan
    rows whose physical position lies in a wall cell (policies.py:73-103):
    among near-goal candidates the one that does not cut through a wall
    wins."""
    base = make_goal_distance_scorer(obs_mean, obs_std)
    grid = torch.as_tensor(np.asarray(wall_grid), dtype=torch.int32)
    mean2 = torch.as_tensor(np.asarray(obs_mean)[0:2], dtype=torch.float32)
    std2 = torch.as_tensor(np.asarray(obs_std)[0:2], dtype=torch.float32)

    def scorer(trajs: torch.Tensor, normed_obs: torch.Tensor) -> torch.Tensor:
        dev = trajs.device
        pos = trajs[:, :, 0:2] * std2.to(dev) + mean2.to(dev)
        bad = wall_violation_mask(pos, grid.to(dev), margin)
        return base(trajs, normed_obs) + penalty * bad.to(
            torch.float32).mean(dim=-1)

    return scorer


def make_velocity_scorer(vel_index: int):
    """Locomotion's scorer: the negative mean planned forward velocity,
    observation component ``vel_index`` (policies.py:106-118)."""

    def scorer(trajs: torch.Tensor, normed_obs: torch.Tensor) -> torch.Tensor:
        return -trajs[:, :, vel_index].mean(dim=-1)

    return scorer


VELOCITY_INDEX = {"halfcheetah": 8, "hopper": 5, "walker": 8}


def velocity_scorer_for_env(env_name: str):
    """The velocity scorer of a gymnasium v5 locomotion env
    (policies.py:123-128)."""
    key = env_name.lower()
    for name, idx in VELOCITY_INDEX.items():
        if name in key:
            return make_velocity_scorer(idx)
    raise ValueError(f"No velocity scorer for {env_name}")


class GuidedPolicy:
    """Conditioned sampling with action buffering (policies.py:131-461), on
    the diffusion module's device; ``seed`` seeds the policy's own
    ``torch.Generator`` there.

    ``sampler``, ``ddim_eta``, ``guide_fn`` / ``guide_weight`` configure
    guides/sampling.py's ``make_sampler``. ``warm_start_t=K``: every replan
    after an episode's first re-noises the previous plan, shifted by the
    actions executed since, to the chain's steps below K.
    ``warm_start_auto`` picks K at each replan from the drift between the
    observation and the plan row it should be on: the smallest K of a grid
    of 10 with sqrt(1 - abar_{K-1}) >= warm_auto_scale * drift /
    sqrt(obs_dim), else the full chain (policies.py:238-257).

    ``skip_conditioned_action`` starts the buffer at row 1.
    ``inverse_dynamics(s, s_next) -> a`` (physical space, batched) derives
    the actions from consecutive planned states; with
    ``track_planned_states`` the buffer holds the planned next states and
    each action is computed at execution time from the observed state.
    ``replan_deviation``: drop the buffer and replan once the observation is
    more than this normalized L2 distance from the plan row it should be
    on. ``candidate_scorer(trajs (N, H, D), normed_obs) -> (N,)``, lower is
    better, picks the best of ``n_candidates``; the default is the
    physical-space goal distance."""

    def __init__(self, diffusion, normalizer, action_horizon: Optional[int] = None,
                 sampling_timesteps: Optional[int] = None, seed: int = 0,
                 projection: Optional[ProjectionSpec] = None,
                 n_candidates: int = 1, guide_fn: Optional[Callable] = None,
                 guide_weight: float = 1.0, sampler: str = "ddpm",
                 ddim_eta: float = 0.0, warm_start_t: Optional[int] = None,
                 warm_start_auto: bool = False, warm_auto_scale: float = 4.0,
                 skip_conditioned_action: bool = False,
                 candidate_scorer: Optional[Callable] = None,
                 inverse_dynamics: Optional[Callable] = None,
                 track_planned_states: bool = False,
                 replan_deviation: Optional[float] = None):
        if warm_start_auto and warm_start_t is not None:
            raise ValueError("pass either warm_start_t or warm_start_auto")
        if track_planned_states and inverse_dynamics is None:
            raise ValueError("track_planned_states needs inverse_dynamics")
        self.diffusion = diffusion
        self.normalizer = normalizer
        self.device = diffusion.device
        self.horizon = diffusion.horizon
        self.observation_dim = diffusion.observation_dim
        self.action_dim = diffusion.action_dim
        self.transition_dim = diffusion.transition_dim
        self.action_horizon = action_horizon if action_horizon is not None else 1
        self.action_buffer: List[np.ndarray] = []
        self._actions_taken = 0  # env steps executed since _last_plan
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        # the whole build config: the planner chain and the warm samplers
        # (and a micro-batching server) rebuild the same sampler from it
        self._sampler_config = dict(
            diffusion=diffusion, guide_fn=guide_fn, guide_weight=guide_weight,
            projection=projection, sampling_timesteps=sampling_timesteps,
            sampler=sampler, ddim_eta=ddim_eta, warm_start_from=warm_start_t)
        cold = dict(self._sampler_config, warm_start_from=None)
        self._plan = make_sampler(**cold)
        self.warm_start_t = warm_start_t
        self._plan_warm = (make_sampler(**self._sampler_config)
                           if warm_start_t is not None else None)
        self.warm_start_auto = warm_start_auto
        self.warm_auto_scale = float(warm_auto_scale)
        self._warm_sigmas = np.sqrt(
            1.0 - diffusion.schedule.alphas_cumprod.cpu().numpy())
        self._warm_cache: dict = {}
        self._warm_enabled = warm_start_t is not None or warm_start_auto
        self.last_warm_k: Optional[int] = None
        self._last_plan: Optional[np.ndarray] = None  # normalized (1, H, D)
        self.skip_conditioned_action = skip_conditioned_action
        self.inverse_dynamics = inverse_dynamics
        self.track_planned_states = track_planned_states
        self.replan_deviation = replan_deviation
        self._planned_obs: List[np.ndarray] = []  # normalized, buffer-aligned
        self.n_candidates = max(1, n_candidates)
        if candidate_scorer is not None:
            self.candidate_scorer = candidate_scorer
        elif normalizer is not None:
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
        the normalized trajectory (1, H, D) (policies.py:301-339). A warm
        replan's candidates all re-noise the same shifted plan."""
        normed_obs = self.normalizer.normalize_observations(
            self._process_observation(observation))
        n = self.n_candidates
        tiled = np.repeat(normed_obs, n, axis=0) if n > 1 else normed_obs
        conditions = conditions_for_initial_obs_np(
            tiled, self.observation_dim, self.horizon, self.transition_dim)
        x_init = self._warm_init()
        warm_fn = self._plan_warm
        self.last_warm_k = self.warm_start_t if x_init is not None else None
        if x_init is not None and self.warm_start_auto:
            k = self._auto_warm_k(normed_obs)
            self.last_warm_k = k
            if k is None:
                x_init = None  # the drift is too large: full chain
            else:
                warm_fn = self._auto_warm_sampler(k)
        if x_init is not None:
            trajs = warm_fn(self._generator, conditions, self._P, self._stats,
                            x_init=x_init)
        else:
            trajs = self._plan(self._generator, conditions, self._P,
                               self._stats)
        if n > 1:
            scores = self.candidate_scorer(
                trajs, torch.as_tensor(normed_obs[0], device=trajs.device))
            trajs = trajs[torch.argmin(scores)][None]
        trajs = trajs.detach().cpu().numpy()
        if self._warm_enabled:
            self._last_plan = trajs
            self._actions_taken = 0
        return trajs

    def _k_from_drift(self, drift: float) -> Optional[int]:
        """The drift-matched warm depth (grid of 10), or None for the full
        chain (policies.py:341-349)."""
        target = self.warm_auto_scale * drift / np.sqrt(self.observation_dim)
        T = len(self._warm_sigmas)
        for k in range(10, T, 10):
            if self._warm_sigmas[k - 1] >= target:
                return k
        return None

    def _auto_warm_k(self, normed_obs) -> Optional[int]:
        shift = min(self._actions_taken, self.horizon - 1)
        row = self._last_plan[0][shift, : self.observation_dim]
        drift = float(np.linalg.norm(np.ravel(normed_obs) - row))
        return self._k_from_drift(drift)

    def _auto_warm_sampler(self, k: int):
        if k not in self._warm_cache:
            self._warm_cache[k] = make_sampler(
                **dict(self._sampler_config, warm_start_from=k))
        return self._warm_cache[k]

    def _warm_init(self) -> Optional[np.ndarray]:
        """The previous plan shifted by the executed steps, its last row
        repeated at the end; None when warm start is off, at an episode's
        first plan, or when nothing of the old plan remains
        (policies.py:364-379)."""
        if not self._warm_enabled or self._last_plan is None:
            return None
        shift = self._actions_taken
        if shift >= self.horizon:
            return None
        prev = self._last_plan[0]
        if shift == 0:
            return prev[None]
        return np.concatenate([prev[shift:], np.repeat(prev[-1:], shift, axis=0)],
                              axis=0)[None]

    def _fill_action_buffer(self, trajectory: np.ndarray) -> None:
        """Buffer the plan's actions from row 0, whose action the
        conditioning zeroed, or from row 1 with ``skip_conditioned_action``;
        from inverse dynamics, or the planned next states to track, where
        the policy has them (policies.py:381-421). The plan rows aligned
        with the buffer are kept for the deviation check."""
        traj = trajectory[0]
        a0, a1 = self.observation_dim, self.observation_dim + self.action_dim
        start = 1 if self.skip_conditioned_action else 0
        stop = min(self.action_horizon + 1, self.horizon)
        if self.inverse_dynamics is not None:
            stop = min(stop, self.horizon - 1)
            obs_rows = self.normalizer.unnormalize_observations(
                traj[start:stop + 1, : self.observation_dim])
            if self.track_planned_states:
                # actions come at execution time from the observed state
                self.action_buffer.extend(np.asarray(nxt)
                                          for nxt in obs_rows[1:])
            else:
                acts = np.asarray(self.inverse_dynamics(obs_rows[:-1],
                                                        obs_rows[1:]))
                self.action_buffer.extend(np.ravel(a) for a in acts)
        else:
            for t in range(start, stop):
                action = self.normalizer.unnormalize_actions(
                    traj[t, a0:a1].reshape(1, -1))
                self.action_buffer.append(np.ravel(action))
        self._planned_obs = [traj[start + i, : self.observation_dim]
                             for i in range(len(self.action_buffer))]

    def _deviated_from_plan(self, observation) -> bool:
        """True when the observation is more than ``replan_deviation``
        (normalized L2) from the plan row it should be on
        (policies.py:423-434)."""
        if self.replan_deviation is None or not self._planned_obs:
            return False
        cur = self.normalizer.normalize_observations(
            self._process_observation(observation))[0]
        return float(np.linalg.norm(cur - self._planned_obs[0])) \
            > self.replan_deviation

    def get_action(self, observation, **kwargs) -> np.ndarray:
        """Pop the buffer, replanning when it is empty or the observation
        left the plan (policies.py:436-455)."""
        if self.action_buffer and self._deviated_from_plan(observation):
            self.action_buffer.clear()
            self._planned_obs.clear()
        if not self.action_buffer:
            self._fill_action_buffer(self.plan(observation))
        self._actions_taken += 1
        if self._planned_obs:
            self._planned_obs.pop(0)
        item = self.action_buffer.pop(0)
        if self.track_planned_states:
            # u_t = g(s_observed, s_planned_next)
            obs_phys = self._process_observation(observation)
            return np.ravel(np.asarray(self.inverse_dynamics(obs_phys,
                                                             item[None])))
        return item

    def reset(self) -> None:
        """A new episode: the action buffer and the warm state go."""
        self.action_buffer.clear()
        self._last_plan = None
        self._actions_taken = 0
        self._planned_obs = []


class MPCPolicy(GuidedPolicy):
    """Plan once, execute ``action_horizon`` actions, replan
    (policies.py:464-473)."""

    def __init__(self, diffusion, normalizer, action_horizon: int = 8,
                 **kwargs):
        super().__init__(diffusion, normalizer, action_horizon=action_horizon,
                         **kwargs)


class ValueGuidedPolicy(GuidedPolicy):
    """Gradient guidance from a learned value (policies.py:476-511), one of
    two flavours: ``value_fn(obs (B, H, obs_dim)) -> (B, H)`` per-step
    values summed over the horizon, or ``trajectory_value_fn(x (B, H, D),
    t (B,)) -> (B,)``, the noisy-trajectory value net
    (models/value_net.py)."""

    def __init__(self, diffusion, normalizer,
                 value_fn: Optional[Callable] = None,
                 guide_weight: float = 1.0,
                 action_horizon: Optional[int] = None,
                 trajectory_value_fn: Optional[Callable] = None, **kwargs):
        obs_dim = diffusion.observation_dim
        if trajectory_value_fn is not None:
            guide_fn = trajectory_value_fn
        elif value_fn is not None:
            def guide_fn(x, t):
                return value_fn(x[:, :, :obs_dim]).sum(dim=1)
        else:
            raise ValueError("provide value_fn or trajectory_value_fn")
        super().__init__(diffusion, normalizer, guide_fn=guide_fn,
                         guide_weight=guide_weight,
                         action_horizon=action_horizon, **kwargs)
        self.value_fn = value_fn


class DynamicsAwarePolicy(GuidedPolicy):
    """Trajectories projected onto the dynamics-consistent subspace at every
    denoise step (policies.py:514-609); ``parity_mode`` samples without the
    projection, as the reference does. Other keywords go to GuidedPolicy
    (the sampler, warm start); guidance defaults to off."""

    def __init__(self, diffusion, projection_matrix, normalizer,
                 state_dim: int = 4, projection_schedule: str = "constant",
                 projection_strength: float = 1.0,
                 action_horizon: Optional[int] = None,
                 sampling_timesteps: Optional[int] = None,
                 parity_mode: bool = False, wall_grid=None,
                 wall_margin: Optional[float] = None, seed: int = 0,
                 n_candidates: int = 1, guide_fn: Optional[Callable] = None,
                 guide_weight: float = 0.0, **kwargs):
        if action_horizon is None:
            action_horizon = diffusion.horizon
        if wall_grid is not None:
            wall_grid = tuple(tuple(int(v) for v in row) for row in wall_grid)
        spec = ProjectionSpec(
            state_dim=state_dim, schedule=projection_schedule,
            strength=projection_strength, parity_mode=parity_mode,
            wall_grid=wall_grid, wall_margin=wall_margin,
        )
        super().__init__(diffusion, normalizer, action_horizon=action_horizon,
                         sampling_timesteps=sampling_timesteps, seed=seed,
                         projection=spec, n_candidates=n_candidates,
                         guide_fn=guide_fn, guide_weight=guide_weight, **kwargs)
        self.state_dim = state_dim
        self.parity_mode = parity_mode
        self.projection_matrix = projection_matrix
        self._P = torch.as_tensor(np.asarray(projection_matrix),
                                  dtype=torch.float32, device=self.device)
        self._stats = NormStats.from_normalizer(normalizer, self.device)
