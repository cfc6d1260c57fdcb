"""The plan -> step -> replan loop on one device.

Counterpart of the JAX package's envs/rollout.py: RolloutMetrics :29 and
make_ondevice_evaluator :37-265. There the whole loop is one jitted program
(two nested scans); here it is a Python loop over replans and env steps whose
every tensor stays on the device: the plans, the actions, the env state, the
rewards and the success flags. Nothing comes back to the host until the
caller reads the final metrics.

With ``use_megakernel`` a replan is one wave of the planner chain
(``ops/planner.py`` ``make_bo_sampler``, K2) over all envs and candidates:
its operands are prepared once per ``evaluate`` call, so the first wave is
driven from the host and captured in a CUDA graph and every later wave is a
replay. Otherwise a replan is a sampler of guides/sampling.py (the module
path: ddpm, ddim, dpmpp or consistency, with or without warm start), best
of ``n_candidates`` by physical-space goal distance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from dadiff_tpu_torch.envs.pointmaze_jax import (
    GOAL_THRESHOLD,
    PointMazeJax,
    PointMazeState,
)
from dadiff_tpu_torch.guides.sampling import (
    ProjectionSpec,
    conditions_for_initial_obs,
    make_sampler,
)
from dadiff_tpu_torch.ops.projection import NormStats

NOT_PORTED = ("is not ported yet (ROADMAP.md, Queue 1: parallelism, which "
              "brings the mesh)")


class RolloutMetrics(NamedTuple):
    success_rate: torch.Tensor       # () share of envs that reached the goal
    mean_reward: torch.Tensor        # () mean total reward per env
    mean_final_distance: torch.Tensor  # () mean distance to the goal at the end
    per_env_reward: Optional[torch.Tensor] = None   # (B,)
    per_env_success: Optional[torch.Tensor] = None  # (B,) bool


def make_ondevice_evaluator(
    diffusion,
    env: PointMazeJax,
    *,
    action_horizon: int = 8,
    n_replans: int = 16,
    sampling_timesteps: Optional[int] = None,
    projection: Optional[ProjectionSpec] = None,
    n_candidates: int = 1,
    warm_start_t: Optional[int] = None,
    sampler: str = "ddpm",
    mesh=None,
    use_megakernel: bool = False,
    P=None,
    stats: Optional[NormStats] = None,
    mega_group_chains: int = 64,
):
    """Build ``evaluate(generator, stats, batch_size, P=None, *, state=None,
    noise=None) -> (RolloutMetrics, final_state)``: ``n_replans`` plan-act
    cycles of ``action_horizon`` env steps for ``batch_size`` envs on the
    diffusion module's device (rollout.py:37-265).

    ``n_candidates > 1`` plans batch_size * n_candidates trajectories per
    replan and executes, per env, the one whose final position is closest
    to the goal. ``stats`` maps between the env's physical space and the
    model's normalized space. ``use_megakernel`` runs each replan through
    the planner chain, which bakes the projection from ``P`` and ``stats``
    at build time; its weights are bf16 on the card and f32 on the CPU, as
    the TPU path takes bf16 and its interpret mode f32. The chain is the
    DDPM sampler: with another ``sampler`` or with warm start it raises, as
    the JAX evaluator does (rollout.py:84-87); it runs a U-Net only, and
    raises for the transformer (``ops/planner.py`` ``make_bo_sampler``).

    ``warm_start_t=K``: the first replan runs the full chain; every later
    one re-noises the previous selected plan, shifted by ``action_horizon``
    and its last row repeated, and denoises only the chain's steps below K.

    Hooks for tests: ``state`` replaces the reset; ``noise`` gives replan k
    its randomness, ``noise[k]`` = (x0 (C*H, D), step_noise (S, C*H, D) or
    None). For the planner chain, C >= batch_size * n_candidates chains
    (padding included) and S = T, as the JAX wave draws them from
    ``init_key, noise_key = split(key)`` (pallas_planner.py:414-416). For
    the module path the first batch_size * n_candidates chains are taken:
    x0 is the sampler's ``init_noise`` and step_noise its ``step_noise``
    (S steps; None for a deterministic sampler; for consistency the
    re-noising draws), as guides/sampling.py draws them.
    """
    if mesh is not None:
        raise NotImplementedError(f"a device mesh {NOT_PORTED}")
    device = diffusion.device
    obs_dim = diffusion.observation_dim
    act_dim = diffusion.action_dim
    horizon = diffusion.horizon
    trans_dim = diffusion.transition_dim
    if use_megakernel and sampler != "ddpm":
        raise ValueError("--megakernel supports the ddpm sampler only")
    if use_megakernel and warm_start_t is not None:
        raise ValueError("--megakernel does not compose with warm start")
    if action_horizon > horizon:
        raise ValueError("action_horizon must be <= planning horizon")

    mega_plan = plan = plan_warm = None
    if use_megakernel:
        if projection is not None and not projection.parity_mode and (
                P is None or stats is None):
            raise ValueError("megakernel projection needs P and stats at "
                             "build time")
        from dadiff_tpu_torch.ops.planner import make_bo_sampler

        mega_plan = make_bo_sampler(
            diffusion, projection_spec=projection, P=P, stats=stats,
            n_candidates=n_candidates, group_chains=mega_group_chains,
            sampling_timesteps=sampling_timesteps,
            weight_dtype=(torch.float32 if device.type == "cpu"
                          else torch.bfloat16))
    else:
        plan = make_sampler(diffusion, projection=projection,
                            sampling_timesteps=sampling_timesteps,
                            sampler=sampler)
        if warm_start_t is not None:
            plan_warm = make_sampler(diffusion, projection=projection,
                                     sampling_timesteps=sampling_timesteps,
                                     sampler=sampler,
                                     warm_start_from=warm_start_t)

    def replan(generator, state, obs, stats, P, prepared, noise_k, x_init):
        normed_obs = (obs - stats.obs_mean) / stats.obs_std
        x0, step_noise = noise_k if noise_k is not None else (None, None)
        if mega_plan is not None:
            cond = conditions_for_initial_obs(normed_obs, obs_dim, horizon,
                                              trans_dim)
            return mega_plan(generator, cond, prepared, x0=x0,
                             step_noise=step_noise)
        B, N = normed_obs.shape[0], n_candidates
        tiled = normed_obs.repeat_interleave(N, dim=0) if N > 1 else normed_obs
        cond = conditions_for_initial_obs(tiled, obs_dim, horizon, trans_dim)
        if x0 is not None:
            x0 = x0.reshape(-1, horizon, trans_dim)[:B * N]
        if step_noise is not None:
            step_noise = step_noise.reshape(
                step_noise.shape[0], -1, horizon, trans_dim)[:, :B * N]
        if x_init is None:
            trajs = plan(generator, cond, P, stats, init_noise=x0,
                         step_noise=step_noise)
        else:
            trajs = plan_warm(generator, cond, P, stats,
                              x_init=x_init.repeat_interleave(N, dim=0),
                              init_noise=x0, step_noise=step_noise)
        if N == 1:
            return trajs
        # final predicted position against the goal in physical space: the
        # env state holds the physical goal exactly (rollout.py:195-208)
        trajs = trajs.reshape(B, N, horizon, trans_dim)
        final_pos = trajs[:, :, -1, 0:2] * stats.obs_std[0:2] \
            + stats.obs_mean[0:2]
        scores = torch.linalg.norm(final_pos - state.goal[:, None], dim=-1)
        best = torch.argmin(scores, dim=1)
        return trajs[torch.arange(B, device=trajs.device), best]

    @torch.no_grad()
    def evaluate(generator: Optional[torch.Generator], stats: NormStats,
                 batch_size: int, P=None, *,
                 state: Optional[PointMazeState] = None,
                 noise: Optional[Sequence[Tuple[torch.Tensor,
                                                Optional[torch.Tensor]]]] = None):
        prepared = mega_plan.prepare() if mega_plan is not None else None
        if state is None:
            state, obs = env.reset(generator, batch_size, device)
        else:
            obs = env.observation(state)
        total_reward = torch.zeros(batch_size, device=device)
        succeeded = torch.zeros(batch_size, dtype=torch.bool, device=device)
        traj = None
        for k in range(n_replans):
            x_init = None
            if plan_warm is not None and traj is not None:
                # the previous selected plan shifted by the executed steps,
                # its last row repeated (rollout.py:160-172)
                x_init = torch.cat(
                    [traj[:, action_horizon:],
                     traj[:, -1:].expand(-1, action_horizon, -1)], dim=1)
            traj = replan(generator, state, obs, stats, P, prepared,
                          None if noise is None else noise[k], x_init)
            # the next action_horizon actions in physical space, row 0's
            # (zeroed by the conditioning) included (rollout.py:217-220)
            acts = traj[:, :action_horizon, obs_dim:obs_dim + act_dim] \
                * stats.action_std + stats.action_mean
            for j in range(action_horizon):
                state, obs, reward, _ = env.step(state, acts[:, j])
                total_reward = total_reward + reward
                dist = torch.linalg.norm(state.pos - state.goal, dim=-1)
                succeeded = succeeded | (dist <= GOAL_THRESHOLD)
        final_dist = torch.linalg.norm(state.pos - state.goal, dim=-1)
        metrics = RolloutMetrics(
            success_rate=succeeded.to(torch.float32).mean(),
            mean_reward=total_reward.mean(),
            mean_final_distance=final_dist.mean(),
            per_env_reward=total_reward,
            per_env_success=succeeded,
        )
        return metrics, state

    # model calls of a replan: the first, and each later one
    first = (len(plan.timesteps) if plan is not None
             else sampling_timesteps or diffusion.n_timesteps)
    evaluate.model_calls = (first, len(plan_warm.timesteps)
                            if plan_warm is not None else first)
    return evaluate
