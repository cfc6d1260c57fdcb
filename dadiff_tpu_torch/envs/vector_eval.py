"""Batched host-env evaluation: N gymnasium episodes in lockstep, one batched
replan per wave.

Counterpart of the JAX package's envs/vector_eval.py,
evaluate_policy_batched :31-260. Episodes are
seeded per env (seed + i), so results are not episode for episode those of
the sequential protocol (envs/host.py). Best of N: each replan samples
N * K plans in one batched call and keeps the best per env under
``policy.candidate_scorer``; with a policy wired to the planner chain
(``--megakernel``) a replan is one wave of N * K chains, selection included.
With warm start (``policy.warm_start_t`` or ``warm_start_auto``) every wave
after the first re-noises the previous wave's selected plans, shifted by
the actions executed since (vector_eval.py:87-160).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from dadiff_tpu_torch.guides.sampling import conditions_for_initial_obs_np


def evaluate_policy_batched(policy, env_name: str, n_episodes: int = 10,
                            max_steps: int = 300, seed: int = 42,
                            env_kwargs: Optional[dict] = None,
                            verbose: bool = True,
                            record_episodes: bool = False) -> Dict[str, Any]:
    """Run ``n_episodes`` host-env episodes in lockstep with batched replans
    (vector_eval.py:31-260), reusing the policy's sampler.

    With ``record_episodes=True`` the executed transitions come back under
    ``metrics["recorded_episodes"]`` in the npz schema (processed
    observations with the goal, len(obs) = len(act) + 1).

    With ``policy.inverse_dynamics`` the actions come from consecutive
    planned states, one batched call per replan, or, with
    ``track_planned_states``, one batched call per lockstep step from the
    observed states toward the planned next states (vector_eval.py:
    161-205).

    With ``policy.warm_start_t`` (``policy._plan_warm``) a wave re-noises
    the previous wave's selected plans, shifted by the actions executed
    since and their last row repeated, to the chain's steps below K; with
    ``policy.warm_start_auto`` the lockstep envs share one K per wave, from
    the 90th percentile of the live envs' drift (``policy._k_from_drift``),
    or the full chain where that gives None (vector_eval.py:87-160)."""
    import gymnasium as gym

    try:
        import gymnasium_robotics  # noqa: F401  (registers PointMaze)
    except ImportError:
        pass

    envs = [gym.make(env_name, **(env_kwargs or {})) for _ in range(n_episodes)]
    obs_list = [env.reset(seed=seed + i)[0] for i, env in enumerate(envs)]

    horizon = policy.horizon
    obs_dim, act_dim = policy.observation_dim, policy.action_dim
    trans_dim = policy.transition_dim
    a0, a1 = obs_dim, obs_dim + act_dim
    # the buffer starts at row 0, whose action the conditioning zeroed, or
    # at row 1 with skip_conditioned_action (vector_eval.py:71-72)
    start_t = 1 if policy.skip_conditioned_action else 0
    n_buffered = min(policy.action_horizon + 1, horizon) - start_t

    total_reward = np.zeros(n_episodes)
    lengths = np.zeros(n_episodes, dtype=int)
    success = np.zeros(n_episodes, dtype=bool)
    done = np.zeros(n_episodes, dtype=bool)

    if record_episodes:
        rec_obs = [[np.ravel(policy._process_observation(o)).astype(np.float32)]
                   for o in obs_list]
        rec_act = [[] for _ in range(n_episodes)]
        rec_rew = [[] for _ in range(n_episodes)]

    n_cand = max(1, getattr(policy, "n_candidates", 1))
    warm_plan = getattr(policy, "_plan_warm", None)
    warm_auto = bool(getattr(policy, "warm_start_auto", False))
    use_warm = warm_plan is not None or warm_auto
    prev_trajs = None  # (N, H, D) the last wave's selected plans
    prev_shift = 0  # env steps executed since prev_trajs were planned
    step = 0
    while step < max_steps and not done.all():
        # one batched replan for all envs, finished or not
        processed = np.concatenate(
            [policy._process_observation(o) for o in obs_list], axis=0)
        normed = policy.normalizer.normalize_observations(processed)
        x_init, plan_fn = None, policy._plan
        if use_warm and prev_trajs is not None and prev_shift < horizon:
            x_init = np.concatenate(
                [prev_trajs[:, prev_shift:],
                 np.repeat(prev_trajs[:, -1:], prev_shift, axis=1)],
                axis=1) if prev_shift > 0 else prev_trajs
            if warm_auto:
                # one K per wave, from the live envs' 90th-percentile drift
                shift_row = min(prev_shift, horizon - 1)
                drifts = np.linalg.norm(
                    normed - prev_trajs[:, shift_row, :obs_dim], axis=-1)
                live = ~done
                d90 = (float(np.percentile(drifts[live], 90)) if live.any()
                       else 0.0)
                k = policy._k_from_drift(d90)
                if k is None:
                    x_init = None  # the drift is too large: full chain
                else:
                    plan_fn = policy._auto_warm_sampler(k)
            else:
                plan_fn = warm_plan
        if n_cand > 1:
            tiled = np.repeat(normed, n_cand, axis=0)
            cond = conditions_for_initial_obs_np(tiled, obs_dim, horizon,
                                                 trans_dim)
            kw = ({} if x_init is None
                  else {"x_init": np.repeat(x_init, n_cand, axis=0)})
            all_trajs = plan_fn(policy._generator, cond, policy._P,
                                policy._stats, **kw).reshape(
                n_episodes, n_cand, horizon, trans_dim)
            normed_t = torch.as_tensor(normed, device=all_trajs.device)
            scores = torch.stack([policy.candidate_scorer(all_trajs[i],
                                                          normed_t[i])
                                  for i in range(n_episodes)])
            best = torch.argmin(scores, dim=1)
            trajs = all_trajs[torch.arange(n_episodes, device=best.device),
                              best]
        else:
            cond = conditions_for_initial_obs_np(normed, obs_dim, horizon,
                                                 trans_dim)
            kw = {} if x_init is None else {"x_init": x_init}
            trajs = plan_fn(policy._generator, cond, policy._P,
                            policy._stats, **kw)
        trajs = trajs.detach().cpu().numpy()
        if use_warm:
            prev_trajs = trajs
        inverse = policy.inverse_dynamics
        if inverse is not None:
            # actions from consecutive planned states (one batched call)
            stop_t = min(start_t + n_buffered, horizon - 1)
            obs_rows = policy.normalizer.unnormalize_observations(
                trajs[:, start_t:stop_t + 1, :obs_dim].reshape(-1, obs_dim)
            ).reshape(n_episodes, -1, obs_dim)
            planned_next = obs_rows[:, 1:]
            n_exec = planned_next.shape[1]
            if not policy.track_planned_states:
                inv_acts = np.asarray(inverse(
                    obs_rows[:, :-1].reshape(-1, obs_dim),
                    planned_next.reshape(-1, obs_dim))).reshape(
                    n_episodes, -1, act_dim)
        else:
            actions_norm = trajs[:, start_t:start_t + n_buffered, a0:a1]
            n_exec = n_buffered

        for j in range(n_exec):
            if step >= max_steps or done.all():
                break
            if inverse is None:
                acts = policy.normalizer.unnormalize_actions(
                    actions_norm[:, j].reshape(n_episodes, -1))
            elif policy.track_planned_states:
                # u_t = g(s_observed, s_planned_next), done envs included
                cur = np.concatenate(
                    [policy._process_observation(o) for o in obs_list],
                    axis=0)
                acts = np.asarray(inverse(cur, planned_next[:, j])).reshape(
                    n_episodes, -1)
            else:
                acts = inv_acts[:, j]
            for i, env in enumerate(envs):
                if done[i]:
                    continue
                action = np.ravel(acts[i])
                obs, reward, terminated, truncated, info = env.step(action)
                obs_list[i] = obs
                total_reward[i] += float(reward)
                lengths[i] += 1
                if record_episodes:
                    rec_act[i].append(action.astype(np.float32))
                    rec_rew[i].append(np.float32(reward))
                    rec_obs[i].append(np.ravel(
                        policy._process_observation(obs)).astype(np.float32))
                if isinstance(info, dict) and info.get("success"):
                    success[i] = True
                done[i] = done[i] | bool(terminated) | bool(truncated)
            step += 1
        prev_shift = n_exec

    for env in envs:
        env.close()
    if verbose:
        for i in range(n_episodes):
            print(f"Episode {i + 1}: reward={total_reward[i]:.2f} "
                  f"length={lengths[i]} success={bool(success[i])}")

    metrics = {
        "mean_reward": float(total_reward.mean()),
        "std_reward": float(total_reward.std()),
        "mean_length": float(lengths.mean()),
        "std_length": float(lengths.std()),
        "success_rate": float(success.mean()),
        "episode_rewards": total_reward.tolist(),
        "episode_lengths": lengths.tolist(),
        "episode_success": success.tolist(),
    }
    if record_episodes:
        metrics["recorded_episodes"] = [
            {"observations": np.stack(rec_obs[i]),
             "actions": np.stack(rec_act[i]) if rec_act[i]
             else np.zeros((0, act_dim), np.float32),
             "rewards": np.asarray(rec_rew[i], np.float32)}
            for i in range(n_episodes)]
    return metrics
