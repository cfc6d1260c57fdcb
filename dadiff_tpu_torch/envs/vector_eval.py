"""Batched host-env evaluation: N gymnasium episodes in lockstep, one batched
replan per wave.

Counterpart of the JAX package's envs/vector_eval.py,
evaluate_policy_batched :31-260 without its warm-start and inverse-dynamics
branches (not ported: a policy that asks for them is refused). Episodes are
seeded per env (seed + i), so results are not episode for episode those of
the sequential protocol (envs/host.py). Best of N: each replan samples
N * K plans in one batched call and keeps the best per env under
``policy.candidate_scorer``; with a policy wired to the planner chain
(``--megakernel``) a replan is one wave of N * K chains, selection included.
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
    observations with the goal, len(obs) = len(act) + 1)."""
    for attr in ("inverse_dynamics", "warm_start_t", "warm_start_auto"):
        if getattr(policy, attr, None):
            raise NotImplementedError(f"evaluate_policy_batched: {attr} is "
                                      "not ported")
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
    # the buffer starts at row 0, whose action the conditioning zeroed
    n_buffered = min(policy.action_horizon + 1, horizon)

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
    step = 0
    while step < max_steps and not done.all():
        # one batched replan for all envs, finished or not
        processed = np.concatenate(
            [policy._process_observation(o) for o in obs_list], axis=0)
        normed = policy.normalizer.normalize_observations(processed)
        if n_cand > 1:
            tiled = np.repeat(normed, n_cand, axis=0)
            cond = conditions_for_initial_obs_np(tiled, obs_dim, horizon,
                                                 trans_dim)
            all_trajs = policy._plan(policy._generator, cond, policy._P,
                                     policy._stats).reshape(
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
            trajs = policy._plan(policy._generator, cond, policy._P,
                                 policy._stats)
        actions_norm = trajs.detach().cpu().numpy()[:, :n_buffered, a0:a1]

        for j in range(n_buffered):
            if step >= max_steps or done.all():
                break
            acts = policy.normalizer.unnormalize_actions(
                actions_norm[:, j].reshape(n_episodes, -1))
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
