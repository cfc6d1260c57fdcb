"""Host (gymnasium) evaluation: the reference protocol's env loop.

Counterpart of the JAX package's envs/host.py: make_env :19, evaluate_policy
:40 and save_results :109. Seeded env, at most ``max_steps`` steps per
episode, mean and std of reward and length, per-episode lists, success from
PointMaze's ``info['success']``, and the timestamped results JSON with the
same keys. gymnasium is imported inside the functions that need it, never
when the package is imported.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np


def make_env(env_name: str, render: str = "none", **env_kwargs):
    """A gymnasium env (host.py:19-37); rendering is not ported, so
    ``render`` must be 'none'."""
    if render != "none":
        raise NotImplementedError(f"render={render!r} is not ported")
    import gymnasium as gym

    try:
        import gymnasium_robotics  # noqa: F401  (registers PointMaze)
    except ImportError:
        pass
    return gym.make(env_name, **env_kwargs)


def evaluate_policy(policy, env, n_episodes: int = 10, max_steps: int = 1000,
                    verbose: bool = True) -> Dict[str, Any]:
    """Run ``n_episodes`` episodes one after another (host.py:40-106).
    Seeding is the caller's: seed the env's stream once with
    ``env.reset(seed=...)`` before the call, and the resets here continue
    it."""
    episode_rewards, episode_lengths, episode_success = [], [], []
    for episode in range(n_episodes):
        obs, info = env.reset()
        if hasattr(policy, "reset"):
            policy.reset()
        done = False
        total_reward, length = 0.0, 0
        success = False
        if verbose and isinstance(obs, dict) and "desired_goal" in obs:
            goal_pos = np.asarray(obs["desired_goal"])
            start = np.asarray(obs["observation"])[:2]
            print(f"Episode {episode + 1}: start={start}, goal={goal_pos}, "
                  f"dist={np.linalg.norm(start - goal_pos):.3f}")
        while not done and length < max_steps:
            action = policy.get_action(obs)
            obs, reward, terminated, truncated, info = env.step(action)
            done = bool(terminated) or bool(truncated)
            total_reward += float(reward)
            length += 1
            if isinstance(info, dict) and info.get("success"):
                success = True
        episode_rewards.append(total_reward)
        episode_lengths.append(length)
        episode_success.append(success)
        if verbose:
            print(f"Episode {episode + 1}: reward={total_reward:.2f} "
                  f"length={length} success={success}")
    return {
        "mean_reward": float(np.mean(episode_rewards)),
        "std_reward": float(np.std(episode_rewards)),
        "mean_length": float(np.mean(episode_lengths)),
        "std_length": float(np.std(episode_lengths)),
        "success_rate": float(np.mean(episode_success)),
        "episode_rewards": episode_rewards,
        "episode_lengths": episode_lengths,
        "episode_success": episode_success,
    }


def save_results(metrics: Dict[str, Any], *, policy_type: str, env_name: str,
                 results_dir: str = "./results",
                 checkpoint: Optional[str] = None,
                 dataset: Optional[str] = None, n_episodes: int = 10,
                 sampling_timesteps: Optional[int] = None, seed: int = 42,
                 extra: Optional[Dict[str, Any]] = None) -> str:
    """Write the timestamped results JSON (host.py:109-145); returns its
    path."""
    os.makedirs(results_dir, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    safe_env = env_name.replace("/", "_").replace("-", "_")
    filepath = os.path.join(results_dir,
                            f"{policy_type}_{safe_env}_{timestamp}.json")
    results = {
        "policy_type": policy_type,
        "environment": env_name,
        "checkpoint": checkpoint,
        "dataset": dataset,
        "n_episodes": n_episodes,
        "sampling_timesteps": sampling_timesteps,
        "seed": seed,
        "timestamp": timestamp,
        "metrics": {
            "mean_reward": metrics["mean_reward"],
            "std_reward": metrics["std_reward"],
            "mean_length": metrics["mean_length"],
            "std_length": metrics["std_length"],
            "success_rate": metrics.get("success_rate"),
            "episode_rewards": [float(r) for r in metrics["episode_rewards"]],
            "episode_lengths": [int(n) for n in metrics["episode_lengths"]],
        },
    }
    if extra:
        results.update(extra)
    with open(filepath, "w") as f:
        json.dump(results, f, indent=2)
    return filepath
