"""Episode sources: npz files and the synthetic PointMaze generator.

Counterpart of the JAX package's datasets/sources.py: flatten_observation :27,
generate_synthetic_episodes :157, load_episodes_npz :217 and load_episodes
:229 for the ``npz:`` and ``synthetic:`` specs (joined with ``+``), and
save_episodes_npz :205. The minari, gym, expert and mppi sources are not
ported yet.

Episodes are dicts ``{'observations': (T+1, obs_dim), 'actions': (T, m)}``
of float32 arrays; dict observations flatten to
``concat([observation, desired_goal])``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

Episode = Dict[str, np.ndarray]


def flatten_observation(obs: Any, include_goal: bool = True) -> np.ndarray:
    """Flatten a (possibly dict) observation to 1-D (sources.py:27-43)."""
    if isinstance(obs, dict):
        if "observation" in obs and "desired_goal" in obs and include_goal:
            return np.concatenate(
                [np.ravel(obs["observation"]), np.ravel(obs["desired_goal"])]
            ).astype(np.float32)
        if "observation" in obs:
            return np.ravel(obs["observation"]).astype(np.float32)
        if "achieved_goal" in obs:
            return np.ravel(obs["achieved_goal"]).astype(np.float32)
        return np.concatenate([np.ravel(v) for v in obs.values()]).astype(np.float32)
    return np.ravel(np.asarray(obs, dtype=np.float32))


def generate_synthetic_episodes(kind: str = "pointmaze", n_episodes: int = 64,
                                episode_len: int = 128, seed: int = 0,
                                dt: float = 0.1) -> List[Episode]:
    """PD-controlled double integrator steering to random goals; obs
    [x, y, vx, vy, gx, gy], actions [ax, ay] (sources.py:157-202)."""
    if kind not in ("pointmaze", "double_integrator"):
        raise ValueError(f"Unknown synthetic dataset kind: {kind}")
    rng = np.random.RandomState(seed)
    A = np.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32)
    B = np.array([[0.5 * dt**2, 0], [0, 0.5 * dt**2], [dt, 0], [0, dt]],
                 np.float32)
    episodes: List[Episode] = []
    for _ in range(n_episodes):
        x = np.concatenate([rng.uniform(-3, 3, 2),
                            rng.uniform(-0.5, 0.5, 2)]).astype(np.float32)
        goal = rng.uniform(-3, 3, 2).astype(np.float32)
        obs_list, act_list, rew_list = [], [], []
        for _ in range(episode_len):
            obs_list.append(np.concatenate([x, goal]))
            u = 1.2 * (goal - x[:2]) - 1.5 * x[2:]
            u = np.clip(u + rng.normal(0, 0.3, 2), -1, 1).astype(np.float32)
            act_list.append(u)
            x = A @ x + B @ u
            rew_list.append(np.exp(-np.linalg.norm(x[:2] - goal)))
        obs_list.append(np.concatenate([x, goal]))
        episodes.append({
            "observations": np.stack(obs_list).astype(np.float32),
            "actions": np.stack(act_list).astype(np.float32),
            "rewards": np.asarray(rew_list, dtype=np.float32),
        })
    return episodes


def save_episodes_npz(path: str, episodes: Sequence[Episode]) -> None:
    """Save episodes as one .npz of obs_i / act_i / rew_i arrays, the schema
    :func:`load_episodes_npz` reads (sources.py:205-214)."""
    arrays = {}
    for i, ep in enumerate(episodes):
        arrays[f"obs_{i}"] = ep["observations"]
        arrays[f"act_{i}"] = ep["actions"]
        if "rewards" in ep:
            arrays[f"rew_{i}"] = ep["rewards"]
    arrays["n_episodes"] = np.asarray(len(episodes))
    np.savez_compressed(path, **arrays)


def load_episodes_npz(path: str) -> List[Episode]:
    """Episodes saved as obs_i / act_i / rew_i arrays (sources.py:217-226)."""
    with np.load(path) as data:
        n = int(data["n_episodes"])
        episodes = []
        for i in range(n):
            ep = {"observations": data[f"obs_{i}"], "actions": data[f"act_{i}"]}
            if f"rew_{i}" in data:
                ep["rewards"] = data[f"rew_{i}"]
            episodes.append(ep)
    return episodes


def load_episodes(spec: str, **kwargs) -> List[Episode]:
    """Dispatch a dataset spec: 'npz:<path>' or
    'synthetic:<kind>[:n=<episodes>,T=<len>,seed=<s>]', joined with '+'
    (sources.py:229-309)."""
    if "+" in spec:
        episodes = []
        for part in spec.split("+"):
            episodes.extend(load_episodes(part, **kwargs))
        return episodes
    if spec.startswith("synthetic:"):
        parts = spec.split(":", 1)[1].split(":")
        opts = dict(p.split("=") for p in parts[1].split(",")) if len(parts) > 1 else {}
        return generate_synthetic_episodes(
            kind=parts[0],
            n_episodes=int(opts.get("n", kwargs.pop("n_episodes", 64))),
            episode_len=int(opts.get("T", kwargs.pop("episode_len", 128))),
            seed=int(opts.get("seed", kwargs.pop("seed", 0))),
        )
    if spec.startswith("npz:"):
        return load_episodes_npz(spec[len("npz:"):])
    raise NotImplementedError(
        f"dataset spec {spec!r}: only 'npz:' and 'synthetic:' are ported")
