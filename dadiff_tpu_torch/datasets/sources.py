"""Episode sources: npz files, the synthetic PointMaze generator, gymnasium
rollouts, the waypoint and MPPI experts, and minari.

Counterpart of the JAX package's datasets/sources.py: flatten_observation :27,
minari_available :66, load_minari_episodes :75, collect_gym_episodes :106,
generate_synthetic_episodes :157, save_episodes_npz :205, load_episodes_npz
:217 and load_episodes :229, every spec of it (``synthetic:``, ``npz:``,
``gym:``, ``expert:``, ``mppi:`` and a minari name, joined with ``+``). The
gym, expert and mppi sources step gymnasium envs on the host and minari
loads its own datasets; each is imported where it is used, so the module
imports where they are absent. Where minari is absent a minari name raises
JAX's ImportError, which names the hermetic specs.

Episodes are dicts ``{'observations': (T+1, obs_dim), 'actions': (T, m)}``
of float32 arrays; dict observations flatten to
``concat([observation, desired_goal])``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

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


def _flatten_episode_observations(obs: Any, include_goal: bool) -> np.ndarray:
    """:func:`flatten_observation` over a whole episode (sources.py:46-60)."""
    if isinstance(obs, dict):
        if "observation" in obs and "desired_goal" in obs and include_goal:
            return np.concatenate(
                [np.asarray(obs["observation"]),
                 np.asarray(obs["desired_goal"])], axis=-1).astype(np.float32)
        if "observation" in obs:
            return np.asarray(obs["observation"], dtype=np.float32)
        if "achieved_goal" in obs:
            return np.asarray(obs["achieved_goal"], dtype=np.float32)
        n = len(next(iter(obs.values())))
        return np.concatenate([np.asarray(v).reshape(n, -1)
                               for v in obs.values()], axis=-1
                              ).astype(np.float32)
    return np.asarray(obs, dtype=np.float32)


def minari_available() -> bool:
    try:
        import minari  # noqa: F401

        return True
    except ImportError:
        return False


def load_minari_episodes(dataset_name: str,
                         max_episodes: Optional[int] = None,
                         include_goal: bool = True) -> List[Episode]:
    """A minari dataset in the episode format (sources.py:75-103)."""
    try:
        import minari
    except ImportError as e:
        raise ImportError(
            "minari is not installed in this image. Use a 'synthetic:*', "
            "'gym:*', or 'npz:<path>' dataset spec instead, or install minari."
        ) from e
    dataset = minari.load_dataset(dataset_name)
    episodes: List[Episode] = []
    for i, ep in enumerate(dataset):
        if max_episodes is not None and i >= max_episodes:
            break
        episode: Episode = {
            "observations": _flatten_episode_observations(
                ep.observations, include_goal).astype(np.float32),
            "actions": np.asarray(ep.actions, dtype=np.float32),
        }
        if getattr(ep, "rewards", None) is not None:
            episode["rewards"] = np.asarray(ep.rewards, dtype=np.float32)
        episodes.append(episode)
    return episodes


def collect_gym_episodes(env_name: str, n_episodes: int = 50,
                         max_steps: int = 300, policy=None, seed: int = 0,
                         include_goal: bool = True,
                         env_kwargs: Optional[dict] = None) -> List[Episode]:
    """Episodes of ``policy(obs)`` (default: the action space's own random
    draws) in a gymnasium env, episode i reset with ``seed + i``
    (sources.py:106-154)."""
    import gymnasium as gym

    try:  # registers PointMaze and the other robotics envs
        import gymnasium_robotics  # noqa: F401
    except ImportError:
        pass

    env = gym.make(env_name, **(env_kwargs or {}))
    episodes: List[Episode] = []
    for ep_idx in range(n_episodes):
        obs, _ = env.reset(seed=seed + ep_idx)
        obs_list = [flatten_observation(obs, include_goal)]
        act_list, rew_list = [], []
        for _ in range(max_steps):
            action = (env.action_space.sample() if policy is None
                      else policy(obs))
            obs, reward, terminated, truncated, _ = env.step(action)
            obs_list.append(flatten_observation(obs, include_goal))
            act_list.append(np.asarray(action, dtype=np.float32))
            rew_list.append(float(reward))
            if terminated or truncated:
                break
        episodes.append({
            "observations": np.stack(obs_list).astype(np.float32),
            "actions": np.stack(act_list).astype(np.float32),
            "rewards": np.asarray(rew_list, dtype=np.float32),
        })
    env.close()
    return episodes


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


def as_spec(path_or_spec: str) -> str:
    """A dataset spec as it is, or a bare npz path as ``npz:<path>`` (the
    bound scripts' ``--visited``)."""
    known = ("npz:", "synthetic:", "expert:", "mppi:", "gym:", "minari:")
    if path_or_spec.startswith(known) or "+" in path_or_spec:
        return path_or_spec
    return f"npz:{path_or_spec}"


def _spec_options(spec: str):
    """'<kind>:<name>[:k=v,...]' -> (name, {k: v})."""
    parts = spec.split(":", 1)[1].split(":")
    opts = dict(p.split("=") for p in parts[1].split(",")) if len(parts) > 1 else {}
    return parts[0], opts


def load_episodes(spec: str, **kwargs) -> List[Episode]:
    """Dispatch a dataset spec (sources.py:229-309):

        'synthetic:<kind>[:n=<episodes>,T=<len>,seed=<s>]'  hermetic generator
        'npz:<path>'                                        saved episodes
        'gym:<EnvName>[:n=<episodes>]'                      random policy
        'expert:<EnvName>[:n=,T=,noise=,seed=,corner_safe=1,lookahead=1]'
                                                            waypoint expert
        'mppi:<EnvName>[:n=<episodes>,T=<len>,seed=<s>]'    MPPI expert
        anything else                                       a minari name

    joined with '+' (the episode lists concatenated in order)."""
    if "+" in spec:
        episodes = []
        for part in spec.split("+"):
            episodes.extend(load_episodes(part, **kwargs))
        return episodes
    if spec.startswith("synthetic:"):
        kind, opts = _spec_options(spec)
        return generate_synthetic_episodes(
            kind=kind,
            n_episodes=int(opts.get("n", kwargs.pop("n_episodes", 64))),
            episode_len=int(opts.get("T", kwargs.pop("episode_len", 128))),
            seed=int(opts.get("seed", kwargs.pop("seed", 0))),
        )
    if spec.startswith("npz:"):
        return load_episodes_npz(spec[len("npz:"):])
    if spec.startswith("expert:"):
        from dadiff_tpu_torch.envs.expert import collect_expert_episodes

        name, opts = _spec_options(spec)
        return collect_expert_episodes(
            env_name=name,
            n_episodes=int(opts.get("n", kwargs.pop("n_episodes", 100))),
            max_steps=int(opts.get("T", kwargs.pop("max_steps", 300))),
            noise=float(opts.get("noise", kwargs.pop("noise", 0.2))),
            seed=int(opts.get("seed", kwargs.pop("seed", 0))),
            corner_safe=bool(int(opts.get("corner_safe",
                                          kwargs.pop("corner_safe", 0)))),
            lookahead=bool(int(opts.get("lookahead",
                                        kwargs.pop("lookahead", 0)))),
        )
    if spec.startswith("mppi:"):
        from dadiff_tpu_torch.envs.mppi_expert import collect_mppi_episodes

        name, opts = _spec_options(spec)
        return collect_mppi_episodes(
            env_name=name,
            n_episodes=int(opts.get("n", kwargs.pop("n_episodes", 40))),
            max_steps=int(opts.get("T", kwargs.pop("max_steps", 1000))),
            seed=int(opts.get("seed", kwargs.pop("seed", 0))),
        )
    if spec.startswith("gym:"):
        name, opts = _spec_options(spec)
        return collect_gym_episodes(
            name, n_episodes=int(opts.get("n", kwargs.pop("n_episodes", 50))),
            **kwargs)
    kwargs.setdefault("max_episodes", kwargs.pop("n_episodes", None))
    return load_minari_episodes(spec, **kwargs)
