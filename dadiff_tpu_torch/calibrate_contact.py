"""Calibrate the PointMaze wall contact against host MuJoCo.

Counterpart of the JAX package's scripts/calibrate_contact.py: transitions
of the real gymnasium-robotics PointMaze under a wall-seeking random policy
are replayed one step through the port's ``envs/pointmaze_jax.PointMazeJax``
(disc contact) at each ``wall_slack`` of a grid, and the velocity and
position errors near walls and in free space are reported; the best slack
minimises the near-wall velocity error's p95.

    python -m dadiff_tpu_torch.calibrate_contact --map medium \\
        --n-transitions 3000 --device cpu

Collecting needs gymnasium and gymnasium_robotics (absent on the card's
machine, so run it where they are, with ``--device cpu``); the replay runs
on ``--device``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

ENV_NAMES = {
    "umaze": "PointMaze_UMaze-v3",
    "medium": "PointMaze_Medium-v3",
    "large": "PointMaze_Large-v3",
}


def collect_host_transitions(env_name, n, seed=0):
    """(s, a, s') stacks of ``n`` real-env transitions under a policy that
    holds a random heading for 12 steps (calibrate_contact.py:32-61)."""
    import gymnasium as gym
    import gymnasium_robotics  # noqa: F401  (registers PointMaze envs)

    env = gym.make(env_name)
    rng = np.random.RandomState(seed)
    out = []
    obs, _ = env.reset(seed=seed)
    heading = rng.uniform(-1, 1, 2)
    k = 0
    while len(out) < n:
        if k % 12 == 0:
            heading = rng.uniform(-1, 1, 2)
            heading /= max(1e-6, np.abs(heading).max())
        k += 1
        s = np.asarray(obs["observation"], np.float32)
        a = np.clip(heading + rng.randn(2) * 0.2, -1, 1).astype(np.float32)
        obs, _, term, trunc, _ = env.step(a)
        out.append((s, a, np.asarray(obs["observation"], np.float32)))
        if term or trunc:
            obs, _ = env.reset(seed=seed + k)
    env.close()
    s, a, s2 = map(np.stack, zip(*out))
    return s, a, s2


def wall_distance(maze: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Distance from the agent disc's edge to the nearest wall box."""
    from dadiff_tpu_torch.envs.pointmaze_jax import AGENT_RADIUS

    Hm, Wm = maze.shape
    rows, cols = np.nonzero(maze == 1)
    lo = np.stack([cols - Wm / 2.0, Hm / 2.0 - (rows + 1)], axis=-1)
    q = np.clip(pos[:, None, :], lo[None], lo[None] + 1.0)
    return np.linalg.norm(pos[:, None, :] - q, axis=-1).min(axis=1) \
        - AGENT_RADIUS


def score_slacks(s, a, s2, map_name: str, slacks, near_wall_dist: float,
                 device="cpu") -> dict:
    """Per slack, one env step of every transition's start state and
    action against the real next state (calibrate_contact.py:105-139)."""
    import torch

    from dadiff_tpu_torch.envs.pointmaze_jax import (
        PointMazeJax,
        PointMazeState,
    )

    near = wall_distance(PointMazeJax(map_name=map_name).maze,
                         s[:, :2]) < near_wall_dist
    print(f"near-wall transitions: {int(near.sum())}/{len(s)}")
    n = len(s)
    state = PointMazeState(
        pos=torch.as_tensor(s[:, :2], device=device),
        vel=torch.as_tensor(s[:, 2:], device=device),
        goal=torch.zeros(n, 2, device=device),
        t=torch.zeros(n, dtype=torch.int32, device=device),
        done=torch.zeros(n, dtype=torch.bool, device=device))
    results = {}
    for slack in slacks:
        env = PointMazeJax(map_name=map_name, collision="disc",
                           wall_slack=float(slack))
        with torch.no_grad():
            nxt, *_ = env.step(state, torch.as_tensor(a, device=device))
        pred = torch.cat([nxt.pos, nxt.vel], dim=-1).cpu().numpy()
        err_v = np.linalg.norm(pred[:, 2:] - s2[:, 2:], axis=-1)
        err_p = np.linalg.norm(pred[:, :2] - s2[:, :2], axis=-1)
        results[slack] = {
            "vel_err_mean_near": float(err_v[near].mean()),
            "vel_err_p95_near": float(np.percentile(err_v[near], 95)),
            "pos_err_p95_near": float(np.percentile(err_p[near], 95)),
            "vel_err_mean_free": float(err_v[~near].mean()),
        }
        print(f"slack={slack:.3f}: " + json.dumps(results[slack]), flush=True)
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Calibrate the PointMaze wall "
                                            "contact against host MuJoCo")
    p.add_argument("--map", type=str, default="medium",
                   choices=list(ENV_NAMES))
    p.add_argument("--n-transitions", type=int, default=3000)
    p.add_argument("--slacks", type=float, nargs="+",
                   default=[0.0, 0.01, 0.02, 0.03, 0.04, 0.06])
    p.add_argument("--near-wall-dist", type=float, default=0.35,
                   help="distance from the agent DISC EDGE to the nearest "
                        "wall box below which a transition counts as "
                        "near-wall")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from dadiff_tpu_torch.cli import resolve_device

    device = resolve_device(args.device)
    env_name = ENV_NAMES[args.map]
    print(f"collecting {args.n_transitions} host transitions on {env_name}...",
          flush=True)
    s, a, s2 = collect_host_transitions(env_name, args.n_transitions,
                                        seed=args.seed)
    results = score_slacks(s, a, s2, args.map, args.slacks,
                           args.near_wall_dist, device)
    best = min(results, key=lambda k: results[k]["vel_err_p95_near"])
    print(f"\nbest slack on {args.map} by near-wall vel p95: {best} "
          f"(current default 0.02)")
    return results


if __name__ == "__main__":
    main()
