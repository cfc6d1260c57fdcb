"""What the reference derives from the data file: the limits normaliser,
the least-squares dynamics (A, B), the projector P = F F+ onto
dynamics-consistent trajectories, and the DDPM schedule.

The recipes are the published ones (Janner et al.'s limits normaliser to
[-1, 1]; x_{t+1} = A x_t + B u_t fitted by least squares; the cosine
schedule of Nichol and Dhariwal), computed here in NumPy from the episodes.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np


def load_episodes(path: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(observations, actions) of every episode of an ``obs_i``/``act_i``
    npz file, in index order."""
    with np.load(path) as data:
        n = int(data["n_episodes"])
        return [(np.asarray(data[f"obs_{i}"], np.float32),
                 np.asarray(data[f"act_{i}"], np.float32)) for i in range(n)]


class Stats(NamedTuple):
    """x_norm = (x - mean) / std, for observations and for actions."""

    obs_mean: np.ndarray
    obs_std: np.ndarray
    act_mean: np.ndarray
    act_std: np.ndarray


def _limits(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lo, hi = data.min(axis=0), data.max(axis=0)
    mean = ((hi + lo) / np.float32(2.0)).astype(np.float32)
    std = ((hi - lo) / np.float32(2.0)).astype(np.float32)
    std = np.where(std < 1e-7, np.float32(1.0), std)
    return mean, np.maximum(std, np.float32(1e-8)).astype(np.float32)


def limits_stats(episodes, max_path_length: int = 1000) -> Stats:
    """Midpoint and half-range of every step an episode takes (its
    observations up to its last action), so that the data maps to
    [-1, 1]."""
    obs, act = [], []
    for o, a in episodes:
        T = min(len(a), max_path_length)
        obs.append(o[:T])
        act.append(a[:T])
    return Stats(*_limits(np.concatenate(obs)), *_limits(np.concatenate(act)))


def fit_dynamics(episodes, state_dim: int, max_trajectories: int = 1000):
    """Least-squares x_{t+1} = A x_t + B u_t on the first ``state_dim``
    observation dimensions, in float64."""
    s, u, s1 = [], [], []
    for o, a in episodes[:max_trajectories]:
        T = min(len(a), len(o) - 1)
        if T <= 0:
            continue
        s.append(o[:T, :state_dim])
        u.append(a[:T])
        s1.append(o[1:T + 1, :state_dim])
    s, u, s1 = (np.concatenate(v).astype(np.float64) for v in (s, u, s1))
    theta, *_ = np.linalg.lstsq(np.hstack([s, u]), s1, rcond=None)
    return theta[:state_dim].T, theta[state_dim:].T


def projector(A: np.ndarray, B: np.ndarray, horizon: int) -> np.ndarray:
    """P = F F+ for the basis F = [[A_bar, C], [0, I]] of trajectories
    [x_0 .. x_T, u_0 .. u_{T-1}] (the final state repeated), float64."""
    n, m = B.shape
    T = horizon
    F = np.zeros(((T + 1) * n + T * m, n + T * m))
    power = np.eye(n)
    for t in range(T + 1):
        F[t * n:(t + 1) * n, :n] = power
        power = power @ A
    AkB = [B]
    for _ in range(T - 1):
        AkB.append(A @ AkB[-1])
    for t in range(1, T + 1):
        for tau in range(t):
            F[t * n:(t + 1) * n, n + tau * m:n + (tau + 1) * m] = \
                AkB[t - tau - 1]
    F[(T + 1) * n:, n:] = np.eye(T * m)
    return F @ np.linalg.pinv(F)


class Schedule(NamedTuple):
    """The per-step coefficients of the reverse chain, float32."""

    betas: np.ndarray
    sqrt_recip_acp: np.ndarray
    sqrt_recipm1_acp: np.ndarray
    coef1: np.ndarray
    coef2: np.ndarray
    log_var: np.ndarray


def cosine_schedule(T: int, s: float = 0.008) -> Schedule:
    x = np.linspace(0, T, T + 1, dtype=np.float64)
    acp = np.cos(((x / T) + s) / (1 + s) * math.pi * 0.5) ** 2
    acp = acp / acp[0]
    betas = np.clip(1.0 - acp[1:] / acp[:-1], 0.0001, 0.9999)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.concatenate([np.ones(1), acp[:-1]])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    return Schedule(
        f32(betas), f32(np.sqrt(1.0 / acp)), f32(np.sqrt(1.0 / acp - 1.0)),
        f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        f32(np.log(np.clip(post_var, 1e-20, None))))
