"""Data-driven linear system identification by least squares (numpy).

Counterpart of the JAX package's dynamics/data_driven.py
(extract_transitions_from_episodes :17, fit_linear_dynamics :49,
identify_dynamics_from_data :93), for pre-loaded episodes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from dadiff_tpu_torch.datasets.sources import Episode


def extract_transitions_from_episodes(
    episodes: Sequence[Episode], max_trajectories: int = 1000
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Episodes -> stacked (s_t, a_t, s_{t+1}) (data_driven.py:17-38)."""
    states, actions, next_states = [], [], []
    for ep in episodes[:max_trajectories]:
        obs = np.asarray(ep["observations"], dtype=np.float32)
        act = np.asarray(ep["actions"], dtype=np.float32)
        T = min(len(act), len(obs) - 1)
        if T <= 0:
            continue
        states.append(obs[:T])
        actions.append(act[:T])
        next_states.append(obs[1: T + 1])
    if not states:
        raise ValueError("No transitions found")
    return np.concatenate(states), np.concatenate(actions), np.concatenate(next_states)


def fit_linear_dynamics(states, actions, next_states,
                        state_dim: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares x_{t+1} = A x_t + B u_t on the first ``state_dim``
    dims (data_driven.py:49-87)."""
    states = np.asarray(states, dtype=np.float64)
    actions = np.asarray(actions, dtype=np.float64)
    next_states = np.asarray(next_states, dtype=np.float64)
    if state_dim is not None and states.shape[1] > state_dim:
        states = states[:, :state_dim]
        next_states = next_states[:, :state_dim]
    n = states.shape[1]
    Theta, *_ = np.linalg.lstsq(np.hstack([states, actions]), next_states,
                                rcond=None)
    return Theta[:n].T, Theta[n:].T


def identify_dynamics_from_data(episodes: Sequence[Episode],
                                state_dim: Optional[int] = None,
                                max_trajectories: int = 1000
                                ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Episodes -> (A, B, state_dim, action_dim) (data_driven.py:93-111)."""
    states, actions, next_states = extract_transitions_from_episodes(
        episodes, max_trajectories)
    if state_dim is None:
        state_dim = states.shape[1]
    A, B = fit_linear_dynamics(states, actions, next_states, state_dim)
    return A, B, state_dim, actions.shape[1]
