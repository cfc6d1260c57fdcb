"""Data-driven linear system identification by least squares (numpy).

Counterpart of the JAX package's dynamics/data_driven.py
(extract_transitions_from_episodes :17, fit_linear_dynamics :49,
extract_transitions :41, identify_dynamics_from_data :93), on pre-loaded
episodes or a dataset spec.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from dadiff_tpu_torch.datasets.sources import Episode, load_episodes


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


def extract_transitions(dataset_name: str, max_trajectories: int = 1000
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load a dataset spec and extract its transitions (data_driven.py:41-46)."""
    return extract_transitions_from_episodes(load_episodes(dataset_name),
                                             max_trajectories)


def fit_linear_dynamics(states, actions, next_states,
                        state_dim: Optional[int] = None, verbose: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares x_{t+1} = A x_t + B u_t on the first ``state_dim``
    dims (data_driven.py:49-87); the fit's R² is left in
    ``fit_linear_dynamics.last_r2``."""
    states = np.asarray(states, dtype=np.float64)
    actions = np.asarray(actions, dtype=np.float64)
    next_states = np.asarray(next_states, dtype=np.float64)
    if state_dim is not None and states.shape[1] > state_dim:
        states = states[:, :state_dim]
        next_states = next_states[:, :state_dim]
    n = states.shape[1]
    Phi = np.hstack([states, actions])
    Theta, *_ = np.linalg.lstsq(Phi, next_states, rcond=None)
    residuals = next_states - Phi @ Theta
    ss_res = float(np.sum(residuals ** 2))
    ss_tot = float(np.sum((next_states - next_states.mean(axis=0)) ** 2))
    fit_linear_dynamics.last_r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    if verbose:
        print(f"sysID: N={len(states)} n={n} m={actions.shape[1]} "
              f"R²={fit_linear_dynamics.last_r2:.4f} mean|err|="
              f"{np.mean(np.linalg.norm(residuals, axis=1)):.6f}")
    return Theta[:n].T, Theta[n:].T


fit_linear_dynamics.last_r2 = None


def identify_dynamics_from_data(episodes: Optional[Sequence[Episode]] = None,
                                state_dim: Optional[int] = None,
                                max_trajectories: int = 1000,
                                dataset_name: Optional[str] = None
                                ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Episodes, or the episodes of the spec ``dataset_name``, -> (A, B,
    state_dim, action_dim) (data_driven.py:93-111)."""
    if episodes is None:
        episodes = load_episodes(dataset_name)
    states, actions, next_states = extract_transitions_from_episodes(
        episodes, max_trajectories)
    if state_dim is None:
        state_dim = states.shape[1]
    A, B = fit_linear_dynamics(states, actions, next_states, state_dim)
    return A, B, state_dim, actions.shape[1]
