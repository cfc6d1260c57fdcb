"""Environment dynamics extractors: analytical, numerical, trajectory-fit.

Counterpart of the JAX package's dynamics/extractor.py
(double_integrator_dynamics :20, DynamicsExtractor :31,
AnalyticalDynamicsExtractor :84, NumericalDynamicsExtractor :94,
TrajectoryDynamicsExtractor :179, get_dynamics_extractor :227). Host-side
numpy set-up that runs once before training or evaluation, on a gymnasium
env (MuJoCo finite differences for the numerical method); its (A, B) feed
the ProjectionMatrixBuilder whose matrix the card applies. gymnasium,
gymnasium_robotics and mujoco are imported inside the functions that step
an env, so the module imports where they are absent (the card's machine);
only :func:`double_integrator_dynamics` runs there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dadiff_tpu_torch.dynamics.data_driven import (
    extract_transitions_from_episodes,
    fit_linear_dynamics,
)


def double_integrator_dynamics(dt: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """PointMaze-style double integrator (reference extractor.py:93-133)."""
    A = np.array(
        [[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float64
    )
    B = np.array(
        [[0.5 * dt**2, 0], [0, 0.5 * dt**2], [dt, 0], [0, dt]], dtype=np.float64
    )
    return A, B


class DynamicsExtractor:
    """Base: owns a gymnasium env and derives (state_dim, action_dim)
    (reference extractor.py:11-75, incl. Dict-space handling :42-49)."""

    def __init__(self, env_name: str):
        import gymnasium as gym

        try:
            import gymnasium_robotics  # noqa: F401  (registers PointMaze etc.)
        except ImportError:
            pass

        self.env_name = env_name
        self.env = gym.make(env_name)
        self.state_dim, self.action_dim = self._get_dimensions()

    def _get_dimensions(self) -> Tuple[int, int]:
        import gymnasium as gym

        space = self.env.action_space
        # Discrete spaces have shape () — not None — so check for both.
        if not getattr(space, "shape", None):
            raise ValueError(f"Cannot determine action dimension for {self.env_name}")
        action_dim = space.shape[0]

        obs_space = self.env.observation_space
        if isinstance(obs_space, gym.spaces.Dict):
            if "observation" not in obs_space.spaces:
                raise ValueError(
                    f"Dict observation space lacks 'observation': "
                    f"{list(obs_space.spaces)}"
                )
            state_dim = obs_space.spaces["observation"].shape[0]
        elif isinstance(obs_space, gym.spaces.Box):
            state_dim = obs_space.shape[0]
        else:
            raise ValueError(f"Unsupported observation space: {type(obs_space)}")
        return state_dim, action_dim

    def _extract_state(self, obs) -> np.ndarray:
        if isinstance(obs, dict):
            if "observation" not in obs:
                raise ValueError("Cannot extract state from dict observation")
            state = np.asarray(obs["observation"], dtype=np.float64)
            return state[: self.state_dim].copy()
        return np.asarray(obs, dtype=np.float64)[: self.state_dim].copy()

    def get_dynamics(
        self, linearization_point: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def close(self):
        self.env.close()


class AnalyticalDynamicsExtractor(DynamicsExtractor):
    """Known closed-form dynamics (maze envs -> double integrator,
    reference extractor.py:78-133)."""

    def get_dynamics(self, linearization_point=None):
        if "maze" in self.env_name.lower():
            return double_integrator_dynamics(dt=0.1)
        raise ValueError(f"No analytical dynamics available for {self.env_name}")


class NumericalDynamicsExtractor(DynamicsExtractor):
    """Finite-difference Jacobians around a linearization point
    (reference extractor.py:136-296; state injection via MuJoCo qpos/qvel)."""

    def _qpos_qvel_layout(self, mj_model) -> Tuple[int, int, int]:
        """(nq, nv, excluded) where ``excluded`` is the count of leading qpos
        coordinates absent from the observation (MuJoCo locomotion envs drop
        the root x — e.g. Hopper nq=6, nv=6, obs=11). Mirrors the reference's
        per-env injection (reference extractor.py:189-216) generically."""
        nq, nv = int(mj_model.nq), int(mj_model.nv)
        excluded = nq + nv - self.state_dim
        if excluded < 0 or excluded > nq:
            raise ValueError(
                f"{self.env_name}: cannot map state_dim={self.state_dim} onto "
                f"qpos({nq})/qvel({nv})"
            )
        return nq, nv, excluded

    def _set_state(self, state: np.ndarray):
        """Inject a flat observation-layout state into the simulator.

        The split point is derived from the MuJoCo model's nq/nv — NOT
        ``state_dim // 2``, which is wrong for odd-state envs (Hopper: 11 =
        qpos 5-visible + qvel 6). Leading excluded qpos coords (root x) keep
        their current simulator values.
        """
        # Maze envs wrap the simulated point mass in `point_env` — that inner
        # env owns set_state (gymnasium-robotics PointMazeEnv).
        unwrapped = self.env.unwrapped
        unwrapped = getattr(unwrapped, "point_env", unwrapped)
        mj_model = getattr(unwrapped, "model", None)
        state = np.asarray(state, dtype=np.float64)

        if hasattr(unwrapped, "set_state") and mj_model is not None:
            nq, nv, excluded = self._qpos_qvel_layout(mj_model)
            qpos = np.array(unwrapped.data.qpos, dtype=np.float64)
            qpos[excluded:] = state[: nq - excluded]
            qvel = state[nq - excluded : nq - excluded + nv]
            unwrapped.set_state(qpos, qvel)
        elif hasattr(unwrapped, "set_state"):
            n_qpos = self.state_dim // 2
            unwrapped.set_state(state[:n_qpos], state[n_qpos:])
        elif hasattr(unwrapped, "data") and mj_model is not None:
            nq, nv, excluded = self._qpos_qvel_layout(mj_model)
            unwrapped.data.qpos[excluded:] = state[: nq - excluded]
            unwrapped.data.qvel[:] = state[nq - excluded : nq - excluded + nv]
            import mujoco

            mujoco.mj_forward(mj_model, unwrapped.data)
        else:
            raise NotImplementedError(f"Cannot set state for {self.env_name}")

    def _step_dynamics(self, state: np.ndarray, action: np.ndarray) -> np.ndarray:
        self._set_state(state)
        obs, *_ = self.env.step(np.asarray(action, dtype=np.float32))
        return self._extract_state(obs)

    def get_dynamics(self, linearization_point=None, eps: float = 1e-4):
        obs, _ = self.env.reset(seed=0)  # gymnasium requires reset before step
        if linearization_point is None:
            linearization_point = self._extract_state(obs)
            if len(linearization_point) == 4:
                linearization_point[2:] = 0.0  # zero velocity (reference :157-159)

        x0 = np.asarray(linearization_point, dtype=np.float64)
        u0 = np.zeros(self.action_dim)
        x_nominal = self._step_dynamics(x0, u0)

        A = np.zeros((self.state_dim, self.state_dim))
        for i in range(self.state_dim):
            xp = x0.copy()
            xp[i] += eps
            A[:, i] = (self._step_dynamics(xp, u0) - x_nominal) / eps

        B = np.zeros((self.state_dim, self.action_dim))
        for i in range(self.action_dim):
            up = u0.copy()
            up[i] += eps
            B[:, i] = (self._step_dynamics(x0, up) - x_nominal) / eps
        return A, B


class TrajectoryDynamicsExtractor(DynamicsExtractor):
    """Least-squares fit from collected rollouts or a dataset
    (reference extractor.py:298-501)."""

    def get_dynamics(
        self,
        linearization_point=None,
        num_trajectories: int = 100,
        trajectory_length: int = 80,
        use_dataset: Optional[str] = None,
    ):
        if use_dataset is not None:
            try:
                from dadiff_tpu_torch.datasets.sources import load_episodes

                episodes = load_episodes(use_dataset)
                states, actions, next_states = extract_transitions_from_episodes(
                    episodes
                )
            except Exception as e:  # dataset unavailable -> collect rollouts
                print(f"Could not load dataset ({e}); collecting rollouts instead")
                states, actions, next_states = self._collect(
                    num_trajectories, trajectory_length
                )
        else:
            states, actions, next_states = self._collect(
                num_trajectories, trajectory_length
            )
        return fit_linear_dynamics(states, actions, next_states, self.state_dim)

    def _collect(self, num_traj: int, traj_len: int):
        all_s, all_a, all_ns = [], [], []
        for i in range(num_traj):
            obs, _ = self.env.reset(seed=i)
            state = self._extract_state(obs)
            for _ in range(traj_len):
                action = self.env.action_space.sample()
                next_obs, _, terminated, truncated, _ = self.env.step(action)
                next_state = self._extract_state(next_obs)
                all_s.append(state)
                all_a.append(np.asarray(action, dtype=np.float64))
                all_ns.append(next_state)
                state = next_state
                if terminated or truncated:
                    break
        return np.array(all_s), np.array(all_a), np.array(all_ns)


def get_dynamics_extractor(env_name: str, method: str = "auto") -> DynamicsExtractor:
    """Factory (reference extractor.py:505-530): 'auto' picks analytical for
    maze envs, trajectory-fit otherwise."""
    if method == "auto":
        method = "analytical" if "maze" in env_name.lower() else "trajectory"
    if method == "analytical":
        return AnalyticalDynamicsExtractor(env_name)
    if method == "numerical":
        return NumericalDynamicsExtractor(env_name)
    if method == "trajectory":
        return TrajectoryDynamicsExtractor(env_name)
    raise ValueError(f"Unknown method: {method}")
