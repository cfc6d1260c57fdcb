"""MPPI expert for locomotion data collection.

Counterpart of the JAX package's envs/mppi_expert.py (the reward models
:24-46, the termination models :49-62, MPPIController :81,
collect_mppi_episodes :177): model-predictive path integral control on the
env's own MuJoCo model, standing in for minari's expert datasets. It samples
action sequences from its own ``np.random.RandomState(seed)``, rolls them
out on a scratch ``MjData``, weights them exponentially by return, executes
the first action of the weighted mean, shifts and repeats.

Host-side numpy and MuJoCo (offline data generation, as dataset downloads
are); mujoco and gymnasium are imported inside the functions that use them.
The card takes the episodes through the ``npz:`` / ``mppi:`` dataset specs;
``envs/mppi_tpu.py`` is the planner that runs on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np


def _halfcheetah_reward(x_before, x_after, dt, action, obs):
    fwd = (x_after - x_before) / dt
    return fwd - 0.1 * float(np.sum(action**2))


def _hopper_reward(x_before, x_after, dt, action, obs):
    fwd = (x_after - x_before) / dt
    z, angle = obs[0], obs[1]
    healthy = (z > 0.7) and (abs(angle) < 0.2)
    return fwd + 1.0 * healthy - 1e-3 * float(np.sum(action**2))


def _walker_reward(x_before, x_after, dt, action, obs):
    fwd = (x_after - x_before) / dt
    z, angle = obs[0], obs[1]
    healthy = (0.8 < z < 2.0) and (abs(angle) < 1.0)
    return fwd + 1.0 * healthy - 1e-3 * float(np.sum(action**2))


_REWARD_MODELS: Dict[str, Callable] = {
    "halfcheetah": _halfcheetah_reward,
    "hopper": _hopper_reward,
    "walker": _walker_reward,
}


def _hopper_done(obs):
    # gymnasium Hopper-v5 is_healthy incl. healthy_state_range
    return not (
        obs[0] > 0.7 and abs(obs[1]) < 0.2 and bool(np.all(np.abs(obs[2:]) < 100))
    )


def _walker_done(obs):
    return not (0.8 < obs[0] < 2.0 and abs(obs[1]) < 1.0)


_DONE_MODELS: Dict[str, Callable] = {
    "halfcheetah": lambda obs: False,  # HalfCheetah never terminates
    "hopper": _hopper_done,
    "walker": _walker_done,
}


def _done_model_for(env_name: str) -> Callable:
    name = env_name.lower()
    for key, fn in _DONE_MODELS.items():
        if key in name:
            return fn
    raise ValueError(f"No MPPI termination model for {env_name}")


def _reward_model_for(env_name: str) -> Callable:
    name = env_name.lower()
    for key, fn in _REWARD_MODELS.items():
        if key in name:
            return fn
    raise ValueError(f"No MPPI reward model for {env_name}")


class MPPIController:
    """Model-predictive path-integral control on the env's own MuJoCo model.

    Args:
        env: a gymnasium MuJoCo env (HalfCheetah/Hopper/Walker2d v4/v5).
        horizon: planning horizon in control steps.
        n_samples: sampled action sequences per replan.
        lam: MPPI temperature.
        sigma: exploration std around the nominal sequence (actions in [-1,1]).
    """

    def __init__(
        self,
        env,
        horizon: int = 12,
        n_samples: int = 32,
        lam: float = 0.5,
        sigma: float = 0.4,
        seed: int = 0,
    ):
        import mujoco

        self._mujoco = mujoco
        u = env.unwrapped
        self.model = u.model
        self.frame_skip = int(getattr(u, "frame_skip", 5))
        self.dt = self.model.opt.timestep * self.frame_skip
        self.scratch = mujoco.MjData(self.model)
        self.act_dim = env.action_space.shape[0]
        self.horizon = horizon
        self.n_samples = n_samples
        self.lam = lam
        self.sigma = sigma
        if env.spec is None:
            raise ValueError(
                "MPPIController needs env.spec.id to pick its reward/"
                "termination model; pass an env created via gym.make"
            )
        self.reward_fn = _reward_model_for(env.spec.id)
        self.done_fn = _done_model_for(env.spec.id)
        self._rng = np.random.RandomState(seed)
        self.mean = np.zeros((horizon, self.act_dim))

    def reset(self):
        self.mean[:] = 0.0

    def act(self, env) -> np.ndarray:
        """Plan from the env's CURRENT simulator state and return one action."""
        mujoco = self._mujoco
        u = env.unwrapped
        qpos0 = np.array(u.data.qpos)
        qvel0 = np.array(u.data.qvel)

        noise = self._rng.randn(self.n_samples, self.horizon, self.act_dim)
        seqs = np.clip(self.mean[None] + self.sigma * noise, -1.0, 1.0)

        returns = np.zeros(self.n_samples)
        for k in range(self.n_samples):
            self.scratch.qpos[:] = qpos0
            self.scratch.qvel[:] = qvel0
            mujoco.mj_forward(self.model, self.scratch)
            total = 0.0
            for h in range(self.horizon):
                a = seqs[k, h]
                x_before = float(self.scratch.qpos[0])
                self.scratch.ctrl[:] = a
                for _ in range(self.frame_skip):
                    mujoco.mj_step(self.model, self.scratch)
                x_after = float(self.scratch.qpos[0])
                obs = np.concatenate(
                    [self.scratch.qpos[1:], self.scratch.qvel]
                )
                total += self.reward_fn(x_before, x_after, self.dt, a, obs)
                if self.done_fn(obs):
                    # terminate the rollout like the real env would — a
                    # candidate that dives forward and falls must not keep
                    # banking velocity reward for the rest of the horizon
                    # (the on-device engine masks this way, mppi_tpu.py)
                    break
            returns[k] = total

        w = np.exp((returns - returns.max()) / self.lam)
        w = w / w.sum()
        self.mean = np.einsum("k,khd->hd", w, seqs)
        action = self.mean[0].copy()
        # receding horizon: shift, repeat last
        self.mean = np.roll(self.mean, -1, axis=0)
        self.mean[-1] = self.mean[-2]
        return np.clip(action, -1.0, 1.0)


def collect_mppi_episodes(
    env_name: str,
    n_episodes: int = 40,
    max_steps: int = 1000,
    horizon: int = 12,
    n_samples: int = 32,
    seed: int = 0,
    verbose: bool = True,
) -> List[dict]:
    """Collect MPPI-expert episodes in the standard episode-dict format
    ({'observations': (T+1, d), 'actions': (T, m), 'rewards': (T,)})."""
    import gymnasium as gym

    env = gym.make(env_name)
    episodes = []
    for ep in range(n_episodes):
        ctrl = MPPIController(
            env, horizon=horizon, n_samples=n_samples, seed=seed + ep
        )
        obs, _ = env.reset(seed=seed + ep)
        obs_list, act_list, rew_list = [np.asarray(obs, np.float32)], [], []
        total = 0.0
        for _ in range(max_steps):
            a = ctrl.act(env)
            obs, r, terminated, truncated, _ = env.step(a.astype(np.float32))
            obs_list.append(np.asarray(obs, np.float32))
            act_list.append(a.astype(np.float32))
            rew_list.append(float(r))
            total += float(r)
            if terminated or truncated:
                break
        episodes.append({
            "observations": np.stack(obs_list),
            "actions": np.stack(act_list),
            "rewards": np.asarray(rew_list, np.float32),
        })
        if verbose:
            print(f"episode {ep + 1}/{n_episodes}: steps={len(act_list)} "
                  f"return={total:.1f}", flush=True)
    env.close()
    return episodes
