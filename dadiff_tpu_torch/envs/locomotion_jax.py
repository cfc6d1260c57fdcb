"""Batched gymnasium-v5 locomotion envs on the exact planar physics, and the
on-device plan -> step -> replan loop over them.

Counterpart of the JAX package's envs/locomotion_jax.py: PlanarGymEnv
:31-128, HalfCheetahJax / HopperJax / Walker2dJax :130-160, PHYSICS_ENVS,
physics_env_for :168, make_physics_step_fn :176 and
make_physics_locomotion_evaluator :198-292. The module keeps its
counterpart's name so that a reader finds it.

State is (qpos, qvel), each (B, nq) on one device. The gym semantics are
the JAX package's: observations exclude the current x and clip qvel to
``VEL_CLIP`` (Hopper, Walker2d; the state keeps the true qvel),
``obs_to_state`` sets rootx to 0 (dynamics and reward do not depend on x),
the forward reward is the x delta over the whole frame skip, and each env
has its own healthy test. Resets reproduce ``gym.make(env).reset(seed=s)``
from the committed model's ``init_qpos``, ``init_qvel`` and noise constants
with numpy's generator, seeded as gymnasium seeds it, so no gymnasium is
needed.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dadiff_tpu_torch.envs.planar_physics import (
    PlanarPhysics,
    load_planar_model,
)
from dadiff_tpu_torch.parallel.mesh import batch_rows, gather_rows, local_rows


class PlanarGymEnv:
    """Batched gymnasium-v5 locomotion env on exact physics
    (locomotion_jax.py:31-128). Subclasses set ENV_NAME, FRAME_SKIP, the
    reward constants and ``healthy``, and VEL_CLIP where gym clips qvel in
    the observation."""

    ENV_NAME: str = ""
    FRAME_SKIP: int = 5
    CTRL_COST: float = 0.1
    FWD_WEIGHT: float = 1.0
    HEALTHY_REWARD: float = 0.0
    VEL_CLIP: Optional[float] = None

    def __init__(self, solver_iters: int = 100, solver: str = "pgs",
                 search_model: bool = False):
        """``search_model=True`` takes the cheaper rollout model (the contact
        set of ``planar_physics.SEARCH_GEOMS``, 2-edge friction pyramids);
        keep the exact model for anything whose returns are quoted."""
        self.model = load_planar_model(self.ENV_NAME, search=search_model)
        self.phys = PlanarPhysics(self.model, solver_iters=solver_iters,
                                  solver=solver,
                                  pyramid_edges=2 if search_model else 4)
        self.dt = self.model.timestep * self.FRAME_SKIP
        self.nq = self.model.nv
        self.obs_dim = 2 * self.model.nv - 1
        self.act_dim = self.model.nu

    # -- obs <-> state ---------------------------------------------------

    def obs_to_state(self, obs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs (..., 2nq-1) -> (qpos (..., nq), qvel (..., nq)); rootx = 0."""
        nq = self.nq
        qpos = torch.cat([obs.new_zeros(obs.shape[:-1] + (1,)),
                          obs[..., :nq - 1]], dim=-1)
        return qpos, obs[..., nq - 1:]

    def state_to_obs(self, qpos: torch.Tensor, qvel: torch.Tensor
                     ) -> torch.Tensor:
        if self.VEL_CLIP is not None:
            qvel = torch.clamp(qvel, -self.VEL_CLIP, self.VEL_CLIP)
        return torch.cat([qpos[..., 1:], qvel], dim=-1)

    # -- resets ------------------------------------------------------------

    def reset_state(self, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """The (qpos, qvel) of ``gym.make(ENV_NAME).reset(seed=seed)``, in
        float64: gymnasium seeds ``np.random.Generator(PCG64(
        SeedSequence(seed)))`` and its ``reset_model`` draws qpos's noise,
        then qvel's."""
        m = self.model
        rng = np.random.default_rng(seed)
        scale = m.reset_noise_scale
        qpos = m.init_qpos + rng.uniform(low=-scale, high=scale, size=m.nv)
        if m.reset_qvel_normal:
            qvel = m.init_qvel + scale * rng.standard_normal(m.nv)
        else:
            qvel = m.init_qvel + rng.uniform(low=-scale, high=scale,
                                             size=m.nv)
        return qpos, qvel

    def reset_obs(self, seeds: Sequence[int]) -> np.ndarray:
        """Observations (len(seeds), obs_dim), float64, of one reset per
        seed."""
        rows = []
        for s in seeds:
            qpos, qvel = self.reset_state(int(s))
            if self.VEL_CLIP is not None:
                qvel = np.clip(qvel, -self.VEL_CLIP, self.VEL_CLIP)
            rows.append(np.concatenate([qpos[1:], qvel]))
        return np.stack(rows)

    # -- env semantics ---------------------------------------------------

    def healthy(self, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
        """gymnasium-v5's is_healthy, True = keep going; here never done."""
        return torch.ones(qpos.shape[:-1], dtype=torch.bool,
                          device=qpos.device)

    def step(self, qpos, qvel, action):
        """One env step of a single env (locomotion_jax.py:89-101): qpos
        (nq,), qvel (nq,), action (nu,) -> (qpos, qvel, obs, reward, done),
        as :meth:`step_batch` computes them for a batch of one."""
        out = self.step_batch(qpos[None], qvel[None], action[None])
        return tuple(o[0] for o in out)

    def step_batch(self, qpos, qvel, action):
        """One env step of every env: (qpos, qvel, obs, reward, done), each
        batched (locomotion_jax.py:91-104). The forward reward is the x
        delta over the full frame skip over dt, the control cost is on the
        action, the healthy bonus is paid while alive, and an unhealthy
        state is done."""
        x0 = qpos[:, 0]
        qpos, qvel = self.phys.env_step(qpos, qvel, action, self.FRAME_SKIP)
        x_vel = (qpos[:, 0] - x0) / self.dt
        healthy = self.healthy(qpos, qvel)
        reward = (self.FWD_WEIGHT * x_vel
                  + self.HEALTHY_REWARD * healthy
                  - self.CTRL_COST * (action ** 2).sum(-1))
        return qpos, qvel, self.state_to_obs(qpos, qvel), reward, ~healthy

    def rollout(self, qpos0, qvel0, actions):
        """Open-loop rollout, no termination masking: actions (B, K, nu) ->
        (obs (B, K, obs_dim), rewards (B, K)) (locomotion_jax.py:110-128)."""
        qp, qv = qpos0, qvel0
        obs, rew = [], []
        for k in range(actions.shape[1]):
            qp, qv, o, r, _ = self.step_batch(qp, qv, actions[:, k])
            obs.append(o)
            rew.append(r)
        return torch.stack(obs, dim=1), torch.stack(rew, dim=1)


class HalfCheetahJax(PlanarGymEnv):
    ENV_NAME = "HalfCheetah-v5"
    FRAME_SKIP = 5
    CTRL_COST = 0.1
    HEALTHY_REWARD = 0.0


class HopperJax(PlanarGymEnv):
    ENV_NAME = "Hopper-v5"
    FRAME_SKIP = 4
    CTRL_COST = 1e-3
    HEALTHY_REWARD = 1.0
    VEL_CLIP = 10.0

    def healthy(self, qpos, qvel):
        z, angle = qpos[..., 1], qpos[..., 2]
        state = torch.cat([qpos[..., 2:], qvel], dim=-1)
        return ((z > 0.7) & (angle.abs() < 0.2)
                & (state.abs() < 100.0).all(-1))


class Walker2dJax(PlanarGymEnv):
    ENV_NAME = "Walker2d-v5"
    FRAME_SKIP = 4
    CTRL_COST = 1e-3
    HEALTHY_REWARD = 1.0
    VEL_CLIP = 10.0

    def healthy(self, qpos, qvel):
        z, angle = qpos[..., 1], qpos[..., 2]
        return (z > 0.8) & (z < 2.0) & (angle.abs() < 1.0)


PHYSICS_ENVS = {
    "halfcheetah": HalfCheetahJax,
    "hopper": HopperJax,
    "walker": Walker2dJax,
}


def physics_env_for(env_name: str, **kwargs) -> PlanarGymEnv:
    key = env_name.lower()
    for name, cls in PHYSICS_ENVS.items():
        if name in key:
            return cls(**kwargs)
    raise ValueError(f"no exact-physics env for {env_name}")


def make_physics_step_fn(env: PlanarGymEnv):
    """``(obs (..., d), act (..., m)) -> next_obs`` over any leading batch
    axes, through the exact physics (locomotion_jax.py:176-195)."""

    def step_fn(obs, act):
        lead = obs.shape[:-1]
        qpos, qvel = env.obs_to_state(obs.reshape(-1, obs.shape[-1]))
        _, _, nobs, _, _ = env.step_batch(qpos, qvel,
                                          act.reshape(-1, act.shape[-1]))
        return nobs.reshape(lead + (nobs.shape[-1],))

    return step_fn


class PhysicsSim:
    """The locomotion evaluator's simulator on exact physics: the state is
    (qpos, qvel), observed through the env's gym semantics."""

    def __init__(self, env: PlanarGymEnv):
        self.env = env

    def from_obs(self, obs: torch.Tensor) -> List[torch.Tensor]:
        return list(self.env.obs_to_state(obs))

    def observe(self, state: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.env.state_to_obs(*state)

    def step(self, state, act):
        """(next state, reward, done) of one env step of every env."""
        qpos, qvel, _, reward, done = self.env.step_batch(*state, act)
        return [qpos, qvel], reward, done


class LocomotionEvaluator:
    """``evaluate(generator, stats, init_obs, *, noise=None) -> (mean_return,
    mean_length, returns)``: ``n_replans`` replans of a batch of envs on a
    simulator ``sim`` (:class:`PhysicsSim`, or the learned simulator of
    envs/learned_model.py). Each replan normalizes the observation,
    conditions row 0 on it, plans through ``guides/sampling.py``
    ``make_sampler`` (the module path: the JAX evaluators plan through XLA,
    not through a kernel), takes the actions at ``[start_t, start_t +
    action_horizon)``, un-normalizes them and steps the simulator once per
    action. A done env freezes: its reward and length are masked and its
    state held.

    ``sim`` gives ``from_obs(obs) -> state`` (a list of (B, ...) tensors),
    ``observe(state) -> obs`` and ``step(state, act) -> (state, reward,
    done)``.

    On the card, with ``graph`` (the default there), the first replan runs
    from the host; the plan and one simulator step are then captured as two
    CUDA graphs, and every later replan copies its draws in, replays the
    plan and replays the step once per action, each time after copying that
    action into the step's input. The step's graph is the same size at any
    ``action_horizon``. Buffers and graphs are kept for the next call with
    the same batch size, dtype and ``stats``, so a second call replays from
    its first replan. ``timing`` holds the last call's times per replan
    (plan ms, steps ms): CUDA events on the card, host clock on the CPU;
    ``replayed`` whether each replan replayed the graphs.

    ``noise``: hook for tests; ``noise[k]`` = (init_noise (B, H, D),
    step_noise (S, B, H, D) or None) replaces replan k's draws, as the
    sampler's ``plan.draw`` takes them.

    ``mesh`` shards the envs over ``batch_axis`` (locomotion_jax.py:208 and
    :240-249): ``init_obs`` holds the global batch, which the axis must
    divide, and the ``noise`` hook is refused; each rank runs its rows,
    drawing for the global batch (parallel/mesh.py ``batch_rows``), and the
    ranks gather the returns, so every rank returns the unsharded run's."""

    def __init__(self, diffusion, sim, *, action_horizon: int = 8,
                 n_replans: int = 25, sampling_timesteps: Optional[int] = None,
                 sampler: str = "ddpm", skip_conditioned_action: bool = False,
                 graph: Optional[bool] = None, mesh=None,
                 batch_axis: str = "dp"):
        from dadiff_tpu_torch.guides.sampling import make_sampler

        self.diffusion, self.sim = diffusion, sim
        self.plan = make_sampler(diffusion,
                                 sampling_timesteps=sampling_timesteps,
                                 sampler=sampler)
        self.action_horizon, self.n_replans = action_horizon, n_replans
        # --skip-conditioned-action starts execution at plan row 1
        self.start_t = 1 if skip_conditioned_action else 0
        if self.start_t + action_horizon > diffusion.horizon:
            raise ValueError("action_horizon must fit in the planning horizon")
        self.graph = diffusion.device.type == "cuda" if graph is None \
            else graph
        if self.graph and diffusion.device.type != "cuda":
            raise ValueError("CUDA graphs need the card")
        self.timing: List[Tuple[float, float]] = []
        self.replayed: List[bool] = []
        self._loop: Optional[_Loop] = None
        self.mesh, self.batch_axis = mesh, batch_axis

    @torch.no_grad()
    def __call__(self, generator: Optional[torch.Generator], stats,
                 init_obs, *, noise=None):
        d = self.diffusion
        device = d.device
        obs = torch.as_tensor(init_obs, device=device)
        if obs.device != device:
            raise ValueError(f"init_obs on {obs.device}, the planner on "
                             f"{device}")
        mesh, axis = self.mesh, self.batch_axis
        if mesh is not None and noise is not None:
            raise ValueError("the noise hook is for one device")
        obs = local_rows(obs, mesh, axis)
        B = obs.shape[0]
        loop = self._loop
        if loop is None or not loop.fits(B, obs.dtype, stats):
            loop = self._loop = _Loop(self, stats, obs)

        def draws(k):
            if noise is not None:
                return noise[k]
            with batch_rows(mesh, axis):
                return self.plan.draw(generator, B)

        loop.reset(obs, draws(0))
        cuda = device.type == "cuda"
        self.timing, self.replayed = [], []
        for k in range(self.n_replans):
            if k:
                loop.set_draws(draws(k))
            self.replayed.append(loop.graphs is not None)
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
            else:
                t0 = time.perf_counter()
            loop.run_plan()
            if cuda:
                ev[1].record()
            else:
                t1 = time.perf_counter()
            for j in range(self.action_horizon):
                loop.run_step(j)
            if cuda:
                ev[2].record()
                self.timing.append(ev)
            else:
                self.timing.append(((t1 - t0) * 1e3,
                                    (time.perf_counter() - t1) * 1e3))
            if self.graph and loop.graphs is None and k + 1 < self.n_replans:
                loop.capture()
        if cuda:
            torch.cuda.synchronize(device)
            self.timing = [(a.elapsed_time(b), b.elapsed_time(c))
                           for a, b, c in self.timing]
        total, length = gather_rows((loop.totals[0], loop.totals[1]), mesh,
                                    axis)
        return total.mean(), length.mean(), total.clone()


class _Loop:
    """The fixed buffers of an evaluator's replans and, once captured, their
    two CUDA graphs: the simulator's ``state``, ``totals`` [total, length,
    alive], ``draws`` [init_noise, step_noise or None], the plan's actions
    ``acts`` (B, K, nu) and the step's input ``act`` (B, nu)."""

    def __init__(self, ev: LocomotionEvaluator, stats, obs: torch.Tensor):
        from dadiff_tpu_torch.guides.sampling import (
            conditions_for_initial_obs,
        )

        d, sim = ev.diffusion, ev.sim
        device = d.device
        od, ad = d.observation_dim, d.action_dim
        s, K = ev.start_t, ev.action_horizon
        B = obs.shape[0]
        self.B, self.dtype, self.stats, self.sim = B, obs.dtype, stats, sim
        self.state = [t.clone() for t in sim.from_obs(obs)]
        self.totals = [obs.new_zeros(B), obs.new_zeros(B),
                       torch.ones(B, dtype=torch.bool, device=device)]
        self.draws = None
        self.acts = torch.zeros(B, K, ad, dtype=torch.float32, device=device)
        self.act = torch.zeros(B, ad, dtype=torch.float32, device=device)
        self.graphs = None
        state, totals, acts, act = self.state, self.totals, self.acts, self.act

        def plan_part():
            obs = sim.observe(state)
            normed = (obs - stats.obs_mean) / stats.obs_std
            cond = conditions_for_initial_obs(normed, od, d.horizon,
                                              d.transition_dim)
            traj = ev.plan(None, cond, init_noise=self.draws[0],
                           step_noise=self.draws[1])
            acts.copy_(traj[:, s:s + K, od:od + ad] * stats.action_std
                       + stats.action_mean)

        def step_part():
            total, length, alive = totals
            new, reward, done = sim.step(state, act)
            new_alive = alive & ~done
            # a frozen env keeps its last state (a masked step)
            for buf, v in zip(state, new):
                buf.copy_(torch.where(new_alive.view((B,) + (1,) * (
                    v.dim() - 1)), v, buf))
            for buf, v in zip(totals, (total + reward * alive,
                                       length + alive, new_alive)):
                buf.copy_(v)

        self.plan_part, self.step_part = plan_part, step_part

    def fits(self, B: int, dtype: torch.dtype, stats) -> bool:
        return (B, dtype) == (self.B, self.dtype) and stats is self.stats

    def reset(self, obs: torch.Tensor, draws) -> None:
        """The initial states of ``obs`` (B, obs_dim) and replan 0's draws;
        returns and lengths to 0, every env alive."""
        for buf, v in zip(self.state, self.sim.from_obs(obs)):
            buf.copy_(v)
        for buf, v in zip(self.totals, (0, 0, True)):
            buf.fill_(v)
        self.set_draws(draws)

    def set_draws(self, draws) -> None:
        if self.draws is None:
            self.draws = [None if v is None else v.to(self.act.device).clone()
                          for v in draws]
            return
        for buf, v in zip(self.draws, draws):
            if buf is not None:
                buf.copy_(v)

    def run_plan(self) -> None:
        (self.graphs[0] if self.graphs else self.plan_part)()

    def run_step(self, j: int) -> None:
        self.act.copy_(self.acts[:, j])
        (self.graphs[1] if self.graphs else self.step_part)()

    def capture(self) -> None:
        self.graphs = (_capture(self.plan_part), _capture(self.step_part))


def _capture(fn):
    """Record ``fn`` in a CUDA graph; returns its replay."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    return graph.replay


def make_physics_locomotion_evaluator(diffusion, env: PlanarGymEnv,
                                      **kwargs) -> LocomotionEvaluator:
    """The exact-physics on-device evaluator (locomotion_jax.py:198-292):
    a :class:`LocomotionEvaluator` on ``PhysicsSim(env)``, keyword
    arguments as there."""
    return LocomotionEvaluator(diffusion, PhysicsSim(env), **kwargs)
