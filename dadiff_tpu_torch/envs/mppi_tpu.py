"""Batched MPPI over an on-device dynamics model (the learned simulator or
exact planar physics), and the data engine built on it: iterated expert
collection on real gymnasium envs and DAgger-style relabelling of a
policy's visited states.

Counterpart of the JAX package's envs/mppi_tpu.py: make_mppi_planner :34,
make_sim_step_fn :146, collect_mppi_tpu_episodes :157, _inject_state :339,
dagger_segment_starts :371, dagger_relabel_episodes :401 and
_collect_batch :565. The module keeps its counterpart's name so that a
reader finds it.

A replan evaluates ``n_samples`` candidate action sequences for each of B
envs (N * B lanes) over the horizon in one batched rollout on the card; on
the card it is replayed from a CUDA graph, one per batch size, captured
after its first host-driven call. The collection steps the real gymnasium
env on the host, one ``env.step`` per executed action, as in JAX: the
card's machine has no gymnasium, so there only the planner runs.

Kept as in JAX, so that the committed engine data stay reproducible: the
AR(1) carry of ``noise_beta`` starts at zero, so the first step of every
candidate's noise has a deviation of sqrt(1 - beta^2), not 1.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


class MPPIPlanner:
    """``plan(generator, obs (B, d), mean (B, H, m), *, noise=None) ->
    (actions (B, n_exec, m), new_mean (B, H, m))``: one MPPI replan
    (mppi_tpu.py:34-143).

    Candidates are ``clip(mean + sigma * noise, -1, 1)`` with noise (N, B,
    H, m) drawn from ``generator`` on the planner's device (or passed in,
    for tests), low-passed along the horizon by an AR(1) of coefficient
    ``noise_beta`` (unit stationary variance, carry starting at zero). Each
    is rolled out by ``step_fn`` from ``obs``; ``reward_done`` scores each
    step and a done candidate stops scoring and holds its state. With
    ``smooth_weight``, ``w * sum_t ||a_{t+1} - a_t||^2`` is subtracted from
    each return. The weights are a softmax over candidates of (return - the
    env's best) / ``lam``; the new mean is their weighted sum, the actions
    its first ``n_exec`` rows clipped, and the returned warm start that mean
    shifted by ``n_exec`` with its last row repeated. Reset an env's mean to
    zeros when it resets.

    On the card the first replan of a batch size runs from the host and is
    then captured in a CUDA graph over fixed buffers; later replans copy
    obs, mean and noise in and replay it. ``replayed`` says whether the
    last call replayed."""

    def __init__(self, step_fn: Callable, reward_done: Callable, *,
                 act_dim: int, horizon: int = 20, n_samples: int = 256,
                 lam: float = 0.3, sigma: float = 0.4, n_exec: int = 1,
                 noise_beta: float = 0.0, smooth_weight: float = 0.0,
                 device="cuda"):
        self.step_fn, self.reward_done = step_fn, reward_done
        self.act_dim, self.horizon, self.n_samples = act_dim, horizon, \
            n_samples
        self.lam, self.sigma, self.n_exec = lam, sigma, n_exec
        self.noise_beta, self.smooth_weight = noise_beta, smooth_weight
        self.device = torch.device(device)
        self.graph = self.device.type == "cuda"
        self.replayed = False
        self._graphs = {}   # B -> (graph, inputs, outputs)

    def plan_fn(self, obs: torch.Tensor, mean: torch.Tensor,
                noise: torch.Tensor):
        """The replan's arithmetic on given noise (N, B, H, m)."""
        N, H = self.n_samples, self.horizon
        if self.noise_beta > 0.0:
            scale = (1.0 - self.noise_beta ** 2) ** 0.5
            carry = torch.zeros_like(noise[:, :, 0])
            cols = []
            for t in range(H):
                carry = self.noise_beta * carry + scale * noise[:, :, t]
                cols.append(carry)
            noise = torch.stack(cols, dim=2)
        seqs = torch.clamp(mean[None] + self.sigma * noise, -1.0, 1.0)
        o = obs[None].expand((N,) + obs.shape)
        total = obs.new_zeros(N, obs.shape[0])
        alive = torch.ones(N, obs.shape[0], dtype=torch.bool,
                           device=obs.device)
        for t in range(H):
            act = seqs[:, :, t]
            nxt = self.step_fn(o, act)
            r, done = self.reward_done(o, nxt, act)
            total = total + r * alive
            alive = alive & ~done
            o = torch.where(alive[..., None], nxt, o)
        if self.smooth_weight > 0.0:
            diff = seqs[:, :, 1:] - seqs[:, :, :-1]
            total = total - self.smooth_weight * (diff * diff).sum((2, 3))
        w = torch.softmax((total - total.max(0).values) / self.lam, dim=0)
        new_mean = torch.einsum("nb,nbhm->bhm", w, seqs)
        actions = torch.clamp(new_mean[:, :self.n_exec], -1.0, 1.0)
        shifted = torch.roll(new_mean, -self.n_exec, dims=1)
        shifted[:, H - self.n_exec:] = new_mean[:, -1:]
        return actions, shifted

    def draw(self, generator: Optional[torch.Generator], B: int):
        return torch.randn((self.n_samples, B, self.horizon, self.act_dim),
                           generator=generator, device=self.device)

    @torch.no_grad()
    def __call__(self, generator: Optional[torch.Generator], obs, mean, *,
                 noise=None):
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        mean = torch.as_tensor(mean, dtype=torch.float32, device=self.device)
        B = obs.shape[0]
        noise = self.draw(generator, B) if noise is None else \
            torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        captured = self._graphs.get(B)
        self.replayed = captured is not None
        if captured is None:
            out = self.plan_fn(obs, mean, noise)
            if self.graph:
                self._graphs[B] = self._capture(obs, mean, noise)
            return out
        graph, inputs, outputs = captured
        for buf, v in zip(inputs, (obs, mean, noise)):
            buf.copy_(v)
        graph.replay()
        return tuple(v.clone() for v in outputs)

    def _capture(self, obs, mean, noise):
        inputs = [obs.clone(), mean.clone(), noise.clone()]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = self.plan_fn(*inputs)
        return graph, inputs, outputs


# the JAX package's name for the planner's factory (mppi_tpu.py:34)
make_mppi_planner = MPPIPlanner


def make_sim_step_fn(model, stats):
    """Physical-space step function of a trained DynamicsMLP and its
    ModelStats (mppi_tpu.py:146-154)."""
    from dadiff_tpu_torch.envs.learned_model import make_mean_step_fn

    if model.n_models is not None:
        raise ValueError("an ensemble steps through make_ensemble_step_fn")
    return make_mean_step_fn(model, stats)


def _fit_step_fn(pool, *, sim_ensemble: int, sim_hidden, sim_steps: int,
                 n_samples: int, seed: int, device):
    """The simulator fitted to ``pool`` and its planner step: trajectory
    sampling over an ensemble, or one model."""
    from dadiff_tpu_torch.envs.learned_model import (
        make_ensemble_step_fn,
        train_dynamics_ensemble,
        train_dynamics_model,
    )

    if sim_ensemble > 1:
        model, stats, metrics = train_dynamics_ensemble(
            pool, n_models=sim_ensemble, hidden=sim_hidden,
            n_steps=sim_steps, seed=seed, device=device)
        return make_ensemble_step_fn(model, stats, n_samples), metrics
    model, stats, metrics = train_dynamics_model(
        pool, hidden=sim_hidden, n_steps=sim_steps, seed=seed, device=device)
    return make_sim_step_fn(model, stats), metrics


def collect_mppi_tpu_episodes(
    env_name: str,
    n_episodes: int = 100,
    *,
    seed_episodes: Optional[Sequence[dict]] = None,
    max_steps: int = 1000,
    batch_envs: int = 8,
    horizon: int = 20,
    n_samples: int = 256,
    lam: float = 0.3,
    sigma: float = 0.4,
    n_exec: int = 1,
    noise_beta: float = 0.0,
    smooth_weight: float = 0.0,
    explore_sigma: float = 0.0,
    explore_beta: float = 0.0,
    n_iterations: int = 3,
    sim_hidden: Tuple[int, ...] = (256, 256),
    sim_steps: int = 4000,
    sim_ensemble: int = 1,
    dynamics_backend: str = "learned",
    physics_solver_iters: int = 100,
    checkpoint_path: Optional[str] = None,
    seed: int = 0,
    verbose: bool = True,
    device="cuda",
) -> List[dict]:
    """Iterated MPPI expert collection on a real gymnasium env
    (mppi_tpu.py:157-336): fit the simulator on ``seed_episodes`` (or plan
    on exact planar physics with ``dynamics_backend="physics"``, no fit),
    then per iteration plan on the card, execute on ``batch_envs`` host
    envs in lockstep and refit on everything gathered so far.
    ``explore_sigma`` adds execution noise on a third of the envs,
    low-passed by ``explore_beta``. Returns the newly collected episodes."""
    import gymnasium as gym

    from dadiff_tpu_torch.envs.learned_model import reward_model_for

    physics_step_fn = None
    if dynamics_backend == "physics":
        # exact planar physics as the rollout model: no simulator fit;
        # jacobi for the N*B-wide batch, the search model's reduced contacts
        # (execution stays on the real env)
        from dadiff_tpu_torch.envs.locomotion_jax import (
            make_physics_step_fn,
            physics_env_for,
        )

        physics_step_fn = make_physics_step_fn(physics_env_for(
            env_name, solver_iters=physics_solver_iters, solver="jacobi",
            search_model=True))
    elif seed_episodes is None or len(seed_episodes) == 0:
        raise ValueError(
            "collect_mppi_tpu_episodes needs seed_episodes to bootstrap the "
            "simulator (e.g. load_episodes('npz:...'))")

    reward_done = reward_model_for(env_name)
    rng = np.random.RandomState(seed)
    pool: List[dict] = list(seed_episodes or [])
    collected: List[dict] = []
    per_iter = max(1, -(-n_episodes // n_iterations))

    envs = [gym.make(env_name) for _ in range(batch_envs)]
    act_dim = envs[0].action_space.shape[0]
    env_seed = seed * 1000

    try:
        it = 0
        while len(collected) < n_episodes:
            it += 1
            if physics_step_fn is not None:
                if verbose and it == 1:
                    print("[mppi] exact-physics rollout model (no simulator "
                          "fit)", flush=True)
                step_fn = physics_step_fn
            else:
                if verbose:
                    print(f"[mppi iter {it}] fitting simulator on "
                          f"{len(pool)} episodes...", flush=True)
                step_fn, metrics = _fit_step_fn(
                    pool, sim_ensemble=sim_ensemble, sim_hidden=sim_hidden,
                    sim_steps=sim_steps, n_samples=n_samples, seed=seed + it,
                    device=device)
                if verbose:
                    print(f"[mppi iter {it}] sim one-step R^2 "
                          f"mean={metrics['r2_mean']:.3f} "
                          f"min={metrics['r2_min']:.3f}", flush=True)
            plan = make_mppi_planner(
                step_fn, reward_done, act_dim=act_dim, horizon=horizon,
                n_samples=n_samples, lam=lam, sigma=sigma, n_exec=n_exec,
                noise_beta=noise_beta, smooth_weight=smooth_weight,
                device=device)
            target = min(per_iter, n_episodes - len(collected))
            new_eps = _collect_batch(
                envs, plan, horizon, act_dim, target, max_steps,
                explore_sigma, rng, env_seed, explore_beta=explore_beta,
                verbose=verbose, tag=f"iter {it}")
            env_seed += 10 * (target + batch_envs)
            collected.extend(new_eps)
            pool.extend(new_eps)
            if checkpoint_path:
                # everything gathered so far persists after every iteration
                from dadiff_tpu_torch.datasets.sources import (
                    save_episodes_npz,
                )

                save_episodes_npz(checkpoint_path, collected)
                if verbose:
                    print(f"[mppi] checkpointed {len(collected)} episodes "
                          f"-> {checkpoint_path}", flush=True)
    finally:
        for e in envs:
            e.close()
    return collected


def _inject_state(env, state: np.ndarray) -> np.ndarray:
    """Set a MuJoCo env's simulator to a flat observation-layout state
    (mppi_tpu.py:339-368): the qpos/qvel split comes from the model's nq/nv,
    the excluded leading coordinates keep their current values. Returns the
    observation after injection."""
    unwrapped = env.unwrapped
    unwrapped = getattr(unwrapped, "point_env", unwrapped)
    mj_model = getattr(unwrapped, "model", None)
    if mj_model is None or not hasattr(unwrapped, "set_state"):
        raise NotImplementedError(
            f"state injection needs a MuJoCo env with set_state; got "
            f"{type(unwrapped).__name__}")
    state = np.asarray(state, np.float64)
    nq, nv = int(mj_model.nq), int(mj_model.nv)
    excluded = nq + nv - state.shape[0]
    if excluded < 0 or excluded > nq:
        raise ValueError(
            f"cannot map state dim {state.shape[0]} onto qpos({nq})/qvel({nv})")
    qpos = np.array(unwrapped.data.qpos, np.float64)
    qpos[excluded:] = state[: nq - excluded]
    qvel = state[nq - excluded: nq - excluded + nv]
    unwrapped.set_state(qpos, qvel)
    return np.asarray(state, np.float32)


def dagger_segment_starts(visited_episodes: Sequence[dict], *,
                          stride: int = 25, skip_initial: int = 10,
                          max_segments: int = 400, seed: int = 0
                          ) -> np.ndarray:
    """Every ``stride``-th visited observation after the first
    ``skip_initial`` steps, pooled over episodes and subsampled to
    ``max_segments`` (mppi_tpu.py:371-398)."""
    starts = []
    for ep in visited_episodes:
        obs = np.asarray(ep["observations"], np.float32)
        starts.extend(obs[skip_initial::stride])
    if not starts:
        raise ValueError("no visited states to relabel (episodes too short?)")
    starts = np.stack(starts)
    if len(starts) > max_segments:
        idx = np.random.RandomState(seed).choice(len(starts), max_segments,
                                                 replace=False)
        starts = starts[np.sort(idx)]
    return starts


def dagger_relabel_episodes(
    env_name: str,
    visited_episodes: Sequence[dict],
    pool_episodes: Sequence[dict],
    *,
    segment_len: int = 48,
    stride: int = 25,
    skip_initial: int = 10,
    max_segments: int = 400,
    batch_envs: int = 16,
    horizon: int = 12,
    n_samples: int = 1024,
    lam: float = 0.3,
    sigma: float = 0.4,
    n_exec: int = 4,
    sim_hidden: Tuple[int, ...] = (512, 512),
    sim_steps: int = 12000,
    sim_ensemble: int = 4,
    seed: int = 0,
    verbose: bool = True,
    device="cuda",
) -> List[dict]:
    """DAgger-style relabelling (mppi_tpu.py:401-562): start states
    subsampled from a policy's recorded rollouts are injected into real
    MuJoCo envs, and the MPPI expert, on a simulator fitted to the pool and
    the visited rollouts, rolls a segment of ``segment_len`` real env steps
    from each. Returns the segments as episode dicts."""
    import gymnasium as gym

    from dadiff_tpu_torch.envs.learned_model import reward_model_for

    starts = dagger_segment_starts(visited_episodes, stride=stride,
                                   skip_initial=skip_initial,
                                   max_segments=max_segments, seed=seed)
    if verbose:
        print(f"[dagger] {len(starts)} segment starts from "
              f"{len(visited_episodes)} visited episodes", flush=True)
    sim_pool = list(pool_episodes) + list(visited_episodes)
    step_fn, metrics = _fit_step_fn(
        sim_pool, sim_ensemble=sim_ensemble, sim_hidden=sim_hidden,
        sim_steps=sim_steps, n_samples=n_samples, seed=seed, device=device)
    if verbose:
        print(f"[dagger] sim fit on {len(sim_pool)} episodes: one-step R^2 "
              f"mean={metrics['r2_mean']:.3f} min={metrics['r2_min']:.3f}",
              flush=True)

    envs = [gym.make(env_name) for _ in range(batch_envs)]
    act_dim = envs[0].action_space.shape[0]
    plan = make_mppi_planner(step_fn, reward_model_for(env_name),
                             act_dim=act_dim, horizon=horizon,
                             n_samples=n_samples, lam=lam, sigma=sigma,
                             n_exec=n_exec, device=device)

    B = len(envs)
    next_start = 0
    active = np.zeros(B, bool)
    obs = np.zeros((B, starts.shape[1]), np.float32)
    mean = np.zeros((B, horizon, act_dim), np.float32)
    steps = np.zeros(B, int)
    bufs = [None] * B
    segments: List[dict] = []
    generator = torch.Generator(device=plan.device).manual_seed(seed)

    def _start_segment(i):
        nonlocal next_start
        envs[i].reset(seed=seed * 1000 + next_start)
        o = _inject_state(envs[i], starts[next_start])
        next_start += 1
        obs[i] = o
        mean[i] = 0.0
        steps[i] = 0
        bufs[i] = {"obs": [o], "act": [], "rew": []}
        active[i] = True

    def _finish_segment(i):
        segments.append({
            "observations": np.stack(bufs[i]["obs"]),
            "actions": np.stack(bufs[i]["act"]),
            "rewards": np.asarray(bufs[i]["rew"], np.float32),
        })
        active[i] = False
        if verbose and len(segments) % 50 == 0:
            rets = [float(s["rewards"].sum()) for s in segments]
            print(f"[dagger] {len(segments)}/{len(starts)} segments, mean "
                  f"segment return {np.mean(rets):.1f}", flush=True)

    try:
        for i in range(B):
            if next_start < len(starts):
                _start_segment(i)
        while active.any():
            actions, new_mean = plan(generator, obs, mean)
            actions = actions.cpu().numpy()
            mean = new_mean.cpu().numpy()
            for i in range(B):
                if not active[i]:
                    continue
                for k in range(actions.shape[1]):
                    a = actions[i, k].astype(np.float32)
                    o, r, term, trunc, _ = envs[i].step(a)
                    bufs[i]["obs"].append(np.asarray(o, np.float32))
                    bufs[i]["act"].append(a)
                    bufs[i]["rew"].append(float(r))
                    obs[i] = o
                    steps[i] += 1
                    if term or trunc or steps[i] >= segment_len:
                        _finish_segment(i)
                        if next_start < len(starts):
                            _start_segment(i)
                        break
    finally:
        for e in envs:
            e.close()
    return segments


def _collect_batch(envs, plan, horizon, act_dim, n_episodes, max_steps,
                   explore_sigma, rng, env_seed, explore_beta=0.0,
                   verbose=True, tag=""):
    """B host envs in lockstep against one planner call per replan
    (mppi_tpu.py:565-666); the planner's generator is seeded from
    ``rng``."""
    B = len(envs)
    obs = np.zeros((B, envs[0].observation_space.shape[0]), np.float32)
    mean = np.zeros((B, horizon, act_dim), np.float32)
    bufs = [{"obs": [], "act": [], "rew": []} for _ in range(B)]
    steps = np.zeros(B, int)
    # a third of the envs (at least one) get execution noise
    noisy = np.zeros(B, bool)
    if explore_sigma > 0:
        noisy[: max(1, B // 3)] = True
    # AR(1) state of the execution noise (stationary std explore_sigma)
    exec_noise_state = np.zeros((B, act_dim))
    exec_scale = float(np.sqrt(max(1.0 - explore_beta ** 2, 0.0)))

    for i in range(B):
        o, _ = envs[i].reset(seed=env_seed + i)
        obs[i] = o
        bufs[i]["obs"].append(np.asarray(o, np.float32))
    next_seed = env_seed + B

    episodes: List[dict] = []
    generator = torch.Generator(device=plan.device).manual_seed(
        int(rng.randint(0, 2 ** 31 - 1)))
    while len(episodes) < n_episodes:
        actions, new_mean = plan(generator, obs, mean)
        actions = actions.cpu().numpy()
        mean = new_mean.cpu().numpy()
        n_exec = actions.shape[1]
        if explore_sigma > 0:
            if explore_beta > 0:
                cols = []
                for _ in range(n_exec):
                    exec_noise_state[:] = (
                        explore_beta * exec_noise_state
                        + exec_scale * rng.randn(B, act_dim))
                    cols.append(exec_noise_state.copy())
                noise = np.stack(cols, axis=1) * explore_sigma
            else:
                noise = rng.randn(B, n_exec, act_dim) * explore_sigma
            actions = np.where(noisy[:, None, None],
                               np.clip(actions + noise, -1.0, 1.0), actions)
        for i in range(B):
            # up to n_exec planned actions open-loop; an ending episode
            # drops the stale tail of the plan
            for k in range(n_exec):
                a = actions[i, k].astype(np.float32)
                o, r, term, trunc, _ = envs[i].step(a)
                bufs[i]["obs"].append(np.asarray(o, np.float32))
                bufs[i]["act"].append(a)
                bufs[i]["rew"].append(float(r))
                obs[i] = o
                steps[i] += 1
                if term or trunc or steps[i] >= max_steps:
                    ep = {"observations": np.stack(bufs[i]["obs"]),
                          "actions": np.stack(bufs[i]["act"]),
                          "rewards": np.asarray(bufs[i]["rew"], np.float32)}
                    episodes.append(ep)
                    if verbose:
                        print(f"[mppi {tag}] episode {len(episodes)}/"
                              f"{n_episodes}: steps={steps[i]} "
                              f"return={ep['rewards'].sum():.1f}"
                              f"{' (noisy)' if noisy[i] else ''}",
                              flush=True)
                    o, _ = envs[i].reset(seed=next_seed)
                    next_seed += 1
                    obs[i] = o
                    bufs[i] = {"obs": [np.asarray(o, np.float32)],
                               "act": [], "rew": []}
                    steps[i] = 0
                    mean[i] = 0.0
                    exec_noise_state[i] = 0.0
                    break
            if len(episodes) >= n_episodes:
                break
    return episodes
