"""The learned simulator: MLPs of locomotion dynamics and inverse dynamics,
their trainers, reward and done models from observations, and the on-device
plan -> step -> replan loop over the simulator.

Counterpart of the JAX package's envs/learned_model.py: DynamicsMLP :33,
ModelStats :47, _chunk_sizes :58, _transitions :66, train_dynamics_model
:78, train_dynamics_ensemble :182, make_ensemble_step_fn :306,
InverseDynamicsMLP :340, train_inverse_dynamics :357, the reward models
:460-499 and make_ondevice_locomotion_evaluator :502. The module keeps its
counterpart's name so that a reader finds it.

The weights live in the module: a trainer returns ``(model, stats,
metrics)`` where the JAX one returns ``(model, params, stats, metrics)``,
and the step functions take the module. An ensemble is one module whose
layers hold E stacked weight matrices (:class:`StackedLinear`), so its
members train and step together, one batched product per layer; its state
dict is the JAX ensemble's stacked tree, each kernel transposed
(io/torch_compat.py ``mlp_params_from_jax``).

As in JAX: layers are initialised with flax's ``lecun_normal`` (a normal
truncated at two deviations, fan-in scaling) and zero biases; the
statistics are numpy's (population std + 1e-6) and the split is
``np.random.RandomState(seed).permutation``; Adam has optax's defaults; the
loss is the mean squared error in normalized space; R^2 is held out, in
physical space. The trainers take injectable initial weights
(``init_params``, a state dict) and batch indices (``batch_idx``, (n_steps,
B) or (n_steps, E, B)), so that a test can feed JAX's draws; without them
the indices come from a ``torch.Generator`` seeded ``seed + 1`` on the
model's device.

Returns of the evaluator are model-based (surrogate) returns: the learned
simulator drifts over long horizons. The bound on them is measured by
``python -m dadiff_tpu_torch.surrogate_bound``.

Observation layouts (gymnasium MuJoCo v5, exclude_current_positions=True):
    HalfCheetah-v5: obs[0:8]=qpos[1:], obs[8:17]=qvel  -> x_vel = obs[8]
    Hopper-v5:      obs[0:5]=qpos[1:], obs[5:11]=qvel  -> x_vel = obs[5]
    Walker2d-v5:    obs[0:8]=qpos[1:], obs[8:17]=qvel  -> x_vel = obs[8]
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dadiff_tpu_torch.envs.locomotion_jax import LocomotionEvaluator

# flax's truncated normal keeps the target deviation after truncation at 2
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal`` on a (..., out, in) weight: fan-in scaling, a
    normal truncated at two deviations."""
    std = math.sqrt(1.0 / weight.shape[-1]) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class StackedLinear(nn.Module):
    """E Linear layers stacked: weight (E, out, in), bias (E, out); x (E, n,
    in) -> (E, n, out) as one batched product."""

    def __init__(self, n_models: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_models, out_features,
                                               in_features))
        self.bias = nn.Parameter(torch.zeros(n_models, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.baddbmm(self.bias.unsqueeze(1), x,
                             self.weight.transpose(1, 2))


class _MLP(nn.Module):
    """Linear + SiLU (flax ``nn.swish``) per hidden width, then a Linear
    head, over two inputs concatenated. With ``n_models`` the layers are
    stacked and every input and output has a leading member axis."""

    def __init__(self, in_dim: int, out_dim: int, hidden: Sequence[int],
                 n_models: Optional[int] = None, seed: int = 0):
        super().__init__()
        self.hidden, self.n_models = tuple(hidden), n_models
        widths = [in_dim, *self.hidden, out_dim]

        def layer(i, o):
            return nn.Linear(i, o) if n_models is None else \
                StackedLinear(n_models, i, o)

        self.layers = nn.ModuleList(layer(i, o) for i, o in
                                    zip(widths[:-1], widths[1:]))
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for lin in self.layers:
                _lecun_normal_(lin.weight, g)
                lin.bias.zero_()

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = torch.cat([a, b], dim=-1)
        if self.n_models is not None:
            lead = x.shape[:-1]
            x = x.reshape(self.n_models, -1, x.shape[-1])
        for lin in self.layers[:-1]:
            x = F.silu(lin(x))
        x = self.layers[-1](x)
        return x if self.n_models is None else x.reshape(lead + x.shape[-1:])


class DynamicsMLP(_MLP):
    """(obs, action) -> delta_obs, all in normalized space
    (learned_model.py:33-44); with ``n_models`` an ensemble of stacked
    members, inputs and output (E, ..., dim)."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 n_models: Optional[int] = None, seed: int = 0):
        super().__init__(obs_dim + act_dim, obs_dim, hidden, n_models, seed)
        self.obs_dim, self.act_dim = obs_dim, act_dim


class InverseDynamicsMLP(_MLP):
    """(obs_t, obs_{t+1}) -> action, all normalized (learned_model.py:340-354):
    actions read off consecutive planned states."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (256, 256), seed: int = 0):
        super().__init__(2 * obs_dim, act_dim, hidden, None, seed)
        self.obs_dim, self.act_dim = obs_dim, act_dim


class ModelStats(NamedTuple):
    """Normalization statistics of the learned simulator (tensors on the
    model's device)."""

    obs_mean: torch.Tensor
    obs_std: torch.Tensor
    act_mean: torch.Tensor
    act_std: torch.Tensor
    delta_mean: torch.Tensor
    delta_std: torch.Tensor

    def to(self, device) -> "ModelStats":
        return ModelStats(*(v.to(device) for v in self))


def _chunk_sizes(n_steps: int, chunk: int):
    """Chunk schedule covering exactly ``n_steps`` SGD steps: full chunks
    plus one exactly-sized remainder (learned_model.py:58-63)."""
    full, rem = divmod(n_steps, chunk)
    return [chunk] * full + ([rem] if rem else [])


def _transitions(episodes: Sequence[dict]) -> Tuple[np.ndarray, ...]:
    """(obs, act, next_obs) float32 over every episode's transitions."""
    obs, act, nxt = [], [], []
    for ep in episodes:
        o = np.asarray(ep["observations"], np.float32)
        a = np.asarray(ep["actions"], np.float32)
        T = min(len(a), len(o) - 1)
        obs.append(o[:T])
        act.append(a[:T])
        nxt.append(o[1:T + 1])
    return np.concatenate(obs), np.concatenate(act), np.concatenate(nxt)


def _split(n: int, val_fraction: float, seed: int):
    """(val_idx, train_idx): numpy's permutation, as the JAX trainers
    draw it."""
    perm = np.random.RandomState(seed).permutation(n)
    n_val = max(1, int(n * val_fraction))
    return perm[:n_val], perm[n_val:]


def _stats_of(x: np.ndarray):
    """numpy mean and population std + 1e-6 (learned_model.py:104-106)."""
    return x.mean(0), x.std(0) + 1e-6


def _r2(true: np.ndarray, pred: np.ndarray) -> np.ndarray:
    ss_res = ((true - pred) ** 2).sum(0)
    ss_tot = ((true - true.mean(0)) ** 2).sum(0) + 1e-12
    return 1.0 - ss_res / ss_tot


def _fit(model: _MLP, inputs, target, *, n_steps: int, batch_size: int,
         lr: float, seed: int, batch_idx, verbose: bool, tag: str) -> None:
    """Adam (optax's defaults) on the mean squared error over minibatches
    of the rows of ``inputs`` (two tensors) and ``target``, on the model's
    device. An ensemble's members draw their own minibatches and each
    minimizes its own mean (the summed loss keeps their gradients apart)."""
    device = target.device
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    n_train = target.shape[0]
    shape = ((model.n_models,) if model.n_models else ()) + (batch_size,)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if batch_idx is not None:
        batch_idx = torch.as_tensor(batch_idx, dtype=torch.long,
                                    device=device)
        if batch_idx.shape != (n_steps,) + shape:
            raise ValueError(f"batch_idx {tuple(batch_idx.shape)}, expected "
                             f"{(n_steps,) + shape}")
    a, b = inputs
    done = 0
    for size in _chunk_sizes(n_steps, max(1, min(500, n_steps))):
        losses = []
        for s in range(done, done + size):
            idx = batch_idx[s] if batch_idx is not None else torch.randint(
                0, n_train, shape, generator=gen, device=device)
            pred = model(a[idx], b[idx])
            per = ((pred - target[idx]) ** 2).mean(dim=(-2, -1))
            opt.zero_grad(set_to_none=True)
            per.sum().backward()
            opt.step()
            losses.append(per.detach())
        done += size
        if verbose:
            loss = float(torch.stack(losses[-50:]).mean())
            print(f"{tag} step {done}: loss={loss:.5f}", flush=True)


def _dynamics_data(episodes, val_fraction: float, seed: int, device):
    obs, act, nxt = _transitions(episodes)
    delta = nxt - obs
    val_idx, train_idx = _split(len(obs), val_fraction, seed)
    om, os_ = _stats_of(obs[train_idx])
    am, as_ = _stats_of(act[train_idx])
    dm, ds = _stats_of(delta[train_idx])
    stats = ModelStats(*(torch.as_tensor(v, device=device)
                         for v in (om, os_, am, as_, dm, ds)))
    normed = [(obs - om) / os_, (act - am) / as_, (delta - dm) / ds]
    train = [torch.as_tensor(v[train_idx], device=device) for v in normed]
    val = [torch.as_tensor(v[val_idx], device=device) for v in normed[:2]]
    return stats, train, val, (dm, ds, delta[val_idx])


def train_dynamics_model(episodes: Sequence[dict], *,
                         hidden: Tuple[int, ...] = (256, 256),
                         n_steps: int = 2000, batch_size: int = 1024,
                         lr: float = 1e-3, val_fraction: float = 0.1,
                         seed: int = 0, verbose: bool = False,
                         device="cuda", init_params=None, batch_idx=None):
    """Fit a DynamicsMLP to episode transitions (learned_model.py:78-179).
    Returns (model, ModelStats, metrics) with the held-out one-step R^2 per
    observation dimension, min and mean."""
    stats, (o, a, d), (vo, va), (dm, ds, true) = _dynamics_data(
        episodes, val_fraction, seed, device)
    model = DynamicsMLP(o.shape[-1], a.shape[-1], hidden, seed=seed)
    if init_params is not None:
        model.load_state_dict(init_params, strict=True)
    model.to(device)
    _fit(model, (o, a), d, n_steps=n_steps, batch_size=batch_size, lr=lr,
         seed=seed, batch_idx=batch_idx, verbose=verbose, tag="dynamics")
    with torch.no_grad():
        pred = model(vo, va).cpu().numpy() * ds + dm
    r2 = _r2(true, pred)
    return model.eval(), stats, {"r2_min": float(r2.min()),
                                 "r2_mean": float(r2.mean())}


def train_dynamics_ensemble(episodes: Sequence[dict], *, n_models: int = 4,
                            hidden: Tuple[int, ...] = (256, 256),
                            n_steps: int = 2000, batch_size: int = 1024,
                            lr: float = 1e-3, val_fraction: float = 0.1,
                            seed: int = 0, verbose: bool = False,
                            device="cuda", init_params=None, batch_idx=None):
    """Fit an ensemble of ``n_models`` DynamicsMLPs, each from its own
    initialisation on its own minibatches, all at once as stacked weights
    (learned_model.py:182-303). Returns (model, ModelStats, metrics) with
    the per-member and the ensemble-mean held-out one-step R^2."""
    stats, (o, a, d), (vo, va), (dm, ds, true) = _dynamics_data(
        episodes, val_fraction, seed, device)
    model = DynamicsMLP(o.shape[-1], a.shape[-1], hidden, n_models=n_models,
                        seed=seed)
    if init_params is not None:
        model.load_state_dict(init_params, strict=True)
    model.to(device)
    _fit(model, (o, a), d, n_steps=n_steps, batch_size=batch_size, lr=lr,
         seed=seed, batch_idx=batch_idx, verbose=verbose, tag="ensemble")
    with torch.no_grad():
        preds = model(vo.expand((n_models,) + vo.shape),
                      va.expand((n_models,) + va.shape)).cpu().numpy()
    preds = preds * ds + dm
    mean_r2 = _r2(true, preds.mean(0))
    return model.eval(), stats, {
        "r2_mean": float(mean_r2.mean()), "r2_min": float(mean_r2.min()),
        "member_r2": [float(_r2(true, p).mean()) for p in preds]}


def train_inverse_dynamics(episodes: Sequence[dict], *,
                           hidden: Tuple[int, ...] = (256, 256),
                           n_steps: int = 2000, batch_size: int = 1024,
                           lr: float = 1e-3, val_fraction: float = 0.1,
                           seed: int = 0, verbose: bool = False,
                           device="cuda", init_params=None, batch_idx=None):
    """Fit an InverseDynamicsMLP to episode transitions
    (learned_model.py:357-455). Returns (predict_fn, metrics):
    ``predict_fn(obs, next_obs) -> action`` in physical space, batched,
    numpy or tensors in and a float32 numpy array out, and the held-out
    action R^2."""
    obs, act, nxt = _transitions(episodes)
    val_idx, train_idx = _split(len(obs), val_fraction, seed)
    om, os_ = _stats_of(obs[train_idx])
    am, as_ = _stats_of(act[train_idx])
    normed = [(obs - om) / os_, (nxt - om) / os_, (act - am) / as_]
    o, n, a = (torch.as_tensor(v[train_idx], device=device) for v in normed)
    model = InverseDynamicsMLP(obs.shape[-1], act.shape[-1], hidden,
                               seed=seed)
    if init_params is not None:
        model.load_state_dict(init_params, strict=True)
    model.to(device)
    _fit(model, (o, n), a, n_steps=n_steps, batch_size=batch_size, lr=lr,
         seed=seed, batch_idx=batch_idx, verbose=verbose, tag="invdyn")
    model.eval()
    with torch.no_grad():
        pred = model(*(torch.as_tensor(v[val_idx], device=device)
                       for v in normed[:2])).cpu().numpy() * as_ + am
    r2 = _r2(act[val_idx], pred)
    metrics = {"r2_min": float(r2.min()), "r2_mean": float(r2.mean())}
    o_m, o_s, a_m, a_s = (torch.as_tensor(v, device=device)
                          for v in (om, os_, am, as_))

    @torch.no_grad()
    def predict_fn(obs_phys, next_obs_phys) -> np.ndarray:
        o = (torch.as_tensor(obs_phys, dtype=torch.float32, device=device)
             - o_m) / o_s
        nx = (torch.as_tensor(next_obs_phys, dtype=torch.float32,
                              device=device) - o_m) / o_s
        return (model(o, nx) * a_s + a_m).cpu().numpy()

    return predict_fn, metrics


def make_mean_step_fn(model: DynamicsMLP, stats: ModelStats):
    """``(obs (..., d), act (..., m)) -> next_obs`` in physical space: the
    model's normalized delta, or for an ensemble the MEAN of its members'
    normalized deltas, the deterministic surrogate that the measured bound
    characterizes (learned_model.py:554-566; mppi_tpu.py:146-154 for one
    model)."""
    E = model.n_models

    def step_fn(obs, act):
        o_n = (obs - stats.obs_mean) / stats.obs_std
        a_n = (act - stats.act_mean) / stats.act_std
        if E is None:
            d_n = model(o_n, a_n)
        else:
            d_n = model(o_n.expand((E,) + o_n.shape),
                        a_n.expand((E,) + a_n.shape)).mean(0)
        return obs + d_n * stats.delta_std + stats.delta_mean

    return step_fn


def make_ensemble_step_fn(model: DynamicsMLP, stats: ModelStats,
                          n_samples: int):
    """PETS trajectory-sampling step for the MPPI planner
    (learned_model.py:306-337): on ``(N, B, d)`` states, candidates
    ``[e*N/E, (e+1)*N/E)`` step under member ``e`` for their whole rollout.
    ``n_samples`` must be divisible by the ensemble size."""
    E = model.n_models
    if n_samples % E:
        raise ValueError(f"n_samples ({n_samples}) must be divisible by "
                         f"ensemble size ({E})")

    def step_fn(obs, act):
        N = obs.shape[0]

        def grp(x):
            return x.reshape((E, N // E) + x.shape[1:])

        o_n = grp((obs - stats.obs_mean) / stats.obs_std)
        a_n = grp((act - stats.act_mean) / stats.act_std)
        d_n = model(o_n, a_n).reshape(obs.shape)
        return obs + d_n * stats.delta_std + stats.delta_mean

    return step_fn


# --- reward and termination from observations (gymnasium v5 semantics) ---

def halfcheetah_reward_done(obs, next_obs, action):
    x_vel = next_obs[..., 8]
    reward = x_vel - 0.1 * (action ** 2).sum(-1)
    return reward, torch.zeros_like(x_vel, dtype=torch.bool)


def hopper_reward_done(obs, next_obs, action):
    x_vel = next_obs[..., 5]
    z, angle = next_obs[..., 0], next_obs[..., 1]
    # is_healthy of Hopper-v5: z and angle ranges AND every remaining state
    # element inside healthy_state_range (-100, 100)
    state_ok = (next_obs[..., 2:].abs() < 100.0).all(-1)
    healthy = (z > 0.7) & (angle.abs() < 0.2) & state_ok
    reward = x_vel + 1.0 * healthy - 1e-3 * (action ** 2).sum(-1)
    return reward, ~healthy


def walker2d_reward_done(obs, next_obs, action):
    x_vel = next_obs[..., 8]
    z, angle = next_obs[..., 0], next_obs[..., 1]
    healthy = (z > 0.8) & (z < 2.0) & (angle.abs() < 1.0)
    reward = x_vel + 1.0 * healthy - 1e-3 * (action ** 2).sum(-1)
    return reward, ~healthy


REWARD_MODELS: Dict[str, Callable] = {
    "halfcheetah": halfcheetah_reward_done,
    "hopper": hopper_reward_done,
    "walker": walker2d_reward_done,
}


def reward_model_for(env_name: str) -> Callable:
    key = env_name.lower()
    for name, fn in REWARD_MODELS.items():
        if name in key:
            return fn
    raise ValueError(f"No on-device reward model for {env_name}")


class LearnedSim:
    """The locomotion evaluator's simulator on the learned model: the state
    is the observation, stepped by :func:`make_mean_step_fn` (an ensemble
    steps its mean), rewarded and ended by ``reward_done``."""

    def __init__(self, model: DynamicsMLP, stats: ModelStats,
                 reward_done: Callable):
        self.step_fn = make_mean_step_fn(model, stats)
        self.reward_done = reward_done

    def from_obs(self, obs):
        return [obs]

    def observe(self, state):
        return state[0]

    def step(self, state, act):
        obs = state[0]
        nxt = self.step_fn(obs, act)
        reward, done = self.reward_done(obs, nxt, act)
        return [nxt], reward, done


def make_ondevice_locomotion_evaluator(
        diffusion, model: DynamicsMLP, model_stats: ModelStats,
        reward_done: Callable, *, action_horizon: int = 8,
        n_replans: int = 25, sampling_timesteps: Optional[int] = None,
        sampler: str = "ddpm", graph: Optional[bool] = None
) -> LocomotionEvaluator:
    """On-device plan -> step -> replan over the learned simulator
    (learned_model.py:502-609): a ``LocomotionEvaluator``
    (envs/locomotion_jax.py) whose simulator is the model, executing the
    plan's actions from row 0. An ensemble (``model.n_models``) steps its
    members' mean. ``evaluate(generator, stats, init_obs, *, noise=None) ->
    (mean_return, mean_length, returns)``; the returns are model-based."""
    return LocomotionEvaluator(
        diffusion, LearnedSim(model, model_stats, reward_done),
        action_horizon=action_horizon, n_replans=n_replans,
        sampling_timesteps=sampling_timesteps, sampler=sampler, graph=graph)
