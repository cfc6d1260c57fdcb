"""The best-of-N DDPM planner, plainly: N chains per observation, each
started from its x_T, conditioned at row 0 on the normalised observation
(its action slot zero), stepped by the ancestral update with the denoiser's
x0 estimate clipped to [-1, 1], and after every step projected onto the
dynamics-consistent trajectories in physical space, blended by
alpha_t = sqrt(1 - beta_t). The noise is re-drawn from the generator the
benchmark seeded, in the order a plan takes it: x_T, then every step's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch


class Operands(NamedTuple):
    """The reference's own derived operands, on the device."""

    recip: torch.Tensor
    recipm1: torch.Tensor
    coef1: torch.Tensor
    coef2: torch.Tensor
    sigma: torch.Tensor      # exp(0.5 log_var), zero at t = 0
    alpha: torch.Tensor      # the projection's blend at each t
    P: torch.Tensor          # float32 projector of concatenated trajectories
    obs_mean: torch.Tensor
    obs_std: torch.Tensor
    act_mean: torch.Tensor
    act_std: torch.Tensor


def operands(schedule, stats, P: np.ndarray, device) -> Operands:
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32),  # noqa: E731
                                  device=device)
    sigma = np.exp(0.5 * schedule.log_var).astype(np.float32)
    sigma[0] = 0.0
    alpha = np.sqrt(np.float32(1.0) - schedule.betas).astype(np.float32)
    return Operands(f(schedule.sqrt_recip_acp), f(schedule.sqrt_recipm1_acp),
                    f(schedule.coef1), f(schedule.coef2), f(sigma), f(alpha),
                    f(P.astype(np.float32)), f(stats.obs_mean),
                    f(stats.obs_std), f(stats.act_mean), f(stats.act_std))


def project(x, alpha, ops: Operands, obs_dim: int, state_dim: int):
    """Blend x (C, H, D, normalised) with its projection in physical
    space; the goal columns are left as they are."""
    C, H, _ = x.shape
    sm, ss = ops.obs_mean[:state_dim], ops.obs_std[:state_dim]
    states = x[..., :state_dim] * ss + sm
    acts = x[..., obs_dim:] * ops.act_std + ops.act_mean
    ext = torch.cat([states, states[:, -1:]], dim=1)
    xc = torch.cat([ext.reshape(C, -1), acts.reshape(C, -1)], dim=1)
    xc = alpha * (xc @ ops.P) + (1.0 - alpha) * xc
    n = (H + 1) * state_dim
    states = xc[:, :n].reshape(C, H + 1, state_dim)[:, :-1]
    acts = xc[:, n:].reshape(C, H, -1)
    return torch.cat([(states - sm) / ss, x[..., state_dim:obs_dim],
                      (acts - ops.act_mean) / ops.act_std], dim=-1)


@torch.no_grad()
def plan(eps_fn: Callable, ops: Operands, obs_norm: torch.Tensor,
         x0: torch.Tensor, noise: torch.Tensor, *, obs_dim: int,
         state_dim: int, block: int = 4096) -> torch.Tensor:
    """Every chain's plan (C, H, D): ``obs_norm`` (C, obs_dim) conditions
    chain c, ``x0`` (C, H, D) and ``noise`` (T, C, H, D) are its draws.
    ``eps_fn(x, t, cond)`` is the denoiser; ``cond`` is each chain's
    ``obs_norm``, the observation its row 0 is inpainted with. Runs
    ``block`` chains at a time."""
    outs = []
    for c0 in range(0, x0.shape[0], block):
        sl = slice(c0, c0 + block)
        outs.append(_plan(eps_fn, ops, obs_norm[sl], x0[sl], noise[:, sl],
                          obs_dim, state_dim))
    return torch.cat(outs)


def _plan(eps_fn, ops, obs_norm, x0, noise, obs_dim, state_dim):
    C = x0.shape[0]
    T = ops.recip.shape[0]
    cond = torch.zeros_like(x0[:, 0])
    cond[:, :obs_dim] = obs_norm
    x = x0.clone()
    x[:, 0] = cond
    for i, t in enumerate(range(T - 1, -1, -1)):
        tt = torch.full((C,), t, dtype=torch.long, device=x.device)
        eps = eps_fn(x, tt, obs_norm)
        xr = (ops.recip[t] * x - ops.recipm1[t] * eps).clamp(-1.0, 1.0)
        x = ops.coef1[t] * xr + ops.coef2[t] * x + ops.sigma[t] * noise[i]
        x = project(x, ops.alpha[t], ops, obs_dim, state_dim)
        x[:, 0] = cond
    return x


def final_distance(plans, goal, ops: Operands):
    """Physical distance from each plan's last position to its goal."""
    pos = plans[:, -1, 0:2] * ops.obs_std[0:2] + ops.obs_mean[0:2]
    return torch.linalg.norm(pos - goal, dim=-1)


def draws(generator: torch.Generator, rows: int, D: int, T: int,
          count: int) -> List[tuple]:
    """``count`` plans' draws from ``generator``: x_T (rows, D) then the T
    steps' noise (T, rows, D) each."""
    dev = generator.device
    out = []
    for _ in range(count):
        x0 = torch.randn(rows, D, generator=generator, device=dev)
        out.append((x0, torch.randn(T, rows, D, generator=generator,
                                    device=dev)))
    return out


def session_draws(seed: int, wanted: Dict[int, None], rows: int, D: int,
                  T: int, device) -> Dict[int, tuple]:
    """The draws of a session's plans at the indices ``wanted``: plan k of
    a session seeded ``seed`` takes the k-th pair of draws."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for k in range(max(wanted) + 1):
        x0 = torch.randn(rows, D, generator=g, device=device)
        noise = torch.randn(T, rows, D, generator=g, device=device)
        if k in wanted:
            out[k] = (x0, noise)
    return out
