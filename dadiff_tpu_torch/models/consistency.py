"""Consistency distillation: a student that plans in 1-4 model calls,
distilled from a trained DDPM teacher (Song et al., arXiv:2303.01469; the
pseudo-Huber metric and weighting of iCT, arXiv:2310.14189).

Counterpart of the JAX package's models/consistency.py: sigma_of_t :45,
consistency_scalings :52, make_consistency_fn :74, teacher_ddim_step :102,
make_cd_loss :130, consistency_noise_levels :190 and make_consistency_sampler
:210. The student has the teacher's architecture and starts from its
weights; the CD target network is the trainer's EMA shadow
(``utils/training.py`` ``loss_takes_ema``), evaluated with
``torch.func.functional_call`` on the student's module.

In VP terms x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps; the VE-equivalent
noise level is sigma_t = sqrt((1 - abar_t) / abar_t), since x_t / sqrt(abar_t)
= x0 + sigma_t eps, so the boundary scalings c_skip / c_out apply to the
rescaled input.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from dadiff_tpu_torch.models.diffusion import (
    GaussianDiffusion,
    _extract,
    eps_and_x0,
    predict_start_from_noise,
    q_sample,
)
from dadiff_tpu_torch.parallel.mesh import draw_rows


def sigma_of_t(schedule, t: torch.Tensor) -> torch.Tensor:
    """sigma_t = sqrt((1 - abar_t) / abar_t) (consistency.py:45-49)."""
    acp = torch.clamp(schedule.alphas_cumprod[t], 1e-8, 1.0 - 1e-8)
    return torch.sqrt((1.0 - acp) / acp)


def consistency_scalings(schedule, t: torch.Tensor, sigma_data: float = 0.5):
    """(coef_x, c_out) with f(x, t) = coef_x x + c_out x0_net(x, t):
    c_skip = sd^2 / (sigma^2 + sd^2), coef_x = c_skip / sqrt(abar_t),
    c_out = 1 - c_skip (consistency.py:52-71)."""
    acp = torch.clamp(schedule.alphas_cumprod[t], 1e-8, 1.0 - 1e-8)
    sigma2 = (1.0 - acp) / acp
    sd2 = sigma_data * sigma_data
    c_skip = sd2 / (sigma2 + sd2)
    return c_skip / torch.sqrt(acp), 1.0 - c_skip


def make_consistency_fn(diffusion: GaussianDiffusion,
                        sigma_data: float = 0.5) -> Callable:
    """``f(x, t_batch, params=None) -> x0`` estimate: the denoiser (with
    ``params``, a name -> tensor dict of the module's parameters, in place
    of its own) read as an x0 prediction and blended with the input by the
    boundary scalings, clipped where the model clips (consistency.py:74-99).
    """
    schedule = diffusion.schedule

    def f(x: torch.Tensor, t_batch: torch.Tensor,
          params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        out = (diffusion(x, t_batch) if params is None
               else functional_call(diffusion, params, (x, t_batch)))
        x0_net = (predict_start_from_noise(schedule, x, t_batch, out)
                  if diffusion.predict_epsilon else out)
        coef_x, c_out = consistency_scalings(schedule, t_batch, sigma_data)
        bshape = (-1,) + (1,) * (x.dim() - 1)
        val = coef_x.reshape(bshape) * x + c_out.reshape(bshape) * x0_net
        if diffusion.clip_denoised:
            val = val.clamp(-1.0, 1.0)
        return val

    return f


def teacher_ddim_step(diffusion: GaussianDiffusion,
                      teacher_params: Optional[Dict[str, torch.Tensor]],
                      x: torch.Tensor, t: torch.Tensor,
                      t_prev: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM step of the teacher from t to t_prev
    (consistency.py:102-127); ``teacher_params`` None runs the module's own
    weights."""
    schedule = diffusion.schedule
    out = (diffusion(x, t) if teacher_params is None
           else functional_call(diffusion, teacher_params, (x, t)))
    eps, x0 = eps_and_x0(out, schedule, x, t,
                         clip_denoised=diffusion.clip_denoised,
                         predict_epsilon=diffusion.predict_epsilon)
    a_prev = _extract(schedule.alphas_cumprod, t_prev, x.dim())
    return torch.sqrt(a_prev) * x0 + torch.sqrt(
        torch.clamp(1.0 - a_prev, min=0.0)) * eps


def make_cd_loss(diffusion: GaussianDiffusion,
                 teacher_params: Dict[str, torch.Tensor], *,
                 sigma_data: float = 0.5, huber_c: Optional[float] = None,
                 skip_steps: int = 1) -> Callable:
    """Consistency-distillation objective over chain pairs (t, t-k),
    t ~ U{k, T-1} (consistency.py:130-187):

        d( f_theta(x_t, t), f_theta-(x_hat_{t-k}, t-k) )

    with x_hat one teacher DDIM step across the gap, theta- the EMA target
    (no gradient), d the pseudo-Huber metric sqrt(||.||^2 + c^2) - c and
    the weight 1 / (sigma_t - sigma_{t-k}).

    ``diffusion`` is the student (its parameters are trained);
    ``teacher_params`` a frozen name -> tensor copy of the teacher's.
    Returns ``loss(batch, generators, target_params, *, t=None, noise=None)
    -> (value, {"consistency": value})`` for ``make_train_step(...,
    loss_takes_ema=True)``; ``t`` and ``noise`` inject the randomness,
    otherwise drawn from ``generators[0]``.
    """
    schedule = diffusion.schedule
    if not 1 <= skip_steps < schedule.n_timesteps:
        raise ValueError(f"skip_steps must be in [1, {schedule.n_timesteps - 1}]"
                         f", got {skip_steps}")
    f = make_consistency_fn(diffusion, sigma_data)
    teacher = {n: v.detach() for n, v in teacher_params.items()}
    k = int(skip_steps)

    def loss(batch, generators, target_params, *, t=None, noise=None):
        x0 = batch["conditions"]
        b = x0.shape[0]
        generator = generators[0] if generators else None
        if t is None:
            t = torch.randint(k, schedule.n_timesteps, (b,),
                              generator=generator, device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                device=x0.device, dtype=x0.dtype)
        x_t = q_sample(schedule, x0, t, noise)
        with torch.no_grad():
            x_prev = teacher_ddim_step(diffusion, teacher, x_t, t, t - k)
            target = f(x_prev, t - k, {n: v.detach() for n, v in
                                       target_params.items()})
        pred = f(x_t, t)
        c = huber_c
        if c is None:  # iCT: c = 0.00054 sqrt(data dim)
            c = 0.00054 * float(np.sqrt(np.prod(x0.shape[1:])))
        d = torch.sqrt(((pred - target) ** 2).sum(dim=(1, 2)) + c * c) - c
        w = 1.0 / torch.clamp(sigma_of_t(schedule, t)
                              - sigma_of_t(schedule, t - k), min=1e-4)
        value = (w * d).mean()
        return value, {"consistency": value}

    return loss


def consistency_noise_levels(n_timesteps: int, n_steps: int,
                             rho: float = 2.0) -> np.ndarray:
    """Descending chain steps of an N-call plan: the chain top, then
    round((T-1) ((N-i)/N)^rho) for i = 1..N-1, colliding levels and t = 0
    dropped (consistency.py:190-207)."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    levels = [n_timesteps - 1]
    for i in range(1, n_steps):
        lvl = max(1, int(round((n_timesteps - 1)
                               * ((n_steps - i) / n_steps) ** rho)))
        if lvl < levels[-1]:
            levels.append(lvl)
    return np.asarray(levels, np.int64)


def make_consistency_sampler(diffusion: GaussianDiffusion, *,
                             n_steps: int = 4, projection=None,
                             rho: float = 2.0, sigma_data: float = 0.5):
    """Few-call plan with make_sampler's signature, ``plan(generator,
    conditions, P=None, stats=None, *, init_noise=None, step_noise=None)``,
    on the STUDENT's weights (consistency.py:210-289). Each call estimates
    x0, projects it at that call's chain step and re-imposes the
    conditions; the next call re-noises the estimate to its level through
    q_sample and re-imposes them again. ``init_noise`` (B, H, D) is the
    first call's draw, ``step_noise`` (len(levels) - 1, B, H, D) the
    re-noising draws, as the JAX plan takes them from ``split(rng,
    n_steps)``'s keys in order; ``plan.draw(generator, batch)`` returns
    both as a plan draws them."""
    from dadiff_tpu_torch.ops.projection import (
        apply_projection,
        projection_alpha,
    )

    schedule = diffusion.schedule
    device = diffusion.device
    f = make_consistency_fn(diffusion, sigma_data)
    levels = torch.as_tensor(
        consistency_noise_levels(schedule.n_timesteps, n_steps, rho),
        device=device)
    H, D = diffusion.horizon, diffusion.transition_dim
    use_projection = projection is not None and not projection.parity_mode
    wall_grid = (
        torch.as_tensor(projection.wall_grid, dtype=torch.int32, device=device)
        if use_projection and projection.wall_grid is not None else None
    )
    alphas = (projection_alpha(levels, diffusion.n_timesteps,
                               projection.schedule, projection.strength,
                               schedule.betas)
              if use_projection else None)

    @torch.no_grad()
    def plan(generator: Optional[torch.Generator], conditions, P=None,
             stats=None, *, init_noise: Optional[torch.Tensor] = None,
             step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        values = conditions.values
        batch = values.shape[0] if values.ndim == 3 else 1
        if init_noise is None or step_noise is None:
            drawn = draw(generator, batch)
            init_noise = drawn[0] if init_noise is None else init_noise
            step_noise = drawn[1] if step_noise is None else step_noise
        if use_projection:
            P = torch.as_tensor(P, dtype=torch.float32, device=device)
        x = conditions.apply(init_noise.to(device))
        x0 = None
        for i, t in enumerate(levels):
            t_b = t.expand(batch)
            if i > 0:  # re-noise the current estimate down to level t
                x = conditions.apply(q_sample(schedule, x0, t_b,
                                              step_noise[i - 1].to(device)))
            x0 = f(x, t_b)
            if use_projection:
                x0 = apply_projection(
                    x0, P, alphas[i], stats,
                    observation_dim=diffusion.observation_dim,
                    action_dim=diffusion.action_dim,
                    state_dim=projection.state_dim, wall_grid=wall_grid,
                    wall_margin=projection.wall_margin)
            x0 = conditions.apply(x0)
        return x0

    def draw(generator: Optional[torch.Generator], batch: int):
        """(init_noise, step_noise) of a plan of ``batch`` chains: the
        draws :func:`plan` takes from ``generator`` when none are
        injected (inside ``parallel.mesh.batch_rows``, this rank's chains
        of the global batch's draws)."""
        init = draw_rows(lambda m: torch.randn(
            (m, H, D), generator=generator, device=device), batch)
        return init, draw_rows(lambda m: torch.randn(
            (len(levels) - 1, m, H, D), generator=generator, device=device),
            batch, dim=1)

    plan.timesteps = levels
    plan.stochastic = len(levels) > 1
    plan.draw = draw
    return plan
