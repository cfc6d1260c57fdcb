"""Progressive distillation (Salimans & Ho, arXiv:2202.00512), discrete
time: each round's student learns to match TWO of its teacher's DDIM steps
with ONE of its own, then teaches the next round at half the step count
(100 -> 50 -> 25 -> 12 -> 6 calls).

Counterpart of the JAX package's models/progressive.py: ddim_grid :47,
pd_pairs :55, _alpha_sigma :69, ddim_jump :79, make_pd_loss :97 and
pd_round_schedule :153. The JAX module records itself as a measured
negative (RESULTS.md: the student never beat the teacher's DDIM grid at a
matched budget); the shipping few-call recipe is consistency distillation.

The student's grid is the EXACT ddim grid of ``make_sampler(...,
sampler="ddim", sampling_timesteps=S)``, so the student plans through the
stock DDIM path. For a student step t -> s with the teacher's midpoint m,
the teacher runs t -> m -> s, and the student's x0 target is the value that
lands its ONE DDIM step on the teacher's endpoint,

    x0* = (x_s - (sigma_s/sigma_t) x_t) / (alpha_s - (sigma_s/sigma_t) alpha_t)

(alpha = sqrt(acp), sigma = sqrt(1 - acp); s = -1 is the clean level,
alpha 1 and sigma 0), under the truncated-SNR weight max(alpha_t^2 /
sigma_t^2, 1).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from dadiff_tpu_torch.models.diffusion import (
    GaussianDiffusion,
    _extract,
    q_sample,
)


def ddim_grid(n_timesteps: int, n_steps: int) -> np.ndarray:
    """Descending chain levels, identical to make_sampler's ddim grid
    (progressive.py:47-52)."""
    taus = np.unique(
        np.linspace(0, n_timesteps - 1, n_steps).round().astype(np.int64))
    return taus[::-1].copy()


def pd_pairs(n_timesteps: int, n_steps: int) -> np.ndarray:
    """(S, 3) int array of (t_hi, t_mid, t_lo) per student step; the
    terminal t_lo is -1 (the clean level) and t_mid is the midpoint level
    the teacher passes through (progressive.py:55-66)."""
    ts = ddim_grid(n_timesteps, n_steps)
    lo = np.concatenate([ts[1:], np.array([-1])])
    mid = np.where(lo >= 0, (ts + lo) // 2, ts // 2)
    mid = np.clip(mid, np.maximum(lo, 0), ts)
    return np.stack([ts, mid, lo], axis=1).astype(np.int64)


def _alpha_sigma(schedule, t: torch.Tensor, ndim: int):
    """(sqrt(acp_t), sqrt(1 - acp_t)) with the t = -1 terminal mapped to the
    clean level, alpha 1 and sigma 0 (progressive.py:69-76)."""
    acp = _extract(schedule.alphas_cumprod, torch.clamp(t, min=0), ndim)
    clean = (t < 0).reshape((-1,) + (1,) * (ndim - 1))
    acp = torch.where(clean, torch.ones_like(acp), acp)
    return torch.sqrt(acp), torch.sqrt(torch.clamp(1.0 - acp, min=0.0))


def _x0_of(diffusion: GaussianDiffusion, out: torch.Tensor, x: torch.Tensor,
           t: torch.Tensor) -> torch.Tensor:
    if not diffusion.predict_epsilon:
        return out
    schedule = diffusion.schedule
    return (_extract(schedule.sqrt_recip_alphas_cumprod, t, x.dim()) * x
            - _extract(schedule.sqrt_recipm1_alphas_cumprod, t, x.dim())
            * out)


def ddim_jump(diffusion: GaussianDiffusion, x: torch.Tensor, t: torch.Tensor,
              t_next: torch.Tensor,
              params: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
    """One deterministic DDIM step t -> t_next, t_next = -1 landing exactly
    on the x0 prediction (progressive.py:79-94). ``params``: a name ->
    tensor dict of the module's parameters in place of its own."""
    schedule = diffusion.schedule
    out = (diffusion(x, t) if params is None
           else functional_call(diffusion, params, (x, t)))
    x0 = _x0_of(diffusion, out, x, t)
    if diffusion.clip_denoised:
        x0 = x0.clamp(-1.0, 1.0)
    recip = _extract(schedule.sqrt_recip_alphas_cumprod, t, x.dim())
    recipm1 = _extract(schedule.sqrt_recipm1_alphas_cumprod, t, x.dim())
    eps = (recip * x - x0) / recipm1
    a_next, s_next = _alpha_sigma(schedule, t_next, x.dim())
    return a_next * x0 + s_next * eps


def make_pd_loss(diffusion: GaussianDiffusion,
                 teacher_params: Dict[str, torch.Tensor],
                 n_student_steps: int) -> Callable:
    """Loss for ONE progressive-distillation round (progressive.py:97-150).

    ``diffusion`` is the student (its parameters are trained);
    ``teacher_params`` a frozen name -> tensor copy of the round's teacher.
    Returns ``loss(batch, generators, *, j=None, noise=None) -> (value,
    {"progressive": value})`` for ``make_train_step``; ``j`` (the student
    step of each sample, an index into ``pd_pairs``) and ``noise`` inject
    the randomness, otherwise drawn from ``generators[0]``: j first, then
    the noise, as the JAX loss draws them from ``split(rng)``'s keys.
    """
    schedule = diffusion.schedule
    pairs = torch.as_tensor(pd_pairs(schedule.n_timesteps, n_student_steps),
                            device=diffusion.device)
    teacher = {n: v.detach() for n, v in teacher_params.items()}

    def loss(batch, generators, *, j=None, noise=None):
        x0 = batch["conditions"]
        b = x0.shape[0]
        generator = generators[0] if generators else None
        if j is None:
            j = torch.randint(0, pairs.shape[0], (b,), generator=generator,
                              device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                device=x0.device, dtype=x0.dtype)
        pick = pairs[j.to(pairs.device)]
        t, t_mid, t_lo = pick[:, 0], pick[:, 1], pick[:, 2]
        x_t = q_sample(schedule, x0, t, noise)

        with torch.no_grad():  # two teacher DDIM steps: t -> mid -> lo
            x_mid = ddim_jump(diffusion, x_t, t, t_mid, teacher)
            x_lo = ddim_jump(diffusion, x_mid, t_mid, t_lo, teacher)

        a_t, s_t = _alpha_sigma(schedule, t, x0.dim())
        a_lo, s_lo = _alpha_sigma(schedule, t_lo, x0.dim())
        ratio = s_lo / s_t
        denom = a_lo - ratio * a_t
        # degenerate adjacent-level pairs have denom ~ 0 (not on sane grids)
        denom = torch.where(denom.abs() < 1e-6,
                            torch.full_like(denom, 1e-6), denom)
        x0_star = (x_lo - ratio * x_t) / denom

        x0_pred = _x0_of(diffusion, diffusion(x_t, t), x_t, t)
        w = torch.clamp((a_t / s_t) ** 2, min=1.0)
        value = (w * (x0_pred - x0_star) ** 2).mean()
        return value, {"progressive": value}

    return loss


def pd_round_schedule(n_timesteps: int, target_steps: int) -> list:
    """Halving schedule from the full chain down to ``target_steps``, e.g.
    T=100, target 6 -> [50, 25, 12, 6] (progressive.py:153-165)."""
    if not 1 <= target_steps < n_timesteps:
        raise ValueError(
            f"target_steps must be in [1, {n_timesteps - 1}], got "
            f"{target_steps}")
    rounds = []
    s = n_timesteps
    while s > target_steps:
        s = max(target_steps, s // 2)
        rounds.append(s)
    return rounds
