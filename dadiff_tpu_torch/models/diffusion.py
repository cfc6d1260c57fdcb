"""Gaussian diffusion over trajectories: the functional core and the module
that holds the denoiser and the schedule.

Counterpart of the JAX package's models/diffusion.py: p_mean_variance :95,
p_sample :116, default_timesteps :129, p_sample_loop :152 and the
GaussianDiffusion container :323. The module's state dict is the reference
schema: the denoiser's weights under ``model.`` and the 12 schedule buffers
at the top level. ``diffusion_loss`` and DDIM are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from dadiff_tpu_torch.ops.schedules import (
    BUFFER_NAMES,
    DiffusionSchedule,
    make_schedule,
)


def _extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-sample coefficients shaped to broadcast (schedules.py:106-118)."""
    out = a[t]
    if out.dim() == 0:
        return out
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def p_mean_variance(model_out: torch.Tensor, schedule: DiffusionSchedule,
                    x: torch.Tensor, t: torch.Tensor, *,
                    clip_denoised: bool = True, predict_epsilon: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse-step mean and log-variance from the denoiser output
    (diffusion.py:95-113)."""
    if predict_epsilon:
        x_recon = (_extract(schedule.sqrt_recip_alphas_cumprod, t, x.dim()) * x
                   - _extract(schedule.sqrt_recipm1_alphas_cumprod, t, x.dim())
                   * model_out)
    else:
        x_recon = model_out
    if clip_denoised:
        x_recon = x_recon.clamp(-1.0, 1.0)
    mean = (_extract(schedule.posterior_mean_coef1, t, x.dim()) * x_recon
            + _extract(schedule.posterior_mean_coef2, t, x.dim()) * x)
    log_var = _extract(schedule.posterior_log_variance_clipped, t, x.dim())
    return mean, log_var


def p_sample(mean: torch.Tensor, log_var: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Ancestral sample, noise masked at t == 0 (diffusion.py:116-126)."""
    nonzero = (t != 0).to(mean.dtype)
    nonzero = nonzero.reshape(nonzero.shape + (1,) * (mean.dim() - nonzero.dim()))
    return mean + nonzero * torch.exp(0.5 * log_var) * noise


def default_timesteps(n_timesteps: int, sampling_timesteps: Optional[int] = None,
                      device=None) -> torch.Tensor:
    """Descending timesteps S-1 .. 0 for the reverse chain; raises for S <= 0
    or S > n_timesteps (diffusion.py:129-149)."""
    s = n_timesteps if sampling_timesteps is None else int(sampling_timesteps)
    if s <= 0:
        raise ValueError(
            f"sampling_timesteps must be positive, got {s} (zero steps would "
            "return the raw Gaussian init as the 'sample')"
        )
    if s > n_timesteps:
        raise ValueError(
            f"sampling_timesteps ({s}) must be <= trained n_timesteps "
            f"({n_timesteps}); the reference silently indexes out of bounds here."
        )
    return torch.arange(s - 1, -1, -1, dtype=torch.long, device=device)


class GaussianDiffusion(nn.Module):
    """Denoiser + schedule + trajectory dims (diffusion.py:323-453)."""

    def __init__(self, model: nn.Module, horizon: int, observation_dim: int,
                 action_dim: int, n_timesteps: int = 1000,
                 clip_denoised: bool = True, predict_epsilon: bool = True,
                 beta_schedule: str = "cosine",
                 prediction: Optional[str] = None):
        super().__init__()
        if prediction not in (None, "epsilon", "x0"):
            raise NotImplementedError(
                f"prediction={prediction!r} is not ported yet")
        if prediction is not None:
            predict_epsilon = prediction != "x0"
        self.model = model
        self.horizon = horizon
        self.observation_dim = observation_dim
        self.action_dim = action_dim
        self.n_timesteps = n_timesteps
        self.clip_denoised = clip_denoised
        self.predict_epsilon = predict_epsilon
        self.beta_schedule = beta_schedule
        self.prediction = prediction
        sched = make_schedule(n_timesteps, beta_schedule)
        for name in BUFFER_NAMES:
            self.register_buffer(name, getattr(sched, name))

    @property
    def transition_dim(self) -> int:
        return self.observation_dim + self.action_dim

    @property
    def schedule(self) -> DiffusionSchedule:
        return DiffusionSchedule(*(getattr(self, n) for n in BUFFER_NAMES))

    @property
    def device(self) -> torch.device:
        return self.betas.device

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.model(x, t)

    def p_mean_variance(self, x, t):
        return p_mean_variance(
            self.model(x, t), self.schedule, x, t,
            clip_denoised=self.clip_denoised,
            predict_epsilon=self.predict_epsilon,
        )

    @torch.no_grad()
    def p_sample_loop(self, shape: Tuple[int, ...], *,
                      generator: Optional[torch.Generator] = None,
                      sampling_timesteps: Optional[int] = None,
                      init_noise: Optional[torch.Tensor] = None,
                      step_noise: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Full reverse chain (diffusion.py:152-196 and :395-413).
        ``init_noise`` (shape) and ``step_noise`` (n_steps, *shape) fix the
        randomness for parity tests."""
        ts = default_timesteps(self.n_timesteps, sampling_timesteps,
                               self.device)
        x = (torch.randn(shape, generator=generator, device=self.device)
             if init_noise is None else init_noise.to(self.device))
        if step_noise is None:
            step_noise = torch.randn((len(ts),) + tuple(shape),
                                     generator=generator, device=self.device)
        for i, t in enumerate(ts):
            t_b = t.expand(shape[0])
            mean, log_var = self.p_mean_variance(x, t_b)
            x = p_sample(mean, log_var, t_b, step_noise[i])
        return x
