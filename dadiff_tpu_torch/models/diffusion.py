"""Gaussian diffusion over trajectories: the functional core and the module
that holds the denoiser and the schedule.

Counterpart of the JAX package's models/diffusion.py: q_sample :38,
predict_start_from_noise :50, v_from_x0_eps :60, epsilon_from_v :71,
q_posterior :82, p_mean_variance :95, p_sample :116, default_timesteps
:129, p_sample_loop :152, ddim_sample_loop :199, diffusion_loss :274 and
the GaussianDiffusion container :323. The module's state dict is the reference schema: the
denoiser's weights under ``model.`` and the 12 schedule buffers at the top
level.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from dadiff_tpu_torch.ops.schedules import (
    BUFFER_NAMES,
    DiffusionSchedule,
    make_schedule,
)
from dadiff_tpu_torch.parallel.mesh import draw_rows


def _extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-sample coefficients shaped to broadcast (schedules.py:106-118)."""
    out = a[t]
    if out.dim() == 0:
        return out
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def q_sample(schedule: DiffusionSchedule, x_start: torch.Tensor,
             t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) (diffusion.py:38-47)."""
    c1 = _extract(schedule.sqrt_alphas_cumprod, t, x_start.dim())
    c2 = _extract(schedule.sqrt_one_minus_alphas_cumprod, t, x_start.dim())
    return c1 * x_start + c2 * noise


def predict_start_from_noise(schedule: DiffusionSchedule, x_t: torch.Tensor,
                             t: torch.Tensor, noise: torch.Tensor
                             ) -> torch.Tensor:
    """x_0 estimate from x_t and predicted noise (diffusion.py:50-57)."""
    return (_extract(schedule.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
            - _extract(schedule.sqrt_recipm1_alphas_cumprod, t, x_t.dim())
            * noise)


def v_from_x0_eps(schedule: DiffusionSchedule, x_start: torch.Tensor,
                  noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """v-parameterization target, v = sqrt(abar_t) eps - sqrt(1 - abar_t) x_0
    (diffusion.py:60-68)."""
    c1 = _extract(schedule.sqrt_alphas_cumprod, t, x_start.dim())
    c2 = _extract(schedule.sqrt_one_minus_alphas_cumprod, t, x_start.dim())
    return c1 * noise - c2 * x_start


def epsilon_from_v(schedule: DiffusionSchedule, x_t: torch.Tensor,
                   v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A v-prediction as the equivalent epsilon-prediction,
    eps = sqrt(1 - abar_t) x_t + sqrt(abar_t) v (diffusion.py:71-79)."""
    c1 = _extract(schedule.sqrt_one_minus_alphas_cumprod, t, x_t.dim())
    c2 = _extract(schedule.sqrt_alphas_cumprod, t, x_t.dim())
    return c1 * x_t + c2 * v


def q_posterior(schedule: DiffusionSchedule, x_start: torch.Tensor,
                x_t: torch.Tensor, t: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior q(x_{t-1} | x_t, x_0) mean and log-variance
    (diffusion.py:82-92)."""
    mean = (_extract(schedule.posterior_mean_coef1, t, x_t.dim()) * x_start
            + _extract(schedule.posterior_mean_coef2, t, x_t.dim()) * x_t)
    log_var = _extract(schedule.posterior_log_variance_clipped, t, x_t.dim())
    return mean, log_var


def diffusion_loss(apply_fn: Callable, schedule: DiffusionSchedule,
                   x_start: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   loss_type: str = "l2", predict_epsilon: bool = True,
                   prediction: Optional[str] = None,
                   weights: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training loss with uniform random t (diffusion.py:274-316).
    ``apply_fn(x, t)`` is the denoiser; with ``prediction="v"`` it must be
    the RAW model, not an epsilon-wrapped one. ``t`` and ``noise`` inject the
    randomness; otherwise both are drawn from ``generator``, which must live
    on ``x_start``'s device (for the global batch inside
    ``parallel.mesh.batch_rows``, this rank's rows kept)."""
    n, rest = x_start.shape[0], tuple(x_start.shape[1:])
    if t is None:
        t = draw_rows(lambda m: torch.randint(
            0, schedule.n_timesteps, (m,), generator=generator,
            device=x_start.device), n)
    if noise is None:
        noise = draw_rows(lambda m: torch.randn(
            (m,) + rest, generator=generator, device=x_start.device,
            dtype=x_start.dtype), n)
    model_out = apply_fn(q_sample(schedule, x_start, t, noise), t)
    if prediction == "v":
        target = v_from_x0_eps(schedule, x_start, noise, t)
    else:
        target = noise if predict_epsilon else x_start
    if loss_type == "l2":
        loss = (model_out - target) ** 2
    elif loss_type == "l1":
        loss = (model_out - target).abs()
    else:
        raise ValueError(f"Unknown loss type: {loss_type}")
    if weights is not None:
        loss = loss * weights
    return loss.mean()


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
    return q_posterior(schedule, x_recon, x, t)


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


def ddim_timesteps(n_timesteps: int, sampling_timesteps: int,
                   device=None) -> torch.Tensor:
    """The strided DDIM subsequence, descending: the unique rounded
    linspace over 0 .. T-1 (diffusion.py:244-248, sampling.py:200-201)."""
    s = int(sampling_timesteps)
    if s > n_timesteps:
        raise ValueError(f"sampling_timesteps ({s}) must be <= {n_timesteps}")
    taus = np.unique(np.linspace(0, n_timesteps - 1, s).round().astype(np.int64))
    return torch.as_tensor(taus[::-1].copy(), device=device)


def eps_and_x0(model_out: torch.Tensor, schedule: DiffusionSchedule,
               x: torch.Tensor, t: torch.Tensor, *, clip_denoised: bool,
               predict_epsilon: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eps, x0) from the denoiser's output; with ``clip_denoised`` x0 is
    clipped and eps recomputed from it (diffusion.py:236-248)."""
    c1 = _extract(schedule.sqrt_recip_alphas_cumprod, t, x.dim())
    c2 = _extract(schedule.sqrt_recipm1_alphas_cumprod, t, x.dim())
    if predict_epsilon:
        eps, x0 = model_out, c1 * x - c2 * model_out
    else:
        x0 = model_out
        eps = (c1 * x - x0) / c2
    if clip_denoised:
        x0 = x0.clamp(-1.0, 1.0)
        eps = (c1 * x - x0) / c2
    return eps, x0


def ddim_update(eps: torch.Tensor, x0: torch.Tensor, a_t: torch.Tensor,
                a_prev: torch.Tensor, last: bool, eta: float,
                noise: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t_prev} = sqrt(abar_prev) x0 + sqrt(1 - abar_prev - sigma^2) eps
    + sigma noise, with sigma = eta sqrt((1-abar_prev)/(1-abar_t))
    sqrt(1 - abar_t/abar_prev) and no noise on the last step
    (diffusion.py:250-266)."""
    sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t)) \
        * torch.sqrt(1 - a_t / a_prev)
    x = torch.sqrt(a_prev) * x0 \
        + torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)) * eps
    if noise is not None and not last:
        x = x + sigma * noise
    return x


def ddim_sample_loop(apply_fn: Callable, schedule: DiffusionSchedule,
                     shape: Tuple[int, ...], *, sampling_timesteps: int,
                     eta: float = 0.0, clip_denoised: bool = True,
                     predict_epsilon: bool = True,
                     generator: Optional[torch.Generator] = None,
                     init_noise: Optional[torch.Tensor] = None,
                     step_noise: Optional[torch.Tensor] = None,
                     device=None) -> torch.Tensor:
    """DDIM over the strided subsequence (diffusion.py:199-271): eta 0 is
    deterministic, eta 1 DDPM-like on the subsequence. ``init_noise``
    (shape) and ``step_noise`` (n_steps, *shape) fix the randomness; the
    step noise is drawn, as the JAX loop draws it, whatever ``eta``."""
    ts = ddim_timesteps(schedule.n_timesteps, sampling_timesteps, device)
    x = (torch.randn(shape, generator=generator, device=device)
         if init_noise is None else init_noise.to(device))
    if step_noise is None:
        step_noise = torch.randn((len(ts),) + tuple(shape),
                                 generator=generator, device=device)
    acp = schedule.alphas_cumprod
    for i, t in enumerate(ts):
        t_b = t.expand(shape[0])
        eps, x0 = eps_and_x0(apply_fn(x, t_b), schedule, x, t_b,
                             clip_denoised=clip_denoised,
                             predict_epsilon=predict_epsilon)
        last = i == len(ts) - 1
        a_prev = acp.new_ones(()) if last else acp[ts[i + 1]]
        x = ddim_update(eps, x0, acp[t], a_prev, last, eta,
                        step_noise[i].to(x.device))
    return x


class GaussianDiffusion(nn.Module):
    """Denoiser + schedule + trajectory dims (diffusion.py:323-453)."""

    def __init__(self, model: nn.Module, horizon: int, observation_dim: int,
                 action_dim: int, n_timesteps: int = 1000,
                 clip_denoised: bool = True, predict_epsilon: bool = True,
                 beta_schedule: str = "cosine",
                 prediction: Optional[str] = None, loss_type: str = "l2"):
        super().__init__()
        if prediction not in (None, "epsilon", "x0", "v"):
            raise ValueError(f"Unknown prediction mode: {prediction}")
        if prediction is not None:
            # v-models are consumed through the epsilon path (apply wraps)
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
        self.loss_type = loss_type
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
        """The denoiser's output as an epsilon (or x0) prediction: a v-model's
        output is converted (diffusion.py:371-375)."""
        out = self.model(x, t)
        if self.prediction == "v":
            out = epsilon_from_v(self.schedule, x, out, t)
        return out

    def q_sample(self, x_start, t, noise):
        return q_sample(self.schedule, x_start, t, noise)

    def predict_start_from_noise(self, x_t, t, noise):
        return predict_start_from_noise(self.schedule, x_t, t, noise)

    def q_posterior(self, x_start, x_t, t):
        return q_posterior(self.schedule, x_start, x_t, t)

    def loss(self, x_start: torch.Tensor,
             weights: Optional[torch.Tensor] = None, *,
             generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Denoising loss (diffusion.py:433-453). v-mode trains the RAW model
        output against the v target; the epsilon wrapping is for sampling."""
        return diffusion_loss(
            self.model if self.prediction == "v" else self, self.schedule,
            x_start, generator=generator, loss_type=self.loss_type,
            predict_epsilon=self.predict_epsilon, prediction=self.prediction,
            weights=weights, t=t, noise=noise)

    def p_mean_variance(self, x, t):
        return p_mean_variance(
            self(x, t), self.schedule, x, t,
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

    @torch.no_grad()
    def ddim_sample_loop(self, shape: Tuple[int, ...], *,
                         sampling_timesteps: int, eta: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         init_noise: Optional[torch.Tensor] = None,
                         step_noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """DDIM with this module's denoiser and flags (diffusion.py:415)."""
        return ddim_sample_loop(
            self, self.schedule, shape,
            sampling_timesteps=sampling_timesteps, eta=eta,
            clip_denoised=self.clip_denoised,
            predict_epsilon=self.predict_epsilon, generator=generator,
            init_noise=init_noise, step_noise=step_noise, device=self.device)
