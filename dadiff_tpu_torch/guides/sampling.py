"""The sampling engine: conditioning, guidance and per-step dynamics
projection around the DDPM, DDIM, DPM-Solver++(2M) and consistency
samplers, with receding-horizon warm start.

Counterpart of the JAX package's guides/sampling.py: Conditions :33,
conditions_for_initial_obs(_np) :48-80, ProjectionSpec :83 and make_sampler
:114-433. There a plan is one jitted ``lax.scan``; here it is a Python loop
over the chain's steps whose tensors stay on the diffusion module's device.
This sampler is also the plain version of the planner chain
(ops/planner.py), which runs the DDPM branch only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dadiff_tpu_torch.models.diffusion import (
    GaussianDiffusion,
    ddim_timesteps,
    ddim_update,
    default_timesteps,
    p_mean_variance,
    q_sample,
)
from dadiff_tpu_torch.ops.projection import (
    NormStats,
    apply_projection,
    projection_alpha,
)


class Conditions(NamedTuple):
    """Inpainting conditions: rows where ``mask`` is set take ``values``."""

    values: torch.Tensor  # (H, D) or (B, H, D)
    mask: torch.Tensor    # (H,) bool

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        values = torch.as_tensor(self.values, dtype=x.dtype, device=x.device)
        if values.dim() == x.dim() - 1:
            values = values[None]
        mask = torch.as_tensor(self.mask, device=x.device)
        return torch.where(mask[None, :, None], values, x)


def conditions_for_initial_obs(normed_obs: torch.Tensor, observation_dim: int,
                               horizon: int, transition_dim: int) -> Conditions:
    """Row 0 conditioned on the observation with its action slot zeroed
    (sampling.py:48-62)."""
    normed_obs = torch.atleast_2d(torch.as_tensor(normed_obs,
                                                  dtype=torch.float32))
    batch = normed_obs.shape[0]
    values = torch.zeros(batch, horizon, transition_dim, dtype=torch.float32,
                         device=normed_obs.device)
    values[:, 0, :observation_dim] = normed_obs
    # built on the device without a host copy: capturable in a CUDA graph
    mask = torch.arange(horizon, device=normed_obs.device) == 0
    return Conditions(values=values, mask=mask)


def conditions_for_initial_obs_np(normed_obs, observation_dim: int,
                                  horizon: int, transition_dim: int
                                  ) -> Conditions:
    """Numpy twin of :func:`conditions_for_initial_obs` for the policy's
    replan path (sampling.py:65-80)."""
    normed_obs = np.atleast_2d(np.asarray(normed_obs, np.float32))
    batch = normed_obs.shape[0]
    values = np.zeros((batch, horizon, transition_dim), np.float32)
    values[:, 0, :observation_dim] = normed_obs
    mask = np.zeros((horizon,), bool)
    mask[0] = True
    return Conditions(values=values, mask=mask)


@dataclasses.dataclass(frozen=True)
class ProjectionSpec:
    """Static projection configuration (sampling.py:83-111). With
    ``parity_mode`` the sampler is built without per-step projection: the
    reference's as-implemented sampling."""

    state_dim: int
    schedule: str = "noise_schedule"
    strength: float = 1.0
    parity_mode: bool = False
    wall_grid: Optional[Tuple[Tuple[int, ...], ...]] = None
    wall_margin: Optional[float] = None


SAMPLERS = ("ddpm", "ddim", "dpmpp", "consistency")


def fewstep_timesteps(schedule, sampler: str,
                      sampling_timesteps: Optional[int], device=None
                      ) -> torch.Tensor:
    """The descending chain steps of the ddim or dpmpp sampler
    (sampling.py:177-203): ddim the unique rounded linspace; dpmpp the steps
    nearest a grid uniform in half-logSNR, its bounds clipped as the solver
    clips them (:184-199)."""
    n = schedule.n_timesteps
    s = n if sampling_timesteps is None else int(sampling_timesteps)
    if s > n:
        raise ValueError(f"sampling_timesteps ({s}) must be <= {n}")
    if sampler == "ddim":
        return ddim_timesteps(n, s, device)
    if s >= n:
        taus = np.arange(n)
    else:
        acp = np.asarray(schedule.alphas_cumprod.cpu(), np.float64)
        a_cl = np.clip(acp, 1e-7, 1.0 - 1e-6)
        lams = 0.5 * (np.log(a_cl) - np.log1p(-a_cl))
        grid = np.linspace(lams[n - 1], lams[0], s)
        taus = np.unique([int(np.argmin(np.abs(lams - g))) for g in grid])
    return torch.as_tensor(taus[::-1].copy(), device=device)


def _half_log_snr(a: torch.Tensor) -> torch.Tensor:
    """lambda = log(alpha / sigma); the upper clip stays below 1 in float32
    (sampling.py:301-305)."""
    a = torch.clamp(a, 1e-7, 1.0 - 1e-6)
    return 0.5 * (torch.log(a) - torch.log1p(-a))


def make_sampler(diffusion: GaussianDiffusion, *,
                 guide_fn: Optional[Callable] = None,
                 guide_weight: float = 1.0,
                 projection: Optional[ProjectionSpec] = None,
                 sampling_timesteps: Optional[int] = None,
                 sampler: str = "ddpm", ddim_eta: float = 0.0,
                 warm_start_from: Optional[int] = None):
    """Build ``plan(generator, conditions, P=None, stats=None, *,
    x_init=None, init_noise=None, step_noise=None) -> (B, H, D)``
    (sampling.py:114-433).

    ``sampler``: ``ddpm`` the ancestral chain; ``ddim`` the strided DDIM
    update (``ddim_eta``); ``dpmpp`` DPM-Solver++(2M), deterministic and
    second order on a half-logSNR grid; ``consistency`` the few-call
    sampler of a distilled student (models/consistency.py), where
    ``sampling_timesteps`` is the model-call budget (default 4).
    ``guide_fn(x, t) -> (B,)`` steers each step by the gradient of its sum:
    DDPM adds ``guide_weight * exp(log_var) * grad`` to the mean (the
    variance, not sigma), DDIM and DPM++ subtract ``guide_weight *
    sqrt(1 - abar_t) * grad`` from eps.

    ``warm_start_from=K``: the plan needs ``x_init``, a normalized
    trajectory (the previous plan shifted by the executed steps), which is
    forward-noised to the first kept timestep and denoised through the
    chain's timesteps below K only.

    ``init_noise`` (B, H, D) is the draw of the initial noise (on a warm
    start, the noise of the forward step); ``step_noise`` (n_steps, B, H, D)
    the per-step draws of the stochastic samplers (ddpm, ddim with eta > 0);
    the deterministic ones draw none (sampling.py:261-269).
    ``plan.draw(generator, batch)`` returns the two draws a plan of
    ``batch`` chains takes from ``generator``.
    """
    schedule = diffusion.schedule
    device = diffusion.device
    if sampler == "consistency":
        from dadiff_tpu_torch.models.consistency import (
            make_consistency_sampler,
        )

        if guide_fn is not None and guide_weight > 0:
            raise ValueError(
                "the consistency sampler does not support gradient guidance "
                "(no posterior mean to steer); use projection/best-of-N")
        if warm_start_from is not None:
            raise ValueError("consistency sampling is already few-step; it "
                             "does not compose with --warm-start-t")
        return make_consistency_sampler(
            diffusion,
            n_steps=int(sampling_timesteps) if sampling_timesteps else 4,
            projection=projection)
    if sampler in ("ddim", "dpmpp"):
        ts = fewstep_timesteps(schedule, sampler, sampling_timesteps, device)
    elif sampler == "ddpm":
        ts = default_timesteps(diffusion.n_timesteps, sampling_timesteps,
                               device)
    else:
        raise ValueError(f"Unknown sampler: {sampler}")

    warm = warm_start_from is not None
    if warm:
        k = int(warm_start_from)
        if not 0 < k <= schedule.n_timesteps:
            raise ValueError(f"warm_start_from must be in "
                             f"[1, {schedule.n_timesteps}], got {k}")
        if not bool((ts < k).any()):
            raise ValueError(f"no sampling timesteps below warm_start_from={k} "
                             f"(chain timesteps: {ts.tolist()})")
        ts = ts[ts < k]
    n_steps = len(ts)
    H, D = diffusion.horizon, diffusion.transition_dim
    use_projection = projection is not None and not projection.parity_mode
    use_guidance = guide_fn is not None and guide_weight > 0
    stochastic = sampler == "ddpm" or (sampler == "ddim" and ddim_eta != 0.0)
    wall_grid = (
        torch.as_tensor(projection.wall_grid, dtype=torch.int32, device=device)
        if use_projection and projection.wall_grid is not None else None
    )
    alphas = (
        projection_alpha(ts, diffusion.n_timesteps, projection.schedule,
                         projection.strength, schedule.betas)
        if use_projection else None
    )
    acp = schedule.alphas_cumprod
    c1s = schedule.sqrt_recip_alphas_cumprod
    c2s = schedule.sqrt_recipm1_alphas_cumprod

    def guide_grad(x, t_b):
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(True)
            return torch.autograd.grad(guide_fn(x_, t_b).sum(), x_)[0]

    def eps_of(out, x, t):
        return out if diffusion.predict_epsilon else (c1s[t] * x - out) / c2s[t]

    @torch.no_grad()
    def plan(generator: Optional[torch.Generator], conditions: Conditions,
             P=None, stats: Optional[NormStats] = None, *,
             x_init=None, init_noise: Optional[torch.Tensor] = None,
             step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        values = np.asarray(conditions.values) if not torch.is_tensor(
            conditions.values) else conditions.values
        batch = values.shape[0] if values.ndim == 3 else 1
        shape = (batch, H, D)
        if init_noise is None or (stochastic and step_noise is None):
            drawn = draw(generator, batch)
            init_noise = drawn[0] if init_noise is None else init_noise
            step_noise = drawn[1] if step_noise is None else step_noise
        noise0 = init_noise.to(device)
        if warm:
            if x_init is None:
                raise ValueError(
                    "warm-start sampler requires x_init (the previous "
                    "normalized plan, shifted by the executed steps)")
            x_init = torch.as_tensor(x_init, dtype=torch.float32,
                                     device=device).expand(shape)
            x = q_sample(schedule, x_init, ts[0].expand(batch), noise0)
        else:
            x = noise0
        x = conditions.apply(x)
        if use_projection:
            P = torch.as_tensor(P, dtype=torch.float32, device=device)
        if sampler == "dpmpp":  # no host-to-device copy: graph-capturable
            x0_prev, h_prev = torch.zeros_like(x), x.new_full((), -1.0)
        for i, t in enumerate(ts):
            t_b = t.expand(batch)
            last = i == n_steps - 1
            out = diffusion(x, t_b)
            if sampler == "ddpm":
                mean, log_var = p_mean_variance(
                    out, schedule, x, t_b,
                    clip_denoised=diffusion.clip_denoised,
                    predict_epsilon=diffusion.predict_epsilon)
                if use_guidance:
                    mean = mean + guide_weight * torch.exp(log_var) \
                        * guide_grad(x, t_b)
                x = mean + (t != 0).to(x.dtype) * torch.exp(0.5 * log_var) \
                    * step_noise[i].to(device)
            else:
                eps = eps_of(out, x, t)
                if use_guidance:
                    eps = eps - guide_weight * torch.sqrt(1.0 - acp[t]) \
                        * guide_grad(x, t_b)
                x0 = c1s[t] * x - c2s[t] * eps
                a_t = acp[t]
                a_next = acp.new_ones(()) if last else acp[ts[i + 1]]
                if diffusion.clip_denoised:
                    x0 = x0.clamp(-1.0, 1.0)
                if sampler == "ddim":
                    if diffusion.clip_denoised:
                        eps = (c1s[t] * x - x0) / c2s[t]
                    x = ddim_update(eps, x0, a_t, a_next, last, ddim_eta,
                                    step_noise[i].to(device) if stochastic
                                    else None)
                else:  # DPM-Solver++(2M), sampling.py:279-328
                    h = _half_log_snr(a_next) - _half_log_snr(a_t)
                    r = h_prev / torch.where(h == 0, torch.ones_like(h), h)
                    inv = 1.0 / (2.0 * torch.clamp(r, min=1e-8))
                    d = torch.where(h_prev > 0,
                                    (1.0 + inv) * x0 - inv * x0_prev, x0)
                    sig_t = torch.sqrt(torch.clamp(1.0 - a_t, min=1e-12))
                    sig_next = torch.sqrt(torch.clamp(1.0 - a_next, min=0.0))
                    # the last step lands on the clean estimate, first order
                    # (lower_order_final)
                    x = x0 if last else (sig_next / sig_t) * x \
                        - torch.sqrt(a_next) * (torch.exp(-h) - 1.0) * d
                    x0_prev, h_prev = x0, h
            if use_projection:
                x = apply_projection(
                    x, P, alphas[i], stats,
                    observation_dim=diffusion.observation_dim,
                    action_dim=diffusion.action_dim,
                    state_dim=projection.state_dim,
                    wall_grid=wall_grid, wall_margin=projection.wall_margin,
                )
            x = conditions.apply(x)
        return x

    def draw(generator: Optional[torch.Generator], batch: int):
        """(init_noise, step_noise or None) of a plan of ``batch`` chains:
        the draws :func:`plan` takes from ``generator`` when none are
        injected."""
        shape = (batch, H, D)
        init = torch.randn(shape, generator=generator, device=device)
        return init, (torch.randn((n_steps,) + shape, generator=generator,
                                  device=device) if stochastic else None)

    plan.timesteps = ts
    plan.stochastic = stochastic
    plan.draw = draw
    return plan
