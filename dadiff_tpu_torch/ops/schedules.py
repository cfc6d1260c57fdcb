"""Noise schedules and the derived DDPM coefficients.

Counterpart of the JAX package's ops/schedules.py (DiffusionSchedule :20,
cosine_beta_schedule :44, linear_beta_schedule :54, schedule_from_betas :61,
make_schedule :95). Everything is built on the host in float64 and cast to
float32 once, which keeps the high-beta end of the cosine schedule equal to
the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

BUFFER_NAMES = (
    "betas",
    "alphas",
    "alphas_cumprod",
    "alphas_cumprod_prev",
    "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod",
    "posterior_variance",
    "posterior_log_variance_clipped",
    "posterior_mean_coef1",
    "posterior_mean_coef2",
)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The 12 DDPM coefficient buffers, each float32 of shape (n_timesteps,)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def n_timesteps(self) -> int:
        return int(self.betas.shape[0])



def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule (schedules.py:44-51)."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0001, 0.9999)


def linear_beta_schedule(timesteps: int, beta_start: float = 1e-4,
                         beta_end: float = 0.02) -> np.ndarray:
    """Ho et al. linear schedule (schedules.py:54-58)."""
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)


def schedule_from_betas(betas: np.ndarray,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> DiffusionSchedule:
    """All DDPM coefficients from betas, in float64, cast to float32
    (schedules.py:61-92)."""
    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.concatenate([np.ones(1), acp[:-1]])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    values = (
        betas,
        alphas,
        acp,
        acp_prev,
        np.sqrt(acp),
        np.sqrt(1.0 - acp),
        np.sqrt(1.0 / acp),
        np.sqrt(1.0 / acp - 1.0),
        post_var,
        np.log(np.clip(post_var, 1e-20, None)),
        betas * np.sqrt(acp_prev) / (1.0 - acp),
        (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
    )
    return DiffusionSchedule(*(
        torch.tensor(v, dtype=torch.float32, device=device) for v in values
    ))


def make_schedule(n_timesteps: int, beta_schedule: str = "cosine",
                  device: Optional[Union[str, torch.device]] = None
                  ) -> DiffusionSchedule:
    """Schedule by name, 'linear' or 'cosine' (schedules.py:95-103)."""
    if beta_schedule == "linear":
        betas = linear_beta_schedule(n_timesteps)
    elif beta_schedule == "cosine":
        betas = cosine_beta_schedule(n_timesteps)
    else:
        raise ValueError(f"Unknown beta schedule: {beta_schedule}")
    return schedule_from_betas(betas, device)
