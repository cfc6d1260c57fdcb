"""Latency-tuned sequential sampler: minimal per-step op count.

Counterpart of the JAX package's models/fast_sampler.py:35
``fast_p_sample_loop``. The timestep-embedding MLP and the schedule gathers
do not depend on the iterate, so both are hoisted out of the loop: all T
embeddings come from one batched MLP call and the per-step DDPM coefficients
from one gather, leaving the body with the fused U-Net trunk
(models/fused_unet.py, one K4 launch per residual block) and the affine
update

    x <- c1 * clip(recip*x - recipm1*eps) + c2 * x + sigma * noise
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dadiff_tpu_torch.models.diffusion import default_timesteps
from dadiff_tpu_torch.models.fused_unet import (
    fused_block_params,
    unet_apply_fused,
)
from dadiff_tpu_torch.ops.schedules import DiffusionSchedule


@torch.no_grad()
def fast_p_sample_loop(unet, schedule: DiffusionSchedule,
                       shape: Tuple[int, ...], *,
                       generator: Optional[torch.Generator] = None,
                       sampling_timesteps: Optional[int] = None,
                       clip_denoised: bool = True,
                       predict_epsilon: bool = True,
                       use_kernel: Optional[bool] = None,
                       init_noise: Optional[torch.Tensor] = None,
                       step_noise: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Drop-in equivalent of ``GaussianDiffusion.p_sample_loop`` with the
    time MLP, the schedule gathers and the block weights' layout hoisted out
    of the loop (fast_sampler.py:35-92). ``use_kernel`` as in
    :func:`unet_apply_fused`."""
    device = schedule.betas.device
    ts = default_timesteps(schedule.n_timesteps, sampling_timesteps, device)
    T, batch = len(ts), shape[0]
    x = (torch.randn(shape, generator=generator, device=device)
         if init_noise is None else init_noise.to(device))
    if step_noise is None:
        step_noise = torch.randn((T,) + tuple(shape), generator=generator,
                                 device=device)
    step_noise = step_noise.to(device)

    t_embs = unet.time_mlp(ts)             # hoisted: (T, time_dim)
    block_params = fused_block_params(unet)
    # hoisted: per-step scalars, on the host so the loop reads no device value
    recip = schedule.sqrt_recip_alphas_cumprod[ts].tolist()
    recipm1 = schedule.sqrt_recipm1_alphas_cumprod[ts].tolist()
    c1 = schedule.posterior_mean_coef1[ts].tolist()
    c2 = schedule.posterior_mean_coef2[ts].tolist()
    sigma = (torch.exp(0.5 * schedule.posterior_log_variance_clipped[ts])
             * (ts != 0)).tolist()

    for i in range(T):
        emb = t_embs[i].expand(batch, -1)
        model_out = unet_apply_fused(unet, x, t_emb=emb, use_kernel=use_kernel,
                                     block_params=block_params)
        x_recon = (recip[i] * x - recipm1[i] * model_out if predict_epsilon
                   else model_out)
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        x = c1[i] * x_recon + c2[i] * x + sigma[i] * step_noise[i]
    return x
