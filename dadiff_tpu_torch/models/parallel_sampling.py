"""Parallel-in-time sampling: Picard iteration over the reverse chain
(Shih et al., "Parallel Sampling of Diffusion Models", arXiv:2305.16317).

Counterpart of the JAX package's models/parallel_sampling.py
(parallel_sample_loop :32-156). With the per-step noise fixed, ancestral
sampling is a deterministic composition x_{i+1} = f_i(x_i); a sliding
window of W steps is iterated as a fixed point, one (W*B)-row model call
per sweep, in the integral form

    X[i+1] = X[s] + sum_{j=s..i} d_j(X[j]),   d_j(x) = f_j(x) - x,

and the window start s advances past every leading position whose iterate
moved less than ``tol`` in the sweep. The JAX loop is a ``lax.while_loop``;
here it is a host loop that reads the advance once per sweep.

At ``tol`` 0 no position ever counts as converged, so the window never
moves (as in JAX): with a window of at least T the ``max_sweeps`` (2T)
sweeps reach the sequential chain exactly; with a smaller one the chain
past the window is never computed.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from dadiff_tpu_torch.models.diffusion import (
    default_timesteps,
    p_mean_variance,
    p_sample,
)
from dadiff_tpu_torch.ops.schedules import DiffusionSchedule


@torch.no_grad()
def parallel_sample_loop(
    apply_fn: Callable,
    schedule: DiffusionSchedule,
    shape: Tuple[int, ...],
    *,
    sampling_timesteps: Optional[int] = None,
    window: int = 16,
    tol: float = 1e-2,
    max_sweeps: Optional[int] = None,
    clip_denoised: bool = True,
    predict_epsilon: bool = True,
    generator: Optional[torch.Generator] = None,
    init_noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    return_sweeps: bool = False,
    time_shard_axis: Optional[str] = None,
    device=None,
):
    """Sliding-window Picard iteration (parallel_sampling.py:32-156).

    ``apply_fn(x, t)`` is the denoiser (e.g. a GaussianDiffusion module).
    ``init_noise`` (shape) and ``step_noise`` (T, *shape) fix the
    randomness; otherwise both are drawn from ``generator`` on ``device``,
    the init first, as ``p_sample_loop`` draws them. ``window``: steps
    iterated per sweep; ``tol``: per-position max-abs change below which a
    position counts as converged; ``max_sweeps``: the sweep cap (2T by
    default); ``return_sweeps``: also return the sweeps run (the sequential
    model calls). ``time_shard_axis`` (a device mesh axis in JAX, where it
    is a no-op without a mesh) raises ``NotImplementedError``: the port has
    no mesh yet (ROADMAP.md, Queue 1 item 6)."""
    if time_shard_axis is not None:
        raise NotImplementedError(
            "time_shard_axis needs a device mesh, which is not ported yet "
            "(ROADMAP.md, Queue 1 item 6: parallelism)")
    ts = default_timesteps(schedule.n_timesteps, sampling_timesteps, device)
    T = int(ts.shape[0])
    batch = shape[0]
    W = min(window, T)
    if max_sweeps is None:
        max_sweeps = 2 * T
    x_init = (torch.randn(shape, generator=generator, device=device)
              if init_noise is None else init_noise.to(device))
    if step_noise is None:
        step_noise = torch.randn((T,) + tuple(shape), generator=generator,
                                 device=device)
    step_noise = step_noise.to(x_init.device)

    # X[i]: the iterate of the state BEFORE step i; X[T]: the sample. Padded
    # by W rows, as the JAX buffer is, so a window never runs off the end.
    X = x_init[None].expand((T + 1 + W,) + tuple(shape)).clone()
    ts_pad = torch.cat([ts, ts.new_zeros(W)])
    noise_pad = torch.cat([step_noise, step_noise.new_zeros(
        (W,) + tuple(shape))])
    offsets = torch.arange(W, device=X.device)
    s, sweeps = 0, 0
    while s < T and sweeps < max_sweeps:
        x_win = X[s:s + W]
        x_flat = x_win.reshape((W * batch,) + tuple(shape[1:]))
        t_flat = ts_pad[s:s + W].repeat_interleave(batch)
        mean, log_var = p_mean_variance(
            apply_fn(x_flat, t_flat), schedule, x_flat, t_flat,
            clip_denoised=clip_denoised, predict_epsilon=predict_epsilon)
        stepped = p_sample(mean, log_var, t_flat, noise_pad[s:s + W].reshape(
            x_flat.shape)).reshape(x_win.shape)
        # the integral update: the converged prefix state plus the drifts
        new = X[s][None] + torch.cumsum(stepped - x_win, dim=0)
        old = X[s + 1:s + 1 + W]
        delta = (new - old).abs().reshape(W, -1).amax(dim=1)
        inside = (s + 1 + offsets) <= T   # positions past T: converged
        delta = torch.where(inside, delta, torch.zeros_like(delta))
        X[s + 1:s + 1 + W] = torch.where(
            inside.reshape((W,) + (1,) * len(shape)), new, old)
        n_adv = int(torch.cumprod((delta < tol).to(torch.int32), 0).sum())
        s, sweeps = min(s + n_adv, T), sweeps + 1
    out = X[T]
    return (out, sweeps) if return_sweeps else out
