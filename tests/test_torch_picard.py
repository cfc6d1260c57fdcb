"""Picard (parallel-in-time) sampling, models/parallel_sampling.py, held
against the JAX package's parallel_sample_loop and against the sequential
chain on the CPU, on the same draws: exact at convergence, within the JAX
test's 0.05 at tol 1e-2 with JAX's sweep count, a window larger than the
chain, the sweep cap, and the refused ``time_shard_axis``.

Models: the JAX test's tiny U-Net (dim 8, mults (1, 2), horizon 8, T = 20)
with seeded weights (tests/torch_jax_models.py) carried over by
``params_from_jax``, and its smooth analytic denoiser
(eps = 0.1 x, cosine T = 50), on which the window advances several
positions a sweep. Tolerances: 1e-4 at convergence (the JAX test's own),
0.05 at tol 1e-2 (ditto).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.diffusion import p_sample_loop as jax_p_sample_loop
from dadiff_tpu.models.parallel_sampling import (
    parallel_sample_loop as jax_parallel,
)
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.ops.schedules import make_schedule as jax_schedule

from dadiff_tpu_torch.io.torch_compat import params_from_jax
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
from dadiff_tpu_torch.models.parallel_sampling import parallel_sample_loop
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from tests.torch_jax_models import seeded_params

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

H, D, T_STEPS = 8, 5, 20
TOL_EXACT, TOL_PRACTICAL = 1e-4, 0.05


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _models():
    jdiff = JaxDiffusion(model=JaxUnet(transition_dim=D, dim=8,
                                       dim_mults=(1, 2)),
                         horizon=H, observation_dim=3, action_dim=2,
                         n_timesteps=T_STEPS)
    params = seeded_params(jdiff.model, H)
    diff = GaussianDiffusion(TemporalUnet(D, dim=8, dim_mults=(1, 2)),
                             horizon=H, observation_dim=3, action_dim=2,
                             n_timesteps=T_STEPS).eval()
    diff.model.load_state_dict(params_from_jax(params), strict=True)
    return jdiff, params, diff


def _draws(seed, batch, steps=T_STEPS):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, H, D).astype(np.float32),
            rng.randn(steps, batch, H, D).astype(np.float32))


def _both(tol, window, seed=1, batch=2, **kw):
    """(port, its sweeps, JAX, its sweeps, the port's sequential chain) on
    the same draws."""
    jdiff, params, diff = _models()
    init, noise = _draws(seed, batch)
    shape = (batch, H, D)
    got, sweeps = parallel_sample_loop(
        diff, diff.schedule, shape, window=window, tol=tol,
        init_noise=_t(init), step_noise=_t(noise), return_sweeps=True, **kw)
    want, jsweeps = jax_parallel(
        jdiff.apply, params, jdiff.schedule, jax.random.PRNGKey(0), shape,
        window=window, tol=tol, init_noise=jnp.asarray(init),
        step_noise=jnp.asarray(noise), return_sweeps=True, **kw)
    seq = diff.p_sample_loop(shape, init_noise=_t(init), step_noise=_t(noise))
    return got, sweeps, np.asarray(want), int(jsweeps), seq


@pytest.mark.parametrize("tol,window", [(0.0, 20), (0.0, 32), (1e-6, 16)])
def test_converged_equals_the_sequential_chain_and_jax(tol, window):
    """At tol 0 no position counts as converged and the window stays put,
    so a window of at least T runs its 2T sweeps to the exact chain; at the
    JAX test's 1e-6 (window 16 < T) the window advances as positions stop
    moving. Either way: the sequential chain, and JAX's, to 1e-4."""
    got, sweeps, want, jsweeps, seq = _both(tol, window)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=TOL_EXACT)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_EXACT)
    assert sweeps <= 2 * T_STEPS
    if tol == 0.0:
        assert sweeps == jsweeps == 2 * T_STEPS


@pytest.mark.parametrize("window", [4, 16])
def test_practical_tol_is_close_with_jax_sweeps(window):
    """tol 1e-2 (the bench's): within the JAX test's 0.05 of the sequential
    chain, with JAX's sweep count."""
    got, sweeps, want, jsweeps, seq = _both(1e-2, window, seed=4, batch=1)
    assert float((got - seq).abs().max()) < TOL_PRACTICAL
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_EXACT)
    assert sweeps == jsweeps


class _Shrink(torch.nn.Module):
    """The JAX test's smooth eps-prediction: shrink toward 0."""

    def forward(self, x, t):
        return 0.1 * x


def test_smooth_model_converges_in_fewer_sweeps_than_steps():
    """The regime trained models live in: far fewer sweeps than T=50, the
    same sweeps and sample as JAX, within 0.05 of the sequential chain."""
    steps, shape = 50, (1, H, D)
    init, noise = _draws(7, 1, steps)
    diff = GaussianDiffusion(_Shrink(), horizon=H, observation_dim=3,
                             action_dim=2, n_timesteps=steps)
    got, sweeps = parallel_sample_loop(
        diff, diff.schedule, shape, window=25, tol=1e-3,
        init_noise=_t(init), step_noise=_t(noise), return_sweeps=True)
    want, jsweeps = jax_parallel(
        lambda p, x, t: 0.1 * x, None, jax_schedule(steps, "cosine"),
        jax.random.PRNGKey(0), shape, window=25, tol=1e-3,
        init_noise=jnp.asarray(init), step_noise=jnp.asarray(noise),
        return_sweeps=True)
    seq = jax_p_sample_loop(lambda p, x, t: 0.1 * x, None,
                            jax_schedule(steps, "cosine"),
                            jax.random.PRNGKey(0), shape,
                            init_noise=jnp.asarray(init),
                            step_noise=jnp.asarray(noise))
    assert sweeps < steps and sweeps == int(jsweeps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(np.abs(got.numpy() - np.asarray(seq)).max()) < TOL_PRACTICAL


def test_window_larger_than_the_chain():
    """A window past T is cut to T (W = min(window, T)), as in JAX."""
    got, sweeps, want, jsweeps, seq = _both(1e-6, 64)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=TOL_EXACT)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_EXACT)
    assert sweeps == jsweeps


def test_sweep_cap_and_strided_chain_as_jax():
    """``max_sweeps`` stops the loop where JAX's stops, on a chain of
    ``sampling_timesteps`` steps, with the result JAX's."""
    jdiff, params, diff = _models()
    init, noise = _draws(9, 1, 12)
    kw = dict(sampling_timesteps=12, window=5, tol=1e-6, max_sweeps=3)
    got, sweeps = parallel_sample_loop(
        diff, diff.schedule, (1, H, D), init_noise=_t(init),
        step_noise=_t(noise), return_sweeps=True, **kw)
    want, jsweeps = jax_parallel(
        jdiff.apply, params, jdiff.schedule, jax.random.PRNGKey(0),
        (1, H, D), init_noise=jnp.asarray(init),
        step_noise=jnp.asarray(noise), return_sweeps=True, **kw)
    assert sweeps == int(jsweeps) == 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_EXACT)


def test_draws_from_a_generator_and_refuses_time_sharding():
    _, _, diff = _models()
    shape = (1, H, D)
    a = parallel_sample_loop(diff, diff.schedule, shape,
                             generator=torch.Generator().manual_seed(3))
    b = parallel_sample_loop(diff, diff.schedule, shape,
                             generator=torch.Generator().manual_seed(3))
    assert a.shape == shape and torch.isfinite(a).all() and torch.equal(a, b)
    # without a mesh the time sharding is a no-op, as in JAX
    # (parallel_sampling.py:70-76)
    c = parallel_sample_loop(diff, diff.schedule, shape,
                             generator=torch.Generator().manual_seed(3),
                             time_shard_axis="pt")
    assert torch.equal(a, c)


def test_bench_picard_on_the_cpu(tmp_path):
    """The bench's rows at a tiny width: finite chain times, the sweeps,
    and the Picard chain within 0.05 of the sequential one; it refuses to
    write the TPU's results file."""
    from dadiff_tpu_torch import bench_picard

    out = bench_picard.main(["--dims", "8", "--device", "cpu", "--out",
                             str(tmp_path / "p.json")])
    row = out["rows"][0]
    assert row["dim"] == 8 and row["sequential_chain_ms"] > 0
    assert 1 <= row["sweeps"] <= 200 and row["max_abs_diff"] < TOL_PRACTICAL
    assert (tmp_path / "p.json").is_file()
    with pytest.raises(SystemExit, match="TPU"):
        bench_picard.main(["--device", "cpu", "--out",
                           "results/picard_crossover.json"])
