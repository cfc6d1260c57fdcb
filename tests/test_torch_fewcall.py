"""The port's few-call planners held against the JAX package on the CPU:
``make_sampler``'s ddim, dpmpp, warm-start and guidance branches and
``parity_mode`` (guides/sampling.py), ``ddim_sample_loop``
(models/diffusion.py), and consistency distillation (models/consistency.py):
its functions, the CD loss and its gradient, one Adam step with the EMA
target (utils/training.py ``loss_takes_ema``) and the few-call sampler.

Each JAX plan draws its noise from keys it splits off its rng
(sampling.py:248-269, consistency.py:260-268); the test draws the same keys
and injects the draws into the port. Nothing in the JAX package changes.

Tiny model: dim 8, mults (1, 2), horizon 8, T = 20. Tolerances: 1e-5 for a
single f32 function (a few products summed in another order); chains and
plans 1e-4 (20 U-Net evaluations whose f32 rounding differs between XLA and
PyTorch, each step's error shrunk by the next, and the projection's
physical-space round trip); the CD loss's gradient 1e-4 of its largest
entry (a backward pass through two U-Net evaluations).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dadiff_tpu.dynamics.projection import ProjectionMatrixBuilder as JaxPMB
from dadiff_tpu.guides import sampling as js
from dadiff_tpu.models import consistency as jc
from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.ops import projection as jproj
from dadiff_tpu.utils import training as jt

from dadiff_tpu_torch.guides import sampling as ts
from dadiff_tpu_torch.io.torch_compat import params_from_jax
from dadiff_tpu_torch.models import consistency as tc
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops.projection import NormStats
from dadiff_tpu_torch.utils import training as tt

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

H, OBS, ACT, T_STEPS, STATE = 8, 6, 2, 20, 4
D = OBS + ACT
TOL_FN, TOL_CHAIN = 1e-5, 1e-4
GRID = ((1, 1, 1, 1, 1), (1, 0, 0, 0, 1), (1, 0, 1, 0, 1), (1, 0, 0, 0, 1),
        (1, 1, 1, 1, 1))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    unet = JaxUnet(transition_dim=D, dim=8, dim_mults=(1, 2))
    return _INIT(unet, jax.random.PRNGKey(seed))


_INIT = jax.jit(lambda unet, key: unet.init_params(key, H), static_argnums=0)


def _pair(seed=0):
    """The same model on both sides, weights from one JAX init."""
    jax_diff = JaxDiffusion(model=JaxUnet(transition_dim=D, dim=8,
                                          dim_mults=(1, 2)),
                            horizon=H, observation_dim=OBS, action_dim=ACT,
                            n_timesteps=T_STEPS)
    params = _jax_params(seed)
    diff = GaussianDiffusion(TemporalUnet(transition_dim=D, dim=8,
                                          dim_mults=(1, 2)),
                             horizon=H, observation_dim=OBS, action_dim=ACT,
                             n_timesteps=T_STEPS).eval()
    diff.model.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    return jax_diff, params, diff


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def dyn():
    A = np.eye(STATE) + 0.1 * np.eye(STATE, k=2)
    B = np.zeros((STATE, ACT))
    B[2:, :] = 0.1 * np.eye(ACT)
    P = JaxPMB(A, B, STATE, ACT).get_projection_matrix(H).astype(np.float32)
    stats = (np.zeros(OBS), np.full(OBS, 1.5), np.zeros(ACT), np.ones(ACT))
    jstats = jproj.NormStats(*(jnp.asarray(v, jnp.float32) for v in stats))
    pstats = NormStats(*(torch.tensor(v, dtype=torch.float32) for v in stats))
    return P, jstats, pstats


def _conditions(B, seed):
    obs = np.random.RandomState(seed).randn(B, OBS).astype(np.float32)
    jcond = js.conditions_for_initial_obs(jnp.asarray(obs), OBS, H, D)
    return jcond, ts.conditions_for_initial_obs(torch.from_numpy(obs), OBS,
                                                H, D)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sampler_draws(key, shape, n_steps, stochastic):
    """What a JAX make_sampler plan draws from its rng (sampling.py:248-269):
    the initial (or forward-step) noise and, if stochastic, the per-step
    noise."""
    _, init_key, noise_key = jax.random.split(key, 3)
    step = (_t(jax.random.normal(noise_key, (n_steps,) + shape))
            if stochastic else None)
    return _t(jax.random.normal(init_key, shape)), step


def _guides():
    """The same guide on both sides: pull the final position toward (0.5,
    -0.5), more strongly at higher t."""

    def jax_guide(x, t):
        d = x[:, -1, 0:2] - jnp.asarray([0.5, -0.5])
        return -jnp.sum(d * d, axis=-1) * (1.0 + 0.05 * t)

    def port_guide(x, t):
        d = x[:, -1, 0:2] - torch.tensor([0.5, -0.5])
        return -(d * d).sum(-1) * (1.0 + 0.05 * t)

    return jax_guide, port_guide


# ---------------------------------------------------------------------------
# make_sampler and ddim_sample_loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
@pytest.mark.parametrize("steps", [1, 3, 5, 7, 10, T_STEPS, None])
@pytest.mark.parametrize("warm", [None, 8])
def test_timestep_grids_equal_jax(models, sampler, steps, warm):
    jax_diff, _, diff = models
    kw = dict(sampler=sampler, sampling_timesteps=steps,
              warm_start_from=warm)
    try:
        want = js.make_sampler(jax_diff, jit=False, **kw).timesteps
    except ValueError:  # no step below K: the port refuses it too
        with pytest.raises(ValueError, match="no sampling timesteps"):
            ts.make_sampler(diff, **kw)
        return
    got = ts.make_sampler(diff, **kw).timesteps
    assert got.tolist() == np.asarray(want).tolist()


def test_consistency_levels_and_ddpm_warm_grid_equal_jax(models):
    jax_diff, _, diff = models
    for n in range(1, 9):
        assert tc.consistency_noise_levels(T_STEPS, n).tolist() == \
            jc.consistency_noise_levels(T_STEPS, n).tolist()
        got = ts.make_sampler(diff, sampler="consistency",
                              sampling_timesteps=n).timesteps
        assert got.tolist() == jc.consistency_noise_levels(T_STEPS, n).tolist()
    for k in (1, 8, T_STEPS):
        got = ts.make_sampler(diff, warm_start_from=k).timesteps
        want = js.make_sampler(jax_diff, warm_start_from=k, jit=False).timesteps
        assert got.tolist() == np.asarray(want).tolist()


CASES = {
    # name: make_sampler keywords; "proj" projects with the wall grid,
    # "guide" adds the closure guide at weight 0.3; warm starts take x_init
    "ddim_eta0": dict(sampler="ddim", sampling_timesteps=10),
    "ddim_eta05": dict(sampler="ddim", sampling_timesteps=10, ddim_eta=0.5,
                       proj=True),
    "dpmpp_5": dict(sampler="dpmpp", sampling_timesteps=5),
    "dpmpp_10": dict(sampler="dpmpp", sampling_timesteps=10, proj=True),
    "dpmpp_T": dict(sampler="dpmpp"),
    "ddpm_warm8": dict(warm_start_from=8, proj=True),
    "ddim_warm8": dict(sampler="ddim", sampling_timesteps=10, ddim_eta=0.5,
                       warm_start_from=8),
    "ddpm_guided": dict(guide=True),
    "ddim_guided": dict(sampler="ddim", sampling_timesteps=10, guide=True,
                        proj=True),
    "dpmpp_guided": dict(sampler="dpmpp", sampling_timesteps=10, guide=True),
    "ddpm_parity_mode": dict(proj=True, parity=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_make_sampler_matches_jax(models, dyn, case):
    """Both packages plan 3 chains from the same conditions and draws."""
    jax_diff, params, diff = models
    P, jstats, pstats = dyn
    kw = dict(CASES[case])
    proj, guide, parity = (kw.pop(k, False) for k in ("proj", "guide",
                                                       "parity"))
    spec = dict(state_dim=STATE, strength=0.8, parity_mode=parity,
                wall_grid=GRID if proj and not parity else None)
    jspec, pspec = (js.ProjectionSpec(**spec), ts.ProjectionSpec(**spec)) \
        if proj else (None, None)
    jg, pg = _guides() if guide else (None, None)
    jplan = js.make_sampler(jax_diff, projection=jspec, guide_fn=jg,
                            guide_weight=0.3, jit=False, **kw)
    plan = ts.make_sampler(diff, projection=pspec, guide_fn=pg,
                           guide_weight=0.3, **kw)
    assert plan.timesteps.tolist() == np.asarray(jplan.timesteps).tolist()
    jcond, cond = _conditions(3, 11)
    key = jax.random.PRNGKey(5)
    x_init = np.random.RandomState(2).randn(1, H, D).astype(np.float32)
    warm = kw.get("warm_start_from") is not None
    extra = dict(x_init=jnp.asarray(x_init)) if warm else {}
    want = jax.jit(lambda p, k: jplan(p, k, jcond, jnp.asarray(P), jstats,
                                      **extra))(params, key)
    init, step = _sampler_draws(key, (3, H, D), len(plan.timesteps),
                                plan.stochastic)
    got = plan(None, cond, torch.from_numpy(P), pstats, init_noise=init,
               step_noise=step,
               **(dict(x_init=torch.from_numpy(x_init)) if warm else {}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_CHAIN,
                               rtol=TOL_CHAIN)
    if parity:  # parity mode samples as if no projection were given
        free = ts.make_sampler(diff, **kw)(None, cond, init_noise=init,
                                           step_noise=step)
        assert torch.equal(free, got)


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp", "ddpm"])
def test_deterministic_samplers_draw_only_the_initial_noise(models, sampler):
    """A plan from a generator equals the plan from the generator's first
    (B, H, D) draw alone for ddim at eta 0 and dpmpp; ddpm draws its step
    noise after it."""
    _, _, diff = models
    plan = ts.make_sampler(diff, sampler=sampler, sampling_timesteps=5)
    _, cond = _conditions(2, 3)
    drawn = plan(torch.Generator().manual_seed(9), cond)
    g = torch.Generator().manual_seed(9)
    init = torch.randn(2, H, D, generator=g)
    step = torch.randn(5, 2, H, D, generator=g) if plan.stochastic else None
    assert plan.stochastic == (sampler == "ddpm")
    assert torch.equal(drawn, plan(None, cond, init_noise=init,
                                   step_noise=step))


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_matches_jax(models, eta):
    jax_diff, params, diff = models
    key = jax.random.PRNGKey(3)
    want = jax_diff.ddim_sample_loop(params, key, (2, H, D),
                                     sampling_timesteps=7, eta=eta)
    _, init_key, noise_key = jax.random.split(key, 3)
    got = diff.ddim_sample_loop(
        (2, H, D), sampling_timesteps=7, eta=eta,
        init_noise=_t(jax.random.normal(init_key, (2, H, D))),
        step_noise=_t(jax.random.normal(noise_key, (7, 2, H, D))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_CHAIN,
                               rtol=TOL_CHAIN)


def test_make_sampler_refusals(models):
    _, _, diff = models
    _, pg = _guides()
    with pytest.raises(ValueError, match="guidance"):
        ts.make_sampler(diff, sampler="consistency", guide_fn=pg)
    with pytest.raises(ValueError, match="warm-start"):
        ts.make_sampler(diff, sampler="consistency", warm_start_from=5)
    with pytest.raises(ValueError, match="Unknown sampler"):
        ts.make_sampler(diff, sampler="euler")
    with pytest.raises(ValueError, match="no sampling timesteps"):
        ts.make_sampler(diff, sampler="dpmpp", sampling_timesteps=1,
                        warm_start_from=5)
    with pytest.raises(ValueError, match="warm_start_from"):
        ts.make_sampler(diff, warm_start_from=T_STEPS + 1)
    with pytest.raises(ValueError, match="<="):
        ts.make_sampler(diff, sampler="dpmpp", sampling_timesteps=T_STEPS + 1)
    _, cond = _conditions(1, 0)
    with pytest.raises(ValueError, match="x_init"):
        ts.make_sampler(diff, warm_start_from=5)(None, cond)


# ---------------------------------------------------------------------------
# Consistency distillation
# ---------------------------------------------------------------------------

def test_consistency_functions_match_jax(models):
    """sigma_t, the scalings, f on the module's and on given weights, and
    the teacher's DDIM step, at every t."""
    jax_diff, params, diff = models
    _, params2, _ = _pair(seed=1)
    js_, ps_ = jax_diff.schedule, diff.schedule
    t = np.arange(T_STEPS)
    for got, want in ((tc.sigma_of_t(ps_, _t(t)), jc.sigma_of_t(js_, t)),
                      *zip(tc.consistency_scalings(ps_, _t(t), 0.4),
                           jc.consistency_scalings(js_, t, 0.4))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_FN, atol=TOL_FN)
    rng = np.random.RandomState(4)
    x = rng.randn(4, H, D).astype(np.float32)
    tb = np.array([0, 5, 13, 19])
    tprev = np.array([0, 3, 12, 18])
    f = tc.make_consistency_fn(diff, 0.4)
    jf = jax.jit(jc.make_consistency_fn(jax_diff, 0.4))
    jstep = jax.jit(lambda p, *a: jc.teacher_ddim_step(jax_diff, p, *a))
    w2 = {f"model.{k}": v for k, v in params_from_jax(_np_tree(params2)).items()}
    jx, jtb, jtp = jnp.asarray(x), jnp.asarray(tb), jnp.asarray(tprev)
    with torch.no_grad():
        pairs = [
            (f(_t(x), _t(tb)), jf(params, jx, jtb)),
            (f(_t(x), _t(tb), w2), jf(params2, jx, jtb)),
            (tc.teacher_ddim_step(diff, None, _t(x), _t(tb), _t(tprev)),
             jstep(params, jx, jtb, jtp)),
            (tc.teacher_ddim_step(diff, w2, _t(x), _t(tb), _t(tprev)),
             jstep(params2, jx, jtb, jtp)),
        ]
    # an x0 estimate is the model's output times sqrt((1 - abar_t) / abar_t)
    # (besides x / sqrt(abar_t)): its rounding grows by that factor, 1,285
    # at t = T-1 of this schedule, so each row is held to TOL_FN times it
    gain = np.maximum(1.0, diff.schedule.sqrt_recipm1_alphas_cumprod[
        _t(tb)].numpy())
    for got, want in pairs:
        err = np.abs(got.numpy() - np.asarray(want)).max(axis=(1, 2))
        assert (err <= TOL_FN * gain).all(), (err, gain)


def _cd_setup(skip_steps):
    """Student = teacher (seed 0) as distillation starts it, a target that
    has moved away (seed 1), a batch, and the JAX loss's own draws."""
    jax_diff, teacher, diff = _pair()
    _, target, _ = _pair(seed=1)
    x0 = np.random.RandomState(7).uniform(-1, 1, (4, H, D)).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    t_key, n_key = jax.random.split(rng)  # consistency.py:166-168
    t = jax.random.randint(t_key, (4,), skip_steps, T_STEPS)
    noise = jax.random.normal(n_key, x0.shape)
    port_target = {f"model.{k}": v for k, v in
                   params_from_jax(_np_tree(target)).items()}
    teacher_w = {n: p.detach().clone() for n, p in diff.named_parameters()}
    return (jax_diff, teacher, target, diff, port_target, teacher_w, x0, rng,
            _t(t), _t(noise))


def test_cd_loss_value_matches_jax_at_a_wider_gap():
    """skip_steps 3 and a given pseudo-Huber c (the step's test below takes
    the defaults: 1 and iCT's c)."""
    (jax_diff, teacher, target, diff, port_target, teacher_w, x0, rng, t,
     noise) = _cd_setup(3)
    jloss = jc.make_cd_loss(jax_diff, teacher, skip_steps=3, huber_c=0.1)
    want = jax.jit(lambda p, x: jloss(p, {"conditions": x}, rng, target)[0])(
        teacher, jnp.asarray(x0))
    loss = tc.make_cd_loss(diff, teacher_w, skip_steps=3, huber_c=0.1)
    with torch.no_grad():
        got, _ = loss({"conditions": torch.from_numpy(x0)}, None, port_target,
                      t=t, noise=noise)
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL_FN)


def test_cd_gradient_and_adam_step_with_ema_target_match_jax():
    """The CD loss, its gradient, and one step of make_train_step(
    loss_takes_ema=True): clip, Adam, and the EMA update of the target the
    loss saw. The JAX side is that step's own sequence (training.py:
    127-162): the gradient against the EMA slot, optax's clip + Adam, then
    ema_update with the new weights."""
    (jax_diff, teacher, target, diff, port_target, teacher_w, x0, rng, t,
     noise) = _cd_setup(1)
    lr, decay = 1e-3, 0.9
    jloss = jc.make_cd_loss(jax_diff, teacher)
    (want_loss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p, x: jloss(p, {"conditions": x}, rng, target),
        has_aux=True))(teacher, jnp.asarray(x0))
    opt = jt.make_optimizer(jt.warmup_cosine_schedule(lr, 0, 20), 1.0)
    updates, _ = opt.update(jgrad, opt.init(teacher), teacher)
    jparams = optax.apply_updates(teacher, updates)
    want = params_from_jax(_np_tree(jparams))
    want_ema = params_from_jax(_np_tree(jt.ema_update(target, jparams,
                                                      decay)))
    jg = params_from_jax(_np_tree(jgrad))

    cd = tc.make_cd_loss(diff, teacher_w)
    batch = {"conditions": torch.from_numpy(x0)}
    diff.zero_grad()
    cd(batch, None, port_target, t=t, noise=noise)[0].backward()
    scale = max(float(v.abs().max()) for v in jg.values())
    for name, p in diff.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(),
                                   atol=1e-4 * scale, err_msg=name)
    state = tt.TrainState(module=diff,
                          optimizer=tt.make_optimizer(diff.parameters(), lr),
                          ema_params={n: v.clone() for n, v in
                                      port_target.items()})
    step = tt.make_train_step(
        lambda b, g, ema: cd(b, g, ema, t=t, noise=noise),
        lr_schedule=tt.warmup_cosine_schedule(lr, 0, 20), gradient_clip=1.0,
        ema_decay=decay, loss_takes_ema=True)
    m = step(state, batch, [None])
    np.testing.assert_allclose(float(m["consistency"]), float(want_loss),
                               rtol=TOL_FN)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(optax.global_norm(jgrad)), rtol=TOL_FN)
    # Adam's first step is lr * g / (|g| + 1e-8) on the clipped gradient g:
    # where |g| < 1e-6 the 1e-8 makes the step follow g's last bits (and a
    # zero true gradient, as a conv bias that feeds a one-channel-per-group
    # GroupNorm has, leaves only rounding noise), so there an entry is held
    # to the learning rate; elsewhere to 1e-5 of its leaf. The port's step
    # leaves the clipped gradient in .grad.
    for name, p in diff.model.named_parameters():
        leaf = float(want[name].abs().max()) + 1e-8
        atol = np.where(p.grad.abs().numpy() < 1e-6, 1.1 * lr,
                        max(1e-5 * leaf, 3e-7))
        err = np.abs(p.detach().numpy() - want[name].numpy())
        assert (err <= atol).all(), (name, err.max())
        err = np.abs(state.ema_params[f"model.{name}"].numpy()
                     - want_ema[name].numpy())
        assert (err <= (1 - decay) * atol + 1e-7).all(), (name, err.max())
    with pytest.raises(ValueError, match="use_ema"):
        tt.make_train_step(cd, lr_schedule=lambda s: lr, use_ema=False,
                           loss_takes_ema=True)


@pytest.mark.parametrize("n_calls", [1, 4])
def test_consistency_sampler_matches_jax(models, dyn, n_calls):
    """The few-call plan with projection and the wall revert; the draws of
    ``split(rng, n_steps)``'s keys in order."""
    jax_diff, params, diff = models
    P, jstats, pstats = dyn
    spec = dict(state_dim=STATE, strength=0.8, wall_grid=GRID)
    jplan = jc.make_consistency_sampler(
        jax_diff, n_steps=n_calls, projection=js.ProjectionSpec(**spec),
        jit=False)
    plan = ts.make_sampler(diff, sampler="consistency",
                           sampling_timesteps=n_calls,
                           projection=ts.ProjectionSpec(**spec))
    jcond, cond = _conditions(3, 12)
    key = jax.random.PRNGKey(8)
    want = jax.jit(lambda p, k: jplan(p, k, jcond, jnp.asarray(P), jstats))(
        params, key)
    keys = jax.random.split(key, n_calls)
    draws = [_t(jax.random.normal(k, (3, H, D))) for k in keys]
    L = len(plan.timesteps)
    got = plan(None, cond, torch.from_numpy(P), pstats, init_noise=draws[0],
               step_noise=torch.stack(draws[1:L]) if L > 1 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_CHAIN,
                               rtol=TOL_CHAIN)
    assert torch.equal(got[:, 0], cond.values[:, 0])
