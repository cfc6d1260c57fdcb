"""The port's learned simulator (dadiff_tpu_torch/envs/learned_model.py) held
against the JAX package's envs/learned_model.py on the CPU: the MLP
forwards on carried weights, the statistics and split, the three trainers
on JAX's initial weights and batch indices, the trajectory-sampling and
ensemble-mean steps, the reward models, and the on-device evaluator on the
JAX draws with an env that falls at its first step.

Sizes are tiny: hidden (32, 32), a few hundred Hopper transitions, 30 SGD
steps of batch 64; a (1, 2) U-Net of dim 8. Tolerances: forwards and steps
1e-5, rewards 1e-6 with exact masks, statistics exact, the trained weights
1e-4 and the held-out predictions and R^2 1e-4 (see the trainer test), the
evaluator's returns and lengths 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dadiff_tpu.envs import learned_model as jl
from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.ops.projection import NormStats as JaxNormStats

from dadiff_tpu_torch.datasets.sources import load_episodes
from dadiff_tpu_torch.envs import learned_model as tl
from dadiff_tpu_torch.io.torch_compat import (
    mlp_params_from_jax,
    params_from_jax,
)
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops.projection import NormStats

torch.set_num_threads(1)

OBS, ACT, HID, E = 11, 3, (32, 32), 2
STEPS, BATCH, SEED = 30, 64, 3


@pytest.fixture(scope="module")
def episodes():
    """A few hundred Hopper transitions: 4 episodes of data/hopper_mppi.npz
    cut to 80 steps."""
    eps = load_episodes("npz:data/hopper_mppi.npz")[:4]
    return [{"observations": ep["observations"][:81],
             "actions": ep["actions"][:80],
             "rewards": ep["rewards"][:80]} for ep in eps]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flax_init(module, in_a, in_b, seed, n_models=None):
    """The JAX trainers' initial weights: ``model.init(PRNGKey(seed))``, or
    one key per member of ``split(PRNGKey(seed), E)``."""
    def init(key):
        return module.init(key, jnp.zeros((1, in_a)),
                           jnp.zeros((1, in_b)))["params"]

    if n_models is None:
        return _np_tree(init(jax.random.PRNGKey(seed)))
    return _np_tree(jax.vmap(init)(jax.random.split(jax.random.PRNGKey(seed),
                                                    n_models)))


def _jax_batch_idx(n_steps, n_train, seed, n_models=None):
    """The JAX trainers' minibatch indices: key PRNGKey(seed + 1), one split
    per chunk of up to 500 steps, one key per step, and for an ensemble one
    more split per member (learned_model.py:137-168, :257-290)."""
    key = jax.random.PRNGKey(seed + 1)
    rows = []
    for size in tl._chunk_sizes(n_steps, max(1, min(500, n_steps))):
        key, sub = jax.random.split(key)
        for k in jax.random.split(sub, size):
            keys = [k] if n_models is None else jax.random.split(k, n_models)
            rows.append(np.stack([np.asarray(jax.random.randint(
                kk, (BATCH,), 0, n_train)) for kk in keys]))
    idx = np.stack(rows)
    return idx[:, 0] if n_models is None else idx


def _n_train(episodes):
    n = len(tl._transitions(episodes)[0])
    return n - max(1, int(n * 0.1))


# ---------------------------------------------------------------------------
# Forwards and weights carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dynamics", "inverse", "ensemble"])
def test_mlp_forwards_match_jax(kind):
    rng = np.random.RandomState(0)
    if kind == "inverse":
        jm, in_b = jl.InverseDynamicsMLP(act_dim=ACT, hidden=HID), OBS
        tm = tl.InverseDynamicsMLP(OBS, ACT, HID)
    else:
        jm, in_b = jl.DynamicsMLP(obs_dim=OBS, hidden=HID), ACT
        tm = tl.DynamicsMLP(OBS, ACT, HID,
                            n_models=E if kind == "ensemble" else None)
    params = _flax_init(jm, OBS, in_b, 5,
                        E if kind == "ensemble" else None)
    tm.load_state_dict(mlp_params_from_jax(params), strict=True)
    lead = (E, 7) if kind == "ensemble" else (7,)
    a = rng.randn(*lead, OBS).astype(np.float32)
    b = rng.randn(*lead, in_b).astype(np.float32)
    if kind == "ensemble":
        want = np.stack([np.asarray(jm.apply(
            {"params": jax.tree_util.tree_map(lambda v: v[e], params)},
            a[e], b[e])) for e in range(E)])
    else:
        want = np.asarray(jm.apply({"params": params}, a, b))
    with torch.no_grad():
        got = tm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_is_flax_lecun_normal():
    """The default initialisation draws flax's distribution: zero biases,
    weights within two deviations of 0 and a deviation of sqrt(1/fan_in)
    (the truncation rescaled), on a wide layer."""
    m = tl.DynamicsMLP(OBS, ACT, (4096, 8), seed=1)
    w = m.layers[1].weight.detach().numpy()
    std = np.sqrt(1.0 / 4096)
    assert np.abs(w).max() <= 2 * std / tl._TRUNC_STD + 1e-9
    assert abs(w.std() / std - 1.0) < 0.05
    assert all(float(lin.bias.detach().abs().max()) == 0.0
               for lin in m.layers)


# ---------------------------------------------------------------------------
# The trainers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(episodes):
    """The three JAX trainers and the port's on JAX's initial weights and
    batch indices; keyed by trainer."""
    n_train = _n_train(episodes)
    kw = dict(hidden=HID, n_steps=STEPS, batch_size=BATCH, seed=SEED)
    out = {}
    out["model"] = (jl.train_dynamics_model(episodes, **kw),
                    tl.train_dynamics_model(
                        episodes, device="cpu",
                        init_params=mlp_params_from_jax(_flax_init(
                            jl.DynamicsMLP(obs_dim=OBS, hidden=HID), OBS, ACT,
                            SEED)),
                        batch_idx=_jax_batch_idx(STEPS, n_train, SEED), **kw))
    out["ensemble"] = (
        jl.train_dynamics_ensemble(episodes, n_models=E, **kw),
        tl.train_dynamics_ensemble(
            episodes, n_models=E, device="cpu",
            init_params=mlp_params_from_jax(_flax_init(
                jl.DynamicsMLP(obs_dim=OBS, hidden=HID), OBS, ACT, SEED, E)),
            batch_idx=_jax_batch_idx(STEPS, n_train, SEED, E), **kw))
    out["inverse"] = (
        jl.train_inverse_dynamics(episodes, **kw),
        tl.train_inverse_dynamics(
            episodes, device="cpu",
            init_params=mlp_params_from_jax(_flax_init(
                jl.InverseDynamicsMLP(act_dim=ACT, hidden=HID), OBS, OBS,
                SEED)),
            batch_idx=_jax_batch_idx(STEPS, n_train, SEED), **kw))
    return out


def test_statistics_and_split_match_jax(episodes, trained):
    """numpy's statistics (population std + 1e-6) on numpy's split: the
    port's ModelStats equal the JAX trainer's bit for bit."""
    for key in ("model", "ensemble"):
        want, got = trained[key][0][2], trained[key][1][1]
        for name, w, g in zip(tl.ModelStats._fields, want, got):
            assert g.dtype == torch.float32, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{key} {name}")
    obs = tl._transitions(episodes)[0]
    val, train = tl._split(len(obs), 0.1, SEED)
    perm = np.random.RandomState(SEED).permutation(len(obs))
    assert np.array_equal(np.concatenate([val, train]), perm)
    assert len(val) == int(len(obs) * 0.1)


@pytest.mark.parametrize("key", ["model", "ensemble", "inverse"])
def test_trainers_match_jax(episodes, trained, key):
    """30 Adam steps from JAX's initial weights on JAX's minibatches: the
    weights within 1e-4 of JAX's (Adam divides each gradient element by its
    own running scale, so an element near zero whose rounding differs
    between the two sides would move by ~lr; none does here at these sizes),
    the held-out predictions within 1e-4 and the R^2 metrics within 1e-4;
    the inverse model's weights stay inside JAX's closure, so its
    predictions are held instead."""
    want, got = trained[key]
    if key == "inverse":
        (predict_w, metrics_w), (predict_g, metrics_g) = want, got
        obs, act, nxt = tl._transitions(episodes)
        jax_params = None
        np.testing.assert_allclose(predict_g(obs[:50], nxt[:50]),
                                   np.asarray(predict_w(obs[:50], nxt[:50])),
                                   rtol=1e-4, atol=1e-4)
    else:
        (_, jax_params, stats, metrics_w), (model, _, metrics_g) = want, got
    for name in ("r2_mean", "r2_min"):
        np.testing.assert_allclose(metrics_g[name], metrics_w[name],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    if key == "ensemble":
        np.testing.assert_allclose(metrics_g["member_r2"],
                                   metrics_w["member_r2"], atol=1e-4)
    if jax_params is not None:
        for k, v in mlp_params_from_jax(_np_tree(jax_params)).items():
            np.testing.assert_allclose(
                model.state_dict()[k].numpy(), v.numpy(), rtol=1e-4,
                atol=1e-4, err_msg=f"{key} {k}")


def test_trainer_draws_its_own_batches(episodes):
    """Without injected indices the port draws from a generator seeded
    seed + 1: two runs agree bit for bit, and the fit reduces the loss's
    held-out error below a model that did not train."""
    kw = dict(hidden=HID, n_steps=10, batch_size=BATCH, seed=SEED,
              device="cpu")
    a = tl.train_dynamics_model(episodes, **kw)
    b = tl.train_dynamics_model(episodes, **kw)
    for k, v in a[0].state_dict().items():
        assert torch.equal(v, b[0].state_dict()[k]), k
    untrained = tl.train_dynamics_model(episodes, **dict(kw, n_steps=0))
    assert a[2]["r2_mean"] > untrained[2]["r2_mean"]
    with pytest.raises(ValueError, match="batch_idx"):
        tl.train_dynamics_model(episodes, batch_idx=np.zeros((3, 5), int),
                                **kw)


# ---------------------------------------------------------------------------
# The simulator steps and the reward models
# ---------------------------------------------------------------------------

def _jax_stats(stats):
    return jl.ModelStats(*(jnp.asarray(v.numpy()) for v in stats))


def test_ensemble_steps_match_jax(trained):
    """The trajectory-sampling step (candidates [e*N/E, (e+1)*N/E) under
    member e) and the ensemble-mean step on (N, B, d) states: 1e-5."""
    (jm, jparams, jstats, _), (model, stats, _) = trained["ensemble"]
    rng = np.random.RandomState(4)
    N, B = 6, 3
    obs = (rng.randn(N, B, OBS) * np.asarray(jstats.obs_std)
           + np.asarray(jstats.obs_mean)).astype(np.float32)
    act = rng.uniform(-1, 1, (N, B, ACT)).astype(np.float32)
    want = jl.make_ensemble_step_fn(jm, jparams, jstats, N)(obs, act)
    got = tl.make_ensemble_step_fn(model, stats, N)(torch.from_numpy(obs),
                                                    torch.from_numpy(act))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # the JAX evaluator's mean step (learned_model.py:554-566)
    o_n = (obs[0] - jstats.obs_mean) / jstats.obs_std
    a_n = (act[0] - jstats.act_mean) / jstats.act_std
    d_n = jnp.mean(jax.vmap(lambda p: jm.apply({"params": p}, o_n, a_n))(
        jparams), axis=0)
    want = obs[0] + d_n * jstats.delta_std + jstats.delta_mean
    got = tl.make_mean_step_fn(model, stats)(torch.from_numpy(obs[0]),
                                             torch.from_numpy(act[0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        tl.make_ensemble_step_fn(model, stats, 5)


@pytest.mark.parametrize("env", ["HalfCheetah-v5", "Hopper-v5",
                                 "Walker2d-v5"])
def test_reward_models_match_jax(env):
    """Rewards 1e-6 and done masks exactly, on states around each env's
    healthy bounds (Hopper's state-range term included)."""
    dim = 11 if env == "Hopper-v5" else 17
    rng = np.random.RandomState(2)
    obs = rng.randn(64, dim).astype(np.float32)
    nxt = rng.randn(64, dim).astype(np.float32) * 0.3
    nxt[:, 0] = rng.uniform(0.5, 2.2, 64)
    nxt[:, 1] = rng.uniform(-1.2, 1.2, 64)
    nxt[:8, 4] = 150.0          # out of Hopper's healthy state range
    act = rng.uniform(-1, 1, (64, 6 if dim == 17 else 3)).astype(np.float32)
    rw, dw = jl.reward_model_for(env)(obs, nxt, act)
    rg, dg = tl.reward_model_for(env)(*map(torch.from_numpy, (obs, nxt, act)))
    np.testing.assert_array_equal(dg.numpy(), np.asarray(dw))
    np.testing.assert_allclose(rg.numpy(), np.asarray(rw), rtol=1e-6,
                               atol=1e-6)
    if env != "HalfCheetah-v5":
        assert 0 < int(dg.sum()) < 64
    assert set(tl.REWARD_MODELS) == set(jl.REWARD_MODELS)
    with pytest.raises(ValueError, match="No on-device reward model"):
        tl.reward_model_for("PointMaze_UMaze-v3")


# ---------------------------------------------------------------------------
# The evaluator
# ---------------------------------------------------------------------------

H, T_STEPS, B, R, AH = 8, 5, 4, 3, 2
D = OBS + ACT


@pytest.fixture(scope="module")
def tiny():
    jdiff = JaxDiffusion(model=JaxUnet(transition_dim=D, dim=8,
                                       dim_mults=(1, 2)),
                         horizon=H, observation_dim=OBS, action_dim=ACT,
                         n_timesteps=T_STEPS)
    params = jax.jit(jdiff.init_params)(jax.random.PRNGKey(0))
    unet = TemporalUnet(transition_dim=D, dim=8, dim_mults=(1, 2))
    unet.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    diff = GaussianDiffusion(unet, horizon=H, observation_dim=OBS,
                             action_dim=ACT, n_timesteps=T_STEPS).eval()
    rng = np.random.RandomState(7)
    stats = [rng.randn(OBS) * 0.1, 0.5 + rng.rand(OBS),
             rng.randn(ACT) * 0.1, 0.3 + 0.2 * rng.rand(ACT)]
    return jdiff, params, diff, [np.asarray(s, np.float32) for s in stats]


def _jax_draws(key):
    """The draws of the JAX evaluator's replans: one key per replan
    (learned_model.py:599), split by make_sampler into init and noise
    keys."""
    out = []
    for k in jax.random.split(key, R):
        _, init_key, noise_key = jax.random.split(k, 3)
        out.append(tuple(torch.from_numpy(np.array(v)) for v in (
            jax.random.normal(init_key, (B, H, D)),
            jax.random.normal(noise_key, (T_STEPS, B, H, D)))))
    return out


@pytest.mark.parametrize("key", ["ensemble", "model"])
def test_evaluator_matches_jax(tiny, trained, key):
    """4 Hopper envs x 3 replans x 2 actions on the learned simulator (the
    ensemble's mean, or one model) with the JAX draws; env 3 starts on the
    ground (z = 0) and falls at its first step, so its reward is masked
    from then on, its length stops at 1 and its observation is held. A
    second call of the same evaluator returns the same."""
    jdiff, params, diff, stats = tiny
    (jm, jparams, jstats, _), (model, mstats, _) = trained[key]
    from dadiff_tpu_torch.envs.locomotion_jax import HopperJax

    init_obs = HopperJax().reset_obs(range(B)).astype(np.float32)
    init_obs[3, 0] = 0.0
    rk = jax.random.PRNGKey(11)
    evaluate = jl.make_ondevice_locomotion_evaluator(
        jdiff, jm, jparams, jstats, jl.hopper_reward_done, action_horizon=AH,
        n_replans=R, jit=False, ensemble=key == "ensemble")
    want = evaluate(params, rk, JaxNormStats(*map(jnp.asarray, stats)),
                    jnp.asarray(init_obs))
    ev = tl.make_ondevice_locomotion_evaluator(
        diff, model, mstats, tl.hopper_reward_done, action_horizon=AH,
        n_replans=R)
    tstats = NormStats(*map(torch.from_numpy, stats))
    got = ev(None, tstats, torch.from_numpy(init_obs), noise=_jax_draws(rk))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    again = ev(None, tstats, torch.from_numpy(init_obs),
               noise=_jax_draws(rk))
    for a, g in zip(again, got):
        assert torch.equal(a, g)
    loop = ev._loop
    assert float(loop.totals[1][3]) == 1.0 and not bool(loop.totals[2][3])
    # the fallen env's observation is the one it started from
    assert torch.equal(loop.state[0][3], torch.from_numpy(init_obs[3]))
    assert len(ev.timing) == R and not ev.graph
    with pytest.raises(ValueError, match="fit in the planning horizon"):
        tl.make_ondevice_locomotion_evaluator(
            diff, model, mstats, tl.hopper_reward_done, action_horizon=H + 1)
