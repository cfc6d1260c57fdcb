"""The port's training path held against the JAX package on the CPU: the
forward process and the losses, the dataloader, the LR schedule, the train
step (clip, Adam, EMA, skip-nonfinite), the Trainer's checkpoints, and the
path end to end: ``train_main`` then ``probe_megakernel`` and ``load_model``
on the exported ``.pt``.

Both sides get the same batch, timesteps, noise and initial weights (numpy
seeds); the JAX loss is wrapped to take ``t`` and ``noise`` from the batch,
and nothing in the JAX package changes for that. Tolerances: 1e-5 for the
losses, 1e-5 relative for the train step (f32 sums taken in another order).
"""

import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dadiff_tpu import losses as jl
from dadiff_tpu.datasets.sequence import SequenceDataset as JaxDataset
from dadiff_tpu.datasets.sequence import create_dataloader as jax_loader
from dadiff_tpu.models import diffusion as jd
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.ops import projection as jproj
from dadiff_tpu.utils import training as jt

from dadiff_tpu_torch import cli, losses, probe_megakernel
from dadiff_tpu_torch.datasets.sequence import (
    SequenceDataset,
    create_dataloader,
    prefetch_to_device,
)
from dadiff_tpu_torch.io.torch_compat import (
    load_pt_checkpoint,
    params_from_jax,
    train_state_from_jax,
)
from dadiff_tpu_torch.models import diffusion as td
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops import projection as proj
from dadiff_tpu_torch.utils import training as tt

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

H, OBS, ACT, T_STEPS, B = 8, 6, 2, 10, 4
D = OBS + ACT
DATASET = "synthetic:pointmaze:n=6,T=40"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params():
    unet = JaxUnet(transition_dim=D, dim=8, dim_mults=(1, 2))
    return jax.jit(lambda k: unet.init_params(k, H))(jax.random.PRNGKey(0))


def _pair(prediction=None, loss_type="l2"):
    """The same model on both sides, weights from one JAX init."""
    jax_unet = JaxUnet(transition_dim=D, dim=8, dim_mults=(1, 2))
    jax_diff = jd.GaussianDiffusion(
        model=jax_unet, horizon=H, observation_dim=OBS, action_dim=ACT,
        n_timesteps=T_STEPS, prediction=prediction, loss_type=loss_type)
    params = _jax_params()
    unet = TemporalUnet(transition_dim=D, dim=8, dim_mults=(1, 2))
    unet.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    diff = td.GaussianDiffusion(unet, H, OBS, ACT, n_timesteps=T_STEPS,
                                prediction=prediction, loss_type=loss_type)
    return jax_diff, params, diff


def _batch(seed, batch=B):
    rng = np.random.RandomState(seed)
    return {"conditions": rng.randn(batch, H, D).astype(np.float32),
            "t": rng.randint(0, T_STEPS, batch),
            "noise": rng.randn(batch, H, D).astype(np.float32)}


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Forward process and losses
# ---------------------------------------------------------------------------

def test_forward_process_functions_match_jax():
    jax_diff, _, diff = _pair()
    b = _batch(1)
    x, t, n = (jnp.asarray(b[k]) for k in ("conditions", "t", "noise"))
    tx, ttt, tn = (torch.from_numpy(np.asarray(b[k]))
                   for k in ("conditions", "t", "noise"))
    js, ts = jax_diff.schedule, diff.schedule
    for got, want in (
        (td.q_sample(ts, tx, ttt, tn), jd.q_sample(js, x, t, n)),
        (td.predict_start_from_noise(ts, tx, ttt, tn),
         jd.predict_start_from_noise(js, x, t, n)),
        (td.v_from_x0_eps(ts, tx, tn, ttt), jd.v_from_x0_eps(js, x, n, t)),
        (td.epsilon_from_v(ts, tx, tn, ttt), jd.epsilon_from_v(js, x, n, t)),
        (diff.q_sample(tx, ttt, tn), jax_diff.q_sample(x, t, n)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("prediction", [None, "x0", "v"])
@pytest.mark.parametrize("weighted", [False, True])
def test_diffusion_loss_matches_jax(loss_type, prediction, weighted):
    jax_diff, params, diff = _pair(prediction, loss_type)
    b = _batch(2)
    w = (np.random.RandomState(3).rand(1, H, D).astype(np.float32)
         if weighted else None)
    want = jax.jit(lambda p: jax_diff.loss(
        p, jax.random.PRNGKey(0), jnp.asarray(b["conditions"]),
        None if w is None else jnp.asarray(w), t=jnp.asarray(b["t"]),
        noise=jnp.asarray(b["noise"])))(params)
    got = diff.loss(torch.from_numpy(b["conditions"]),
                    None if w is None else torch.from_numpy(w),
                    t=torch.from_numpy(b["t"]),
                    noise=torch.from_numpy(b["noise"]))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-5)
    if prediction == "v":   # sampling reads a v-model as an epsilon model
        x, t = torch.from_numpy(b["conditions"]), torch.from_numpy(b["t"])
        want_eps = jax_diff.apply(params, jnp.asarray(b["conditions"]),
                                  jnp.asarray(b["t"]))
        with torch.no_grad():
            np.testing.assert_allclose(diff(x, t).numpy(), np.asarray(want_eps),
                                       atol=1e-4)


def test_diffusion_loss_draws_from_its_generator():
    _, _, diff = _pair()
    x = torch.from_numpy(_batch(4)["conditions"])
    a = diff.loss(x, generator=torch.Generator().manual_seed(5))
    b = diff.loss(x, generator=torch.Generator().manual_seed(5))
    c = diff.loss(x, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a)
    with pytest.raises(ValueError, match="loss type"):
        td.diffusion_loss(diff, diff.schedule, x, loss_type="huber")
    with pytest.raises(ValueError, match="prediction"):
        td.GaussianDiffusion(diff.model, H, OBS, ACT, prediction="score")


class _JaxInjected(jl.BaseLoss):
    """The JAX diffusion loss with t and noise taken from the batch."""

    name = "diffusion"

    def __init__(self, diffusion):
        super().__init__(1.0)
        self.diffusion = diffusion

    def compute(self, params, batch, rng):
        return self.diffusion.loss(params, rng, batch["conditions"],
                                   t=batch["t"], noise=batch["noise"])


class _Injected(losses.BaseLoss):
    name = "diffusion"

    def __init__(self, diffusion):
        super().__init__(1.0)
        self.diffusion = diffusion

    def compute(self, batch, generator):
        return self.diffusion.loss(batch["conditions"], t=batch["t"],
                                   noise=batch["noise"])


class _Normalizer:
    def __init__(self, seed):
        rng = np.random.RandomState(seed)
        self.obs_mean, self.obs_std = rng.randn(OBS), 0.5 + rng.rand(OBS)
        self.action_mean, self.action_std = rng.randn(ACT), 0.5 + rng.rand(ACT)


def _projection_matrix():
    from dadiff_tpu_torch.dynamics.projection import ProjectionMatrixBuilder

    A = np.eye(4) + 0.1 * np.eye(4, k=2)
    Bm = np.zeros((4, ACT))
    Bm[2:, :] = 0.1 * np.eye(ACT)
    return ProjectionMatrixBuilder(A, Bm, 4, ACT).get_projection_matrix(H)


def test_projection_residual_and_composed_loss_match_jax():
    jax_diff, params, diff = _pair()
    P, norm, b = _projection_matrix(), _Normalizer(7), _batch(8)
    kw = dict(observation_dim=OBS, action_dim=ACT, state_dim=4)
    want = jproj.projection_residual(
        jnp.asarray(b["conditions"]), jnp.asarray(P, jnp.float32),
        jproj.NormStats.from_normalizer(norm), **kw)
    got = proj.projection_residual(
        torch.from_numpy(b["conditions"]), torch.as_tensor(P, dtype=torch.float32),
        proj.NormStats.from_normalizer(norm), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)

    jax_loss = jl.ComposedLoss([_JaxInjected(jax_diff), jl.ProjectionLoss(
        P, norm, state_dim=4, action_dim=ACT, observation_dim=OBS, horizon=H,
        weight=0.3)])
    loss = losses.ComposedLoss([_Injected(diff), losses.ProjectionLoss(
        P, norm, state_dim=4, action_dim=ACT, observation_dim=OBS, horizon=H,
        weight=0.3)])
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want_total, want_m = jax_loss(params, jb, jax.random.PRNGKey(0))
    total, m = loss(_to_torch(b), losses.make_generators(2, 0, "cpu"))
    assert loss.names == jax_loss.names == ["diffusion", "projection"]
    assert set(m) == set(want_m)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(want_m[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)
    with pytest.raises(ValueError, match="one generator"):
        loss(_to_torch(b), [None])


def test_build_loss_composes_like_jax():
    _, _, diff = _pair()
    fn, names = losses.build_loss(diff)
    assert names == ["diffusion"]
    total, m = fn(_to_torch(_batch(9)), losses.make_generators(1, 3, "cpu"))
    assert set(m) == {"diffusion", "total"} and torch.equal(total, m["diffusion"])
    fn, names = losses.build_loss(
        diff, projection_weight=0.1, projection_matrix=_projection_matrix(),
        normalizer=_Normalizer(1), state_dim=4)
    assert names == ["diffusion", "projection"]
    with pytest.raises(ValueError, match="requires"):
        losses.build_loss(diff, projection_weight=0.1)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_dataloader_draws_the_jax_batches():
    ds, jds = SequenceDataset(DATASET, horizon=H), JaxDataset(DATASET, horizon=H)
    assert len(ds) == len(jds) == 6 * (40 - H + 1)
    np.testing.assert_array_equal(ds[17]["conditions"], jds[17]["conditions"])
    for shuffle, drop_last in ((True, True), (False, False)):
        a = create_dataloader(ds, 16, shuffle=shuffle, drop_last=drop_last, seed=3)
        b = jax_loader(jds, 16, shuffle=shuffle, drop_last=drop_last, seed=3)
        assert len(a) == len(b)
        batches = list(zip(a, b))
        assert len(batches) == len(a)
        for x, y in batches:
            np.testing.assert_array_equal(x["conditions"], y["conditions"])
    on_device = list(prefetch_to_device(iter(a), "cpu"))
    assert len(on_device) == len(a)
    assert on_device[0]["conditions"].dtype == torch.float32
    assert on_device[-1]["conditions"].shape == (len(ds) % 16, H, D)


# ---------------------------------------------------------------------------
# Schedule, optimizer, train step
# ---------------------------------------------------------------------------

def test_warmup_cosine_matches_jax():
    want = jt.warmup_cosine_schedule(3e-4, 10, 100, min_lr=1e-5)
    got = tt.warmup_cosine_schedule(3e-4, 10, 100, min_lr=1e-5)
    for step in (0, 5, 10, 55, 100, 140):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)
    no_warm = tt.warmup_cosine_schedule(1.0, 0, 10)
    assert no_warm(0) == 1.0 and abs(no_warm(10)) < 1e-12


def _jax_stepper(jax_diff, params, clip, use_ema=True, skip_nonfinite=False):
    opt = jt.make_optimizer(jt.warmup_cosine_schedule(1e-3, 0, 20), clip)
    state = jt.TrainState(
        step=jnp.asarray(0), params=params, opt_state=opt.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params) if use_ema else None)
    step = jt.make_train_step(jl.ComposedLoss([_JaxInjected(jax_diff)]), opt,
                              ema_decay=0.9, donate=False, use_ema=use_ema,
                              skip_nonfinite=skip_nonfinite)
    return state, step


def _stepper(diff, clip, use_ema=True, skip_nonfinite=False):
    state = tt.TrainState(
        module=diff, optimizer=tt.make_optimizer(diff.parameters(), 1e-3),
        ema_params=tt.EMA(diff, 0.9).shadow if use_ema else None)
    step = tt.make_train_step(
        losses.ComposedLoss([_Injected(diff)]),
        lr_schedule=tt.warmup_cosine_schedule(1e-3, 0, 20), gradient_clip=clip,
        ema_decay=0.9, use_ema=use_ema, skip_nonfinite=skip_nonfinite)
    return state, step


def _rounding_level_leaves(jax_diff, params, diff, batch):
    """Names of the parameters whose true gradient is zero, picked by a rule
    on the JAX gradient: its largest entry is below 1e-6 of the largest
    entry of the whole gradient. (A conv bias that feeds a GroupNorm whose
    groups hold one channel each is such a leaf: the normalisation removes
    it.) The port's gradient must be at that level on the same leaves and on
    no other."""
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    g = jax.grad(lambda p: jax_diff.loss(
        p, jax.random.PRNGKey(0), b["conditions"], t=b["t"],
        noise=b["noise"]))(params)
    g = {n: float(v.abs().max()) for n, v in params_from_jax(_np_tree(g)).items()}
    tb = _to_torch(batch)
    diff.zero_grad()
    diff.loss(tb["conditions"], t=tb["t"], noise=tb["noise"]).backward()
    tg = {n: float(p.grad.abs().max()) for n, p in diff.model.named_parameters()}
    diff.zero_grad()
    level = 1e-6 * max(g.values())
    picked = {n for n in g if g[n] <= level}
    assert picked and picked == {n for n in tg if tg[n] <= level}
    assert len(picked) < len(g) // 4
    return picked


def _assert_params_close(diff, state, jstate, noise_leaves, rtol=1e-5):
    """Parameters and EMA against the JAX state, 1e-5 relative to each leaf's
    largest entry. On ``noise_leaves`` (see ``_rounding_level_leaves``) both
    sides see only rounding noise as the gradient, which Adam normalises to
    steps of about the learning rate in either direction, so those leaves
    are held to the summed learning rates (3 steps of 1e-3) instead. The
    floor of 3e-7 is 1e-4 of that sum: Adam passes the relative rounding
    error of a small gradient entry on undamped, whatever the entry's size."""
    want = params_from_jax(_np_tree(jstate.params))
    want_ema = params_from_jax(_np_tree(jstate.ema_params))
    assert noise_leaves <= set(want)
    for name, p in diff.model.named_parameters():
        scale = float(want[name].abs().max()) + 1e-8
        atol = (3.1e-3 if name in noise_leaves else max(rtol * scale, 3e-7))
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)
        np.testing.assert_allclose(
            state.ema_params[f"model.{name}"].numpy(), want_ema[name].numpy(),
            rtol=rtol, atol=atol, err_msg=f"ema {name}")


def _adam_state(jstate):
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return int(adam.count), _np_tree(adam.mu), _np_tree(adam.nu)


@pytest.mark.parametrize("clip", [4.0, 0.05])
def test_train_step_matches_jax_after_1_and_3_steps(clip):
    """Loss, grad_norm, parameters and EMA after step 1 (Adam's bias
    correction) and step 3 (its momentum), 1e-5 relative; the clip is active
    in the second case (grad_norm > 0.05)."""
    jax_diff, params, diff = _pair()
    jstate, jstep = _jax_stepper(jax_diff, params, clip)
    state, step = _stepper(diff, clip)
    noise_leaves = _rounding_level_leaves(jax_diff, params, diff, _batch(20))
    for i in range(3):
        b = _batch(20 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(i))
        m = step(state, _to_torch(b), [None])
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        if clip < 1:
            assert float(m["grad_norm"]) > clip
        if i in (0, 2):
            _assert_params_close(diff, state, jstate, noise_leaves)
    assert (state.step, state.n_updates, int(jstate.step)) == (3, 3, 3)


def test_train_state_carried_over_from_jax_continues_alike():
    """An optax Adam state and EMA tree taken after one JAX step, carried
    into the port, give the same steps 2 and 3."""
    jax_diff, params, diff = _pair()
    jstate, jstep = _jax_stepper(jax_diff, params, 4.0)
    b0 = _batch(30)
    noise_leaves = _rounding_level_leaves(jax_diff, params, diff, b0)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b0.items()},
                      jax.random.PRNGKey(0))
    state, step = _stepper(diff, 4.0)
    diff.model.load_state_dict(params_from_jax(_np_tree(jstate.params)))
    count, mu, nu = _adam_state(jstate)
    train_state_from_jax(state, count=count, mu=mu, nu=nu,
                         ema=_np_tree(jstate.ema_params))
    assert (state.step, state.n_updates) == (1, 1)
    for i in (1, 2):
        b = _batch(30 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(i))
        m = step(state, _to_torch(b), [None])
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5)
    _assert_params_close(diff, state, jstate, noise_leaves)


def test_skip_nonfinite_rolls_back_parameters_and_adam_state():
    jax_diff, params, diff = _pair()
    jstate, jstep = _jax_stepper(jax_diff, params, 4.0, skip_nonfinite=True)
    state, step = _stepper(diff, 4.0, skip_nonfinite=True)
    good, bad = _batch(40), _batch(41)
    noise_leaves = _rounding_level_leaves(jax_diff, params, diff, good)
    bad["noise"][0, 0, 0] = np.nan
    for i, b in enumerate((good, bad)):
        if b is bad:
            before = {n: p.detach().clone()
                      for n, p in diff.named_parameters()}
            moments = {n: {k: v.clone() for k, v in state.optimizer.state[p].items()}
                       for n, p in diff.named_parameters()}
            ema_before = {n: v.clone() for n, v in state.ema_params.items()}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(i))
        m = step(state, _to_torch(b), [None])
        assert float(m["nonfinite"]) == float(jm["nonfinite"]) == float(b is bad)
    for n, p in diff.named_parameters():
        assert torch.equal(p, before[n]), n
        for k, v in state.optimizer.state[p].items():
            assert torch.equal(v, moments[n][k]), (n, k)
        # the EMA still moves toward the (unchanged) parameters, as in JAX
        want = 0.9 * ema_before[n] + 0.1 * before[n]
        torch.testing.assert_close(state.ema_params[n], want)
    assert (state.step, state.n_updates) == (2, 1)
    _assert_params_close(diff, state, jstate, noise_leaves)
    # a finite batch afterwards trains again, from the rolled-back state
    b = _batch(42)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                      jax.random.PRNGKey(2))
    m = step(state, _to_torch(b), [None])
    assert float(m["nonfinite"]) == 0.0 and state.n_updates == 2
    _assert_params_close(diff, state, jstate, noise_leaves)


def test_train_step_without_ema_or_clip():
    _, _, diff = _pair()
    state, step = _stepper(diff, 0.0, use_ema=False)
    before = [p.detach().clone() for p in diff.parameters()]
    m = step(state, _to_torch(_batch(50)), [None])
    assert state.ema_params is None and "nonfinite" not in m
    assert any(not torch.equal(a, b) for a, b in zip(before, diff.parameters()))
    ema = tt.EMA(diff, 0.5)
    first = next(iter(ema.shadow))
    old = ema.shadow[first].clone()
    with torch.no_grad():
        dict(diff.named_parameters())[first].add_(1.0)
    torch.testing.assert_close(ema.update()[first], old + 0.5)
    assert tt.count_parameters(diff) == sum(p.numel() for p in diff.parameters())


# ---------------------------------------------------------------------------
# Trainer: logs, checkpoints, resume
# ---------------------------------------------------------------------------

def _trainer(tmp_path, seed=0, **kw):
    torch.manual_seed(seed)
    ds = SequenceDataset(DATASET, horizon=H)
    unet = TemporalUnet(transition_dim=D, dim=8, dim_mults=(1, 2))
    diff = td.GaussianDiffusion(unet, H, OBS, ACT, n_timesteps=T_STEPS)
    loss_fn, names = losses.build_loss(diff)
    return tt.Trainer(
        diff, create_dataloader(ds, 32, seed=1), loss_fn, lr=1e-3,
        warmup_steps=2, total_steps=40, log_dir=str(tmp_path), loss_names=names,
        seed=3, normalizer=ds.normalizer, log_freq=2, **kw), ds


def test_trainer_save_load_latest_continues_the_uninterrupted_run(tmp_path):
    batches = [_to_torch({"conditions": _batch(60 + i, 8)["conditions"]})
               for i in range(4)]
    whole, _ = _trainer(tmp_path / "whole")
    for b in batches:
        whole.train_step(b)
    part, _ = _trainer(tmp_path / "part")
    for b in batches[:2]:
        part.train_step(b)
    base = part.save_checkpoint(epoch=5)
    assert base.endswith("checkpoint_step_2")
    part.close()

    resumed, _ = _trainer(tmp_path / "part", seed=99)   # other initial weights
    assert resumed.load_latest() == 5 and resumed.global_step == 2
    assert resumed.state.n_updates == 2
    metrics = [resumed.train_step(b) for b in batches[2:]]
    assert resumed.global_step == 4 and np.isfinite(metrics[-1]["total"])
    for (n, a), (_, b) in zip(whole.diffusion.named_parameters(),
                              resumed.diffusion.named_parameters()):
        assert torch.equal(a, b), n
    for n in whole.state.ema_params:
        assert torch.equal(whole.state.ema_params[n],
                           resumed.state.ema_params[n]), n
    empty, _ = _trainer(tmp_path / "empty")
    assert empty.load_latest() is None
    # fine-tune semantics: weights restored, optimizer and counters fresh
    assert empty.load_checkpoint(base, reset_optimizer=True) == 5
    assert empty.global_step == 0 and not empty.state.optimizer.state
    for t in (whole, resumed, empty):
        t.close()
    with pytest.raises(TypeError, match="sized"):
        tt.Trainer(whole.diffusion, iter([]), whole.loss_fn,
                   log_dir=str(tmp_path / "bad"))


def test_trainer_epochs_logs_and_val_probe(tmp_path, capsys):
    ds = SequenceDataset(DATASET, horizon=H)
    val = ds.get_batch(np.arange(16))
    trainer, _ = _trainer(tmp_path, val_batch=val, eval_freq=3, save_freq=4)
    history = trainer.train(2, max_steps=9)
    trainer.close()
    assert len(history["total"]) == 2 and "val_loss" in history
    assert trainer.global_step == 9
    assert "Epoch 1:" in capsys.readouterr().out
    lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert [l["epoch"] for l in lines] == [1, 2] and lines[-1]["step"] == 9
    assert (tmp_path / "training.log").read_text().count("Epoch") == 2
    for step in (4, 8, 9):
        assert (tmp_path / f"checkpoint_step_{step}.pt").is_file()
        assert (tmp_path / f"checkpoint_step_{step}.train.pt").is_file()
    cfg = tt.load_config(str(tmp_path / "config.json"))
    assert cfg["dim_mults"] == [1, 2] and "normalizer_stats" in cfg
    ck = load_pt_checkpoint(str(tmp_path / "checkpoint_step_9.pt"))
    assert ck["global_step"] == 9 and set(ck["ema_state_dict"]) == set(
        ck["model_state_dict"])
    assert not torch.equal(ck["ema_state_dict"]["model.final_conv.1.weight"],
                           ck["model_state_dict"]["model.final_conv.1.weight"])
    assert isinstance(trainer.evaluate(use_ema=True), float)
    tt.save_config({"a": 1}, str(tmp_path / "c.json"))
    assert tt.load_config(str(tmp_path / "c.json")) == {"a": 1}


# ---------------------------------------------------------------------------
# End to end: train, then the ladder and the loader on the exported .pt
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--dataset", DATASET, "--horizon", str(H), "--dim", "16",
              "--dim-mults", "1", "2", "--n-timesteps", "6", "--batch-size",
              "16", "--warmup-steps", "2", "--device", "cpu", "--log-freq", "4"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    log_dir = cli.train_main(TRAIN_ARGS + ["--n-epochs", "2", "--log-dir",
                                           str(root), "--projection-weight",
                                           "0.05"])
    return root, log_dir


def test_train_main_then_ladder_then_load_model(trained):
    root, log_dir = trained
    lines = [json.loads(l) for l in open(f"{log_dir}/metrics.jsonl")]
    assert len(lines) == 2 and lines[1]["step"] == 24
    assert all(np.isfinite(l["total"]) and "projection" in l for l in lines)
    final = json.load(open(f"{log_dir}/final_config.json"))
    assert final["loss_components"] == ["diffusion", "projection"]
    ckpt = f"{log_dir}/checkpoint_step_24.pt"

    out = probe_megakernel.main(["--checkpoint", ckpt, "--device", "cpu",
                                 "--repeats", "1"])
    assert out["steps"] == 6 and out["shape"] == [1, H, D]
    for name in ("hoisted", "hoisted_fused", "chain_f32"):
        assert out["rungs"][name]["max_abs_diff"] <= 1e-4, name
    assert out["rungs"]["chain_bf16"]["max_abs_diff"] < 0.15

    diff, dataset = cli.load_model(ckpt, DATASET, device="cpu")
    assert (diff.horizon, diff.n_timesteps, diff.model.dim) == (H, 6, 16)
    stored = json.load(open(f"{log_dir}/config.json"))["normalizer_stats"]
    np.testing.assert_allclose(dataset.normalizer.obs_mean, stored["obs_mean"],
                               rtol=1e-6)
    x = diff.p_sample_loop((2, H, D), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(x).all()


def test_train_main_fine_tunes_and_resumes(trained):
    root, log_dir = trained
    ckpt = f"{log_dir}/checkpoint_step_24.pt"
    tuned = cli.train_main(TRAIN_ARGS + [
        "--n-epochs", "1", "--log-dir", str(root / "ft"), "--checkpoint", ckpt,
        "--finetune-mode", "--dim", "32", "--max-steps", "3"])
    # the architecture came from the weights, not from --dim
    ck = load_pt_checkpoint(f"{tuned}/checkpoint_step_3.pt")
    assert ck["model_state_dict"]["model.final_conv.1.weight"].shape[1] == 16
    assert ck["epoch"] == 1     # epochs go on from the checkpoint's own
    resumed = cli.train_main(TRAIN_ARGS + [
        "--n-epochs", "1", "--log-dir", str(root / "ft"), "--resume",
        "--max-steps", "2", "--no-export-pt"])
    assert resumed == tuned
    assert list((root / "ft").rglob("checkpoint_step_5.train.pt"))
    assert not list((root / "ft").rglob("checkpoint_step_5.pt"))


def test_train_entry_point_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where there is no card")
    assert cli.build_train_parser().parse_args([]).device == "cuda"
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.train_main(["--n-epochs", "1"])
