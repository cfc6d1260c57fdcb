"""Progressive distillation, models/progressive.py and ``distill --method
progressive``, held against the JAX package on the CPU: the grids, pairs
and round schedule exactly; ``ddim_jump`` and the loss on the same draws
(the JAX loss's own draws from its key, injected into the port's); the loss
of a one-step-consistent teacher; a round's weights after three Adam steps
against JAX's Trainer; and the CLI's rounds on disk.

Models: a tiny U-Net (dim 8, mults (1, 2), horizon 8, T = 20) and a tiny
transformer (dim 16, depth 2, 2 heads), both with seeded JAX weights
(tests/torch_jax_models.py) carried over.
Tolerances: 1e-5 of (1 + |x|) for the jumps and the loss; 1e-4 for the
weights after three steps of lr 1e-3 (the attention key bias, whose true
gradient is zero, to the summed learning rates: Adam normalises its
rounding noise to steps of about the learning rate).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dadiff_tpu.models import progressive as jpd
from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.temporal_transformer import (
    TemporalTransformer as JaxTransformer,
)
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.utils.training import Trainer as JaxTrainer

from dadiff_tpu_torch import cli
from dadiff_tpu_torch.io.torch_compat import (
    load_pt_checkpoint,
    params_from_jax,
    transformer_params_from_jax,
)
from dadiff_tpu_torch.models import progressive as pd
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
from dadiff_tpu_torch.models.temporal_transformer import TemporalTransformer
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.utils.training import Trainer
from tests.torch_jax_models import seeded_params

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

H, OBS, ACT, T_STEPS, B = 8, 6, 2, 20, 6
D = OBS + ACT
TOL, TOL_W, LR = 1e-5, 1e-4, 1e-3
DATASET = "synthetic:pointmaze:n=6,T=40"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want) / (1.0 + np.abs(want))
    assert err.max() <= tol, err.max()


@functools.lru_cache(maxsize=None)
def _models(family="unet"):
    if family == "unet":
        jmodel = JaxUnet(transition_dim=D, dim=8, dim_mults=(1, 2))
        model = TemporalUnet(D, dim=8, dim_mults=(1, 2))
        carry = params_from_jax
    else:
        jmodel = JaxTransformer(transition_dim=D, dim=16, depth=2, n_heads=2)
        model = TemporalTransformer(D, dim=16, depth=2, n_heads=2)
        carry = transformer_params_from_jax
    jdiff = JaxDiffusion(model=jmodel, horizon=H, observation_dim=OBS,
                         action_dim=ACT, n_timesteps=T_STEPS)
    params = seeded_params(jmodel, H, seed=1)
    model.load_state_dict(carry(params), strict=True)
    diff = GaussianDiffusion(model, horizon=H, observation_dim=OBS,
                             action_dim=ACT, n_timesteps=T_STEPS).eval()
    return jdiff, params, diff


def _teacher(diff):
    return {n: p.detach().clone() for n, p in diff.named_parameters()}


def _x0(seed, batch=B):
    return (np.random.RandomState(seed).randn(batch, H, D) * 0.3).astype(
        np.float32)


def _jax_draws(key, batch, n_pairs):
    """The JAX loss's draws from its key (progressive.py:119-125)."""
    j_key, n_key = jax.random.split(key)
    return (_t(jax.random.randint(j_key, (batch,), 0, n_pairs)),
            _t(jax.random.normal(n_key, (batch, H, D))))


# ---------------------------------------------------------------------------
# The grids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [6, 20, 100, 200])
def test_grids_pairs_and_round_schedule_are_jax(n):
    for s in sorted({1, 2, 3, 5, 6, n // 4 or 1, n // 2, n - 1, n}):
        np.testing.assert_array_equal(pd.ddim_grid(n, s), jpd.ddim_grid(n, s))
        np.testing.assert_array_equal(pd.pd_pairs(n, s), jpd.pd_pairs(n, s))
        if s < n:
            assert pd.pd_round_schedule(n, s) == jpd.pd_round_schedule(n, s)
    assert pd.pd_round_schedule(100, 6) == [50, 25, 12, 6]
    for bad in (0, n):
        with pytest.raises(ValueError):
            pd.pd_round_schedule(n, bad)
        with pytest.raises(ValueError):
            jpd.pd_round_schedule(n, bad)


def test_student_grid_is_the_ddim_sampler_grid():
    """The student plans through the stock DDIM path on its exact grid."""
    from dadiff_tpu_torch.models.diffusion import ddim_timesteps

    for n, s in ((100, 12), (100, 6), (20, 5)):
        np.testing.assert_array_equal(pd.ddim_grid(n, s),
                                      ddim_timesteps(n, s).numpy())


# ---------------------------------------------------------------------------
# The jump and the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["transformer", "unet"])
def test_ddim_jump_matches_jax(family):
    jdiff, params, diff = _models(family)
    jump = jax.jit(functools.partial(jpd.ddim_jump, jdiff))
    x = _x0(2) * 3
    for t, t_next in ((np.array([19, 12, 5, 3, 8, 1]),
                       np.array([10, 6, 2, 0, 4, -1])),
                      (np.full(B, 4), np.full(B, -1))):
        want = jump(params, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                    jnp.asarray(t_next, jnp.int32))
        with torch.no_grad():
            got = pd.ddim_jump(diff, _t(x), _t(t), _t(t_next))
            teacher = pd.ddim_jump(diff, _t(x), _t(t), _t(t_next),
                                   _teacher(diff))
        _close(got, want)
        assert torch.equal(got, teacher)
    # the terminal lands on the clipped x0 prediction
    assert float(got.abs().max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("family,steps", [("unet", 5), ("unet", 10),
                                          ("transformer", 5)])
def test_pd_loss_matches_jax_on_its_draws(family, steps):
    jdiff, params, diff = _models(family)
    jloss = jax.jit(jpd.make_pd_loss(jdiff, params, steps))
    loss = pd.make_pd_loss(diff, _teacher(diff), steps)
    n_pairs = len(pd.pd_pairs(T_STEPS, steps))
    for seed in (3, 4):
        x0 = _x0(seed)
        key = jax.random.PRNGKey(seed)
        want, wm = jloss(params, {"conditions": jnp.asarray(x0)}, key)
        j, noise = _jax_draws(key, B, n_pairs)
        got, m = loss({"conditions": _t(x0)}, None, j=j, noise=noise)
        _close(float(got.detach()), float(want))
        assert set(m) == set(wm) == {"progressive"}


def test_pd_loss_draws_from_its_generator():
    _, _, diff = _models("unet")
    loss = pd.make_pd_loss(diff, _teacher(diff), 5)
    batch = {"conditions": _t(_x0(5))}
    a = loss(batch, [torch.Generator().manual_seed(1)])[0]
    b = loss(batch, [torch.Generator().manual_seed(1)])[0]
    c = loss(batch, [torch.Generator().manual_seed(2)])[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


class _ConstantX0(torch.nn.Module):
    """An x0-model whose prediction is one constant: its DDIM path is a
    straight line, so two teacher steps land where one student step does."""

    def forward(self, x, t):
        return torch.full_like(x, 0.25)


def test_pd_loss_vanishes_for_a_one_step_consistent_teacher():
    diff = GaussianDiffusion(_ConstantX0(), horizon=H, observation_dim=OBS,
                             action_dim=ACT, n_timesteps=T_STEPS,
                             predict_epsilon=False)
    loss = pd.make_pd_loss(diff, {}, 5)
    value, _ = loss({"conditions": _t(_x0(6))},
                    [torch.Generator().manual_seed(0)])
    assert float(value) < 1e-9


def test_pd_loss_falls_under_one_gradient_step():
    """The port of the JAX test (test_progressive.py:100): a trainable
    signal, not a degenerate constant. A short step along the normalised
    negative gradient (the truncated-SNR weights make the raw surface
    steep at low t)."""
    _, _, trained = _models("unet")
    diff = GaussianDiffusion(TemporalUnet(D, dim=8, dim_mults=(1, 2)),
                             horizon=H, observation_dim=OBS, action_dim=ACT,
                             n_timesteps=T_STEPS).eval()
    diff.load_state_dict(trained.state_dict())
    loss = pd.make_pd_loss(diff, _teacher(diff), 5)
    batch = {"conditions": _t(_x0(4, 16))}
    draws = dict(j=torch.randint(0, 5, (16,), generator=torch.Generator()
                                 .manual_seed(5)),
                 noise=torch.randn(16, H, D, generator=torch.Generator()
                                   .manual_seed(6)))
    v0, _ = loss(batch, None, **draws)
    v0.backward()
    grads = [p.grad for p in diff.parameters()]
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
    with torch.no_grad():
        for p, g in zip(diff.parameters(), grads):
            p -= 1e-4 * g / norm
        v1, _ = loss(batch, None, **draws)
    assert float(v1) < float(v0.detach())


# ---------------------------------------------------------------------------
# A round against JAX's Trainer
# ---------------------------------------------------------------------------

def test_round_weights_after_three_adam_steps_match_jax(tmp_path):
    """One round (5 steps) on the transformer from the same weights, the
    same three batches and the JAX Trainer's draws (its key per step, then
    the loss's), lr 1e-3 with clip: the weights against JAX's to 1e-4.
    The leaves whose gradient is at rounding level (<= 1e-6 of the largest
    entry) must be the attention key biases, which the softmax cancels;
    they are held to the summed learning rates. The checkpoint config's keys are JAX's."""
    jdiff, params, diff = _models("transformer")
    diff = GaussianDiffusion(
        TemporalTransformer(D, dim=16, depth=2, n_heads=2), horizon=H,
        observation_dim=OBS, action_dim=ACT, n_timesteps=T_STEPS)
    diff.load_state_dict(_models("transformer")[2].state_dict())
    steps, seed = 5, 3
    batches = [_x0(10 + i) for i in range(3)]
    extra = {"progressive": True, "progressive_steps": steps,
             "teacher_checkpoint": "teacher.pt"}
    common = dict(lr=LR, warmup_steps=0, total_steps=20, gradient_clip=1.0,
                  use_ema=False, eval_freq=0, loss_names=["progressive"],
                  seed=seed, extra_config=extra)
    jloss = jpd.make_pd_loss(jdiff, params, steps)
    jt = JaxTrainer(jdiff, [None] * 3, jloss, params=params,
                    log_dir=str(tmp_path / "jax"), save_freq=0, **common)
    # the JAX Trainer's key per step (training.py:293-296), its loss's draws
    rng, draws = jax.random.PRNGKey(seed), []
    for _ in batches:
        rng, key = jax.random.split(rng)
        draws.append(_jax_draws(key, B, steps))
    pd_loss = pd.make_pd_loss(diff, _teacher(diff), steps)
    # the key bias's gradient is rounding noise (the softmax cancels it)
    pd_loss({"conditions": _t(batches[0])}, None, j=draws[0][0],
            noise=draws[0][1])[0].backward()
    grads = {n: float(p.grad.abs().max())
             for n, p in diff.model.named_parameters()}
    diff.zero_grad(set_to_none=True)
    noise_leaves = {n for n in grads if grads[n] <= 1e-6 * max(grads.values())}
    assert noise_leaves == {f"blocks.{i}.attn.key.bias" for i in range(2)}
    it = iter(draws)

    def loss(batch, generators):
        j, noise = next(it)
        return pd_loss(batch, generators, j=j, noise=noise)

    tr = Trainer(diff, [None] * 3, loss, log_dir=str(tmp_path / "port"),
                 save_freq=0, **common)
    for x0 in batches:
        jm = jt.train_step({"conditions": jnp.asarray(x0)})
        m = tr.train_step({"conditions": _t(x0)})
        np.testing.assert_allclose(m["progressive"], jm["progressive"],
                                   rtol=TOL_W)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=TOL_W)
    want = transformer_params_from_jax(_np_tree(jt.state.params))
    for name, p in diff.model.named_parameters():
        atol = 3 * LR + TOL_W if name in noise_leaves else TOL_W
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=atol, err_msg=name)
    assert set(tr._config_dict()) == set(jt._config_dict())
    assert tr._config_dict()["model_type"] == "transformer"
    tr.close()
    jt.close()


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_distill_progressive_writes_the_rounds(tmp_path, capsys):
    """A teacher of T = 8 distilled to 2 steps: rounds of 4 and 2, each in
    ``round_{r}_steps{S}`` with the JAX config keys; each round's student
    starts from the previous round's; the closing line names the DDIM
    sampler, through which the student plans."""
    teacher_dir = cli.train_main([
        "--dataset", DATASET, "--horizon", str(H), "--dim", "8",
        "--dim-mults", "1", "2", "--n-timesteps", "8", "--batch-size", "16",
        "--max-steps", "2", "--n-epochs", "1", "--eval-freq", "0",
        "--device", "cpu", "--log-dir", str(tmp_path / "teacher")])
    teacher = os.path.join(teacher_dir, "checkpoint_step_2.pt")
    log_dir = cli.distill_main([
        "--checkpoint", teacher, "--dataset", DATASET, "--method",
        "progressive", "--target-steps", "2", "--n-epochs", "1",
        "--max-steps", "2", "--batch-size", "8", "--lr", "1e-3",
        "--warmup-steps", "0", "--save-freq", "0", "--log-freq", "1",
        "--device", "cpu", "--log-dir", str(tmp_path / "pd")])
    assert "--sampler ddim --sampling-timesteps 2" in capsys.readouterr().out
    assert sorted(os.listdir(log_dir)) == ["config.json", "round_0_steps4",
                                           "round_1_steps2"]
    states = [load_pt_checkpoint(teacher)["model_state_dict"]]
    for r, steps in enumerate((4, 2)):
        rdir = os.path.join(log_dir, f"round_{r}_steps{steps}")
        ck = load_pt_checkpoint(os.path.join(rdir, "checkpoint_step_2.pt"))
        cfg = ck["config"]
        assert (cfg["progressive"], cfg["progressive_steps"],
                cfg["teacher_checkpoint"]) == (True, steps, teacher)
        assert "ema_state_dict" not in ck
        assert json.load(open(os.path.join(rdir, "config.json")))[
            "progressive_steps"] == steps
        lines = [json.loads(x) for x in open(os.path.join(rdir,
                                                          "metrics.jsonl"))]
        assert lines[-1]["step"] == 2 and all(
            np.isfinite(lines[-1]["total_series"]))
        states.append(ck["model_state_dict"])
    key = "model.final_conv.1.weight"
    assert not torch.equal(states[0][key], states[1][key])
    assert not torch.equal(states[1][key], states[2][key])
    student, dataset = cli.load_model(
        os.path.join(log_dir, "round_1_steps2", "checkpoint_step_2.pt"),
        DATASET, device="cpu")
    from dadiff_tpu_torch.guides.sampling import (
        conditions_for_initial_obs,
        make_sampler,
    )

    plan = make_sampler(student, sampler="ddim", sampling_timesteps=2)
    assert len(plan.timesteps) == 2
    out = plan(torch.Generator().manual_seed(0), conditions_for_initial_obs(
        torch.zeros(3, OBS), OBS, H, D))
    assert out.shape == (3, H, D) and torch.isfinite(out).all()
