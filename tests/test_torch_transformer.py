"""The port's second model family, the TemporalTransformer, held against
the JAX package on the CPU: weights carried by ``transformer_params_from_jax``
give JAX's forward; a fresh model predicts zeros; the reverse chain, the
loss and a dynamics-aware best-of-8 plan equal JAX's on the same draws; the
train CLI writes a ``.pt`` that ``load_model`` rebuilds with
``strict=True`` and that resumes, fine-tunes, serves, evaluates on the
on-device PointMaze and locomotion loops and distills; ``--megakernel`` refuses it (and what the JAX
package does instead); the train parser's flags are JAX's.

Tiny model: dim 32, depth 2, 4 heads (dim 16, depth 2, 2 heads for the CLI).
Tolerances: the forward 1e-5 (f32 sums in another order), the loss 1e-5,
the 10-step chain 1e-4, the best-of-8 plan TOL_CHAIN_F32 = 2e-3 (the JAX
planner tests' own).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dadiff_tpu.guides import policies as jpol
from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.temporal_transformer import (
    TemporalTransformer as JaxTransformer,
)

from dadiff_tpu_torch import cli, eval_ondevice
from tests.torch_jax_models import seeded_params
from dadiff_tpu_torch.guides import policies as pol
from dadiff_tpu_torch.io.torch_compat import (
    load_pt_checkpoint,
    transformer_params_from_jax,
)
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
from dadiff_tpu_torch.models.temporal_transformer import TemporalTransformer

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

OBS, ACT, T_STEPS, DIM, DEPTH, HEADS = 6, 2, 10, 32, 2, 4
D = OBS + ACT
H = 8
TOL_FWD, TOL_CHAIN, TOL_CHAIN_F32 = 1e-5, 1e-4, 2e-3
DATASET = "synthetic:pointmaze:n=6,T=40"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_params(perturb: bool = True):
    """JAX's own init at horizon 8, or (``perturb``) seeded weights in
    which every leaf carries signal, the zero-initialised adaLN and output
    kernels too."""
    model = JaxTransformer(transition_dim=D, dim=DIM, depth=DEPTH,
                           n_heads=HEADS)
    if perturb:
        return model, seeded_params(model, H, seed=1)
    return model, jax.jit(lambda k: model.init_params(k, H))(
        jax.random.PRNGKey(0))


def _port_model(params):
    m = TemporalTransformer(D, dim=DIM, depth=DEPTH, n_heads=HEADS)
    m.load_state_dict(transformer_params_from_jax(_np_tree(params)),
                      strict=True)
    return m.eval()


@functools.lru_cache(maxsize=None)
def _diffusions():
    model, params = _jax_params()
    jdiff = JaxDiffusion(model=model, horizon=H, observation_dim=OBS,
                         action_dim=ACT, n_timesteps=T_STEPS)
    diff = GaussianDiffusion(_port_model(params), horizon=H,
                             observation_dim=OBS, action_dim=ACT,
                             n_timesteps=T_STEPS).eval()
    return jdiff, params, diff


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("horizon", [7, 12, 33])
def test_params_from_jax_give_the_jax_forward(horizon):
    """Any horizon (no divisibility constraint), the position table sliced
    to it; timesteps across the chain."""
    model, params = _jax_params()
    rng = np.random.RandomState(horizon)
    x = rng.randn(3, horizon, D).astype(np.float32)
    t = np.array([0, 4, 9])
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(x),
                                jnp.asarray(t, jnp.int32))
    with torch.no_grad():
        got = _port_model(params)(_t(x), _t(t))
    assert got.dtype == torch.float32 and got.shape == (3, horizon, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_FWD,
                               rtol=TOL_FWD)


def test_fresh_model_predicts_zeros_and_inits_like_flax():
    """adaLN-Zero: the zero-initialised final projection makes a fresh
    model's output exactly zero, on both sides. The other kernels take
    lecun_normal (deviation 1/sqrt(fan_in)), pos_emb normal(0.02), biases
    zero."""
    model, params = _jax_params(perturb=False)
    x = np.random.RandomState(0).randn(2, H, D).astype(np.float32)
    t = np.array([3, 7])
    want = model.apply({"params": params}, jnp.asarray(x),
                       jnp.asarray(t, jnp.int32))
    m = TemporalTransformer(D, dim=256, depth=2, n_heads=8)
    with torch.no_grad():
        got = m(_t(x), _t(t))
    assert not np.asarray(want).any() and not got.any()
    state = m.state_dict()
    for name in ("blocks.0.adaln_mod.weight", "final_mod.weight",
                 "out_proj.weight"):
        assert not state[name].any(), name
    assert all(not v.any() for k, v in state.items() if k.endswith(".bias"))
    for name, fan_in in (("blocks.1.mlp1.weight", 256),
                         ("blocks.1.mlp2.weight", 1024),
                         ("blocks.0.attn.query.weight", 256)):
        std = float(state[name].std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05, (name, std)
    assert abs(float(state["pos_emb"].std()) - 0.02) < 1e-3
    assert m.dim_mults == ()


def test_horizon_above_max_horizon_is_refused():
    m = TemporalTransformer(D, dim=16, depth=1, n_heads=2, max_horizon=8)
    with pytest.raises(ValueError, match="max_horizon"):
        m(torch.zeros(1, 9, D), torch.zeros(1, dtype=torch.long))
    assert m(torch.zeros(1, 8, D), torch.zeros(1, dtype=torch.long)).shape \
        == (1, 8, D)


@pytest.mark.parametrize("transition_dim,count", [(6, 7_892_486),
                                                  (8, 7_893_512)])
def test_parameter_count_at_the_recipe_width(transition_dim, count):
    """dim 256, depth 6, 8 heads: the JAX module's count (from its shapes,
    nothing initialised) equals the port's; UMaze's transitions are 8 wide."""
    model = JaxTransformer(transition_dim=transition_dim, dim=256, depth=6,
                           n_heads=8)
    shapes = jax.eval_shape(lambda k: model.init_params(k, 32),
                            jax.random.PRNGKey(0))
    jax_count = sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(shapes))
    port = TemporalTransformer(transition_dim, dim=256, depth=6, n_heads=8)
    assert jax_count == count
    assert sum(p.numel() for p in port.parameters()) == count


# ---------------------------------------------------------------------------
# Through GaussianDiffusion and the policies
# ---------------------------------------------------------------------------

def test_p_sample_loop_and_loss_match_jax():
    jdiff, params, diff = _diffusions()
    rng = np.random.RandomState(5)
    init = rng.randn(2, H, D).astype(np.float32)
    noise = rng.randn(T_STEPS, 2, H, D).astype(np.float32)
    want = jdiff.p_sample_loop(params, jax.random.PRNGKey(0), (2, H, D),
                               init_noise=jnp.asarray(init),
                               step_noise=jnp.asarray(noise))
    got = diff.p_sample_loop((2, H, D), init_noise=_t(init),
                             step_noise=_t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_CHAIN)
    x0 = rng.randn(4, H, D).astype(np.float32)
    t = rng.randint(0, T_STEPS, 4)
    eps = rng.randn(4, H, D).astype(np.float32)
    want = jdiff.loss(params, jax.random.PRNGKey(0), jnp.asarray(x0),
                      t=jnp.asarray(t, jnp.int32), noise=jnp.asarray(eps))
    got = diff.loss(_t(x0), t=_t(t), noise=_t(eps))
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=TOL_FWD)


class _Affine:
    """One normalizer for both packages: per-dim affine maps in numpy."""

    obs_mean = np.array([0.1, -0.2, 0.0, 0.05, 0.3, -0.1], np.float32)
    obs_std = np.array([1.5, 2.0, 0.5, 0.7, 1.2, 1.8], np.float32)
    action_mean = np.array([0.02, -0.01], np.float32)
    action_std = np.array([0.6, 0.4], np.float32)

    def normalize_observations(self, x):
        return ((np.asarray(x, np.float32) - self.obs_mean)
                / self.obs_std).astype(np.float32)

    def unnormalize_observations(self, x):
        return np.asarray(x, np.float32) * self.obs_std + self.obs_mean

    def unnormalize_actions(self, x):
        return np.asarray(x, np.float32) * self.action_std + self.action_mean


def _projection():
    from dadiff_tpu_torch.dynamics.projection import ProjectionMatrixBuilder

    dt = 0.1
    A = np.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]])
    B = np.array([[0.5 * dt * dt, 0], [0, 0.5 * dt * dt], [dt, 0], [0, dt]])
    return ProjectionMatrixBuilder(A, B, 4, ACT).get_projection_matrix(H) \
        .astype(np.float32)


def test_dynamics_aware_bo8_plan_matches_jax():
    """The first best-of-8 plan of a dynamics-aware policy (projection at
    every step, noise_schedule) on the JAX policy's draws:
    ``split(PRNGKey(seed))`` (policies.py:311), then the sampler's
    ``split(key, 3)`` (sampling.py:248); and the actions it buffers."""
    jdiff, params, diff = _diffusions()
    P, norm, seed, n = _projection(), _Affine(), 7, 8
    kw = dict(state_dim=4, projection_schedule="noise_schedule",
              action_horizon=4, n_candidates=n, seed=seed)
    jp = jpol.DynamicsAwarePolicy(jdiff, projection_matrix=P,
                                  normalizer=norm, params=params, **kw)
    pp = pol.DynamicsAwarePolicy(diff, projection_matrix=P, normalizer=norm,
                                 **kw)
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    _, init_key, noise_key = jax.random.split(key, 3)
    init = _t(jax.random.normal(init_key, (n, H, D)))
    step = _t(jax.random.normal(noise_key, (T_STEPS, n, H, D)))
    plan = pp._plan
    pp._plan = lambda g, c, P=None, s=None: plan(
        g, c, P, s, init_noise=init, step_noise=step)
    obs = np.array([0.4, -0.3, 0.1, 0.0, 1.0, 0.8], np.float32)
    want = jp.plan(obs)
    got = pp.plan(obs)
    assert got.shape == (1, H, D)
    np.testing.assert_allclose(got, want, atol=TOL_CHAIN_F32)
    jp._fill_action_buffer(want)
    pp._fill_action_buffer(got)
    np.testing.assert_allclose(np.stack(pp.action_buffer),
                               np.stack(jp.action_buffer), atol=1e-3)


# ---------------------------------------------------------------------------
# The CLI: train, load, resume, fine-tune, and the module-path entry points
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--dataset", DATASET, "--horizon", str(H), "--model-type",
              "transformer", "--dim", "16", "--depth", "2", "--n-heads", "2",
              "--n-timesteps", "6", "--batch-size", "16", "--warmup-steps",
              "2", "--device", "cpu", "--log-freq", "1", "--eval-freq", "0"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("tt")
    log_dir = cli.train_main(TRAIN_ARGS + ["--n-epochs", "1", "--max-steps",
                                           "4", "--log-dir", str(root)])
    return root, log_dir, os.path.join(log_dir, "checkpoint_step_4.pt")


def test_train_cli_writes_a_pt_that_load_model_rebuilds(trained):
    root, log_dir, ckpt = trained
    lines = [json.loads(line) for line in open(f"{log_dir}/metrics.jsonl")]
    assert lines[-1]["step"] == 4 and all(np.isfinite(lines[-1]
                                                      ["total_series"]))
    raw = load_pt_checkpoint(ckpt)
    cfg = raw["config"]
    assert (cfg["model_type"], cfg["dim"], cfg["depth"], cfg["n_heads"],
            cfg["mlp_ratio"]) == ("transformer", 16, 2, 2, 4)
    assert "model.blocks.1.attn.out.weight" in raw["model_state_dict"]
    assert set(raw["ema_state_dict"]) == set(raw["model_state_dict"])
    final = json.load(open(f"{log_dir}/final_config.json"))
    assert final["model_type"] == "transformer" and final["dim_mults"] == []
    diff, dataset = cli.load_model(ckpt, DATASET, device="cpu")
    m = diff.model
    assert isinstance(m, TemporalTransformer)
    assert (m.dim, m.depth, m.n_heads, m.mlp_ratio, diff.n_timesteps) == (
        16, 2, 2, 4, 6)
    for k, v in diff.state_dict().items():
        assert torch.equal(v, raw["model_state_dict"][k]), k
    ema, _ = cli.load_model(ckpt, DATASET, device="cpu", use_ema=True)
    assert not torch.equal(ema.model.out_proj.weight, m.out_proj.weight)
    x = diff.p_sample_loop((2, H, D),
                           generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(x).all()


def test_train_cli_resumes_and_fine_tunes_a_transformer(trained):
    root, log_dir, ckpt = trained
    resumed = cli.train_main(TRAIN_ARGS + [
        "--n-epochs", "1", "--max-steps", "2", "--log-dir", str(root),
        "--resume"])
    assert resumed == log_dir
    assert os.path.isfile(f"{log_dir}/checkpoint_step_6.pt")
    # the family and the widths come from the checkpoint, not from the flags
    tuned = cli.train_main([
        "--dataset", DATASET, "--device", "cpu", "--checkpoint", ckpt,
        "--finetune-mode", "--n-epochs", "1", "--max-steps", "2",
        "--batch-size", "16", "--eval-freq", "0", "--log-dir",
        str(root / "ft")])
    diff, _ = cli.load_model(f"{tuned}/checkpoint_step_2.pt", DATASET,
                             device="cpu")
    assert isinstance(diff.model, TemporalTransformer)
    assert (diff.model.dim, diff.model.depth, diff.horizon) == (16, 2, H)


def _server_args(ckpt, *extra):
    from dadiff_tpu_torch.serve import build_server_parser

    return build_server_parser().parse_args(
        ["--checkpoint", ckpt, "--dataset", DATASET, "--device", "cpu",
         "--policy-type", "dynamics-aware", "--n-candidates", "3",
         "--action-horizon", "4", *extra])


def test_module_path_entry_points_take_a_transformer(trained, tmp_path):
    """serve's handler (concurrency 1) and a micro-batched session
    (concurrency K), eval_ondevice (the module path) and distill
    --method consistency, each on the transformer .pt."""
    from dadiff_tpu_torch.serve import make_handler
    from dadiff_tpu_torch.serving import BatchedPlanner

    _, _, ckpt = trained
    diff, dataset = cli.load_model(ckpt, DATASET, device="cpu")
    policy = cli.build_policy_from_args(_server_args(ckpt), diff, dataset,
                                        DATASET, diff.n_timesteps)
    handle = make_handler(policy)
    obs = [0.5, -0.5, 0.0, 0.1, 1.0, 1.0]
    r = handle({"obs": obs, "plan": True})
    assert np.asarray(r["plan"]).shape == (H, D) and len(r["action"]) == ACT
    batcher = BatchedPlanner(policy, max_batch=2, window_ms=50.0)
    try:
        traj = batcher.session(seed=1).plan(np.asarray(obs, np.float32))
    finally:
        batcher.close()
    assert traj.shape == (1, H, D) and np.isfinite(traj).all()
    out = eval_ondevice.main([
        "--checkpoint", ckpt, "--dataset", DATASET, "--device", "cpu",
        "--batch", "2", "--n-replans", "2", "--action-horizon", "4",
        "--projection", "--n-candidates", "2", "--warm-start-t", "3",
        "--results-dir", ""])
    assert out["model_calls_per_replan"] == [6, 3]
    assert 0.0 <= out["success_rate"] <= 1.0
    log_dir = cli.distill_main([
        "--checkpoint", ckpt, "--dataset", DATASET, "--device", "cpu",
        "--n-epochs", "1", "--max-steps", "2", "--batch-size", "8",
        "--save-freq", "0", "--log-dir", str(tmp_path)])
    student, sdata = cli.load_model(f"{log_dir}/checkpoint_step_2.pt",
                                    DATASET, device="cpu")
    assert isinstance(student.model, TemporalTransformer)
    assert sdata.checkpoint_config["consistency"] is True


def test_locomotion_evaluator_takes_a_transformer(tmp_path):
    """eval_ondevice_locomotion plans through the module path: a
    transformer trained (2 steps) on the Hopper data drives the physics
    loop on the CPU."""
    from dadiff_tpu_torch import eval_ondevice_locomotion as evl

    data = "npz:data/hopper_mppi.npz"
    log_dir = cli.train_main([
        "--dataset", data, "--horizon", str(H), "--model-type",
        "transformer", "--dim", "16", "--depth", "1", "--n-heads", "2",
        "--n-timesteps", "5", "--batch-size", "8", "--max-steps", "2",
        "--n-epochs", "1", "--eval-freq", "0", "--device", "cpu",
        "--log-dir", str(tmp_path)])
    out = evl.main([
        "--checkpoint", f"{log_dir}/checkpoint_step_2.pt", "--dataset", data,
        "--env", "Hopper-v5", "--backend", "physics", "--solver", "jacobi",
        "--solver-iters", "5", "--batch", "2", "--n-replans", "2",
        "--action-horizon", "1", "--skip-conditioned-action", "--device",
        "cpu", "--results-dir", ""])
    assert np.isfinite(out["mean_return"])


def test_megakernel_refuses_a_transformer(trained):
    """The planner chain runs the U-Net's layer program: the served policy
    and the on-device evaluator refuse a transformer with --megakernel and
    name the module path."""
    _, _, ckpt = trained
    diff, dataset = cli.load_model(ckpt, DATASET, device="cpu")
    with pytest.raises(ValueError, match="module path"):
        cli.build_policy_from_args(_server_args(ckpt, "--megakernel"), diff,
                                   dataset, DATASET, diff.n_timesteps)
    with pytest.raises(ValueError, match="module path"):
        eval_ondevice.main(["--checkpoint", ckpt, "--dataset", DATASET,
                            "--device", "cpu", "--megakernel",
                            "--action-horizon", "4", "--results-dir", ""])


def test_jax_megakernel_wires_a_transformer_then_fails_at_the_first_plan():
    """The JAX package wires --megakernel on any denoiser
    (pallas_planner.py:449-494) and fails at the first plan, flattening the
    U-Net's layers out of a transformer's params (pallas_unet.py:137:
    ``KeyError: 'mid_block1'``). The port refuses at wiring instead
    (test_megakernel_refuses_a_transformer)."""
    from dadiff_tpu.ops.pallas_planner import wire_policy_megakernel

    jdiff, params, _ = _diffusions()
    policy = jpol.DynamicsAwarePolicy(
        jdiff, projection_matrix=_projection(), normalizer=_Affine(),
        params=params, state_dim=4, action_horizon=4, n_candidates=4)
    wire_policy_megakernel(policy, n_candidates=4, group_chains=4,
                           interpret=True)
    assert policy.megakernel and policy.n_candidates == 1
    with pytest.raises(KeyError, match="mid_block1"):
        policy.plan(np.zeros(OBS, np.float32))


def test_train_parser_matches_jax():
    """The port's train flags are the JAX parser's (--config and --dtype
    included), plus --max-steps and --log-freq; every shared default equals
    JAX's but --device (cuda, not tpu), and the model families, the
    activation dtypes and the dynamics methods are the same choices."""
    from dadiff_tpu.cli import build_train_parser as jax_parser

    def flags(parser):
        return {a.option_strings[0]: a for a in parser._actions
                if a.option_strings and a.option_strings[0] != "-h"}

    jf, tf = flags(jax_parser()), flags(cli.build_train_parser())
    assert set(jf) - set(tf) == set()
    assert set(tf) - set(jf) == {"--max-steps", "--log-freq"}
    differ = {k for k in set(jf) & set(tf) if jf[k].default != tf[k].default}
    assert differ == {"--device"} and tf["--device"].default == "cuda"
    for name in ("--model-type", "--dtype", "--dynamics-method"):
        assert tf[name].choices == jf[name].choices, name
    for name in ("--model-type", "--depth", "--n-heads", "--dim", "--dtype",
                 "--config"):
        assert tf[name].type == jf[name].type, name
