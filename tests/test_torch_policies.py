"""The port's remaining policies held against the JAX package on the CPU:
MPC, guided and value-guided plans (both guide flavours) with the JAX
plans' draws injected, each scorer, the action buffer with
``skip_conditioned_action``, ``replan_deviation`` and inverse dynamics
(open loop and ``track_planned_states``) driven by a closure; the eval and
server parsers against the JAX ones; and the policy the CLI builds for
each ``--policy-type``, with its refusals.

Tiny model: dim 8, mults (1, 2), horizon 8, T = 10. Tolerances: plans
1e-4 (10 U-Net evaluations, and with guidance 10 value-net gradients, the
f32 rounding of XLA and PyTorch apart); scorers 1e-5; buffered actions
1e-6 (the same affine maps of the same plan).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dadiff_tpu import cli as jcli
from dadiff_tpu.guides import policies as jpol
from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.models.value_net import ValueNet as JaxValueNet
from dadiff_tpu.models.value_net import make_value_guide_fn as jax_guide

from dadiff_tpu_torch import cli, serve
from dadiff_tpu_torch.envs.pointmaze_jax import MAZE_MAPS
from dadiff_tpu_torch.guides import policies as pol
from dadiff_tpu_torch.io.torch_compat import params_from_jax, value_params_from_jax
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.models.value_net import ValueNet, make_value_guide_fn

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

H, OBS, ACT, T_STEPS = 8, 6, 2, 10
D = OBS + ACT
TOL_PLAN, TOL_SCORE, TOL_ACT = 1e-4, 1e-5, 1e-6
DATASET = "synthetic:pointmaze:n=6,T=40"


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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models():
    jdiff = JaxDiffusion(model=JaxUnet(transition_dim=D, dim=8,
                                       dim_mults=(1, 2)),
                         horizon=H, observation_dim=OBS, action_dim=ACT,
                         n_timesteps=T_STEPS)
    params = jax.jit(jdiff.init_params)(jax.random.PRNGKey(0))
    diff = GaussianDiffusion(TemporalUnet(D, dim=8, dim_mults=(1, 2)),
                             horizon=H, observation_dim=OBS, action_dim=ACT,
                             n_timesteps=T_STEPS).eval()
    diff.model.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    vnet = JaxValueNet(transition_dim=D, dim=8, dim_mults=(1, 2))
    vparams = jax.jit(lambda k: vnet.init_params(k, H))(jax.random.PRNGKey(3))
    port_vnet = ValueNet(D, dim=8, dim_mults=(1, 2))
    port_vnet.load_state_dict(value_params_from_jax(_np_tree(vparams)),
                              strict=True)
    return jdiff, params, diff, (vnet, vparams), port_vnet.requires_grad_(False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inject_first_plan(policy, seed, n):
    """The port policy's replans take the draws of the JAX policy's first
    plan: ``split(PRNGKey(seed))`` (policies.py:311), then the sampler's
    ``split(key, 3)`` (sampling.py:248)."""
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    _, init_key, noise_key = jax.random.split(key, 3)
    init = _t(jax.random.normal(init_key, (n, H, D)))
    step = _t(jax.random.normal(noise_key, (T_STEPS, n, H, D)))
    plan = policy._plan
    policy._plan = lambda g, c, P=None, s=None: plan(
        g, c, P, s, init_noise=init, step_noise=step)


def _value_fns():
    """The per-step flavour: a value of the planned observations."""
    target = np.linspace(-0.5, 0.5, OBS).astype(np.float32)

    def jax_value(obs):
        return -jnp.sum((obs - target) ** 2, axis=-1)

    def port_value(obs):
        return -((obs - torch.from_numpy(target)) ** 2).sum(dim=-1)

    return jax_value, port_value


CASES = ["mpc_bo3", "guided", "value_net", "value_per_step"]


def _policies(case, seed=7):
    jdiff, params, diff, (vnet, vparams), port_vnet = _models()
    norm = _Affine()
    if case == "mpc_bo3":
        return (jpol.MPCPolicy(jdiff, norm, params=params, action_horizon=4,
                               n_candidates=3, seed=seed),
                pol.MPCPolicy(diff, norm, action_horizon=4, n_candidates=3,
                              seed=seed), 3)
    if case == "guided":
        return (jpol.GuidedPolicy(jdiff, norm, params=params, seed=seed),
                pol.GuidedPolicy(diff, norm, seed=seed), 1)
    if case == "value_net":
        return (jpol.ValueGuidedPolicy(
                    jdiff, norm, trajectory_value_fn=jax_guide(vnet, vparams),
                    params=params, guide_weight=2.0, action_horizon=4,
                    seed=seed),
                pol.ValueGuidedPolicy(
                    diff, norm, trajectory_value_fn=make_value_guide_fn(
                        port_vnet), guide_weight=2.0, action_horizon=4,
                    seed=seed), 1)
    jax_value, port_value = _value_fns()
    return (jpol.ValueGuidedPolicy(jdiff, norm, value_fn=jax_value,
                                   params=params, guide_weight=0.5,
                                   action_horizon=4, seed=seed),
            pol.ValueGuidedPolicy(diff, norm, value_fn=port_value,
                                  guide_weight=0.5, action_horizon=4,
                                  seed=seed), 1)


@pytest.mark.parametrize("case", CASES)
def test_plan_matches_jax(case):
    """The first plan of each policy on the JAX draws, best of N included,
    and the actions it buffers."""
    jp, pp, n = _policies(case)
    _inject_first_plan(pp, 7, n)
    obs = np.array([0.4, -0.3, 0.1, 0.0, 1.0, 0.8], np.float32)
    want = jp.plan(obs)
    got = pp.plan(obs)
    assert got.shape == (1, H, D)
    np.testing.assert_allclose(got, want, atol=TOL_PLAN)
    jp._fill_action_buffer(want)
    pp._fill_action_buffer(got)
    np.testing.assert_allclose(np.stack(pp.action_buffer),
                               np.stack(jp.action_buffer), atol=1e-4)
    if case.startswith("value"):
        # the guidance moved the plan: the same draws without it differ
        _, plain, _ = _policies("guided")
        _inject_first_plan(plain, 7, 1)
        assert np.abs(plain.plan(obs) - got).max() > 1e2 * TOL_PLAN


def test_value_guided_needs_a_value():
    _, _, diff, _, _ = _models()
    with pytest.raises(ValueError, match="value_fn or trajectory_value_fn"):
        pol.ValueGuidedPolicy(diff, _Affine())


def test_scorers_match_jax():
    rng = np.random.RandomState(0)
    trajs = rng.randn(5, H, D).astype(np.float32) * 1.5
    normed = rng.randn(OBS).astype(np.float32)
    n = _Affine()
    grid = MAZE_MAPS["umaze"]
    pairs = [
        (jpol.goal_distance_scorer, pol.goal_distance_scorer),
        (jpol.make_goal_distance_scorer(n.obs_mean, n.obs_std),
         pol.make_goal_distance_scorer(n.obs_mean, n.obs_std)),
        (jpol.make_wall_penalty_scorer(n.obs_mean, n.obs_std, grid, 5.0),
         pol.make_wall_penalty_scorer(n.obs_mean, n.obs_std, grid, 5.0)),
        (jpol.make_wall_penalty_scorer(n.obs_mean, n.obs_std, grid, 2.0,
                                       margin=0.2),
         pol.make_wall_penalty_scorer(n.obs_mean, n.obs_std, grid, 2.0,
                                      margin=0.2)),
    ]
    for jf, pf in pairs:
        want = np.asarray(jf(jnp.asarray(trajs), jnp.asarray(normed)))
        got = pf(torch.from_numpy(trajs), torch.from_numpy(normed)).numpy()
        np.testing.assert_allclose(got, want, atol=TOL_SCORE)
    wide = rng.randn(4, H, 20).astype(np.float32)
    for env in ("HalfCheetah-v5", "Hopper-v5", "Walker2d-v5"):
        want = np.asarray(jpol.velocity_scorer_for_env(env)(
            jnp.asarray(wide), None))
        got = pol.velocity_scorer_for_env(env)(torch.from_numpy(wide), None)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL_SCORE)
    with pytest.raises(ValueError, match="No velocity scorer"):
        pol.velocity_scorer_for_env("PointMaze_UMaze-v3")
    # the wall term is live on these plans
    pen = pol.make_wall_penalty_scorer(n.obs_mean, n.obs_std, grid, 5.0)
    base = pol.make_goal_distance_scorer(n.obs_mean, n.obs_std)
    t = torch.from_numpy(trajs)
    assert (pen(t, torch.from_numpy(normed))
            > base(t, torch.from_numpy(normed))).any()


def _inverse_dynamics(s, s_next):
    """A closure for both packages: physical states in, actions out."""
    s, s_next = np.atleast_2d(s), np.atleast_2d(s_next)
    return 10.0 * (s_next[:, 2:4] - s[:, 2:4]) + 0.1 * s[:, 0:2]


def _stubbed(pkg_policy, traj, **kw):
    """A policy of either package whose plan is ``traj``, counting plans."""
    jdiff, params, diff, _, _ = _models()
    if pkg_policy is jpol.MPCPolicy:
        policy = pkg_policy(jdiff, _Affine(), params=params,
                            action_horizon=4, **kw)
    else:
        policy = pkg_policy(diff, _Affine(), action_horizon=4, **kw)
    calls = []
    policy.plan = lambda obs: calls.append(1) or traj
    return policy, calls


BUFFER_CASES = {
    "plan_actions": {},
    "skip_conditioned": {"skip_conditioned_action": True},
    "inverse_dynamics": {"inverse_dynamics": _inverse_dynamics},
    "track": {"inverse_dynamics": _inverse_dynamics,
              "track_planned_states": True, "skip_conditioned_action": True},
    "replan_deviation": {"replan_deviation": 0.5},
}


@pytest.mark.parametrize("case", list(BUFFER_CASES))
def test_action_buffer_matches_jax(case):
    """The same plan and the same observations through both packages'
    get_action: the executed actions, the plans taken and the rows the
    deviation check reads. The observations follow the first plan's rows,
    and jump off them at step 3."""
    rng = np.random.RandomState(1)
    traj = (rng.randn(1, H, D) * 0.3).astype(np.float32)
    on_plan = _Affine().unnormalize_observations(traj[0, :, :OBS])
    obs_seq = [on_plan[min(i, H - 1)] for i in range(10)]
    obs_seq[3] = obs_seq[3] + 3.0
    runs = []
    for cls in (jpol.MPCPolicy, pol.MPCPolicy):
        policy, calls = _stubbed(cls, traj, **BUFFER_CASES[case])
        acts = []
        for o in obs_seq:
            acts.append(np.asarray(policy.get_action(o)))
        runs.append((np.stack(acts), len(calls),
                     [np.asarray(r) for r in policy._planned_obs]))
        policy.reset()
        assert policy._planned_obs == [] and policy.action_buffer == []
    (want, want_calls, want_rows), (got, got_calls, got_rows) = runs
    np.testing.assert_allclose(got, want, atol=TOL_ACT)
    assert got_calls == want_calls
    assert len(got_rows) == len(want_rows)
    for a, b in zip(got_rows, want_rows):
        np.testing.assert_allclose(a, b, atol=TOL_ACT)
    # 5 actions a plan, 4 with skip: 2 or 3 plans for 10 steps, more where
    # an observation off the plan drops the buffer
    assert got_calls == {"skip_conditioned": 3, "track": 3,
                         "replan_deviation": got_calls}.get(case, 2)
    assert case != "replan_deviation" or got_calls > 2


def test_track_needs_inverse_dynamics():
    _, _, diff, _, _ = _models()
    with pytest.raises(ValueError, match="needs inverse_dynamics"):
        pol.GuidedPolicy(diff, _Affine(), track_planned_states=True)


# ---------------------------------------------------------------------------
# The parsers and the CLI's policies
# ---------------------------------------------------------------------------

# dests whose difference from the JAX parser is deliberate
DELIBERATE = {
    "device",        # cuda or cpu; JAX names the TPU
    "render",        # none only: the card's machine has no display
    "video_dir",     # goes with render
}


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def _same_flags(jax_parser, port_parser):
    want, got = _actions(jax_parser), _actions(port_parser)
    for dest in sorted(set(want) | set(got)):
        if dest in DELIBERATE:
            continue
        assert dest in want and dest in got, dest
        a, b = want[dest], got[dest]
        for attr in ("option_strings", "default", "choices", "type", "nargs",
                     "const", "required"):
            assert getattr(a, attr) == getattr(b, attr), (dest, attr)
    # every deliberate difference is one
    for dest in DELIBERATE:
        a, b = want.get(dest), got.get(dest)
        assert a is None or b is None or a.choices != b.choices, dest


def test_eval_parser_matches_jax():
    _same_flags(jcli.build_eval_parser(), cli.build_eval_parser())
    args = cli.build_eval_parser().parse_args(["--checkpoint", "x.pt"])
    assert args.policy_type == "mpc"


def test_server_parser_matches_jax():
    from scripts.serve import build_server_parser as jax_server_parser

    _same_flags(jax_server_parser(), serve.build_server_parser())
    args = serve.build_server_parser().parse_args(["--checkpoint", "x.pt"])
    assert (args.concurrency, args.batch_window_ms, args.max_batch) == (
        1, 5.0, 8)


@pytest.fixture(scope="module")
def cli_parts(tmp_path_factory):
    from dadiff_tpu_torch.datasets.sequence import SequenceDataset

    _, _, diff, _, _ = _models()
    dataset = SequenceDataset(DATASET, horizon=H)
    vpath = cli.train_value_main([
        "--dataset", DATASET, "--horizon", str(H), "--dim", "8",
        "--dim-mults", "1", "2", "--n-timesteps", str(T_STEPS),
        "--batch-size", "16", "--max-steps", "2", "--device", "cpu",
        "--log-dir", str(tmp_path_factory.mktemp("values"))])
    return diff, dataset, vpath


def _build(cli_parts, *argv):
    diff, dataset, _ = cli_parts
    args = cli.build_eval_parser().parse_args(
        ["--checkpoint", "x.pt", "--dataset", DATASET, "--device", "cpu",
         *argv])
    return cli.build_policy_from_args(args, diff, dataset, DATASET, T_STEPS)


@pytest.mark.parametrize("ptype,cls,horizon", [
    ("guided", pol.GuidedPolicy, 1), ("mpc", pol.MPCPolicy, 16),
    ("dynamics-aware", pol.DynamicsAwarePolicy, 16),
    ("value-guided", pol.ValueGuidedPolicy, 16)])
def test_cli_builds_each_policy_type(cli_parts, ptype, cls, horizon):
    extra = ["--value-checkpoint", cli_parts[2]] \
        if ptype == "value-guided" else []
    policy = _build(cli_parts, "--policy-type", ptype, "--n-candidates", "2",
                    "--skip-conditioned-action", "--replan-deviation", "0.3",
                    *extra)
    assert type(policy) is cls and policy.action_horizon == horizon
    assert policy.skip_conditioned_action and policy.replan_deviation == 0.3
    # value-guided plans one candidate with the ddpm sampler, as in JAX
    assert policy.n_candidates == (1 if ptype == "value-guided" else 2)
    assert (policy._sampler_config["guide_fn"] is not None) == (
        ptype == "value-guided")
    plan = policy.plan(np.zeros(OBS, np.float32))
    assert plan.shape == (1, H, D) and np.isfinite(plan).all()


@pytest.mark.parametrize("ptype,source", [
    ("guided", "inverse-dynamics"), ("mpc", "track"),
    ("dynamics-aware", "inverse-dynamics"), ("value-guided", "track")])
def test_cli_wires_the_action_source(cli_parts, monkeypatch, ptype, source):
    """``--action-source inverse-dynamics|track`` fits the port's inverse
    model to the dataset (cut to 5 steps of a (16, 16) MLP here) and hands
    it to every policy type; an action comes back from it, of the action
    width and finite."""
    from dadiff_tpu_torch.envs import learned_model

    real = learned_model.train_inverse_dynamics
    fits = []

    def short(episodes, **kw):
        fits.append(kw)
        return real(episodes, **dict(kw, n_steps=5, hidden=(16, 16)))

    monkeypatch.setattr(learned_model, "train_inverse_dynamics", short)
    extra = ["--value-checkpoint", cli_parts[2]] \
        if ptype == "value-guided" else []
    policy = _build(cli_parts, "--policy-type", ptype, "--action-source",
                    source, *extra)
    assert len(fits) == 1 and fits[0]["seed"] == 42
    assert policy.inverse_dynamics is not None
    assert policy.track_planned_states == (source == "track")
    act = policy.get_action(np.zeros(OBS, np.float32))
    assert act.shape == (ACT,) and np.isfinite(act).all()
    default = _build(cli_parts, "--policy-type", ptype, *extra)
    assert default.inverse_dynamics is None


def test_cli_scorers_and_refusals(cli_parts):
    vpath = cli_parts[2]
    policy = _build(cli_parts, "--policy-type", "mpc", "--n-candidates", "2",
                    "--candidate-scorer", "wall-penalty",
                    "--wall-penalty-weight", "3.0")
    assert policy.candidate_scorer.__qualname__.startswith(
        "make_wall_penalty_scorer")
    with pytest.raises(ValueError, match="No velocity scorer"):
        _build(cli_parts, "--candidate-scorer", "velocity")
    # the wave selects by goal distance: another scorer is refused
    for scorer in ("velocity", "wall-penalty"):
        with pytest.raises(ValueError, match="--megakernel selects"):
            _build(cli_parts, "--policy-type", "dynamics-aware",
                   "--megakernel", "--candidate-scorer", scorer)
    # guidance runs on the module path only
    for argv in (["--policy-type", "value-guided"],
                 ["--policy-type", "dynamics-aware"]):
        with pytest.raises(ValueError, match="gradient guidance"):
            _build(cli_parts, *argv, "--value-checkpoint", vpath,
                   "--megakernel")
    with pytest.raises(SystemExit, match="requires --value-checkpoint"):
        _build(cli_parts, "--policy-type", "value-guided")
    with pytest.raises(SystemExit, match="sequential"):
        cli.evaluate_main(["--checkpoint", "nonexistent.pt", "--dataset",
                           DATASET, "--replan-deviation", "0.5", "--batched"])
    # the stacked guide on dynamics-aware, and the megakernel's group size
    stacked = _build(cli_parts, "--policy-type", "dynamics-aware",
                     "--value-checkpoint", vpath, "--guide-weight", "0.7")
    assert stacked._sampler_config["guide_weight"] == 0.7
    wired = _build(cli_parts, "--policy-type", "dynamics-aware",
                   "--megakernel", "--n-candidates", "4",
                   "--mega-group-chains", "2")
    assert wired.megakernel and wired.n_candidates == 1
    x0, _ = wired._plan.sampler.draw(torch.Generator().manual_seed(0))
    assert x0.shape == (4 * H, D)
