"""The port's evaluation path held against the JAX package on the CPU: the
on-device plan -> step -> replan loop (envs/rollout.py), the host evaluators
and their CLI (envs/host.py, envs/vector_eval.py, cli.evaluate_main), the
results file, EMA weights at load, the flags the port refuses, and the plan
of K2's tiles at the evaluator's 1,024 chains.

Tiny model (dim 8, mults (1, 2), horizon 8, T = 5). Tolerances: the JAX
planner kernel runs in interpret mode with f32 weights, and final positions
and plans agree to 3e-3, the tolerance of tests/test_pallas_planner.py with
projection; success flags, episode lengths and sparse rewards exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dadiff_tpu import cli as jcli
from dadiff_tpu.dynamics.projection import ProjectionMatrixBuilder as JaxPMB
from dadiff_tpu.envs.pointmaze_jax import PointMazeJax as JaxEnv
from dadiff_tpu.envs.rollout import make_ondevice_evaluator as jax_evaluator
from dadiff_tpu.guides.sampling import ProjectionSpec as JaxSpec
from dadiff_tpu.io.torch_compat import save_pt_checkpoint as jax_save_pt
from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.ops import pallas_planner as jpp
from dadiff_tpu.ops import projection as jproj
from dadiff_tpu.ops.pallas_unet import prepare_chain_operands as jax_prepare

from dadiff_tpu_torch import cli
from dadiff_tpu_torch import eval_ondevice
from dadiff_tpu_torch.envs.pointmaze_jax import PointMazeJax
from dadiff_tpu_torch.envs.rollout import make_ondevice_evaluator
from dadiff_tpu_torch.guides.sampling import (
    ProjectionSpec, conditions_for_initial_obs,
)
from dadiff_tpu_torch.io.torch_compat import params_from_jax
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops import conv_tiling as ct
from dadiff_tpu_torch.ops import planner as pl
from dadiff_tpu_torch.ops.projection import NormStats

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

H, OBS, ACT, T_STEPS = 8, 6, 2, 5
D = OBS + ACT
TOL = 3e-3
DATASET = "synthetic:pointmaze:n=6,T=40"


def _tiny_models(seed=0):
    jax_diff = JaxDiffusion(model=JaxUnet(transition_dim=D, dim=8,
                                          dim_mults=(1, 2)),
                            horizon=H, observation_dim=OBS, action_dim=ACT,
                            n_timesteps=T_STEPS)
    params = jax.jit(jax_diff.init_params)(jax.random.PRNGKey(seed))
    unet = TemporalUnet(transition_dim=D, dim=8, dim_mults=(1, 2))
    unet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                params)),
                         strict=True)
    diff = GaussianDiffusion(unet, horizon=H, observation_dim=OBS,
                             action_dim=ACT, n_timesteps=T_STEPS).eval()
    return jax_diff, params, diff


@pytest.fixture(scope="module")
def models():
    return _tiny_models()


@pytest.fixture(scope="module")
def dynamics():
    dt = 0.1
    A = np.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]])
    B = np.array([[0.5 * dt * dt, 0], [0, 0.5 * dt * dt], [dt, 0], [0, dt]])
    P = JaxPMB(A, B, 4, ACT).get_projection_matrix(H).astype(np.float32)
    stats = (np.zeros(OBS), np.full(OBS, 1.5), np.zeros(ACT), np.ones(ACT))
    jstats = jproj.NormStats(*(jnp.asarray(v, jnp.float32) for v in stats))
    pstats = NormStats(*(torch.tensor(v, dtype=torch.float32) for v in stats))
    return P, jstats, pstats


# ---------------------------------------------------------------------------
# The on-device loop
# ---------------------------------------------------------------------------

def _recording_env(env_cls, record, jax_side):
    """``env_cls`` whose step also appends the action it takes, (B, 2) as
    numpy, to ``record``: through an ordered host callback on the JAX side,
    whose step runs inside the evaluator's scans."""

    class Recording(env_cls):
        def step(self, state, a):
            if jax_side:
                jax.debug.callback(lambda v: record.append(np.array(v)), a,
                                   ordered=True)
            else:
                record.append(a.numpy().copy())
            return super().step(state, a)

    return Recording()


@pytest.mark.parametrize("n_candidates", [1, 2])
@pytest.mark.parametrize("projection", [False, True])
def test_ondevice_evaluator_matches_jax_megakernel(models, dynamics,
                                                   projection, n_candidates):
    """2 envs x best of N x 2 replans x 4 actions, with and without the
    projection: the JAX reset state and the draws of the JAX plan's keys go
    into the port; the actions the port's planner-chain path and its module
    path execute at every step of every replan, and where they end, agree
    with the JAX evaluator (megakernel, interpret mode)."""
    jax_diff, params, diff = models
    P, jstats, pstats = dynamics
    B, N, R, A = 2, n_candidates, 2, 4
    jspec = JaxSpec(state_dim=4) if projection else None
    spec = ProjectionSpec(state_dim=4) if projection else None
    want_acts = []
    env = _recording_env(JaxEnv, want_acts, jax_side=True)
    jeval = jax_evaluator(
        jax_diff, env, action_horizon=A, n_replans=R, n_candidates=N,
        projection=jspec, use_megakernel=True,
        P=jnp.asarray(P), stats=jstats, mega_group_chains=4,
        mega_interpret=True)
    key = jax.random.PRNGKey(1)
    want, want_state = jeval(params, key, jstats, B, jnp.asarray(P))
    jax.effects_barrier()
    assert len(want_acts) == R * A

    # what the JAX evaluate draws (rollout.py:141-249, pallas_planner.py:414)
    rng, reset_key = jax.random.split(key)
    state0, _ = JaxEnv().reset(reset_key, B)
    noise = []
    for k in jax.random.split(rng, R):
        init_key, noise_key = jax.random.split(k)
        noise.append(tuple(torch.from_numpy(np.array(v)) for v in (
            jax.random.normal(init_key, (B * N * H, D)),
            jax.random.normal(noise_key, (T_STEPS, B * N * H, D)))))
    for mega in (True, False):
        got_acts = []
        evaluate = make_ondevice_evaluator(
            diff, _recording_env(PointMazeJax, got_acts, jax_side=False),
            action_horizon=A, n_replans=R, n_candidates=N, projection=spec,
            use_megakernel=mega, P=torch.from_numpy(P), stats=pstats,
            mega_group_chains=4)
        state, _ = PointMazeJax().reset(
            None, pos=torch.from_numpy(np.array(state0.pos)),
            goal=torch.from_numpy(np.array(state0.goal)))
        got, got_state = evaluate(None, pstats, B, torch.from_numpy(P),
                                  state=state, noise=noise)
        np.testing.assert_allclose(np.stack(got_acts), np.stack(want_acts),
                                   atol=TOL)
        np.testing.assert_allclose(got_state.pos.numpy(),
                                   np.asarray(want_state.pos), atol=TOL)
        np.testing.assert_array_equal(got_state.t.numpy(), R * A)
        np.testing.assert_array_equal(got.per_env_success.numpy(),
                                      np.asarray(want.per_env_success))
        np.testing.assert_array_equal(got.per_env_reward.numpy(),
                                      np.asarray(want.per_env_reward))
        np.testing.assert_allclose(float(got.mean_final_distance),
                                   float(want.mean_final_distance), atol=TOL)


def _reaching_state():
    """Four envs that start 0.6 from their goals in the UMaze's corridors,
    so that the plans decide whether an env succeeds."""
    pos = torch.tensor([[-1.0, 1.0], [0.0, 1.0], [1.0, 0.4], [1.0, -0.6]])
    goal = pos + torch.tensor([[0.6, 0.0], [0.6, 0.0], [0.0, -0.6],
                               [0.0, -0.6]])
    return PointMazeJax().reset(None, pos=pos, goal=goal)[0]


@pytest.mark.parametrize("n_candidates", [1, 3])
@pytest.mark.parametrize("projection", [False, True])
def test_module_path_matches_planner_chain_path(models, dynamics, projection,
                                                n_candidates):
    """The module-path evaluator (the DDPM sampler, best of N against the
    env's physical goal) against the planner-chain path on the same noise:
    the plans agree to f32 rounding, so the episodes end alike."""
    _, _, diff = models
    P, _, pstats = dynamics
    B, R, A = 4, 3, 4
    C = B * n_candidates
    g = torch.Generator().manual_seed(7)
    noise = [(torch.randn(C * H, D, generator=g),
              torch.randn(T_STEPS, C * H, D, generator=g)) for _ in range(R)]
    spec = ProjectionSpec(state_dim=4) if projection else None
    out = []
    for mega in (True, False):
        evaluate = make_ondevice_evaluator(
            diff, PointMazeJax(), action_horizon=A, n_replans=R,
            n_candidates=n_candidates, projection=spec, use_megakernel=mega,
            P=torch.from_numpy(P), stats=pstats, mega_group_chains=C)
        out.append(evaluate(None, pstats, B, torch.from_numpy(P),
                            state=_reaching_state(), noise=noise))
    (m1, s1), (m2, s2) = out
    np.testing.assert_allclose(s1.pos.numpy(), s2.pos.numpy(), atol=1e-4)
    np.testing.assert_array_equal(m1.per_env_success.numpy(),
                                  m2.per_env_success.numpy())
    np.testing.assert_array_equal(m1.per_env_reward.numpy(),
                                  m2.per_env_reward.numpy())


def test_group_count_sets_only_the_padding(models, dynamics):
    """--mega-group-chains: a count that divides the B * N chains gives the
    same plans bit for bit; one that does not pads the wave to whole groups,
    drawing noise for the padded chains, which are planned and dropped: on
    the same noise for the real chains the plans are the same."""
    _, _, diff = models
    P, _, pstats = dynamics
    B, N = 3, 2
    obs = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, OBS)).astype(np.float32))
    cond = conditions_for_initial_obs(obs, OBS, H, D)

    def sampler(group_chains):
        return pl.make_bo_sampler(
            diff, projection_spec=ProjectionSpec(state_dim=4),
            P=torch.from_numpy(P), stats=pstats, n_candidates=N,
            group_chains=group_chains, weight_dtype=torch.float32)

    plans = {gc: sampler(gc)(torch.Generator().manual_seed(5), cond)
             for gc in (6, 3, 2, 1)}
    for gc in (3, 2, 1):
        assert torch.equal(plans[gc], plans[6])
    g = torch.Generator().manual_seed(5)
    x0 = torch.randn(8 * H, D, generator=g)
    noise = torch.randn(T_STEPS, 8 * H, D, generator=g)
    padded = sampler(4)(None, cond, x0=x0, step_noise=noise)  # 2 groups of 4
    exact = sampler(6)(None, cond, x0=x0[:6 * H],
                       step_noise=noise[:, :6 * H].contiguous())
    assert torch.equal(padded, exact)
    with pytest.raises(ValueError):  # the padded wave takes noise for 8
        sampler(4)(None, cond, x0=x0[:6 * H],
                   step_noise=noise[:, :6 * H].contiguous())


def test_ondevice_evaluator_draws_from_its_generator(models, dynamics):
    """Without hooks the evaluator resets and plans from the generator: the
    same seed repeats, metrics are device tensors of the stated shapes."""
    _, _, diff = models
    P, _, pstats = dynamics
    evaluate = make_ondevice_evaluator(
        diff, PointMazeJax(), action_horizon=3, n_replans=2, n_candidates=2,
        projection=ProjectionSpec(state_dim=4), use_megakernel=True,
        P=torch.from_numpy(P), stats=pstats)
    runs = [evaluate(torch.Generator().manual_seed(s), pstats, 5,
                     torch.from_numpy(P)) for s in (3, 3, 4)]
    (m, state), (m2, state2), (_, state3) = runs
    assert torch.equal(state.pos, state2.pos) and torch.equal(
        m.per_env_reward, m2.per_env_reward)
    assert not torch.equal(state.pos, state3.pos)
    assert m.success_rate.shape == () and m.per_env_success.shape == (5,)
    assert m.per_env_success.dtype == torch.bool
    assert (state.t == 6).all()


@pytest.mark.parametrize("kw", [{"warm_start_t": 3}, {"sampler": "ddim"},
                                {"sampler": "dpmpp"},
                                {"sampler": "consistency"}, {"mesh": object()}],
                         ids=["warm_start", "ddim", "dpmpp", "consistency",
                              "mesh"])
def test_ondevice_evaluator_refuses_what_is_not_ported(models, kw):
    """The device mesh is not ported; the planner chain is the DDPM sampler
    and refuses another sampler or warm start, as the JAX evaluator does
    (rollout.py:84-87), where the module path takes them."""
    _, _, diff = models
    if "mesh" in kw:
        with pytest.raises(NotImplementedError, match="mesh"):
            make_ondevice_evaluator(diff, PointMazeJax(), **kw)
        return
    with pytest.raises(ValueError, match="--megakernel"):
        make_ondevice_evaluator(diff, PointMazeJax(), use_megakernel=True,
                                **kw)
    make_ondevice_evaluator(diff, PointMazeJax(), **kw)


# ---------------------------------------------------------------------------
# The checkpoint: EMA weights at load, the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX-written .pt whose EMA weights differ from its model weights."""
    jax_diff, params, _ = _tiny_models(seed=4)
    ema = jax.jit(jax_diff.init_params)(jax.random.PRNGKey(5))
    stats = {"obs_mean": [0.1] * OBS, "obs_std": [2.0] * OBS,
             "action_mean": [0.0] * ACT, "action_std": [0.5] * ACT}
    path = str(tmp_path_factory.mktemp("ckpt") / "model.pt")
    jax_save_pt(path, params, jax_diff.schedule, {
        "horizon": H, "observation_dim": OBS, "action_dim": ACT,
        "n_timesteps": T_STEPS, "beta_schedule": "cosine",
        "dim_mults": (1, 2), "normalizer_stats": stats,
    }, ema_params=ema)
    return path


def test_load_model_use_ema_matches_jax(checkpoint):
    x = np.random.RandomState(0).randn(2, H, D).astype(np.float32)
    t = np.array([1, 4])
    outs = {}
    for use_ema in (False, True):
        jdiff, jparams, _ = jcli.load_model(checkpoint, DATASET,
                                            use_ema=use_ema)
        want = np.asarray(jax.jit(jdiff.apply)(jparams, jnp.asarray(x),
                                               jnp.asarray(t, jnp.int32)))
        diff, _ = cli.load_model(checkpoint, DATASET, device="cpu",
                                 use_ema=use_ema)
        with torch.no_grad():
            got = diff(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)
        outs[use_ema] = got
    assert np.abs(outs[True] - outs[False]).max() > 1e-2


@pytest.mark.parametrize("argv", [
    ["--sampler", "dpmpp"], ["--value-checkpoint", "v"],
    ["--replan-deviation", "0.5"], ["--warm-start-t", "20"],
    ["--warm-start-auto"], ["--policy-type", "guided"],
    ["--render", "video"], ["--mega-group-chains", "8"],
], ids=lambda a: a[0])
def test_eval_parser_refuses_unported_flags(argv, capsys):
    """The flags of what is not ported are refused (``--render video``:
    the port renders nothing); the others are ported and parse as the JAX
    CLI parses them (tests/test_torch_policies.py holds every flag)."""
    base = ["--checkpoint", "x.pt"]
    want = jcli.build_eval_parser().parse_args(base + argv)  # JAX takes it
    if argv[0] != "--render":
        got = cli.build_eval_parser().parse_args(base + argv)
        dest = argv[0][2:].replace("-", "_")
        assert getattr(got, dest) == getattr(want, dest), dest
        return
    with pytest.raises(SystemExit):
        cli.build_eval_parser().parse_args(base + argv)
    assert "error" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--sampler", "ddim"],
                                  ["--warm-start-t", "20"]],
                         ids=lambda a: a[0])
def test_eval_ondevice_parser_refuses_unported_flags(argv):
    """Both flags are ported now, with the JAX script's defaults (ddpm, no
    warm start)."""
    base = ["--checkpoint", "x.pt", "--dataset", DATASET]
    default = eval_ondevice.build_parser().parse_args(base)
    assert (default.sampler, default.warm_start_t) == ("ddpm", None)
    got = eval_ondevice.build_parser().parse_args(base + argv)
    assert (got.sampler, got.warm_start_t) in (("ddim", None), ("ddpm", 20))


# the keys of the JAX eval_ondevice results file (scripts/eval_ondevice.py
# :168-204); the port adds the device, use_ema and the model calls per
# replan
ONDEVICE_KEYS = {
    "policy_type", "environment", "checkpoint", "dataset", "n_episodes",
    "sampling_timesteps", "seed", "timestamp", "metrics", "mode",
    "megakernel", "projection", "wall_aware", "n_candidates", "warm_start_t",
    "batch", "env_steps_per_episode", "success_rate", "mean_reward",
    "mean_final_distance", "wallclock_s", "episodes_per_hour", "compile_s",
    "action_horizon", "n_replans", "sampler", "collision", "wall_slack",
    "per_env_success"}


def test_eval_ondevice_main_on_cpu(checkpoint, tmp_path):
    out = eval_ondevice.main([
        "--checkpoint", checkpoint, "--dataset", DATASET, "--batch", "3",
        "--n-replans", "2", "--action-horizon", "4", "--projection",
        "--n-candidates", "2", "--megakernel", "--wall-aware", "--device",
        "cpu", "--results-dir", str(tmp_path), "--use-ema"])
    with open(out["results_path"]) as f:
        saved = json.load(f)
    assert set(saved) == ONDEVICE_KEYS | {"device", "use_ema",
                                          "model_calls_per_replan"}
    assert saved["model_calls_per_replan"] == [T_STEPS, T_STEPS]
    assert saved["device"] == "cpu" and saved["use_ema"] is True
    assert saved["env_steps_per_episode"] == 8 and saved["batch"] == 3
    assert len(saved["per_env_success"]) == 3
    assert saved["metrics"]["episode_lengths"] == [8, 8, 8]
    assert 0.0 <= out["success_rate"] <= 1.0 and out["episodes_per_hour"] > 0


# ---------------------------------------------------------------------------
# The host evaluators, against the JAX ones on the real PointMaze
# ---------------------------------------------------------------------------

def _draws(k, C, T):
    """Replan k's randomness: numpy seed k for both packages."""
    rs = np.random.RandomState(k)
    return (rs.randn(C, H, D).astype(np.float32),
            rs.randn(T, C, H, D).astype(np.float32))


def _inject_jax(policy, calls):
    """The JAX policy's sampler replaced by the planner chain (interpret
    mode, f32 weights) on replan k's numpy draws: one plan per row of the
    conditions, as the policy's own sampler returns."""
    diff, spec = policy.diffusion, policy._sampler_config["projection"]
    M, b = jpp.build_interleaved_projection(
        policy._P, policy._stats, observation_dim=OBS, action_dim=ACT,
        state_dim=spec.state_dim, horizon=H)
    chains = {}

    def plan(params, key, conditions, P=None, stats=None, **_):
        values = jnp.asarray(conditions.values)
        C = values.shape[0]
        if C not in chains:
            chain = jpp.make_pallas_planner_chain(
                diff.model, diff.schedule, H, C, 1, projection=True,
                sampling_timesteps=policy._sampler_config["sampling_timesteps"],
                weight_dtype=jnp.float32, interpret=True)
            fw, me, sc = jax_prepare(diff.model, diff.schedule, params,
                                     chain.timesteps, weight_dtype=jnp.float32)
            sc = sc.at[:, 5].set(jproj.projection_alpha(
                chain.timesteps, T_STEPS, spec.schedule, spec.strength,
                diff.schedule.betas))
            chains[C] = (jax.jit(chain), fw, me, sc)
        chain, fw, me, sc = chains[C]
        x0, noise = _draws(len(calls), C, sc.shape[0])
        calls.append(C)
        out = chain(fw, jnp.asarray(x0).reshape(C * H, D), me,
                    jnp.asarray(noise).reshape(-1, C * H, D), sc,
                    values.reshape(C * H, D), M, b)
        return out.reshape(C, H, D)

    policy._plan = plan


def _inject_port(policy, calls, path):
    """The port's sampler on replan k's numpy draws: the DDPM sampler (the
    module path) or the planner chain with one candidate per row."""
    sampler = policy._plan
    mega = pl.make_bo_sampler(
        policy.diffusion, projection_spec=policy._sampler_config["projection"],
        P=policy._P, stats=policy._stats, n_candidates=1,
        sampling_timesteps=policy._sampler_config["sampling_timesteps"],
        weight_dtype=torch.float32)
    prepared = mega.prepare()

    def plan(generator, conditions, P=None, stats=None):
        C = np.asarray(conditions.values).shape[0]
        x0, noise = (torch.from_numpy(v) for v in _draws(
            len(calls), C, prepared[2].shape[0]))
        calls.append(C)
        if path == "module":
            return sampler(generator, conditions, P, stats, init_noise=x0,
                           step_noise=noise)
        return mega(None, conditions, prepared, x0=x0.reshape(C * H, D),
                    step_noise=noise.reshape(-1, C * H, D))

    policy._plan = plan


def _recording(policy, actions):
    get_action = policy.get_action

    def wrapped(obs, **kw):
        a = get_action(obs, **kw)
        actions.append(np.asarray(a, np.float64))
        return a

    policy.get_action = wrapped


def _evaluate_both(checkpoint, tmp_path, monkeypatch, batched, path,
                   extra=()):
    """evaluate_main of both packages on the same .pt, seeds and injected
    noise (2 episodes of PointMaze_UMaze-v3, 20 steps, best of 2, argv
    ``extra`` added): (metrics, plan calls, actions, results file) of
    each."""
    runs = {}
    for name, mod, inject in (("jax", jcli, _inject_jax),
                              ("port", cli, None)):
        calls, actions = [], []
        build = mod.build_policy_from_args

        def wrapped(*a, _build=build, _inject=inject, _calls=calls,
                    _actions=actions, **k):
            policy = _build(*a, **k)
            if _inject is None:
                _inject_port(policy, _calls, path)
            else:
                _inject(policy, _calls)
            if not batched:
                _recording(policy, _actions)
            return policy

        monkeypatch.setattr(mod, "build_policy_from_args", wrapped)
        results = tmp_path / name
        argv = ["--checkpoint", checkpoint, "--dataset", DATASET,
                "--env", "PointMaze_UMaze-v3", "--policy-type",
                "dynamics-aware", "--n-candidates", "2", "--action-horizon",
                "4", "--n-episodes", "2", "--max-steps", "20", "--seed", "3",
                "--device", "cpu", "--results-dir", str(results), *extra]
        if batched:
            argv += ["--batched", "--save-episodes", str(tmp_path / name)
                     + ".npz"]
        metrics = mod.evaluate_main(argv)
        (saved,) = [json.load(open(results / f)) for f in os.listdir(results)]
        runs[name] = (metrics, calls, actions, saved)
    return runs["jax"], runs["port"]


@pytest.mark.parametrize("path", ["module", "planner_chain"])
@pytest.mark.parametrize("batched", [False, True], ids=["sequential",
                                                        "batched"])
def test_evaluate_main_matches_jax(checkpoint, tmp_path, monkeypatch, batched,
                                   path):
    """evaluate_main of both packages on the same .pt, seeds and injected
    noise, 2 episodes of PointMaze_UMaze-v3, 20 steps, best of 2: the same
    replans, the same actions to TOL, the same results dicts, and results
    files with the same keys."""
    pytest.importorskip("gymnasium")
    pytest.importorskip("gymnasium_robotics")
    (jm, jcalls, jacts, jsaved), (pm, pcalls, pacts, psaved) = \
        _evaluate_both(checkpoint, tmp_path, monkeypatch, batched, path)
    assert pcalls == jcalls and len(jcalls) == (4 if batched else 8)
    assert set(psaved) == set(jsaved)
    assert set(psaved["metrics"]) == set(jsaved["metrics"])
    assert set(pm) == set(jm)
    for key in ("episode_lengths", "episode_success", "episode_rewards",
                "success_rate", "mean_length"):
        assert pm[key] == jm[key], key
    for key in ("n_candidates", "batched", "action_horizon", "use_ema",
                "sampling_timesteps", "seed", "n_episodes", "policy_type"):
        assert psaved[key] == jsaved[key], key
    if batched:
        from dadiff_tpu.datasets.sources import load_episodes as jload

        from dadiff_tpu_torch.datasets.sources import load_episodes

        port_eps = load_episodes("npz:" + str(tmp_path / "port.npz"))
        jax_eps = jload("npz:" + str(tmp_path / "jax.npz"))
        assert len(port_eps) == len(jax_eps) == 2
        for a, b in zip(port_eps, jax_eps):
            np.testing.assert_allclose(a["actions"], b["actions"], atol=TOL)
            np.testing.assert_allclose(a["observations"], b["observations"],
                                       atol=TOL)
            np.testing.assert_array_equal(a["rewards"], b["rewards"])
    else:
        assert len(pacts) == len(jacts) == 40
        np.testing.assert_allclose(np.stack(pacts), np.stack(jacts), atol=TOL)


def _inverse_dynamics(s, s_next):
    """One inverse model for both packages: physical states in, actions
    out (numpy)."""
    s, s_next = np.atleast_2d(s), np.atleast_2d(s_next)
    return np.clip(5.0 * (s_next[:, 2:4] - s[:, 2:4]) + 0.1 * s[:, 0:2],
                   -1.0, 1.0)


@pytest.mark.parametrize("source", ["inverse-dynamics", "track"])
def test_evaluate_main_action_source_matches_jax(checkpoint, tmp_path,
                                                 monkeypatch, source):
    """``--action-source`` through both CLIs in lockstep (the batched
    branch) with one inverse model for both (each CLI's fit replaced by
    it): the same replans, executed actions and episodes, and the results
    file's ``action_source``."""
    pytest.importorskip("gymnasium")
    pytest.importorskip("gymnasium_robotics")
    from dadiff_tpu.envs import learned_model as jax_learned

    from dadiff_tpu_torch.envs import learned_model as port_learned

    fits = []

    def fit(episodes, **kw):
        fits.append(kw["seed"])
        return _inverse_dynamics, {"r2_mean": 0.5, "r2_min": 0.1}

    for mod in (jax_learned, port_learned):
        monkeypatch.setattr(mod, "train_inverse_dynamics", fit)
    (jm, jcalls, _, jsaved), (pm, pcalls, _, psaved) = _evaluate_both(
        checkpoint, tmp_path, monkeypatch, True, "module",
        ["--action-source", source])
    assert fits == [3, 3] and pcalls == jcalls
    assert psaved["action_source"] == jsaved["action_source"] == source
    for key in ("episode_lengths", "episode_success", "episode_rewards"):
        assert pm[key] == jm[key], key
    from dadiff_tpu.datasets.sources import load_episodes as jload

    from dadiff_tpu_torch.datasets.sources import load_episodes

    for a, b in zip(load_episodes("npz:" + str(tmp_path / "port.npz")),
                    jload("npz:" + str(tmp_path / "jax.npz"))):
        np.testing.assert_allclose(a["actions"], b["actions"], atol=TOL)
        np.testing.assert_allclose(a["observations"], b["observations"],
                                   atol=TOL)


def test_save_results_writes_the_jax_keys(tmp_path):
    from dadiff_tpu.envs.host import save_results as jax_save

    from dadiff_tpu_torch.envs.host import save_results

    metrics = {"mean_reward": 1.0, "std_reward": 0.0, "mean_length": 3.0,
               "std_length": 0.0, "success_rate": 0.5,
               "episode_rewards": [1.0, 1.0], "episode_lengths": [3, 3]}
    kw = dict(policy_type="dynamics-aware", env_name="PointMaze_UMaze-v3",
              checkpoint="c.pt", dataset=DATASET, n_episodes=2, seed=1,
              sampling_timesteps=5, extra={"use_ema": True})
    got = json.load(open(save_results(metrics, results_dir=str(tmp_path / "p"),
                                      **kw)))
    want = json.load(open(jax_save(metrics, results_dir=str(tmp_path / "j"),
                                   **kw)))
    got.pop("timestamp"), want.pop("timestamp")
    assert got == want


def test_save_episodes_npz_round_trip(tmp_path):
    from dadiff_tpu.datasets.sources import load_episodes_npz as jax_load

    from dadiff_tpu_torch.datasets.sources import (
        load_episodes_npz,
        save_episodes_npz,
    )

    rng = np.random.RandomState(0)
    eps = [{"observations": rng.randn(n + 1, OBS).astype(np.float32),
            "actions": rng.randn(n, ACT).astype(np.float32),
            "rewards": rng.rand(n).astype(np.float32)} for n in (3, 0, 5)]
    path = str(tmp_path / "eps.npz")
    save_episodes_npz(path, eps)
    for loaded in (load_episodes_npz(path), jax_load(path)):
        assert len(loaded) == 3
        for a, b in zip(loaded, eps):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# K2 at the evaluator's size: 128 envs x 8 candidates = 1,024 chains
# ---------------------------------------------------------------------------

ROWS_1024 = 1024 * 32


@pytest.fixture(scope="module")
def flagship_step():
    from dadiff_tpu_torch.sweep_kernels import step_launches

    unet = TemporalUnet(transition_dim=D, dim=128, dim_mults=(1, 2, 4))
    calls, _, n_res = step_launches(unet, ROWS_1024, D, 32)
    return calls, n_res


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_k2_tiling_and_group_plan_at_1024_chains(flagship_step, bf16):
    """Every conv of a denoise step at R = 32,768 rows, walked in Python as
    the launchers cut it: a tile the kernels instantiate (with bf16 weights
    the 128-row wgmma tile), whole K splits, grid dimensions within CUDA's
    limits, and for the fused convs group blocks that cover every (chain,
    group) pair once: one tile each on the wgmma tile (one K split), else
    blocks that fit the conv ring's shared memory."""
    calls, n_res = flagship_step
    known = ({(True, *t) for t in ct.MMA_TILES + ct.WG_TILES}
             | {(False, *ct.F32_TILE)})
    assert len(calls) == 35 and n_res == 12
    for kind, rows, ca, cb, cout, mode, k, seg, *_ in calls:
        if kind == "conv":
            t = pl._split_k(rows, ca + cb, cout, mode, k, bf16)
        else:
            t, g = pl._split_k_gn(rows, ca + cb, cout, k, seg, bf16)
            if t.bm == ct.WG_BM:
                assert (g.tiles_m, g.tiles_n, t.splits) == (1, 1, 1)
                assert ct.wg_gn_fits(seg, cout, t.bn)
            else:
                assert g.fits and g.pairs <= ct.MAX_GROUP_PAIRS
                assert g.smem_bytes <= ct.CONV_SMEM_BYTES
            seen = np.zeros((t.M // seg, ct.N_GROUPS), np.int64)
            blocks = list(ct.group_blocks(t.M, cout, seg, t.bm, t.bn))
            assert len(blocks) == g.blocks
            for gb in blocks:
                for _, s, grp in gb.pairs:
                    seen[s, grp] += 1
            assert (seen == 1).all()
        assert (bf16, t.bm, t.bn) in known
        assert (t.bm == ct.WG_BM) == bf16  # every bf16 conv takes the wgmma tile
        k_tiles = -(-t.K // t.bk)
        per_split = -(-k_tiles // t.splits)
        assert (t.splits - 1) * per_split < k_tiles <= t.splits * per_split
        # grid (cout tiles, row tiles, splits x parities): y and z < 65,536
        grid = (-(-cout // t.bn), -(-t.M // t.bm), t.splits * t.parities)
        assert grid[1] < 65536 and grid[2] < 65536
        assert grid[0] * grid[1] * grid[2] < 2 ** 31
        assert t.partial_elems == t.parities * t.splits * t.M * cout


def test_split_k_counters_belong_to_their_owner(monkeypatch):
    """Each (device, stream) has its own split-K counters for the public
    wrapper, and each wave's ops their own: launches on two streams at once
    never share one."""
    from dadiff_tpu_torch.ops import cuda_lib

    monkeypatch.setattr(cuda_lib, "_counters", {})
    a = cuda_lib.counters("cpu", 10, 1)
    b = cuda_lib.counters("cpu", 10, 2)
    assert a.data_ptr() != b.data_ptr()
    assert cuda_lib.counters("cpu", 100, 1).data_ptr() == a.data_ptr()
    assert int(a.abs().sum()) == 0
    big = cuda_lib.counters("cpu", 1 << 15, 1)
    assert big.numel() == 1 << 15 and cuda_lib.counters(
        "cpu", 10, 2).data_ptr() == b.data_ptr()

    launched = []
    monkeypatch.setattr(pl, "launch_rows_conv",
                        lambda *a, **k: launched.append(a[-1]))
    owners = [pl._CudaOps("cpu"), pl._CudaOps("cpu")]
    x = torch.zeros(ROWS_1024 // 32, 128)
    w = torch.zeros(5 * 128, 128, dtype=torch.bfloat16)
    for ops in owners:
        ops.begin("step")
        ops.conv(x, None, w, torch.zeros(1, 128), ct.SAME, 5, 32)
    t = pl._split_k(x.shape[0], 128, 128, ct.SAME, 5, True)
    assert t.splits > 1
    assert launched[0] is owners[0].counters and launched[1] is owners[1].counters
    assert launched[0].data_ptr() != launched[1].data_ptr()
    assert launched[0].numel() >= t.tiles
