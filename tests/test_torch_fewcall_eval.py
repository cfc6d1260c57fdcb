"""The few-call planners through the port's entry points, held against the
JAX package on the CPU: the on-device evaluator with the ddim, dpmpp and
consistency samplers and with warm start (envs/rollout.py); the distill CLI
end to end (a port-distilled ``.pt`` loads in the JAX ``load_model`` and
both plan alike); the eval guards, refusals and defaults (cli.py,
eval_ondevice.py); the policy's adaptive warm depth (guides/policies.py);
and the server's warm state (serve.py).

Tiny model: dim 8, mults (1, 2), horizon 8, T = 20. Tolerances: executed
actions and final positions 1e-4 (plans of up to 20 U-Net evaluations each,
the f32 rounding of XLA and PyTorch apart, carried through the env's
steps); success flags and rewards exactly.
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
from dadiff_tpu.guides import policies as jpol
from dadiff_tpu.guides.sampling import ProjectionSpec as JaxSpec
from dadiff_tpu.guides.sampling import conditions_for_initial_obs as jax_cond
from dadiff_tpu.io.torch_compat import save_pt_checkpoint as jax_save_pt
from dadiff_tpu.models.consistency import make_consistency_sampler
from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.ops import projection as jproj

from dadiff_tpu_torch import cli, eval_ondevice
from dadiff_tpu_torch.envs.pointmaze_jax import PointMazeJax
from dadiff_tpu_torch.envs.rollout import make_ondevice_evaluator
from dadiff_tpu_torch.guides import policies as pol
from dadiff_tpu_torch.guides.sampling import (
    ProjectionSpec,
    conditions_for_initial_obs,
    make_sampler,
)
from dadiff_tpu_torch.io.torch_compat import params_from_jax
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops.projection import NormStats
from dadiff_tpu_torch.serve import build_server_parser, make_handler

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

H, OBS, ACT, T_STEPS = 8, 6, 2, 20
D = OBS + ACT
TOL = 1e-4
DATASET = "synthetic:pointmaze:n=6,T=40"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    jax_diff = JaxDiffusion(model=JaxUnet(transition_dim=D, dim=8,
                                          dim_mults=(1, 2)),
                            horizon=H, observation_dim=OBS, action_dim=ACT,
                            n_timesteps=T_STEPS)
    params = jax.jit(jax_diff.init_params)(jax.random.PRNGKey(0))
    unet = TemporalUnet(transition_dim=D, dim=8, dim_mults=(1, 2))
    unet.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    diff = GaussianDiffusion(unet, horizon=H, observation_dim=OBS,
                             action_dim=ACT, n_timesteps=T_STEPS).eval()
    return jax_diff, params, diff


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
# The on-device loop with each sampler and with warm start
# ---------------------------------------------------------------------------

def _recording_env(env_cls, record, jax_side):
    """``env_cls`` whose step also appends the (B, 2) action it takes to
    ``record``: on the JAX side through an ordered host callback, since its
    step runs inside the evaluator's scans."""

    class Recording(env_cls):
        def step(self, state, a):
            if jax_side:
                jax.debug.callback(lambda v: record.append(np.array(v)), a,
                                   ordered=True)
            else:
                record.append(a.numpy().copy())
            return super().step(state, a)

    return Recording()


def _replan_draws(key, sampler, n_steps, shape):
    """What replan ``key`` of the JAX evaluator's module path draws
    (sampling.py:248-269; consistency.py:260-268), flattened to (C*H, D)
    rows as the port's ``noise`` hook takes them."""
    rows = lambda a: _t(a).reshape(*a.shape[:-3], -1, D)
    if sampler == "consistency":
        keys = jax.random.split(key, n_steps)
        draws = [jax.random.normal(k, shape) for k in keys]
        return rows(draws[0]), (rows(jnp.stack(draws[1:]))
                                if n_steps > 1 else None)
    _, init_key, noise_key = jax.random.split(key, 3)
    step = (rows(jax.random.normal(noise_key, (n_steps,) + shape))
            if sampler == "ddpm" else None)
    return rows(jax.random.normal(init_key, shape)), step


EVAL_CASES = {
    # name: (sampler, sampling_timesteps, warm_start_t, projection)
    "ddim": ("ddim", 5, None, True),
    "dpmpp": ("dpmpp", 5, None, False),
    "consistency": ("consistency", 2, None, True),
    "ddpm_warm8": ("ddpm", None, 8, True),
    "ddim_warm8": ("ddim", 10, 8, False),
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_ondevice_evaluator_matches_jax(models, dynamics, case):
    """2 envs x best of 2 x 3 replans x 4 actions on the module path: the
    JAX reset state and the draws of the JAX plans' keys go into the port;
    the port executes the JAX evaluator's actions at every step of every
    replan (a warm replan re-noises the previous selected plan), and the
    episodes end alike."""
    jax_diff, params, diff = models
    P, jstats, pstats = dynamics
    sampler, steps, warm, projection = EVAL_CASES[case]
    B, N, R, A = 2, 2, 3, 4
    want_acts = []
    jeval = jax_evaluator(
        jax_diff, _recording_env(JaxEnv, want_acts, jax_side=True),
        action_horizon=A, n_replans=R, n_candidates=N,
        sampling_timesteps=steps, sampler=sampler, warm_start_t=warm,
        projection=JaxSpec(state_dim=4) if projection else None)
    key = jax.random.PRNGKey(3)
    want, want_state = jeval(params, key, jstats, B, jnp.asarray(P))
    jax.effects_barrier()
    assert len(want_acts) == R * A

    got_acts = []
    evaluate = make_ondevice_evaluator(
        diff, _recording_env(PointMazeJax, got_acts, jax_side=False),
        action_horizon=A, n_replans=R, n_candidates=N,
        sampling_timesteps=steps, sampler=sampler, warm_start_t=warm,
        projection=ProjectionSpec(state_dim=4) if projection else None)
    first, later = evaluate.model_calls
    rng, reset_key = jax.random.split(key)
    state0, _ = JaxEnv().reset(reset_key, B)
    # a consistency plan splits its rng into the call budget's keys
    noise = [_replan_draws(k, sampler, steps if sampler == "consistency"
                           else first if i == 0 else later, (B * N, H, D))
             for i, k in enumerate(jax.random.split(rng, R))]
    state, _ = PointMazeJax().reset(None, pos=_t(state0.pos),
                                    goal=_t(state0.goal))
    got, got_state = evaluate(None, pstats, B, torch.from_numpy(P),
                              state=state, noise=noise)
    np.testing.assert_allclose(np.stack(got_acts), np.stack(want_acts),
                               atol=TOL)
    np.testing.assert_allclose(got_state.pos.numpy(),
                               np.asarray(want_state.pos), atol=TOL)
    np.testing.assert_array_equal(got.per_env_success.numpy(),
                                  np.asarray(want.per_env_success))
    np.testing.assert_array_equal(got.per_env_reward.numpy(),
                                  np.asarray(want.per_env_reward))
    calls = {"ddim": (5, 5), "dpmpp": (4, 4), "consistency": (2, 2),
             "ddpm_warm8": (20, 8), "ddim_warm8": (10, 4)}[case]
    assert (first, later) == calls


# ---------------------------------------------------------------------------
# The distill CLI, the student's checkpoint and the eval guards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def teacher(tmp_path_factory, models):
    """A JAX-written teacher .pt with stored normalizer stats."""
    jax_diff, params, _ = models
    stats = {"obs_mean": [0.1] * OBS, "obs_std": [2.0] * OBS,
             "action_mean": [0.0] * ACT, "action_std": [0.5] * ACT}
    path = str(tmp_path_factory.mktemp("teacher") / "teacher.pt")
    jax_save_pt(path, params, jax_diff.schedule, {
        "horizon": H, "observation_dim": OBS, "action_dim": ACT,
        "n_timesteps": T_STEPS, "beta_schedule": "cosine",
        "dim_mults": (1, 2), "normalizer_stats": stats,
    })
    return path


@pytest.fixture(scope="module")
def student(tmp_path_factory, teacher):
    """The port's distill entry point: 4 steps of batch 8 on the CPU."""
    log_dir = cli.distill_main([
        "--checkpoint", teacher, "--dataset", DATASET, "--n-epochs", "1",
        "--max-steps", "4", "--batch-size", "8", "--warmup-steps", "0",
        "--lr", "1e-3", "--log-freq", "1", "--save-freq", "0", "--device",
        "cpu", "--log-dir", str(tmp_path_factory.mktemp("distill"))])
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        record = json.loads(f.read().splitlines()[-1])
    return os.path.join(log_dir, "checkpoint_step_4.pt"), record


def test_distilled_student_loads_in_jax_and_plans_alike(student, teacher):
    path, record = student
    assert record["step"] == 4 and len(record["total_series"]) == 4
    assert all(np.isfinite(record["total_series"]))
    diff, dataset = cli.load_model(path, DATASET, device="cpu")
    jdiff, jparams, jdataset = jcli.load_model(path, DATASET)
    for cfg in (dataset.checkpoint_config, jdataset.checkpoint_config):
        assert cfg["consistency"] is True and cfg["sigma_data"] == 0.5
        assert cfg["teacher_checkpoint"] == teacher
    tdiff, _ = cli.load_model(teacher, DATASET, device="cpu")
    moved = max((a - b).abs().max().item() for a, b in zip(
        diff.model.parameters(), tdiff.model.parameters()))
    assert moved > 1e-4  # 4 Adam steps of lr 1e-3 moved the student
    obs = np.random.RandomState(0).randn(3, OBS).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = make_consistency_sampler(jdiff, n_steps=2, jit=False)(
        jparams, key, jax_cond(jnp.asarray(obs), OBS, H, D))
    draws = [_t(jax.random.normal(k, (3, H, D)))
             for k in jax.random.split(key, 2)]
    got = make_sampler(diff, sampler="consistency", sampling_timesteps=2)(
        None, conditions_for_initial_obs(torch.from_numpy(obs), OBS, H, D),
        init_noise=draws[0], step_noise=draws[1][None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_distill_refuses_a_student_and_progressive(student, teacher, tmp_path):
    base = ["--dataset", DATASET, "--device", "cpu", "--max-steps", "1",
            "--log-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="already a consistency"):
        cli.distill_main(["--checkpoint", student[0], *base])
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        cli.distill_main(["--checkpoint", teacher, "--method", "progressive",
                          *base])


def test_student_needs_the_consistency_sampler(student, tmp_path, capsys):
    path = student[0]
    with pytest.raises(SystemExit, match="--sampler consistency"):
        cli.evaluate_main(["--checkpoint", path, "--dataset", DATASET,
                           "--device", "cpu"])
    with pytest.raises(SystemExit, match="--sampler consistency"):
        eval_ondevice.main(["--checkpoint", path, "--dataset", DATASET,
                            "--device", "cpu", "--results-dir", ""])
    with pytest.raises(SystemExit, match="model-call budget"):
        cli.evaluate_main(["--checkpoint", path, "--dataset", DATASET,
                           "--device", "cpu", "--sampler", "consistency",
                           "--sampling-timesteps", "17"])
    out = eval_ondevice.main([
        "--checkpoint", path, "--dataset", DATASET, "--batch", "2",
        "--n-replans", "2", "--action-horizon", "4", "--projection",
        "--n-candidates", "2", "--sampler", "consistency",
        "--sampling-timesteps", "2", "--device", "cpu", "--results-dir",
        str(tmp_path)])
    with open(out["results_path"]) as f:
        saved = json.load(f)
    assert saved["sampler"] == "consistency"
    assert saved["model_calls_per_replan"] == [2, 2]
    assert saved["warm_start_t"] is None and len(saved["per_env_success"]) == 2


def test_eval_defaults_and_warm_start_record(teacher, student, tmp_path,
                                             capsys):
    """The step budget's defaults (4 calls for a student, 200 clamped to
    the chain otherwise) and the reverse guard's warning; eval_ondevice
    records K and the calls of a warm replan."""
    diff, dataset = cli.load_model(teacher, DATASET, device="cpu")
    sdiff, sdataset = cli.load_model(student[0], DATASET, device="cpu")
    parse = lambda *a: cli.build_eval_parser().parse_args(
        ["--checkpoint", "x.pt", *a])
    assert cli.planning_timesteps(parse(), diff, dataset) == T_STEPS
    assert cli.planning_timesteps(parse("--sampler", "consistency"), sdiff,
                                  sdataset) == 4
    assert cli.planning_timesteps(parse("--sampler", "consistency"), diff,
                                  dataset) == 4
    assert "WARNING" in capsys.readouterr().out
    out = eval_ondevice.main([
        "--checkpoint", teacher, "--dataset", DATASET, "--batch", "2",
        "--n-replans", "2", "--action-horizon", "4", "--warm-start-t", "8",
        "--device", "cpu", "--results-dir", str(tmp_path)])
    assert out["warm_start_t"] == 8 and out["sampler"] == "ddpm"
    assert out["model_calls_per_replan"] == [T_STEPS, 8]


@pytest.mark.parametrize("argv", [["--sampler", "ddim"], ["--sampler", "dpmpp"],
                                  ["--sampler", "consistency"],
                                  ["--warm-start-t", "8"],
                                  ["--warm-start-auto"]],
                         ids=lambda a: "_".join(a).strip("-"))
def test_megakernel_refuses_other_samplers_and_warm_start(teacher, argv):
    """--megakernel is the DDPM chain: it raises, never routes the plan
    quietly to the module path (pallas_planner.py:465-470)."""
    args = build_server_parser().parse_args(
        ["--checkpoint", teacher, "--dataset", DATASET, "--device", "cpu",
         "--n-candidates", "2", "--megakernel", *argv])
    diff, dataset = cli.load_model(teacher, DATASET, device="cpu")
    with pytest.raises(ValueError, match="--megakernel"):
        cli.build_policy_from_args(args, diff, dataset, DATASET, T_STEPS)
    if argv[0] != "--warm-start-auto":  # eval_ondevice has no such flag
        with pytest.raises(ValueError, match="--megakernel"):
            eval_ondevice.main(["--checkpoint", teacher, "--dataset",
                                DATASET, "--device", "cpu", "--megakernel",
                                "--results-dir", "", *argv])


def test_entry_points_need_a_card_by_default(teacher, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (cli.evaluate_main, cli.distill_main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["--checkpoint", teacher, "--dataset", DATASET])


# ---------------------------------------------------------------------------
# The policy's adaptive warm depth and the server's warm state
# ---------------------------------------------------------------------------

class _Normalizer:
    """The few fields a policy reads, numpy, the same for both packages."""

    obs_mean = np.zeros(OBS, np.float32)
    obs_std = np.full(OBS, 2.0, np.float32)
    action_mean = np.zeros(ACT, np.float32)
    action_std = np.ones(ACT, np.float32)

    def normalize_observations(self, x):
        return ((x - self.obs_mean) / self.obs_std).astype(np.float32)

    def unnormalize_actions(self, a):
        return a * self.action_std + self.action_mean


def _scripted_plans(policy, calls, to_array):
    """Replace the policy's samplers by one that returns, for every row of
    the conditions, the conditioned row followed by rows drifting from it
    by 0.1 per step: the same plans on both sides, so that only the
    policies' own logic picks the warm depth. Records (K, x_init)."""

    def fake(k):
        def plan(*args, x_init=None, **kw):
            values = np.asarray(next(a for a in args
                                     if hasattr(a, "mask")).values)
            steps = 0.1 * np.arange(H, dtype=np.float32)[None, :, None]
            calls.append((k, None if x_init is None else np.asarray(x_init)))
            return to_array(values[:, :1] + steps)
        return plan

    policy._plan = fake(None)
    policy._plan_warm = fake("fixed")
    policy._auto_warm_sampler = fake


def test_warm_auto_depth_matches_jax():
    """Over one observation sequence, whose drift from the plan grows from
    almost nothing to more than the whole chain can cover, the port's
    policy picks the JAX policy's warm depth at every replan (and the full
    chain where the JAX one does), with the same shifted plans. T = 100, so
    that the grid of depths (10, 20, ..., 90) has room; the plans are
    scripted, so the weights never run."""
    kw = dict(horizon=H, observation_dim=OBS, action_dim=ACT,
              n_timesteps=100)
    jpolicy = jpol.GuidedPolicy(
        JaxDiffusion(model=JaxUnet(transition_dim=D, dim=8, dim_mults=(1, 2)),
                     **kw), _Normalizer(), action_horizon=3, n_candidates=2,
        warm_start_auto=True)
    policy = pol.GuidedPolicy(
        GaussianDiffusion(TemporalUnet(transition_dim=D, dim=8,
                                       dim_mults=(1, 2)), **kw),
        _Normalizer(), action_horizon=3, n_candidates=2, warm_start_auto=True)
    jcalls, calls = [], []
    _scripted_plans(jpolicy, jcalls, jnp.asarray)
    _scripted_plans(policy, calls, torch.from_numpy)
    # a replan every 4 actions, 4 actions after the last: the plan's row 4
    # is the last conditioned row + 0.4 per dim; the observation at replan
    # r is off it by 0.02 r^2 per dim
    rng = np.random.RandomState(5)
    ks, jks, normed = [], [], 0.0
    for i in range(28):
        if i % 4 == 0:
            r = i // 4
            normed += (0.4 + 0.02 * r * r) if r else 0.0
            obs = (2 * normed + 1e-3 * rng.randn(OBS)).astype(np.float32)
        a, ja = policy.get_action(obs), jpolicy.get_action(obs)
        np.testing.assert_allclose(a, np.asarray(ja), atol=1e-6)
        ks.append(policy.last_warm_k)
        jks.append(jpolicy.last_warm_k)
    assert ks == jks
    picked = ks[::4]
    assert picked[0] is None and None in picked[3:]
    assert len({k for k in picked if k is not None}) >= 3, picked
    assert [c[0] for c in calls] == [c[0] for c in jcalls]
    for (_, x), (_, jx) in zip(calls, jcalls):
        if jx is None:
            assert x is None
        else:
            np.testing.assert_allclose(x, jx, atol=1e-6)
    policy.reset()
    assert policy._last_plan is None and policy._warm_init() is None


def test_server_keeps_warm_state_until_reset(teacher):
    """The server's policy with --warm-start-t: an episode's first plan is
    the full chain, the next re-noises it shifted by the executed actions;
    {"reset": true} starts a new episode (scripts/serve.py:21). A plan
    request refills the buffer from the returned plan."""
    args = build_server_parser().parse_args(
        ["--checkpoint", teacher, "--dataset", DATASET, "--device", "cpu",
         "--n-candidates", "2", "--action-horizon", "2", "--warm-start-t",
         "8", "--sampler", "ddim", "--sampling-timesteps", "10"])
    diff, dataset = cli.load_model(teacher, DATASET, device="cpu")
    policy = cli.build_policy_from_args(
        args, diff, dataset, DATASET, cli.planning_timesteps(args, diff,
                                                             dataset))
    assert policy._plan_warm.timesteps.tolist() == [6, 4, 2, 0]
    seen = []
    warm = policy._plan_warm

    def recording(*a, x_init=None, **kw):
        seen.append(np.asarray(x_init))
        return warm(*a, x_init=x_init, **kw)

    policy._plan_warm = recording
    handle = make_handler(policy)
    obs = {"obs": [0.1] * OBS}
    first = handle({**obs, "plan": True})
    assert policy.last_warm_k is None and len(first["plan"]) == H
    for _ in range(2):  # the rest of the buffer: action_horizon + 1 rows
        handle(obs)
    handle(obs)  # the buffer is empty: a warm replan, 3 actions later
    assert policy.last_warm_k == 8 and len(seen) == 1
    prev = np.asarray(first["plan"], np.float32)
    np.testing.assert_allclose(
        seen[0][0], np.concatenate([prev[3:], np.repeat(prev[-1:], 3, 0)]),
        atol=1e-6)
    assert handle({"reset": True}) == {"ok": True}
    assert policy.action_buffer == [] and policy._last_plan is None
    handle(obs)
    assert policy.last_warm_k is None and len(seen) == 1
