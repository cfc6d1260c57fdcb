"""The port's locomotion path held against the JAX package on the CPU: the
batched envs' steps (obs, reward, done) for HalfCheetah, Hopper and
Walker2d, the resets against gymnasium's, the on-device evaluator with the
JAX draws injected, the chunk-bound guard and the CLI's results, and the
trainer's normalizer and first losses on the Hopper data.

Tolerances: env steps 1e-9 in float64 (the JAX side under the x64 fixture)
and 1e-5 in float32 (the forward reward divides an x delta by dt = 8-50 ms,
so it is held relative too); resets exactly; the evaluator's returns and
lengths 1e-4 relative (tiny U-Net, float32 physics on both sides).
"""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

mujoco = pytest.importorskip("mujoco")
gym = pytest.importorskip("gymnasium")

from dadiff_tpu.datasets.sequence import SequenceDataset as JaxDataset  # noqa: E402,E501
from dadiff_tpu.envs import locomotion_jax as jl  # noqa: E402
from dadiff_tpu.io.torch_compat import save_pt_checkpoint as jax_save_pt  # noqa: E402,E501
from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion  # noqa: E402,E501
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet  # noqa: E402,E501
from dadiff_tpu.ops.projection import NormStats as JaxNormStats  # noqa: E402

from dadiff_tpu_torch import eval_ondevice_locomotion as evl  # noqa: E402
from dadiff_tpu_torch.datasets.sequence import SequenceDataset  # noqa: E402
from dadiff_tpu_torch.envs import locomotion_jax as tl  # noqa: E402
from dadiff_tpu_torch.io.torch_compat import params_from_jax  # noqa: E402
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion  # noqa: E402
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet  # noqa: E402
from dadiff_tpu_torch.ops.projection import NormStats  # noqa: E402
from tests import torch_jax_physics as tj  # noqa: E402

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
ENVS = {"HalfCheetah-v5": tl.HalfCheetahJax, "Hopper-v5": tl.HopperJax,
        "Walker2d-v5": tl.Walker2dJax}
HOPPER_DATA = "npz:data/hopper_mppi.npz+npz:data/hopper_engine_r5.npz"
ITERS = tj.ITERS


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_registry_and_obs_state_round_trip():
    assert isinstance(tl.physics_env_for("HalfCheetah-v5"), tl.HalfCheetahJax)
    assert isinstance(tl.physics_env_for("Hopper-v5"), tl.HopperJax)
    assert isinstance(tl.physics_env_for("Walker2d-v5"), tl.Walker2dJax)
    with pytest.raises(ValueError):
        tl.physics_env_for("PointMaze_UMaze-v3")
    env = tl.HalfCheetahJax(solver_iters=5)
    obs = torch.from_numpy(np.random.RandomState(0).randn(4, 17))
    qpos, qvel = env.obs_to_state(obs)
    assert qpos.shape == (4, 9) and qvel.shape == (4, 9)
    assert (qpos[:, 0] == 0).all()
    assert torch.equal(env.state_to_obs(qpos, qvel), obs)
    search = tl.HalfCheetahJax(solver_iters=5, search_model=True)
    assert len(search.model.con_body) < len(env.model.con_body)
    assert search.phys.pyramid_edges == 2 and env.phys.pyramid_edges == 4


def _start_states(env, n=6):
    """(qpos, qvel) float64: gymnasium resets at seeds 0.. and, in the last
    row, a Hopper/Walker2d pitched past its healthy angle."""
    rows = [env.reset_state(s) for s in range(n)]
    qpos = np.stack([r[0] for r in rows])
    qvel = np.stack([r[1] for r in rows])
    qvel[:, 2] += np.linspace(-2.0, 2.0, n)   # some pitch to integrate
    if env.ENV_NAME != "HalfCheetah-v5":
        qpos[-1, 2] = 1.2
    return qpos, qvel


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("env_name", list(ENVS))
def test_env_steps_match_jax(env_name, dtype, x64):
    """Three teacher-forced env steps of 6 envs from resets with random
    actions: the port's qpos, qvel, obs, reward and done against the JAX
    env's, both from the JAX state of each step. In float64 these are the
    env's integrator steps (Euler for HalfCheetah, RK4 for the others) to
    1e-9."""
    jenv, tenv = tj.env(env_name), ENVS[env_name](solver_iters=ITERS)
    np_dtype = np.dtype(dtype)
    qpos, qvel = (a.astype(np_dtype) for a in _start_states(tenv))
    rng = np.random.RandomState(3)
    tol = 1e-9 if dtype == "float64" else 1e-5
    done_seen = False
    for _ in range(3):
        act = np.clip(rng.randn(qpos.shape[0], tenv.act_dim) * 0.6, -1, 1
                      ).astype(np_dtype)
        want = tj.rows(jenv.step_jit, qpos, qvel, act)
        got = [v.numpy() for v in tenv.step_batch(
            *(torch.from_numpy(a) for a in (qpos, qvel, act)))]
        for name, g, w in zip(("qpos", "qvel", "obs", "reward"), got, want):
            assert g.dtype == np_dtype, name
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
        np.testing.assert_array_equal(got[4], want[4])
        done_seen |= bool(want[4].any())
        qpos, qvel = want[0], want[1]
    assert done_seen == (env_name != "HalfCheetah-v5")


def test_single_env_step_matches_jax(x64):
    """``PlanarGymEnv.step`` on one env, without a batch axis
    (locomotion_jax.py:89-101): a Hopper from a reset and one pitched past
    its healthy angle, against the JAX env's single-env step, float64 to
    1e-9."""
    jenv, tenv = tj.env("Hopper-v5"), tl.HopperJax(solver_iters=ITERS)
    qpos, qvel = _start_states(tenv, 2)
    act = np.clip(np.random.RandomState(4).randn(2, tenv.act_dim) * 0.6,
                  -1, 1)
    for i in range(2):
        want = jenv.step_jit(qpos[i], qvel[i], act[i])
        got = tenv.step(*(torch.from_numpy(a[i]) for a in (qpos, qvel, act)))
        for g, w in zip(got, want):
            assert g.shape == np.shape(w)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-9)
    assert bool(got[4]) and bool(want[4])  # the pitched one is done


def test_rollout_and_step_fn_shapes():
    env = tl.HopperJax(solver_iters=5, solver="jacobi", search_model=True)
    qpos, qvel = (torch.from_numpy(a) for a in _start_states(env, 3))
    acts = torch.from_numpy(np.random.RandomState(2).randn(3, 4, 3) * 0.5)
    obs, rew = env.rollout(qpos, qvel, acts)
    assert obs.shape == (3, 4, 11) and rew.shape == (3, 4)
    fn = tl.make_physics_step_fn(env)
    nobs = fn(env.state_to_obs(qpos, qvel)[:, None].expand(3, 5, 11),
              acts[:, :1].expand(3, 5, 3))
    assert nobs.shape == (3, 5, 11) and torch.isfinite(nobs).all()


@pytest.mark.parametrize("env_name", list(ENVS))
def test_resets_equal_gymnasium(env_name):
    """Eight seeds: the port's reset observation equals gymnasium's, bit for
    bit, from the committed constants alone."""
    host = gym.make(env_name)
    env = tl.physics_env_for(env_name)
    seeds = list(range(40, 48))
    want = np.stack([host.reset(seed=s)[0] for s in seeds])
    host.close()
    got = env.reset_obs(seeds)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The evaluator
# ---------------------------------------------------------------------------

H, OBS, ACT, T_STEPS, B, R, AH = 8, 11, 3, 5, 4, 3, 2
D = OBS + ACT


@pytest.fixture(scope="module")
def tiny():
    jdiff = JaxDiffusion(model=JaxUnet(transition_dim=D, dim=8,
                                       dim_mults=(1, 2)),
                         horizon=H, observation_dim=OBS, action_dim=ACT,
                         n_timesteps=T_STEPS)
    params = jax.jit(jdiff.init_params)(jax.random.PRNGKey(0))
    unet = TemporalUnet(transition_dim=D, dim=8, dim_mults=(1, 2))
    unet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                params)),
                         strict=True)
    diff = GaussianDiffusion(unet, horizon=H, observation_dim=OBS,
                             action_dim=ACT, n_timesteps=T_STEPS).eval()
    rng = np.random.RandomState(7)
    stats = [rng.randn(OBS) * 0.1, 0.5 + rng.rand(OBS),
             rng.randn(ACT) * 0.1, 0.3 + 0.2 * rng.rand(ACT)]
    return jdiff, params, diff, [np.asarray(s, np.float32) for s in stats]


def _jax_draws(key):
    """The draws of the JAX evaluator's replans: one key per replan
    (locomotion_jax.py:285), split by make_sampler into init and noise keys
    (guides/sampling.py:248-269)."""
    out = []
    for k in jax.random.split(key, R):
        _, init_key, noise_key = jax.random.split(k, 3)
        out.append(tuple(torch.from_numpy(np.array(v)) for v in (
            jax.random.normal(init_key, (B, H, D)),
            jax.random.normal(noise_key, (T_STEPS, B, H, D)))))
    return out


@pytest.mark.parametrize("skip", [False, True], ids=["row0", "skip"])
def test_evaluator_matches_jax(tiny, skip):
    """4 Hopper envs x 3 replans x 2 actions on the JAX draws; env 3 starts
    pitched and falls in its first step, so its reward and length are
    masked from then on and its state held. With skip, a second call of the
    same evaluator returns the same."""
    jdiff, params, diff, stats = tiny
    jenv = tj.env("Hopper-v5", "jacobi")
    tenv = tl.HopperJax(solver_iters=ITERS, solver="jacobi")
    init_obs = tenv.reset_obs(range(B)).astype(np.float32)
    init_obs[3, 1], init_obs[3, OBS // 2 + 2] = 0.19, 4.0
    key = jax.random.PRNGKey(11)
    evaluate = jl.make_physics_locomotion_evaluator(
        jdiff, jenv, action_horizon=AH, n_replans=R,
        skip_conditioned_action=skip, jit=False)
    want = evaluate(params, key, JaxNormStats(*map(jnp.asarray, stats)),
                    jnp.asarray(init_obs))
    ev = tl.make_physics_locomotion_evaluator(
        diff, tenv, action_horizon=AH, n_replans=R,
        skip_conditioned_action=skip)
    tstats = NormStats(*map(torch.from_numpy, stats))
    got = ev(None, tstats, torch.from_numpy(init_obs), noise=_jax_draws(key))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    if skip:
        # a second call reuses the first one's buffers from a fresh reset
        again = ev(None, tstats, torch.from_numpy(init_obs),
                   noise=_jax_draws(key))
        for a, g in zip(again, got):
            assert torch.equal(a, g)
    returns = got[2].numpy()
    assert len(ev.timing) == R and not ev.graph
    # env 3 fell at its first step: one step counted, the others all
    np.testing.assert_allclose(float(got[1]), (3 * R * AH + 1) / B)
    assert np.all(np.isfinite(returns))
    with pytest.raises(ValueError, match="fit in the planning horizon"):
        tl.make_physics_locomotion_evaluator(diff, tenv, action_horizon=H,
                                             skip_conditioned_action=True)
    with pytest.raises(ValueError, match="CUDA graphs"):
        tl.make_physics_locomotion_evaluator(diff, tenv, graph=True)


# ---------------------------------------------------------------------------
# The CLI: chunk bound, flags, results
# ---------------------------------------------------------------------------

class _Args:
    def __init__(self, env, ah, allow=False):
        self.env, self.action_horizon, self.allow_unquotable = env, ah, allow


def _k_star(env):
    rows = json.loads(pathlib.Path(evl.chunk_bound_path(env)).read_text())[
        "distributions"]["heldout"]["rows"]
    k = 0
    for r in sorted(rows, key=lambda r: r["K"]):
        if not r["quotable"]:
            break
        k = r["K"]
    return k


@pytest.mark.parametrize("env", list(ENVS))
def test_chunk_bound_guard(env, capsys):
    """K* is the contiguous quotable prefix (Walker2d: 8); above it the run
    is refused unless --allow-unquotable; without a bound file it warns."""
    k = _k_star(env)
    assert k >= 1 and (env != "Walker2d-v5" or k == 8)
    evl._check_chunk_bound(_Args(env, k))
    assert "chunk bound OK" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="exceeds the measured K"):
        evl._check_chunk_bound(_Args(env, k + 1))
    evl._check_chunk_bound(_Args(env, k + 1, allow=True))
    assert "--allow-unquotable" in capsys.readouterr().out
    evl._check_chunk_bound(_Args("NoSuchEnv-v0", 1))
    assert "no measured chunk bound" in capsys.readouterr().out


def test_cli_flags_against_the_jax_script(capsys):
    """The port's flags are the JAX script's, with its default backend
    (learned) and both backends' choices; ``--device`` takes cuda or cpu
    where the JAX script names the TPU."""
    src = (REPO / "scripts" / "eval_ondevice_locomotion.py").read_text()
    jax_flags = set(re.findall(r'add_argument\("(--[a-z-]+)"', src))
    port = {a.option_strings[0] for a in evl.build_parser()._actions
            if a.option_strings and a.option_strings[0] != "-h"}
    assert port == jax_flags
    base = ["--checkpoint", "c", "--dataset", "d"]
    for extra in (["--backend", "mjx"], ["--device", "tpu"]):
        with pytest.raises(SystemExit):
            evl.build_parser().parse_args(base + extra)
    args = evl.build_parser().parse_args(base)
    assert (args.backend, args.device, args.solver, args.solver_iters,
            args.batch, args.n_replans, args.action_horizon,
            args.model_steps, args.sim_ensemble) == (
        "learned", "cuda", "pgs", 100, 128, 25, 8, 3000, 4)
    backend = next(a for a in evl.build_parser()._actions
                   if a.dest == "backend")
    assert backend.choices == ["learned", "physics"]


# the keys of the JAX script's printed result (physics backend) and of its
# results file (eval_ondevice_locomotion.py:215-268, envs/host.py)
RESULT_KEYS = {"env", "backend", "sampler", "batch", "env_steps_per_episode",
               "mean_return", "return_std", "return_se", "mean_alive_length",
               "wall_clock_s", "episodes_per_hour_per_chip",
               "simulator_r2_mean", "note"}
FILE_KEYS = ({"policy_type", "environment", "checkpoint", "dataset",
              "n_episodes", "sampling_timesteps", "seed", "timestamp",
              "metrics"} | RESULT_KEYS - {"env"}
             | {"action_horizon", "n_replans", "solver", "solver_iters",
                "skip_conditioned_action"})


# the learned backend's: model-based returns (eval_ondevice_locomotion.py:
# 221-222)
LEARNED_KEYS = RESULT_KEYS - {"mean_return", "return_std"} | {
    "model_based_mean_return", "model_based_return_std"}


def _tiny_checkpoint(tiny, tmp_path) -> str:
    jdiff, params, _, stats = tiny
    path = str(tmp_path / "model.pt")
    names = ("obs_mean", "obs_std", "action_mean", "action_std")
    jax_save_pt(path, params, jdiff.schedule, {
        "horizon": H, "observation_dim": OBS, "action_dim": ACT,
        "n_timesteps": T_STEPS, "beta_schedule": "cosine",
        "dim_mults": (1, 2),
        "normalizer_stats": {k: v.tolist() for k, v in zip(names, stats)}})
    return path


def test_cli_runs_and_writes_the_jax_keys(tiny, tmp_path, capsys):
    path = _tiny_checkpoint(tiny, tmp_path)
    out = evl.main([
        "--checkpoint", path, "--dataset", "npz:data/hopper_mppi.npz",
        "--env", "Hopper-v5", "--backend", "physics", "--solver", "jacobi",
        "--solver-iters", "5",
        "--batch", "3", "--n-replans", "2", "--action-horizon", "1",
        "--skip-conditioned-action", "--device", "cpu", "--results-dir",
        str(tmp_path / "results")])
    printed = capsys.readouterr().out
    assert "chunk bound OK" in printed and "ms per env step" in printed
    line = next(ln for ln in printed.splitlines() if ln.startswith('{"env"'))
    assert set(json.loads(line)) == RESULT_KEYS
    saved = json.loads(pathlib.Path(out["results_path"]).read_text())
    assert FILE_KEYS <= set(saved)
    assert saved["policy_type"] == "ondevice-physics"
    assert saved["environment"] == "Hopper-v5"
    assert len(saved["metrics"]["episode_rewards"]) == 3
    assert out["timing"]["clock"].startswith("host clock")
    assert np.isfinite(out["mean_return"])


def test_cli_learned_backend_writes_the_jax_learned_keys(tiny, tmp_path,
                                                         capsys):
    """No ``--backend``: the learned simulator (an ensemble of 2 fitted for
    5 steps) steps the loop; the printed result and the results file carry
    the JAX script's learned keys, policy type ``ondevice-learned`` and no
    solver; no chunk-bound guard runs. An env without a reward model is
    refused."""
    path = _tiny_checkpoint(tiny, tmp_path)
    argv = ["--checkpoint", path, "--dataset", "npz:data/hopper_mppi.npz",
            "--env", "Hopper-v5", "--model-steps", "5", "--sim-ensemble",
            "2", "--batch", "3", "--n-replans", "2", "--action-horizon", "2",
            "--device", "cpu", "--results-dir", str(tmp_path / "results")]
    out = evl.main(argv)
    printed = capsys.readouterr().out
    assert "simulator held-out one-step R^2" in printed
    assert "chunk bound" not in printed and "ms per model step" in printed
    line = next(ln for ln in printed.splitlines() if ln.startswith('{"env"'))
    assert set(json.loads(line)) == LEARNED_KEYS
    saved = json.loads(pathlib.Path(out["results_path"]).read_text())
    assert FILE_KEYS - RESULT_KEYS | LEARNED_KEYS - {"env"} <= set(saved)
    assert saved["policy_type"] == "ondevice-learned"
    assert saved["backend"] == "learned"
    assert saved["solver"] is None and saved["solver_iters"] is None
    assert np.isfinite(saved["simulator_r2_mean"])
    assert np.isfinite(out["model_based_mean_return"])
    assert out["timing"]["ms_per_sim_train_step"] > 0
    with pytest.raises(SystemExit, match="HalfCheetah, Hopper and Walker2d"):
        evl.main(argv[:4] + ["--env", "Ant-v5"] + argv[6:])


# ---------------------------------------------------------------------------
# Training at the locomotion width, on the Hopper data
# ---------------------------------------------------------------------------

def test_hopper_data_normalizer_and_first_losses_match_jax():
    """The +-joined Hopper spec: the same windows, normalizer statistics and
    first shuffled batches; and the diffusion loss of a (1, 4, 8) U-Net on
    the first three batches, the same weights, timesteps and noise (1e-5,
    as tests/test_torch_train.py holds the loss)."""
    ds, jds = (SequenceDataset(HOPPER_DATA, horizon=32),
               JaxDataset(HOPPER_DATA, horizon=32))
    assert len(ds) == len(jds) and ds.observation_dim == OBS
    for name in ("obs_mean", "obs_std", "action_mean", "action_std"):
        np.testing.assert_array_equal(getattr(ds.normalizer, name),
                                      getattr(jds.normalizer, name))
    jnet = JaxUnet(transition_dim=D, dim=8, dim_mults=(1, 4, 8))
    jdiff = JaxDiffusion(model=jnet, horizon=32, observation_dim=OBS,
                         action_dim=ACT, n_timesteps=100)
    params = jax.jit(jdiff.init_params)(jax.random.PRNGKey(1))
    unet = TemporalUnet(transition_dim=D, dim=8, dim_mults=(1, 4, 8))
    unet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                params)),
                         strict=True)
    diff = GaussianDiffusion(unet, horizon=32, observation_dim=OBS,
                             action_dim=ACT, n_timesteps=100)
    jloss = jax.jit(lambda p, x, t, n: jdiff.loss(
        p, jax.random.PRNGKey(0), x, t=t, noise=n))
    rng = np.random.RandomState(5)
    order = rng.permutation(len(ds))
    for i in range(3):
        idx = order[16 * i:16 * (i + 1)]
        x = ds.get_batch(idx)["conditions"]
        np.testing.assert_array_equal(x, jds.get_batch(idx)["conditions"])
        t = rng.randint(0, 100, 16)
        n = rng.randn(16, 32, D).astype(np.float32)
        want = float(jloss(params, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(n)))
        with torch.no_grad():
            got = float(diff.loss(torch.from_numpy(x), t=torch.from_numpy(t),
                                  noise=torch.from_numpy(n)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_new_modules_fall_under_the_no_jax_check():
    """The import check of tests/test_torch_serve.py walks the package: the
    locomotion modules are in its walk, and none of them imports JAX, the
    JAX package, gymnasium or mujoco at import."""
    import pkgutil
    import subprocess
    import sys

    import dadiff_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(
        dadiff_tpu_torch.__path__, "dadiff_tpu_torch.")}
    new = ["dadiff_tpu_torch.envs.planar_physics",
           "dadiff_tpu_torch.envs.locomotion_jax",
           "dadiff_tpu_torch.eval_ondevice_locomotion"]
    assert set(new) <= names
    code = ("import importlib, sys\n"
            f"for name in {new!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dadiff_tpu', 'gymnasium', 'mujoco')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(REPO))
    assert r.returncode == 0, r.stderr
