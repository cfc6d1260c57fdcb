"""The port's MPPI data engine (dadiff_tpu_torch/envs/mppi_tpu.py) and the
surrogate bound (dadiff_tpu_torch/surrogate_bound.py) held against the JAX
package on the CPU: the planner on the same ``jax.random.normal`` draw (one
model and the trajectory-sampling ensemble, white noise and the AR(1) noise
with the jerk penalty), the DAgger segment starts, the bound's segments and
table on one committed file, a tiny collection and relabelling on real
gymnasium envs, and the CLIs' flags and defaults against the JAX scripts.

Tolerances: the planner's actions and warm start 1e-5; the segment starts
exactly; the bound's numbers 1e-4 relative (the same weights on both sides,
f32 rollouts summed in another order).
"""

import argparse
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dadiff_tpu.envs import learned_model as jl
from dadiff_tpu.envs import mppi_tpu as jm

from dadiff_tpu_torch import collect_mppi_tpu, dagger_relabel
from dadiff_tpu_torch import surrogate_bound as sb
from dadiff_tpu_torch.datasets.sources import load_episodes
from dadiff_tpu_torch.envs import learned_model as tl
from dadiff_tpu_torch.envs import mppi_tpu as tm
from dadiff_tpu_torch.io.torch_compat import mlp_params_from_jax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
OBS, ACT, HID, E = 11, 3, (16, 16), 2
N, B, HORIZON = 8, 3, 6


def _script(name):
    """scripts/<name>.py of the JAX package, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sims():
    """One model and an ensemble of E on both sides, the same flax weights,
    statistics of the Hopper data's scale."""
    rng = np.random.RandomState(1)
    stats = [rng.randn(OBS) * 0.2, 0.5 + rng.rand(OBS), np.zeros(ACT),
             0.6 + 0.1 * rng.rand(ACT), rng.randn(OBS) * 0.01,
             0.05 + 0.05 * rng.rand(OBS)]
    stats = [np.asarray(v, np.float32) for v in stats]
    jstats = jl.ModelStats(*map(jnp.asarray, stats))
    tstats = tl.ModelStats(*map(torch.from_numpy, stats))
    model = jl.DynamicsMLP(obs_dim=OBS, hidden=HID)

    def init(key):
        return model.init(key, jnp.zeros((1, OBS)),
                          jnp.zeros((1, ACT)))["params"]

    one = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(2)))
    stacked = jax.tree_util.tree_map(np.asarray, jax.vmap(init)(
        jax.random.split(jax.random.PRNGKey(3), E)))
    t_one = tl.DynamicsMLP(OBS, ACT, HID)
    t_one.load_state_dict(mlp_params_from_jax(one))
    t_ens = tl.DynamicsMLP(OBS, ACT, HID, n_models=E)
    t_ens.load_state_dict(mlp_params_from_jax(stacked))
    return {
        "model": (jm.make_sim_step_fn(model, one, jstats),
                  tm.make_sim_step_fn(t_one, tstats)),
        "ensemble": (jl.make_ensemble_step_fn(model, stacked, jstats, N),
                     tl.make_ensemble_step_fn(t_ens, tstats, N)),
        "stats": stats,
    }


@pytest.mark.parametrize("beta,smooth", [(0.0, 0.0), (0.7, 0.05)],
                         ids=["white", "ar1-smooth"])
@pytest.mark.parametrize("sim", ["model", "ensemble"])
def test_mppi_planner_matches_jax(sims, sim, beta, smooth):
    """Two replans of 3 Hopper states, 8 candidates over 6 steps, 2 actions
    executed, each on the JAX plan's own normal draw; the second replan
    starts from the first's warm start. Actions and warm start 1e-5."""
    jstep, tstep = sims[sim]
    kw = dict(act_dim=ACT, horizon=HORIZON, n_samples=N, n_exec=2,
              noise_beta=beta, smooth_weight=smooth)
    jplan = jm.make_mppi_planner(jstep, jl.hopper_reward_done, jit=False,
                                 **kw)
    tplan = tm.make_mppi_planner(tstep, tl.hopper_reward_done, device="cpu",
                                 **kw)
    mu, sd = sims["stats"][:2]
    obs = (np.random.RandomState(5).randn(B, OBS) * sd + mu).astype(
        np.float32)
    obs[:, 0] = 1.25           # healthy height: most candidates score
    jmean = tmean = np.zeros((B, HORIZON, ACT), np.float32)
    for key in jax.random.split(jax.random.PRNGKey(7), 2):
        want = jplan(key, jnp.asarray(obs), jnp.asarray(jmean))
        noise = np.array(jax.random.normal(key, (N, B, HORIZON, ACT)))
        got = tplan(None, obs, tmean, noise=noise)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        assert got[0].shape == (B, 2, ACT) and not tplan.replayed
        jmean, tmean = np.asarray(want[1]), got[1].numpy()
    assert float(np.abs(tmean).max()) > 0
    # without injected noise the planner draws from its generator
    g = torch.Generator().manual_seed(0)
    a1 = tplan(g, obs, tmean)
    a2 = tplan(torch.Generator().manual_seed(0), obs, tmean)
    assert all(torch.equal(x, y) for x, y in zip(a1, a2))


def test_ar1_carry_starts_at_zero(sims):
    """The AR(1) noise's first column is sqrt(1 - beta^2) * eps: the carry
    starts at zero, as in JAX (a reference-side choice kept for parity)."""
    _, tstep = sims["model"]
    beta = 0.6
    plan = tm.make_mppi_planner(tstep, tl.hopper_reward_done, act_dim=ACT,
                                horizon=HORIZON, n_samples=N, sigma=1.0,
                                noise_beta=beta, device="cpu")
    noise = torch.full((N, B, HORIZON, ACT), 0.5)
    seen = {}

    def step(o, a):
        seen.setdefault("first", a.clone())
        return tstep(o, a)

    plan.step_fn = step
    plan(None, np.zeros((B, OBS), np.float32),
         np.zeros((B, HORIZON, ACT), np.float32), noise=noise)
    np.testing.assert_allclose(seen["first"].numpy(),
                               0.5 * np.sqrt(1 - beta ** 2), rtol=1e-6)


def test_dagger_segment_starts_match_jax():
    """Every stride-th visited state after skip_initial, pooled and
    subsampled: equal to JAX's, on a committed visited file."""
    visited = load_episodes("npz:data/hc_visited_i1.npz")[:6]
    for kw in (dict(stride=25, skip_initial=10, max_segments=400, seed=0),
               dict(stride=7, skip_initial=3, max_segments=20, seed=4)):
        want = jm.dagger_segment_starts(visited, **kw)
        got = tm.dagger_segment_starts(visited, **kw)
        np.testing.assert_array_equal(got, want)
    assert len(got) == 20
    with pytest.raises(ValueError, match="no visited states"):
        tm.dagger_segment_starts([{"observations": np.zeros((3, 17))}],
                                 skip_initial=10)


# ---------------------------------------------------------------------------
# The surrogate bound
# ---------------------------------------------------------------------------

BOUND_ARGV = ["--env", "Hopper-v5", "--data", "npz:data/hopper_mppi.npz",
              "--k", "4", "8", "16", "--stride", "10", "--sim-hidden", "32",
              "32", "--sim-steps", "20", "--sim-ensemble", "2", "--seed", "1"]


def test_surrogate_bound_matches_jax(tmp_path, monkeypatch):
    """The JAX script's table on data/hopper_mppi.npz (an ensemble of 2 fit
    for 20 steps), and the port's on the same fitted weights: every row's
    numbers 1e-4 relative, the quotable flags and K* equal, the schema
    equal."""
    fitted = {}
    real = jl.train_dynamics_ensemble

    def capture(*a, **kw):
        fitted["out"] = real(*a, **kw)
        return fitted["out"]

    monkeypatch.setattr(jl, "train_dynamics_ensemble", capture)
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["surrogate_bound.py", *BOUND_ARGV,
                                      "--out", str(out)])
    _script("surrogate_bound").main()
    want = json.loads(out.read_text())

    _, stacked, jstats, metrics = fitted["out"]
    args = sb.build_parser().parse_args(BOUND_ARGV + ["--device", "cpu"])
    pool = load_episodes("npz:data/hopper_mppi.npz")
    held = pool[::args.holdout_every]
    fit = [ep for i, ep in enumerate(pool) if i % args.holdout_every]
    model = tl.DynamicsMLP(OBS, ACT, (32, 32), n_models=2)
    model.load_state_dict(mlp_params_from_jax(
        jax.tree_util.tree_map(np.asarray, stacked)))
    stats = tl.ModelStats(*(torch.from_numpy(np.array(v)) for v in jstats))
    got = json.loads(json.dumps(sb.bound_report(args, fit, held, model, stats,
                                                metrics)))
    assert set(got) == set(want) and got["fit_episodes"] == len(fit)
    rows_w = want["distributions"]["heldout"]["rows"]
    rows_g = got["distributions"]["heldout"]["rows"]
    assert [r["K"] for r in rows_g] == [4, 8, 16]
    assert got["distributions"]["heldout"]["k_star"] == \
        want["distributions"]["heldout"]["k_star"]
    for rg, rw in zip(rows_g, rows_w):
        assert set(rg) == set(rw)
        for k, w in rw.items():
            if isinstance(w, (bool, int)) or w is None:
                assert rg[k] == w, k
            else:
                np.testing.assert_allclose(rg[k], w, rtol=1e-4, atol=1e-6,
                                           err_msg=k)


def test_surrogate_bound_segments_per_k():
    """Windows per K; an episode too short for a K is excluded from that K
    only and counted; the same stacks as JAX's."""
    rng = np.random.RandomState(0)

    def ep(n):
        return {"observations": rng.randn(n + 1, 3).astype(np.float32),
                "actions": rng.randn(n, 2).astype(np.float32),
                "rewards": rng.randn(n).astype(np.float32)}

    episodes = [ep(10), ep(100)]
    jsb = _script("surrogate_bound")
    for k in (4, 64):
        got, ex = sb.segments_from_episodes(episodes, k, 10, 2)
        want, ex_w = jsb.segments_from_episodes(episodes, k, 10, 2)
        assert ex == ex_w == (0 if k == 4 else 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert sb.segments_from_episodes([ep(5)], 64, 10, 2) == (None, 1)


def test_surrogate_bound_cli_writes_the_report(tmp_path, capsys):
    out = tmp_path / "bound.json"
    report = sb.main(BOUND_ARGV + ["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert "| K | |R_real|" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        sb.main(BOUND_ARGV + ["--holdout-every", "1", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Collection and relabelling on real envs (gymnasium, host)
# ---------------------------------------------------------------------------

EPISODE_KEYS = {"observations", "actions", "rewards"}


def _check_episodes(eps, obs_dim, act_dim, max_len):
    for ep in eps:
        assert set(ep) == EPISODE_KEYS
        T = len(ep["actions"])
        assert 1 <= T <= max_len
        assert ep["observations"].shape == (T + 1, obs_dim)
        assert ep["actions"].shape == (T, act_dim)
        assert ep["rewards"].shape == (T,)
        assert ep["observations"].dtype == np.float32
        assert np.all(np.abs(ep["actions"]) <= 1.0)


@pytest.mark.parametrize("backend", ["learned", "physics"])
def test_collect_writes_episodes(tmp_path, backend):
    """A tiny collection on real Hopper envs (3 episodes of at most 6
    steps, 2 envs, an ensemble of 2 fit for 5 steps, or the exact search
    physics), with execution noise: the episode schema and shapes, and the
    checkpointed npz equal to what came back."""
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    seed = load_episodes("npz:data/hopper_mppi.npz")[:3]
    path = tmp_path / "engine.npz"
    eps = tm.collect_mppi_tpu_episodes(
        "Hopper-v5", n_episodes=3, seed_episodes=seed, max_steps=6,
        batch_envs=2, horizon=4, n_samples=8, n_exec=2, explore_sigma=0.2,
        explore_beta=0.5, n_iterations=2, sim_hidden=(16, 16), sim_steps=5,
        sim_ensemble=2, dynamics_backend=backend, physics_solver_iters=5,
        checkpoint_path=str(path), seed=1, verbose=False, device="cpu")
    assert len(eps) == 3
    _check_episodes(eps, OBS, ACT, 6)
    saved = load_episodes(f"npz:{path}")
    assert len(saved) == 3
    for s, e in zip(saved, eps):
        for k in EPISODE_KEYS:
            np.testing.assert_array_equal(s[k], e[k])
    with pytest.raises(ValueError, match="seed_episodes"):
        tm.collect_mppi_tpu_episodes("Hopper-v5", seed_episodes=[],
                                     device="cpu")


def test_dagger_relabel_writes_segments(tmp_path):
    """Three segments of at most 5 real Hopper steps from injected visited
    states: each starts at its injected state; the CLI writes them."""
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    visited = load_episodes("npz:data/hopper_mppi.npz")[3:5]
    pool = load_episodes("npz:data/hopper_mppi.npz")[:3]
    kw = dict(segment_len=5, stride=20, skip_initial=5, max_segments=3,
              batch_envs=2, horizon=4, n_samples=8, n_exec=2,
              sim_hidden=(16, 16), sim_steps=5, sim_ensemble=2, seed=2,
              verbose=False, device="cpu")
    segs = tm.dagger_relabel_episodes("Hopper-v5", visited, pool, **kw)
    starts = tm.dagger_segment_starts(visited, stride=20, skip_initial=5,
                                      max_segments=3, seed=2)
    assert len(segs) == len(starts) == 3
    _check_episodes(segs, OBS, ACT, 5)
    got = sorted(s["observations"][0].tobytes() for s in segs)
    assert got == sorted(s.tobytes() for s in starts)

    from dadiff_tpu_torch.datasets.sources import save_episodes_npz

    vpath = tmp_path / "visited.npz"
    save_episodes_npz(str(vpath), visited)
    out = tmp_path / "dagger.npz"
    dagger_relabel.main([
        "--env", "Hopper-v5", "--visited", str(vpath), "--pool",
        "npz:data/hopper_mppi.npz", "--out", str(out), "--segment-len", "3",
        "--stride", "20", "--skip-initial", "5", "--max-segments", "2",
        "--batch-envs", "2", "--horizon", "4", "--n-samples", "8",
        "--n-exec", "2", "--sim-hidden", "16", "16", "--sim-steps", "3",
        "--sim-ensemble", "2", "--device", "cpu"])
    assert len(load_episodes(f"npz:{out}")) == 2


def test_collect_cli_writes_npz(tmp_path):
    pytest.importorskip("gymnasium")
    out = tmp_path / "c.npz"
    collect_mppi_tpu.main([
        "--env", "Hopper-v5", "--seed-data", "npz:data/hopper_mppi.npz",
        "--episodes", "2", "--max-steps", "4", "--batch-envs", "2",
        "--horizon", "4", "--n-samples", "8", "--iterations", "1",
        "--sim-steps", "3", "--sim-hidden", "16", "16", "--out", str(out),
        "--device", "cpu"])
    eps = load_episodes(f"npz:{out}")
    assert len(eps) == 2
    _check_episodes(eps, OBS, ACT, 4)


# ---------------------------------------------------------------------------
# The CLIs against the JAX scripts
# ---------------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _jax_parser(name, monkeypatch):
    """The argparse parser that scripts/<name>.py builds in its main."""
    seen = {}

    def grab(self, *a, **kw):
        seen["p"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        _script(name).main()
    monkeypatch.undo()
    return seen["p"]


@pytest.mark.parametrize("name,port,device", [
    ("collect_mppi_tpu", collect_mppi_tpu, "tpu"),
    ("dagger_relabel", dagger_relabel, None),
    ("surrogate_bound", sb, None)])
def test_cli_flags_match_the_jax_scripts(name, port, device, monkeypatch):
    """Every flag with its default, choices, type, nargs and requiredness;
    ``--device`` takes cuda (the default) or cpu, where the JAX script names
    the TPU or has no such flag."""
    want = {a.dest: a for a in _jax_parser(name, monkeypatch)._actions
            if a.dest != "help"}
    got = {a.dest: a for a in port.build_parser()._actions
           if a.dest != "help"}
    assert set(got) == set(want) | {"device"}
    for dest, a in want.items():
        if dest == "device":
            continue
        b = got[dest]
        for attr in ("option_strings", "default", "choices", "type",
                     "nargs", "required"):
            assert getattr(a, attr) == getattr(b, attr), (dest, attr)
    assert (got["device"].default, got["device"].choices) == (
        "cuda", ["cuda", "cpu"])
    if device:
        assert want["device"].default == device
