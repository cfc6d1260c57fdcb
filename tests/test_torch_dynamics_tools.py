"""The dynamics tools held against the JAX package on the CPU: A and B from
every extractor (analytical, numerical MuJoCo finite differences,
trajectory fit from rollouts and from a dataset), every branch of
``get_dynamics_for_env`` with its fallbacks and warnings, and the
``diagnose_dynamics``, ``physics_bound`` and ``calibrate_contact`` scripts
at tiny sizes against the JAX scripts' outputs.

The extractors run the same numpy and MuJoCo calls on both sides, so A and
B are equal bit for bit; random rollouts draw from the env's action space,
seeded the same on both sides here. The physics bound replays float32
planar physics under XLA and under PyTorch: returns agree to rounding
(~1e-5 after a few steps), so its error percentiles are held to
1e-3 absolute and everything else exactly. The contact calibration steps
float32 PointMaze on both: 1e-5."""

import sys
from pathlib import Path

import numpy as np
import pytest

from dadiff_tpu.dynamics import extractor as jext
from dadiff_tpu.dynamics import registry as jreg

from dadiff_tpu_torch import calibrate_contact, diagnose_dynamics, physics_bound
from dadiff_tpu_torch.dynamics import extractor, registry

ROOT = Path(__file__).resolve().parents[1]
SYNTH = "synthetic:pointmaze:n=4,T=40"


def _gym():
    pytest.importorskip("gymnasium")
    pytest.importorskip("gymnasium_robotics")
    pytest.importorskip("mujoco")


def _seeded(factory):
    """``get_dynamics_extractor`` whose env's action space draws from seed
    0, so that random rollouts repeat."""
    def make(env_name, method="auto"):
        ex = factory(env_name, method=method)
        ex.env.action_space.seed(0)
        return ex
    return make


def test_double_integrator_matches_jax():
    for dt in (0.01, 0.1):
        for got, want in zip(extractor.double_integrator_dynamics(dt),
                             jext.double_integrator_dynamics(dt)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("env,method", [
    ("PointMaze_UMaze-v3", "analytical"), ("PointMaze_UMaze-v3", "numerical"),
    ("Hopper-v5", "numerical"), ("HalfCheetah-v5", "numerical"),
    ("PointMaze_UMaze-v3", "trajectory"), ("Hopper-v5", "trajectory"),
    ("Hopper-v5", "auto")])
def test_extractor_matches_jax(env, method):
    _gym()
    out = []
    for mod in (extractor, jext):
        ex = _seeded(mod.get_dynamics_extractor)(env, method=method)
        try:
            if "trajectory" in type(ex).__name__.lower():
                A, B = ex.get_dynamics(num_trajectories=3,
                                       trajectory_length=20)
            else:
                A, B = ex.get_dynamics()
            out.append((A, B, ex.state_dim, ex.action_dim))
        finally:
            ex.close()
    (A, B, n, m), (jA, jB, jn, jm) = out
    assert (n, m) == (jn, jm) and A.shape == (n, n) and B.shape == (n, m)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(B, jB)


def test_trajectory_extractor_fits_a_dataset_as_jax():
    _gym()
    out = []
    for mod in (extractor, jext):
        ex = mod.get_dynamics_extractor("PointMaze_UMaze-v3",
                                        method="trajectory")
        out.append(ex.get_dynamics(use_dataset=SYNTH))
        ex.close()
    for got, want in zip(*out):
        np.testing.assert_array_equal(got, want)


def test_unknown_method_and_non_maze_analytical_raise_as_jax():
    with pytest.raises(ValueError, match="Unknown method"):
        extractor.get_dynamics_extractor("Hopper-v5", method="magic")
    _gym()
    for mod in (extractor, jext):
        ex = mod.get_dynamics_extractor("Hopper-v5", method="analytical")
        with pytest.raises(ValueError, match="No analytical dynamics"):
            ex.get_dynamics()
        ex.close()


def _registry_case(mod, monkeypatch, **kw):
    monkeypatch.setattr(mod, "get_dynamics_extractor",
                        _seeded(mod.get_dynamics_extractor))
    return mod.get_dynamics_for_env(**kw)


@pytest.mark.parametrize("case", [
    # data-driven on pre-loaded episodes (the CLIs' hermetic specs)
    {"env_name": "PointMaze_UMaze-v3", "episodes": "synthetic"},
    # data-driven on a spec by name
    {"env_name": "PointMaze_UMaze-v3", "dataset_name": SYNTH},
    # a minari name where minari is absent: the maze falls back to the
    # analytical double integrator
    {"env_name": "PointMaze_Medium-v3"},
    # no dataset resolves for a locomotion env: a trajectory fit
    {"env_name": "Walker2d-v5"},
    # explicit methods
    {"env_name": "Hopper-v5", "method": "numerical"},
    {"env_name": "PointMaze_UMaze-v3", "method": "analytical"},
    {"env_name": "HalfCheetah-v5", "method": "trajectory",
     "dataset_name": "npz:data/halfcheetah_mppi.npz"},
], ids=["episodes", "spec", "minari-fallback", "trajectory-fallback",
        "numerical", "analytical", "trajectory-dataset"])
def test_get_dynamics_for_env_matches_jax(case, monkeypatch, capsys):
    _gym()
    from dadiff_tpu.datasets.sources import load_episodes

    kw = dict(case)
    if kw.get("episodes") == "synthetic":
        kw["episodes"] = load_episodes(SYNTH)
    if "dataset_name" in kw and kw["dataset_name"].startswith("npz:"):
        kw["dataset_name"] = "npz:" + str(ROOT / kw["dataset_name"][4:])
    got = _registry_case(registry, monkeypatch, **kw)
    ours = capsys.readouterr().out
    want = _registry_case(jreg, monkeypatch, **kw)
    theirs = capsys.readouterr().out
    assert ours == theirs
    assert got[2:] == want[2:]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if case["env_name"] == "PointMaze_Medium-v3":
        assert "degrade to 'analytical'" in ours
    if case["env_name"] == "Walker2d-v5":
        assert "no dataset resolves" in ours and "random-rollout" in ours


def test_registry_tables_equal_jax():
    assert registry.DYNAMICS_REGISTRY == jreg.DYNAMICS_REGISTRY
    assert registry.STATE_DIM_REGISTRY == jreg.STATE_DIM_REGISTRY
    assert registry.DATASET_REGISTRY == jreg.DATASET_REGISTRY


def _jax_script(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    import importlib

    return importlib.import_module(f"scripts.{name}")


@pytest.mark.parametrize("dataset", [SYNTH,
                                     "npz:data/pointmaze_umaze_expert.npz"])
def test_diagnose_dynamics_prints_what_jax_prints(dataset, monkeypatch,
                                                  capsys):
    if dataset.startswith("npz:"):
        dataset = "npz:" + str(ROOT / dataset[4:])
    argv = ["--dataset", dataset, "--horizon", "8"]
    out = diagnose_dynamics.main(argv)
    ours = capsys.readouterr().out
    _jax_script("diagnose_dynamics", monkeypatch).main(argv)
    assert ours == capsys.readouterr().out
    assert out["idempotent"] and out["r2"] > 0.9


def test_physics_bound_matches_the_jax_script(tmp_path, monkeypatch):
    """Hopper at K = 2, 4 segments, 30 solver iterations, float32: the
    report's schema and rows against the JAX script's."""
    import json

    args = ["--env", "Hopper-v5", "--data",
            "npz:" + str(ROOT / "data/hopper_mppi.npz"), "--k", "2",
            "--max-segments", "4", "--solver-iters", "30"]
    ours = physics_bound.main(args + ["--device", "cpu", "--out",
                                      str(tmp_path / "ours.json")])
    monkeypatch.setattr(sys, "argv", ["physics_bound.py"] + args + [
        "--out", str(tmp_path / "theirs.json")])
    _jax_script("physics_bound", monkeypatch).main()
    theirs = json.load(open(tmp_path / "theirs.json"))
    assert json.load(open(tmp_path / "ours.json")) == ours
    assert set(ours) == set(theirs)
    for k in ("env", "backend", "dtype", "solver_iters", "tolerance"):
        assert ours[k] == theirs[k], k
    got, want = (r["distributions"]["heldout"] for r in (ours, theirs))
    assert got["k_star"] == want["k_star"]
    for a, b in zip(got["rows"], want["rows"]):
        assert set(a) == set(b)
        for k in ("K", "n_segments", "n_episodes_excluded", "quotable"):
            assert a[k] == b[k], k
        assert a["mean_abs_R_real"] == pytest.approx(b["mean_abs_R_real"],
                                                     rel=1e-6)
        for k in ("err_p50", "err_p90"):
            assert abs(a[k] - b[k]) <= 1e-3, k


def test_calibrate_contact_matches_the_jax_script(monkeypatch):
    """UMaze, 300 host transitions, three slacks: the same transitions
    (the same collector) and each slack's errors against the JAX
    script's (its device selection bypassed: JAX already runs on the CPU
    here)."""
    _gym()
    ours = calibrate_contact.main(["--map", "umaze", "--n-transitions", "300",
                                   "--slacks", "0.0", "0.02", "0.06",
                                   "--device", "cpu"])
    import dadiff_tpu.cli as jcli

    monkeypatch.setattr(jcli, "_select_device", lambda device: None)
    monkeypatch.setattr(sys, "argv", [
        "calibrate_contact.py", "--map", "umaze", "--n-transitions", "300",
        "--slacks", "0.0", "0.02", "0.06"])
    theirs = _jax_script("calibrate_contact", monkeypatch).main()
    assert set(ours) == set(theirs)
    for slack, row in theirs.items():
        for k, v in row.items():
            assert ours[slack][k] == pytest.approx(v, abs=1e-5), (slack, k)
