"""The data tools held against the JAX package on the CPU: every dataset
spec of ``load_episodes`` (``gym:``, ``expert:``, ``mppi:``, minari's
absence), ``python -m dadiff_tpu_torch.download_data --collect / --info``,
``compare_results`` on two committed results files, ``check_install``, and
the package importing where gymnasium, gymnasium_robotics, mujoco, minari
and PyYAML are absent (the card's machine). Episodes and printed reports
are equal exactly (the same numpy, gymnasium and MuJoCo calls)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dadiff_tpu import cli as jcli
from dadiff_tpu.datasets import sources as jsrc

from dadiff_tpu_torch import check_install, cli, compare_results
from dadiff_tpu_torch.datasets import sources

ROOT = Path(__file__).resolve().parents[1]


def _assert_episodes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _gym():
    pytest.importorskip("gymnasium")
    pytest.importorskip("gymnasium_robotics")
    pytest.importorskip("mujoco")


@pytest.mark.parametrize("spec", [
    "expert:PointMaze_UMaze-v3:n=2,T=30,noise=0.1,seed=4",
    "expert:PointMaze_Medium-v3:n=1,T=25,corner_safe=1,lookahead=1",
    "mppi:Hopper-v5:n=1,T=3,seed=2",
    "synthetic:pointmaze:n=2,T=10+expert:PointMaze_UMaze-v3:n=1,T=12"])
def test_collector_specs_match_jax(spec):
    _gym()
    _assert_episodes_equal(sources.load_episodes(spec),
                           jsrc.load_episodes(spec))


def test_gym_episodes_match_jax_under_one_policy():
    """``collect_gym_episodes`` with a deterministic policy equals JAX's;
    the ``gym:`` spec (the action space's own unseeded draws) has JAX's
    layout."""
    _gym()

    def policy(obs):
        return np.tanh(np.asarray(obs["observation"][:2]) - 0.3
                       ).astype(np.float32)

    kw = dict(n_episodes=2, max_steps=15, policy=policy, seed=3)
    _assert_episodes_equal(
        sources.collect_gym_episodes("PointMaze_UMaze-v3", **kw),
        jsrc.collect_gym_episodes("PointMaze_UMaze-v3", **kw))
    eps = sources.load_episodes("gym:PointMaze_UMaze-v3:n=2", max_steps=7)
    assert len(eps) == 2 and eps[0]["observations"].shape == (8, 6)
    assert eps[0]["actions"].shape == (7, 2) and eps[0]["rewards"].shape == (7,)


def test_minari_absent_raises_jax_error():
    assert sources.minari_available() == jsrc.minari_available()
    if sources.minari_available():
        pytest.skip("minari is installed here")
    with pytest.raises(ImportError) as ours:
        sources.load_episodes("D4RL/pointmaze/umaze-v2")
    with pytest.raises(ImportError) as theirs:
        jsrc.load_episodes("D4RL/pointmaze/umaze-v2")
    assert str(ours.value) == str(theirs.value)
    assert "'synthetic:*'" in str(ours.value)


def test_flatten_episode_observations_matches_jax():
    rng = np.random.RandomState(0)
    obs = {"observation": rng.randn(5, 4), "desired_goal": rng.randn(5, 2),
           "achieved_goal": rng.randn(5, 2)}
    for include_goal in (True, False):
        np.testing.assert_array_equal(
            sources._flatten_episode_observations(obs, include_goal),
            jsrc._flatten_episode_observations(obs, include_goal))
    np.testing.assert_array_equal(
        sources._flatten_episode_observations({"a": rng.randn(3, 2),
                                               "b": rng.randn(3)}, True)
        .shape, (3, 3))


@pytest.mark.parametrize("spec", ["synthetic:pointmaze",
                                  "expert:PointMaze_UMaze-v3:T=20"])
def test_download_collect_and_info_match_jax(spec, tmp_path, capsys):
    if spec.startswith("expert:"):
        _gym()
    ours, theirs = tmp_path / "ours.npz", tmp_path / "theirs.npz"
    cli.download_main(["--collect", spec, "--episodes", "3", "--out",
                       str(ours)])
    jcli.download_main(["--collect", spec, "--episodes", "3", "--out",
                        str(theirs)])
    out = capsys.readouterr().out
    assert out.count("saved 3 episodes") == 2
    _assert_episodes_equal(sources.load_episodes_npz(str(ours)),
                           jsrc.load_episodes_npz(str(theirs)))
    cli.download_main(["--info", spec, "--episodes", "2"])
    mine = capsys.readouterr().out
    jcli.download_main(["--info", spec, "--episodes", "2"])
    assert mine == capsys.readouterr().out and "Total episodes: 2" in mine


def test_download_without_minari_refuses_as_jax():
    if sources.minari_available():
        pytest.skip("minari is installed here")
    with pytest.raises(SystemExit, match="minari is not installed"):
        cli.download_main(["--list"])
    with pytest.raises(SystemExit, match="minari is not installed"):
        jcli.download_main(["--list"])


@pytest.mark.parametrize("pair", [
    ("guided_PointMaze_UMaze_v3_20260816_073855.json",
     "dynamics-aware_PointMaze_UMaze_v3_20260816_075734.json"),
    ("dynamics-aware_PointMaze_Large_v3_20260817_222659.json",
     "dynamics-aware_PointMaze_Large_v3_20260818_052559.json")])
def test_compare_results_prints_what_jax_prints(pair, monkeypatch, capsys):
    paths = [str(ROOT / "results" / p) for p in pair]
    assert compare_results.main(paths) == 0
    ours = capsys.readouterr().out
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    from scripts import compare_results as jcompare

    assert jcompare.main(paths) == 0
    assert ours == capsys.readouterr().out and "paired" in ours


def test_compare_results_latest_by_policy_type(capsys):
    assert compare_results.main(["--results-dir", str(ROOT / "results"),
                                 "--a", "guided", "--b",
                                 "dynamics-aware"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("A: guided") and "B: dynamics-aware" in out
    with pytest.raises(SystemExit, match="no results matching"):
        compare_results.main(["--results-dir", str(ROOT / "results"),
                              "--a", "nothing"])


def test_check_install_passes_on_the_cpu(capsys):
    assert check_install.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[FAIL]" not in out and "model forward" in out
    import torch

    if torch.cuda.is_available():
        return
    assert check_install.main([]) == 1  # no card here: the card checks fail
    assert "[FAIL] CUDA device" in capsys.readouterr().out


def test_port_imports_without_the_host_only_packages():
    """Every module of the port imports with gymnasium, gymnasium_robotics,
    mujoco, minari and yaml unimportable (None in sys.modules), as on the
    card's machine."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('gymnasium', 'gymnasium_robotics', 'mujoco', 'minari', "
        "'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import dadiff_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "dadiff_tpu_torch.__path__, 'dadiff_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) > 60, len(names)\n"
        "print(len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
