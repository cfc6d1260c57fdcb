"""The port's entry points on the CPU: a ``.pt`` written by the JAX package
loads through ``load_model`` with ``strict=True``, the serve handler and the
TCP server answer ping/obs/plan/reset, and importing the port leaves JAX and
the JAX package out of ``sys.modules``."""

import ast
import json
import pathlib
import pkgutil
import socket
import subprocess
import sys
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dadiff_tpu.io.torch_compat import save_pt_checkpoint as jax_save_pt
from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet

import dadiff_tpu_torch
from dadiff_tpu_torch.cli import load_model
from dadiff_tpu_torch.serve import build_server_parser, make_handler, serve

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

H, OBS, ACT, T_STEPS = 8, 6, 2, 6
DATASET = "synthetic:pointmaze:n=6,T=40"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    unet = JaxUnet(transition_dim=OBS + ACT, dim=32, dim_mults=(1, 2))
    diff = JaxDiffusion(model=unet, horizon=H, observation_dim=OBS,
                        action_dim=ACT, n_timesteps=T_STEPS)
    params = jax.jit(diff.init_params)(jax.random.PRNGKey(4))
    stats = {"obs_mean": [0.1] * OBS, "obs_std": [2.0] * OBS,
             "action_mean": [0.0] * ACT, "action_std": [0.5] * ACT}
    path = str(tmp_path_factory.mktemp("ckpt") / "model.pt")
    jax_save_pt(path, params, diff.schedule, {
        "horizon": H, "observation_dim": OBS, "action_dim": ACT,
        "n_timesteps": T_STEPS, "beta_schedule": "cosine",
        "dim_mults": (1, 2), "normalizer_stats": stats,
    })
    return path, diff, params, stats


def test_load_model_reads_jax_written_pt(checkpoint):
    path, jax_diff, params, stats = checkpoint
    diff, dataset = load_model(path, DATASET, device="cpu")
    assert (diff.horizon, diff.n_timesteps, diff.model.dim_mults) == (H, T_STEPS, (1, 2))
    np.testing.assert_allclose(dataset.normalizer.obs_std, stats["obs_std"])
    np.testing.assert_allclose(diff.betas.numpy(),
                               np.asarray(jax_diff.schedule.betas), atol=1e-7)
    x = np.random.RandomState(0).randn(2, H, OBS + ACT).astype(np.float32)
    t = np.array([1, 4])
    want = jax.jit(jax_diff.apply)(params, jnp.asarray(x),
                                   jnp.asarray(t, jnp.int32))
    with torch.no_grad():
        got = diff(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _policy(path, extra=()):
    from dadiff_tpu_torch.cli import build_policy_from_args

    args = build_server_parser().parse_args(
        ["--checkpoint", path, "--dataset", DATASET, "--device", "cpu",
         "--policy-type", "dynamics-aware", "--n-candidates", "3",
         "--action-horizon", "4", *extra])
    diff, dataset = load_model(path, DATASET, device="cpu")
    return build_policy_from_args(args, diff, dataset, DATASET,
                                  min(200, diff.n_timesteps))


@pytest.mark.parametrize("extra", [(), ("--megakernel", "--wall-aware")])
def test_serve_handler_on_cpu(checkpoint, extra):
    policy = _policy(checkpoint[0], extra)
    handle = make_handler(policy)
    pong = handle({"ping": True})
    assert pong["ok"] and pong["horizon"] == H and pong["action_dim"] == ACT
    obs = [0.5, -0.5, 0.0, 0.1, 1.0, 1.0]
    r = handle({"obs": obs, "plan": True})
    plan = np.asarray(r["plan"])
    assert plan.shape == (H, OBS + ACT) and np.isfinite(plan).all()
    normed = policy.normalizer.normalize_observations(np.asarray(obs, np.float32))
    np.testing.assert_allclose(plan[0, :OBS], normed, atol=1e-6)
    np.testing.assert_array_equal(plan[0, OBS:], 0.0)
    assert len(r["action"]) == ACT and r["plan_ms"] >= 0
    assert len(handle({"obs": obs})["action"]) == ACT
    assert handle({"reset": True}) == {"ok": True}
    assert not policy.action_buffer
    assert "error" in handle({"bogus": 1})


@pytest.mark.parametrize("source", ["plan", "inverse-dynamics", "track"])
def test_serve_handler_action_source(checkpoint, monkeypatch, source):
    """Every ``--action-source`` answers a plan request and a plain obs
    request with an action of the action width. With an inverse model (cut
    to 5 steps of a (16, 16) MLP here) the plan request's action is
    ``g(obs, planned next state)``: under ``track`` the buffer holds planned
    states, which the handler turns into an action as ``get_action`` does.
    The planned rows kept for the deviation check stay aligned with the
    buffer."""
    from dadiff_tpu_torch.envs import learned_model

    real = learned_model.train_inverse_dynamics
    monkeypatch.setattr(
        learned_model, "train_inverse_dynamics",
        lambda episodes, **kw: real(episodes,
                                    **dict(kw, n_steps=5, hidden=(16, 16))))
    policy = _policy(checkpoint[0], ("--action-source", source))
    assert (policy.inverse_dynamics is None) == (source == "plan")
    handle = make_handler(policy)
    obs = np.asarray([0.5, -0.5, 0.0, 0.1, 1.0, 1.0], np.float32)
    r = handle({"obs": obs.tolist(), "plan": True})
    act = np.asarray(r["action"])
    assert act.shape == (ACT,) and np.isfinite(act).all()
    assert len(policy._planned_obs) == len(policy.action_buffer)
    if source != "plan":
        plan = np.asarray(r["plan"], np.float32)
        nxt = policy.normalizer.unnormalize_observations(plan[1:2, :OBS])
        want = np.ravel(policy.inverse_dynamics(obs[None], nxt))
        np.testing.assert_allclose(act, want, rtol=1e-5, atol=1e-5)
    act = np.asarray(handle({"obs": obs.tolist()})["action"])
    assert act.shape == (ACT,) and np.isfinite(act).all()


def test_serve_tcp_roundtrip(checkpoint):
    policy = _policy(checkpoint[0], ("--megakernel",))
    ready = threading.Event()
    box = {}

    def on_ready(port):
        box["port"] = port
        ready.set()

    th = threading.Thread(target=lambda: box.update(
        n=serve(policy, "127.0.0.1", 0, max_requests=4, ready_cb=on_ready)),
        daemon=True)
    th.start()
    assert ready.wait(30)
    reqs = [{"ping": True}, {"obs": [0.0] * OBS, "plan": True}, {"nope": 1},
            {"reset": True}]
    with socket.create_connection(("127.0.0.1", box["port"]), timeout=60) as s:
        f = s.makefile("rwb")
        out = []
        for req in reqs:
            f.write((json.dumps(req) + "\n").encode())
            f.flush()
            out.append(json.loads(f.readline()))
    th.join(timeout=30)
    assert not th.is_alive() and box["n"] == 4
    assert out[0]["ok"] and len(out[1]["plan"]) == H
    assert "error" in out[2] and out[3] == {"ok": True}


def test_port_imports_no_jax():
    """Every module of the port imports without JAX or the JAX package."""
    names = [m.name for m in pkgutil.walk_packages(
        dadiff_tpu_torch.__path__, "dadiff_tpu_torch.")]
    assert {"dadiff_tpu_torch.ops.planner", "dadiff_tpu_torch.ops.chain",
            "dadiff_tpu_torch.ops.resblock", "dadiff_tpu_torch.losses",
            "dadiff_tpu_torch.utils.training", "dadiff_tpu_torch.train",
            "dadiff_tpu_torch.models.fused_unet",
            "dadiff_tpu_torch.models.fast_sampler",
            "dadiff_tpu_torch.probe_megakernel",
            "dadiff_tpu_torch.envs.pointmaze_jax",
            "dadiff_tpu_torch.envs.rollout", "dadiff_tpu_torch.envs.host",
            "dadiff_tpu_torch.envs.vector_eval",
            "dadiff_tpu_torch.eval_ondevice",
            "dadiff_tpu_torch.evaluate", "dadiff_tpu_torch.distill",
            "dadiff_tpu_torch.models.consistency",
            "dadiff_tpu_torch.envs.learned_model",
            "dadiff_tpu_torch.envs.mppi_tpu",
            "dadiff_tpu_torch.surrogate_bound",
            "dadiff_tpu_torch.collect_mppi_tpu",
            "dadiff_tpu_torch.dagger_relabel",
            "dadiff_tpu_torch.models.temporal_transformer",
            "dadiff_tpu_torch.models.parallel_sampling",
            "dadiff_tpu_torch.models.progressive",
            "dadiff_tpu_torch.bench_picard",
            "dadiff_tpu_torch.parallel",
            "dadiff_tpu_torch.parallel.distributed",
            "dadiff_tpu_torch.parallel.mesh",
            "dadiff_tpu_torch.parallel.planner",
            "dadiff_tpu_torch.parallel.tp",
            "dadiff_tpu_torch.parallel.comm_analysis",
            "dadiff_tpu_torch.dryrun_multihost",
            "dadiff_tpu_torch.dryrun_multichip",
            "dadiff_tpu_torch.analyze_tp_comm",
            "dadiff_tpu_torch.bench_forward",
            "dadiff_tpu_torch.bench_gn_mish",
            "dadiff_tpu_torch.utils.config",
            "dadiff_tpu_torch.utils.profiling",
            "dadiff_tpu_torch.utils.debug",
            "dadiff_tpu_torch.utils.arrays",
            "dadiff_tpu_torch.dynamics.extractor",
            "dadiff_tpu_torch.dynamics.registry",
            "dadiff_tpu_torch.envs.expert",
            "dadiff_tpu_torch.envs.mppi_expert",
            "dadiff_tpu_torch.download_data",
            "dadiff_tpu_torch.physics_bound",
            "dadiff_tpu_torch.diagnose_dynamics",
            "dadiff_tpu_torch.calibrate_contact",
            "dadiff_tpu_torch.compare_results",
            "dadiff_tpu_torch.check_install"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'dadiff_tpu', "
        "'gymnasium')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_imports_nothing_of_jax():
    """The smoke script, like the port, names no module of JAX or of the JAX
    package in any import, top-level or inside a function."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    tree = ast.parse(path.read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert "dadiff_tpu_torch.probe_megakernel" in mods | {
        f"{n.module}.{a.name}" for n in ast.walk(tree)
        if isinstance(n, ast.ImportFrom) and n.module for a in n.names}
    bad = [m for m in mods if m.split(".")[0] in
           ("jax", "jaxlib", "flax", "optax", "orbax", "dadiff_tpu")]
    assert not bad, bad
