"""The port does all that the JAX package does, name by name.

The first two tests read both packages' sources with ``ast`` (no JAX runs):
every public top-level function, class and method of ``dadiff_tpu/`` has a
counterpart of the same name in ``dadiff_tpu_torch/``, and every
command-line flag of the JAX package's CLIs and scripts has one in the
port's module of the same name, apart from the exceptions listed below,
each with its reason. The rest hold the names the port added last against
their JAX counterparts on the CPU.
"""

import ast
import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dadiff_tpu.envs import mppi_tpu as jm
from dadiff_tpu.models import diffusion as jd
from dadiff_tpu.ops.projection import NormStats as JaxNormStats
from dadiff_tpu.ops.schedules import make_schedule as jax_schedule
from dadiff_tpu.utils import training as jt

from dadiff_tpu_torch.envs import mppi_tpu as tm
from dadiff_tpu_torch.models import diffusion as td
from dadiff_tpu_torch.ops.projection import NormStats
from dadiff_tpu_torch.ops.schedules import make_schedule
from dadiff_tpu_torch.utils import training as tt

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "dadiff_tpu", ROOT / "dadiff_tpu_torch"

# JAX files none of whose names the port carries over, and why
FILES_NOT_PORTED = {
    "ops/pallas_kernels.py": "the Pallas K1 kernel: ported as CUDA in "
                             "ops/gn_mish.py (gn_mish, gn_mish_plain)",
    "ops/pallas_planner.py": "the Pallas K2 chain: ported as CUDA in "
                             "ops/planner.py (make_planner_chain, "
                             "make_bo_sampler, wire_policy_megakernel)",
    "ops/pallas_unet.py": "the Pallas K3 chain: ported as CUDA in "
                          "ops/chain.py (make_chain, chain_p_sample_loop)",
    "ops/pallas_resblock.py": "the Pallas K4 block: ported as CUDA in "
                              "ops/resblock.py (fused_residual_block, "
                              "residual_block_plain)",
    "io/checkpoints.py": "ROADMAP 'Not to port': orbax; the port writes .pt",
    "io/torch_rng.py": "ROADMAP 'Not to port': replays torch's draws for "
                       "JAX's noise hooks; the port draws with torch",
}

# JAX names without a same-named counterpart, and why
NAMES_NOT_PORTED = {
    "ConvTranspose1d": "a flax layer; the port uses torch.nn.ConvTranspose1d",
    "PallasGroupNormMish": "flax wrapper of K1; the port's Conv1dBlock calls "
                           "ops/gn_mish.py gn_mish",
    "GaussianDiffusion.apply": "flax's functional call; a torch module is "
                               "called (GaussianDiffusion.forward)",
    "GaussianDiffusion.init_params": "flax's functional init; torch modules "
                                     "own their parameters",
    "TemporalUnet.init_params": "flax's functional init",
    "TemporalTransformer.init_params": "flax's functional init",
    "ValueNet.init_params": "flax's functional init",
    "batch_sharding": "a jax.sharding object; the port slices rows "
                      "(parallel/mesh.py local_rows)",
    "replicated_sharding": "a jax.sharding object; the port replicates with "
                           "DTensor Replicate (parallel/tp.py "
                           "shard_params_tp)",
    "enable_compilation_cache": "XLA's compilation cache; the port builds "
                                "its CUDA libraries once per source hash "
                                "(ops/cuda_lib.py build_all)",
    "diffusion_state_to_flax": "a torch->flax converter; only tests move "
                               "weights between the packages",
    "flax_to_diffusion_state": "a flax->torch converter; the port's is "
                               "io/torch_compat.py params_from_jax",
    "flax_unet_params_to_torch_state": "as flax_to_diffusion_state",
    "torch_unet_state_to_flax": "a torch->flax converter",
    "extract": "under another name: models/diffusion.py _extract",
    "p_sample_loop": "the functional form of a scan; the loop is "
                     "GaussianDiffusion.p_sample_loop",
    "check_finite_pytree": "under another name: utils/debug.py check_finite",
    "tree_all_finite": "under another name: utils/debug.py all_finite",
    "to_jnp": "makes a jax.Array; the port's is utils/arrays.py "
              "batch_to_device",
}

# JAX command-line flags without a counterpart, and why
FLAGS_NOT_PORTED = {
    "--video-dir": "goes with --render video, which the port refuses: the "
                   "card's machine has no display (ROADMAP 'Not to port')",
}
SCRIPTS_NOT_PORTED = {
    "perf_probe.py": "ROADMAP 'Not to port': a TPU probe",
    "probe_planner_kernel.py": "ROADMAP 'Not to port': a TPU probe",
}


def _public_names(pkg: pathlib.Path, skip=()):
    """The names of every public top-level function and class and, as
    ``Class.method``, every public method of a top-level class."""
    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    out = set()
    for path in sorted(pkg.rglob("*.py")):
        if path.relative_to(pkg).as_posix() in skip:
            continue
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, defs) or node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{sub.name}" for sub in node.body
                        if isinstance(sub, defs[:2])
                        and not sub.name.startswith("_")}
    return out


def _flags(path: pathlib.Path):
    """The ``--flag`` strings of every ``add_argument`` call in a file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and a.value.startswith("--")}
    return out


def test_every_public_jax_name_has_a_counterpart_in_the_port():
    missing = (_public_names(JAX_PKG, skip=FILES_NOT_PORTED)
               - _public_names(PORT_PKG))
    listed = set(NAMES_NOT_PORTED)
    assert missing == listed, (
        f"without a counterpart: {sorted(missing - listed)}; "
        f"listed but ported: {sorted(listed - missing)}")
    for rel in FILES_NOT_PORTED:
        assert (JAX_PKG / rel).is_file(), rel
    assert all(NAMES_NOT_PORTED.values()) and all(FILES_NOT_PORTED.values())


def test_every_jax_flag_has_a_counterpart_in_the_port():
    """dadiff_tpu/cli.py against the port's cli.py, and each
    ``scripts/X.py`` against ``dadiff_tpu_torch/X.py`` (or the port's
    cli.py, which holds the parsers the scripts share)."""
    shared = _flags(PORT_PKG / "cli.py")
    pairs = [(JAX_PKG / "cli.py", PORT_PKG / "cli.py")]
    for script in sorted((ROOT / "scripts").glob("*.py")):
        if script.name.startswith("_") or script.name in SCRIPTS_NOT_PORTED:
            continue
        pairs.append((script, PORT_PKG / script.name))
    missing = set()
    for jax_file, port_file in pairs:
        assert port_file.is_file(), f"{jax_file.name} has no port module"
        missing |= {f"{jax_file.name} {f}" for f in
                    _flags(jax_file) - _flags(port_file) - shared
                    if f not in FLAGS_NOT_PORTED}
    assert not missing, sorted(missing)
    assert _flags(ROOT / "scripts/dryrun_multihost.py") <= _flags(
        PORT_PKG / "dryrun_multihost.py")
    assert all((ROOT / "scripts" / s).is_file() for s in SCRIPTS_NOT_PORTED)


def test_q_posterior_matches_jax():
    """The posterior mean and log-variance (diffusion.py:82-92), as a
    function and as the GaussianDiffusion method, for one t and for one t a
    row."""
    rng = np.random.RandomState(0)
    x0, xt = (rng.randn(4, 8, 6).astype(np.float32) for _ in range(2))
    sched = make_schedule(20, "cosine")
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    diff = td.GaussianDiffusion(TemporalUnet(6, dim=8, dim_mults=(1, 2)), 8,
                                4, 2, n_timesteps=20)
    for t in (np.int32(7), np.array([0, 5, 13, 19], np.int32)):
        want = jd.q_posterior(jax_schedule(20, "cosine"), jnp.asarray(x0),
                              jnp.asarray(xt), jnp.asarray(t))
        steps = torch.as_tensor(t).long()
        for got in (td.q_posterior(sched, torch.from_numpy(x0),
                                   torch.from_numpy(xt), steps),
                    diff.q_posterior(torch.from_numpy(x0),
                                     torch.from_numpy(xt), steps)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(
                    np.broadcast_to(g.numpy(), x0.shape),
                    np.broadcast_to(np.asarray(w), x0.shape),
                    rtol=1e-6, atol=1e-6)


def test_norm_stats_identity_matches_jax():
    want = JaxNormStats.identity(5, 3)
    got = NormStats.identity(5, 3)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert NormStats.identity(2, 1, dtype=torch.float64).obs_std.dtype == \
        torch.float64


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


def test_make_mppi_planner_takes_the_jax_signature():
    """The JAX builder's parameters in its order with its defaults
    (mppi_tpu.py:34-47), then the port's ``device``; ``jit=False`` drives
    every replan from the host. Its plans are held against JAX's in
    tests/test_torch_mppi.py."""
    assert _params(tm.make_mppi_planner)[:-1] == _params(jm.make_mppi_planner)
    assert _params(tm.make_mppi_planner)[-1][0] == "device"

    def step(o, a):
        return o + a.sum(-1, keepdim=True)

    def reward_done(o, nxt, a):
        return nxt[..., 0], torch.zeros_like(nxt[..., 0], dtype=torch.bool)

    plan = tm.make_mppi_planner(step, reward_done, act_dim=2, horizon=3,
                                n_samples=4, jit=False, device="cpu")
    assert isinstance(plan, tm.MPPIPlanner) and not plan.graph
    actions, mean = plan(torch.Generator().manual_seed(0),
                         torch.zeros(2, 1), torch.zeros(2, 3, 2))
    assert actions.shape == (2, 1, 2) and mean.shape == (2, 3, 2)


def test_create_trainer_with_custom_loss_takes_the_jax_signature(tmp_path):
    """The reference's factory (training.py:502-516): JAX's parameters and
    defaults, and a Trainer with the settings it was given that takes a
    step."""
    assert _params(tt.create_trainer_with_custom_loss) == \
        _params(jt.create_trainer_with_custom_loss)
    from dadiff_tpu_torch import losses
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    diff = td.GaussianDiffusion(TemporalUnet(6, dim=8, dim_mults=(1, 2)), 8,
                                4, 2, n_timesteps=10)
    loss_fn, names = losses.build_loss(diff)
    trainer = tt.create_trainer_with_custom_loss(
        diff, [None], loss_fn, scheduler=object(), device="cpu",
        log_dir=str(tmp_path), save_freq=7, eval_freq=0, ema_decay=0.9,
        gradient_clip=0.5, loss_names=names, export_pt=False)
    try:
        assert isinstance(trainer, tt.Trainer)
        assert (trainer.log_dir, trainer.save_freq, trainer.use_ema) == (
            str(tmp_path), 7, True)
        m = trainer.train_step({"conditions": torch.randn(4, 8, 6)})
        assert np.isfinite(m["total"]) and trainer.global_step == 1
    finally:
        trainer.close()
