"""The port's parallelism layer against the JAX package's
(tests/test_parallel.py, tests/test_distributed.py) and against its own
unsharded runs: the mesh helpers, the dp and FSDP train steps, the Trainer
and ``train --mesh-dp``, the batched planner, the three on-device
evaluators, Picard's time sharding and the multi-process dry run.

One spawn of two gloo ranks on the CPU (tests/torch_parallel_workers.py)
runs every case; each test reads its part. JAX runs in this process only.
"""

import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dadiff_tpu import losses as jl
from dadiff_tpu.models import diffusion as jd
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.utils import training as jt

import torch_parallel_workers as w
from torch_jax_models import seeded_params

from dadiff_tpu_torch import cli
from dadiff_tpu_torch.io.torch_compat import params_from_jax
from dadiff_tpu_torch.parallel import distributed

torch.set_num_threads(1)

DATASET = "synthetic:pointmaze:n=6,T=40"
CLI_ARGS = ["--dataset", DATASET, "--horizon", str(w.H), "--dim", "8",
            "--dim-mults", "1", "2", "--n-timesteps", "6", "--batch-size",
            "16", "--warmup-steps", "2", "--device", "cpu", "--log-freq", "1",
            "--n-epochs", "1", "--max-steps", "3", "--seed", "0",
            "--eval-freq", "0"]
LR, STEPS = 1e-3, 3


def _jax_unet(dim=8):
    return JaxUnet(transition_dim=w.D, dim=dim, dim_mults=(1, 2))


@functools.lru_cache(maxsize=None)
def _jax_params():
    return seeded_params(_jax_unet(), w.H, seed=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sgd_batch():
    rng = np.random.RandomState(0)
    return {"conditions": rng.randn(16, w.H, w.D).astype(np.float32),
            "t": rng.randint(0, 10, 16),
            "noise": rng.randn(16, w.H, w.D).astype(np.float32)}


class _JaxInjected(jl.BaseLoss):
    name = "diffusion"

    def __init__(self, diffusion):
        super().__init__(1.0)
        self.diffusion = diffusion

    def compute(self, params, batch, rng):
        return self.diffusion.loss(params, rng, batch["conditions"],
                                   t=batch["t"], noise=batch["noise"])


@functools.lru_cache(maxsize=None)
def _jax_sgd_step():
    """JAX's single-device SGD step (tests/test_parallel.py:68-106) on the
    injected draws: (loss, torch-named parameters)."""
    diff = jd.GaussianDiffusion(model=_jax_unet(), horizon=w.H,
                                observation_dim=w.OBS, action_dim=w.ACT,
                                n_timesteps=10)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    opt = optax.sgd(1e-2)
    step = jt.make_train_step(jl.ComposedLoss([_JaxInjected(diff)]), opt,
                              use_ema=False, donate=False)
    state = jt.TrainState(step=jnp.asarray(0), params=params,
                          opt_state=opt.init(params), ema_params=None)
    batch = {k: jnp.asarray(v) for k, v in _sgd_batch().items()}
    state, metrics = step(state, batch, jax.random.PRNGKey(1))
    return float(metrics["total"]), params_from_jax(_np_tree(state.params))


def _unet_state():
    return params_from_jax(_np_tree(_jax_params()))


def _resume_batches():
    rng = np.random.RandomState(4)
    return [{"conditions": torch.from_numpy(
        rng.randn(16, w.H, w.D).astype(np.float32))} for _ in range(4)]


def _unsharded_checkpoint(tmp: str) -> str:
    """An unsharded Trainer's checkpoint after the first half of the resume
    batches (path without extension)."""
    trainer = w.resume_trainer(_unet_state(), os.path.join(tmp, "unsharded"))
    w.resume_steps(trainer, _resume_batches()[:2])
    try:
        return trainer.save_checkpoint(epoch=3)
    finally:
        trainer.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.RandomState(3)
    inputs = {
        "resume_batches": _resume_batches(),
        "unet_other": w.seeded_state(w.unet_diffusion().model, 11),
        "unsharded_ckpt": _unsharded_checkpoint(tmp),
        "unet": _unet_state(),
        "sgd_batch": {k: torch.from_numpy(v) for k, v in _sgd_batch().items()},
        "cli_argv": CLI_ARGS + ["--log-dir", os.path.join(tmp, "cli2")],
        "unet_cheetah": w.seeded_state(
            w.unet_diffusion(transition=23, obs=17).model, 1),
        "cheetah_obs": (0.1 * rng.randn(4, 17)).astype(np.float32),
        "unet_hopper": w.seeded_state(
            w.unet_diffusion(transition=14, obs=11).model, 2),
        "hopper_obs": (0.1 * rng.randn(4, 11)).astype(np.float32),
        "picard_draws": (torch.from_numpy(rng.randn(2, w.H, w.D)
                                          .astype(np.float32)),
                         torch.from_numpy(rng.randn(10, 2, w.H, w.D)
                                          .astype(np.float32))),
    }
    return inputs, w.spawn("parallel", 2, inputs, tmp), tmp


def _assert_state_close(got, want, rtol=1e-4, atol=1e-6, noise=()):
    assert set(got) == set(want)
    for name in want:
        tol = STEPS * LR * 1.01 if name in noise else atol
        np.testing.assert_allclose(np.asarray(got[name]),
                                   np.asarray(want[name]), rtol=rtol,
                                   atol=tol, err_msg=name)


def _noise_leaves(state):
    """Parameters whose true gradient is zero (a conv bias feeding a
    GroupNorm of one channel a group): Adam turns their rounding noise into
    steps of about the learning rate either way, so the sharded and the
    unsharded runs may differ there by the summed learning rates. Picked by
    their gradient on a batch, below 1e-6 of the largest entry."""
    diff = w.unet_diffusion(state)
    b = _sgd_batch()
    diff.loss(torch.from_numpy(b["conditions"]), t=torch.from_numpy(b["t"]),
              noise=torch.from_numpy(b["noise"])).backward()
    g = {n: float(p.grad.abs().max()) for n, p in diff.model.named_parameters()}
    level = 1e-6 * max(g.values())
    return {n for n, v in g.items() if v <= level}


# ---------------------------------------------------------------------------
# process groups, meshes, batch rows
# ---------------------------------------------------------------------------

def test_initialize_distributed_is_a_noop_in_one_process(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary_host() is True
    assert distributed.local_device_count() == (
        torch.cuda.device_count() if torch.cuda.is_available() else 1)


def test_make_mesh_needs_a_process_group():
    from dadiff_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh({"dp": 1})


def test_mesh_shapes_and_batch_rows(ranks):
    _, outs, _ = ranks
    for rank, out in enumerate(outs):
        m = out["mesh"]
        assert m["default"] == {"dp": 2} and m["wildcard"] == {"dp": 1,
                                                               "mp": 2}
        assert m["refused"] == [{"dp": 3}, {"dp": -1, "x": -1}, "3 rows"]
        assert torch.equal(m["rows"], torch.arange(8.0).reshape(4, 2)
                           [2 * rank:2 * rank + 2])
        assert m["round_trip"]
        assert out["jax_modules"] == []  # the ranks import no JAX


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dp_step", "fsdp_step"])
def test_sharded_sgd_step_matches_jax_single_device(ranks, case):
    """dp (DDP) and FSDP2 over two ranks, each on its 8 rows, against JAX's
    one-device step on the 16 (tests/test_parallel.py:68-106): loss 1e-5
    relative, weights rtol 1e-4 / atol 1e-6, under SGD so that the update
    is the gradient itself."""
    _, outs, _ = ranks
    loss, want = _jax_sgd_step()
    for out in outs:
        assert out[case]["loss"] == pytest.approx(loss, rel=1e-5)
        _assert_state_close(out[case]["params"], want)


def test_fsdp_shards_every_parameter_on_dim_0(ranks):
    """FSDP2 shards every parameter on dim 0, rank 0 holding the first
    ceil(n/2) rows; each layer with a weight of 128 elements or more is a
    unit of its own, the rest belong to the root's."""
    _, outs, _ = ranks
    diff = w.unet_diffusion()
    names = dict(diff.model.named_parameters())
    for rank, out in enumerate(outs):
        placement = out["fsdp_step"]["placement"]
        assert set(placement) == set(names)
        for name, (kind, where, local) in placement.items():
            n = names[name].shape[0]
            own = min(max(n - rank * -(-n // 2), 0), -(-n // 2))
            assert kind == "DTensor" and where == ("Shard(dim=0)",), name
            assert local == (own,) + tuple(names[name].shape[1:]), name
        units = set(out["fsdp_step"]["units"])
        want = {""} | {n for n, mod in diff.model.named_modules() if any(
            p.numel() >= 128 for p in mod.parameters(recurse=False))}
        assert units == want


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_trainer_with_mesh_matches_the_unsharded_trainer(ranks, tmp_path,
                                                         kind):
    """Three Adam steps of Trainer(mesh=dp2), DDP or FSDP2, against the
    Trainer on one process: the losses, the weights and the EMA; rank 0
    alone logs, and its ``.pt`` loads with strict=True into a one-device
    module and holds the run's weights."""
    inputs, outs, tmp = ranks
    ref = w.trainer_run(inputs["unet"], str(tmp_path))
    noise = _noise_leaves(inputs["unet"])
    for out in outs:
        got = out[f"trainer/{kind}"]
        np.testing.assert_allclose(got["history"]["total"],
                                   ref["history"]["total"], rtol=1e-5)
        _assert_state_close(
            {k[len("model."):]: v for k, v in got["params"].items()
             if k.startswith("model.")},
            {k[len("model."):]: v for k, v in ref["params"].items()
             if k.startswith("model.")}, noise=noise)
        _assert_state_close({k[6:]: v for k, v in got["ema"].items()},
                            {k[6:]: v for k, v in ref["ema"].items()},
                            noise=noise)
    log_dir = os.path.join(tmp, f"trainer_{kind}")
    lines = open(os.path.join(log_dir, "training.log")).readlines()
    assert len(lines) == 1 and lines[0].startswith("Epoch 1:")
    ck = torch.load(os.path.join(log_dir, f"checkpoint_step_{STEPS}.pt"),
                    weights_only=False)
    diff = w.unet_diffusion()
    diff.load_state_dict(ck["model_state_dict"], strict=True)
    for k, v in diff.state_dict().items():
        assert torch.equal(v, outs[0][f"trainer/{kind}"]["params"][k]), k


def _assert_train_states_equal(got, want):
    """Two ``train_state`` records equal bit for bit."""
    for part in ("params", "ema"):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    assert set(got["adam"]) == set(want["adam"])
    for i, moments in want["adam"].items():
        for k, v in moments.items():
            assert torch.equal(got["adam"][i][k], v), ("adam", i, k)
    assert (got["step"], got["n_updates"]) == (want["step"], want["n_updates"])
    for a, b in zip(got["generators"], want["generators"]):
        assert torch.equal(a, b)


def test_fsdp_run_resumes_bit_for_bit(ranks):
    """FSDP2 over two ranks: N steps, a checkpoint, a fresh Trainer (other
    initial weights) that resumes and takes N more, against 2N steps
    straight: every loss, weight, EMA leaf, Adam moment, counter and
    generator state equal bit for bit on both ranks."""
    _, outs, _ = ranks
    for out in outs:
        r = out["resume"]
        assert r["resumed"]["epoch"] == 3
        assert r["resumed"]["losses"] == r["straight"]["losses"]
        _assert_train_states_equal(r["resumed"]["state"],
                                   r["straight"]["state"])


def _file_state(base: str):
    """A ``.train.pt`` read as a ``train_state`` record."""
    ck = torch.load(base + ".train.pt", weights_only=False)
    return ck, {"params": ck["model_state_dict"], "ema": ck["ema_params"],
                "adam": ck["optimizer_state_dict"]["state"],
                "step": ck["step"], "n_updates": ck["n_updates"],
                "generators": ck["generator_states"]}


@pytest.mark.parametrize("direction", ["unsharded->fsdp", "fsdp->unsharded"])
def test_train_pt_crosses_between_fsdp_and_unsharded_runs(ranks, tmp_path,
                                                          direction):
    """A ``.train.pt`` is the same file whether the run was sharded: whole
    tensors, Adam's state keyed as ``Optimizer.state_dict`` keys it. An
    FSDP Trainer loads an unsharded run's checkpoint, and an unsharded
    Trainer an FSDP run's, to the bit; each then takes the last N steps,
    which equal the run that did not stop within the tolerances of
    ``test_trainer_with_mesh_matches_the_unsharded_trainer``."""
    inputs, outs, _ = ranks
    batches = inputs["resume_batches"]
    ref = w.resume_trainer(inputs["unet"], str(tmp_path / "straight"))
    ref_losses = w.resume_steps(ref, batches)
    ref_state = w.train_state(ref)
    ref.close()
    fsdp_ck, fsdp_file = _file_state(outs[0]["resume"]["fsdp_ckpt"])
    plain_ck, plain_file = _file_state(inputs["unsharded_ckpt"])
    assert fsdp_ck.keys() == plain_ck.keys()
    assert fsdp_ck["optimizer_state_dict"]["param_groups"] == \
        plain_ck["optimizer_state_dict"]["param_groups"]
    for i, moments in plain_file["adam"].items():
        for k, v in moments.items():
            assert fsdp_file["adam"][i][k].shape == v.shape, (i, k)
    if direction == "unsharded->fsdp":
        runs = [(out["resume"]["from_unsharded"]["loaded"],
                 out["resume"]["from_unsharded"]["losses"],
                 out["resume"]["from_unsharded"]["state"]) for out in outs]
        file = plain_file
    else:
        trainer = w.resume_trainer(inputs["unet_other"],
                                   str(tmp_path / "resumed"))
        assert trainer.load_checkpoint(outs[0]["resume"]["fsdp_ckpt"]) == 3
        loaded = w.train_state(trainer)
        losses = w.resume_steps(trainer, batches[2:])
        runs = [(loaded, losses, w.train_state(trainer))]
        trainer.close()
        file = fsdp_file
    noise = _noise_leaves(inputs["unet"])
    for loaded, losses, state in runs:
        _assert_train_states_equal(loaded, file)
        np.testing.assert_allclose(losses, ref_losses[2:], rtol=1e-5)
        for part in ("params", "ema"):
            _assert_state_close(
                {k[6:]: v for k, v in state[part].items()
                 if k.startswith("model.")},
                {k[6:]: v for k, v in ref_state[part].items()
                 if k.startswith("model.")}, noise=noise)


def test_train_mesh_dp_2_matches_mesh_dp_1(ranks, tmp_path):
    """``train --mesh-dp 2`` in a world of two against ``--mesh-dp 1``: the
    logged losses and the exported ``.pt``, which loads with strict=True
    into a single-device module."""
    inputs, outs, _ = ranks
    log1 = cli.train_main(CLI_ARGS + ["--mesh-dp", "1", "--log-dir",
                                      str(tmp_path)])
    log2 = outs[0]["cli_log_dir"]
    assert outs[1]["cli_log_dir"] == log2

    def series(log):
        return [json.loads(l) for l in open(f"{log}/metrics.jsonl")]

    (s1,), (s2,) = series(log1), series(log2)
    assert s2["step"] == s1["step"] == STEPS
    np.testing.assert_allclose(s2["total_series"], s1["total_series"],
                               rtol=1e-5)
    ck1 = torch.load(f"{log1}/checkpoint_step_{STEPS}.pt", weights_only=False)
    ck2 = torch.load(f"{log2}/checkpoint_step_{STEPS}.pt", weights_only=False)
    noise = {f"model.{n}" for n in _noise_leaves(inputs["unet"])}
    _assert_state_close(ck2["model_state_dict"], ck1["model_state_dict"],
                        noise=noise)
    diff, _ = cli.load_model(f"{log2}/checkpoint_step_{STEPS}.pt", DATASET,
                             device="cpu")
    assert diff.model.dim == 8
    assert len(glob.glob(f"{log2}/checkpoint_step_*.pt")) == 2  # .pt + .train.pt


def test_mesh_dp_without_its_world_names_torchrun():
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        cli.train_main(CLI_ARGS + ["--mesh-dp", "2", "--log-dir", "/nonexistent"])
    assert cli.build_train_parser().parse_args([]).mesh_dp == 1


# ---------------------------------------------------------------------------
# planning and evaluation under the mesh
# ---------------------------------------------------------------------------

def test_batched_planner_matches_the_sampler(ranks):
    """1 x 32 chains over two ranks against ``make_sampler`` on one process
    (tests/test_parallel.py:110-145), the same generator seed."""
    from dadiff_tpu_torch.guides.sampling import make_sampler

    inputs, outs, _ = ranks
    diff = w.unet_diffusion(inputs["unet"])
    want = make_sampler(diff, sampling_timesteps=5)(
        torch.Generator().manual_seed(2), w.planner_conditions(32))
    for out in outs:
        assert out["planner"].shape == (32, w.H, w.D)
        np.testing.assert_allclose(out["planner"].numpy(), want.numpy(),
                                   atol=1e-5)
    np.testing.assert_allclose(want[:, 0, :w.OBS].numpy(),
                               w.planner_conditions(32).values[:, 0, :w.OBS]
                               .numpy(), atol=1e-6)


def test_pointmaze_evaluator_under_a_mesh_matches_unsharded(ranks):
    inputs, outs, _ = ranks
    want = w.as_numpy(w.pointmaze_run(w.unet_diffusion(inputs["unet"])))
    for out in outs:
        got = w.as_numpy(out["pointmaze"])
        for part in ("metrics", "state"):
            for k, v in want[part].items():
                np.testing.assert_allclose(got[part][k], v, rtol=1e-4,
                                           atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["physics", "learned"])
def test_locomotion_evaluators_under_a_mesh_match_unsharded(ranks, case):
    """The exact-physics (HalfCheetah, search model) and the learned
    (Hopper) evaluators over two ranks: the mean return, the mean length
    and every env's return of the unsharded run."""
    inputs, outs, _ = ranks
    if case == "physics":
        want = w.physics_run(inputs["unet_cheetah"], inputs["cheetah_obs"])
    else:
        want = w.learned_run(inputs["unet_hopper"], inputs["hopper_obs"])
    for out in outs:
        for got, ref in zip(out[case], want):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                       atol=1e-5)
        assert out[case][2].shape == (4,)


def test_time_shard_axis_matches_the_plain_picard_chain(ranks):
    """Each sweep's 4 x 2 window rows split over the two ranks: the chain
    of the unsharded Picard loop (parallel_sampling.py:106-112)."""
    inputs, outs, _ = ranks
    want = w.picard_run(w.unet_diffusion(inputs["unet"]),
                        inputs["picard_draws"])
    for out in outs:
        np.testing.assert_allclose(out["picard"].numpy(), want.numpy(),
                                   atol=1e-5)


def test_dryrun_multihost():
    """Two processes join through ``initialize_distributed`` and take the
    real train step, each on its rows: the single-process loss."""
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "-m",
                        "dadiff_tpu_torch.dryrun_multihost", "--device",
                        "cpu"],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK multihost dryrun" in r.stdout
