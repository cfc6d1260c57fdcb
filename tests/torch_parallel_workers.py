"""The ranks of the port's parallel tests (tests/test_torch_parallel.py,
tests/test_torch_tensor_parallel.py, tests/test_torch_eval.py).

:func:`spawn` starts ``world`` CPU processes that join one gloo process
group through a file in a temporary directory (no port for pytest-xdist
workers to collide on), each runs one suite of cases on the inputs the test
wrote, and the results of every rank come back. The workers import torch and
the port only, never JAX: the tests hold the results against JAX in their
own process. Every case builds its models from the inputs' state dicts, so
the ranks and the test start from the same weights.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.multiprocessing as mp

from dadiff_tpu_torch import losses

H, OBS, ACT = 8, 6, 2
D = OBS + ACT
SPAWN_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------


def spawn(suite: str, world: int, inputs: Dict[str, Any], tmp: str
          ) -> List[Dict[str, Any]]:
    """Run ``suite`` on ``world`` gloo ranks; returns each rank's results.
    Fails, after stopping every rank, when one raises or the run passes
    ``SPAWN_TIMEOUT_S``."""
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    ctx = mp.start_processes(_entry, args=(world, tmp, suite), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{suite} ranks still running after "
                                   f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank: int, world: int, tmp: str, suite: str) -> None:
    import sys

    import torch.distributed as dist

    from dadiff_tpu_torch.parallel.distributed import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}",
                           rank=rank, world_size=world, device="cpu")
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"),
                            weights_only=False)
        out = SUITES[suite](rank, inputs, tmp)
        # what the rank imported of JAX, flax, optax or the JAX package
        out["jax_modules"] = sorted(
            m for m in sys.modules if m.split(".")[0] in (
                "jax", "jaxlib", "flax", "optax", "dadiff_tpu"))
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# models and losses shared with the tests
# ---------------------------------------------------------------------------


def unet_diffusion(state=None, *, dim=8, mults=(1, 2), horizon=H,
                   transition=D, obs=OBS, n_timesteps=10, act_spec=None):
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    unet = TemporalUnet(transition, dim=dim, dim_mults=mults,
                        act_spec=act_spec)
    if state is not None:
        unet.load_state_dict(state, strict=True)
    return GaussianDiffusion(unet, horizon, obs, transition - obs,
                             n_timesteps=n_timesteps)


def transformer(state, act_spec=None, dim=32, depth=2, n_heads=4):
    from dadiff_tpu_torch.models.temporal_transformer import (
        TemporalTransformer,
    )

    model = TemporalTransformer(D, dim=dim, depth=depth, n_heads=n_heads,
                                act_spec=act_spec)
    model.load_state_dict(state, strict=True)
    return model


class Injected(losses.BaseLoss):
    """The diffusion loss with ``t`` and ``noise`` taken from the batch."""

    name = "diffusion"

    def __init__(self, diffusion):
        super().__init__(1.0)
        self.diffusion = diffusion

    def compute(self, batch, generator):
        return self.diffusion.loss(batch["conditions"], t=batch["t"],
                                   noise=batch["noise"])


def sgd_step(diffusion, batch, *, objective=None, clip=0.0, after=None):
    """One train step of ``make_train_step`` under SGD(1e-2) on the batch's
    injected draws; returns the metrics."""
    from dadiff_tpu_torch.utils import training as tt

    state = tt.TrainState(
        module=diffusion,
        optimizer=torch.optim.SGD(diffusion.parameters(), lr=1e-2),
        ema_params=None)
    step = tt.make_train_step(
        objective or losses.ComposedLoss([Injected(diffusion)]),
        lr_schedule=lambda _: 1e-2, gradient_clip=clip, use_ema=False,
        after_backward=after)
    return step(state, batch, [None])


def stats_identity(obs=OBS, act=ACT):
    from dadiff_tpu_torch.ops.projection import NormStats

    return NormStats(torch.zeros(obs), torch.ones(obs), torch.zeros(act),
                     torch.ones(act))


def pointmaze_run(diffusion, mesh=None):
    """The PointMaze evaluator, two candidates a replan: (metrics, state)."""
    from dadiff_tpu_torch.envs.pointmaze_jax import PointMazeJax
    from dadiff_tpu_torch.envs.rollout import make_ondevice_evaluator

    ev = make_ondevice_evaluator(
        diffusion, PointMazeJax(), action_horizon=4, n_replans=2,
        sampling_timesteps=5, n_candidates=2, mesh=mesh)
    metrics, state = ev(torch.Generator().manual_seed(1), stats_identity(), 8)
    return {"metrics": metrics._asdict(), "state": state._asdict()}


def physics_run(state, init_obs, mesh=None):
    from dadiff_tpu_torch.envs.locomotion_jax import (
        HalfCheetahJax,
        make_physics_locomotion_evaluator,
    )

    diff = unet_diffusion(state, transition=23, obs=17)
    ev = make_physics_locomotion_evaluator(
        diff, HalfCheetahJax(solver_iters=15, solver="jacobi",
                             search_model=True),
        action_horizon=2, n_replans=2, sampling_timesteps=5, mesh=mesh)
    return ev(torch.Generator().manual_seed(7), stats_identity(17, 6),
              torch.from_numpy(init_obs))


def learned_run(state, init_obs, mesh=None):
    from dadiff_tpu_torch.envs.learned_model import (
        DynamicsMLP,
        ModelStats,
        hopper_reward_done,
        make_ondevice_locomotion_evaluator,
    )

    diff = unet_diffusion(state, transition=14, obs=11)
    model = DynamicsMLP(11, 3, (16, 16), seed=1)
    zeros, ones = torch.zeros(11), torch.ones(11)
    stats = ModelStats(zeros, ones, torch.zeros(3), torch.ones(3),
                       zeros, 0.1 * ones)
    ev = make_ondevice_locomotion_evaluator(
        diff, model, stats, hopper_reward_done, action_horizon=2,
        n_replans=2, sampling_timesteps=5, mesh=mesh)
    return ev(torch.Generator().manual_seed(8), stats_identity(11, 3),
              torch.from_numpy(init_obs))


def planner_conditions(n: int):
    from dadiff_tpu_torch.guides.sampling import conditions_for_initial_obs

    obs = torch.linspace(-1, 1, OBS)[None].repeat(n, 1)
    return conditions_for_initial_obs(obs, OBS, H, D)


def picard_run(diffusion, draws, mesh=None, axis=None):
    from dadiff_tpu_torch.models.parallel_sampling import parallel_sample_loop

    init, noise = draws
    return parallel_sample_loop(
        diffusion, diffusion.schedule, tuple(init.shape), window=4, tol=0.0,
        init_noise=init, step_noise=noise, time_shard_axis=axis, mesh=mesh)


def trainer_run(state, log_dir: str, mesh=None, steps: int = 3,
                fsdp_axis=None):
    """Three Adam steps of the Trainer over a synthetic dataset of 16-row
    batches: (history, final weights, EMA); the exported ``.pt`` in
    ``log_dir``."""
    from dadiff_tpu_torch.datasets.sequence import (
        SequenceDataset,
        create_dataloader,
    )
    from dadiff_tpu_torch.utils.training import Trainer

    diff = unet_diffusion(state)
    ds = SequenceDataset("synthetic:pointmaze:n=6,T=40", horizon=H)
    loader = create_dataloader(ds, batch_size=16, seed=0)
    loss_fn, names = losses.build_loss(diff)
    trainer = Trainer(diff, loader, loss_fn, lr=1e-3, log_dir=log_dir,
                      save_freq=0, log_freq=1, loss_names=names, seed=5,
                      mesh=mesh, fsdp_axis=fsdp_axis)
    try:
        history = trainer.train(1, max_steps=steps)
    finally:
        trainer.close()
    from dadiff_tpu_torch.parallel.mesh import full_state_dict

    return {"history": history,
            "params": full_state_dict(diff.state_dict()),
            "ema": full_state_dict(trainer.state.ema_params)}


def resume_trainer(state, log_dir: str, mesh=None, fsdp_axis=None):
    """A Trainer of Adam(1e-3), clip 1, EMA, no files but its checkpoints,
    over the U-Net of ``state``; it is driven batch by batch with
    :func:`resume_steps`."""
    from dadiff_tpu_torch.utils.training import Trainer

    diff = unet_diffusion(state)
    loss_fn, names = losses.build_loss(diff)
    return Trainer(diff, [None], loss_fn, lr=1e-3, log_dir=log_dir,
                   save_freq=0, loss_names=names, seed=5, export_pt=False,
                   mesh=mesh, fsdp_axis=fsdp_axis)


def resume_steps(trainer, batches, mesh=None):
    from dadiff_tpu_torch.parallel.mesh import local_rows

    return [trainer.train_step(local_rows(b, mesh))["total"]
            for b in batches]


def train_state(trainer) -> Dict[str, Any]:
    """Everything a ``.train.pt`` restores, whole and copied: the weights,
    the EMA, Adam's moments and step, the counters and the generators'
    states. Every rank calls it (it gathers)."""
    from dadiff_tpu_torch.parallel.mesh import full_state_dict

    def whole(state):
        return {k: v.clone() for k, v in full_state_dict(state).items()}

    opt = trainer.state.optimizer.state_dict()["state"]
    return {"params": whole(trainer.diffusion.state_dict()),
            "ema": whole(trainer.state.ema_params),
            "adam": {i: whole(s) for i, s in opt.items()},
            "step": trainer.state.step, "n_updates": trainer.state.n_updates,
            "generators": [g.get_state() for g in trainer.generators]}


def fsdp_resume_runs(inputs, tmp: str, mesh) -> Dict[str, Any]:
    """FSDP2 over dp: 2N steps straight; N steps, a checkpoint, a fresh
    Trainer (other initial weights) that resumes from it and takes N more;
    a fresh Trainer that resumes from an unsharded run's checkpoint after N
    steps and takes N more. Each resumed Trainer's state right after
    loading, and every run's losses and final state."""
    batches = inputs["resume_batches"]
    n = len(batches) // 2
    out = {}
    straight = resume_trainer(inputs["unet"], os.path.join(tmp, "straight"),
                              mesh, "dp")
    out["straight"] = {"losses": resume_steps(straight, batches, mesh),
                       "state": train_state(straight)}
    log_dir = os.path.join(tmp, "resume_fsdp")
    part = resume_trainer(inputs["unet"], log_dir, mesh, "dp")
    first = resume_steps(part, batches[:n], mesh)
    part.save_checkpoint(epoch=3)
    for name, path in (("resumed", None),
                       ("from_unsharded", inputs["unsharded_ckpt"])):
        trainer = resume_trainer(inputs["unet_other"], log_dir, mesh, "dp")
        epoch = (trainer.load_latest() if path is None
                 else trainer.load_checkpoint(path))
        loaded = train_state(trainer)
        losses = resume_steps(trainer, batches[n:], mesh)
        out[name] = {"epoch": epoch, "loaded": loaded,
                     "losses": (first if path is None else []) + losses,
                     "state": train_state(trainer)}
        trainer.close()
    straight.close()
    part.close()
    out["fsdp_ckpt"] = os.path.join(log_dir, f"checkpoint_step_{n}")
    return out


# ---------------------------------------------------------------------------
# the suites
# ---------------------------------------------------------------------------


def parallel_suite(rank: int, inputs, tmp: str) -> Dict[str, Any]:
    """Two ranks: the mesh helpers, the dp and FSDP steps, the Trainer and
    ``train --mesh-dp 2``, the batched planner, the three evaluators and
    Picard's time sharding."""
    from torch.distributed.tensor import DTensor
    from torch.nn.parallel import DistributedDataParallel

    from dadiff_tpu_torch import cli
    from dadiff_tpu_torch.parallel.mesh import (
        all_reduce_mean,
        full_state_dict,
        gather_rows,
        local_rows,
        make_mesh,
        shard_params_fsdp,
    )
    from dadiff_tpu_torch.parallel.planner import make_batched_planner
    from dadiff_tpu_torch.utils.training import _Objective

    out: Dict[str, Any] = {}
    mesh = make_mesh()
    refused = []
    for axes in ({"dp": 3}, {"dp": -1, "x": -1}):
        try:
            make_mesh(axes)
        except ValueError:
            refused.append(axes)
    try:
        local_rows(torch.zeros(3), mesh)
    except ValueError:
        refused.append("3 rows")
    x = torch.arange(8.0).reshape(4, 2)
    out["mesh"] = {
        "default": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        "wildcard": dict(zip(("dp", "mp"), make_mesh({"dp": 1, "mp": -1})
                             .mesh.shape)),
        "refused": refused,
        "rows": local_rows(x, mesh),
        "round_trip": bool(torch.equal(gather_rows(local_rows(x, mesh), mesh),
                                       x)),
    }

    # the dp step: DDP over the Trainer's objective
    batch = local_rows(inputs["sgd_batch"], mesh)
    diff = unet_diffusion(inputs["unet"])
    objective = DistributedDataParallel(
        _Objective(diff, losses.ComposedLoss([Injected(diff)])),
        process_group=mesh.get_group("dp"))
    m = all_reduce_mean(sgd_step(diff, batch, objective=objective), mesh)
    out["dp_step"] = {"loss": float(m["total"]),
                      "params": full_state_dict(diff.model.state_dict())}

    # FSDP2 over dp: which parameters are sharded, and the same step
    diff = unet_diffusion(inputs["unet"])
    shard_params_fsdp(diff.model, mesh, min_elements=128)
    placement = {n: (type(p).__name__, tuple(repr(q) for q in p.placements),
                     tuple(p.to_local().shape))
                 for n, p in diff.model.named_parameters()
                 if isinstance(p, DTensor)}
    units = [n for n, mod in diff.model.named_modules()
             if type(mod).__name__.startswith("FSDP")]
    m = all_reduce_mean(sgd_step(diff, batch), mesh)
    out["fsdp_step"] = {"loss": float(m["total"]), "placement": placement,
                        "units": units,
                        "params": full_state_dict(diff.model.state_dict())}

    # FSDP runs that resume, and cross to and from unsharded runs
    out["resume"] = fsdp_resume_runs(inputs, tmp, mesh)

    # the Trainer and the train CLI under the mesh
    out["trainer/ddp"] = trainer_run(inputs["unet"],
                                     os.path.join(tmp, "trainer_ddp"), mesh)
    out["trainer/fsdp"] = trainer_run(
        inputs["unet"], os.path.join(tmp, "trainer_fsdp"), mesh,
        fsdp_axis="dp")
    out["cli_log_dir"] = cli.train_main(inputs["cli_argv"] + ["--mesh-dp",
                                                               "2"])

    # the batched planner and the evaluators, against their unsharded runs
    diff = unet_diffusion(inputs["unet"])
    planner = make_batched_planner(diff, mesh, sampling_timesteps=5)
    out["planner"] = gather_rows(planner(torch.Generator().manual_seed(2),
                                         planner_conditions(32)), mesh)
    out["pointmaze"] = pointmaze_run(diff, mesh)
    out["physics"] = physics_run(inputs["unet_cheetah"], inputs["cheetah_obs"],
                                 mesh)
    out["learned"] = learned_run(inputs["unet_hopper"], inputs["hopper_obs"],
                                 mesh)
    out["picard"] = picard_run(diff, inputs["picard_draws"], mesh, "dp")
    return out


def rollout_suite(rank: int, inputs, tmp: str) -> Dict[str, Any]:
    """Two ranks: the PointMaze evaluator's module path under a mesh."""
    from dadiff_tpu_torch.parallel.mesh import make_mesh

    diff = unet_diffusion(inputs["unet"], n_timesteps=inputs["n_timesteps"])
    return pointmaze_run(diff, make_mesh())


TP_MESHES = {
    "tp": ({"dp": 2, "tp": 2}, ("dp", None, "tp")),
    "sp": ({"dp": 2, "sp": 2}, ("dp", "sp", None)),
    "sp-tp": ({"sp": 2, "tp": 2}, ("dp", "sp", "tp")),
    # 2-D parameter sharding: tp x fsdp, and fsdp beside dp
    "fsdp-tp": ({"fsdp": 2, "tp": 2}, ("dp", None, "tp")),
    "dp-fsdp": ({"dp": 2, "fsdp": 2}, ("dp", None, None)),
}
TP_TRAIN = ("tp", "sp-tp", "fsdp-tp", "dp-fsdp")


def tp_suite(rank: int, inputs, tmp: str) -> Dict[str, Any]:
    """Four ranks: the tp, sp, tp+sp and 2-D (tp x fsdp, dp x fsdp)
    forwards of both families, with their collectives; their train steps;
    the batched planner over a tp U-Net."""
    from dadiff_tpu_torch.parallel.comm_analysis import (
        CollectiveCounter,
        weight_gather_violations,
    )
    from dadiff_tpu_torch.parallel.mesh import (
        all_reduce_mean,
        full_state_dict,
        gather_rows,
        local_rows,
        make_mesh,
    )
    from dadiff_tpu_torch.parallel.planner import make_batched_planner
    from dadiff_tpu_torch.parallel.tp import average_grads, shard_params_tp

    out: Dict[str, Any] = {}
    x, t = inputs["x"], inputs["t"]
    for name, (axes, spec) in TP_MESHES.items():
        mesh = make_mesh(axes)
        for family in ("unet", "transformer"):
            if family == "unet":
                model = unet_diffusion(inputs["unet32"], dim=32,
                                       horizon=16, act_spec=spec).model
            else:
                model = transformer(inputs["transformer"], act_spec=spec)
            shard_params_tp(model, mesh, fsdp_axis="fsdp")
            with torch.no_grad(), CollectiveCounter() as counter:
                y = model(*local_rows((x, t), mesh))
            whole = inputs["unet32"] if family == "unet" else \
                inputs["transformer"]
            out[f"{family}/{name}"] = {
                "out": gather_rows(y, mesh),
                "summary": counter.summary,
                "violations": weight_gather_violations(counter.summary,
                                                       whole)}

    for name in TP_TRAIN:
        axes, spec = TP_MESHES[name]
        mesh = make_mesh(axes)
        diff = unet_diffusion(inputs["unet32"], dim=32, horizon=16,
                              act_spec=spec)
        shard_params_tp(diff.model, mesh, fsdp_axis="fsdp")
        local = {n: tuple(p.to_local().shape)
                 for n, p in diff.model.named_parameters()}
        with CollectiveCounter() as counter:
            m = sgd_step(diff, local_rows(inputs["tp_batch"], mesh), clip=4.0,
                         after=lambda: average_grads(diff, mesh, "dp"))
        m = all_reduce_mean(m, mesh)
        out[f"train/{name}"] = {
            "loss": float(m["total"]), "grad_norm": float(m["grad_norm"]),
            "params": full_state_dict(diff.model.state_dict()),
            "local_shapes": local,
            "summary": counter.summary,
            "violations": weight_gather_violations(counter.summary,
                                                   inputs["unet32"])}

    axes, spec = TP_MESHES["tp"]
    mesh = make_mesh(axes)
    diff = unet_diffusion(inputs["unet32"], dim=32, horizon=16, act_spec=spec)
    shard_params_tp(diff.model, mesh)
    planner = make_batched_planner(diff, mesh)
    from dadiff_tpu_torch.guides.sampling import conditions_for_initial_obs

    cond = conditions_for_initial_obs(
        torch.linspace(-1, 1, OBS)[None].repeat(8, 1), OBS, 16, D)
    out["planner"] = gather_rows(
        planner(torch.Generator().manual_seed(7), cond), mesh)
    return out


SUITES = {"parallel": parallel_suite, "rollout": rollout_suite,
          "tp": tp_suite}


def as_numpy(tree):
    """Tensors of a result tree as numpy arrays."""
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_numpy(v) for v in tree)
    return tree.detach().numpy() if torch.is_tensor(tree) else tree


def seeded_state(module, seed: int) -> Dict[str, torch.Tensor]:
    """Every parameter of ``module`` drawn from ``seed``: normal with
    deviation 1/sqrt(fan-in), GroupNorm weights 1 + normal(0.1), biases
    normal(0.1); every leaf nonzero."""
    rng = np.random.RandomState(seed)
    state = {}
    for name, p in module.state_dict().items():
        if name.endswith("bias"):
            v = 0.1 * rng.randn(*p.shape)
        elif p.dim() == 1:
            v = 1.0 + 0.1 * rng.randn(*p.shape)
        else:
            v = rng.randn(*p.shape) / np.sqrt(max(p[0].numel(), 1))
        state[name] = torch.tensor(v, dtype=torch.float32)
    return state
