"""Multi-device dry run of the parallelism layer: one process per device.

The port's counterpart of the JAX package's ``dryrun_multichip`` function
(its record on a TPU slice is ``MULTICHIP_r05.json``). ``--nproc N``
processes join one process group (NCCL over the cards, or gloo with
``--device cpu``) and run its four legs at tiny widths:

  1. a dp x fsdp train step (``{'dp': N/2, 'fsdp': 2}`` for an even N >= 4,
     else ``{'dp': N}``): ``Trainer(mesh=, fsdp_axis=)``, clip 1.0, EMA;
  2. the batched planner (``parallel.planner.make_batched_planner``) on
     the trained weights, two chains per dp rank;
  3. the exact-physics HalfCheetah plan -> step -> replan loop under the
     mesh (``envs/locomotion_jax.py``, the search model, Jacobi);
  4. for N divisible by 4, a dp x sp x tp train step (``{'dp': N/4, 'sp':
     2, 'tp': 2}``) of a U-Net with ``act_spec`` ('dp', 'sp', 'tp').

Every rank must reach finite losses and returns, and the ranks must agree.

    python -m dadiff_tpu_torch.dryrun_multichip --nproc 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile


def _diffusion(transition_dim: int, obs_dim: int, act_dim: int, horizon: int,
               seed: int, **unet_kw):
    import torch

    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    torch.manual_seed(seed)
    return GaussianDiffusion(
        TemporalUnet(transition_dim, dim=16, dim_mults=(1, 2), **unet_kw),
        horizon, observation_dim=obs_dim, action_dim=act_dim, n_timesteps=10)


def _agree(value: float, mesh) -> float:
    """``value``, after checking that every rank holds the same."""
    import torch
    import torch.distributed as dist

    from dadiff_tpu_torch.parallel.distributed import mesh_device

    t = torch.tensor([value, -value], device=mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if not (abs(float(t[0]) - value) < 1e-6
            and abs(float(-t[1]) - value) < 1e-6):
        raise RuntimeError(f"ranks disagree: {value} vs max {float(t[0])} "
                           f"min {float(-t[1])}")
    if value != value or abs(value) == float("inf"):
        raise RuntimeError(f"non-finite value {value}")
    return value


def _legs(rank: int, nproc: int, init: str, device: str, log_dir: str):
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from dadiff_tpu_torch.envs.locomotion_jax import (
        HalfCheetahJax,
        make_physics_locomotion_evaluator,
    )
    from dadiff_tpu_torch.guides.sampling import conditions_for_initial_obs
    from dadiff_tpu_torch.losses import build_loss
    from dadiff_tpu_torch.ops.projection import NormStats
    from dadiff_tpu_torch.parallel.distributed import (
        initialize_distributed,
        mesh_device,
    )
    from dadiff_tpu_torch.parallel.mesh import (
        all_reduce_mean,
        batch_rows,
        local_rows,
        make_mesh,
    )
    from dadiff_tpu_torch.parallel.planner import make_batched_planner
    from dadiff_tpu_torch.parallel.tp import average_grads, shard_params_tp
    from dadiff_tpu_torch.utils.training import (
        EMA,
        TrainState,
        Trainer,
        make_optimizer,
        make_train_step,
        warmup_cosine_schedule,
    )

    initialize_distributed(init, rank=rank, world_size=nproc, device=device)
    try:
        # 1. dp x fsdp train step
        axes = ({"dp": nproc // 2, "fsdp": 2} if nproc % 2 == 0
                and nproc >= 4 else {"dp": nproc})
        mesh = make_mesh(axes)
        dev = mesh_device(mesh)
        diffusion = _diffusion(8, 6, 2, 16, seed=0).to(dev)
        loss_fn, names = build_loss(diffusion)
        batch = {"conditions": np.random.RandomState(0).randn(
            axes["dp"] * 2, 16, 8).astype(np.float32)}
        trainer = Trainer(
            diffusion, [batch], loss_fn, lr=1e-3, gradient_clip=1.0,
            log_dir=log_dir, save_freq=0, loss_names=names, export_pt=False,
            mesh=mesh, fsdp_axis="fsdp" if "fsdp" in axes else None)
        rows = local_rows(batch, mesh)
        loss = _agree(trainer.train_step(
            {k: torch.from_numpy(v).to(dev) for k, v in rows.items()})["total"],
            mesh)
        trainer.close()
        if trainer.state.step != 1:
            raise RuntimeError(f"step {trainer.state.step} after one step")

        # 2. the batched planner on the trained weights
        n_plans = axes["dp"] * 2
        planner = make_batched_planner(diffusion, mesh)
        cond = conditions_for_initial_obs(torch.zeros(n_plans, 6, device=dev),
                                          6, 16, 8)
        traj = planner(torch.Generator(dev).manual_seed(3), cond)
        if traj.shape != (2, 16, 8) or not bool(torch.isfinite(traj).all()):
            raise RuntimeError(f"plan {tuple(traj.shape)} not finite")

        # 3. the exact-physics loop under the mesh
        env = HalfCheetahJax(solver_iters=15, solver="jacobi",
                             search_model=True)
        diff_l = _diffusion(23, 17, 6, 8, seed=6).to(dev)
        stats = NormStats(torch.zeros(17, device=dev),
                          torch.ones(17, device=dev),
                          torch.zeros(6, device=dev),
                          torch.ones(6, device=dev))
        ev = make_physics_locomotion_evaluator(
            diff_l, env, action_horizon=2, n_replans=2, mesh=mesh,
            graph=False)
        ret, _, _ = ev(torch.Generator(dev).manual_seed(7), stats,
                       torch.zeros(axes["dp"] * 2, 17, device=dev))
        ret = _agree(float(ret), mesh)
        msg = (f"dryrun_multichip OK: mesh={axes} loss={loss:.4f} "
               f"plan=({n_plans}, 16, 8); physics loop ret={ret:.3f}")

        # 4. dp x sp x tp train step
        if nproc % 4 == 0:
            axes3 = {"dp": nproc // 4, "sp": 2, "tp": 2}
            mesh3 = make_mesh(axes3)
            diff3 = _diffusion(8, 6, 2, 16, seed=4,
                               act_spec=("dp", "sp", "tp")).to(dev)
            shard_params_tp(diff3.model, mesh3)
            loss3_fn, _ = build_loss(diff3)
            state = TrainState(module=diff3,
                               optimizer=make_optimizer(diff3.parameters(),
                                                        1e-3),
                               ema_params=EMA(diff3).shadow)
            step = make_train_step(
                loss3_fn, lr_schedule=warmup_cosine_schedule(1e-3, 0, 10),
                gradient_clip=1.0,
                after_backward=lambda: average_grads(diff3, mesh3, "dp"))
            x3 = np.random.RandomState(1).randn(axes3["dp"] * 2, 16, 8)
            b3 = local_rows({"conditions": torch.tensor(
                x3, dtype=torch.float32, device=dev)}, mesh3)
            gen = [torch.Generator(dev).manual_seed(2)]
            with batch_rows(mesh3):
                m3 = step(state, b3, gen)
            loss3 = _agree(float(all_reduce_mean(
                {"total": m3["total"]}, mesh3)["total"]), mesh3)
            msg += f"; tp/sp mesh={axes3} loss={loss3:.4f}"
        else:
            msg += "; tp/sp skipped (needs nproc % 4 == 0)"
        if rank == 0:
            print(msg, flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    import torch
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser(description="Multi-device dry run of the "
                                "parallelism layer")
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.nproc:
        raise SystemExit(f"--nproc {args.nproc} needs as many cards; "
                         f"{torch.cuda.device_count()} visible (pass "
                         "--device cpu for gloo processes)")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_legs, args=(args.nproc, f"file://{tmp}/rendezvous",
                              args.device, os.path.join(tmp, "logs")),
                 nprocs=args.nproc, join=True)


if __name__ == "__main__":
    main()
