"""Multi-process dry run: evidence that parallel/distributed.py joins
processes into one data-parallel train step.

Counterpart of the JAX package's scripts/dryrun_multihost.py. Two
processes, one per card over NCCL (or gloo processes on the CPU with
``--device cpu``), join one process group through
``initialize_distributed`` at the coordinator's address (``--coordinator
localhost:PORT``, a free port, and ``--process-id``, as the JAX script
passes them; a child started by torchrun without them reads its
variables), build the ('dp',) mesh and take the REAL train step
(``utils.training.Trainer`` with its DDP objective) on a deterministic
global batch, each process on its own rows. The parent takes the same step
in one process and requires the same loss from both children: the
cross-process path computes the single-process math.

It sees the rendezvous, the mesh over the processes, per-process batch rows
and the gradient all-reduce across processes. It cannot see more than one
host.

    python -m dadiff_tpu_torch.dryrun_multihost [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_PROCS = 2
BATCH, HORIZON, DIM = 16, 8, 4


def _trainer(log_dir: str, device: str, mesh=None):
    """Tiny diffusion model and the real train step, weights from seed 0."""
    import numpy as np
    import torch

    from dadiff_tpu_torch.losses import build_loss
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
    from dadiff_tpu_torch.utils.training import Trainer

    torch.manual_seed(0)
    diffusion = GaussianDiffusion(
        TemporalUnet(DIM, dim=8, dim_mults=(1, 2)), HORIZON,
        observation_dim=3, action_dim=1, n_timesteps=10).to(device)
    loss_fn, names = build_loss(diffusion)
    batch = {"conditions": np.random.RandomState(0).randn(
        BATCH, HORIZON, DIM).astype(np.float32)}
    trainer = Trainer(diffusion, [batch], loss_fn, lr=1e-3, log_dir=log_dir,
                      save_freq=0, loss_names=names, seed=42,
                      export_pt=False, mesh=mesh)
    return trainer, batch


def _loss(trainer, batch) -> float:
    import torch

    from dadiff_tpu_torch.parallel.mesh import local_rows

    rows = local_rows(batch, trainer.mesh)
    device = next(trainer.diffusion.parameters()).device
    try:
        return trainer.train_step({k: torch.from_numpy(v).to(device)
                                   for k, v in rows.items()})["total"]
    finally:
        trainer.close()


def run_child(args) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from dadiff_tpu_torch.parallel.distributed import (
        initialize_distributed,
        mesh_device,
    )
    from dadiff_tpu_torch.parallel.mesh import make_mesh

    joined = (initialize_distributed(f"tcp://{args.coordinator}",
                                     rank=args.process_id,
                                     world_size=NUM_PROCS, device=args.device)
              if args.coordinator else
              initialize_distributed(device=args.device))
    if not joined:
        raise SystemExit("initialize_distributed found no world")
    try:
        if dist.get_world_size() != NUM_PROCS:
            raise SystemExit(f"world of {dist.get_world_size()}, not "
                             f"{NUM_PROCS}")
        mesh = make_mesh({"dp": NUM_PROCS})
        trainer, batch = _trainer(args.log_dir, mesh_device(mesh), mesh)
        loss = _loss(trainer, batch)
        print(f"CHILD {dist.get_rank()} LOSS {loss:.10f}", flush=True)
    finally:
        dist.destroy_process_group()


def run_parent(device: str) -> None:
    import torch

    torch.set_num_threads(1)
    if device == "cuda" and torch.cuda.device_count() < NUM_PROCS:
        raise SystemExit(f"{NUM_PROCS} processes need as many cards; "
                         f"{torch.cuda.device_count()} visible (pass "
                         "--device cpu for gloo processes)")
    with tempfile.TemporaryDirectory() as tmp:
        trainer, batch = _trainer(os.path.join(tmp, "ref"), device)
        ref_loss = _loss(trainer, batch)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            coordinator = f"localhost:{s.getsockname()[1]}"
        procs = []
        for rank in range(NUM_PROCS):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dadiff_tpu_torch.dryrun_multihost",
                 "--role", "child", "--device", device, "--coordinator",
                 coordinator, "--process-id", str(rank), "--log-dir",
                 os.path.join(tmp, "run")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=ROOT))
        losses = {}
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, (out, err) in zip(procs, outs):
            if p.returncode != 0:
                print(out)
                print(err)
                raise SystemExit("child failed")
            for line in out.splitlines():
                if line.startswith("CHILD"):
                    _, rank, _, loss = line.split()
                    losses[int(rank)] = float(loss)
    if len(losses) != NUM_PROCS:
        raise SystemExit(f"children reported {losses}")
    vals = list(losses.values())
    if abs(vals[0] - vals[1]) > 1e-9:
        raise SystemExit(f"processes disagree on the global loss: {losses}")
    if abs(vals[0] - ref_loss) > 1e-6:
        raise SystemExit(f"multi-process loss {vals[0]} != single-process "
                         f"{ref_loss}")
    print(f"OK multihost dryrun: {NUM_PROCS} processes, train step loss "
          f"{vals[0]:.10f} == single-process {ref_loss:.10f}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--role", default="parent", choices=["parent", "child"])
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT of process 0 (a child's rendezvous)")
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.role == "parent":
        run_parent(args.device)
    else:
        run_child(args)


if __name__ == "__main__":
    main()
