"""Write the measured communication of the tp-sharded Temporal U-Net forward.

Counterpart of the JAX package's scripts/analyze_tp_comm.py. ``--nproc``
processes, one per card over NCCL (or gloo processes on the CPU with
``--device cpu``; the collectives are the sharded forward's own,
parallel/tp.py, whatever the backend), run the forward of a U-Net of
``--dim`` at horizon ``--horizon`` and ``--batch`` rows, on the meshes
``{'dp': nproc/tp, 'tp': tp}`` for tp 2 and 4, and count every collective
with parallel/comm_analysis.py. The table (collective, count, result bytes)
and the whole-weight gather check go to ``--out``. These are counts and
bytes from the program's shapes, not times.

    python -m dadiff_tpu_torch.analyze_tp_comm [--dim 256] [--nproc 8] \\
        [--device cpu] [--out docs/tp_comm_volume_torch.md]
"""

from __future__ import annotations

import argparse
import os
import tempfile


def _run(rank: int, args, init: str, result: str) -> None:
    import torch
    import torch.distributed

    torch.set_num_threads(1)
    from dadiff_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed(init, rank=rank, world_size=args.nproc,
                           device=args.device)
    try:
        rows = _count(args)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        torch.save(rows, result)


def _count(args) -> list:
    """Per tp size: (tp, dp, parameter count, collective summary, whole
    weights gathered)."""
    import numpy as np
    import torch

    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
    from dadiff_tpu_torch.parallel.comm_analysis import (
        CollectiveCounter,
        collective_summary,
        weight_gather_violations,
    )
    from dadiff_tpu_torch.parallel.distributed import mesh_device
    from dadiff_tpu_torch.parallel.mesh import local_rows, make_mesh
    from dadiff_tpu_torch.parallel.tp import shard_params_tp

    r = np.random.RandomState(0)
    x = torch.tensor(r.randn(args.batch, args.horizon, 8), dtype=torch.float32)
    t = torch.tensor(r.randint(0, 100, (args.batch,)))
    rows = []
    for tp in (2, 4):
        if args.nproc % tp:
            continue
        torch.manual_seed(0)
        mesh = make_mesh({"dp": args.nproc // tp, "tp": tp})
        dev = mesh_device(mesh)
        unet = TemporalUnet(8, dim=args.dim, dim_mults=tuple(args.mults),
                            act_spec=("dp", None, "tp")).to(dev)
        whole = {k: v.detach().clone() for k, v in unet.state_dict().items()}
        n_params = sum(v.numel() for v in whole.values())
        shard_params_tp(unet, mesh)
        with torch.no_grad(), CollectiveCounter() as counter:
            unet(*local_rows((x.to(dev), t.to(dev)), mesh))
        summary = collective_summary(counter)
        rows.append((tp, args.nproc // tp, n_params, summary,
                     weight_gather_violations(summary, whole)))
    return rows


def _report(rows, args) -> str:
    lines = [
        "# Measured tp communication volume (Temporal U-Net forward, "
        "PyTorch port)",
        "",
        f"Config: dim={args.dim}, mults={tuple(args.mults)}, "
        f"h={args.horizon}, batch={args.batch}, transition_dim=8, "
        f"{args.nproc} processes ({args.backend}). Counted per rank (rank "
        "0) by `dadiff_tpu_torch/parallel/comm_analysis.py` around the "
        "sharded forward's own collectives (`parallel/tp.py`); regenerate "
        "with `python -m dadiff_tpu_torch.analyze_tp_comm`. Counts and bytes "
        "follow from the shapes: the same on any backend.",
        "",
        "| mesh | collective | count | result bytes/forward |",
        "|---|---|---|---|",
    ]
    for tp, dp, _, summary, _ in rows:
        for op, entry in sorted(summary.items()):
            lines.append(f"| dp={dp} tp={tp} | {op} | {entry['count']} | "
                         f"{entry['bytes']:,} |")
    bad = [v for *_, v in rows if v]
    lines += [
        "",
        "**Whole-weight gather check:** "
        + ("no all-gather result has the shape of a weight of 4,096 "
           "elements or more: the activations move, the weights stay put."
           if not bad else f"VIOLATIONS FOUND: {bad}"),
        "",
        "Reading the numbers: a layer whose output channels are split "
        "all-gathers its input's channels (activation bytes); a layer whose "
        "weight stays whole on split inputs (the final 1x1 conv's 8 "
        "outputs; a time projection whose shard would hold fewer than 128) "
        "all-reduces its partial sums. Both scale with batch x rows x "
        "channels, not with the parameter count "
        f"({rows[0][2]:,} at dim={args.dim}).",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    import torch
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser(description="tp communication volume of "
                                "the sharded U-Net forward")
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--mults", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--nproc", type=int, default=8)
    p.add_argument("--out", type=str, default="docs/tp_comm_volume_torch.md")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.nproc:
        raise SystemExit(f"--nproc {args.nproc} needs as many cards; "
                         f"{torch.cuda.device_count()} visible (pass "
                         "--device cpu for gloo processes)")
    args.backend = "nccl" if args.device == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "rows.pt")
        mp.spawn(_run, args=(args, f"file://{tmp}/rendezvous", result),
                 nprocs=args.nproc, join=True)
        rows = torch.load(result, weights_only=False)
    for tp, dp, _, summary, violations in rows:
        print(f"tp={tp}: {summary} violations={violations}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(_report(rows, args))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
