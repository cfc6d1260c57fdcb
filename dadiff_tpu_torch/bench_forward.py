"""Time the eager forward of both model families on a card: plain, and on a
one-rank tp/sp mesh.

For each family at the recipe's width (the flagship U-Net: horizon 32, dim
128, mults 1 2 4, D 8; the transformer: dim 256, depth 6, 8 heads) and each
``--chains`` count, a model with seeded weights runs its forward on seeded
inputs, timed by CUDA events: ``--repeats`` runs of ``--reps`` calls each,
after a warm-up. Each model runs twice: as built, and with ``act_spec``
('dp', 'sp', 'tp') after ``parallel.tp.shard_params_tp`` has placed its
weights on a ('dp', 'sp', 'tp') mesh of one NCCL rank. The U-Net then takes
its sharded forward (``parallel.tp.unet_forward``); the transformer runs
its one forward either way. The repeats of the two alternate. Prints one
JSON object: the card, and per family and chain count both lists of ms and
the largest difference of the two outputs.

    python -m dadiff_tpu_torch.bench_forward [--chains 8 256] [--reps 50] \\
        [--repeats 5]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import tempfile

HORIZON, D, T_STEPS = 32, 8, 100


def _models(seed: int):
    import torch

    from dadiff_tpu_torch.models.temporal_transformer import (
        TemporalTransformer,
    )
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    torch.manual_seed(seed)
    unet = TemporalUnet(D, dim=128, dim_mults=(1, 2, 4))
    torch.manual_seed(seed)
    transformer = TemporalTransformer(D, dim=256, depth=6, n_heads=8)
    # the transformer's adaLN and output projections start at zero: give
    # every weight a draw so that the whole forward carries values
    for p in transformer.parameters():
        if p.dim() > 1:
            torch.nn.init.normal_(p, 0.0, p.shape[-1] ** -0.5)
    return {"unet": unet.cuda(), "transformer": transformer.cuda()}


def _ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> None:
    import torch
    import torch.distributed as dist

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chains", type=int, nargs="+", default=[8, 256])
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_forward times the card; none is visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from dadiff_tpu_torch.parallel.distributed import initialize_distributed
    from dadiff_tpu_torch.parallel.mesh import make_mesh
    from dadiff_tpu_torch.parallel.tp import shard_params_tp

    out = {"card": _card(), "torch": torch.__version__, "reps": args.reps,
           "forward_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{os.path.join(tmp, 'rdv')}", rank=0,
                               world_size=1, device="cuda")
        try:
            mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
            for family, model in _models(args.seed).items():
                sharded = copy.deepcopy(model)
                sharded.act_spec = ("dp", "sp", "tp")
                shard_params_tp(sharded, mesh)
                for n in args.chains:
                    g = torch.Generator("cuda").manual_seed(args.seed + n)
                    x = torch.randn(n, HORIZON, D, generator=g, device="cuda")
                    t = torch.randint(0, T_STEPS, (n,), generator=g,
                                      device="cuda")
                    runs = {"plain": [], "sharded": []}
                    with torch.no_grad():
                        err = float((sharded(x, t) - model(x, t)).abs().max())
                        for _ in range(3):
                            model(x, t), sharded(x, t)
                        for _ in range(args.repeats):
                            for name, m in (("plain", model),
                                            ("sharded", sharded)):
                                runs[name].append(
                                    _ms(lambda: m(x, t), args.reps))
                    out["forward_ms"][f"{family}/{n}"] = dict(
                        runs, max_abs_diff=err)
        finally:
            dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
