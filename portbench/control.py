"""The two readings each compared number's limit is set from, on the card
at the cell's own size: the port's (the lower reading, over many seeds)
and the control's (the reference in the precision below the stated one,
put in the port's place: fp8 products for a bf16 configuration, TF32 for
a float32 one, the env in bf16; the upper reading). One process runs every
seed, each with a short window at the cell's own load.

    python3 portbench/control.py --workload unet_umaze.serve_closed8 \\
        --seeds 101 102 103 --seconds 6

Prints one JSON line a seed: its readings and the window's end-to-end
metrics.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    args = p.parse_args(argv)
    import torch

    run.cache_env(spec.REPO)
    cell = spec.find(spec.load_benchmark()["workloads"], args.workload,
                     "workload")
    cfg = spec.load_config(cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    if not torch.cuda.is_available():
        print("control readings are taken on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        out, ctx = run.execute(cfg, traffic, seed, args.seconds, device,
                               control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": ctx.readings,
                          "end_to_end": out.end_to_end,
                          "failed": out.failed, "info": out.info}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
