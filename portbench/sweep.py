"""The knee of the open-loop serving cell, swept once on the card: the
cell's traffic at each fixed rate, one window each in one process. A rate
is sustained when the answers keep up with it and the latency does not
climb through the window (the backlog does not grow).

    python3 portbench/sweep.py --workload unet_umaze.serve_open \\
        --rates 40 50 60 70 80 --seconds 20 --seed 7

Prints one JSON line a rate: offered, answered per second, p50 and p95 of
the latency, and the median latency of the window's first and last thirds.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run, spec  # noqa: E402
from portbench.outcome import percentile  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    import torch

    run.cache_env(spec.REPO)
    cell = spec.find(spec.load_benchmark()["workloads"], args.workload,
                     "workload")
    cfg = spec.load_config(cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    for rate in args.rates:
        out, _ = run.execute(cfg, dict(traffic, rate=rate), args.seed,
                             args.seconds, device)
        lat = out.records["latencies_s"]
        third = max(1, len(lat) // 3)
        sizes = out.records["batch_sizes"]
        print(json.dumps({
            "rate": rate, "answered_per_s": out.end_to_end["plans_per_s"],
            "p50_ms": 1e3 * percentile(lat, 0.5),
            "p95_ms": out.end_to_end["plan_p95_ms"],
            "first_third_p50_ms": 1e3 * percentile(lat[:third], 0.5),
            "last_third_p50_ms": 1e3 * percentile(lat[-third:], 0.5),
            "mean_batch": sum(sizes) / max(1, len(sizes)),
            "failed": out.failed, "info": out.info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
