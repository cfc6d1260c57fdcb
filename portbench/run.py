"""Run one cell of BENCHMARK.json and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (from the start of the process to the start of the window) is
timed by phase, and the phases go on an earlier line. ``--trace 0`` prints
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read
from a traced sub-window. Every run compares what its window produced with
the plain reference and prints each compared number beside its limit, as
the last lines of standard error and under ``checks``, the last key of the
result.

Build and kernel caches stay inside the checkout (``build/``); a run
writes nothing else but under ``TMPDIR``. The run fails, and prints no
result, without a CUDA card (or fewer than the cell asks for), and when
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from portbench.phases import Phases, process_start  # noqa: E402

START = process_start()
FORBIDDEN = ("jax", "jaxlib", "flax", "dadiff_tpu")


def cache_env(repo: Path) -> None:
    """Every compile cache under ``build/`` of the checkout, at fixed
    paths (the port keys its own nvcc builds under build/dadiff_tpu_torch),
    the interpreter's bytecode among them: where the environment turns
    bytecode caching off, every run would compile torch's ~1,000 modules
    from source (about 4 s of a 9 s import on an H100 host)."""
    build = repo / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the whole name before the first dot)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a runner is given."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def execute(cfg, traffic, seed, seconds, device, *, trace=False,
            control=False, phases=None, pkg=None):
    """Run the traffic's runner on ``device`` (a test may pass the CPU),
    with the parts found under ``pkg`` (a copy of the benchmark, in a
    test); returns its Outcome and the context it was given."""
    from portbench import spec

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = Context(cfg=cfg, traffic=traffic, seed=seed, seconds=seconds,
                      trace=trace, device=device,
                      phases=phases or Phases(time.perf_counter()),
                      tmpdir=tmp, control=control, readings={},
                      pkg=pkg or spec.PKG,
                      product_dtype=(cfg["product_dtype"]
                                     if device.type == "cuda" else "float32"))
        out = spec.runner(traffic["runner"], ctx.pkg).run(ctx)
    out.records["pkg"] = ctx.pkg    # where a reader finds the family
    return out, ctx


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(HERE.parent)
    from portbench import spec

    bench = spec.load_benchmark()
    cell = spec.find(bench["workloads"], args.workload, "workload")
    cfg = spec.load_config(cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    phases = Phases(START)
    import torch

    phases.mark("interpreter_and_torch_import")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    phases.mark("cuda_context")
    out, _ = execute(cfg, traffic, args.seed, args.seconds, device,
                     trace=bool(args.trace), phases=phases)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {found}",
              file=sys.stderr)
        return 3
    return report(bench, cell, cfg, args, out, phases, device)


def report(bench, cell, cfg, args, out, phases, device) -> int:
    import torch

    from portbench import spec

    name = cell["name"]
    setup_s = out.window_start - phases.start
    print("portbench phases " + json.dumps(
        {k: round(v, 4) for k, v in phases.spans.items()}
        | {"setup_s": setup_s}), flush=True)
    print("portbench info " + json.dumps(out.info), flush=True)
    metrics = {}
    if args.trace:
        if out.trace is None:
            print("portbench: the traced sub-window was not reached",
                  file=sys.stderr)
            return 4
        print("portbench trace " + json.dumps(
            {k: out.trace[k] for k in ("window_s", "busy_s", "waves",
                                       "device_events")}), flush=True)
        for m in spec.cell_metrics(bench, name, "per_layer"):
            value = spec.metric_reader(m["name"]).read(m["name"], out, cfg)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.cell_metrics(bench, name, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" \
                else out.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": int(cell["chips"]),
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.trace["window_s"]
        result["breakdown"] = {"device_ops": out.trace["device_ops"],
                               "idle_gaps": out.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    for k, (v, lim) in out.checks.items():
        print(f"portbench check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
