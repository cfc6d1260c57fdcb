"""Served bo-N plans: the port's planning server in this process, with
micro-batching (``serve(policy, ..., concurrency, max_batch, window_ms)``),
and the load generator (``loadgen.py``) in a process of its own.

Traffic keys: ``loop`` closed or open; ``controllers``; ``max_batch``;
``window_ms``; ``rate`` (plans/s, open loop); ``trace_from_s`` and
``trace_waves`` (the traced sub-window: that many waves, from the first
that starts ``trace_from_s`` into the window);
``check_requests`` (the answers the reference recomputes).
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import threading
import time


from portbench import inputs, program
from portbench.outcome import Outcome, percentile
from portbench.spec import PKG, rng

SERVER_START_S = 900.0


def run(ctx) -> Outcome:
    import torch

    from portbench import check

    cfg, tr, seed, dev = ctx.cfg, ctx.traffic, ctx.seed, ctx.device
    ph = ctx.phases
    program.load_kernels(cfg, dev, ctx.pkg)
    ph.mark("kernel_libraries")
    diff = program.diffusion(
        cfg, inputs.make_weights(cfg, seed, dev, ctx.pkg), dev, ctx.pkg)
    ph.mark("weights")
    data = program.data(cfg, dev)
    ph.mark("normaliser_and_dynamics")
    policy = program.served_policy(cfg, diff, data, seed)
    ph.mark("policy_and_planner")

    C = int(tr["controllers"])
    hooks = program.ServerHooks(seed, cfg["n_candidates"])
    box, ready, errors = {}, threading.Event(), []

    def server():
        from dadiff_tpu_torch.serve import serve

        try:
            serve(policy, "127.0.0.1", 0, max_requests=None,
                  ready_cb=lambda p: (box.update(port=p), ready.set()),
                  concurrency=C, window_ms=float(tr["window_ms"]),
                  max_batch=int(tr["max_batch"]))
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            ready.set()

    if ctx.trace:
        from portbench.trace import Tracer

        Tracer.initialize()
    srv = threading.Thread(target=server, daemon=True)
    gen = None
    try:
        srv.start()
        if not ready.wait(SERVER_START_S) or errors:
            raise RuntimeError(f"the server did not start: {errors}")
        ph.mark("batcher_captures_and_listen")
        plan = request_plan(cfg, tr, seed, ctx.seconds, box["port"])
        gen = subprocess.Popen([sys.executable, str(PKG / "loadgen.py")],
                               stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                               text=True)
        gen.stdin.write(json.dumps(plan))
        gen.stdin.close()
        first = gen.stdout.readline().split()
        if len(first) != 2 or first[0] != "ready":
            raise RuntimeError(f"the load generator did not start: {first}")
        t0 = float(first[1])
        ph.mark("generator_connected_and_warm")
        batcher = hooks.batchers[-1]
        waves_before = len(batcher.batch_sizes)
        tracer = None
        if ctx.trace:
            tracer = hooks.tracer = Tracer(ctx.tmpdir)
            hooks.trace_waves = int(tr["trace_waves"])
            hooks.trace_at = t0 + float(tr["trace_from_s"])
        result = json.loads(gen.stdout.read())
        gen.wait(timeout=60)
        if "error" in result:
            raise RuntimeError(f"load generator: {result['error']}")
    finally:
        hooks.stop.set()
        if gen is not None and gen.poll() is None:
            gen.kill()
            gen.wait()
        srv.join(timeout=30)
        hooks.restore()
    if srv.is_alive():
        raise RuntimeError("the server did not stop")
    sizes = list(batcher.batch_sizes[waves_before:])
    cold = int(batcher.cold_calls)
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" \
        else 0
    summary = (tracer.read() if tracer is not None
               and hooks.trace_done.is_set() else None)
    del policy, diff, data, batcher, hooks
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    reqs = result["records"]
    out = window_metrics(reqs, tr["loop"], t0)
    sample = pick_requests(reqs, int(tr["check_requests"]), seed)
    t_ref = time.perf_counter()
    checks = check.served(ctx, [
        dict(controller=c, k=k, obs=plan["obs"][c][k],
             reply=json.loads(result["replies"][f"{c} {k}"]))
        for c, k in sample])
    lat = result["lateness_s"]
    info = {
        "requests": len(reqs), "failed": out["failed"], "cold_calls": cold,
        "waves": len(sizes), "window_s": out["window_s"],
        "generator_lateness_ms": {
            "n": len(lat), "p50": 1e3 * percentile(lat, 0.5) if lat else 0.0,
            "p99": 1e3 * percentile(lat, 0.99) if lat else 0.0,
            "max": 1e3 * max(lat) if lat else 0.0},
        "reference_s": time.perf_counter() - t_ref,
    }
    records = {"latencies_s": out["latencies"], "batch_sizes": sizes,
               "max_batch": int(tr["max_batch"]), "recv": out["recv"],
               "n_candidates": cfg["n_candidates"]}
    e2e = {"plan_p95_ms": 1e3 * percentile(out["latencies"], 0.95),
           "plans_per_s": out["done"] / out["window_s"]}
    if cold:
        checks["cold_calls"] = [float(cold), 0.0]
    return Outcome(window_start=t0, end_to_end=e2e, attempted=len(reqs),
                   failed=out["failed"], memory_peak_bytes=peak,
                   checks=checks, trace=summary, records=records, info=info)


def request_plan(cfg, tr, seed, seconds, port) -> dict:
    """The generator's input: every controller's observations and, in an
    open loop, its due times."""
    C = int(tr["controllers"])
    if tr["loop"] == "open":
        due = [d.tolist() for d in inputs.arrival_schedule(
            seed, C, float(tr["rate"]), seconds)]
        counts = [len(d) + 1 for d in due]
    else:
        due = None
        # more than a closed loop can send: a plan per 20 ms at the most
        counts = [int(seconds / 0.02) + 2] * C
    pool = inputs.observation_pool(cfg, seed, sum(counts))
    obs, i = [], 0
    for n in counts:
        obs.append(pool[i:i + n].tolist())
        i += n
    return {"port": port, "loop": tr["loop"], "seconds": seconds,
            "obs": obs, "due": due}


def window_metrics(reqs, loop: str, t0: float) -> dict:
    """Latency of every request of the window (received minus due in an
    open loop, minus sent in a closed one; +inf for one that failed), the
    answered count and the window's length, from its start to the last
    answer."""
    lat, recv, failed = [], [], 0
    for _, _, due, sent, got, ok in sorted(reqs, key=lambda r: r[2]):
        if got is None or not ok:
            failed += 1
            lat.append(float("inf"))
            continue
        lat.append(got - (due if loop == "open" else sent))
        recv.append(got)
    end = max(recv) if recv else t0
    return {"latencies": lat, "recv": recv, "failed": failed,
            "done": len(recv), "window_s": max(end - t0, 1e-9)}


def pick_requests(reqs, n: int, seed: int):
    """(controller, k) of the answers to recompute: the slowest answered
    request, and the rest drawn from the seed."""
    done = [(r[0], r[1], r[4] - r[3]) for r in reqs
            if r[4] is not None and r[5]]
    if not done:
        return []
    slowest = max(done, key=lambda r: r[2])
    rest = [r for r in done if r is not slowest]
    idx = rng(seed, "check").permutation(len(rest))[:max(0, n - 1)]
    return [(slowest[0], slowest[1])] + [(rest[i][0], rest[i][1])
                                         for i in sorted(idx)]
