"""Concurrent-serving latency: one client against K concurrent clients.

Counterpart of the JAX package's scripts/bench_serve.py. Starts the server
in-process on the policy the flags describe (every serve flag applies), and
drives real TCP clients through three phases: one client, K concurrent
clients (``--concurrency K``: their plan requests micro-batched), one
client again. Prints one JSON line: the replan times' median, p50 and p95
of the solo phases and of the concurrent phase, the slowdown and the
throughput gain over serving the K clients one after another.

    python -m dadiff_tpu_torch.bench_serve --checkpoint model.pt \
        --dataset npz:data/pointmaze_umaze_expert.npz \
        --policy-type dynamics-aware --n-candidates 8 --megakernel \
        --clients 4

A warm-start policy cannot be micro-batched (per-client warm state): its
concurrent phase is served one client at a time and says so, and then
``throughput_gain_vs_serialized_x`` is null, since that phase is itself
serialized.
"""

from __future__ import annotations

import json
import socket
import statistics
import sys
import threading
import time


def _rpc(f, req):
    f.write((json.dumps(req) + "\n").encode())
    f.flush()
    line = f.readline()
    if not line:
        raise ConnectionError("the server closed the connection")
    resp = json.loads(line)
    if "error" in resp:
        raise RuntimeError(f"server error: {resp['error']}")
    return resp


def _client_latencies(port, n_requests, obs_dim, start_evt=None,
                      timeout_s=600.0):
    """One client: ping, one untimed replan, then ``n_requests`` timed
    replans (seconds each)."""
    lats = []
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout_s) as c:
        f = c.makefile("rwb")
        _rpc(f, {"ping": True})
        _rpc(f, {"obs": [0.05] * obs_dim, "plan": True})
        if start_evt is not None and not start_evt.wait(timeout_s):
            raise TimeoutError("the burst did not start")
        for i in range(n_requests):
            t0 = time.perf_counter()
            _rpc(f, {"obs": [0.01 * (i + 1)] * obs_dim, "plan": True})
            lats.append(time.perf_counter() - t0)
    return lats


def _quantile_ms(lats, q):
    return sorted(lats)[min(len(lats) - 1, int(q * len(lats)))] * 1e3


def main(argv=None) -> dict:
    import torch

    from dadiff_tpu_torch.serve import (
        build_server_parser,
        policy_from_args,
        serve,
    )

    parser = build_server_parser()
    parser.add_argument("--clients", type=int, default=4)
    parser.add_argument("--requests-per-client", type=int, default=8)
    args = parser.parse_args(argv)
    policy, steps = policy_from_args(args)
    device = policy.device
    obs_dim = policy.observation_dim
    K, R = args.clients, args.requests_per_client

    def run_phase(concurrency, n_clients):
        box, errors = {}, []
        ready = threading.Event()

        def run_server():
            try:
                serve(policy, "127.0.0.1", 0,
                      max_requests=n_clients * (R + 2),  # + ping, warm-up
                      ready_cb=lambda p: (box.update(port=p), ready.set()),
                      concurrency=concurrency, window_ms=args.batch_window_ms,
                      max_batch=args.max_batch)
            except BaseException as e:
                errors.append(e)
                ready.set()

        srv = threading.Thread(target=run_server, daemon=True)
        srv.start()
        if not ready.wait(600) or errors:
            raise RuntimeError(f"the server did not start: {errors}")
        start = threading.Event()
        results = [None] * n_clients

        def client(i):
            try:
                results[i] = _client_latencies(
                    box["port"], R, obs_dim,
                    start if n_clients > 1 else None)
            except BaseException as e:
                errors.append(e)

        threads = []
        for i in range(n_clients):
            t = threading.Thread(target=client, args=(i,), daemon=True)
            t.start()
            threads.append(t)
            if n_clients > 1:
                time.sleep(0.5)  # connections are up before the burst
        start.set()
        for t in threads:
            t.join(timeout=900)
        srv.join(timeout=60)
        if errors or any(r is None for r in results) or srv.is_alive():
            raise RuntimeError(f"phase of {n_clients} clients failed: "
                               f"{errors}")
        return [x for r in results for x in r]

    solo = run_phase(1, 1)
    batched_ok = args.warm_start_t is None and not args.warm_start_auto
    if batched_ok:
        concurrent_mode = "micro-batched"
        conc = run_phase(K, K)
    else:
        concurrent_mode = ("serialized (micro-batching does not compose with "
                           "per-client warm-start state)")
        conc = run_phase(1, K)
    solo_all = solo + run_phase(1, 1)  # the solo phase again, for stability
    solo_ms = statistics.median(solo_all) * 1e3
    conc_ms = statistics.median(conc) * 1e3
    out = {
        "solo_replan_ms": solo_ms,
        "solo_p50_ms": _quantile_ms(solo_all, 0.50),
        "solo_p95_ms": _quantile_ms(solo_all, 0.95),
        f"concurrent_{K}_replan_ms": conc_ms,
        f"concurrent_{K}_p50_ms": _quantile_ms(conc, 0.50),
        f"concurrent_{K}_p95_ms": _quantile_ms(conc, 0.95),
        "slowdown_x": conc_ms / solo_ms,
        # K clients served one after another would take K solo replans each
        # round; a serialized concurrent phase has no such gain to report
        "throughput_gain_vs_serialized_x": (K * solo_ms / conc_ms
                                            if batched_ok else None),
        "concurrent_mode": concurrent_mode,
        "target": f"< 2.0 (vs ~{K} under serialized serving)",
        "n_candidates": args.n_candidates,
        "policy_type": args.policy_type,
        "megakernel": args.megakernel,
        "sampler": args.sampler,
        "sampling_timesteps": steps,
        "warm_start_t": args.warm_start_t,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
