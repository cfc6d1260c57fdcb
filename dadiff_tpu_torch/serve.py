"""Planning server: a policy behind newline-delimited JSON over TCP.

Counterpart of scripts/serve.py (make_handler :64, _serve_connection and
_Counter :108-140, serve :143, main :203).

    python -m dadiff_tpu_torch.serve --checkpoint model.pt \\
        --dataset npz:data/pointmaze_umaze_expert.npz \\
        --policy-type dynamics-aware --n-candidates 8 --megakernel --port 7033

``--concurrency 1`` (the default) serves one client at a time. With
``--concurrency K`` > 1 each connection gets its own policy session in its
own thread, and the plan requests that arrive within ``--batch-window-ms``
(at most ``--max-batch``) run as one batched call (serving.py): with
``--megakernel`` one planner-chain wave of K_pad x n_candidates chains.

Every flag of the evaluate CLI applies (cli.build_eval_parser): the
samplers, warm start (``--warm-start-t``, ``--warm-start-auto``), a
consistency student with ``--sampler consistency``.

Protocol (one JSON object per line, one response per request):
    {"obs": [..flat obs..]}          -> {"action": [...], "plan_ms": t}
    {"obs": [...], "plan": true}     -> adds "plan": the normalized (H, D) plan
    {"reset": true}                  -> {"ok": true}  (a new episode: clears
                                        the action buffer and warm state)
    {"ping": true}                   -> {"ok": true, "policy": "...", ...}
    {"stats": true}                  -> {"ok": true, "counters": {...}}
                                        (cumulative: requests answered,
                                        the wave runner's captures,
                                        replays and host-driven waves, and
                                        with --concurrency > 1 the
                                        batcher's waves, requests,
                                        padded_lanes and cold_calls)
Malformed requests get {"error": "..."} and the connection stays up.

Spans (utils/profiling.py ``span``; recorded while a profiler runs on the
batcher's thread or a ``profiling.trace`` is open): ``serve.request``
from a line read to its reply's flush (attributes ``conn`` and
``request``, the connection and the request's ordinal on it), and inside
it ``serve.decode``, ``policy.act`` and ``serve.reply``.
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
import time

import numpy as np

from dadiff_tpu_torch.utils.profiling import span


def build_server_parser() -> argparse.ArgumentParser:
    from dadiff_tpu_torch.cli import build_eval_parser

    p = build_eval_parser()
    p.description = "Serve a planning policy over TCP (JSON lines)"
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=7033)
    p.add_argument("--max-requests", type=int, default=None,
                   help="exit after N requests")
    p.add_argument("--concurrency", type=int, default=1,
                   help="concurrent client connections; > 1 micro-batches "
                        "the plan requests that arrive within "
                        "--batch-window-ms into one call (serving.py)")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="how long the batcher waits to fold concurrent "
                        "plan requests into one call")
    p.add_argument("--max-batch", type=int, default=8,
                   help="most plan requests folded into one call")
    return p


def make_handler(policy, stats=None):
    """Request dict -> response dict, no socket concerns (serve.py:64-105).
    ``stats``: a function that returns the counters of a ``stats``
    request (default: the wave runner's)."""
    stats = stats or server_counters

    def handle(req: dict) -> dict:
        if req.get("stats"):
            return {"ok": True, "counters": stats()}
        if req.get("ping"):
            return {
                "ok": True,
                "policy": type(policy).__name__,
                "horizon": policy.horizon,
                "observation_dim": policy.observation_dim,
                "action_dim": policy.action_dim,
            }
        if req.get("reset"):
            policy.reset()
            return {"ok": True}
        if "obs" not in req:
            return {"error": "request needs 'obs', 'reset', or 'ping'"}
        obs = req["obs"]
        if isinstance(obs, dict):
            obs = {k: np.asarray(v, np.float32) for k, v in obs.items()}
        else:
            obs = np.asarray(obs, np.float32)
        t0 = time.perf_counter()
        with span("policy.act"):
            if req.get("plan"):
                # full replan: return the plan AND refill the buffer from it
                traj = policy.plan(obs)
                policy.action_buffer.clear()
                policy._fill_action_buffer(traj)
                policy._actions_taken += 1
                if policy._planned_obs:
                    policy._planned_obs.pop(0)
                action = policy.action_buffer.pop(0)
                if policy.track_planned_states:
                    # the buffer holds planned next states: u = g(s, s_next),
                    # as get_action takes it
                    action = policy.inverse_dynamics(
                        policy._process_observation(obs), action[None])
                resp = {"plan": np.asarray(traj)[0].tolist()}
            else:
                action = policy.get_action(obs)
                resp = {}
        resp.update({
            "action": np.ravel(action).tolist(),
            "plan_ms": round((time.perf_counter() - t0) * 1e3, 3),
        })
        return resp

    return handle


def _serve_connection(conn, handle, counter, max_requests,
                      conn_id: int = 0) -> None:
    """Answer one connection's requests until it closes or the server's
    limit is reached (serve.py:108-121)."""
    with conn, conn.makefile("rwb") as f:
        for ordinal, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            with span("serve.request", conn=conn_id, request=ordinal):
                try:
                    with span("serve.decode"):
                        req = json.loads(line)
                    resp = handle(req)
                except Exception as e:  # malformed request; keep serving
                    resp = {"error": f"{type(e).__name__}: {e}"}
                with span("serve.reply"):
                    f.write((json.dumps(resp) + "\n").encode())
                    f.flush()
            if counter.bump() and max_requests is not None:
                return


class _Counter:
    """Requests answered by all connections (serve.py:124-140)."""

    def __init__(self, limit):
        self.limit = limit
        self.n = 0
        self._lock = threading.Lock()

    def bump(self) -> bool:
        """Count one; True once the limit is reached."""
        with self._lock:
            self.n += 1
            return self.limit is not None and self.n >= self.limit

    def done(self) -> bool:
        with self._lock:
            return self.limit is not None and self.n >= self.limit


def serve(policy, host: str, port: int, max_requests=None, ready_cb=None,
          concurrency: int = 1, window_ms: float = 5.0,
          max_batch: int = 8) -> int:
    """Accept loop; returns the requests served after ``max_requests``
    (serve.py:143-200). ``concurrency == 1``: one client at a time, on the
    policy itself. ``concurrency > 1``: a session per connection in its own
    thread, the sessions' replans micro-batched (serving.py); the batcher,
    every wave of it captured, is built before the server listens."""
    batcher = None
    if concurrency > 1:
        from dadiff_tpu_torch.serving import BatchedPlanner

        batcher = BatchedPlanner(policy, max_batch=max_batch,
                                 window_ms=window_ms)
    counter = _Counter(max_requests)

    def stats():
        return server_counters(batcher, counter)

    handle = make_handler(policy, stats)
    threads, n_conns = [], 0
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, port))
            srv.listen(max(1, concurrency))
            bound_port = srv.getsockname()[1]
            print(f"serving on {host}:{bound_port} (concurrency="
                  f"{concurrency})", flush=True)
            if ready_cb is not None:
                ready_cb(bound_port)
            srv.settimeout(0.2)
            while not counter.done():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    threads = [t for t in threads if t.is_alive()]
                    continue
                conn.settimeout(None)
                conn_id, n_conns = n_conns, n_conns + 1
                if batcher is None:
                    _serve_connection(conn, handle, counter, max_requests,
                                      conn_id)
                    continue
                session = make_handler(batcher.session(seed=conn_id), stats)
                t = threading.Thread(target=_serve_connection,
                                     args=(conn, session, counter,
                                           max_requests, conn_id),
                                     daemon=True)
                t.start()
                threads.append(t)
    finally:
        for t in threads:
            t.join(timeout=5.0)
        if batcher is not None:
            batcher.close()
    return counter.n


def server_counters(batcher=None, counter=None) -> dict:
    """The counters a ``stats`` request answers: the wave runner's, the
    batcher's where there is one, and the requests answered."""
    from dadiff_tpu_torch.ops.planner import _WaveRunner

    out = _WaveRunner.counters()
    if batcher is not None:
        out.update(batcher.counters())
    if counter is not None:
        out["answered"] = counter.n
    return out


def policy_from_args(args):
    """The policy the server flags describe, on its device, and the
    planning steps it takes (the set-up of :func:`main` and of
    bench_serve)."""
    from dadiff_tpu_torch.cli import (
        ENV_TO_DATASET,
        build_policy_from_args,
        load_model,
        planning_timesteps,
        resolve_device,
    )

    device = resolve_device(args.device)
    dataset_spec = args.dataset or ENV_TO_DATASET.get(args.env)
    if dataset_spec is None:
        raise SystemExit(f"No default dataset for {args.env}; pass --dataset")
    diffusion, dataset = load_model(args.checkpoint, dataset_spec,
                                    device=device, use_ema=args.use_ema)
    steps = planning_timesteps(args, diffusion, dataset)
    return build_policy_from_args(args, diffusion, dataset, dataset_spec,
                                  steps), steps


def main(argv=None):
    args = build_server_parser().parse_args(argv)
    policy, _ = policy_from_args(args)
    serve(policy, args.host, args.port, max_requests=args.max_requests,
          concurrency=args.concurrency, window_ms=args.batch_window_ms,
          max_batch=args.max_batch)


if __name__ == "__main__":
    main()
