"""Planning server: a policy behind newline-delimited JSON over TCP.

Counterpart of scripts/serve.py (make_handler :64, serve :143 with
concurrency 1, main :203). Micro-batching of concurrent clients
(the JAX package's serving.py) is not ported yet.

    python -m dadiff_tpu_torch.serve --checkpoint model.pt \\
        --dataset npz:data/pointmaze_umaze_expert.npz \\
        --policy-type dynamics-aware --n-candidates 8 --megakernel --port 7033

Every flag of the evaluate CLI applies (cli.build_eval_parser): the
samplers, warm start (``--warm-start-t``, ``--warm-start-auto``), a
consistency student with ``--sampler consistency``.

Protocol (one JSON object per line, one response per request):
    {"obs": [..flat obs..]}          -> {"action": [...], "plan_ms": t}
    {"obs": [...], "plan": true}     -> adds "plan": the normalized (H, D) plan
    {"reset": true}                  -> {"ok": true}  (a new episode: clears
                                        the action buffer and warm state)
    {"ping": true}                   -> {"ok": true, "policy": "...", ...}
Malformed requests get {"error": "..."} and the connection stays up.
"""

from __future__ import annotations

import argparse
import json
import socket
import time

import numpy as np


def build_server_parser() -> argparse.ArgumentParser:
    from dadiff_tpu_torch.cli import build_eval_parser

    p = build_eval_parser()
    p.description = "Serve a planning policy over TCP (JSON lines)"
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=7033)
    p.add_argument("--max-requests", type=int, default=None,
                   help="exit after N requests")
    return p


def make_handler(policy):
    """Request dict -> response dict, no socket concerns (serve.py:64-105)."""

    def handle(req: dict) -> dict:
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
        if req.get("plan"):
            # full replan: return the plan AND refill the buffer from it
            traj = policy.plan(obs)
            policy.action_buffer.clear()
            policy._fill_action_buffer(traj)
            policy._actions_taken += 1
            action = policy.action_buffer.pop(0)
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


def serve(policy, host: str, port: int, max_requests=None, ready_cb=None) -> int:
    """Accept loop, one client at a time; returns the requests served after
    ``max_requests`` (serve.py:143-200 with concurrency 1)."""
    handle = make_handler(policy)
    n = 0
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        bound_port = srv.getsockname()[1]
        print(f"serving on {host}:{bound_port}", flush=True)
        if ready_cb is not None:
            ready_cb(bound_port)
        while max_requests is None or n < max_requests:
            conn, _ = srv.accept()
            with conn, conn.makefile("rwb") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        resp = handle(json.loads(line))
                    except Exception as e:  # malformed request; keep serving
                        resp = {"error": f"{type(e).__name__}: {e}"}
                    f.write((json.dumps(resp) + "\n").encode())
                    f.flush()
                    n += 1
                    if max_requests is not None and n >= max_requests:
                        break
    return n


def main(argv=None):
    args = build_server_parser().parse_args(argv)
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
    sampling_timesteps = planning_timesteps(args, diffusion, dataset)
    policy = build_policy_from_args(args, diffusion, dataset, dataset_spec,
                                    sampling_timesteps)
    serve(policy, args.host, args.port, max_requests=args.max_requests)


if __name__ == "__main__":
    main()
