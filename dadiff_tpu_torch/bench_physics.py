"""Time one env step of the exact planar physics on the card, host-driven
and as a CUDA-graph replay, for each env and constraint solver.

    python -m dadiff_tpu_torch.bench_physics

Prints one JSON line per (env, solver): ms per env step from CUDA events,
host-driven and replayed, the ops one env step dispatches (each one launch
on the card), the constraint rows and the frame skip, then the card's name
and power limit. ENVS envs in float32 from gymnasium resets, ITERS solver
iterations (the CLI's default). Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess

ENVS = 30
ITERS = 100
SOLVERS = ("jacobi", "pgs")
# timed env steps per measurement: a PGS step dispatches ~0.6-1.6M ops
REPS = {"jacobi": 10, "pgs": 2}


def _ms(fn, reps: int) -> float:
    """CUDA-event ms per call of ``fn``, after one untimed call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _count_ops(fn) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def time_env_step(env) -> dict:
    """One float32 env step of ``env`` for ENVS envs from gymnasium resets
    (seeds 0..ENVS-1) under uniform random actions: the ops it dispatches,
    and its ms host-driven and as a replay of its CUDA graph."""
    import numpy as np
    import torch

    states = [env.reset_state(s) for s in range(ENVS)]
    qpos, qvel = (torch.as_tensor(np.stack([s[i] for s in states]),
                                  dtype=torch.float32, device="cuda")
                  for i in (0, 1))
    g = torch.Generator(device="cuda").manual_seed(0)
    u = torch.rand(ENVS, env.act_dim, generator=g, device="cuda") * 2 - 1

    def step():
        env.step_batch(qpos, qvel, u)

    reps = REPS[env.phys.solver]
    ops = _count_ops(step)
    host_ms = _ms(step, reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return {"env": env.ENV_NAME, "solver": env.phys.solver,
            "iters": env.phys.solver_iters, "envs": ENVS,
            "integrator": env.model.integrator, "frames": env.FRAME_SKIP,
            "rows": env.phys.n_rows, "ops_per_env_step": ops,
            "host_driven_ms": host_ms, "graph_ms": _ms(graph.replay, reps)}


def main() -> list:
    import torch

    from dadiff_tpu_torch.envs.locomotion_jax import PHYSICS_ENVS

    if not torch.cuda.is_available():
        raise SystemExit("bench_physics needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rows = []
    for cls in PHYSICS_ENVS.values():
        for solver in SOLVERS:
            row = time_env_step(cls(solver_iters=ITERS, solver=solver))
            row["card"] = card
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(card, flush=True)
    return rows


if __name__ == "__main__":
    main()
