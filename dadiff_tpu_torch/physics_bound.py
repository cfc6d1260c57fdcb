"""K-step return-error bound of the exact planar physics.

Counterpart of the JAX package's scripts/physics_bound.py, with its flags
and its JSON schema: recorded action windows are replayed from recorded
start states through the port's planar physics
(``envs/locomotion_jax.physics_env_for``, PGS at ``--solver-iters``), and
each window's K-step return is compared with the recorded MuJoCo return.
The physics is MuJoCo's up to solver and precision noise, so the residual
measures chaos amplification of rounding, not model error. K* is the
largest K whose p90 error is within ``--tolerance`` of the mean |return|.
The windows come from ``surrogate_bound.segments_from_episodes``, the
held-out episodes (every ``--holdout-every``-th) of ``--data`` as in the
learned simulator's bound.

    python -m dadiff_tpu_torch.physics_bound --env Hopper-v5 \\
        --data npz:data/hopper_mppi.npz --k 1 2 4 8

Runs on the card (no gymnasium needed); ``--device cpu`` runs on the host.
``--x64`` runs the physics in float64. The report goes to ``--out``, by
default ``build/dadiff_tpu_torch/physics_bound_<env>_<dtype>.json``.
PGS dispatches ~925,000 ops a Hopper env step (bench_physics counts them),
so on the card each step costs seconds: choose ``--k`` accordingly.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="K-step return-error bound of "
                                            "the exact planar physics",
                                allow_abbrev=False)
    p.add_argument("--env", type=str, default="HalfCheetah-v5",
                   help="HalfCheetah-v5 / Hopper-v5 / Walker2d-v5")
    p.add_argument("--data", type=str, nargs="+", required=True)
    p.add_argument("--visited", type=str, default=None)
    p.add_argument("--holdout-every", type=int, default=7,
                   help="use every Nth episode (surrogate_bound's held-out "
                        "subset)")
    p.add_argument("--k", type=int, nargs="+", default=[4, 8, 16, 32, 64, 128])
    p.add_argument("--stride", type=int, default=60)
    p.add_argument("--skip-initial", type=int, default=5)
    p.add_argument("--solver-iters", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=0.10)
    p.add_argument("--x64", action="store_true",
                   help="run the physics in float64 (default: float32)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--max-segments", type=int, default=512)
    p.add_argument("--out", type=str, default=None)
    return p


def measure(name, episodes, rollout, args) -> dict:
    """Per K: segments, mean |R_real|, p50/p90 |R_sim - R_real|, whether
    quotable, wall seconds; then K* (physics_bound.py:79-126)."""
    from dadiff_tpu_torch.surrogate_bound import segments_from_episodes

    rows = []
    for K in args.k:
        seg, excluded = segments_from_episodes(episodes, K, args.stride,
                                               args.skip_initial)
        if seg is None:
            print(f"[{name}] K={K}: no segments")
            continue
        obs0, acts, rews, _ = seg
        if len(obs0) > args.max_segments:
            idx = np.random.RandomState(0).choice(
                len(obs0), args.max_segments, replace=False)
            obs0, acts, rews = obs0[idx], acts[idx], rews[idx]
        t0 = time.time()
        sim_rew = rollout(obs0, acts)
        dt = time.time() - t0
        r_real = rews.sum(1)
        err = np.abs(sim_rew.sum(1) - r_real)
        scale = float(np.mean(np.abs(r_real)))
        rows.append({
            "K": K,
            "n_segments": int(len(r_real)),
            "n_episodes_excluded": int(excluded),
            "mean_abs_R_real": scale,
            "err_p50": float(np.percentile(err, 50)),
            "err_p90": float(np.percentile(err, 90)),
            "quotable": bool(np.percentile(err, 90)
                             <= args.tolerance * max(scale, 1e-9)),
            "wall_s": round(dt, 2),
        })
        r = rows[-1]
        print(f"[{name}] K={K}: n={r['n_segments']} |R|={scale:.2f} err "
              f"p50={r['err_p50']:.3f} p90={r['err_p90']:.3f} "
              f"quotable={r['quotable']}", flush=True)
    if not rows:
        return None
    k_star = max((r["K"] for r in rows if r["quotable"]), default=0)
    print(f"[{name}] K* (p90 err <= {args.tolerance:.0%} of |R|) = {k_star}")
    return {"rows": rows, "k_star": k_star}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from dadiff_tpu_torch.cli import resolve_device
    from dadiff_tpu_torch.datasets.sources import as_spec, load_episodes
    from dadiff_tpu_torch.envs.locomotion_jax import physics_env_for

    device = resolve_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    env = physics_env_for(args.env, solver_iters=args.solver_iters)

    @torch.no_grad()
    def rollout(obs0, acts):
        qpos, qvel = env.obs_to_state(
            torch.as_tensor(obs0, dtype=dtype, device=device))
        _, rew = env.rollout(qpos, qvel, torch.as_tensor(
            acts, dtype=dtype, device=device))
        return rew.cpu().numpy()

    pool = []
    for spec in args.data:
        pool.extend(load_episodes(spec))
    held = pool[::args.holdout_every]
    print(f"pool {len(pool)} episodes -> evaluating on {len(held)} "
          f"(every {args.holdout_every}th, matching surrogate_bound)",
          flush=True)
    report = {
        "env": args.env,
        "backend": "planar_physics",
        "dtype": "float64" if args.x64 else "float32",
        "solver_iters": args.solver_iters,
        "tolerance": args.tolerance,
        "distributions": {},
    }
    out = measure("held-out fit mix", held, rollout, args)
    if out:
        report["distributions"]["heldout"] = out
    if args.visited:
        out = measure("policy-visited", load_episodes(as_spec(args.visited)),
                      rollout, args)
        if out:
            report["distributions"]["visited"] = out
    path = args.out or (f"build/dadiff_tpu_torch/physics_bound_"
                        f"{args.env.replace('-', '_')}_{report['dtype']}.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"saved -> {path}")
    return report


if __name__ == "__main__":
    main()
