"""DAgger-style relabelling of a diffusion policy's visited states: start
states subsampled from the policy's recorded rollouts (``python -m
dadiff_tpu_torch.evaluate ... --batched --save-episodes visited.npz``) are
injected into real MuJoCo envs, and the MPPI expert, on an ensemble
simulator fitted to the pool and the visited rollouts, rolls a short
segment from each (envs/mppi_tpu.py). Merge the output into the training
mix with a ``+``-joined dataset spec and retrain. Counterpart of the JAX
package's scripts/dagger_relabel.py.

    python -m dadiff_tpu_torch.dagger_relabel --env HalfCheetah-v5 \\
        --visited data/hc_visited_i1.npz \\
        --pool npz:data/halfcheetah_mppi.npz \\
        --out data/hc_dagger.npz

The envs are gymnasium's: the command needs gymnasium and mujoco
installed. ``--device cpu`` runs the planner on the host.
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DAgger relabelling with the "
                                            "MPPI expert",
                                allow_abbrev=False)
    p.add_argument("--env", type=str, default="HalfCheetah-v5")
    p.add_argument("--visited", type=str, required=True,
                   help="npz of the policy's own rollouts (evaluate "
                        "--save-episodes output)")
    p.add_argument("--pool", type=str, nargs="+", required=True,
                   help="dataset spec(s) for the simulator fit pool (the "
                        "training mix; visited rollouts are added "
                        "automatically)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--segment-len", type=int, default=48,
                   help="expert segment length in real env steps")
    p.add_argument("--stride", type=int, default=25,
                   help="visited-state subsampling stride within an episode")
    p.add_argument("--skip-initial", type=int, default=10,
                   help="skip the first N steps of each visited episode")
    p.add_argument("--max-segments", type=int, default=400)
    p.add_argument("--batch-envs", type=int, default=16)
    p.add_argument("--horizon", type=int, default=12,
                   help="MPPI planning horizon (control steps)")
    p.add_argument("--n-samples", type=int, default=1024)
    p.add_argument("--lam", type=float, default=0.3)
    p.add_argument("--sigma", type=float, default=0.4)
    p.add_argument("--n-exec", type=int, default=4)
    p.add_argument("--sim-hidden", type=int, nargs="+", default=[512, 512])
    p.add_argument("--sim-steps", type=int, default=12000)
    p.add_argument("--sim-ensemble", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from dadiff_tpu_torch.cli import resolve_device
    from dadiff_tpu_torch.datasets.sources import (
        load_episodes,
        save_episodes_npz,
    )
    from dadiff_tpu_torch.envs.mppi_tpu import dagger_relabel_episodes

    device = resolve_device(args.device)
    visited = load_episodes(f"npz:{args.visited}")
    pool = []
    for spec in args.pool:
        pool.extend(load_episodes(spec))
    print(f"visited: {len(visited)} episodes; sim pool: {len(pool)} "
          f"episodes", flush=True)

    t0 = time.time()
    segments = dagger_relabel_episodes(
        args.env, visited, pool, segment_len=args.segment_len,
        stride=args.stride, skip_initial=args.skip_initial,
        max_segments=args.max_segments, batch_envs=args.batch_envs,
        horizon=args.horizon, n_samples=args.n_samples, lam=args.lam,
        sigma=args.sigma, n_exec=args.n_exec,
        sim_hidden=tuple(args.sim_hidden), sim_steps=args.sim_steps,
        sim_ensemble=args.sim_ensemble, seed=args.seed, device=device)
    dt = time.time() - t0

    rets = [float(s["rewards"].sum()) for s in segments]
    steps = sum(len(s["rewards"]) for s in segments)
    print(f"relabeled {len(segments)} segments ({steps} real env steps) in "
          f"{dt / 60:.1f} min: segment return mean={np.mean(rets):.1f} "
          f"max={np.max(rets):.1f} min={np.min(rets):.1f}", flush=True)
    save_episodes_npz(args.out, segments)
    print(f"saved -> {args.out}")
    return segments


if __name__ == "__main__":
    main()
