"""Collect locomotion expert data with the batched MPPI planner: plan on
the card (the learned simulator, refitted every iteration on everything
gathered so far, or exact planar physics with ``--backend physics``),
execute on real gymnasium envs on the host (envs/mppi_tpu.py).
Counterpart of the JAX package's scripts/collect_mppi_tpu.py.

    python -m dadiff_tpu_torch.collect_mppi_tpu --env Hopper-v5 \\
        --seed-data npz:data/hopper_mppi.npz npz:data/hopper_random.npz \\
        --episodes 200 --batch-envs 16 --horizon 12 --n-samples 1024 \\
        --n-exec 4 --iterations 8 --sim-steps 12000 --sim-hidden 512 512 \\
        --sim-ensemble 4 --explore-sigma 0.15 --seed 5 \\
        --out data/hopper_engine.npz

The envs are gymnasium's: the command needs gymnasium and mujoco
installed. ``--device cpu`` runs the planner on the host.
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Collect locomotion expert data "
                                            "with the batched MPPI planner",
                                allow_abbrev=False)
    p.add_argument("--env", type=str, default="HalfCheetah-v5")
    p.add_argument("--seed-data", type=str, nargs="+", required=True,
                   help="dataset spec(s) for simulator bootstrap (npz:...); "
                        "multiple specs are concatenated (mix expert + "
                        "random for coverage)")
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--max-steps", type=int, default=1000)
    p.add_argument("--batch-envs", type=int, default=8)
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--n-samples", type=int, default=256)
    p.add_argument("--lam", type=float, default=0.3)
    p.add_argument("--sigma", type=float, default=0.4)
    p.add_argument("--n-exec", type=int, default=2,
                   help="actions executed open-loop per replan")
    p.add_argument("--explore-sigma", type=float, default=0.0,
                   help="execution-time action noise on 1/3 of the envs "
                        "(diversity/recovery data)")
    p.add_argument("--noise-beta", type=float, default=0.0,
                   help="AR(1) low-pass coefficient of the MPPI search "
                        "noise along the horizon (0 = white)")
    p.add_argument("--smooth-weight", type=float, default=0.0,
                   help="jerk penalty weight in the MPPI candidate score: "
                        "w * sum ||a_{t+1}-a_t||^2 subtracted from returns")
    p.add_argument("--explore-beta", type=float, default=0.0,
                   help="AR(1) low-pass of the execution-time exploration "
                        "noise (0 = white; stationary std stays "
                        "--explore-sigma)")
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--sim-steps", type=int, default=4000)
    p.add_argument("--sim-hidden", type=int, nargs="+", default=[256, 256])
    p.add_argument("--sim-ensemble", type=int, default=1,
                   help="ensemble size; >1 enables PETS-style trajectory "
                        "sampling (each candidate scored under one member)")
    p.add_argument("--backend", type=str, default="learned",
                   choices=["learned", "physics"],
                   help="'physics' rolls MPPI candidates on the exact "
                        "planar dynamics (envs/locomotion_jax.py): no model "
                        "error, no simulator fit (HalfCheetah/Hopper/"
                        "Walker2d)")
    p.add_argument("--physics-solver-iters", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cpu = host-only smoke runs")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from dadiff_tpu_torch.cli import resolve_device
    from dadiff_tpu_torch.datasets.sources import (
        load_episodes,
        save_episodes_npz,
    )
    from dadiff_tpu_torch.envs.mppi_tpu import collect_mppi_tpu_episodes

    device = resolve_device(args.device)
    seed_eps = []
    for spec in args.seed_data:
        seed_eps.extend(load_episodes(spec))
    rets = [float(e["rewards"].sum()) for e in seed_eps if "rewards" in e]
    print(f"seed data: {len(seed_eps)} episodes (mean return "
          f"{sum(rets) / max(1, len(seed_eps)):.1f})", flush=True)

    t0 = time.time()
    episodes = collect_mppi_tpu_episodes(
        args.env, n_episodes=args.episodes, seed_episodes=seed_eps,
        max_steps=args.max_steps, batch_envs=args.batch_envs,
        horizon=args.horizon, n_samples=args.n_samples, lam=args.lam,
        sigma=args.sigma, n_exec=args.n_exec, noise_beta=args.noise_beta,
        smooth_weight=args.smooth_weight, explore_sigma=args.explore_sigma,
        explore_beta=args.explore_beta, n_iterations=args.iterations,
        sim_steps=args.sim_steps, sim_hidden=tuple(args.sim_hidden),
        sim_ensemble=args.sim_ensemble, dynamics_backend=args.backend,
        physics_solver_iters=args.physics_solver_iters,
        checkpoint_path=args.out, seed=args.seed, device=device)
    dt = time.time() - t0

    rets = [float(e["rewards"].sum()) for e in episodes]
    print(f"collected {len(episodes)} episodes in {dt / 60:.1f} min "
          f"({len(episodes) / (dt / 3600):.0f} eps/hr): return "
          f"mean={np.mean(rets):.1f} max={np.max(rets):.1f} "
          f"min={np.min(rets):.1f}", flush=True)
    save_episodes_npz(args.out, episodes)
    print(f"saved -> {args.out}")
    return episodes


if __name__ == "__main__":
    main()
