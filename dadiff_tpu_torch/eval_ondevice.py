"""On-device batched evaluation: plans, actions and env physics all on the
card, with no host sync until the final metrics. Counterpart of the JAX
package's scripts/eval_ondevice.py :21-206.

    python -m dadiff_tpu_torch.eval_ondevice --checkpoint logs/.../checkpoint_step_N.pt \
        --dataset npz:data/pointmaze_umaze_expert.npz --batch 128 \
        --n-replans 20 --action-horizon 16 --projection --n-candidates 8 \
        --megakernel --seed 42

One untimed run (seed), then the timed run (seed + 1) whose metrics are
reported: success rate, mean reward and episodes/hour, printed as JSON and
saved through envs/host.py ``save_results`` with the JAX file's keys.
``--sampler ddim|dpmpp|consistency`` and ``--warm-start-t K`` plan through
the module path (a distilled student needs ``--sampler consistency``, where
``--sampling-timesteps`` is the model-call budget); ``--megakernel`` is the
DDPM chain and refuses both. ``--device cpu`` runs the plain versions. As
the JAX script, it runs one device: the mesh is the evaluator's,
``envs/rollout.py`` ``make_ondevice_evaluator(mesh=)``, in a torchrun world.

    python -m dadiff_tpu_torch.eval_ondevice --checkpoint student.pt \
        --dataset npz:data/pointmaze_umaze_expert.npz --batch 128 \
        --n-replans 20 --action-horizon 16 --projection --n-candidates 8 \
        --sampler consistency --sampling-timesteps 1
"""

from __future__ import annotations

import argparse
import json
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="On-device batched evaluation",
                                allow_abbrev=False)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--dataset", type=str, required=True,
                   help="dataset spec for the normalizer and the sysID")
    p.add_argument("--map", type=str, default="umaze",
                   choices=["umaze", "open", "medium", "large"])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--n-replans", type=int, default=16)
    p.add_argument("--action-horizon", type=int, default=16)
    p.add_argument("--sampling-timesteps", type=int, default=None)
    p.add_argument("--sampler", type=str, default="ddpm",
                   choices=["ddpm", "ddim", "dpmpp", "consistency"],
                   help="consistency = few-step distilled student checkpoint "
                        "(--sampling-timesteps is the model-call budget)")
    p.add_argument("--projection", action="store_true",
                   help="dynamics-aware projection after every denoise step")
    p.add_argument("--n-candidates", type=int, default=1,
                   help="best-of-N candidate plans per replan wave")
    p.add_argument("--warm-start-t", type=int, default=None,
                   help="warm-start replans after the first from the shifted "
                        "previous plan re-noised to this timestep")
    p.add_argument("--projection-schedule", type=str, default="noise_schedule",
                   choices=["constant", "linear", "quadratic", "noise_schedule"])
    p.add_argument("--wall-aware", action="store_true",
                   help="revert plan rows the projection drags into wall "
                        "cells of the selected map")
    p.add_argument("--collision", type=str, default="disc",
                   choices=["disc", "axis"],
                   help="wall contact: disc push-out (default) or axis-freeze")
    p.add_argument("--wall-slack", type=float, default=0.02,
                   help="soft-contact penetration allowance of the disc model")
    p.add_argument("--megakernel", action="store_true",
                   help="run every replan wave (all candidates, conditioning, "
                        "per-step projection, best-of-N selection) through "
                        "the planner chain's CUDA kernels (ops/planner.py)")
    p.add_argument("--mega-group-chains", type=int, default=64,
                   help="chains per group of the planner chain: a wave runs "
                        "the candidates padded up to whole groups, and draws "
                        "its noise for the padded count (a count that "
                        "divides them changes nothing)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--results-dir", type=str, default="./results",
                   help="directory for the timestamped results JSON ('' "
                        "disables)")
    p.add_argument("--use-ema", action="store_true",
                   help="plan with the EMA weights if the checkpoint has them")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from dadiff_tpu_torch.cli import load_model, resolve_device
    from dadiff_tpu_torch.envs.pointmaze_jax import PointMazeJax
    from dadiff_tpu_torch.envs.rollout import make_ondevice_evaluator
    from dadiff_tpu_torch.guides.sampling import ProjectionSpec
    from dadiff_tpu_torch.ops.projection import NormStats

    device = resolve_device(args.device)
    diffusion, dataset = load_model(args.checkpoint, args.dataset,
                                    device=device, use_ema=args.use_ema)
    if dataset.checkpoint_config.get("consistency") and \
            args.sampler != "consistency":
        raise SystemExit("checkpoint is a consistency-distilled student; "
                         "pass --sampler consistency")
    env = PointMazeJax(map_name=args.map, collision=args.collision,
                       wall_slack=args.wall_slack)
    stats = NormStats.from_normalizer(dataset.normalizer, device)

    projection = P = None
    if args.projection:
        from dadiff_tpu_torch.datasets.sources import load_episodes
        from dadiff_tpu_torch.dynamics.projection import ProjectionMatrixBuilder
        from dadiff_tpu_torch.dynamics.registry import get_dynamics_for_env

        A, B, state_dim, action_dim = get_dynamics_for_env(
            "PointMaze_UMaze-v3", episodes=load_episodes(args.dataset))
        P = torch.as_tensor(
            ProjectionMatrixBuilder(A, B, state_dim, action_dim)
            .get_projection_matrix(diffusion.horizon),
            dtype=torch.float32, device=device)
        wall_grid = None
        if args.wall_aware:
            wall_grid = tuple(tuple(int(v) for v in row) for row in env.maze)
        projection = ProjectionSpec(state_dim=state_dim,
                                    schedule=args.projection_schedule,
                                    wall_grid=wall_grid)

    evaluator = make_ondevice_evaluator(
        diffusion, env, action_horizon=args.action_horizon,
        n_replans=args.n_replans, sampling_timesteps=args.sampling_timesteps,
        projection=projection, n_candidates=args.n_candidates,
        warm_start_t=args.warm_start_t, sampler=args.sampler,
        use_megakernel=args.megakernel, P=P, stats=stats,
        mega_group_chains=args.mega_group_chains)

    def run(seed):
        generator = torch.Generator(device=device).manual_seed(seed)
        t0 = time.perf_counter()
        metrics, _ = evaluator(generator, stats, args.batch, P)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return metrics, time.perf_counter() - t0

    _, first_s = run(args.seed)          # builds, captures the wave's graph
    metrics, run_s = run(args.seed + 1)  # the timed run

    out = {
        "mode": "on-device plan->step->replan",
        "megakernel": bool(args.megakernel),
        "projection": bool(args.projection),
        "wall_aware": bool(args.wall_aware),
        "n_candidates": args.n_candidates,
        "warm_start_t": args.warm_start_t,
        "sampler": args.sampler,
        # model calls of a replan: the first, and each later one
        "model_calls_per_replan": list(evaluator.model_calls),
        "batch": args.batch,
        "env_steps_per_episode": args.n_replans * args.action_horizon,
        "success_rate": float(metrics.success_rate),
        "mean_reward": float(metrics.mean_reward),
        "mean_final_distance": float(metrics.mean_final_distance),
        "wallclock_s": run_s,
        "episodes_per_hour": args.batch / run_s * 3600,
        # the untimed first run (the JAX script's compile time)
        "compile_s": first_s,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    print(json.dumps(out, indent=2))
    if args.results_dir:
        from dadiff_tpu_torch.envs.host import save_results

        per_reward = metrics.per_env_reward.cpu().numpy().astype(np.float64)
        per_succ = metrics.per_env_success.cpu().numpy()
        n_steps = args.n_replans * args.action_horizon
        path = save_results(
            {
                "mean_reward": float(per_reward.mean()),
                "std_reward": float(per_reward.std()),
                "mean_length": float(n_steps),
                "std_length": 0.0,
                "success_rate": float(per_succ.mean()),
                "episode_rewards": [float(r) for r in per_reward],
                "episode_lengths": [n_steps] * args.batch,
            },
            policy_type="ondevice-maze", env_name=f"PointMaze_{args.map}",
            results_dir=args.results_dir, checkpoint=args.checkpoint,
            dataset=args.dataset, n_episodes=args.batch,
            sampling_timesteps=args.sampling_timesteps, seed=args.seed,
            extra=out | {
                "action_horizon": args.action_horizon,
                "n_replans": args.n_replans,
                "collision": args.collision,
                "wall_slack": args.wall_slack,
                "per_env_success": [bool(s) for s in per_succ],
                "use_ema": args.use_ema,
            })
        out["results_path"] = path
        print(f"results saved to {path}")
    return out


if __name__ == "__main__":
    main()
