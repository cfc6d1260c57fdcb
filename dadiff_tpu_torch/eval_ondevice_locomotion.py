"""On-device locomotion evaluation: plans, actions and the simulator of a
batch of envs all on the card. Counterpart of the JAX package's
scripts/eval_ondevice_locomotion.py, with both of its backends:

- ``--backend learned`` (the default, as in JAX): an ensemble of
  DynamicsMLPs (``--sim-ensemble``, one model at 1) is fitted for
  ``--model-steps`` steps to the transitions of ``--dataset`` (the data the
  planner trained on) and the loop steps its members' mean
  (envs/learned_model.py). Returns are model-based (surrogate): the keys
  ``model_based_mean_return`` and ``model_based_return_std``, the held-out
  one-step R^2 as ``simulator_r2_mean``; their bound is measured by
  ``python -m dadiff_tpu_torch.surrogate_bound``.
- ``--backend physics``: exact planar MuJoCo dynamics
  (envs/locomotion_jax.py); returns are real. A run is refused when
  ``--action-horizon`` exceeds the env's measured chunk bound K*
  (results/physics_bound_<env>_float32.json, the contiguous quotable
  prefix), unless ``--allow-unquotable``.

    python -m dadiff_tpu_torch.eval_ondevice_locomotion \
        --checkpoint logs/.../checkpoint_step_N.pt \
        --dataset "npz:data/hopper_mppi.npz+npz:data/hopper_engine_r5.npz" \
        --env Hopper-v5 --backend physics --solver jacobi --batch 30 \
        --n-replans 992 --action-horizon 1 --skip-conditioned-action --seed 42

Initial observations are the gymnasium resets at seeds seed .. seed+B-1,
drawn from the committed planar model's constants (envs/locomotion_jax.py
``reset_obs``), so the card's machine needs no gymnasium; HalfCheetah,
Hopper and Walker2d are therefore the envs of both backends (they are also
the only ones with a reward model). One untimed run (seed), which captures
the CUDA graphs on the card, then the timed run (seed + 1), which replays
them and whose returns are reported, as JSON with the JAX script's keys
and in a results file (envs/host.py ``save_results``, policy type
``ondevice-<backend>``). Lines before the result give ms per replan, per
plan and per simulator step (CUDA events on the card), episodes/hour and,
for the learned backend, ms per training step of the simulator.
"""

from __future__ import annotations

import argparse
import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chunk_bound_path(env: str) -> str:
    env_key = env.replace("/", "_").replace("-", "_")
    return os.path.join(ROOT, "results",
                        f"physics_bound_{env_key}_float32.json")


def _check_chunk_bound(args):
    """Refuse a run whose executed chunk exceeds the env's measured K*
    (eval_ondevice_locomotion.py:31-73): K* is the last K of the contiguous
    quotable prefix of the held-out rows, so an isolated quotable K above a
    failing one does not raise it."""
    path = chunk_bound_path(args.env)
    if not os.path.exists(path):
        print(f"WARNING: no measured chunk bound at {path}; returns are "
              "unbounded by measurement — run scripts/physics_bound.py",
              flush=True)
        return
    with open(path) as f:
        bound = json.load(f)
    rows = sorted(bound.get("distributions", {}).get("heldout", {})
                  .get("rows", []), key=lambda r: r["K"])
    k_star = 0
    for r in rows:
        if not r.get("quotable"):
            break
        k_star = r["K"]
    if args.action_horizon > k_star:
        msg = (f"--action-horizon {args.action_horizon} exceeds the "
               f"measured K* = {k_star} for {args.env} at float32 "
               f"({path}): per-chunk returns are not quotable as "
               "real-env numbers at this length.")
        if args.allow_unquotable:
            print("WARNING: " + msg + " Proceeding (--allow-unquotable).",
                  flush=True)
        else:
            raise SystemExit(msg + " Pass --allow-unquotable to override.")
    else:
        print(f"chunk bound OK: action_horizon {args.action_horizon} <= "
              f"K* = {k_star} ({path})", flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="On-device locomotion eval "
                                            "(learned simulator or exact "
                                            "planar physics)",
                                allow_abbrev=False)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--dataset", type=str, required=True,
                   help="episode spec: trains the simulator + the normalizer")
    p.add_argument("--env", type=str, default="HalfCheetah-v5")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--n-replans", type=int, default=25)
    p.add_argument("--action-horizon", type=int, default=8)
    p.add_argument("--sampling-timesteps", type=int, default=None)
    p.add_argument("--sampler", type=str, default="ddpm",
                   choices=["ddpm", "ddim", "dpmpp", "consistency"])
    p.add_argument("--model-steps", type=int, default=3000,
                   help="dynamics-MLP training steps")
    p.add_argument("--sim-ensemble", type=int, default=4,
                   help="simulator ensemble size; the evaluator steps the "
                        "ensemble MEAN (the surrogate the measured error "
                        "bound applies to). 1 = single model.")
    p.add_argument("--backend", type=str, default="learned",
                   choices=["learned", "physics"],
                   help="'physics' = exact planar MuJoCo dynamics "
                        "(HalfCheetah/Hopper/Walker2d): returns are real. "
                        "'learned' = ensemble-mean DynamicsMLP: returns are "
                        "model-based, bounded by python -m "
                        "dadiff_tpu_torch.surrogate_bound.")
    p.add_argument("--solver-iters", type=int, default=100,
                   help="physics backend: constraint-solver iterations")
    p.add_argument("--solver", type=str, default="pgs",
                   choices=["pgs", "jacobi"],
                   help="physics backend: constraint solver; 'jacobi' "
                        "(parallel FISTA) is "
                        "one masked product per iteration — use it for long "
                        "loops on the card")
    p.add_argument("--skip-conditioned-action", action="store_true",
                   help="start execution at plan row 1 (the host MPC "
                        "locomotion protocol; physics backend only)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--results-dir", type=str, default="./results",
                   help="directory for the timestamped results JSON ('' "
                        "disables)")
    p.add_argument("--allow-unquotable", action="store_true",
                   help="physics backend: run even when --action-horizon "
                        "exceeds the env's "
                        "measured K* chunk bound; returns are then NOT "
                        "quotable as real-env numbers")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from dadiff_tpu_torch.cli import load_model, resolve_device
    from dadiff_tpu_torch.envs.locomotion_jax import (
        make_physics_locomotion_evaluator,
        physics_env_for,
    )
    from dadiff_tpu_torch.ops.projection import NormStats

    device = resolve_device(args.device)
    # the physics' products stay in float32; the U-Net's convs may take TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    diffusion, dataset = load_model(args.checkpoint, args.dataset,
                                    device=device)
    if dataset.checkpoint_config.get("consistency") and \
            args.sampler != "consistency":
        raise SystemExit("checkpoint is a consistency-distilled student; "
                         "pass --sampler consistency")
    stats = NormStats.from_normalizer(dataset.normalizer, device)

    physics = args.backend == "physics"
    try:
        # the resets' constants (and, for physics, the engine)
        env = physics_env_for(args.env, solver_iters=args.solver_iters,
                              solver=args.solver)
    except ValueError:
        raise SystemExit(
            f"--env {args.env}: the on-device locomotion loop covers "
            f"HalfCheetah, Hopper and Walker2d (their resets replay from the "
            f"committed planar models, and only they have a reward model)")
    sim_timing = {}
    if physics:
        print("backend: exact planar physics (no simulator fit; returns are "
              "real, bound: results/physics_bound_*.json)", flush=True)
        _check_chunk_bound(args)
        # exact dynamics: no fitted simulator, hence no held-out R^2
        metrics = {"r2_mean": None, "r2_min": None}
        evaluate = make_physics_locomotion_evaluator(
            diffusion, env, action_horizon=args.action_horizon,
            n_replans=args.n_replans,
            sampling_timesteps=args.sampling_timesteps, sampler=args.sampler,
            skip_conditioned_action=args.skip_conditioned_action)
    else:
        from dadiff_tpu_torch.datasets.sources import load_episodes
        from dadiff_tpu_torch.envs.learned_model import (
            make_ondevice_locomotion_evaluator,
            reward_model_for,
            train_dynamics_ensemble,
            train_dynamics_model,
        )

        episodes = load_episodes(args.dataset)
        print(f"fitting simulator on {len(episodes)} episodes ...",
              flush=True)
        fit = dict(n_steps=args.model_steps, seed=args.seed, verbose=True,
                   device=device)
        t0 = time.perf_counter()
        if args.sim_ensemble > 1:
            # the ensemble MEAN is the surrogate surrogate_bound bounds
            model, mstats, metrics = train_dynamics_ensemble(
                episodes, n_models=args.sim_ensemble, **fit)
        else:
            model, mstats, metrics = train_dynamics_model(episodes, **fit)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        fit_s = time.perf_counter() - t0
        sim_timing = {"sim_fit_s": fit_s,
                      "ms_per_sim_train_step": fit_s * 1e3
                      / max(args.model_steps, 1)}
        print(f"simulator held-out one-step R^2: "
              f"mean={metrics['r2_mean']:.4f} "
              f"min={metrics['r2_min']:.4f}; fit {fit_s:.3f} s, "
              f"{sim_timing['ms_per_sim_train_step']:.3f} ms a step "
              f"(host clock, set-up included)", flush=True)
        evaluate = make_ondevice_locomotion_evaluator(
            diffusion, model, mstats, reward_model_for(args.env),
            action_horizon=args.action_horizon, n_replans=args.n_replans,
            sampling_timesteps=args.sampling_timesteps, sampler=args.sampler)
    init_obs = torch.as_tensor(
        env.reset_obs(range(args.seed, args.seed + args.batch)),
        dtype=torch.float32, device=device)

    def run(seed):
        generator = torch.Generator(device=device).manual_seed(seed)
        t0 = time.perf_counter()
        out = evaluate(generator, stats, init_obs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    _, first_s = run(args.seed)            # builds, captures the graphs
    first_replan_ms = sum(evaluate.timing[0])
    (mean_ret, mean_len, returns), dt = run(args.seed + 1)

    plan_ms = np.array([p for p, _ in evaluate.timing])
    step_ms = np.array([s for _, s in evaluate.timing])
    # the replans that replayed the graphs (on the card: all of the timed
    # run's, since the first run captured them)
    timed = np.array(evaluate.replayed) if any(evaluate.replayed) \
        else np.ones(len(plan_ms), bool)
    clock = "CUDA events" if device.type == "cuda" else "host clock, CPU"
    timing = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "clock": clock,
        "graph": evaluate.graph,
        "ms_per_replan": float(np.mean((plan_ms + step_ms)[timed])),
        "ms_per_plan": float(np.mean(plan_ms[timed])),
        "ms_per_env_step": float(np.mean(step_ms[timed]))
        / args.action_horizon,
        "replans_timed": int(timed.sum()),
        "first_replan_ms": first_replan_ms,
        "episodes_per_hour": args.batch / dt * 3600.0,
        "first_run_s": first_s,
        **sim_timing,
    }
    if device.type == "cuda":
        timing["peak_memory_mib"] = torch.cuda.max_memory_allocated(
            device) / 2 ** 20
    print(f"ms per replan {timing['ms_per_replan']:.3f} (plan "
          f"{timing['ms_per_plan']:.3f}, "
          f"{'env' if physics else 'model'} steps "
          f"{timing['ms_per_env_step'] * args.action_horizon:.3f}; {clock}, "
          f"{timing['replans_timed']} replans of the timed run, "
          f"graph={evaluate.graph})", flush=True)
    print(f"ms per {'env' if physics else 'model'} step "
          f"{timing['ms_per_env_step']:.3f}; first replan "
          f"{timing['first_replan_ms']:.3f} ms (host-driven, untimed run)",
          flush=True)
    print(f"episodes/hour {timing['episodes_per_hour']:.1f} ({args.batch} "
          f"envs in {dt:.3f} s; untimed first run {first_s:.3f} s)",
          flush=True)

    returns = returns.double().cpu().numpy()
    n_steps = args.n_replans * args.action_horizon
    std = float(np.std(returns))
    result = {
        "env": args.env,
        "backend": args.backend,
        "sampler": args.sampler,
        "batch": args.batch,
        "env_steps_per_episode": n_steps,
        ("mean_return" if physics else "model_based_mean_return"):
            round(float(mean_ret), 2),
        ("return_std" if physics else "model_based_return_std"):
            round(std, 2),
        "return_se": round(std / max(args.batch, 1) ** 0.5, 2),
        "mean_alive_length": round(float(mean_len), 1),
        "wall_clock_s": round(dt, 3),
        "episodes_per_hour_per_chip": round(args.batch / dt * 3600.0, 1),
        "simulator_r2_mean": (None if metrics["r2_mean"] is None
                              else round(metrics["r2_mean"], 4)),
        "note": ("REAL returns: exact planar-physics dynamics (parity with "
                 "the JAX engine pinned in tests/test_torch_planar_physics"
                 ".py; K-step bound in results/physics_bound_*.json)"
                 if physics else
                 "model-based surrogate returns (learned simulator); "
                 "host-env MPC eval is ground truth"),
    }
    print(json.dumps(result), flush=True)
    if args.results_dir:
        from dadiff_tpu_torch.envs.host import save_results

        path = save_results(
            {
                "mean_reward": float(mean_ret),
                "std_reward": std,
                "mean_length": float(mean_len),
                "std_length": 0.0,
                "success_rate": None,
                "episode_rewards": [float(r) for r in returns],
                "episode_lengths": [n_steps] * args.batch,
            },
            policy_type=f"ondevice-{args.backend}",
            env_name=args.env,
            results_dir=args.results_dir,
            checkpoint=args.checkpoint,
            dataset=args.dataset,
            n_episodes=args.batch,
            sampling_timesteps=args.sampling_timesteps,
            seed=args.seed,
            extra={k: v for k, v in result.items() if k != "env"} | {
                "action_horizon": args.action_horizon,
                "n_replans": args.n_replans,
                "solver": args.solver if physics else None,
                "solver_iters": args.solver_iters if physics else None,
                "skip_conditioned_action": args.skip_conditioned_action,
                "timing": timing,
            },
        )
        print(f"results saved to {path}")
        result["results_path"] = path
    result["timing"] = timing
    return result


if __name__ == "__main__":
    main()
