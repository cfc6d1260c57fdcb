"""The measured error bound of the learned simulator's returns.

Held-out recorded action sequences are replayed through the ensemble-mean
surrogate (envs/learned_model.py) from the start states the real env
visited, and the surrogate's return is compared with the recorded return
segment by segment, as a function of the open-loop chunk length K. The
recorded data were collected in the real env, so its next states and
rewards are ground truth for those actions. Two distributions are
measured: held-out episodes of the fit mix, and with ``--visited`` a
policy's own rollouts (the ``--save-episodes`` output).

Per K: the p50/p90 absolute return error, the reward-model floor (the
reward model on REAL transitions against the recorded reward), the p90
residual of a cross-fitted affine calibration, the state nRMSE at K, and
whether the p90 error is within ``--tolerance`` of the mean |return| (K*
is the largest such K). Counterpart of the JAX package's
scripts/surrogate_bound.py, with its JSON schema
(results/surrogate_bound_<env>.json).

    python -m dadiff_tpu_torch.surrogate_bound --env HalfCheetah-v5 \\
        --data npz:data/halfcheetah_mppi.npz --out bound.json

The simulator trains and replays on the card; ``--device cpu`` runs it on
the host.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def segments_from_episodes(episodes, k, stride, skip_initial):
    """(obs0, acts, rews, real_next_obs) stacks of the length-k windows
    starting at ``skip_initial``, every ``stride`` steps, built per k (an
    episode too short for k is excluded from that k only). Returns (stacks
    or None, n_episodes_excluded)."""
    obs0, acts, rews, nxts = [], [], [], []
    excluded = 0
    for ep in episodes:
        o, a, r = ep["observations"], ep["actions"], ep["rewards"]
        n = len(a)
        if n - k <= skip_initial:
            excluded += 1
            continue
        for t in range(skip_initial, n - k, stride):
            obs0.append(o[t])
            acts.append(a[t:t + k])
            rews.append(r[t:t + k])
            nxts.append(o[t + 1:t + k + 1])
    if not obs0:
        return None, excluded
    return ((np.stack(obs0), np.stack(acts), np.stack(rews),
             np.stack(nxts)), excluded)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Measured error bound of the "
                                            "learned simulator's returns",
                                allow_abbrev=False)
    p.add_argument("--env", type=str, default="HalfCheetah-v5")
    p.add_argument("--data", type=str, nargs="+", required=True,
                   help="dataset spec(s) for the simulator fit pool")
    p.add_argument("--visited", type=str, default=None,
                   help="npz of the diffusion policy's own rollouts "
                        "(evaluate --save-episodes output): the on-policy "
                        "evaluation distribution")
    p.add_argument("--holdout-every", type=int, default=7,
                   help="every Nth pool episode is held out of the fit")
    p.add_argument("--k", type=int, nargs="+",
                   default=[4, 8, 16, 32, 64, 128])
    p.add_argument("--stride", type=int, default=60)
    p.add_argument("--skip-initial", type=int, default=5)
    p.add_argument("--sim-hidden", type=int, nargs="+", default=[512, 512])
    p.add_argument("--sim-steps", type=int, default=12000)
    p.add_argument("--sim-ensemble", type=int, default=4)
    p.add_argument("--tolerance", type=float, default=0.10,
                   help="quotability threshold: p90 |err| <= tol * "
                        "mean|R_real| defines K*")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p


def measure(name, episodes, *, rollout, reward_fn, obs_scale, ks, stride,
            skip_initial, tolerance):
    """The per-K rows of one distribution and its K* (printed as a table);
    None without usable segments. ``rollout(obs0, acts) -> (sim next obs
    (S, K, d), sim rewards (S, K))`` and ``reward_fn`` on numpy arrays."""
    rows = []
    for K in ks:
        seg, excluded = segments_from_episodes(episodes, K, stride,
                                               skip_initial)
        if seg is None:
            print(f"[{name}] K={K}: no segments (episodes too short)")
            continue
        obs0, acts, rews, real_nxt = seg
        if excluded:
            print(f"[{name}] K={K}: {excluded}/{len(episodes)} episodes "
                  f"too short for this window, excluded", flush=True)
        sim_nxt, sim_rew = rollout(obs0, acts)
        # the reward-model floor: the reward model on REAL transitions
        real_prev = np.concatenate([obs0[:, None], real_nxt[:, :-1]], axis=1)
        floor_rew = reward_fn(real_prev, real_nxt, acts)
        r_real, r_sim, r_floor = rews.sum(1), sim_rew.sum(1), floor_rew.sum(1)
        err = np.abs(r_sim - r_real)
        scale = float(np.mean(np.abs(r_real)))
        # cross-fitted affine calibration (fit even segments, score odd)
        if len(r_real) >= 8:
            a_c, b_c = np.polyfit(r_sim[0::2], r_real[0::2], 1)
            resid = np.abs(a_c * r_sim[1::2] + b_c - r_real[1::2])
            calib_p90 = float(np.percentile(resid, 90))
        else:
            calib_p90 = None
        rmse = float(np.sqrt(np.mean(
            ((sim_nxt[:, -1] - real_nxt[:, -1]) / obs_scale) ** 2)))
        rows.append({
            "K": K,
            "n_segments": int(len(r_real)),
            "n_episodes_excluded": int(excluded),
            "mean_abs_R_real": scale,
            "err_p50": float(np.percentile(err, 50)),
            "err_p90": float(np.percentile(err, 90)),
            "floor_p90": float(np.percentile(np.abs(r_floor - r_real), 90)),
            "calib_resid_p90": calib_p90,
            "state_nrmse_at_K": rmse,
            "quotable": bool(np.percentile(err, 90)
                             <= tolerance * max(scale, 1e-9)),
        })
    if not rows:
        print(f"[{name}] no usable segments at any K")
        return None
    k_star = max((r["K"] for r in rows if r["quotable"]), default=0)
    print(f"\n[{name}] segments per K "
          f"{ {r['K']: r['n_segments'] for r in rows} }; "
          f"K* (p90 err <= {tolerance:.0%} of |R|) = {k_star}")
    print("| K | |R_real| | sim err p50 | p90 | reward-model floor p90 "
          "| calib resid p90 | state nRMSE |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        calib = (f"{r['calib_resid_p90']:.2f}"
                 if r["calib_resid_p90"] is not None else "n/a")
        print(f"| {r['K']} | {r['mean_abs_R_real']:.2f} "
              f"| {r['err_p50']:.2f} | {r['err_p90']:.2f} "
              f"| {r['floor_p90']:.2f} | {calib} "
              f"| {r['state_nrmse_at_K']:.2f} |")
    return {"rows": rows, "k_star": k_star}


def bound_report(args, fit_episodes, held, model, stats, metrics,
                 visited=None) -> dict:
    """The report of ``args`` (the parser's namespace) for a fitted
    ensemble ``model`` (envs/learned_model.py) and its ``stats``: the
    held-out distribution and, given, the visited one."""
    import torch

    from dadiff_tpu_torch.envs.learned_model import (
        make_mean_step_fn,
        reward_model_for,
    )

    step = make_mean_step_fn(model, stats)
    reward_t = reward_model_for(args.env)
    device = stats.obs_mean.device

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    @torch.no_grad()
    def rollout(obs0, acts):
        o, a = tensor(obs0), tensor(acts)
        nxts, rs = [], []
        for k in range(a.shape[1]):
            nxt = step(o, a[:, k])
            rs.append(reward_t(o, nxt, a[:, k])[0])
            nxts.append(nxt)
            o = nxt
        return (torch.stack(nxts, 1).cpu().numpy(),
                torch.stack(rs, 1).cpu().numpy())

    @torch.no_grad()
    def reward_fn(prev, nxt, acts):
        return reward_t(tensor(prev), tensor(nxt), tensor(acts))[0] \
            .cpu().numpy()

    kw = dict(rollout=rollout, reward_fn=reward_fn,
              obs_scale=stats.obs_std.cpu().numpy(), ks=args.k,
              stride=args.stride, skip_initial=args.skip_initial,
              tolerance=args.tolerance)
    report = {"env": args.env, "fit_episodes": len(fit_episodes),
              "sim_r2": float(metrics["r2_mean"]),
              "tolerance": args.tolerance, "distributions": {}}
    out = measure("held-out fit mix", held, **kw)
    if out:
        report["distributions"]["heldout"] = out
    if visited is not None:
        out = measure("policy-visited", visited, **kw)
        if out:
            report["distributions"]["visited"] = out
    return report


def main(argv=None) -> dict:
    p = build_parser()
    args = p.parse_args(argv)
    if args.holdout_every < 2:
        p.error("--holdout-every must be >= 2 (1 would hold out every "
                "episode, leaving nothing to fit the simulator on)")
    import torch

    from dadiff_tpu_torch.cli import resolve_device
    from dadiff_tpu_torch.datasets.sources import as_spec, load_episodes
    from dadiff_tpu_torch.envs.learned_model import train_dynamics_ensemble

    device = resolve_device(args.device)
    # the replayed segments' products stay in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    pool = []
    for spec in args.data:
        pool.extend(load_episodes(spec))
    held = pool[::args.holdout_every]
    fit = [ep for i, ep in enumerate(pool) if i % args.holdout_every]
    print(f"pool {len(pool)} episodes -> fit {len(fit)} / held {len(held)}",
          flush=True)
    t0 = time.time()
    model, stats, metrics = train_dynamics_ensemble(
        fit, n_models=args.sim_ensemble, hidden=tuple(args.sim_hidden),
        n_steps=args.sim_steps, seed=args.seed, device=device)
    print(f"ensemble fit in {time.time() - t0:.0f}s: held-out one-step R^2 "
          f"mean={metrics['r2_mean']:.4f}", flush=True)
    visited = None
    if args.visited:
        visited = load_episodes(as_spec(args.visited))
    report = bound_report(args, fit, held, model, stats, metrics, visited)
    path = args.out or (
        f"results/surrogate_bound_{args.env.replace('-', '_')}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"\nsaved -> {path}")
    return report


if __name__ == "__main__":
    main()
