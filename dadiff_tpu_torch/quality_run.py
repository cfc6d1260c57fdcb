"""Plan quality of a port-trained flagship, on the card: train with the
README recipe, then evaluate on the on-device protocol and its ablation.

    python -m dadiff_tpu_torch.quality_run [--out build/quality/results]
    python -m dadiff_tpu_torch.quality_run --suite hopper --out ...
    python -m dadiff_tpu_torch.quality_run --suite transformer --out ...

1. ``train_main`` at the flagship flags (horizon 32, dim 128, mults 1 2 4,
   T = 100, 100 epochs of batch 256, lr 2e-4, seed 42) on
   data/pointmaze_umaze_expert.npz; the checkpoint goes under
   ``--train-dir`` (by default build/quality, outside what git commits).
2. ``eval_ondevice.main`` at the published protocol (128 envs, 20 replans of
   16 actions, planner chain) in three cells, each at seeds 42, 1042, 2042
   and 3042: dynamics-aware best of 8 (projection, 8 candidates), best of
   8 without the projection, and the projection with one candidate; and
   the first cell on the EMA weights at seed 42.
3. ``distill_main`` by the JAX recipe (150 epochs of batch 256, lr 1e-4,
   target EMA 0.95, sigma_data 0.5, skip 1; RESULTS.md:687-692) from that
   checkpoint, then the few-call cells of dynamics-aware best of 8 through
   the module path, each at the four seeds: the student at 1 and 2 calls,
   DDIM-10, DDIM-20 and DDPM warm start K=40.

With ``--suite hopper`` it runs the locomotion cell instead: ``train_main``
by the r5 recipe of scripts/r5_phase3.sh:28-31 (horizon 32, dim 128, mults
1 4 8, T = 100, 60 epochs of batch 256, lr 2e-4, seed 42) on
data/hopper_mppi.npz + data/hopper_engine_r5.npz, then
``eval_ondevice_locomotion.main`` at that script's on-device protocol
(:45-48: exact physics, jacobi, 30 envs, 992 replans of one action,
skip-conditioned, seed 42), untuned.

With ``--suite transformer`` it runs the second model family's cells:
``train_main`` with the JAX recipe's flags (scripts/r3_session_chain.sh:22-27:
``--model-type transformer``, dim 256, depth 6, 8 heads, horizon 32, T =
100, 100 epochs of batch 256, lr 2e-4, seed 42) on
data/pointmaze_umaze_expert.npz, 3,900 steps as RESULTS.md:1061-1066 trains
it, then ``eval_ondevice.main`` at the
published protocol through the module path (the planner chain takes a
U-Net only): dynamics-aware best of 8, and the same with warm start K=40,
each at the four seeds.

Prints one JSON line per cell and a summary line with the card's name and
power limit; writes the results files under ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DATASET = "npz:data/pointmaze_umaze_expert.npz"
RECIPE = ["--dataset", DATASET, "--horizon", "32", "--dim", "128",
          "--dim-mults", "1", "2", "4", "--n-timesteps", "100",
          "--n-epochs", "100", "--batch-size", "256", "--lr", "2e-4"]
PROTOCOL = ["--dataset", DATASET, "--batch", "128", "--n-replans", "20",
            "--action-horizon", "16", "--megakernel"]
# name: extra flags of eval_ondevice, run at each seed
CELLS = {
    "projection_bo8": ["--projection", "--n-candidates", "8"],
    "no_projection_bo8": ["--n-candidates", "8"],
    "projection_bo1": ["--projection", "--n-candidates", "1"],
}
SEEDS = (42, 1042, 2042, 3042)
RUNS = [(f"{name}_seed{seed}", flags + ["--seed", str(seed)])
        for seed in SEEDS for name, flags in CELLS.items()]
RUNS.append(("projection_bo8_ema_seed42",
             CELLS["projection_bo8"] + ["--seed", "42", "--use-ema"]))
# the student's recipe (RESULTS.md:687-692)
DISTILL = ["--dataset", DATASET, "--n-epochs", "150", "--batch-size", "256",
           "--lr", "1e-4", "--target-ema-decay", "0.95", "--sigma-data",
           "0.5", "--skip-steps", "1"]
# name: (the student's checkpoint?, flags) of the few-call cells, through
# the module path (the planner chain is the DDPM sampler alone)
FEW_PROTOCOL = [f for f in PROTOCOL if f != "--megakernel"] + [
    "--projection", "--n-candidates", "8"]
FEW_CELLS = {
    "student_1call": (True, ["--sampler", "consistency",
                             "--sampling-timesteps", "1"]),
    "student_2calls": (True, ["--sampler", "consistency",
                              "--sampling-timesteps", "2"]),
    "ddim10": (False, ["--sampler", "ddim", "--sampling-timesteps", "10"]),
    "ddim20": (False, ["--sampler", "ddim", "--sampling-timesteps", "20"]),
    "ddpm_warm40": (False, ["--warm-start-t", "40"]),
}
# the transformer's cells: scripts/r3_session_chain.sh:22-27's flags on the
# UMaze data (RESULTS.md:1061-1066), the on-device protocol through the
# module path
TT_RECIPE = ["--dataset", DATASET, "--model-type", "transformer", "--dim",
             "256", "--depth", "6", "--n-heads", "8", "--horizon", "32",
             "--n-timesteps", "100", "--n-epochs", "100", "--batch-size",
             "256", "--lr", "2e-4"]
TT_CELLS = {"projection_bo8": [], "ddpm_warm40": ["--warm-start-t", "40"]}
CELL_KEYS = ("success_rate", "mean_reward", "mean_final_distance",
             "wallclock_s", "episodes_per_hour", "compile_s")
# the locomotion cell: scripts/r5_phase3.sh:28-31 and :45-48
HOPPER_DATA = "npz:data/hopper_mppi.npz+npz:data/hopper_engine_r5.npz"
HOPPER_RECIPE = ["--dataset", HOPPER_DATA, "--horizon", "32", "--dim", "128",
                 "--dim-mults", "1", "4", "8", "--n-timesteps", "100",
                 "--n-epochs", "60", "--batch-size", "256", "--lr", "2e-4"]
HOPPER_PROTOCOL = ["--dataset", HOPPER_DATA, "--env", "Hopper-v5",
                   "--backend", "physics", "--solver", "jacobi", "--batch",
                   "30", "--n-replans", "992", "--action-horizon", "1",
                   "--skip-conditioned-action", "--seed", "42"]
HOPPER_KEYS = ("mean_return", "return_std", "return_se",
               "mean_alive_length", "wall_clock_s",
               "episodes_per_hour_per_chip", "timing")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def latest_pt(log_dir: str) -> str:
    pts = [p for p in glob.glob(os.path.join(log_dir, "checkpoint_step_*.pt"))
           if not p.endswith(".train.pt")]
    if not pts:
        raise SystemExit(f"no checkpoint in {log_dir}")
    return max(pts, key=lambda p: int(re.search(r"_(\d+)\.pt$", p).group(1)))


def train(recipe, run_name: str, train_dir: str, card: str) -> dict:
    """``train_main`` by ``recipe`` at seed 42; the summary of the run, its
    last checkpoint under "checkpoint"."""
    from dadiff_tpu_torch.cli import train_main

    t0 = time.perf_counter()
    log_dir = train_main(recipe + ["--log-dir", train_dir, "--run-name",
                                   run_name, "--seed", "42", "--save-freq",
                                   "0", "--eval-freq", "0"])
    train_s = time.perf_counter() - t0
    records = [json.loads(line) for line in
               open(os.path.join(log_dir, "metrics.jsonl"))]
    summary = {"card": card, "checkpoint": latest_pt(log_dir),
               "train_s": train_s, "train_steps": records[-1]["step"],
               "loss_first_epoch": records[0].get("total"),
               "loss_last_epoch": records[-1].get("total"), "cells": {}}
    print(json.dumps({"training": summary}), flush=True)
    return summary


def hopper_suite(args, card: str) -> dict:
    """The Hopper cell: train by the r5 recipe, then the on-device
    exact-physics protocol on the last checkpoint."""
    from dadiff_tpu_torch import eval_ondevice_locomotion

    summary = train(HOPPER_RECIPE, "hop_r5", args.train_dir, card)
    out = eval_ondevice_locomotion.main([
        "--checkpoint", summary["checkpoint"], *HOPPER_PROTOCOL,
        "--results-dir", os.path.join(args.out, "hopper_physics_ah1_seed42")])
    summary["cells"]["hopper_physics_ah1_seed42"] = {
        k: out[k] for k in HOPPER_KEYS}
    return summary


def transformer_suite(args, card: str) -> dict:
    """The transformer's cells: train by the JAX recipe, then the on-device
    protocol through the module path, best of 8 and warm start K=40, at
    each seed."""
    from dadiff_tpu_torch import eval_ondevice

    summary = train(TT_RECIPE, "transformer", args.train_dir, card)
    for seed in SEEDS:
        for cell, flags in TT_CELLS.items():
            name = f"transformer_{cell}_seed{seed}"
            out = eval_ondevice.main([
                "--checkpoint", summary["checkpoint"], *FEW_PROTOCOL, *flags,
                "--seed", str(seed), "--results-dir",
                os.path.join(args.out, name)])
            summary["cells"][name] = {k: out[k] for k in CELL_KEYS} | {
                "model_calls_per_replan": out["model_calls_per_replan"]}
            print(json.dumps({name: summary["cells"][name]}), flush=True)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, default="build/quality/results")
    p.add_argument("--train-dir", type=str, default="build/quality")
    p.add_argument("--suite", type=str, default="pointmaze",
                   choices=["pointmaze", "hopper", "transformer"])
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("quality_run needs a CUDA device")
    from dadiff_tpu_torch import eval_ondevice
    from dadiff_tpu_torch.cli import distill_main

    os.chdir(ROOT)
    card = card_line()
    print(f"card: {card}", flush=True)
    if args.suite == "hopper":
        return _finish(hopper_suite(args, card), args.out)
    if args.suite == "transformer":
        return _finish(transformer_suite(args, card), args.out)
    summary = train(RECIPE, "flagship", args.train_dir, card)
    ckpt = summary["checkpoint"]
    for name, flags in RUNS:
        out = eval_ondevice.main(["--checkpoint", ckpt, *PROTOCOL, *flags,
                                  "--results-dir",
                                  os.path.join(args.out, name)])
        summary["cells"][name] = {k: out[k] for k in CELL_KEYS}
        print(json.dumps({name: summary["cells"][name]}), flush=True)
    t0 = time.perf_counter()
    student_dir = distill_main(DISTILL + [
        "--checkpoint", ckpt, "--log-dir", args.train_dir, "--run-name",
        "student", "--seed", "42", "--save-freq", "0"])
    student = latest_pt(student_dir)
    records = [json.loads(line) for line in
               open(os.path.join(student_dir, "metrics.jsonl"))]
    summary["distill"] = {"checkpoint": student,
                          "distill_s": time.perf_counter() - t0,
                          "steps": records[-1]["step"],
                          "loss_first_epoch": records[0].get("consistency"),
                          "loss_last_epoch": records[-1].get("consistency")}
    print(json.dumps({"distill": summary["distill"]}), flush=True)
    for seed in SEEDS:
        for cell, (on_student, flags) in FEW_CELLS.items():
            name = f"{cell}_seed{seed}"
            out = eval_ondevice.main([
                "--checkpoint", student if on_student else ckpt,
                *FEW_PROTOCOL, *flags, "--seed", str(seed), "--results-dir",
                os.path.join(args.out, name)])
            summary["cells"][name] = {k: out[k] for k in CELL_KEYS} | {
                "model_calls_per_replan": out["model_calls_per_replan"]}
            print(json.dumps({name: summary["cells"][name]}), flush=True)
    return _finish(summary, args.out)


def _finish(summary: dict, out_dir: str) -> dict:
    summary["card_after"] = card_line()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
