"""Plan quality of a port-trained flagship, on the card: train with the
README recipe, then evaluate on the on-device protocol and its ablation.

    python -m dadiff_tpu_torch.quality_run [--out build/quality/results]
    python -m dadiff_tpu_torch.quality_run --suite hopper --out ...
    python -m dadiff_tpu_torch.quality_run --suite walker2d --out ...
    python -m dadiff_tpu_torch.quality_run --suite transformer --out ...

1. ``train_main`` at the flagship flags (horizon 32, dim 128, mults 1 2 4,
   T = 100, 100 epochs of batch 256, lr 2e-4, seed ``--train-seed``) on
   data/pointmaze_umaze_expert.npz; the checkpoint goes under
   ``--train-dir`` (by default build/quality, outside what git commits).
   ``--checkpoint X`` skips the training and evaluates X instead (a
   reference-schema ``.pt``, e.g. one the JAX package trained).
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

``--cells A B ...`` runs only the cells named (the distillation only if a
student cell is among them). Besides the cells above it names the A/B
cells, which run only when named: the three protocol cells through the
module path with TF32 off (``*_module``: f32 convs, as the JAX package's
XLA scan), and the student cells with TF32 off (``*_f32``).
``--slim-out DIR`` writes the checkpoints this run made, without their EMA
weights (``io/torch_compat.py`` ``slim_pt_checkpoint``), as
``teacher_seed<S>.pt`` and ``student_seed<S>.pt``: small enough to carry
off the card's machine and evaluate with the JAX package's
scripts/eval_ondevice.py.

With ``--suite hopper`` or ``--suite walker2d`` it runs a locomotion cell
instead: ``train_main`` by the r5 recipe of scripts/r5_phase3.sh:28-31
(horizon 32, dim 128, mults 1 4 8, T = 100, 60 epochs of batch 256, lr
2e-4, seed ``--train-seed``) on data/<env>_mppi.npz +
data/<env>_engine_r5.npz, then ``eval_ondevice_locomotion.main`` at that
script's on-device protocol (:45-48: exact physics, jacobi, 30 envs, 992
replans of one action, skip-conditioned, seed 42), untuned.

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
import contextlib
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
MODULE_PROTOCOL = ["--dataset", DATASET, "--batch", "128", "--n-replans",
                   "20", "--action-horizon", "16"]
PROTOCOL = MODULE_PROTOCOL + ["--megakernel"]
SEEDS = (42, 1042, 2042, 3042)
BO8 = ["--projection", "--n-candidates", "8"]
# the few-call cells plan through the module path (the planner chain is the
# DDPM sampler alone)
FEW_PROTOCOL = MODULE_PROTOCOL + BO8
STUDENT_1 = ["--sampler", "consistency", "--sampling-timesteps", "1"]
STUDENT_2 = ["--sampler", "consistency", "--sampling-timesteps", "2"]
# name: (on the student?, flags of eval_ondevice, seeds)
CELLS = {
    "projection_bo8": (False, PROTOCOL + BO8, SEEDS),
    "no_projection_bo8": (False, PROTOCOL + ["--n-candidates", "8"], SEEDS),
    "projection_bo1": (False, PROTOCOL + ["--projection", "--n-candidates",
                                          "1"], SEEDS),
    "projection_bo8_ema": (False, PROTOCOL + BO8 + ["--use-ema"], (42,)),
    "student_1call": (True, FEW_PROTOCOL + STUDENT_1, SEEDS),
    "student_2calls": (True, FEW_PROTOCOL + STUDENT_2, SEEDS),
    "ddim10": (False, FEW_PROTOCOL + ["--sampler", "ddim",
                                      "--sampling-timesteps", "10"], SEEDS),
    "ddim20": (False, FEW_PROTOCOL + ["--sampler", "ddim",
                                      "--sampling-timesteps", "20"], SEEDS),
    "ddpm_warm40": (False, FEW_PROTOCOL + ["--warm-start-t", "40"], SEEDS),
}
# the A/B cells, run only when --cells names them and always with TF32 off:
# the protocol's cells through the module path (f32, as the JAX package's
# XLA scan), and the student's cells
AB_CELLS = {
    **{f"{name}_module": (False, [f for f in CELLS[name][1]
                                  if f != "--megakernel"], SEEDS)
       for name in ("projection_bo8", "no_projection_bo8", "projection_bo1")},
    **{f"{name}_f32": CELLS[name] for name in ("student_1call",
                                                "student_2calls")},
}
# the student's recipe (RESULTS.md:687-692)
DISTILL = ["--dataset", DATASET, "--n-epochs", "150", "--batch-size", "256",
           "--lr", "1e-4", "--target-ema-decay", "0.95", "--sigma-data",
           "0.5", "--skip-steps", "1"]
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
# the locomotion cells: scripts/r5_phase3.sh:28-31 and :45-48
# suite: (env id, run name of the script)
LOCOMOTION = {"hopper": ("Hopper-v5", "hop_r5"),
              "walker2d": ("Walker2d-v5", "wlk_r5")}
LOCO_KEYS = ("mean_return", "return_std", "return_se",
             "mean_alive_length", "wall_clock_s",
             "episodes_per_hour_per_chip", "timing")


def loco_data(suite: str) -> str:
    return f"npz:data/{suite}_mppi.npz+npz:data/{suite}_engine_r5.npz"


def loco_recipe(suite: str) -> list:
    return ["--dataset", loco_data(suite), "--horizon", "32", "--dim", "128",
            "--dim-mults", "1", "4", "8", "--n-timesteps", "100",
            "--n-epochs", "60", "--batch-size", "256", "--lr", "2e-4"]


def loco_protocol(suite: str) -> list:
    return ["--dataset", loco_data(suite), "--env", LOCOMOTION[suite][0],
            "--backend", "physics", "--solver", "jacobi", "--batch", "30",
            "--n-replans", "992", "--action-horizon", "1",
            "--skip-conditioned-action", "--seed", "42"]


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


def train(recipe, run_name: str, args, card: str) -> dict:
    """``train_main`` by ``recipe`` at ``--train-seed``; the summary of the
    run, its last checkpoint under "checkpoint"."""
    from dadiff_tpu_torch.cli import train_main

    if args.train_seed != 42:
        run_name = f"{run_name}_seed{args.train_seed}"
    t0 = time.perf_counter()
    log_dir = train_main(recipe + ["--log-dir", args.train_dir, "--run-name",
                                   run_name, "--seed", str(args.train_seed),
                                   "--save-freq", "0", "--eval-freq", "0"])
    train_s = time.perf_counter() - t0
    records = [json.loads(line) for line in
               open(os.path.join(log_dir, "metrics.jsonl"))]
    summary = {"card": card, "checkpoint": latest_pt(log_dir),
               "train_seed": args.train_seed,
               "train_s": train_s, "train_steps": records[-1]["step"],
               "loss_first_epoch": records[0].get("total"),
               "loss_last_epoch": records[-1].get("total"), "cells": {}}
    print(json.dumps({"training": summary}), flush=True)
    return summary


def locomotion_suite(args, card: str) -> dict:
    """A locomotion cell: train by the r5 recipe, then the on-device
    exact-physics protocol on the last checkpoint."""
    from dadiff_tpu_torch import eval_ondevice_locomotion

    summary = train(loco_recipe(args.suite), LOCOMOTION[args.suite][1], args,
                    card)
    name = f"{args.suite}_physics_ah1_seed42"
    out = eval_ondevice_locomotion.main([
        "--checkpoint", summary["checkpoint"], *loco_protocol(args.suite),
        "--results-dir", os.path.join(args.out, name)])
    summary["cells"][name] = {k: out[k] for k in LOCO_KEYS}
    return summary


def transformer_suite(args, card: str) -> dict:
    """The transformer's cells: train by the JAX recipe, then the on-device
    protocol through the module path, best of 8 and warm start K=40, at
    each seed."""
    from dadiff_tpu_torch import eval_ondevice

    summary = train(TT_RECIPE, "transformer", args, card)
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


@contextlib.contextmanager
def tf32_off(off: bool):
    """TF32 off for cuDNN's convs and cuBLAS's products inside, if ``off``;
    the flags as they were after."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if off:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def pointmaze_suite(args, card: str) -> dict:
    """The PointMaze cells ``args.cells`` on the flagship (trained here
    unless ``--checkpoint``) and on a student distilled from it."""
    import torch

    from dadiff_tpu_torch import eval_ondevice
    from dadiff_tpu_torch.cli import distill_main
    from dadiff_tpu_torch.io.torch_compat import slim_pt_checkpoint

    table = CELLS | AB_CELLS
    cells = {name: table[name] for name in args.cells}
    if args.checkpoint:
        summary = {"card": card, "checkpoint": args.checkpoint,
                   "train_seed": args.train_seed, "cells": {}}
    else:
        summary = train(RECIPE, "flagship", args, card)
        if args.slim_out:
            slim_pt_checkpoint(summary["checkpoint"], os.path.join(
                args.slim_out, f"teacher_seed{args.train_seed}.pt"))
    teacher = summary["checkpoint"]
    student = None
    if any(on_student for on_student, _, _ in cells.values()):
        t0 = time.perf_counter()
        student_dir = distill_main(DISTILL + [
            "--checkpoint", teacher, "--log-dir", args.train_dir,
            "--run-name", f"student_seed{args.train_seed}", "--seed",
            str(args.train_seed), "--save-freq", "0"])
        student = latest_pt(student_dir)
        records = [json.loads(line) for line in
                   open(os.path.join(student_dir, "metrics.jsonl"))]
        summary["distill"] = {
            "checkpoint": student, "distill_s": time.perf_counter() - t0,
            "steps": records[-1]["step"],
            "loss_first_epoch": records[0].get("consistency"),
            "loss_last_epoch": records[-1].get("consistency")}
        print(json.dumps({"distill": summary["distill"]}), flush=True)
        if args.slim_out:
            slim_pt_checkpoint(student, os.path.join(
                args.slim_out, f"student_seed{args.train_seed}.pt"))
    for cell, (on_student, flags, seeds) in cells.items():
        for seed in seeds:
            name = f"{cell}_seed{seed}"
            with tf32_off(cell in AB_CELLS):
                tf32 = {"cudnn": torch.backends.cudnn.allow_tf32,
                        "matmul": torch.backends.cuda.matmul.allow_tf32}
                out = eval_ondevice.main([
                    "--checkpoint", student if on_student else teacher,
                    *flags, "--seed", str(seed), "--results-dir",
                    os.path.join(args.out, name)])
            summary["cells"][name] = {k: out[k] for k in CELL_KEYS} | {
                "model_calls_per_replan": out["model_calls_per_replan"],
                "tf32": tf32}
            print(json.dumps({name: summary["cells"][name]}), flush=True)
    return summary


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, default="build/quality/results")
    p.add_argument("--train-dir", type=str, default="build/quality")
    p.add_argument("--suite", type=str, default="pointmaze",
                   choices=["pointmaze", *LOCOMOTION, "transformer"])
    p.add_argument("--train-seed", type=int, default=42,
                   help="seed of the training (and of the distillation)")
    p.add_argument("--cells", type=str, nargs="+", default=list(CELLS),
                   choices=list(CELLS | AB_CELLS),
                   help="PointMaze cells to run (default: every cell but "
                        "the A/B ones)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="PointMaze: evaluate (and distill from) this .pt "
                        "instead of training one")
    p.add_argument("--slim-out", type=str, default=None,
                   help="PointMaze: write the checkpoints this run made, "
                        "without their EMA weights, into this directory")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("quality_run needs a CUDA device")
    os.chdir(ROOT)
    card = card_line()
    print(f"card: {card}", flush=True)
    if args.suite in LOCOMOTION:
        return _finish(locomotion_suite(args, card), args.out)
    if args.suite == "transformer":
        return _finish(transformer_suite(args, card), args.out)
    return _finish(pointmaze_suite(args, card), args.out)


def _finish(summary: dict, out_dir: str) -> dict:
    summary["card_after"] = card_line()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
