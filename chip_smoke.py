#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from dadiff_tpu_torch/csrc (nvcc, sm_90a,
   one process per source, all started together) into build/dadiff_tpu_torch/.
2. Drives the training-and-ladder path: ``dadiff_tpu_torch.cli.train_main`` on
   the committed PointMaze data at the flagship width (horizon 32, dim 128,
   mults 1 2 4, T=100, batch 32) for a fixed number of steps; the loss must
   be finite and fall. Then
   ``dadiff_tpu_torch.probe_megakernel`` samples one batch-1 chain from the
   exported ``.pt`` through every rung: module path, hoisted sampler, fused
   U-Net (K4 per residual block, K1 in its final block), the one-launch
   chain (K3). The train step (loss, grad, clip, Adam, EMA) is timed at
   batch 32 and 256 with the library GroupNorm and through K1's forward and
   backward kernels (the U-Net's ``use_pallas_norm``), in turns; their
   first losses must agree.
3. Holds every kernel against its plain PyTorch version on the card at the
   flagship shapes (K1's forward and backward at every GroupNorm shape of a
   train step, in both layouts, at batch 32 and 256 and at the ladder's,
   two backward runs and a CUDA-graph replay of both against eager bit for
   bit; the fused conv + GroupNorm + Mish at every pair of a denoise step,
   f32 and bf16 weights, with and without its adds; ``rows_conv`` at the
   1,024-chain wave's K = 5,120 conv over 8 seeds, each within TOL_CONV),
   and times kernel, plain version, a library call where one exists, and
   the least time the card could take.
4. Drives the serving path: starts ``dadiff_tpu_torch.serve``'s ``main`` on
   the trained ``.pt`` with ``--policy-type dynamics-aware --n-candidates 8
   --megakernel`` in a thread, sends ping, plan requests and reset over TCP,
   checks the answers. The first plan is driven from the host and its wave
   captured in a CUDA graph; the later plans replay it. Each path runs with
   the kernels' launch counters set to 0 just before and read just after.
5. Drives the evaluation path: ``dadiff_tpu_torch.eval_ondevice``'s ``main``
   on the trained ``.pt`` at the published protocol (128 envs, best of 8,
   projection, 20 replans of 16 actions: one wave of 1,024 chains per
   replan, the first host-driven and captured, the others replays), holds a
   1,024-chain wave replayed against the same wave driven from the host bit
   for bit and times it; the card's env against the same env on the CPU;
   the planner chain at 64 chains with f32 weights against its plain
   version; a served chain (8 chains) and an evaluator chain (64 chains),
   and two K4 launches, on two streams at once against each alone; and,
   where gymnasium imports, ``python -m dadiff_tpu_torch.evaluate
   --batched --megakernel``. At the 1,024-chain wave's shapes (the wgmma
   tile of csrc/wgmma.cuh) it holds every conv and fused pair of a step
   against its plain version, two launches of each bit for bit, and times
   K2's ``rows_conv`` and ``rows_conv_gn`` per launch and per step beside
   cuDNN's conv and the library composition, the bound, and the same
   launches on the mma.sync tiles they took before (in turns).
6. Drives the few-call planners (``fewcall_phase``): distills a consistency
   student from the trained checkpoint through
   ``dadiff_tpu_torch.cli.distill_main``, plans bo8 through DDIM, DPM++,
   warm start and the student (each held against the CPU) and at 1,024
   chains, runs ``eval_ondevice`` with the student and with warm start, and
   checks that ``--megakernel`` refuses them.
7. Drives micro-batched serving (``microbatch_phase``): ``serve.main`` with
   ``--concurrency 4 --max-batch 8``, four TCP clients planning at once
   (their plans fold into one K2 wave of up to 64 chains), the batched
   plans against the solo plans, the wave timed at 8-64 chains, and
   ``dadiff_tpu_torch.bench_serve`` at 4 clients; then value guidance
   (``value_phase``): ``train_value_main`` for a few steps, value-guided
   and MPC plans on the card against the CPU.
8. Drives locomotion (``locomotion_phase``): ``train_main`` at the Hopper
   planner's full width (dim 128, mults 1 4 8) for a few steps, one env
   step of HalfCheetah (Euler), Hopper and Walker2d (RK4) with both
   constraint solvers in float64 and float32 on the card against the CPU
   (ground contact and joints past their limits among the states), an env
   step timed host-driven and as a CUDA-graph replay, and
   ``eval_ondevice_locomotion.main`` on the card (Hopper, 30 envs, a few
   replans of one action, jacobi): the chunk-bound guard passes, the
   results file is written, every op of the loop runs on the card, the
   graph replays equal the host-driven loop (at two actions a replan, and
   on a second call that reuses the graphs), and no port kernel launches
   (the JAX evaluator plans through XLA; so does this path, through the
   module path).
9. Drives the learned simulator (``learned_phase``): ``train_dynamics_ensemble``
   at the CLI's widths (4 members of (256, 256), batch 1,024) on the
   HalfCheetah data, its mean and trajectory-sampling steps on the card
   against the CPU, ``eval_ondevice_locomotion.main`` with no
   ``--backend`` (the learned default) on the Hopper checkpoint at 128
   envs and 8 actions (the results file must carry the JAX learned keys,
   the loop must run on the card, no port kernel may launch, the graph
   replays must equal the host-driven loop bit for bit), and the MPPI
   planner at the r5 recipe's shape (16,384 lanes, 4 members of (512,
   512)) replayed from its CUDA graph, against the CPU on the same noise.
   At the 1,024-chain wave's shapes it also times the U-Net's final conv
   alone beside cuDNN's.
10. Drives the second model family (``transformer_phase``): ``train_main
   --model-type transformer`` at the JAX recipe's width (dim 256, depth 6,
   8 heads) for a few steps of batch 256, its forward on the card against
   the CPU at 8 and 1,024 chains with its bound, ``serve.main`` on its
   ``.pt`` (best of 8 through the module path; ``--megakernel`` refused),
   ``eval_ondevice`` at 128 envs x best of 8, cold and warm (K=40), cut
   to a few replans; Picard sampling at tol 0 against the sequential
   chain, and ``dadiff_tpu_torch.bench_picard``; ``distill --method
   progressive`` from the U-Net checkpoint and a DDIM-25 plan of its
   student against the CPU. No port kernel launches on these paths.
11. Drives the parallelism layer (``parallel_phase``) at world 1: a NCCL
   process group of one rank and the ('dp',) mesh; DDP steps through
   ``Trainer(mesh=)`` and FSDP2 steps of the flagship at batch 256 against
   the Trainer without a mesh, each step timed; ``make_batched_planner``
   at 1,024 chains against ``make_sampler``; ``make_ondevice_evaluator``
   under the mesh at 128 envs x best of 8 for 2 replans against the
   unsharded run, and its refusal of ``use_megakernel``; the tp and sp
   forwards of the flagship U-Net and of the transformer against their
   plain forwards, and the same through ``shard_params_tp(fsdp_axis=)`` on
   a ('dp', 'fsdp', 'tp') mesh; an FSDP2 run saved halfway and resumed in a
   fresh Trainer against the run that did not stop. No port kernel
   launches there. Then two processes on the one card join over gloo and
   take a DDP step and a step with the weights split over ``{'fsdp': 2}``
   (the tp/fsdp path), each held against the same step in one process.
12. Drives bf16 training (``dtype_phase``): ``train_main --dtype float32``
   and ``--dtype bfloat16`` for 10 steps of batch 256, the flagship U-Net
   (fine-tuned from the smoke checkpoint) and the transformer recipe,
   three repeats of each in turns, step ms and first losses; each bf16
   forward on the card against the CPU. Then ``train --config`` with a
   JSON file and one flag that wins (``config_phase``).
13. Traces through ``dadiff_tpu_torch.utils.profiling`` (``profile_phase``):
   5 replays of the served bo8 wave (busy share, top kernels, the trace's
   K2 launches against the counters') and 5 flagship train steps at batch
   256 (busy share).
14. Runs ``dadiff_tpu_torch.physics_bound`` on Hopper-v5 at the committed
   artifact's settings, K cut to its first rows (``physics_bound_phase``),
   and ``python -m dadiff_tpu_torch.check_install`` (exit 0).
15. Prints the card, the kernel table as one JSON line, and as the last
   line ``{"ok": true, "device": {...}}``.

It exits non-zero, with no result, without a CUDA device or outside a
checkout of the repository. It uses nothing of JAX.
"""

from __future__ import annotations

import json
import math
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
SEED = 0
N_CAND, HORIZON, DIM, MULTS, T_STEPS = 8, 32, 128, (1, 2, 4), 100
DATASET = "npz:data/pointmaze_umaze_expert.npz"
ENV = "PointMaze_UMaze-v3"
N_PLANS = 4
BATCH, N_TRAIN_STEPS, LOG_FREQ = 32, 150, 10
# the on-device protocol (RESULTS.md, "Batched planning megakernel"): 128
# envs x best of 8 = 1,024 chains per replan wave, 20 replans of 16 actions
EVAL_ENVS, EVAL_REPLANS, EVAL_ACTIONS, EVAL_SEED = 128, 20, 16, 42
EVAL_CHAINS, GROUP_CHAINS = EVAL_ENVS * N_CAND, 64
# the card's env against the CPU's: the same float32 ops on both; positions
# may part by rounding (observed: none), a contact may flip only where a
# position sits on a wall's edge to the last bit
TOL_ENV_POS = 1e-4
ENV_MISMATCH_PER_STEP = 1e-4

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 and f32 FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12

TOL_GN = 1e-5       # f32 sums in another order: ~1e-6 observed
TOL_CONV = 1e-4     # K up to 5120 f32 products summed in another order
# rows_conv_gn against rows_conv_plain -> gn_mish_plain: TOL_CONV carried
# through the norm (times its gain, max |scale| * rstd, and Mish's slope,
# <= 1.1, computed per case from the plain conv), then TOL_GN
MISH_SLOPE = 1.1
TOL_STEP = 1e-5
TOL_CHAIN_F32 = 2e-3  # tests/test_pallas_planner.py's tolerance for the chain
# bf16 chain vs the plain chain at the same bf16 rounding points: the two sum
# in other orders, so an activation near a bf16 rounding boundary can round
# the other way (2^-8 relative) and 100 steps carry it on
TOL_CHAIN_BF16 = 5e-2
TOL_RESBLOCK = 1e-4   # tests/test_pallas_resblock.py's own, f32 throughout
# the few-call phase: distillation steps and batch, and the warm depth
FEW_STEPS, FEW_BATCH, FEW_K = 60, 64, 40
# the few-call plans on the card against the same function on the CPU (f32,
# TF32 off, the same draws) are held to TOL_CHAIN_F32; a consistency plan's
# first call, at t = T-1, reads x0 off the model's eps times
# sqrt((1 - abar)/abar), 6,417 at T-1 of the flagship's schedule, so the f32
# model's rounding on two devices (up to ~5e-6: the f32 K2 chain is 4.3e-6
# from its plain version on the card) becomes up to ~3e-2 there, and each
# later call re-noises that estimate (times sqrt(abar_t)) and reads it back
# (over sqrt(abar_t)): the error carries through every call of the plan
TOL_FEW_TOP = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
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


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn``'s launches, captured once in a CUDA graph and
    replayed, so the host's per-launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


# ---------------------------------------------------------------------------
# The launches of one denoise step and their least cost
# ---------------------------------------------------------------------------

def step_launches(unet, rows: int, D: int):
    from dadiff_tpu_torch.sweep_kernels import step_launches as record

    return record(unet, rows, D, HORIZON)


def conv_cost(rows, cin_a, cin_b, cout, mode, k, wbytes):
    from dadiff_tpu_torch.ops.planner import UP, _conv_out_rows

    cin = cin_a + cin_b
    taps = 4 if mode == UP else k
    out_rows = _conv_out_rows(rows, mode)
    flops = 2.0 * out_rows * (2 if mode == UP else k) * cin * cout
    nbytes = 4 * rows * cin + wbytes * taps * cin * cout + 4 * cout \
        + 4 * out_rows * cout
    return flops, nbytes


def wave_cost(unet, flat_w, m_embs, rows: int, D: int):
    """(products, bytes, weight bytes) of one wave of the planner chain on
    ``rows`` trajectory rows: every conv of T U-Net forwards, the projection
    of every chain at every step and the hoisted time-dense rows; weights,
    x_T, noise, conditioning, iterate, projection and per-step operands each
    moved once."""
    from dadiff_tpu_torch.ops.planner import _program

    calls, _, _ = step_launches(unet, rows, D)
    HD = HORIZON * D
    flops = sum(conv_cost(*c[1:7], 2)[0] for c in calls) * T_STEPS
    flops += 2.0 * T_STEPS * (rows // HORIZON) * HD ** 2
    flops += sum(2.0 * T_STEPS * op[2][0].shape[0] * op[2][0].shape[1]
                 for op in _program(unet, flat_w) if op[0] == "res")
    w_bytes = sum(t.numel() * t.element_size() for t in flat_w)
    nbytes = (w_bytes + 4 * rows * D * (T_STEPS + 3) + 4 * HD ** 2
              + 4 * T_STEPS * (8 + m_embs.shape[1]))
    return flops, nbytes, w_bytes


def bound_ms(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def _counters():
    """Every kernel wrapper's launch count, by the kernel's name."""
    from dadiff_tpu_torch.ops.chain import launch_chain
    from dadiff_tpu_torch.ops.gn_mish import gn_mish, gn_mish_backward
    from dadiff_tpu_torch.ops.planner import (
        ddpm_project_step, rows_conv, rows_conv_gn,
    )
    from dadiff_tpu_torch.ops.resblock import fused_residual_block

    return {"gn_mish": gn_mish, "gn_mish_backward": gn_mish_backward,
            "rows_conv": rows_conv,
            "rows_conv_gn": rows_conv_gn,
            "ddpm_project_step": ddpm_project_step,
            "resblock": fused_residual_block, "chain": launch_chain}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0
        if hasattr(fn, "cluster_launches"):
            fn.cluster_launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def read_cluster_counts() -> dict:
    """Launches of ``rows_conv`` and ``rows_conv_gn`` on the cluster tile
    (part of their ``launches``)."""
    return {name: fn.cluster_launches for name, fn in _counters().items()
            if hasattr(fn, "cluster_launches")}


def tile_name(t) -> str:
    """A conv tiling as the logs name it: family, shape, ring."""
    fam = "cluster" if t.cluster else "wgmma" if t.ring else "mma.sync"
    return f"{fam} tile {t.bm}x{t.bn}" + (f" ring {t.ring}" if t.ring else "")


def train_phase(root: Path) -> Path:
    """The train entry point with its real flags at the flagship width, for
    N_TRAIN_STEPS steps; returns the exported reference-schema ``.pt``."""
    from dadiff_tpu_torch.cli import train_main

    t0 = time.perf_counter()
    log_dir = Path(train_main([
        "--dataset", DATASET, "--horizon", str(HORIZON), "--dim", str(DIM),
        "--dim-mults", *map(str, MULTS), "--n-timesteps", str(T_STEPS),
        "--batch-size", str(BATCH), "--n-epochs", "1",
        "--max-steps", str(N_TRAIN_STEPS), "--warmup-steps", "10",
        "--log-freq", str(LOG_FREQ), "--eval-freq", "0", "--save-freq", "0",
        "--seed", str(SEED), "--log-dir", str(root)]))
    took = time.perf_counter() - t0
    record = json.loads((log_dir / "metrics.jsonl").read_text().splitlines()[-1])
    series = record["total_series"]
    require(record["step"] == N_TRAIN_STEPS, f"trained {record['step']} steps")
    require(len(series) == 1 + N_TRAIN_STEPS // LOG_FREQ
            and all(v == v and abs(v) < 1e6 for v in series),
            f"training loss finite: {series}")
    first, last = sum(series[:3]) / 3, sum(series[-3:]) / 3
    log(f"train: {N_TRAIN_STEPS} steps of batch {BATCH} in {took:.1f} s "
        f"(data and set-up included); loss {first:.4f} (first 3 logged) -> "
        f"{last:.4f} (last 3)")
    require(last < first, f"training loss fell ({first} -> {last})")
    ckpt = log_dir / f"checkpoint_step_{N_TRAIN_STEPS}.pt"
    require(ckpt.is_file(), f"{ckpt} was exported")
    return ckpt


TRAIN_STEP_REPEATS, TRAIN_STEP_STEPS = 3, 10
TOL_K1_LOSS = 1e-4   # first loss, K1 against the library norm, relative
# after the timed steps (38 a side), K1's backward as the train step runs it:
# the loss of one more step, relative, and the two weight changes' difference
# relative to the library's change; ~1.2e-7 and ~3e-6 observed at batch 32
# and 256 on an H100, so about 8x and 10x that
TOL_K1_LAST_LOSS, TOL_K1_DRIFT = 1e-6, 3e-5


def train_step_phase(ckpt: Path) -> dict:
    """Times the port's train step (loss, grad, clip, Adam, EMA) on the
    trained weights at batch BATCH and DT_BATCH: with the library GroupNorm
    as trained (``library_norm``) and with the U-Net's ``use_pallas_norm``
    option (``k1_norm``: GroupNorm+Mish through K1's forward and backward
    kernels), TRAIN_STEP_REPEATS repeats of TRAIN_STEP_STEPS steps each, in
    turns. The two take the same batch and draws: their first losses must
    agree within TOL_K1_LOSS, and a ``k1_norm`` step must launch K1's
    forward and backward once per norm. After the timed steps one more
    step each holds K1's backward as the step runs it (channels-first,
    the gradient arriving through the block's transposed view): its loss
    within TOL_K1_LAST_LOSS and the weights' change since the checkpoint
    within TOL_K1_DRIFT of the library's, both relative. The counts are set
    to 0 at the start and read at the end (``launches``)."""
    from dadiff_tpu_torch.cli import load_model
    from dadiff_tpu_torch.datasets.sequence import create_dataloader
    from dadiff_tpu_torch.losses import build_loss, make_generators
    from dadiff_tpu_torch.models.temporal_unet import Conv1dBlock
    from dadiff_tpu_torch.utils import training as tt

    out = {}
    reset_counts()
    for bs in (BATCH, DT_BATCH):
        steps, first, launches, models = {}, {}, {}, {}
        for name, kernel_norm in (("k1_norm", True), ("library_norm", False)):
            diff, dataset = load_model(str(ckpt), DATASET, device="cuda")
            diff.train()
            start = [p.detach().clone() for p in diff.parameters()]
            models[name] = diff
            blocks = [m for m in diff.modules() if isinstance(m, Conv1dBlock)]
            for m in blocks:
                m.use_pallas_norm = kernel_norm
            loss_fn, names = build_loss(diff)
            state = tt.TrainState(diff, tt.make_optimizer(diff.parameters()),
                                  tt.EMA(diff).shadow)
            step = tt.make_train_step(
                loss_fn, lr_schedule=tt.warmup_cosine_schedule(3e-4, 10,
                                                               10000),
                gradient_clip=4.0)
            gens = make_generators(len(names), SEED, "cuda")
            batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(
                iter(create_dataloader(dataset, bs, seed=SEED))).items()}
            before = read_counts()
            first[name] = float(step(state, batch, gens)["total"])
            after = read_counts()
            launches[name] = {k: after[k] - before[k]
                              for k in ("gn_mish", "gn_mish_backward")}
            steps[name] = (lambda s=step, st=state, b=batch, g=gens:
                           s(st, b, g))
        n = len(blocks)
        rel = abs(first["k1_norm"] - first["library_norm"]) \
            / abs(first["library_norm"])
        log(f"train step at batch {bs}: first loss k1_norm "
            f"{first['k1_norm']:.7f}, library_norm "
            f"{first['library_norm']:.7f} (relative {rel:.3e}); K1 launches "
            f"a step {launches}")
        require(rel <= TOL_K1_LOSS, f"first loss through K1 vs the library "
                f"norm at batch {bs}: {rel} > {TOL_K1_LOSS}")
        require(launches["k1_norm"] == {"gn_mish": n, "gn_mish_backward": n}
                and not any(launches["library_norm"].values()),
                f"K1 launches a step: {launches} ({n} norms)")
        ms = {name: [] for name in steps}
        for rep in range(TRAIN_STEP_REPEATS):
            for name in (list(steps) if rep % 2 == 0 else list(steps)[::-1]):
                ms[name].append(cuda_ms(steps[name], TRAIN_STEP_STEPS,
                                        warmup=2))
        last = {name: float(run()["total"]) for name, run in steps.items()}
        change = {name: torch.cat([(p.detach() - p0).flatten() for p, p0 in
                                   zip(m.parameters(), start)])
                  for name, m in models.items()}
        drift = float((change["k1_norm"] - change["library_norm"]).norm()
                      / change["library_norm"].norm())
        last_rel = abs(last["k1_norm"] - last["library_norm"]) \
            / abs(last["library_norm"])
        taken = 2 + TRAIN_STEP_REPEATS * (TRAIN_STEP_STEPS + 2)
        log(f"train step at batch {bs}, after {taken} steps: loss k1_norm "
            f"{last['k1_norm']:.7f}, library_norm {last['library_norm']:.7f} "
            f"(relative {last_rel:.3e}); weight change, k1_norm against "
            f"library_norm, relative {drift:.3e}")
        require(last_rel <= TOL_K1_LAST_LOSS,
                f"last loss through K1 vs the library norm at batch {bs}: "
                f"{last_rel} > {TOL_K1_LAST_LOSS}")
        require(drift <= TOL_K1_DRIFT,
                f"weight change through K1 vs the library norm at batch {bs}:"
                f" {drift} > {TOL_K1_DRIFT}")
        out[f"batch_{bs}"] = {
            "step_ms": ms, "first_loss": first, "first_loss_rel": rel,
            "last_loss": last, "last_loss_rel": last_rel,
            "weight_change_rel": drift,
            "k1_launches_per_step": launches["k1_norm"],
            "samples_per_s": {k: bs / min(v) * 1e3 for k, v in ms.items()}}
        for name, v in ms.items():
            log(f"train step ({name}) at batch {bs}: "
                f"{', '.join(f'{t:.3f}' for t in v)} ms, "
                f"{bs / min(v) * 1e3:.0f} samples/s")
    out["launches"] = read_counts()
    return out


def ladder_phase(ckpt: Path) -> dict:
    """The latency ladder's entry point on the trained checkpoint."""
    from dadiff_tpu_torch import probe_megakernel

    out = probe_megakernel.main(["--checkpoint", str(ckpt), "--repeats", "3"])
    rungs = out["rungs"]
    require(all(r["finite"] for r in rungs.values()), "ladder outputs finite")
    # the plain block and K4 against the module path (cuDNN f32, TF32 off)
    # over 100 steps: the f32 chain tolerance; bf16 weights: within the
    # 0.15 the JAX package's own test allows its bf16 chain
    for name, tol in (("hoisted", TOL_CHAIN_F32), ("hoisted_fused", TOL_CHAIN_F32),
                      ("chain_f32", TOL_CHAIN_F32), ("chain_bf16", 0.15)):
        require(rungs[name]["max_abs_diff"] <= tol,
                f"ladder rung {name} vs module path "
                f"{rungs[name]['max_abs_diff']} > {tol}")
    return out


def resblock_phase(unet) -> dict:
    """K4 against its plain version at the 12 residual blocks of the
    flagship, B=1 and B=8, on the trained weights, and two launches on the
    same inputs bit for bit; its gradient; the grid and grid barriers of a
    launch; the 12 launches of one batch-1 denoise step timed one by one
    (weights warm in L2) beside each block's bound, and together (58.5 MB of
    weights, more than L2); where the widest block's launch spends its
    cycles."""
    import torch.nn.functional as F
    from dadiff_tpu_torch.models.fused_unet import fused_block_params
    from dadiff_tpu_torch.ops import chain as ch
    from dadiff_tpu_torch.ops import resblock as rb

    fused_residual_block = rb.fused_residual_block
    residual_block_plain = rb.residual_block_plain
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    blocks = [{k: v.detach() for k, v in bp.items()}
              for bp in fused_block_params(unet)]
    require(len(blocks) == 12, "the flagship has 12 residual blocks")
    L = len(unet.dim_mults)   # rows per block: down levels, mid, up levels
    rows = ([HORIZON >> i for i in range(L) for _ in range(2)]
            + [HORIZON >> (L - 1)] * 2
            + [HORIZON >> (L - 1 - j) for j in range(L - 1) for _ in range(2)])
    err, bufs, flops, nbytes, bounds = 0.0, [], 0.0, 0.0, []
    for B in (1, 8):
        for H, bp in zip(rows, blocks):
            k, cin, cout = bp["w1"].shape
            x = torch.randn(B, H, cin, device=dev, generator=g)
            te = torch.randn(B, cout, device=dev, generator=g)
            got = fused_residual_block(x, te, bp)
            require(torch.equal(got, fused_residual_block(x, te, bp)),
                    f"K4 B={B} H={H} {cin}->{cout} repeats bit for bit")
            e = (got - residual_block_plain(x, te, bp)).abs().max().item()
            log(f"K4 resblock B={B} H={H} {cin}->{cout} "
                f"res={'wr' in bp}: max|err| {e:.3e}, two launches equal")
            err = max(err, e)
            if B == 1:
                n_w = sum(v.numel() for v in bp.values())
                f = 2.0 * B * H * (n_w - (6 + ("wr" in bp)) * cout)
                nb = 4 * (B * H * cin + B * cout + n_w + B * H * cout)
                flops += f
                nbytes += nb
                bounds.append(bound_ms(f, nb, F32_FLOPS))
                bufs.append((x, te, bp))
    require(err <= TOL_RESBLOCK, f"resblock vs plain {err} > {TOL_RESBLOCK}")
    torch.cuda.synchronize()
    # the 12 launches of a step as one piece of work: products and bytes summed
    bnd, bnd_by = bound_ms(flops, nbytes, F32_FLOPS)

    # one launch: the grid and the barriers of the block's program
    ops, grid = rb._template(bufs[0][2], bufs[0][0], 8)
    barriers = sum(op.sync_after for op in ops)
    require(barriers == 3 and grid == ch.grid_size(dev, "resblock"),
            f"K4: {barriers} grid barriers per launch, grid {grid}")
    log(f"K4: one cooperative launch per block, grid {grid} blocks, "
        f"{barriers} grid barriers, {len(ops)} ops (5 with the 1x1 conv)")

    # gradient: the plain version's, through the autograd.Function
    x, te, bp = bufs[2]
    gy = torch.randn(1, x.shape[1], bp["w1"].shape[2], device=dev, generator=g)
    grads = []
    for fn in (fused_residual_block, residual_block_plain):
        leaves = {k: v.clone().requires_grad_(True) for k, v in bp.items()}
        xx, tt = x.clone().requires_grad_(True), te.clone().requires_grad_(True)
        fn(xx, tt, leaves).backward(gy)
        grads.append([xx.grad, tt.grad] + [leaves[k].grad for k in bp])
    e = max((a - b).abs().max().item() for a, b in zip(*grads))
    log(f"K4 resblock backward vs plain autograd: max|err| {e:.3e}")
    require(e <= 1e-4, f"resblock backward {e}")

    def library(x, te, bp):
        """One ResidualTemporalBlock from PyTorch's own calls (cuDNN convs,
        F.group_norm, F.mish), channels-first."""
        def conv(h, w, b):
            return F.conv1d(h, w.permute(2, 1, 0), b, padding=w.shape[0] // 2)

        xc = x.transpose(1, 2)
        h = F.mish(F.group_norm(conv(xc, bp["w1"], bp["b1"]), 8, bp["s1"],
                                bp["g1"], 1e-5)) + te[:, :, None]
        h = F.mish(F.group_norm(conv(h, bp["w2"], bp["b2"]), 8, bp["s2"],
                                bp["g2"], 1e-5))
        res = (F.conv1d(xc, bp["wr"].t()[:, :, None], bp["br"])
               if "wr" in bp else xc)
        return (h + res).transpose(1, 2)

    e = max((library(*b) - residual_block_plain(*b)).abs().max().item()
            for b in bufs)
    require(e <= TOL_RESBLOCK, f"library residual block vs plain {e}")

    def k4():
        return [fused_residual_block(*b) for b in bufs]

    # device time per launch: ten launches of one block in a CUDA graph
    per_launch = [graph_ms(lambda b=b: [fused_residual_block(*b)
                                        for _ in range(10)], 5) / 10
                  for b in bufs]
    for (x, te, bp), t, (b_ms, _) in zip(bufs, per_launch, bounds):
        k, cin, cout = bp["w1"].shape
        log(f"K4 B=1 H={x.shape[1]} {cin}->{cout}: {t:.4f} ms per launch "
            f"(weights warm in L2), bound {b_ms:.4f} ms (bytes of the block), "
            f"{t / b_ms:.1f}x")
    # a step's 12 launches: a CUDA graph where capture takes the cooperative
    # launches, else CUDA events around launches driven from Python
    try:
        ms, step_timing = graph_ms(k4, 10), "graph"
    except RuntimeError as e:
        log(f"K4: capturing the step in a CUDA graph failed ({e}); timed "
            "with events")
        ms, step_timing = cuda_ms(k4, 10), "events"
    host_ms = cuda_ms(k4, 10)
    log(f"K4 step (12 launches, B=1): {ms:.4f} ms ({step_timing}), "
        f"{host_ms:.4f} ms driven from Python, bound {bnd:.4f} ms; per "
        f"launch summed {sum(per_launch):.4f} ms")

    # where the widest block's launch goes, as block 0 sees it
    widest = max(range(len(bufs)),
                 key=lambda i: sum(v.numel() for v in bufs[i][2].values()))
    x, te, bp = bufs[widest]
    prof = torch.zeros(len(ch.PROFILE_SLOTS), dtype=torch.int64, device=dev)
    rb.launch_resblock(x, te, bp, torch.empty(1, x.shape[1], bp["w1"].shape[2],
                                              device=dev), 8, rb.EPS, prof=prof)
    cycles = dict(zip(ch.PROFILE_SLOTS, prof.tolist()))
    share = {k: v / max(sum(cycles.values()), 1) for k, v in cycles.items()
             if k in ("conv", "gn", "barrier")}
    log(f"K4 widest block (H={x.shape[1]}, {bp['w1'].shape[1]}->"
        f"{bp['w1'].shape[2]}), share of block 0's cycles: "
        + " ".join(f"{k} {v:.3f}" for k, v in share.items()))
    return dict(
        max_abs_err=err, ms=ms, step_timing=step_timing, host_ms=host_ms,
        plain_ms=graph_ms(lambda: [residual_block_plain(*b) for b in bufs], 10),
        library_ms=graph_ms(lambda: [library(*b) for b in bufs], 10),
        bound_ms=bnd, bound_by=bnd_by, per="batch-1 denoise step",
        launches_per_step=len(bufs), ms_per_launch=per_launch,
        bound_ms_per_launch=[b for b, _ in bounds], grid=grid,
        barriers_per_launch=barriers, cycle_share=share)


def one_chain_phase(diff) -> dict:
    """K3 against the plain chain on the card: f32 and bf16 weights, with and
    without row-0 conditioning; one launch per chain; ms per chain, per step
    and per grid barrier; the bounds; the same chain through K2's host loop."""
    from dadiff_tpu_torch.ops import chain as ch
    from dadiff_tpu_torch.ops import cuda_lib
    from dadiff_tpu_torch.ops.chain_operands import prepare_chain_operands
    from dadiff_tpu_torch.ops.planner import make_planner_chain

    dev = diff.device
    unet, H, D = diff.model, diff.horizon, diff.transition_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    x0 = torch.randn(H, D, device=dev, generator=g)
    noise = torch.randn(T_STEPS, H, D, device=dev, generator=g)
    cond = torch.zeros(H, D, device=dev)
    cond[0, :diff.observation_dim] = torch.randn(diff.observation_dim,
                                                 device=dev, generator=g) * 0.5
    ts = torch.arange(T_STEPS - 1, -1, -1, device=dev)
    errs, launches = {}, {}
    for wd, tol in ((torch.float32, TOL_CHAIN_F32),
                    (torch.bfloat16, TOL_CHAIN_BF16)):
        fw, me, sc = prepare_chain_operands(unet, diff.schedule, ts, wd)
        for c in (None, cond):
            chain = ch.make_chain(unet, diff.schedule, H,
                                  clip_denoised=diff.clip_denoised,
                                  predict_epsilon=diff.predict_epsilon,
                                  condition_row0=c is not None)
            want = ch.chain_plain(unet, fw, x0, me, noise, sc, c, chain.config)
            ch.launch_chain.launches = 0
            got = chain(fw, x0, me, noise, sc, c)
            torch.cuda.synchronize()
            require(ch.launch_chain.launches == 1,
                    f"one launch per chain ({ch.launch_chain.launches})")
            launch = chain.bind(fw, x0, me, noise, sc, c)
            again = launch().clone()
            require(torch.equal(got, again) and torch.equal(again, launch()),
                    "the chain repeats bit for bit")
            e = (got - want).abs().max().item()
            name = f"{str(wd)[6:]}{'_cond' if c is not None else ''}"
            log(f"K3 chain {name} vs plain chain (T={T_STEPS}): max|err| "
                f"{e:.3e} (tolerance {tol})")
            require(e <= tol and bool(torch.isfinite(got).all()),
                    f"K3 chain {name} vs plain")
            if c is not None:
                require(bool((got[0] == c[0]).all()), "K3 row 0 conditioned")
            errs[name] = e
            launches[name] = launch
    bf16, f32 = launches["bfloat16"], launches["float32"]
    fw, me, sc = prepare_chain_operands(unet, diff.schedule, ts, torch.bfloat16)
    chain = ch.make_chain(unet, diff.schedule, H)
    plain_ms = cuda_ms(lambda: ch.chain_plain(unet, fw, x0, me, noise, sc, None,
                                              chain.config), 2, warmup=1)
    ms = cuda_ms(bf16, 5, warmup=1)
    ms_f32 = cuda_ms(f32, 5, warmup=1)
    call_ms = cuda_ms(lambda: chain(fw, x0, me, noise, sc), 5, warmup=1)
    # the same chain with another cap on the K splits of a conv (what a
    # consumer sums per value): the program is rebuilt, the kernel is the same
    capped = ch.MAX_FAN_IN
    ms_by_fan_in = {capped: ms}
    for cap in (8, 33):
        ch.MAX_FAN_IN = cap
        try:
            other = chain.bind(fw, x0, me, noise, sc)
            e = (other() - launches["bfloat16"]()).abs().max().item()
            require(e <= TOL_CHAIN_BF16, f"K3 at fan-in {cap} vs {capped}: {e}")
            ms_by_fan_in[cap] = cuda_ms(other, 3, warmup=1)
        finally:
            ch.MAX_FAN_IN = capped
    log("K3 chain bf16, ms per chain by cap on the K splits: "
        + " ".join(f"{k}: {v:.2f}" for k, v in sorted(ms_by_fan_in.items())))

    lib, n_sync = cuda_lib.lib("chain"), 6000
    stream = torch.cuda.current_stream().cuda_stream

    def probe():
        cuda_lib.check(lib.grid_sync_probe(n_sync, bf16.grid, stream),
                       "grid_sync_probe")

    sync_us = cuda_ms(probe, 3, warmup=1) / n_sync * 1e3
    # where block 0 spends a chain: clock cycles by kind of op and at barriers
    prof = torch.zeros(len(ch.PROFILE_SLOTS), dtype=torch.int64, device=dev)
    bf16(prof)
    cycles = dict(zip(ch.PROFILE_SLOTS, prof.tolist()))
    share = {k: v / max(sum(cycles.values()), 1) for k, v in cycles.items()}
    log("K3 chain, share of block 0's cycles: "
        + " ".join(f"{k} {v:.3f}" for k, v in share.items()))

    # the same chain through K2's host loop, one chain, no projection
    k2 = make_planner_chain(unet, diff.schedule, H, 1, 1,
                            clip_denoised=diff.clip_denoised,
                            predict_epsilon=diff.predict_epsilon)
    x0r, nr = x0.reshape(H, D), noise.reshape(T_STEPS, H, D)
    e = (k2(fw, x0r, me, nr, sc, cond) - launches["bfloat16_cond"]()
         ).abs().max().item()
    require(e <= TOL_CHAIN_BF16, f"K3 vs K2's host loop at N=1: {e}")
    k2_ms = cuda_ms(lambda: k2(fw, x0r, me, nr, sc, cond, graph=False), 3,
                    warmup=1)
    k2_graph_ms = cuda_ms(lambda: k2(fw, x0r, me, nr, sc, cond), 3, warmup=1)

    # bounds from the shapes: products of T U-Net forwards at batch 1 (and
    # the hoisted time-dense rows), each weight read once
    calls, _, _ = step_launches(unet, H, D)
    flops = sum(conv_cost(*c[1:7], 2)[0] for c in calls)  # every conv
    flops_step = flops
    from dadiff_tpu_torch.ops.planner import _program

    flops = flops * T_STEPS + sum(
        2.0 * T_STEPS * op[2][0].shape[0] * op[2][0].shape[1]
        for op in _program(unet, fw) if op[0] == "res")
    w_bytes = sum(t.numel() * t.element_size() for t in fw)
    nbytes = w_bytes + 4 * H * D * (T_STEPS + 2) + 4 * T_STEPS * (
        8 + me.shape[1])
    b_ms, b_by = bound_ms(flops, nbytes, BF16_FLOPS)
    return dict(
        max_abs_err=errs["float32"], errs=errs, ms=ms, ms_f32=ms_f32,
        call_ms=call_ms, host_ms=call_ms, ms_per_step=ms / T_STEPS,
        plain_ms=plain_ms,
        library_ms=None, bound_ms=b_ms, bound_by=b_by, per="batch-1 chain",
        flops_per_step=flops_step, flops_per_chain=flops, weight_bytes=w_bytes,
        reread_weights_ms=T_STEPS * w_bytes / HBM_BPS * 1e3,
        grid=bf16.grid, grid_syncs=bf16.syncs, sync_us=sync_us,
        syncs_ms=bf16.syncs * sync_us * 1e-3, ops=bf16.n_ops,
        cycle_share=share, ms_by_fan_in=ms_by_fan_in,
        k2_host_loop_ms=k2_ms, k2_graph_ms=k2_graph_ms)


def hold_rows_conv(conv_calls, dtypes, g) -> float:
    """``rows_conv`` against ``rows_conv_plain`` at every distinct conv of
    ``conv_calls`` ((rows, cin_a, cin_b, cout, mode, k, seg) each), for each
    weight dtype, within TOL_CONV; two launches of each conv agree bit for
    bit. The tile, its ring (wgmma tiles) and K splits each launch takes
    are logged beside its error."""
    from dadiff_tpu_torch.ops.planner import (
        UP, _split_k, rows_conv, rows_conv_plain,
    )

    err = 0.0
    for wd in dtypes:
        for R, ca, cb, cout, mode, k, seg in sorted(set(conv_calls)):
            xa = torch.randn(R, ca, device="cuda", generator=g)
            xb = torch.randn(R, cb, device="cuda", generator=g) if cb else None
            taps = 4 if mode == UP else k
            w = (torch.randn(taps * (ca + cb), cout, device="cuda",
                             generator=g) / (ca + cb) ** 0.5).to(wd)
            bias = torch.randn(1, cout, device="cuda", generator=g)
            got = rows_conv(xa, xb, w, bias, mode, k, seg)
            e = (got - rows_conv_plain(xa, xb, w, bias, mode, k, seg)
                 ).abs().max().item()
            t = _split_k(R, ca + cb, cout, mode, k, wd == torch.bfloat16,
                         seg=seg, cin_b=cb)
            log(f"K2 rows_conv {str(wd)[6:]} mode={mode} k={k} rows={R} "
                f"cin={ca}+{cb} cout={cout} {tile_name(t)} splits "
                f"{t.splits}: max|err| {e:.3e}")
            err = max(err, e)
            require(torch.equal(got, rows_conv(xa, xb, w, bias, mode, k, seg)),
                    f"two launches of rows_conv at rows={R} cin={ca}+{cb} "
                    f"cout={cout} mode={mode} agree bit for bit")
    require(err <= TOL_CONV, f"rows_conv vs plain {err} > {TOL_CONV}")
    # split-K sums its partials in a fixed order: repeated launches agree
    require(all(torch.equal(rows_conv(xa, xb, w, bias, mode, k, seg),
                            rows_conv(xa, xb, w, bias, mode, k, seg))
                for _ in range(3)), "rows_conv is deterministic")
    return err


SPREAD_SEEDS = 8


def conv_spread(unet, D) -> dict:
    """``rows_conv`` against ``rows_conv_plain`` at the 1,024-chain wave's
    conv of the longest reduction (K = 5,120: 512 + 512 channels in, k = 5,
    at 8,192 rows), over SPREAD_SEEDS seeds of its operands, bf16 weights
    (as the wave runs it) and f32: each seed's max |err| must stay within
    TOL_CONV."""
    from dadiff_tpu_torch.ops.planner import UP, rows_conv, rows_conv_plain

    calls, _, _ = step_launches(unet, EVAL_CHAINS * HORIZON, D)
    shapes = {c[1:8] for c in calls
              if (4 if c[5] == UP else c[6]) * (c[2] + c[3]) == 5120}
    require(len(shapes) == 1, f"one conv with K = 5,120: {shapes}")
    R, ca, cb, cout, mode, k, seg = shapes.pop()
    out = {"shape": {"rows": R, "cin": [ca, cb], "cout": cout, "k": k},
           "tolerance": TOL_CONV}
    for wd in (torch.bfloat16, torch.float32):
        errs = []
        for seed in range(SPREAD_SEEDS):
            g = torch.Generator(device="cuda").manual_seed(SEED + 1000 + seed)
            xa = torch.randn(R, ca, device="cuda", generator=g)
            xb = torch.randn(R, cb, device="cuda", generator=g)
            w = (torch.randn((4 if mode == UP else k) * (ca + cb), cout,
                             device="cuda", generator=g)
                 / (ca + cb) ** 0.5).to(wd)
            bias = torch.randn(1, cout, device="cuda", generator=g)
            errs.append((rows_conv(xa, xb, w, bias, mode, k, seg)
                         - rows_conv_plain(xa, xb, w, bias, mode, k, seg)
                         ).abs().max().item())
        mean = sum(errs) / len(errs)
        out[str(wd)[6:]] = {
            "max_abs_err": errs, "max": max(errs), "min": min(errs),
            "mean": mean,
            "std": (sum((e - mean) ** 2 for e in errs) / len(errs)) ** 0.5}
        log(f"K2 rows_conv K=5,120 ({R} rows, {ca}+{cb} -> {cout}, k {k}) "
            f"{str(wd)[6:]} over {SPREAD_SEEDS} seeds: max|err| {errs}; "
            f"max {max(errs):.3e} min {min(errs):.3e} mean {mean:.3e} std "
            f"{out[str(wd)[6:]]['std']:.3e} (TOL_CONV {TOL_CONV})")
        require(max(errs) <= TOL_CONV,
                f"rows_conv at K = 5,120 {str(wd)[6:]}: {errs} > {TOL_CONV}")
    return out


def gn_case(R, ca, cb, cout, k, seg, wd, g):
    """Operands of one fused (conv, GroupNorm) pair, without adds."""
    xa = torch.randn(R, ca, device="cuda", generator=g)
    xb = torch.randn(R, cb, device="cuda", generator=g) if cb else None
    w = (torch.randn(k * (ca + cb), cout, device="cuda", generator=g)
         / (ca + cb) ** 0.5).to(wd)
    bias = torch.randn(1, cout, device="cuda", generator=g)
    scale = 1 + 0.5 * torch.randn(cout, device="cuda", generator=g)
    gbias = torch.randn(cout, device="cuda", generator=g)
    return xa, xb, w, bias, k, seg, scale, gbias


def hold_rows_conv_gn(fused, dtypes, g):
    """``rows_conv_gn`` against ``rows_conv_gn_plain`` at every distinct
    (conv, GroupNorm) pair of ``fused`` (step_launches' "conv_gn" entries),
    for each weight dtype, without adds, with the time row (one for all
    chains, or one per chain), the residual, or both: within TOL_GN plus
    TOL_CONV carried through the norm. Repeated launches agree bit for bit.
    Returns (max error, max error over its tolerance)."""
    from dadiff_tpu_torch.ops.planner import (
        SAME, _split_k_gn, rows_conv_gn, rows_conv_gn_plain, rows_conv_plain,
    )

    err, worst = 0.0, 0.0
    for wd in dtypes:
        for R, ca, cb, cout, _, k, seg in sorted(set(c[1:8] for c in fused)):
            base = gn_case(R, ca, cb, cout, k, seg, wd, g)
            pre = rows_conv_plain(*base[:4], SAME, k, seg).reshape(
                R // seg, seg, 8, cout // 8)
            rstd = torch.rsqrt(pre.var(dim=(1, 3), unbiased=False) + 1e-5)
            gain = MISH_SLOPE * (rstd[:, :, None] * base[6].abs().reshape(
                1, 8, -1)).max().item()
            tol = TOL_GN + TOL_CONV * gain
            t, gp = _split_k_gn(R, ca + cb, cout, k, seg, wd == torch.bfloat16,
                                cb)
            for adds in ("none", "te", "te_per_chain", "res", "te_res"):
                te = res = None
                if adds.startswith("te"):
                    te = torch.randn(R // seg if adds == "te_per_chain" else 1,
                                     cout, device="cuda", generator=g)
                if adds.endswith("res"):
                    res = torch.randn(R, cout, device="cuda", generator=g)
                args = (*base, te, res)
                got = rows_conv_gn(*args)
                e = (got - rows_conv_gn_plain(*args)).abs().max().item()
                if adds == "te_res":  # two launches of each pair agree
                    require(torch.equal(got, rows_conv_gn(*args)),
                            f"two launches of rows_conv_gn at rows={R} "
                            f"cin={ca}+{cb} cout={cout} agree bit for bit")
                log(f"K2 rows_conv_gn {str(wd)[6:]} rows={R} cin={ca}+{cb} "
                    f"cout={cout} seg={seg} {tile_name(t)} splits "
                    f"{t.splits} group block {gp.tiles_m}x{gp.tiles_n} "
                    f"{adds}: max|err| {e:.3e} (tolerance {tol:.2e})")
                require(e <= tol, f"rows_conv_gn vs plain {e} > {tol}")
                err, worst = max(err, e), max(worst, e / tol)
    # the group blocks add their tiles' sums in tile order, and split-K its
    # partials in split order: repeated launches agree (the last case has
    # two tiles per group block and several K splits)
    require(all(torch.equal(rows_conv_gn(*args), rows_conv_gn(*args))
                for _ in range(3)), "rows_conv_gn is deterministic")
    return err, worst


def conv_buffers(conv_calls, g):
    """Operands of each conv of ``conv_calls`` ((rows, cin_a, cin_b, cout,
    mode, k, seg) each) with bf16 weights, for ``rows_conv`` (the first
    seven) and, channels-first in bf16, for cuDNN (the last three)."""
    from dadiff_tpu_torch.ops.planner import UP

    bufs = []
    for R, ca, cb, cout, mode, k, seg in conv_calls:
        xa = torch.randn(R, ca, device="cuda", generator=g)
        xb = torch.randn(R, cb, device="cuda", generator=g) if cb else None
        taps = 4 if mode == UP else k
        w = (torch.randn(taps * (ca + cb), cout, device="cuda", generator=g)
             / (ca + cb) ** 0.5).to(torch.bfloat16)
        bias = torch.randn(1, cout, device="cuda", generator=g)
        xcat = xa if xb is None else torch.cat([xa, xb], 1)
        x_lib = xcat.reshape(R // seg, seg, ca + cb).permute(0, 2, 1) \
            .contiguous().to(torch.bfloat16)
        wf = w.float()
        if mode == UP:
            w_lib = torch.stack([wf[t * (ca + cb):(t + 1) * (ca + cb)]
                                 for t in range(4)], dim=2)
        else:
            w_lib = wf.reshape(k, ca + cb, cout).permute(2, 1, 0)
        bufs.append((xa, xb, w, bias, mode, k, seg,
                     x_lib, w_lib.contiguous().to(torch.bfloat16),
                     bias.reshape(-1).to(torch.bfloat16)))
    return bufs


def lib_conv(x, w, b, mode, k):
    """cuDNN's conv of the same function as ``rows_conv``, channels-first."""
    import torch.nn.functional as F
    from dadiff_tpu_torch.ops.planner import DOWN, UP

    if mode == UP:
        return F.conv_transpose1d(x, w, b, stride=2, padding=1)
    return F.conv1d(x, w, b, stride=2 if mode == DOWN else 1, padding=k // 2)


def lib_operands(a):
    """A (conv, GroupNorm) pair's operands channels-first in bf16 for
    cuDNN's conv."""
    xa, xb, w, bias, k, seg, scale, gbias, te, res = a
    x = xa if xb is None else torch.cat([xa, xb], 1)
    R, cin = x.shape
    cout = w.shape[1]
    return (x.reshape(R // seg, seg, cin).permute(0, 2, 1).contiguous()
            .to(torch.bfloat16),
            w.float().reshape(k, cin, cout).permute(2, 1, 0).contiguous()
            .to(torch.bfloat16), bias.reshape(-1).to(torch.bfloat16),
            scale, gbias, None if te is None else te[:, None],
            None if res is None else res.reshape(R // seg, seg, cout)
            .permute(0, 2, 1).contiguous())


def lib_gn(xc, wc, bc, scale, gbias, te, res):
    """cuDNN's bf16 conv, then F.group_norm and F.mish, channels-first: the
    library composition of ``rows_conv_gn``."""
    import torch.nn.functional as F

    y = F.conv1d(xc, wc, bc, padding=wc.shape[2] // 2).float()
    y = F.mish(F.group_norm(y, 8, scale, gbias, 1e-5))
    if te is not None:
        y = y + te
    return y if res is None else y + res


def gn_buffers(fused, g):
    """Operands of each fused pair of ``fused`` (step_launches' "conv_gn"
    entries) with bf16 weights and its adds, as the wave launches them."""
    bufs = []
    for _, R, ca, cb, cout, _, k, seg, has_te, has_res in fused:
        base = gn_case(R, ca, cb, cout, k, seg, torch.bfloat16, g)
        te = torch.randn(cout, device="cuda", generator=g) if has_te else None
        res = (torch.randn(R, cout, device="cuda", generator=g) if has_res
               else None)
        bufs.append((*base, te, res))
    return bufs


def gn_pair_times(call):
    """(ms of operations, ms of bytes) at the peaks for one fused pair
    (a step_launches "conv_gn" entry): bf16 products and the norm's f32
    operations; the bytes the pair moves."""
    from dadiff_tpu_torch.ops.planner import SAME

    _, R, ca, cb, cout, _, k, seg, has_te, has_res = call
    fl, nb = conv_cost(R, ca, cb, cout, SAME, k, 2)
    nb += 4 * cout * (2 + has_te) + 4 * R * cout * has_res
    return (fl / BF16_FLOPS * 1e3 + 20.0 * R * cout / F32_FLOPS * 1e3,
            nb / HBM_BPS * 1e3)


def gn_pair_bound(fused):
    """(bound ms, by) of a step's fused pairs."""
    t_ops = sum(gn_pair_times(c)[0] for c in fused)
    t_bytes = sum(gn_pair_times(c)[1] for c in fused)
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


TOL_K1_BWD = 1e-4   # dx, f32; dscale / dbias / dte are sums over up to
#                     8,192 positions: of their largest entry (at least 1)


def k1_grad_err(got, want, is_sum: bool) -> float:
    e = (got - want).abs().max().item()
    return e / max(1.0, want.abs().max().item()) if is_sum else e


def norm_shapes(unet, batch: int):
    """(B, C, L) of every GroupNorm of one forward of ``unet`` at ``batch``,
    in the order the forward runs them (the library norm, hooked)."""
    from dadiff_tpu_torch.models.temporal_unet import Conv1dBlock

    blocks = [m for m in unet.modules() if isinstance(m, Conv1dBlock)]
    flags = [m.use_pallas_norm for m in blocks]
    shapes = []
    hooks = [m.block[1].register_forward_hook(
        lambda mod, inp, out: shapes.append(tuple(inp[0].shape)))
        for m in blocks]
    try:
        for m in blocks:
            m.use_pallas_norm = False
        with torch.no_grad():
            unet(torch.zeros(batch, HORIZON, unet.transition_dim,
                             device="cuda"),
                 torch.zeros(batch, dtype=torch.long, device="cuda"))
    finally:
        for h in hooks:
            h.remove()
        for m, f in zip(blocks, flags):
            m.use_pallas_norm = f
    require(len(shapes) == len(blocks), f"{len(shapes)} norms hooked")
    return shapes


def k1_case(S, L, C, cf: bool, g) -> dict:
    """K1 forward and backward at one shape and layout against the plain
    versions: the forward within TOL_GN; the backward kernel against
    gn_mish_backward_plain and against autograd of gn_mish_plain within
    TOL_K1_BWD; two backward runs, and both launchers replayed from one CUDA
    graph against their eager runs, bit for bit."""
    from dadiff_tpu_torch.ops.gn_mish import (
        gn_mish_backward, gn_mish_backward_plain, gn_mish_plain,
        launch_gn_mish, launch_plan,
    )

    shape = (S, C, L) if cf else (S, L, C)
    x = torch.randn(shape, device="cuda", generator=g) * 2 + 0.3
    s = torch.randn(C, device="cuda", generator=g)
    b = torch.randn(C, device="cuda", generator=g)
    gy = torch.randn(shape, device="cuda", generator=g)
    out = torch.empty_like(x)
    stats = torch.empty(S, 8, 2, device="cuda")

    def fwd():
        launch_gn_mish(x, out, s, b, None, 0, None, 8, 1e-5, L,
                       channels_first=cf, stats=stats)

    def bwd():
        return gn_mish_backward(x, s, b, gy, stats, 8, cf)[:3]

    fwd()
    want, want_stats = gn_mish_plain(x, s, b, channels_first=cf,
                                     return_stats=True)
    e_fwd = (out - want).abs().max().item()
    got, again = bwd(), bwd()
    plain = gn_mish_backward_plain(x, s, b, gy, want_stats, 8, cf)
    leaves = [t.clone().requires_grad_(True) for t in (x, s, b)]
    gn_mish_plain(*leaves, channels_first=cf).backward(gy)
    e_plain = max(k1_grad_err(a, w, i > 0)
                  for i, (a, w) in enumerate(zip(got, plain)))
    e_auto = max(k1_grad_err(a, l.grad, i > 0)
                 for i, (a, l) in enumerate(zip(got, leaves)))
    eager = [out.clone(), stats.clone(), *got]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fwd()
        bwd()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    out.zero_()
    stats.zero_()
    with torch.cuda.graph(graph):
        fwd()
        captured = bwd()
    graph.replay()
    torch.cuda.synchronize()
    replay = [out, stats, *captured]
    rec = dict(shape=list(shape), layout="channels_first" if cf else
               "feature_last", route=list(launch_plan(L, C, 8, cf)),
               fwd_err=e_fwd, bwd_err_plain=e_plain, bwd_err_autograd=e_auto,
               bwd_bits_equal=all(torch.equal(p, q)
                                  for p, q in zip(got, again)),
               graph_bits_equal=all(torch.equal(p, q)
                                    for p, q in zip(eager, replay)))
    log(f"K1 {rec['layout']} {tuple(shape)} route {rec['route']}: forward "
        f"{e_fwd:.3e}, backward vs plain {e_plain:.3e}, vs autograd "
        f"{e_auto:.3e}, two runs equal {rec['bwd_bits_equal']}, graph == "
        f"eager {rec['graph_bits_equal']}")
    require(e_fwd <= TOL_GN, f"gn_mish at {shape}: {e_fwd} > {TOL_GN}")
    require(max(e_plain, e_auto) <= TOL_K1_BWD,
            f"gn_mish backward at {shape}: {e_plain}, {e_auto}")
    require(rec["bwd_bits_equal"], f"gn_mish backward at {shape}: two runs "
            "differ")
    require(rec["graph_bits_equal"], f"gn_mish at {shape}: graph replay "
            "differs from eager")
    return rec


def k1_times(unet, batch: int, g) -> dict:
    """The 25 norms of a train step at ``batch`` as the use_pallas_norm
    U-Net runs them (channels-first), replayed from CUDA graphs: K1's
    forward (with its statistics) and backward launches, the same through
    the autograd.Function (forward and backward), the plain versions, and
    the library composition F.group_norm -> F.mish with its autograd
    backward (timed with its forward; its backward alone is the
    difference). Bounds in bytes: forward x, scale, bias in and y and the
    statistics out; backward x, g, scale, bias and the statistics in, dx,
    dscale, dbias out."""
    import torch.nn.functional as F
    from dadiff_tpu_torch.ops.gn_mish import (
        gn_mish, gn_mish_backward, gn_mish_backward_plain, gn_mish_plain,
        launch_gn_mish,
    )

    bufs = []
    fwd_b = bwd_b = fwd_fl = bwd_fl = 0.0
    for S, C, L in norm_shapes(unet, batch):
        x = torch.randn(S, C, L, device="cuda", generator=g)
        s = torch.randn(C, device="cuda", generator=g)
        b = torch.randn(C, device="cuda", generator=g)
        gy = torch.randn_like(x)
        out, stats = torch.empty_like(x), torch.empty(S, 8, 2, device="cuda")
        launch_gn_mish(x, out, s, b, None, 0, None, 8, 1e-5, L,
                       channels_first=True, stats=stats)
        leaves = [t.clone().requires_grad_(True) for t in (x, s, b)]
        bufs.append((x, s, b, gy, out, stats, L, leaves))
        N = S * C * L
        fwd_b += 4 * (2 * N + 2 * C + 16 * S)
        bwd_b += 4 * (3 * N + 4 * C + 16 * S)
        fwd_fl += 20.0 * N
        bwd_fl += 40.0 * N

    def k1_fwd():
        for x, s, b, _, out, stats, L, _ in bufs:
            launch_gn_mish(x, out, s, b, None, 0, None, 8, 1e-5, L,
                           channels_first=True, stats=stats)

    def k1_bwd():
        return [gn_mish_backward(x, s, b, gy, stats, 8, True)
                for x, s, b, gy, _, stats, _, _ in bufs]

    def k1_autograd():
        return [torch.autograd.grad(gn_mish(*lv, channels_first=True), lv, gy)
                for _, _, _, gy, _, _, _, lv in bufs]

    def lib_fwd():
        return [F.mish(F.group_norm(x, 8, s, b, 1e-5))
                for x, s, b, *_ in bufs]

    def lib_autograd():
        return [torch.autograd.grad(F.mish(F.group_norm(
            lv[0], 8, lv[1], lv[2], 1e-5)), lv, gy)
            for _, _, _, gy, _, _, _, lv in bufs]

    fb, fby = bound_ms(fwd_fl, fwd_b, F32_FLOPS)
    bb, bby = bound_ms(bwd_fl, bwd_b, F32_FLOPS)
    lib_f, lib_fb = graph_ms(lib_fwd, 20), graph_ms(lib_autograd, 20)
    rec = dict(
        batch=batch, norms=len(bufs),
        fwd_ms=graph_ms(k1_fwd, 20), fwd_host_ms=cuda_ms(k1_fwd, 20),
        bwd_ms=graph_ms(k1_bwd, 20), bwd_host_ms=cuda_ms(k1_bwd, 20),
        autograd_ms=graph_ms(k1_autograd, 20),
        autograd_host_ms=cuda_ms(k1_autograd, 20),
        plain_fwd_ms=graph_ms(lambda: [gn_mish_plain(
            x, s, b, channels_first=True, return_stats=True)
            for x, s, b, *_ in bufs], 20),
        plain_bwd_ms=graph_ms(lambda: [gn_mish_backward_plain(
            x, s, b, gy, stats, 8, True)
            for x, s, b, gy, _, stats, _, _ in bufs], 20),
        library_fwd_ms=lib_f, library_autograd_ms=lib_fb,
        library_bwd_ms=lib_fb - lib_f,
        library_autograd_host_ms=cuda_ms(lib_autograd, 20),
        fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb, bwd_bound_by=bby,
        fwd_bytes=fwd_b, bwd_bytes=bwd_b)
    log(f"K1 train step's {len(bufs)} norms at batch {batch}: "
        + json.dumps(rec))
    return rec


def k1_phase(unet, g) -> dict:
    """K1's checks at every training shape (both layouts, batch BATCH and
    DT_BATCH) and the ladder's, and its times at the train step's norms
    and at the ladder's final block; the kernels-line records of
    ``gn_mish`` and ``gn_mish_backward``."""
    from dadiff_tpu_torch.ops.gn_mish import gn_mish, gn_mish_plain

    import torch.nn.functional as F

    shapes = sorted({(L, C) for _, C, L in norm_shapes(unet, 1)},
                    reverse=True)
    cases = [k1_case(S, L, C, cf, g) for S in (BATCH, DT_BATCH)
             for L, C in shapes for cf in (False, True)]
    cases += [k1_case(1, HORIZON, unet.dim, cf, g) for cf in (False, True)]
    # the routes no flagship shape takes: two vectors a thread, the looped
    # route (a group past REG_MAX floats), scalar loads (runs of 6 floats)
    cases += [k1_case(S, L, C, cf, g)
              for S, L, C in ((2, 64, 256), (2, 64, 512), (4, 6, 48))
              for cf in (False, True)]
    fwd_err = max(c["fwd_err"] for c in cases)
    bwd_err = max(max(c["bwd_err_plain"], c["bwd_err_autograd"])
                  for c in cases)
    times = {bs: k1_times(unet, bs, g) for bs in (BATCH, DT_BATCH)}
    # the ladder's final block: batch 1, feature-last, 100 launches a chain
    x = torch.randn(1, HORIZON, unet.dim, device="cuda", generator=g)
    s = torch.randn(unet.dim, device="cuda", generator=g)
    b = torch.randn(unet.dim, device="cuda", generator=g)
    xc = x.transpose(1, 2).contiguous()
    ladder = dict(
        shape=[1, HORIZON, unet.dim],
        us=1e3 * graph_ms(lambda: [gn_mish(x, s, b) for _ in range(10)],
                          20) / 10,
        plain_us=1e3 * graph_ms(lambda: [gn_mish_plain(x, s, b)
                                         for _ in range(10)], 20) / 10,
        library_us=1e3 * graph_ms(lambda: [F.mish(F.group_norm(
            xc, 8, s, b, 1e-5)) for _ in range(10)], 20) / 10,
        bound_us=1e3 * bound_ms(20.0 * xc.numel(),
                                4 * (2 * xc.numel() + 2 * unet.dim),
                                F32_FLOPS)[0])
    log(f"K1 ladder final block: {json.dumps(ladder)}")
    top, low = times[DT_BATCH], times[BATCH]
    per = (f"the {top['norms']} norms of a train step at batch {DT_BATCH} "
           "(channels-first)")
    fwd = dict(
        max_abs_err=fwd_err, ms=top["fwd_ms"], host_ms=top["fwd_host_ms"],
        plain_ms=top["plain_fwd_ms"], library_ms=top["library_fwd_ms"],
        bound_ms=top["fwd_bound_ms"], bound_by=top["fwd_bound_by"],
        per=per + ", forward", launches_per_step=top["norms"],
        at_batch_32={k: low[k] for k in (
            "fwd_ms", "fwd_host_ms", "plain_fwd_ms", "library_fwd_ms",
            "fwd_bound_ms")},
        autograd={bs: {k: t[k] for k in (
            "autograd_ms", "autograd_host_ms", "library_autograd_ms",
            "library_autograd_host_ms")} for bs, t in times.items()},
        ladder=ladder, cases=len(cases))
    bwd = dict(
        max_abs_err=bwd_err, ms=top["bwd_ms"], host_ms=top["bwd_host_ms"],
        plain_ms=top["plain_bwd_ms"], library_ms=top["library_bwd_ms"],
        bound_ms=top["bwd_bound_ms"], bound_by=top["bwd_bound_by"],
        per=per + ", backward (the group pass and the channel sums, two "
        "kernels a launch; library: the autograd backward of F.group_norm "
        "-> F.mish)", launches_per_step=top["norms"],
        at_batch_32={k: low[k] for k in (
            "bwd_ms", "bwd_host_ms", "plain_bwd_ms", "library_bwd_ms",
            "bwd_bound_ms")},
        cases=len(cases))
    return {"gn_mish": fwd, "gn_mish_backward": bwd}


def kernel_phase(unet, rows, D):
    """K1 (``k1_phase``, and at the served step's shapes with its adds) and
    the K2 kernels against their plain versions, and their times over the
    launches of one denoise step."""
    import numpy as np
    import torch.nn.functional as F
    from dadiff_tpu_torch.ops.gn_mish import gn_mish, gn_mish_plain
    from dadiff_tpu_torch.ops.planner import (
        SAME, UP, StepConfig, ddpm_project_step, ddpm_project_step_plain,
        rows_conv, rows_conv_gn_plain, rows_conv_plain,
    )
    from dadiff_tpu_torch.cli import maze_grid_for_env

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    calls, _, _ = step_launches(unet, rows, D)
    fused = [c for c in calls if c[0] == "conv_gn"]
    results = {}

    # -- K1 (forward and backward kernels): every training shape in both
    # layouts at both batches and the ladder's, its times at the 25 norms
    # of a train step; then the served step's shapes with the epilogue adds
    results.update(k1_phase(unet, g))

    gn_calls = [("gn", c[1], c[4], c[7], c[8], c[9]) for c in fused]
    err = 0.0
    for _, R, C, seg, has_te, has_res in sorted(set(gn_calls)):
        x = torch.randn(R // seg, seg, C, device=dev, generator=g) * 2 + 0.3
        s = torch.randn(C, device=dev, generator=g)
        b = torch.randn(C, device=dev, generator=g)
        kw = {}
        if has_te:
            kw["te"] = torch.randn(C, device=dev, generator=g)
        if has_res:
            kw["res"] = torch.randn_like(x)
        e = (gn_mish(x, s, b, **kw) - gn_mish_plain(x, s, b, **kw)).abs().max().item()
        log(f"K1 gn_mish ({R}, {C}) seg={seg} te={has_te} res={has_res}: "
            f"max|err| {e:.3e}")
        err = max(err, e)
    require(err <= TOL_GN, f"gn_mish vs plain {err} > {TOL_GN}")
    # the epilogue adds' gradients through the backward kernel (a third
    # plane of channel sums): a shared row and one row per segment
    for te_rows in (1, 8):
        args = [torch.randn(8, HORIZON, DIM, device=dev, generator=g),
                torch.randn(DIM, device=dev, generator=g),
                torch.randn(DIM, device=dev, generator=g),
                torch.randn(te_rows, DIM, device=dev, generator=g).squeeze(0),
                torch.randn(8, HORIZON, DIM, device=dev, generator=g)]
        gy = torch.randn(8, HORIZON, DIM, device=dev, generator=g)
        grads = []
        for fn in (gn_mish, gn_mish_plain):
            leaves = [a.clone().requires_grad_(True) for a in args]
            fn(*leaves[:3], te=leaves[3], res=leaves[4]).backward(gy)
            grads.append([a.grad for a in leaves])
        e = max(k1_grad_err(grads[0][i], grads[1][i], i > 0)
                for i in range(5))
        log(f"K1 gn_mish backward with te ({te_rows} rows) and res vs plain "
            f"autograd: {e:.3e}")
        require(e <= TOL_K1_BWD, f"gn_mish backward with te/res {e}")

    # the served step's 25 norms, unfused (the wave fuses them into their
    # convs: rows_conv_gn)
    gn_bufs = []
    nbytes = bnd = 0.0
    for _, R, C, seg, has_te, has_res in gn_calls:
        x = torch.randn(R // seg, seg, C, device=dev, generator=g)
        s, b = torch.randn(C, device=dev), torch.randn(C, device=dev)
        te = torch.randn(C, device=dev) if has_te else None
        res = torch.randn_like(x) if has_res else None
        gn_bufs.append((x, s, b, te, res, x.permute(0, 2, 1).contiguous()))
        nb = 4 * R * C * (2 + has_res) + 4 * C * (2 + has_te)
        bnd += bound_ms(20.0 * R * C, nb, F32_FLOPS)[0]

    def k1():
        return [gn_mish(x, s, b, te=te, res=res) for x, s, b, te, res, _ in gn_bufs]

    results["gn_mish"]["served_step"] = dict(
        max_abs_err=err, ms=graph_ms(k1, 50), host_ms=cuda_ms(k1, 50),
        plain_ms=graph_ms(lambda: [gn_mish_plain(x, s, b, te=te, res=res)
                                   for x, s, b, te, res, _ in gn_bufs], 50),
        library_ms=graph_ms(lambda: [F.mish(F.group_norm(xc, 8, s, b, 1e-5))
                                     for _, s, b, _, _, xc in gn_bufs], 50),
        bound_ms=bnd, bound_by="bytes",
        per="the 25 norms of a served denoise step, unfused",
        launches_per_step=len(gn_calls))
    results["gn_mish"]["max_abs_err"] = max(
        results["gn_mish"]["max_abs_err"], err)

    # -- rows_conv: every distinct conv of a step (the fused ones without
    # their epilogue), f32 and bf16 weights
    conv_calls = [c[1:8] for c in calls]
    err = hold_rows_conv(conv_calls, (torch.float32, torch.bfloat16), g)
    k5120 = conv_spread(unet, D)

    conv_bufs = conv_buffers(conv_calls, g)
    bnd = sum(bound_ms(*conv_cost(R, ca, cb, cout, mode, k, 2), BF16_FLOPS)[0]
              for R, ca, cb, cout, mode, k, seg in conv_calls)

    def k2():
        return [rows_conv(*c[:7]) for c in conv_bufs]

    from dadiff_tpu_torch.ops.planner import _split_k

    per_launch = []
    for c in conv_bufs:
        t = _split_k(c[0].shape[0], c[2].shape[0] // (4 if c[4] == UP else c[5]),
                     c[2].shape[1], c[4], c[5], True, seg=c[6],
                     cin_b=0 if c[1] is None else c[1].shape[1])
        per_launch.append({
            "M": t.M, "K": t.K, "N": t.cout, "mode": c[4],
            "tile": [t.bm, t.bn], "cluster": t.cluster, "splits": t.splits,
            "us": 1e3 * graph_ms(lambda c=c: [rows_conv(*c[:7])
                                               for _ in range(10)], 5) / 10,
            "library_us": 1e3 * graph_ms(
                lambda c=c: [lib_conv(c[7], c[8], c[9], c[4], c[5])
                             for _ in range(10)], 5) / 10})
    log("K2 rows_conv per launch (bf16, weights warm in L2), in forward "
        "order: " + json.dumps(per_launch))
    ms = graph_ms(k2, 20)
    served = [c for c, call in zip(conv_bufs, calls) if call[0] == "conv"]
    results["rows_conv"] = dict(
        max_abs_err=err, ms=ms, host_ms=cuda_ms(k2, 20),
        # the 10 convs a served step launches alone (no GroupNorm after them)
        ms_served=graph_ms(lambda: [rows_conv(*c[:7]) for c in served], 20),
        launches_served_per_step=len(served),
        # the variants of the bf16 product that were built and timed
        variants={"mma.sync m16n8k16, cp.async ring": ms},
        plain_ms=graph_ms(lambda: [rows_conv_plain(*c[:7]) for c in conv_bufs],
                          20),
        library_ms=graph_ms(lambda: [lib_conv(c[7], c[8], c[9], c[4], c[5])
                                     for c in conv_bufs], 20),
        bound_ms=bnd, bound_by="operations", per="denoise step",
        launches_per_step=len(conv_calls), k5120_spread=k5120)

    # -- rows_conv_gn: every (conv, GroupNorm) pair of a step, f32 and bf16
    # weights, without adds, with the time row (one for all chains, or one
    # per chain), the residual, or both
    err, worst = hold_rows_conv_gn(fused, (torch.float32, torch.bfloat16), g)

    from dadiff_tpu_torch.ops.planner import _CudaOps, _split_k_gn

    # timed as the wave launches them: outputs, split-K scratch and group
    # counters are the chain's own fixed buffers (the public wrapper would
    # allocate and zero counters on every call)
    ops = _CudaOps(dev)

    def served_gn(a):
        ops.begin("pair")
        return ops.conv_gn(*a)

    gn_bufs = gn_buffers(fused, g)
    per_pair = []
    pair_bound_us = [1e3 * max(gn_pair_times(c)) for c in fused]
    gn_bnd, gn_by = gn_pair_bound(fused)

    def unfused(a):
        """rows_conv then K1: the pair as two launches, unfused."""
        y = rows_conv(*a[:4], SAME, a[4], a[5])
        R, C = y.shape
        return gn_mish(y.reshape(R // a[5], a[5], C), a[6], a[7], te=a[8],
                       res=None if a[9] is None else a[9].reshape(
                           R // a[5], a[5], C))

    lib_bufs = [lib_operands(a) for a in gn_bufs]
    for a, bound_us in zip(gn_bufs, pair_bound_us):
        R, cout = a[0].shape[0], a[2].shape[1]
        t, gp = _split_k_gn(R, a[2].shape[0] // a[4], cout, a[4], a[5], True,
                            0 if a[1] is None else a[1].shape[1])
        per_pair.append({
            "M": t.M, "K": t.K, "N": cout, "seg": a[5],
            "te": a[8] is not None, "res": a[9] is not None,
            "tile": [t.bm, t.bn], "cluster": t.cluster, "splits": t.splits,
            "group_block_tiles": [gp.tiles_m, gp.tiles_n],
            "bound_us": bound_us,
            "us": 1e3 * graph_ms(lambda a=a: [served_gn(a)
                                               for _ in range(10)], 5) / 10,
            "rows_conv_us": 1e3 * graph_ms(
                lambda a=a: [rows_conv(*a[:4], SAME, a[4], a[5])
                             for _ in range(10)], 5) / 10,
            "unfused_us": 1e3 * graph_ms(lambda a=a: [unfused(a)
                                                       for _ in range(10)],
                                         5) / 10})
    log("K2 rows_conv_gn per launch (bf16, weights warm in L2), in forward "
        "order, beside rows_conv alone and rows_conv + K1: "
        + json.dumps(per_pair))

    def k5():
        ops.begin("step")
        return [ops.conv_gn(*a) for a in gn_bufs]

    results["rows_conv_gn"] = dict(
        max_abs_err=err, worst_err_over_tolerance=worst,
        ms=graph_ms(k5, 20), host_ms=cuda_ms(k5, 20),
        unfused_ms=graph_ms(lambda: [unfused(a) for a in gn_bufs], 20),
        plain_ms=graph_ms(lambda: [rows_conv_gn_plain(*a) for a in gn_bufs],
                          20),
        library_ms=None,
        library_composition_ms=graph_ms(
            lambda: [lib_gn(*b) for b in lib_bufs], 20),
        bound_ms=gn_bnd, bound_by=gn_by,
        per="denoise step", launches_per_step=len(gn_bufs),
        ms_per_launch=[q["us"] / 1e3 for q in per_pair])

    # -- ddpm_project_step, without walls, with the wall grid, with margin
    HD = HORIZON * D
    err = 0.0
    x = torch.randn(rows, D, device=dev, generator=g)
    eps, noise, cond = (torch.randn_like(x) for _ in range(3))
    scal = torch.tensor([1.2, 0.5, 0.6, 0.4, 0.1, 0.7, 0.0, 0.0], device=dev)
    M = torch.randn(HD, HD, device=dev, generator=g) / 16
    bvec = torch.randn(HD, device=dev, generator=g)
    grid = np.asarray(maze_grid_for_env(ENV))
    pos = ((0.1, -0.2), (1.6, 1.6))
    for wall, margin in ((None, None), (grid, None), (grid, 0.1)):
        cfg = StepConfig(HORIZON, True, True, wall, margin, pos)
        for Mi, bi in ((M, bvec), (None, None)):
            want = ddpm_project_step_plain(x, eps, noise, scal, cond, Mi, bi, cfg)
            got = ddpm_project_step(x.clone(), eps, noise, scal, cond, Mi, bi, cfg)
            e = (got - want).abs().max().item()
            log(f"K2 ddpm_project_step walls={wall is not None} "
                f"margin={margin} projection={Mi is not None}: max|err| {e:.3e}")
            err = max(err, e)
    require(err <= TOL_STEP, f"ddpm_project_step vs plain {err} > {TOL_STEP}")
    cfg = StepConfig(HORIZON, True, True, None, None, None)
    xs = x.clone()
    nb = 4 * rows * D * 5 + 4 * HD * HD + 4 * HD + 32
    fl = 2.0 * (rows // HORIZON) * HD * HD
    b_ms, b_by = bound_ms(fl, nb, F32_FLOPS)
    def k3():
        return ddpm_project_step(xs, eps, noise, scal, cond, M, bvec, cfg)

    results["ddpm_project_step"] = dict(
        max_abs_err=err, ms=graph_ms(k3, 200), host_ms=cuda_ms(k3, 200),
        # ten launches in one graph: without the launch of a graph per call
        ms_in_sequence=graph_ms(lambda: [k3() for _ in range(10)], 50) / 10,
        plain_ms=graph_ms(lambda: ddpm_project_step_plain(
            x, eps, noise, scal, cond, M, bvec, cfg), 200),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, per="launch",
        launches_per_step=1)
    return results


def chain_phase(policy):
    """The whole chain (N=8, T=100) against its plain version, the DDPM
    sampler, with f32 weights; then with the main path's bf16 weights
    against the plain chain at the same rounding points; then wave times."""
    from dadiff_tpu_torch.guides.sampling import (
        conditions_for_initial_obs, make_sampler,
    )
    from dadiff_tpu_torch.ops.chain_operands import prepare_chain_operands
    from dadiff_tpu_torch.ops.planner import (
        StepConfig, _PlainOps, build_interleaved_projection,
        make_planner_chain, run_chain,
    )
    from dadiff_tpu_torch.ops.projection import projection_alpha

    diff = policy.diffusion
    spec = policy._sampler_config["projection"]
    stats, P = policy._stats, policy._P
    H, D = diff.horizon, diff.transition_dim
    rows = N_CAND * H
    dev = diff.device
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    obs = torch.randn(N_CAND, diff.observation_dim, device=dev, generator=g) * 0.5
    cond = conditions_for_initial_obs(obs, diff.observation_dim, H, D)
    x0 = torch.randn(N_CAND, H, D, device=dev, generator=g)
    noise = torch.randn(T_STEPS, N_CAND, H, D, device=dev, generator=g)
    M, b = build_interleaved_projection(
        P, stats,
        observation_dim=diff.observation_dim, action_dim=diff.action_dim,
        state_dim=spec.state_dim, horizon=H)
    M, b = M.to(dev), b.to(dev)
    chain = make_planner_chain(diff.model, diff.schedule, H, N_CAND, 1,
                               projection=True)
    ts = chain.timesteps.to(dev)

    def operands(wd):
        fw, me, sc = prepare_chain_operands(diff.model, diff.schedule, ts, wd)
        sc[:, 5] = projection_alpha(ts, diff.n_timesteps, spec.schedule,
                                    spec.strength, diff.schedule.betas)
        return fw, me, sc

    def run(ops_w, graph=True, noise=noise):
        fw, me, sc = ops_w
        return chain(fw, x0.reshape(rows, D), me,
                     noise.reshape(T_STEPS, rows, D), sc,
                     cond.values.reshape(rows, D), M, b, graph=graph)

    sampler = make_sampler(diff, projection=spec)

    def plain():
        return sampler(None, cond, P, stats, init_noise=x0, step_noise=noise)

    ops32, ops16 = operands(torch.float32), operands(torch.bfloat16)
    want = plain()
    got32 = run(ops32).reshape(N_CAND, H, D)
    err32 = (got32 - want).abs().max().item()
    log(f"K2 chain f32 weights vs plain DDPM sampler (N={N_CAND}, T={T_STEPS}):"
        f" max|err| {err32:.3e} (tolerance {TOL_CHAIN_F32})")
    require(err32 <= TOL_CHAIN_F32, "f32 chain vs plain sampler")

    # plain version of the same chain at bf16 rounding points, on the card
    fw, me, sc = ops16
    with torch.no_grad():
        x = run_chain(_PlainOps(), diff.model, fw, x0.reshape(rows, D), me,
                      noise.reshape(T_STEPS, rows, D), sc,
                      cond.values.reshape(rows, D), M, b, StepConfig(H))
    got16 = run(ops16)
    err16 = (got16 - x).abs().max().item()
    err16_f32 = (got16.reshape(N_CAND, H, D) - want).abs().max().item()
    log(f"K2 chain bf16 weights vs plain chain at bf16: max|err| {err16:.3e} "
        f"(tolerance {TOL_CHAIN_BF16}); vs the f32 plain sampler {err16_f32:.3e}")
    require(err16 <= TOL_CHAIN_BF16, "bf16 chain vs plain chain")
    require(bool(torch.isfinite(got16).all()), "bf16 chain finite")
    require(bool((got16.reshape(N_CAND, H, D)[:, 0] ==
                  cond.values[:, 0]).all()), "chain row 0 conditioned")

    # the wave replayed from its CUDA graph (captured by the call above)
    # against the wave driven from the host: the same noise gives the same
    # bits, other noise through the same buffers too, and a replay counts
    # the launches of a host-driven wave
    counters = _counters()
    noise2 = torch.randn(T_STEPS, N_CAND, H, D, device=dev, generator=g)
    for nz in (noise, noise2, noise):
        before = {k: f.launches for k, f in counters.items()}
        cl_before = read_cluster_counts()
        replayed = run(ops16, noise=nz)
        mid = {k: f.launches for k, f in counters.items()}
        cl_mid = read_cluster_counts()
        hosted = run(ops16, graph=False, noise=nz)
        after = {k: f.launches for k, f in counters.items()}
        cl_after = read_cluster_counts()
        require(torch.equal(replayed, hosted),
                "a replayed wave equals the host-driven wave bit for bit")
        require(all(mid[k] - before[k] == after[k] - mid[k] for k in before)
                and all(cl_mid[k] - cl_before[k] == cl_after[k] - cl_mid[k]
                        for k in cl_before),
                f"a replay counts a wave's launches ({before} {mid} {after}; "
                f"cluster tile {cl_before} {cl_mid} {cl_after})")
    require(torch.equal(replayed, got16), "the wave repeats bit for bit")
    require(not torch.equal(run(ops16, noise=noise2), got16),
            "other noise gives another plan")
    per_wave = {k: after[k] - mid[k] for k in after if after[k] != mid[k]}
    calls, _, n_res = step_launches(diff.model, rows, D)
    launches_per_wave = T_STEPS * (len(calls) + 1) + n_res
    cl_per_wave = {k: cl_after[k] - cl_mid[k] for k in cl_after}
    log(f"K2 chain: replayed wave == host-driven wave bit for bit on 3 "
        f"waves; launches per wave {per_wave} "
        f"({sum(per_wave.values())} in all), of them on the cluster tile "
        f"{cl_per_wave}")
    require(sum(per_wave.values()) == launches_per_wave
            and per_wave.get("rows_conv_gn") == 25 * T_STEPS
            and "gn_mish" not in per_wave,
            f"a wave launches {launches_per_wave}, 25 fused convs a step and "
            f"no K1: {per_wave}")

    # the same wave with each fused pair unfused, rows_conv then K1
    # (the standalone GroupNorm), replayed from its own graph: the fusion's
    # share of the wave, timed in turns with the fused wave
    from dadiff_tpu_torch.ops.gn_mish import launch_gn_mish
    from dadiff_tpu_torch.ops.planner import SAME, _CudaOps, _WaveRunner

    class UnfusedOps(_CudaOps):
        def conv_gn(self, xa, xb, w, bias, k, seg, scale, gbias, te=None,
                    res=None):
            y = self.conv(xa, xb, w, bias, SAME, k, seg)
            out = self._take(*y.shape)
            launch_gn_mish(y, out, scale, gbias, te, 0, res, 8, 1e-5, seg,
                           self.stream)
            return out

    unfused = _WaveRunner(diff.model, StepConfig(H), UnfusedOps(dev),
                          (rows, D), T_STEPS, dev)
    fw, me, sc = ops16

    def run_unfused():
        return unfused.run(fw, x0.reshape(rows, D), me,
                           noise.reshape(T_STEPS, rows, D), sc,
                           cond.values.reshape(rows, D), M, b)

    e = (run_unfused() - got16).abs().max().item()
    require(e <= TOL_CHAIN_BF16, f"unfused wave vs fused wave {e}")
    turns = {"fused": [], "unfused": []}
    for name in ("fused", "unfused", "unfused", "fused"):
        turns[name].append(cuda_ms(run_unfused if name == "unfused"
                                   else lambda: run(ops16), 5, warmup=1))
    log(f"K2 chain: bo8 wave replayed, fused vs rows_conv + K1, in turns: "
        f"{json.dumps(turns)} (max|diff| {e:.3e})")

    # wave times and the bound of one bo8 wave
    flops, nbytes, w_bytes = wave_cost(diff.model, ops16[0], me, rows, D)
    b_ms, b_by = bound_ms(flops, nbytes, BF16_FLOPS)
    return dict(
        max_abs_err=err32, bf16_max_abs_err=err16,
        ms=cuda_ms(lambda: run(ops16, graph=False), 5, warmup=1),
        graph_ms=cuda_ms(lambda: run(ops16), 5, warmup=1),
        ms_f32=cuda_ms(lambda: run(ops32), 3, warmup=1),
        launches_by_kernel=per_wave,
        plain_ms=cuda_ms(plain, 3, warmup=1),
        plain_graph_ms=graph_ms(plain, 3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, per="bo8 wave",
        flops_per_wave=flops, weight_bytes=w_bytes,
        bytes_per_wave=nbytes,
        launches_per_wave=launches_per_wave,
        wave_ms_in_turns=turns,
    )


def _chain_operands(diff, spec, chain, weight_dtype):
    """Flattened weights, time rows and step scalars of a projected chain."""
    from dadiff_tpu_torch.ops.chain_operands import prepare_chain_operands
    from dadiff_tpu_torch.ops.projection import projection_alpha

    ts = chain.timesteps.to(diff.device)
    fw, me, sc = prepare_chain_operands(diff.model, diff.schedule, ts,
                                        weight_dtype)
    sc[:, 5] = projection_alpha(ts, diff.n_timesteps, spec.schedule,
                                spec.strength, diff.schedule.betas)
    return fw, me, sc


def _wave_inputs(diff, n_chains, seed):
    """x_T, step noise and row-0 conditioning of ``n_chains`` chains."""
    from dadiff_tpu_torch.guides.sampling import conditions_for_initial_obs

    H, D, dev = diff.horizon, diff.transition_dim, diff.device
    g = torch.Generator(device=dev).manual_seed(seed)
    obs = torch.randn(n_chains, diff.observation_dim, device=dev,
                      generator=g) * 0.5
    cond = conditions_for_initial_obs(obs, diff.observation_dim, H, D)
    x0 = torch.randn(n_chains * H, D, device=dev, generator=g)
    noise = torch.randn(T_STEPS, n_chains * H, D, device=dev, generator=g)
    return x0, noise, cond, cond.values.reshape(n_chains * H, D)


def chain64_phase(policy) -> dict:
    """The planner chain at 64 chains in one group (an evaluator chain) with
    f32 weights against its plain version, the DDPM sampler with the
    projection, on the card."""
    from dadiff_tpu_torch.guides.sampling import make_sampler
    from dadiff_tpu_torch.ops.planner import (
        build_interleaved_projection, make_planner_chain,
    )

    diff, spec = policy.diffusion, policy._sampler_config["projection"]
    H, D, n = diff.horizon, diff.transition_dim, GROUP_CHAINS
    M, b = (t.to(diff.device) for t in build_interleaved_projection(
        policy._P, policy._stats, observation_dim=diff.observation_dim,
        action_dim=diff.action_dim, state_dim=spec.state_dim, horizon=H))
    chain = make_planner_chain(diff.model, diff.schedule, H, n, 1,
                               projection=True)
    x0, noise, cond, cond_rows = _wave_inputs(diff, n, SEED + 5)
    fw, me, sc = _chain_operands(diff, spec, chain, torch.float32)
    got = chain(fw, x0, me, noise, sc, cond_rows, M, b).reshape(n, H, D)
    want = make_sampler(diff, projection=spec)(
        None, cond, policy._P, policy._stats, init_noise=x0.reshape(n, H, D),
        step_noise=noise.reshape(T_STEPS, n, H, D))
    err = (got - want).abs().max().item()
    log(f"K2 chain f32 weights, {n} chains, vs plain DDPM sampler: max|err| "
        f"{err:.3e} (tolerance {TOL_CHAIN_F32})")
    require(err <= TOL_CHAIN_F32 and bool(torch.isfinite(got).all()),
            f"the {n}-chain f32 wave vs the plain sampler: {err}")
    return {"chains": n, "max_abs_err": err}


def two_stream_phase(policy) -> dict:
    """Work on two streams at once gives what each gives alone, bit for bit:
    a served chain (8 chains) and an evaluator chain (64 chains), each owning
    its buffers and split-K and group counters, replayed from their CUDA
    graphs on two streams and driven from the host by two threads; two K4
    launches, whose partials and h live in a scratch per stream."""
    from dadiff_tpu_torch.models.fused_unet import fused_block_params
    from dadiff_tpu_torch.ops.planner import (
        build_interleaved_projection, make_planner_chain,
    )
    from dadiff_tpu_torch.ops.resblock import fused_residual_block

    diff, spec = policy.diffusion, policy._sampler_config["projection"]
    H, dev = diff.horizon, diff.device
    M, b = (t.to(dev) for t in build_interleaved_projection(
        policy._P, policy._stats, observation_dim=diff.observation_dim,
        action_dim=diff.action_dim, state_dim=spec.state_dim, horizon=H))
    waves = []
    for n, seed in ((N_CAND, SEED + 6), (GROUP_CHAINS, SEED + 7)):
        chain = make_planner_chain(diff.model, diff.schedule, H, n, 1,
                                   projection=True)
        fw, me, sc = _chain_operands(diff, spec, chain, torch.bfloat16)
        x0, noise, _, cond_rows = _wave_inputs(diff, n, seed)
        args = (fw, x0, me, noise, sc, cond_rows, M, b)
        alone = chain(*args)          # host-driven, then captured
        require(torch.equal(chain(*args), alone), "a replay repeats its wave")
        waves.append((chain, args, alone))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for rep in range(3):
        outs = [None, None]
        for i, ((chain, args, _), st) in enumerate(zip(waves, streams)):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs[i] = chain(*args)   # a replay, enqueued at once
        torch.cuda.synchronize()
        require(all(torch.equal(o, w[2]) for o, w in zip(outs, waves)),
                f"replays on two streams equal each alone (round {rep})")

    def host_driven(i):
        chain, args, _ = waves[i]
        with torch.cuda.stream(streams[i]):
            outs[i] = chain(*args, graph=False)

    outs = [None, None]
    threads = [threading.Thread(target=host_driven, args=(i,))
               for i in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    require(all(torch.equal(o, w[2]) for o, w in zip(outs, waves)),
            "host-driven waves from two threads on two streams equal each "
            "alone")
    log(f"two streams: the {N_CAND}- and {GROUP_CHAINS}-chain waves, "
        "replayed (3 rounds) and host-driven from two threads, equal each "
        "alone bit for bit")

    # K4: the widest block and a 128 -> 256 block, on two streams at once
    blocks = [{k: v.detach() for k, v in bp.items()}
              for bp in fused_block_params(diff.model)]
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    cases = []
    for bp, rows in ((blocks[4], H // 4), (blocks[2], H // 2)):
        x = torch.randn(8, rows, bp["w1"].shape[1], device=dev, generator=g)
        te = torch.randn(8, bp["w1"].shape[2], device=dev, generator=g)
        cases.append((x, te, bp, fused_residual_block(x, te, bp)))
    torch.cuda.synchronize()
    for rep in range(3):
        outs = [None, None]
        for i, ((x, te, bp, _), st) in enumerate(zip(cases, streams)):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs[i] = [fused_residual_block(x, te, bp) for _ in range(4)]
        torch.cuda.synchronize()
        require(all(torch.equal(o, c[3]) for os_, c in zip(outs, cases)
                    for o in os_),
                f"K4 on two streams equals K4 alone (round {rep})")
    log("two streams: K4 launches of two blocks, 4 each per stream, equal "
        "their one-stream results bit for bit")
    return {"waves": [N_CAND, GROUP_CHAINS], "rounds": 3, "k4_blocks": 2}


def env_phase() -> dict:
    """The batched PointMaze on the card against the same env on the CPU:
    EVAL_ENVS envs x 320 random actions from the same states, for both
    contact models; the largest position difference over all steps and the
    contact events that disagree (a contact: the contact model changed the
    integrated velocity by more than 1e-5)."""
    from dadiff_tpu_torch.envs.pointmaze_jax import PointMazeJax

    out = {}
    n_steps = EVAL_REPLANS * EVAL_ACTIONS
    for collision in ("disc", "axis"):
        env = PointMazeJax(collision=collision)
        g = torch.Generator().manual_seed(SEED + 9)
        cpu, _ = env.reset(g, EVAL_ENVS)
        actions = torch.randn(n_steps, EVAL_ENVS, 2, generator=g) * 2
        card = type(cpu)(*(t.cuda() for t in cpu))
        acts_card = actions.cuda()
        diff_max, mismatch, contacts = 0.0, 0, 0

        def step(state, a):
            """The env's step, and which envs the contact model touched."""
            free = (env.damping * state.vel
                    + a.clamp(-1, 1) * env.vel_gain).clamp(-5.0, 5.0)
            new = env.step(state, a)[0]
            return new, ((new.vel - free).abs() > 1e-5).any(-1)

        t0 = time.perf_counter()
        for i in range(n_steps):
            card, h_card = step(card, acts_card[i])
            cpu, h_cpu = step(cpu, actions[i])
            mismatch += int((h_card.cpu() != h_cpu).sum())
            contacts += int(h_cpu.sum())
            diff_max = max(diff_max, (card.pos.cpu() - cpu.pos).abs().max()
                           .item())
        took = time.perf_counter() - t0
        log(f"env ({collision}): {EVAL_ENVS} envs x {n_steps} steps on the "
            f"card vs the CPU: max|pos diff| {diff_max:.3e}, contact events "
            f"{contacts}, mismatches {mismatch} ({took:.1f} s for both)")
        require(diff_max <= TOL_ENV_POS, f"env {collision}: positions part "
                f"by {diff_max} > {TOL_ENV_POS}")
        require(mismatch <= ENV_MISMATCH_PER_STEP * EVAL_ENVS * n_steps,
                f"env {collision}: {mismatch} contact events disagree")
        require(contacts > 0, f"env {collision}: no wall was touched")
        out[collision] = {"max_pos_diff": diff_max, "contacts": contacts,
                          "mismatches": mismatch}
    return out


# the keys of the JAX package's eval_ondevice results file
# (scripts/eval_ondevice.py:168-204)
ONDEVICE_KEYS = (
    "policy_type", "environment", "checkpoint", "dataset", "n_episodes",
    "sampling_timesteps", "seed", "timestamp", "metrics", "mode",
    "megakernel", "projection", "wall_aware", "n_candidates", "warm_start_t",
    "batch", "env_steps_per_episode", "success_rate", "mean_reward",
    "mean_final_distance", "wallclock_s", "episodes_per_hour", "compile_s",
    "action_horizon", "n_replans", "sampler", "collision", "wall_slack",
    "per_env_success")


def step_library_times(calls, g) -> dict:
    """``rows_conv`` over every conv of a denoise step's ``calls`` (bf16
    weights, the fused ones without their epilogue) and ``rows_conv_gn``
    over its fused pairs (as the wave launches them, on its own buffers),
    each replayed from a CUDA graph, beside the library's time for the same
    function on the same inputs (one cuDNN bf16 conv per conv; cuDNN's conv,
    F.group_norm, F.mish and the adds per pair), timed and never used by
    the port, and the bound; per launch, tile, splits, kernel, library and
    bound in microseconds; the 10 convs the wave launches through
    ``rows_conv`` alone (``wave_convs``); and the same launches on the
    mma.sync tiles that these shapes took before the wgmma tile
    (``mma_sync_ms``), in turns with the wgmma tiles."""
    from dadiff_tpu_torch.ops.planner import (
        _CudaOps, _conv_out_rows, _split_k, _split_k_gn, _split_k_gn_mma,
        _split_k_mma, launch_rows_conv, launch_rows_conv_gn, rows_conv,
    )

    def tile_of(t):
        return (f"wgmma 128x{t.bn}, {t.ring} stages" if t.ring
                else f"mma.sync {t.bm}x{t.bn}")

    conv_calls = [c[1:8] for c in calls]
    conv_bufs = conv_buffers(conv_calls, g)
    costs = [conv_cost(R, ca, cb, cout, mode, k, 2)
             for R, ca, cb, cout, mode, k, _ in conv_calls]
    t_ops = sum(fl for fl, _ in costs) / BF16_FLOPS * 1e3
    t_bytes = sum(nb for _, nb in costs) / HBM_BPS * 1e3
    per_launch = []
    for (R, ca, cb, cout, mode, k, _), c, (fl, nb) in zip(conv_calls,
                                                          conv_bufs, costs):
        t = _split_k(R, ca + cb, cout, mode, k, True)
        per_launch.append({
            "M": t.M, "K": t.K, "N": cout, "mode": mode, "tile": tile_of(t),
            "splits": t.splits,
            "us": 1e3 * graph_ms(lambda c=c: [rows_conv(*c[:7])
                                               for _ in range(5)], 3) / 5,
            "library_us": 1e3 * graph_ms(
                lambda c=c: [lib_conv(c[7], c[8], c[9], c[4], c[5])
                             for _ in range(5)], 3) / 5,
            "bound_us": 1e3 * bound_ms(fl, nb, BF16_FLOPS)[0]})
    log(f"K2 rows_conv at {calls[0][1]} rows, per launch (weights warm in "
        f"L2): " + json.dumps(per_launch))
    # the U-Net's final conv (the narrowest output), alone beside cuDNN's
    i = min(range(len(conv_calls)), key=lambda j: conv_calls[j][3])
    final = dict(per_launch[i], cin=conv_calls[i][1] + conv_calls[i][2],
                 kernel_over_library=per_launch[i]["us"]
                 / per_launch[i]["library_us"])
    log(f"K2 rows_conv, the final {final['cin']}->{final['N']} conv at "
        f"{calls[0][1]} rows ({final['tile']}, {final['splits']} split(s)): "
        f"kernel {final['us']:.2f} us, cuDNN (F.conv1d, bf16) "
        f"{final['library_us']:.2f} us, bound {final['bound_us']:.2f} us "
        f"a launch (CUDA-graph replays of 5 launches)")

    # the same launches on the mma.sync tiles (the tile rule of before)
    mma = []
    for (R, ca, cb, cout, mode, k, _), c in zip(conv_calls, conv_bufs):
        t = _split_k_mma(R, ca + cb, cout, mode, k, True)
        out = torch.empty(_conv_out_rows(R, mode), cout, device="cuda")
        scratch = torch.empty(max(t.partial_elems, 1), device="cuda")
        mma.append((c, out, scratch, t))

    def on_mma():
        for c, out, scratch, t in mma:
            launch_rows_conv(*c[:4], out, *c[4:7], None, scratch, t)

    def on_rule():
        return [rows_conv(*c[:7]) for c in conv_bufs]

    wave = [c for c, call in zip(conv_bufs, calls) if call[0] == "conv"]
    turns = [graph_ms(on_mma, 5), graph_ms(on_rule, 5), graph_ms(on_rule, 5),
             graph_ms(on_mma, 5)]
    out = {"rows_conv": dict(
        ms=turns[1], library_ms=graph_ms(
            lambda: [lib_conv(c[7], c[8], c[9], c[4], c[5])
                     for c in conv_bufs], 5),
        bound_ms=sum(bound_ms(fl, nb, BF16_FLOPS)[0] for fl, nb in costs),
        bound_by="operations" if t_ops > t_bytes else "bytes",
        launches_per_step=len(conv_bufs),
        ms_in_turns={"mma_sync": [turns[0], turns[3]],
                     "rule": [turns[1], turns[2]]},
        mma_sync_ms=turns[0],
        wave_convs=dict(
            launches=len(wave),
            ms=graph_ms(lambda: [rows_conv(*c[:7]) for c in wave], 5),
            library_ms=graph_ms(
                lambda: [lib_conv(c[7], c[8], c[9], c[4], c[5])
                         for c in wave], 5),
            bound_ms=sum(bound_ms(fl, nb, BF16_FLOPS)[0]
                         for (fl, nb), call in zip(costs, calls)
                         if call[0] == "conv")),
        final_conv=final,
        tiles=sorted({q["tile"] for q in per_launch}))}
    del conv_bufs, mma, wave
    fused = [c for c in calls if c[0] == "conv_gn"]
    gn_bufs = gn_buffers(fused, g)
    lib_bufs = [lib_operands(a) for a in gn_bufs]
    ops = _CudaOps("cuda")

    def k5():
        ops.begin("step")
        return [ops.conv_gn(*a) for a in gn_bufs]

    # the fused pairs on the mma.sync tiles, with their group counters
    gcount = torch.zeros(1 << 14, dtype=torch.int32, device="cuda")
    mma_gn = []
    for a in gn_bufs:
        R, cin, cout = a[0].shape[0], a[2].shape[0] // a[4], a[2].shape[1]
        t, gp = _split_k_gn_mma(R, cin, cout, a[4], a[5], True)
        mma_gn.append((a, torch.empty(R, cout, device="cuda"),
                       torch.empty(max(t.partial_elems, 1), device="cuda"),
                       t, gp))

    def k5_mma():
        for a, o, scratch, t, gp in mma_gn:
            launch_rows_conv_gn(*a[:4], o, *a[4:8], a[8], 0, a[9], gcount,
                                None, scratch, t, gp)

    per_pair = []
    for call, a in zip(fused, gn_bufs):
        R, cin, cout = a[0].shape[0], a[2].shape[0] // a[4], a[2].shape[1]
        t, _ = _split_k_gn(R, cin, cout, a[4], a[5], True)

        def one(a=a):
            ops.begin("pair")
            return ops.conv_gn(*a)

        per_pair.append({
            "M": R, "K": t.K, "N": cout, "seg": a[5], "tile": tile_of(t),
            "splits": t.splits,
            "us": 1e3 * graph_ms(lambda one=one: [one() for _ in range(5)],
                                 3) / 5,
            "bound_us": 1e3 * max(gn_pair_times(call))})
    log(f"K2 rows_conv_gn at {fused[0][1]} rows, per launch (weights warm "
        f"in L2): " + json.dumps(per_pair))
    b_ms, b_by = gn_pair_bound(fused)
    turns = [graph_ms(k5_mma, 5), graph_ms(k5, 5), graph_ms(k5, 5),
             graph_ms(k5_mma, 5)]
    out["rows_conv_gn"] = dict(
        ms=turns[1],
        library_ms=graph_ms(lambda: [lib_gn(*b) for b in lib_bufs], 5),
        bound_ms=b_ms, bound_by=b_by, launches_per_step=len(gn_bufs),
        ms_in_turns={"mma_sync": [turns[0], turns[3]],
                     "rule": [turns[1], turns[2]]},
        mma_sync_ms=turns[0], tiles=sorted({q["tile"] for q in per_pair}))
    for name, r in out.items():
        r["kernel_over_library"] = r["ms"] / r["library_ms"]
    return out


def ondevice_eval_phase(ckpt: Path, policy, results_dir: Path) -> dict:
    """The on-device evaluation entry point at the published protocol on the
    trained checkpoint (150 steps of training: the success rate is logged,
    not gated), with the counters set to 0 before and read after: two runs
    (untimed, timed) of EVAL_REPLANS waves of 1,024 chains, 3,612 K2
    launches each and no K1. Then a 1,024-chain wave on the chain's own
    buffers: replayed from its graph equal to host-driven bit for bit, both
    timed, with its bound; ``ddpm_project_step`` at 1,024 chains; K2's
    kernels at the wave's shapes beside the library's time; peak memory."""
    from dadiff_tpu_torch import eval_ondevice
    from dadiff_tpu_torch.ops.planner import (
        StepConfig, _PlainOps, build_interleaved_projection,
        ddpm_project_step, make_planner_chain, run_chain,
    )

    diff, spec = policy.diffusion, policy._sampler_config["projection"]
    H, D, dev = diff.horizon, diff.transition_dim, diff.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = eval_ondevice.main([
        "--checkpoint", str(ckpt), "--dataset", DATASET, "--megakernel",
        "--projection", "--n-candidates", str(N_CAND), "--batch",
        str(EVAL_ENVS), "--n-replans", str(EVAL_REPLANS), "--action-horizon",
        str(EVAL_ACTIONS), "--seed", str(EVAL_SEED), "--results-dir",
        str(results_dir)])
    took = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    calls, _, n_res = step_launches(diff.model, EVAL_CHAINS * H, D)
    per_wave = T_STEPS * (len(calls) + 1) + n_res
    want_waves = 2 * EVAL_REPLANS
    k2 = {k: counts[k] for k in ("rows_conv", "rows_conv_gn",
                                 "ddpm_project_step")}
    log(f"on-device eval launches: {counts} (expected {want_waves} waves of "
        f"{per_wave})")
    require(sum(k2.values()) == want_waves * per_wave
            and k2["rows_conv_gn"] == want_waves * 25 * T_STEPS
            and k2["ddpm_project_step"] == want_waves * T_STEPS,
            f"the on-device run launches {want_waves} waves of {per_wave}: "
            f"{k2}")
    require(counts["gn_mish"] == counts["gn_mish_backward"] == 0, "K1 launched on the on-device path")
    waves = sum(k2.values()) / per_wave
    with open(out["results_path"]) as f:
        saved = json.load(f)
    missing = [k for k in ONDEVICE_KEYS if k not in saved]
    require(not missing, f"results file lacks the JAX keys {missing}")
    require(0.0 <= out["success_rate"] <= 1.0
            and len(saved["per_env_success"]) == EVAL_ENVS,
            "on-device metrics")
    log(f"on-device eval: success {out['success_rate']} over {EVAL_ENVS} "
        f"episodes (150 training steps: not gated), timed run "
        f"{out['wallclock_s']:.3f} s, {out['episodes_per_hour']:.0f} "
        f"episodes/hour, first run {out['compile_s']:.3f} s, peak memory "
        f"{peak / 2**20:.1f} MiB, {took:.1f} s for the entry point")

    # K2's kernels at the shapes of the 32,768-row wave (other tiles, K
    # splits and group blocks than at the served 256 rows): every conv and
    # every fused pair of its denoise step, with bf16 weights as the wave
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    conv_err = hold_rows_conv([c[1:8] for c in calls], (torch.bfloat16,), g)
    gn_err, gn_worst = hold_rows_conv_gn(
        [c for c in calls if c[0] == "conv_gn"], (torch.bfloat16,), g)
    library = step_library_times(calls, g)
    log(f"K2 at {EVAL_CHAINS * H} rows, per denoise step against the "
        f"library: {json.dumps(library)}")

    # one wave of the evaluator's shape: 16 groups of 64 chains
    M, b = (t.to(dev) for t in build_interleaved_projection(
        policy._P, policy._stats, observation_dim=diff.observation_dim,
        action_dim=diff.action_dim, state_dim=spec.state_dim, horizon=H))
    chain = make_planner_chain(diff.model, diff.schedule, H, GROUP_CHAINS,
                               EVAL_CHAINS // GROUP_CHAINS, projection=True)
    fw, me, sc = _chain_operands(diff, spec, chain, torch.bfloat16)
    x0, noise, _, cond_rows = _wave_inputs(diff, EVAL_CHAINS, SEED + 10)
    args = (fw, x0, me, noise, sc, cond_rows, M, b)
    first = chain(*args)                  # host-driven, then captured
    replayed = chain(*args)
    hosted = chain(*args, graph=False)
    require(torch.equal(replayed, hosted) and torch.equal(first, replayed),
            "the 1,024-chain wave replayed equals the host-driven wave bit "
            "for bit")
    require(bool(torch.isfinite(replayed).all()), "1,024-chain wave finite")
    # the plain chain at the same bf16 rounding points, on the card
    box = {}

    def plain():
        box["x"] = run_chain(_PlainOps(), diff.model, fw, x0, me, noise, sc,
                             cond_rows, M, b, StepConfig(H))

    with torch.no_grad():
        plain_ms = cuda_ms(plain, 1, warmup=0)
    wave_err = (replayed - box.pop("x")).abs().max().item()
    log(f"K2 chain bf16 weights, {EVAL_CHAINS} chains, vs plain chain at "
        f"bf16: max|err| {wave_err:.3e} (tolerance {TOL_CHAIN_BF16})")
    require(wave_err <= TOL_CHAIN_BF16,
            f"the {EVAL_CHAINS}-chain bf16 wave vs the plain chain: "
            f"{wave_err}")
    wave_ms = cuda_ms(lambda: chain(*args), 3, warmup=1)
    host_ms = cuda_ms(lambda: chain(*args, graph=False), 2, warmup=0)
    flops, nbytes, _ = wave_cost(diff.model, fw, me, EVAL_CHAINS * H, D)
    b_ms, b_by = bound_ms(flops, nbytes, BF16_FLOPS)
    # ddpm_project_step alone at 1,024 chains, projection on
    cfg = StepConfig(H)
    g.manual_seed(SEED + 11)
    xs, eps, nz = (torch.randn(EVAL_CHAINS * H, D, device=dev, generator=g)
                   for _ in range(3))
    scal = sc[50].contiguous()
    step_ms = graph_ms(lambda: [ddpm_project_step(xs, eps, nz, scal,
                                                  cond_rows, M, b, cfg)
                                for _ in range(10)], 5) / 10
    HD = H * D
    step_bound, step_by = bound_ms(2.0 * EVAL_CHAINS * HD * HD,
                                   4 * EVAL_CHAINS * H * D * 5
                                   + 4 * HD * (HD + 1) + 32, F32_FLOPS)
    waves_s = EVAL_REPLANS * wave_ms * 1e-3
    log(f"1,024-chain wave: {wave_ms:.3f} ms replayed, {host_ms:.3f} ms "
        f"host-driven, bound {b_ms:.4f} ms ({b_by}, {flops / 1e12:.2f} "
        f"TFLOP); ddpm_project_step {step_ms * 1e3:.2f} us per launch "
        f"({100 * T_STEPS * step_ms / wave_ms:.1f}% of a wave; bound "
        f"{step_bound * 1e3:.3f} us, {step_by}); the timed evaluator run "
        f"{out['wallclock_s']:.3f} s against {waves_s:.3f} s of "
        f"{EVAL_REPLANS} replayed waves; the plain wave {plain_ms:.3f} ms")
    return dict(
        success_rate=out["success_rate"], mean_reward=out["mean_reward"],
        wallclock_s=out["wallclock_s"], first_run_s=out["compile_s"],
        episodes_per_hour=out["episodes_per_hour"], peak_memory_bytes=peak,
        launches_by_kernel={**k2, "gn_mish": counts["gn_mish"]},
        launches_per_wave=per_wave, waves=waves,
        conv_max_abs_err=conv_err, conv_gn_max_abs_err=gn_err,
        conv_gn_worst_err_over_tolerance=gn_worst,
        wave_max_abs_err=wave_err, wave_plain_ms=plain_ms,
        chains=EVAL_CHAINS, wave_ms=wave_ms, wave_host_ms=host_ms,
        wave_bound_ms=b_ms, wave_bound_by=b_by, wave_flops=flops,
        waves_s=waves_s, step_us=step_ms * 1e3,
        step_share_of_wave=T_STEPS * step_ms / wave_ms,
        step_bound_us=step_bound * 1e3, library=library)


def refused(fn, exc, match: str) -> bool:
    """True when ``fn()`` raises ``exc`` with ``match`` in its message."""
    try:
        fn()
    except exc as e:
        return match in str(e)
    return False


def _timed_samplers(rollout, spans):
    """``rollout.make_sampler`` whose plans record a pair of CUDA events
    around each call into ``spans``; returns the original."""
    original = rollout.make_sampler

    def make(*args, **kw):
        plan = original(*args, **kw)

        def timed(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = plan(*a, **k)
            ev[1].record()
            spans.append(ev)
            return out

        timed.timesteps, timed.stochastic = plan.timesteps, plan.stochastic
        return timed

    rollout.make_sampler = make
    return original


def fewcall_phase(ckpt: Path, policy, root: Path, results_dir: Path,
                  card: str) -> dict:
    """The few-call planners through their entry points at the flagship
    width, with the counters set to 0 before and read after (the module
    path, as the JAX package runs them through XLA: no port kernel):
    ``distill_main`` for FEW_STEPS steps of batch FEW_BATCH from the trained
    checkpoint, its train step timed with CUDA events; the student reloaded
    and its marker checked; bo8 plans through DDIM-10 (eta 0 and 0.5),
    DPM++-10, DDPM warm K=FEW_K from a previous plan and the student at 1
    and 4 calls, each held against the same function on the CPU on the same
    draws and timed; DDIM-10 and the student at 1 call at 1,024 chains;
    ``eval_ondevice`` at the published protocol with the student at 1 call
    and with warm start K=FEW_K, the planner's calls bracketed by CUDA
    events; and the refusals."""
    from dadiff_tpu_torch import eval_ondevice
    from dadiff_tpu_torch.cli import (
        build_policy_from_args, distill_main, load_model,
    )
    from dadiff_tpu_torch.datasets.sequence import create_dataloader
    from dadiff_tpu_torch.envs import rollout
    from dadiff_tpu_torch.guides.sampling import (
        conditions_for_initial_obs, make_sampler,
    )
    from dadiff_tpu_torch.losses import make_generators
    from dadiff_tpu_torch.models.consistency import make_cd_loss
    from dadiff_tpu_torch.serve import build_server_parser
    from dadiff_tpu_torch.utils import training as tt

    reset_counts()
    t0 = time.perf_counter()
    log_dir = Path(distill_main([
        "--checkpoint", str(ckpt), "--dataset", DATASET, "--n-epochs", "1",
        "--max-steps", str(FEW_STEPS), "--batch-size", str(FEW_BATCH),
        "--warmup-steps", "10", "--log-freq", str(LOG_FREQ), "--save-freq",
        "0", "--seed", str(SEED), "--log-dir", str(root / "distill")]))
    distill_s = time.perf_counter() - t0
    record = json.loads((log_dir / "metrics.jsonl").read_text()
                        .splitlines()[-1])
    series = record["total_series"]
    require(record["step"] == FEW_STEPS and len(series) > 1
            and all(v == v and abs(v) < 1e6 for v in series),
            f"distillation ran {record['step']} steps, loss finite: {series}")
    student_pt = log_dir / f"checkpoint_step_{FEW_STEPS}.pt"
    student, sdata = load_model(str(student_pt), DATASET, device="cuda")
    require(sdata.checkpoint_config.get("consistency") is True,
            "the student's checkpoint is marked consistency: true")
    require(refused(lambda: eval_ondevice.main([
        "--checkpoint", str(student_pt), "--dataset", DATASET,
        "--results-dir", ""]), SystemExit, "--sampler consistency"),
        "evaluating the student without --sampler consistency exits")

    # the distill step alone: CD loss (teacher DDIM step, student, EMA
    # target), grad, clip, Adam, EMA, at batch FEW_BATCH, CUDA events
    teacher, tdata = load_model(str(ckpt), DATASET, device="cuda")
    frozen = {n: p.detach().clone() for n, p in teacher.named_parameters()}
    teacher.train()
    state = tt.TrainState(teacher, tt.make_optimizer(teacher.parameters()),
                          tt.EMA(teacher, 0.95).shadow)
    step = tt.make_train_step(
        make_cd_loss(teacher, frozen),
        lr_schedule=tt.warmup_cosine_schedule(1e-4, 10, 10000),
        gradient_clip=1.0, ema_decay=0.95, loss_takes_ema=True)
    gens = make_generators(1, SEED, "cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(iter(
        create_dataloader(tdata, FEW_BATCH, seed=SEED))).items()}
    step_ms = cuda_ms(lambda: step(state, batch, gens), 20, warmup=3)
    del state, step, frozen
    log(f"distill: {FEW_STEPS} steps of batch {FEW_BATCH} in "
        f"{distill_s:.1f} s (set-up included); loss {series[0]:.4f} (first "
        f"logged) -> {series[-1]:.4f} (last); a step {step_ms:.3f} ms (CUDA "
        f"events, 20 steps); card {card}")

    # bo8 plans through every new sampler, on the card and on the CPU
    teacher, _ = load_model(str(ckpt), DATASET, device="cuda")
    cpu = {"teacher": load_model(str(ckpt), DATASET, device="cpu")[0],
           "student": load_model(str(student_pt), DATASET, device="cpu")[0]}
    card_models = {"teacher": teacher, "student": student}
    spec, P, stats = (policy._sampler_config["projection"], policy._P,
                      policy._stats)
    P_cpu, stats_cpu = P.cpu(), type(stats)(*(v.cpu() for v in stats))
    H, D = teacher.horizon, teacher.transition_dim
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    obs = (torch.randn(1, teacher.observation_dim, device="cuda",
                       generator=g) * 0.5).repeat(N_CAND, 1)
    cond = conditions_for_initial_obs(obs, teacher.observation_dim, H, D)
    cond_cpu = type(cond)(cond.values.cpu(), cond.mask.cpu())
    cases = [
        ("ddim10", "teacher", dict(sampler="ddim", sampling_timesteps=10),
         TOL_CHAIN_F32),
        ("ddim10_eta0.5", "teacher", dict(sampler="ddim",
                                          sampling_timesteps=10,
                                          ddim_eta=0.5), TOL_CHAIN_F32),
        ("dpmpp10", "teacher", dict(sampler="dpmpp", sampling_timesteps=10),
         TOL_CHAIN_F32),
        (f"ddpm_warm{FEW_K}", "teacher", dict(warm_start_from=FEW_K),
         TOL_CHAIN_F32),
        ("consistency1", "student", dict(sampler="consistency",
                                         sampling_timesteps=1), TOL_FEW_TOP),
        ("consistency4", "student", dict(sampler="consistency",
                                         sampling_timesteps=4), TOL_FEW_TOP),
    ]
    plans8, prev = {}, None
    for name, who, kw, tol in cases:
        plan = make_sampler(card_models[who], projection=spec, **kw)
        n = len(plan.timesteps)
        draws = dict(init_noise=torch.randn(N_CAND, H, D, device="cuda",
                                            generator=g))
        if plan.stochastic:
            n_draws = n - 1 if kw.get("sampler") == "consistency" else n
            draws["step_noise"] = torch.randn(n_draws, N_CAND, H, D,
                                              device="cuda", generator=g)
        if "warm_start_from" in kw:  # the previous plan, 16 actions on
            draws["x_init"] = torch.cat(
                [prev[:, EVAL_ACTIONS:],
                 prev[:, -1:].expand(-1, EVAL_ACTIONS, -1)], dim=1)[:1]
        got = plan(None, cond, P, stats, **draws)
        ms = cuda_ms(lambda: plan(None, cond, P, stats, **draws), 3,
                     warmup=1)
        want = make_sampler(cpu[who], projection=spec, **kw)(
            None, cond_cpu, P_cpu, stats_cpu,
            **{k: v.cpu() for k, v in draws.items()})
        err = (got.cpu() - want).abs().max().item()
        log(f"few-call bo8 {name}: {n} model calls, {ms:.3f} ms (CUDA "
            f"events, module path), card vs CPU max|err| {err:.3e} "
            f"(tolerance {tol}); card {card}")
        require(err <= tol and bool(torch.isfinite(got).all()),
                f"few-call plan {name} on the card vs the CPU: {err}")
        plans8[name] = {"model_calls": n, "ms": ms, "max_abs_err": err,
                        "tolerance": tol}
        prev = got if name == "ddim10" else prev

    # the on-device evaluator's wave size: 128 envs x 8 candidates
    x0, _, cond1024, _ = _wave_inputs(teacher, EVAL_CHAINS, SEED + 21)
    plans1024 = {}
    for name, who, kw in (("ddim10", "teacher", dict(
            sampler="ddim", sampling_timesteps=10)),
            ("consistency1", "student", dict(sampler="consistency",
                                             sampling_timesteps=1))):
        plan = make_sampler(card_models[who], projection=spec, **kw)
        init = x0.reshape(EVAL_CHAINS, H, D)
        got = plan(None, cond1024, P, stats, init_noise=init)
        require(got.shape == (EVAL_CHAINS, H, D)
                and bool(torch.isfinite(got).all()),
                f"{name} at {EVAL_CHAINS} chains finite")
        ms = cuda_ms(lambda: plan(None, cond1024, P, stats,
                                  init_noise=init), 3, warmup=1)
        plans1024[name] = {"model_calls": len(plan.timesteps), "ms": ms}
        log(f"few-call {name} at {EVAL_CHAINS} chains: "
            f"{len(plan.timesteps)} model calls, {ms:.3f} ms (CUDA events, "
            f"module path); card {card}")

    # the on-device protocol through the entry point; TF32 convs on, the
    # library's default, as a user of the CLI runs it
    runs = {}
    for name, pt, flags in (
            ("consistency1", student_pt, ["--sampler", "consistency",
                                          "--sampling-timesteps", "1"]),
            (f"ddpm_warm{FEW_K}", ckpt, ["--warm-start-t", str(FEW_K)])):
        spans = []
        original = _timed_samplers(rollout, spans)
        torch.backends.cudnn.allow_tf32 = True
        try:
            out = eval_ondevice.main([
                "--checkpoint", str(pt), "--dataset", DATASET,
                "--projection", "--n-candidates", str(N_CAND), "--batch",
                str(EVAL_ENVS), "--n-replans", str(EVAL_REPLANS),
                "--action-horizon", str(EVAL_ACTIONS), "--seed",
                str(EVAL_SEED), "--results-dir", str(results_dir), *flags])
        finally:
            torch.backends.cudnn.allow_tf32 = False
            rollout.make_sampler = original
        torch.cuda.synchronize()
        require(len(spans) == 2 * EVAL_REPLANS,
                f"{name}: {len(spans)} planner calls over two runs")
        planner_s = sum(a.elapsed_time(b) for a, b in
                        spans[EVAL_REPLANS:]) / 1e3
        require(0.0 <= out["success_rate"] <= 1.0, f"{name} metrics")
        runs[name] = {
            "success_rate": out["success_rate"],
            "wallclock_s": out["wallclock_s"], "planner_s": planner_s,
            "share_outside_planner": 1.0 - planner_s / out["wallclock_s"],
            "episodes_per_hour": out["episodes_per_hour"],
            "first_run_s": out["compile_s"],
            "model_calls_per_replan": out["model_calls_per_replan"]}
        log(f"eval_ondevice {name}: success {out['success_rate']} over "
            f"{EVAL_ENVS} episodes (not gated), timed run "
            f"{out['wallclock_s']:.3f} s of which the planner "
            f"{planner_s:.3f} s ({100 * (1 - planner_s / out['wallclock_s']):.1f}"
            f"% outside it), {out['episodes_per_hour']:.0f} episodes/hour, "
            f"model calls per replan {out['model_calls_per_replan']}; card "
            f"{card}")
    require(runs["consistency1"]["model_calls_per_replan"] == [1, 1]
            and runs[f"ddpm_warm{FEW_K}"]["model_calls_per_replan"]
            == [T_STEPS, FEW_K], f"model calls per replan: {runs}")

    # the planner chain is the DDPM sampler: it refuses the rest
    for flags in (["--sampler", "ddim"], ["--warm-start-t", str(FEW_K)]):
        require(refused(lambda: eval_ondevice.main([
            "--checkpoint", str(ckpt), "--dataset", DATASET, "--megakernel",
            "--results-dir", "", *flags]), ValueError, "--megakernel"),
            f"eval_ondevice --megakernel {flags} raises")
        args = build_server_parser().parse_args(
            ["--checkpoint", str(ckpt), "--dataset", DATASET,
             "--policy-type", "dynamics-aware", "--megakernel", *flags])
        require(refused(lambda: build_policy_from_args(
            args, teacher, tdata, DATASET, T_STEPS), ValueError,
            "--megakernel"), f"a served --megakernel {flags} raises")
    counts = read_counts()
    log(f"few-call path launches: {counts}")
    require(not any(counts.values()),
            "the few-call path runs the module path: no port kernel")
    return {"distill": {"steps": FEW_STEPS, "batch": FEW_BATCH,
                        "wall_s": distill_s, "loss_first": series[0],
                        "loss_last": series[-1], "step_ms": step_ms},
            "plans_8_chains": plans8, "plans_1024_chains": plans1024,
            "eval_ondevice": runs, "card": card}


def _connect(port: int, deadline_s: float, failure: list):
    """A connection to the server on ``port`` once it listens."""
    deadline = time.time() + deadline_s
    while True:
        require(not failure, f"server failed: {failure and failure[0]!r}")
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=600)
        except OSError:
            require(time.time() < deadline, "server did not start")
            time.sleep(0.2)


def _ask(f, req):
    f.write((json.dumps(req) + "\n").encode())
    f.flush()
    return json.loads(f.readline())


def microbatch_phase(ckpt: Path, obs_rows, card: str) -> dict:
    """The micro-batched server through its entry point: ``serve.main``
    with ``--concurrency 4 --max-batch 8`` on the trained checkpoint, four
    TCP clients (sessions 0-3 in connection order) planning at once behind a
    barrier, the counters set to 0 before and read after. Then, on the
    batcher the server built: (a) a batch of one against the solo plan bit
    for bit, (b) a request at K_pad 2, 4 and 8 with other companions bit
    for bit, (c) every lane of a 64-chain wave and each client's served
    plan against its solo plan within TOL_CHAIN_BF16; no graph captured
    after construction; the bo8 wave (best of 8 included, staged draws)
    timed at 8, 16, 32 and 64 chains beside its bound and launches (those
    on the cluster tile apart), replayed against host-driven bit for bit, its
    chain against the plain chain at bf16 on the same draws (timed too),
    and at 16-64 chains every conv and fused pair of a step against its
    plain version with bf16 weights; and ``bench_serve`` at 4 clients."""
    import numpy as np
    from dadiff_tpu_torch import bench_serve, serve, serving
    from dadiff_tpu_torch.guides.sampling import conditions_for_initial_obs_np
    from dadiff_tpu_torch.ops.planner import _WaveRunner

    made = []
    original = serving.BatchedPlanner

    class Recording(original):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    n_clients = 4
    port = free_port()
    flags = ["--checkpoint", str(ckpt), "--env", ENV, "--dataset", DATASET,
             "--policy-type", "dynamics-aware", "--n-candidates",
             str(N_CAND), "--megakernel", "--concurrency", str(n_clients),
             "--max-batch", "8"]
    failure = []

    def run():
        try:
            # a 20 ms window: the four requests of the burst fold however
            # the host schedules the client threads
            serve.main(flags + ["--batch-window-ms", "20", "--port",
                                str(port), "--max-requests",
                                str(2 * n_clients)])
        except BaseException as e:  # reported by the main thread too
            failure.append(e)
            raise

    serving.BatchedPlanner = Recording
    reset_counts()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        conns = [_connect(port, 300, failure)]
        # the batcher is built (and every wave captured) before the server
        # listens; sessions are numbered in connection order
        captures = _WaveRunner.captures
        files = [conns[0].makefile("rwb")]
        require(_ask(files[0], {"ping": True}).get("ok"), "ping")
        for _ in range(1, n_clients):
            conns.append(socket.create_connection(("127.0.0.1", port),
                                                  timeout=600))
            files.append(conns[-1].makefile("rwb"))
            require(_ask(files[-1], {"ping": True}).get("ok"), "ping")
    finally:
        serving.BatchedPlanner = original
    barrier = threading.Barrier(n_clients, timeout=300)
    served = [None] * n_clients

    def client(i):
        barrier.wait()
        t0 = time.perf_counter()
        r = _ask(files[i], {"obs": obs_rows[i].tolist(), "plan": True})
        served[i] = (r, (time.perf_counter() - t0) * 1e3)

    workers = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n_clients)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    th.join(timeout=120)
    for c in conns:
        c.close()
    require(not th.is_alive() and not failure,
            f"the concurrent server did not stop cleanly: {failure}")
    counts = read_counts()
    require(len(made) == 1, "the server built one batcher")
    batcher = made[0]
    require(all(s is not None and "error" not in s[0] for s in served),
            f"a served plan failed: {served}")
    require(batcher.n_requests == n_clients and max(batcher.batch_sizes) > 1,
            f"the burst folded: batch sizes {batcher.batch_sizes}")
    require(_WaveRunner.captures == captures and batcher.cold_calls == 0,
            f"no capture and no cold wave in the live burst "
            f"({_WaveRunner.captures - captures} captures)")
    for name in ("rows_conv", "rows_conv_gn", "ddpm_project_step"):
        require(counts[name] > 0,
                f"{name} was not launched on the micro-batched path")
    require(counts["gn_mish"] == counts["gn_mish_backward"] == 0, "K1 launched on the micro-batched path")
    log(f"micro-batched serving: {n_clients} clients, batch sizes "
        f"{batcher.batch_sizes}, plan ms {[round(s[1], 3) for s in served]} "
        f"(host clock, request to response); launches {counts}")

    # (a)-(c) on the batcher the server built
    policy = batcher.policy
    H, D, obs_dim = policy.horizon, policy.transition_dim, \
        policy.observation_dim

    def request(seed, i):
        normed = policy.normalizer.normalize_observations(
            obs_rows[i % len(obs_rows)][None])
        cond = conditions_for_initial_obs_np(normed, obs_dim, H, D)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return serving._PlanRequest(gen, cond.values), cond

    def solo(seed, i):
        cond = request(seed, i)[1]
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return policy._plan(gen, cond, policy._P, policy._stats)

    solos = [solo(100 + i, i) for i in range(8)]
    one = batcher._call([request(100, 0)[0]])[0]
    require(torch.equal(one, solos[0]), "(a) a batch of one == solo plan")
    for k_pad in (2, 4, 8):
        a = batcher._call([request(100, 0)[0]] + [
            request(200 + j, j)[0] for j in range(1, k_pad)])[0]
        b = batcher._call([request(100, 0)[0]] + [
            request(300 + j, j + 1)[0] for j in range(1, k_pad)])[0]
        require(torch.equal(a, b), f"(b) other companions at K_pad {k_pad}")
    lane_err = {}
    for k_pad in (2, 4, 8):
        out = batcher._call([request(100 + i, i)[0] for i in range(k_pad)])
        lane_err[k_pad * N_CAND] = max(
            (o - w).abs().max().item() for o, w in zip(out, solos))
    served_err = max(float(np.abs(
        np.asarray(served[i][0]["plan"]) - solo(i, i)[0].cpu().numpy()
    ).max()) for i in range(n_clients))
    log(f"micro-batched serving: (a) batch of one == solo bit for bit; (b) "
        f"bit for bit at K_pad 2, 4, 8; (c) lanes vs solo max|err| by wave "
        f"chains {lane_err}, served plans vs solo {served_err:.3e} "
        f"(tolerance {TOL_CHAIN_BF16})")
    require(max(lane_err.values()) <= TOL_CHAIN_BF16
            and served_err <= TOL_CHAIN_BF16, "(c) lanes vs their solo plans")
    require(_WaveRunner.captures == captures,
            "the checks replayed the server's graphs")

    # the bo8 wave at 8-64 chains: staged draws, replay, best of 8; its
    # chain against the plain chain at bf16 on the same draws; at 16-64
    # chains (other tiles and K splits than the 8-chain wave) every conv
    # and fused pair of a denoise step against its plain version
    flat_w, m_embs, scal = prep = batcher._prepared()
    unet = policy.diffusion.model
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    waves = {}
    for k_pad in (1, 2, 4, 8):
        reqs = [request(400 + i, i)[0] for i in range(k_pad)]
        x0, noise = batcher._wave.stack_draws(
            [batcher._wave.draw(r.generator) for r in reqs], k_pad)
        values = torch.as_tensor(np.stack([r.values[0] for r in reqs]),
                                 device="cuda")

        def wave():
            return batcher._wave(None, (values,), prep, x0=x0,
                                 step_noise=noise)

        wave()
        reset_counts()
        wave()
        torch.cuda.synchronize()
        launches = sum(read_counts().values())
        cluster_launches = read_cluster_counts()
        chains = k_pad * N_CAND
        flops, nbytes, _ = wave_cost(unet, flat_w, m_embs, chains * HORIZON,
                                     D)
        b_ms, b_by = bound_ms(flops, nbytes, BF16_FLOPS)
        chain, (M, b) = batcher._wave.chain_of(k_pad)
        cond_rows = values.repeat_interleave(N_CAND, dim=0).reshape(-1, D)
        got = chain(flat_w, x0, m_embs, noise, scal, cond_rows, M, b)
        hosted = chain(flat_w, x0, m_embs, noise, scal, cond_rows, M, b,
                       graph=False)
        require(torch.equal(got, hosted),
                f"the {chains}-chain wave replayed equals the host-driven "
                "wave bit for bit")
        box = {}

        def plain():
            box["x"] = chain.plain(flat_w, x0, m_embs, noise, scal,
                                   cond_rows, M, b)

        plain_ms = cuda_ms(plain, 1, warmup=0)
        err = (got - box.pop("x")).abs().max().item()
        require(err <= TOL_CHAIN_BF16 and bool(torch.isfinite(got).all()),
                f"the {chains}-chain served wave vs the plain chain at bf16: "
                f"{err}")
        waves[chains] = {
            "ms": cuda_ms(wave, 5, warmup=1),
            "call_ms": cuda_ms(lambda: batcher._call(reqs), 5, warmup=1),
            "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "launches": launches, "cluster_launches": cluster_launches}
        log(f"micro-batched wave, {chains} chains: {waves[chains]['ms']:.3f} "
            f"ms replayed (CUDA events, draws staged, best of 8 included), "
            f"{waves[chains]['call_ms']:.3f} ms as a batched call (draws "
            f"included), the plain chain {plain_ms:.3f} ms; chain vs plain "
            f"at bf16 max|err| {err:.3e} (tolerance {TOL_CHAIN_BF16}); bound "
            f"{b_ms:.4f} ms ({b_by}, {flops / 1e9:.1f} GFLOP); {launches} "
            f"launches, of them on the cluster tile {cluster_launches}; "
            f"replayed == host-driven bit for bit; card {card}")
        if k_pad > 1:
            calls = step_launches(unet, chains * HORIZON, D)[0]
            waves[chains]["conv_max_abs_err"] = hold_rows_conv(
                [c[1:8] for c in calls], (torch.bfloat16,), g)
            gn_err, gn_worst = hold_rows_conv_gn(
                [c for c in calls if c[0] == "conv_gn"], (torch.bfloat16,), g)
            waves[chains].update(conv_gn_max_abs_err=gn_err,
                                 conv_gn_worst_err_over_tolerance=gn_worst)
    require(_WaveRunner.captures == captures, "the timed waves replayed")

    bench = bench_serve.main(flags + ["--clients", str(n_clients),
                                      "--requests-per-client", "8"])
    require(bench["concurrent_mode"] == "micro-batched"
            and bench["throughput_gain_vs_serialized_x"] is not None,
            f"bench_serve micro-batched: {bench}")
    log(f"bench_serve (4 clients): {json.dumps(bench)}; card {card}")
    return {"batch_sizes": batcher.batch_sizes, "launches": counts,
            "served_ms": [s[1] for s in served], "lane_max_abs_err": lane_err,
            "served_max_abs_err": served_err, "waves": waves,
            "bench_serve": bench, "card": card}


def value_phase(ckpt: Path, root: Path, card: str) -> dict:
    """Value guidance through its entry points: ``train_value_main`` for a
    few steps on the committed data at the flagship's schedule, then a
    value-guided bo1 plan and an MPC bo8 plan built by
    ``build_policy_from_args`` on the card, each against the same policy on
    the CPU on the same draws (TOL_CHAIN_F32), and ``--megakernel`` refusing
    value guidance. The module path runs: no port kernel."""
    from dadiff_tpu_torch.cli import (
        build_policy_from_args, load_model, train_value_main,
    )
    from dadiff_tpu_torch.serve import build_server_parser

    reset_counts()
    t0 = time.perf_counter()
    vpath = train_value_main([
        "--dataset", DATASET, "--horizon", str(HORIZON), "--n-timesteps",
        str(T_STEPS), "--batch-size", "64", "--max-steps", "40",
        "--reward", "goal-dense", "--seed", str(SEED), "--log-dir",
        str(root / "values")])
    train_s = time.perf_counter() - t0
    series = torch.load(vpath, weights_only=False)["loss_series"]
    require(all(v == v and abs(v) < 1e6 for v in series),
            f"value loss finite: {series}")
    models = {dev: load_model(str(ckpt), DATASET, device=dev)
              for dev in ("cuda", "cpu")}
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    obs = torch.randn(6, generator=g, device="cuda").cpu().numpy() * 0.5
    plans = {}
    for name, argv, n in (
            ("value_guided_bo1", ["--policy-type", "value-guided",
                                  "--value-checkpoint", vpath], 1),
            ("mpc_bo8", ["--policy-type", "mpc", "--n-candidates",
                         str(N_CAND)], N_CAND)):
        D = models["cuda"][0].transition_dim
        init = torch.randn(n, HORIZON, D, generator=g, device="cuda")
        step = torch.randn(T_STEPS, n, HORIZON, D, generator=g,
                           device="cuda")
        out = {}
        for dev, (diff, data) in models.items():
            args = build_server_parser().parse_args(
                ["--checkpoint", str(ckpt), "--env", ENV, "--dataset",
                 DATASET, "--device", dev, *argv])
            policy = build_policy_from_args(args, diff, data, DATASET,
                                            T_STEPS)
            plan = policy._plan
            policy._plan = lambda gen, c, P=None, st=None, _p=plan, _d=dev: \
                _p(gen, c, P, st, init_noise=init.to(_d),
                   step_noise=step.to(_d))
            t0 = time.perf_counter()
            out[dev] = policy.plan(obs)
            if dev == "cuda":
                plan_ms = (time.perf_counter() - t0) * 1e3
        err = float(abs(out["cuda"] - out["cpu"]).max())
        plans[name] = {"max_abs_err": err, "plan_ms": plan_ms}
        log(f"{name}: card vs CPU max|err| {err:.3e} (tolerance "
            f"{TOL_CHAIN_F32}); a plan {plan_ms:.1f} ms on the card (host "
            f"clock, module path); card {card}")
        require(err <= TOL_CHAIN_F32, f"{name} on the card vs the CPU: {err}")
    diff, data = models["cuda"]
    args = build_server_parser().parse_args(
        ["--checkpoint", str(ckpt), "--env", ENV, "--dataset", DATASET,
         "--policy-type", "value-guided", "--value-checkpoint", vpath,
         "--megakernel"])
    require(refused(lambda: build_policy_from_args(
        args, diff, data, DATASET, T_STEPS), ValueError,
        "gradient guidance"), "--megakernel refuses value guidance")
    counts = read_counts()
    require(not any(counts.values()),
            f"value guidance runs the module path: no port kernel {counts}")
    log(f"value phase: {len(series)} epoch(s) of value training in "
        f"{train_s:.1f} s, loss {series}")
    return {"train_s": train_s, "loss_series": series, "plans": plans}


# the locomotion slice: the Hopper planner of scripts/r5_phase3.sh:28-31 at
# full width (horizon 32, dim 128, mults 1 4 8, T = 100), a few steps here
LOCO_DATA = "npz:data/hopper_mppi.npz+npz:data/hopper_engine_r5.npz"
LOCO_MULTS, LOCO_STEPS, LOCO_BATCH = (1, 4, 8), 40, 32
# the on-device protocol of r5_phase3.sh:45-48 at a few replans
LOCO_ENVS, LOCO_REPLANS, LOCO_SEED = 30, 8, 42
# graph replays against the host-driven loop at two actions a replan
LOCO_CMP_AH = 2
# solver iterations: the CLI's --solver-iters for jacobi; PGS, sequential
# over rows (5 launches a row per sweep, 190k-540k launches an env step at
# 100), is held at the CPU tests' 30 to keep the phase short
LOCO_ITERS = {"jacobi": 100, "pgs": 30}
# the card's physics against the CPU's after one env step from the same
# states: float64 to 1e-9, float32 to 1e-4 in qpos and qvel
TOL_PHYS = {torch.float64: 1e-9, torch.float32: 1e-4}


def _physics_states(env):
    """(qpos, qvel, ctrl), float64, 8 rows: resets (seeds 0-3), two pushed
    1-3 cm into the ground, two with a limited hinge past its range and in
    the ground; and which rows have an active contact row and a limit row."""
    import numpy as np

    m, phys = env.model, env.phys
    rows = [env.reset_state(s) for s in range(8)]
    qpos = np.stack([r[0] for r in rows])
    qvel = np.stack([r[1] for r in rows]) + np.linspace(-1, 1, 8)[:, None]
    lim = [d for d in range(m.nv) if m.jnt_limited[d]]
    lo, hi = m.jnt_range[lim[0]][0], m.jnt_range[lim[-1]][1]
    qpos[6, lim[0]], qpos[7, lim[-1]] = lo - 0.05, hi + 0.05
    pts = phys.contact_points(torch.from_numpy(qpos))
    gap = (pts[..., 1] - torch.from_numpy(m.con_radius)
           - torch.from_numpy(m.con_margin)).amin(-1).numpy()
    qpos[4:8, 1] -= gap[4:8] + np.array([0.01, 0.03, 0.01, 0.02])
    ctrl = np.random.RandomState(SEED).uniform(-1, 1, (8, m.nu))
    active = phys._constraint_rows(torch.from_numpy(qpos),
                                   torch.from_numpy(qvel))[3]
    n_con = phys.pyramid_edges * len(m.con_body)
    return (qpos, qvel, ctrl, bool(active[:, :n_con].any()),
            bool(active[:, n_con:].any()))


class _DeviceAudit(TorchDispatchMode):
    """Counts the ops dispatched while active, and those that touch a CPU
    tensor of one element or more (a Python number PyTorch wraps is none)."""

    def __init__(self):
        super().__init__()
        self.ops, self.cpu_ops = 0, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves = _pytree.tree_leaves((args, kwargs, out))
        self.ops += 1
        if any(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               and t.dim() > 0 for t in leaves):
            self.cpu_ops[str(func)] = self.cpu_ops.get(str(func), 0) + 1
        return out


def locomotion_phase(root: Path, card: str) -> dict:
    """The locomotion path on the card: ``train_main`` at the Hopper
    planner's full width for LOCO_STEPS steps; one env step of each env,
    each solver and each dtype on the card against the CPU from the same
    states (ground contact and a joint past its limit among them); one
    jacobi env step of each env timed from the host and as a CUDA-graph
    replay (``bench_physics.time_env_step``);
    then ``eval_ondevice_locomotion.main`` on the card at the r5 protocol
    cut to LOCO_REPLANS replans (the chunk-bound guard must pass, the
    results file must be written, every op of the evaluator's loop must run
    on the card), held against the same evaluator without CUDA graphs on
    the same draws. The path plans through the module path
    (guides/sampling.py, as the JAX evaluator plans through XLA): the
    kernels' launch counters must read 0 around it."""
    import contextlib
    import io

    import numpy as np
    from dadiff_tpu_torch import eval_ondevice_locomotion as evl
    from dadiff_tpu_torch.bench_physics import time_env_step
    from dadiff_tpu_torch.cli import load_model, train_main
    from dadiff_tpu_torch.envs import locomotion_jax as loco
    from dadiff_tpu_torch.envs.planar_physics import _Consts
    from dadiff_tpu_torch.ops.projection import NormStats

    out = {"card": card}
    reset_counts()
    t0 = time.perf_counter()
    log_dir = Path(train_main([
        "--dataset", LOCO_DATA, "--horizon", str(HORIZON), "--dim", str(DIM),
        "--dim-mults", *map(str, LOCO_MULTS), "--n-timesteps", str(T_STEPS),
        "--batch-size", str(LOCO_BATCH), "--n-epochs", "1",
        "--max-steps", str(LOCO_STEPS), "--warmup-steps", "10",
        "--log-freq", str(LOCO_STEPS // 4), "--eval-freq", "0",
        "--save-freq", "0", "--seed", str(SEED), "--log-dir",
        str(root / "hopper")]))
    record = json.loads((log_dir / "metrics.jsonl").read_text()
                        .splitlines()[-1])
    series = record["total_series"]
    require(record["step"] == LOCO_STEPS and all(
        v == v and abs(v) < 1e6 for v in series),
        f"Hopper training: {record['step']} steps, loss {series}")
    ckpt = log_dir / f"checkpoint_step_{LOCO_STEPS}.pt"
    require(ckpt.is_file(), f"{ckpt} was exported")
    out["train"] = {"steps": LOCO_STEPS, "batch": LOCO_BATCH,
                    "s": time.perf_counter() - t0, "loss_series": series}
    out["checkpoint"] = str(ckpt)
    log(f"locomotion: trained the Hopper planner (dim {DIM}, mults "
        f"{LOCO_MULTS}) {LOCO_STEPS} steps in {out['train']['s']:.1f} s "
        f"(set-up included); loss {series}")

    # -- the card's physics against the CPU's, one env step
    parity, timing = {}, {}
    t0 = time.perf_counter()
    for cls in (loco.HalfCheetahJax, loco.HopperJax, loco.Walker2dJax):
        for solver in ("pgs", "jacobi"):
            env = cls(solver_iters=LOCO_ITERS[solver], solver=solver)
            qpos, qvel, ctrl, contact, limit = _physics_states(env)
            require(contact and limit, f"{env.ENV_NAME}: the states hold a "
                    f"contact ({contact}) and a limit ({limit})")
            for dtype, tol in TOL_PHYS.items():
                args = [torch.as_tensor(a, dtype=dtype)
                        for a in (qpos, qvel, ctrl)]
                cpu = env.step_batch(*args)
                card_out = env.step_batch(*(a.cuda() for a in args))
                require(all(t.device.type == "cuda" for t in card_out),
                        "the physics ran on the card")
                err = max(float((c.cpu() - h).abs().max())
                          for c, h in zip(card_out[:2], cpu[:2]))
                same_done = bool((card_out[4].cpu() == cpu[4]).all())
                key = f"{env.ENV_NAME}/{solver}/{str(dtype)[6:]}"
                parity[key] = err
                require(err <= tol and same_done,
                        f"physics {key}: card vs CPU {err} > {tol} or done "
                        f"differs ({same_done})")
            key = f"{env.ENV_NAME}/{solver}"
            msg = (f"physics {key} ({LOCO_ITERS[solver]} iterations, "
                   f"{env.phys.n_rows} rows): card vs CPU max|err| f64 "
                   f"{parity[key + '/float64']:.2e} f32 "
                   f"{parity[key + '/float32']:.2e}")
            if solver == "jacobi":
                # one env step of 30 envs from resets, float32: host-driven
                # and as a replay of its CUDA graph (PGS: bench_physics)
                row = time_env_step(env)
                timing[key] = row
                msg += (f"; an env step of {row['envs']} envs (f32, "
                        f"{row['ops_per_env_step']} ops) "
                        f"{row['host_driven_ms']:.3f} ms host-driven, "
                        f"{row['graph_ms']:.3f} ms as a graph replay (CUDA "
                        f"events; card {card})")
            log(msg)
    out["physics_max_abs_err"] = parity
    out["env_step_ms"] = timing
    out["physics_s"] = time.perf_counter() - t0

    # -- the evaluator's CLI on the card
    results_dir = root / "results_locomotion"
    argv = ["--checkpoint", str(ckpt), "--dataset", LOCO_DATA, "--env",
            "Hopper-v5", "--backend", "physics", "--solver", "jacobi",
            "--batch", str(LOCO_ENVS), "--n-replans", str(LOCO_REPLANS),
            "--action-horizon", "1", "--skip-conditioned-action", "--seed",
            str(LOCO_SEED), "--results-dir", str(results_dir)]
    audits = []   # one per evaluator call: the untimed run, the timed run
    call = loco.LocomotionEvaluator.__call__

    def audited(self, *a, **kw):
        audits.append(_DeviceAudit())
        with audits[-1]:
            return call(self, *a, **kw)

    # the CLI as a user runs it: TF32 convs on (the library's default)
    loco.LocomotionEvaluator.__call__ = audited
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    printed = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            result = evl.main(argv)
        run_s = time.perf_counter() - t0
    finally:
        loco.LocomotionEvaluator.__call__ = call
    counts = read_counts()
    log(printed.getvalue().rstrip())
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    require("chunk bound OK" in printed.getvalue(),
            "the K* guard passed at --action-horizon 1")
    require(Path(result["results_path"]).is_file(), "results file written")
    require(np.isfinite(result["mean_return"])
            and result["mean_alive_length"] > 0, f"returns {result}")
    # the first call uploads the physics model's constants once (a host
    # tensor made and copied per field); nothing else touches the CPU
    upload = {"aten.lift_fresh.default": len(_Consts._fields),
              "aten._to_copy.default": len(_Consts._fields)}
    require(len(audits) == 2 and audits[0].cpu_ops == upload
            and not audits[1].cpu_ops and audits[1].ops > 0,
            f"the evaluator's loop ran on the card: ops "
            f"{[a.ops for a in audits]}, on the CPU "
            f"{[a.cpu_ops for a in audits]}")
    require(result["timing"]["graph"], "the replans replayed CUDA graphs")
    require(not any(counts.values()), f"the locomotion path runs the module "
            f"path: no port kernel {counts}")

    # the evaluator at LOCO_CMP_AH actions a replan (the env step's graph
    # replayed once per action), called twice with CUDA graphs (the second
    # call replays from its first replan) and once without, on the same draws
    diff, data = load_model(str(ckpt), LOCO_DATA, device="cuda")
    stats = NormStats.from_normalizer(data.normalizer, "cuda")
    env = loco.HopperJax(solver_iters=LOCO_ITERS["jacobi"], solver="jacobi")
    init = torch.as_tensor(env.reset_obs(range(LOCO_SEED,
                                               LOCO_SEED + LOCO_ENVS)),
                           dtype=torch.float32, device="cuda")
    runs = {}
    try:
        for graph in (True, False):
            ev = loco.make_physics_locomotion_evaluator(
                diff, env, action_horizon=LOCO_CMP_AH, n_replans=LOCO_REPLANS,
                skip_conditioned_action=True, graph=graph)
            for call in range(2 if graph else 1):
                g = torch.Generator(device="cuda").manual_seed(LOCO_SEED + 1)
                runs[graph, call] = (ev(g, stats, init)[2], ev.timing,
                                     ev.replayed)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    eager = runs[False, 0]
    graph_err = max(float((runs[True, c][0] - eager[0]).abs().max())
                    for c in (0, 1))
    eager_replan = float(np.mean([p + s for p, s in eager[1][1:]]))
    eager_plan = float(np.mean([p for p, _ in eager[1][1:]]))
    require(graph_err <= 1e-3, f"graph replans vs host-driven: {graph_err}")
    require(runs[True, 0][2] == [False] + [True] * (LOCO_REPLANS - 1)
            and all(runs[True, 1][2]) and not any(eager[2]),
            f"replayed replans: {[runs[k][2] for k in runs]}")
    out["evaluator"] = {
        "argv": argv, "mean_return": result["mean_return"],
        "return_se": result["return_se"],
        "mean_alive_length": result["mean_alive_length"],
        "timing": result["timing"], "run_s": run_s, "peak_memory_mib": peak,
        "audited_ops": [a.ops for a in audits], "launches": counts,
        "graph_vs_eager_max_abs_err": graph_err,
        "compared_at_action_horizon": LOCO_CMP_AH,
        "eager_ms_per_replan": eager_replan, "eager_ms_per_plan": eager_plan,
        "results_path": result["results_path"]}
    tm = result["timing"]
    log(f"locomotion evaluator (Hopper, {LOCO_ENVS} envs, {LOCO_REPLANS} "
        f"replans, jacobi): mean return {result['mean_return']} (se "
        f"{result['return_se']}, 40-step planner), ms per replan "
        f"{tm['ms_per_replan']:.3f} as graph replays (host-driven at "
        f"{LOCO_CMP_AH} actions {eager_replan:.3f}), plan "
        f"{tm['ms_per_plan']:.3f} (host-driven {eager_plan:.3f}), env step "
        f"{tm['ms_per_env_step']:.3f}, {tm['episodes_per_hour']:.1f} "
        f"episodes/hour ({result['env_steps_per_episode']}-step episodes), "
        f"peak memory {peak:.1f} MiB; graph vs host-driven returns at "
        f"{LOCO_CMP_AH} actions a replan, two graph calls, "
        f"{graph_err:.2e}; {sum(a.ops for a in audits)} ops audited, none "
        f"on the CPU but the model's upload; TF32 convs; "
        f"launches {counts}; card {card}")
    return out


# the learned slice: the simulator at the CLI's widths (an ensemble of 4
# members of (256, 256), batch 1,024) on the HalfCheetah data, a few hundred
# steps here (the CLI's default is 3,000)
LEARNED_DATA = "npz:data/halfcheetah_mppi.npz"
LEARNED_FIT_STEPS, LEARNED_STATES = 300, 128
# the evaluator's CLI at its own 128 envs and 8 actions, a few replans on a
# simulator fit for a few hundred steps
LEARNED_ENVS, LEARNED_REPLANS, LEARNED_MODEL_STEPS = 128, 3, 200
# the MPPI planner at the r5 recipe's shape (scripts/r5_phase3.sh:14-18):
# horizon 12, 1,024 candidates for each of 16 envs, 4 members of (512, 512)
MPPI_H, MPPI_N, MPPI_ENVS, MPPI_HIDDEN, MPPI_MEMBERS = 12, 1024, 16, \
    (512, 512), 4
MPPI_EXEC, MPPI_REPLANS = 4, 20
# the card's simulator step against the CPU's: f32 products (TF32 off) in
# another order, |card - cpu| <= TOL * (1 + |cpu|); the MPPI plan likewise,
# its softmax over 1,024 returns dividing their rounding by lam = 0.3
TOL_SIM, TOL_MPPI = 1e-5, 1e-4


def _rel_err(card, cpu) -> float:
    return float(((card.cpu() - cpu).abs() / (1 + cpu.abs())).max())


def learned_phase(ckpt: Path, root: Path, card: str) -> dict:
    """The learned simulator on the card: ``train_dynamics_ensemble`` at the
    CLI's widths (ms per training step, held-out R^2); one ensemble-mean
    and one trajectory-sampling step of LEARNED_STATES states on the card
    against the CPU; ``eval_ondevice_locomotion.main`` with no
    ``--backend`` (the learned default) on ``locomotion_phase``'s Hopper
    checkpoint at the CLI's 128 envs and 8 actions, a few replans (the
    results file must carry the JAX script's learned keys, every op of the
    loop must run on the card, no port kernel may launch), and its graph
    replays against the same evaluator driven from the host on the same
    draws, bit for bit; then ``make_mppi_planner`` at the r5 shape,
    replayed from its CUDA graph, timed, and held against the CPU on the
    same noise."""
    import contextlib
    import copy
    import io

    import numpy as np
    from dadiff_tpu_torch import eval_ondevice_locomotion as evl
    from dadiff_tpu_torch.cli import load_model
    from dadiff_tpu_torch.datasets.sources import load_episodes
    from dadiff_tpu_torch.envs import learned_model as lm
    from dadiff_tpu_torch.envs import locomotion_jax as loco
    from dadiff_tpu_torch.envs.mppi_tpu import make_mppi_planner
    from dadiff_tpu_torch.ops.projection import NormStats

    out = {"card": card}
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    episodes = load_episodes(LEARNED_DATA)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, stats, metrics = lm.train_dynamics_ensemble(
        episodes, n_models=4, hidden=(256, 256), batch_size=1024,
        n_steps=LEARNED_FIT_STEPS, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    require(np.isfinite(metrics["r2_mean"]), f"simulator R^2 {metrics}")
    out["fit"] = {"steps": LEARNED_FIT_STEPS, "members": 4,
                  "hidden": [256, 256], "batch": 1024, "s": fit_s,
                  "ms_per_step": fit_s * 1e3 / LEARNED_FIT_STEPS,
                  "r2_mean": metrics["r2_mean"], "r2_min": metrics["r2_min"],
                  "member_r2": metrics["member_r2"]}
    log(f"learned: train_dynamics_ensemble (4 x (256, 256), batch 1,024) "
        f"{LEARNED_FIT_STEPS} steps in {fit_s:.3f} s, "
        f"{out['fit']['ms_per_step']:.3f} ms a step (host clock, set-up and "
        f"R^2 included); held-out one-step R^2 mean {metrics['r2_mean']:.4f} "
        f"min {metrics['r2_min']:.4f}; card {card}")

    # -- one mean step and one TS step on the card against the CPU
    cpu_model = copy.deepcopy(model).cpu()
    cpu_stats = stats.to("cpu")
    rng = np.random.RandomState(SEED)
    o = np.concatenate([ep["observations"][:-1] for ep in episodes[:2]])
    pick = rng.choice(len(o), LEARNED_STATES, replace=False)
    obs = torch.as_tensor(o[pick], dtype=torch.float32)
    act = torch.as_tensor(rng.uniform(-1, 1, (LEARNED_STATES, 6)),
                          dtype=torch.float32)
    errs = {}
    with torch.no_grad():
        for name, card_fn, cpu_fn, shape in (
                ("mean", lm.make_mean_step_fn(model, stats),
                 lm.make_mean_step_fn(cpu_model, cpu_stats), None),
                ("ts", lm.make_ensemble_step_fn(model, stats, LEARNED_STATES),
                 lm.make_ensemble_step_fn(cpu_model, cpu_stats,
                                          LEARNED_STATES), (-1, 1))):
            o_, a_ = ((obs, act) if shape is None else
                      (obs.reshape(LEARNED_STATES, 1, -1),
                       act.reshape(LEARNED_STATES, 1, -1)))
            got = card_fn(o_.cuda(), a_.cuda())
            require(got.device.type == "cuda", "the simulator ran on the card")
            errs[name] = _rel_err(got, cpu_fn(o_, a_))
            require(errs[name] <= TOL_SIM, f"simulator {name} step: card vs "
                    f"CPU {errs[name]} > {TOL_SIM}")
    out["step_err"] = errs
    log(f"learned: ensemble-mean and trajectory-sampling steps of "
        f"{LEARNED_STATES} states, card vs CPU max |err|/(1+|cpu|) "
        f"{errs['mean']:.2e} / {errs['ts']:.2e} (tolerance {TOL_SIM})")

    # -- the evaluator's CLI with no --backend: the learned default
    results_dir = root / "results_learned"
    argv = ["--checkpoint", ckpt, "--dataset", LOCO_DATA, "--env",
            "Hopper-v5", "--batch", str(LEARNED_ENVS), "--n-replans",
            str(LEARNED_REPLANS), "--model-steps", str(LEARNED_MODEL_STEPS),
            "--seed", str(LOCO_SEED), "--results-dir", str(results_dir)]
    audits = []
    call = loco.LocomotionEvaluator.__call__

    def audited(self, *a, **kw):
        audits.append(_DeviceAudit())
        with audits[-1]:
            return call(self, *a, **kw)

    loco.LocomotionEvaluator.__call__ = audited
    # the CLI as a user runs it: TF32 convs on (the library's default)
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    printed = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            result = evl.main(argv)
        run_s = time.perf_counter() - t0
    finally:
        loco.LocomotionEvaluator.__call__ = call
    counts = read_counts()
    log(printed.getvalue().rstrip())
    require(result["backend"] == "learned", "no --backend runs the learned "
            "simulator")
    saved = json.loads(Path(result["results_path"]).read_text())
    learned_keys = {"model_based_mean_return", "model_based_return_std",
                    "simulator_r2_mean", "note"}
    require(learned_keys <= set(saved) and "mean_return" not in saved
            and saved["policy_type"] == "ondevice-learned"
            and saved["solver"] is None and saved["solver_iters"] is None,
            f"the results file carries the JAX learned keys: {sorted(saved)}")
    require(np.isfinite(result["model_based_mean_return"]),
            f"returns {result}")
    require(len(audits) == 2 and all(a.ops > 0 and not a.cpu_ops
                                     for a in audits),
            f"the evaluator's loop ran on the card: ops "
            f"{[a.ops for a in audits]}, on the CPU "
            f"{[a.cpu_ops for a in audits]}")
    require(result["timing"]["graph"], "the replans replayed CUDA graphs")
    require(not any(counts.values()), f"the learned path runs the module "
            f"path: no port kernel {counts}")

    # the evaluator replayed from its graphs (two calls) and driven from the
    # host, on the same simulator and draws
    diff, data = load_model(ckpt, LOCO_DATA, device="cuda")
    nstats = NormStats.from_normalizer(data.normalizer, "cuda")
    hop, hstats, _ = lm.train_dynamics_ensemble(
        load_episodes(LOCO_DATA), n_models=4, n_steps=LEARNED_MODEL_STEPS,
        seed=LOCO_SEED, device="cuda")
    init = torch.as_tensor(loco.HopperJax().reset_obs(
        range(LOCO_SEED, LOCO_SEED + LEARNED_ENVS)), dtype=torch.float32,
        device="cuda")
    runs = {}
    try:
        for graph in (True, False):
            ev = lm.make_ondevice_locomotion_evaluator(
                diff, hop, hstats, lm.hopper_reward_done,
                n_replans=LEARNED_REPLANS, graph=graph)
            for c in range(2 if graph else 1):
                g = torch.Generator(device="cuda").manual_seed(LOCO_SEED + 1)
                runs[graph, c] = ev(g, nstats, init)[2], ev.replayed
    finally:
        torch.backends.cudnn.allow_tf32 = False
    eager = runs[False, 0][0]
    same = all(torch.equal(runs[True, c][0], eager) for c in (0, 1))
    require(same, f"learned evaluator: graph replays vs host-driven, max "
            f"|diff| {max(float((runs[True, c][0] - eager).abs().max()) for c in (0, 1))}")
    require(runs[True, 0][1] == [False] + [True] * (LEARNED_REPLANS - 1)
            and all(runs[True, 1][1]) and not any(runs[False, 0][1]),
            f"replayed replans: {[runs[k][1] for k in runs]}")
    tm = result["timing"]
    # this run's episodes are cut to LEARNED_REPLANS replans; the CLI's
    # default episode (25 replans of 8 actions, 200 steps) at the same
    # measured ms per replan is the figure comparable with other runs
    parser = evl.build_parser()
    cli_replans = parser.get_default("n_replans")
    cli_steps = cli_replans * parser.get_default("action_horizon")
    cli_eph = LEARNED_ENVS * 3.6e6 / (cli_replans * tm["ms_per_replan"])
    out["evaluator"] = {
        "argv": argv, "result": {k: v for k, v in result.items()
                                 if k != "timing"},
        "timing": tm, "run_s": run_s,
        "episodes_per_hour_cli_episode": cli_eph,
        "audited_ops": [a.ops for a in audits], "launches": counts,
        "graph_equals_host_driven": same}
    log(f"learned evaluator (Hopper, {LEARNED_ENVS} envs, {LEARNED_REPLANS} "
        f"replans of 8 actions, 4 members): model-based return "
        f"{result['model_based_mean_return']} (R^2 "
        f"{result['simulator_r2_mean']}), ms per replan "
        f"{tm['ms_per_replan']:.3f} (plan {tm['ms_per_plan']:.3f}, 8 model "
        f"steps {tm['ms_per_env_step'] * 8:.3f}; CUDA events, graph "
        f"replays), simulator fit {tm['ms_per_sim_train_step']:.3f} ms a "
        f"step, {tm['episodes_per_hour']:.1f} episodes/hour "
        f"({result['env_steps_per_episode']}-step episodes; "
        f"{cli_eph:.1f} at the CLI's {cli_steps}-step episode), peak memory "
        f"{tm['peak_memory_mib']:.1f} MiB; graph replays == host-driven bit "
        f"for bit (two graph calls); {sum(a.ops for a in audits)} ops "
        f"audited, none on the CPU; launches {counts}; card {card}")

    # -- the MPPI planner at the r5 shape, one CUDA graph per replan
    ens = lm.DynamicsMLP(17, 6, MPPI_HIDDEN, n_models=MPPI_MEMBERS,
                         seed=SEED).cuda().eval()
    step = lm.make_ensemble_step_fn(ens, stats, MPPI_N)
    kw = dict(act_dim=6, horizon=MPPI_H, n_samples=MPPI_N, n_exec=MPPI_EXEC)
    plan = make_mppi_planner(step, lm.halfcheetah_reward_done, **kw)
    mobs = obs[:MPPI_ENVS].cuda()
    mean = torch.zeros(MPPI_ENVS, MPPI_H, 6, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    noise = plan.draw(g, MPPI_ENVS)
    reset_counts()
    first = plan(None, mobs, mean, noise=noise)        # host-driven, captured
    replay = plan(None, mobs, mean, noise=noise)
    require(plan.replayed and all(torch.equal(a, b) for a, b in
                                  zip(first, replay)),
            "MPPI: the replayed replan equals the host-driven one")
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for _ in range(MPPI_REPLANS):
        acts, mean = plan(g, mobs, mean)
    ev1.record()
    ev1.synchronize()
    mppi_ms = ev0.elapsed_time(ev1) / MPPI_REPLANS
    mppi_counts = read_counts()
    require(not any(mppi_counts.values()), f"MPPI launches {mppi_counts}")
    cpu_plan = make_mppi_planner(
        lm.make_ensemble_step_fn(copy.deepcopy(ens).cpu(), cpu_stats, MPPI_N),
        lm.halfcheetah_reward_done, device="cpu", **kw)
    want = cpu_plan(None, mobs.cpu(), torch.zeros(MPPI_ENVS, MPPI_H, 6),
                    noise=noise.cpu())
    mppi_err = max(_rel_err(a, b) for a, b in zip(first, want))
    require(mppi_err <= TOL_MPPI, f"MPPI: card vs CPU {mppi_err} > {TOL_MPPI}")
    require(acts.shape == (MPPI_ENVS, MPPI_EXEC, 6)
            and bool(torch.isfinite(acts).all()), "MPPI actions")
    # the simulator's share: the horizon's 12 TS steps alone, replayed; the
    # bound: the members' products at the f32 peak against every weight,
    # state and action read once and every state written once
    lanes = MPPI_N * MPPI_ENVS
    o_in = mobs[None].expand(MPPI_N, -1, -1).contiguous()
    a_in = noise.clamp(-1, 1)

    def steps():
        o = o_in
        with torch.no_grad():
            for t in range(MPPI_H):
                o = step(o, a_in[:, :, t])
        return o

    sim_ms = graph_ms(steps, 5)
    widths = [17 + 6, *MPPI_HIDDEN, 17]
    flops = 2.0 * lanes * MPPI_H * sum(i * o for i, o in
                                      zip(widths[:-1], widths[1:]))
    nbytes = 4 * (sum(p.numel() for p in ens.parameters())
                  + lanes * MPPI_H * (6 + 2 * 17))
    mppi_bound, mppi_by = bound_ms(flops, nbytes, F32_FLOPS)
    out["mppi"] = {"horizon": MPPI_H, "n_samples": MPPI_N,
                   "envs": MPPI_ENVS, "lanes": MPPI_N * MPPI_ENVS,
                   "members": MPPI_MEMBERS, "hidden": list(MPPI_HIDDEN),
                   "ms_per_replan": mppi_ms, "replans": MPPI_REPLANS,
                   "sim_steps_ms": sim_ms, "bound_ms": mppi_bound,
                   "bound_by": mppi_by, "flops": flops,
                   "card_vs_cpu": mppi_err, "launches": mppi_counts}
    log(f"MPPI planner (r5 shape: horizon {MPPI_H}, {MPPI_N} candidates x "
        f"{MPPI_ENVS} envs = {MPPI_N * MPPI_ENVS} lanes, {MPPI_MEMBERS} "
        f"members of {MPPI_HIDDEN}, TS step): {mppi_ms:.3f} ms a replan "
        f"(CUDA events over {MPPI_REPLANS} graph replays, noise draw "
        f"included), of which the {MPPI_H} simulator steps alone "
        f"{sim_ms:.3f} ms (a graph replay); bound {mppi_bound:.3f} ms "
        f"({mppi_by}: {flops:.3g} FLOP at the f32 peak); card vs CPU on the "
        f"same noise {mppi_err:.2e} "
        f"(tolerance {TOL_MPPI}); replay == host-driven bit for bit; "
        f"launches {mppi_counts}; card {card}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"learned phase: {out['phase_s']:.1f} s")
    return out


# the second model family: the JAX recipe's width
# (scripts/r3_session_chain.sh:22-27) on the UMaze data, whose transitions
# are 8 wide: 7,893,512 parameters (7,892,486 at 6 wide)
TT_DIM, TT_DEPTH, TT_HEADS, TT_BATCH, TT_STEPS = 256, 6, 8, 256, 100
TT_PARAMS = 7_893_512
TT_REPLANS = 3       # the protocol's 20 replans cut to 3
TOL_TT_FWD = 1e-5    # f32 products summed in another order, of (1 + |x|)
TOL_PICARD = 1e-4    # tests/test_parallel_sampling.py:42
PD_TARGET, PD_STEPS, PD_BATCH = 25, 5, 64


def transformer_cost(model, chains: int, horizon: int):
    """(FLOPs, bytes) of one TemporalTransformer forward on ``chains``
    chains of ``horizon`` rows: per token and block 12 dim^2 products
    (q, k, v, out: 4 dim^2; the MLP 2 mlp_ratio dim^2) and 2 horizon dim
    for the attention; in_proj and out_proj per token; the time MLP and the
    adaLN projections per chain. Bytes: the weights, x, t and the output
    once each."""
    dim, tdim, D = model.dim, model.time_dim, model.transition_dim
    tokens = chains * horizon
    per_token = model.depth * (4 * dim * dim + 2 * model.mlp_ratio * dim * dim
                               + 2 * horizon * dim) + 2 * D * dim
    per_chain = (dim * 4 * tdim + 4 * tdim * tdim
                 + model.depth * tdim * 6 * dim + tdim * 2 * dim)
    flops = 2.0 * (tokens * per_token + chains * per_chain)
    nbytes = 4 * sum(p.numel() for p in model.parameters()) \
        + 4 * (2 * tokens * D + chains)
    return flops, nbytes


def transformer_phase(unet_ckpt: Path, root: Path, results_dir: Path,
                      card: str) -> dict:
    """The second model family, Picard and progressive distillation on the
    card, through their entry points, each path with the counters set to 0
    before and read after (K1-K4 must read 0: the JAX package runs these
    through XLA, and the planner chain takes a U-Net only):
    ``train_main --model-type transformer`` at the recipe's width for
    TT_STEPS steps of batch TT_BATCH (the loss must fall; the step timed
    with CUDA events; the parameter count from the code); its forward on
    the card against the CPU at 8 and 1,024 chains, timed, beside its
    bound; ``serve.main`` on the ``.pt`` (dynamics-aware best of 8, the
    module path) over TCP, a best-of-8 plan held against the CPU on the same
    draws, and ``--megakernel`` refused; ``eval_ondevice`` at the published
    protocol's 128 envs x best of 8, cut to TT_REPLANS replans, cold and
    with ``--warm-start-t 40``; ``parallel_sample_loop`` at tol 0 against
    ``p_sample_loop`` on the same draws, and ``bench_picard``; ``distill
    --method progressive --target-steps PD_TARGET`` from the U-Net
    checkpoint (two rounds of PD_STEPS steps) and a DDIM-25 best-of-8 plan
    of its student against the CPU."""
    import numpy as np
    from dadiff_tpu_torch import bench_picard, eval_ondevice, serve
    from dadiff_tpu_torch.cli import (
        build_policy_from_args, distill_main, load_model, train_main,
    )
    from dadiff_tpu_torch.datasets.sequence import create_dataloader
    from dadiff_tpu_torch.datasets.sources import load_episodes
    from dadiff_tpu_torch.envs import rollout
    from dadiff_tpu_torch.guides.sampling import (
        conditions_for_initial_obs, make_sampler,
    )
    from dadiff_tpu_torch.losses import build_loss, make_generators
    from dadiff_tpu_torch.models.parallel_sampling import parallel_sample_loop
    from dadiff_tpu_torch.models.temporal_transformer import (
        TemporalTransformer,
    )
    from dadiff_tpu_torch.serve import build_server_parser
    from dadiff_tpu_torch.utils import training as tt

    out = {"card": card}
    t_phase = time.perf_counter()

    # -- train at the recipe's width
    reset_counts()
    t0 = time.perf_counter()
    log_dir = Path(train_main([
        "--dataset", DATASET, "--model-type", "transformer", "--dim",
        str(TT_DIM), "--depth", str(TT_DEPTH), "--n-heads", str(TT_HEADS),
        "--horizon", str(HORIZON), "--n-timesteps", str(T_STEPS),
        "--batch-size", str(TT_BATCH), "--lr", "2e-4", "--n-epochs", "3",
        "--max-steps", str(TT_STEPS), "--warmup-steps", "10", "--log-freq",
        str(LOG_FREQ), "--eval-freq", "0", "--save-freq", "0", "--seed",
        str(SEED), "--log-dir", str(root / "transformer")]))
    train_s = time.perf_counter() - t0
    record = json.loads((log_dir / "metrics.jsonl").read_text()
                        .splitlines()[-1])
    series = [v for line in (log_dir / "metrics.jsonl").read_text()
              .splitlines() for v in json.loads(line)["total_series"]]
    require(record["step"] == TT_STEPS and all(v == v and abs(v) < 1e6
                                               for v in series),
            f"transformer trained {record['step']} steps, finite: {series}")
    first, last = sum(series[:3]) / 3, sum(series[-3:]) / 3
    require(last < first, f"transformer loss fell ({first} -> {last})")
    ckpt = log_dir / f"checkpoint_step_{TT_STEPS}.pt"
    diff, dataset = load_model(str(ckpt), DATASET, device="cuda")
    require(isinstance(diff.model, TemporalTransformer)
            and diff.model.depth == TT_DEPTH, "load_model rebuilt it")
    n_params = sum(p.numel() for p in diff.model.parameters())
    require(n_params == TT_PARAMS, f"{n_params} parameters, not {TT_PARAMS}")
    # the step alone: loss, grad, clip, Adam, EMA at batch TT_BATCH
    tdiff, _ = load_model(str(ckpt), DATASET, device="cuda")
    tdiff.train()
    loss_fn, names = build_loss(tdiff)
    state = tt.TrainState(tdiff, tt.make_optimizer(tdiff.parameters()),
                          tt.EMA(tdiff).shadow)
    step = tt.make_train_step(
        loss_fn, lr_schedule=tt.warmup_cosine_schedule(2e-4, 10, 10000),
        gradient_clip=4.0)
    gens = make_generators(len(names), SEED, "cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(iter(
        create_dataloader(dataset, TT_BATCH, seed=SEED))).items()}
    step_ms = cuda_ms(lambda: step(state, batch, gens), 20, warmup=3)
    step_flops = 3 * transformer_cost(diff.model, TT_BATCH, HORIZON)[0]
    del state, step, tdiff
    out["train"] = {"steps": TT_STEPS, "batch": TT_BATCH, "wall_s": train_s,
                    "loss_first": first, "loss_last": last,
                    "step_ms": step_ms, "parameters": n_params,
                    "step_bound_ms": step_flops / F32_FLOPS * 1e3}
    log(f"transformer train: {TT_STEPS} steps of batch {TT_BATCH} in "
        f"{train_s:.1f} s (set-up included); loss {first:.4f} -> "
        f"{last:.4f}; a step {step_ms:.3f} ms (CUDA events, 20 steps; "
        f"~3x the forward's FLOPs at the f32 peak: "
        f"{out['train']['step_bound_ms']:.3f} ms); {n_params:,} parameters; "
        f"card {card}")

    # -- the forward on the card against the CPU, timed, with its bound
    cpu_diff, _ = load_model(str(ckpt), DATASET, device="cpu")
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    H, D = diff.horizon, diff.transition_dim
    out["forward"] = {}
    for chains in (N_CAND, EVAL_CHAINS):
        x = torch.randn(chains, H, D, device="cuda", generator=g)
        t = torch.randint(0, T_STEPS, (chains,), device="cuda", generator=g)
        with torch.no_grad():
            got = diff(x, t)
            want = cpu_diff(x.cpu(), t.cpu())
            ms = cuda_ms(lambda: diff(x, t), 10, warmup=2)
        err = _rel_err(got, want)
        flops, nbytes = transformer_cost(diff.model, chains, H)
        bound, by = bound_ms(flops, nbytes, F32_FLOPS)
        require(err <= TOL_TT_FWD and bool(torch.isfinite(got).all()),
                f"transformer forward at {chains} chains vs CPU: {err}")
        out["forward"][chains] = {"ms": ms, "max_rel_err": err,
                                  "gflop": flops / 1e9, "bound_ms": bound,
                                  "bound_by": by}
        log(f"transformer forward at {chains} x {H} rows: {ms:.3f} ms (CUDA "
            f"events, f32, TF32 off), bound {bound:.3f} ms ({by}; "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); card vs CPU "
            f"{err:.2e} of (1 + |x|) (tolerance {TOL_TT_FWD}); card {card}")
    launches = {"train": read_counts()}

    # -- serving through the module path, and a bo8 plan against the CPU
    reset_counts()
    port = free_port()
    flags = ["--checkpoint", str(ckpt), "--env", ENV, "--dataset", DATASET,
             "--policy-type", "dynamics-aware", "--n-candidates",
             str(N_CAND)]
    failure = []

    def run():
        try:
            serve.main(flags + ["--port", str(port), "--max-requests",
                                str(N_PLANS + 3)])
        except BaseException as e:  # reported by the main thread too
            failure.append(e)
            raise

    th = threading.Thread(target=run, daemon=True)
    th.start()
    eps_rows = [np.asarray(ep["observations"][0], np.float32) for ep in
                load_episodes(DATASET)[:N_PLANS]]
    plan_ms = []
    with _connect(port, 300, failure) as conn, conn.makefile("rwb") as f:
        require(_ask(f, {"ping": True}).get("ok"), "transformer ping")
        for o in eps_rows:
            r = _ask(f, {"obs": o.tolist(), "plan": True})
            require("error" not in r and np.asarray(r["plan"]).shape
                    == (H, D) and np.isfinite(r["plan"]).all(),
                    f"transformer plan request: {r.get('error')}")
            plan_ms.append(r["plan_ms"])
        require(len(_ask(f, {"obs": eps_rows[0].tolist()})["action"]) == 2,
                "transformer action")
        require(_ask(f, {"reset": True}) == {"ok": True}, "reset")
    th.join(timeout=120)
    require(not th.is_alive() and not failure,
            f"transformer server did not stop {failure}")
    args = build_server_parser().parse_args(flags)
    policy = build_policy_from_args(args, diff, dataset, DATASET, T_STEPS)
    spec, P, stats = (policy._sampler_config["projection"], policy._P,
                      policy._stats)
    P_cpu, stats_cpu = P.cpu(), type(stats)(*(v.cpu() for v in stats))
    obs = (torch.randn(1, diff.observation_dim, device="cuda", generator=g)
           * 0.5).repeat(N_CAND, 1)
    cond = conditions_for_initial_obs(obs, diff.observation_dim, H, D)
    cond_cpu = type(cond)(cond.values.cpu(), cond.mask.cpu())
    draws = {"init_noise": torch.randn(N_CAND, H, D, device="cuda",
                                       generator=g),
             "step_noise": torch.randn(T_STEPS, N_CAND, H, D, device="cuda",
                                       generator=g)}
    got = make_sampler(diff, projection=spec)(None, cond, P, stats, **draws)
    want = make_sampler(cpu_diff, projection=spec)(
        None, cond_cpu, P_cpu, stats_cpu,
        **{k: v.cpu() for k, v in draws.items()})
    plan_err = (got.cpu() - want).abs().max().item()
    require(plan_err <= TOL_CHAIN_F32 and bool(torch.isfinite(got).all()),
            f"transformer bo8 plan on the card vs the CPU: {plan_err}")
    args_mk = build_server_parser().parse_args(flags + ["--megakernel"])
    require(refused(lambda: build_policy_from_args(
        args_mk, diff, dataset, DATASET, T_STEPS), ValueError, "module path"),
        "--megakernel refuses the transformer")
    launches["serving"] = read_counts()
    out["serving"] = {"plan_ms": plan_ms, "bo8_plan_max_abs_err": plan_err}
    log(f"transformer serving (module path, bo8): plan_ms {plan_ms}; a bo8 "
        f"plan on the card vs the CPU {plan_err:.2e} (tolerance "
        f"{TOL_CHAIN_F32}); --megakernel refused; card {card}")

    # -- the on-device protocol, cut to TT_REPLANS replans; cold and warm
    reset_counts()
    out["eval_ondevice"] = {}
    for name, extra in (("bo8", []), ("warm40", ["--warm-start-t", "40"])):
        spans, audits = [], []
        original = _timed_samplers(rollout, spans)
        make_eval = rollout.make_ondevice_evaluator

        def audited_evaluator(*a, **kw):
            evaluate = make_eval(*a, **kw)

            def run_audited(*ea, **ekw):
                if audits:  # the timed run: no dispatch hook in its time
                    return evaluate(*ea, **ekw)
                audits.append(_DeviceAudit())
                with audits[-1]:
                    return evaluate(*ea, **ekw)

            run_audited.model_calls = evaluate.model_calls
            return run_audited

        rollout.make_ondevice_evaluator = audited_evaluator
        try:
            res = eval_ondevice.main([
                "--checkpoint", str(ckpt), "--dataset", DATASET,
                "--projection", "--n-candidates", str(N_CAND), "--batch",
                str(EVAL_ENVS), "--n-replans", str(TT_REPLANS),
                "--action-horizon", str(EVAL_ACTIONS), "--seed",
                str(EVAL_SEED), "--results-dir", str(results_dir), *extra])
        finally:
            rollout.make_sampler = original
            rollout.make_ondevice_evaluator = make_eval
        torch.cuda.synchronize()
        require(Path(res["results_path"]).is_file(),
                f"transformer eval {name}: results file written")
        require(len(spans) == 2 * TT_REPLANS and len(audits) == 1,
                f"transformer eval {name}: {len(spans)} planner calls")
        timed = [a.elapsed_time(b) for a, b in spans[TT_REPLANS:]]
        calls = res["model_calls_per_replan"]
        per_call = [ms / c for ms, c in zip(
            timed, [calls[0]] + [calls[1]] * (TT_REPLANS - 1))]
        audit = audits[0]  # the untimed run, set-up included
        cpu_share = sum(audit.cpu_ops.values()) / max(audit.ops, 1)
        require(audit.ops > 0 and cpu_share < 0.01,
                f"transformer eval {name}: the loop on the card "
                f"({audit.ops} ops, on the CPU {audit.cpu_ops})")
        out["eval_ondevice"][name] = {
            "success_rate": res["success_rate"],
            "wallclock_s": res["wallclock_s"],
            "replan_ms": timed, "model_call_ms": per_call,
            "model_calls_per_replan": calls,
            "planner_share": sum(timed) / 1e3 / res["wallclock_s"],
            "audited_ops": audit.ops, "cpu_ops": audit.cpu_ops}
        log(f"transformer eval_ondevice {name}: {EVAL_ENVS} envs x bo8 "
            f"({EVAL_CHAINS} chains a replan), {TT_REPLANS} replans (cut "
            f"from {EVAL_REPLANS}); model calls {calls}; replan ms "
            f"{[round(v, 3) for v in timed]} (CUDA events), per model call "
            f"{[round(v, 3) for v in per_call]} ms; timed run "
            f"{res['wallclock_s']:.3f} s; success {res['success_rate']} "
            f"(not gated); {audit.ops} ops of the untimed run audited, "
            f"{sum(audit.cpu_ops.values())} on the CPU; card {card}")
    require(out["eval_ondevice"]["warm40"]["model_calls_per_replan"]
            == [T_STEPS, 40], "warm start: 100 calls, then 40")
    require(refused(lambda: eval_ondevice.main([
        "--checkpoint", str(ckpt), "--dataset", DATASET, "--megakernel",
        "--results-dir", ""]), ValueError, "module path"),
        "eval_ondevice --megakernel refuses the transformer")
    launches["evaluation"] = read_counts()

    # -- Picard: exact at tol 0 (window T), then the bench
    reset_counts()
    shape = (2, H, D)
    init = torch.randn(shape, device="cuda", generator=g)
    noise = torch.randn((T_STEPS,) + shape, device="cuda", generator=g)
    seq = diff.p_sample_loop(shape, init_noise=init, step_noise=noise)
    par, sweeps = parallel_sample_loop(
        diff, diff.schedule, shape, window=T_STEPS, tol=0.0,
        init_noise=init, step_noise=noise, return_sweeps=True,
        device="cuda")
    pic_err = (par - seq).abs().max().item()
    require(pic_err <= TOL_PICARD and sweeps == 2 * T_STEPS,
            f"Picard at tol 0 vs the sequential chain: {pic_err}, {sweeps}")
    pic25, sweeps25 = parallel_sample_loop(
        diff, diff.schedule, shape, window=25, tol=1e-2, init_noise=init,
        step_noise=noise, return_sweeps=True, device="cuda")
    bench = bench_picard.main(["--out", str(root / "picard_crossover.json")])
    launches["picard"] = read_counts()
    out["picard"] = {"tol0_max_abs_err": pic_err, "tol0_sweeps": sweeps,
                     "transformer_tol1e-2_sweeps": sweeps25,
                     "transformer_tol1e-2_max_abs_diff":
                         (pic25 - seq).abs().max().item(),
                     "bench": bench["rows"]}
    log(f"Picard: the transformer at tol 0 (window {T_STEPS}, {sweeps} "
        f"sweeps) vs p_sample_loop {pic_err:.2e} (tolerance {TOL_PICARD}); "
        f"at tol 1e-2, window 25: {sweeps25} sweeps, "
        f"{out['picard']['transformer_tol1e-2_max_abs_diff']:.2e} from the "
        f"chain; bench_picard {json.dumps([{k: r[k] for k in ('dim', 'sequential_chain_ms', 'picard_chain_ms', 'sweeps', 'picard_speedup')} for r in bench['rows']])}; "
        f"card {card}")

    # -- progressive distillation from the U-Net, and its DDIM-25 student
    reset_counts()
    t0 = time.perf_counter()
    pd_dir = Path(distill_main([
        "--checkpoint", str(unet_ckpt), "--dataset", DATASET, "--method",
        "progressive", "--target-steps", str(PD_TARGET), "--n-epochs", "1",
        "--max-steps", str(PD_STEPS), "--batch-size", str(PD_BATCH),
        "--warmup-steps", "0", "--log-freq", "1", "--save-freq", "0",
        "--seed", str(SEED), "--log-dir", str(root / "progressive")]))
    pd_s = time.perf_counter() - t0
    rounds = sorted(p.name for p in pd_dir.iterdir() if p.is_dir())
    require(rounds == ["round_0_steps50", "round_1_steps25"],
            f"progressive rounds {rounds}")
    student_pt = pd_dir / "round_1_steps25" / f"checkpoint_step_{PD_STEPS}.pt"
    require(student_pt.is_file(), f"{student_pt} written")
    student, sdata = load_model(str(student_pt), DATASET, device="cuda")
    require(sdata.checkpoint_config.get("progressive_steps") == PD_TARGET,
            "the student's checkpoint records progressive_steps")
    cpu_student, _ = load_model(str(student_pt), DATASET, device="cpu")
    plan = make_sampler(student, projection=spec, sampler="ddim",
                        sampling_timesteps=PD_TARGET)
    d25 = {"init_noise": draws["init_noise"],
           "step_noise": draws["step_noise"][:len(plan.timesteps)]}
    got = plan(None, cond, P, stats, **d25)
    want = make_sampler(cpu_student, projection=spec, sampler="ddim",
                        sampling_timesteps=PD_TARGET)(
        None, cond_cpu, P_cpu, stats_cpu, **{k: v.cpu() for k, v in
                                             d25.items()})
    pd_err = (got.cpu() - want).abs().max().item()
    require(len(plan.timesteps) == PD_TARGET and pd_err <= TOL_CHAIN_F32
            and bool(torch.isfinite(got).all()),
            f"the DDIM-{PD_TARGET} student plan vs the CPU: {pd_err}")
    pd_ms = cuda_ms(lambda: plan(None, cond, P, stats, **d25), 3, warmup=1)
    launches["progressive"] = read_counts()
    out["progressive"] = {"rounds": rounds, "steps_per_round": PD_STEPS,
                          "batch": PD_BATCH, "wall_s": pd_s,
                          "ddim25_bo8_ms": pd_ms,
                          "ddim25_bo8_max_abs_err": pd_err}
    log(f"progressive: rounds {rounds} ({PD_STEPS} steps of batch "
        f"{PD_BATCH} each) in {pd_s:.1f} s; the student's DDIM-{PD_TARGET} "
        f"bo8 plan {pd_ms:.3f} ms (CUDA events), card vs CPU {pd_err:.2e} "
        f"(tolerance {TOL_CHAIN_F32}); card {card}")

    for path, counts in launches.items():
        require(not any(counts.values()),
                f"a port kernel launched on the transformer's {path} path: "
                f"{counts}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"transformer_phase: K1-K4 launches {launches}; "
        f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The parallelism layer at world 1 (and a two-rank DDP step over gloo)
# ---------------------------------------------------------------------------

PAR_BATCH, PAR_STEPS, PAR_LR = 256, 3, 3e-4
PAR_TIMED, PAR_REPEATS = 10, 3  # step ms: repeats of 10 steps, interleaved
PAR_ENVS, PAR_REPLANS = 128, 2
# a DDP or FSDP run against the same steps without a mesh: the loss to 1e-5
# relative (f32 sums, cuDNN's backward may add in another order). A leaf
# whose true gradient is 0 (a conv bias before a one-channel GroupNorm
# group; picked by its gradient, below 1e-6 of the largest entry) takes Adam
# steps of up to the learning rate on rounding noise, so it is held to the
# summed learning rates; every other leaf's change over the steps is held
# to the run without a mesh's change, relative in the L2 norm (a run that
# leaves the weights as they were reads 1)
TOL_PAR_LOSS = 1e-5
TOL_PAR_NOISE = PAR_LR * 1.01  # a step
TOL_PAR_DELTA = 1e-4
# the sharded forward at world 1 against the plain one: its GroupNorm sums
# in another order, its convs pad by hand (another cuDNN algorithm may run)
TOL_TP_FWD = 1e-4


def _par_trainer(ckpt: Path, log_dir: Path, mesh=None, fsdp_axis=None):
    """The flagship, loaded from the trained ``.pt``, in a Trainer."""
    from dadiff_tpu_torch.cli import load_model
    from dadiff_tpu_torch.losses import build_loss
    from dadiff_tpu_torch.utils.training import Trainer

    diff, dataset = load_model(str(ckpt), DATASET, device="cuda")
    diff.train()
    loss_fn, names = build_loss(diff)
    trainer = Trainer(diff, [None], loss_fn, lr=PAR_LR, warmup_steps=0,
                      total_steps=10000, log_dir=str(log_dir), save_freq=0,
                      loss_names=names, seed=SEED, export_pt=False,
                      mesh=mesh, fsdp_axis=fsdp_axis)
    return trainer, dataset


def _par_run(trainer, batches, mesh):
    """PAR_STEPS steps on this rank's rows: the losses, the weights after
    the first step and after the last."""
    from dadiff_tpu_torch.parallel.mesh import full_state_dict, local_rows

    losses, first = [], None
    for b in batches:
        losses.append(trainer.train_step(local_rows(b, mesh))["total"])
        state = {k: v.detach().clone() for k, v in full_state_dict(
            trainer.diffusion.state_dict()).items()}
        first = first or state
    return losses, first, state


def _noise_leaves(ckpt: Path, batch: dict) -> set:
    """State keys of the parameters whose gradient on ``batch`` is below
    1e-6 of the largest entry of any (their true gradient is 0)."""
    from dadiff_tpu_torch.cli import load_model
    from dadiff_tpu_torch.losses import build_loss

    diff, _ = load_model(str(ckpt), DATASET, device="cuda")
    diff.train()
    loss_fn, names = build_loss(diff)
    gens = [torch.Generator("cuda").manual_seed(SEED + i)
            for i in range(len(names))]
    loss_fn(batch, gens)[0].backward()
    g = {n: float(p.grad.abs().max()) for n, p in diff.named_parameters()}
    level = 1e-6 * max(g.values())
    return {n for n, v in g.items() if v <= level}


def _weights_against(got: dict, ref: dict, start: dict, noise: set,
                     steps: int) -> dict:
    """A run's weights against the reference run's, both from ``start``:
    the noise leaves' largest difference (held to the summed learning
    rates), and for every other leaf the difference of the two runs'
    changes, relative to the reference's change in the L2 norm, and its
    largest entry."""
    num = den = 0.0
    noise_max = other_max = 0.0
    for k in ref:
        if not ref[k].is_floating_point():
            continue
        d = (got[k].float() - ref[k].float()).abs()
        if k in noise:
            noise_max = max(noise_max, float(d.max()))
            continue
        other_max = max(other_max, float(d.max()))
        num += float(d.double().square().sum())
        den += float((ref[k].double() - start[k].double()).square().sum())
    out = {"noise_max_abs": noise_max, "max_abs": other_max,
           "delta_rel": (num / den) ** 0.5}
    require(noise_max <= steps * TOL_PAR_NOISE
            and out["delta_rel"] <= TOL_PAR_DELTA,
            f"weights against the run without a mesh: {out}")
    return out


def _tp_fsdp_step(ckpt: Path, batch: dict, axes: dict):
    """One train step of the flagship as the Trainer takes it (its loss and
    draws, clip 1, Adam at PAR_LR), the weights placed by
    ``shard_params_tp(fsdp_axis='fsdp')`` on a mesh of ``axes`` and the
    forward through the sharded path: (loss, whole weights after the step,
    the share of the weights this rank stores). The mesh lies on the card
    whatever the backend (``make_mesh`` puts a gloo group's on the CPU).
    The whole weights are gathered as the sharded forward gathers them
    (``Sharded.param``): DTensor's ``full_tensor`` takes a functional
    all-gather that crashes over gloo on CUDA tensors (torch 2.11)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from dadiff_tpu_torch.cli import load_model
    from dadiff_tpu_torch.losses import build_loss, make_generators
    from dadiff_tpu_torch.parallel.mesh import batch_rows, local_rows
    from dadiff_tpu_torch.parallel.tp import (
        Sharded, average_grads, shard_params_tp,
    )
    from dadiff_tpu_torch.utils import training as tt

    mesh = init_device_mesh("cuda", tuple(axes.values()),
                            mesh_dim_names=tuple(axes))
    diff, _ = load_model(str(ckpt), DATASET, device="cuda")
    diff.train()
    diff.model.act_spec = ("dp", None, "tp")
    shard_params_tp(diff.model, mesh, fsdp_axis="fsdp")
    loss_fn, names = build_loss(diff)
    state = tt.TrainState(module=diff, ema_params=None,
                          optimizer=tt.make_optimizer(diff.parameters(),
                                                      PAR_LR))
    step = tt.make_train_step(
        loss_fn, lr_schedule=tt.warmup_cosine_schedule(PAR_LR, 0, 10000),
        use_ema=False, after_backward=lambda: average_grads(diff, mesh))
    gens = make_generators(len(names) + 1, SEED, diff.device)[:len(names)]
    with batch_rows(mesh):
        loss = float(step(state, local_rows(batch, mesh), gens)["total"])
    stored = (sum(p.to_local().numel() for p in diff.parameters())
              / sum(p.numel() for p in diff.parameters()))
    view = Sharded(diff.model)
    whole = {k: v for k, v in diff.state_dict().items()
             if not isinstance(v, DTensor)}
    with torch.no_grad():
        whole.update({f"model.{n}": view.param(p, rows=False)
                      for n, p in diff.model.named_parameters()})
    return loss, whole, stored


def _gloo_rank(rank: int, rendezvous: str, ckpt: str, batch_file: str,
               out_file: str) -> None:
    """One of two processes on the one card, joined over gloo: a DDP step
    of the flagship on its rows of the batch, then a step with its weights
    split over ``{'fsdp': 2}`` through the tp/fsdp path, with the launch
    counters set to 0 before and read after."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from dadiff_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=rendezvous, rank=rank,
                            world_size=2)
    try:
        reset_counts()
        mesh = make_mesh({"dp": 2})
        trainer, _ = _par_trainer(Path(ckpt), Path(out_file).parent
                                  / f"gloo{rank}", mesh)
        batch = {k: v.cuda() for k, v in torch.load(batch_file).items()}
        losses, state, _ = _par_run(trainer, [batch], mesh)
        trainer.close()
        fsdp_loss, fsdp_state, stored = _tp_fsdp_step(Path(ckpt), batch,
                                                      {"fsdp": 2})
        if rank == 0:
            torch.save({"loss": losses[0],
                        "state": {k: v.cpu() for k, v in state.items()},
                        "fsdp_loss": fsdp_loss, "fsdp_stored": stored,
                        "fsdp_state": {k: v.cpu()
                                       for k, v in fsdp_state.items()},
                        "launches": read_counts()}, out_file)
    finally:
        dist.destroy_process_group()


def parallel_phase(ckpt: Path, root: Path, card: str) -> dict:
    """The parallelism layer (dadiff_tpu_torch/parallel/) on the card at
    world 1, each path against the same work without a mesh, with the
    counters set to 0 before and read after (K1-K4 must read 0: the JAX
    package runs its mesh paths through XLA, and its evaluator refuses the
    planner kernel under a mesh): a world-1 NCCL process group and the
    ('dp',) mesh; PAR_STEPS DDP steps through ``Trainer(mesh=)`` and
    PAR_STEPS FSDP2 steps (``fsdp_axis='dp'``) of the flagship at batch
    PAR_BATCH against the Trainer without a mesh (the loss, and the change
    in the weights), and the ms of a step of each, PAR_REPEATS times in
    turn; ``make_batched_planner`` at 1,024 chains against ``make_sampler``;
    ``make_ondevice_evaluator(mesh=)`` at PAR_ENVS envs x best of 8 for
    PAR_REPLANS replans against the unsharded evaluator, and its refusal of
    the planner chain; the tp and sp forwards of the flagship U-Net and of
    the transformer at the recipe's width on a ('dp', 'sp', 'tp') mesh of
    one rank against their plain forwards. Then two processes on the one
    card join over gloo and take a DDP step, against the first step of the
    run without a mesh."""
    import copy

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from dadiff_tpu_torch.datasets.sequence import create_dataloader
    from dadiff_tpu_torch.envs.pointmaze_jax import PointMazeJax
    from dadiff_tpu_torch.envs.rollout import make_ondevice_evaluator
    from dadiff_tpu_torch.guides.sampling import (
        conditions_for_initial_obs,
        make_sampler,
    )
    from dadiff_tpu_torch.models.temporal_transformer import (
        TemporalTransformer,
    )
    from dadiff_tpu_torch.ops.projection import NormStats
    from dadiff_tpu_torch.parallel.distributed import initialize_distributed
    from dadiff_tpu_torch.parallel.mesh import make_mesh
    from dadiff_tpu_torch.parallel.planner import make_batched_planner
    from dadiff_tpu_torch.parallel.tp import shard_params_tp

    out = {"card": card}
    root.mkdir(parents=True, exist_ok=True)
    rendezvous = root / "nccl_rendezvous"
    rendezvous.unlink(missing_ok=True)
    t0 = time.perf_counter()
    reset_counts()
    require(initialize_distributed(f"file://{rendezvous}", rank=0,
                                   world_size=1, device="cuda")
            and dist.get_backend() == "nccl", "a world-1 NCCL group")
    try:
        mesh = make_mesh({"dp": 1})

        # -- training: DDP and FSDP2 against no mesh
        trainers, runs = {}, {}
        for name, m, fsdp in (("none", None, None), ("ddp", mesh, None),
                              ("fsdp", mesh, "dp")):
            trainers[name], dataset = _par_trainer(
                ckpt, root / f"train_{name}", m, fsdp)
            if name == "none":
                it = iter(create_dataloader(dataset, PAR_BATCH, seed=SEED))
                batches = [{k: torch.as_tensor(v, device="cuda")
                            for k, v in next(it).items()}
                           for _ in range(PAR_STEPS)]
                noise = _noise_leaves(ckpt, batches[0])
                start = {k: v.detach().clone() for k, v in
                         trainers[name].diffusion.state_dict().items()}
            runs[name] = _par_run(trainers[name], batches, m)
        out["noise_leaves"] = sorted(noise)
        for name in ("ddp", "fsdp"):
            loss_err = max(abs(a - b) / abs(b) for a, b in
                           zip(runs[name][0], runs["none"][0]))
            require(loss_err <= TOL_PAR_LOSS,
                    f"{name} steps against no mesh: loss {loss_err:.2e}")
            out[f"{name}_loss_rel_err"] = loss_err
            out[f"{name}_weights"] = _weights_against(
                runs[name][2], runs["none"][2], start, noise, PAR_STEPS)
        times = {name: [] for name in trainers}
        for _ in range(PAR_REPEATS):
            for name, trainer in trainers.items():
                times[name].append(cuda_ms(lambda: trainer._step(batches[0]),
                                           PAR_TIMED))
        for trainer in trainers.values():
            trainer.close()
        first_batch = {k: v.cpu() for k, v in batches[0].items()}
        out["step_ms"] = times

        # -- an FSDP2 run saved halfway, resumed in a fresh Trainer
        half = PAR_STEPS // 2
        part, _ = _par_trainer(ckpt, root / "train_resume", mesh, "dp")
        losses = _par_run(part, batches[:half], mesh)[0]
        base = part.save_checkpoint(epoch=0)
        part.close()
        resumed, _ = _par_trainer(ckpt, root / "train_resume", mesh, "dp")
        resumed.load_checkpoint(base)
        rest, _, state = _par_run(resumed, batches[half:], mesh)
        resumed.close()
        losses += rest
        ref_losses, ref_state = runs["fsdp"][0], runs["fsdp"][2]
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, ref_losses))
        require(loss_err <= TOL_PAR_LOSS,
                f"FSDP resumed against the run that did not stop: loss "
                f"{loss_err:.2e}")
        out["fsdp_resume"] = {
            "saved_after": half, "losses": losses, "loss_rel_err": loss_err,
            "bit_for_bit": losses == ref_losses and all(
                torch.equal(state[k], ref_state[k]) for k in ref_state),
            "weights": _weights_against(state, ref_state, start, noise,
                                        PAR_STEPS)}
        log(f"parallel: FSDP2 run saved after {half} of {PAR_STEPS} steps "
            f"and resumed in a fresh Trainer: losses {losses} vs "
            f"{ref_losses} ({loss_err:.1e}); {out['fsdp_resume']}")
        log(f"parallel: train step at batch {PAR_BATCH}, {PAR_REPEATS} x "
            f"{PAR_TIMED} steps each: no mesh {times['none']} ms, DDP (world "
            f"1, NCCL) {times['ddp']} ms, FSDP2 {times['fsdp']} ms ({card}); "
            f"losses {runs['none'][0]} / {runs['ddp'][0]} / "
            f"{runs['fsdp'][0]}; weights DDP {out['ddp_weights']}, FSDP2 "
            f"{out['fsdp_weights']} ({len(noise)} noise leaves)")

        # -- the batched planner at 1,024 chains
        from dadiff_tpu_torch.cli import load_model

        diff, dataset = load_model(str(ckpt), DATASET, device="cuda")
        g = torch.Generator("cuda").manual_seed(SEED)
        obs = 0.5 * torch.randn(EVAL_CHAINS, diff.observation_dim,
                                generator=g, device="cuda")
        cond = conditions_for_initial_obs(obs, diff.observation_dim, HORIZON,
                                          diff.transition_dim)
        planner = make_batched_planner(diff, mesh)
        sampler = make_sampler(diff)
        plans = {}
        for name, fn in (("mesh", planner), ("none", sampler)):
            t1 = time.perf_counter()
            plans[name] = fn(torch.Generator("cuda").manual_seed(1), cond)
            torch.cuda.synchronize()
            out[f"planner_{name}_s"] = time.perf_counter() - t1
        err = float((plans["mesh"] - plans["none"]).abs().max())
        require(plans["mesh"].shape == (EVAL_CHAINS, HORIZON,
                                        diff.transition_dim) and err <= 1e-5,
                f"batched planner against make_sampler ({err})")
        out["planner_max_abs_err"] = err

        # -- the on-device evaluator under the mesh
        stats = NormStats.from_normalizer(dataset.normalizer, device="cuda")
        require(refused(lambda: make_ondevice_evaluator(
            diff, PointMazeJax(), use_megakernel=True, mesh=mesh),
            ValueError, "single-chip"), "the planner chain refuses a mesh")
        evals = {}
        for name, m in (("mesh", mesh), ("none", None)):
            ev = make_ondevice_evaluator(
                diff, PointMazeJax(), action_horizon=EVAL_ACTIONS,
                n_replans=PAR_REPLANS, n_candidates=N_CAND, mesh=m)
            t1 = time.perf_counter()
            evals[name] = ev(torch.Generator("cuda").manual_seed(EVAL_SEED),
                             stats, PAR_ENVS)
            torch.cuda.synchronize()
            out[f"eval_{name}_s"] = time.perf_counter() - t1
        pos_err = float((evals["mesh"][1].pos - evals["none"][1].pos)
                        .abs().max())
        require(pos_err <= TOL_ENV_POS and torch.equal(
            evals["mesh"][0].per_env_success,
            evals["none"][0].per_env_success),
            f"meshed evaluator against unsharded ({pos_err})")
        out["eval_pos_max_abs_err"] = pos_err
        out["eval_success_rate"] = float(evals["mesh"][0].success_rate)

        # -- tp and sp forwards at world 1, both families
        mesh3 = make_mesh({"dp": 1, "sp": 1, "tp": 1})
        mesh_2d = make_mesh({"dp": 1, "fsdp": 1, "tp": 1})
        x = torch.randn(PAR_BATCH, HORIZON, diff.transition_dim, generator=g,
                        device="cuda")
        t = torch.randint(0, T_STEPS, (PAR_BATCH,), generator=g,
                          device="cuda")
        torch.manual_seed(SEED)
        tt_model = TemporalTransformer(diff.transition_dim, dim=TT_DIM,
                                       depth=TT_DEPTH,
                                       n_heads=TT_HEADS).cuda()
        for name, model in (("unet", diff.model), ("transformer", tt_model)):
            with torch.no_grad():
                ref = model(x, t)
            for layout, m, spec, fsdp in (
                    ("tp_sp", mesh3, ("dp", "sp", "tp"), None),
                    ("tp_fsdp", mesh_2d, ("dp", None, "tp"), "fsdp")):
                sharded = copy.deepcopy(model)
                sharded.act_spec = spec
                shard_params_tp(sharded, m, fsdp_axis=fsdp)
                with torch.no_grad():
                    got = sharded(x, t)
                err = float((got - ref).abs().max())
                require(err <= TOL_TP_FWD, f"{name} {layout} forward ({err})")
                out[f"{name}_{layout}_max_abs_err"] = err
        out["launches"] = read_counts()
        require(not any(out["launches"].values()),
                f"a port kernel launched on the parallel paths: "
                f"{out['launches']}")
    finally:
        dist.destroy_process_group()

    # -- two ranks on the one card over gloo: a DDP step
    batch_file, result = root / "gloo_batch.pt", root / "gloo_result.pt"
    torch.save(first_batch, batch_file)
    gloo_rdv = root / "gloo_rendezvous"
    gloo_rdv.unlink(missing_ok=True)
    t1 = time.perf_counter()
    ctx = mp.start_processes(
        _gloo_rank, args=(f"file://{gloo_rdv}", str(ckpt), str(batch_file),
                          str(result)), nprocs=2, join=False,
        start_method="spawn")
    try:
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            require(time.monotonic() < deadline, "gloo ranks timed out")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    got = torch.load(result, weights_only=False)
    require(not any(got["launches"].values()),
            f"a port kernel launched on the gloo ranks: {got['launches']}")
    ref_loss = runs["none"][0][0]
    ref_state = {k: v.cpu() for k, v in runs["none"][1].items()}
    cpu = {k: v.cpu() for k, v in start.items()}
    for kind, loss_key, state_key in (("ddp", "loss", "state"),
                                      ("fsdp", "fsdp_loss", "fsdp_state")):
        loss_err = abs(got[loss_key] - ref_loss) / abs(ref_loss)
        require(loss_err <= TOL_PAR_LOSS,
                f"two gloo ranks ({kind}) against one process: loss "
                f"{loss_err:.2e}")
        out[f"gloo_{kind}"] = {
            "loss": got[loss_key], "loss_rel_err": loss_err,
            "weights": _weights_against(got[state_key], ref_state, cpu,
                                        noise, 1)}
    require(got["fsdp_stored"] < 0.6,
            f"a {{'fsdp': 2}} rank stores {got['fsdp_stored']:.3f} of the "
            "weights")
    out.update(gloo_fsdp_stored=got["fsdp_stored"],
               gloo_launches=got["launches"],
               gloo_s=time.perf_counter() - t1,
               total_s=time.perf_counter() - t0)
    log(f"parallel: two gloo ranks on one card against one process "
        f"(loss {ref_loss:.6f}): DDP {out['gloo_ddp']}; weights split over "
        f"{{'fsdp': 2}} through the tp/fsdp path {out['gloo_fsdp']}, each "
        f"rank storing {got['fsdp_stored']:.3f} of them; launches "
        f"{got['launches']} ({out['gloo_s']:.1f} s)")
    return out



# ---------------------------------------------------------------------------
# bf16 training, experiment configs, the profiler, the physics bound, the
# installation check
# ---------------------------------------------------------------------------

DT_STEPS, DT_REPEATS, DT_BATCH = 10, 3, 256
# tests/test_torch_dtype.py: a bf16 forward within 3e-2 of the largest
# |output| of the other side's bf16 forward (rounding points in other order)
TOL_FWD_BF16 = 3e-2
# the committed artifact's settings (results/physics_bound_Hopper_v5_float32
# .json); PGS at 100 iterations dispatches ~925,000 ops a Hopper env step,
# seconds each host-driven, so the K list is cut to its first rows
PB_K = (1, 2)
PB_ARTIFACT = "results/physics_bound_Hopper_v5_float32.json"


def _dtype_runs(ckpt: Path, root: Path) -> dict:
    """``train_main`` for DT_STEPS steps at batch DT_BATCH, per family and
    dtype, DT_REPEATS repeats in turns (f32, bf16, f32, ...): the run's
    step ms (its wall time over its steps, data included: the Trainer's
    steps_per_sec) and its first logged loss."""
    from dadiff_tpu_torch.cli import train_main

    base = {
        "unet": ["--checkpoint", str(ckpt), "--reset-optimizer"],
        "transformer": ["--model-type", "transformer", "--dim", str(TT_DIM),
                        "--depth", str(TT_DEPTH), "--n-heads", str(TT_HEADS),
                        "--n-timesteps", str(T_STEPS)],
    }
    runs = {fam: {"float32": [], "bfloat16": []} for fam in base}
    for rep in range(DT_REPEATS):
        for fam, args in base.items():
            for dtype in ("float32", "bfloat16"):
                log_dir = Path(train_main(args + [
                    "--dataset", DATASET, "--horizon", str(HORIZON),
                    "--batch-size", str(DT_BATCH), "--n-epochs", "1",
                    "--max-steps", str(DT_STEPS), "--warmup-steps", "10",
                    "--log-freq", "1", "--eval-freq", "0", "--save-freq",
                    "0", "--no-export-pt", "--seed", str(SEED), "--dtype",
                    dtype, "--log-dir",
                    str(root / f"{fam}_{dtype}_{rep}")]))
                rec = json.loads((log_dir / "metrics.jsonl").read_text()
                                 .splitlines()[-1])
                series = rec["total_series"]
                require(rec["step"] == DT_STEPS and len(series) == DT_STEPS
                        and all(v == v and abs(v) < 1e6 for v in series),
                        f"{fam} {dtype}: {DT_STEPS} finite losses {series}")
                runs[fam][dtype].append({
                    "step_ms": 1e3 / rec["steps_per_sec"],
                    "first_loss": series[0], "last_loss": series[-1]})
    return runs


def _train_steps(ckpt: Path) -> dict:
    """One train step (loss, grad, clip, Adam, EMA) at batch DT_BATCH on
    one batch already on the card, per family and dtype, keyed
    "<family>_<dtype>": the U-Net with the smoke checkpoint's weights, the
    transformer recipe with its seed's initialisation."""
    from dadiff_tpu_torch.cli import load_model
    from dadiff_tpu_torch.datasets.sequence import create_dataloader
    from dadiff_tpu_torch.losses import build_loss, make_generators
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_transformer import (
        TemporalTransformer,
    )
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
    from dadiff_tpu_torch.utils import training as tt

    base, dataset = load_model(str(ckpt), DATASET, device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(iter(
        create_dataloader(dataset, DT_BATCH, seed=SEED))).items()}
    steps = {}
    for fam in ("unet", "transformer"):
        for dtype in (torch.float32, torch.bfloat16):
            if fam == "unet":
                model = TemporalUnet(8, dim=DIM, dim_mults=MULTS, dtype=dtype)
                model.load_state_dict(base.model.state_dict())
            else:
                torch.manual_seed(SEED)
                model = TemporalTransformer(8, dim=TT_DIM, depth=TT_DEPTH,
                                            n_heads=TT_HEADS, dtype=dtype)
            diff = GaussianDiffusion(model, HORIZON, base.observation_dim,
                                     base.action_dim, n_timesteps=T_STEPS
                                     ).cuda().train()
            loss_fn, names = build_loss(diff)
            state = tt.TrainState(diff, tt.make_optimizer(diff.parameters()),
                                  tt.EMA(diff).shadow)
            step = tt.make_train_step(
                loss_fn, lr_schedule=tt.warmup_cosine_schedule(3e-4, 10,
                                                               10000),
                gradient_clip=4.0)
            gens = make_generators(len(names), SEED, "cuda")
            steps[f"{fam}_{str(dtype)[6:]}"] = (
                lambda s=step, st=state, g=gens: s(st, batch, g))
    return steps


def _dtype_step_ms(steps: dict) -> dict:
    """Each step of :func:`_train_steps` timed alone with CUDA events over
    10 steps after 3, DT_REPEATS repeats in turns: the device-side step
    without ``train_main``'s data path."""
    ms = {k: [] for k in steps}
    for _ in range(DT_REPEATS):
        for k, fn in steps.items():
            ms[k].append(cuda_ms(fn, 10, warmup=3))
    return ms


def _bf16_forward_vs_cpu(model_gpu, model_cpu, x, t) -> float:
    """max |card - CPU| of the bf16 forward over the CPU's largest |out|."""
    with torch.no_grad():
        got = model_gpu(x.cuda(), t.cuda()).cpu()
        want = model_cpu(x, t)
    require(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
            "bf16 forward: float32 and finite")
    return float((got - want).abs().max() / want.abs().max())


def dtype_phase(ckpt: Path, root: Path, card: str) -> dict:
    """bf16 training (``train --dtype``) on the card: the flagship U-Net
    (fine-tuned from the smoke checkpoint) and the transformer recipe (dim
    256, depth 6, 8 heads), DT_STEPS steps of batch DT_BATCH through
    ``train_main`` at float32 and bfloat16, DT_REPEATS repeats in turns;
    step ms and first losses; each family's bf16 forward on the card
    against the same forward on the CPU (TOL_FWD_BF16 of the largest
    output). No port kernel launches on these paths."""
    from dadiff_tpu_torch.io.torch_compat import load_pt_checkpoint
    from dadiff_tpu_torch.models.temporal_transformer import (
        TemporalTransformer,
    )
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    t_phase = time.perf_counter()
    reset_counts()
    runs = _dtype_runs(ckpt, root)
    step_ms = _dtype_step_ms(_train_steps(ckpt))
    counts = read_counts()
    require(not any(counts.values()),
            f"a port kernel launched on the dtype path: {counts}")
    out = {"card": card, "runs": runs, "launches": counts,
           "step_ms": step_ms}
    log(f"dtype: the train step alone at batch {DT_BATCH} (CUDA events, 10 "
        f"steps, {DT_REPEATS} repeats in turns), ms: "
        f"{json.dumps(step_ms)} [{card}]")
    for fam, r in runs.items():
        f32 = [x["step_ms"] for x in r["float32"]]
        bf16 = [x["step_ms"] for x in r["bfloat16"]]
        rel, rel_last = (abs(r["bfloat16"][0][k] - r["float32"][0][k])
                         / abs(r["float32"][0][k])
                         for k in ("first_loss", "last_loss"))
        out[fam] = {"step_ms_float32": f32, "step_ms_bfloat16": bf16,
                    "first_loss_rel_diff": rel,
                    "last_loss_rel_diff": rel_last}
        log(f"dtype: {fam} batch {DT_BATCH}, {DT_STEPS} steps a run, "
            f"train_main wall ms a step (data included) f32 "
            f"{[round(v, 3) for v in f32]} bf16 {[round(v, 3) for v in bf16]}"
            f"; first loss bf16 {r['bfloat16'][0]['first_loss']:.6f} vs f32 "
            f"{r['float32'][0]['first_loss']:.6f} (rel {rel:.2e}; the "
            f"transformer's zero-initialised output makes its first loss "
            f"equal), last loss rel {rel_last:.2e} [{card}]")
        require(rel < 5e-2, f"{fam}: bf16's first loss near f32's ({rel})")

    # the bf16 forward on the card against the CPU
    state = load_pt_checkpoint(str(ckpt))["model_state_dict"]
    unet_sd = {k[len("model."):]: v for k, v in state.items()
               if k.startswith("model.")}
    g = torch.Generator().manual_seed(SEED + 14)
    x = torch.randn(N_CAND, HORIZON, 8, generator=g)
    t = torch.randint(0, T_STEPS, (N_CAND,), generator=g)
    pair = []
    for dev in ("cuda", "cpu"):
        m = TemporalUnet(8, dim=DIM, dim_mults=MULTS, dtype=torch.bfloat16)
        m.load_state_dict(unet_sd)
        pair.append(m.to(dev).eval())
    out["unet"]["forward_rel_err"] = _bf16_forward_vs_cpu(*pair, x, t)
    torch.manual_seed(SEED)
    tt_cpu = TemporalTransformer(8, dim=TT_DIM, depth=TT_DEPTH,
                                 n_heads=TT_HEADS, dtype=torch.bfloat16)
    with torch.no_grad():  # every leaf nonzero, the zero-init ones too
        for p in tt_cpu.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    tt_gpu = TemporalTransformer(8, dim=TT_DIM, depth=TT_DEPTH,
                                 n_heads=TT_HEADS, dtype=torch.bfloat16)
    tt_gpu.load_state_dict(tt_cpu.state_dict())
    out["transformer"]["forward_rel_err"] = _bf16_forward_vs_cpu(
        tt_gpu.cuda().eval(), tt_cpu.eval(), x, t)
    for fam in runs:
        e = out[fam]["forward_rel_err"]
        log(f"dtype: {fam} bf16 forward, card vs CPU at {N_CAND} chains: "
            f"{e:.3e} of the largest output (tolerance {TOL_FWD_BF16})")
        require(e <= TOL_FWD_BF16, f"{fam} bf16 forward card vs CPU {e}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"dtype_phase: {out['phase_s']:.1f} s")
    return out


def config_phase(root: Path) -> dict:
    """``train --config`` with a JSON experiment file (PyYAML may be absent
    here) and one flag on the command line: three steps; the file's
    values apply, the flag wins over the file's value, and the file's
    "tpu" device means the card."""
    from dadiff_tpu_torch.cli import train_main

    t0 = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    path = root / "experiment.json"
    path.write_text(json.dumps({
        "dataset": {"name": DATASET, "horizon": HORIZON},
        "model": {"dim": DIM, "dim_mults": list(MULTS)},
        "diffusion": {"n_timesteps": T_STEPS},
        "training": {"batch_size": BATCH, "warmup_steps": 10,
                     "eval_freq": 0, "save_freq": 0},
        "system": {"device": "tpu", "seed": SEED}}))
    reset_counts()
    log_dir = Path(train_main(["--config", str(path), "--dim", "64",
                               "--n-epochs", "1", "--max-steps", "3",
                               "--log-freq", "1", "--no-export-pt",
                               "--log-dir", str(root / "run")]))
    counts = read_counts()
    final = json.loads((log_dir / "final_config.json").read_text())
    rec = json.loads((log_dir / "metrics.jsonl").read_text().splitlines()[-1])
    require(rec["step"] == 3 and all(v == v for v in rec["total_series"]),
            f"config run: 3 finite steps {rec}")
    require(final["dim"] == 64 and final["horizon"] == HORIZON
            and final["n_timesteps"] == T_STEPS
            and final["dim_mults"] == list(MULTS),
            f"--dim wins over the file, the file over the defaults: {final}")
    require(not any(counts.values()), f"kernels launched: {counts}")
    out = {"dim": final["dim"], "horizon": final["horizon"],
           "losses": rec["total_series"], "launches": counts,
           "phase_s": time.perf_counter() - t0}
    log(f"config_phase: {json.dumps(out)}")
    return out


def kernel_family(name: str):
    """The port kernel a traced CUDA kernel name belongs to, or None."""
    import re

    if "ddpm_project" in name:
        return "ddpm_project_step"
    if "rows_conv" not in name:
        return None
    # rows_conv_kernel<Tile, kGn> (demangled ", true>(" / mangled "Lb1E")
    gn = re.search(r"true>\s*\(", name) or "Lb1E" in name
    return "rows_conv_gn" if gn else "rows_conv"


def profile_phase(ckpt: Path, policy, root: Path, chain: dict,
                  card: str) -> dict:
    """Traces through ``utils/profiling.trace`` on the card: 5 replays of
    the served bo8 wave (bf16 weights; the trace's launches of each K2
    kernel must equal the counters', 5 waves of 1,012 / 2,500 / 100), and
    5 train steps at batch 256 of the flagship U-Net and the transformer
    recipe, each at float32 and bfloat16. Each trace's busy share and its
    top kernels by device time; an empty trace fails."""
    from dadiff_tpu_torch.ops.planner import (
        build_interleaved_projection, make_planner_chain,
    )
    from dadiff_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    out = {"card": card}
    diff, spec = policy.diffusion, policy._sampler_config["projection"]
    H, D = diff.horizon, diff.transition_dim
    M, b = (v.to(diff.device) for v in build_interleaved_projection(
        policy._P, policy._stats, observation_dim=diff.observation_dim,
        action_dim=diff.action_dim, state_dim=spec.state_dim, horizon=H))
    wave = make_planner_chain(diff.model, diff.schedule, H, N_CAND, 1,
                              projection=True)
    x0, noise, _, cond_rows = _wave_inputs(diff, N_CAND, SEED + 7)
    fw, me, sc = _chain_operands(diff, spec, wave, torch.bfloat16)

    def replay():
        return wave(fw, x0, me, noise, sc, cond_rows, M, b)

    replay()  # drives from the host and captures the graph
    torch.cuda.synchronize()
    t_wave = time.perf_counter()
    for _ in range(5):
        replay()
    torch.cuda.synchronize()
    t_wave = (time.perf_counter() - t_wave) / 5 * 1e3
    reset_counts()
    with profiling.trace(str(root / "wave")):
        with profiling.annotate("wave"):
            for _ in range(5):
                replay()
            torch.cuda.synchronize()
    counts = read_counts()
    r = profiling.read_trace(str(root / "wave" / profiling.TRACE_FILE),
                             window="wave")
    require(r["n_device_events"] > 0, "the wave's trace holds no device "
            "event: the card's CUPTI gave none")
    by_family = {}
    for name, k in r["kernels"].items():
        fam = kernel_family(name)
        if fam:
            by_family[fam] = by_family.get(fam, 0) + k["count"]
    want = {k: 5 * n for k, n in chain["launches_by_kernel"].items()}
    top = sorted(r["kernels"].items(), key=lambda kv: -kv[1]["us"])[:5]
    out["wave"] = {
        "busy_share": r["busy_share"], "wall_ms": r["wall_us"] / 1e3,
        "untraced_wall_ms_per_wave": t_wave,
        "device_ms_per_wave": r["busy_us"] / 5e3,
        "kernel_ms_per_wave": sum(k["us"] for k in r["kernels"].values())
        / 5e3,
        "chain_phase_graph_ms": chain["graph_ms"],
        "trace_launches": by_family, "counter_launches": counts,
        "top_kernels": [(n[:80], k["count"], k["us"] / 1e3) for n, k in top]}
    log(f"profile: 5 bo8 wave replays, busy share {r['busy_share']:.4f}, "
        f"wall ms a wave {r['wall_us'] / 5e3:.3f} traced, {t_wave:.3f} "
        f"untraced; device ms a wave "
        f"{out['wave']['device_ms_per_wave']:.3f} beside "
        f"chain_phase's graph_ms {chain['graph_ms']:.3f}; trace launches "
        f"{by_family} vs counters {counts} [{card}]")
    log(f"profile: wave top kernels (name, count, ms): "
        f"{json.dumps(out['wave']['top_kernels'])}")
    require(by_family == want and all(counts[k] == n for k, n in want.items()),
            f"the trace's K2 launches {by_family} equal the counters' "
            f"{counts} ({want})")

    # 5 train steps at batch 256 of each family at f32 and bf16
    out["train"] = {}
    for name, step in _train_steps(ckpt).items():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t_train = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        t_train = (time.perf_counter() - t_train) / 5 * 1e3
        reset_counts()
        with profiling.trace(str(root / name)):
            with profiling.annotate("train"):
                for _ in range(5):
                    step()
                torch.cuda.synchronize()
        r = profiling.read_trace(str(root / name / profiling.TRACE_FILE),
                                 window="train")
        require(r["n_device_events"] > 0, f"the {name} train steps' trace "
                "holds no device event")
        top = sorted(r["kernels"].items(), key=lambda kv: -kv[1]["us"])[:5]
        rec = out["train"][name] = {
            "busy_share": r["busy_share"],
            "wall_ms_per_step": r["wall_us"] / 5e3,
            "untraced_wall_ms_per_step": t_train,
            "device_ms_per_step": r["busy_us"] / 5e3,
            "kernels_per_step": sum(k["count"] for k in
                                    r["kernels"].values()) / 5,
            "launches": read_counts(),
            "top_kernels": [(n[:80], k["count"], k["us"] / 1e3)
                            for n, k in top]}
        log(f"profile: 5 {name} train steps at batch {DT_BATCH}, busy share "
            f"{r['busy_share']:.4f}, wall ms a step "
            f"{rec['wall_ms_per_step']:.3f} traced, {t_train:.3f} untraced, "
            f"device ms a step {rec['device_ms_per_step']:.3f}, "
            f"{rec['kernels_per_step']:.0f} kernels a step [{card}]")
        log(f"profile: {name} top kernels (name, count, ms): "
            f"{json.dumps(rec['top_kernels'])}")
        require(not any(rec["launches"].values()),
                f"kernels launched in the {name} train steps")
    out["memory"] = profiling.device_memory_stats()
    out["phase_s"] = time.perf_counter() - t0
    return out


def physics_bound_phase(root: Path, card: str) -> dict:
    """``python -m dadiff_tpu_torch.physics_bound`` on Hopper-v5 at the
    committed artifact's settings (100 solver iterations, tolerance 0.1,
    float32) on the card, its K list cut to PB_K; its K* and per-K errors
    beside the artifact's rows at those K."""
    from dadiff_tpu_torch import physics_bound

    t0 = time.perf_counter()
    reset_counts()
    report = physics_bound.main([
        "--env", "Hopper-v5", "--data", "npz:data/hopper_mppi.npz",
        "--solver-iters", "100", "--tolerance", "0.1",
        "--k", *map(str, PB_K), "--out", str(root / "physics_bound.json")])
    counts = read_counts()
    took = time.perf_counter() - t0
    art = json.loads((ROOT / PB_ARTIFACT).read_text())
    got = report["distributions"]["heldout"]
    ref = {row["K"]: row for row in art["distributions"]["heldout"]["rows"]}
    require(report["dtype"] == "float32" and got["rows"]
            and all(math.isfinite(r["err_p90"]) for r in got["rows"]),
            f"physics bound rows {got}")
    require(not any(counts.values()), f"kernels launched: {counts}")
    rows = [{"K": r["K"], "n": r["n_segments"], "err_p50": r["err_p50"],
             "err_p90": r["err_p90"], "quotable": r["quotable"],
             "wall_s": r["wall_s"],
             "artifact": {k: ref[r["K"]][k] for k in (
                 "n_segments", "err_p50", "err_p90", "quotable")}
             if r["K"] in ref else None} for r in got["rows"]]
    out = {"card": card, "k_star": got["k_star"],
           "artifact_k_star": art["distributions"]["heldout"]["k_star"],
           "k_cut_to": list(PB_K), "rows": rows, "launches": counts,
           "phase_s": took}
    log(f"physics_bound: Hopper-v5 float32, 100 iterations, K cut to "
        f"{list(PB_K)} (the artifact's K reach 128): K* {got['k_star']} "
        f"(artifact, all K: {out['artifact_k_star']}); rows "
        f"{json.dumps(rows)}; {took:.1f} s [{card}]")
    return out


def check_install_phase() -> dict:
    """``python -m dadiff_tpu_torch.check_install`` on the card: exit 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "dadiff_tpu_torch.check_install"],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
    log("check_install: " + " | ".join(lines))
    require(proc.returncode == 0,
            f"check_install exited {proc.returncode}:\n{proc.stdout}\n"
            f"{proc.stderr}")
    return {"rc": proc.returncode, "checks": len(lines),
            "s": time.perf_counter() - t0}


def host_eval_phase(ckpt: Path, results_dir: Path) -> dict:
    """The host evaluator (``python -m dadiff_tpu_torch.evaluate``) in
    lockstep through the planner chain, where gymnasium and
    gymnasium-robotics import."""
    try:
        import gymnasium  # noqa: F401
        import gymnasium_robotics  # noqa: F401
    except ImportError as e:
        log(f"host evaluator: not run, gymnasium does not import here ({e})")
        return {"ran": False, "why": str(e)}
    proc = subprocess.run(
        [sys.executable, "-m", "dadiff_tpu_torch.evaluate", "--checkpoint",
         str(ckpt), "--dataset", DATASET, "--env", ENV, "--policy-type",
         "dynamics-aware", "--n-candidates", str(N_CAND), "--megakernel",
         "--batched", "--n-episodes", "8", "--max-steps", "50",
         "--results-dir", str(results_dir)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    require(proc.returncode == 0, f"host evaluator failed:\n{proc.stderr}")
    tail = [ln for ln in proc.stdout.splitlines() if ln.startswith(
        ("Mean", "Results"))]
    log(f"host evaluator: ran (8 episodes, 50 steps, batched, bo8 waves "
        f"of 64 chains): {' | '.join(tail)}")
    return {"ran": True, "summary": tail}


def reference_package() -> str:
    """Directory of the JAX package beside the port, which holds the TPU
    kernels the port replaces (read as files, never imported)."""
    return next(p.name for p in sorted(ROOT.iterdir())
                if (p / "ops" / "pallas_planner.py").is_file())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main_path(ckpt: Path, obs_rows):
    """The serving entry point with its real flags, driven over TCP."""
    import numpy as np
    from dadiff_tpu_torch import serve

    port = free_port()
    n_requests = 1 + N_PLANS + 1 + 1
    argv = ["--checkpoint", str(ckpt), "--env", ENV, "--dataset", DATASET,
            "--policy-type", "dynamics-aware", "--n-candidates", str(N_CAND),
            "--megakernel", "--port", str(port),
            "--max-requests", str(n_requests)]
    reset_counts()
    failure = []

    def run():
        try:
            serve.main(argv)
        except BaseException as e:  # reported by the main thread too
            failure.append(e)
            raise

    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.time() + 300
    while True:
        require(not failure, f"server failed: {failure and failure[0]!r}")
        try:
            conn = socket.create_connection(("127.0.0.1", port), timeout=600)
            break
        except OSError:
            require(time.time() < deadline, "server did not start")
            time.sleep(0.2)
    stream = torch.cuda.current_stream()
    out = []
    with conn, conn.makefile("rwb") as f:
        def ask(req):
            f.write((json.dumps(req) + "\n").encode())
            f.flush()
            return json.loads(f.readline())

        pong = ask({"ping": True})
        require(pong.get("ok") and pong["horizon"] == HORIZON, f"ping {pong}")
        for i in range(N_PLANS):
            o = obs_rows[i]
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record(stream)
            r = ask({"obs": o.tolist(), "plan": True})
            ev1.record(stream)
            ev1.synchronize()
            require("error" not in r, f"plan request failed: {r}")
            out.append((o, r, ev0.elapsed_time(ev1)))
        r_act = ask({"obs": obs_rows[0].tolist()})
        r_reset = ask({"reset": True})
    th.join(timeout=120)
    require(not th.is_alive() and not failure, f"server did not stop {failure}")
    counts = read_counts()
    require(len(r_act["action"]) == 2 and r_reset == {"ok": True},
            "action / reset responses")

    from dadiff_tpu_torch.datasets.normalization import DatasetNormalizer

    ck = torch.load(str(ckpt), map_location="cpu", weights_only=False)
    norm = DatasetNormalizer.from_arrays(
        {k: np.asarray(v, np.float32)
         for k, v in ck["config"]["normalizer_stats"].items()})
    plan_ms = []
    for o, r, wave_ms in out:
        plan = np.asarray(r["plan"], np.float64)
        act = np.asarray(r["action"])
        require(plan.shape == (HORIZON, 8) and np.isfinite(plan).all(),
                "plan shape / finite")
        require(act.shape == (2,) and np.isfinite(act).all(), "action shape")
        normed = norm.normalize_observations(o.reshape(1, -1))[0]
        row_err = float(np.abs(plan[0, :6] - normed).max())
        require(row_err <= 1e-6, f"row 0 holds the observation ({row_err})")
        require(np.all(plan[0, 6:] == 0.0), "row-0 action columns are 0")
        plan_ms.append(r["plan_ms"])
        how = ("replayed from the CUDA graph" if len(plan_ms) > 1 else
               "driven from the host, then captured")
        log(f"main path: plan_ms {r['plan_ms']} device wave {wave_ms:.3f} ms "
            f"(CUDA events) row0 err {row_err:.1e}; {how}")
    for name in ("rows_conv", "rows_conv_gn", "ddpm_project_step"):
        require(counts[name] > 0,
                f"{name} was not launched on the serving path")
    require(counts["gn_mish"] == counts["gn_mish_backward"] == 0,
            "K1 launched on the serving path: every "
            "GroupNorm there is the epilogue of its conv")
    log(f"serving path launches: {counts}")
    return counts, plan_ms, [w for _, _, w in out]


def main() -> int:

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "dadiff_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import os

    os.chdir(ROOT)
    import numpy as np
    from dadiff_tpu_torch.ops import cuda_lib
    from dadiff_tpu_torch.cli import build_policy_from_args, load_model
    from dadiff_tpu_torch.serve import build_server_parser
    from dadiff_tpu_torch.datasets.sources import load_episodes

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    took = cuda_lib.build_all()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in took.items()})} "
        f"({time.perf_counter() - t0:.2f} s)")

    # -- the training path: train, export the .pt, run the ladder on it
    reset_counts()
    ckpt = train_phase(ROOT / "build" / "dadiff_tpu_torch" / "smoke")
    ladder = ladder_phase(ckpt)
    train_counts = read_counts()
    log(f"train + ladder launches: {train_counts}")
    for name in ("gn_mish", "resblock", "chain"):
        require(train_counts[name] > 0,
                f"{name} was not launched on the train-and-ladder path")
    log(f"ladder: {json.dumps(ladder)}")
    # the train step through K1's forward and backward (use_pallas_norm)
    train = train_step_phase(ckpt)
    require(train["launches"]["gn_mish_backward"] > 0,
            "gn_mish_backward was not launched on the train step")

    args = build_server_parser().parse_args(
        ["--checkpoint", str(ckpt), "--env", ENV, "--dataset", DATASET,
         "--policy-type", "dynamics-aware", "--n-candidates", str(N_CAND)])
    diff, dataset = load_model(str(ckpt), DATASET, device="cuda")
    n_params = sum(p.numel() for p in diff.model.parameters())
    policy = build_policy_from_args(args, diff, dataset, DATASET, T_STEPS)

    # -- every kernel against its plain version, and its times
    kern = kernel_phase(diff.model, N_CAND * HORIZON, diff.transition_dim)
    log(f"kernels per step: {json.dumps(kern)}")
    kern["resblock"] = resblock_phase(diff.model)
    log(f"resblock: {json.dumps(kern['resblock'])}")
    kern["chain"] = one_chain_phase(diff)
    log(f"one-launch chain: {json.dumps(kern['chain'])}")
    chain = chain_phase(policy)
    log(f"planner chain: {json.dumps(chain)}")

    # -- the serving path: the server on the trained checkpoint
    eps = load_episodes(DATASET)
    obs_rows = [np.asarray(eps[i]["observations"][0], np.float32)
                for i in range(0, 4 * N_PLANS, 4)]
    counts, plan_ms, wave_ms = main_path(ckpt, obs_rows)
    log(f"serving path: plan_ms {plan_ms}; device ms per bo8 wave {wave_ms}")
    # the first plan drove its wave from the host, the others replayed the
    # graph: each counts the launches of one wave
    for name, n in chain["launches_by_kernel"].items():
        require(counts[name] == N_PLANS * n,
                f"{name}: {counts[name]} launches for {N_PLANS} waves of {n}")

    # -- the evaluation path: the on-device loop at the published protocol
    results_dir = ROOT / "build" / "dadiff_tpu_torch" / "smoke" / "results"
    ondevice = ondevice_eval_phase(ckpt, policy, results_dir)
    log(f"on-device evaluation: {json.dumps(ondevice)}")
    env = env_phase()
    chain64 = chain64_phase(policy)
    streams = two_stream_phase(policy)
    host_eval = host_eval_phase(ckpt, results_dir)
    fewcall = fewcall_phase(ckpt, policy, ROOT / "build" / "dadiff_tpu_torch"
                            / "smoke", results_dir, card)
    log(f"fewcall_phase: {json.dumps(fewcall)}")
    micro = microbatch_phase(ckpt, obs_rows, card)
    log(f"microbatch_phase: {json.dumps(micro)}")
    value = value_phase(ckpt, ROOT / "build" / "dadiff_tpu_torch" / "smoke",
                        card)
    log(f"value_phase: {json.dumps(value)}")
    locomotion = locomotion_phase(ROOT / "build" / "dadiff_tpu_torch"
                                  / "smoke", card)
    log(f"locomotion_phase: {json.dumps(locomotion)}")
    learned = learned_phase(locomotion["checkpoint"], ROOT / "build"
                            / "dadiff_tpu_torch" / "smoke", card)
    log(f"learned_phase: {json.dumps(learned)}")
    transformer = transformer_phase(ckpt, ROOT / "build" / "dadiff_tpu_torch"
                                    / "smoke", results_dir, card)
    log(f"transformer_phase: {json.dumps(transformer)}")
    parallel = parallel_phase(ckpt, ROOT / "build" / "dadiff_tpu_torch"
                              / "smoke" / "parallel", card)
    log(f"parallel_phase: {json.dumps(parallel)}")
    smoke = ROOT / "build" / "dadiff_tpu_torch" / "smoke"
    dtypes = dtype_phase(ckpt, smoke / "dtype", card)
    log(f"dtype_phase: {json.dumps(dtypes)}")
    config = config_phase(smoke / "config")
    profile = profile_phase(ckpt, policy, smoke / "profile", chain, card)
    log(f"profile_phase: {json.dumps(profile)}")
    bound = physics_bound_phase(smoke, card)
    log(f"physics_bound_phase: {json.dumps(bound)}")
    install = check_install_phase()

    csrc = "dadiff_tpu_torch/csrc"
    ref = reference_package()
    table = {  # name: (source, TPU kernel replaced, launches on its path)
        "gn_mish": (f"{csrc}/gn_mish.cu", f"{ref}/ops/pallas_kernels.py:84",
                    train_counts["gn_mish"]),
        "gn_mish_backward": (f"{csrc}/gn_mish.cu",
                             f"{ref}/ops/pallas_kernels.py:118-139",
                             train["launches"]["gn_mish_backward"]),
        "rows_conv": (f"{csrc}/planner.cu", f"{ref}/ops/pallas_planner.py:95",
                      counts["rows_conv"]),
        "rows_conv_gn": (f"{csrc}/planner.cu", f"{ref}/ops/pallas_unet.py:198",
                         counts["rows_conv_gn"]),
        "ddpm_project_step": (f"{csrc}/planner.cu",
                              f"{ref}/ops/pallas_planner.py:95",
                              counts["ddpm_project_step"]),
        "chain": (f"{csrc}/chain.cu", f"{ref}/ops/pallas_unet.py:334",
                  train_counts["chain"]),
        "resblock": (f"{csrc}/resblock.cu", f"{ref}/ops/pallas_resblock.py:132",
                     train_counts["resblock"]),
    }
    evaluation = ondevice["launches_by_kernel"]
    for name in ("rows_conv", "rows_conv_gn"):
        # the same kernels at the on-device evaluator's 32,768-row shapes
        lib = ondevice["library"][name]
        kern[name]["at_32768_rows"] = {k: lib[k] for k in (
            "ms", "library_ms", "bound_ms", "bound_by", "kernel_over_library",
            "tiles", "mma_sync_ms", "ms_in_turns") + (
                ("wave_convs", "final_conv") if name == "rows_conv" else ())}
    kernels = []
    for name, (source, replaces, launches) in table.items():
        r = kern[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "per": r["per"], "launches_per_step": r.get("launches_per_step"),
            "host_ms": r.get("host_ms"),
        })
        # the locomotion path plans through the module path: none; nor
        # does the learned path or the MPPI planner
        kernels[-1]["launches_locomotion"] = \
            locomotion["evaluator"]["launches"][name]
        kernels[-1]["launches_learned"] = \
            learned["evaluator"]["launches"][name]
        kernels[-1]["launches_mppi"] = learned["mppi"]["launches"][name]
        # the transformer (train, serve, evaluate), Picard and progressive
        # distillation run the module path: none
        tt_counts = transformer["launches"]
        kernels[-1]["launches_transformer"] = sum(
            tt_counts[p][name] for p in ("train", "serving", "evaluation"))
        kernels[-1]["launches_picard"] = tt_counts["picard"][name]
        kernels[-1]["launches_progressive"] = tt_counts["progressive"][name]
        # DDP, FSDP, the batched planner, the meshed evaluator and the
        # tp/sp forwards run the module path: none
        kernels[-1]["launches_parallel"] = parallel["launches"][name]
        # bf16 and config training, the traced train steps and the physics
        # bound run the module path: none; the traced bo8 wave: 5 waves
        kernels[-1]["launches_dtype"] = dtypes["launches"][name]
        kernels[-1]["launches_config"] = config["launches"][name]
        kernels[-1]["launches_profile_wave"] = \
            profile["wave"]["counter_launches"][name]
        kernels[-1]["launches_profile_train"] = sum(
            rec["launches"][name] for rec in profile["train"].values())
        kernels[-1]["launches_physics_bound"] = bound["launches"][name]
        if name in evaluation:
            # the evaluation path's count (its untimed and timed runs)
            kernels[-1]["launches_evaluation"] = evaluation[name]
            kernels[-1]["launches_microbatch"] = micro["launches"][name]
        for extra in ("variants", "ms_f32", "cycle_share", "grid_syncs",
                      "ms_by_fan_in", "ms_served", "unfused_ms",
                      "library_composition_ms", "ms_in_sequence", "grid",
                      "barriers_per_launch", "step_timing", "ms_per_launch",
                      "bound_ms_per_launch", "at_32768_rows", "at_batch_32",
                      "autograd", "ladder", "served_step"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    # K1 runs on the train-and-ladder path (its forward in the ladder's
    # fused U-Net) and on the train step under use_pallas_norm (forward and
    # backward); on the serving path every GroupNorm is the epilogue of its
    # conv (rows_conv_gn)
    for k in kernels[:2]:
        k["launches_serving"] = counts[k["name"]]
        k["launches_train_step"] = train["launches"][k["name"]]
    kernels.append({
        "name": "planner_chain", "route": "cuda",
        "source": "dadiff_tpu_torch/ops/planner.py",
        "replaces": f"{ref}/ops/pallas_planner.py:95",
        "launches": len(wave_ms), "max_abs_err": chain["max_abs_err"],
        # what a served plan runs: the wave replayed from its CUDA graph,
        # staging copies included; host_ms: every launch driven from Python
        "ms": chain["graph_ms"], "plain_ms": chain["plain_ms"],
        "bound_ms": chain["bound_ms"], "bound_by": chain["bound_by"],
        "library_ms": None, "per": "bo8 wave",
        "launches_per_wave": chain["launches_per_wave"],
        "host_ms": chain["ms"], "plain_graph_ms": chain["plain_graph_ms"],
        "served_plan_ms": plan_ms, "served_wave_ms": wave_ms,
        "wave_ms_in_turns": chain["wave_ms_in_turns"],
        # the on-device evaluator's wave: 1,024 chains, replayed
        "ondevice_chains": ondevice["chains"],
        "ondevice_wave_ms": ondevice["wave_ms"],
        "ondevice_wave_host_ms": ondevice["wave_host_ms"],
        "ondevice_bound_ms": ondevice["wave_bound_ms"],
        "ondevice_bound_by": ondevice["wave_bound_by"],
        "ondevice_plain_ms": ondevice["wave_plain_ms"],
        "ondevice_max_abs_err": ondevice["wave_max_abs_err"],
        "ondevice_conv_max_abs_err": ondevice["conv_max_abs_err"],
        "ondevice_conv_gn_max_abs_err": ondevice["conv_gn_max_abs_err"],
        # measured: the counters read after the on-device runs
        "ondevice_launches_by_kernel": ondevice["launches_by_kernel"],
        "ondevice_launches_per_wave": ondevice["launches_per_wave"],
        "ondevice_waves": ondevice["waves"],
        "ondevice_step_us": ondevice["step_us"],
        "chain64_f32_max_abs_err": chain64["max_abs_err"],
        # the micro-batched server's waves: K_pad requests of bo8
        "microbatch_waves": micro["waves"],
        "microbatch_lane_max_abs_err": micro["lane_max_abs_err"],
    })
    log(f"evaluation: env {json.dumps(env)}; two streams "
        f"{json.dumps(streams)}; host evaluator {json.dumps(host_eval)}")
    log(f"train step: {json.dumps(train)}")
    log(f"check_install: {json.dumps(install)}")
    log(f"flagship: {n_params} parameters; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
