"""Picard (parallel-in-time) against sequential sampling on the card: the
counterpart of the JAX package's scripts/bench_picard.py.

    python -m dadiff_tpu_torch.bench_picard [--dims 128 256 512]

For each U-Net width (mults 1 2 4, weights from a seeded init, horizon 32,
transition 8, cosine T = 100) it times one batch-1 chain of the sequential
sampler (``p_sample_loop``) and of ``parallel_sample_loop`` (window 25, tol
1e-2) on the same draws: CUDA events around each chain, the median of
REPEATS chains after one untimed chain. It prints one JSON line per
width (the two chain times, the sweeps, the speedup and the two chains'
largest difference) and writes them to ``--out``. The JAX script's
``results/picard_crossover.json`` holds the TPU's numbers and is never
written here. ``--device cpu`` times on the host clock.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

HORIZON, TRANSITION, N_TIMESTEPS, WINDOW, TOL = 32, 8, 100, 25, 1e-2
REPEATS = 5


def _chain_ms(fn, device) -> list:
    import torch

    fn()  # untimed
    times = []
    for _ in range(REPEATS):
        if device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def bench_dim(dim: int, device, seed: int = 0) -> dict:
    """One width: the sequential and the Picard chain on the same draws."""
    import torch

    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.parallel_sampling import parallel_sample_loop
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    torch.manual_seed(seed)
    diff = GaussianDiffusion(
        TemporalUnet(TRANSITION, dim=dim, dim_mults=(1, 2, 4)), HORIZON,
        observation_dim=6, action_dim=2, n_timesteps=N_TIMESTEPS,
    ).to(device).eval()
    shape = (1, HORIZON, TRANSITION)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    init = torch.randn(shape, generator=g, device=device)
    noise = torch.randn((N_TIMESTEPS,) + shape, generator=g, device=device)
    box = {}

    def seq():
        box["seq"] = diff.p_sample_loop(shape, init_noise=init,
                                        step_noise=noise)

    def picard():
        box["picard"], box["sweeps"] = parallel_sample_loop(
            diff, diff.schedule, shape, window=WINDOW, tol=TOL,
            init_noise=init, step_noise=noise, return_sweeps=True,
            device=device)

    seq_ms = _chain_ms(seq, device)
    pic_ms = _chain_ms(picard, device)
    s, p = statistics.median(seq_ms), statistics.median(pic_ms)
    return {"dim": dim, "sequential_chain_ms": s, "picard_chain_ms": p,
            "picard_speedup": s / p, "sweeps": box["sweeps"],
            "max_abs_diff": float((box["picard"] - box["seq"]).abs().max()),
            "sequential_ms_all": seq_ms, "picard_ms_all": pic_ms}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--dims", type=int, nargs="+", default=[128, 256, 512])
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--out", type=str,
                   default="build/dadiff_tpu_torch/picard_crossover.json")
    args = p.parse_args(argv)
    if os.path.normpath(args.out) == os.path.join("results",
                                                  "picard_crossover.json"):
        raise SystemExit("results/picard_crossover.json holds the TPU's "
                         "numbers: write the port's elsewhere")
    import torch

    from dadiff_tpu_torch.cli import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":  # f32 products: the same arithmetic as JAX's
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for dim in args.dims:
        row = bench_dim(dim, device)
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if not k.endswith("_all")}), flush=True)
    out = {"protocol": f"batch-1 chain, T={N_TIMESTEPS}, window={WINDOW}, "
                       f"tol={TOL}, median of {REPEATS} chains after "
                       f"one untimed, the same draws for both samplers",
           "timing": ("CUDA events around each chain" if device.type == "cuda"
                      else "host clock around each chain"),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
