"""The batch-1 latency ladder: one unguided chain sampled through every
sampler the package has, from the same weights and the same noise.

Counterpart of the JAX package's scripts/probe_megakernel.py and of the
batch-1 rows of its bench.py (:134-142).

    python -m dadiff_tpu_torch.probe_megakernel --checkpoint X.pt

Rungs, each a (1, H, D) chain of T steps:

  module         ``GaussianDiffusion.p_sample_loop``: the module path;
  hoisted        ``fast_p_sample_loop`` with the plain residual block: time
                 MLP, schedule gathers and weight layouts hoisted;
  hoisted_fused  the same over the fused U-Net: one K4 launch per residual
                 block, the final GroupNorm+Mish through K1;
  chain_bf16     the whole chain as ONE launch of K3, bf16 weights;
  chain_f32      the same with f32 weights.

For each rung it prints ms per chain (median of ``--repeats``, after one
warm-up), steps/s and the max abs difference from the module path; the last
line is one JSON object with all of it. Without ``--checkpoint`` it uses
seeded random weights at the flagship shape (dim 128, mults 1 2 4, horizon
32, T=100, D=8), as the JAX script does. It runs on the card; on
``--device cpu`` every rung takes its plain version and the times are the
host's, which the output says.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batch-1 latency ladder",
                                allow_abbrev=False)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="reference-schema .pt (default: seeded random "
                        "weights at the shape given by the flags below)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--sampling-timesteps", type=int, default=None)
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--dim-mults", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--n-timesteps", type=int, default=100)
    p.add_argument("--observation-dim", type=int, default=6)
    p.add_argument("--action-dim", type=int, default=2)
    return p


def _load(args, device):
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    if args.checkpoint:
        from dadiff_tpu_torch.cli import diffusion_from_checkpoint
        from dadiff_tpu_torch.io.torch_compat import load_pt_checkpoint

        ck = load_pt_checkpoint(args.checkpoint)
        cfg = ck["config"]
        diff = diffusion_from_checkpoint(ck, cfg["observation_dim"],
                                         cfg["action_dim"], cfg["horizon"])
    else:
        torch.manual_seed(args.seed)
        unet = TemporalUnet(args.observation_dim + args.action_dim,
                            dim=args.dim, dim_mults=tuple(args.dim_mults))
        diff = GaussianDiffusion(unet, args.horizon, args.observation_dim,
                                 args.action_dim, n_timesteps=args.n_timesteps)
    return diff.to(device).eval()


def _time_ms(fn, repeats: int, device) -> float:
    """Median wall time of ``fn`` in ms, the device drained before each
    reading of the clock."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@torch.no_grad()
def run_ladder(diff, *, repeats: int = 5, sampling_timesteps=None,
               seed: int = 0) -> dict:
    """Sample one chain through every rung with the same injected noise."""
    from dadiff_tpu_torch.models.fast_sampler import fast_p_sample_loop
    from dadiff_tpu_torch.ops.chain import chain_p_sample_loop

    device = diff.device
    unet, sched = diff.model, diff.schedule
    shape = (1, diff.horizon, diff.transition_dim)
    T = diff.n_timesteps if sampling_timesteps is None else sampling_timesteps
    g = torch.Generator(device=device).manual_seed(seed)
    init = torch.randn(shape, generator=g, device=device)
    noise = torch.randn((T,) + shape, generator=g, device=device)
    kw = dict(sampling_timesteps=sampling_timesteps, init_noise=init,
              step_noise=noise)
    flags = dict(clip_denoised=diff.clip_denoised,
                 predict_epsilon=diff.predict_epsilon)

    if diff.prediction == "v":
        raise NotImplementedError(
            "the fused U-Net and the one-launch chain take epsilon or x0 "
            "models")
    rungs = {
        "module": lambda: diff.p_sample_loop(shape, **kw),
        "hoisted": lambda: fast_p_sample_loop(unet, sched, shape,
                                              use_kernel=False, **flags, **kw),
        "hoisted_fused": lambda: fast_p_sample_loop(unet, sched, shape,
                                                    **flags, **kw),
        "chain_bf16": lambda: chain_p_sample_loop(
            unet, sched, shape, weight_dtype=torch.bfloat16, **flags, **kw),
        "chain_f32": lambda: chain_p_sample_loop(
            unet, sched, shape, weight_dtype=torch.float32, **flags, **kw),
    }
    gold = rungs["module"]()
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "steps": T, "shape": list(shape), "rungs": {}}
    for name, fn in rungs.items():
        x = fn()
        ms = _time_ms(fn, repeats, device)
        err = float((x - gold).abs().max())
        out["rungs"][name] = {"ms_per_chain": ms, "steps_per_s": T / ms * 1e3,
                              "max_abs_diff": err,
                              "finite": bool(torch.isfinite(x).all())}
        print(f"{name}: {ms:.3f} ms per chain, {T / ms * 1e3:.1f} steps/s, "
              f"max|diff| vs module {err:.3e} ({out['device']})", flush=True)
    return out


def main(argv=None) -> dict:
    from dadiff_tpu_torch.cli import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # the module path is the reference of every rung: keep its library
    # convs and products in full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    diff = _load(args, device)
    out = run_ladder(diff, repeats=args.repeats,
                     sampling_timesteps=args.sampling_timesteps, seed=args.seed)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
