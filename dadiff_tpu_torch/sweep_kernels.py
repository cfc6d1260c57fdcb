"""Sweep the free parameters of the conv kernels on the card, at the flagship
shapes (horizon 32, dim 128, mults 1 2 4, random weights):

    python -m dadiff_tpu_torch.sweep_kernels conv  [--chains 8]
    python -m dadiff_tpu_torch.sweep_kernels chain
    python -m dadiff_tpu_torch.sweep_kernels resblock

``conv``: every distinct conv of one denoise step (the fused ones without
their GroupNorm epilogue) through ``rows_conv`` (bf16 weights) with each tile
of ``conv_tiling.MMA_TILES`` and 1-32 K splits and, from 1,024 rows on, each
wgmma tile of ``conv_tiling.WG_BUILT`` (width 128 or 256, its ring's stages)
with 1 and 2 K splits, and wherever it fits the cluster tile (64 x 128,
1-8 splits), timed as ten launches replayed from a CUDA graph (weights warm
in L2), beside the tile and split that ``ops/planner.py`` takes itself and
the one it took without the cluster tile; the sums over a step of the best
choices and of the rule's. Then
every fused pair through ``rows_conv_gn`` the same way (the rule's tile,
the mma.sync rule's, each cluster tiling, ``WG_GN`` where the rule takes a
wgmma tile). This is where ``tile_shape``, ``_want_splits``,
``_wg_width``, ``_takes_cluster`` and ``_cl_splits`` come from (``--chains
1024`` for the wgmma tile, ``--chains 8|16|32|64`` for the cluster
tile).

``chain``: the one-launch chain (K3) with 1 or 2 blocks per SM and several
caps on the K splits of a conv, ms per chain and block 0's cycle shares: where
``_BLOCKS_PER_SM`` and ``MAX_FAN_IN`` of ``ops/chain.py`` come from.

``resblock``: the fused residual block (K4), which runs the same layer
program for one block (one block per SM, all its registers can take), at
the 12 blocks of a batch-1 step with several caps on the K splits: device
time per launch (ten launches of one block replayed, weights warm in L2) and
per step (the 12 replayed), and block 0's cycle shares at the widest and the
narrowest block.

It needs a CUDA device, prints the card's name and power limit first, and
checks every variant against the plain version before it times it.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
from collections import Counter

import torch

from dadiff_tpu_torch.ops import chain as ch
from dadiff_tpu_torch.ops import conv_tiling as ct
from dadiff_tpu_torch.ops import planner as pl
from dadiff_tpu_torch.ops.chain_operands import (
    flatten_unet_params, prepare_chain_operands,
)

HORIZON, DIM, MULTS, D, T_STEPS = 32, 128, (1, 2, 4), 8, 100


def graph_ms(fn, reps: int = 5) -> float:
    """Device ms of ``fn``'s launches, captured once and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class _Recorder:
    """Stands in for the chain's ops on meta tensors and records each launch
    with its shapes."""

    def __init__(self):
        self.calls = []

    def conv(self, xa, xb, w, bias, mode, k, seg):
        self.calls.append(("conv", xa.shape[0], xa.shape[1],
                           0 if xb is None else xb.shape[1], w.shape[1], mode,
                           k, seg))
        return torch.empty(pl._conv_out_rows(xa.shape[0], mode), w.shape[1],
                           device="meta")

    def conv_gn(self, xa, xb, w, bias, k, seg, scale, gbias, te=None,
                res=None):
        self.calls.append(("conv_gn", xa.shape[0], xa.shape[1],
                           0 if xb is None else xb.shape[1], w.shape[1],
                           ct.SAME, k, seg, te is not None, res is not None))
        return torch.empty(xa.shape[0], w.shape[1], device="meta")


def step_launches(unet, rows: int, D: int, horizon: int):
    """The launches of one denoise step on ``rows`` stacked rows, recorded
    from the chain's own host loop: (calls, layer program, residual blocks),
    a call being ("conv", rows, cin_a, cin_b, cout, mode, k, seg) or
    ("conv_gn", rows, cin_a, cin_b, cout, SAME, k, seg, has_te, has_res)."""
    rec = _Recorder()
    prog = pl._program(unet, [w.to("meta") for w in flatten_unet_params(unet)])
    tes = [torch.empty(op[2][0].shape[1], device="meta") for op in prog
           if op[0] == "res"]
    pl._unet_eps(rec, prog, torch.empty(rows, D, device="meta"), tes, horizon,
                 unet.kernel_size)
    return rec.calls, prog, len(tes)


def _label(t) -> str:
    """A tiling's name in the sweep's lines: family, shape, stages, splits."""
    fam = "cl" if t.cluster else "wg" if t.bm == ct.WG_BM else "mma"
    return f"{fam}{t.bm}x{t.bn}" + (f"x{t.ring}" if t.ring else "") \
        + f"/s{t.splits}"


def _cluster_tilings(M, K, parities, cout):
    """The distinct cluster tilings of 1-8 splits."""
    return list({_label(t): t for t in (
        ct.cl_tiling(M, K, parities, cout, s)
        for s in range(1, ct.CL_MAX_SPLITS + 1))}.values())


def _print_times(head: str, rule, us: dict, extra: str = "") -> None:
    best = sorted(us, key=us.get)[:3]
    shapes = sorted({q.split("/")[0] for q in us})
    ring = f"cl{ct.CL_BM}x{ct.CL_BN}x{ct.CL_STAGES}"
    curve = {q.split("/s")[1]: v for q, v in us.items()
             if q.split("/")[0] == ring}
    print(f"{head}: rule {_label(rule)} {us[_label(rule)]:.1f} us{extra} | "
          "best " + " ".join(f"{q}: {us[q]:.1f}" for q in best)
          + " | by tile " + " ".join(
              f"{sh}: {min(v for q, v in us.items() if q.split('/')[0] == sh):.1f}"
              for sh in shapes)
          + (" | " + ring + " by splits " + " ".join(
              f"{q}: {curve[q]:.1f}" for q in sorted(curve, key=int))
             if curve else ""), flush=True)


def sweep_conv(unet, n_chains: int) -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    total = {"best": 0.0, "rule": 0.0, "mma": 0.0}
    calls, _, _ = step_launches(unet, n_chains * HORIZON, D, HORIZON)
    # every conv of the step, with or without the GroupNorm epilogue
    for (R, ca, cb, cout, mode, k, seg), n in Counter(
            c[1:8] for c in calls).items():
        cin = ca + cb
        xa = torch.randn(R, ca, device="cuda", generator=g)
        xb = torch.randn(R, cb, device="cuda", generator=g) if cb else None
        w = (torch.randn((4 if mode == ct.UP else k) * cin, cout, device="cuda",
                         generator=g) / cin ** 0.5).to(torch.bfloat16)
        bias = torch.randn(1, cout, device="cuda", generator=g)
        out = torch.empty(pl._conv_out_rows(R, mode), cout, device="cuda")
        want = pl.rows_conv_plain(xa, xb, w, bias, mode, k, seg)
        M, K, parities = ct.gemm_dims(R, cin, mode, k)
        k_tiles = -(-K // ct.BK)

        def time_of(t):
            scratch = torch.empty(max(t.partial_elems, 1), device="cuda")

            def ten():
                for _ in range(10):
                    pl.launch_rows_conv(xa, xb, w, bias, out, mode, k, seg,
                                        None, scratch, t)

            ten()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if err > 1e-4:
                raise SystemExit(f"rows_conv {_label(t)} disagrees: {err}")
            return graph_ms(ten) * 100  # us per launch

        tilings = []
        for bm, bn in ct.MMA_TILES:
            tiles = -(-cout // bn) * -(-M // bm) * parities
            for want_s in (1, 2, 4, 8, 16, 32):
                tilings.append(ct.Tiling(bm, bn, tiles, ct.even_splits(
                    k_tiles, want_s), M, K, parities, cout))
        if M >= 8 * ct.WG_BM and (mode != ct.UP or cin % ct.WG_BK == 0):
            for (bn, stages), s in itertools.product(ct.WG_BUILT, (1, 2)):
                tilings.append(ct.wg_tiling(M, K, parities, cout, bn, s,
                                            stages))
        if ct.cl_fits(mode, seg, ca, cb, cout):
            tilings += _cluster_tilings(M, K, parities, cout)
        rule = pl._split_k(R, cin, cout, mode, k, True, seg=seg, cin_b=cb)
        mma = pl._split_k(R, cin, cout, mode, k, True)  # without the cluster
        us = {}
        for t in tilings + [rule, mma]:
            if _label(t) not in us:
                us[_label(t)] = time_of(t)
        total["best"] += n * min(us.values())
        total["rule"] += n * us[_label(rule)]
        total["mma"] += n * us[_label(mma)]
        _print_times(f"x{n} M={M} K={K} N={cout} mode={mode} seg={seg}", rule,
                     us, f" (without the cluster tile {_label(mma)} "
                     f"{us[_label(mma)]:.1f})")
    print(f"per step at {n_chains} chains: best of the sweep "
          f"{total['best'] / 1e3:.4f} ms, the rule {total['rule'] / 1e3:.4f} "
          f"ms, the rule without the cluster tile {total['mma'] / 1e3:.4f} ms",
          flush=True)
    sweep_conv_gn(calls, g)


def sweep_conv_gn(calls, g) -> None:
    """Every distinct fused pair through ``rows_conv_gn`` with a time row
    and a residual, checked against the plain version first: on the tile
    the rule takes, on the rule's tile without the cluster tile, on every
    cluster tiling that holds its pairs, and where the rule takes a wgmma
    tile on ``conv_tiling.WG_GN``, beside it the same conv through
    ``rows_conv`` on that tile (the epilogue's cost)."""
    totals = {"best": 0.0, "rule": 0.0, "mma": 0.0}
    pairs = Counter(c[1:8] for c in calls if c[0] == "conv_gn")
    for (R, ca, cb, cout, _, k, seg), n in pairs.items():
        cin = ca + cb
        t, gp = pl._split_k_gn(R, cin, cout, k, seg, True, cb)
        tm, gm = pl._split_k_gn_mma(R, cin, cout, k, seg, True)
        xa = torch.randn(R, ca, device="cuda", generator=g)
        xb = torch.randn(R, cb, device="cuda", generator=g) if cb else None
        w = (torch.randn(k * cin, cout, device="cuda", generator=g)
             / cin ** 0.5).to(torch.bfloat16)
        bias, scale, gbias, te = (torch.randn(cout, device="cuda",
                                              generator=g) for _ in range(4))
        bias = bias.reshape(1, -1)
        res = torch.randn(R, cout, device="cuda", generator=g)
        out = torch.empty(R, cout, device="cuda")
        want = pl.rows_conv_gn_plain(xa, xb, w, bias, k, seg, scale, gbias,
                                     te, res)
        tilings = [(t, gp), (tm, gm)]
        if ct.cl_fits(ct.SAME, seg, ca, cb, cout) and ct.cl_gn_fits(seg, cout):
            tilings += [(tc, ct.group_plan(R, cout, seg, tc.bm, tc.bn))
                        for tc in _cluster_tilings(R, t.K, 1, cout)]
        if t.bm == ct.WG_BM:
            bn, stages = ct.WG_GN
            tw = ct.wg_tiling(R, t.K, 1, cout, bn, 1, stages)
            tilings.append((tw, gp))
        us = {}
        for tt, gg in tilings:
            if _label(tt) in us:
                continue
            gcount = torch.zeros(max(gg.blocks, 1), dtype=torch.int32,
                                 device="cuda")
            scratch = torch.empty(max(tt.partial_elems, 1), device="cuda")

            def ten(tt=tt, gg=gg, gcount=gcount, scratch=scratch):
                for _ in range(10):
                    pl.launch_rows_conv_gn(xa, xb, w, bias, out, k, seg, scale,
                                           gbias, te, 0, res, gcount, None,
                                           scratch, t=tt, g=gg)

            ten()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if err > 1e-3:
                raise SystemExit(f"rows_conv_gn {_label(tt)} disagrees: {err}")
            us[_label(tt)] = graph_ms(ten) * 100
        extra = f" (without the cluster tile {_label(tm)} {us[_label(tm)]:.1f})"
        if t.bm == ct.WG_BM:
            tc = ct.wg_tiling(R, t.K, 1, cout, t.bn, 1, t.ring)

            def conv(tc=tc):
                for _ in range(10):
                    pl.launch_rows_conv(xa, xb, w, bias, out, ct.SAME, k, seg,
                                        None, None, tc)

            extra += f" (rows_conv on it {graph_ms(conv) * 100:.1f})"
        totals["best"] += n * min(us.values())
        totals["rule"] += n * us[_label(t)]
        totals["mma"] += n * us[_label(tm)]
        _print_times(f"x{n} fused M={R} K={t.K} N={cout} seg={seg}", t, us,
                     extra)
    print("fused pairs per step: " + " ".join(
        f"{q} {v / 1e3:.4f} ms" for q, v in totals.items()), flush=True)


def sweep_chain(unet, schedule) -> None:
    g = torch.Generator(device="cuda").manual_seed(3)
    x0 = torch.randn(HORIZON, D, device="cuda", generator=g)
    noise = torch.randn(T_STEPS, HORIZON, D, device="cuda", generator=g)
    ts = torch.arange(T_STEPS - 1, -1, -1, device="cuda")
    chain = ch.make_chain(unet, schedule, HORIZON)
    defaults = ch._BLOCKS_PER_SM, ch.MAX_FAN_IN
    try:
        for wd in (torch.bfloat16, torch.float32):
            fw, me, sc = prepare_chain_operands(unet, schedule, ts, wd)
            want = ch.chain_plain(unet, fw, x0, me, noise, sc, None,
                                  chain.config)
            for per_sm, cap in itertools.product((1, 2), (8, 16, 33)):
                ch._BLOCKS_PER_SM, ch.MAX_FAN_IN = per_sm, cap
                launch = chain.bind(fw, x0, me, noise, sc)
                err = (launch() - want).abs().max().item()
                if err > (5e-2 if wd == torch.bfloat16 else 2e-3):
                    raise SystemExit(f"chain disagrees: {err}")
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                for _ in range(5):
                    launch()
                end.record()
                end.synchronize()
                prof = torch.zeros(len(ch.PROFILE_SLOTS), dtype=torch.int64,
                                   device="cuda")
                launch(prof)
                cyc = dict(zip(ch.PROFILE_SLOTS, prof.tolist()))
                tot = max(sum(cyc.values()), 1)
                print(f"{str(wd)[6:]} blocks/SM {per_sm} (grid {launch.grid}) "
                      f"splits <= {cap}: {start.elapsed_time(end) / 5:.2f} ms "
                      "per chain; cycles " + " ".join(
                          f"{k} {v / tot:.2f}" for k, v in cyc.items()
                          if v / tot >= 0.005) + f"; err {err:.1e}", flush=True)
    finally:
        ch._BLOCKS_PER_SM, ch.MAX_FAN_IN = defaults


def sweep_resblock(unet) -> None:
    from dadiff_tpu_torch.models.fused_unet import fused_block_params
    from dadiff_tpu_torch.ops import resblock as rb

    g = torch.Generator(device="cuda").manual_seed(4)
    L = len(MULTS)
    rows = ([HORIZON >> i for i in range(L) for _ in range(2)]
            + [HORIZON >> (L - 1)] * 2
            + [HORIZON >> (L - 1 - j) for j in range(L - 1) for _ in range(2)])
    bufs = []
    for H, bp in zip(rows, fused_block_params(unet)):
        bp = {k: v.detach() for k, v in bp.items()}
        x = torch.randn(1, H, bp["w1"].shape[1], device="cuda", generator=g)
        te = torch.randn(1, bp["w1"].shape[2], device="cuda", generator=g)
        bufs.append((x, te, bp, rb.residual_block_plain(x, te, bp)))
    n_w = [sum(v.numel() for v in b[2].values()) for b in bufs]
    ends = {"widest": n_w.index(max(n_w)), "narrowest": n_w.index(min(n_w))}

    def cycles(i):
        x, te, bp, want = bufs[i]
        prof = torch.zeros(len(ch.PROFILE_SLOTS), dtype=torch.int64,
                           device="cuda")
        rb.launch_resblock(x, te, bp, torch.empty_like(want), 8, rb.EPS,
                           prof=prof)
        c = dict(zip(ch.PROFILE_SLOTS, prof.tolist()))
        tot = max(sum(c.values()), 1)
        return " ".join(f"{k} {c[k] / tot:.2f}" for k in ("conv", "gn",
                                                            "barrier"))

    default = ch.MAX_FAN_IN
    try:
        for cap in (4, 8, 16, 32):
            ch.MAX_FAN_IN = cap
            rb._templates.clear()
            err = max((rb.fused_residual_block(x, te, bp) - want).abs().max()
                      .item() for x, te, bp, want in bufs)
            if err > 1e-4:
                raise SystemExit(f"resblock disagrees: {err}")
            per = [graph_ms(lambda b=b: [rb.fused_residual_block(*b[:3])
                                         for _ in range(10)]) / 10
                   for b in bufs]
            step = graph_ms(lambda: [rb.fused_residual_block(*b[:3])
                                     for b in bufs])
            print(f"splits <= {cap}: {step * 1e3:.1f} us "
                  "per step; us per launch " + " ".join(
                      f"{t * 1e3:.1f}" for t in per) + "; cycles " + "; ".join(
                      f"{name} {cycles(i)}" for name, i in ends.items())
                  + f"; err {err:.1e}", flush=True)
    finally:
        ch.MAX_FAN_IN = default
        rb._templates.clear()


def main(argv=None) -> None:
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", choices=("conv", "chain", "resblock"))
    parser.add_argument("--chains", type=int, default=8)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_kernels: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.manual_seed(0)
    unet = TemporalUnet(D, dim=DIM, dim_mults=MULTS).cuda()
    with torch.no_grad():
        if args.what == "conv":
            sweep_conv(unet, args.chains)
        elif args.what == "resblock":
            sweep_resblock(unet)
        else:
            diff = GaussianDiffusion(unet, HORIZON, 6, 2,
                                     n_timesteps=T_STEPS).cuda().eval()
            sweep_chain(unet, diff.schedule)


if __name__ == "__main__":
    main()
