#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from dadiff_tpu_torch/csrc (nvcc, sm_90a)
   into build/dadiff_tpu_torch/.
2. Holds every kernel against its plain PyTorch version on the card, at the
   flagship planner's shapes (8 chains x horizon 32, dim 128, mults 1 2 4,
   T=100), and times kernel, plain version, a library call where one exists,
   and the least time the card could take.
3. Drives the main path: writes a seeded flagship checkpoint (.pt, reference
   schema), starts ``python -m dadiff_tpu_torch.serve``'s ``main`` with
   ``--policy-type dynamics-aware --n-candidates 8 --megakernel`` in a
   thread, sends ping, plan requests and reset over TCP, checks the answers
   and that the kernels' launch counters rose.
4. Prints the card, the kernel table as one JSON line, and as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, with no result, without a CUDA device or outside a
checkout of the repository. It uses nothing of JAX.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
N_CAND, HORIZON, DIM, MULTS, T_STEPS = 8, 32, 128, (1, 2, 4), 100
DATASET = "npz:data/pointmaze_umaze_expert.npz"
ENV = "PointMaze_UMaze-v3"
N_PLANS = 4

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 and f32 FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12

TOL_GN = 1e-5       # f32 sums in another order: ~1e-6 observed
TOL_CONV = 1e-4     # K up to 5120 f32 products summed in another order
TOL_STEP = 1e-5
TOL_CHAIN_F32 = 2e-3  # tests/test_pallas_planner.py's tolerance for the chain
# bf16 chain vs the plain chain at the same bf16 rounding points: the two sum
# in other orders, so an activation near a bf16 rounding boundary can round
# the other way (2^-8 relative) and 100 steps carry it on
TOL_CHAIN_BF16 = 5e-2


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
# The launches of one denoise step, recorded from the chain's own host loop
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for the chain's ops on meta tensors and records each launch
    with its shapes."""

    def __init__(self):
        self.calls = []

    def conv(self, xa, xb, w, bias, mode, k, seg):
        from dadiff_tpu_torch.ops.planner import _conv_out_rows

        self.calls.append(("conv", xa.shape[0], xa.shape[1],
                           0 if xb is None else xb.shape[1], w.shape[1], mode,
                           k, seg))
        return torch.empty(_conv_out_rows(xa.shape[0], mode), w.shape[1],
                           device="meta")

    def gn(self, x, scale, bias, seg, te=None, res=None):
        self.calls.append(("gn", x.shape[0], x.shape[1], seg, te is not None,
                           res is not None))
        return torch.empty_like(x, device="meta")


def step_launches(unet, rows: int, D: int):
    from dadiff_tpu_torch.ops.chain_operands import flatten_unet_params
    from dadiff_tpu_torch.ops.planner import _program, _unet_eps

    rec = _Recorder()
    prog = _program(unet, [w.to("meta") for w in flatten_unet_params(unet)])
    n_res = sum(op[0] == "res" for op in prog)
    tes = [torch.empty(op[2][0].shape[1], device="meta") for op in prog
           if op[0] == "res"]
    _unet_eps(rec, prog, torch.empty(rows, D, device="meta"), tes, HORIZON,
              unet.kernel_size)
    return rec.calls, prog, n_res


def conv_cost(rows, cin_a, cin_b, cout, mode, k, wbytes):
    from dadiff_tpu_torch.ops.planner import UP, _conv_out_rows

    cin = cin_a + cin_b
    taps = 4 if mode == UP else k
    out_rows = _conv_out_rows(rows, mode)
    flops = 2.0 * out_rows * (2 if mode == UP else k) * cin * cout
    nbytes = 4 * rows * cin + wbytes * taps * cin * cout + 4 * cout \
        + 4 * out_rows * cout
    return flops, nbytes


def bound_ms(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def write_checkpoint(path: Path):
    """A flagship planner with seeded random weights, as a reference-schema
    .pt carrying the dataset's normalization stats."""
    from dadiff_tpu_torch.datasets.sequence import SequenceDataset
    from dadiff_tpu_torch.io.torch_compat import save_pt_checkpoint
    from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    torch.manual_seed(SEED)
    ds = SequenceDataset(DATASET, horizon=HORIZON)
    unet = TemporalUnet(transition_dim=ds.transition_dim, dim=DIM,
                        dim_mults=MULTS)
    diff = GaussianDiffusion(unet, horizon=HORIZON,
                             observation_dim=ds.observation_dim,
                             action_dim=ds.action_dim, n_timesteps=T_STEPS)
    n_params = sum(p.numel() for p in unet.parameters())
    path.parent.mkdir(parents=True, exist_ok=True)
    save_pt_checkpoint(str(path), diff, {
        "horizon": HORIZON, "observation_dim": ds.observation_dim,
        "action_dim": ds.action_dim, "n_timesteps": T_STEPS,
        "beta_schedule": "cosine", "normalizer_name": "LimitsNormalizer",
        "normalizer_stats": {k: v.tolist() for k, v in
                             ds.normalizer.as_arrays().items()},
    })
    log(f"checkpoint: {path.relative_to(ROOT)} ({n_params} parameters)")
    return n_params


def kernel_phase(unet, rows, D):
    """K1 and the K2 kernels against their plain versions, and their times
    over the launches of one denoise step."""
    import numpy as np
    import torch.nn.functional as F
    from dadiff_tpu_torch.ops.gn_mish import gn_mish, gn_mish_plain
    from dadiff_tpu_torch.ops.planner import (
        DOWN, UP, StepConfig, ddpm_project_step, ddpm_project_step_plain,
        rows_conv, rows_conv_plain,
    )
    from dadiff_tpu_torch.cli import maze_grid_for_env

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    calls, _, _ = step_launches(unet, rows, D)
    results = {}

    # -- K1 at the flagship shapes, with and without its epilogue adds
    gn_calls = [c for c in calls if c[0] == "gn"]
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
    # its gradient is the plain version's (the JAX custom_vjp's backward)
    args = [torch.randn(8, HORIZON, DIM, device=dev, generator=g),
            torch.randn(DIM, device=dev, generator=g),
            torch.randn(DIM, device=dev, generator=g),
            torch.randn(DIM, device=dev, generator=g)]
    gy = torch.randn(8, HORIZON, DIM, device=dev, generator=g)
    grads = []
    for fn in (gn_mish, gn_mish_plain):
        leaves = [a.clone().requires_grad_(True) for a in args]
        fn(*leaves[:3], te=leaves[3]).backward(gy)
        grads.append([a.grad for a in leaves])
    e = max((a - b).abs().max().item() for a, b in zip(*grads))
    log(f"K1 gn_mish backward vs plain autograd: max|err| {e:.3e}")
    require(e <= 1e-4, f"gn_mish backward {e}")

    gn_bufs = []
    flops = nbytes = bnd = 0.0
    for _, R, C, seg, has_te, has_res in gn_calls:
        x = torch.randn(R // seg, seg, C, device=dev, generator=g)
        s, b = torch.randn(C, device=dev), torch.randn(C, device=dev)
        te = torch.randn(C, device=dev) if has_te else None
        res = torch.randn_like(x) if has_res else None
        gn_bufs.append((x, s, b, te, res, x.permute(0, 2, 1).contiguous()))
        nb = 4 * R * C * (2 + has_res) + 4 * C * (2 + has_te)
        fl = 20.0 * R * C
        bnd += bound_ms(fl, nb, F32_FLOPS)[0]
        flops, nbytes = flops + fl, nbytes + nb
    def k1():
        return [gn_mish(x, s, b, te=te, res=res) for x, s, b, te, res, _ in gn_bufs]

    results["gn_mish"] = dict(
        max_abs_err=err, ms=graph_ms(k1, 50), host_ms=cuda_ms(k1, 50),
        plain_ms=graph_ms(lambda: [gn_mish_plain(x, s, b, te=te, res=res)
                                   for x, s, b, te, res, _ in gn_bufs], 50),
        library_ms=graph_ms(lambda: [F.mish(F.group_norm(xc, 8, s, b, 1e-5))
                                     for _, s, b, _, _, xc in gn_bufs], 50),
        bound_ms=bnd, bound_by="bytes", per="denoise step",
        launches_per_step=len(gn_calls))

    # -- rows_conv: every distinct conv of a step, f32 and bf16 weights
    conv_calls = [c for c in calls if c[0] == "conv"]
    err = 0.0
    for wd in (torch.float32, torch.bfloat16):
        for _, R, ca, cb, cout, mode, k, seg in sorted(set(conv_calls)):
            xa = torch.randn(R, ca, device=dev, generator=g)
            xb = torch.randn(R, cb, device=dev, generator=g) if cb else None
            taps = 4 if mode == UP else k
            w = (torch.randn(taps * (ca + cb), cout, device=dev, generator=g)
                 / (ca + cb) ** 0.5).to(wd)
            bias = torch.randn(1, cout, device=dev, generator=g)
            e = (rows_conv(xa, xb, w, bias, mode, k, seg)
                 - rows_conv_plain(xa, xb, w, bias, mode, k, seg)).abs().max().item()
            log(f"K2 rows_conv {str(wd)[6:]} mode={mode} k={k} rows={R} "
                f"cin={ca}+{cb} cout={cout}: max|err| {e:.3e}")
            err = max(err, e)
    require(err <= TOL_CONV, f"rows_conv vs plain {err} > {TOL_CONV}")
    # split-K sums its partials in a fixed order: repeated launches agree
    require(all(torch.equal(rows_conv(xa, xb, w, bias, mode, k, seg),
                            rows_conv(xa, xb, w, bias, mode, k, seg))
                for _ in range(3)), "rows_conv is deterministic")

    conv_bufs = []
    bnd = 0.0
    for _, R, ca, cb, cout, mode, k, seg in conv_calls:
        xa = torch.randn(R, ca, device=dev, generator=g)
        xb = torch.randn(R, cb, device=dev, generator=g) if cb else None
        taps = 4 if mode == UP else k
        w = (torch.randn(taps * (ca + cb), cout, device=dev, generator=g)
             / (ca + cb) ** 0.5).to(torch.bfloat16)
        bias = torch.randn(1, cout, device=dev, generator=g)
        xcat = xa if xb is None else torch.cat([xa, xb], 1)
        x_lib = xcat.reshape(R // seg, seg, ca + cb).permute(0, 2, 1) \
            .contiguous().to(torch.bfloat16)
        wf = w.float()
        if mode == UP:
            w_lib = torch.stack([wf[t * (ca + cb):(t + 1) * (ca + cb)]
                                 for t in range(4)], dim=2)
        else:
            w_lib = wf.reshape(k, ca + cb, cout).permute(2, 1, 0)
        conv_bufs.append((xa, xb, w, bias, mode, k, seg,
                          x_lib, w_lib.contiguous().to(torch.bfloat16),
                          bias.reshape(-1).to(torch.bfloat16)))
        bnd += bound_ms(*conv_cost(R, ca, cb, cout, mode, k, 2), BF16_FLOPS)[0]

    def lib_conv(x, w, b, mode, k):
        if mode == UP:
            return F.conv_transpose1d(x, w, b, stride=2, padding=1)
        return F.conv1d(x, w, b, stride=2 if mode == DOWN else 1,
                        padding=k // 2)

    def k2():
        return [rows_conv(*c[:7]) for c in conv_bufs]

    results["rows_conv"] = dict(
        max_abs_err=err, ms=graph_ms(k2, 20), host_ms=cuda_ms(k2, 20),
        plain_ms=graph_ms(lambda: [rows_conv_plain(*c[:7]) for c in conv_bufs],
                          20),
        library_ms=graph_ms(lambda: [lib_conv(c[7], c[8], c[9], c[4], c[5])
                                     for c in conv_bufs], 20),
        bound_ms=bnd, bound_by="operations", per="denoise step",
        launches_per_step=len(conv_calls))

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
        StepConfig, _PlainOps, _program, build_interleaved_projection,
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

    def run(ops_w):
        fw, me, sc = ops_w
        return chain(fw, x0.reshape(rows, D), me,
                     noise.reshape(T_STEPS, rows, D), sc,
                     cond.values.reshape(rows, D), M, b)

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

    # wave times and the bound of one bo8 wave
    calls, _, n_res = step_launches(diff.model, rows, D)
    flops = nbytes = 0.0
    for c in calls:
        if c[0] == "conv":
            fl, _ = conv_cost(c[1], c[2], c[3], c[4], c[5], c[6], 2)
            flops += fl
    flops = flops * T_STEPS + 2.0 * T_STEPS * N_CAND * (H * D) ** 2
    te_flops = sum(2.0 * T_STEPS * op[2][0].shape[0] * op[2][0].shape[1]
                   for op in _program(diff.model, fw) if op[0] == "res")
    flops += te_flops
    w_bytes = sum(t.numel() * t.element_size() for t in ops16[0])
    nbytes = (w_bytes + 4 * rows * D * (T_STEPS + 3) + 4 * (H * D) ** 2
              + 4 * T_STEPS * (8 + me.shape[1]))
    b_ms, b_by = bound_ms(flops, nbytes, BF16_FLOPS)
    return dict(
        max_abs_err=err32, bf16_max_abs_err=err16,
        ms=cuda_ms(lambda: run(ops16), 5, warmup=1),
        graph_ms=graph_ms(lambda: run(ops16), 5),
        ms_f32=cuda_ms(lambda: run(ops32), 3, warmup=1),
        plain_ms=cuda_ms(plain, 3, warmup=1),
        plain_graph_ms=graph_ms(plain, 3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, per="bo8 wave",
        flops_per_wave=flops, weight_bytes=w_bytes,
        bytes_per_wave=nbytes,
        launches_per_wave=T_STEPS * (len(calls) + 1) + n_res,
    )


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
    from dadiff_tpu_torch.ops.gn_mish import gn_mish
    from dadiff_tpu_torch.ops.planner import ddpm_project_step, rows_conv

    port = free_port()
    n_requests = 1 + N_PLANS + 1 + 1
    argv = ["--checkpoint", str(ckpt), "--env", ENV, "--dataset", DATASET,
            "--policy-type", "dynamics-aware", "--n-candidates", str(N_CAND),
            "--megakernel", "--port", str(port),
            "--max-requests", str(n_requests)]
    for fn in (gn_mish, rows_conv, ddpm_project_step):
        fn.launches = 0
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
    counts = {fn.__name__: fn.launches for fn in (gn_mish, rows_conv,
                                                  ddpm_project_step)}
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
        log(f"main path: plan_ms {r['plan_ms']} device wave {wave_ms:.3f} ms "
            f"(CUDA events) row0 err {row_err:.1e}")
    for name, n in counts.items():
        require(n > 0, f"{name} was not launched on the main path")
    log(f"main path launches: {counts}")
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

    ckpt = ROOT / "build" / "dadiff_tpu_torch" / "smoke" / "flagship.pt"
    n_params = write_checkpoint(ckpt)
    args = build_server_parser().parse_args(
        ["--checkpoint", str(ckpt), "--env", ENV, "--dataset", DATASET,
         "--policy-type", "dynamics-aware", "--n-candidates", str(N_CAND)])
    diff, dataset = load_model(str(ckpt), DATASET, device="cuda")
    policy = build_policy_from_args(args, diff, dataset, DATASET, T_STEPS)

    kern = kernel_phase(diff.model, N_CAND * HORIZON, diff.transition_dim)
    log(f"kernels per step: {json.dumps(kern)}")
    chain = chain_phase(policy)
    log(f"chain: {json.dumps(chain)}")

    eps = load_episodes(DATASET)
    obs_rows = [np.asarray(eps[i]["observations"][0], np.float32)
                for i in range(0, 4 * N_PLANS, 4)]
    counts, plan_ms, wave_ms = main_path(ckpt, obs_rows)
    log(f"main path: plan_ms {plan_ms}; device ms per bo8 wave {wave_ms}")

    src = {"gn_mish": "dadiff_tpu_torch/csrc/gn_mish.cu",
           "rows_conv": "dadiff_tpu_torch/csrc/planner.cu",
           "ddpm_project_step": "dadiff_tpu_torch/csrc/planner.cu"}
    ref = reference_package()
    replaces = {"gn_mish": f"{ref}/ops/pallas_kernels.py:84",
                "rows_conv": f"{ref}/ops/pallas_planner.py:95",
                "ddpm_project_step": f"{ref}/ops/pallas_planner.py:95"}
    kernels = []
    for name in ("gn_mish", "rows_conv", "ddpm_project_step"):
        r = kern[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name],
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "per": r["per"], "launches_per_step": r["launches_per_step"],
            "host_ms": r["host_ms"],
        })
    kernels.append({
        "name": "planner_chain", "route": "cuda",
        "source": "dadiff_tpu_torch/ops/planner.py",
        "replaces": f"{ref}/ops/pallas_planner.py:95",
        "launches": len(wave_ms), "max_abs_err": chain["max_abs_err"],
        "ms": chain["ms"], "plain_ms": chain["plain_ms"],
        "bound_ms": chain["bound_ms"], "bound_by": chain["bound_by"],
        "library_ms": None, "per": "bo8 wave",
        "launches_per_wave": chain["launches_per_wave"],
        "graph_ms": chain["graph_ms"], "plain_graph_ms": chain["plain_graph_ms"],
    })
    log(f"flagship: {n_params} parameters; total {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
