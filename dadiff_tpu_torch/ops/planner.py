"""K2: the batched best-of-N planning chain, as hand-written CUDA kernels
(``csrc/planner.cu``) driven by a host loop.

Counterpart of the JAX package's ops/pallas_planner.py: build_interleaved_projection
:53, make_pallas_planner_chain :95 (its ``pallas_call`` at :287, inner kernel
:206, ``_project`` :156, ``_apply_cond`` :152), make_pallas_bo_sampler :305
and wire_policy_megakernel :449; and of the U-Net body it runs,
ops/pallas_unet.py:258 ``_unet_forward`` with its ``_group_norm_mish`` :198.

On the TPU the whole chain is one kernel with the weights resident in VMEM.
Here each denoise step is a short sequence of launches, 36 at the flagship:

  rows_conv          the convs that feed no GroupNorm (the k=1 residual
                     convs, the k=3 stride-2 downsample, the k=4 stride-2
                     transposed conv, the final k=1 conv), on all chains at
                     once, zero-padded per chain; the bf16 product runs on
                     the tensor cores (csrc/common.cuh);
  rows_conv_gn       every k=5 conv with the GroupNorm+Mish that follows it
                     in its epilogue, statistics per chain, with the
                     time-embedding add or the residual add fused after it;
  ddpm_project_step  DDPM update, projection, wall revert, row-0 conditioning,
                     into the other of two buffers.

The per-step time-dense products are hoisted out of the loop: one k=1
``rows_conv`` per residual block over all T steps. Noise is drawn outside the
kernels, as on the TPU (pallas_planner.py:414-416).

On the card a chain owns every buffer of its wave (:class:`_WaveRunner`): the
caller's x_T, noise and conditioning are copied into fixed buffers, the first
wave on a set of prepared operands is driven from the host and then captured
in a CUDA graph, and every later wave replays that graph: one graph launch
instead of ~3,600 kernel launches, the counterpart of the TPU's one jitted
call. A capture or a replay that fails raises.

The same host loop runs the plain PyTorch version of each kernel when the
tensors lie on the CPU; on CUDA tensors it launches the kernels or raises.
The plain version of the whole chain, the oracle on the card, is the DDPM
sampler of guides/sampling.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dadiff_tpu_torch.ops import cuda_lib
from dadiff_tpu_torch.ops.chain_operands import _layer_plan, prepare_chain_operands
from dadiff_tpu_torch.ops.conv_tiling import (
    DOWN, F32_TILE, MMA_TILES, N_GROUPS, N_SM, SAME, UP, BK, WG_BK, WG_BM,
    WG_GN, GroupPlan, Tiling, even_splits, gemm_dims, group_plan, tiling,
    wg_gn_fits, wg_tiling,
)
from dadiff_tpu_torch.ops.gn_mish import gn_mish_plain
from dadiff_tpu_torch.ops.projection import (
    NormStats,
    apply_projection,
    projection_alpha,
    wall_violation_mask,
)


# ---------------------------------------------------------------------------
# rows_conv: one conv of the U-Net over row-stacked chains
# ---------------------------------------------------------------------------

def _shift_rows(x: torch.Tensor, s: int, seg: int) -> torch.Tensor:
    """y[h] = x[h - s] within each segment of ``seg`` rows, zero padded
    (pallas_unet.py:161-181)."""
    if s == 0:
        return x
    R, C = x.shape
    y = torch.zeros_like(x).reshape(R // seg, seg, C)
    if abs(s) < seg:
        xs = x.reshape(R // seg, seg, C)
        if s > 0:
            y[:, s:] = xs[:, :seg - s]
        else:
            y[:, :seg + s] = xs[:, -s:]
    return y.reshape(R, C)


def rows_conv_plain(xa, xb, w, bias, mode: int, k: int, seg_in: int):
    """Plain version: conv of the channel concat [xa | xb] (R, cin) with a
    flattened weight (pallas_unet.py:275-323). With bf16 weights the
    activations are rounded to bf16 first, as the TPU casts them."""
    x = xa if xb is None else torch.cat([xa, xb], dim=1)
    if w.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).to(torch.float32)
    wf = w.to(torch.float32)
    cin, cout = x.shape[1], wf.shape[1]
    if mode == UP:
        R = [wf[t * cin:(t + 1) * cin] for t in range(4)]
        even = x @ R[1] + _shift_rows(x, 1, seg_in) @ R[3] + bias
        odd = _shift_rows(x, -1, seg_in) @ R[0] + x @ R[2] + bias
        return torch.stack([even, odd], dim=1).reshape(2 * x.shape[0], cout)
    half = k // 2
    stack = torch.cat([_shift_rows(x, half - t, seg_in) for t in range(k)], dim=1)
    y = stack @ wf + bias
    if mode == DOWN:
        y = y.reshape(-1, 2, cout)[:, 0]
    return y


def _conv_out_rows(rows: int, mode: int) -> int:
    return {SAME: rows, DOWN: rows // 2, UP: 2 * rows}[mode]


# blocks the card has room for at two per SM; a launch may queue twice that
_ROOM = 2 * N_SM


def _want_splits(tiles: int, k_tiles: int) -> int:
    """K splits of one launch, from a sweep of the flagship's convs on the
    card: none under 8 K tiles (the partial tiles' round trip costs more
    than the short loop), else 2 or more K tiles per split, 8 splits (one
    batch of loads for the block that sums them) until a split would pass 10
    K tiles, and no more than four blocks per SM in all."""
    if k_tiles < 8:
        return 1
    return min(k_tiles // 2, max(8, k_tiles // 10), -(-2 * _ROOM // tiles))


def _wg_width(M: int, cout: int, parities: int) -> int:
    """Columns of the wgmma tile of a conv (``sweep_kernels conv --chains
    1024`` on the card): 256 where that still leaves three output tiles for
    every four SMs (each A tile then feeds twice the columns), else 128.
    No K splits: one launch on one split beat two splits at every conv of
    the 1,024-chain wave, the 128 tiles of a 8,192-row 256-channel conv
    too."""
    tiles = -(-M // WG_BM) * -(-cout // 256) * parities
    return 256 if cout >= 256 and 4 * tiles >= 3 * N_SM else 128


def _split_k_mma(rows: int, cin: int, cout: int, mode: int, k: int,
                 bf16: bool) -> Tiling:
    """The mma.sync (f32: CUDA-core) tile and K splits of a launch."""
    return tiling(rows, cin, cout, mode, k, bf16, _ROOM, _want_splits)


def _split_k(rows: int, cin: int, cout: int, mode: int, k: int,
             bf16: bool) -> Tiling:
    """Tile shape, output tiles and K splits of one launch. bf16 weights
    take the mma.sync tiles of ``tile_shape`` while the largest of them
    leaves no more blocks than the card has SMs (every conv of the served
    8-chain wave and of the 64-chain chain; K3 and K4 cut their own), and
    past that the 128-row wgmma tile: every conv of the 1,024-chain wave
    (8,192-32,768 rows; a transposed conv only where its cin is whole K
    tiles of 64, the rows its TMA box reads)."""
    t = _split_k_mma(rows, cin, cout, mode, k, bf16)
    M, _, parities = gemm_dims(rows, cin, mode, k)
    largest = -(-M // MMA_TILES[-1][0]) * -(-cout // MMA_TILES[-1][1])
    if not bf16 or largest * parities <= N_SM or (mode == UP and cin % WG_BK):
        return t
    return wg_tiling(t.M, t.K, t.parities, cout,
                     _wg_width(t.M, cout, t.parities), 1)


def _partial(xa, t: Tiling, scratch):
    """The split-K partial tiles of a launch: None for one split, else
    ``scratch`` if it is large enough, else a new buffer."""
    if t.splits == 1:
        return None
    if scratch is None or scratch.numel() < t.partial_elems:
        scratch = torch.empty(t.partial_elems, dtype=torch.float32,
                              device=xa.device)
    return scratch


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_rows_conv(xa, xb, w, bias, out, mode: int, k: int, seg_in: int,
                     stream=None, scratch=None, t: Optional[Tiling] = None,
                     counters=None):
    """Launch the kernel on contiguous CUDA tensors (unchecked). ``scratch``:
    a float32 tensor that holds the split-K partial tiles if it is large
    enough; else one is allocated. ``t``: another tile and split than
    :func:`_split_k`'s (measurements). ``counters``: zeroed int32, one per
    output tile, left zeroed; by default the set of (device, stream)."""
    cin_b = 0 if xb is None else xb.shape[1]
    rows, cout = xa.shape[0], w.shape[1]
    bf16 = w.dtype == torch.bfloat16
    if t is None:
        t = _split_k(rows, xa.shape[1] + cin_b, cout, mode, k, bf16)
    partial = _partial(xa, t, scratch)
    stream = cuda_lib.stream_of(xa) if stream is None else stream
    if partial is None:
        counters = None
    elif counters is None:
        counters = cuda_lib.counters(xa.device, t.tiles, stream)
    if t.bm == WG_BM:  # csrc/wgmma.cuh, bf16 weights
        rc = cuda_lib.lib("planner").rows_conv_wg(
            xa.data_ptr(), _ptr(xb), xa.shape[1], cin_b, w.data_ptr(),
            bias.data_ptr(), out.data_ptr(), rows, seg_in, cout, mode, k,
            t.bn, t.ring, t.splits, _ptr(partial), _ptr(counters), stream)
    else:
        rc = cuda_lib.lib("planner").rows_conv(
            xa.data_ptr(), _ptr(xb), xa.shape[1], cin_b, w.data_ptr(),
            int(bf16), bias.data_ptr(), out.data_ptr(), rows, seg_in, cout,
            mode, k, t.bm, t.bn, t.splits, _ptr(partial), _ptr(counters),
            stream)
    cuda_lib.check(rc, "rows_conv")
    rows_conv.launches += 1


def _check_conv(xa, xb, w, bias, mode: int, k: int, seg_in: int,
                what: str) -> None:
    for t in (xa, xb, bias):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()
                              or t.device != xa.device):
            raise ValueError(f"{what}: activations and bias must be "
                             "contiguous float32 on one device")
    if w.dtype not in (torch.float32, torch.bfloat16) or not w.is_contiguous() \
            or w.device != xa.device:
        raise ValueError(f"{what}: w must be contiguous f32 or bf16")
    cin = xa.shape[1] + (0 if xb is None else xb.shape[1])
    taps = 4 if mode == UP else k
    if w.shape[0] != taps * cin or bias.numel() != w.shape[1] \
            or xa.shape[0] % seg_in or (xb is not None
                                        and xb.shape[0] != xa.shape[0]):
        raise ValueError(f"{what}: shapes do not match")
    if w.shape[1] % 8 or any(t is not None and t.data_ptr() % 16
                             for t in (xa, xb, w)):
        raise ValueError(f"{what}: the kernel moves 16 bytes at a time: "
                         "cout must be a multiple of 8 and the operands "
                         "16-byte aligned")


def rows_conv(xa, xb, w, bias, mode: int, k: int, seg_in: int) -> torch.Tensor:
    """Conv of [xa | xb] ((R, cin_a), (R, cin_b) or None) over R/seg_in
    stacked chains. ``w``: flattened (taps*cin, cout), bf16 or f32; ``bias``
    (1, cout) f32; ``mode`` SAME (k odd), DOWN (k=3, s=2) or UP (k=4, s=2).
    Plain version on the CPU, the kernel on CUDA tensors."""
    if xa.device.type == "cpu":
        return rows_conv_plain(xa, xb, w, bias, mode, k, seg_in)
    _check_conv(xa, xb, w, bias, mode, k, seg_in, "rows_conv")
    out = torch.empty(_conv_out_rows(xa.shape[0], mode), w.shape[1],
                      dtype=torch.float32, device=xa.device)
    launch_rows_conv(xa, xb, w, bias, out, mode, k, seg_in)
    return out


rows_conv.launches = 0


# ---------------------------------------------------------------------------
# rows_conv_gn: a SAME conv with GroupNorm + Mish (+ te, + res) in its epilogue
# ---------------------------------------------------------------------------

def rows_conv_gn_plain(xa, xb, w, bias, k: int, seg_in: int, scale, gbias,
                       te=None, res=None, eps: float = 1e-5) -> torch.Tensor:
    """Plain version: rows_conv_plain (SAME), then gn_mish_plain per segment
    of ``seg_in`` rows (pallas_unet.py:198 with the adds of :281-293)."""
    y = rows_conv_plain(xa, xb, w, bias, SAME, k, seg_in)
    R, C = y.shape
    return gn_mish_plain(
        y.reshape(R // seg_in, seg_in, C), scale, gbias, N_GROUPS, eps, te=te,
        res=None if res is None else res.reshape(R // seg_in, seg_in, C)
    ).reshape(R, C)


def _split_k_gn(rows: int, cin: int, cout: int, k: int, seg: int,
                bf16: bool) -> Tuple[Tiling, GroupPlan]:
    """Tile, K splits and group blocks of a fused conv: :func:`_split_k`'s
    tile, or the largest smaller one whose group block fits the kernel's
    shared memory (only segments of more than 64 rows at 64-row tiles need
    that). Where :func:`_split_k` takes the wgmma tile, a fused conv takes
    ``WG_GN``, 128 columns and 3 stages (on the card the 256-wide tile lost
    at every fused pair of the 1,024-chain wave, and 3 stages matched 4),
    with one K split, and holds its pairs itself (a group block of one tile,
    :func:`conv_tiling.wg_gn_fits`); where it cannot, the conv takes the
    mma.sync tiles."""
    t = _split_k(rows, cin, cout, SAME, k, bf16)
    bn, stages = WG_GN
    if t.bm == WG_BM and wg_gn_fits(seg, cout, bn):
        t = wg_tiling(t.M, t.K, 1, cout, bn, 1, stages)
        return t, group_plan(rows, cout, seg, t.bm, t.bn)
    return _split_k_gn_mma(rows, cin, cout, k, seg, bf16)


def _split_k_gn_mma(rows: int, cin: int, cout: int, k: int, seg: int,
                    bf16: bool) -> Tuple[Tiling, GroupPlan]:
    """The mma.sync tile, K splits and group blocks of a fused conv."""
    t = _split_k_mma(rows, cin, cout, SAME, k, bf16)
    shapes = [s for s in (MMA_TILES if bf16 else (F32_TILE,))
              if s[0] * s[1] <= t.bm * t.bn]
    for bm, bn in sorted(shapes, key=lambda s: -s[0] * s[1]):
        g = group_plan(rows, cout, seg, bm, bn)
        if g.fits:
            if (bm, bn) != (t.bm, t.bn):
                tiles, k_tiles = -(-rows // bm) * -(-cout // bn), -(-t.K // BK)
                t = Tiling(bm, bn, tiles, even_splits(
                    k_tiles, _want_splits(tiles, k_tiles)), t.M, t.K, 1, cout)
            return t, g
    raise ValueError(f"rows_conv_gn: no tile holds a group block of {seg}-row "
                     f"segments and {cout // N_GROUPS}-channel groups")


def launch_rows_conv_gn(xa, xb, w, bias, out, k: int, seg_in: int, scale,
                        gbias, te, te_stride: int, res, gcounters,
                        stream=None, scratch=None, t: Optional[Tiling] = None,
                        g: Optional[GroupPlan] = None,
                        eps: float = 1e-5) -> None:
    """Launch the fused kernel on contiguous CUDA tensors (unchecked).
    ``gcounters``: zeroed int32, one per group block (``g.blocks``), left
    zeroed (None on a wgmma tile, which needs none); ``scratch`` as for
    :func:`launch_rows_conv`; ``te``: None or rows of cout at stride
    ``te_stride`` per segment."""
    cin_b = 0 if xb is None else xb.shape[1]
    rows, cout = xa.shape[0], w.shape[1]
    if t is None or g is None:
        t, g = _split_k_gn(rows, xa.shape[1] + cin_b, cout, k, seg_in,
                           w.dtype == torch.bfloat16)
    stream = cuda_lib.stream_of(xa) if stream is None else stream
    if t.bm == WG_BM:  # one split, no group counters
        rc = cuda_lib.lib("planner").rows_conv_gn_wg(
            xa.data_ptr(), _ptr(xb), xa.shape[1], cin_b, w.data_ptr(),
            bias.data_ptr(), out.data_ptr(), rows, seg_in, cout, k, t.bn,
            t.ring, scale.data_ptr(), gbias.data_ptr(), _ptr(te), te_stride,
            _ptr(res), eps, stream)
    else:
        rc = cuda_lib.lib("planner").rows_conv_gn(
            xa.data_ptr(), _ptr(xb), xa.shape[1], cin_b, w.data_ptr(),
            int(w.dtype == torch.bfloat16), bias.data_ptr(), out.data_ptr(),
            rows, seg_in, cout, k, t.bm, t.bn, t.splits,
            _ptr(_partial(xa, t, scratch)), scale.data_ptr(),
            gbias.data_ptr(), _ptr(te), te_stride, _ptr(res), eps, g.tiles_m,
            g.tiles_n, g.segs, g.groups, gcounters.data_ptr(), stream)
    cuda_lib.check(rc, "rows_conv_gn")
    rows_conv_gn.launches += 1


def rows_conv_gn(xa, xb, w, bias, k: int, seg_in: int, scale, gbias,
                 te=None, res=None) -> torch.Tensor:
    """SAME conv of [xa | xb] (as :func:`rows_conv`), then GroupNorm(8) +
    affine + Mish per segment of ``seg_in`` rows, then + ``te`` ((C,) for
    every segment, or (S, C)) and + ``res`` (like the output). Plain version
    on the CPU, the fused kernel on CUDA tensors."""
    if xa.device.type == "cpu":
        return rows_conv_gn_plain(xa, xb, w, bias, k, seg_in, scale, gbias,
                                  te, res)
    _check_conv(xa, xb, w, bias, SAME, k, seg_in, "rows_conv_gn")
    R, C = xa.shape[0], w.shape[1]
    for name, v, n in (("scale", scale, (C,)), ("gbias", gbias, (C,)),
                       ("te", te, (C, R // seg_in * C)), ("res", res, (R * C,))):
        if v is None:
            continue
        if v.dtype != torch.float32 or not v.is_contiguous() \
                or v.device != xa.device or v.numel() not in n:
            raise ValueError(f"rows_conv_gn: {name} must be contiguous float32"
                             f" on {xa.device} with {' or '.join(map(str, n))}"
                             " elements")
    t, g = _split_k_gn(R, xa.shape[1] + (0 if xb is None else xb.shape[1]), C,
                       k, seg_in, w.dtype == torch.bfloat16)
    out = torch.empty(R, C, dtype=torch.float32, device=xa.device)
    gcounters = None if t.bm == WG_BM else torch.zeros(
        g.blocks, dtype=torch.int32, device=xa.device)
    te_stride = 0 if te is None or te.numel() == C else C
    launch_rows_conv_gn(xa, xb, w, bias, out, k, seg_in, scale, gbias, te,
                        te_stride, res, gcounters, t=t, g=g)
    return out


rows_conv_gn.launches = 0


# ---------------------------------------------------------------------------
# ddpm_project_step: DDPM update + projection + wall revert + conditioning
# ---------------------------------------------------------------------------

class StepConfig:
    """Static options of the step: the TPU kernel bakes them at build."""

    def __init__(self, horizon: int, clip_denoised: bool = True,
                 predict_epsilon: bool = True, wall_grid=None,
                 wall_margin: Optional[float] = None, pos_stats=None):
        self.horizon = horizon
        self.clip_denoised = clip_denoised
        self.predict_epsilon = predict_epsilon
        self.wall_grid = None if wall_grid is None else np.asarray(
            wall_grid, np.int32)
        self.wall_margin = float(wall_margin or 0.0)
        if self.wall_grid is not None and pos_stats is None:
            raise ValueError("wall-aware step needs pos_stats")
        self.pos_stats = pos_stats
        self._grid_dev = {}

    def grid_on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._grid_dev:
            self._grid_dev[key] = torch.as_tensor(self.wall_grid,
                                                  device=device).contiguous()
        return self._grid_dev[key]


def ddpm_project_step_plain(x, eps, noise, scal_t, cond, M, b,
                            cfg: StepConfig) -> torch.Tensor:
    """Plain version (pallas_planner.py:230-249 with _project :156-204);
    ``cond`` None leaves row 0 unconditioned (pallas_unet.py:404)."""
    H = cfg.horizon
    R, D = x.shape
    recip, recipm1, c1, c2, sigma, alpha = scal_t[:6]
    xr = recip * x - recipm1 * eps if cfg.predict_epsilon else eps
    if cfg.clip_denoised:
        xr = xr.clamp(-1.0, 1.0)
    xn = c1 * xr + c2 * x + sigma * noise
    xp = xn
    if M is not None:
        flat = xn.reshape(-1, H * D)
        z = flat @ M + b.reshape(1, -1)
        xp = (alpha * z + (1.0 - alpha) * flat).reshape(R, D)
        if cfg.wall_grid is not None:
            (mx, my), (sx, sy) = cfg.pos_stats
            pos = torch.stack([xp[:, 0] * sx + mx, xp[:, 1] * sy + my], dim=-1)
            bad = wall_violation_mask(pos, cfg.grid_on(x.device),
                                      cfg.wall_margin)
            xp = torch.where(bad[:, None], xn, xp)
    if cond is None:
        return xp
    row0 = (torch.arange(R, device=x.device) % H == 0)[:, None]
    return torch.where(row0, cond, xp)


STEP_CHAINS = 8  # chains a block of the kernel updates at a time (kStepChains)


def ddpm_project_step_blocks(x, eps, noise, scal_t, cond, M, b,
                             cfg: StepConfig):
    """The kernel's partition walked on the CPU: block h owns trajectory row
    h of every chain; per group of STEP_CHAINS chains it takes the DDPM
    update of all their rows, then row h's D outputs as dot products over
    H*D split across 32 lanes (lane l adds terms l, l + 32, .. in order; a
    shuffle tree adds the lanes), the wall revert of row h and its
    conditioning. Reads ``x`` only and returns (out, cover), a new tensor
    and how often each of its elements was written."""
    H = cfg.horizon
    R, D = x.shape
    HD, C = H * D, R // H
    recip, recipm1, c1, c2, sigma, alpha = scal_t[:6]
    out = torch.full_like(x, float("nan")).reshape(C, H, D)
    cover = torch.zeros(C, H, D, dtype=torch.int64)
    xs, es, ns = (t.reshape(C, HD) for t in (x, eps, noise))
    wall = cfg.wall_grid is not None and M is not None
    for h in range(H):
        for c0 in range(0, C, STEP_CHAINS):
            cs = slice(c0, min(C, c0 + STEP_CHAINS))
            xr = recip * xs[cs] - recipm1 * es[cs] if cfg.predict_epsilon \
                else es[cs]
            if cfg.clip_denoised:
                xr = xr.clamp(-1.0, 1.0)
            xn = c1 * xr + c2 * xs[cs] + sigma * ns[cs]     # (nc, HD)
            row = xn[:, h * D:(h + 1) * D]
            xp = row
            if M is not None:
                terms = xn[:, :, None] * M[:, h * D:(h + 1) * D][None]
                lanes = torch.stack([terms[:, lane::32].sum(dim=1)
                                     for lane in range(32)], dim=1)  # (nc, 32, D)
                for width in (16, 8, 4, 2, 1):  # the shuffle-down tree
                    lanes = lanes[:, :width] + lanes[:, width:2 * width]
                z = lanes[:, 0] + b[h * D:(h + 1) * D]
                xp = alpha * z + (1.0 - alpha) * row
                if wall:
                    (mx, my), (sx, sy) = cfg.pos_stats
                    pos = torch.stack([xp[:, 0] * sx + mx, xp[:, 1] * sy + my],
                                      dim=-1)
                    bad = wall_violation_mask(pos, cfg.grid_on(x.device),
                                              cfg.wall_margin)
                    xp = torch.where(bad[:, None], row, xp)
            out[cs, h] = cond.reshape(C, H, D)[cs, 0] if h == 0 else xp
            cover[cs, h] += 1
    return out.reshape(R, D), cover.reshape(R, D)


def launch_ddpm_project_step(x, out, eps, noise, scal_t, cond, M, b,
                             cfg: StepConfig, stream=None) -> None:
    """Launch the kernel on contiguous float32 CUDA tensors, reading x and
    writing out (another buffer: every block reads all of x) (unchecked)."""
    R, D = x.shape
    H = cfg.horizon
    wall = cfg.grid_on(x.device) if (M is not None and
                                     cfg.wall_grid is not None) else None
    (mx, my), (sx, sy) = cfg.pos_stats or ((0.0, 0.0), (1.0, 1.0))
    gh, gw = cfg.wall_grid.shape if wall is not None else (0, 0)
    rc = cuda_lib.lib("planner").ddpm_project_step(
        x.data_ptr(), out.data_ptr(), eps.data_ptr(), noise.data_ptr(),
        scal_t.data_ptr(), cond.data_ptr(), _ptr(M), _ptr(b), R // H, H, D,
        int(cfg.clip_denoised), int(cfg.predict_epsilon), _ptr(wall), gh, gw,
        mx, my, sx, sy, cfg.wall_margin,
        cuda_lib.stream_of(x) if stream is None else stream)
    cuda_lib.check(rc, "ddpm_project_step")
    ddpm_project_step.launches += 1


def ddpm_project_step(x, eps, noise, scal_t, cond, M, b,
                      cfg: StepConfig) -> torch.Tensor:
    """One reverse step on (R, D) row-stacked chains of ``cfg.horizon`` rows:
    x' = cond at row 0, else [wall revert of] alpha*(xn@M+b)+(1-alpha)*xn with
    xn the DDPM update from scal_t = (recip, recipm1, c1, c2, sigma, alpha).
    Returns a new tensor: the plain version on the CPU, the kernel's output
    on CUDA."""
    if x.device.type == "cpu":
        return ddpm_project_step_plain(x, eps, noise, scal_t, cond, M, b, cfg)
    for t in (x, eps, noise, scal_t, cond, M, b):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()
                              or t.device != x.device):
            raise ValueError("ddpm_project_step: operands must be contiguous "
                             "float32 on one device")
    R, D = x.shape
    HD = cfg.horizon * D
    if R % cfg.horizon or eps.shape != x.shape or noise.shape != x.shape \
            or cond.shape != x.shape or scal_t.numel() < 6 or (
                M is not None and (M.shape != (HD, HD) or b.numel() != HD)):
        raise ValueError("ddpm_project_step: shapes do not match")
    out = torch.empty_like(x)
    launch_ddpm_project_step(x, out, eps, noise, scal_t, cond, M, b, cfg)
    return out


ddpm_project_step.launches = 0


# ---------------------------------------------------------------------------
# The chain: one host loop over steps and layer-plan ops
# ---------------------------------------------------------------------------

class _PlainOps:
    """The plain version of every kernel (CPU tensors)."""

    def begin(self, section: str) -> None:
        pass

    def conv(self, xa, xb, w, bias, mode, k, seg):
        return rows_conv_plain(xa, xb, w, bias, mode, k, seg)

    def conv_gn(self, xa, xb, w, bias, k, seg, scale, gbias, te=None,
                res=None):
        return rows_conv_gn_plain(xa, xb, w, bias, k, seg, scale, gbias, te,
                                  res)

    def step(self, x, eps, noise, scal_t, cond, M, b, cfg):
        return ddpm_project_step_plain(x, eps, noise, scal_t, cond, M, b, cfg)


class _CudaOps:
    """The kernels, launched on buffers the chain owns, so the per-launch
    checks of the public wrappers are skipped. Outputs come from a pool in
    launch order: the prologue's, and one denoise step's, which every step
    reuses; the step writes into the partner of its input, so a wave
    ping-pongs between two fixed buffers. Once a first wave has warmed the
    pool a wave allocates nothing, which capture in a CUDA graph needs. The
    split-K partial tiles of every conv share one scratch buffer, the output
    tiles of every conv one set of split-K counters, and the group blocks of
    every fused conv one set of group counters: the wave's launches run in
    stream order, and another wave (another chain) owns other buffers, so
    two waves may run on two streams at once."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool, self.section, self.cursor = {}, "", 0
        self.scratch = self.counters = self.gcounters = None
        self.partner = {}  # data_ptr of a step's input -> its output buffer

    @property
    def stream(self):
        """PyTorch's current stream (the capture stream under capture)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device).cuda_stream

    def begin(self, section: str) -> None:
        self.section, self.cursor = section, 0

    def _take(self, rows: int, cols: int) -> torch.Tensor:
        key = (self.section, self.cursor)
        self.cursor += 1
        buf = self.pool.get(key)
        if buf is None or buf.shape != (rows, cols):
            buf = self.pool[key] = torch.empty(
                rows, cols, dtype=torch.float32, device=self.device)
        return buf

    def _grow_scratch(self, t: Tiling) -> None:
        if self.scratch is None or self.scratch.numel() < t.partial_elems:
            self.scratch = torch.empty(t.partial_elems, dtype=torch.float32,
                                       device=self.device)

    def conv(self, xa, xb, w, bias, mode, k, seg):
        out = self._take(_conv_out_rows(xa.shape[0], mode), w.shape[1])
        t = _split_k(xa.shape[0],
                     xa.shape[1] + (0 if xb is None else xb.shape[1]),
                     w.shape[1], mode, k, w.dtype == torch.bfloat16)
        self._grow_scratch(t)
        if t.splits > 1 and (self.counters is None
                             or self.counters.numel() < t.tiles):
            self.counters = torch.zeros(t.tiles, dtype=torch.int32,
                                        device=self.device)
        launch_rows_conv(xa, xb, w, bias, out, mode, k, seg, self.stream,
                         self.scratch, t, self.counters)
        return out

    def conv_gn(self, xa, xb, w, bias, k, seg, scale, gbias, te=None,
                res=None):
        out = self._take(xa.shape[0], w.shape[1])
        t, g = _split_k_gn(xa.shape[0],
                           xa.shape[1] + (0 if xb is None else xb.shape[1]),
                           w.shape[1], k, seg, w.dtype == torch.bfloat16)
        self._grow_scratch(t)
        if t.bm != WG_BM and (self.gcounters is None
                              or self.gcounters.numel() < g.blocks):
            self.gcounters = torch.zeros(g.blocks, dtype=torch.int32,
                                         device=self.device)
        launch_rows_conv_gn(xa, xb, w, bias, out, k, seg, scale, gbias, te, 0,
                            res, None if t.bm == WG_BM else self.gcounters,
                            self.stream, self.scratch, t, g)
        return out

    def step(self, x, eps, noise, scal_t, cond, M, b, cfg):
        out = self.partner.get(x.data_ptr())
        if out is None:
            out = self.partner[x.data_ptr()] = torch.empty_like(x)
            self.partner[out.data_ptr()] = x
        launch_ddpm_project_step(x, out, eps, noise, scal_t, cond, M, b, cfg,
                                 self.stream)
        return out


def _program(unet, flat_w):
    """Group the flattened weights by layer-plan op."""
    plan, _ = _layer_plan(unet)
    it = iter(flat_w)

    def take(n):
        return tuple(next(it) for _ in range(n))

    prog = []
    for op in plan:
        kind = op[0]
        if kind == "res":
            _, _, cin, cout = op
            prog.append(("res", take(4), take(2), take(4),
                         take(2) if cin != cout else None))
        elif kind in ("down", "up", "final_conv"):
            prog.append((kind,) + take(2))
        elif kind == "res_plain":
            prog.append((kind, take(4)))
        else:
            prog.append((kind,))
    if next(it, None) is not None:
        raise ValueError("unconsumed flattened weights")
    return prog


def _unet_eps(ops, prog, x, tes, H: int, k: int):
    """One U-Net forward on (R, D) stacked chains of H rows
    (pallas_unet.py:258-331); ``tes``: this step's time-dense row per
    residual block."""
    seg, skips, pending, r = H, [], None, 0
    for op in prog:
        kind = op[0]
        if kind == "res":
            _, (w1, b1, s1, g1), _, (w2, b2, s2, g2), rconv = op
            h = ops.conv_gn(x, pending, w1, b1, k, seg, s1, g1, te=tes[r])
            r += 1
            res = x if rconv is None else ops.conv(x, pending, rconv[0],
                                                   rconv[1], SAME, 1, seg)
            x = ops.conv_gn(h, None, w2, b2, k, seg, s2, g2, res=res)
            pending = None
        elif kind == "push_skip":
            skips.append(x)
        elif kind == "pop_skip":
            pending = skips.pop()
        elif kind == "down":
            x = ops.conv(x, None, op[1], op[2], DOWN, 3, seg)
            seg //= 2
        elif kind == "up":
            x = ops.conv(x, None, op[1], op[2], UP, 4, seg)
            seg *= 2
        elif kind == "res_plain":
            w, b, s, g = op[1]
            x = ops.conv_gn(x, None, w, b, k, seg, s, g)
        elif kind == "final_conv":
            x = ops.conv(x, None, op[1], op[2], SAME, 1, seg)
    return x


def run_chain(ops, unet, flat_w, x0, m_embs, step_noise, scal, cond, M, b,
              cfg: StepConfig, out=None):
    """The chain's host loop on ``ops`` (the kernels, or their plain
    versions): time-dense rows for all steps, cond on x_T, then per step the
    U-Net and the projected DDPM update (pallas_planner.py:206-250). The
    iterate lives in ``out`` if given, else in a new tensor."""
    prog = _program(unet, flat_w)
    T, H = scal.shape[0], cfg.horizon
    D = x0.shape[1]
    # time-dense rows of every residual block for all T steps at once
    ops.begin("prologue")
    tes = [ops.conv(m_embs, None, op[2][0], op[2][1], SAME, 1, T)
           for op in prog if op[0] == "res"]
    x = x0.clone() if out is None else out.copy_(x0)
    if cond is not None:  # only the plain step takes an unconditioned chain
        x.view(-1, H, D)[:, 0] = cond.view(-1, H, D)[:, 0]
    for i in range(T):
        ops.begin("step")
        eps = _unet_eps(ops, prog, x, [te[i] for te in tes], H, unet.kernel_size)
        x = ops.step(x, eps, step_noise[i], scal[i], cond, M, b, cfg)
    if out is not None and x is not out:  # a new tensor, or the partner
        x = out.copy_(x)
    return x


def _launch_counts():
    return (rows_conv.launches, rows_conv_gn.launches,
            ddpm_project_step.launches)


def _set_launch_counts(counts) -> None:
    rows_conv.launches, rows_conv_gn.launches, ddpm_project_step.launches = \
        counts


class _WaveRunner:
    """The fixed buffers of one chain's waves and their CUDA graphs.

    ``run`` copies the caller's x_T, noise and conditioning into buffers
    whose addresses never change. The first wave on a set of prepared
    operands (flattened weights, time embeddings, step scalars, projection)
    is driven from the host, which also warms the pool of ``ops``; then the
    same loop is captured, and every later wave on those operands is one
    replay. Capture launches nothing, so the launches it counted are taken
    back, and every replay adds them to the wrappers' counts. The graphs of
    the last ``MAX_GRAPHS`` operand sets are kept (each holds its operands
    alive)."""

    MAX_GRAPHS = 4
    captures = 0  # graphs captured by every runner, ever

    def __init__(self, unet, cfg: StepConfig, ops, shape, T: int, device):
        R, D = shape
        self.unet, self.cfg, self.ops = unet, cfg, ops

        def new(*s):
            return torch.empty(*s, dtype=torch.float32, device=device)

        self.x0, self.cond, self.x = new(R, D), new(R, D), new(R, D)
        self.noise = new(T, R, D)
        self.graphs = {}   # operand addresses -> (replay, launches, operands)

    def _capture(self, wave):
        """Record ``wave`` in a CUDA graph; returns its replay."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            wave()
        _WaveRunner.captures += 1
        return graph.replay

    def run(self, flat_w, x0, m_embs, step_noise, scal, cond, M, b,
            graph: bool = True) -> torch.Tensor:
        """One wave; the result stays in a buffer the next wave overwrites."""
        self.x0.copy_(x0)
        self.noise.copy_(step_noise)
        self.cond.copy_(cond)

        def wave():
            run_chain(self.ops, self.unet, flat_w, self.x0, m_embs, self.noise,
                      scal, self.cond, M, b, self.cfg, out=self.x)

        operands = [*flat_w, m_embs, scal, M, b]
        key = tuple(None if t is None else t.data_ptr() for t in operands)
        if not graph:
            wave()
        elif key in self.graphs:
            replay, launches, _ = self.graphs[key]
            replay()
            _set_launch_counts(tuple(
                n + d for n, d in zip(_launch_counts(), launches)))
        else:
            wave()  # answers this call and warms the pool
            before = _launch_counts()
            replay = self._capture(wave)
            launches = tuple(a - c for a, c in zip(_launch_counts(), before))
            _set_launch_counts(before)
            if len(self.graphs) >= self.MAX_GRAPHS:
                del self.graphs[next(iter(self.graphs))]  # the oldest
            self.graphs[key] = (replay, launches, operands)
        return self.x


def make_planner_chain(unet, schedule, horizon: int, n_chains: int,
                       n_groups: int, *, sampling_timesteps: Optional[int] = None,
                       clip_denoised: bool = True, predict_epsilon: bool = True,
                       projection: bool = False, wall_grid=None,
                       wall_margin: Optional[float] = None, pos_stats=None):
    """Build ``chain(flat_w, x0, m_embs, step_noise, scal, cond[, M, b]) -> x``
    running ``n_groups * n_chains`` independent reverse chains
    (pallas_planner.py:95-302). Operands, with R = n_groups*n_chains*horizon:

      x0 (R, D), m_embs (T, time_dim), step_noise (T, R, D),
      scal (T, 8) lanes recip, recipm1, c1, c2, sigma, alpha,
      cond (R, D) (row 0 of each chain used), M (H*D, H*D), b (H*D,).

    The TPU walks groups one after another; here all chains of all groups run
    together, which gives the same result since chains are independent. The
    flattened weights' dtype (bf16 or f32) selects the product precision.

    On CUDA operands the wave runs on the chain's own buffers and, with
    ``graph=True``, from a CUDA graph captured at the first call on these
    prepared operands (:class:`_WaveRunner`); ``graph=False`` drives every
    launch from the host. Either way a new tensor is returned.
    """
    from dadiff_tpu_torch.models.diffusion import default_timesteps

    ts = default_timesteps(schedule.n_timesteps, sampling_timesteps)
    cfg = StepConfig(horizon, clip_denoised, predict_epsilon,
                     wall_grid if projection else None, wall_margin, pos_stats)
    H = horizon
    runners = {}

    @torch.no_grad()
    def chain(flat_w, x0, m_embs, step_noise, scal, cond, M=None, b=None,
              graph: bool = True):
        T = scal.shape[0]
        R, D = x0.shape
        if R != n_groups * n_chains * H or step_noise.shape != (T, R, D) \
                or cond.shape != (R, D) or (projection and M is None):
            raise ValueError("planner chain: operand shapes do not match")
        if not projection:
            M = b = None
        if x0.device.type == "cpu":
            return plain(flat_w, x0, m_embs, step_noise, scal, cond, M, b)
        acts = [t for t in (x0, m_embs, step_noise, scal, cond, M, b)
                if t is not None]
        if any(t.dtype != torch.float32 for t in acts) or any(
                w.dtype not in (torch.float32, torch.bfloat16)
                for w in flat_w) or any(
                not t.is_contiguous() or t.device != x0.device
                for t in acts + list(flat_w)):
            raise ValueError("planner chain: operands must be contiguous "
                             "on one device, float32 (weights f32 or bf16)")
        key = (str(x0.device), T, D)
        if key not in runners:
            runners[key] = _WaveRunner(unet, cfg, _CudaOps(x0.device), (R, D),
                                       T, x0.device)
        return runners[key].run(flat_w, x0, m_embs, step_noise, scal, cond,
                                M, b, graph).clone()

    @torch.no_grad()
    def plain(flat_w, x0, m_embs, step_noise, scal, cond, M=None, b=None):
        """The chain's plain version on the same operands, on their device:
        the same rounding points, PyTorch ops for the kernels."""
        return run_chain(_PlainOps(), unet, flat_w, x0, m_embs, step_noise,
                         scal, cond, M if projection else None,
                         b if projection else None, cfg)

    chain.timesteps = ts
    chain.n_steps = len(ts)
    chain.plain = plain
    return chain


# ---------------------------------------------------------------------------
# Projection operands, best-of-N sampler and policy wiring
# ---------------------------------------------------------------------------

def build_interleaved_projection(P, stats: NormStats, *, observation_dim: int,
                                 action_dim: int, state_dim: int, horizon: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse apply_projection (alpha=1, no walls) into one affine map on
    the flattened normalized trajectory, project(x) == x_flat @ M + b, built
    from apply_projection itself on the standard basis in float64 and cast
    to float32 (pallas_planner.py:53-86). M is (H*D, H*D), b (H*D,)."""
    D = observation_dim + action_dim
    HD = horizon * D
    def f64(v):
        v = v.detach().cpu() if torch.is_tensor(v) else np.asarray(v)
        return torch.as_tensor(v, dtype=torch.float64)

    P64 = f64(P)
    st64 = NormStats(*(f64(v) for v in stats))

    def f(x_flat):
        out = apply_projection(
            x_flat.reshape(-1, horizon, D), P64, 1.0, st64,
            observation_dim=observation_dim, action_dim=action_dim,
            state_dim=state_dim,
        )
        return out.reshape(-1, HD)

    b = f(torch.zeros(1, HD, dtype=torch.float64))[0]
    M = f(torch.eye(HD, dtype=torch.float64)) - b[None, :]
    return M.to(torch.float32), b.to(torch.float32)


def make_bo_sampler(diffusion, *, projection_spec=None, P=None,
                    stats: Optional[NormStats] = None, n_candidates: int = 8,
                    group_chains: int = 64,
                    sampling_timesteps: Optional[int] = None,
                    weight_dtype=torch.bfloat16):
    """Best-of-N planner through the planner chain (pallas_planner.py:305):
    ``plan(generator, conditions) -> (B, H, D)``, the best plan per episode
    stream by physical-space goal distance. ``plan.prepare()`` computes the
    flattened weights and per-step operands once; pass its result back as
    ``prepared``: on the card the wave of prepared operands is captured in
    a CUDA graph at its first plan and replayed afterwards, while a plan
    without them prepares anew and drives its wave from the host.
    ``x0``/``step_noise`` inject the randomness; without them a plan of B
    streams takes ``plan.draw(generator, B)``, and ``plan.stack_draws(draws,
    B)`` lays B streams' own draws out as the wave of B streams takes them
    (a micro-batched server, serving.py)."""
    from dadiff_tpu_torch.models.diffusion import default_timesteps
    from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

    if not isinstance(diffusion.model, TemporalUnet):
        # the JAX package builds the wave for any denoiser and fails at its
        # first plan (pallas_unet.py:137, KeyError: 'mid_block1')
        raise ValueError(
            f"--megakernel runs the TemporalUnet's layer program only; a "
            f"{type(diffusion.model).__name__} plans through the module "
            f"path (guides/sampling.py): drop --megakernel")
    if diffusion.prediction == "v":
        raise NotImplementedError(
            "the planner chain reads the model output as epsilon or x0; a "
            "v-model needs the module path (guides/sampling.py)")
    unet = diffusion.model
    device = diffusion.device
    H, D = diffusion.horizon, diffusion.transition_dim
    obs_dim = diffusion.observation_dim
    use_projection = (projection_spec is not None
                      and not projection_spec.parity_mode)

    M = b = None
    pos_stats = wall_grid = None
    if use_projection:
        if P is None or stats is None:
            raise ValueError("projection needs P and stats at build time")
        M, b = build_interleaved_projection(
            P, stats,
            observation_dim=obs_dim, action_dim=diffusion.action_dim,
            state_dim=projection_spec.state_dim, horizon=H,
        )
        M, b = M.to(device), b.to(device)
        if projection_spec.wall_grid is not None:
            wall_grid = np.asarray(projection_spec.wall_grid)
            pos_stats = (
                (float(stats.obs_mean[0]), float(stats.obs_mean[1])),
                (float(stats.obs_std[0]), float(stats.obs_std[1])),
            )
    chains = {}
    n_steps = len(default_timesteps(diffusion.n_timesteps, sampling_timesteps))

    def _layout(n_streams):
        """Chains per group, groups, and all chains with the pad."""
        C_tot = n_streams * n_candidates
        Ng = min(group_chains, C_tot)
        G = -(-C_tot // Ng)
        return Ng, G, G * Ng

    def _get_chain(n_chains, n_groups):
        key = (n_chains, n_groups)
        if key not in chains:
            chains[key] = make_planner_chain(
                unet, diffusion.schedule, H, n_chains, n_groups,
                sampling_timesteps=sampling_timesteps,
                clip_denoised=diffusion.clip_denoised,
                predict_epsilon=diffusion.predict_epsilon,
                projection=use_projection, wall_grid=wall_grid,
                wall_margin=projection_spec.wall_margin if use_projection
                else None,
                pos_stats=pos_stats,
            )
        return chains[key]

    def prepare():
        schedule = diffusion.schedule
        ts = default_timesteps(schedule.n_timesteps, sampling_timesteps, device)
        flat_w, m_embs, scal = prepare_chain_operands(unet, schedule, ts,
                                                      weight_dtype)
        if use_projection:
            scal[:, 5] = projection_alpha(
                ts, diffusion.n_timesteps, projection_spec.schedule,
                projection_spec.strength, schedule.betas)
        return flat_w, m_embs, scal

    def plan(generator, conditions, prepared=None, *, x0=None, step_noise=None):
        values = conditions[0]
        if not torch.is_tensor(values):
            values = torch.as_tensor(np.asarray(values))
        # a tensor on the device stays there: no transfer, no host sync
        values = values.to(device=device, dtype=torch.float32)
        if values.dim() == 2:
            values = values[None]
        B = values.shape[0]
        C_tot = B * n_candidates
        Ng, G, C_pad = _layout(B)
        flat_w, m_embs, scal = prepared if prepared is not None else prepare()
        if x0 is None or step_noise is None:
            drawn = draw(generator, B)
            x0 = drawn[0] if x0 is None else x0
            step_noise = drawn[1] if step_noise is None else step_noise
        cond = torch.cat([values.repeat_interleave(n_candidates, dim=0),
                          values.new_zeros(C_pad - C_tot, H, D)]
                         ).reshape(C_pad * H, D)
        # operands prepared for this call alone will not come back: no graph
        out = _get_chain(Ng, G)(flat_w, x0.to(device).contiguous(), m_embs,
                                step_noise.to(device).contiguous(), scal, cond,
                                M, b, graph=prepared is not None)
        plans = out[: C_tot * H].reshape(B, n_candidates, H, D)
        # physical-space goal distance (pallas_planner.py:427-442)
        gd = obs_dim - 2
        if stats is not None:
            pos_m, pos_s = stats.obs_mean[:2], stats.obs_std[:2]
            goal_m, goal_s = stats.obs_mean[gd:obs_dim], stats.obs_std[gd:obs_dim]
        else:
            pos_m = goal_m = torch.zeros(2, device=device)
            pos_s = goal_s = torch.ones(2, device=device)
        final_pos = plans[:, :, -1, 0:2] * pos_s + pos_m
        goal = values[:, 0, gd:obs_dim] * goal_s + goal_m
        d = torch.linalg.norm(final_pos - goal[:, None, :], dim=-1)
        best = torch.argmin(d, dim=1)
        return plans[torch.arange(B, device=device), best]

    def draw(generator, n_streams: int = 1):
        """x_T and step noise of a plan of ``n_streams`` streams (all chains
        of its wave, the pad included): the draws :func:`plan` takes from
        ``generator`` when none are injected."""
        rows = _layout(n_streams)[2] * H
        x0 = torch.randn(rows, D, generator=generator, device=device)
        return x0, torch.randn(n_steps, rows, D, generator=generator,
                               device=device)

    def stack_draws(draws, n_streams: int):
        """The wave's x_T and step noise of ``n_streams`` streams from their
        :func:`draw` results (fewer draws than streams: the rest of the
        wave, like the pad chains, is zeros). Chains are independent, so a
        stream's plan does not depend on the other streams' draws."""
        rows = n_candidates * H
        wave_rows = _layout(n_streams)[2] * H
        x0 = torch.zeros(wave_rows, D, device=device)
        step_noise = torch.zeros(n_steps, wave_rows, D, device=device)
        for i, (x, n) in enumerate(draws):
            x0[i * rows:(i + 1) * rows] = x[:rows]
            step_noise[:, i * rows:(i + 1) * rows] = n[:, :rows]
        return x0, step_noise

    def chain_of(n_streams: int):
        """The planner chain of the wave of ``n_streams`` streams and its
        projection operands (M, b): a check runs the chain's plain version
        (``chain.plain``) on a wave's own operands."""
        return _get_chain(*_layout(n_streams)[:2]), (M, b)

    plan.uses_projection = use_projection
    plan.prepare = prepare
    plan.chain_of = chain_of
    plan.draw = draw
    plan.stack_draws = stack_draws
    return plan


def wire_policy_megakernel(policy, *, n_candidates: int,
                           group_chains: int = 64):
    """Route a policy's replans through the planner chain: one chain call per
    replan wave (all candidates, conditioning, per-step projection), then
    best-of-N selection; ``policy.n_candidates`` becomes 1
    (pallas_planner.py:449-494). Weights are bf16 on the card and f32 on the
    CPU, as the TPU path takes bf16 and its interpret mode f32. The chain is
    the DDPM sampler alone: another sampler, guidance or warm start raises
    (pallas_planner.py:465-470), never routed quietly to the module path; so
    does a denoiser other than the U-Net (``make_bo_sampler``).
    The replan function carries the sampler (``.sampler``) and its prepared
    operands (``.prepared()``), which a micro-batched server shares."""
    cfg = policy._sampler_config
    if cfg["sampler"] != "ddpm":
        raise ValueError("--megakernel supports the ddpm sampler only")
    if cfg["guide_fn"] is not None and cfg["guide_weight"]:
        raise ValueError("--megakernel does not support gradient guidance")
    if cfg["warm_start_from"] or getattr(policy, "warm_start_auto", False):
        raise ValueError("--megakernel does not compose with warm start")
    cpu = policy.diffusion.device.type == "cpu"
    mega = make_bo_sampler(
        policy.diffusion,
        projection_spec=cfg["projection"],
        P=getattr(policy, "_P", None),
        stats=getattr(policy, "_stats", None),
        n_candidates=n_candidates,
        group_chains=group_chains,
        sampling_timesteps=cfg["sampling_timesteps"],
        weight_dtype=torch.float32 if cpu else torch.bfloat16,
    )
    box = {}

    def prepared():
        if "prep" not in box:
            box["prep"] = mega.prepare()
        return box["prep"]

    def plan(generator, conditions, P=None, stats_=None):
        return mega(generator, conditions, prepared())

    plan.sampler, plan.prepared = mega, prepared
    policy._plan = plan
    policy.n_candidates = 1
    policy.megakernel = True
    return policy
