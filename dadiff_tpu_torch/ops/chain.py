"""K3: the whole batch-1 reverse chain as ONE kernel launch, a hand-written
CUDA kernel (``csrc/chain.cu``).

Counterpart of the JAX package's ops/pallas_unet.py: make_pallas_chain :334
(``pallas_call`` :437, body ``kernel`` :362, ``_unet_forward`` :258) and
pallas_p_sample_loop :481. It reuses the planner chain's host side:
``flatten_unet_params`` and ``prepare_chain_operands``
(ops/chain_operands.py) and the layer plan (``_program`` of ops/planner.py).

What this kernel is, against the planner chain of ops/planner.py, is the
single launch: the host writes a *layer program* (one :class:`ChainOp` per
conv, GroupNorm+Mish, DDPM step) to device memory and launches one
persistent cooperative kernel that walks it, once for the prologue (x_T
conditioning and the time-dense rows of all T steps, computed inside the same
launch) and once per denoise step, with a grid-wide barrier between dependent
ops. Every conv is split over K (at most ``MAX_FAN_IN`` ways) into items that
run the tile product of ``csrc/common.cuh``, the one ``rows_conv`` runs, and
its consumer (a GroupNorm, the DDPM step) sums the partial tiles in a fixed
order, so a chain repeats bit for bit; where the consumer is another conv,
the last item of a tile to arrive sums it and writes the conv's output. The
partial tiles and the tiles' arrival counters live in buffers of the chain's
own, not in the per-device split-K counters of ``rows_conv``.

On the CPU the chain runs its plain version, :func:`chain_plain`: the planner
chain's host loop on the plain version of every kernel, one chain, no
projection. On
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dadiff_tpu_torch.ops import cuda_lib
from dadiff_tpu_torch.ops.chain_operands import prepare_chain_operands
from dadiff_tpu_torch.ops.conv_tiling import DOWN, SAME, UP, Tiling, tiling
from dadiff_tpu_torch.ops.planner import (
    StepConfig, _PlainOps, _program, run_chain,
)

_PTRS = ("xa", "xb", "w", "bias", "partial", "scale", "gbias", "te", "res",
         "res_partial", "res_bias", "out", "noise", "scal", "cond", "counters")
_INTS = ("kind", "sync_after", "rot", "cin_a", "cin_b", "rows_in", "seg_in",
         "cout", "mode", "k", "w_bf16", "splits", "res_splits", "te_stride",
         "clip", "predict_eps", "groups", "bm", "bn", "te_seg_stride")
CONV, GN, STEP, INIT = range(4)  # ChainOp.kind, as in csrc/program.cuh
_GROUPS = 8
# blocks of the persistent kernel per SM: a grid barrier costs less with fewer
_BLOCKS_PER_SM = 1
# most K splits of a conv: what its consumer sums per value, and loads in one
# round trip to L2 (csrc/common.cuh kBatch)
MAX_FAN_IN = 16


class ChainOp(ctypes.Structure):
    """One op of the layer program; the struct of the same name in
    csrc/program.cuh."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in _INTS])


def chain_plain(unet, flat_w, x0, m_embs, step_noise, scal, cond,
                cfg: StepConfig) -> torch.Tensor:
    """Plain version of the chain on any device: x0 (H, D), step_noise
    (T, H, D), cond (H, D) or None -> (H, D)."""
    with torch.no_grad():
        return run_chain(_PlainOps(), unet, flat_w, x0, m_embs, step_noise,
                         scal, cond, None, None, cfg)


def device_limits(device, name: str = "chain") -> Tuple[int, int]:
    """(co-resident blocks per SM, SM count) of the persistent kernel of
    library ``name`` (``chain``: K3, ``resblock``: K4); raises if the device
    cannot launch it cooperatively."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        cuda_lib.check(getattr(cuda_lib.lib(name), f"{name}_limits")(out),
                       f"{name}_limits")
    per_sm, n_sm, coop, size = out
    if not coop or per_sm < 1:
        raise RuntimeError(f"the {name} kernel needs a device that can launch "
                           "cooperatively with at least one block per SM")
    if size != ctypes.sizeof(ChainOp):
        raise RuntimeError(f"ChainOp is {ctypes.sizeof(ChainOp)} bytes here "
                           f"and {size} in csrc/{name}.cu")
    return per_sm, n_sm


def grid_size(device, name: str = "chain") -> int:
    """Blocks of a cooperative launch of library ``name``'s kernel:
    ``_BLOCKS_PER_SM`` on every SM, as far as they are co-resident."""
    per_sm, n_sm = device_limits(device, name)
    return min(per_sm, _BLOCKS_PER_SM) * n_sm


PROFILE_SLOTS = ("conv", "gn", "step", "init", "barrier")


def launch_chain(prog: torch.Tensor, n_pre: int, n_step: int, T: int,
                 grid: int, prof: Optional[torch.Tensor] = None,
                 stream=None) -> None:
    """One cooperative launch of the program (unchecked). ``prof``: zeroed
    int64 tensor of ``len(PROFILE_SLOTS)`` on the device, which receives the
    clock cycles one thread of block 0 spent in each kind of op and at the
    barriers."""
    rc = cuda_lib.lib("chain").chain_run(
        prog.data_ptr(), n_pre, n_step, T, grid,
        None if prof is None else prof.data_ptr(),
        cuda_lib.stream_of(prog) if stream is None else stream)
    cuda_lib.check(rc, "chain")
    launch_chain.launches += 1


launch_chain.launches = 0


class _ProgramBuilder:
    """Lays the U-Net's layer plan out as ChainOps over buffers it owns.
    An operand may be a tensor or anything with ``shape`` and ``data_ptr()``
    (ops/resblock.py's placeholders, patched in at launch)."""

    def __init__(self, device, grid: int, groups: int = _GROUPS):
        self.device, self.grid, self.groups = device, grid, groups
        self.ops, self.keep = [], []
        self.region_elems = [0, 0]    # partials of main convs, of 1x1 residuals
        self.patches = []             # (op, field, region) resolved by finish
        self.counted = []             # (op, first of its tiles' counters)
        self.n_counters = 0
        self.rot = 0                  # items already given out in this phase

    def buf(self, *shape) -> torch.Tensor:
        t = torch.empty(*shape, dtype=torch.float32, device=self.device)
        self.keep.append(t)
        return t

    def emit(self, kind: int, sync: bool, region=None, res_region=None,
             **fields) -> ChainOp:
        """Append an op; ``region``/``res_region`` name the partial region it
        writes or reads, whose address is known once all ops are laid out."""
        op = ChainOp(kind=kind, sync_after=int(sync), groups=self.groups)
        for name, v in fields.items():
            setattr(op, name, v.data_ptr() if hasattr(v, "data_ptr") else v)
        if region is not None:
            self.patches.append((op, "partial", region))
        if res_region is not None:
            self.patches.append((op, "res_partial", res_region))
        self.ops.append(op)
        return op

    def tiling_for(self, rows: int, cin: int, w, mode: int, k: int) -> Tiling:
        """Tile and K splits of a conv: the splits that bring its items to
        about one per block, none of them empty, at most MAX_FAN_IN."""
        return tiling(rows, cin, w.shape[1], mode, k,
                      w.dtype == torch.bfloat16, self.grid,
                      lambda tiles, k_tiles: min(self.grid // tiles,
                                                 MAX_FAN_IN))

    def conv(self, xa, xb, w, mode: int, k: int, seg: int, *, region=0,
             partial=None, sync=True, out=None, bias=None) -> int:
        """A conv split over K into partial tiles, in ``partial`` or in a
        shared region; returns its splits, which its consumer needs. With
        ``out`` (and the conv's ``bias``) the last item of each tile to
        arrive sums the tile into ``out``: for a conv that feeds a conv."""
        cin_b = 0 if xb is None else xb.shape[1]
        t = self.tiling_for(xa.shape[0], xa.shape[1] + cin_b, w, mode, k)
        if partial is None:
            self.region_elems[region] = max(self.region_elems[region],
                                            t.partial_elems)
        op = self.emit(
            CONV, sync, region=None if partial is not None else region,
            xa=xa, xb=xb, w=w, partial=partial, cin_a=xa.shape[1],
            cin_b=cin_b, rows_in=xa.shape[0], seg_in=seg, cout=w.shape[1],
            mode=mode, k=k, w_bf16=int(w.dtype == torch.bfloat16),
            splits=t.splits, bm=t.bm, bn=t.bn, rot=self.rot % self.grid,
            out=out, bias=bias)
        if out is not None:
            self.counted.append((op, self.n_counters))
            self.n_counters += t.tiles
        self.rot = 0 if sync else self.rot + t.tiles * t.splits
        return t.splits

    def gn(self, splits: int, bias, scale, gbias, rows: int, seg: int, C: int,
           sync: bool = True, out=None, **extra):
        """GroupNorm + Mish of (bias + the partials in region 0) per
        (segment, group), into ``out`` or a new buffer, which it returns."""
        out = self.buf(rows, C) if out is None else out
        self.emit(GN, sync, region=0, splits=splits, bias=bias, scale=scale,
                  gbias=gbias, rows_in=rows, seg_in=seg, cout=C, out=out,
                  **extra)
        return out

    def res_block(self, x, xb, w1, b1, s1, g1, w2, b2, s2, g2, rconv, k: int,
                  seg: int, te, te_stride: int, te_seg_stride: int,
                  h=None, out=None, sync: bool = True):
        """One ResidualTemporalBlock on x (rows, cin) [| xb]: conv1 and the
        1x1 residual conv ``rconv`` = (wr, br) or None in one phase, GN + te
        (row ``step * te_stride + segment * te_seg_stride``) into ``h``,
        conv2, GN + residual into ``out`` (``h``, ``out``: new buffers if
        None); ``sync``: a barrier after the last op. Returns the output."""
        rows, cout = x.shape[0], w1.shape[1]
        if rconv is None and xb is not None:
            raise ValueError("chain: an identity residual cannot follow "
                             "a skip concat")
        # conv1 and the 1x1 residual conv both read x: one phase
        sp1 = self.conv(x, xb, w1, SAME, k, seg, sync=rconv is None)
        if rconv is not None:
            spr = self.conv(x, xb, rconv[0], SAME, 1, seg, region=1)
        h = self.gn(sp1, b1, s1, g1, rows, seg, cout, out=h, te=te,
                    te_stride=te_stride, te_seg_stride=te_seg_stride)
        sp2 = self.conv(h, None, w2, SAME, k, seg)
        if rconv is None:
            return self.gn(sp2, b2, s2, g2, rows, seg, cout, sync, out, res=x)
        return self.gn(sp2, b2, s2, g2, rows, seg, cout, sync, out,
                       res_region=1, res_bias=rconv[1], res_splits=spr)

    def place(self, regions) -> None:
        """Patch the addresses of the partial regions into the ops."""
        for op, field, region in self.patches:
            setattr(op, field, regions[region])

    def finish(self) -> torch.Tensor:
        """Allocate the partial regions, patch their addresses in and return
        the program as a uint8 tensor on the device."""
        self.place([self.buf(max(n, 1)).data_ptr() for n in self.region_elems])
        counters = torch.zeros(max(self.n_counters, 1), dtype=torch.int32,
                               device=self.device)
        self.keep.append(counters)
        for op, first in self.counted:
            op.counters = counters.data_ptr() + 4 * first
        raw = bytearray(b"".join(bytes(op) for op in self.ops))
        return torch.frombuffer(raw, dtype=torch.uint8).to(self.device)


def _build_program(unet, flat_w, x0, m_embs, step_noise, scal, cond,
                   cfg: StepConfig, grid: int):
    """The layer program of one chain: (program tensor, n_pre, n_step, grid
    barriers per launch, x, tensors to keep alive)."""
    b = _ProgramBuilder(x0.device, grid)
    prog = _program(unet, flat_w)
    T, H, D, k = scal.shape[0], cfg.horizon, x0.shape[1], unet.kernel_size
    x = b.buf(H, D)

    # -- prologue: x = x_T (row 0 conditioned), time-dense rows of all steps;
    # every table has its own partials and counters, so the convs need no
    # barrier between
    b.emit(INIT, False, xa=x0, cond=cond, out=x, rows_in=H, seg_in=H, cout=D)
    dense = [op[2] for op in prog if op[0] == "res"]
    tables = []
    for i, (wt, bt) in enumerate(dense):
        t = b.tiling_for(T, wt.shape[0], wt, SAME, 1)
        tables.append(b.buf(T, wt.shape[1]))
        b.conv(m_embs, None, wt, SAME, 1, T, partial=b.buf(t.partial_elems),
               sync=i == len(dense) - 1, out=tables[-1], bias=bt)
    n_pre = len(b.ops)

    # -- one denoise step (the walk of planner._unet_eps)
    cur, seg, skips, pending, r = x, H, [], None, 0
    for op in prog:
        kind = op[0]
        if kind == "res":
            _, (w1, b1, s1, g1), _, (w2, b2, s2, g2), rconv = op
            # one time row per step, the same for the chain's one segment
            cur = b.res_block(cur, pending, w1, b1, s1, g1, w2, b2, s2, g2,
                              rconv, k, seg, tables[r], w1.shape[1], 0)
            r += 1
            pending = None
        elif kind == "push_skip":
            skips.append(cur)
        elif kind == "pop_skip":
            pending = skips.pop()
        elif kind in ("down", "up"):
            mode, kk = (DOWN, 3) if kind == "down" else (UP, 4)
            out = b.buf(seg // 2 if kind == "down" else seg * 2,
                        op[1].shape[1])
            b.conv(cur, None, op[1], mode, kk, seg, out=out, bias=op[2])
            cur, seg = out, out.shape[0]
        elif kind == "res_plain":
            w, bias, s, g = op[1]
            sp = b.conv(cur, None, w, SAME, k, seg)
            cur = b.gn(sp, bias, s, g, seg, seg, w.shape[1])
        elif kind == "final_conv":
            sp = b.conv(cur, None, op[1], SAME, 1, seg)
            b.emit(STEP, True, region=0, splits=sp, bias=op[2], out=x,
                   noise=step_noise, scal=scal, cond=cond, rows_in=H, seg_in=H,
                   cout=D, clip=int(cfg.clip_denoised),
                   predict_eps=int(cfg.predict_epsilon))
    n_step = len(b.ops) - n_pre
    syncs = (sum(op.sync_after for op in b.ops[:n_pre])
             + T * sum(op.sync_after for op in b.ops[n_pre:]))
    return b.finish(), n_pre, n_step, syncs, x, b.keep


def make_chain(unet, schedule, horizon: int, *,
               sampling_timesteps: Optional[int] = None,
               clip_denoised: bool = True, predict_epsilon: bool = True,
               condition_row0: bool = False):
    """Build ``chain(flat_w, x0, m_embs, step_noise, scal[, cond]) -> x``
    running the full T-step reverse diffusion of one chain
    (pallas_unet.py:334-451). Operands: x0 (H, D), m_embs (T, time_dim),
    step_noise (T, H, D), scal (T, 8) lanes recip, recipm1, c1, c2, sigma,
    cond (H, D) whose row 0 is inpainted into x_T and after every step. The
    flattened weights' dtype (bf16 or f32) selects the product precision.

    ``chain.bind(...)`` takes the same operands (on the card), writes the
    layer program once and returns ``launch(prof=None) -> x``: each call is
    one kernel launch, reading the operands as they are then and writing the
    same output buffer (``prof`` as in :func:`launch_chain`).
    """
    from dadiff_tpu_torch.models.diffusion import default_timesteps

    ts = default_timesteps(schedule.n_timesteps, sampling_timesteps)
    cfg = StepConfig(horizon, clip_denoised, predict_epsilon)
    H = horizon

    def _check(flat_w, x0, m_embs, step_noise, scal, cond):
        T, D = scal.shape[0], x0.shape[1]
        if x0.shape != (H, D) or step_noise.shape != (T, H, D) \
                or m_embs.shape[0] != T or scal.shape != (T, 8) \
                or (cond is None) == condition_row0 \
                or (cond is not None and cond.shape != (H, D)):
            raise ValueError("chain: operand shapes do not match")
        if x0.device.type == "cpu":
            return
        acts = [t for t in (x0, m_embs, step_noise, scal, cond)
                if t is not None]
        if any(t.dtype != torch.float32 for t in acts) or any(
                w.dtype not in (torch.float32, torch.bfloat16)
                for w in flat_w) or any(
                not t.is_contiguous() or t.device != x0.device
                for t in acts + list(flat_w)):
            raise ValueError("chain: operands must be contiguous on one "
                             "device, float32 (weights f32 or bf16)")

    def bind(flat_w, x0, m_embs, step_noise, scal, cond=None):
        _check(flat_w, x0, m_embs, step_noise, scal, cond)
        if x0.device.type == "cpu":
            raise ValueError("chain.bind: the kernel needs CUDA tensors")
        grid = grid_size(x0.device)
        prog, n_pre, n_step, syncs, x, keep = _build_program(
            unet, flat_w, x0, m_embs, step_noise, scal, cond, cfg, grid)
        keep += [prog, x0, m_embs, step_noise, scal, cond, *flat_w]
        T = scal.shape[0]

        def launch(prof=None):
            launch_chain(prog, n_pre, n_step, T, grid, prof)
            return x

        launch.keep, launch.grid, launch.syncs = keep, grid, syncs
        launch.n_ops = (n_pre, n_step)
        return launch

    @torch.no_grad()
    def chain(flat_w, x0, m_embs, step_noise, scal, cond=None):
        _check(flat_w, x0, m_embs, step_noise, scal, cond)
        if x0.device.type == "cpu":
            return chain_plain(unet, flat_w, x0, m_embs, step_noise, scal,
                               cond, cfg)
        return bind(flat_w, x0, m_embs, step_noise, scal, cond)()

    chain.bind = bind
    chain.timesteps = ts
    chain.n_steps = len(ts)
    chain.config = cfg
    return chain


@torch.no_grad()
def chain_p_sample_loop(unet, schedule, shape: Tuple[int, int, int], *,
                        generator: Optional[torch.Generator] = None,
                        sampling_timesteps: Optional[int] = None,
                        weight_dtype=torch.bfloat16,
                        init_noise: Optional[torch.Tensor] = None,
                        step_noise: Optional[torch.Tensor] = None,
                        clip_denoised: bool = True,
                        predict_epsilon: bool = True,
                        cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-1 equivalent of ``GaussianDiffusion.p_sample_loop`` running the
    entire chain as one kernel launch; shape = (1, H, D)
    (pallas_unet.py:481-529). ``cond``: optional (H, D) or (1, H, D) whose
    row 0 is inpainted into every iterate, the initial one included."""
    if shape[0] != 1:
        raise ValueError("the one-launch chain is the batch-1 latency path")
    _, H, D = shape
    device = schedule.betas.device
    chain = make_chain(unet, schedule, H,
                       sampling_timesteps=sampling_timesteps,
                       clip_denoised=clip_denoised,
                       predict_epsilon=predict_epsilon,
                       condition_row0=cond is not None)
    ts = chain.timesteps.to(device)
    T = chain.n_steps
    x = (torch.randn(shape, generator=generator, device=device)
         if init_noise is None else init_noise.to(device))
    if step_noise is None:
        step_noise = torch.randn((T,) + tuple(shape), generator=generator,
                                 device=device)
    flat_w, m_embs, scal = prepare_chain_operands(unet, schedule, ts,
                                                  weight_dtype)
    if cond is not None:
        cond = torch.as_tensor(cond, dtype=torch.float32, device=device
                               ).reshape(H, D).contiguous()
    out = chain(flat_w, x[0].to(torch.float32).contiguous(), m_embs,
                step_noise.to(device)[:, 0].to(torch.float32).contiguous(),
                scal, cond)
    return out[None]
