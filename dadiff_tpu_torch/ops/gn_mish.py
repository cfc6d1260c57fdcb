"""K1: fused GroupNorm(8) + Mish, forward and backward, hand-written CUDA
kernels (``csrc/gn_mish.cu``).

Counterpart of the JAX package's ops/pallas_kernels.py:84 ``group_norm_mish_pallas``
(its body ``_gn_mish_kernel`` :56, its ``custom_vjp`` :118-139, whose backward
``_gn_bwd`` :130 is the XLA vjp of the reference) and of the per-chain GN+Mish
stage of the planner chain (pallas_unet.py:198-240).

Two layouts: the JAX package's feature-last ``(S, L, C)`` and the conv's own
channels-first ``(S, C, L)`` (``channels_first=True``), so that a caller
holding a conv's output needs no layout copy. S segments (batch rows or
stacked chains) of L positions; statistics are per segment and group over
(L, C/8), with var = E[x^2] - mean^2 and eps 1e-5. Optional epilogue adds:
``te`` (one row per segment, or one shared row) and ``res`` (like x), the two
adds the planner chain fuses around the norm (pallas_unet.py:281-293).

``gn_mish`` runs the kernels only on CUDA tensors, and the plain versions only
because a tensor lies on the CPU; on a CUDA tensor the kernel launches or the
wrapper raises. When a gradient is wanted it goes through one
``autograd.Function`` on both devices: the forward saves x and the
per-(segment, group) statistics, and the backward is the closed form
(``gn_mish_backward``: the backward kernel on the card,
``gn_mish_backward_plain`` on the CPU), the same function the JAX
``custom_vjp`` differentiates through the XLA reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from dadiff_tpu_torch.ops import cuda_lib

# a group of at most REG_MAX floats stays in registers (csrc/gn_mish.cu)
REG_MAX = 2048
MAX_THREADS = 256


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def mish_grad(y: torch.Tensor) -> torch.Tensor:
    """d mish / dy, as torch's Mish backward and the kernel compute it."""
    tsp = torch.tanh(F.softplus(y))
    return tsp + y * torch.sigmoid(y) * (1 - tsp * tsp)


def _layout(x, n_groups: int, channels_first: bool):
    """(x as (S, G, C/G, L) or (S, L, G, C/G), the dims a group spans, the
    shape a per-channel row broadcasts to, the dim of the positions)."""
    if channels_first:
        S, C, L = x.shape
        return (x.reshape(S, n_groups, C // n_groups, L), (2, 3), (1, C, 1),
                2)
    S, L, C = x.shape
    return x.reshape(S, L, n_groups, C // n_groups), (1, 3), (1, 1, C), 1


def _group_stats(stats, channels_first: bool):
    """(mean, rstd) of an (S, G, 2) stats tensor, shaped to broadcast over
    :func:`_layout`'s grouped view."""
    S, G, _ = stats.shape
    shape = (S, G, 1, 1) if channels_first else (S, 1, G, 1)
    return stats[..., 0].reshape(shape), stats[..., 1].reshape(shape)


def gn_mish_plain(x, scale, bias, n_groups: int = 8, eps: float = 1e-5,
                  te: Optional[torch.Tensor] = None,
                  res: Optional[torch.Tensor] = None,
                  channels_first: bool = False, return_stats: bool = False):
    """Plain PyTorch version: the test oracle and the CPU path. With
    ``return_stats`` also the (S, G, 2) per-(segment, group) mean and rstd
    that the backward reads."""
    g, dims, row, _ = _layout(x, n_groups, channels_first)
    mean = g.mean(dim=dims, keepdim=True)
    var = (g * g).mean(dim=dims, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = ((g - mean) * rstd).reshape(x.shape) * scale.reshape(row) \
        + bias.reshape(row)
    y = mish(y)
    if te is not None:
        y = y + te.reshape((-1,) + row[1:])
    if res is not None:
        y = y + res
    if not return_stats:
        return y
    S = x.shape[0]
    return y, torch.stack([mean.reshape(S, n_groups),
                           rstd.reshape(S, n_groups)], dim=-1)


def gn_mish_backward_plain(x, scale, bias, g, stats, n_groups: int = 8,
                           channels_first: bool = False, te_rows: int = 0):
    """The closed-form gradient of :func:`gn_mish_plain` for the incoming
    gradient ``g``, from x and the forward's statistics, in the kernel's
    arithmetic: x^ = (x - mean) rstd, y = x^ scale + bias, gy = g mish'(y),
    dx = rstd (gy scale - mean(gy scale) - x^ mean(gy scale x^)) over each
    group, dscale = sum(gy x^), dbias = sum(gy). Returns (dx, dscale, dbias,
    dte): dte is None for ``te_rows`` 0, the (C,) sum of g for a shared row
    (1), else the (S, C) sum of g per segment."""
    xg, dims, row, pos = _layout(x, n_groups, channels_first)
    mean, rstd = _group_stats(stats, channels_first)
    xh = (xg - mean) * rstd
    xhat = xh.reshape(x.shape)
    gy = g * mish_grad(xhat * scale.reshape(row) + bias.reshape(row))
    gs = _layout(gy * scale.reshape(row), n_groups, channels_first)[0]
    dx = rstd * (gs - gs.mean(dim=dims, keepdim=True)
                 - xh * (gs * xh).mean(dim=dims, keepdim=True))
    dscale = (gy * xhat).sum(dim=pos).sum(dim=0)
    dbias = gy.sum(dim=pos).sum(dim=0)
    dte = None
    if te_rows:
        dte = g.sum(dim=pos)
        if te_rows == 1:
            dte = dte.sum(dim=0)
    return dx.reshape(x.shape), dscale, dbias, dte


# ---------------------------------------------------------------------------
# The kernels' launches
# ---------------------------------------------------------------------------

class LaunchPlan(NamedTuple):
    vec: int       # floats a load: 4 (128-bit) or 1
    nv: int        # vectors a thread holds; 0: the looped route
    threads: int   # the block's width


@functools.lru_cache(maxsize=None)
def launch_plan(seg: int, C: int, n_groups: int, channels_first: bool,
                aligned: bool = True) -> LaunchPlan:
    """The route of one (segment, group) block: 128-bit loads where the
    group's runs (C/G channels feature-last, L positions channels-first)
    are a multiple of 4 floats and the pointers 16-byte aligned; the
    register route up to REG_MAX floats a group, one vector a thread as far
    as 256 threads go; the looped route beyond."""
    cg = C // n_groups
    n = seg * cg
    vec = 4 if aligned and (seg if channels_first else cg) % 4 == 0 else 1
    if n > REG_MAX:
        return LaunchPlan(vec, 0, MAX_THREADS)
    nvec = n // vec
    threads = min(MAX_THREADS, -(-nvec // 32) * 32)
    need = -(-nvec // threads)
    return LaunchPlan(vec, next(k for k in (1, 2, 4, 8) if k >= need),
                      threads)


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def _dims(x, channels_first: bool):
    """(S, seg, C) of x in its layout."""
    if channels_first:
        S, C, L = x.shape
        return S, L, C
    return x.shape


def launch_gn_mish(x, out, scale, bias, te, te_stride: int, res,
                   n_groups: int, eps: float, seg: int, stream=None,
                   channels_first: bool = False, stats=None) -> None:
    """Launch the forward kernel on contiguous float32 CUDA tensors
    (unchecked). Feature-last x/out/res: (R, C) with R a multiple of
    ``seg`` (any shape with C last); channels-first: (S, C, seg). te: None
    or rows of C at stride ``te_stride``; stats: None or (S, G, 2)."""
    C = x.shape[1] if channels_first else x.shape[-1]
    plan = launch_plan(seg, C, n_groups, channels_first,
                       _aligned(x, out, res))
    rc = cuda_lib.lib("gn_mish").gn_mish(
        x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if te is None else te.data_ptr(), te_stride,
        None if res is None else res.data_ptr(),
        None if stats is None else stats.data_ptr(),
        x.numel() // (seg * C), seg, C, n_groups, eps, int(channels_first),
        plan.vec, plan.nv, plan.threads,
        cuda_lib.stream_of(x) if stream is None else stream)
    cuda_lib.check(rc, "gn_mish")
    gn_mish.launches += 1


def _check(x, scale, bias, te, res, n_groups, channels_first, what="gn_mish"):
    for name, t in (("x", x), ("scale", scale), ("bias", bias), ("te", te),
                    ("res", res)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"tensor on {x.device}")
    layout = "(S, C, L)" if channels_first else "(S, L, C)"
    if x.dim() != 3:
        raise ValueError(f"{what}: x must be {layout}, got {tuple(x.shape)}")
    S, _, C = _dims(x, channels_first)
    if C % n_groups:
        raise ValueError(f"{what}: x must be {layout} with C divisible by "
                         f"{n_groups}, got {tuple(x.shape)}")
    if scale.numel() != C or bias.numel() != C:
        raise ValueError(f"{what}: scale/bias must have the C = {C} elements "
                         f"of x's {layout} layout")
    if te is not None and te.numel() not in (C, S * C):
        raise ValueError(f"{what}: te must be (C,) or (S, C)")
    if res is not None and res.shape != x.shape:
        raise ValueError(f"{what}: res must have x's shape")


def _forward(x, scale, bias, te, res, n_groups, eps, channels_first,
             want_stats: bool):
    """(out, stats or None): the kernel on a CUDA tensor, else the plain
    version."""
    if x.device.type == "cpu":
        y = gn_mish_plain(x, scale, bias, n_groups, eps, te=te, res=res,
                          channels_first=channels_first,
                          return_stats=want_stats)
        return y if want_stats else (y, None)
    S, seg, C = _dims(x, channels_first)
    out = torch.empty_like(x)
    stats = (torch.empty(S, n_groups, 2, device=x.device, dtype=torch.float32)
             if want_stats else None)
    te_stride = 0 if te is None or te.numel() == C else C
    launch_gn_mish(x, out, scale, bias, te, te_stride, res, n_groups, eps,
                   seg, channels_first=channels_first, stats=stats)
    return out, stats


def gn_mish_backward(x, scale, bias, g, stats, n_groups: int = 8,
                     channels_first: bool = False, te_rows: int = 0):
    """The gradient of K1 from x, the forward's (S, G, 2) statistics and the
    incoming gradient ``g`` (x's layout): (dx, dscale, dbias, dte) as
    :func:`gn_mish_backward_plain` returns them. The backward kernel on a
    CUDA tensor (two launches: the group pass and the channel sums), the
    plain version on the CPU."""
    _check(x, scale, bias, None, None, n_groups, channels_first,
           "gn_mish_backward")
    if g.shape != x.shape or g.dtype != torch.float32 \
            or not g.is_contiguous() or g.device != x.device:
        raise ValueError("gn_mish_backward: g must be a contiguous float32 "
                         "tensor of x's shape on x's device")
    S, seg, C = _dims(x, channels_first)
    if stats.shape != (S, n_groups, 2) or stats.dtype != torch.float32 \
            or not stats.is_contiguous() or stats.device != x.device:
        raise ValueError("gn_mish_backward: stats must be the forward's "
                         f"contiguous float32 (S, {n_groups}, 2)")
    return _backward(x, scale, bias, g, stats, n_groups, channels_first,
                     te_rows)


def _backward(x, scale, bias, g, stats, n_groups, channels_first, te_rows):
    """:func:`gn_mish_backward` on checked tensors: the kernel on a CUDA
    tensor, else the plain version."""
    if x.device.type == "cpu":
        return gn_mish_backward_plain(x, scale, bias, g, stats, n_groups,
                                      channels_first, te_rows)
    S, seg, C = _dims(x, channels_first)
    planes = 3 if te_rows else 2
    dx = torch.empty_like(x)
    part = torch.empty(planes, S, C, device=x.device, dtype=torch.float32)
    dscale = torch.empty(C, device=x.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    dte = torch.empty_like(dscale) if te_rows == 1 else None
    plan = launch_plan(seg, C, n_groups, channels_first, _aligned(x, g))
    rc = cuda_lib.lib("gn_mish").gn_mish_backward(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        stats.data_ptr(), dx.data_ptr(), part.data_ptr(), dscale.data_ptr(),
        dbias.data_ptr(), None if dte is None else dte.data_ptr(), planes,
        S, seg, C, n_groups, int(channels_first), plan.vec, plan.nv,
        plan.threads, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "gn_mish_backward")
    gn_mish_backward.launches += 1
    if te_rows and te_rows != 1:
        dte = part[2]
    return dx, dscale, dbias, dte


class _GnMish(torch.autograd.Function):
    """K1 with its closed-form backward: the kernels on the card, the plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, x, scale, bias, te, res, n_groups, eps, channels_first):
        out, stats = _forward(x, scale, bias, te, res, n_groups, eps,
                              channels_first, want_stats=True)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.n_groups, ctx.channels_first = n_groups, channels_first
        ctx.te_shape = None if te is None else te.shape
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, stats = ctx.saved_tensors
        need = ctx.needs_input_grad
        te_rows = 0
        if ctx.te_shape is not None and need[3]:
            te_rows = 1 if ctx.te_shape.numel() == scale.numel() else x.shape[0]
        # the forward checked x, scale and bias; g has x's shape and dtype
        dx, dscale, dbias, dte = _backward(
            x, scale, bias, g.contiguous(), stats, ctx.n_groups,
            ctx.channels_first, te_rows)
        return (dx if need[0] else None, dscale if need[1] else None,
                dbias if need[2] else None,
                None if dte is None else dte.reshape(ctx.te_shape),
                g if need[4] else None, None, None, None)


def gn_mish(x, scale, bias, n_groups: int = 8, eps: float = 1e-5,
            te: Optional[torch.Tensor] = None,
            res: Optional[torch.Tensor] = None,
            channels_first: bool = False) -> torch.Tensor:
    """GroupNorm(n_groups) + affine + Mish (+ te per segment or shared, +
    res) on float32 ``(S, L, C)``, or ``(S, C, L)`` with ``channels_first``;
    the output has x's layout. Plain versions on the CPU, the K1 kernels on
    a CUDA tensor."""
    _check(x, scale, bias, te, res, n_groups, channels_first)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, scale, bias, te, res)):
        return _GnMish.apply(x, scale, bias, te, res, n_groups, eps,
                             channels_first)
    return _forward(x, scale, bias, te, res, n_groups, eps, channels_first,
                    want_stats=False)[0]


gn_mish.launches = 0
gn_mish_backward.launches = 0
