"""Tensor and sequence parallelism for both model families.

Counterpart of the JAX package's parallel/tp.py (maybe_constrain :40,
_tp_spec_for_leaf :56, unet_param_specs :109, shard_params_tp :147) and of
the ``act_spec`` hooks of its models (temporal_unet.py:191-198,
temporal_transformer.py:97-110). JAX annotates shardings and lets GSPMD
insert the collectives; here the sharded forward is written out:

  * **tp** shards conv and dense output channels (the JAX spec table,
    :func:`unet_param_specs`). A layer with sharded outputs reads the whole
    input, all-gathered over tp; a layer whose weight stays whole (too few
    outputs) contracts each rank's input channels and all-reduces the
    partial sums. GroupNorm(8) stays on each rank when tp divides the 8
    groups (tp.py:8-10); another tp size is refused. The transformer takes
    Megatron's layout (:func:`transformer_param_specs`): query, key, value
    and ``mlp1`` split their outputs (heads stay whole on a rank), ``out``
    and ``mlp2`` their inputs, all-reduced; the residual stream stays whole.
    Its modules' own forwards run through :class:`Sharded`, which is the
    plain operation on axes of size 1; the U-Net's sharded forward is
    :func:`unet_forward`.
  * **sp** shards the horizon. A 1-D conv reads its kernel's overlap from
    the neighbouring ranks (a halo: 2 rows on each side at k=5, 1 for the
    stride-2 down- and up-sampling), GroupNorm's statistics are all-reduced
    over sp, and attention gathers every rank's keys and values.

DTensor's conv rule takes only a batch-sharded input with a replicated
weight, so these collectives are explicit autograd functions (Megatron's f
and g and their kin) over the mesh's process groups. The parameters are
DTensors (``shard_params_tp``), so the optimizer, the EMA and the
global-norm clip (``torch._foreach_norm`` on DTensors, reduced over the
shards) see the whole model. A sharded module is a drop-in for the plain
one on this rank's batch rows: whole input, whole output, and each rank's
gradient is the true gradient of its shard of every parameter, the same on
every rank for a replicated one (average them over dp with
:func:`average_grads`). Every collective is counted by
parallel/comm_analysis.py's ``CollectiveCounter``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dadiff_tpu_torch.parallel.comm_analysis import record

# ---------------------------------------------------------------------------
# collectives with their gradients
# ---------------------------------------------------------------------------


def _all_gather(x: torch.Tensor, dim: int, group, size: int,
                kind: str = "all-gather") -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    record(kind, out)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    record("all-reduce", x)
    return x


class _Copy(torch.autograd.Function):
    """A whole value entering per-rank work: identity, gradient summed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """Per-rank partial sums made whole: all-reduce, gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Shards made whole: all-gather along ``dim``, gradient sliced (each
    rank computed the gradient of the whole value). ``kind`` names it for
    the counters: ``all-gather/fsdp`` for a weight's fsdp shards, which
    every rank of the fsdp axis gathers for the same rows (the batch
    splits over dp only)."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size, kind="all-gather"):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return _all_gather(x, dim, group, size, kind)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None, \
            None, None


class _Scatter(torch.autograd.Function):
    """A whole value cut to this rank's block: gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        if x.shape[dim] % size:
            raise ValueError(f"{x.shape[dim]} rows do not divide over "
                             f"{size} ranks")
        n = x.shape[dim] // size
        return x.narrow(dim, rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.size), None, None, \
            None, None


class _Halo(torch.autograd.Function):
    """Rows (dim 1) of the neighbours: ``left`` rows of the rank before and
    ``right`` of the rank after, zeros at the ends of the horizon. Only the
    boundary rows move (one all-gather of them); the gradient of a halo row
    goes back to the rank that owns it."""

    @staticmethod
    def forward(ctx, x, left, right, group, rank, size):
        ctx.args = (left, right, group, rank, size)
        h = x.shape[1]
        parts = _all_gather(torch.cat([x[:, h - left:], x[:, :right]], 1), 1,
                            group, size).split(left + right, dim=1)
        lo = (parts[rank - 1][:, :left] if rank > 0
              else x.new_zeros(x.shape[0], left, x.shape[2]))
        hi = (parts[rank + 1][:, left:] if rank + 1 < size
              else x.new_zeros(x.shape[0], right, x.shape[2]))
        return torch.cat([lo, x, hi], dim=1)

    @staticmethod
    def backward(ctx, g):
        left, right, group, rank, size = ctx.args
        h = g.shape[1] - left - right
        gx = g[:, left:left + h].clone()
        parts = _all_gather(torch.cat([g[:, :left], g[:, left + h:]], 1), 1,
                            group, size).split(left + right, dim=1)
        if rank + 1 < size:  # the next rank's left halo is my tail
            gx[:, h - left:] += parts[rank + 1][:, :left]
        if rank > 0:  # the previous rank's right halo is my head
            gx[:, :right] += parts[rank - 1][:, left:]
        return gx, None, None, None, None, None


# ---------------------------------------------------------------------------
# the mesh as the sharded forward sees it
# ---------------------------------------------------------------------------


class _Axis:
    """One mesh axis: its group, this rank's index and its size (1 and no
    group when the mesh lacks it)."""

    def __init__(self, mesh, name: Optional[str]):
        self.group, self.rank, self.size = None, 0, 1
        if mesh is not None and name in (mesh.mesh_dim_names or ()):
            sub = mesh[name]
            self.group, self.rank, self.size = (mesh.get_group(name),
                                                sub.get_local_rank(),
                                                sub.size())

    def copy(self, x):
        return _Copy.apply(x, self.group) if self.size > 1 else x

    def reduce(self, x):
        return _Reduce.apply(x, self.group) if self.size > 1 else x

    def gather(self, x, dim):
        return (_Gather.apply(x, dim, self.group, self.rank, self.size)
                if self.size > 1 else x)

    def gather_shards(self, x, dim):
        return (_Gather.apply(x, dim, self.group, self.rank, self.size,
                              "all-gather/fsdp") if self.size > 1 else x)

    def scatter(self, x, dim):
        return (_Scatter.apply(x, dim, self.group, self.rank, self.size)
                if self.size > 1 else x)

    def block(self, n: int) -> slice:
        m = n // self.size
        return slice(self.rank * m, (self.rank + 1) * m)


def maybe_constrain(x: torch.Tensor, spec: Sequence[Optional[str]],
                    mesh=None) -> torch.Tensor:
    """This rank's block of ``x`` on each dim that ``spec`` names an axis of
    ``mesh`` for (tp.py:40-53); ``x`` itself without a mesh or when none of
    the named axes is in it. The gradient is gathered back."""
    for dim, name in enumerate(spec):
        x = _Axis(mesh, name).scatter(x, dim)
    return x


class Sharded:
    """The sharded forward's view of a module: its sp and tp axes (from the
    module's ``act_spec`` = (batch, horizon, channel) axis names) and the tp
    dim of each parameter. Without a mesh (or ``act_spec``) both axes have
    size 1 and every method is the plain operation: the transformer's one
    forward runs through it either way."""

    def __init__(self, module):
        spec = tuple(module.act_spec or ()) + (None,) * 3
        self.sp = _Axis(module.mesh, spec[1])
        self.tp = _Axis(module.mesh, spec[2])
        self.tp_dim, self.shards = _placed_dims(module, spec[2])
        # the module's activation dtype: every layer casts its input,
        # weight and bias to it (flax Dense/Conv(dtype=))
        self.dtype = getattr(module, "dtype", torch.float32)

    def param(self, p, rows: bool):
        """The tp-local tensor of ``p``: its local block, gathered over every
        other axis that shards it (fsdp); ``rows``: used on this rank's rows
        of the horizon, so its gradient is summed over sp."""
        local = p.to_local() if hasattr(p, "to_local") else p
        for axis, dim in self.shards.get(p, ()):
            local = axis.gather_shards(local, dim)
        return self.sp.copy(local) if rows else local

    # activations are (tensor, split): split = channels sharded over tp
    def whole(self, a):
        return self.tp.gather(a[0], -1) if a[1] else a[0]

    def split(self, a):
        return a[0] if a[1] else self.tp.scatter(a[0], -1)

    def as_layout(self, a, split: bool):
        return (self.split(a), True) if split else (self.whole(a), False)

    def layer(self, a, layer, op, out_dim: int, rows: bool, **kw):
        """``op(x, weight, bias, **kw)`` of a conv or dense layer whose
        weight holds its outputs on ``out_dim`` (0 for conv and dense, 1 for
        the transposed conv) and its inputs on ``1 - out_dim``."""
        a = (a[0].to(self.dtype), a[1])
        w, b = layer.weight, layer.bias
        wd = self.tp_dim.get(w)
        wl = self.param(w, rows).to(self.dtype)
        bl = self.param(b, rows).to(self.dtype)
        if wd == out_dim:  # outputs split: read the whole input
            return op(self.tp.copy(self.whole(a)), wl, bl, **kw), True
        if wd is not None:  # inputs split (Megatron's row-parallel layer)
            return self.tp.reduce(op(self.split(a), wl, None, **kw)) + bl, \
                False
        if not a[1]:
            return op(a[0], wl, bl, **kw), False
        # a whole weight on split inputs: partial sums, all-reduced
        cin = self.tp.block(wl.shape[1 - out_dim])
        wl = self.tp.copy(wl).narrow(1 - out_dim, cin.start,
                                     cin.stop - cin.start)
        return self.tp.reduce(op(a[0], wl, None, **kw)) + bl, False

    def conv(self, a, conv, *, halo: Tuple[int, int] = (0, 0), stride=1,
             transpose: bool = False):
        """A conv on this rank's rows: the halo rows from the neighbours
        (once the channels it reads are gathered), then the conv without
        padding (feature-last in and out)."""

        def op(x, w, b):
            if halo != (0, 0):
                x = (_Halo.apply(x, halo[0], halo[1], self.sp.group,
                                 self.sp.rank, self.sp.size)
                     if self.sp.size > 1
                     else F.pad(x, (0, 0, halo[0], halo[1])))
            x = x.transpose(1, 2)
            if transpose:
                y = F.conv_transpose1d(x, w, b, stride=stride)
            else:
                y = F.conv1d(x, w, b, stride=stride)
            return y.transpose(1, 2)

        return self.layer(a, conv, op, 1 if transpose else 0, rows=True)

    def dense(self, a, linear, rows: bool):
        return self.layer(a, linear, F.linear, 0, rows)

    def group_norm(self, a, norm):
        """GroupNorm over this rank's rows and channels: the groups a rank
        holds are whole when its channels are split, the sums over the
        horizon all-reduced over sp."""
        x, split = a
        G = norm.num_groups // (self.tp.size if split else 1)
        if split and norm.num_groups % self.tp.size:
            raise ValueError(f"tp {self.tp.size} does not divide the "
                             f"{norm.num_groups} groups of GroupNorm")
        B, H, C = x.shape
        xg = x.reshape(B, H, G, C // G)
        count = H * self.sp.size * (C // G)

        def total(v):
            return self.sp.copy(self.sp.reduce(v.sum(dim=(1, 3),
                                                     keepdim=True)))

        mean = total(xg) / count
        var = total((xg - mean) ** 2) / count
        y = ((xg - mean) * torch.rsqrt(var + norm.eps)).reshape(B, H, C)
        w, b = self.param(norm.weight, True), self.param(norm.bias, True)
        if split and self.tp_dim.get(norm.weight) is None:
            cs = self.tp.block(C * self.tp.size)
            w, b = self.tp.copy(w)[cs], self.tp.copy(b)[cs]
        return y * w + b, split


def _placed_dims(module, tp_axis: Optional[str]):
    """From the parameters' DTensor placements: parameter -> its dim sharded
    over ``tp_axis``, and parameter -> [(axis, dim)] of every other axis
    that shards it (fsdp), which :meth:`Sharded.param` gathers."""
    tp_dim, shards = {}, {}
    mesh = module.mesh
    if mesh is None:
        return tp_dim, shards
    from torch.distributed.tensor import DTensor, Shard

    names = mesh.mesh_dim_names or ()
    axes = [_Axis(mesh, name) for name in names]
    for p in module.parameters():
        if not isinstance(p, DTensor):
            continue
        for name, axis, where in zip(names, axes, p.placements):
            if not isinstance(where, Shard):
                continue
            if name == tp_axis:
                tp_dim[p] = where.dim
            else:
                shards.setdefault(p, []).append((axis, where.dim))
    return tp_dim, shards


def _mish_act(a):
    return F.mish(a[0]), a[1]


# ---------------------------------------------------------------------------
# the sharded forwards
# ---------------------------------------------------------------------------


def _check_rows(horizon: int, sp: _Axis, levels: int) -> None:
    for lv in range(levels):
        rows = horizon >> lv
        if rows % sp.size or (lv < levels - 1 and (rows // sp.size) % 2):
            raise ValueError(f"sp {sp.size} does not split the horizon "
                             f"{horizon} into even blocks at every level")


def unet_forward(unet, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """``TemporalUnet.forward`` with the horizon sharded over sp and the
    channels over tp (temporal_unet.py:200-281 under ``act_spec``).

    Unlike the transformer, whose one forward runs through :class:`Sharded`
    with or without a mesh, the U-Net keeps this second copy of its forward:
    it pads each conv by hand (for the halo), computes GroupNorm from its
    sums (to all-reduce them over sp), carries a decoder level's skip
    concatenation as its two halves and has no ``use_pallas_norm`` kernel,
    all of which would slow the plain path that every single-device
    sampler, trainer and evaluator runs (``python -m
    dadiff_tpu_torch.bench_forward`` times both on a card)."""
    if unet.dtype != torch.float32:
        raise NotImplementedError(
            f"the sharded U-Net forward runs float32 only, not {unet.dtype}; "
            "TemporalUnet.forward without a mesh (the plain forward) takes "
            "its dtype")
    s = Sharded(unet)
    _check_rows(x.shape[1], s.sp, len(unet.dim_mults))
    t = (unet.time_mlp[0](time), False)
    t = _mish_act(s.dense(t, unet.time_mlp[1], rows=False))
    t = s.whole(s.dense(t, unet.time_mlp[3], rows=False))
    a = (s.sp.scatter(x.to(torch.float32), 1), False)
    skips = []
    for res1, res2, down in unet.downs:
        a = _res_block(s, res2, _res_block(s, res1, a, t), t)
        skips.append(a)
        if not isinstance(down, torch.nn.Identity):
            a = s.conv(a, down.conv, halo=(1, 0), stride=2)
    a = _res_block(s, unet.mid_block2, _res_block(s, unet.mid_block1, a, t), t)
    for res1, res2, up in unet.ups:
        a = (a, skips.pop())  # the concatenation, kept as its two halves
        a = _res_block(s, res2, _res_block(s, res1, a, t), t)
        # rows 3 .. 3 + 2h of the unpadded transposed conv of the h rows
        # and their halo are this rank's 2h rows of the padded one
        a = s.conv(a, up.conv, halo=(1, 1), stride=2, transpose=True)
        a = (a[0][:, 3:a[0].shape[1] - 3], a[1])
    block, conv = unet.final_conv
    a = s.conv(_conv_block(s, block, a), conv)
    return s.sp.gather(s.whole(a), 1)


def _conv_block(s: Sharded, block, a):
    conv, norm, _ = block.block
    k = conv.kernel_size[0]
    return _mish_act(s.group_norm(s.conv(a, conv, halo=(k // 2, k // 2)),
                                  norm))


def _res_block(s: Sharded, block, a, t):
    """ResidualTemporalBlock (temporal_unet.py:141-169); ``a`` may be the
    (upper, skip) pair of a decoder level, read as their concatenation."""
    x = _cat(s, a) if isinstance(a[0], tuple) else a
    h = _conv_block(s, block.blocks[0], x)
    te = s.dense((F.mish(t), False), block.time_mlp[1], rows=False)
    te = s.as_layout(te, h[1])
    h = (h[0] + s.sp.copy(te[0])[:, None, :], h[1])
    h = _conv_block(s, block.blocks[1], h)
    if isinstance(block.residual_conv, torch.nn.Identity):
        res = s.as_layout(x, h[1])
    else:
        res = s.as_layout(s.conv(x, block.residual_conv), h[1])
    return h[0] + res[0], h[1]


def _cat(s: Sharded, pair):
    """The channel concatenation of two activations: whole when either is
    split, since the halves' shards do not interleave into the whole's."""
    (a, b) = pair
    if not (a[1] or b[1]):
        return torch.cat([a[0], b[0]], dim=-1), False
    return torch.cat([s.whole(a), s.whole(b)], dim=-1), False


# ---------------------------------------------------------------------------
# parameter specs and placement
# ---------------------------------------------------------------------------


def _module_of(model, name: str):
    return model.get_submodule(name.rsplit(".", 1)[0])


def _fsdp_dim(shape, spec, fsdp_size: int, min_size: int,
              flax_order: Sequence[int]) -> Optional[int]:
    """JAX's 2-D rule (tp.py:128-144): among the dims that tp leaves free,
    the fsdp size divides and are at least ``min_size`` long, the longest;
    a tie goes to the dim that comes first in flax's layout, visited in
    ``flax_order`` (torch dims). None when fsdp is 1 or no dim qualifies."""
    if fsdp_size <= 1:
        return None
    free = [d for d in flax_order if spec[d] is None
            and shape[d] % fsdp_size == 0 and shape[d] >= min_size]
    return max(free, key=lambda d: shape[d]) if free else None


def _with_fsdp(specs, model, fsdp_axis, fsdp_size, min_size, flax_order):
    if fsdp_axis is None:
        return specs
    for name, p in model.named_parameters():
        spec = list(specs[name])
        d = _fsdp_dim(p.shape, spec, fsdp_size, min_size, flax_order(p))
        if d is not None:
            spec[d] = fsdp_axis
        specs[name] = tuple(spec)
    return specs


def unet_param_specs(unet, tp_size: int, *, tp_axis: Optional[str] = "tp",
                     fsdp_axis: Optional[str] = None, fsdp_size: int = 1,
                     min_size: int = 16) -> Dict[str, Tuple]:
    """Parameter name -> the axis name of each of its dims (None:
    replicated), the JAX spec table (tp.py:56-106 and :109-144) in torch's
    layouts: a conv's (out, in, k) and a dense (out, in) weight split dim 0,
    the transposed conv's (in, out, k) dim 1, biases and GroupNorm's affine
    dim 0. A dim that tp does not divide, or shorter than ``min_size``,
    stays whole, and so do the time projections whose shard would hold
    fewer than 128 outputs. Without a ``tp_axis`` nothing is split over tp.

    With ``fsdp_axis`` (of ``fsdp_size`` ranks) each parameter also splits
    one dim that tp leaves free over it, by JAX's rule (:func:`_fsdp_dim`).
    Every U-Net layout is flax's reversed ((k, in, out) -> (out, in, k)), so
    a tie goes to the last tying torch dim: a square dense weight splits its
    inputs, as in JAX."""
    specs = {}
    for name, p in unet.named_parameters():
        layer = _module_of(unet, name)
        out_dim = 1 if (isinstance(layer, torch.nn.ConvTranspose1d)
                        and p.dim() == 3) else 0
        n = p.shape[out_dim]
        keep = tp_axis is None or n % tp_size or n < min_size or (
            ".time_mlp." in f".{name}" and n // max(1, tp_size) < 128)
        spec = [None] * p.dim()
        if not keep:
            spec[out_dim] = tp_axis
        specs[name] = tuple(spec)
    return _with_fsdp(specs, unet, fsdp_axis, fsdp_size, min_size,
                      lambda p: range(p.dim() - 1, -1, -1))


def transformer_param_specs(model, tp_size: int, *,
                            tp_axis: Optional[str] = "tp",
                            fsdp_axis: Optional[str] = None,
                            fsdp_size: int = 1,
                            min_size: int = 16) -> Dict[str, Tuple]:
    """Megatron's table for the transformer: the query, key and value
    weights and biases and ``mlp1``'s split their outputs (dim 0), ``out``
    and ``mlp2`` their inputs (dim 1 of the weight; the bias stays whole);
    every other parameter stays whole. JAX's GSPMD table also splits the
    outputs of ``in_proj``, ``adaln_mod``, ``mlp2`` and ``final_mod`` and
    the width of ``pos_emb``; the port keeps those whole so that the
    residual stream is whole on every rank: one all-reduce per sublayer and
    no gathers. The heads and the hidden units must divide over tp.

    With ``fsdp_axis``, JAX's 2-D rule (:func:`_fsdp_dim`) on top of this
    table, ties broken in flax's layout: a dense (out, in) weight is flax's
    (in, out) reversed; ``pos_emb`` keeps flax's order."""
    if tp_axis is not None and (model.n_heads % tp_size
                                or (model.mlp_ratio * model.dim) % tp_size):
        raise ValueError(f"tp {tp_size} does not divide the {model.n_heads} "
                         "heads and the MLP's hidden units")
    specs = {}
    for name, p in model.named_parameters():
        spec = [None] * p.dim()
        leaf = name.rsplit(".", 2)
        if tp_axis is not None and len(leaf) == 3:
            if leaf[1] in ("query", "key", "value", "mlp1"):
                spec[0] = tp_axis
            elif leaf[1] in ("out", "mlp2") and p.dim() == 2:
                spec[1] = tp_axis
        specs[name] = tuple(spec)
    return _with_fsdp(specs, model, fsdp_axis, fsdp_size, min_size,
                      lambda p: (range(p.dim()) if p is model.pos_emb
                                 else range(p.dim() - 1, -1, -1)))


def shard_params_tp(model, mesh, *, tp_axis: str = "tp",
                    fsdp_axis: Optional[str] = None, min_size: int = 16):
    """Place ``model``'s parameters on ``mesh`` as DTensors (tp.py:147-167),
    in place, and keep the mesh for its sharded forward: each parameter
    ``Shard``s the dim its spec table gives ``tp_axis`` over tp and, with
    ``fsdp_axis``, the dim it gives that axis over fsdp (2-D sharding), and
    is replicated over every other axis (from rank 0's values). An axis
    missing from the mesh shards nothing: without either every parameter is
    replicated, as the JAX sp tests place them. The model's ``act_spec``
    then picks the sharded forward, which gathers the fsdp shards where a
    layer uses them (:meth:`Sharded.param`). Returns ``model``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    names = mesh.mesh_dim_names or ()
    tp_size = mesh[tp_axis].size() if tp_axis in names else 1
    fsdp_size = mesh[fsdp_axis].size() if fsdp_axis in names else 1
    table = (transformer_param_specs if hasattr(model, "blocks")
             else unet_param_specs)
    specs = table(model, tp_size, tp_axis=tp_axis if tp_axis in names
                  else None, fsdp_axis=fsdp_axis if fsdp_axis in names
                  else None, fsdp_size=fsdp_size, min_size=min_size)
    for name, p in list(model.named_parameters()):
        placements = [Replicate()] * len(names)
        for dim, axis in enumerate(specs[name]):
            if axis is not None:
                placements[names.index(axis)] = Shard(dim)
        value = distribute_tensor(p.detach(), mesh, placements)
        owner = _module_of(model, name) if "." in name else model
        setattr(owner, name.rsplit(".", 1)[-1],
                torch.nn.Parameter(value, requires_grad=p.requires_grad))
    model.mesh = mesh
    return model


def average_grads(module, mesh, axis: str = "dp") -> None:
    """Average every gradient over ``axis`` in one collective: the dp step
    of a tp/sp-sharded module, whose replicas over dp saw their own rows."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return
    count = mesh[axis].size()
    if count == 1:
        return
    grads = [p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
             for p in module.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.get_group(axis))
    record("all-reduce", flat)
    flat /= count
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
