"""K4: one fused ResidualTemporalBlock per launch, a hand-written CUDA kernel
(``csrc/resblock.cu``).

Counterpart of the JAX package's ops/pallas_resblock.py:
``residual_block_reference`` :62, ``residual_block_pallas`` :132 (body
``_kernel`` :82) and ``fused_residual_block`` :179 with its ``custom_vjp``
(:184-197).

    conv1(k) -> GroupNorm -> Mish -> + te -> conv2(k) -> GroupNorm -> Mish
    -> + (1x1 conv of x, or x)

Layout is the JAX package's: ``x`` (B, H, Cin), ``te`` (B, Cout) the
post-Dense time embedding, ``params`` a dict ``w1`` (k, Cin, Cout), ``w2``
(k, Cout, Cout), ``b1 s1 g1 b2 s2 g2`` (Cout,) and, when Cin != Cout, ``wr``
(Cin, Cout) and ``br`` (Cout,). Float32 throughout.

The kernel is K3's layer program (``csrc/program.cuh``) run for one block:
one cooperative launch, one block per SM, walks the block's 4 ops (5 with
the 1x1 residual conv) with 3 grid barriers. :func:`block_program` lays
them out with ``ops/chain.py``'s builder, once per block's weights and (B,
H) and stream: the template is cached, with placeholders where x, te and
out go, which the C entry patches at each launch. The split-K partials and h
live in a scratch buffer of the (device, stream), shared by the templates of
that stream, so launches on two streams at once never share one; a buffer
that is outgrown is kept, so a CUDA graph that captured launches stays
valid.

``fused_residual_block`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. Its gradient is the
plain version's, as the JAX ``custom_vjp`` differentiates the XLA reference.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from dadiff_tpu_torch.ops import chain as ch
from dadiff_tpu_torch.ops import cuda_lib
from dadiff_tpu_torch.ops.gn_mish import gn_mish_plain

_KEYS = ("w1", "b1", "s1", "g1", "w2", "b2", "s2", "g2", "wr", "br")


def _conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """'same' 1-D conv as one product over the k shifted copies of x:
    x (B, H, Cin), w (k, Cin, Cout) (pallas_resblock.py:92-103)."""
    k, cin, cout = w.shape
    p, H = k // 2, x.shape[1]
    xp = F.pad(x, (0, 0, p, p))
    stack = torch.cat([xp[:, j:j + H] for j in range(k)], dim=-1)
    return stack @ w.reshape(k * cin, cout) + b


def residual_block_plain(x, te, params: Dict[str, torch.Tensor],
                         n_groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: the test oracle, the CPU path and the function
    the gradient differentiates (pallas_resblock.py:62-79)."""
    h = gn_mish_plain(_conv_same(x, params["w1"], params["b1"]), params["s1"],
                      params["g1"], n_groups, eps, te=te)
    h = gn_mish_plain(_conv_same(h, params["w2"], params["b2"]), params["s2"],
                      params["g2"], n_groups, eps)
    res = x @ params["wr"] + params["br"] if "wr" in params else x
    return h + res


# Placeholders in a block's op template (csrc/resblock.cu kArgX, kArgTe,
# kArgOut): resblock_run puts x, te and out where they stand. HIDDEN stands
# for h until the template is placed in the scratch buffer.
X, TE, OUT, HIDDEN = 1, 2, 3, 4
EPS = 1e-5              # the kernel's (csrc/program.cuh kEps)
_MAX_TEMPLATES = 64     # cached op templates, least recently used dropped


class Operand(NamedTuple):
    """An operand of a block's op template: ``code`` stands where its
    address goes."""
    code: int
    shape: Tuple[int, ...]

    def data_ptr(self) -> int:
        return self.code


def patch(ops, addrs: Dict[int, int]) -> None:
    """Replace every pointer field of ``ops`` that holds a key of ``addrs``
    by its value: what resblock_run does with X, TE and OUT."""
    for op in ops:
        for field in ch._PTRS:
            addr = addrs.get(getattr(op, field))
            if addr is not None:
                setattr(op, field, addr)


class _Scratch:
    """The buffers for the split-K partials and h, one per (device,
    stream). Each only grows; an outgrown buffer is kept, since cached
    templates and captured CUDA graphs still point into it."""

    def __init__(self):
        self.bufs: Dict[Tuple[str, int], list] = {}

    def at_least(self, device, n: int, stream: int = 0) -> int:
        """Address of a float32 buffer of at least ``n`` elements for the
        launches on ``stream`` (a pointer)."""
        bufs = self.bufs.setdefault((str(device), int(stream or 0)), [])
        if not bufs or bufs[-1].numel() < n:
            size = max(n, 2 * bufs[-1].numel() if bufs else 0)
            bufs.append(torch.empty(size, dtype=torch.float32, device=device))
        return bufs[-1].data_ptr()


_scratch = _Scratch()
_templates: "OrderedDict[tuple, Tuple[ctypes.Array, int]]" = OrderedDict()


def block_program(params, x, te, out, B: int, H: int, n_groups: int,
                  grid: int, device, stream: int = 0) -> ctypes.Array:
    """The ops of one residual block for a launch of ``grid`` blocks, as a
    ctypes array: conv1 [+ the 1x1 conv wr] | GN + te | conv2 | GN +
    residual into out, three barriers. ``x`` (B*H, Cin), ``te`` (B, Cout)
    and ``out`` (B*H, Cout) are tensors or :class:`Operand` placeholders.
    Batch rows are the program's segments; tiles and K splits follow
    ``ops/chain.py``'s builder. The partials and h are placed in the
    scratch buffer of (``device``, ``stream``)."""
    k, cin, cout = params["w1"].shape
    b = ch._ProgramBuilder(device, grid, n_groups)
    rconv = (params["wr"], params["br"]) if "wr" in params else None
    b.res_block(x, None, params["w1"].reshape(k * cin, cout), params["b1"],
                params["s1"], params["g1"],
                params["w2"].reshape(k * cout, cout), params["b2"],
                params["s2"], params["g2"], rconv, k, H, te, 0, cout,
                h=Operand(HIDDEN, (B * H, cout)), out=out, sync=False)
    r0, r1 = b.region_elems
    base = _scratch.at_least(device, r0 + r1 + B * H * cout, stream)
    b.place([base, base + 4 * r0])
    patch(b.ops, {HIDDEN: base + 4 * (r0 + r1)})
    return (ch.ChainOp * len(b.ops))(*b.ops)


def _template(params, x, n_groups: int, stream: int = 0):
    """(ops with X, TE, OUT placeholders, grid) of a block on x launched on
    ``stream``, cached by the weights' names and addresses, x's and w1's
    shapes, the group count and the stream; the other shapes follow from
    these (``_check_cuda``)."""
    key = (x.device, x.shape, n_groups, params["w1"].shape, *params,
           *[t.data_ptr() for t in params.values()], stream)
    hit = _templates.get(key)
    if hit is not None:
        _templates.move_to_end(key)
        return hit
    B, H, cin = x.shape
    cout = params["w1"].shape[2]
    grid = ch.grid_size(x.device, "resblock")
    ops = block_program(params, Operand(X, (B * H, cin)),
                        Operand(TE, (B, cout)), Operand(OUT, (B * H, cout)),
                        B, H, n_groups, grid, x.device, stream)
    _templates[key] = ops, grid
    if len(_templates) > _MAX_TEMPLATES:
        _templates.popitem(last=False)
    return ops, grid


def launch_resblock(x, te, params, out, n_groups: int, eps: float,
                    stream=None, prof=None) -> None:
    """Launch the kernel on contiguous float32 CUDA tensors (unchecked).
    ``prof``: None, or zeroed int64 (5,) on the device that receives
    chain.PROFILE_SLOTS' clock cycles of block 0."""
    stream = cuda_lib.stream_of(x) if stream is None else stream
    ops, grid = _template(params, x, n_groups, stream)
    rc = cuda_lib.lib("resblock").resblock_run(
        ctypes.addressof(ops), len(ops), x.data_ptr(), te.data_ptr(),
        out.data_ptr(), grid, None if prof is None else prof.data_ptr(),
        stream)
    cuda_lib.check(rc, "resblock")
    fused_residual_block.launches += 1


def _check_cuda(x, te, params, n_groups, eps=EPS):
    for name, t in (("x", x), ("te", te), *params.items()):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"fused_residual_block: {name} must be a "
                             f"contiguous float32 tensor on {x.device}")
        if name in ("x", "w1", "w2", "wr") and t.data_ptr() % 16:
            # the conv items copy them in 16-byte pieces (cp.async)
            raise ValueError(f"fused_residual_block: {name} must be 16-byte "
                             "aligned")
    if unknown := set(params) - set(_KEYS):
        raise ValueError(f"fused_residual_block: unknown params {unknown}")
    if eps != EPS:
        raise ValueError(f"fused_residual_block: the kernel's eps is {EPS}")
    B, H, cin = x.shape
    k, w_cin, cout = params["w1"].shape
    # cout % 4: F32Tile moves weights and stores outputs in 16-byte rows
    if w_cin != cin or params["w2"].shape != (k, cout, cout) \
            or te.shape != (B, cout) or cout % n_groups or cout % 4 \
            or k % 2 == 0 or any(params[n].numel() != cout
                                 for n in ("b1", "s1", "g1", "b2", "s2", "g2")):
        raise ValueError("fused_residual_block: shapes do not match")
    if ("wr" in params) != ("br" in params) or (
            "wr" in params and (params["wr"].shape != (cin, cout)
                                or params["br"].numel() != cout)) or (
            "wr" not in params and cin != cout):
        raise ValueError("fused_residual_block: the residual needs wr (Cin, "
                         "Cout) and br when Cin != Cout")


class _ResBlockCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, te, n_groups, eps, names, *tensors):
        ctx.save_for_backward(x, te, *tensors)
        ctx.n_groups, ctx.eps, ctx.names = n_groups, eps, names
        params = dict(zip(names, tensors))
        out = torch.empty(*x.shape[:2], params["w1"].shape[2],
                          dtype=torch.float32, device=x.device)
        launch_resblock(x, te, params, out, n_groups, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        need = (ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                *ctx.needs_input_grad[5:])
        inputs = [t.detach().requires_grad_(bool(n))
                  for t, n in zip(ctx.saved_tensors, need)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = residual_block_plain(inputs[0], inputs[1],
                                     dict(zip(ctx.names, inputs[2:])),
                                     ctx.n_groups, ctx.eps)
        grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
        out = [next(grads) if t.requires_grad else None for t in inputs]
        return (out[0], out[1], None, None, None, *out[2:])


def fused_residual_block(x, te, params: Dict[str, torch.Tensor],
                         n_groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """One ResidualTemporalBlock, (B, H, Cin) -> (B, H, Cout). Plain version
    on the CPU, the K4 kernel (one launch) on CUDA tensors; differentiable
    either way."""
    if x.device.type == "cpu":
        return residual_block_plain(x, te, params, n_groups, eps)
    _check_cuda(x, te, params, n_groups, eps)
    names = tuple(params)
    return _ResBlockCuda.apply(x, te, n_groups, eps, names,
                               *(params[n] for n in names))


fused_residual_block.launches = 0
