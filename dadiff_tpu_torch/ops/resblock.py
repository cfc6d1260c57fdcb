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

The kernel gives a batch row to one thread-block cluster of ``n_groups``
blocks (at most 8, the portable cluster size), block g owning group g's
channels; see the source for the design.

``fused_residual_block`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. Its gradient is the
plain version's, as the JAX ``custom_vjp`` differentiates the XLA reference.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

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


def launch_resblock(x, te, params, out, n_groups: int, eps: float,
                    stream=None) -> None:
    """Launch the kernel on contiguous float32 CUDA tensors (unchecked)."""
    B, H, cin = x.shape
    k, _, cout = params["w1"].shape
    wr, br = params.get("wr"), params.get("br")
    rc = cuda_lib.lib("resblock").resblock(
        x.data_ptr(), te.data_ptr(),
        *(params[n].data_ptr() for n in _KEYS[:8]),
        None if wr is None else wr.data_ptr(),
        None if br is None else br.data_ptr(), out.data_ptr(), B, H, cin,
        cout, k, n_groups, eps,
        cuda_lib.stream_of(x) if stream is None else stream)
    cuda_lib.check(rc, "resblock")
    fused_residual_block.launches += 1


def _check_cuda(x, te, params, n_groups):
    for name, t in (("x", x), ("te", te), *params.items()):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"fused_residual_block: {name} must be a "
                             f"contiguous float32 tensor on {x.device}")
    if unknown := set(params) - set(_KEYS):
        raise ValueError(f"fused_residual_block: unknown params {unknown}")
    B, H, cin = x.shape
    k, w_cin, cout = params["w1"].shape
    if w_cin != cin or params["w2"].shape != (k, cout, cout) \
            or te.shape != (B, cout) or cout % n_groups or n_groups > 8 \
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
    _check_cuda(x, te, params, n_groups)
    names = tuple(params)
    return _ResBlockCuda.apply(x, te, n_groups, eps, names,
                               *(params[n] for n in names))


fused_residual_block.launches = 0
