"""K1: fused GroupNorm(8) + Mish, a hand-written CUDA kernel
(``csrc/gn_mish.cu``).

Counterpart of the JAX package's ops/pallas_kernels.py:84 ``group_norm_mish_pallas``
(its body ``_gn_mish_kernel`` :56, its ``custom_vjp`` :118-139) and of the
per-chain GN+Mish stage of the planner chain (pallas_unet.py:198-240).

Layout is the JAX package's feature-last ``(S, L, C)``: S segments (batch rows
or stacked chains) of L rows. Statistics are per segment and group over
(L, C/8), with var = E[x^2] - mean^2 and eps 1e-5. Optional epilogue adds:
``te`` (one row per segment, or one shared row) and ``res`` (like x), the two
adds the planner chain fuses around the norm (pallas_unet.py:281-293).

``gn_mish`` takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. Its gradient is the plain version's,
as the JAX ``custom_vjp`` differentiates through the XLA reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dadiff_tpu_torch.ops import cuda_lib


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def gn_mish_plain(x, scale, bias, n_groups: int = 8, eps: float = 1e-5,
                  te: Optional[torch.Tensor] = None,
                  res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the test oracle and the CPU path."""
    S, L, C = x.shape
    g = x.reshape(S, L, n_groups, C // n_groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g * g).mean(dim=(1, 3), keepdim=True) - mean * mean
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(S, L, C) * scale + bias
    y = mish(y)
    if te is not None:
        y = y + te.reshape(-1, 1, C)
    if res is not None:
        y = y + res
    return y


def launch_gn_mish(x, out, scale, bias, te, te_stride: int, res, n_groups: int,
                   eps: float, seg: int, stream=None) -> None:
    """Launch the kernel on contiguous float32 CUDA tensors (unchecked).
    x/out/res: (R, C) with R a multiple of ``seg``; te: None or rows of C at
    stride ``te_stride``."""
    C = x.shape[-1]
    rc = cuda_lib.lib("gn_mish").gn_mish(
        x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if te is None else te.data_ptr(), te_stride,
        None if res is None else res.data_ptr(),
        x.numel() // (seg * C), seg, C, n_groups, eps,
        cuda_lib.stream_of(x) if stream is None else stream)
    cuda_lib.check(rc, "gn_mish")
    gn_mish.launches += 1


def _check_cuda(x, scale, bias, te, res, n_groups):
    for name, t in (("x", x), ("scale", scale), ("bias", bias), ("te", te),
                    ("res", res)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"gn_mish: {name} must be a contiguous float32 "
                             f"tensor on {x.device}")
    if x.dim() != 3 or x.shape[2] % n_groups:
        raise ValueError(f"gn_mish: x must be (S, L, C) with C divisible by "
                         f"{n_groups}, got {tuple(x.shape)}")
    C = x.shape[2]
    if scale.numel() != C or bias.numel() != C:
        raise ValueError("gn_mish: scale/bias must have C elements")
    if te is not None and te.numel() not in (C, x.shape[0] * C):
        raise ValueError("gn_mish: te must be (C,) or (S, C)")
    if res is not None and res.shape != x.shape:
        raise ValueError("gn_mish: res must have x's shape")


class _GnMishCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, te, res, n_groups, eps):
        ctx.save_for_backward(x, scale, bias, te, res)
        ctx.n_groups, ctx.eps = n_groups, eps
        out = torch.empty_like(x)
        te_stride = 0 if te is None or te.numel() == x.shape[2] else x.shape[2]
        launch_gn_mish(x, out, scale, bias, te, te_stride, res, n_groups, eps,
                       x.shape[1])
        return out

    @staticmethod
    def backward(ctx, g):
        inputs = [None if t is None else t.detach().requires_grad_(bool(need))
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            y = gn_mish_plain(*inputs[:3], ctx.n_groups, ctx.eps,
                              te=inputs[3], res=inputs[4])
        grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
        return (*(next(grads) if t is not None and t.requires_grad else None
                  for t in inputs), None, None)


def gn_mish(x, scale, bias, n_groups: int = 8, eps: float = 1e-5,
            te: Optional[torch.Tensor] = None,
            res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm(n_groups) + affine + Mish (+ te per segment, + res) on
    feature-last ``(S, L, C)`` float32. Plain version on the CPU, the K1
    kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return gn_mish_plain(x, scale, bias, n_groups, eps, te=te, res=res)
    _check_cuda(x, scale, bias, te, res, n_groups)
    return _GnMishCuda.apply(x, scale, bias, te, res, n_groups, eps)


gn_mish.launches = 0
