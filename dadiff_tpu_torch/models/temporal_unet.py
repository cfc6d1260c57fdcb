"""Temporal U-Net denoiser as PyTorch modules.

Counterpart of the JAX package's models/temporal_unet.py (TemporalUnet :172,
ResidualTemporalBlock :141, Conv1dBlock :108, SinusoidalPosEmb :38,
ConvTranspose1d :52). Public shapes are the JAX package's feature-last
``(B, H, C)``; convolutions run in PyTorch's ``(B, C, H)`` inside each module.

The module tree is the reference torch key tree (``time_mlp.1``,
``downs.0.0.blocks.0.block.0``, ``mid_block1``, ``ups.0.2.conv``,
``final_conv.1``, ...), so a reference-schema ``.pt`` state dict loads with
``strict=True`` and the JAX package's io/torch_compat.py:58 ``unet_key_mapping``
applies unchanged.

Convolutions stay ``torch.nn.functional.conv1d`` (the JAX module leaves them
to XLA outside any Pallas kernel). With ``use_pallas_norm`` every
GroupNorm+Mish goes through the K1 kernels (ops/gn_mish.py: the forward on
the conv's ``(B, C, H)`` output as it lies, and its backward), the
counterpart of the JAX ``PallasGroupNormMish`` (:89). When this module serves as a
reference on the card, set ``torch.backends.cudnn.allow_tf32 = False``.

``dtype`` is the activation dtype (JAX's ``dtype`` knob, float32 or
bfloat16), cast where the JAX module casts: the weights stay float32 in the
module and its state dict, and every conv and dense layer casts its input,
weight and bias to ``dtype`` (flax ``Conv``/``Dense(dtype=)``, the
transposed conv at :79-86); GroupNorm runs in float32 and Mish on its
float32 output before the cast back (:134-138; K1 takes float32, :105); the
sinusoidal embedding is float32 (:47-48) and the time MLP runs in
``dtype`` (:206-208); the input is cast at :214 and the output returns to
float32 at the head (:275).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dadiff_tpu_torch.ops.gn_mish import gn_mish


class CastLinear(nn.Linear):
    """``nn.Linear`` that casts its input, weight and bias to ``act_dtype``
    (flax ``Dense(dtype=)``); the weights stay float32. Called as a module,
    so hooks on it (FSDP2's unshard) run."""

    def __init__(self, *args, act_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.act_dtype = act_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.act_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class CastConv1d(nn.Conv1d):
    """``nn.Conv1d`` on ``act_dtype`` (flax ``Conv(dtype=)``), as
    :class:`CastLinear`."""

    def __init__(self, *args, act_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.act_dtype = act_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.act_dtype
        return self._conv_forward(x.to(d), self.weight.to(d),
                                  self.bias.to(d))


class CastConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` on ``act_dtype`` (the JAX module's transposed
    conv casts input, kernel and bias, :79-86), as :class:`CastLinear`."""

    def __init__(self, *args, act_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.act_dtype = act_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.act_dtype
        return F.conv_transpose1d(x.to(d), self.weight.to(d), self.bias.to(d),
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class SinusoidalPosEmb(nn.Module):
    """Sinusoidal timestep embedding (temporal_unet.py:38-49)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        scale = math.log(10000.0) / (half - 1)
        freqs = torch.exp(-scale * torch.arange(half, dtype=torch.float32,
                                                device=t.device))
        emb = t.to(torch.float32)[:, None] * freqs[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class Conv1dBlock(nn.Module):
    """Conv1d -> GroupNorm(8, eps 1e-5) -> Mish on (B, H, C)
    (temporal_unet.py:108-138)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, n_groups: int = 8,
                 use_pallas_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block = nn.Sequential(
            CastConv1d(cin, cout, kernel_size, padding=kernel_size // 2,
                       act_dtype=dtype),
            nn.GroupNorm(n_groups, cout, eps=1e-5),
            nn.Mish(),
        )
        self.use_pallas_norm = use_pallas_norm
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, norm, act = self.block
        y = conv(x.transpose(1, 2)).float()
        if self.use_pallas_norm:
            # K1 reads the conv's (B, C, H) output as it lies: no layout copy
            return gn_mish(y, norm.weight, norm.bias, norm.num_groups,
                           norm.eps, channels_first=True
                           ).transpose(1, 2).to(self.dtype)
        return act(norm(y)).transpose(1, 2).to(self.dtype)


class ResidualTemporalBlock(nn.Module):
    """Two Conv1dBlocks, a time-embedding add between them and a 1x1
    residual conv when the widths differ (temporal_unet.py:141-169)."""

    def __init__(self, cin: int, cout: int, time_dim: int, kernel_size: int = 5,
                 use_pallas_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(use_pallas_norm=use_pallas_norm, dtype=dtype)
        self.blocks = nn.ModuleList([
            Conv1dBlock(cin, cout, kernel_size, **kw),
            Conv1dBlock(cout, cout, kernel_size, **kw),
        ])
        self.time_mlp = nn.Sequential(
            nn.Mish(), CastLinear(time_dim, cout, act_dtype=dtype))
        self.residual_conv = (CastConv1d(cin, cout, 1, act_dtype=dtype)
                              if cin != cout else nn.Identity())
        self.dtype = dtype

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        h = self.blocks[0](x) + self.time_mlp(t_emb)[:, None, :]
        h = self.blocks[1](h)
        if isinstance(self.residual_conv, nn.Identity):
            return h + x
        return h + self.residual_conv(x.transpose(1, 2)).transpose(1, 2)


class Downsample1d(nn.Module):
    """Conv1d k=3, s=2, p=1 (temporal_unet.py:230-237)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = CastConv1d(dim, dim, 3, 2, 1, act_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class Upsample1d(nn.Module):
    """ConvTranspose1d k=4, s=2, p=1 (temporal_unet.py:52-86)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = CastConvTranspose1d(dim, dim, 4, 2, 1, act_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class TemporalUnet(nn.Module):
    """1-D conv U-Net over the horizon, timestep-conditioned
    (temporal_unet.py:172-281). ``forward(x (B, H, D), t (B,)) -> (B, H, D)``;
    H must be divisible by ``2 ** (len(dim_mults) - 1)``.

    ``act_spec``: the (batch, horizon, channel) mesh axis names, e.g. ("dp",
    "sp", "tp") (temporal_unet.py:187-198). Once ``parallel.tp
    .shard_params_tp`` has placed the weights on a mesh, the forward shards
    the horizon and the channels over those axes (parallel/tp.py); without
    a mesh it is the plain forward, as JAX's is without an ambient mesh."""

    def __init__(self, transition_dim: int, dim: int = 128,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), kernel_size: int = 5,
                 time_dim: Optional[int] = None, use_pallas_norm: bool = False,
                 act_spec: Optional[Tuple[Optional[str], ...]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_spec = act_spec
        self.dtype = dtype
        self.mesh = None  # set by parallel.tp.shard_params_tp
        self.transition_dim = transition_dim
        self.dim = dim
        self.dim_mults = tuple(dim_mults)
        self.kernel_size = kernel_size
        self.time_dim = time_dim or dim
        td = self.time_dim
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(dim), CastLinear(dim, td * 4, act_dtype=dtype),
            nn.Mish(), CastLinear(td * 4, td, act_dtype=dtype),
        )
        dims = [transition_dim] + [dim * m for m in self.dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n_levels = len(in_out)
        kw = dict(kernel_size=kernel_size, use_pallas_norm=use_pallas_norm,
                  dtype=dtype)
        self.downs = nn.ModuleList()
        for i, (cin, cout) in enumerate(in_out):
            self.downs.append(nn.ModuleList([
                ResidualTemporalBlock(cin, cout, td, **kw),
                ResidualTemporalBlock(cout, cout, td, **kw),
                Downsample1d(cout, dtype) if i < n_levels - 1
                else nn.Identity(),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResidualTemporalBlock(mid, mid, td, **kw)
        self.mid_block2 = ResidualTemporalBlock(mid, mid, td, **kw)
        self.ups = nn.ModuleList()
        for dim_in, dim_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                ResidualTemporalBlock(dim_out * 2, dim_in, td, **kw),
                ResidualTemporalBlock(dim_in, dim_in, td, **kw),
                Upsample1d(dim_in, dtype),
            ]))
        self.final_conv = nn.Sequential(
            Conv1dBlock(dim, dim, kernel_size, use_pallas_norm=use_pallas_norm,
                        dtype=dtype),
            CastConv1d(dim, transition_dim, 1, act_dtype=dtype),
        )

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None and self.act_spec is not None:
            from dadiff_tpu_torch.parallel.tp import unet_forward

            return unet_forward(self, x, time)
        t = self.time_mlp(time)
        x = x.to(self.dtype)
        skips = []
        for res1, res2, down in self.downs:
            x = res2(res1(x, t), t)
            skips.append(x)
            x = down(x)
        x = self.mid_block2(self.mid_block1(x, t), t)
        for res1, res2, up in self.ups:
            x = torch.cat([x, skips.pop()], dim=-1)
            x = up(res2(res1(x, t), t))
        block, conv = self.final_conv
        x = conv(block(x).transpose(1, 2))
        return x.transpose(1, 2).to(torch.float32)
