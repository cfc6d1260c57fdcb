"""The temporal U-Net of Janner et al. (Diffuser), plain PyTorch on a dict
of weights: residual blocks of two (Conv1d, GroupNorm(8), Mish) with the
time embedding added after the first, a 1x1 residual conv where the widths
differ, stride-2 down and transposed-conv up samples, skips concatenated
on the way up. Weight names follow the reference torch module tree.

``prec`` rounds the operands of every conv and of each block's time dense
to the precision of the product (bf16 on the served path), accumulating in
float32; the top time MLP, the norms, Mish and the adds run in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F


def _dims(cfg) -> List[Tuple[int, int]]:
    dims = [cfg["transition_dim"]] + [cfg["dim"] * m for m in cfg["dim_mults"]]
    return list(zip(dims[:-1], dims[1:]))


def param_specs(cfg) -> List[tuple]:
    """(name, shape, init, fan_in): ``uniform`` is PyTorch's default for
    conv and linear layers, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), for the
    weight and the bias alike; GroupNorm starts at ones and zeros."""
    dim, k, td = cfg["dim"], cfg["kernel_size"], cfg["dim"]
    D = cfg["transition_dim"]
    specs = []

    def lin(name, i, o):
        specs.extend([(f"{name}.weight", (o, i), "uniform", i),
                      (f"{name}.bias", (o,), "uniform", i)])

    def conv(name, i, o, kk):
        specs.extend([(f"{name}.weight", (o, i, kk), "uniform", i * kk),
                      (f"{name}.bias", (o,), "uniform", i * kk)])

    def conv_t(name, i, o, kk):  # torch counts a transposed conv's fan-in
        specs.extend([(f"{name}.weight", (i, o, kk), "uniform", o * kk),
                      (f"{name}.bias", (o,), "uniform", o * kk)])

    def norm(name, c):
        specs.extend([(f"{name}.weight", (c,), "ones", 0),
                      (f"{name}.bias", (c,), "zeros", 0)])

    def res(name, i, o):
        conv(f"{name}.blocks.0.block.0", i, o, k)
        norm(f"{name}.blocks.0.block.1", o)
        conv(f"{name}.blocks.1.block.0", o, o, k)
        norm(f"{name}.blocks.1.block.1", o)
        lin(f"{name}.time_mlp.1", td, o)
        if i != o:
            conv(f"{name}.residual_conv", i, o, 1)

    lin("time_mlp.1", dim, 4 * td)
    lin("time_mlp.3", 4 * td, td)
    in_out = _dims(cfg)
    for i, (ci, co) in enumerate(in_out):
        res(f"downs.{i}.0", ci, co)
        res(f"downs.{i}.1", co, co)
        if i < len(in_out) - 1:
            conv(f"downs.{i}.2.conv", co, co, 3)
    mid = in_out[-1][1]
    res("mid_block1", mid, mid)
    res("mid_block2", mid, mid)
    for j, (di, do) in enumerate(reversed(in_out[1:])):
        res(f"ups.{j}.0", 2 * do, di)
        res(f"ups.{j}.1", di, di)
        conv_t(f"ups.{j}.2.conv", di, di, 4)
    conv("final_conv.0.block.0", dim, dim, k)
    norm("final_conv.0.block.1", dim)
    conv("final_conv.1", dim, D, 1)
    return specs


def sinusoidal(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(-scale * torch.arange(half, dtype=torch.float32,
                                            device=t.device))
    emb = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def time_embedding(w: Dict[str, torch.Tensor], t: torch.Tensor,
                   dim: int) -> torch.Tensor:
    """Mish of the time MLP's output, the input of every block's dense."""
    h = F.linear(sinusoidal(t, dim), w["time_mlp.1.weight"],
                 w["time_mlp.1.bias"])
    h = F.linear(F.mish(h), w["time_mlp.3.weight"], w["time_mlp.3.bias"])
    return F.mish(h)


def forward(w: Dict[str, torch.Tensor], cfg, x: torch.Tensor,
            t: torch.Tensor, prec: Callable = lambda v: v,
            cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """eps (B, H, D) from x (B, H, D) at steps t (B,). The U-Net takes no
    global condition: ``cond`` is ignored."""
    temb = time_embedding(w, t, cfg["dim"])

    def conv(h, name, stride=1, pad=None):
        wt = w[f"{name}.weight"]
        return F.conv1d(prec(h), prec(wt), w[f"{name}.bias"], stride,
                        wt.shape[-1] // 2 if pad is None else pad)

    def block(h, name):
        y = conv(h, f"{name}.block.0")
        y = F.group_norm(y, 8, w[f"{name}.block.1.weight"],
                         w[f"{name}.block.1.bias"], 1e-5)
        return F.mish(y)

    def res(h, name):
        te = F.linear(prec(temb), prec(w[f"{name}.time_mlp.1.weight"]),
                      w[f"{name}.time_mlp.1.bias"])
        a = block(h, f"{name}.blocks.0") + te[:, :, None]
        a = block(a, f"{name}.blocks.1")
        if f"{name}.residual_conv.weight" in w:
            return a + conv(h, f"{name}.residual_conv")
        return a + h

    in_out = _dims(cfg)
    h = x.transpose(1, 2)
    skips = []
    for i in range(len(in_out)):
        h = res(res(h, f"downs.{i}.0"), f"downs.{i}.1")
        skips.append(h)
        if i < len(in_out) - 1:
            h = conv(h, f"downs.{i}.2.conv", stride=2, pad=1)
    h = res(res(h, "mid_block1"), "mid_block2")
    for j in range(len(in_out) - 1):
        h = torch.cat([h, skips.pop()], dim=1)
        h = res(res(h, f"ups.{j}.0"), f"ups.{j}.1")
        h = F.conv_transpose1d(prec(h), prec(w[f"ups.{j}.2.conv.weight"]),
                               w[f"ups.{j}.2.conv.bias"], 2, 1)
    h = block(h, "final_conv.0")
    h = conv(h, "final_conv.1")
    return h.transpose(1, 2)
