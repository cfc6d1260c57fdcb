"""Launch-minimal U-Net forward built on the fused residual block (K4).

Counterpart of the JAX package's models/fused_unet.py: _block_params :44,
_res_block :61, unet_apply_fused :69 and make_fused_apply :131. It reads the
weights of the port's ``TemporalUnet`` module, so checkpoints are
interchangeable, but runs each ResidualTemporalBlock as ONE launch of the K4
kernel (ops/resblock.py) instead of two convs, two norms, two activations
and the adds. Down/up sampling, the final k=5 conv and the final 1x1 stay
library convs, as they stay XLA convs in the JAX package (:94-128); the
final GroupNorm+Mish goes through K1 (:121-126).

Aimed at the batch-1 planning path. ``use_kernel=None`` picks the kernels
for tensors on the card and the plain versions on the CPU; ``False`` takes
the plain versions anywhere (the reference rung of the latency ladder).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from dadiff_tpu_torch.ops.chain_operands import _time_embedding
from dadiff_tpu_torch.ops.gn_mish import gn_mish, gn_mish_plain
from dadiff_tpu_torch.ops.resblock import (
    fused_residual_block,
    residual_block_plain,
)


def _block_params(block) -> Dict[str, torch.Tensor]:
    """A ResidualTemporalBlock module's weights in the layout of
    ops/resblock.py: conv kernels (k, Cin, Cout), contiguous
    (fused_unet.py:44-58)."""
    (conv1, norm1, _), (conv2, norm2, _) = (b.block for b in block.blocks)
    out = {
        "w1": conv1.weight.permute(2, 1, 0).contiguous(), "b1": conv1.bias,
        "s1": norm1.weight, "g1": norm1.bias,
        "w2": conv2.weight.permute(2, 1, 0).contiguous(), "b2": conv2.bias,
        "s2": norm2.weight, "g2": norm2.bias,
    }
    if isinstance(block.residual_conv, torch.nn.Conv1d):
        out["wr"] = block.residual_conv.weight[:, :, 0].t().contiguous()
        out["br"] = block.residual_conv.bias
    return out


def _res_blocks(unet) -> List:
    """The residual blocks in forward order."""
    blocks = [b for level in unet.downs for b in level[:2]]
    blocks += [unet.mid_block1, unet.mid_block2]
    return blocks + [b for level in unet.ups for b in level[:2]]


def fused_block_params(unet) -> List[Dict[str, torch.Tensor]]:
    """``_block_params`` of every residual block in forward order: compute
    once outside a sampling loop and pass as ``block_params``."""
    return [_block_params(b) for b in _res_blocks(unet)]


def _res_block(block, bp, x, t_emb, use_kernel: bool):
    te = block.time_mlp(t_emb)  # mish -> dense (fused_unet.py:62)
    if use_kernel:
        return fused_residual_block(x.contiguous(), te.contiguous(), bp)
    return residual_block_plain(x, te, bp)


def unet_apply_fused(unet, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                     use_kernel: Optional[bool] = None,
                     t_emb: Optional[torch.Tensor] = None,
                     block_params=None) -> torch.Tensor:
    """Fused-forward equivalent of ``unet(x, t)`` on (B, H, D)
    (fused_unet.py:69-128). ``t_emb`` may be precomputed (once for all
    timesteps outside a sampling loop) to skip the in-step time MLP."""
    if t is None and t_emb is None:
        raise ValueError("unet_apply_fused needs t (timesteps) or t_emb")
    if use_kernel is None:
        use_kernel = x.device.type != "cpu"
    if t_emb is None:
        t_emb = unet.time_mlp(t)
    params = iter(block_params if block_params is not None
                  else fused_block_params(unet))

    def res(block, x):
        return _res_block(block, next(params), x, t_emb, use_kernel)

    def conv(mod, x):  # library conv on (B, H, C)
        return mod(x.transpose(1, 2)).transpose(1, 2)

    x = x.to(torch.float32)
    skips = []
    for res1, res2, down in unet.downs:
        x = res(res2, res(res1, x))
        skips.append(x)
        if not isinstance(down, torch.nn.Identity):
            x = conv(down.conv, x)
    x = res(unet.mid_block2, res(unet.mid_block1, x))
    for res1, res2, up in unet.ups:
        x = torch.cat([x, skips.pop()], dim=-1)
        x = conv(up.conv, res(res2, res(res1, x)))
    # final head: Conv1dBlock + 1x1 conv
    block, final = unet.final_conv
    fconv, norm, _ = block.block
    h = conv(fconv, x).contiguous()
    h = (gn_mish if use_kernel else gn_mish_plain)(
        h, norm.weight, norm.bias, norm.num_groups, norm.eps)
    return F.linear(h, final.weight[:, :, 0], final.bias)


def make_fused_apply(unet, use_kernel: Optional[bool] = None):
    """apply_fn(x, t) drop-in for samplers and benchmarks
    (fused_unet.py:131-137)."""

    def apply_fn(x, t):
        return unet_apply_fused(unet, x, t, use_kernel=use_kernel)

    return apply_fn
