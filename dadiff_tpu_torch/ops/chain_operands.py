"""Host side of the planner chain: the layer plan, the flattened weights and
the per-step operands.

Counterpart of the JAX package's ops/pallas_unet.py: _resblock_entries :45,
_layer_plan :68, flatten_unet_params :126 and prepare_chain_operands :454
(with the ``_time_embedding`` it imports from models/fused_unet.py:33).

Flattened layout, as on the TPU: a k-tap conv kernel becomes (k*cin, cout)
with tap-major rows (matching the shifted-stack column order); a
ConvTranspose1d kernel becomes the stacked per-tap (4*cin, cout)
[R0;R1;R2;R3] with R_tap = kernel[tap].T in the JAX (k, out, in) layout;
dense kernels (in, out); vectors (1, c) float32. Matrices take
``weight_dtype`` (bf16 or f32).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from dadiff_tpu_torch.ops.gn_mish import mish
from dadiff_tpu_torch.ops.schedules import DiffusionSchedule


def _resblock_entries(name: str, cin: int, cout: int):
    """(name, path, kind) entries of one ResidualTemporalBlock, in the order
    the chain consumes them (pallas_unet.py:45-65)."""
    ent = [
        (name, "block1.conv.kernel", "conv"),
        (name, "block1.conv.bias", "vec"),
        (name, "block1.norm.scale", "vec"),
        (name, "block1.norm.bias", "vec"),
        (name, "time_dense.kernel", "mat"),
        (name, "time_dense.bias", "vec"),
        (name, "block2.conv.kernel", "conv"),
        (name, "block2.conv.bias", "vec"),
        (name, "block2.norm.scale", "vec"),
        (name, "block2.norm.bias", "vec"),
    ]
    if cin != cout:
        ent += [
            (name, "residual_conv.kernel", "conv1"),
            (name, "residual_conv.bias", "vec"),
        ]
    return ent


def _layer_plan(unet) -> Tuple[list, list]:
    """Static walk of the architecture: the (op, meta) list in forward order
    and the flattened-weight entry list (pallas_unet.py:68-116)."""
    dims = [unet.transition_dim] + [unet.dim * m for m in unet.dim_mults]
    in_out = list(zip(dims[:-1], dims[1:]))
    n_levels = len(in_out)
    ops, entries = [], []

    def res(name, cin, cout):
        ops.append(("res", name, cin, cout))
        entries.extend(_resblock_entries(name, cin, cout))

    for i, (cin, cout) in enumerate(in_out):
        res(f"down_{i}_res1", cin, cout)
        res(f"down_{i}_res2", cout, cout)
        ops.append(("push_skip", i, cout))
        if i < n_levels - 1:
            ops.append(("down", f"down_{i}_downsample", cout, cout))
            entries.append((f"down_{i}_downsample", "kernel", "conv"))
            entries.append((f"down_{i}_downsample", "bias", "vec"))
    mid = dims[-1]
    res("mid_block1", mid, mid)
    res("mid_block2", mid, mid)
    for i, (dim_in, dim_out) in enumerate(reversed(in_out[1:])):
        ops.append(("pop_skip", n_levels - 1 - i, dim_out))
        res(f"up_{i}_res1", dim_out * 2, dim_in)
        res(f"up_{i}_res2", dim_in, dim_in)
        ops.append(("up", f"up_{i}_upsample", dim_in, dim_in))
        entries.append((f"up_{i}_upsample", "kernel", "convT"))
        entries.append((f"up_{i}_upsample", "bias", "vec"))
    ops.append(("res_plain", "final_block", unet.dim, unet.dim))
    entries.extend([
        ("final_block", "conv.kernel", "conv"),
        ("final_block", "conv.bias", "vec"),
        ("final_block", "norm.scale", "vec"),
        ("final_block", "norm.bias", "vec"),
    ])
    ops.append(("final_conv", "final_conv", unet.dim, unet.transition_dim))
    entries.extend([
        ("final_conv", "kernel", "conv1"),
        ("final_conv", "bias", "vec"),
    ])
    return ops, entries


def _module_of(unet, name: str) -> nn.Module:
    """The torch module a JAX-side layer name refers to."""
    if name.startswith(("down_", "up_")):
        side, i, part = name.split("_", 2)
        blocks = unet.downs if side == "down" else unet.ups
        idx = {"res1": 0, "res2": 1, "downsample": 2, "upsample": 2}[part]
        mod = blocks[int(i)][idx]
        return mod.conv if idx == 2 else mod
    if name == "final_block":
        return unet.final_conv[0]
    if name == "final_conv":
        return unet.final_conv[1]
    return getattr(unet, name)


_SUBMODULE = {
    "block1.conv": lambda m: m.blocks[0].block[0],
    "block1.norm": lambda m: m.blocks[0].block[1],
    "block2.conv": lambda m: m.blocks[1].block[0],
    "block2.norm": lambda m: m.blocks[1].block[1],
    "time_dense": lambda m: m.time_mlp[1],
    "residual_conv": lambda m: m.residual_conv,
    "conv": lambda m: m.block[0],
    "norm": lambda m: m.block[1],
}


def _param(unet, name: str, path: str) -> torch.Tensor:
    mod = _module_of(unet, name)
    *sub, leaf = path.split(".")
    if sub:
        mod = _SUBMODULE[".".join(sub)](mod)
    return mod.weight if leaf in ("kernel", "scale") else mod.bias


@torch.no_grad()
def flatten_unet_params(unet, weight_dtype=torch.bfloat16) -> List[torch.Tensor]:
    """TemporalUnet weights -> the ordered list of 2-D tensors the chain
    consumes (pallas_unet.py:126-154), on the module's device."""
    _, entries = _layer_plan(unet)
    flat = []
    for name, path, kind in entries:
        a = _param(unet, name, path).detach().to(torch.float32)
        if kind == "conv":      # torch (cout, cin, k) -> (k*cin, cout)
            cout, cin, k = a.shape
            m = a.permute(2, 1, 0).reshape(k * cin, cout)
        elif kind == "conv1":   # torch (cout, cin, 1) -> (cin, cout)
            m = a[:, :, 0].t()
        elif kind == "convT":   # torch (in, out, k) -> [R0;..;R3], R_t (in, out)
            m = torch.cat([a[:, :, t] for t in range(a.shape[2])], dim=0)
        elif kind == "mat":     # torch Linear (out, in) -> (in, out)
            m = a.t()
        elif kind == "vec":
            flat.append(a.reshape(1, -1).contiguous())
            continue
        else:
            raise ValueError(kind)
        flat.append(m.to(weight_dtype).contiguous())
    return flat


@torch.no_grad()
def _time_embedding(unet, ts: torch.Tensor) -> torch.Tensor:
    """Sinusoidal embedding -> dense -> mish -> dense (fused_unet.py:33-41)."""
    return unet.time_mlp(ts)


@torch.no_grad()
def prepare_chain_operands(unet, schedule: DiffusionSchedule, ts: torch.Tensor,
                           weight_dtype=torch.bfloat16):
    """Flattened weights, pre-Mish'd per-step time embeddings (T, time_dim)
    and the per-step DDPM scalars (T, 8): lanes recip, recipm1, c1, c2,
    sigma (zero at t == 0), and lane 5 left for the projection alpha
    (pallas_unet.py:454-478)."""
    flat_w = flatten_unet_params(unet, weight_dtype)
    ts = ts.to(schedule.betas.device)
    m_embs = mish(_time_embedding(unet, ts)).to(torch.float32).contiguous()
    scal = torch.zeros(len(ts), 8, dtype=torch.float32, device=ts.device)
    scal[:, 0] = schedule.sqrt_recip_alphas_cumprod[ts]
    scal[:, 1] = schedule.sqrt_recipm1_alphas_cumprod[ts]
    scal[:, 2] = schedule.posterior_mean_coef1[ts]
    scal[:, 3] = schedule.posterior_mean_coef2[ts]
    sigma = torch.exp(0.5 * schedule.posterior_log_variance_clipped[ts])
    scal[:, 4] = sigma * (ts != 0)
    return flat_w, m_embs, scal
