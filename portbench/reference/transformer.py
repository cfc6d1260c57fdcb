"""The DiT-style temporal transformer (Peebles and Xie, adaLN-Zero), plain
PyTorch on a dict of weights: a sinusoidal time embedding through a
two-layer Mish MLP, SiLU, and per block a modulation into (shift, scale,
gate) for attention and for the MLP; LayerNorm without scale or bias
(epsilon 1e-6); attention with the query divided by sqrt(head_dim); a
final modulated LayerNorm and an output projection. Float32 throughout.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.unet import sinusoidal

LN_EPS = 1e-6


def param_specs(cfg) -> List[tuple]:
    """(name, shape, init, fan_in): PyTorch's default linear init for every
    dense layer, N(0, 0.02) for the positional table."""
    dim, D, td = cfg["dim"], cfg["transition_dim"], cfg["dim"]
    hidden = cfg["mlp_ratio"] * dim
    specs = [("pos_emb", (cfg["max_horizon"], dim), "normal02", 0)]

    def lin(name, i, o):
        specs.extend([(f"{name}.weight", (o, i), "uniform", i),
                      (f"{name}.bias", (o,), "uniform", i)])

    lin("time_dense1", dim, 4 * td)
    lin("time_dense2", 4 * td, td)
    lin("in_proj", D, dim)
    for b in range(cfg["depth"]):
        p = f"blocks.{b}"
        lin(f"{p}.adaln_mod", td, 6 * dim)
        for name in ("query", "key", "value", "out"):
            lin(f"{p}.attn.{name}", dim, dim)
        lin(f"{p}.mlp1", dim, hidden)
        lin(f"{p}.mlp2", hidden, dim)
    lin("final_mod", td, 2 * dim)
    lin("out_proj", dim, D)
    return specs


def _ln(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


def forward(w: Dict[str, torch.Tensor], cfg, x: torch.Tensor,
            t: torch.Tensor, prec=None,
            cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """eps (B, H, D) from x (B, H, D) at steps t (B,). The transformer
    takes no global condition: ``cond`` is ignored."""
    B, H, _ = x.shape
    heads = cfg["n_heads"]
    hd = cfg["dim"] // heads

    def lin(v, name):
        return F.linear(v, w[f"{name}.weight"], w[f"{name}.bias"])

    t_act = F.silu(lin(F.mish(lin(sinusoidal(t, cfg["dim"]), "time_dense1")),
                       "time_dense2"))
    h = lin(x, "in_proj") + w["pos_emb"][:H][None]
    for b in range(cfg["depth"]):
        p = f"blocks.{b}"
        s1, g1, gate1, s2, g2, gate2 = lin(t_act, f"{p}.adaln_mod")[
            :, None, :].chunk(6, dim=-1)
        a = _ln(h) * (1.0 + g1) + s1

        def split(v):
            return v.reshape(B, H, heads, hd).transpose(1, 2)

        q = split(lin(a, f"{p}.attn.query"))
        kk = split(lin(a, f"{p}.attn.key"))
        v = split(lin(a, f"{p}.attn.value"))
        att = torch.softmax(q / (hd ** 0.5) @ kk.transpose(-1, -2), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(B, H, -1)
        h = h + gate1 * lin(o, f"{p}.attn.out")
        a = _ln(h) * (1.0 + g2) + s2
        h = h + gate2 * lin(F.mish(lin(a, f"{p}.mlp1")), f"{p}.mlp2")
    shift, scale = lin(t_act, "final_mod")[:, None, :].chunk(2, dim=-1)
    return lin(_ln(h) * (1.0 + scale) + shift, "out_proj")
