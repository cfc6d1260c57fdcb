"""DiT-style temporal transformer denoiser: the second model family.

Counterpart of the JAX package's models/temporal_transformer.py (AdaLNBlock
:37, TemporalTransformer :82). The same ``(B, H, D) x (B,) -> (B, H, D)``
contract as ``TemporalUnet``, so it drops into ``GaussianDiffusion`` and
every sampler, policy, loss and trainer of the module path unchanged; the
planner chain (``--megakernel``) takes a U-Net only and refuses it.

Every product is a dense matmul, written as plain tensor ops as the XLA
module is (no fused attention call), so the CPU and the card run the JAX
module's arithmetic:

  * LayerNorm with epsilon 1e-6 (flax's default) and neither scale nor bias;
  * adaLN-Zero: ``Linear(6*dim)`` of ``silu(t_emb)``, zero-initialised, split
    into (shift1, scale1, gate1, shift2, scale2, gate2); a branch applies
    ``h * (1 + scale) + shift`` and adds ``gate * branch``;
  * attention as flax's MultiHeadDotProductAttention: the query divided by
    sqrt(head_dim) before the product, softmax over the keys, no mask and
    no dropout;
  * the final layer splits ``Linear(2*dim)`` into (shift, scale) and ends in
    a zero-initialised ``out_proj``, so a fresh model predicts zeros.

Module names follow the flax tree (``time_dense1``, ``blocks.{i}.adaln_mod``,
``blocks.{i}.attn.query`` ...), so io/torch_compat.py
``transformer_params_from_jax`` maps one onto the other. Kernels other than
the zero-initialised ones take flax's ``lecun_normal``; ``pos_emb`` is
normal(0.02) at (max_horizon, dim), sliced to the horizon.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dadiff_tpu_torch.envs.learned_model import _lecun_normal_
from dadiff_tpu_torch.models.temporal_unet import SinusoidalPosEmb

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


class Attention(nn.Module):
    """flax MultiHeadDotProductAttention(num_heads, qkv_features=dim,
    out_features=dim) on self-attention. ``query``/``key``/``value`` hold
    the flax (dim, heads, head_dim) kernels as (heads*head_dim, dim)
    weights; ``out`` the (heads, head_dim, dim) kernel as (dim,
    heads*head_dim)."""

    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} is not a multiple of n_heads "
                             f"{n_heads}")
        self.n_heads = n_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        B, H, C = h.shape
        hd = C // self.n_heads

        def heads(x):  # (B, H, C) -> (B, heads, H, head_dim)
            return x.reshape(B, H, self.n_heads, hd).transpose(1, 2)

        q = heads(self.query(h)) / (hd ** 0.5)
        k, v = heads(self.key(h)), heads(self.value(h))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out((w @ v).transpose(1, 2).reshape(B, H, C))


class AdaLNBlock(nn.Module):
    """Pre-LN transformer block with adaLN-Zero timestep modulation
    (temporal_transformer.py:37-79)."""

    def __init__(self, dim: int, n_heads: int, mlp_ratio: int = 4,
                 time_dim: Optional[int] = None):
        super().__init__()
        self.adaln_mod = nn.Linear(time_dim or dim, 6 * dim)
        self.attn = Attention(dim, n_heads)
        self.mlp1 = nn.Linear(dim, mlp_ratio * dim)
        self.mlp2 = nn.Linear(mlp_ratio * dim, dim)

    def forward(self, x: torch.Tensor, t_act: torch.Tensor) -> torch.Tensor:
        """``t_act`` is ``silu(t_emb)``, shared by every block."""
        s1, g1, gate1, s2, g2, gate2 = self.adaln_mod(t_act)[:, None, :] \
            .chunk(6, dim=-1)
        h = _layer_norm(x) * (1.0 + g1) + s1
        x = x + gate1 * self.attn(h)
        h = _layer_norm(x) * (1.0 + g2) + s2
        h = self.mlp2(F.mish(self.mlp1(h)))
        return x + gate2 * h


class TemporalTransformer(nn.Module):
    """Timestep-conditioned transformer over the horizon axis
    (temporal_transformer.py:82-168): any horizon up to ``max_horizon``."""

    def __init__(self, transition_dim: int, dim: int = 128, depth: int = 4,
                 n_heads: int = 4, mlp_ratio: int = 4,
                 time_dim: Optional[int] = None, max_horizon: int = 512):
        super().__init__()
        self.transition_dim = transition_dim
        self.dim, self.depth, self.n_heads = dim, depth, n_heads
        self.mlp_ratio, self.max_horizon = mlp_ratio, max_horizon
        self.time_dim = td = time_dim or dim
        self.time_pos_emb = SinusoidalPosEmb(dim)
        self.time_dense1 = nn.Linear(dim, td * 4)
        self.time_dense2 = nn.Linear(td * 4, td)
        self.pos_emb = nn.Parameter(torch.empty(max_horizon, dim))
        self.in_proj = nn.Linear(transition_dim, dim)
        self.blocks = nn.ModuleList(
            AdaLNBlock(dim, n_heads, mlp_ratio, td) for _ in range(depth))
        self.final_mod = nn.Linear(td, 2 * dim)
        self.out_proj = nn.Linear(dim, transition_dim)
        self._init()

    # U-Net config-surface compat: configs that record dim_mults read ()
    @property
    def dim_mults(self) -> Tuple[int, ...]:
        return ()

    @torch.no_grad()
    def _init(self) -> None:
        """flax's initialisers, drawn from torch's global generator (which
        the train CLI seeds): lecun_normal kernels and zero biases, zero
        kernels for the adaLN projections and ``out_proj``, normal(0.02)
        for ``pos_emb``."""
        zero = {"final_mod", "out_proj"} | {
            f"blocks.{i}.adaln_mod" for i in range(self.depth)}
        for name, m in self.named_modules():
            if isinstance(m, nn.Linear):
                if name in zero:
                    m.weight.zero_()
                else:
                    _lecun_normal_(m.weight, None)
                m.bias.zero_()
        self.pos_emb.normal_(0.0, 0.02)

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        horizon = x.shape[1]
        if horizon > self.max_horizon:
            raise ValueError(f"horizon {horizon} exceeds max_horizon "
                             f"{self.max_horizon}")
        t = self.time_dense2(F.mish(self.time_dense1(self.time_pos_emb(time))))
        t_act = F.silu(t)
        h = self.in_proj(x.to(torch.float32)) + self.pos_emb[None, :horizon]
        for block in self.blocks:
            h = block(h, t_act)
        shift, scale = self.final_mod(t_act)[:, None, :].chunk(2, dim=-1)
        h = _layer_norm(h) * (1.0 + scale) + shift
        return self.out_proj(h).to(torch.float32)
