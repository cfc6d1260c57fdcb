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

``dtype`` is the activation dtype (JAX's ``dtype``, float32 or bfloat16),
cast as flax casts it: the weights stay float32; every dense layer casts
its input, weight and bias (``Dense(dtype=)``); the residual stream, the
adaLN modulation, Mish and SiLU run in ``dtype``; LayerNorm computes its
statistics and its normalisation in float32 and returns ``dtype`` (flax's
``_compute_stats`` promotes to float32, ``_normalize`` casts the result);
attention scales the query by ``sqrt(head_dim)`` rounded to ``dtype`` and
takes its softmax in ``dtype`` (flax's ``force_fp32_for_softmax`` is off);
the sinusoidal embedding is float32 and the output returns to float32
(temporal_transformer.py:162).

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
from dadiff_tpu_torch.parallel.tp import Sharded

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(use_bias=False, use_scale=False, dtype=x.dtype)``:
    float32 inside, ``x``'s dtype out."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=LN_EPS).to(x.dtype)


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

    def forward(self, h: torch.Tensor, view: Sharded) -> torch.Tensor:
        """Self-attention of this rank's query rows against every rank's
        keys and values, over this rank's heads (all of them without a
        mesh)."""
        B, H, C = h.shape
        hd = self.query.in_features // self.n_heads

        def heads(x):  # (B, rows, heads*hd) -> (B, heads, rows, head_dim)
            return x.reshape(B, x.shape[1], -1, hd).transpose(1, 2)

        q = view.dense((h, False), self.query, rows=True)
        k = view.dense((h, False), self.key, rows=True)
        v = view.dense((h, False), self.value, rows=True)
        k_all = view.sp.copy(view.sp.gather(k[0], 1))
        v_all = view.sp.copy(view.sp.gather(v[0], 1))
        # flax divides by jnp.sqrt(depth).astype(dtype)
        scale = torch.tensor(hd ** 0.5).to(q[0].dtype).item()
        w = torch.softmax(heads(q[0]) / scale
                          @ heads(k_all).transpose(-1, -2), dim=-1)
        o = (w @ heads(v_all)).transpose(1, 2).reshape(B, H, -1)
        return view.whole(view.dense((o, q[1]), self.out, rows=True))


class AdaLNBlock(nn.Module):
    """Pre-LN transformer block with adaLN-Zero timestep modulation
    (temporal_transformer.py:37-79)."""

    def __init__(self, dim: int, n_heads: int, mlp_ratio: int = 4,
                 time_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.adaln_mod = nn.Linear(time_dim or dim, 6 * dim)
        self.attn = Attention(dim, n_heads)
        self.mlp1 = nn.Linear(dim, mlp_ratio * dim)
        self.mlp2 = nn.Linear(mlp_ratio * dim, dim)

    def forward(self, x: torch.Tensor, t_act: torch.Tensor,
                view: Sharded) -> torch.Tensor:
        """``t_act`` is ``silu(t_emb)``, shared by every block; ``x`` this
        rank's rows of the residual stream."""
        mod = view.whole(view.dense((t_act, False), self.adaln_mod,
                                    rows=False))
        s1, g1, gate1, s2, g2, gate2 = view.sp.copy(mod)[:, None, :] \
            .chunk(6, dim=-1)
        h = _layer_norm(x) * (1.0 + g1) + s1
        x = x + gate1 * self.attn(h, view)
        h = _layer_norm(x) * (1.0 + g2) + s2
        h = view.dense((h, False), self.mlp1, rows=True)
        h = view.whole(view.dense((F.mish(h[0]), h[1]), self.mlp2, rows=True))
        return x + gate2 * h


class TemporalTransformer(nn.Module):
    """Timestep-conditioned transformer over the horizon axis
    (temporal_transformer.py:82-168): any horizon up to ``max_horizon``.
    ``act_spec`` names the (batch, horizon, channel) mesh axes, as in
    ``TemporalUnet`` (temporal_transformer.py:96-110). The one forward runs
    through ``parallel.tp.Sharded``: once ``shard_params_tp`` has placed the
    weights on a mesh it shards the horizon over sp and the heads and the
    MLP's hidden units over tp; without a mesh every step is the plain
    operation."""

    def __init__(self, transition_dim: int, dim: int = 128, depth: int = 4,
                 n_heads: int = 4, mlp_ratio: int = 4,
                 time_dim: Optional[int] = None, max_horizon: int = 512,
                 act_spec: Optional[Tuple[Optional[str], ...]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_spec = act_spec
        self.dtype = dtype
        self.mesh = None  # set by parallel.tp.shard_params_tp
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
            AdaLNBlock(dim, n_heads, mlp_ratio, td, dtype)
            for _ in range(depth))
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
        view = Sharded(self)
        horizon = x.shape[1]
        if horizon > self.max_horizon:
            raise ValueError(f"horizon {horizon} exceeds max_horizon "
                             f"{self.max_horizon}")
        if horizon % view.sp.size:
            raise ValueError(f"horizon {horizon} does not split over sp "
                             f"{view.sp.size}")
        t = view.dense((self.time_pos_emb(time), False), self.time_dense1,
                       rows=False)
        t = view.dense((F.mish(t[0]), t[1]), self.time_dense2, rows=False)
        t_act = F.silu(view.whole(t))
        x = view.sp.scatter(x.to(self.dtype), 1)
        pos = view.param(self.pos_emb, rows=True)[view.sp.block(horizon)]
        h = view.whole(view.dense((x, False), self.in_proj, rows=True)) \
            + pos[None].to(self.dtype)
        for block in self.blocks:
            h = block(h, t_act, view)
        mod = view.whole(view.dense((t_act, False), self.final_mod,
                                    rows=False))
        shift, scale = view.sp.copy(mod)[:, None, :].chunk(2, dim=-1)
        h = _layer_norm(h) * (1.0 + scale) + shift
        out = view.whole(view.dense((h, False), self.out_proj, rows=True))
        return view.sp.gather(out, 1).to(torch.float32)
