"""The DiT-style adaLN-Zero temporal transformer (Peebles and Xie): the
port's ``TemporalTransformer``, planned on the module path
(``guides/sampling.py``), and its work counted from shapes: every dense
layer and both attention products."""

from __future__ import annotations

PLANNER = "module"


def denoiser(cfg):
    """The port's denoiser, built by the CLI's own builder."""
    from dadiff_tpu_torch.cli import build_denoiser

    return build_denoiser("transformer", cfg["transition_dim"],
                          dim=cfg["dim"], depth=cfg["depth"],
                          n_heads=cfg["n_heads"],
                          mlp_ratio=cfg["mlp_ratio"])


def model_flops(cfg, chains: int) -> float:
    """Products of one denoiser call on ``chains`` chains."""
    td = cfg["dim"]
    d, H, D = cfg["dim"], cfg["horizon"], cfg["transition_dim"]
    hidden = cfg["mlp_ratio"] * d
    block = (2.0 * H * d * d * 4          # query, key, value, out
             + 2.0 * H * H * d * 2        # scores and the weighted sum
             + 2.0 * H * d * hidden * 2   # the MLP
             + 2.0 * td * 6 * d)          # the modulation
    per_chain = (cfg["depth"] * block + 2.0 * H * D * d * 2
                 + 2.0 * td * 2 * d + 2.0 * d * 4 * td + 2.0 * 4 * td * td)
    return chains * per_chain
