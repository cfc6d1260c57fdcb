"""The temporal U-Net of Janner et al. (Diffuser): the port's
``TemporalUnet``, planned by K2 (``ops/planner.py`` on ``csrc/planner.cu``),
and its work counted from shapes: every conv of a forward, each block's
time dense and the time MLP."""

from __future__ import annotations

from typing import List, Tuple

PLANNER = "k2"

SAME, DOWN, UP = "same", "down", "up"


def denoiser(cfg):
    """The port's denoiser, built by the CLI's own builder."""
    from dadiff_tpu_torch.cli import build_denoiser

    return build_denoiser("unet", cfg["transition_dim"], dim=cfg["dim"],
                          dim_mults=tuple(cfg["dim_mults"]),
                          kernel_size=cfg["kernel_size"])


def unet_convs(cfg) -> List[Tuple[str, int, int, int, int, bool]]:
    """Every conv of one U-Net forward on one chain: (mode, rows in, cin,
    cout, taps, followed by a GroupNorm)."""
    dim, k, D, H = cfg["dim"], cfg["kernel_size"], cfg["transition_dim"], \
        cfg["horizon"]
    dims = [D] + [dim * m for m in cfg["dim_mults"]]
    in_out = list(zip(dims[:-1], dims[1:]))
    convs, L = [], H

    def res(ci, co):
        convs.append((SAME, L, ci, co, k, True))
        if ci != co:
            convs.append((SAME, L, ci, co, 1, False))
        convs.append((SAME, L, co, co, k, True))

    for i, (ci, co) in enumerate(in_out):
        res(ci, co)
        res(co, co)
        if i < len(in_out) - 1:
            convs.append((DOWN, L, co, co, 3, False))
            L //= 2
    mid = in_out[-1][1]
    res(mid, mid)
    res(mid, mid)
    for di, do in reversed(in_out[1:]):
        res(2 * do, di)
        res(di, di)
        convs.append((UP, L, di, di, 4, False))
        L *= 2
    convs.append((SAME, L, dim, dim, k, True))
    convs.append((SAME, L, dim, D, 1, False))
    return convs


def conv_flops(mode: str, rows: int, cin: int, cout: int, taps: int) -> float:
    """Multiply-adds x 2 of a conv over ``rows`` input rows: a stride-2
    conv makes rows/2 outputs of ``taps`` taps, a transposed conv 2 x rows
    outputs of two taps each."""
    if mode == DOWN:
        return 2.0 * (rows // 2) * taps * cin * cout
    if mode == UP:
        return 2.0 * (2 * rows) * 2 * cin * cout
    return 2.0 * rows * taps * cin * cout


def n_res_blocks(cfg) -> List[int]:
    """The output width of every residual block, in order."""
    dim = cfg["dim"]
    dims = [cfg["transition_dim"]] + [dim * m for m in cfg["dim_mults"]]
    in_out = list(zip(dims[:-1], dims[1:]))
    outs = [co for _, co in in_out for _ in range(2)]
    outs += [in_out[-1][1]] * 2
    outs += [di for di, _ in reversed(in_out[1:]) for _ in range(2)]
    return outs


def unet_chain_step_flops(cfg) -> float:
    """The convs of one forward on one chain of ``horizon`` rows."""
    return sum(conv_flops(m, r, ci, co, t)
               for m, r, ci, co, t, _ in unet_convs(cfg))


def model_flops(cfg, chains: int) -> float:
    """Products of one denoiser call on ``chains`` chains: its convs, each
    block's time dense and the time MLP."""
    td = cfg["dim"]
    per_chain = unet_chain_step_flops(cfg)
    per_chain += sum(2.0 * td * co for co in n_res_blocks(cfg))
    per_chain += 2.0 * cfg["dim"] * 4 * td + 2.0 * 4 * td * td
    return chains * per_chain


def wave_work(cfg, chains: int) -> Tuple[float, float]:
    """(operations, bytes) of one K2 wave of ``chains`` chains over the
    configuration's T steps."""
    T, H, D = cfg["n_timesteps"], cfg["horizon"], cfg["transition_dim"]
    td = cfg["dim"]
    rows = chains * H
    HD = H * D
    flops = T * chains * unet_chain_step_flops(cfg)
    flops += 2.0 * T * chains * HD * HD                      # projection
    flops += sum(2.0 * T * td * co for co in n_res_blocks(cfg))  # time dense
    w_bytes = 0
    for m, _, ci, co, taps, gn in unet_convs(cfg):
        w_bytes += 2 * taps * ci * co + 4 * co + (8 * co if gn else 0)
    w_bytes += sum(2 * td * co + 4 * co for co in n_res_blocks(cfg))
    nbytes = (w_bytes + 4 * rows * D * (T + 3) + 4 * HD * HD
              + 4 * T * (8 + td))
    return flops, float(nbytes)
