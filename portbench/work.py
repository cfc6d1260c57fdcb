"""The work of a wave and of a model call, counted from shapes, and the
card's peaks: the yardstick of every roofline and MFU share. The counts
of a family are its own (``families/<family>.py``); the U-Net's stay
importable from here.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W: 989 TFLOP/s
bf16, 495 TFLOP/s TF32, 67 TFLOP/s float32 off the tensor cores, and
3.35 TB/s of HBM. A wave of the K2 planner chain (bf16 weights, bf16
products) is bound by the larger of its operations at the bf16 peak and its
bytes at the HBM rate, each input byte read once and each output byte
written once: weights, x_T, the step noise, the conditioning, the result,
the projection and the per-step operands.
"""

from __future__ import annotations

from typing import Tuple

from portbench import spec
from portbench.families.unet import (  # noqa: F401  (the U-Net's counts)
    conv_flops, n_res_blocks, unet_chain_step_flops, unet_convs)
from portbench.spec import PKG

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
HBM_BPS = 3.35e12


def model_flops(cfg, chains: int, pkg=PKG) -> float:
    """Products of one denoiser call on ``chains`` chains (the model FLOPs
    of MFU), as the configuration's family counts them."""
    return spec.family(cfg, pkg).model_flops(cfg, chains)


def wave_work(cfg, chains: int, pkg=PKG) -> Tuple[float, float]:
    """(operations, bytes) of one K2 wave of ``chains`` chains over the
    configuration's T steps, as its (K2) family counts them."""
    return spec.family(cfg, pkg).wave_work(cfg, chains)


def wave_least_s(cfg, chains: int, pkg=PKG) -> float:
    """The least time of one wave: operations at the bf16 peak or bytes at
    the HBM rate, whichever is longer."""
    flops, nbytes = wave_work(cfg, chains, pkg)
    return max(flops / PEAK_BF16, nbytes / HBM_BPS)


def product_peak(cfg) -> Tuple[float, str]:
    """The peak of the precision the configuration's products run in."""
    if cfg["product_dtype"] == "bfloat16":
        return PEAK_BF16, "bf16 989 TFLOP/s"
    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        return PEAK_TF32, "TF32 495 TFLOP/s"
    return PEAK_F32, "float32 67 TFLOP/s"
