"""Rounding of a product's operands to the precision a configuration
states, and to the one below it (the control)."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return t.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(
        torch.float32)


ROUNDING = {"float32": identity, "bfloat16": bf16, "float8_e4m3fn": fp8}

# the precision the control computes in, below each stated one
BELOW = {"bfloat16": "float8_e4m3fn", "float32": "tf32"}


@contextlib.contextmanager
def float32_products(tf32: bool = False):
    """Products in true float32 (TF32 off), or in TF32 for the control."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
