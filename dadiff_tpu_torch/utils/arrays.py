"""Array utilities: host <-> device moves, normalisation and seeding.

Counterpart of the JAX package's utils/arrays.py (to_np :40, batch_to_device
:47, normalize :60, unnormalize :65, atleast_2d :70, apply_dict :77,
set_seed :82) on tensors; JAX's ``to_jnp`` is ``torch.as_tensor``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def to_np(x: Any) -> np.ndarray:
    """Tensor (on any device) or array-like -> host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def batch_to_device(batch: Dict[str, Any], device="cuda",
                    dtype: torch.dtype = None) -> Dict[str, Any]:
    """Every array or tensor of a batch dict onto ``device`` (as
    ``dtype`` when given); other values pass through (arrays.py:47-57)."""
    out = {}
    for key, val in batch.items():
        if isinstance(val, (np.ndarray, torch.Tensor)):
            out[key] = torch.as_tensor(val, dtype=dtype, device=device)
        else:
            out[key] = val
    return out


def normalize(x: Array, mean: Array, std: Array) -> Array:
    """(x - mean) / (std + 1e-8)."""
    return (x - mean) / (std + 1e-8)


def unnormalize(x: Array, mean: Array, std: Array) -> Array:
    """x * (std + 1e-8) + mean."""
    return x * (std + 1e-8) + mean


def atleast_2d(x: Array) -> Array:
    """Prepend axes until ndim >= 2."""
    while x.ndim < 2:
        x = x[None]
    return x


def apply_dict(fn: Callable, d: Dict) -> Dict:
    """Apply ``fn`` to every value."""
    return {k: fn(v) for k, v in d.items()}


def set_seed(seed: int, device="cpu") -> torch.Generator:
    """Seed numpy's and torch's global generators and return a generator
    on ``device`` seeded with ``seed``: the counterpart of JAX's root
    ``PRNGKey(seed)`` (arrays.py:82-93)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
