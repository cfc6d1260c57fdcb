"""Numerical-anomaly detection and debugging aids.

Counterpart of the JAX package's utils/debug.py (check_finite_pytree :17,
tree_all_finite :28, finite_or_skip :36, debug_nans :50) on tensors and
their containers.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Tuple

import torch
from torch.utils._pytree import tree_flatten_with_path, tree_leaves, \
    tree_map, keystr


def _tensors(tree: Any) -> Any:
    """A module's named parameters and buffers, or ``tree`` itself."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.state_dict(keep_vars=True))
    return tree


def check_finite(tree: Any, name: str = "tree") -> List[str]:
    """Host-side audit: the paths of the floating tensors of ``tree`` (or
    of a module's state) that hold a non-finite value; empty when all are
    finite (debug.py:17-25)."""
    bad = []
    for path, leaf in tree_flatten_with_path(_tensors(tree))[0]:
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and not bool(torch.isfinite(leaf.detach()).all())):
            bad.append(f"{name}{keystr(path)}")
    return bad


def all_finite(tree: Any) -> torch.Tensor:
    """One boolean tensor, on the tensors' device: every tensor of ``tree``
    is finite (debug.py:28-33). Reading it on the host waits for the
    card."""
    leaves = [x for x in tree_leaves(_tensors(tree))
              if isinstance(x, torch.Tensor)]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x.detach()).all() for x in leaves]
                       ).all()


def finite_or_skip(grads: Any) -> Tuple[Any, torch.Tensor]:
    """``(grads or zeros, all_finite flag)`` (debug.py:36-47): a bad batch
    zeroes its update instead of poisoning the parameters. No host sync."""
    finite = all_finite(grads)
    safe = tree_map(lambda g: torch.where(finite, g, torch.zeros_like(g))
                    if isinstance(g, torch.Tensor) else g, grads)
    return safe, finite


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped anomaly detection: a backward that makes a NaN raises at the
    forward op that caused it (slow; debug only). JAX's ``jax_debug_nans``
    (debug.py:50-57) on ``torch.autograd.set_detect_anomaly``."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)
