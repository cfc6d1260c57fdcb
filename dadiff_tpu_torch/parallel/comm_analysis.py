"""The collectives a sharded forward or train step issues.

Counterpart of the JAX package's parallel/comm_analysis.py
(collective_summary :63, weight_gather_violations :93). JAX reads them from
the compiled HLO, where GSPMD decided them; here the sharded forward writes
them out (parallel/tp.py), and each one it issues, in the forward and in the
backward, is recorded into every open :class:`CollectiveCounter` with its
result's shape and bytes. A test can then assert the structure: tp
all-reduces partial sums, sp moves only boundary rows, and no all-gather
rebuilds a whole weight.
"""

from __future__ import annotations

from typing import Dict, List

import torch

# counters open now; the backward runs on autograd's threads, which a
# context variable would not reach
_OPEN: List["CollectiveCounter"] = []


class CollectiveCounter:
    """``with CollectiveCounter() as c:`` records every collective of
    parallel/tp.py issued inside the block; ``c.summary`` is
    ``{kind: {"count", "bytes", "result_shapes"}}`` with the kinds named as
    the JAX summary names them (``all-reduce``, ``all-gather``)."""

    def __init__(self):
        self.summary: Dict[str, Dict] = {}

    def __enter__(self) -> "CollectiveCounter":
        _OPEN.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _OPEN.remove(self)

    def add(self, kind: str, result: torch.Tensor) -> None:
        entry = self.summary.setdefault(
            kind, {"count": 0, "bytes": 0, "result_shapes": []})
        entry["count"] += 1
        entry["bytes"] += result.numel() * result.element_size()
        entry["result_shapes"].append(tuple(result.shape))


def record(kind: str, result: torch.Tensor) -> None:
    """Count one collective of ``kind`` whose result is ``result``."""
    for counter in _OPEN:
        counter.add(kind, result)


def collective_summary(counter: CollectiveCounter) -> Dict:
    """``{kind: {"count": n, "bytes": total result bytes, "result_shapes":
    [...]}}`` of a counter's block (comm_analysis.py:63-90)."""
    return counter.summary


def weight_gather_violations(summary: Dict, params) -> List[tuple]:
    """All-gather result shapes equal to a whole parameter's shape: the mark
    of a sharding that undoes itself by gathering weights where they are
    used (comm_analysis.py:93-116). ``params`` is a state dict or a list of
    tensors of the WHOLE model; leaves under 4,096 elements are ignored."""
    tensors = params.values() if isinstance(params, dict) else params
    shapes = {tuple(int(d) for d in p.shape) for p in tensors
              if p.numel() >= 4096}
    gathered = summary.get("all-gather", {}).get("result_shapes", [])
    return [s for s in gathered if s in shapes]
