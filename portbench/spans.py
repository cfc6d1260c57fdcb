"""The port's own spans (``dadiff_tpu_torch/utils/profiling.py``) as the
per-layer readers take them: those recorded inside the traced sub-window
(``out.trace["host_s"]``, on the same ``time.perf_counter`` clock).

The port records while the profiler runs on the thread that drives the
card, so a traced run records with no change to the runners. A checkout
whose port records no spans gives none, and its readers return None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

PREFIX = "dadiff."


def recorded(out) -> List:
    """The spans that started and ended inside the traced sub-window."""
    if not out.trace or "host_s" not in out.trace:
        return []
    try:
        from dadiff_tpu_torch.utils import profiling
    except ImportError:
        return []
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return []
    t0, t1 = out.trace["host_s"]
    return [s for s in spans() if t0 <= s.t0 and s.t1 <= t1]


def named(spans, name: str) -> List:
    return [s for s in spans if s.name == PREFIX + name]


def durations_ms(spans, name: str) -> List[float]:
    return [1e3 * (s.t1 - s.t0) for s in named(spans, name)]


def children(spans) -> Dict[Optional[int], List]:
    """Each span id's direct children."""
    out: Dict[Optional[int], List] = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def self_ms(spans, name: str, minus) -> List[float]:
    """Each ``name`` span's time less that of its direct children named in
    ``minus``; only spans that have at least one such child."""
    kids = children(spans)
    out = []
    for s in named(spans, name):
        sub = [c for c in kids.get(s.sid, ())
               if c.name in {PREFIX + m for m in minus}]
        if sub:
            out.append(1e3 * ((s.t1 - s.t0) - sum(c.t1 - c.t0 for c in sub)))
    return out


def median(values) -> Optional[float]:
    return statistics.median(values) if values else None
