"""What a runner hands back to the harness."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional


@dataclasses.dataclass
class Outcome:
    window_start: float                  # perf_counter at the window's start
    end_to_end: Dict[str, float]         # the cell's metrics but setup_s
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, List[float]]       # name -> [value, limit]
    trace: Optional[dict] = None         # trace.summarize() of the sub-window
    records: dict = dataclasses.field(default_factory=dict)  # for readers
    info: dict = dataclasses.field(default_factory=dict)     # earlier lines

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank q-quantile (0 < q <= 1) of every value; a request
    that failed is +inf and so lies above every one that came."""
    if not values:
        return math.inf
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]
