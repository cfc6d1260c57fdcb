"""Set-up timed by phase, from the start of the process.

The process's start is read from ``/proc/self/stat`` (its start time in
clock ticks since boot) against ``CLOCK_BOOTTIME``, so the interpreter's
own start-up and the imports before this module count in the first phase.
"""

from __future__ import annotations

import os
import time


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (10 ms
    resolution); the time of this call where /proc is not there."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return now
    return now - max(0.0, age)


class Phases:
    """``mark(name)`` closes the phase ``name`` at the current time."""

    def __init__(self, start: float):
        self.start = start
        self.last = start
        self.spans = {}

    def mark(self, name: str) -> float:
        now = time.perf_counter()
        self.spans[name] = self.spans.get(name, 0.0) + (now - self.last)
        self.last = now
        return now

    def total(self, until: float) -> float:
        return until - self.start
