"""Profiling and step timing on torch.profiler.

Counterpart of the JAX package's utils/profiling.py (trace :25, annotate
:37, StepTimer :44, device_memory_stats :102):

  * ``trace(log_dir)``: ``torch.profiler.profile`` over the CPU and, where
    there is one, the card; the Chrome trace is written into ``log_dir``;
  * ``annotate(name)``: a named range in that trace
    (``torch.profiler.record_function``);
  * ``StepTimer``: wall-clock step times with warmup discard, its
    ``timed_call`` waiting for the card that holds the returned tensors;
  * ``device_memory_stats()``: the allocator's counts for every visible
    card;
  * ``read_trace(path)``: what a trace says of the card: the device-busy
    share of a window (the union of the card's kernel, copy and set
    intervals over the window's wall time) and device time by kernel name.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from typing import Dict, List, Optional

import torch

TRACE_FILE = "trace.json"
# the card's activity in a torch.profiler Chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace what runs inside: ``with trace('/tmp/t') as prof: step()``.
    Writes ``log_dir/trace.json``; ``prof.key_averages()`` sums by op."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named range in the profiler timeline."""
    return torch.profiler.record_function(name)


def _synchronize(out) -> None:
    """Wait for every card that holds a tensor of ``out`` (any nesting)."""
    from torch.utils._pytree import tree_leaves

    devices = {x.device for x in tree_leaves(out)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class StepTimer:
    """Wall-clock step timing with warmup discard (profiling.py:44-99).

    CUDA launches return before the card finishes: the ``step`` context
    measures only what the enclosed code waits for, so either synchronise
    inside it or use :meth:`timed_call`, which waits for the returned
    tensors' cards."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._samples: List[int] = []

    @contextlib.contextmanager
    def step(self, n_samples: int = 1):
        t0 = time.perf_counter()
        yield
        self._times.append(time.perf_counter() - t0)
        self._samples.append(n_samples)

    def timed_call(self, fn, *args, n_samples: int = 1, **kwargs):
        """Call ``fn`` and time it until its returned tensors are ready."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize(out)
        self._times.append(time.perf_counter() - t0)
        self._samples.append(n_samples)
        return out

    @property
    def times(self) -> List[float]:
        return self._times[self.warmup:]

    def summary(self) -> Dict[str, float]:
        times = self.times
        if not times:
            return {}
        samples = self._samples[self.warmup:]
        total = sum(times)
        return {
            "steps_per_sec": len(times) / total,
            "samples_per_sec": sum(samples) / total,
            "mean_ms": 1000 * total / len(times),
            "median_ms": 1000 * statistics.median(times),
            "p90_ms": 1000 * sorted(times)[int(0.9 * (len(times) - 1))],
        }


def device_memory_stats() -> Optional[Dict[str, Dict[str, int]]]:
    """The caching allocator's counts for EVERY visible card (an unbalanced
    shard can run one card out of memory); None without a card."""
    if not torch.cuda.is_available():
        return None
    out = {}
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_reserved": torch.cuda.memory_reserved(i),
            "bytes_free": free,
            "bytes_limit": total,
        }
    return out


def _union_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def read_trace(path: str, window: Optional[str] = None) -> dict:
    """What a Chrome trace of :func:`trace` says of the card.

    ``window``: the name of an :func:`annotate` range; the window runs from
    its first start to its last end on the host's clock (None: from the
    first to the last event of the trace). Returns the window's wall time,
    the union of the card's intervals inside it (kernels, copies and sets
    clipped to the window), their share of the wall time, and for each
    kernel name its count and device time inside the window."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if window is None:
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events]
    else:
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e["name"] == window
                 and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"{path}: no events"
                         + (f" named {window!r}" if window else ""))
    lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    busy, kernels = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if b <= lo or a >= hi:
            continue
        busy.append((max(a, lo), min(b, hi)))
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], {"count": 0, "us": 0.0})
            k["count"] += 1
            k["us"] += b - a
    busy_us = _union_us(busy)
    return {"wall_us": hi - lo, "busy_us": busy_us,
            "busy_share": busy_us / (hi - lo) if hi > lo else 0.0,
            "n_device_events": len(busy), "kernels": kernels}
