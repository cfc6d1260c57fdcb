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
    intervals over the window's wall time) and device time by kernel name;
  * ``span(name, **attrs)`` and ``record(name, t0, t1, **attrs)``: the
    port's own spans, kept in a bounded ring in memory (``spans()``).

The spans follow the profiler. ``torch.profiler`` records the host side of
the thread that started it and of no other. So the layer that drives the
card (the batcher's wave, the evaluator's call) reads its own thread's
profiler state once per unit of work (:func:`follow_profiler`) and turns
recording on or off for the whole process from it; every span reads only
that flag. Off, ``span`` returns one shared object that does nothing.
On, a span records its name (prefixed ``dadiff.``), its start and end on
``time.perf_counter()``, its thread, its parent span and its attributes,
and on a thread whose profiler is running it also enters
``record_function``, so it lies in the device trace beside the card's
work. ``trace`` turns recording on for its duration and writes the spans
of every other thread into its ``trace.json``, shifted onto the trace's
clock through one anchor annotation.

Never put a span inside a region that a CUDA graph captures: it would run
once, at the capture, and never at a replay.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import statistics
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

TRACE_FILE = "trace.json"
# the card's activity in a torch.profiler Chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


SPAN_PREFIX = "dadiff."
ANCHOR = SPAN_PREFIX + "anchor"
RING_SIZE = 1 << 16


class Span(NamedTuple):
    """One recorded span; times on ``time.perf_counter()``."""
    name: str
    t0: float
    t1: float
    thread: int
    sid: int
    parent: Optional[int]
    attrs: dict
    traced: bool  # also entered as record_function on a profiled thread


_ring: "collections.deque[Span]" = collections.deque(maxlen=RING_SIZE)
_ids = itertools.count(1)
_local = threading.local()
_profiled: set = set()  # threads whose own profiler is running
_forced = 0             # open trace() contexts
_on = False


class _Off:
    """What :func:`span` returns while recording is off: one object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "sid", "parent", "rf", "t0")

    def __init__(self, name, attrs):
        self.name, self.attrs, self.rf = SPAN_PREFIX + name, attrs, None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.sid = next(_ids)
        stack.append(self.sid)
        if threading.get_ident() in _profiled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def set(self, **attrs):
        """Attributes known only inside the span (a wave id)."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = _stack()
        if stack and stack[-1] == self.sid:
            stack.pop()
        _ring.append(Span(self.name, self.t0, t1, threading.get_ident(),
                          self.sid, self.parent, self.attrs,
                          self.rf is not None))
        return None


def span(name: str, **attrs):
    """A span around the work inside: ``with span("serve.decode"): ...``.
    While recording is off, the one shared object that does nothing."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def each(name: str, items, key: str = "i"):
    """Iterate ``items`` with each pass of the caller's loop body inside a
    span ``name`` of its own (attribute ``key``: the pass's index)."""
    for i, item in enumerate(items):
        with span(name, **{key: i}):
            yield item


def record(name: str, t0: float, t1: float, *, parent: Optional[int] = None,
           **attrs) -> None:
    """Record an interval whose ends were stamped earlier (perf_counter),
    on the calling thread; ``parent`` defaults to its open span."""
    if not _on:
        return
    if parent is None:
        stack = _stack()
        parent = stack[-1] if stack else None
    _ring.append(Span(SPAN_PREFIX + name, t0, t1, threading.get_ident(),
                      next(_ids), parent, attrs, False))


def current() -> Optional[int]:
    """The id of the calling thread's innermost open span (None while
    recording is off)."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def follow_profiler() -> bool:
    """Called by the layer that drives the card at the top of each unit of
    work: recording is on while this thread's profiler runs (or a
    :func:`trace` is open). One thread-local read."""
    global _on
    me = threading.get_ident()
    if torch._C._autograd._profiler_enabled():
        _profiled.add(me)
    elif _profiled:
        _profiled.discard(me)
        # a thread that ended with its profiler on follows it no longer
        _profiled.intersection_update(t.ident for t in threading.enumerate())
    _on = bool(_forced or _profiled)
    return _on


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most ``RING_SIZE``)."""
    return list(_ring)


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace what runs inside: ``with trace('/tmp/t') as prof: step()``.
    Writes ``log_dir/trace.json``; ``prof.key_averages()`` sums by op.
    Recording is on inside; the spans of threads the profiler does not
    follow are merged into the trace on its clock."""
    global _forced, _on
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    me = threading.get_ident()
    with profile(activities=activities) as prof:
        _forced += 1
        _profiled.add(me)
        _on = True
        start = time.perf_counter()
        a = time.perf_counter()
        with torch.profiler.record_function(ANCHOR):
            pass
        anchor = (a + time.perf_counter()) / 2
        try:
            yield prof
        finally:
            _forced -= 1
            _profiled.discard(me)
            _on = bool(_forced or _profiled)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _merge_spans(path, anchor, [s for s in spans()
                                if s.t0 >= start and not s.traced])


def _merge_spans(path: str, anchor: float, extra: List[Span]) -> None:
    """Append ``extra`` to the Chrome trace at ``path`` as complete events
    on its clock: the offset is the one at which the trace's ``ANCHOR``
    annotation, entered at perf_counter ``anchor``, has its midpoint."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    mark = next(e for e in events if e.get("name") == ANCHOR
                and e.get("ph") == "X")
    offset = float(mark["ts"]) + float(mark.get("dur", 0)) / 2 - anchor * 1e6
    for s in extra:
        events.append({
            "ph": "X", "cat": "user_annotation", "name": s.name,
            "pid": mark.get("pid"), "tid": s.thread,
            "ts": s.t0 * 1e6 + offset, "dur": (s.t1 - s.t0) * 1e6,
            "args": dict(s.attrs, span=s.sid, parent=s.parent)})
    with open(path, "w") as f:
        json.dump(doc, f)


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
