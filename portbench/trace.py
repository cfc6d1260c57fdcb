"""The traced sub-window: ``torch.profiler`` (CUPTI) over the CPU and the
card, and what its Chrome trace says.

The union arithmetic of busy intervals is a frozen copy of the port's
``utils/profiling.py`` ``read_trace``: the card is busy where a kernel, a
copy or a set runs; the idle share is one minus the union of those
intervals over the sub-window's wall time. The sub-window is the span of
the benchmark's own ``portbench.subwindow`` annotation; a wave is the span
of a ``portbench.wave.c<chains>`` annotation that the benchmark puts around
its call into the wave, and its kernels are the device work correlated with
the runtime calls made inside that span, whatever their names.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

SUBWINDOW = "portbench.subwindow"
WAVE = "portbench.wave.c"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver",
                   "user_annotation", "python_function")


class Tracer:
    """Start and stop the profiler around a sub-window; ``read`` exports
    the trace into ``directory``, reduces it and deletes it."""

    def __init__(self, directory: str):
        self.directory = directory
        self.prof = None
        self.mark = None

    @staticmethod
    def initialize() -> None:
        """Bring the profiler up once on the calling (main) thread, so that
        a later start on another thread finds it initialised."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):
            pass

    def start(self):
        """Start tracing: called on the thread that launches the work
        (the profiler records the CPU side of its own thread)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.mark = torch.profiler.record_function(SUBWINDOW)
        self.mark.__enter__()
        self.host = [time.perf_counter(), None]

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.host[1] = time.perf_counter()
        self.mark.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> dict:
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, "portbench_trace.json")
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            if os.path.exists(path):
                os.remove(path)
        self.prof = None
        return summarize(events) | {"host_s": self.host}


def union_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _corr(e) -> Optional[int]:
    args = e.get("args") or {}
    c = args.get("correlation", args.get("correlation id"))
    return None if c is None else int(c)


def summarize(events: List[dict]) -> dict:
    """The sub-window's wall and busy time, device time by kernel name, the
    waves inside it (chains, device seconds of their work), and the idle
    gaps by what the host was doing."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
             if e.get("name") == SUBWINDOW
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError("the trace has no sub-window annotation")
    lo, hi = min(a for a, _ in marks), max(b for _, b in marks)
    device, by_name, by_corr = [], defaultdict(float), defaultdict(float)
    for e in xs:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        device.append((a, b))
        by_name[e["name"]] += b - a
        c = _corr(e)
        if c is not None:
            by_corr[c] += b - a
    busy_us = union_us(device)
    waves = _waves(xs, lo, hi, by_corr)
    gaps = _idle_gaps(xs, _merged(device), lo, hi)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "waves": waves,
        "device_ops": [[n, us / 1e6] for n, us in top],
        "idle_gaps": [[n, us / 1e6] for n, us in gaps[:10]],
        "device_events": len(device),
    }


def _waves(xs, lo, hi, by_corr) -> List[list]:
    """[chains, device seconds] of every wave annotation inside the
    sub-window: the device time correlated with the runtime calls that its
    thread made inside it."""
    runtime = defaultdict(list)  # tid -> sorted [(ts, correlation)]
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = _corr(e)
            if c is not None:
                runtime[e.get("tid")].append((float(e["ts"]), c))
    for v in runtime.values():
        v.sort()
    out = []
    for e in xs:
        name = e.get("name", "")
        if e.get("cat") != "user_annotation" or not name.startswith(WAVE):
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if a < lo or b > hi:
            continue
        calls = runtime.get(e.get("tid"), [])
        i = bisect.bisect_left(calls, (a, -1))
        us = 0.0
        while i < len(calls) and calls[i][0] <= b:
            us += by_corr.get(calls[i][1], 0.0)
            i += 1
        out.append([int(name[len(WAVE):]), us / 1e6])
    return out


def _idle_gaps(xs, busy, lo, hi) -> List[tuple]:
    """Seconds of the card's idle gaps inside the sub-window, summed by the
    innermost host event under each gap's midpoint (on any thread), longest
    first."""
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "?")) for e in xs
                  if e.get("cat") in HOST_CATEGORIES
                  and e.get("name") != SUBWINDOW)
    totals: Dict[str, float] = defaultdict(float)
    active, j = [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        m = (a + b) / 2
        while j < len(host) and host[j][0] <= m:
            heapq.heappush(active, (host[j][1], host[j][1] - host[j][0],
                                    host[j][2]))
            j += 1
        while active and active[0][0] < m:
            heapq.heappop(active)
        name = (min(active, key=lambda h: h[1])[2] if active
                else "host:no_traced_activity")
        totals[name] += b - a
    return sorted(totals.items(), key=lambda kv: -kv[1])
