"""The busy-share union, the waves' device time and the idle gaps on a
synthetic trace."""

import pytest

from portbench.trace import SUBWINDOW, WAVE, summarize


def ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_union_waves_and_gaps():
    events = [
        ev(SUBWINDOW, "user_annotation", 0, 1000),
        ev(f"{WAVE}64", "user_annotation", 100, 300, tid=2),
        ev("cudaGraphLaunch", "cuda_runtime", 110, 10, tid=2, corr=7),
        ev("k_a", "kernel", 150, 200, tid=9, corr=7),
        ev("k_b", "kernel", 300, 100, tid=9, corr=7),    # overlaps k_a
        ev("copy", "gpu_memcpy", 600, 100, tid=9, corr=8),
        ev("cudaMemcpyAsync", "cuda_runtime", 590, 5, tid=3, corr=8),
        ev("aten::copy_", "cpu_op", 450, 100, tid=3),
        ev("k_out", "kernel", 1500, 50, tid=9),          # outside
    ]
    s = summarize(events)
    assert s["window_s"] == pytest.approx(1000e-6)
    # busy: [150, 400) and [600, 700)
    assert s["busy_s"] == pytest.approx(350e-6)
    assert s["waves"] == [[64, pytest.approx(300e-6)]]
    gaps = dict(s["idle_gaps"])
    assert gaps["host:no_traced_activity"] == pytest.approx(150e-6 + 300e-6)
    assert gaps["aten::copy_"] == pytest.approx(200e-6)
    names = dict(s["device_ops"])
    assert names["k_a"] == pytest.approx(200e-6)
    assert "k_out" not in names
