"""The arrival schedule and the window's statistics."""

import math

import numpy as np
import pytest

from portbench import inputs
from portbench.runners.eval import window_rate
from portbench.runners.serve import window_metrics
from portbench.outcome import percentile


def test_schedule_is_the_seeds():
    a = inputs.arrival_schedule(2**31 + 12345, 8, 35.0, 30.0)
    b = inputs.arrival_schedule(2**31 + 12345, 8, 35.0, 30.0)
    c = inputs.arrival_schedule(2**31 + 12346, 8, 35.0, 30.0)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    # another seed deals the same sequences to other controllers
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    key = lambda d: d.tolist()  # noqa: E731
    assert sorted(map(key, a)) == sorted(map(key, c))
    gaps = inputs.exponential_gaps(35.0 / 8, 30.0)
    assert math.isclose(gaps.mean(), 8 / 35.0, rel_tol=0.05)
    for due in a:
        assert np.all(np.diff(due) > 0) and due[-1] < 30.0
        got = np.diff(np.concatenate([[0.0], due]))
        assert np.all(np.isin(got.round(9), gaps.round(9)))
        assert len(due) >= len(gaps) - 1


def test_p95_over_every_request_with_a_stall():
    t0 = 100.0
    reqs = []
    for k in range(100):  # 100 ms each, but a 2 s stall holds 10 of them
        due = t0 + 0.2 * k
        lat = 2.0 if 40 <= k < 50 else 0.1
        reqs.append([0, k, due, due, due + lat, True])
    reqs.append([1, 0, t0 + 5, t0 + 5, None, False])   # failed
    m = window_metrics(reqs, "open", t0)
    assert m["failed"] == 1 and m["done"] == 100
    assert percentile(m["latencies"], 0.95) == pytest.approx(2.0)
    assert math.isinf(percentile(m["latencies"], 1.0))
    assert percentile(m["latencies"], 0.5) == pytest.approx(0.1)
    assert math.isclose(m["window_s"], 0.2 * 99 + 0.1)


def test_closed_loop_latency_is_from_the_send():
    reqs = [[0, 1, 10.0, 10.5, 10.6, True]]
    assert math.isclose(window_metrics(reqs, "closed", 10.0)["latencies"][0],
                        0.1)
    assert math.isclose(window_metrics(reqs, "open", 10.0)["latencies"][0],
                        0.6)


def test_window_rate_holds_a_stall():
    steps = 1000
    smooth = window_rate([1.0, 2.0, 3.0, 4.0], 0.0, steps)
    stalled = window_rate([1.0, 2.0, 5.0, 6.0], 0.0, steps)
    assert smooth == 1000.0
    assert math.isclose(stalled, 4000 / 6.0)
