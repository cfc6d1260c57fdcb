"""The port's utils/profiling.py, utils/debug.py and utils/arrays.py held
against the JAX package's on the CPU: StepTimer's summary on given times
(exact, the same arithmetic), the finite checks and the skip guard, the
array helpers and the seeding; the trace reader's busy share and kernel
times on a hand-written trace (exact), and a CPU trace of the port through
``trace`` and ``annotate``."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dadiff_tpu.utils import arrays as jarr
from dadiff_tpu.utils import debug as jdbg
from dadiff_tpu.utils import profiling as jprof

from dadiff_tpu_torch.utils import arrays, debug, profiling

torch.set_num_threads(1)


@pytest.mark.parametrize("warmup,times", [
    (0, [0.5]), (2, [9.0, 8.0, 0.010, 0.012, 0.011, 0.030]),
    (1, [1.0] + [0.001 * (i % 7 + 1) for i in range(23)]), (3, [1.0, 2.0])])
def test_step_timer_summary_matches_jax(warmup, times):
    samples = [(i % 3) + 1 for i in range(len(times))]
    ours, theirs = profiling.StepTimer(warmup), jprof.StepTimer(warmup)
    for t in (ours, theirs):
        t._times, t._samples = list(times), list(samples)
    assert ours.summary() == theirs.summary()
    assert ours.times == theirs.times


def test_timed_call_records_a_step_and_returns_the_output():
    timer = profiling.StepTimer(warmup=0)
    out = timer.timed_call(lambda x: {"y": x * 2}, torch.ones(3), n_samples=3)
    assert torch.equal(out["y"], torch.full((3,), 2.0))
    with timer.step(n_samples=5):
        pass
    assert len(timer.times) == 2 and timer.summary()["samples_per_sec"] > 0
    assert profiling.device_memory_stats() is None  # no card here


def _event(name, cat, ts, dur, ph="X"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": ph}


def test_read_trace_unions_device_intervals_in_the_window(tmp_path):
    """Kernels at [10, 20), [15, 30) (overlapping), [40, 45), a copy at
    [50, 52), one kernel outside the window; the window [5, 55): busy
    10..30 + 40..45 + 50..52 = 27 of 50 us."""
    events = [
        _event("win", "user_annotation", 5, 50),
        _event("k_a", "kernel", 10, 10), _event("k_b", "kernel", 15, 15),
        _event("k_a", "kernel", 40, 5), _event("Memcpy HtoD", "gpu_memcpy",
                                               50, 2),
        _event("k_a", "kernel", 60, 5), _event("cpu_op", "cpu_op", 0, 70),
        _event("k_a", "kernel", 70, 1, ph="i"),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = profiling.read_trace(str(path), window="win")
    assert (r["wall_us"], r["busy_us"], r["n_device_events"]) == (50, 27, 4)
    assert math.isclose(r["busy_share"], 27 / 50)
    assert r["kernels"] == {"k_a": {"count": 2, "us": 15.0},
                            "k_b": {"count": 1, "us": 15.0}}
    whole = profiling.read_trace(str(path))
    assert whole["wall_us"] == 70 and whole["kernels"]["k_a"]["count"] == 3
    with pytest.raises(ValueError, match="no events named"):
        profiling.read_trace(str(path), window="absent")


def test_trace_and_annotate_write_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("window"):
            for _ in range(3):
                x = torch.tanh(x @ x)
    assert prof.key_averages()
    r = profiling.read_trace(str(tmp_path / profiling.TRACE_FILE),
                             window="window")
    # no card: no device events, so a busy share of 0
    assert r["wall_us"] > 0 and r["busy_us"] == 0 and r["kernels"] == {}


def _tree(bad):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.ones(4, np.float32)
    if bad:
        b[2] = np.nan
    return {"a": a, "layer": {"b": b, "c": np.zeros(2, np.float32)}}


@pytest.mark.parametrize("bad", [False, True])
def test_finite_checks_match_jax(bad):
    tree = _tree(bad)
    ttree = {"a": torch.from_numpy(tree["a"]),
             "layer": {k: torch.from_numpy(v)
                       for k, v in tree["layer"].items()}}
    jtree = {"a": jnp.asarray(tree["a"]),
             "layer": {k: jnp.asarray(v) for k, v in tree["layer"].items()}}
    assert debug.check_finite(ttree, "g") == jdbg.check_finite_pytree(jtree,
                                                                      "g")
    assert bool(debug.all_finite(ttree)) == bool(jdbg.tree_all_finite(jtree))
    safe, ok = debug.finite_or_skip(ttree)
    jsafe, jok = jdbg.finite_or_skip(jtree)
    assert bool(ok) == bool(jok)
    np.testing.assert_array_equal(safe["layer"]["b"].numpy(),
                                  np.asarray(jsafe["layer"]["b"]))
    np.testing.assert_array_equal(safe["a"].numpy(), np.asarray(jsafe["a"]))


def test_check_finite_reads_a_module():
    m = torch.nn.Linear(3, 2)
    assert debug.check_finite(m, "m") == []
    with torch.no_grad():
        m.bias[1] = float("inf")
    assert debug.check_finite(m, "m") == ["m['bias']"]


def test_debug_nans_scopes_anomaly_detection():
    assert not torch.is_anomaly_enabled()
    with debug.debug_nans():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).sum().backward()
    assert not torch.is_anomaly_enabled()


def test_array_helpers_match_jax():
    rng = np.random.RandomState(0)
    x, mean, std = rng.randn(5, 3), rng.randn(3), rng.rand(3)
    for ours, theirs in ((arrays.normalize, jarr.normalize),
                         (arrays.unnormalize, jarr.unnormalize)):
        np.testing.assert_array_equal(
            ours(torch.from_numpy(x), torch.from_numpy(mean),
                 torch.from_numpy(std)).numpy(), theirs(x, mean, std))
    assert arrays.atleast_2d(torch.ones(3)).shape == \
        jarr.atleast_2d(np.ones(3)).shape == (1, 3)
    assert arrays.apply_dict(lambda v: v * 2, {"a": 1}) == \
        jarr.apply_dict(lambda v: v * 2, {"a": 1})
    np.testing.assert_array_equal(arrays.to_np(torch.from_numpy(x)),
                                  jarr.to_np(x))
    batch = arrays.batch_to_device({"x": x, "n": 3}, device="cpu",
                                   dtype=torch.float32)
    assert batch["x"].dtype == torch.float32 and batch["n"] == 3


def test_set_seed_seeds_numpy_as_jax_and_returns_a_generator():
    g = arrays.set_seed(7)
    ours = np.random.rand(4)
    jarr.set_seed(7)
    np.testing.assert_array_equal(ours, np.random.rand(4))
    assert isinstance(g, torch.Generator) and g.initial_seed() == 7
