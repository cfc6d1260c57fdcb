"""The port's spans and counters (utils/profiling.py ``span``, ``record``,
``each``; the spans of serve.py, serving.py, guides/policies.py,
ops/planner.py, envs/rollout.py and guides/sampling.py) on the CPU.

Off (no profiler on the driving thread, no ``trace`` open): ``span`` is
one shared object that keeps nothing and enters no ``record_function``,
and a served request and an evaluator call leave the ring empty. On,
under ``profiling.trace``: the served request's span tree across the
connection and batcher threads, shared wave ids, the driving thread's
spans as ``user_annotation`` events in ``trace.json`` and the other
threads' merged on the trace's clock, the evaluator's spans against its
counters, plans and env states equal bit for bit on and off, and the
server's ``stats`` request.

Tiny model: dim 8, mults (1, 2), horizon 8, T = 5. Every join, wait and
socket has a timeout.
"""

import json
import socket
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from dadiff_tpu_torch.datasets.sequence import SequenceDataset
from dadiff_tpu_torch.dynamics.projection import ProjectionMatrixBuilder
from dadiff_tpu_torch.envs.pointmaze_jax import PointMazeJax
from dadiff_tpu_torch.envs.rollout import make_ondevice_evaluator
from dadiff_tpu_torch.guides import policies as pol
from dadiff_tpu_torch.guides.sampling import ProjectionSpec
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops.planner import _WaveRunner, wire_policy_megakernel
from dadiff_tpu_torch.ops.projection import NormStats
from dadiff_tpu_torch.serve import make_handler, serve
from dadiff_tpu_torch.serving import BatchedPlanner
from dadiff_tpu_torch.utils import profiling

torch.set_num_threads(1)

H, OBS, ACT, T_STEPS, N = 8, 6, 2, 5, 2
D = OBS + ACT
WAIT_S = 120
P_ = "dadiff."


@pytest.fixture(scope="module")
def parts():
    torch.manual_seed(0)
    dataset = SequenceDataset("synthetic:pointmaze:n=6,T=40", horizon=H)
    diff = GaussianDiffusion(TemporalUnet(D, dim=8, dim_mults=(1, 2)),
                             horizon=H, observation_dim=OBS, action_dim=ACT,
                             n_timesteps=T_STEPS).eval()
    dt = 0.1
    A = np.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]])
    B = np.array([[0.5 * dt * dt, 0], [0, 0.5 * dt * dt], [dt, 0], [0, dt]])
    P = ProjectionMatrixBuilder(A, B, 4, ACT).get_projection_matrix(H)
    return diff, dataset, P.astype(np.float32)


@pytest.fixture(autouse=True)
def _empty_ring():
    assert not profiling._on
    profiling._ring.clear()
    yield
    profiling._ring.clear()


def _policy(parts):
    diff, dataset, P = parts
    policy = pol.DynamicsAwarePolicy(diff, projection_matrix=P,
                                     normalizer=dataset.normalizer,
                                     action_horizon=4, n_candidates=N)
    return wire_policy_megakernel(policy, n_candidates=N)


def _obs(i):
    return np.random.RandomState(100 + i).uniform(-1, 1, OBS).astype(
        np.float32)


def _evaluator(parts, mega, R=3, A=2):
    diff, _, P = parts
    stats = NormStats(torch.zeros(OBS), torch.full((OBS,), 1.5),
                      torch.zeros(ACT), torch.ones(ACT))
    evaluate = make_ondevice_evaluator(
        diff, PointMazeJax(), action_horizon=A, n_replans=R,
        n_candidates=N, projection=ProjectionSpec(state_dim=4),
        use_megakernel=mega, P=torch.from_numpy(P), stats=stats)
    return lambda seed: evaluate(torch.Generator().manual_seed(seed), stats,
                                 3, torch.from_numpy(P)), evaluate


def _named(spans, name):
    return [s for s in spans if s.name == P_ + name]


def _inside(child, parent):
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


# ---------------------------------------------------------------------------
# Off
# ---------------------------------------------------------------------------

def test_off_span_is_one_shared_object_that_keeps_nothing(monkeypatch):
    """Off, ``span`` returns the same object every call, enters no
    ``record_function`` and keeps no allocation; ``record`` and ``each``
    record nothing."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = profiling.span("serve.request")
    assert first is profiling.span("policy.act", wave=3) is profiling._OFF
    for _ in range(10):  # let any lazy allocation happen first
        with profiling.span("serve.request") as sp:
            sp.set(wave=1)
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        for _ in range(1000):
            with profiling.span("serve.request"):
                pass
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # a span record is a few hundred bytes: 1,000 of them would show
    assert after - before < 256 and peak - before < 1024
    profiling.record("batcher.queue", 0.0, 1.0, wave=1)
    assert list(profiling.each("env.step", range(3))) == [0, 1, 2]
    assert profiling.current() is None and profiling.spans() == []


def test_off_request_and_evaluator_call_leave_the_ring_empty(parts):
    batcher = BatchedPlanner(_policy(parts), max_batch=2, window_ms=50.0)
    try:
        handle = make_handler(batcher.session(seed=1))
        resp = handle({"obs": _obs(0).tolist(), "plan": True})
        assert "error" not in resp and len(resp["plan"]) == H
    finally:
        batcher.close()
    run, evaluate = _evaluator(parts, mega=True)
    run(3)
    assert evaluate.counters == {"calls": 1, "prepares": 1}
    assert profiling.spans() == []


# ---------------------------------------------------------------------------
# On
# ---------------------------------------------------------------------------

def _rpc(f, req):
    f.write((json.dumps(req) + "\n").encode())
    f.flush()
    return json.loads(f.readline())


def _serve_two(parts, tmp_path):
    """serve(..., concurrency=2) under ``profiling.trace``: two clients send
    one replan each at once, then one asks for the counters."""
    policy = _policy(parts)
    box, ready = {}, threading.Event()

    def run():
        box["n"] = serve(policy, "127.0.0.1", 0, max_requests=3,
                         ready_cb=lambda p: (box.update(port=p), ready.set()),
                         concurrency=2, window_ms=200.0, max_batch=2)

    out = [None, None]

    def client(i, barrier):
        with socket.create_connection(("127.0.0.1", box["port"]),
                                      timeout=WAIT_S) as c:
            f = c.makefile("rwb")
            barrier.wait()
            out[i] = _rpc(f, {"obs": _obs(i).tolist(), "plan": True})
            if i == 0:
                barrier.wait()
                out.append(_rpc(f, {"stats": True}))
            else:
                barrier.wait()

    with profiling.trace(str(tmp_path)):
        th = threading.Thread(target=run, daemon=True)
        th.start()
        assert ready.wait(WAIT_S)
        barrier = threading.Barrier(2, timeout=WAIT_S)
        clients = [threading.Thread(target=client, args=(i, barrier),
                                    daemon=True) for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=WAIT_S)
        th.join(timeout=WAIT_S)
    assert not th.is_alive() and box["n"] == 3
    return out, profiling.spans()


def test_served_requests_give_the_span_tree(parts, tmp_path):
    """Each request: serve.request (conn, request) holds serve.decode,
    policy.act and serve.reply; policy.act holds batcher.wait and
    policy.readback; the batcher's queue span of the request is a child of
    its wait, with the wave id of its wave; every child lies inside its
    parent, and the queue waits are >= 0."""
    out, spans = _serve_two(parts, tmp_path)
    assert all("plan" in r for r in out[:2])
    by_id = {s.sid: s for s in spans}
    waves = {s.attrs["wave"]: s for s in _named(spans, "batcher.wave")}
    requests = [s for s in _named(spans, "serve.request")]
    plans = [r for r in requests if any(
        c.name == P_ + "policy.act" and c.parent == r.sid for c in spans)]
    assert len(plans) == 2
    assert sorted(r.attrs["conn"] for r in plans) == [0, 1]
    for r in plans:
        kids = {c.name: c for c in spans if c.parent == r.sid}
        assert set(kids) == {P_ + "serve.decode", P_ + "policy.act",
                             P_ + "serve.reply"}
        assert all(_inside(c, r) for c in kids.values())
        act = kids[P_ + "policy.act"]
        inner = {c.name: c for c in spans if c.parent == act.sid}
        assert set(inner) == {P_ + "batcher.wait", P_ + "policy.readback"}
        assert all(_inside(c, act) for c in inner.values())
        wait = inner[P_ + "batcher.wait"]
        wave = waves[wait.attrs["wave"]]
        assert wait.t0 <= wave.t0 <= wave.t1 <= wait.t1
        assert wave.attrs["K_pad"] >= wave.attrs["K"] >= 1
        assert wave.attrs["chains"] == wave.attrs["K_pad"] * N
        queue = [q for q in _named(spans, "batcher.queue")
                 if q.parent == wait.sid]
        assert len(queue) == 1 and queue[0].attrs["wave"] == wave.attrs["wave"]
        assert _inside(queue[0], wait) and queue[0].t1 >= queue[0].t0
        assert queue[0].t1 == pytest.approx(wave.t0, abs=1e-3)
        assert by_id[wave.sid].thread != r.thread
    for name in ("batcher.await", "batcher.window", "wave.draws",
                 "wave.select"):
        assert _named(spans, name), name
    # on the batcher's thread (not the prewarm's) each part of a wave lies
    # inside its cycle
    cycles = {s.sid: s for s in _named(spans, "batcher.cycle")}
    batcher_thread = {s.thread for s in cycles.values()}
    assert len(batcher_thread) == 1
    for name in ("batcher.window", "batcher.wave"):
        for s in _named(spans, name):
            if s.thread in batcher_thread:
                assert s.parent in cycles and _inside(s, cycles[s.parent])


def test_stats_request_answers_the_counters(parts, tmp_path):
    out, _ = _serve_two(parts, tmp_path)
    stats = out[2]
    assert stats["ok"] is True
    c = stats["counters"]
    assert c["requests"] == 2 and c["answered"] == 2
    assert c["waves"] in (1, 2) and c["cold_calls"] == 0
    assert c["padded_lanes"] == 0  # waves of one or two requests
    assert set(_WaveRunner.counters()) <= set(c)


def test_trace_json_holds_every_thread_on_one_clock(parts, tmp_path):
    """Under ``trace`` the calling thread's spans are ``user_annotation``
    events of the profiler; the batcher thread's spans are merged at their
    anchor-shifted times, and each batcher.wave lies inside the batcher.wait
    of the profiled thread that waited for it, within 1 ms."""
    batcher = BatchedPlanner(_policy(parts), max_batch=2, window_ms=1.0)
    try:
        session = batcher.session(seed=4)
        with profiling.trace(str(tmp_path)):
            for i in range(2):
                session.plan(_obs(i))
        done = time.perf_counter()
    finally:
        batcher.close()
    me = threading.get_ident()
    spans = profiling.spans()
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    annotations = [e for e in events if e.get("cat") == "user_annotation"]
    anchor = next(e for e in annotations if e["name"] == profiling.ANCHOR)
    mine = {s.sid for s in spans if s.thread == me}
    assert all(s.traced for s in spans if s.thread == me)
    assert not any(s.traced for s in spans if s.thread != me)
    waits = [e for e in annotations if e["name"] == P_ + "batcher.wait"]
    assert len(waits) == 2
    assert all("span" not in e.get("args", {}) for e in waits)
    merged = [e for e in annotations if "span" in e.get("args", {})]
    # every other thread's span that had ended (the batcher's await, open
    # at the end, is not)
    assert {e["args"]["span"] for e in merged} == {
        s.sid for s in spans if s.sid not in mine and s.t1 < done}
    by_id = {s.sid: s for s in spans}
    offsets = [e["ts"] - by_id[e["args"]["span"]].t0 * 1e6 for e in merged]
    assert max(offsets) - min(offsets) < 1.0  # one shift, to the us
    assert anchor["ts"] <= min(e["ts"] for e in merged)
    wave_events = [e for e in merged if e["name"] == P_ + "batcher.wave"]
    assert len(wave_events) == 2
    for w in wave_events:
        assert any(wt["ts"] - 1e3 <= w["ts"]
                   and w["ts"] + w["dur"] <= wt["ts"] + wt["dur"] + 1e3
                   for wt in waits)


@pytest.mark.parametrize("mega", [True, False], ids=["k2", "module"])
def test_evaluator_spans_match_its_counters(parts, tmp_path, mega):
    R, A = 3, 2
    run, evaluate = _evaluator(parts, mega, R=R, A=A)
    with profiling.trace(str(tmp_path)):
        run(5)
    spans = profiling.spans()
    count = {n: len(_named(spans, n)) for n in (
        "evaluator.call", "evaluator.prepare", "evaluator.replan",
        "env.steps", "env.step", "sampler.plan", "sampler.step",
        "wave.draws", "wave.select")}
    assert count["evaluator.call"] == evaluate.counters["calls"] == 1
    assert count["evaluator.prepare"] == evaluate.counters["prepares"] \
        == (1 if mega else 0)
    assert count["evaluator.replan"] == count["env.steps"] == R
    assert count["env.step"] == R * A
    if mega:
        assert count["wave.draws"] == count["wave.select"] == R
        assert count["sampler.plan"] == 0
    else:
        assert count["sampler.plan"] == R
        assert count["sampler.step"] == R * T_STEPS
    call = _named(spans, "evaluator.call")[0]
    replans = _named(spans, "evaluator.replan")
    assert sorted(r.attrs["k"] for r in replans) == list(range(R))
    assert all(r.parent == call.sid and _inside(r, call) for r in replans)
    for steps in _named(spans, "env.steps"):
        replan = next(r for r in replans if r.sid == steps.parent)
        assert replan.attrs["k"] == steps.attrs["k"] and _inside(steps,
                                                                 replan)
        kids = [s for s in spans if s.parent == steps.sid]
        assert [s.attrs["i"] for s in kids] == list(range(A))
        assert all(_inside(s, steps) for s in kids)


@pytest.mark.parametrize("mega", [True, False], ids=["k2", "module"])
def test_recording_changes_no_result(parts, tmp_path, mega):
    """Plans, metrics and env states equal bit for bit with recording on
    and off: the evaluator's, and a served plan's."""
    run, _ = _evaluator(parts, mega)
    m_off, s_off = run(11)
    with profiling.trace(str(tmp_path)):
        m_on, s_on = run(11)
    for a, b in ((s_off.pos, s_on.pos), (s_off.vel, s_on.vel),
                 (m_off.per_env_reward, m_on.per_env_reward)):
        assert torch.equal(a, b)
    if not mega:
        return
    plans = []
    for on in (False, True):
        batcher = BatchedPlanner(_policy(parts), max_batch=2, window_ms=1.0)
        try:
            handle = make_handler(batcher.session(seed=9))
            if on:
                with profiling.trace(str(tmp_path / "serve")):
                    plans.append(handle({"obs": _obs(3).tolist(),
                                         "plan": True}))
            else:
                plans.append(handle({"obs": _obs(3).tolist(), "plan": True}))
        finally:
            batcher.close()
    assert plans[0]["plan"] == plans[1]["plan"]
    assert plans[0]["action"] == plans[1]["action"]


def test_recording_follows_the_driving_threads_profiler():
    """A thread whose profiler runs turns recording on at its unit of work
    and off at its next one without it; one that ended with its profiler
    on is dropped at the next unit of work on any thread."""
    from torch.profiler import ProfilerActivity, profile

    def drive(stop):
        with profile(activities=[ProfilerActivity.CPU]):
            assert profiling.follow_profiler()
            with profiling.span("batcher.wave") as sp:
                assert sp is not profiling._OFF
        if stop:
            assert not profiling.follow_profiler()

    th = threading.Thread(target=drive, args=(True,))
    th.start()
    th.join(timeout=WAIT_S)
    assert not profiling._on
    assert [s.traced for s in _named(profiling.spans(), "batcher.wave")] \
        == [True]
    th = threading.Thread(target=drive, args=(False,))
    th.start()
    th.join(timeout=WAIT_S)
    assert profiling._on  # its thread ended before its next unit of work
    assert not profiling.follow_profiler() and not profiling._on


def test_record_each_and_nesting(tmp_path):
    """``record`` takes its parent from the open span or from ``parent=``;
    ``each`` opens one span per pass; attributes set inside a span stay."""
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", a=1) as sp:
            sp.set(b=2)
            profiling.record("inner", 1.0, 2.0, c=3)
            profiling.record("other", 1.0, 2.0, parent=7)
            for _ in profiling.each("step", range(2), "k"):
                assert profiling.current() is not None
    spans = profiling.spans()
    outer = _named(spans, "outer")[0]
    assert outer.attrs == {"a": 1, "b": 2} and outer.parent is None
    assert _named(spans, "inner")[0].parent == outer.sid
    assert _named(spans, "other")[0].parent == 7
    steps = _named(spans, "step")
    assert [s.attrs["k"] for s in steps] == [0, 1]
    assert all(s.parent == outer.sid and _inside(s, outer) for s in steps)
    assert not profiling._on
