"""A tiny run of each runner on the CPU against the reference, and the
same runs with the timed path broken underneath: ``correct`` comes out
false for each fault a cell can have (one card, so no exchange between
cards to leave out)."""

import contextlib

import pytest
import torch

from portbench import run
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 977


def execute(cfg, traffic, seconds=1.5, seed=SEED):
    return run.execute(cfg, traffic, seed, seconds, CPU)[0]


@pytest.mark.parametrize("cell", ["serve_closed", "serve_open", "unet_eval",
                                  "transformer_eval"])
def test_reference_agrees(cell):
    cfg, traffic = {
        "serve_closed": (tiny.unet(), tiny.traffic("serve_closed8")),
        "serve_open": (tiny.unet(), tiny.traffic("serve_open", rate=15.0)),
        "unet_eval": (tiny.unet(), tiny.traffic("eval_1024")),
        "transformer_eval": (tiny.transformer(), tiny.traffic("eval_1024")),
    }[cell]
    out = execute(cfg, traffic)
    assert out.failed == 0 and out.attempted > 0
    for name, (value, limit) in out.checks.items():
        # the port on the CPU runs float32 products, as the reference here
        assert value < 1e-3, (name, value)
    assert out.correct
    assert out.info.get("cold_calls", 0) == 0


@contextlib.contextmanager
def patched(obj, name, make):
    saved = getattr(obj, name)
    setattr(obj, name, make(saved))
    try:
        yield
    finally:
        setattr(obj, name, saved)


def step_unchanged(base):
    def step(self, x, eps, noise, scal_t, cond, M, b, cfg):
        return x
    return step


def altered_serve(base):
    def _call(self, lanes):
        out = base(self, lanes)
        out[0] = out[0] + 0.25
        return out
    return _call


def half_batch_serve(base):
    def _call(self, lanes):
        out = base(self, lanes)
        half = (len(out) + 1) // 2
        return out[:half] + [out[0]] * (len(out) - half)
    return _call


def altered_eval(base):
    def make(*args, **kw):
        plan = base(*args, **kw)

        def wrong(*a, **k):
            return plan(*a, **k) + 0.25
        wrong.prepare = plan.prepare
        return wrong
    return make


def half_batch_eval(base):
    def make(*args, **kw):
        plan = base(*args, **kw)

        def half(*a, **k):
            out = plan(*a, **k)
            h = out.shape[0] // 2
            return torch.cat([out[:h], out[:out.shape[0] - h]])
        half.prepare = plan.prepare
        return half
    return make


@pytest.mark.parametrize("fault", ["step_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("runner", ["serve", "eval"])
def test_fault_is_caught(runner, fault):
    import dadiff_tpu_torch.ops.planner as planner
    import dadiff_tpu_torch.serving as serving

    cfg = tiny.unet()
    traffic = tiny.traffic("serve_closed8" if runner == "serve"
                           else "eval_1024")
    where = {
        ("serve", "step_unchanged"): (planner._PlainOps, "step",
                                      step_unchanged),
        ("eval", "step_unchanged"): (planner._PlainOps, "step",
                                     step_unchanged),
        ("serve", "half_batch"): (serving.BatchedPlanner, "_call",
                                  half_batch_serve),
        ("serve", "answer_altered"): (serving.BatchedPlanner, "_call",
                                      altered_serve),
        ("eval", "half_batch"): (planner, "make_bo_sampler",
                                 half_batch_eval),
        ("eval", "answer_altered"): (planner, "make_bo_sampler",
                                     altered_eval),
    }[runner, fault]
    with patched(*where):
        out = execute(cfg, traffic)
    assert not out.correct, out.checks


@pytest.mark.parametrize("traffic_name", ["serve_closed8", "eval_1024"])
def test_traced_run_reaches_its_sub_window(traffic_name):
    """The plumbing of a traced run on the CPU (a device reading needs the
    card): the sub-window is traced, its waves are found by their spans,
    and every per-layer reader runs."""
    from portbench import spec

    traffic = tiny.traffic(traffic_name, trace_from_s=0.2, trace_waves=1)
    out, _ = run.execute(tiny.unet(), traffic, SEED, 3.0, CPU, trace=True)
    assert out.trace is not None and out.trace["window_s"] > 0
    assert out.trace["waves"] and all(c > 0 for c, _ in out.trace["waves"])
    for m in spec.load_benchmark()["per_layer"]:
        spec.metric_reader(m["name"]).read(m["name"], out, tiny.unet())
