"""The readers of the port's own spans (``portbench/spans.py`` and the
metrics that read it) on a traced CPU run of each kind of cell: each
returns a finite value or None and never raises, and each finds its spans
where its cell has them. Without spans (a port that records none, or an
untraced run) each returns None."""

import math

import pytest
import torch

from portbench import run, spec, spans
from portbench.outcome import Outcome
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 4099
READERS = ("queue_wait_ms.serve", "server_self_ms.serve",
           "policy_self_ms.serve", "wave_host_ms.serve_closed",
           "wave_turnaround_ms.serve_closed", "call_overhead_ms.eval",
           "env_ms_per_replan.eval", "sampler_step_ms.eval")
# what each kind of traced run records on the CPU (the planner chain runs
# its plain version here, so no wave is driven, captured or replayed)
FOUND = {
    "serve": {"queue_wait_ms.serve", "server_self_ms.serve",
              "policy_self_ms.serve", "wave_host_ms.serve_closed",
              "wave_turnaround_ms.serve_closed"},
    "unet_eval": {"call_overhead_ms.eval", "env_ms_per_replan.eval"},
    "transformer_eval": {"env_ms_per_replan.eval", "sampler_step_ms.eval"},
}


def _read(out, cfg):
    values = {}
    for name in READERS:
        v = spec.metric_reader(name).read(name, out, cfg)
        assert v is None or (isinstance(v, float) and math.isfinite(v)), \
            (name, v)
        values[name] = v
    return values


@pytest.mark.parametrize("kind", ["serve", "unet_eval", "transformer_eval"])
def test_span_readers_on_a_traced_cpu_run(kind):
    cfg = tiny.transformer() if kind == "transformer_eval" else tiny.unet()
    traffic = (tiny.traffic("serve_closed8", trace_from_s=0.2, trace_waves=4)
               if kind == "serve" else tiny.traffic("eval_1024"))
    out, _ = run.execute(cfg, traffic, SEED, 3.0, CPU, trace=True)
    assert out.trace is not None and out.correct
    values = _read(out, cfg)
    found = {n for n, v in values.items() if v is not None}
    assert found == FOUND[kind], found
    assert all(values[n] >= 0 for n in found)
    t0, t1 = out.trace["host_s"]
    assert all(t0 <= s.t0 <= s.t1 <= t1 for s in spans.recorded(out))


def test_span_readers_without_spans():
    out = Outcome(window_start=0.0, end_to_end={}, attempted=0, failed=0,
                  memory_peak_bytes=0, checks={})
    assert set(_read(out, tiny.unet()).values()) == {None}
    out.trace = {"host_s": [0.0, 0.0]}
    assert set(_read(out, tiny.unet()).values()) == {None}
