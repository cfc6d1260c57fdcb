"""What each evaluator call pays before its waves replay: the port's
``evaluator.prepare`` (the planner chain's operands), ``wave.host_driven``
and ``wave.capture`` spans summed over the traced calls, per traced
``evaluator.call``."""

from portbench import spans


def read(name, out, cfg):
    rec = spans.recorded(out)
    calls = len(spans.named(rec, "evaluator.call"))
    parts = [d for n in ("evaluator.prepare", "wave.host_driven",
                         "wave.capture") for d in spans.durations_ms(rec, n)]
    if not calls or not parts:
        return None
    return sum(parts) / calls
