"""The env's host time per replan: the median of the port's ``env.steps``
spans (a replan's ``action_horizon`` steps of the on-device maze) inside
the traced sub-window."""

from portbench import spans


def read(name, out, cfg):
    return spans.median(spans.durations_ms(spans.recorded(out),
                                           "env.steps"))
