"""How long a served request waits in the batcher's queue: the median of
the port's ``batcher.queue`` spans (from the request's submit to the start
of its wave) inside the traced sub-window."""

from portbench import spans


def read(name, out, cfg):
    return spans.median(spans.durations_ms(spans.recorded(out),
                                           "batcher.queue"))
