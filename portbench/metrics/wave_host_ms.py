"""The wave runner's host time per served wave: the median of the port's
``batcher.wave`` spans on the batcher's thread (the sessions' draws, the
graph's launch and the best of N, up to the return of the launch) inside
the traced sub-window."""

from portbench import spans


def read(name, out, cfg):
    return spans.median(spans.durations_ms(spans.recorded(out),
                                           "batcher.wave"))
