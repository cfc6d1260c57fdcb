"""Median replan latency as the controllers see it, over every request of
the window (from its due time in an open loop, from its send in a closed
one; a failed request lies above every other): the server layer, from the
load generator's clock."""

from portbench.outcome import percentile


def read(name, out, cfg):
    lat = out.records.get("latencies_s")
    if not lat:
        return None
    return 1e3 * percentile(lat, 0.5)
