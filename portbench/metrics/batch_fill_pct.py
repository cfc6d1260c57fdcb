"""The batcher's fill: plan requests over the lanes of the waves that ran
in the window, each wave's count padded to the power of two it runs at.
Read from the port's own counters (``BatchedPlanner.batch_sizes``) of the
instance the server built."""


def _padded(k):
    p = 1
    while p < k:
        p *= 2
    return p


def read(name, out, cfg):
    sizes = out.records.get("batch_sizes")
    if not sizes:
        return None
    return 100.0 * sum(sizes) / sum(_padded(k) for k in sizes)
