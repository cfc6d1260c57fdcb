"""The card's idle share of the traced sub-window: one minus the union of
its kernel, copy and set intervals over the sub-window's wall time (the
CUPTI trace)."""


def read(name, out, cfg):
    t = out.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
