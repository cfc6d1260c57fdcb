"""K2's share of its roofline over the waves of the traced sub-window: the
least time of their work (portbench/work.py: operations at the bf16 peak,
989 TFLOP/s, or bytes at 3.35 TB/s, whichever is longer, at each wave's
padded chain count) over the device time of every kernel, copy and set
that ran inside those waves, whatever its name."""

from portbench import work


def read(name, out, cfg):
    waves = (out.trace or {}).get("waves") or []
    device_s = sum(s for _, s in waves)
    if not waves or device_s <= 0:
        return None
    least = sum(work.wave_least_s(cfg, chains, out.records["pkg"])
                for chains, _ in waves)
    return 100.0 * least / device_s
