"""The batcher's serial host path between served waves: the median, over
consecutive waves n and n + 1 of the traced sub-window, of the start of
wave n + 1's ``batcher.wave`` span less the end of the last
``policy.readback`` of wave n's requests (their replies, the
controllers' next requests, the queue and the window)."""

from portbench import spans


def read(name, out, cfg):
    rec = spans.recorded(out)
    kids = spans.children(rec)
    starts = {s.attrs.get("wave"): s.t0
              for s in spans.named(rec, "batcher.wave")}
    readback_end = {}
    for act in spans.named(rec, "policy.act"):
        sub = kids.get(act.sid, ())
        wave = next((c.attrs.get("wave") for c in sub
                     if c.name == spans.PREFIX + "batcher.wait"), None)
        ends = [c.t1 for c in sub
                if c.name == spans.PREFIX + "policy.readback"]
        if wave is not None and ends:
            readback_end[wave] = max([readback_end.get(wave, 0.0), *ends])
    gaps = [1e3 * (starts[w + 1] - end) for w, end in readback_end.items()
            if w in starts and w + 1 in starts]
    return spans.median(gaps)
