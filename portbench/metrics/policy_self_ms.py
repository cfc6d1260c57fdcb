"""The policy's own time in a served replan: the median over requests of
the port's ``policy.act`` span less its ``batcher.wait`` (the batched
call) and ``policy.readback`` (the wait for the card) children, inside
the traced sub-window."""

from portbench import spans


def read(name, out, cfg):
    return spans.median(spans.self_ms(spans.recorded(out), "policy.act",
                                      ("batcher.wait", "policy.readback")))
