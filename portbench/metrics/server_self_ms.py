"""The server's own time in a served replan: the median over requests of
the port's ``serve.request`` span (from the line read to the reply's
flush) less its ``policy.act`` child, inside the traced sub-window."""

from portbench import spans


def read(name, out, cfg):
    return spans.median(spans.self_ms(spans.recorded(out), "serve.request",
                                      ("policy.act",)))
