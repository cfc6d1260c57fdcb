"""The whole model step's share of the card's peak: model FLOPs (every
denoiser call of the plans or replans completed inside the traced
sub-window, counted from shapes by the configuration's family,
portbench/families/<family>.py) over the
sub-window's wall time times the peak of the precision the path's
products run in (bf16 989 TFLOP/s for the K2 wave; for float32 products
TF32 495 TFLOP/s where ``torch.backends.cuda.matmul.allow_tf32`` reads
true, else 67 TFLOP/s). The peaks are the H100 SXM data sheet's at its
full 700 W; the cells were measured on H100 80GB HBM3 cards whose
``power.limit`` read 700.00 W."""

from portbench import work


def read(name, out, cfg):
    t = out.trace
    if not t:
        return None
    t0, t1 = t["host_s"]
    steps = cfg["n_timesteps"]
    if "recv" in out.records:   # served plans answered in the sub-window
        n = sum(1 for r in out.records["recv"] if t0 <= r <= t1)
        flops = n * steps * work.model_flops(cfg, cfg["n_candidates"],
                                             out.records["pkg"])
    else:                       # the traced call's replans
        flops = out.records["replans_traced"] * steps * work.model_flops(
            cfg, out.records["chains"], out.records["pkg"])
    if flops <= 0:
        return None
    peak, _ = work.product_peak(cfg)
    return 100.0 * flops / ((t1 - t0) * peak)
