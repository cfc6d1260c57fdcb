"""The module-path sampler's host time per denoising step: the median of
the port's ``sampler.step`` spans (one call of the denoiser, the DDPM
update, the projection and the conditioning) inside the traced
sub-window."""

from portbench import spans


def read(name, out, cfg):
    return spans.median(spans.durations_ms(spans.recorded(out),
                                           "sampler.step"))
