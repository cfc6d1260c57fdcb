"""The frozen work counts reproduce PERF.md's bounds (section 3)."""

import pytest

from portbench import spec, work


@pytest.mark.parametrize("chains,bound_ms", [
    (8, "0.236"), (16, "0.471"), (32, "0.942"), (64, "1.884"),
    (1024, "30.13")])
def test_wave_bound(chains, bound_ms):
    cfg = spec.load_config("unet_umaze")
    flops, nbytes = work.wave_work(cfg, chains)
    assert flops / work.PEAK_BF16 > nbytes / work.HBM_BPS  # operations
    # PERF.md gives each bound rounded to the digits written
    digits = len(bound_ms.split(".")[1])
    assert f"{work.wave_least_s(cfg, chains) * 1e3:.{digits}f}" == bound_ms


def test_transformer_forward_bound():
    cfg = spec.load_config("transformer_umaze")
    assert work.model_flops(cfg, 1024) / work.PEAK_F32 * 1e3 == \
        pytest.approx(4.808, abs=1e-3)


def test_unet_convs_of_a_step():
    cfg = spec.load_config("unet_umaze")
    convs = work.unet_convs(cfg)
    assert sum(1 for c in convs if c[5]) == 25        # rows_conv_gn
    assert sum(1 for c in convs if not c[5]) == 10    # rows_conv
