"""What the cells read does not move when a family's parts are found by
name: the weights drawn for a seed and the work counts equal, bit for bit,
those computed by the harness that chose them by ``family == "unet"``,
and each reference forward gives the same bits with the chains'
observations handed to it as without."""

import hashlib

import pytest
import torch

from portbench import inputs, spec, work
from portbench.reference import precision

SEED = 2**31 + 977
CPU = torch.device("cpu")

WEIGHTS = {
    "unet_umaze":
        "5a1c9dae97631ed91a12d8eb0472501ea904b27aebfeea07af59a844898df2f0",
    "transformer_umaze":
        "1ac0298cef3760683695ed80b4d0f5dd22b24e8f3e287adfaf16eac5844c222a",
}
CHAINS = (8, 64, 1024)
MODEL_FLOPS = {
    "unet_umaze": (2336751616.0, 18694012928.0, 299104206848.0),
    "transformer_umaze": (2516582400.0, 20132659200.0, 322122547200.0),
}
WAVE_WORK = {
    8: (232928051200.0, 32676512.0),
    16: (465764352000.0, 33520288.0),
    32: (931436953600.0, 35207840.0),
    64: (1862782156800.0, 38582944.0),
    1024: (29803138252800.0, 139836064.0),
}


def digest(weights) -> str:
    h = hashlib.sha256()
    for name, w in weights.items():
        h.update(name.encode())
        h.update(str(tuple(w.shape)).encode())
        h.update(w.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_weights_drawn_as_before(name):
    cfg = spec.load_config(name)
    assert digest(inputs.make_weights(cfg, SEED, CPU)) == WEIGHTS[name]


@pytest.mark.parametrize("name", sorted(MODEL_FLOPS))
def test_model_flops_as_before(name):
    cfg = spec.load_config(name)
    assert tuple(work.model_flops(cfg, c) for c in CHAINS) == \
        MODEL_FLOPS[name]


@pytest.mark.parametrize("chains", sorted(WAVE_WORK))
def test_wave_work_as_before(chains):
    cfg = spec.load_config("unet_umaze")
    assert work.wave_work(cfg, chains) == WAVE_WORK[chains]


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_cond_changes_no_bit(name):
    cfg = spec.load_config(name)
    forward = spec.reference(cfg).forward
    w = inputs.make_weights(cfg, SEED, CPU)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, cfg["horizon"], cfg["transition_dim"], generator=g)
    t = torch.tensor([0, 17, 50, cfg["n_timesteps"] - 1])
    cond = torch.randn(4, cfg["observation_dim"], generator=g)
    prec = precision.ROUNDING[cfg["product_dtype"]]
    assert torch.equal(forward(w, cfg, x, t, prec, cond=None),
                       forward(w, cfg, x, t, prec, cond=cond))
