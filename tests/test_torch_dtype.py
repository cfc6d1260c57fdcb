"""bfloat16 activations (``dtype``) of both model families, held against
the JAX modules at ``dtype=jnp.bfloat16`` on the CPU: the forwards, three
train steps (losses and the change in the weights), the sharded U-Net
forward's refusal, and ``train --dtype bfloat16`` through the CLI.

Weights come from ``tests/torch_jax_models.seeded_params``; inputs from
numpy seeds. The two sides round to bfloat16 at the same points of the
network, but XLA on the CPU fuses elementwise chains and keeps excess
precision inside a fusion, and PyTorch's CPU conv, matmul, softmax and Mish
take float32 inside an op and round once, so the roundings differ by
construction. Measured spread at two seeds (dim 32, depth 2 / mults 1 2 4,
horizon 16): the forward's largest difference 0.63-1.19% of the largest
output (JAX's own bfloat16 output with excess precision on and off differs
as much, up to 0.033 absolute); three train steps: the loss 0-0.20%
relative, the change in the weights 8.0-11.1% in the L2 norm. Tolerances,
about 2.5x the largest reading: the forward 3e-2 of the largest output,
the loss 5e-3 relative, the weight change 0.25 in the L2 norm. The f32
tolerances of the other files are unchanged.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dadiff_tpu import losses as jl
from dadiff_tpu.models import diffusion as jd
from dadiff_tpu.models.temporal_transformer import (
    TemporalTransformer as JaxTransformer,
)
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.utils import training as jt

from dadiff_tpu_torch import cli, losses
from dadiff_tpu_torch.io.torch_compat import (
    load_pt_checkpoint,
    params_from_jax,
    transformer_params_from_jax,
)
from dadiff_tpu_torch.models import diffusion as td
from dadiff_tpu_torch.models.temporal_transformer import TemporalTransformer
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.parallel import tp
from dadiff_tpu_torch.utils import training as tt
from tests.torch_jax_models import seeded_params

torch.set_num_threads(1)

OBS, ACT, T_STEPS = 6, 2, 10
D = OBS + ACT
TOL_FWD_BF16 = 3e-2    # of the largest |output|
TOL_LOSS_BF16 = 5e-3   # relative
TOL_DW_BF16 = 0.25     # relative L2 of the change in the weights
DATASET = "synthetic:pointmaze:n=6,T=40"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(family, dtype, seed, width):
    """The JAX module at ``dtype`` and the port's at the torch dtype, both
    on the JAX weights drawn from ``seed``; ``width`` (dim, mults or
    depth, horizon)."""
    dim, shape, H = width
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    if family == "transformer":
        kw = dict(dim=dim, depth=shape, n_heads=2 if dim == 16 else 4)
        jm = JaxTransformer(transition_dim=D, dtype=jdt, **kw)
        params = seeded_params(JaxTransformer(transition_dim=D, **kw), H,
                               seed=seed)
        m = TemporalTransformer(D, dtype=tdt, **{
            "dim": dim, "depth": shape, "n_heads": kw["n_heads"]})
        m.load_state_dict(transformer_params_from_jax(_np_tree(params)),
                          strict=True)
        return jm, params, m
    jm = JaxUnet(transition_dim=D, dim=dim, dim_mults=shape, dtype=jdt)
    params = seeded_params(JaxUnet(transition_dim=D, dim=dim,
                                   dim_mults=shape), H, seed=seed)
    m = TemporalUnet(D, dim=dim, dim_mults=shape, dtype=tdt,
                     use_pallas_norm=family == "unet_pallas")
    m.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    return jm, params, m


def _forward_width(family):
    return (32, 2, 16) if family == "transformer" else (32, (1, 2, 4), 16)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("family", ["unet", "unet_pallas", "transformer"])
def test_bf16_forward_matches_jax(family, seed):
    """The bfloat16 forward against JAX's at bfloat16 (K1 on the plain
    version under ``use_pallas_norm``); float32 out, float32 weights, and
    bfloat16 really taken: the port's bfloat16 output is not its float32
    output."""
    H = _forward_width(family)[2]
    jm, params, m = _pair(family, "bfloat16", seed, _forward_width(family))
    rng = np.random.RandomState(10 + seed)
    x = rng.randn(4, H, D).astype(np.float32)
    t = rng.randint(0, T_STEPS, 4).astype(np.int32)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x, t))
    assert want.dtype == np.float32
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t).long())
        m32 = type(m)(**{**_ctor(m), "dtype": torch.float32})
        m32.load_state_dict(m.state_dict())
        f32 = m32(torch.from_numpy(x), torch.from_numpy(t).long())
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in m.parameters())
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL_FWD_BF16 * scale)
    assert float((got - f32).abs().max()) > 1e-3 * scale


def _ctor(m):
    if isinstance(m, TemporalTransformer):
        return dict(transition_dim=m.transition_dim, dim=m.dim, depth=m.depth,
                    n_heads=m.n_heads)
    return dict(transition_dim=m.transition_dim, dim=m.dim,
                dim_mults=m.dim_mults)


def test_dtype_defaults_to_float32_in_every_block():
    unet = TemporalUnet(D, dim=16, dim_mults=(1, 2), dtype=torch.bfloat16)
    blocks = [b for b in unet.modules() if hasattr(b, "dtype")
              and isinstance(b, torch.nn.Module)]
    assert len(blocks) > 5 and {b.dtype for b in blocks} == {torch.bfloat16}
    assert TemporalUnet(D, dim=16, dim_mults=(1, 2)).dtype == torch.float32
    tr = TemporalTransformer(D, dim=16, depth=2, n_heads=2,
                             dtype=torch.bfloat16)
    assert {b.dtype for b in tr.blocks} == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in tr.parameters())


def test_sharded_unet_forward_refuses_bf16():
    """``parallel/tp.py`` keeps a second copy of the U-Net forward; it runs
    float32 only and names the plain forward."""
    unet = TemporalUnet(D, dim=16, dim_mults=(1, 2), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="plain forward"):
        tp.unet_forward(unet, torch.zeros(1, 8, D), torch.zeros(1).long())


class _JaxInjected(jl.BaseLoss):
    name = "diffusion"

    def __init__(self, diffusion):
        super().__init__(1.0)
        self.diffusion = diffusion

    def compute(self, params, batch, rng):
        return self.diffusion.loss(params, rng, batch["conditions"],
                                   t=batch["t"], noise=batch["noise"])


class _Injected(losses.BaseLoss):
    name = "diffusion"

    def __init__(self, diffusion):
        super().__init__(1.0)
        self.diffusion = diffusion

    def compute(self, batch, generator):
        return self.diffusion.loss(batch["conditions"], t=batch["t"],
                                   noise=batch["noise"])


@pytest.mark.parametrize("family", ["unet", "transformer"])
def test_bf16_train_steps_match_jax(family):
    """Three train steps (clip 4, Adam at 1e-3, no EMA) at bfloat16 on
    the same batches, t and noise: the losses and the change in the
    weights against JAX's."""
    H, B = 8, 8
    width = (16, 2, H) if family == "transformer" else (16, (1, 2), H)
    jm, params, m = _pair(family, "bfloat16", 0, width)
    jdiff = jd.GaussianDiffusion(model=jm, horizon=H, observation_dim=OBS,
                                 action_dim=ACT, n_timesteps=T_STEPS)
    diff = td.GaussianDiffusion(m, H, OBS, ACT, n_timesteps=T_STEPS)
    opt = jt.make_optimizer(jt.warmup_cosine_schedule(1e-3, 0, 20), 4.0)
    jstate = jt.TrainState(step=jnp.asarray(0), params=params,
                           opt_state=opt.init(params), ema_params=None)
    jstep = jt.make_train_step(jl.ComposedLoss([_JaxInjected(jdiff)]), opt,
                               ema_decay=0.9, donate=False, use_ema=False)
    state = tt.TrainState(module=diff, optimizer=tt.make_optimizer(
        diff.parameters(), 1e-3), ema_params=None)
    step = tt.make_train_step(
        losses.ComposedLoss([_Injected(diff)]),
        lr_schedule=tt.warmup_cosine_schedule(1e-3, 0, 20), gradient_clip=4.0,
        ema_decay=0.9, use_ema=False)
    start = {n: p.detach().clone() for n, p in m.named_parameters()}
    for i in range(3):
        rng = np.random.RandomState(20 + i)
        b = {"conditions": rng.randn(B, H, D).astype(np.float32),
             "t": rng.randint(0, T_STEPS, B),
             "noise": rng.randn(B, H, D).astype(np.float32)}
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.PRNGKey(i))
        got = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                   [None])
        np.testing.assert_allclose(float(got["total"]), float(jm_["total"]),
                                   rtol=TOL_LOSS_BF16, err_msg=f"step {i}")
    to_torch = (transformer_params_from_jax if family == "transformer"
                else params_from_jax)
    want, want0 = to_torch(_np_tree(jstate.params)), to_torch(_np_tree(params))
    names = [n for n, _ in m.named_parameters()]
    dp = np.concatenate([(p.detach() - start[n]).numpy().ravel()
                         for n, p in m.named_parameters()])
    dj = np.concatenate([(want[n] - want0[n]).numpy().ravel() for n in names])
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert np.linalg.norm(dp - dj) <= TOL_DW_BF16 * np.linalg.norm(dj)


@pytest.mark.parametrize("model_type", ["unet", "transformer"])
def test_train_cli_trains_bf16(model_type, tmp_path, monkeypatch):
    """``train --dtype bfloat16``: three finite steps, ``dtype`` recorded
    in the config.json written before training (JAX's ``vars(args)``,
    cli.py:180; a checkpoint rewrites it with the model's config, as JAX's
    Trainer does), float32 weights in the ``.pt``, and ``load_model``
    rebuilds a float32 module (cli.py:854-920 passes no dtype)."""
    seen = {}
    train = tt.Trainer.train

    def spy(self, *a, **kw):
        seen.update(json.load(open(f"{self.log_dir}/config.json")))
        return train(self, *a, **kw)

    monkeypatch.setattr(tt.Trainer, "train", spy)
    log_dir = cli.train_main([
        "--dataset", DATASET, "--horizon", "8", "--dim", "16", "--dim-mults",
        "1", "2", "--depth", "2", "--n-heads", "2", "--model-type",
        model_type, "--n-timesteps", "6", "--batch-size", "8",
        "--warmup-steps", "2", "--device", "cpu", "--log-freq", "1",
        "--n-epochs", "1", "--max-steps", "3", "--save-freq", "3",
        "--eval-freq", "0", "--dtype", "bfloat16",
        "--log-dir", str(tmp_path)])
    assert seen["dtype"] == "bfloat16"
    lines = [json.loads(l) for l in open(f"{log_dir}/metrics.jsonl")]
    assert lines[-1]["step"] == 3
    assert all(np.isfinite(v) for v in lines[-1]["total_series"])
    ckpt = f"{log_dir}/checkpoint_step_3.pt"
    state = load_pt_checkpoint(ckpt)["model_state_dict"]
    assert {v.dtype for v in state.values()
            if v.is_floating_point()} == {torch.float32}
    diff, _ = cli.load_model(ckpt, DATASET, device="cpu")
    assert diff.model.dtype == torch.float32
