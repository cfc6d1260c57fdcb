"""The port's tensor and sequence parallelism against the JAX package
(tests/test_tensor_parallel.py): the tp, sp and tp+sp forwards of both model
families against the one-device forward, the tp train steps against JAX's
one-device step, the spec table against JAX's ``unet_param_specs``, the
collective structure, the batched planner over a tp U-Net, and the
multi-device entry points.

One spawn of four gloo ranks on the CPU (tests/torch_parallel_workers.py)
runs every sharded case; each test reads its part. JAX runs in this process
only, on the CPU.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dadiff_tpu import losses as jl
from dadiff_tpu.models import diffusion as jd
from dadiff_tpu.models.temporal_transformer import (
    TemporalTransformer as JaxTransformer,
)
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.parallel.mesh import make_mesh as jax_mesh
from dadiff_tpu.parallel.tp import unet_param_specs as jax_specs
from dadiff_tpu.utils import training as jt

import torch_parallel_workers as w
from torch_jax_models import seeded_params

from dadiff_tpu_torch.io.torch_compat import (
    params_from_jax,
    transformer_params_from_jax,
    unet_key_mapping,
)
from dadiff_tpu_torch.parallel.tp import maybe_constrain, unet_param_specs

torch.set_num_threads(1)

H = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data():
    """tests/test_tensor_parallel.py:34-38."""
    r = np.random.RandomState(0)
    return (r.randn(8, H, w.D).astype(np.float32),
            r.randint(0, 20, (8,)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_models():
    unet = JaxUnet(transition_dim=w.D, dim=32, dim_mults=(1, 2))
    trans = JaxTransformer(transition_dim=w.D, dim=32, depth=2, n_heads=4)
    return (unet, seeded_params(unet, H, seed=0), trans,
            seeded_params(trans, H, seed=1))


def _tp_batch():
    rng = np.random.RandomState(1)
    return {"conditions": rng.randn(8, H, w.D).astype(np.float32),
            "t": rng.randint(0, 10, 8),
            "noise": rng.randn(8, H, w.D).astype(np.float32)}


class _JaxInjected(jl.BaseLoss):
    name = "diffusion"

    def __init__(self, diffusion):
        super().__init__(1.0)
        self.diffusion = diffusion

    def compute(self, params, batch, rng):
        return self.diffusion.loss(params, rng, batch["conditions"],
                                   t=batch["t"], noise=batch["noise"])


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's one-device step, SGD(1e-2) after a global-norm clip of 4:
    (loss, grad_norm, torch-named parameters)."""
    unet, params, _, _ = _jax_models()
    diff = jd.GaussianDiffusion(model=unet, horizon=H, observation_dim=w.OBS,
                                action_dim=w.ACT, n_timesteps=10)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    opt = optax.chain(optax.clip_by_global_norm(4.0), optax.sgd(1e-2))
    step = jt.make_train_step(jl.ComposedLoss([_JaxInjected(diff)]), opt,
                              use_ema=False, donate=False)
    state = jt.TrainState(step=jnp.asarray(0), params=params,
                          opt_state=opt.init(params), ema_params=None)
    state, m = step(state, {k: jnp.asarray(v) for k, v in _tp_batch().items()},
                    jax.random.PRNGKey(2))
    return (float(m["total"]), float(m["grad_norm"]),
            params_from_jax(_np_tree(state.params)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, uparams, _, tparams = _jax_models()
    x, t = _data()
    inputs = {
        "x": torch.from_numpy(x), "t": torch.from_numpy(t).long(),
        "unet32": params_from_jax(_np_tree(uparams)),
        "transformer": transformer_params_from_jax(_np_tree(tparams)),
        "tp_batch": {k: torch.from_numpy(v) for k, v in _tp_batch().items()},
    }
    tmp = str(tmp_path_factory.mktemp("tp"))
    return inputs, w.spawn("tp", 4, inputs, tmp)


def test_maybe_constrain_is_a_noop_without_a_mesh():
    x = torch.ones(4, 8, 8)
    assert maybe_constrain(x, ("dp", None, "tp")) is x


def test_param_specs_match_jax():
    """The spec table of every U-Net parameter at tp=2 is JAX's
    (tp.py:109-144) read through ``params_from_jax``'s names, its dims in
    torch's order (the reverse of flax's: (k, in, out) -> (out, in, k))."""
    unet, params, _, _ = _jax_models()
    specs = jax_specs(params, jax_mesh({"dp": 4, "tp": 2}), tp_axis="tp")
    want = {}
    for prefix, path, kind in unet_key_mapping(2):
        node = specs
        for p in path:
            node = node.get(p) if isinstance(node, dict) else None
            if node is None:
                break
        if node is None:
            continue
        kernel = node["scale" if kind == "norm" else "kernel"]
        want[f"{prefix}.weight"] = tuple(reversed(tuple(kernel)))
        want[f"{prefix}.bias"] = tuple(node["bias"])
    port = w.unet_diffusion(dim=32, horizon=H).model
    got = unet_param_specs(port, 2)
    assert got == want
    assert got["mid_block1.blocks.0.block.0.weight"] == ("tp", None, None)
    assert got["ups.0.2.conv.weight"] == (None, "tp", None)
    assert got["time_mlp.1.weight"] == (None, None)
    assert got["final_conv.1.weight"] == (None, None, None)


@pytest.mark.parametrize("family", ["unet", "transformer"])
@pytest.mark.parametrize("mesh", list(w.TP_MESHES))
def test_sharded_forward_matches_single_device(ranks, mesh, family):
    """tests/test_tensor_parallel.py:71-92: the sharded forward against the
    JAX module on one device, atol 2e-5, on every rank."""
    unet, uparams, trans, tparams = _jax_models()
    x, t = _data()
    model, params = (unet, uparams) if family == "unet" else (trans, tparams)
    ref = np.asarray(model.apply({"params": jax.tree_util.tree_map(
        jnp.asarray, params)}, jnp.asarray(x), jnp.asarray(t)))
    _, outs = ranks
    for out in outs:
        np.testing.assert_allclose(out[f"{family}/{mesh}"]["out"].numpy(),
                                   ref, atol=2e-5)


@pytest.mark.parametrize("mesh", ["tp", "sp-tp"])
def test_tp_train_step_matches_jax_single_device(ranks, mesh):
    """One SGD step after the global-norm clip, the U-Net's channels split
    over tp (and its horizon over sp): the loss, the whole norm (the
    DTensor-aware clip) and every weight of JAX's one-device step."""
    loss, norm, want = _jax_step()
    _, outs = ranks
    for out in outs:
        got = out[f"train/{mesh}"]
        assert got["loss"] == pytest.approx(loss, abs=1e-5)
        assert got["grad_norm"] == pytest.approx(norm, rel=1e-5)
        for name, v in want.items():
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       v.numpy(), atol=1e-4, err_msg=name)


def test_tp_forward_collective_structure(ranks):
    """tp contracts the whole-weight final conv's partial sums with an
    all-reduce, gathers only activations, never a whole weight. (The ranks
    import no JAX.)"""
    _, outs = ranks
    assert all(out["jax_modules"] == [] for out in outs)
    for family in ("unet", "transformer"):
        s = outs[0][f"{family}/tp"]
        assert s["summary"].get("all-reduce", {}).get("count", 0) >= 1, s
        assert s["violations"] == []


def test_sp_forward_collective_structure(ranks):
    """sp moves the kernels' boundary rows (2 + 2 at k=5, 1 for the
    down-sampling, 1 + 1 for the up-sampling), all-reduces GroupNorm's
    sums, and gathers no whole weight."""
    _, outs = ranks
    s = outs[0]["unet/sp"]
    rows = {shape[1] for shape in s["summary"]["all-gather"]["result_shapes"]}
    assert {2 * 4, 2 * 1, 2 * 2} <= rows  # world 2 x (2+2, 1+0, 1+1) rows
    assert s["summary"]["all-reduce"]["count"] >= 2 * 10
    assert s["violations"] == []


def test_tp_train_step_collective_structure(ranks):
    _, outs = ranks
    s = outs[0]["train/tp"]
    assert s["summary"].get("all-reduce", {}).get("count", 0) >= 1, s
    assert s["violations"] == []


def test_batched_planner_composes_with_tp(ranks):
    """The batch over dp and the U-Net over tp in one planner: the plans of
    ``make_sampler`` on one device (tests/test_tensor_parallel.py:169-202),
    the same generator seed."""
    from dadiff_tpu_torch.guides.sampling import (
        conditions_for_initial_obs,
        make_sampler,
    )

    inputs, outs = ranks
    diff = w.unet_diffusion(inputs["unet32"], dim=32, horizon=H)
    cond = conditions_for_initial_obs(
        torch.linspace(-1, 1, w.OBS)[None].repeat(8, 1), w.OBS, H, w.D)
    want = make_sampler(diff)(torch.Generator().manual_seed(7), cond)
    for out in outs:
        np.testing.assert_allclose(out["planner"].numpy(), want.numpy(),
                                   atol=3e-5)


def _run(args, timeout=600):
    r = subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                       text=True, timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_dryrun_multichip_four_processes():
    """Its four legs at --nproc 4 over gloo: the dp x fsdp step, the
    batched planner, the physics loop and the dp x sp x tp step."""
    out = _run(["dadiff_tpu_torch.dryrun_multichip", "--nproc", "4",
                "--device", "cpu"])
    assert ("dryrun_multichip OK: mesh={'dp': 2, 'fsdp': 2}" in out
            and "physics loop ret=" in out
            and "tp/sp mesh={'dp': 1, 'sp': 2, 'tp': 2} loss=" in out), out


def test_analyze_tp_comm(tmp_path):
    out_md = tmp_path / "tp.md"
    _run(["dadiff_tpu_torch.analyze_tp_comm", "--dim", "32", "--nproc", "4",
          "--device", "cpu", "--out", str(out_md)])
    text = out_md.read_text()
    assert "| dp=2 tp=2 | all-reduce | 1 |" in text
    assert "| dp=1 tp=4 | all-gather |" in text
    assert "VIOLATIONS" not in text


@pytest.mark.parametrize("module,argv", [
    ("dryrun_multihost", []),
    ("dryrun_multichip", ["--nproc", "2"]),
    ("analyze_tp_comm", ["--nproc", "2"]),
])
def test_entry_points_take_the_cards_unless_told_cpu(module, argv,
                                                    monkeypatch):
    """Without ``--device cpu`` each entry point asks for a card per
    process and refuses, naming ``--device cpu``, when too few are
    visible: no entry point moves to the CPU on its own."""
    import importlib

    main = importlib.import_module(f"dadiff_tpu_torch.{module}").main
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(argv)
