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


def _unet_specs_by_torch_name(specs):
    """JAX's U-Net spec tree read through ``params_from_jax``'s names, its
    dims in torch's order (the reverse of flax's: (k, in, out) -> (out, in,
    k))."""
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
    return want


def _transformer_specs_by_torch_name(specs, depth=2):
    """JAX's transformer spec tree read through
    ``transformer_params_from_jax``'s names and layouts: a dense (in, out)
    kernel reversed; q/k/v (in, heads, head_dim) -> (heads * head_dim, in);
    out (heads, head_dim, out) -> (out, heads * head_dim)."""
    def dense(prefix, node):
        return {f"{prefix}.weight": tuple(reversed(tuple(node["kernel"]))),
                f"{prefix}.bias": tuple(node["bias"])}

    want = {"pos_emb": tuple(specs["pos_emb"])}
    for name in ("time_dense1", "time_dense2", "in_proj", "final_mod",
                 "out_proj"):
        want.update(dense(name, specs[name]))
    for i in range(depth):
        blk, pre = specs[f"block_{i}"], f"blocks.{i}"
        for name in ("adaln_mod", "mlp1", "mlp2"):
            want.update(dense(f"{pre}.{name}", blk[name]))
        for name in ("query", "key", "value"):
            k, b = blk["attn"][name]["kernel"], blk["attn"][name]["bias"]
            want[f"{pre}.attn.{name}.weight"] = (k[1] or k[2], k[0])
            want[f"{pre}.attn.{name}.bias"] = (b[0] or b[1],)
        k = blk["attn"]["out"]["kernel"]
        want[f"{pre}.attn.out.weight"] = (k[2], k[0] or k[1])
        want[f"{pre}.attn.out.bias"] = tuple(blk["attn"]["out"]["bias"])
    return want


def test_param_specs_match_jax():
    """The spec table of every U-Net parameter at tp=2 is JAX's
    (tp.py:109-144) read through ``params_from_jax``'s names, its dims in
    torch's order (the reverse of flax's: (k, in, out) -> (out, in, k))."""
    unet, params, _, _ = _jax_models()
    specs = jax_specs(params, jax_mesh({"dp": 4, "tp": 2}), tp_axis="tp")
    want = _unet_specs_by_torch_name(specs)
    port = w.unet_diffusion(dim=32, horizon=H).model
    got = unet_param_specs(port, 2)
    assert got == want
    assert got["mid_block1.blocks.0.block.0.weight"] == ("tp", None, None)
    assert got["ups.0.2.conv.weight"] == (None, "tp", None)
    assert got["time_mlp.1.weight"] == (None, None)
    assert got["final_conv.1.weight"] == (None, None, None)


def test_2d_param_specs_match_jax():
    """tp x fsdp (JAX's test_tp_fsdp_2d_param_sharding mesh, {fsdp: 4, tp:
    2}): every U-Net leaf is JAX's ``unet_param_specs(..., fsdp_axis=)``.
    A square dense weight ties its two dims; JAX takes the first in flax's
    (in, out), so the port's (out, in) splits dim 1 over fsdp."""
    unet, params, _, _ = _jax_models()
    specs = jax_specs(params, jax_mesh({"fsdp": 4, "tp": 2}), tp_axis="tp",
                      fsdp_axis="fsdp")
    want = _unet_specs_by_torch_name(specs)
    port = w.unet_diffusion(dim=32, horizon=H).model
    got = unet_param_specs(port, 2, fsdp_axis="fsdp", fsdp_size=4)
    assert got == want
    assert port.downs[0][0].time_mlp[1].weight.shape == (32, 32)
    assert got["downs.0.0.time_mlp.1.weight"] == (None, "fsdp")  # the tie
    assert got["mid_block1.blocks.0.block.0.weight"] == ("tp", "fsdp", None)
    assert got["ups.0.2.conv.weight"] == ("fsdp", "tp", None)
    assert got["final_conv.1.weight"] == (None, "fsdp", None)
    assert unet_param_specs(port, 2, fsdp_axis="fsdp", fsdp_size=1) == \
        unet_param_specs(port, 2)


# the transformer's Megatron table keeps whole what JAX's GSPMD table
# splits over tp: the outputs of in_proj, adaln_mod, mlp2 and final_mod and
# the width of pos_emb (ROADMAP Queue 3: the residual stream stays whole)
MEGATRON_DEPARTURES = ("in_proj", "adaln_mod", "mlp2", "final_mod", "pos_emb")


def test_2d_transformer_specs_match_jax_but_megatron_departures():
    """The transformer at {fsdp: 4, tp: 2}: every leaf equals JAX's table
    except the leaves of the departures named above, each of which
    differs."""
    from dadiff_tpu_torch.parallel.tp import transformer_param_specs

    _, _, trans, params = _jax_models()
    specs = jax_specs(params, jax_mesh({"fsdp": 4, "tp": 2}), tp_axis="tp",
                      fsdp_axis="fsdp")
    want = _transformer_specs_by_torch_name(specs)
    port = w.transformer(transformer_params_from_jax(_np_tree(params)))
    got = transformer_param_specs(port, 2, fsdp_axis="fsdp", fsdp_size=4)
    assert set(got) == set(want)
    departing = {n for n in want if any(d in n for d in MEGATRON_DEPARTURES)}
    assert {n for n in want if got[n] != want[n]} == departing
    assert len(departing) == 2 + 2 + 2 * 2 * 2 + 1  # depth 2
    assert got["blocks.0.attn.query.weight"] == ("tp", "fsdp")
    assert got["blocks.0.attn.out.weight"] == ("fsdp", "tp")
    assert got["blocks.0.mlp2.weight"] == ("fsdp", "tp")  # JAX: ("tp", "fsdp")


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


@pytest.mark.parametrize("mesh", w.TP_TRAIN)
def test_tp_train_step_matches_jax_single_device(ranks, mesh):
    """One SGD step after the global-norm clip, the U-Net's channels split
    over tp (and its horizon over sp, or its weights in 2-D over fsdp):
    the loss, the whole norm (the DTensor-aware clip, reduced over both
    axes of a 2-D placement) and every weight of JAX's one-device step."""
    loss, norm, want = _jax_step()
    _, outs = ranks
    for out in outs:
        got = out[f"train/{mesh}"]
        assert got["loss"] == pytest.approx(loss, abs=1e-5)
        assert got["grad_norm"] == pytest.approx(norm, rel=1e-5)
        for name, v in want.items():
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       v.numpy(), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("mesh", ["fsdp-tp", "dp-fsdp"])
def test_2d_ranks_hold_only_their_blocks(ranks, mesh):
    """Each rank stores its block of every parameter: numel / (tp x fsdp)
    elements of a leaf split on both axes, numel / fsdp of one split over
    fsdp alone, the whole of one the table keeps whole."""
    _, outs = ranks
    axes = w.TP_MESHES[mesh][0]
    port = w.unet_diffusion(dim=32, horizon=H).model
    specs = unet_param_specs(port, axes.get("tp", 1),
                             tp_axis="tp" if "tp" in axes else None,
                             fsdp_axis="fsdp", fsdp_size=axes["fsdp"])
    shapes = {n: p.shape for n, p in port.named_parameters()}
    two_d = [n for n, s in specs.items() if "tp" in s and "fsdp" in s]
    assert len(two_d) >= (20 if "tp" in axes else 0)
    for out in outs:
        local = out[f"train/{mesh}"]["local_shapes"]
        for name, spec in specs.items():
            parts = np.prod([axes[a] for a in spec if a is not None])
            assert np.prod(local[name]) * parts == np.prod(shapes[name]), name
        for name in two_d:
            assert np.prod(local[name]) == np.prod(shapes[name]) // 4, name


@pytest.mark.parametrize("family", ["unet", "transformer"])
def test_2d_forward_collective_structure(ranks, family):
    """The tp x fsdp forward gathers each fsdp-split weight where a layer
    uses it, counted under its own kind (``all-gather/fsdp``), and holds
    the tp side to the rule of the 1-D forwards: no all-gather of the tp
    kind rebuilds a whole weight."""
    _, outs = ranks
    s = outs[0][f"{family}/fsdp-tp"]
    assert s["summary"]["all-gather/fsdp"]["count"] >= 10, s["summary"]
    assert s["summary"].get("all-reduce", {}).get("count", 0) >= 1
    assert s["violations"] == []


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
