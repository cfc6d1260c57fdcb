"""The port's batch-1 latency ladder held against the JAX package on the CPU:
the fused residual block (K4's plain version and its gradient), the fused
U-Net, the hoisted sampler, the one-launch chain (K3's plain version and the
layer program its kernel walks) and ``probe_megakernel``.

Inputs come from numpy seeds. The JAX Pallas kernels run in interpret mode
with float32 weights, as tests/test_pallas_resblock.py and
tests/test_pallas_unet.py run them; the tolerances are those files' own.
On the CPU every wrapper takes its plain version; the kernels themselves are
held against the plain versions on the card by chip_smoke.py.
"""

import ctypes

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dadiff_tpu.guides.sampling import conditions_for_initial_obs as jax_cond
from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.diffusion import p_sample_loop as jax_p_sample_loop
from dadiff_tpu.models.fast_sampler import fast_p_sample_loop as jax_fast
from dadiff_tpu.models.fused_unet import _block_params as jax_block_params
from dadiff_tpu.models.fused_unet import unet_apply_fused as jax_fused
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.ops.pallas_resblock import _frb_bwd, residual_block_pallas
from dadiff_tpu.ops.pallas_unet import pallas_p_sample_loop

from dadiff_tpu_torch import probe_megakernel
from dadiff_tpu_torch.guides.sampling import (
    conditions_for_initial_obs,
    make_sampler,
)
from dadiff_tpu_torch.io.torch_compat import (
    block_params_from_jax,
    params_from_jax,
)
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion, default_timesteps
from dadiff_tpu_torch.models.fast_sampler import fast_p_sample_loop
from dadiff_tpu_torch.models.fused_unet import (
    _block_params,
    make_fused_apply,
    unet_apply_fused,
)
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops import chain as ch
from dadiff_tpu_torch.ops import resblock as rb
from dadiff_tpu_torch.ops.chain_operands import prepare_chain_operands
from dadiff_tpu_torch.ops.conv_tiling import tile_shape
from dadiff_tpu_torch.ops.planner import DOWN, UP, StepConfig
from tests.torch_program import interpret

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

D = 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(dim, mults, H, T, seed=0):
    """The same U-Net and diffusion on both sides, weights from the JAX init."""
    jax_unet = JaxUnet(transition_dim=D, dim=dim, dim_mults=mults)
    jax_diff = JaxDiffusion(model=jax_unet, horizon=H, observation_dim=6,
                            action_dim=2, n_timesteps=T)
    params = jax.jit(jax_diff.init_params)(jax.random.PRNGKey(seed))
    unet = TemporalUnet(transition_dim=D, dim=dim, dim_mults=mults)
    unet.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    diff = GaussianDiffusion(unet, horizon=H, observation_dim=6, action_dim=2,
                             n_timesteps=T).eval()
    return jax_diff, params, diff


def _noise(T, H, seed, batch=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, H, D).astype(np.float32),
            rng.randn(T, batch, H, D).astype(np.float32))


@pytest.fixture(scope="module")
def three_level():
    return _pair(16, (1, 2, 4), 16, 6)


# ---------------------------------------------------------------------------
# K4: the fused residual block
# ---------------------------------------------------------------------------

def _block_inputs(cin, cout, with_res, B=2, H=16, k=5, seed=0):
    rng = np.random.RandomState(seed)
    p = {"w1": rng.randn(k, cin, cout) * 0.2, "b1": rng.randn(cout) * 0.1,
         "s1": 1 + 0.1 * rng.randn(cout), "g1": 0.1 * rng.randn(cout),
         "w2": rng.randn(k, cout, cout) * 0.2, "b2": rng.randn(cout) * 0.1,
         "s2": 1 + 0.1 * rng.randn(cout), "g2": 0.1 * rng.randn(cout)}
    if with_res:
        p["wr"] = rng.randn(cin, cout) * 0.2
        p["br"] = rng.randn(cout) * 0.1
    p = {k_: v.astype(np.float32) for k_, v in p.items()}
    x = rng.randn(B, H, cin).astype(np.float32)
    te = rng.randn(B, cout).astype(np.float32)
    return x, te, p


@pytest.mark.parametrize("cin,cout,with_res", [(64, 64, False), (16, 64, True)])
def test_residual_block_plain_matches_pallas(cin, cout, with_res):
    x, te, p = _block_inputs(cin, cout, with_res)
    want = residual_block_pallas(jnp.asarray(x), jnp.asarray(te),
                                 {k: jnp.asarray(v) for k, v in p.items()},
                                 n_groups=8, interpret=True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = rb.residual_block_plain(torch.from_numpy(x), torch.from_numpy(te), tp)
    # tests/test_pallas_resblock.py:43
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(rb.fused_residual_block(
        torch.from_numpy(x), torch.from_numpy(te), tp), got)


def _plain_launch(x, te, params, out, n_groups, eps, stream=None):
    """Stands in for the kernel's launcher where there is no card."""
    with torch.no_grad():
        out.copy_(rb.residual_block_plain(x, te, params, n_groups, eps))
    rb.fused_residual_block.launches += 1


@pytest.mark.parametrize("cin,cout,with_res", [(16, 16, False), (8, 32, True)])
@pytest.mark.parametrize("through_function", [False, True])
def test_fused_residual_block_gradients_match_jax(monkeypatch, cin, cout,
                                                  with_res, through_function):
    """Gradients w.r.t. x, te and every weight against the JAX custom_vjp's
    backward rule, 1e-4. ``through_function`` drives the autograd.Function
    that wraps the kernel (its launcher replaced by the plain version), so
    the backward the card runs is the one checked."""
    x, te, p = _block_inputs(cin, cout, with_res, B=2, H=8, seed=3)
    gy = np.random.RandomState(4).randn(2, 8, cout).astype(np.float32)
    gx, gte, gp = _frb_bwd(8, (jnp.asarray(x), jnp.asarray(te),
                               {k: jnp.asarray(v) for k, v in p.items()}),
                           jnp.asarray(gy))
    tx = torch.from_numpy(x).requires_grad_(True)
    tte = torch.from_numpy(te).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    if through_function:
        monkeypatch.setattr(rb, "launch_resblock", _plain_launch)
        before = rb.fused_residual_block.launches
        names = tuple(tp)
        out = rb._ResBlockCuda.apply(tx, tte, 8, 1e-5, names,
                                     *(tp[n] for n in names))
        assert rb.fused_residual_block.launches == before + 1
    else:
        out = rb.fused_residual_block(tx, tte, tp)
    out.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tte.grad.numpy(), np.asarray(gte), rtol=1e-4,
                               atol=1e-4)
    assert set(gp) == set(tp)
    for name in tp:
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(gp[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_fused_residual_block_rejects_bad_operands():
    x, te, p = _block_inputs(8, 16, True, B=1, H=8)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx, tte = torch.from_numpy(x), torch.from_numpy(te)
    rb._check_cuda(tx, tte, tp, 8)
    with pytest.raises(ValueError, match="contiguous"):
        rb._check_cuda(tx, tte, {**tp, "w1": tp["w1"].permute(0, 2, 1)
                                 .contiguous().permute(0, 2, 1)}, 8)
    with pytest.raises(ValueError, match="shapes"):
        rb._check_cuda(tx, tte[:, :8].contiguous(), tp, 8)
    no_res = {k: v for k, v in tp.items() if k not in ("wr", "br")}
    with pytest.raises(ValueError, match="residual"):
        rb._check_cuda(tx, tte, no_res, 8)
    with pytest.raises(ValueError, match="unknown"):
        rb._check_cuda(tx, tte, {**tp, "w3": tp["w2"]}, 8)


# ---------------------------------------------------------------------------
# Fused U-Net and the hoisted sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mults", [(1, 2), (1, 2, 4)])
def test_fused_unet_matches_jax_and_module(mults):
    jax_diff, params, diff = _pair(16, mults, 16, 10)
    rng = np.random.RandomState(1)
    x = rng.randn(3, 16, D).astype(np.float32)
    t = np.array([0, 5, 9])
    want = jax.jit(lambda p, x_, t_: jax_fused(
        jax_diff.model, p, x_, t_, use_pallas=False))(
            params, jnp.asarray(x), jnp.asarray(t, jnp.int32))
    with torch.no_grad():
        got = unet_apply_fused(diff.model, torch.from_numpy(x),
                               torch.from_numpy(t))
        module = diff.model(torch.from_numpy(x), torch.from_numpy(t))
        via_factory = make_fused_apply(diff.model)(torch.from_numpy(x),
                                                   torch.from_numpy(t))
    # tests/test_fused_unet.py:21
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), module.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(via_factory, got)
    with pytest.raises(ValueError, match="t_emb"):
        unet_apply_fused(diff.model, torch.from_numpy(x))


def test_block_params_layout_matches_jax(three_level):
    jax_diff, params, diff = three_level
    p = _np_tree(params)
    for name, block in (("down_0_res1", diff.model.downs[0][0]),
                        ("mid_block1", diff.model.mid_block1),
                        ("up_0_res1", diff.model.ups[0][0])):
        want = jax_block_params(p[name])
        got = _block_params(block)
        carried = block_params_from_jax(p[name])
        assert set(got) == set(want) == set(carried)
        for k in want:
            assert got[k].is_contiguous()
            np.testing.assert_array_equal(got[k].detach().numpy(),
                                          np.asarray(want[k]), err_msg=k)
            np.testing.assert_array_equal(carried[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("sampling_timesteps", [None, 5])
def test_fast_p_sample_loop_matches_jax(sampling_timesteps):
    jax_diff, params, diff = _pair(8, (1, 2), 8, 20)
    T = sampling_timesteps or 20
    init, noise = _noise(T, 8, 2, batch=2)
    want = jax.jit(lambda p, i, n: jax_fast(
        jax_diff.model, p, jax_diff.schedule, jax.random.PRNGKey(0), (2, 8, D),
        sampling_timesteps=sampling_timesteps, init_noise=i, step_noise=n))(
            params, jnp.asarray(init), jnp.asarray(noise))
    kw = dict(sampling_timesteps=sampling_timesteps,
              init_noise=torch.from_numpy(init),
              step_noise=torch.from_numpy(noise))
    got = fast_p_sample_loop(diff.model, diff.schedule, (2, 8, D), **kw)
    module = diff.p_sample_loop((2, 8, D), **kw)
    # tests/test_fast_sampler.py:32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), module.numpy(), rtol=1e-3,
                               atol=1e-4)
    drawn = fast_p_sample_loop(diff.model, diff.schedule, (1, 8, D),
                               sampling_timesteps=5,
                               generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (1, 8, D) and torch.isfinite(drawn).all()


# ---------------------------------------------------------------------------
# K3: the one-launch chain
# ---------------------------------------------------------------------------

def _jax_chain(jax_diff, params, init, noise, **kw):
    H = init.shape[1]
    return jax.jit(lambda p, i, n: pallas_p_sample_loop(
        jax_diff.model, p, jax_diff.schedule, jax.random.PRNGKey(5),
        (1, H, D), interpret=True, init_noise=i, step_noise=n, **kw))(
            params, jnp.asarray(init), jnp.asarray(noise))


@pytest.mark.parametrize("dim,mults,H,T", [(16, (1, 2, 4), 16, 6),
                                           (16, (1, 2), 16, 4)])
def test_chain_f32_matches_pallas_chain(dim, mults, H, T):
    jax_diff, params, diff = _pair(dim, mults, H, T)
    init, noise = _noise(T, H, 7)
    want = _jax_chain(jax_diff, params, init, noise, weight_dtype=jnp.float32)
    got = ch.chain_p_sample_loop(
        diff.model, diff.schedule, (1, H, D), weight_dtype=torch.float32,
        init_noise=torch.from_numpy(init), step_noise=torch.from_numpy(noise))
    # tests/test_pallas_unet.py:48
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_chain_bf16_close_to_f32_module_path(three_level):
    jax_diff, params, diff = three_level
    init, noise = _noise(6, 16, 8)
    kw = dict(init_noise=torch.from_numpy(init),
              step_noise=torch.from_numpy(noise))
    gold = diff.p_sample_loop((1, 16, D), **kw)
    got = ch.chain_p_sample_loop(diff.model, diff.schedule, (1, 16, D),
                                 weight_dtype=torch.bfloat16, **kw)
    want = _jax_chain(jax_diff, params, init, noise, weight_dtype=jnp.bfloat16)
    # tests/test_pallas_unet.py:59
    assert float((got - gold).abs().max()) < 0.15
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 0.15


def test_chain_conditioned_matches_jax(three_level):
    jax_diff, params, diff = three_level
    init, noise = _noise(6, 16, 9)
    obs = np.linspace(-0.5, 0.5, 6).astype(np.float32)
    cond = jax_cond(jnp.asarray(obs), 6, 16, D)
    cvals = np.array(cond.values).reshape(16, D)
    want = _jax_chain(jax_diff, params, init, noise, weight_dtype=jnp.float32,
                      cond=jnp.asarray(cvals))
    got = ch.chain_p_sample_loop(
        diff.model, diff.schedule, (1, 16, D), weight_dtype=torch.float32,
        init_noise=torch.from_numpy(init), step_noise=torch.from_numpy(noise),
        cond=torch.from_numpy(cvals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(got[0, 0].numpy(), cvals[0])
    # and it is the guided sampler's conditioning (tests/test_pallas_unet.py:91)
    ref = make_sampler(diff)(
        None, conditions_for_initial_obs(torch.from_numpy(obs), 6, 16, D),
        init_noise=torch.from_numpy(init), step_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


def test_chain_forwards_predict_epsilon_and_clip(three_level):
    jax_diff, params, diff = three_level
    init, noise = _noise(6, 16, 10)
    want = jax_p_sample_loop(
        jax_diff.apply, params, jax_diff.schedule, jax.random.PRNGKey(5),
        (1, 16, D), init_noise=jnp.asarray(init), step_noise=jnp.asarray(noise),
        clip_denoised=False, predict_epsilon=False)
    kw = dict(weight_dtype=torch.float32, init_noise=torch.from_numpy(init),
              step_noise=torch.from_numpy(noise))
    got = ch.chain_p_sample_loop(diff.model, diff.schedule, (1, 16, D),
                                 clip_denoised=False, predict_epsilon=False,
                                 **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    default = ch.chain_p_sample_loop(diff.model, diff.schedule, (1, 16, D), **kw)
    assert float((got - default).abs().max()) > 1e-3


def test_chain_truncation_draws_and_checks(three_level):
    _, _, diff = three_level
    out = ch.chain_p_sample_loop(diff.model, diff.schedule, (1, 16, D),
                                 sampling_timesteps=3,
                                 generator=torch.Generator().manual_seed(1),
                                 weight_dtype=torch.float32)
    assert out.shape == (1, 16, D) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="batch-1"):
        ch.chain_p_sample_loop(diff.model, diff.schedule, (2, 16, D))
    chain = ch.make_chain(diff.model, diff.schedule, 16)
    ts = default_timesteps(6)
    fw, me, sc = prepare_chain_operands(diff.model, diff.schedule, ts,
                                        torch.float32)
    x0, noise = torch.zeros(16, D), torch.zeros(6, 16, D)
    with pytest.raises(ValueError, match="shapes"):
        chain(fw, x0, me, noise[:5], sc)
    with pytest.raises(ValueError, match="shapes"):
        chain(fw, x0, me, noise, sc, torch.zeros(16, D))  # not condition_row0
    with pytest.raises(ValueError, match="CUDA"):
        chain.bind(fw, x0, me, noise, sc)


@pytest.mark.parametrize("mults,H", [((1, 2, 4), 16), ((1, 2), 8)])
@pytest.mark.parametrize("conditioned", [False, True])
@pytest.mark.parametrize("flags", [(True, True), (False, False)])
def test_chain_layer_program_equals_plain_chain(monkeypatch, mults, H,
                                                conditioned, flags):
    """The program the kernel walks (ops, operands, partial regions, splits,
    barriers), run by an interpreter of the op set, gives the plain chain."""
    torch.manual_seed(0)
    T = 5
    unet = TemporalUnet(D, dim=16, dim_mults=mults)
    diff = GaussianDiffusion(unet, H, 6, 2, n_timesteps=T).eval()
    fw, me, sc = prepare_chain_operands(unet, diff.schedule,
                                        default_timesteps(T), torch.float32)
    x0, noise = torch.randn(H, D), torch.randn(T, H, D)
    cond = torch.randn(H, D) if conditioned else None
    cfg = StepConfig(H, *flags)
    want = ch.chain_plain(unet, fw, x0, me, noise, sc, cond, cfg)

    built = {}
    finish = ch._ProgramBuilder.finish
    monkeypatch.setattr(ch._ProgramBuilder, "finish",
                        lambda self: built.update(ops=self.ops) or finish(self))
    grid = 132
    prog, n_pre, n_step, syncs, x, keep = ch._build_program(
        unet, fw, x0, me, noise, sc, cond, cfg, grid)
    ops = built["ops"]
    assert prog.numel() == len(ops) * ctypes.sizeof(ch.ChainOp) == \
        (n_pre + n_step) * 208
    assert bytes(prog.numpy().tobytes()) == b"".join(bytes(op) for op in ops)
    n_res = 2 * (2 * len(mults) - 1) + 2
    assert n_pre == 1 + n_res
    # every phase ends in a barrier, the last op of a step included, and no
    # conv leaves more items than one per block unless its tiles alone do
    assert ops[n_pre - 1].sync_after and ops[-1].sync_after
    assert ops[-1].kind == ch.STEP
    assert syncs == 1 + T * sum(op.sync_after for op in ops[n_pre:])
    # a conv's tile is the one its rows call for, its splits fill the grid
    # without passing what a consumer sums in one batch of loads, and no
    # reduce op stands between a conv and a GroupNorm or the DDPM step
    for op in ops:
        assert 0 <= op.rot < grid
        assert op.te_seg_stride == 0  # one time row per step: K3's one chain
        if op.kind == ch.CONV:
            M = op.rows_in // 2 if op.mode == DOWN else op.rows_in
            assert (op.bm, op.bn) == tile_shape(
                M, bool(op.w_bf16), op.cout, 2 if op.mode == UP else 1, grid)
            assert 1 <= op.splits <= ch.MAX_FAN_IN and op.partial
        if op.kind in (ch.GN, ch.STEP):
            assert 1 <= op.splits <= ch.MAX_FAN_IN
    # the down and up convs, which feed a conv, sum their own tiles; no other
    # conv of a step does, and every phase is a conv, a norm or the step
    own = [op for op in ops[n_pre:] if op.kind == ch.CONV and op.out]
    assert len(own) == 2 * (len(mults) - 1)
    assert all(op.mode in (DOWN, UP) and op.sync_after for op in own)
    assert all(op.out and op.counters for op in ops[1:n_pre])
    n_blocks, n_cut = 2 * (2 * len(mults) - 1) + 2, len(mults) - 1
    assert sum(op.sync_after for op in ops[n_pre:]) == \
        4 * n_blocks + 2 * n_cut + 2 + 2

    interpret(ops, n_pre, T, {w.data_ptr(): w for w in fw},
               walk_tiles=conditioned and flags[0])
    np.testing.assert_allclose(x.numpy(), want.numpy(), atol=1e-4)


def test_chain_op_struct_layout():
    """The struct the kernels read: 16 pointers then 20 ints, no padding;
    the last int is a GroupNorm's time-row stride per segment."""
    assert ctypes.sizeof(ch.ChainOp) == 16 * 8 + 20 * 4 == 208
    assert ch.ChainOp.xa.offset == 0 and ch.ChainOp.cond.offset == 14 * 8
    assert ch.ChainOp.counters.offset == 15 * 8
    assert ch.ChainOp.kind.offset == 128 and ch.ChainOp.groups.offset == 192
    assert ch.ChainOp.bm.offset == 196 and ch.ChainOp.bn.offset == 200
    assert ch.ChainOp.te_seg_stride.offset == 204
    assert ch._INTS[-1] == "te_seg_stride" and ch._PTRS[7] == "te"
    assert (ch.CONV, ch.GN, ch.STEP, ch.INIT) == (0, 1, 2, 3)
    assert ch.PROFILE_SLOTS.index("barrier") == 4


# ---------------------------------------------------------------------------
# probe_megakernel
# ---------------------------------------------------------------------------

def test_probe_megakernel_random_weights_on_cpu(capsys):
    out = probe_megakernel.main(
        ["--device", "cpu", "--dim", "16", "--dim-mults", "1", "2",
         "--horizon", "8", "--n-timesteps", "5", "--repeats", "1"])
    rungs = out["rungs"]
    assert list(rungs) == ["module", "hoisted", "hoisted_fused", "chain_bf16",
                           "chain_f32"]
    assert out["device"] == "cpu" and out["steps"] == 5
    assert all(r["finite"] and r["ms_per_chain"] > 0 for r in rungs.values())
    for name in ("hoisted", "hoisted_fused", "chain_f32"):
        assert rungs[name]["max_abs_diff"] <= 1e-4, name
    assert rungs["chain_bf16"]["max_abs_diff"] < 0.15
    import json

    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_ladder_entry_point_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where there is no card")
    assert probe_megakernel.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe_megakernel.main([])
