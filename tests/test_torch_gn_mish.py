"""K1 (GroupNorm(8) + Mish) held against the JAX package on the CPU: the
plain forward in both layouts against ``group_norm_mish_pallas`` in interpret
mode, the closed-form backward (``gn_mish_backward_plain``, which the
backward kernel's arithmetic mirrors) against ``jax.vjp`` of
``group_norm_mish_reference`` (the JAX custom_vjp's ``_gn_bwd``), the epilogue
adds' gradients, the ``autograd.Function`` that routes them, the wrapper's
refusals, the launch plan, and a tiny ``use_pallas_norm`` U-Net's
diffusion-loss gradient against JAX's.

Inputs come from numpy with fixed seeds. Tolerances: the forward 1e-5 (as
tests/test_torch_unet.py holds it), the backward atol 1e-5 / rtol 1e-4 (the
JAX package's own, tests/test_pallas.py:52), the U-Net's gradient 1e-4
(f32 sums over the whole network taken in another order).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dadiff_tpu.models import diffusion as jd
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.ops.pallas_kernels import (
    group_norm_mish_pallas,
    group_norm_mish_reference,
)

from dadiff_tpu_torch.io.torch_compat import params_from_jax
from dadiff_tpu_torch.models import diffusion as td
from dadiff_tpu_torch.models.temporal_unet import Conv1dBlock, TemporalUnet
from dadiff_tpu_torch.ops.gn_mish import (
    LaunchPlan,
    gn_mish,
    gn_mish_backward,
    gn_mish_backward_plain,
    gn_mish_plain,
    launch_plan,
)

torch.set_num_threads(1)

# the flagship's five (L, C) ratios (32, 128), (16, 256), (8, 512),
# (8, 256), (16, 128), channels narrowed 4x
SHAPES = [(32, 32), (16, 64), (8, 128), (8, 64), (16, 32)]
LAYOUTS = ["feature_last", "channels_first"]
TOL_BWD = dict(atol=1e-5, rtol=1e-4)


def _inputs(S, L, C, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(S, L, C) * 2 + 0.3).astype(np.float32)
    scale = rng.randn(C).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    g = rng.randn(S, L, C).astype(np.float32)
    return x, scale, bias, g


def _port(a: np.ndarray, layout: str) -> torch.Tensor:
    """A feature-last (S, L, C) array in the port's layout."""
    t = torch.from_numpy(a)
    return t.transpose(1, 2).contiguous() if layout == "channels_first" else t


def _back(t: torch.Tensor, layout: str) -> np.ndarray:
    return (t.transpose(1, 2) if layout == "channels_first" else t).numpy()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("L,C", SHAPES + [(32, 128)])
def test_forward_matches_pallas(L, C, layout):
    S = 1 if C == 128 and L == 32 else 2   # the last: the ladder's (1, 32, 128)
    x, scale, bias, _ = _inputs(S, L, C, L + C)
    want = group_norm_mish_pallas(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), interpret=True)
    got = gn_mish(_port(x, layout), torch.from_numpy(scale),
                  torch.from_numpy(bias),
                  channels_first=layout == "channels_first")
    np.testing.assert_allclose(_back(got, layout), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_vjp(S, L, C, seed):
    x, scale, bias, g = _inputs(S, L, C, seed)
    _, vjp = jax.vjp(lambda a, b, c: group_norm_mish_reference(a, b, c),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    return tuple(np.asarray(d) for d in vjp(jnp.asarray(g)))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("L,C", SHAPES)
def test_backward_plain_matches_jax_vjp(L, C, layout):
    """The closed form against JAX's _gn_bwd (jax.vjp of the reference) and
    against torch autograd of the plain forward, for x, scale and bias."""
    cf = layout == "channels_first"
    x, scale, bias, g = _inputs(2, L, C, 7 * L + C)
    want = _jax_vjp(2, L, C, 7 * L + C)
    tx, ts, tb = _port(x, layout), torch.from_numpy(scale), torch.from_numpy(bias)
    _, stats = gn_mish_plain(tx, ts, tb, channels_first=cf, return_stats=True)
    assert stats.shape == (2, 8, 2)
    dx, dscale, dbias, dte = gn_mish_backward_plain(
        tx, ts, tb, _port(g, layout), stats, channels_first=cf)
    assert dte is None
    for got, w in zip((_back(dx, layout), dscale.numpy(), dbias.numpy()), want):
        np.testing.assert_allclose(got, w, **TOL_BWD)
    leaves = [t.clone().requires_grad_(True) for t in (tx, ts, tb)]
    gn_mish_plain(*leaves, channels_first=cf).backward(_port(g, layout))
    for got, leaf in zip((dx, dscale, dbias), leaves):
        torch.testing.assert_close(got, leaf.grad, **TOL_BWD)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("te_kind", ["per_segment", "shared", "none"])
@pytest.mark.parametrize("with_res", [False, True])
def test_epilogue_adds_and_their_gradients(layout, te_kind, with_res):
    """te (one row per segment, or one shared row) and res: the output is
    the plain norm plus them, d te is the sum of g over positions (and
    segments, for a shared row), d res is g itself."""
    cf = layout == "channels_first"
    S, L, C = 3, 8, 32
    x, scale, bias, g = _inputs(S, L, C, 11)
    rng = np.random.RandomState(12)
    te = {"per_segment": rng.randn(S, C), "shared": rng.randn(C),
          "none": None}[te_kind]
    te = None if te is None else torch.from_numpy(te.astype(np.float32))
    res = (_port(rng.randn(S, L, C).astype(np.float32), layout)
           if with_res else None)
    args = [_port(x, layout), torch.from_numpy(scale), torch.from_numpy(bias),
            te, res]
    grads = []
    for fn in (gn_mish, gn_mish_plain):
        leaves = [None if a is None else a.clone().requires_grad_(True)
                  for a in args]
        y = fn(*leaves[:3], te=leaves[3], res=leaves[4], channels_first=cf)
        y.backward(_port(g, layout))
        grads.append([None if a is None else a.grad for a in leaves])
        if fn is gn_mish:
            base = gn_mish_plain(*args[:3], channels_first=cf)
            row = (-1, C, 1) if cf else (-1, 1, C)
            want = base + (0 if te is None else te.reshape(row)) \
                + (0 if res is None else res)
            torch.testing.assert_close(y.detach(), want)
    for got, want in zip(*grads):
        assert (got is None) == (want is None)
        if got is not None:
            torch.testing.assert_close(got, want, **TOL_BWD)
    if with_res:
        assert torch.equal(grads[0][4], _port(g, layout))
    if te is not None:
        pos = 2 if cf else 1
        gs = _port(g, layout).sum(dim=pos)
        want_te = gs if te_kind == "per_segment" else gs.sum(dim=0)
        torch.testing.assert_close(grads[0][3], want_te, **TOL_BWD)


def test_autograd_function_on_the_cpu():
    """With a gradient wanted, gn_mish runs its autograd.Function on the
    CPU: the plain forward saves x and the statistics, the backward is
    gn_mish_backward_plain exactly; without one, no graph is kept."""
    x, scale, bias, g = _inputs(2, 16, 64, 3)
    tx, ts, tb = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, scale, bias))
    y = gn_mish(tx, ts, tb)
    assert type(y.grad_fn).__name__ == "_GnMishBackward"
    saved = y.grad_fn.saved_tensors
    assert saved[0] is tx and saved[3].shape == (2, 8, 2)
    y.backward(torch.from_numpy(g))
    _, stats = gn_mish_plain(tx.detach(), ts.detach(), tb.detach(),
                             return_stats=True)
    want = gn_mish_backward_plain(tx.detach(), ts.detach(), tb.detach(),
                                  torch.from_numpy(g), stats)
    for got, w in zip((tx.grad, ts.grad, tb.grad), want):
        assert torch.equal(got, w)
    with torch.no_grad():
        assert gn_mish(tx, ts, tb).grad_fn is None
    # only the leaves that want it get a gradient
    ts2 = torch.from_numpy(scale).requires_grad_(True)
    gn_mish(torch.from_numpy(x), ts2, torch.from_numpy(bias)).sum().backward()
    assert ts2.grad is not None and ts2.grad.shape == (64,)


def test_conv_block_hands_the_conv_output_over_without_a_copy():
    """Conv1dBlock under use_pallas_norm: K1 reads the conv's (B, C, H)
    output channels-first and the block returns a transposed view of K1's
    output (no .contiguous()); the next conv's transpose is contiguous
    again. Equal to the library GroupNorm + Mish path."""
    rng = np.random.RandomState(5)
    block = Conv1dBlock(16, 32, 5, use_pallas_norm=True)
    with torch.no_grad():
        block.block[1].weight.copy_(torch.from_numpy(rng.randn(32).astype(np.float32)))
        block.block[1].bias.copy_(torch.from_numpy(rng.randn(32).astype(np.float32)))
    x = torch.from_numpy(rng.randn(3, 8, 16).astype(np.float32))
    x.requires_grad_(True)
    out = block(x)
    assert out.shape == (3, 8, 32) and not out.is_contiguous()
    assert out.transpose(1, 2).is_contiguous()
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "_GnMishBackward"
    block.use_pallas_norm = False
    want = block(x)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    g = torch.from_numpy(rng.randn(3, 8, 32).astype(np.float32))
    got_grads = torch.autograd.grad(out, [x, *block.parameters()], g)
    want_grads = torch.autograd.grad(want, [x, *block.parameters()], g)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _refusal_case(case):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 8, 32).astype(np.float32))
    s, b = torch.ones(32), torch.zeros(32)
    kw = {}
    if case == "dtype":
        x = x.double()
    elif case == "non_contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "groups":
        x, s, b = x[..., :12].contiguous(), s[:12], b[:12]
    elif case == "layout":
        kw["channels_first"] = True     # (2, 8, 32) read as C = 8
    elif case == "te":
        kw["te"] = torch.zeros(3, 32)
    elif case == "res":
        kw["res"] = torch.zeros(2, 8, 16)
    elif case == "rank":
        x = x.reshape(16, 32)
    return x, s, b, kw


@pytest.mark.parametrize("case", ["dtype", "non_contiguous", "groups",
                                  "layout", "te", "res", "rank"])
def test_wrapper_refuses(case):
    x, s, b, kw = _refusal_case(case)
    with pytest.raises(ValueError, match="gn_mish"):
        gn_mish(x, s, b, **kw)


def test_backward_wrapper_refuses_foreign_stats():
    x, scale, bias, g = (torch.from_numpy(a) for a in _inputs(2, 8, 32, 1))
    _, stats = gn_mish_plain(x, scale, bias, return_stats=True)
    with pytest.raises(ValueError, match="stats"):
        gn_mish_backward(x, scale, bias, g, stats[:1])
    with pytest.raises(ValueError, match="gn_mish_backward"):
        gn_mish_backward(x, scale, bias, g.transpose(1, 2), stats)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_launch_plan_routes(layout):
    """Every training shape of the flagship (and the ladder's) takes the
    register route with 128-bit loads, one vector a thread; a group past
    REG_MAX floats loops; a ragged or misaligned run loads scalars."""
    cf = layout == "channels_first"
    for L, C in [(32, 128), (16, 256), (8, 512), (8, 256), (16, 128)]:
        n = L * C // 8
        assert launch_plan(L, C, 8, cf) == LaunchPlan(4, 1, n // 4)
    assert launch_plan(64, 256, 8, cf) == LaunchPlan(4, 2, 256)
    assert launch_plan(64, 512, 8, cf) == LaunchPlan(4, 0, 256)
    assert launch_plan(8, 128, 8, cf, aligned=False).vec == 1
    ragged = (6, 64) if cf else (8, 48)    # a run of 6 floats either way
    assert launch_plan(*ragged, 8, cf) == LaunchPlan(1, 1, 64)
    # every plan is one the C launcher takes (csrc/gn_mish.cu)
    takes = {4: (0, 1, 2), 1: (0, 1, 2, 4, 8)}
    for seg in range(1, 70):
        for C in range(8, 1032, 8):
            p = launch_plan(seg, C, 8, cf)
            assert p.nv in takes[p.vec] and p.threads % 32 == 0 \
                and 32 <= p.threads <= 256, (seg, C, p)
            if p.nv:
                assert p.nv * p.threads * p.vec >= seg * C // 8


H, OBS, ACT, T_STEPS = 8, 6, 2, 10
D = OBS + ACT


@pytest.mark.parametrize("seed", [0, 1])
def test_unet_loss_gradient_matches_jax(seed):
    """A tiny use_pallas_norm U-Net's diffusion-loss gradient (every K1 on
    the channels-first route, its backward the closed form) against JAX's
    (PallasGroupNormMish, differentiated through the reference), leaf by
    leaf, within 1e-4 of the gradient's largest entry."""
    jax_unet = JaxUnet(transition_dim=D, dim=16, dim_mults=(1, 2),
                       use_pallas_norm=True)
    jax_diff = jd.GaussianDiffusion(model=jax_unet, horizon=H,
                                    observation_dim=OBS, action_dim=ACT,
                                    n_timesteps=T_STEPS)
    params = jax.jit(lambda k: jax_unet.init_params(k, H))(
        jax.random.PRNGKey(seed))
    unet = TemporalUnet(transition_dim=D, dim=16, dim_mults=(1, 2),
                        use_pallas_norm=True)
    unet.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    diff = td.GaussianDiffusion(unet, H, OBS, ACT, n_timesteps=T_STEPS)
    rng = np.random.RandomState(20 + seed)
    x = rng.randn(4, H, D).astype(np.float32)
    t = rng.randint(0, T_STEPS, 4)
    noise = rng.randn(4, H, D).astype(np.float32)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jax_diff.loss(
        p, jax.random.PRNGKey(0), jnp.asarray(x), t=jnp.asarray(t),
        noise=jnp.asarray(noise))))(params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    loss = diff.loss(torch.from_numpy(x), t=torch.from_numpy(t),
                     noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    scale = max(float(v.abs().max()) for v in want.values())
    for name, p in unet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


def test_bench_refuses_without_a_card():
    """``bench_gn_mish`` times the card only: without one it exits, naming
    why, before it builds anything."""
    from dadiff_tpu_torch import bench_gn_mish

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(SystemExit, match="none is visible"):
        bench_gn_mish.main(["--batches", "2"])
