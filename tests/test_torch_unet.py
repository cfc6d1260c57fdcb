"""The port's schedules, TemporalUnet, K1 (GroupNorm+Mish) and the chain's
conv operand layout, held against the JAX package on the CPU.

Inputs come from numpy with fixed seeds; weights come from JAX
``init_params`` through ``params_from_jax``. Pallas kernels run as the JAX
package's own tests run them: ``interpret=True`` with float32 weights.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.ops import schedules as jax_schedules
from dadiff_tpu.ops.pallas_kernels import group_norm_mish_pallas
from dadiff_tpu.ops.pallas_unet import _layer_plan as jax_layer_plan
from dadiff_tpu.ops.pallas_unet import flatten_unet_params as jax_flatten
from dadiff_tpu.ops.pallas_unet import prepare_chain_operands as jax_prepare

from dadiff_tpu_torch.io.torch_compat import params_from_jax
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops import schedules
from dadiff_tpu_torch.ops.chain_operands import (
    _layer_plan,
    flatten_unet_params,
    prepare_chain_operands,
)
from dadiff_tpu_torch.ops.gn_mish import gn_mish, gn_mish_plain
from dadiff_tpu_torch.ops.planner import DOWN, SAME, UP, rows_conv

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

D = 8


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _init(jax_unet, seed, H):
    # jitted: eager Flax init dispatches op by op and takes ~10 s on the CPU
    return jax.jit(lambda k: jax_unet.init_params(k, H))(jax.random.PRNGKey(seed))


def _port_unet(jax_unet, params, **kw):
    unet = TemporalUnet(transition_dim=jax_unet.transition_dim, dim=jax_unet.dim,
                        dim_mults=jax_unet.dim_mults, **kw)
    unet.load_state_dict(params_from_jax(_np_tree(params)), strict=True)
    return unet.eval()


@pytest.mark.parametrize("name", ["cosine", "linear"])
@pytest.mark.parametrize("T", [6, 100])
def test_schedule_buffers_match(name, T):
    want = jax_schedules.make_schedule(T, name)
    got = schedules.make_schedule(T, name)
    for buf in schedules.BUFFER_NAMES:
        np.testing.assert_allclose(getattr(got, buf).numpy(),
                                   np.asarray(getattr(want, buf)), atol=1e-6,
                                   rtol=0, err_msg=buf)
        assert getattr(got, buf).dtype == torch.float32


@pytest.fixture(scope="module", params=[((1, 2), 8), ((1, 2, 4), 16)],
                ids=["mults12", "mults124"])
def unet_ref(request):
    """A JAX TemporalUnet, its params and its forward on fixed inputs."""
    mults, H = request.param
    jax_unet = JaxUnet(transition_dim=D, dim=32, dim_mults=mults)
    params = _init(jax_unet, 1, H)
    rng = np.random.RandomState(2)
    x = rng.randn(3, H, D).astype(np.float32)
    t = np.array([0, 3, 5], np.int32)
    want = jax.jit(jax_unet.apply)({"params": params}, jnp.asarray(x),
                                   jnp.asarray(t))
    return jax_unet, params, x, t, np.asarray(want)


@pytest.mark.parametrize("use_pallas_norm", [False, True])
def test_temporal_unet_forward_matches_jax(unet_ref, use_pallas_norm):
    jax_unet, params, x, t, want = unet_ref
    H = x.shape[1]
    unet = _port_unet(jax_unet, params, use_pallas_norm=use_pallas_norm)
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t).long())
    assert got.shape == (3, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_flagship_parameter_count():
    """15.86 M parameters, counted from the layer plan's weight entries."""
    unet = TemporalUnet(transition_dim=D, dim=128, dim_mults=(1, 2, 4))
    _, entries = _layer_plan(unet)
    flat_count = sum(w.numel() for w in flatten_unet_params(unet, torch.float32))
    module_count = sum(p.numel() for p in unet.parameters())
    time_mlp = sum(p.numel() for p in unet.time_mlp.parameters())
    assert flat_count + time_mlp == module_count
    assert round(module_count / 1e6, 2) == 15.86
    assert entries == jax_layer_plan(JaxUnet(transition_dim=D, dim=128,
                                             dim_mults=(1, 2, 4)))[1]


@pytest.mark.parametrize("shape", [(2, 8, 32), (3, 4, 64), (1, 16, 128)])
def test_gn_mish_plain_matches_pallas(shape):
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale = rng.randn(shape[2]).astype(np.float32)
    bias = rng.randn(shape[2]).astype(np.float32)
    want = group_norm_mish_pallas(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), interpret=True)
    got = gn_mish(torch.from_numpy(x), torch.from_numpy(scale),
                  torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_gn_mish_epilogue_adds_and_gradient():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 8, 32).astype(np.float32))
    s = torch.from_numpy(rng.randn(32).astype(np.float32))
    b = torch.from_numpy(rng.randn(32).astype(np.float32))
    te = torch.from_numpy(rng.randn(2, 32).astype(np.float32))
    res = torch.from_numpy(rng.randn(2, 8, 32).astype(np.float32))
    base = gn_mish_plain(x, s, b)
    got = gn_mish(x, s, b, te=te, res=res)
    torch.testing.assert_close(got, base + te[:, None, :] + res)
    xg = x.clone().requires_grad_(True)
    gn_mish(xg, s, b).sum().backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().sum() > 0


def _jax_conv(x, w, k, seg, mode):
    """The TPU kernel's conv arithmetic (pallas_unet.py:275-318)."""
    from dadiff_tpu.ops.pallas_unet import _even_rows, _interleave_rows

    x = jnp.asarray(x)
    w = jnp.asarray(w)
    if mode == UP:
        C = x.shape[1]
        R = [w[t * C:(t + 1) * C] for t in range(4)]
        even = x @ R[1] + _shift_rows_np(x, 1, seg) @ R[3]
        odd = _shift_rows_np(x, -1, seg) @ R[0] + x @ R[2]
        return np.asarray(_interleave_rows(even, odd))
    stack = jnp.concatenate([_shift_rows_np(x, k // 2 - t, seg)
                             for t in range(k)], axis=1)
    y = stack @ w
    return np.asarray(_even_rows(y) if mode == DOWN else y)


def _shift_rows_np(x, s, seg):
    """pallas_unet._shift_rows semantics outside a kernel (it uses
    pltpu.roll, which needs a kernel context)."""
    x = np.asarray(x)
    R, C = x.shape
    y = np.roll(x, s, axis=0)
    pos = np.arange(R)[:, None] % seg
    mask = pos >= s if s > 0 else pos < seg + s
    return jnp.asarray(np.where(mask, y, 0.0))


@pytest.mark.parametrize("mode,k,seg,cin,cout", [
    (SAME, 5, 8, 16, 24), (SAME, 1, 8, 16, 8), (DOWN, 3, 8, 16, 16),
    (UP, 4, 4, 16, 16), (SAME, 5, 2, 8, 16),
])
def test_rows_conv_plain_matches_tpu_layout(mode, k, seg, cin, cout):
    rng = np.random.RandomState(k * 7 + mode)
    x = rng.randn(3 * seg, cin).astype(np.float32)
    w = rng.randn(k * cin, cout).astype(np.float32)
    want = _jax_conv(x, w, k, seg, mode)
    got = rows_conv(torch.from_numpy(x), None, torch.from_numpy(w),
                    torch.zeros(1, cout), mode, k, seg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    # the concat input [xa | xb] equals the conv of the concatenation
    got2 = rows_conv(torch.from_numpy(x[:, :cin // 2]),
                     torch.from_numpy(x[:, cin // 2:]), torch.from_numpy(w),
                     torch.zeros(1, cout), mode, k, seg)
    torch.testing.assert_close(got2, got)


def test_chain_operands_match_jax(unet_ref):
    jax_unet, params, _, _, _ = unet_ref
    unet = _port_unet(jax_unet, params)
    jsched = jax_schedules.make_schedule(6)
    ts = np.arange(5, -1, -1)
    want_w, want_m, want_s = jax_prepare(jax_unet, jsched, params,
                                         jnp.asarray(ts, jnp.int32),
                                         weight_dtype=jnp.float32)
    got_w, got_m, got_s = prepare_chain_operands(
        unet, schedules.make_schedule(6), torch.from_numpy(ts),
        weight_dtype=torch.float32)
    assert len(got_w) == len(want_w) == len(jax_flatten(jax_unet, params))
    for g, w in zip(got_w, want_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6)
    bf = flatten_unet_params(unet, torch.bfloat16)
    assert bf[0].dtype == torch.bfloat16 and bf[1].dtype == torch.float32
