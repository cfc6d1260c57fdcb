"""K4, the fused residual block, as the layer program its kernel walks
(``ops/resblock.py`` ``block_program``, ``csrc/resblock.cu``), held on the
CPU where no kernel runs: the program for one block is run by the
interpreter of the op set (tests/torch_program.py), through the pointers the
ops hold, with every conv also rebuilt from the tiles and K splits its op
names, and compared with ``residual_block_plain`` and with the JAX
``residual_block_pallas`` (pallas_resblock.py:132) in interpret mode.

Tolerances: 1e-5 against the plain version (the same f32 products and
statistics, summed in another order); 1e-4 against the JAX kernel, the
tolerance of tests/test_pallas_resblock.py:43.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dadiff_tpu.ops.pallas_resblock import residual_block_pallas

from dadiff_tpu_torch.ops import chain as ch
from dadiff_tpu_torch.ops import cuda_lib
from dadiff_tpu_torch.ops import resblock as rb
from dadiff_tpu_torch.ops.conv_tiling import F32_TILE, SAME, rows_conv_tiled
from dadiff_tpu_torch.ops.planner import rows_conv_plain
from tests.torch_program import interpret

# the blocks here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

GRID = 132
# (Cin, Cout, 1x1 residual conv): the U-Net's first block (Cin = 8, K = 40:
# F32Tile's ragged path), a widening block, an identity residual
BLOCKS = {"first": (8, 32, True), "wide": (32, 64, True),
          "identity": (64, 64, False)}


def _inputs(cin, cout, with_res, B, H, k=5, seed=0):
    """Weights at the scale of a conv's own init, 1 / sqrt(fan-in), so that
    activations stay near 1 as in the U-Net."""
    rng = np.random.RandomState(seed)
    p = {"w1": rng.randn(k, cin, cout) / np.sqrt(k * cin),
         "b1": rng.randn(cout) * 0.1,
         "s1": 1 + 0.1 * rng.randn(cout), "g1": 0.1 * rng.randn(cout),
         "w2": rng.randn(k, cout, cout) / np.sqrt(k * cout),
         "b2": rng.randn(cout) * 0.1,
         "s2": 1 + 0.1 * rng.randn(cout), "g2": 0.1 * rng.randn(cout)}
    if with_res:
        p["wr"] = rng.randn(cin, cout) / np.sqrt(cin)
        p["br"] = rng.randn(cout) * 0.1
    p = {n: torch.from_numpy(v.astype(np.float32)) for n, v in p.items()}
    x = torch.from_numpy(rng.randn(B, H, cin).astype(np.float32))
    te = torch.from_numpy(rng.randn(B, cout).astype(np.float32))
    return x, te, p


def _weights(p):
    """The flattened (taps * cin, cout) weights the interpreter multiplies,
    by the address the ops hold."""
    k, cin, cout = p["w1"].shape
    ws = [p["w1"].reshape(k * cin, cout), p["w2"].reshape(k * cout, cout)]
    if "wr" in p:
        ws.append(p["wr"])
    return {w.data_ptr(): w for w in ws}


def _run_program(x, te, p, n_groups=8):
    """The block's program with x, te and out in place, interpreted."""
    B, H, cin = x.shape
    cout = p["w1"].shape[2]
    out = torch.full((B * H, cout), float("nan"))
    ops = rb.block_program(p, x.reshape(B * H, cin), te, out, B, H, n_groups,
                           GRID, x.device)
    interpret(list(ops), 0, 1, _weights(p), walk_tiles=True)
    return ops, out.reshape(B, H, cout)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H", [8, 16, 32])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_program_matches_plain_and_pallas(block, H, B):
    cin, cout, with_res = BLOCKS[block]
    x, te, p = _inputs(cin, cout, with_res, B, H, seed=H + B)
    ops, got = _run_program(x, te, p)

    # the program: conv1 [and the 1x1 conv, in one phase] | GN + te | conv2
    # | GN + residual, three barriers and none after the last op
    kinds = [op.kind for op in ops]
    assert kinds == ([ch.CONV, ch.CONV] if with_res else [ch.CONV]) + [
        ch.GN, ch.CONV, ch.GN]
    assert [op.sync_after for op in ops] == (
        [0, 1] if with_res else [1]) + [1, 1, 0]
    for op in ops:
        assert op.rows_in == B * H and op.seg_in == H and op.groups == 8
        assert 0 <= op.rot < GRID
        if op.kind == ch.CONV:
            # f32 weights on F32Tile, about one item per block, never more
            # splits than a GroupNorm sums in one batch of loads
            assert (op.bm, op.bn) == F32_TILE and op.w_bf16 == 0
            assert 1 <= op.splits <= ch.MAX_FAN_IN and op.partial
    gn1, gn2 = (op for op in ops if op.kind == ch.GN)
    # one time row per batch row
    assert gn1.te == te.data_ptr() and gn1.te_seg_stride == cout
    assert gn2.te is None and gn2.out and gn1.out == ops[-2].xa
    if with_res:
        assert gn2.res is None and gn2.res_partial == ops[1].partial
        assert ops[0].partial != ops[1].partial
    else:
        assert gn2.res == x.data_ptr() and not gn2.res_partial

    want = rb.residual_block_plain(x, te, p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    jax_out = residual_block_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(te.numpy()),
        {n: jnp.asarray(v.numpy()) for n, v in p.items()}, n_groups=8,
        interpret=True)
    # tests/test_pallas_resblock.py:43
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n_groups", [4, 16])
def test_block_program_other_group_counts(n_groups):
    """The GroupNorm items take any group count that divides Cout (the old
    cluster kernel's cap of 8 came from its cluster size)."""
    x, te, p = _inputs(32, 64, True, 2, 8, seed=7)
    ops, got = _run_program(x, te, p, n_groups)
    assert all(op.groups == n_groups for op in ops)
    np.testing.assert_allclose(
        got.numpy(), rb.residual_block_plain(x, te, p, n_groups).numpy(),
        rtol=1e-5, atol=1e-5)


def _pointers(op):
    return {f: getattr(op, f) for f in ch._PTRS}


@pytest.mark.parametrize("block", ["first", "identity"])
def test_template_patched_equals_fresh_build(block):
    """The cached template holds X, TE and OUT where x, te and out go;
    patched as resblock_run patches it, its bytes are a fresh build's with
    those pointers."""
    cin, cout, with_res = BLOCKS[block]
    B, H = 2, 16
    x, te, p = _inputs(cin, cout, with_res, B, H)
    out = torch.empty(B * H, cout)
    tmpl = rb.block_program(
        p, rb.Operand(rb.X, (B * H, cin)), rb.Operand(rb.TE, (B, cout)),
        rb.Operand(rb.OUT, (B * H, cout)), B, H, 8, GRID, "cpu")
    fresh = rb.block_program(p, x.reshape(B * H, cin), te, out, B, H, 8,
                             GRID, "cpu")
    assert ctypes.sizeof(tmpl) == len(tmpl) * 208 == (5 if with_res else 4) * 208
    # the placeholders stand exactly where the operands go, h is placed
    where = {(i, f): v for i, op in enumerate(tmpl)
             for f, v in _pointers(op).items()
             if v in (rb.X, rb.TE, rb.OUT, rb.HIDDEN)}
    n = len(tmpl)
    want = {(0, "xa"): rb.X, (n - 3, "te"): rb.TE, (n - 1, "out"): rb.OUT}
    if with_res:
        want[(1, "xa")] = rb.X
    else:
        want[(n - 1, "res")] = rb.X
    assert where == want
    patched = (ch.ChainOp * n).from_buffer_copy(tmpl)
    rb.patch(patched, {rb.X: x.data_ptr(), rb.TE: te.data_ptr(),
                       rb.OUT: out.data_ptr()})
    assert bytes(patched) == bytes(fresh)
    assert bytes(patched) != bytes(tmpl)


class _FakeLib:
    """Stands in for the built library where there is no card: resblock_run
    patches the template as csrc/resblock.cu does and interprets it."""

    def __init__(self, weights):
        self.weights, self.calls = weights, []

    def resblock_run(self, ops, n_ops, x, te, out, grid, prof, stream):
        prog = (ch.ChainOp * n_ops).from_buffer_copy(
            (ch.ChainOp * n_ops).from_address(ops))
        rb.patch(prog, {rb.X: x, rb.TE: te, rb.OUT: out})
        interpret(list(prog), 0, 1, self.weights)
        self.calls.append((ops, n_ops, grid, prof, stream))
        return 0


def test_launcher_runs_the_cached_template(monkeypatch):
    """The launcher's path on the CPU: the template cached per block's
    weights and (B, H), handed to the C entry with x, te and out, counted
    once per launch, gives the plain block."""
    monkeypatch.setattr(rb, "_templates", type(rb._templates)())
    monkeypatch.setattr(ch, "grid_size", lambda device, name: GRID)
    x, te, p = _inputs(32, 64, True, 2, 8, seed=5)
    fake = _FakeLib(_weights(p))
    monkeypatch.setattr(cuda_lib, "lib", lambda name: fake)
    before = rb.fused_residual_block.launches
    outs = []
    for x_ in (x, 2 * x):
        out = torch.empty(2, 8, 64)
        rb.launch_resblock(x_, te, p, out, 8, 1e-5, stream=0)
        outs.append(out)
        np.testing.assert_allclose(
            out.numpy(), rb.residual_block_plain(x_, te, p).numpy(),
            rtol=1e-5, atol=1e-5)
    assert rb.fused_residual_block.launches == before + 2
    # one template for both calls, passed by address, 5 ops, the grid
    assert len(rb._templates) == 1 and len({c[0] for c in fake.calls}) == 1
    assert fake.calls[0][1:] == (5, GRID, None, 0)
    # another (B, H) is another template; the cache keeps the newest
    rb.launch_resblock(x[:1], te[:1], p, torch.empty(1, 8, 64), 8, 1e-5,
                       stream=0)
    assert len(rb._templates) == 2
    monkeypatch.setattr(rb, "_MAX_TEMPLATES", 2)
    for H in (4, 2):
        rb.launch_resblock(x[:, :H].contiguous(), te, p,
                           torch.empty(2, H, 64), 8, 1e-5, stream=0)
    assert len(rb._templates) == 2
    assert [key[1][:2] for key in rb._templates] == [(2, 4), (2, 2)]


def test_scratch_grows_and_keeps_what_it_outgrew():
    s = rb._Scratch()
    a = s.at_least("cpu", 100)
    assert s.at_least("cpu", 50) == a
    b = s.at_least("cpu", 150)
    assert b != a and s.bufs[("cpu", 0)][-1].numel() == 200
    assert s.bufs[("cpu", 0)][0].data_ptr() == a  # still held
    # another stream has buffers of its own
    c = s.at_least("cpu", 100, stream=7)
    assert c not in (a, b) and s.at_least("cpu", 50, stream=7) == c
    assert s.at_least("cpu", 150) == b


def test_fused_residual_block_checks_what_the_kernel_needs():
    x, te, p = _inputs(8, 16, True, 1, 8)
    rb._check_cuda(x, te, p, 8)
    rb._check_cuda(x, te, p, 16)  # no cap on the group count
    with pytest.raises(ValueError, match="eps"):
        rb._check_cuda(x, te, p, 8, eps=1e-6)
    odd = torch.empty(x.numel() + 1)[1:].view_as(x)
    odd.copy_(x)
    assert odd.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        rb._check_cuda(odd, te, p, 8)
    x6, te6, p6 = _inputs(8, 6, True, 1, 8)
    with pytest.raises(ValueError, match="shapes"):
        rb._check_cuda(x6, te6, p6, 2)  # Cout 6: not whole 16-byte rows


def _inputs_older_scale(cin, cout, with_res, B, H, k=5, seed=0):
    """The weights of the older K4 tests, 0.2 * N(0, 1) whatever the fan-in,
    where activations reach ~12."""
    x, te, p = _inputs(cin, cout, with_res, B, H, k, seed)
    rng = np.random.RandomState(seed + 1000)
    for name in ("w1", "w2", "wr"):
        if name in p:
            p[name] = torch.from_numpy(
                (rng.randn(*p[name].shape) * 0.2).astype(np.float32))
    return x, te, p


@pytest.mark.parametrize("block", list(BLOCKS))
def test_tile_walk_at_the_older_weight_scale_is_within_f32_rounding(block):
    """At the older 0.2 weight scale the tile walk of a conv and the plain
    conv can differ by more than the 1e-5 of the checks above (1.1e-5 was
    seen on one element of 6,144). Both are held here against the same conv
    evaluated in float64: each stays within the worst-case rounding bound of
    an f32 sum of its K products, gamma_K * sum_k |x_k w_k| (gamma_K =
    K u / (1 - K u), u = 2^-24), so the two differ by the order of their
    sums and not by a fault. The plain block in f32 holds against float64 to
    1e-5 as well."""
    cin, cout, with_res = BLOCKS[block]
    B, H = 3, 32
    x, te, p = _inputs_older_scale(cin, cout, with_res, B, H, seed=H + B)
    ops = rb.block_program(p, x.reshape(B * H, cin), te,
                           torch.empty(B * H, cout), B, H, 8, GRID, "cpu")
    convs = [op for op in ops if op.kind == ch.CONV]
    # each conv's input: x for conv1 and the 1x1 conv, h (computed in
    # float64, rounded to f32) for conv2
    p64 = {n: v.double() for n, v in p.items()}
    h = rb.gn_mish_plain(rb._conv_same(x.double(), p64["w1"], p64["b1"]),
                         p64["s1"], p64["g1"], 8, 1e-5, te=te.double()).float()
    k = p["w1"].shape[0]
    inputs = [(x, p["w1"].reshape(k * cin, cout), k),
              (h, p["w2"].reshape(k * cout, cout), k)]
    if with_res:
        inputs.insert(1, (x, p["wr"], 1))
    assert len(inputs) == len(convs)
    u = 2.0 ** -24
    gap = 0.0
    for op, (inp, w, taps) in zip(convs, inputs):
        xa = inp.reshape(B * H, -1)
        zero = torch.zeros(1, cout)
        walk, _ = rows_conv_tiled(xa, None, w, zero, SAME, taps, H, op.bm,
                                  op.bn, op.splits)
        plain = rows_conv_plain(xa, None, w, zero, SAME, taps, H)
        K = w.shape[0]
        w3 = w.double().reshape(taps, K // taps, cout)
        x3 = inp.double().reshape(B, H, -1)
        ref = rb._conv_same(x3, w3, 0.0).reshape(B * H, cout)
        terms = rb._conv_same(x3.abs(), w3.abs(), 0.0).reshape(B * H, cout)
        bound = K * u / (1 - K * u) * terms
        assert bool(((walk.double() - ref).abs() <= bound).all())
        assert bool(((plain.double() - ref).abs() <= bound).all())
        gap = max(gap, float((walk - plain).abs().max()))
    assert gap < 1e-4
    want = rb.residual_block_plain(x.double(), te.double(), p64)
    got = rb.residual_block_plain(x, te, p)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
