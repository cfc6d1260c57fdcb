"""The fused conv + GroupNorm + Mish of the planner chain (``rows_conv_gn`` of
csrc/planner.cu) and the row-parallel ``ddpm_project_step``, held on the CPU
where no kernel runs: their partitions are walked in Python
(``conv_tiling.group_plan`` / ``rows_conv_gn_tiled``,
``planner.ddpm_project_step_blocks``) and compared with the plain versions
and with the JAX package's ``_conv_stack`` + ``_group_norm_mish``
(pallas_unet.py:184, :198, in a Pallas kernel in interpret mode) and
``_project`` / ``_apply_cond`` (pallas_planner.py:156, :152).

Tolerances: 1e-5 for f32 sums in another order (conv K <= 640, norm
statistics over <= 1024 values); the JAX comparison 2e-5, the same sums
taken once more by XLA.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as jpl

from dadiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from dadiff_tpu.models.temporal_unet import TemporalUnet as JaxUnet
from dadiff_tpu.ops import pallas_planner as jpp
from dadiff_tpu.ops.pallas_unet import _conv_stack, _dot, _group_norm_mish

from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops import conv_tiling as ct
from dadiff_tpu_torch.ops import planner as pl
from dadiff_tpu_torch.sweep_kernels import step_launches

# the models here are tiny: one thread per test process, so that several
# processes side by side do not oversubscribe the cores
torch.set_num_threads(1)

GRID = ((1, 1, 1, 1, 1), (1, 0, 0, 0, 1), (1, 0, 1, 0, 1), (1, 0, 0, 0, 1),
        (1, 1, 1, 1, 1))
POS = ((0.1, -0.2), (1.6, 1.6))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# rows_conv_gn: the group blocks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship_pairs():
    """The 25 (conv, GroupNorm) pairs of one denoise step at the flagship:
    8 chains x 32 rows, dim 128, mults 1 2 4."""
    unet = TemporalUnet(transition_dim=8, dim=128, dim_mults=(1, 2, 4))
    calls, _, _ = step_launches(unet, 8 * 32, 8, 32)
    pairs = [c for c in calls if c[0] == "conv_gn"]
    assert len(pairs) == 25
    return pairs


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_group_plan_covers_every_pair_once(flagship_pairs, bf16):
    """At every flagship pair, with the tile the launcher takes: the group
    blocks partition the tiles, each holds whole (segment, group) pairs,
    every pair lies in exactly one, and at most 2 x 2 tiles meet in one."""
    for _, R, ca, cb, cout, mode, k, seg, _, _ in flagship_pairs:
        t, g = pl._split_k_gn(R, ca + cb, cout, k, seg, bf16)
        # the launcher's own tile: every group block fits shared memory
        assert (t.bm, t.bn) == pl._split_k(R, ca + cb, cout, mode, k, bf16,
                                           seg=seg, cin_b=cb)[:2]
        assert g == ct.group_plan(t.M, cout, seg, t.bm, t.bn) and g.fits
        assert g.tiles_m * g.tiles_n <= 4
        tiles = torch.zeros(-(-R // t.bm), -(-cout // t.bn), dtype=torch.int64)
        pairs = torch.zeros(R // seg, ct.N_GROUPS, dtype=torch.int64)
        blocks = list(ct.group_blocks(R, cout, seg, t.bm, t.bn))
        assert sorted(b.index for b in blocks) == list(range(g.blocks))
        cg = cout // ct.N_GROUPS
        for b in blocks:
            for tm, tn in b.tiles:
                tiles[tm, tn] += 1
            for p, s, grp in b.pairs:
                assert p < g.pairs
                pairs[s, grp] += 1
                assert b.rows[0] <= s * seg and (s + 1) * seg <= b.rows[1]
                assert b.cols[0] <= grp * cg and (grp + 1) * cg <= b.cols[1]
        assert bool((tiles == 1).all()) and bool((pairs == 1).all())


def test_fused_tile_falls_back_where_the_group_block_is_too_large():
    """64 chains of 128 rows at 256 channels on the mma.sync tiles: the
    conv's own 64 x 128 tile would give a 128 x 128 group block (64 KB), so
    the fused conv takes the largest smaller tile whose group block fits;
    the flagship never does. At these rows the launcher itself takes the
    128-row wgmma tile, which holds a 128-row segment in one tile; with
    24-row segments it cannot, and the fused conv falls back to the same
    mma.sync rule."""
    rows, cin, cout, seg = 64 * 128, 256, 256, 128
    t = pl._split_k_mma(rows, cin, cout, ct.SAME, 5, True)
    assert (t.bm, t.bn) == (64, 128)
    assert not ct.group_plan(rows, cout, seg, t.bm, t.bn).fits
    tg, g = pl._split_k_gn_mma(rows, cin, cout, 5, seg, True)
    assert (tg.bm, tg.bn) == (64, 64) and g.fits
    assert g == ct.group_plan(rows, cout, seg, 64, 64)
    assert tg.splits == ct.even_splits(-(-tg.K // ct.BK), pl._want_splits(
        tg.tiles, -(-tg.K // ct.BK))) and tg.tiles == 128 * 4
    assert pl._split_k_gn(rows, cin, cout, 5, seg, True)[0].bm == ct.WG_BM
    rows2, seg2 = 24 * 2048, 24
    assert pl._split_k(rows2, cin, cout, ct.SAME, 5, True).bm == ct.WG_BM
    tw, gw = pl._split_k_gn(rows2, cin, cout, 5, seg2, True)
    assert (tw, gw) == pl._split_k_gn_mma(rows2, cin, cout, 5, seg2, True)
    assert tw.bm != ct.WG_BM and gw.fits
    with pytest.raises(ValueError, match="no tile holds"):
        pl._split_k_gn(64 * 1024, 32, 64, 5, 1024, False)


CONV_GN_INPUTS = {
    # name: (cin_a, cin_b, cout, segments, rows per segment)
    "ragged_cin8": (8, 0, 32, 2, 8),       # the first conv: K = 40
    "concat": (32, 32, 64, 2, 8),          # decoder skip concat
    "tall": (32, 0, 64, 9, 8),             # 72 rows: a ragged last tile
    "deep": (32, 0, 256, 2, 4),            # groups of 32 channels, 4-row segs
    "odd_widths": (32, 0, 96, 3, 12),      # lcm group blocks: 12-row segs,
}                                          # 12-channel groups


ADDS = ["none", "te", "te_per_segment", "res", "te_res"]


def _conv_gn_case(inputs, bf16, adds, seed):
    ca, cb, cout, n_seg, seg = CONV_GN_INPUTS[inputs]
    rng = np.random.RandomState(seed)
    R, cin = n_seg * seg, ca + cb
    xa = _t(rng.randn(R, ca))
    xb = _t(rng.randn(R, cb)) if cb else None
    w = _t(rng.randn(5 * cin, cout) / cin ** 0.5)
    w = w.to(torch.bfloat16) if bf16 else w
    bias = _t(rng.randn(1, cout))
    scale, gbias = _t(1 + 0.5 * rng.randn(cout)), _t(rng.randn(cout))
    te = res = None
    if adds.startswith("te"):
        te = _t(rng.randn(n_seg if adds == "te_per_segment" else 1, cout))
    if adds.endswith("res"):
        res = _t(rng.randn(R, cout))
    return (xa, xb, w, bias, 5, seg, scale, gbias, te, res)


@pytest.mark.parametrize("adds", ADDS)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("inputs", list(CONV_GN_INPUTS))
def test_rows_conv_gn_tiled_matches_plain(inputs, bf16, adds):
    """The kernel's walk (a group block's tiles, each its K splits added in
    split order, then each pair's statistics) gives rows_conv_plain ->
    gn_mish_plain and normalises every (segment, group) once, for every
    tile of the weight type and several K splits."""
    args = _conv_gn_case(inputs, bf16, adds, len(inputs) + 7 * len(adds) + bf16)
    want = pl.rows_conv_gn_plain(*args)
    xa, xb, w, _, k, seg = args[:6]
    R, cin, cout = xa.shape[0], xa.shape[1] + (0 if xb is None else
                                               xb.shape[1]), w.shape[1]
    ref = pl.rows_conv_plain(xa, xb, w, args[3], ct.SAME, k, seg)
    assert torch.equal(want, pl.rows_conv_gn(*args))  # the CPU wrapper
    t = pl._split_k(R, cin, cout, ct.SAME, k, bf16)
    shapes = [(t.bm, t.bn)] + [s for s in (ct.MMA_TILES if bf16 else ())
                               if s != (t.bm, t.bn)]
    k_tiles = -(-5 * cin // ct.BK)
    for bm, bn in shapes:
        for splits in sorted({1, t.splits, ct.even_splits(k_tiles, 3)}):
            got, cover = ct.rows_conv_gn_tiled(*args, bm=bm, bn=bn,
                                               splits=splits)
            assert bool((cover == 1).all())
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                       err_msg=f"{bm}x{bn} splits={splits}")
    # the norm changed the conv's output: the epilogue ran
    assert not torch.allclose(want, ref, atol=1e-2)


def _jax_conv_gn(x, w, b, scale, gbias, te, res, k, n_chains):
    """The JAX package's conv stack and _group_norm_mish inside one Pallas
    kernel, in interpret mode, with the adds res_block fuses around it."""
    R, cout = x.shape[0], w.shape[1]

    def kernel(x_ref, w_ref, b_ref, s_ref, g_ref, te_ref, res_ref, o_ref):
        h = x_ref[:]
        seg = R // n_chains if n_chains > 1 else None
        y = _dot(_conv_stack(h, k, seg), w_ref[:]) + b_ref[:]
        o_ref[:] = (_group_norm_mish(y, s_ref[:], g_ref[:], n_chains=n_chains)
                    + te_ref[:] + res_ref[:])

    return np.asarray(jpl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((R, cout), jnp.float32),
        interpret=True)(x, w, b, scale.reshape(1, -1), gbias.reshape(1, -1),
                        te.reshape(1, -1), res))


@pytest.mark.parametrize("inputs", ["concat", "tall", "deep"])
def test_rows_conv_gn_matches_jax(inputs):
    """Walk and plain version against the TPU kernel's own conv and
    GroupNorm+Mish (f32 weights, per-chain statistics)."""
    xa, xb, w, bias, k, seg, scale, gbias, te, res = _conv_gn_case(
        inputs, False, "te_res", 3)
    x = xa if xb is None else torch.cat([xa, xb], 1)
    want = _jax_conv_gn(x.numpy(), w.numpy(), bias.numpy(), scale.numpy(),
                        gbias.numpy(), te.numpy(), res.numpy(), k,
                        x.shape[0] // seg)
    args = (xa, xb, w, bias, k, seg, scale, gbias, te, res)
    np.testing.assert_allclose(pl.rows_conv_gn_plain(*args).numpy(), want,
                               atol=2e-5)
    got, _ = ct.rows_conv_gn_tiled(*args, bm=32, bn=32, splits=2)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_rows_conv_gn_wrapper_checks():
    """The CUDA path's checks, reached here on meta tensors; the CPU path
    launches nothing."""
    before = pl.rows_conv_gn.launches
    x = torch.zeros(16, 32)
    w, b = torch.zeros(5 * 32, 64), torch.zeros(1, 64)
    s = torch.ones(64)
    pl.rows_conv_gn(x, None, w, b, 5, 8, s, s)
    assert pl.rows_conv_gn.launches == before
    meta = [t.to("meta") for t in (x, w, b, s)]
    with pytest.raises(ValueError, match="te must be"):
        pl.rows_conv_gn(meta[0], None, meta[1], meta[2], 5, 8, meta[3],
                        meta[3], te=torch.zeros(3, 64, device="meta"))
    with pytest.raises(ValueError, match="shapes do not match"):
        pl.rows_conv_gn(meta[0], None, meta[1][:-1], meta[2], 5, 8, meta[3],
                        meta[3])


# ---------------------------------------------------------------------------
# ddpm_project_step: one block per trajectory row, every chain
# ---------------------------------------------------------------------------

WALLS = {"none": (None, None), "grid": (GRID, None), "margin": (GRID, 0.1)}


def _step_case(C, H, D, seed):
    rng = np.random.RandomState(seed)
    x, eps, noise, cond = (_t(rng.randn(C * H, D)) for _ in range(4))
    scal = _t([1.2, 0.5, 0.6, 0.4, 0.1, 0.7, 0.0, 0.0])
    M = _t(rng.randn(H * D, H * D) / (H * D) ** 0.5)
    b = _t(rng.randn(H * D))
    return x, eps, noise, scal, cond, M, b


@pytest.mark.parametrize("chains", [8, 3, 11])
@pytest.mark.parametrize("projection", [True, False], ids=["proj", "noproj"])
@pytest.mark.parametrize("walls", list(WALLS))
def test_ddpm_step_partition_matches_plain(walls, projection, chains):
    """Block h writes row h of every chain once, chains in groups of
    STEP_CHAINS (11 = 8 + 3), the lanes' dot products and the shuffle tree
    as the kernel adds them; x is only read."""
    H, D = 32, 8
    x, eps, noise, scal, cond, M, b = _step_case(chains, H, D, chains)
    if not projection:
        M = b = None
    wall, margin = WALLS[walls]
    cfg = pl.StepConfig(H, True, True, None if wall is None else
                        np.asarray(wall), margin, POS)
    x_before = x.clone()
    want = pl.ddpm_project_step_plain(x, eps, noise, scal, cond, M, b, cfg)
    got, cover = pl.ddpm_project_step_blocks(x, eps, noise, scal, cond, M, b,
                                             cfg)
    assert torch.equal(x, x_before) and bool((cover == 1).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_array_equal(got.reshape(chains, H, D)[:, 0].numpy(),
                                  cond.reshape(chains, H, D)[:, 0].numpy())


def test_ddpm_step_ping_pong_over_steps():
    """Three steps through two buffers, as the wave runs them: each reads
    one and writes the other, and the result equals three plain steps."""
    H, D, C = 8, 8, 3
    x, eps, noise, scal, cond, M, b = _step_case(C, H, D, 5)
    cfg = pl.StepConfig(H, True, True, np.asarray(GRID), 0.1, POS)
    bufs = [x.clone(), torch.zeros_like(x)]
    want = x
    for i in range(3):
        want = pl.ddpm_project_step_plain(want, eps, noise, scal, cond, M, b,
                                          cfg)
        out, _ = pl.ddpm_project_step_blocks(bufs[i % 2], eps, noise, scal,
                                             cond, M, b, cfg)
        bufs[(i + 1) % 2].copy_(out)
    np.testing.assert_allclose(bufs[1].numpy(), want.numpy(), atol=1e-5)


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


@pytest.mark.parametrize("H", [8, 6])
@pytest.mark.parametrize("walls", list(WALLS))
def test_ddpm_step_partition_matches_jax(walls, H):
    """The walk against the TPU kernel's own step: its DDPM update lines,
    ``_project`` and ``_apply_cond`` (taken from the kernel that
    make_pallas_planner_chain builds), on 3 row-stacked chains; H = 6 gives
    H*D = 48, a ragged last lane round."""
    C, D = 3, 8
    x, eps, noise, scal, cond, M, b = _step_case(C, H, D, 17 + H)
    wall, margin = WALLS[walls]
    unet = JaxUnet(transition_dim=D, dim=32, dim_mults=(1, 2))
    diff = JaxDiffusion(model=unet, horizon=H, observation_dim=6,
                        action_dim=2, n_timesteps=4)
    jchain = jpp.make_pallas_planner_chain(
        unet, diff.schedule, H, C, 1, projection=True,
        wall_grid=None if wall is None else np.asarray(wall),
        wall_margin=margin, pos_stats=POS, weight_dtype=jnp.float32,
        interpret=True)
    fns = _closure(_closure(jchain)["kernel"])
    project, apply_cond = fns["_project"], fns["_apply_cond"]
    recip, recipm1, c1, c2, sigma, alpha = (float(v) for v in scal[:6])
    jx, je, jn = (jnp.asarray(t.numpy()) for t in (x, eps, noise))
    # the kernel's DDPM update (pallas_planner.py:230-237)
    xr = jnp.clip(recip * jx - recipm1 * je, -1.0, 1.0)
    xn = c1 * xr + c2 * jx + sigma * jn
    want = np.asarray(apply_cond(project(xn, alpha, jnp.asarray(M.numpy()),
                                         jnp.asarray(b.numpy())[None]),
                                 jnp.asarray(cond.numpy())))
    cfg = pl.StepConfig(H, True, True, None if wall is None else
                        np.asarray(wall), margin, POS)
    got, _ = pl.ddpm_project_step_blocks(x, eps, noise, scal, cond, M, b, cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    plain = pl.ddpm_project_step_plain(x, eps, noise, scal, cond, M, b, cfg)
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-5)
