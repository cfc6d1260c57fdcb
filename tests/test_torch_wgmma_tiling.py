"""The wgmma tile of K2's conv product (``WgTile`` of csrc/wgmma.cuh, through
``rows_conv_wg`` / ``rows_conv_gn_wg`` of csrc/planner.cu), held on the CPU
where no kernel runs: which convs take it (every conv of the 1,024-chain
wave, none of the served 8-chain wave, the 64-chain chain or K3), and its
walk (``conv_tiling.rows_conv_tiled`` / ``rows_conv_gn_tiled`` at 128 rows,
BK = 64, TMA boxes of consecutive weight rows, statistics per 8-row piece)
against the plain versions and the JAX package's ``_conv_stack`` +
``_group_norm_mish`` (pallas_unet.py:184, :198, a Pallas kernel in interpret
mode).

Tolerances: 2e-5 for the conv walk (f32 sums of up to K = 1,280 products in
another order), 1e-5 for the fused walk against the plain fused conv (as
test_torch_epilogue.py), 2e-5 against JAX (the same sums once more by XLA).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as jpl

from dadiff_tpu.ops.pallas_unet import _conv_stack, _dot, _group_norm_mish

from dadiff_tpu_torch.models.temporal_unet import TemporalUnet
from dadiff_tpu_torch.ops import chain as ch
from dadiff_tpu_torch.ops import conv_tiling as ct
from dadiff_tpu_torch.ops import planner as pl
from dadiff_tpu_torch.sweep_kernels import step_launches

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flagship():
    return TemporalUnet(transition_dim=8, dim=128, dim_mults=(1, 2, 4))


def _tiles(calls):
    out = []
    for kind, R, ca, cb, cout, mode, k, seg, *_ in calls:
        t = (pl._split_k(R, ca + cb, cout, mode, k, True) if kind == "conv"
             else pl._split_k_gn(R, ca + cb, cout, k, seg, True)[0])
        out.append((t.bm, t.bn, t.splits))
    return out


# (bm, bn, splits) of each of a step's 35 launches in forward order, as the
# mma.sync rule gave them before the wgmma tile existed
PINNED = {
    8: [(16, 64, s) for s in (1, 1, 7, 7, 7, 6, 7, 1, 8, 8, 8, 8, 8, 4, 8, 8,
                              8, 8, 8, 8, 8, 16, 8, 8, 8, 8, 8, 8, 8, 7, 7, 7,
                              4, 7, 1)],
    64: [(16, 64, s) for s in (1, 1, 3, 3, 3, 4, 3, 1, 3, 3, 3, 5, 3, 3, 3, 3,
                               3, 3, 3, 3, 3, 5, 5, 5, 5, 5, 3, 5, 4, 5, 5, 5,
                               3, 3, 1)],
}
# the one-launch chain's (K3) tiles at batch 1 on its 132-block grid
K3_PINNED = {
    "bf16": [(16, 64, s) for s in (2, 1, 10, 10, 10, 12, 10, 4, 14, 14, 14,
                                   12, 14, 8, 16, 16, 16, 16, 16, 16, 16, 16,
                                   16, 14, 14, 14, 16, 16, 16, 10, 10, 10, 8,
                                   10, 4)],
    "f32": [(32, 32, s) for s in (2, 1, 10, 10, 10, 12, 10, 4, 14, 14, 14, 12,
                                  8, 8, 8, 8, 8, 8, 8, 8, 8, 16, 16, 14, 14,
                                  14, 8, 16, 16, 10, 10, 10, 8, 10, 4)],
}


@pytest.mark.parametrize("chains", [8, 64])
def test_served_and_64_chain_waves_keep_their_tiles(flagship, chains):
    """The served bo8 wave (256 rows) and the 64-chain chain keep the
    mma.sync tiles and K splits they had, so their results stay bit for bit
    those of before."""
    calls, _, _ = step_launches(flagship, chains * 32, 8, 32)
    assert len(calls) == 35
    assert _tiles(calls) == PINNED[chains]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_one_launch_chain_keeps_its_tiles(flagship, dtype):
    """K3 (and K4, which walks the same layer program) cut their convs with
    ``tiling`` alone: the wgmma tile never reaches them."""
    wd = torch.bfloat16 if dtype == "bf16" else torch.float32
    calls, _, _ = step_launches(flagship, 32, 8, 32)
    got = []
    for _, R, ca, cb, cout, mode, k, *_ in calls:
        t = ch._ProgramBuilder("cpu", 132).tiling_for(
            R, ca + cb, torch.empty(0, cout, dtype=wd), mode, k)
        got.append((t.bm, t.bn, t.splits))
    assert got == K3_PINNED[dtype]


def test_every_conv_of_the_1024_chain_wave_takes_the_wgmma_tile(flagship):
    """At 32,768 rows every conv takes a 128-row wgmma tile; every fused
    conv one K split and a group block of one tile that holds whole (chain,
    group) pairs, each pair once; the grid within CUDA's limits, its K
    splits whole 64-wide K tiles."""
    calls, _, _ = step_launches(flagship, 1024 * 32, 8, 32)
    fused = 0
    for kind, R, ca, cb, cout, mode, k, seg, *_ in calls:
        if kind == "conv":
            t = pl._split_k(R, ca + cb, cout, mode, k, True)
        else:
            fused += 1
            t, g = pl._split_k_gn(R, ca + cb, cout, k, seg, True)
            assert t.splits == 1 and ct.wg_gn_fits(seg, cout, t.bn)
            assert (g.tiles_m, g.tiles_n) == (1, 1) and g.blocks == t.tiles
            seen = np.zeros((t.M // seg, ct.N_GROUPS), np.int64)
            for gb in ct.group_blocks(t.M, cout, seg, t.bm, t.bn):
                assert len(gb.tiles) == 1
                for _, s, grp in gb.pairs:
                    seen[s, grp] += 1
            assert (seen == 1).all()
        assert (t.bm, t.bn) in ct.WG_TILES and t.bk == ct.WG_BK
        assert (t.bn, t.ring) in ct.WG_BUILT
        per_split = -(-t.k_tiles // t.splits)
        assert (t.splits - 1) * per_split < t.k_tiles <= t.splits * per_split
        ranges = [ct.k_range(s, t.splits, t.K, t.bk) for s in range(t.splits)]
        assert all(a % ct.WG_BK == 0 for a, _ in ranges)
        grid = (-(-cout // t.bn), -(-t.M // t.bm), t.splits * t.parities)
        assert grid[1] < 65536 and grid[2] < 65536
        assert t.tiles == grid[0] * grid[1] * t.parities
        assert t.splits == 1  # no split-K on the wgmma tile
    assert fused == 25


def test_wgmma_rule_edges():
    """Where the fused epilogue cannot hold a tile's pairs (a segment that
    is not whole 8-row pieces dividing 128 rows, a group not whole 8-column
    chunks) the conv keeps the mma.sync tiles; a transposed conv whose cin
    is not whole 64-row boxes keeps them too; f32 weights never take it."""
    assert ct.wg_gn_fits(8, 512, 128) and ct.wg_gn_fits(32, 128, 256)
    assert not ct.wg_gn_fits(24, 128, 128)      # 24 does not divide 128
    assert not ct.wg_gn_fits(4, 128, 128)       # half a piece
    assert not ct.wg_gn_fits(8, 96, 128)        # 12-channel groups
    rows = 24 * 2048
    t, g = pl._split_k_gn(rows, 128, 128, 5, 24, True)
    assert t.bm != ct.WG_BM and g.fits
    assert pl._split_k(rows, 128, 128, ct.SAME, 5, True).bm == ct.WG_BM
    assert pl._split_k(rows, 96, 128, ct.UP, 4, True).bm != ct.WG_BM
    assert pl._split_k(rows, 128, 128, ct.UP, 4, True).bm == ct.WG_BM
    assert (pl._split_k(rows, 128, 128, ct.SAME, 5, False)[:2]
            == ct.F32_TILE)
    # 256 columns where three tiles are left for every four SMs, unfused
    assert pl._wg_width(8192, 512, 1) == 256 and pl._wg_width(8192, 256, 2) == 256
    assert pl._wg_width(8192, 256, 1) == 128 and pl._wg_width(32768, 128, 1) == 128
    assert pl._split_k_gn(8192, 512, 512, 5, 8, True)[0].bn == 128


# levels of the flagship U-Net: segment rows and channels
LEVELS = {"seg32_c128": (32, 128), "seg16_c256": (16, 256),
          "seg8_c512": (8, 512)}
CONV_MODES = {"same5": (ct.SAME, 5, 64), "same1": (ct.SAME, 1, 64),
              "down": (ct.DOWN, 3, 64), "up": (ct.UP, 4, 64),
              "ragged_cin8": (ct.SAME, 5, 8), "concat": (ct.SAME, 5, 128)}
ROWS = 256  # two 128-row tiles


def _conv_case(mode, k, cin, seg, cout, seed):
    rng = np.random.RandomState(seed)
    ca, cb = (cin // 2, cin // 2) if cin == 128 else (cin, 0)
    taps = 4 if mode == ct.UP else k
    rows = ROWS // 2 if mode == ct.UP else ROWS
    xa = torch.from_numpy(rng.randn(rows, ca).astype(np.float32))
    xb = torch.from_numpy(rng.randn(rows, cb).astype(np.float32)) if cb else None
    w = torch.from_numpy((rng.randn(taps * cin, cout) / cin ** 0.5)
                         .astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.randn(1, cout).astype(np.float32))
    return xa, xb, w, bias


@pytest.mark.parametrize("level", list(LEVELS))
@pytest.mark.parametrize("conv", list(CONV_MODES))
def test_wgmma_walk_rebuilds_rows_conv(conv, level):
    """The wgmma tile's walk (128-row tiles, 64-wide K tiles, a ragged K
    tile's weight rows as one box of consecutive rows) gives
    rows_conv_plain and multiplies every K index of every tile once, at
    both widths, one and two K splits."""
    mode, k, cin = CONV_MODES[conv]
    seg, cout = LEVELS[level]
    xa, xb, w, bias = _conv_case(mode, k, cin, seg, cout,
                                 len(conv) + 7 * len(level))
    want = pl.rows_conv_plain(xa, xb, w, bias, mode, k, seg)
    M, K, parities = ct.gemm_dims(xa.shape[0], cin, mode, k)
    for _, bn in ct.WG_TILES:
        for splits in (1, 2):
            t = ct.wg_tiling(M, K, parities, cout, bn, splits)
            got, cover = ct.rows_conv_tiled(xa, xb, w, bias, mode, k, seg,
                                            t.bm, t.bn, t.splits)
            assert cover.shape == (parities, -(-M // 128), -(-cout // bn), K)
            assert bool((cover == 1).all()), (bn, splits)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                       err_msg=f"bn={bn} splits={splits}")


ADDS = ["none", "te", "te_per_segment", "res", "te_res"]


def _gn_case(seg, cout, adds, seed, bf16=True, cin=64):
    rng = np.random.RandomState(seed)
    xa = torch.from_numpy(rng.randn(ROWS, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(5 * cin, cout) / cin ** 0.5)
                         .astype(np.float32))
    w = w.to(torch.bfloat16) if bf16 else w
    f = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(1, cout), 1 + 0.5 * rng.randn(cout), rng.randn(cout))]
    te = res = None
    if adds.startswith("te"):
        te = torch.from_numpy(rng.randn(
            ROWS // seg if adds == "te_per_segment" else 1, cout)
            .astype(np.float32))
    if adds.endswith("res"):
        res = torch.from_numpy(rng.randn(ROWS, cout).astype(np.float32))
    return (xa, None, w, f[0], 5, seg, f[1], f[2], te, res)


@pytest.mark.parametrize("adds", ADDS)
@pytest.mark.parametrize("level", list(LEVELS))
def test_wgmma_walk_rebuilds_rows_conv_gn(level, adds):
    """The fused conv on the wgmma tile (one K split; each (segment, group)
    pair's sums per 8-row piece, added in row order) gives rows_conv_plain
    -> gn_mish_plain with its adds, normalising every pair once, at each
    width whose tile holds the pairs."""
    seg, cout = LEVELS[level]
    args = _gn_case(seg, cout, adds, len(level) + 3 * len(adds))
    want = pl.rows_conv_gn_plain(*args)
    widths = [bn for _, bn in ct.WG_TILES if ct.wg_gn_fits(seg, cout, bn)]
    assert widths == [128, 256]
    for bn in widths:
        got, cover = ct.rows_conv_gn_tiled(*args, bm=ct.WG_BM, bn=bn,
                                           splits=1)
        assert bool((cover == 1).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   err_msg=f"bn={bn}")


def _jax_conv_gn(x, w, b, scale, gbias, te, res, k, n_chains):
    """The JAX package's conv stack and _group_norm_mish in one Pallas
    kernel, in interpret mode, with the adds res_block fuses around it."""
    R, cout = x.shape[0], w.shape[1]

    def kernel(x_ref, w_ref, b_ref, s_ref, g_ref, te_ref, res_ref, o_ref):
        y = _dot(_conv_stack(x_ref[:], k, R // n_chains), w_ref[:]) + b_ref[:]
        o_ref[:] = (_group_norm_mish(y, s_ref[:], g_ref[:], n_chains=n_chains)
                    + te_ref[:] + res_ref[:])

    return np.asarray(jpl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((R, cout), jnp.float32),
        interpret=True)(x, w, b, scale.reshape(1, -1), gbias.reshape(1, -1),
                        te.reshape(1, -1), res))


@pytest.mark.parametrize("level", list(LEVELS))
def test_wgmma_fused_walk_matches_jax(level):
    """The fused walk on the wgmma tile against the TPU kernel's own conv
    and GroupNorm+Mish (f32 weights, per-chain statistics)."""
    seg, cout = LEVELS[level]
    args = _gn_case(seg, cout, "te_res", 11, bf16=False, cin=32)
    xa, _, w, bias, k, _, scale, gbias, te, res = args
    want = _jax_conv_gn(xa.numpy(), w.numpy(), bias.numpy(), scale.numpy(),
                        gbias.numpy(), te.numpy(), res.numpy(), k,
                        ROWS // seg)
    got, _ = ct.rows_conv_gn_tiled(*args, bm=ct.WG_BM, bn=128, splits=1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


class _FakeLib:
    """Records the C calls the launchers make."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def test_launchers_route_the_wgmma_tile(monkeypatch):
    """A wgmma tiling goes to rows_conv_wg / rows_conv_gn_wg with its width,
    its ring and its splits (split-K scratch and counters only with more
    than one split; the fused entry takes neither, nor group counters); the
    mma.sync tiles keep their entries."""
    from dadiff_tpu_torch.ops import cuda_lib

    fake = _FakeLib()
    monkeypatch.setattr(cuda_lib, "lib", lambda name: fake)
    R, cin, cout = 1024 * 32, 128, 128
    xa = torch.zeros(R // 64, cin)  # shapes only: nothing is computed
    w = torch.zeros(5 * cin, cout, dtype=torch.bfloat16)
    bias, out = torch.zeros(1, cout), torch.zeros(R // 64, cout)
    counters = torch.zeros(1024, dtype=torch.int32)
    scratch = torch.zeros(1)
    t = pl._split_k(R, cin, cout, ct.SAME, 5, True)
    assert t.bm == ct.WG_BM and t.splits == 1
    pl.launch_rows_conv(xa, None, w, bias, out, ct.SAME, 5, 32, stream=7,
                        scratch=scratch, t=t, counters=counters)
    name, a = fake.calls[-1]
    assert name == "rows_conv_wg"
    assert a[12:15] == (t.bn, ct.WG_STAGES[t.bn], 1) and a[15] is None \
        and a[16] is None and a[17] == 7
    two = ct.wg_tiling(R // 64, 5 * cin, 1, cout, 128, 2, stages=3)
    pl.launch_rows_conv(xa, None, w, bias, out, ct.SAME, 5, 32, stream=7,
                        scratch=scratch, t=two, counters=counters)
    name, a = fake.calls[-1]
    assert a[12:15] == (128, 3, 2) and a[15] is not None \
        and a[16] == counters.data_ptr()
    tg, g = pl._split_k_gn(R, cin, cout, 5, 32, True)
    pl.launch_rows_conv_gn(xa, None, w, bias, out, 5, 32, bias.reshape(-1),
                           bias.reshape(-1), None, 0, None, None, stream=7,
                           t=tg, g=g)
    name, a = fake.calls[-1]
    assert name == "rows_conv_gn_wg" and len(a) == 20
    assert a[11:13] == ct.WG_GN and tg[:2] == (128, 128) and a[-1] == 7
    small = pl._split_k(256, cin, cout, ct.SAME, 5, True)
    pl.launch_rows_conv(xa, None, w, bias, out, ct.SAME, 5, 32, stream=7,
                        scratch=scratch, t=small, counters=counters)
    assert fake.calls[-1][0] == "rows_conv"


def test_every_c_entry_has_its_ctypes_signature():
    """Each ``extern "C"`` entry of csrc/*.cu is registered in
    ``cuda_lib.SIGNATURES`` with one argtype per parameter: a pointer (or
    the stream) as c_void_p, an int as c_int, a float as c_float. ctypes
    would otherwise pass every argument as a 32-bit int."""
    import ctypes
    import re

    from dadiff_tpu_torch.ops import cuda_lib

    kinds = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    seen = 0
    for src in sorted(cuda_lib.CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            want = ["P" if "*" in p else "F" if p.split()[0] == "float"
                    else "I" for p in params.split(",")]
            got = [kinds[a] for a in cuda_lib.SIGNATURES[src.stem][name]]
            assert got == want, name
            seen += 1
    assert seen == sum(len(v) for v in cuda_lib.SIGNATURES.values())
