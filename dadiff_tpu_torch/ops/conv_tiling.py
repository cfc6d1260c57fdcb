"""The tiling of the conv kernels (``csrc/common.cuh``), written once in
Python: which tile a conv gets, how its K range is split, and the index
functions that turn (GEMM row, K index) into (input row, weight row).

A conv of the U-Net over row-stacked chains is an implicit GEMM
``out[M, cout] = stack[M, K] @ w[K, cout]`` whose left operand, the shifted
stack of the JAX package's ops/pallas_unet.py ``_conv_stack`` :184, is never
built: stack index ``K = j * cin + ci`` is tap ``j`` of channel ``ci``, and
:func:`in_row` finds the input row (or the zero pad) per segment. The k=4 s=2
transposed conv runs as two parities of two virtual taps each.

The launchers (``ops/planner.py``, ``ops/chain.py``) take tile shapes and
splits from here and hand them to the kernels; :func:`rows_conv_tiled` walks
the same tiles on the CPU, so the tests hold the tiling against
``rows_conv_plain`` where no kernel can run. Two families of tiles: the
mma.sync tiles of csrc/common.cuh (``MMA_TILES``, ``F32_TILE``; K tiles of
32) and the wgmma tiles of csrc/wgmma.cuh (``WG_TILES``: 128 rows, K tiles
of 64, at large row counts; the cluster tile, ``CL_BM x CL_BN``, at the
served waves' rows), which only the planner's launcher takes.

A conv that feeds a GroupNorm (``rows_conv_gn`` of csrc/planner.cu) also
normalises in its epilogue: the tiles that share a (segment, group) meet in a
group block, :func:`group_plan`, and :func:`rows_conv_gn_tiled` repeats the
kernel's order of sums on the CPU.
"""

from __future__ import annotations

import math
from typing import Iterator, List, NamedTuple, Tuple

import torch

SAME, DOWN, UP = 0, 1, 2  # conv modes, as in csrc/common.cuh
BK = 32                   # K tile of every kernel tile
N_SM = 132                # streaming multiprocessors of an H100


MMA_TILES = ((16, 64), (32, 64), (64, 64), (64, 128))  # bf16, smallest first
F32_TILE = (32, 32)
# the wgmma tiles of csrc/wgmma.cuh (DADIFF_WITH_WG_TILE): 128 rows, BK = 64,
# the stages each width takes by default and the (width, stages) built
WG_BM, WG_BK = 128, 64
WG_TILES = ((WG_BM, 128), (WG_BM, 256))
WG_STAGES = {128: 4, 256: 3}
WG_BUILT = ((128, 4), (128, 3), (256, 3))
# rows_conv_gn's wgmma tile: 128 columns, 3 stages (the ring leaves room for
# the residual tile of its epilogue)
WG_GN = (128, 3)
# the cluster tile of csrc/wgmma.cuh (ClusterTile): 64 x 128, K tiles of 64,
# a ring of 3 stages, the K splits of an output tile one thread-block
# cluster of at most 8 blocks (the portable cluster size)
CL_BM, CL_BN, CL_STAGES, CL_MAX_SPLITS = 64, 128, 3, 8


def tile_bk(bm: int) -> int:
    """K tile of the tile with ``bm`` rows: 64 for a wgmma tile, else 32."""
    return WG_BK if bm == WG_BM else BK


def tile_shape(M: int, bf16: bool, cout: int, parities: int = 1,
               room: int = 2 * N_SM) -> Tuple[int, int]:
    """(rows, columns) of the output tile of a conv with M GEMM rows; one of
    the tiles ``DADIFF_WITH_TILE`` of csrc/common.cuh instantiates. bf16
    weights: the smallest tile that leaves no more than ``room`` output
    tiles. At the U-Net's sizes up to the 64-chain chain a conv is bound by
    latency, and many small blocks, each with its own loads in flight, beat
    the fewer re-reads of a large tile: on the card 16 x 64 came first at
    every conv of the flagship at 8 chains. f32 weights: 32 x 32. (The K3
    and K4 programs cut their convs here too; the planner's launcher takes
    the cluster tile where it fits and has the work to fill it, and the
    wgmma tiles of ``WG_TILES`` past the point where 64 x 128 leaves more
    blocks than the card has SMs: ops/planner.py ``_split_k``.)"""
    if not bf16:
        return F32_TILE
    for bm, bn in MMA_TILES:
        if -(-M // bm) * -(-cout // bn) * parities <= room:
            break
    return bm, bn


def tap_row(mode: int, l: int, j: int, parity: int, k: int) -> int:
    """Row inside its segment that feeds local output row ``l`` through
    virtual tap ``j`` (outside the segment: a zero pad)."""
    if mode == DOWN:
        return 2 * l + j - 1
    if mode == SAME:
        return l + j - k // 2
    # even rows: x[h] R1 + x[h-1] R3; odd rows: x[h+1] R0 + x[h] R2
    if parity == 0:
        return l if j == 0 else l - 1
    return l + 1 if j == 0 else l


def in_row(mode: int, m: int, j: int, parity: int, seg_in: int, k: int) -> int:
    """Input row feeding GEMM row ``m`` through virtual tap ``j``, or -1."""
    seg_m = seg_in // 2 if mode == DOWN else seg_in
    s = m // seg_m
    li = tap_row(mode, m - s * seg_m, j, parity, k)
    return s * seg_in + li if 0 <= li < seg_in else -1


def weight_tap(mode: int, j: int, parity: int) -> int:
    """Row block of the flattened weight that virtual tap ``j`` multiplies."""
    if mode != UP:
        return j
    return (1, 3)[j] if parity == 0 else (0, 2)[j]


def out_row(mode: int, m: int, parity: int, seg_in: int) -> int:
    if mode != UP:
        return m
    s = m // seg_in
    return s * 2 * seg_in + 2 * (m - s * seg_in) + parity


def gemm_dims(rows: int, cin: int, mode: int, k: int) -> Tuple[int, int, int]:
    """(M, K, parities) of the conv's GEMM."""
    return (rows // 2 if mode == DOWN else rows,
            (2 if mode == UP else k) * cin, 2 if mode == UP else 1)


def k_range(split: int, splits: int, K: int, bk: int = BK) -> Tuple[int, int]:
    """[k_begin, k_end) of one K split: whole K tiles of ``bk``, equal
    shares."""
    k_tiles = -(-K // bk)
    per_split = -(-k_tiles // splits)
    k_begin = split * per_split * bk
    return k_begin, max(k_begin, min(K, k_begin + per_split * bk))


def even_splits(k_tiles: int, want: int) -> int:
    """At most ``want`` splits of ``k_tiles`` K tiles, none of them empty."""
    want = max(1, min(want, k_tiles))
    return -(-k_tiles // -(-k_tiles // want))


class Tiling(NamedTuple):
    bm: int
    bn: int
    tiles: int       # output tiles, parities included
    splits: int      # K splits per output tile
    M: int
    K: int
    parities: int
    cout: int
    stages: int = 0  # a wgmma tile's ring; 0: WG_STAGES[bn]
    cluster: bool = False  # the cluster tile: K splits meet in a cluster

    @property
    def bk(self) -> int:
        return WG_BK if self.cluster else tile_bk(self.bm)

    @property
    def k_tiles(self) -> int:
        return -(-self.K // self.bk)

    @property
    def ring(self) -> int:
        """Stages of a wgmma tile's ring (0 for the other tiles)."""
        if self.cluster:
            return CL_STAGES
        if self.bm != WG_BM:
            return 0
        return self.stages or WG_STAGES[self.bn]

    @property
    def partial_elems(self) -> int:
        """Floats of the split-K partial tiles, [parity][split][M][cout]
        (none on the cluster tile: its splits meet in shared memory)."""
        if self.cluster:
            return 0
        return self.parities * self.splits * self.M * self.cout


def tiling(rows: int, cin: int, cout: int, mode: int, k: int, bf16: bool,
           room: int, want_splits) -> Tiling:
    """Tile and K splits of a conv on a card with room for ``room`` blocks.
    ``want_splits(tiles, k_tiles)`` says how many splits the launcher would
    like for that many output tiles; it gets at most that many, none of them
    empty."""
    M, K, parities = gemm_dims(rows, cin, mode, k)
    bm, bn = tile_shape(M, bf16, cout, parities, room)
    tiles = -(-cout // bn) * -(-M // bm) * parities
    k_tiles = -(-K // BK)
    return Tiling(bm, bn, tiles, even_splits(k_tiles, want_splits(tiles, k_tiles)),
                  M, K, parities, cout)


def wg_tiling(M: int, K: int, parities: int, cout: int, bn: int,
              splits: int, stages: int = 0) -> Tiling:
    """A conv's GEMM on the 128 x ``bn`` wgmma tile."""
    tiles = -(-cout // bn) * -(-M // WG_BM) * parities
    return Tiling(WG_BM, bn, tiles, even_splits(-(-K // WG_BK), splits), M, K,
                  parities, cout, stages)


def cl_tiling(M: int, K: int, parities: int, cout: int,
              splits: int) -> Tiling:
    """A conv's GEMM on the 64 x 128 cluster tile with at most ``splits``
    K splits (at most ``CL_MAX_SPLITS``), none of them empty."""
    tiles = -(-cout // CL_BN) * -(-M // CL_BM) * parities
    return Tiling(CL_BM, CL_BN, tiles,
                  even_splits(-(-K // WG_BK), min(splits, CL_MAX_SPLITS)),
                  M, K, parities, cout, 0, True)


def cl_fits(mode: int, seg: int, cin_a: int, cin_b: int, cout: int) -> bool:
    """The cluster tile takes the conv (csrc/planner.cu rows_conv_cl): A
    travels by TMA (every K tile in one tap and one of xa / xb, a segment of
    GEMM rows a divisor or a multiple of 64 rows) and cout is whole 64-wide
    boxes of the weight."""
    seg_m = seg // 2 if mode == DOWN else seg
    return (cin_a % WG_BK == 0 and cin_b % WG_BK == 0 and cout % 64 == 0
            and seg_m > 0 and (CL_BM % seg_m == 0 or seg_m % CL_BM == 0)
            and (mode != DOWN or seg % 2 == 0) and (mode != UP or cin_b == 0))


def rows_conv_tiled(xa, xb, w, bias, mode: int, k: int, seg_in: int, bm: int,
                    bn: int, splits: int, cluster: bool = False):
    """The conv rebuilt from its kernel tiles on the CPU: every (tile,
    parity, K split) sums its K tiles (of the tile's BK) into a partial
    tile, through the index functions above, and the partials are added in
    split order. A wgmma tile reads the weight rows of a ragged K tile as
    one box of consecutive rows (its TMA load; SAME and DOWN only).
    ``cluster``: the cluster tile (``bm x bn`` = ``CL_BM x CL_BN``, K tiles
    of 64, whole K tiles in one tap only), whose blocks add the splits'
    partial tiles in the same split order. Returns (out, cover):
    ``cover[parity, tile_m, tile_n, K index]`` counts how often a tile's
    walk multiplied that index."""
    x = xa if xb is None else torch.cat([xa, xb], dim=1)
    if w.dtype == torch.bfloat16:  # rounded as they are staged
        x = x.to(torch.bfloat16).to(torch.float32)
    wf = w.to(torch.float32)
    rows, cin = x.shape
    cout = wf.shape[1]
    M, K, parities = gemm_dims(rows, cin, mode, k)
    bk, wg = (WG_BK if cluster else tile_bk(bm)), bm == WG_BM
    aligned = xa.shape[1] % bk == 0 and (xb is None or xb.shape[1] % bk == 0)
    if cluster and not aligned:
        raise ValueError("the cluster tile needs cin_a, cin_b % 64 == 0")
    if wg and not aligned and mode == UP:
        raise ValueError("a wgmma tile's transposed conv needs cin % 64 == 0")
    tiles_m, tiles_n = -(-M // bm), -(-cout // bn)
    out = torch.zeros(parities * M if mode == UP else M, cout)
    cover = torch.zeros(parities, tiles_m, tiles_n, K, dtype=torch.int64)
    zero = torch.zeros(cin)
    for parity in range(parities):
        for tm in range(tiles_m):
            ms = range(tm * bm, min(M, (tm + 1) * bm))
            for tn in range(tiles_n):
                n0, n1 = tn * bn, min(cout, (tn + 1) * bn)
                acc = torch.zeros(len(ms), n1 - n0)
                for split in range(splits):
                    part = torch.zeros_like(acc)
                    k_begin, k_end = k_range(split, splits, K, bk)
                    for k0 in range(k_begin, k_end, bk):
                        k1 = min(k_end, k0 + bk)
                        a = torch.zeros(len(ms), k1 - k0)
                        if aligned:  # one tap per K tile, found once per row
                            j, ci = divmod(k0, cin)
                            for i, m in enumerate(ms):
                                r = in_row(mode, m, j, parity, seg_in, k)
                                a[i] = (zero if r < 0 else x[r])[ci:ci + k1 - k0]
                            wr0 = weight_tap(mode, j, parity) * cin + ci
                            b = wf[wr0:wr0 + k1 - k0, n0:n1]
                        else:        # ragged: element by element
                            b = torch.zeros(k1 - k0, n1 - n0)
                            for kk, kg in enumerate(range(k0, k1)):
                                j, ci = divmod(kg, cin)
                                for i, m in enumerate(ms):
                                    r = in_row(mode, m, j, parity, seg_in, k)
                                    a[i, kk] = 0.0 if r < 0 else x[r, ci]
                                b[kk] = wf[kg if wg else
                                           weight_tap(mode, j, parity) * cin
                                           + ci, n0:n1]
                        part += a @ b
                        cover[parity, tm, tn, k0:k1] += 1
                    acc += part
                for i, m in enumerate(ms):
                    out[out_row(mode, m, parity, seg_in), n0:n1] = \
                        acc[i] + bias.reshape(-1)[n0:n1]
    return out, cover


# ---------------------------------------------------------------------------
# The group blocks of rows_conv_gn (csrc/planner.cu gn_epilogue)
# ---------------------------------------------------------------------------

N_GROUPS = 8            # GroupNorm(8), as every norm of the U-Net
CONV_SMEM_BYTES = 47104  # kConvSmemBytes of csrc/common.cuh
MAX_GROUP_PAIRS = 256    # pairs a group block may hold: one thread each


class GroupPlan(NamedTuple):
    """How the output tiles of a SAME conv meet for GroupNorm statistics per
    (segment, group). A group block is ``tiles_m x tiles_n`` tiles, the
    aligned rectangle of lcm(seg, bm) rows by lcm(C/8, bn) columns, capped at
    the conv's tiles: it holds ``segs x groups`` whole (segment, group)
    pairs, and every pair lies in exactly one group block."""
    tiles_m: int     # tiles per group block along the rows
    tiles_n: int     # ... along the columns
    segs: int        # segments per group block
    groups: int      # groups per group block
    blocks: int      # group blocks of the launch: one counter each
    smem_bytes: int  # shared memory its epilogue needs at the least

    @property
    def pairs(self) -> int:
        return self.segs * self.groups

    @property
    def fits(self) -> bool:
        """The kernel holds the group block in the conv's shared memory."""
        return (self.smem_bytes <= CONV_SMEM_BYTES
                and self.pairs <= MAX_GROUP_PAIRS)


def group_plan(M: int, cout: int, seg: int, bm: int, bn: int,
               n_groups: int = N_GROUPS) -> GroupPlan:
    """The group blocks of a SAME conv of M rows in segments of ``seg``, cut
    into ``bm x bn`` tiles."""
    cg = cout // n_groups
    all_m, all_n = -(-M // bm), -(-cout // bn)
    tm = min(math.lcm(seg, bm) // bm, all_m)
    tn = min(math.lcm(cg, bn) // bn, all_n)
    segs = -(-min(tm * bm, M) // seg)
    groups = -(-min(tn * bn, cout) // cg)
    blocks = -(-all_m // tm) * -(-all_n // tn)
    # the group block, its pairs' statistics, bias, scale, shift and time
    # rows (gn_smem_bytes of csrc/planner.cu); the residual is staged where
    # the rest leaves room for it
    return GroupPlan(tm, tn, segs, groups, blocks,
                     4 * tm * bm * tn * bn + 16 * -(-segs * groups // 2)
                     + 4 * tn * bn * (3 + segs))


def wg_gn_fits(seg: int, cout: int, bn: int, n_groups: int = N_GROUPS
               ) -> bool:
    """The GroupNorm epilogue of a wgmma tile ``bn`` wide (csrc/planner.cu
    wg_gn_epilogue, built for ``WG_GN``) holds every (segment, group) pair
    inside one tile: a segment is whole 8-row pieces and divides 128 rows, a
    group is whole 8-column chunks and divides the tile's width (or the
    tile spans cout)."""
    cg = cout // n_groups
    return (cout % n_groups == 0 and seg % 8 == 0 and WG_BM % seg == 0
            and cg % 8 == 0 and (bn % cg == 0 or bn >= cout))


def cl_gn_fits(seg: int, cout: int, n_groups: int = N_GROUPS) -> bool:
    """The GroupNorm epilogue of the cluster tile (csrc/planner.cu cl_conv)
    holds every (segment, group) pair inside one tile: a segment is whole
    8-row pieces and divides 64 rows, a group is whole 8-column chunks and
    divides the tile's 128 columns."""
    cg = cout // n_groups
    return (cout % 64 == 0 and seg % 8 == 0 and CL_BM % seg == 0
            and cg % 8 == 0 and CL_BN % cg == 0)


class GroupBlock(NamedTuple):
    index: int                       # its counter
    rows: Tuple[int, int]            # [m0, m1) of the conv's rows
    cols: Tuple[int, int]            # [n0, n1) of its columns
    tiles: List[Tuple[int, int]]     # (tile row, tile column)
    pairs: List[Tuple[int, int, int]]  # (index p, segment, group) in it


def group_blocks(M: int, cout: int, seg: int, bm: int, bn: int,
                 n_groups: int = N_GROUPS) -> Iterator[GroupBlock]:
    """Every group block of :func:`group_plan` with its tiles and its
    (segment, group) pairs, as the kernel finds them from its block index."""
    g = group_plan(M, cout, seg, bm, bn, n_groups)
    cg = cout // n_groups
    all_m, all_n = -(-M // bm), -(-cout // bn)
    per_row = -(-all_n // g.tiles_n)
    for gbm in range(-(-all_m // g.tiles_m)):
        for gbn in range(per_row):
            tms = range(gbm * g.tiles_m, min(all_m, (gbm + 1) * g.tiles_m))
            tns = range(gbn * g.tiles_n, min(all_n, (gbn + 1) * g.tiles_n))
            m0, n0 = tms[0] * bm, tns[0] * bn
            pairs = [(sl * g.groups + gl, m0 // seg + sl, n0 // cg + gl)
                     for sl in range(g.segs) for gl in range(g.groups)
                     if m0 + sl * seg < M and n0 + gl * cg < cout]
            yield GroupBlock(gbm * per_row + gbn,
                             (m0, min(M, (tms[-1] + 1) * bm)),
                             (n0, min(cout, (tns[-1] + 1) * bn)),
                             [(tm, tn) for tm in tms for tn in tns], pairs)


def rows_conv_gn_tiled(xa, xb, w, bias, k: int, seg: int, scale, gbias,
                       te=None, res=None, *, bm: int, bn: int, splits: int,
                       eps: float = 1e-5, cluster: bool = False):
    """The fused conv + GroupNorm + Mish (+ te per segment, + res) rebuilt
    from the kernel's tiles and group blocks on the CPU: a group block's
    tiles, each the sum of its K splits in split order, then per (segment,
    group) pair mean and var = E[x^2] - mean^2; on a wgmma tile and on the
    cluster tile (``cluster``) the pair's sums per 8-row piece, the pieces
    added in row order. Returns (out, cover): ``cover[segment, group]``
    counts the group blocks that normalised the pair."""
    pre, _ = rows_conv_tiled(xa, xb, w, bias, SAME, k, seg, bm, bn, splits,
                             cluster)
    M, cout = pre.shape
    cg = cout // N_GROUPS
    out = torch.empty_like(pre)
    cover = torch.zeros(M // seg, N_GROUPS, dtype=torch.int64)
    te = None if te is None else te.reshape(-1, cout).expand(M // seg, cout)
    wg = bm == WG_BM or cluster
    if bm == WG_BM and not wg_gn_fits(seg, cout, bn):
        raise ValueError("the wgmma tile does not hold these pairs")
    if cluster and not cl_gn_fits(seg, cout):
        raise ValueError("the cluster tile does not hold these pairs")
    for gb in group_blocks(M, cout, seg, bm, bn):
        for _, s, g in gb.pairs:
            rs, cs = slice(s * seg, (s + 1) * seg), slice(g * cg, (g + 1) * cg)
            x = pre[rs, cs]
            if wg:  # sums per 8-row piece, the pieces added in row order
                pieces = x.reshape(seg // 8, 8 * cg)
                s1 = torch.zeros(())
                s2 = torch.zeros(())
                for p in pieces:
                    s1, s2 = s1 + p.sum(), s2 + (p * p).sum()
            else:
                s1, s2 = x.sum(), (x * x).sum()
            mean = s1 / (seg * cg)
            rstd = torch.rsqrt(s2 / (seg * cg) - mean * mean + eps)
            y = (x - mean) * rstd * scale.reshape(-1)[cs] \
                + gbias.reshape(-1)[cs]
            y = y * torch.tanh(torch.nn.functional.softplus(y))
            if te is not None:
                y = y + te[s, cs]
            if res is not None:
                y = y + res[rs, cs]
            out[rs, cs] = y
            cover[s, g] += 1
    return out, cover
