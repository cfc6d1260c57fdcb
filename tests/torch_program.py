"""The layer program of the persistent kernels (K3: ops/chain.py, K4:
ops/resblock.py), interpreted on the CPU as csrc/program.cuh reads it: op
by op, through the pointers the ops hold. A test helper, not a test."""

import ctypes

import numpy as np
import torch

from dadiff_tpu_torch.ops import chain as ch
from dadiff_tpu_torch.ops.conv_tiling import rows_conv_tiled
from dadiff_tpu_torch.ops.planner import DOWN, UP, rows_conv_plain


def arr(ptr, n):
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


def interpret(ops, n_pre, T, weights, walk_tiles=False):
    """Run a layer program op by op. A conv puts its whole product into
    split 0 and an offset that cancels over the splits into the others, so a
    consumer that reads too few splits, or the wrong plane, shows. With
    ``walk_tiles`` every conv of the prologue and of the first step is also
    rebuilt from the tiles and K splits its op names, as the kernel's items
    cut it."""

    def partials(ptr, splits, plane):
        return arr(ptr, splits * plane).reshape(splits, plane).sum(0)

    def run(op, step):
        rows, cout = op.rows_in, op.cout
        n = rows * cout
        if op.kind == ch.INIT:
            x = arr(op.xa, n).reshape(rows, cout).copy()
            if op.cond:
                x[::op.seg_in] = arr(op.cond, n).reshape(rows, cout)[::op.seg_in]
            arr(op.out, n)[:] = x.ravel()
        elif op.kind == ch.CONV:
            xa = torch.from_numpy(
                arr(op.xa, rows * op.cin_a).reshape(rows, op.cin_a).copy())
            xb = None if not op.cin_b else torch.from_numpy(
                arr(op.xb, rows * op.cin_b).reshape(rows, op.cin_b).copy())
            w = weights[op.w]
            taps = 4 if op.mode == UP else op.k
            assert w.shape == (taps * (op.cin_a + op.cin_b), cout)
            assert op.w_bf16 == (w.dtype == torch.bfloat16)
            full = rows_conv_plain(xa, xb, w, torch.zeros(1, cout), op.mode,
                                   op.k, op.seg_in).numpy()
            if walk_tiles and step == 0:
                tiled, cover = rows_conv_tiled(
                    xa, xb, w, torch.zeros(1, cout), op.mode, op.k, op.seg_in,
                    op.bm, op.bn, op.splits)
                np.testing.assert_allclose(tiled.numpy(), full, atol=1e-5)
                assert bool((cover == 1).all())
            M = rows // 2 if op.mode == DOWN else rows
            full = (np.stack([full[0::2], full[1::2]]) if op.mode == UP
                    else full[None])
            out = arr(op.partial, full.shape[0] * op.splits * M * cout
                       ).reshape(full.shape[0], op.splits, M, cout)
            out[:, 1:] = 0.25
            out[:, 0] = full - 0.25 * (op.splits - 1)
            if op.out:   # the last item of a tile sums it: no consumer op
                assert op.counters and not arr(op.counters, 1).view(np.int32)[0]
                p = out.sum(1) + arr(op.bias, cout)
                p = (np.stack([p[0], p[1]], axis=1).reshape(2 * M, cout)
                     if op.mode == UP else p[0])
                arr(op.out, p.size)[:] = p.ravel()
        elif op.kind == ch.GN:
            v = partials(op.partial, op.splits, n).reshape(rows, cout) \
                + arr(op.bias, cout)
            g = v.reshape(rows // op.seg_in, op.seg_in, op.groups,
                          cout // op.groups)
            mean = g.mean(axis=(1, 3), keepdims=True)
            var = (g * g).mean(axis=(1, 3), keepdims=True) - mean * mean
            y = ((g - mean) / np.sqrt(var + 1e-5)).reshape(rows, cout)
            y = y * arr(op.scale, cout) + arr(op.gbias, cout)
            y = y * np.tanh(np.log1p(np.exp(y)))
            if op.te:  # a time row per step and segment
                segs = rows // op.seg_in
                te = np.stack([arr(op.te + 4 * (step * op.te_stride
                                                + s * op.te_seg_stride), cout)
                               for s in range(segs)])
                y = (y.reshape(segs, op.seg_in, cout)
                     + te[:, None]).reshape(rows, cout)
            if op.res:
                y = y + arr(op.res, n).reshape(rows, cout)
            if op.res_partial:
                y = y + partials(op.res_partial, op.res_splits, n).reshape(
                    rows, cout) + arr(op.res_bias, cout)
            arr(op.out, n)[:] = y.ravel()
        elif op.kind == ch.STEP:
            eps = partials(op.partial, op.splits, n).reshape(rows, cout) \
                + arr(op.bias, cout)
            x = arr(op.out, n).reshape(rows, cout)
            sc = arr(op.scal + 32 * step, 8)
            xr = sc[0] * x - sc[1] * eps if op.predict_eps else eps
            if op.clip:
                xr = np.clip(xr, -1, 1)
            xn = sc[2] * xr + sc[3] * x + sc[4] * arr(
                op.noise + 4 * step * n, n).reshape(rows, cout)
            if op.cond:
                xn[::op.seg_in] = arr(op.cond, n).reshape(rows, cout)[::op.seg_in]
            x[:] = xn
        else:
            raise AssertionError(op.kind)

    for op in ops[:n_pre]:
        run(op, 0)
    for step in range(T):
        for op in ops[n_pre:]:
            run(op, step)
