// The layer program that the persistent kernels walk: K3, the one-launch
// chain (chain.cu), and K4, the fused residual block (resblock.cu), compile
// their conv and GroupNorm phases from this one source.
//
// A program is a list of ChainOps (ops/chain.py _ProgramBuilder writes
// them). A kernel launched cooperatively, at most as many blocks as are
// co-resident, walks the list: each op's work items are spread over the
// blocks (first_item), and a grid-wide barrier follows an op whose
// sync_after is set.
//
//   conv_items  a conv split over K into items (tile, parity, K split) that
//               run a tile product of common.cuh and store partial tiles,
//               or, with `out`, whose last item of a tile sums it
//               (split_k_last);
//   gn_items    GroupNorm + Mish of (bias + the conv's partials, summed in
//               split order) per (segment, group), + a time row, + a
//               residual (read directly, or the partials of a 1x1 conv).
//
// Every sum is taken in a fixed order, so a program repeats bit for bit.

#pragma once

#include "common.cuh"

namespace dadiff {

// One op of the layer program. The field order and sizes are those of
// ChainOp in ops/chain.py (ctypes.Structure).
struct ChainOp {
  const float* xa;           // conv input (or x0 for init)
  const float* xb;           // conv input, second half of a channel concat
  const void* w;             // conv weight, flattened (taps*cin, cout)
  const float* bias;         // bias of the conv whose partials are read
  float* partial;            // conv: partial tiles out; consumers: partials in
  const float* scale;        // GroupNorm scale
  const float* gbias;        // GroupNorm bias
  const float* te;           // GN: time rows, te + step * te_stride +
                             // segment * te_seg_stride
  const float* res;          // GN: residual read directly
  const float* res_partial;  // GN: residual as partials of a 1x1 conv
  const float* res_bias;     // GN: bias of that conv
  float* out;                // GN / init output; step: x in place; conv:
                             // null, or where a tile's last item sums it
  const float* noise;        // step: (T, H, D)
  const float* scal;         // step: (T, 8)
  const float* cond;         // init / step: row-0 conditioning or null
  unsigned int* counters;    // conv with out: one zeroed counter per tile
  int kind, sync_after, rot;
  int cin_a, cin_b, rows_in, seg_in, cout, mode, k, w_bf16, splits;
  int res_splits, te_stride, clip, predict_eps, groups;
  int bm, bn;                // conv: the tile of common.cuh that runs it
  int te_seg_stride;         // GN: te's stride per segment (0: one row)
};

constexpr int kOpConv = 0, kOpGn = 1, kOpStep = 2, kOpInit = 3, kBarrier = 4;
constexpr float kEps = 1e-5f;
constexpr int kStash = kConvSmemBytes / 4;  // floats of the conv ring

__device__ __forceinline__ int first_item(int rot) {
  const int G = gridDim.x;
  return (blockIdx.x + G - rot % G) % G;
}

// The block's threads copy `src` into `dst` (shared memory), a word each;
// the caller synchronises the block before and after.
__device__ __forceinline__ void load_op(const ChainOp* src, ChainOp* dst) {
  constexpr int kWords = sizeof(ChainOp) / sizeof(int);
  static_assert(kWords <= kThreads, "one word per thread");
  if (threadIdx.x < kWords)
    reinterpret_cast<int*>(dst)[threadIdx.x] =
        reinterpret_cast<const int*>(src)[threadIdx.x];
}

template <class Tile>
__device__ inline void conv_items(const ChainOp& op, unsigned char* smem) {
  const int M = op.mode == kDown ? op.rows_in / 2 : op.rows_in;
  const int cin = op.cin_a + op.cin_b;
  const int K = (op.mode == kUp ? 2 : op.k) * cin;
  const int tiles_n = (op.cout + Tile::BN - 1) / Tile::BN;
  const int tiles_m = (M + Tile::BM - 1) / Tile::BM;
  const int parities = op.mode == kUp ? 2 : 1;
  const int k_tiles = (K + BK - 1) / BK;
  const int per_split = (k_tiles + op.splits - 1) / op.splits;
  const int n_items = tiles_n * tiles_m * parities * op.splits;
  const int cout = op.cout;
  const ConvIn c{op.xa,     op.xb,   op.cin_a, op.cin_b, M,
                 op.seg_in, op.cout, op.mode,  op.k};
  for (int item = first_item(op.rot); item < n_items; item += gridDim.x) {
    const int tn = item % tiles_n;
    const int t = item / tiles_n;
    const int tm = t % tiles_m;
    const int z = t / tiles_m;  // parity * splits + split
    const int split = z % op.splits, parity = z / op.splits;
    const int k_begin = split * per_split * BK;
    const int k_end = min(K, k_begin + per_split * BK);
    const int m0 = tm * Tile::BM, n0 = tn * Tile::BN;
    float acc[Tile::ACC];
#pragma unroll
    for (int i = 0; i < Tile::ACC; ++i) acc[i] = 0.f;
    Tile::product(c, (const typename Tile::W*)op.w, parity, m0, n0, k_begin,
                  k_end, smem, acc);
    if (op.out == nullptr) {  // the consumer sums the partial tiles
      float* mine = op.partial + ((size_t)z * M) * cout;
      Tile::pairs(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
        if (m < M && n < cout)
          *reinterpret_cast<float2*>(mine + (size_t)m * cout + n) =
              make_float2(v0, v1);
      });
    } else if (split_k_last<Tile>(
                   acc, op.partial, parity, split, op.splits, M, cout, m0, n0,
                   &op.counters[(parity * tiles_m + tm) * tiles_n + tn])) {
      Tile::pairs(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
        if (m >= M || n >= cout) return;
        const size_t o =
            (size_t)out_row(op.mode, m, parity, op.seg_in) * cout + n;
        *reinterpret_cast<float2*>(op.out + o) =
            make_float2(v0 + op.bias[n], v1 + op.bias[n + 1]);
      });
    }
  }
}

// GroupNorm + Mish of (bias + partials), then + te row of this step and
// segment, + residual (direct, or bias + partials of the 1x1 conv). One block per
// (segment, group), two passes as K1. Where a group fits `stash` (kStash
// floats: always at the U-Net's shapes), the first pass keeps there each
// value, its scale and bias and everything added after the Mish, two values
// per thread with all their loads in flight together, and the second pass
// reads nothing from global memory again.
__device__ inline void gn_items(const ChainOp& op, int step, float* stash,
                                float* red1, float* red2, float* stat) {
  const int C = op.cout, rows = op.rows_in, seg = op.seg_in;
  const int cgp = C / op.groups;
  const int n = seg * cgp;
  const size_t plane = (size_t)rows * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_items = (rows / seg) * op.groups;
  const bool keep = 4 * n <= kStash;
  float* stash_add = stash + n;
  float* stash_scale = stash + 2 * n;
  float* stash_gbias = stash + 3 * n;
  for (int item = first_item(op.rot); item < n_items; item += gridDim.x) {
    const int s = item / op.groups, g = item - s * op.groups;
    const size_t base = (size_t)s * seg * C + (size_t)g * cgp;
    // this step's and this segment's time row
    const float* te_row = op.te == nullptr ? nullptr
                          : op.te + (size_t)step * op.te_stride +
                                (size_t)s * op.te_seg_stride;
    auto index = [&](int i, int& ch) {
      const int r = i / cgp, c = i - r * cgp;
      ch = g * cgp + c;
      return base + (size_t)r * C + c;
    };
    auto addend = [&](size_t idx, int ch) {
      float a = 0.f;
      if (te_row != nullptr) a += __ldcg(te_row + ch);
      if (op.res != nullptr) a += __ldcg(op.res + idx);
      if (op.res_partial != nullptr)
        a += op.res_bias[ch] +
             sum_partials(op.res_partial, op.res_splits, plane, idx);
      return a;
    };
    const bool res_p = op.res_partial != nullptr;
    const int fan_in = max(op.splits, res_p ? op.res_splits : 0);
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < n; i += 2 * kThreads) {
      const int i2 = i + kThreads;
      const bool two = i2 < n;
      int ch1, ch2;
      const size_t idx1 = index(i, ch1), idx2 = index(two ? i2 : i, ch2);
      // everything this pair of values reads crosses L2: start the loads of
      // the addends and of both values' partials, the residual conv's too,
      // before the first sum waits for one of them
      const float b1 = op.bias[ch1], b2 = op.bias[ch2];
      const float sc1 = op.scale[ch1], sc2 = op.scale[ch2];
      const float gb1 = op.gbias[ch1], gb2 = op.gbias[ch2];
      float a1 = 0.f, a2 = 0.f;
      if (te_row != nullptr) {
        a1 = __ldcg(te_row + ch1);
        a2 = __ldcg(te_row + ch2);
      }
      float d1 = 0.f, d2 = 0.f;
      if (op.res != nullptr) {
        d1 = __ldcg(op.res + idx1);
        d2 = __ldcg(op.res + idx2);
      }
      float v1 = 0.f, v2 = 0.f, q1 = 0.f, q2 = 0.f;
      for (int sp = 0; sp < fan_in; sp += kBatch) {
        float m1[kBatch], m2[kBatch], r1[kBatch], r2[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const bool in = sp + b < op.splits;
          const size_t off = (size_t)(sp + b) * plane;
          m1[b] = in ? __ldcg(op.partial + off + idx1) : 0.f;
          m2[b] = in ? __ldcg(op.partial + off + idx2) : 0.f;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const bool in = res_p && sp + b < op.res_splits;
          const size_t off = (size_t)(sp + b) * plane;
          r1[b] = in ? __ldcg(op.res_partial + off + idx1) : 0.f;
          r2[b] = in ? __ldcg(op.res_partial + off + idx2) : 0.f;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          v1 += m1[b];
          v2 += m2[b];
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          q1 += r1[b];
          q2 += r2[b];
        }
      }
      v1 += b1;
      v2 += b2;
      s1 += v1;
      s2 += v1 * v1;
      if (two) {
        s1 += v2;
        s2 += v2 * v2;
      }
      if (keep) {
        stash[i] = v1;
        stash_add[i] = a1 + d1 + (res_p ? op.res_bias[ch1] + q1 : 0.f);
        stash_scale[i] = sc1;
        stash_gbias[i] = gb1;
        if (two) {
          stash[i2] = v2;
          stash_add[i2] = a2 + d2 + (res_p ? op.res_bias[ch2] + q2 : 0.f);
          stash_scale[i2] = sc2;
          stash_gbias[i2] = gb2;
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red1[warp] = s1;
      red2[warp] = s2;
    }
    __syncthreads();
    if (warp == 0) {
      s1 = lane < kThreads / 32 ? red1[lane] : 0.f;
      s2 = lane < kThreads / 32 ? red2[lane] : 0.f;
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        const float mean = s1 / (float)n;
        stat[0] = mean;
        stat[1] = rsqrtf(s2 / (float)n - mean * mean + kEps);
      }
    }
    __syncthreads();
    const float mean = stat[0], rstd = stat[1];
    for (int i = threadIdx.x; i < n; i += kThreads) {
      int ch;
      const size_t idx = index(i, ch);
      // a thread reads back only what it stored itself
      const float v = keep ? stash[i]
                           : op.bias[ch] + sum_partials(op.partial, op.splits,
                                                        plane, idx);
      const float scale = keep ? stash_scale[i] : op.scale[ch];
      const float gbias = keep ? stash_gbias[i] : op.gbias[ch];
      const float y = mish((v - mean) * rstd * scale + gbias);
      op.out[idx] = y + (keep ? stash_add[i] : addend(idx, ch));
    }
    __syncthreads();  // stat, red and stash are reused by the next item
  }
}

}  // namespace dadiff
