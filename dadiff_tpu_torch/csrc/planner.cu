// K2, the planner chain, as a family of kernels driven by a host loop over
// the denoise steps and the U-Net's layer plan (dadiff_tpu_torch/ops/planner.py),
// captured once per set of operands in a CUDA graph and replayed per wave.
//
// Replaces: the JAX package's ops/pallas_planner.py:95 make_pallas_planner_chain
// (inner kernel :206, _project :156, _apply_cond :152) and the U-Net body it
// runs, ops/pallas_unet.py:258 _unet_forward with _conv_stack
// :184, _shift_rows :161, _even_rows :243, _interleave_rows :248 and the
// GroupNorm+Mish stage _group_norm_mish :198 with the adds res_block fuses
// around it (:281-293).
//
//   rows_conv          one conv of the U-Net as an implicit shifted-stack
//                      GEMM over row-stacked chains: k-tap SAME (k = 5 or 1),
//                      k=3 stride 2 (even rows only), or the k=4 s=2
//                      transposed conv as even/odd two-tap products. Zero
//                      padding applies per segment (chain), so N stacked
//                      chains equal N separate forwards.
//   rows_conv_gn       a SAME conv with GroupNorm(8) + affine + Mish (+ a
//                      time row per segment, + a residual) in its epilogue:
//                      every GroupNorm of the chain, in the launch of the
//                      conv that feeds it (below).
//   ddpm_project_step  one block per trajectory row, all chains at once: DDPM
//                      update from scal[t], the interleaved projection
//                      alpha*(x@M+b)+(1-alpha)*x, the wall revert and the
//                      row-0 conditioning, from x into a second buffer.
//
// Bound on an H100 (flagship: 8 chains x 32 rows, dim 128, mults 1 2 4;
// the times below are chip_smoke.py's on an NVIDIA H100 80GB HBM3, 700 W):
// one denoise step of the 8-chain wave is ~2.3 GFLOP of products over
// ~31.7 MB of bf16 weights, i.e. ~74 operations per weight byte, well
// under the ~295 the card needs to be compute-bound: the least time is
// ~2.4 us of tensor-core work and ~9.5 us of weight streaming from HBM per
// step. What a step really costs is its dependent launches (36: 10
// rows_conv, 25 rows_conv_gn, one step) whose GEMMs are 64-256 rows by
// 8-512 columns: each is bound by the latency of its K loop and by L2, not
// by the tensor cores, and none can go under the ~3 us a dependent launch
// costs in a graph. Three tiles serve the convs, chosen by ops/planner.py
// _split_k from the launch's shape alone (GEMM rows, cout, K):
// - the tile product of common.cuh (mma.sync on bf16, cp.async ring,
//   hoisted row arithmetic), smallest tile first, 16 x 64, with K split
//   over blocks (_want_splits) that meet through global partial planes and
//   an arrival counter (split_k_last of common.cuh, in split order): the
//   convs with little work (K of 1-3 K tiles of 64, few output tiles), the
//   first conv (cin 8: K = 40, less than one K tile) and the final 128 -> 8
//   conv;
// - ClusterTile of wgmma.cuh (rows_conv_cl, rows_conv_gn_cl below) for the
//   rest of the served waves, 8-64 chains: a 64 x 128 wgmma tile whose K
//   splits are the 1-8 blocks of one thread-block cluster and meet in
//   distributed shared memory (cl_conv). At 64 chains (512-2,048 rows, 18.6
//   GFLOP a step: 18.8 us of tensor-core work) the 16 x 64 tiles ran
//   640-768 blocks in three rounds, each walking up to 27 serial K tiles of
//   32, and re-read every weight from L2 32-128 times (1.16 GB a step); on
//   the card (sweep_kernels conv --chains 64) the step's 35 convs took
//   0.741 ms bare and its 25 fused pairs 0.906 ms there, and 0.302 / 0.317
//   ms on the cluster tile;
// - at the on-device evaluator's 1,024-chain wave (8,192-32,768 rows) a
//   step is 0.298 TFLOP, whose least time is set by the bytes (~0.40 ms:
//   f32 activations in and out) and the tensor cores (0.30 ms), and the
//   mma.sync tiles, whose every thread gathers A by cp.async, ran at 7-8%
//   of the bf16 peak: there rows_conv and rows_conv_gn run on WgTile of
//   wgmma.cuh (rows_conv_wg, rows_conv_gn_wg below): 128-row tiles, one
//   producer warpgroup issuing TMA for both operands, two consumer
//   warpgroups on wgmma, no split-K (one split won at every conv of that
//   wave in sweep_kernels conv --chains 1024), from the point where the
//   largest mma.sync tile, 64 x 128, would leave more blocks than the card
//   has SMs.
// Every split-K sum is taken in split order, so a replayed wave equals a
// host-driven one bit for bit.
//
// rows_conv_gn. A standalone GroupNorm+Mish (K1, gn_mish.cu) moves 128 KB
// each way per call at these shapes, ~0.08 us at 3.35 TB/s, and takes
// ~2.7 us: the launch, not the work. Its bound inside the conv is the conv's
// operations plus K1's bytes (scale, bias, time row and residual read once),
// so the only lever is the launch, and the GroupNorm goes where the TPU
// kernel computes it, after the conv in the same kernel. Statistics are per
// (segment, group) and a conv tile is smaller than that at the top level
// (a 32-row segment over two 16 x 64 tiles) or holds several (two 8-row
// segments), so the tiles that share a (segment, group) meet in a "group
// block": the aligned rectangle of lcm(seg, bm) rows by lcm(C/8, bn)
// columns, capped at the conv's size (at most 2 x 2 tiles at the flagship).
// Every block of a group block (its tiles times the K splits) stores its
// share of the conv into its K split's plane and counts its arrival on the
// group block's counter; the last to arrive adds every tile's splits in
// split order into shared memory (so the result does not depend on which
// block that is, and a replayed wave equals a host-driven one bit for bit),
// takes each pair's sum x and sum x^2 there in a fixed order, mean and
// var = E[x^2] - mean^2 with eps as gn_mish.cu and the TPU do, and
// normalises: affine, Mish, + te[segment], + res. A group block of one tile
// and one split touches no other block's data. One arrival per group block
// and not two (split_k_last per tile, then the tiles' sums per group
// block): on the card the two dependent round trips cost more than the
// separate K1 launch they replace. The plan of group blocks is written
// once, ops/conv_tiling.py group_plan, which the CPU tests walk. On a
// wgmma tile (128 rows, a multiple of every segment; 128 columns, a
// multiple of every group) the group block is the tile and its only block:
// no partial planes, no counters, no arrival; the statistics come from the
// accumulators in registers (wg_gn_epilogue). On the cluster tile (64
// rows, a multiple of every segment at the served levels; 128 columns)
// the group block is the tile too, and its K splits are the cluster's
// blocks: each adds the splits' partial tiles for its own 8-row pieces,
// takes their sums x and x^2 per group, and reads the other pieces' sums
// of its segments from the blocks that own them (cl_conv).
//
// ddpm_project_step. The step is ~0.5 MFLOP over a 256 KB M, a 0.09 us
// bound; one block per chain (8 blocks, each walking a dependent 256-long
// FMA chain per thread and reading all of M from L2) took 26 us. Here one
// block owns trajectory row h, all D lanes of it, so the wall revert stays
// inside the block, for every chain: it computes the DDPM-updated x of 8
// chains at a time (8 x H*D floats) in shared memory, reads its H*D x D
// slice of M once for all chains (all of a thread's loads started
// together), and each warp computes one chain's D outputs of row h as
// lane-split dot products (a lane loads each x once for 8 outputs) with a
// shuffle reduce: 32 blocks at the flagship. Every block reads every chain's x while others
// write theirs, so the step writes into a second buffer: the wave
// ping-pongs between two fixed buffers (ops/planner.py _CudaOps.step).

#include <cooperative_groups.h>

#include "wgmma.cuh"

namespace {

using namespace dadiff;

// The GroupNorm+Mish epilogue of rows_conv_gn and its group-block plan
// (ops/conv_tiling.py group_plan).
struct GnEpi {
  const float* scale;  // (cout,)
  const float* gbias;  // (cout,)
  const float* te;     // a row of cout per segment at te_stride, or null
  const float* res;    // (M, cout), or null
  int te_stride;
  int cg;              // channels per group: cout / 8
  int gtm, gtn;        // tiles per group block along rows and columns
  int ns, ng;          // segments and groups per group block
  float eps;
  unsigned int* counters;  // one per group block, zero, left zero
};

// a / b for 0 <= a < 2^22 and b >= 1 through the float reciprocal of b
// (exact there: the error of (a + 0.5) * (1 / b) stays under 0.5 / b)
__device__ __forceinline__ int div_small(int a, float inv_b) {
  return (int)(((float)a + 0.5f) * inv_b);
}

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

// Column pairs a thread of the last block sums over the K splits per batch:
// 4 x 8 float2 loads in flight.
constexpr int kSumBatch = 4;

// Mish as y * n / (n + 2) with n = e^y (e^y + 2), which is y * tanh(softplus
// y) with one exponential; softplus's threshold of 20 as mish() has it
// (tanh(y) rounds to 1 there). Without a branch: above the threshold the
// exponential of 20 is taken and its quotient dropped, so every value is
// the one a branch would give, and the epilogues' many values interleave.
__device__ __forceinline__ float mish_epi(float y) {
  const float e = __expf(fminf(y, 20.f));
  const float n = e * (e + 2.f);
  const float m = __fdividef(y * n, n + 2.f);
  return y > 20.f ? y : m;
}

// The normalisation of one (segment, group) pair, written once for both
// GroupNorm epilogues: mean and rstd from the pair's sum x and sum x^2 over
// n_el values (var = E[x^2] - mean^2, eps inside the root, as gn_mish.cu and
// the TPU take them), then one value: affine, Mish, + add.
__device__ __forceinline__ float2 gn_stat(float t1, float t2, float n_el,
                                          float eps) {
  const float mean = t1 / n_el;
  return make_float2(mean, rsqrtf(t2 / n_el - mean * mean + eps));
}
__device__ __forceinline__ float gn_apply(float x, float2 st, float sc,
                                          float sh, float add) {
  return mish_epi((x - st.x) * st.y * sc + sh) + add;
}

// The tile's share of the conv is in acc. Every block of a group block (its
// tiles times the K splits) stores its share and counts its arrival; the
// last to arrive sums every tile's splits in split order into shared
// memory, takes the statistics of each (segment, group) pair there and
// normalises the group block: affine, Mish, + te[segment], + res. A group
// block of one tile and one split needs no other block. The operands of the
// normalisation (bias, scale, shift, time rows, residual) travel to shared
// memory by cp.async while the sums are taken.
template <class Tile>
__device__ __forceinline__ void gn_epilogue(float (&acc)[Tile::ACC],
                                            const ConvIn& c,
                                            const float* __restrict__ bias,
                                            float* __restrict__ out,
                                            int splits,
                                            float* __restrict__ partial,
                                            const GnEpi& g,
                                            unsigned char* smem) {
  const int M = c.M, cout = c.cout, seg = c.seg_in;
  const int split = blockIdx.z, tm = blockIdx.y, tn = blockIdx.x;
  const int m0 = tm * Tile::BM, n0 = tn * Tile::BN;
  const int gbm = tm / g.gtm, gbn = tn / g.gtn;
  const int gb = gbm * ((gridDim.x + g.gtn - 1) / g.gtn) + gbn;
  const int gm0 = gbm * g.gtm * Tile::BM, gn0 = gbn * g.gtn * Tile::BN;
  const int gr = min(g.gtm * Tile::BM, M - gm0);   // rows of the group block
  const int gc = min(g.gtn * Tile::BN, cout - gn0);  // and columns (% 8 == 0)
  const int gc2 = gc / 2, total = gr * gc2;        // column pairs
  const float inv_gc2 = 1.f / (float)gc2, inv_seg = 1.f / (float)seg;
  const float inv_cg = 1.f / (float)g.cg;
  const int arrivals = min(g.gtm, (int)gridDim.y - gbm * g.gtm) *
                       min(g.gtn, (int)gridDim.x - gbn * g.gtn) * splits;
  const int P = g.ns * g.ng;

  // shared memory (gn_smem_bytes): the group block's values before the
  // bias [rows][ld], the pairs' statistics, then the staged operands: bias,
  // scale and shift [ld], the time rows [ns][ld], and the residual
  // [rows][ld] where it fits
  const int ld = g.gtn * Tile::BN, rows = g.gtm * Tile::BM;
  float* gv = reinterpret_cast<float*>(smem);
  float2* stat = reinterpret_cast<float2*>(gv + rows * ld);
  float* b_s = reinterpret_cast<float*>(stat + (P + 1) / 2 * 2);  // 16 B
  float* sc_s = b_s + ld;
  float* sh_s = sc_s + ld;
  float* te_s = sh_s + ld;
  float* res_s = reinterpret_cast<float*>(
      (reinterpret_cast<size_t>(te_s + (g.te != nullptr ? g.ns * ld : 0)) +
       15) & ~(size_t)15);  // 16-byte copies
  const bool res_staged =
      g.res != nullptr &&
      (unsigned char*)(res_s + rows * ld) <= smem + kConvSmemBytes;
  auto stage = [&]() {
    for (int i = threadIdx.x; i < gc; i += kThreads) {
      cp_async4(b_s + i, bias + gn0 + i);
      cp_async4(sc_s + i, g.scale + gn0 + i);
      cp_async4(sh_s + i, g.gbias + gn0 + i);
    }
    if (g.te != nullptr) {
      const float inv_gc = 1.f / (float)gc;
      const int s_last = M / seg - 1;
      for (int i = threadIdx.x; i < g.ns * gc; i += kThreads) {
        const int sl = div_small(i, inv_gc), cc = i - sl * gc;
        const int s = min(div_small(gm0, inv_seg) + sl, s_last);
        cp_async4(te_s + sl * ld + cc, g.te + (size_t)s * g.te_stride + gn0 + cc);
      }
    }
    if (res_staged) {
      const int gc4 = gc / 4;
      const float inv_gc4 = 1.f / (float)gc4;
      for (int i = threadIdx.x; i < gr * gc4; i += kThreads) {
        const int r = div_small(i, inv_gc4), c4 = 4 * (i - r * gc4);
        cp_async16(res_s + r * ld + c4,
                   g.res + (size_t)(gm0 + r) * cout + gn0 + c4);
      }
    }
    cp_async_commit();
  };

  if (arrivals == 1) {
    // the tile is the group block and its only block: into shared memory
    stage();
    Tile::pairs(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
      const bool in = m < M && n < cout;
      *reinterpret_cast<float2*>(gv + (m - m0) * ld + (n - n0)) =
          in ? make_float2(v0, v1) : make_float2(0.f, 0.f);
    });
  } else {
    // 1. this block's share into its plane (K split), then arrive
    float* plane0 = splits > 1 ? partial : out;
    const size_t plane = (size_t)M * cout;
    float* mine = plane0 + (size_t)split * plane;
    Tile::pairs(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
      if (m < M && n < cout)
        *reinterpret_cast<float2*>(mine + (size_t)m * cout + n) =
            make_float2(v0, v1);
    });
    __threadfence();
    __syncthreads();
    __shared__ bool last;
    if (threadIdx.x == 0)
      last = atomicAdd(&g.counters[gb], 1u) == (unsigned)arrivals - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    stage();
    // 2. the group block: every tile's K splits added in split order (as
    // split_k_last adds them) into shared memory; the loads of kSumBatch
    // column pairs times 8 splits started together
    for (int base = threadIdx.x; base < total; base += kThreads * kSumBatch) {
      float2 sum[kSumBatch];
      size_t at[kSumBatch];
#pragma unroll
      for (int j = 0; j < kSumBatch; ++j) {
        const int i = min(base + j * kThreads, total - 1);
        const int r = div_small(i, inv_gc2);
        at[j] = (size_t)(gm0 + r) * cout + gn0 + 2 * (i - r * gc2);
        sum[j] = make_float2(0.f, 0.f);
      }
      for (int sp0 = 0; sp0 < splits; sp0 += 8) {
        float2 v[kSumBatch][8];
#pragma unroll
        for (int j = 0; j < kSumBatch; ++j)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[j][q] = base + j * kThreads < total && sp0 + q < splits
                          ? __ldcg(reinterpret_cast<const float2*>(
                                plane0 + (size_t)(sp0 + q) * plane + at[j]))
                          : make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < kSumBatch; ++j)
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            sum[j].x += v[j][q].x;
            sum[j].y += v[j][q].y;
          }
      }
#pragma unroll
      for (int j = 0; j < kSumBatch; ++j) {
        const int i = base + j * kThreads;
        if (i >= total) continue;
        const int r = div_small(i, inv_gc2), cc = 2 * (i - r * gc2);
        *reinterpret_cast<float2*>(gv + r * ld + cc) = sum[j];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's sums and staged operands landed

  // 3. sum x and sum x^2 of each (segment, group) pair, x the value plus
  // its bias: a pair gets wpp of the 8 warps, whose lanes take its elements
  // (four at a time where a group's channels allow) in a fixed order; a
  // shuffle tree adds a warp's lanes, then the pair's warps are added in
  // order
  __shared__ float2 red[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpp = P < kThreads / 32 ? (kThreads / 32) / P : 1;
  const int per_round = (kThreads / 32) / wpp;
  const float n_el = (float)(seg * g.cg);
  const bool quads = (g.cg & 3) == 0;
  for (int p0 = 0; p0 < P; p0 += per_round) {
    const int p = p0 + warp / wpp, part = warp % wpp;
    float s1 = 0.f, s2 = 0.f;
    if (warp / wpp < per_round && p < P) {
      const int sl = p / g.ng, gl = p - sl * g.ng;
      const int r0 = sl * seg, r1 = min(r0 + seg, gr);
      const int c0 = gl * g.cg, c1 = min(c0 + g.cg, gc);
      if (r1 > r0 && c1 > c0) {
        const int wq = quads ? (c1 - c0) / 4 : c1 - c0;
        const float inv_wq = 1.f / (float)wq;
        for (int u = part * 32 + lane; u < (r1 - r0) * wq; u += 32 * wpp) {
          const int r = div_small(u, inv_wq), q = u - r * wq;
          const float* at = gv + (r0 + r) * ld + c0;
          if (quads) {
            float4 x = *reinterpret_cast<const float4*>(at + 4 * q);
            const float4 b = *reinterpret_cast<const float4*>(b_s + c0 + 4 * q);
            x = make_float4(x.x + b.x, x.y + b.y, x.z + b.z, x.w + b.w);
            s1 += (x.x + x.y) + (x.z + x.w);
            s2 = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, s2))));
          } else {
            const float x = at[q] + b_s[c0 + q];
            s1 += x;
            s2 = fmaf(x, x, s2);
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_down_sync(0xffffffffu, s1, o);
      s2 += __shfl_down_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) red[warp] = make_float2(s1, s2);
    __syncthreads();
    if ((int)threadIdx.x < per_round && p0 + (int)threadIdx.x < P) {
      float t1 = 0.f, t2 = 0.f;
      for (int k = 0; k < wpp; ++k) {
        t1 += red[threadIdx.x * wpp + k].x;
        t2 += red[threadIdx.x * wpp + k].y;
      }
      stat[p0 + threadIdx.x] = gn_stat(t1, t2, n_el, g.eps);
    }
    __syncthreads();
  }
  // 4. normalise: affine, Mish, + te, + res
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = div_small(i, inv_gc2), cc = 2 * (i - r * gc2);
    const int sl = div_small(r, inv_seg);
    float2 x = *reinterpret_cast<const float2*>(gv + r * ld + cc);
    const float2 b = *reinterpret_cast<const float2*>(b_s + cc);
    x.x += b.x;
    x.y += b.y;
    const float2 s0 = stat[sl * g.ng + div_small(cc, inv_cg)];
    const float2 s1 =
        (g.cg & 1) ? stat[sl * g.ng + div_small(cc + 1, inv_cg)] : s0;
    const float2 sc = *reinterpret_cast<const float2*>(sc_s + cc);
    const float2 sh = *reinterpret_cast<const float2*>(sh_s + cc);
    float2 add = make_float2(0.f, 0.f);
    if (g.te != nullptr)
      add = *reinterpret_cast<const float2*>(te_s + sl * ld + cc);
    if (g.res != nullptr) {
      const float2 q =
          res_staged ? *reinterpret_cast<const float2*>(res_s + r * ld + cc)
                     : *reinterpret_cast<const float2*>(
                           g.res + (size_t)(gm0 + r) * cout + gn0 + cc);
      add.x += q.x;
      add.y += q.y;
    }
    *reinterpret_cast<float2*>(out + (size_t)(gm0 + r) * cout + gn0 + cc) =
        make_float2(gn_apply(x.x, s0, sc.x, sh.x, add.x),
                    gn_apply(x.y, s1, sc.y, sh.y, add.y));
  }
  if (arrivals > 1 && threadIdx.x == 0) g.counters[gb] = 0u;  // next conv
}

// out[out_row(m)] = bias + sum_{j, ci} x[in_row(m, j), ci] * w[wtap(j)*cin + ci],
// or with kGn the GroupNorm+Mish epilogue above. One block per (output
// tile, parity, K split); the tile product is Tile::product of common.cuh.
template <class Tile, bool kGn>
__global__ void __launch_bounds__(kThreads, 2)
rows_conv_kernel(ConvIn c, const typename Tile::W* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int splits, float* __restrict__ partial,
                 unsigned int* __restrict__ counters, GnEpi gn) {
  const int cin = c.cin_a + c.cin_b;
  const int K = (c.mode == kUp ? 2 : c.k) * cin;
  const int split = blockIdx.z % splits;
  const int parity = blockIdx.z / splits;
  const int m0 = blockIdx.y * Tile::BM, n0 = blockIdx.x * Tile::BN;
  // this block's share of the K loop (split-K: see the reduction below)
  const int k_tiles = (K + BK - 1) / BK;
  const int per_split = (k_tiles + splits - 1) / splits;
  const int k_begin = split * per_split * BK;
  const int k_end = min(K, k_begin + per_split * BK);

  __shared__ __align__(128) unsigned char smem[kConvSmemBytes];

  float acc[Tile::ACC];
#pragma unroll
  for (int i = 0; i < Tile::ACC; ++i) acc[i] = 0.f;
  Tile::product(c, w, parity, m0, n0, k_begin, k_end, smem, acc);

  if constexpr (kGn) {
    gn_epilogue<Tile>(acc, c, bias, out, splits, partial, gn, smem);
    return;
  }
  const int M = c.M, cout = c.cout;
  if (splits > 1) {
    // every block stores its partial tile; the last of a tile to arrive
    // holds their sum, in split order (split_k_last of common.cuh)
    const int tile = (parity * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (!split_k_last<Tile>(acc, partial, parity, split, splits, M, cout, m0,
                            n0, &counters[tile]))
      return;
  }
  Tile::pairs(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
    if (m >= M || n >= cout) return;
    const size_t o = (size_t)out_row(c.mode, m, parity, c.seg_in) * cout + n;
    *reinterpret_cast<float2*>(out + o) =
        make_float2(v0 + bias[n], v1 + bias[n + 1]);
  });
}

// The per-column operands of rows_conv_gn's epilogue on a wgmma tile
// (bias, scale, shift) and its time rows, staged into shared memory by the
// consumers before the K loop, so that the epilogue reads no global memory
// but the residual tile, which TMA brings meanwhile.
template <class Tile>
__device__ __forceinline__ void wg_gn_stage(const ConvIn& c,
                                            const float* __restrict__ bias,
                                            const GnEpi& g,
                                            const typename Tile::Smem& s,
                                            int m0, int n0) {
  constexpr int BN = Tile::BN;
  const int n_seg = min(Tile::BM, c.M - m0) / c.seg_in;
  const int te_rows = g.te == nullptr ? 0 : (g.te_stride == 0 ? 1 : n_seg);
  for (int i = threadIdx.x; i < (3 + te_rows) * BN; i += Tile::kConsumers) {
    const int r = i / BN, j = i - r * BN, n = n0 + j;
    float v = 0.f;
    if (n < c.cout) {
      if (r == 0)
        v = bias[n];
      else if (r == 1)
        v = g.scale[n];
      else if (r == 2)
        v = g.gbias[n];
      else
        v = g.te[(size_t)(m0 / c.seg_in + r - 3) * g.te_stride + n];
    }
    s.par[i] = v;  // par, then te: one array
  }
  ConsumerSync()();
}

// The GroupNorm+Mish epilogue of rows_conv_gn on a wgmma tile. The tile
// holds whole (segment, group) pairs (segments of 8-128 rows that divide
// 128, groups of a multiple of 8 channels that divide 128 or span all of
// cout: ops/conv_tiling.py wg_gn_fits), so it needs no other block: no
// partial planes, no counter, no arrival. x = acc + bias in registers;
// each warp sums x and x^2 of each (8-row piece, group) it holds, its lanes
// in column order and a shuffle tree over the lanes; the consumers meet once
// (named barrier) and a pair adds its pieces in row order; then each thread
// normalises its own values: affine, Mish, + te[segment], + res (from the
// residual tile in shared memory). Every sum is taken in a fixed order.
template <class Tile>
__device__ __forceinline__ void wg_gn_epilogue(float (&acc)[Tile::ACC],
                                               const ConvIn& c,
                                               float* __restrict__ out,
                                               const GnEpi& g,
                                               const typename Tile::Smem& s) {
  constexpr int BN = Tile::BN, G = Tile::kMaxGroups;
  const int M = c.M, cout = c.cout, seg = c.seg_in;
  const int m0 = blockIdx.y * Tile::BM, n0 = blockIdx.x * BN;
  const int ct = threadIdx.x, lane = ct & 31, t = lane & 3;
  const int r_lo = (ct >> 7) * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
  const int piece = r_lo >> 3;  // row r_lo + 8 lies in piece + 1
  const int cgc = g.cg / 8;     // 8-column chunks per group
  const int ng = min(BN, cout - n0) / g.cg;  // groups of the tile
  const bool in_row[2] = {m0 + r_lo < M, m0 + r_lo + 8 < M};
  const float* sc = s.par + BN;
  const float* sh = s.par + 2 * BN;
  ConsumerSync sync;

  // 1. x = acc + bias; sums per (8-row piece, group)
  float q[4] = {0.f, 0.f, 0.f, 0.f};  // rows r_lo: x, x^2; r_lo + 8: x, x^2
#pragma unroll
  for (int i = 0; i < Tile::NI; ++i) {
    const float2 b = *reinterpret_cast<const float2*>(s.par + 8 * i + 2 * t);
    float* v = acc + 4 * i;
    v[0] += b.x;
    v[1] += b.y;
    v[2] += b.x;
    v[3] += b.y;
    if (in_row[0]) {
      q[0] += v[0] + v[1];
      q[1] = fmaf(v[0], v[0], fmaf(v[1], v[1], q[1]));
    }
    if (in_row[1]) {
      q[2] += v[2] + v[3];
      q[3] = fmaf(v[2], v[2], fmaf(v[3], v[3], q[3]));
    }
    if ((i + 1) % cgc == 0) {  // the last chunk of group i / cgc
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          q[u] += __shfl_xor_sync(0xffffffffu, q[u], o);
      const int gl = i / cgc;
      if (lane == 0 && gl < ng) {
        s.red[piece * G + gl] = make_float2(q[0], q[1]);
        s.red[(piece + 1) * G + gl] = make_float2(q[2], q[3]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u] = 0.f;
    }
  }
  sync();
  // 2. each pair's statistics: its pieces added in row order
  const int n_seg = (min(Tile::BM, M - m0) + seg - 1) / seg;
  const float n_el = (float)(seg * g.cg);
  for (int p = ct; p < n_seg * ng; p += Tile::kConsumers) {
    const int sl = p / ng, gl = p - sl * ng;
    float t1 = 0.f, t2 = 0.f;
    for (int u = sl * seg / 8; u < (sl + 1) * seg / 8; ++u) {
      t1 += s.red[u * G + gl].x;
      t2 += s.red[u * G + gl].y;
    }
    s.stat[p] = gn_stat(t1, t2, n_el, g.eps);
  }
  sync();
  // 3. normalise this thread's values
  if (g.res != nullptr) mbar_wait(s.resbar, 0);
  const int te_seg = g.te_stride == 0 ? 0 : 1;  // time row per segment?
#pragma unroll
  for (int i = 0; i < Tile::NI; ++i) {
    const int j = 8 * i + 2 * t, n = n0 + j;
    if (n >= cout) continue;
    const int gl = i / cgc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h, m = m0 + r;
      if (!in_row[h]) continue;
      const int sl = r / seg;
      const float2 st = s.stat[sl * ng + gl];
      float2 add = make_float2(0.f, 0.f);
      if (g.te != nullptr)
        add = *reinterpret_cast<const float2*>(s.te + te_seg * sl * BN + j);
      if (g.res != nullptr) {
        const float2 rv =
            *reinterpret_cast<const float2*>(s.res + Tile::res_at(r, j));
        add.x += rv.x;
        add.y += rv.y;
      }
      *reinterpret_cast<float2*>(out + (size_t)m * cout + n) = make_float2(
          gn_apply(acc[4 * i + 2 * h], st, sc[j], sh[j], add.x),
          gn_apply(acc[4 * i + 2 * h + 1], st, sc[j + 1], sh[j + 1], add.y));
    }
  }
}

// rows_conv_wg_kernel on a ClusterTile (wgmma.cuh): the K loop, then the K
// splits of the output tile, the blocks of one cluster (rank = split), meet
// through distributed shared memory. Block r owns whole 8-row pieces of the
// tile, ceil(8 / splits) of them, and adds for each of its values the
// splits' partial tiles in split order (the sum split_k_last takes), then
// the bias; bare, it stores them. With kGn it sums x and x^2 per (8-row
// piece, group) of its rows, the cluster meets again, and it takes the
// statistics of each (segment, group) pair its rows touch from the pieces'
// sums added in row order (those of wg_gn_epilogue, read from the blocks
// that own them), then normalises its rows: affine, Mish, + te[segment], +
// res. Nothing but the output goes to global memory, no counter is used,
// and every sum is taken in a fixed order, so a replayed wave equals a
// host-driven one bit for bit.
template <class Tile, bool kGn>
__device__ __forceinline__ void cl_conv(const ConvIn& c,
                                        const CUtensorMap* wmap,
                                        const ActMaps& am,
                                        const float* __restrict__ bias,
                                        float* __restrict__ out, int parity,
                                        int split, int splits, int m0, int n0,
                                        int k_begin, int k_end, const GnEpi& g,
                                        const typename Tile::Smem& s) {
  namespace cgr = cooperative_groups;
  constexpr int BM = Tile::BM, BN = Tile::BN, LDP = Tile::LDP, C4 = BN / 4;
  constexpr int G = Tile::kMaxGroups, S_MAX = Tile::kMaxSplits;
  constexpr int kWarps = Tile::kThreads / 32;
  cgr::cluster_group cluster = cgr::this_cluster();
  const int M = c.M, cout = c.cout;

  float acc[Tile::ACC];
#pragma unroll
  for (int i = 0; i < Tile::ACC; ++i) acc[i] = 0.f;
  if (threadIdx.x >= Tile::kConsumers) {
    Tile::produce(c, wmap, am, parity, m0, n0, k_begin, k_end, s);
    __syncwarp();
  } else {
    Tile::consume((k_end - k_begin + Tile::BK - 1) / Tile::BK, s, acc);
  }
  __syncthreads();  // the K loop is done: the ring takes the partial tile
  float* part = reinterpret_cast<float*>(s.ring);
  if (threadIdx.x < Tile::kConsumers)
    Tile::pairs(acc, 0, 0, [&](int m, int n, float& v0, float& v1) {
      *reinterpret_cast<float2*>(part + m * LDP + n) = make_float2(v0, v1);
    });
  cluster.sync();  // every split's partial tile

  // this block's rows [r0, r1): the split sums, + bias
  const int per = (BM / 8 + splits - 1) / splits;  // pieces a block
  const int r0 = min(BM, split * per * 8), r1 = min(BM, r0 + per * 8);
  const float* peer[S_MAX];
#pragma unroll
  for (int q = 0; q < S_MAX; ++q)
    peer[q] = q < splits ? cluster.map_shared_rank(part, q) : part;
  for (int i = threadIdx.x; i < (r1 - r0) * C4; i += Tile::kThreads) {
    const int r = r0 + i / C4, j = 4 * (i % C4), n = n0 + j, m = m0 + r;
    float4 v[S_MAX];
#pragma unroll
    for (int q = 0; q < S_MAX; ++q)  // the splits' loads in flight together
      if (q < splits)
        v[q] = *reinterpret_cast<const float4*>(peer[q] + r * LDP + j);
    float4 x = v[0];
#pragma unroll
    for (int q = 1; q < S_MAX; ++q)
      if (q < splits) {
        x.x += v[q].x;
        x.y += v[q].y;
        x.z += v[q].z;
        x.w += v[q].w;
      }
    if (n < cout) {
      const float4 b = *reinterpret_cast<const float4*>(bias + n);
      x = make_float4(x.x + b.x, x.y + b.y, x.z + b.z, x.w + b.w);
    }
    if constexpr (kGn)
      *reinterpret_cast<float4*>(part + r * LDP + j) = x;  // no peer reads it
    else if (m < M && n < cout)
      *reinterpret_cast<float4*>(
          out + (size_t)out_row(c.mode, m, parity, c.seg_in) * cout + n) = x;
  }

  if constexpr (kGn) {
    __syncthreads();  // this block's rows of x
    // sums of x and x^2 per (8-row piece, group) of its rows: a warp a
    // pair, its lanes over the piece's float4s in order, a shuffle tree
    const int cg = g.cg, ng = min(BN, cout - n0) / cg, qr = cg / 4;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int p = warp; p < (r1 - r0) / 8 * ng; p += kWarps) {
      const int u = r0 / 8 + p / ng, gl = p % ng;
      float s1 = 0.f, s2 = 0.f;
      for (int it = lane; it < 8 * qr; it += 32) {
        const int r = 8 * u + it / qr, q = it % qr;
        const float4 x =
            *reinterpret_cast<const float4*>(part + r * LDP + gl * cg + 4 * q);
        s1 += (x.x + x.y) + (x.z + x.w);
        s2 = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, s2))));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (lane == 0) s.red[u * G + gl] = make_float2(s1, s2);
    }
    cluster.sync();  // every piece's sums
    // the statistics of the pairs this block's rows touch: each pair's
    // pieces added in row order, from the blocks that own them
    const int seg = c.seg_in, pieces = seg / 8;
    const int sl0 = r0 / seg, n_sl = r1 > r0 ? (r1 - 1) / seg + 1 - sl0 : 0;
    const float n_el = (float)(seg * cg);
    for (int p = threadIdx.x; p < n_sl * ng; p += Tile::kThreads) {
      const int sl = sl0 + p / ng, gl = p % ng;
      float t1 = 0.f, t2 = 0.f;
      for (int u = sl * pieces; u < (sl + 1) * pieces; ++u) {
        const float2 v = cluster.map_shared_rank(s.red, u / per)[u * G + gl];
        t1 += v.x;
        t2 += v.y;
      }
      s.stat[sl * G + gl] = gn_stat(t1, t2, n_el, g.eps);
    }
    __syncthreads();
    // normalise this block's rows
    for (int i = threadIdx.x; i < (r1 - r0) * C4; i += Tile::kThreads) {
      const int r = r0 + i / C4, j = 4 * (i % C4), n = n0 + j, m = m0 + r;
      if (m >= M || n >= cout) continue;
      const float2 st = s.stat[(r / seg) * G + j / cg];
      const float4 x = *reinterpret_cast<const float4*>(part + r * LDP + j);
      const float4 sc = *reinterpret_cast<const float4*>(g.scale + n);
      const float4 sh = *reinterpret_cast<const float4*>(g.gbias + n);
      float4 add = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g.te != nullptr)
        add = *reinterpret_cast<const float4*>(
            g.te + (size_t)(m / seg) * g.te_stride + n);
      if (g.res != nullptr) {
        const float4 q =
            *reinterpret_cast<const float4*>(g.res + (size_t)m * cout + n);
        add = make_float4(add.x + q.x, add.y + q.y, add.z + q.z, add.w + q.w);
      }
      *reinterpret_cast<float4*>(out + (size_t)m * cout + n) = make_float4(
          gn_apply(x.x, st, sc.x, sh.x, add.x),
          gn_apply(x.y, st, sc.y, sh.y, add.y),
          gn_apply(x.z, st, sc.z, sh.z, add.z),
          gn_apply(x.w, st, sc.w, sh.w, add.w));
    }
  }
  cluster.sync();  // no peer reads this block's shared memory any more
}

// rows_conv_kernel on a wgmma tile (wgmma.cuh). WgTile: warpgroup 2 loads,
// 0 and 1 multiply and run the epilogue; one block per (output tile,
// parity, K split). ClusterTile: cl_conv, one cluster per (output tile,
// parity), a block per K split. The weights come through the tensor map
// `wmap`.
template <class Tile, bool kGn>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
rows_conv_wg_kernel(ConvIn c, const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ ActMaps amaps,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int splits, float* __restrict__ partial,
                    unsigned int* __restrict__ counters, GnEpi gn) {
  extern __shared__ unsigned char wg_smem[];
  const typename Tile::Smem s = Tile::carve(wg_smem);
  const int cin = c.cin_a + c.cin_b;
  const int K = (c.mode == kUp ? 2 : c.k) * cin;
  const int split = blockIdx.z % splits;
  const int parity = blockIdx.z / splits;
  const int m0 = blockIdx.y * Tile::BM, n0 = blockIdx.x * Tile::BN;
  const int k_tiles = (K + Tile::BK - 1) / Tile::BK;
  const int per_split = (k_tiles + splits - 1) / splits;
  const int k_begin = split * per_split * Tile::BK;
  const int k_end = min(K, k_begin + per_split * Tile::BK);

  Tile::setup(c, m0, amaps.tma, s);
  if constexpr (Tile::kCluster) {
    cl_conv<Tile, kGn>(c, &wmap, amaps, bias, out, parity, split, splits, m0,
                       n0, k_begin, k_end, gn, s);
  } else {
    if (threadIdx.x >= Tile::kConsumers) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          Tile::kProducerRegs));
      Tile::produce(c, &wmap, amaps, parity, m0, n0, k_begin, k_end, s);
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Tile::kConsumerRegs));
    if constexpr (kGn) wg_gn_stage<Tile>(c, bias, gn, s, m0, n0);
    float acc[Tile::ACC];
#pragma unroll
    for (int i = 0; i < Tile::ACC; ++i) acc[i] = 0.f;
    Tile::consume((k_end - k_begin + Tile::BK - 1) / Tile::BK, s, acc);

    if constexpr (kGn) {
      wg_gn_epilogue<Tile>(acc, c, out, gn, s);
      return;
    }
    const int M = c.M, cout = c.cout;
    if (splits > 1) {
      const int tile =
          (parity * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      if (!split_k_last<Tile>(acc, partial, parity, split, splits, M, cout,
                              m0, n0, &counters[tile], ConsumerSync()))
        return;
    }
    Tile::pairs(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
      if (m >= M || n >= cout) return;
      const size_t o = (size_t)out_row(c.mode, m, parity, c.seg_in) * cout + n;
      *reinterpret_cast<float2*>(out + o) =
          make_float2(v0 + bias[n], v1 + bias[n + 1]);
    });
  }
}

// Chains whose DDPM-updated x a block of ddpm_project_kernel holds at once:
// one warp each for the dot products.
constexpr int kStepChains = 8;
// Elements a thread loads (its M slice and x, eps, noise) before it stores
// any: one round trip to L2 for the flagship's 8 chains.
constexpr int kStepBatch = 8;

// Outputs of row h a warp's lanes take at once in the step's dot products:
// each lane keeps one accumulator per output and loads each x once for all.
constexpr int kStepOuts = 8;

// One block per trajectory row h, for every chain; x (n_chains, H*D) is
// read, out written.
__global__ void __launch_bounds__(kThreads) ddpm_project_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    const float* __restrict__ eps, const float* __restrict__ noise,
    const float* __restrict__ scal, const float* __restrict__ cond,
    const float* __restrict__ Mp, const float* __restrict__ bp, int n_chains,
    int H, int D, int clip, int predict_eps, const int* __restrict__ wall,
    int grid_h, int grid_w, float mx, float my, float sx, float sy,
    float margin) {
  extern __shared__ float sh[];
  const bool project = Mp != nullptr;
  const int HD = H * D, h = blockIdx.x;
  float* ms = sh;                           // M[:, hD..hD+D), output-major
  float* xn = ms + (project ? D * HD : 0);  // kStepChains x HD
  float* zs = xn + kStepChains * HD;        // kStepChains x D: row h
  const float alpha = scal[5];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int c0 = 0; c0 < n_chains; c0 += kStepChains) {
    const int nc = min(kStepChains, n_chains - c0);
    // the DDPM update of every row of these chains when projecting, else of
    // row h only; with the first chains, the block's slice of M
    const int n_x = project ? nc * HD : nc * D;
    const int n_m = project && c0 == 0 ? HD * D : 0;
    auto x_at = [&](int i) {  // place in xn of the i-th updated value
      if (project) return i;
      const int cc = i / D;
      return cc * HD + h * D + (i - cc * D);
    };
    for (int i0 = threadIdx.x; i0 < max(n_x, n_m);
         i0 += kThreads * kStepBatch) {
      float mv[kStepBatch], xv[kStepBatch], ev[kStepBatch], nv[kStepBatch];
#pragma unroll
      for (int j = 0; j < kStepBatch; ++j) {
        const int i = i0 + j * kThreads;
        if (i < n_m) {
          const int r = i / D;
          mv[j] = Mp[(size_t)r * HD + h * D + (i - r * D)];
        }
        if (i < n_x) {
          const size_t o = (size_t)c0 * HD + x_at(i);
          xv[j] = x[o];
          ev[j] = eps[o];
          nv[j] = noise[o];
        }
      }
#pragma unroll
      for (int j = 0; j < kStepBatch; ++j) {
        const int i = i0 + j * kThreads;
        if (i < n_m) {
          const int r = i / D;
          ms[(i - r * D) * HD + r] = mv[j];
        }
        if (i < n_x)
          xn[x_at(i)] = ddpm_update(xv[j], ev[j], nv[j], scal, clip,
                                    predict_eps);
      }
    }
    __syncthreads();
    if (project && warp < nc) {
      // row h of chain c0 + warp: D dot products over HD, split over the
      // lanes (lane l adds the terms l, l + 32, ..), kStepOuts at a time,
      // each lane's partial sums added by a shuffle tree
      const float* xc = xn + warp * HD;
      for (int d0 = 0; d0 < D; d0 += kStepOuts) {
        float z[kStepOuts];
#pragma unroll
        for (int q = 0; q < kStepOuts; ++q) z[q] = 0.f;
        for (int i = lane; i < HD; i += 32) {
          const float xi = xc[i];
#pragma unroll
          for (int q = 0; q < kStepOuts; ++q)
            if (d0 + q < D) z[q] = fmaf(xi, ms[(d0 + q) * HD + i], z[q]);
        }
#pragma unroll
        for (int q = 0; q < kStepOuts; ++q) z[q] = warp_sum(z[q]);
        if (lane == 0)
#pragma unroll
          for (int q = 0; q < kStepOuts; ++q) {
            const int d = d0 + q;
            if (d < D)
              zs[warp * D + d] = alpha * (z[q] + bp[h * D + d]) +
                                 (1.f - alpha) * xc[h * D + d];
          }
      }
    }
    __syncthreads();
    // wall revert and row-0 conditioning, one thread per chain
    if ((int)threadIdx.x < nc) {
      const int cc = threadIdx.x;
      const float* xr = xn + cc * HD + h * D;  // after the DDPM update
      const float* pr = project ? zs + cc * D : xr;  // after projection
      bool bad = false;
      if (project && wall != nullptr) {
        // rounded as the reference computes them (no fused multiply-add);
        // the probes' cells are loaded together
        const float px = __fadd_rn(__fmul_rn(pr[0], sx), mx);
        const float py = __fadd_rn(__fmul_rn(pr[1], sy), my);
        const int n_probe = margin != 0.f ? 4 : 1;
        int cell[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (p >= n_probe) break;
          const float dx = n_probe == 1 ? 0.f : (p < 2 ? -margin : margin);
          const float dy = n_probe == 1 ? 0.f : ((p & 1) ? margin : -margin);
          int col = (int)floorf(__fadd_rn(__fadd_rn(px, dx), grid_w * 0.5f));
          int row = (int)floorf(__fsub_rn(grid_h * 0.5f, __fadd_rn(py, dy)));
          col = min(max(col, 0), grid_w - 1);
          row = min(max(row, 0), grid_h - 1);
          cell[p] = wall[row * grid_w + col];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (p < n_probe) bad = bad || cell[p] == 1;
      }
      const size_t o = (size_t)(c0 + cc) * HD + h * D;
      for (int d = 0; d < D; ++d)
        out[o + d] = h == 0 ? cond[o + d] : (bad ? xr[d] : pr[d]);
    }
    __syncthreads();  // xn and zs serve the next chains
  }
}

}  // namespace

// A (bm x bn) tile per block, one of those DADIFF_WITH_TILE knows (else
// cudaErrorInvalidValue); cout must be a multiple of 8. splits > 1 needs
// partial (parities * splits * M * cout floats) and counters (one zeroed
// unsigned per output tile, left zeroed on return).
extern "C" int rows_conv(const float* xa, const float* xb, int cin_a, int cin_b,
                         const void* w, int w_bf16, const float* bias,
                         float* out, int rows_in, int seg_in, int cout, int mode,
                         int k, int bm, int bn, int splits, float* partial,
                         unsigned int* counters, void* stream) {
  const int M = mode == kDown ? rows_in / 2 : rows_in;
  if (cout % 8 != 0 || splits < 1 || bm < 1 || bn < 1)
    return (int)cudaErrorInvalidValue;
  const ConvIn c{xa, xb, cin_a, cin_b, M, seg_in, cout, mode, k};
  dim3 grid((cout + bn - 1) / bn, (M + bm - 1) / bm,
            (mode == kUp ? 2 : 1) * splits);
  cudaStream_t st = (cudaStream_t)stream;
  bool ok;
  DADIFF_WITH_TILE(w_bf16, bm, bn, ok,
                   rows_conv_kernel<Tile, false><<<grid, kThreads, 0, st>>>(
                       c, (const Tile::W*)w, bias, out, splits, partial,
                       counters, GnEpi{}));
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Shared memory the epilogue of rows_conv_gn needs at the least: the group
// block, its pairs' statistics, bias, scale, shift and time rows
// (ops/conv_tiling.py GroupPlan.smem_bytes).
static int gn_smem_bytes(int gtm, int gtn, int bm, int bn, int ns, int ng) {
  return 4 * gtm * bm * gtn * bn + 16 * ((ns * ng + 1) / 2) +
         4 * gtn * bn * (3 + ns);
}

// rows_conv in SAME mode, then GroupNorm(8) + affine + Mish (+ te, + res)
// over segments of seg_in rows, in the same launch. gtm, gtn, ns, ng: the
// group-block plan of ops/conv_tiling.py group_plan for this tile, whose
// gn_smem_bytes fit the conv's shared memory with ns * ng <= 256 pairs;
// partial: splits * rows * cout floats if splits > 1; gcounters: one
// zeroed unsigned per group block (left zeroed).
extern "C" int rows_conv_gn(const float* xa, const float* xb, int cin_a,
                            int cin_b, const void* w, int w_bf16,
                            const float* bias, float* out, int rows, int seg_in,
                            int cout, int k, int bm, int bn, int splits,
                            float* partial, const float* scale,
                            const float* gbias, const float* te, int te_stride,
                            const float* res, float eps, int gtm, int gtn,
                            int ns, int ng, unsigned int* gcounters,
                            void* stream) {
  if (cout % 8 != 0 || splits < 1 || bm < 1 || bn < 1 || gtm < 1 ||
      gtn < 1 || ns * ng < 1 || ns * ng > kThreads ||
      gn_smem_bytes(gtm, gtn, bm, bn, ns, ng) > kConvSmemBytes)
    return (int)cudaErrorInvalidValue;
  const ConvIn c{xa, xb, cin_a, cin_b, rows, seg_in, cout, kSame, k};
  const GnEpi g{scale, gbias, te, res, te_stride, cout / 8, gtm, gtn, ns, ng,
                eps, gcounters};
  dim3 grid((cout + bn - 1) / bn, (rows + bm - 1) / bm, splits);
  cudaStream_t st = (cudaStream_t)stream;
  bool ok;
  DADIFF_WITH_TILE(w_bf16, bm, bn, ok,
                   rows_conv_kernel<Tile, true><<<grid, kThreads, 0, st>>>(
                       c, (const Tile::W*)w, bias, out, splits, partial,
                       nullptr, g));
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x and out (n_chains, H*D), distinct; eps, noise, cond like x; M (H*D,
// H*D) and b (H*D,) or null (no projection); wall (grid_h, grid_w) or null.
extern "C" int ddpm_project_step(const float* x, float* out, const float* eps,
                                 const float* noise, const float* scal,
                                 const float* cond, const float* M,
                                 const float* b, int n_chains, int H, int D,
                                 int clip, int predict_eps, const int* wall,
                                 int grid_h, int grid_w, float mx, float my,
                                 float sx, float sy, float margin,
                                 void* stream) {
  if (x == out) return (int)cudaErrorInvalidValue;
  const int HD = H * D;
  const size_t smem =
      sizeof(float) *
      ((M != nullptr ? (size_t)D * HD : 0) + (size_t)kStepChains * (HD + D));
  if (smem > 48 * 1024) {
    // above 48 KB only after this opt-in (long horizons or wide rows)
    cudaError_t e = cudaFuncSetAttribute(
        ddpm_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ddpm_project_kernel<<<H, kThreads, smem, (cudaStream_t)stream>>>(
      x, out, eps, noise, scal, cond, M, b, n_chains, H, D, clip, predict_eps,
      wall, grid_h, grid_w, mx, my, sx, sy, margin);
  return (int)cudaGetLastError();
}

// ---- wgmma tiles -----------------------------------------------------------

// cuTensorMapEncodeTiled of the driver, found through the runtime (no
// driver library at link time)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The tensor map of a (rows, cout) row-major bf16 weight, in boxes of 64
// rows x 64 columns with the 128-byte swizzle, zeros past its edges; encoded
// from the pointer it serves, at each launch (a graph keeps the map it
// captured with the launch, and the graph keeps its weights alive).
static int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                      const void* base, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box,
                      const cuuint32_t* elem) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const CUresult r = encode(
      map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

static int weight_map(CUtensorMap* map, const void* w, int rows, int cout) {
  const cuuint64_t dims[2] = {(cuuint64_t)cout, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cout * 2};
  const cuuint32_t box[2] = {64, 64}, elem[2] = {1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dims,
                    strides, box, elem);
}

// The tensor map of one activation source x (rows_in, cin_x) f32 over
// segments of seg_in rows, in boxes of 32 channels x the tile's bm GEMM
// rows with the 128-byte swizzle, zeros outside a segment: (cin_x, seg_in,
// segments), or for the stride-2 conv (cin_x, 2, seg_in / 2, segments) so
// that a box takes every other row.
static int act_map(CUtensorMap* map, const float* x, int cin_x, int rows_in,
                   int seg_in, int mode, int bm) {
  const bool down = mode == kDown;
  const int seg_m = down ? seg_in / 2 : seg_in;
  const int rows_box = seg_m < bm ? seg_m : bm;
  const cuuint64_t row = (cuuint64_t)cin_x * 4;
  const cuuint64_t dims[4] = {
      (cuuint64_t)cin_x, down ? 2u : (cuuint64_t)seg_in,
      down ? (cuuint64_t)seg_m : (cuuint64_t)(rows_in / seg_in),
      (cuuint64_t)(rows_in / seg_in)};
  const cuuint64_t strides[3] = {row, down ? 2 * row : row * seg_in,
                                 row * seg_in};
  const cuuint32_t box[4] = {32, down ? 1u : (cuuint32_t)rows_box,
                             down ? (cuuint32_t)rows_box
                                  : (cuuint32_t)(bm / rows_box),
                             (cuuint32_t)(bm / rows_box)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, down ? 4 : 3,
                    x, dims, strides, box, elem);
}

// The activations' maps of a launch on a tile of bm rows: A travels by TMA
// where every K tile lies in one tap and one of xa / xb (cin_a, cin_b
// multiples of 64) and a tile's bm rows are whole segments or lie in one;
// else tma = 0 and the producer gathers A.
static int act_maps(ActMaps* am, const ConvIn& c, int rows_in, int bm) {
  const int seg_m = c.mode == kDown ? c.seg_in / 2 : c.seg_in;
  am->has_res = 0;
  am->tma = c.cin_a % 64 == 0 && c.cin_b % 64 == 0 && seg_m > 0 &&
            (bm % seg_m == 0 || seg_m % bm == 0) &&
            (c.mode != kDown || c.seg_in % 2 == 0);
  if (!am->tma) return 0;
  int rc = act_map(&am->xa, c.xa, c.cin_a, rows_in, c.seg_in, c.mode, bm);
  if (rc == 0 && c.xb != nullptr)
    rc = act_map(&am->xb, c.xb, c.cin_b, rows_in, c.seg_in, c.mode, bm);
  return rc;
}

// A wgmma launch of Tile: opts in to its shared memory, then launches.
template <class Tile, bool kGn>
static int launch_wg(dim3 grid, cudaStream_t st, const ConvIn& c,
                     const CUtensorMap& map, const ActMaps& am,
                     const float* bias, float* out, int splits,
                     float* partial, unsigned int* counters, const GnEpi& g) {
  constexpr int smem = kGn ? Tile::SMEM_GN : Tile::SMEM;
  static_assert(smem <= 232448, "shared memory of a block");
  cudaError_t e = cudaFuncSetAttribute(
      rows_conv_wg_kernel<Tile, kGn>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  rows_conv_wg_kernel<Tile, kGn><<<grid, Tile::kThreads, smem, st>>>(
      c, map, am, bias, out, splits, partial, counters, g);
  return (int)cudaGetLastError();
}

// rows_conv on a 128 x bn wgmma tile with `stages` stages (one of those
// DADIFF_WITH_WG_TILE knows, else cudaErrorInvalidValue); bf16 weights.
// cout a multiple of 8, the transposed conv (UP) needs cin_a % 64 == 0 and
// no xb; splits > 1 needs partial (parities * splits * M * cout floats) and
// counters (one zeroed unsigned per output tile, left zeroed).
extern "C" int rows_conv_wg(const float* xa, const float* xb, int cin_a,
                            int cin_b, const void* w, const float* bias,
                            float* out, int rows_in, int seg_in, int cout,
                            int mode, int k, int bn, int stages, int splits,
                            float* partial, unsigned int* counters,
                            void* stream) {
  const int M = mode == kDown ? rows_in / 2 : rows_in;
  if (cout % 8 != 0 || splits < 1 ||
      (mode == kUp && (cin_a % 64 != 0 || xb != nullptr)))
    return (int)cudaErrorInvalidValue;
  const ConvIn c{xa, xb, cin_a, cin_b, M, seg_in, cout, mode, k};
  CUtensorMap map;
  ActMaps am;
  int rc = weight_map(&map, w, (mode == kUp ? 4 : k) * (cin_a + cin_b), cout);
  if (rc == 0) rc = act_maps(&am, c, rows_in, 128);
  if (rc != 0) return rc;
  dim3 grid((cout + bn - 1) / bn, (M + 127) / 128,
            (mode == kUp ? 2 : 1) * splits);
  cudaStream_t st = (cudaStream_t)stream;
  bool ok;
  int e = 0;
  DADIFF_WITH_WG_TILE(bn, stages, ok,
                      e = (launch_wg<Tile, false>(grid, st, c, map, am, bias,
                                                  out,
                                                  splits, partial, counters,
                                                  GnEpi{})));
  return ok ? e : (int)cudaErrorInvalidValue;
}

// rows_conv_gn on the 128 x 128 wgmma tile with 3 stages (the ring leaves
// room for the epilogue's residual tile), one K split: every (segment,
// group) pair lies in one tile (seg_in a multiple of 8 that divides 128;
// cout / 8 a multiple of 8 that divides 128, or cout <= 128).
extern "C" int rows_conv_gn_wg(const float* xa, const float* xb, int cin_a,
                               int cin_b, const void* w, const float* bias,
                               float* out, int rows, int seg_in, int cout,
                               int k, int bn, int stages, const float* scale,
                               const float* gbias, const float* te,
                               int te_stride, const float* res, float eps,
                               void* stream) {
  const int cg = cout / 8;
  if (cout % 64 != 0 || seg_in % 8 != 0 || 128 % seg_in != 0 ||
      rows % seg_in != 0 || (128 % cg != 0 && 128 < cout) || bn != 128 ||
      stages != 3)
    return (int)cudaErrorInvalidValue;
  const ConvIn c{xa, xb, cin_a, cin_b, rows, seg_in, cout, kSame, k};
  const GnEpi g{scale, gbias, te, res, te_stride, cg, 1, 1,
                128 / seg_in, min(bn, cout) / cg, eps, nullptr};
  CUtensorMap map;
  ActMaps am;
  int rc = weight_map(&map, w, k * (cin_a + cin_b), cout);
  if (rc == 0) rc = act_maps(&am, c, rows, 128);
  if (rc == 0 && res != nullptr) {
    const cuuint64_t dims[2] = {(cuuint64_t)cout, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cout * 4};
    const cuuint32_t box[2] = {32, 128}, elem[2] = {1, 1};
    am.has_res = 1;
    rc = encode_map(&am.res, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, res, dims,
                    strides, box, elem);
  }
  if (rc != 0) return rc;
  return launch_wg<WgTile<128, 3>, true>(
      dim3((cout + 127) / 128, (rows + 127) / 128, 1), (cudaStream_t)stream,
      c, map, am, bias, out, 1, nullptr, nullptr, g);
}

// ---- the cluster tile ------------------------------------------------------

// A launch of the cluster tile: the K splits of an output tile are one
// cluster of (1, 1, splits) blocks along z.
template <class Tile, bool kGn>
static int launch_cl(dim3 grid, int splits, cudaStream_t st, const ConvIn& c,
                     const CUtensorMap& map, const ActMaps& am,
                     const float* bias, float* out, const GnEpi& g) {
  cudaError_t e = cudaFuncSetAttribute(
      rows_conv_wg_kernel<Tile, kGn>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Tile::kThreads);
  cfg.dynamicSmemBytes = Tile::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  float* partial = nullptr;
  unsigned int* counters = nullptr;
  void* args[] = {(void*)&c,      (void*)&map,      (void*)&am,
                  (void*)&bias,   (void*)&out,      (void*)&splits,
                  (void*)&partial, (void*)&counters, (void*)&g};
  e = cudaLaunchKernelExC(&cfg, (const void*)rows_conv_wg_kernel<Tile, kGn>,
                          args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p) {
  return ((size_t)p & 15) == 0;
}

// The weight and activation maps of a cluster-tile launch; A must travel by
// TMA (cudaErrorInvalidValue otherwise: the tile has no gathering producer).
static int cl_maps(CUtensorMap* map, ActMaps* am, const ConvIn& c,
                   const void* w, int rows_in) {
  const int taps = c.mode == kUp ? 4 : c.k;
  int rc = weight_map(map, w, taps * (c.cin_a + c.cin_b), c.cout);
  if (rc == 0) rc = act_maps(am, c, rows_in, 64);
  if (rc == 0 && !am->tma) rc = (int)cudaErrorInvalidValue;
  return rc;
}

// rows_conv on the 64 x 128 cluster tile with 1-8 K splits, the blocks of
// one cluster; bf16 weights. cout a multiple of 64, cin_a and cin_b multiples of 64, a
// segment of GEMM rows a divisor or a multiple of 64; the transposed conv
// (UP) without xb; bias 16-byte aligned.
extern "C" int rows_conv_cl(const float* xa, const float* xb, int cin_a,
                            int cin_b, const void* w, const float* bias,
                            float* out, int rows_in, int seg_in, int cout,
                            int mode, int k, int splits, void* stream) {
  const int M = mode == kDown ? rows_in / 2 : rows_in;
  if (cout % 64 != 0 || splits < 1 || splits > 8 || !aligned16(bias) ||
      (mode == kUp && xb != nullptr))
    return (int)cudaErrorInvalidValue;
  const ConvIn c{xa, xb, cin_a, cin_b, M, seg_in, cout, mode, k};
  CUtensorMap map;
  ActMaps am;
  const int rc = cl_maps(&map, &am, c, w, rows_in);
  if (rc != 0) return rc;
  return launch_cl<ClusterTile, false>(
      dim3((cout + 127) / 128, (M + 63) / 64, (mode == kUp ? 2 : 1) * splits),
      splits, (cudaStream_t)stream, c, map, am, bias, out, GnEpi{});
}

// rows_conv_gn on the cluster tile: every (segment, group) pair lies in one
// tile (seg_in a multiple of 8 that divides 64; cout / 8 a multiple of 8
// that divides 128). te: a row of cout per segment at te_stride (0: one
// row for all), or null; res (rows, cout) or null; bias, scale, gbias, te
// and res 16-byte aligned.
extern "C" int rows_conv_gn_cl(const float* xa, const float* xb, int cin_a,
                               int cin_b, const void* w, const float* bias,
                               float* out, int rows, int seg_in, int cout,
                               int k, int splits, const float* scale,
                               const float* gbias,
                               const float* te, int te_stride,
                               const float* res, float eps, void* stream) {
  const int cg = cout / 8;
  if (cout % 64 != 0 || seg_in % 8 != 0 || 64 % seg_in != 0 ||
      rows % seg_in != 0 || 128 % cg != 0 || splits < 1 || splits > 8 ||
      te_stride % 4 != 0 || !aligned16(bias) || !aligned16(scale) ||
      !aligned16(gbias) || !aligned16(te) || !aligned16(res))
    return (int)cudaErrorInvalidValue;
  const ConvIn c{xa, xb, cin_a, cin_b, rows, seg_in, cout, kSame, k};
  const GnEpi g{scale, gbias, te, res, te_stride, cg, 1, 1, 64 / seg_in,
                min(128, cout) / cg, eps, nullptr};
  CUtensorMap map;
  ActMaps am;
  const int rc = cl_maps(&map, &am, c, w, rows);
  if (rc != 0) return rc;
  return launch_cl<ClusterTile, true>(
      dim3((cout + 127) / 128, (rows + 63) / 64, splits), splits,
      (cudaStream_t)stream, c, map, am, bias, out, g);
}
