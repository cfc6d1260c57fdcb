// K4: one ResidualTemporalBlock in ONE launch (dadiff_tpu_torch/ops/resblock.py).
//
// Replaces: the JAX package's ops/pallas_resblock.py:132 residual_block_pallas
// (body `_kernel` :82):
//
//   conv1(k) -> GroupNorm -> Mish -> + te -> conv2(k) -> GroupNorm -> Mish
//   -> + (1x1 conv of x, or x)
//
// f32 throughout, zero-padded 'same' convs, statistics per batch row and
// group over (H, C/G) with var = E[x^2] - mean^2.
//
// On the TPU one program owns a whole batch row and h never leaves VMEM.
// Here a batch row is owned by one thread-block CLUSTER of G blocks (G = the
// group count, 8: the portable cluster limit), block g computing the C/G
// output channels of group g for all H rows. A group's statistics then need
// no traffic between blocks, and G SMs stream a row's weights instead of
// one. conv2 needs ALL channels of h, so after a cluster barrier every block
// gathers the other groups' h from their shared memory (distributed shared
// memory); a second barrier keeps every block resident until all have read.
// Nothing between the two convs goes through global memory.
//
// Within a block: x and the gathered h live in shared memory with k/2 zero
// rows at both ends, which turns a k-tap conv into one product over
// K = k * Cin with no bounds test (conv_cols). The block's threads split K:
// each weight is read from global memory once, by one thread, and used on 8
// rows; the K slices are summed through shared memory in a fixed order.
//
// Bound on an H100: bytes at batch 1 (the weights, up to 5*1024*256 f32 =
// 5.2 MB for the widest block, against 21 MFLOP of products), operations at
// larger batch. At B = 1 only G of the 132 SMs work, on the CUDA cores.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using dadiff::mish;
using dadiff::warp_sum;

constexpr int kBlock = 512;
constexpr int kRows = 8;  // rows a thread accumulates at once

// dst[r * cw + c] = bias[c0 + c] + sum_{kk < K} src[r * cin + kk] *
//                                               w[kk * cout + c0 + c]
// for r < H, c < cw: the block's cw output channels from c0 on, as a product
// over K = taps * cin. `src` points at padded row 0 of a buffer with k/2 zero
// rows above row 0 of the data, so tap j of channel ci at row r is
// src[(r + j) * cin + ci] = src[r * cin + kk] with kk = j * cin + ci: the taps
// need no index arithmetic. Threads are spread over (K slice, channel): a
// thread reads each weight of its slice once (coalesced over the channels),
// uses it on kRows rows whose activations are shared-memory broadcasts, and
// the slices are summed through `part` (kBlock * kRows floats) in slice
// order, so the result does not depend on timing.
__device__ void conv_cols(const float* src, const float* __restrict__ w,
                          const float* __restrict__ bias, float* dst, int H,
                          int cin, int cout, int K, int c0, int cw,
                          float* part) {
  const int lanes = min(cw, kBlock);  // threads across channels
  const int n_ks = kBlock / lanes;    // K slices
  const int ks = threadIdx.x / lanes, cl = threadIdx.x - ks * lanes;
  const int per = (K + n_ks - 1) / n_ks;
  const int k_begin = min(K, ks * per), k_end = min(K, k_begin + per);
  for (int cb = 0; cb < cw; cb += lanes) {
    for (int r0 = 0; r0 < H; r0 += kRows) {
      if (ks < n_ks && cb + cl < cw) {
        const float* wc = w + c0 + cb + cl;
        int off[kRows];
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          off[i] = min(r0 + i, H - 1) * cin;  // clamped rows are not stored
          acc[i] = 0.f;
        }
#pragma unroll 8
        for (int kk = k_begin; kk < k_end; ++kk) {
          const float wv = __ldg(wc + (size_t)kk * cout);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            acc[i] = fmaf(src[off[i] + kk], wv, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          part[(ks * kRows + i) * lanes + cl] = acc[i];
      }
      __syncthreads();
      for (int t = threadIdx.x; t < kRows * lanes; t += kBlock) {
        const int i = t / lanes, c = cb + t % lanes, r = r0 + i;
        if (r < H && c < cw) {
          float sum = 0.f;
          for (int q = 0; q < n_ks; ++q)
            sum += part[(q * kRows + i) * lanes + t % lanes];
          dst[r * cw + c] = sum + bias[c0 + c];
        }
      }
      __syncthreads();
    }
  }
}

// mean and 1/std over the n values of buf, by the whole block
__device__ void block_stats(const float* buf, int n, float eps, float* red,
                            float* stat) {
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += kBlock) {
    const float v = buf[i];
    s1 += v;
    s2 += v * v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[warp] = s1;
    red[kBlock / 32 + warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < kBlock / 32 ? red[lane] : 0.f;
    s2 = lane < kBlock / 32 ? red[kBlock / 32 + lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mean = s1 / (float)n;
      stat[0] = mean;
      stat[1] = rsqrtf(s2 / (float)n - mean * mean + eps);
    }
  }
  __syncthreads();
}

// One cluster per batch row; block `g` of the cluster owns group g.
__global__ void __launch_bounds__(kBlock)
resblock_kernel(const float* __restrict__ x, const float* __restrict__ te,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ s1, const float* __restrict__ g1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ s2, const float* __restrict__ g2,
                const float* __restrict__ wr, const float* __restrict__ br,
                float* __restrict__ out, int H, int cin, int cout, int k,
                float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  __shared__ float red[2 * kBlock / 32], stat[2];
  __shared__ float part[kBlock * kRows];
  const int groups = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  const int b = blockIdx.x / groups;
  const int p = k / 2;
  const int cw = cout / groups, c0 = g * cw;
  float* xs = smem;                      // (H + 2p, cin), zero halo
  float* hs = xs + (H + 2 * p) * cin;    // (H + 2p, cout), zero halo: all of h
  float* hl = hs + (H + 2 * p) * cout;   // (H, cw): this group's h, then y
  float* rs = hl + H * cw;               // (H, cw): this group's residual

  for (int i = threadIdx.x; i < (H + 2 * p) * cin; i += kBlock) {
    const int r = i / cin - p;
    xs[i] = (r >= 0 && r < H) ? x[((size_t)b * H + r) * cin + (i % cin)] : 0.f;
  }
  for (int i = threadIdx.x; i < p * cout; i += kBlock) {
    hs[i] = 0.f;
    hs[(H + p) * cout + i] = 0.f;
  }
  __syncthreads();

  // conv1 -> GN -> Mish -> + te on this group's channels
  conv_cols(xs, w1, b1, hl, H, cin, cout, k * cin, c0, cw, part);
  if (wr != nullptr)
    conv_cols(xs + p * cin, wr, br, rs, H, cin, cout, cin, c0, cw, part);
  block_stats(hl, H * cw, eps, red, stat);
  for (int i = threadIdx.x; i < H * cw; i += kBlock) {
    const int ch = c0 + i % cw;
    hl[i] = mish((hl[i] - stat[0]) * stat[1] * s1[ch] + g1[ch])
            + te[(size_t)b * cout + ch];
  }

  // every group's h into this block's hs, through distributed shared memory
  cluster.sync();
  for (int r = 0; r < groups; ++r) {
    const float* remote = cluster.map_shared_rank(hl, r);
    for (int i = threadIdx.x; i < H * cw; i += kBlock)
      hs[(i / cw + p) * cout + r * cw + i % cw] = remote[i];
  }
  cluster.sync();  // all have read: hl may be overwritten, blocks may exit

  // conv2 -> GN -> Mish -> + residual on this group's channels
  conv_cols(hs, w2, b2, hl, H, cout, cout, k * cout, c0, cw, part);
  block_stats(hl, H * cw, eps, red, stat);
  for (int i = threadIdx.x; i < H * cw; i += kBlock) {
    const int r = i / cw, ch = c0 + i % cw;
    const float res = wr != nullptr ? rs[i] : xs[(r + p) * cin + ch];
    out[((size_t)b * H + r) * cout + ch] =
        mish((hl[i] - stat[0]) * stat[1] * s2[ch] + g2[ch]) + res;
  }
}

}  // namespace

// x (B, H, cin), te (B, cout), w1 (k*cin, cout) and w2 (k*cout, cout)
// tap-major, wr (cin, cout) or null (then cin == cout), vectors (cout,),
// out (B, H, cout); all contiguous float32. groups <= 8 (the cluster size).
extern "C" int resblock(const float* x, const float* te, const float* w1,
                        const float* b1, const float* s1, const float* g1,
                        const float* w2, const float* b2, const float* s2,
                        const float* g2, const float* wr, const float* br,
                        float* out, int B, int H, int cin, int cout, int k,
                        int groups, float eps, void* stream) {
  const int p = k / 2;
  const int smem = (int)sizeof(float) * ((H + 2 * p) * cin + (H + 2 * p) * cout +
                                         2 * H * (cout / groups));
  // static plus dynamic shared memory above 48 KB needs this opt-in, which
  // holds per device: set on every launch, it is cheap
  cudaError_t e = cudaFuncSetAttribute(
      resblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * groups);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = groups;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, resblock_kernel, x, te, w1, b1, s1, g1, w2, b2,
                         s2, g2, wr, br, out, H, cin, cout, k, eps);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
