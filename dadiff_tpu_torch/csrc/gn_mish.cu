// K1: fused GroupNorm(8) + affine + Mish on row-stacked segments, with an
// optional epilogue add (a per-segment row, a residual tensor, or both).
//
// Replaces: the JAX package's ops/pallas_kernels.py:84 group_norm_mish_pallas
// (body _gn_mish_kernel :56) and the per-chain GN+Mish stage inside the
// planner chain, ops/pallas_unet.py:198 _group_norm_mish, with the
// adds that res_block fuses around it (pallas_unet.py:281-293).
//
// Layout: x is (S * seg, C) float32, row-major; S segments (chains or batch
// rows) of seg rows each. Statistics are per (segment, group) over seg rows
// and C/8 channels, var = E[x^2] - mean^2, as the TPU kernel computes them.
//
// Bound on an H100: bytes. At the flagship shapes ((8*32,128), (8*16,256),
// (8*8,512)) one call reads and writes 128 KB each way, ~0.08 us at 3.35 TB/s,
// so a launch (~2-3 us) dominates. Design: one block per (segment, group)
// (64 blocks at the flagship), one pass that reads the 512-element slab for
// the sums, a second that rereads it from L1/L2 and writes the result; no
// shared-memory staging beyond the 2 x 32-float reduction.

#include "common.cuh"

namespace {

using dadiff::mish;
using dadiff::warp_sum;

__global__ void gn_mish_kernel(const float* __restrict__ x,
                               float* __restrict__ out,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias,
                               const float* __restrict__ te, int te_stride,
                               const float* __restrict__ res, int C, int seg,
                               int groups, float eps) {
  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int cg = C / groups;
  const int n = seg * cg;
  const size_t base = (size_t)s * seg * C + (size_t)g * cg;

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / cg, c = i - r * cg;
    const float v = x[base + (size_t)r * C + c];
    s1 += v;
    s2 += v * v;
  }
  __shared__ float red1[32], red2[32];
  __shared__ float stat[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red1[warp] = s1;
    red2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    s1 = lane < nw ? red1[lane] : 0.f;
    s2 = lane < nw ? red2[lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mean = s1 / (float)n;
      const float var = s2 / (float)n - mean * mean;
      stat[0] = mean;
      stat[1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / cg, c = i - r * cg;
    const int ch = g * cg + c;
    const size_t idx = base + (size_t)r * C + c;
    float y = (x[idx] - mean) * rstd * scale[ch] + bias[ch];
    y = mish(y);
    if (te != nullptr) y += te[(size_t)s * te_stride + ch];
    if (res != nullptr) y += res[idx];
    out[idx] = y;
  }
}

}  // namespace

extern "C" int gn_mish(const float* x, float* out, const float* scale,
                       const float* bias, const float* te, int te_stride,
                       const float* res, int n_seg, int seg, int C, int groups,
                       float eps, void* stream) {
  dim3 grid(n_seg, groups);
  gn_mish_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      x, out, scale, bias, te, te_stride, res, C, seg, groups, eps);
  return (int)cudaGetLastError();
}
