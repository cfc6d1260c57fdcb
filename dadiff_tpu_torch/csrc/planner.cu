// K2, the planner chain, as a family of kernels driven by a host loop over
// the denoise steps and the U-Net's layer plan (dadiff_tpu_torch/ops/planner.py),
// captured once per set of operands in a CUDA graph and replayed per wave.
//
// Replaces: the JAX package's ops/pallas_planner.py:95 make_pallas_planner_chain
// (inner kernel :206, _project :156, _apply_cond :152) and the U-Net body it
// runs, ops/pallas_unet.py:258 _unet_forward with _conv_stack
// :184, _shift_rows :161, _even_rows :243 and _interleave_rows :248. The
// GroupNorm+Mish stages go through K1 (gn_mish.cu).
//
//   rows_conv          one conv of the U-Net as an implicit shifted-stack
//                      GEMM over row-stacked chains: k-tap SAME (k = 5 or 1),
//                      k=3 stride 2 (even rows only), or the k=4 s=2
//                      transposed conv as even/odd two-tap products. Zero
//                      padding applies per segment (chain), so N stacked
//                      chains equal N separate forwards.
//   ddpm_project_step  one block per chain: DDPM update from scal[t], the
//                      interleaved projection alpha*(x@M+b)+(1-alpha)*x, the
//                      wall revert and the row-0 conditioning, in place.
//
// Bound on an H100 (flagship: 8 chains x 32 rows, dim 128, mults 1 2 4):
// one denoise step is ~2.3 GFLOP of products over ~31.7 MB of bf16 weights,
// i.e. ~74 operations per weight byte, well under the ~295 the card needs to
// be compute-bound: the least time is ~2.4 us of tensor-core work and ~9.5 us
// of weight streaming from HBM per step. What a step really costs is 35
// dependent launches whose GEMMs are 64-256 rows by 8-512 columns: each is
// bound by the latency of its K loop and by L2, not by the tensor cores.
// rows_conv therefore takes the tile product of common.cuh (mma.sync on
// bf16, cp.async ring, hoisted row arithmetic) with the smallest tile that
// still leaves the card room for every block, 16 x 64 at these shapes, and
// splits K over blocks (ops/planner.py _want_splits), so that some 200
// blocks each walk 2-10 K tiles with their own loads in flight: on the card
// that beat the 64-row tiles, which read the deep layers' weights once, by
// 1.4-1.9x. Split-K stays deterministic: the last block of a tile to arrive
// sums the partial tiles in split order (split_k_last of common.cuh).

#include "common.cuh"

namespace {

using namespace dadiff;

// out[out_row(m)] = bias + sum_{j, ci} x[in_row(m, j), ci] * w[wtap(j)*cin + ci]
// One block per (output tile, parity, K split); the tile product is
// Tile::product of common.cuh.
template <class Tile>
__global__ void __launch_bounds__(kThreads, 2)
rows_conv_kernel(ConvIn c, const typename Tile::W* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int splits, float* __restrict__ partial,
                 unsigned int* __restrict__ counters) {
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

// One block per chain of H rows x D lanes (HD = H*D values).
__global__ void ddpm_project_kernel(
    float* __restrict__ x, const float* __restrict__ eps,
    const float* __restrict__ noise, const float* __restrict__ scal,
    const float* __restrict__ cond, const float* __restrict__ Mp,
    const float* __restrict__ bp, int H, int D, int clip, int predict_eps,
    const int* __restrict__ wall, int grid_h, int grid_w, float mx, float my,
    float sx, float sy, float margin) {
  extern __shared__ float sh[];
  const int HD = H * D;
  float* xn = sh;       // x after the DDPM update
  float* xp = sh + HD;  // after projection and wall revert
  const size_t base = (size_t)blockIdx.x * HD;
  const float alpha = scal[5];

  for (int i = threadIdx.x; i < HD; i += blockDim.x) {
    xn[i] = ddpm_update(x[base + i], eps[base + i], noise[base + i], scal,
                        clip, predict_eps);
  }
  __syncthreads();

  if (Mp != nullptr) {
    for (int j = threadIdx.x; j < HD; j += blockDim.x) {
      float z = 0.f;
      for (int i = 0; i < HD; ++i) z = fmaf(xn[i], Mp[(size_t)i * HD + j], z);
      z += bp[j];
      xp[j] = alpha * z + (1.f - alpha) * xn[j];
    }
    __syncthreads();
    if (wall != nullptr) {
      for (int h = threadIdx.x; h < H; h += blockDim.x) {
        // rounded as the reference computes them (no fused multiply-add)
        const float px = __fadd_rn(__fmul_rn(xp[h * D], sx), mx);
        const float py = __fadd_rn(__fmul_rn(xp[h * D + 1], sy), my);
        const int n_probe = margin != 0.f ? 4 : 1;
        bool bad = false;
        for (int p = 0; p < n_probe; ++p) {
          const float dx = n_probe == 1 ? 0.f : (p < 2 ? -margin : margin);
          const float dy = n_probe == 1 ? 0.f : ((p & 1) ? margin : -margin);
          int col = (int)floorf(__fadd_rn(__fadd_rn(px, dx), grid_w * 0.5f));
          int row = (int)floorf(__fsub_rn(grid_h * 0.5f, __fadd_rn(py, dy)));
          col = min(max(col, 0), grid_w - 1);
          row = min(max(row, 0), grid_h - 1);
          bad = bad || wall[row * grid_w + col] == 1;
        }
        if (bad)
          for (int d = 0; d < D; ++d) xp[h * D + d] = xn[h * D + d];
      }
      __syncthreads();
    }
  } else {
    for (int i = threadIdx.x; i < HD; i += blockDim.x) xp[i] = xn[i];
    __syncthreads();
  }

  for (int i = threadIdx.x; i < HD; i += blockDim.x)
    x[base + i] = i < D ? cond[base + i] : xp[i];
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
                   rows_conv_kernel<Tile><<<grid, kThreads, 0, st>>>(
                       c, (const Tile::W*)w, bias, out, splits,
                       partial, counters));
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ddpm_project_step(float* x, const float* eps, const float* noise,
                                 const float* scal, const float* cond,
                                 const float* M, const float* b, int n_chains,
                                 int H, int D, int clip, int predict_eps,
                                 const int* wall, int grid_h, int grid_w,
                                 float mx, float my, float sx, float sy,
                                 float margin, void* stream) {
  const size_t smem = 2 * (size_t)H * D * sizeof(float);
  ddpm_project_kernel<<<n_chains, 256, smem, (cudaStream_t)stream>>>(
      x, eps, noise, scal, cond, M, b, H, D, clip, predict_eps, wall, grid_h,
      grid_w, mx, my, sx, sy, margin);
  return (int)cudaGetLastError();
}
