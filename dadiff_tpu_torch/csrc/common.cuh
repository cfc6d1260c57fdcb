// Device routines shared by the port's kernels, so that the per-layer
// kernels (gn_mish.cu, planner.cu), the one-launch chain (chain.cu) and the
// fused residual block (resblock.cu) compile from one source of truth:
//
//   mish, warp_sum        the activation and the warp reduction of K1;
//   in_row, weight_tap,   the row and tap arithmetic of the U-Net's convs over
//   out_row               row-stacked chains (zero padding per segment);
//   conv_tile_acc         one 32x32 output tile of a conv as an implicit
//                         shifted-stack GEMM over a K range, on the CUDA cores;
//   ddpm_update           the DDPM reverse-step arithmetic on one element.
//
// Every library's build is keyed by the hash of its .cu and of every .cuh
// (ops/cuda_lib.py), so an edit here rebuilds all of them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace dadiff {

constexpr int kSame = 0;  // k-tap SAME conv, stride 1
constexpr int kDown = 1;  // k=3, stride 2, padding 1: even rows of the SAME conv
constexpr int kUp = 2;    // ConvTranspose1d k=4, s=2, p=1

constexpr int BM = 32, BN = 32, BK = 32, kThreads = 256;

__device__ __forceinline__ float mish(float y) {
  // x * tanh(softplus(x)); softplus with torch's threshold of 20
  float sp = (y > 20.f) ? y : log1pf(expf(y));
  return y * tanhf(sp);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float load_w(const float* w, size_t i) {
  return __ldg(w + i);
}
__device__ __forceinline__ float load_w(const __nv_bfloat16* w, size_t i) {
  return __bfloat162float(w[i]);
}

// Input row feeding GEMM row m through virtual tap j, or -1 for a zero pad.
__device__ __forceinline__ int in_row(int mode, int m, int j, int parity,
                                      int seg_in, int k) {
  int s, li;
  if (mode == kDown) {
    const int seg_out = seg_in >> 1;
    s = m / seg_out;
    li = 2 * (m - s * seg_out) + j - 1;
  } else {
    s = m / seg_in;
    const int l = m - s * seg_in;
    if (mode == kSame) {
      li = l + j - k / 2;
    } else {
      // even rows: x[h] R1 + x[h-1] R3; odd rows: x[h+1] R0 + x[h] R2
      li = parity == 0 ? (j == 0 ? l : l - 1) : (j == 0 ? l + 1 : l);
    }
  }
  return (li >= 0 && li < seg_in) ? s * seg_in + li : -1;
}

// Row block of the flattened weight that virtual tap j multiplies.
__device__ __forceinline__ int weight_tap(int mode, int j, int parity) {
  if (mode != kUp) return j;
  return parity == 0 ? (j == 0 ? 1 : 3) : (j == 0 ? 0 : 2);
}

__device__ __forceinline__ int out_row(int mode, int m, int parity, int seg_in) {
  if (mode != kUp) return m;
  const int s = m / seg_in;
  return s * 2 * seg_in + 2 * (m - s * seg_in) + parity;
}

// acc[i][jn] += sum over K in [k_begin, k_end) of
//   x[in_row(m0 + 2*ty + i, j), ci] * w[weight_tap(j) * cin + ci, n0 + 2*tx + jn]
// with K = j * cin + ci, for the 2x2 outputs of thread (tx, ty) of a 256-thread
// block. The input is the channel concatenation [xa | xb] (xb may be null),
// which covers the decoder's skip concat without a copy. Activations are read
// through L2 (another block of the same launch may have written them). With
// bf16 weights the activations are rounded to bf16 first, as the TPU kernels
// cast them to the compute dtype before every product.
template <typename WT, bool kBf16Act>
__device__ __forceinline__ void conv_tile_acc(
    const float* xa, const float* xb, int cin_a, int cin_b, const WT* w, int M,
    int seg_in, int cout, int mode, int k, int parity, int m0, int n0,
    int k_begin, int k_end, float (*As)[BM + 1], float (*Bs)[BN],
    float (&acc)[2][2]) {
  const int cin = cin_a + cin_b;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 2x2 outputs per thread
  float acc00 = acc[0][0], acc01 = acc[0][1], acc10 = acc[1][0],
        acc11 = acc[1][1];
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e % BK, mm = e / BK;
      const int kg = k0 + kk, m = m0 + mm;
      float v = 0.f;
      if (kg < k_end && m < M) {
        const int j = kg / cin, ci = kg - j * cin;
        const int r = in_row(mode, m, j, parity, seg_in, k);
        if (r >= 0) {
          v = ci < cin_a ? __ldcg(xa + (size_t)r * cin_a + ci)
                         : __ldcg(xb + (size_t)r * cin_b + (ci - cin_a));
          if (kBf16Act) v = __bfloat162float(__float2bfloat16(v));
        }
      }
      As[kk][mm] = v;
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int nn = e % BN, kk = e / BN;
      const int kg = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (kg < k_end && n < cout) {
        const int j = kg / cin, ci = kg - j * cin;
        const int wt = weight_tap(mode, j, parity);
        v = load_w(w, (size_t)(wt * cin + ci) * cout + n);
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = As[kk][2 * ty], a1 = As[kk][2 * ty + 1];
      const float b0 = Bs[kk][2 * tx], b1 = Bs[kk][2 * tx + 1];
      acc00 = fmaf(a0, b0, acc00);
      acc01 = fmaf(a0, b1, acc01);
      acc10 = fmaf(a1, b0, acc10);
      acc11 = fmaf(a1, b1, acc11);
    }
    __syncthreads();
  }
  acc[0][0] = acc00;
  acc[0][1] = acc01;
  acc[1][0] = acc10;
  acc[1][1] = acc11;
}

// x_{t-1} before projection and conditioning, from x_t, the model output, the
// step's noise and scal = (recip, recipm1, c1, c2, sigma).
__device__ __forceinline__ float ddpm_update(float xv, float e, float nz,
                                             const float* scal, int clip,
                                             int predict_eps) {
  float xr = predict_eps ? scal[0] * xv - scal[1] * e : e;
  if (clip) xr = fminf(fmaxf(xr, -1.f), 1.f);
  return scal[2] * xr + scal[3] * xv + scal[4] * nz;
}

}  // namespace dadiff
