// K1: fused GroupNorm(8) + affine + Mish, forward and backward, on segments
// in either layout, with optional epilogue adds (a per-segment or shared
// row `te`, a residual `res`).
//
// Replaces: the JAX package's ops/pallas_kernels.py:84 group_norm_mish_pallas
// (body _gn_mish_kernel :56) and its custom_vjp's backward _gn_bwd (:130, the
// XLA vjp of the reference, which XLA fuses); and the per-chain GN+Mish stage
// of the planner chain, ops/pallas_unet.py:198 _group_norm_mish, with the
// adds that res_block fuses around it (pallas_unet.py:281-293).
//
// Layouts, by strides: feature-last (S, L, C), the JAX package's, and
// channels-first (S, C, L), the conv's own output, which the U-Net's
// use_pallas_norm option hands over without a copy. Either way one
// (segment, group) is `outer` runs of `inner` contiguous floats:
//   feature-last:   L runs of C/8 floats, C apart;
//   channels-first: C/8 runs of L floats, back to back (one run of C/8 * L).
// Statistics are per (segment, group), var = E[x^2] - mean^2 and
// rsqrt(var + eps), as the TPU kernel computes them (pallas_kernels.py:70-72).
//
// What bounds it on an H100: bytes. The training step's 25 norms (batch B,
// (L, C) = 5 x (32, 128), 4 x (16, 256), 8 x (8, 512), 4 x (8, 256),
// 4 x (16, 128)) hold 86,016 floats a batch row: at B = 256 the forward
// reads x and writes y, 176 MB, 52.6 us at 3.35 TB/s; the backward reads x
// and g and writes dx, 264 MB, 78.9 us. At B = 32 they are 8x smaller and a
// launch (~2-3 us) costs more than the bytes.
//
// Design: one block per (segment, group), 32-256 threads (one 128-bit
// vector each at the training shapes' 256 and 512 floats a group).
// - Register route (a group of at most REG_MAX = 2,048 floats: every shape
//   the port runs): each thread loads its NV vectors of VEC floats once,
//   128-bit (VEC 4) where the run length is a multiple of 4 and the
//   pointers are 16-byte aligned, else scalar (VEC 1); the sums reduce
//   with warp shuffles and one shared-memory stage; the thread normalises
//   from its registers and stores 128-bit, so each element is read once and
//   written once. The element walk steps by the block's width with a
//   carried quotient and remainder: no integer division per element.
// - Looped route (a larger group): the same walk in a loop, a first pass
//   for the sums and a second that reads x again to write y (and, in the
//   backward, a third per channel for the channel sums).
// - Backward, per (segment, group): read x and g once, rebuild x^ from the
//   saved (mean, rstd) and y = x^ * scale + bias, gy = g * mish'(y); reduce
//   sum(gy * scale) and sum(gy * scale * x^) over the group; write
//   dx = rstd * (gy*scale - mean(gy*scale) - x^ * mean(gy*scale*x^)). The
//   per-channel sums of gy * x^, gy (and g, for te) over the segment's
//   positions go through shared memory (padded so that a channel's thread
//   reads without bank conflicts) into an (S, C) plane each; a second small
//   launch sums those planes over S in a fixed order (8 warps, each a fixed
//   stride of S, then the 8 partials in warp order) into dscale, dbias and a
//   shared te's gradient. No float atomics anywhere: two runs give the same
//   bits; no allocation and no host synchronisation, so both launches can be
//   captured in a CUDA graph.
//
// The host picks VEC, NV and the block width (ops/gn_mish.py launch_plan).

#include <stdint.h>

#include "common.cuh"

namespace {

using dadiff::mish;
using dadiff::warp_sum;

constexpr int kThreads = 256;  // the largest block

__device__ __forceinline__ float mish_grad(float y) {
  // d/dy y * tanh(softplus(y)), softplus with torch's threshold of 20
  const float sp = (y > 20.f) ? y : log1pf(expf(y));
  const float tsp = tanhf(sp);
  const float sig = 1.f / (1.f + expf(-y));
  return tsp + y * sig * (1.f - tsp * tsp);
}

// The elements of one (segment, group), VEC at a time, visited by thread t
// at vectors t, t + T, t + 2T, ... (T the block's width).
template <bool CF, int VEC>
struct Walk {
  int inner_v;   // vectors a run
  int ostride;   // floats from one run to the next
  int nvec;      // vectors in the group
  size_t base;   // the group's first float
  int ch0;       // the group's first channel
  int v, o, r;   // this thread's vector, its run and its place in the run
  int dq, dr;    // a step of T vectors, as runs and vectors

  __device__ Walk(int s, int g, int C, int seg, int cg, int t, int T) {
    if (CF) {  // (S, C, L): seg == L
      inner_v = seg / VEC;
      ostride = seg;
      nvec = cg * inner_v;
      base = ((size_t)s * C + (size_t)g * cg) * seg;
    } else {   // (S, L, C)
      inner_v = cg / VEC;
      ostride = C;
      nvec = seg * inner_v;
      base = (size_t)s * seg * C + (size_t)g * cg;
    }
    ch0 = g * cg;
    v = t;
    o = t / inner_v;
    r = t - o * inner_v;
    dq = T / inner_v;
    dr = T - dq * inner_v;
  }
  __device__ __forceinline__ bool valid() const { return v < nvec; }
  __device__ __forceinline__ size_t addr() const {
    return base + (size_t)o * ostride + (size_t)r * VEC;
  }
  // channel of lane j of the current vector
  __device__ __forceinline__ int channel(int j) const {
    return CF ? ch0 + o : ch0 + r * VEC + j;
  }
  // the element's index inside the group, run-major (for the backward's
  // staging; `ld` floats a run)
  __device__ __forceinline__ int local(int j, int ld) const {
    return o * ld + r * VEC + j;
  }
  __device__ __forceinline__ void next(int T) {
    v += T;
    o += dq;
    r += dr;
    if (r >= inner_v) {
      r -= inner_v;
      ++o;
    }
  }
};

template <int VEC>
__device__ __forceinline__ void load(const float* __restrict__ p, float* v) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* __restrict__ p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// Sums a and b over the block; every thread gets the same totals, added in
// warp order. `red` holds 64 floats; one call per kernel.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < nw; ++w) {
    a += red[w];
    b += red[32 + w];
  }
}

// -------------------------------------------------------------------------
// Forward
// -------------------------------------------------------------------------

template <bool CF, int VEC>
__device__ __forceinline__ void emit(const float* q, const Walk<CF, VEC>& w,
                                     float mean, float rstd, int s,
                                     float* __restrict__ out,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ te,
                                     int te_stride,
                                     const float* __restrict__ res) {
  float y[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = w.channel(j);
    float h = mish((q[j] - mean) * rstd * scale[c] + bias[c]);
    if (te != nullptr) h += te[(size_t)s * te_stride + c];
    y[j] = h;
  }
  const size_t a = w.addr();
  if (res != nullptr) {
    float rv[VEC];
    load<VEC>(res + a, rv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) y[j] += rv[j];
  }
  store<VEC>(out + a, y);
}

// NV > 0: the register route, NV vectors a thread; NV == 0: the looped route.
template <bool CF, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
    gn_mish_fwd(const float* __restrict__ x, float* __restrict__ out,
                const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ te,
                int te_stride, const float* __restrict__ res,
                float* __restrict__ stats, int C, int seg, int groups,
                float eps) {
  __shared__ float red[64];
  const int s = blockIdx.x, g = blockIdx.y, t = threadIdx.x, T = blockDim.x;
  const int cg = C / groups;
  const float n = (float)(seg * cg);
  const Walk<CF, VEC> w0(s, g, C, seg, cg, t, T);

  float s1 = 0.f, s2 = 0.f;
  float v[NV > 0 ? NV : 1][VEC];
  Walk<CF, VEC> w = w0;
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (w.valid()) {
        load<VEC>(x + w.addr(), v[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s1 += v[k][j];
          s2 += v[k][j] * v[k][j];
        }
      }
      w.next(T);
    }
  } else {
    for (; w.valid(); w.next(T)) {
      load<VEC>(x + w.addr(), v[0]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s1 += v[0][j];
        s2 += v[0][j] * v[0][j];
      }
    }
  }
  block_sum2(s1, s2, red);
  const float mean = s1 / n;
  const float var = s2 / n - mean * mean;
  const float rstd = rsqrtf(var + eps);
  if (stats != nullptr && t == 0) {
    stats[((size_t)s * groups + g) * 2] = mean;
    stats[((size_t)s * groups + g) * 2 + 1] = rstd;
  }

  w = w0;
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (w.valid())
        emit<CF, VEC>(v[k], w, mean, rstd, s, out, scale, bias, te,
                      te_stride, res);
      w.next(T);
    }
  } else {
    for (; w.valid(); w.next(T)) {
      load<VEC>(x + w.addr(), v[0]);
      emit<CF, VEC>(v[0], w, mean, rstd, s, out, scale, bias, te, te_stride,
                    res);
    }
  }
}

// -------------------------------------------------------------------------
// Backward
// -------------------------------------------------------------------------

// x^, gy and gy * scale of one vector.
template <bool CF, int VEC>
__device__ __forceinline__ void grad_terms(const float* xv, const float* gv,
                                           const Walk<CF, VEC>& w, float mean,
                                           float rstd,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           float* xh, float* gy, float* gs) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = w.channel(j);
    xh[j] = (xv[j] - mean) * rstd;
    gy[j] = gv[j] * mish_grad(xh[j] * scale[c] + bias[c]);
    gs[j] = gy[j] * scale[c];
  }
}

// Writes this (segment, group)'s per-channel sums of gy * x^, gy and g
// into planes 0-2 of `part` ((planes, S, C)), reading the group again from
// global memory: the looped route's channel pass.
template <bool CF>
__device__ void channel_sums_global(const float* __restrict__ x,
                                    const float* __restrict__ gout,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias,
                                    float mean, float rstd,
                                    float* __restrict__ part, int planes,
                                    int S, int s, int g, int C, int seg,
                                    int cg) {
  const size_t grp = CF ? ((size_t)s * C + (size_t)g * cg) * seg
                        : (size_t)s * seg * C + (size_t)g * cg;
  for (int c = threadIdx.x; c < cg; c += blockDim.x) {
    const int ch = g * cg + c;
    float p0 = 0.f, p1 = 0.f, p2 = 0.f;
    for (int l = 0; l < seg; ++l) {
      const size_t a = CF ? grp + (size_t)c * seg + l
                          : grp + (size_t)l * C + c;
      const float xh = (x[a] - mean) * rstd;
      const float gy = gout[a] * mish_grad(xh * scale[ch] + bias[ch]);
      p0 += gy * xh;
      p1 += gy;
      p2 += gout[a];
    }
    const size_t o = (size_t)s * C + ch;
    part[o] = p0;
    part[(size_t)S * C + o] = p1;
    if (planes > 2) part[2 * (size_t)S * C + o] = p2;
  }
}

template <bool CF, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
    gn_mish_bwd(const float* __restrict__ x, const float* __restrict__ gout,
                const float* __restrict__ scale,
                const float* __restrict__ bias,
                const float* __restrict__ stats, float* __restrict__ dx,
                float* __restrict__ part, int planes, int C, int seg,
                int groups) {
  __shared__ float red[64];
  extern __shared__ float stage[];  // register route: planes x cg x ld
  const int s = blockIdx.x, g = blockIdx.y, t = threadIdx.x, T = blockDim.x;
  const int S = gridDim.x;
  const int cg = C / groups;
  const float n = (float)(seg * cg);
  const float mean = stats[((size_t)s * groups + g) * 2];
  const float rstd = stats[((size_t)s * groups + g) * 2 + 1];
  const Walk<CF, VEC> w0(s, g, C, seg, cg, t, T);
  // staging: run-major, `ld` floats a run; channels-first pads an even run
  // by one so that thread c's reads of channel c do not share a bank
  const int ld = CF ? (seg + 1 - (seg & 1)) : cg;
  const int plane = CF ? cg * ld : seg * cg;

  float a = 0.f, b = 0.f;
  float xh[NV > 0 ? NV : 1][VEC], gs[NV > 0 ? NV : 1][VEC];
  Walk<CF, VEC> w = w0;
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (w.valid()) {
        float xv[VEC], gv[VEC], gy[VEC];
        load<VEC>(x + w.addr(), xv);
        load<VEC>(gout + w.addr(), gv);
        grad_terms<CF, VEC>(xv, gv, w, mean, rstd, scale, bias, xh[k], gy,
                            gs[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          a += gs[k][j];
          b += gs[k][j] * xh[k][j];
          const int e = w.local(j, ld);
          stage[e] = gy[j] * xh[k][j];
          stage[plane + e] = gy[j];
          if (planes > 2) stage[2 * plane + e] = gv[j];
        }
      }
      w.next(T);
    }
  } else {
    for (; w.valid(); w.next(T)) {
      float xv[VEC], gv[VEC], gy[VEC];
      load<VEC>(x + w.addr(), xv);
      load<VEC>(gout + w.addr(), gv);
      grad_terms<CF, VEC>(xv, gv, w, mean, rstd, scale, bias, xh[0], gy,
                          gs[0]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        a += gs[0][j];
        b += gs[0][j] * xh[0][j];
      }
    }
  }
  block_sum2(a, b, red);  // its barrier also ends the staging
  const float ma = a / n, mb = b / n;

  w = w0;
  if constexpr (NV > 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (w.valid()) {
        float d[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          d[j] = rstd * (gs[k][j] - ma - xh[k][j] * mb);
        store<VEC>(dx + w.addr(), d);
      }
      w.next(T);
    }
    // per channel, in a fixed order over the segment's positions
    const int step = CF ? 1 : cg;  // from one position to the next
    for (int c = t; c < cg; c += T) {
      const int e0 = CF ? c * ld : c;
      float p0 = 0.f, p1 = 0.f, p2 = 0.f;
      for (int l = 0; l < seg; ++l) {
        const int e = e0 + l * step;
        p0 += stage[e];
        p1 += stage[plane + e];
        if (planes > 2) p2 += stage[2 * plane + e];
      }
      const size_t o = (size_t)s * C + g * cg + c;
      part[o] = p0;
      part[(size_t)S * C + o] = p1;
      if (planes > 2) part[2 * (size_t)S * C + o] = p2;
    }
  } else {
    for (; w.valid(); w.next(T)) {
      float xv[VEC], gv[VEC], gy[VEC], d[VEC];
      load<VEC>(x + w.addr(), xv);
      load<VEC>(gout + w.addr(), gv);
      grad_terms<CF, VEC>(xv, gv, w, mean, rstd, scale, bias, xh[0], gy,
                          gs[0]);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        d[j] = rstd * (gs[0][j] - ma - xh[0][j] * mb);
      store<VEC>(dx + w.addr(), d);
    }
    channel_sums_global<CF>(x, gout, scale, bias, mean, rstd, part, planes,
                            S, s, g, C, seg, cg);
  }
}

// out_p[c] = sum over s of part[p][s][c], for the planes whose output is
// not null; 32 channels a block, 8 warps each summing every 8th segment,
// then the 8 partials in warp order.
__global__ void __launch_bounds__(kThreads)
    gn_mish_channel_sums(const float* __restrict__ part, int planes, int S,
                         int C, float* __restrict__ out0,
                         float* __restrict__ out1, float* __restrict__ out2) {
  __shared__ float acc[8][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  for (int p = 0; p < planes; ++p) {
    float* dst = p == 0 ? out0 : (p == 1 ? out1 : out2);
    if (dst == nullptr) continue;
    float v = 0.f;
    if (c < C) {
#pragma unroll 8
      for (int s = warp; s < S; s += 8) v += part[((size_t)p * S + s) * C + c];
    }
    acc[warp][lane] = v;
    __syncthreads();
    if (warp == 0 && c < C) {
      float tot = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) tot += acc[k][lane];
      dst[c] = tot;
    }
    __syncthreads();
  }
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// Launchers. vec 4 with nv 1 or 2, or vec 1 with nv 1, 2, 4 or 8 (the
// register route: REG_MAX floats over 256 threads), or nv 0 (looped);
// threads a multiple of 32 up to 256. A combination the kernels do not
// take, or a vec of 4 on a misaligned pointer, returns cudaErrorInvalidValue.

#define DADIFF_GN_ROUTE(KERNEL, CF, ...)                                 \
  do {                                                                  \
    if (vec == 4) {                                                     \
      switch (nv) {                                                     \
        case 0: KERNEL<CF, 4, 0><<<grid, threads, smem, st>>>(__VA_ARGS__); break; \
        case 1: KERNEL<CF, 4, 1><<<grid, threads, smem, st>>>(__VA_ARGS__); break; \
        case 2: KERNEL<CF, 4, 2><<<grid, threads, smem, st>>>(__VA_ARGS__); break; \
        default: return (int)cudaErrorInvalidValue;                     \
      }                                                                 \
    } else {                                                            \
      switch (nv) {                                                     \
        case 0: KERNEL<CF, 1, 0><<<grid, threads, smem, st>>>(__VA_ARGS__); break; \
        case 1: KERNEL<CF, 1, 1><<<grid, threads, smem, st>>>(__VA_ARGS__); break; \
        case 2: KERNEL<CF, 1, 2><<<grid, threads, smem, st>>>(__VA_ARGS__); break; \
        case 4: KERNEL<CF, 1, 4><<<grid, threads, smem, st>>>(__VA_ARGS__); break; \
        case 8: KERNEL<CF, 1, 8><<<grid, threads, smem, st>>>(__VA_ARGS__); break; \
        default: return (int)cudaErrorInvalidValue;                     \
      }                                                                 \
    }                                                                   \
  } while (0)

static bool bad_route(int vec, int threads, int C, int groups) {
  return (vec != 4 && vec != 1) || threads < 32 || threads > kThreads ||
         threads % 32 != 0 || C % groups != 0;
}

// x, out, res: n_seg segments of seg positions by C channels, in the
// layout `channels_first` names; te: null or rows of C at stride te_stride
// (0: one shared row); stats: null or (n_seg, groups, 2) of (mean, rstd).
extern "C" int gn_mish(const float* x, float* out, const float* scale,
                       const float* bias, const float* te, int te_stride,
                       const float* res, float* stats, int n_seg, int seg,
                       int C, int groups, float eps, int channels_first,
                       int vec, int nv, int threads, void* stream) {
  if (bad_route(vec, threads, C, groups) ||
      (vec == 4 && !(aligned(x) && aligned(out) &&
                     (res == nullptr || aligned(res)))))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_seg, groups);
  const size_t smem = 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (channels_first)
    DADIFF_GN_ROUTE(gn_mish_fwd, true, x, out, scale, bias, te, te_stride,
                    res, stats, C, seg, groups, eps);
  else
    DADIFF_GN_ROUTE(gn_mish_fwd, false, x, out, scale, bias, te, te_stride,
                    res, stats, C, seg, groups, eps);
  return (int)cudaGetLastError();
}

// g: the gradient of out, in x's layout; stats: the forward's; dx: like x;
// part: (planes, n_seg, C) scratch, planes 2, or 3 when te needs its
// gradient (plane 2 then holds each segment's sum of g: a per-segment te's
// gradient); dscale, dbias: (C,); dte: null, or (C,) for a shared te.
// Two launches: the group pass, then the channel sums over segments.
extern "C" int gn_mish_backward(const float* x, const float* g,
                                const float* scale, const float* bias,
                                const float* stats, float* dx, float* part,
                                float* dscale, float* dbias, float* dte,
                                int planes, int n_seg, int seg, int C,
                                int groups, int channels_first, int vec,
                                int nv, int threads, void* stream) {
  if (bad_route(vec, threads, C, groups) || planes < 2 || planes > 3 ||
      (vec == 4 && !(aligned(x) && aligned(g) && aligned(dx))))
    return (int)cudaErrorInvalidValue;
  const int cg = C / groups;
  const int ld = channels_first ? (seg + 1 - (seg & 1)) : cg;
  const int per_plane = channels_first ? cg * ld : seg * cg;
  const dim3 grid(n_seg, groups);
  const size_t smem =
      nv > 0 ? (size_t)planes * per_plane * sizeof(float) : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (channels_first)
    DADIFF_GN_ROUTE(gn_mish_bwd, true, x, g, scale, bias, stats, dx, part,
                    planes, C, seg, groups);
  else
    DADIFF_GN_ROUTE(gn_mish_bwd, false, x, g, scale, bias, stats, dx, part,
                    planes, C, seg, groups);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  gn_mish_channel_sums<<<(C + 31) / 32, kThreads, 0, st>>>(
      part, planes, n_seg, C, dscale, dbias, dte);
  return (int)cudaGetLastError();
}
