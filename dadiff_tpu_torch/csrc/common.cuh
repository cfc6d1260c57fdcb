// Device routines shared by the port's kernels, so that the per-layer
// kernels (gn_mish.cu, planner.cu), the one-launch chain (chain.cu) and the
// fused residual block (resblock.cu) compile from one source of truth:
//
//   mish, warp_sum        the activation and the warp reduction of K1;
//   tap_row, in_row,      the row and tap arithmetic of the U-Net's convs over
//   weight_tap, out_row   row-stacked chains (zero padding per segment);
//   MmaTile, F32Tile      one output tile of a conv as an implicit
//                         shifted-stack GEMM over a K range (below);
//   split_k_last,         split-K partial tiles summed in split order, by
//   sum_partials          the tile's last block or by the op that consumes them;
//   ddpm_update           the DDPM reverse-step arithmetic on one element.
//
// The conv tile product replaces _conv_stack (:184), _shift_rows (:161),
// _even_rows (:243) and _interleave_rows (:248) of the JAX package's
// ops/pallas_unet.py: a k-tap SAME conv, the k=3 stride-2 conv and the k=4
// stride-2 transposed conv (as two parities of two taps) over row-stacked
// chains, on the channel concat [xa | xb], with f32 accumulation. The TPU
// builds the shifted stack in VMEM and feeds one large matmul; here the
// stack is never built: K = tap * cin + ci indexes it, and a tile's loads
// gather it from the activations.
//
// What bounds it on an H100: at the shapes these tiles serve (8-2,048 rows
// of the served 8-chain wave, the 64-chain chain and the batch-1 chain, by
// 128-512 channels, K up to 5120) a conv is a few MFLOP to a few GFLOP
// against up to 5 MB of bf16 weights that stay in the 50 MB L2, so it is
// bound by the latency and the bandwidth of L2, far under the tensor cores'
// peak. (From 8,192 rows on, the 1,024-chain wave's convs, the planner
// takes WgTile of wgmma.cuh instead: see there.) The design therefore
// - keeps loads in flight: a ring of 2-5 shared-memory stages; both
//   operands of tiles k+1.. travel global -> shared with cp.async (16 bytes
//   a thread) while tile k is multiplied; one __syncthreads per K tile. The
//   activations travel as f32, as they lie in memory: staging them through
//   registers to round them first leaves their load latency exposed in
//   every K tile;
// - hoists the row arithmetic: BK = 32 divides every cin but the first
//   conv's 8, so a K tile lies inside one tap and one of xa/xb, and the tap,
//   the input row and the source are found once per row per tile, the
//   segment of a row once per item. The first conv (K = 40) takes the ragged
//   path, element by element;
// - bf16 weights: the activations are rounded to bf16 as the fragments are
//   built from shared memory (the TPU kernels cast them before every
//   product; the plain version rounds the same values) and the product runs
//   on the tensor cores, mma.sync.m16n8k16 bf16 x bf16 -> f32, the weights
//   fed by ldmatrix.trans; rows are padded (160 and 2*BN+16 bytes) so that
//   neither operand's reads conflict. mma.sync and not wgmma at these
//   shapes: the batch-1 chain has 32, 16 and 8 rows and a wgmma tile has
//   64, and at 8 chains 16-row tiles beat 64-row ones (more blocks, each
//   with its own loads in flight);
// - f32 weights: the same pipeline and the product in full f32 on the CUDA
//   cores (fmaf, K ascending; no TF32).
// Tile shapes (rows x columns) are chosen by the host, ops/conv_tiling.py
// tile_shape: the smallest of 16x64, 32x64, 64x64, 64x128 that leaves no
// more output tiles than the card has room for blocks (at these sizes more,
// smaller blocks beat fewer re-reads: a sweep on the card put 16x64 first at
// every conv of the flagship at 8 chains); 32x32 for f32 weights.
// ops/planner.py _split_k takes these for the served waves' convs with
// little work (ClusterTile of wgmma.cuh takes the rest), and the 128-row
// wgmma tile once 64x128 would leave more blocks than the card has SMs.
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

constexpr int BK = 32;         // K tile: two k16 steps of mma.sync
constexpr int kThreads = 256;  // 8 warps
// shared memory of the conv ring, static: under the 48 KB a kernel may use
// without opting in, with room for the callers' own few hundred bytes
constexpr int kConvSmemBytes = 47104;

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

// Row inside its segment that feeds local output row l through virtual tap
// j; outside [0, seg_in) it is a zero pad. For kDown l counts output rows.
__device__ __forceinline__ int tap_row(int mode, int l, int j, int parity,
                                       int k) {
  if (mode == kDown) return 2 * l + j - 1;
  if (mode == kSame) return l + j - k / 2;
  // even rows: x[h] R1 + x[h-1] R3; odd rows: x[h+1] R0 + x[h] R2
  return parity == 0 ? (j == 0 ? l : l - 1) : (j == 0 ? l + 1 : l);
}

// Input row feeding GEMM row m through virtual tap j, or -1 for a zero pad.
__device__ __forceinline__ int in_row(int mode, int m, int j, int parity,
                                      int seg_in, int k) {
  const int seg_m = mode == kDown ? seg_in >> 1 : seg_in;
  const int s = m / seg_m;
  const int li = tap_row(mode, m - s * seg_m, j, parity, k);
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

// One conv: the channel concat [xa | xb] (xb may be null) of rows_in rows in
// segments of seg_in, M GEMM rows, cout columns (a multiple of 8).
struct ConvIn {
  const float* xa;
  const float* xb;
  int cin_a, cin_b, M, seg_in, cout, mode, k;
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, past L1 (another block of the same launch may
// have written the source)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

// The activation x[r, ci] of the concat, read through L2.
__device__ __forceinline__ const float* act_ptr(const ConvIn& c, int r, int ci) {
  return ci < c.cin_a ? c.xa + (size_t)r * c.cin_a + ci
                      : c.xb + (size_t)r * c.cin_b + (ci - c.cin_a);
}

// Element kg of the shifted stack for GEMM row m (ragged path).
__device__ __forceinline__ float stack_elem(const ConvIn& c, int m, int kg,
                                            int parity) {
  const int cin = c.cin_a + c.cin_b;
  const int j = kg / cin, ci = kg - j * cin;
  const int r = in_row(c.mode, m, j, parity, c.seg_in, c.k);
  return r >= 0 ? __ldcg(act_ptr(c, r, ci)) : 0.f;
}

// Weight row of stack index kg.
__device__ __forceinline__ size_t weight_row(const ConvIn& c, int kg,
                                             int parity) {
  const int cin = c.cin_a + c.cin_b;
  const int j = kg / cin;
  return (size_t)weight_tap(c.mode, j, parity) * cin + (kg - j * cin);
}

// A K tile lies inside one tap and one of xa/xb, and rows are 16-byte
// vectors: true for every conv but the first (cin = 8).
__device__ __forceinline__ bool aligned_k(const ConvIn& c) {
  return c.cin_a % BK == 0 && c.cin_b % BK == 0;
}

// ---- bf16 weights: tensor cores -------------------------------------------
//
// acc += sum over K in [k_begin, k_end) of
//   bf16(x[in_row(m0 + m, j), ci]) * w[weight_tap(j) * cin + ci, n0 + n]
// with K = j * cin + ci and k_begin a multiple of BK, for a BM_ x BN_ tile
// by a 256-thread block. Warp (wm, wn) of WM x WN owns rows 16*wm.. and
// columns WTN*wn..; its accumulators are NI m16n8 fragments.
template <int BM_, int BN_>
struct MmaTile {
  using W = __nv_bfloat16;
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WM = BM / 16, WN = 8 / WM;
  static constexpr int WTN = BN / WN, NI = WTN / 8;
  static constexpr int ACC = NI * 4;
  // padded rows: A in floats (rounded as fragments are built), B in bf16
  static constexpr int A_LD = BK + 8, B_LD = BN + 8;
  static constexpr int A_BYTES = BM * A_LD * 4, B_BYTES = BK * B_LD * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      kConvSmemBytes / STAGE < 5 ? kConvSmemBytes / STAGE : 5;
  static constexpr int A_ITERS = (BM * (BK / 4) + kThreads - 1) / kThreads;
  static_assert(WM * WN == 8 && NI >= 1 && (NI == 1 || NI % 2 == 0), "tile");
  static_assert(STAGES >= 2, "ring");

  static __device__ __forceinline__ void product(
      const ConvIn& c, const W* __restrict__ w, int parity, int m0, int n0,
      int k_begin, int k_end, unsigned char* smem, float (&acc)[ACC]) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp % WM, wn = warp / WM;
    const int cin = c.cin_a + c.cin_b;
    const bool vec = aligned_k(c);
    const int nk = (k_end - k_begin + BK - 1) / BK;

    // this thread's share of an A tile: 4 channels of A_ITERS rows, whose
    // segment and row inside it are found once
    const int ak = (tid & 7) * 4;
    const int seg_m = c.mode == kDown ? c.seg_in >> 1 : c.seg_in;
    int a_l[A_ITERS], a_base[A_ITERS];  // a_base < 0: no such row
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int am = (tid >> 3) + i * (kThreads / 8);
      const int m = m0 + am;
      const int seg_i = m / seg_m;
      a_l[i] = m - seg_i * seg_m;
      a_base[i] = (am < BM && m < c.M) ? seg_i * c.seg_in : -1;
    }

    auto a_of = [&](int s) { return (float*)(smem + s * STAGE); };
    auto b_of = [&](int s) { return (W*)(smem + s * STAGE + A_BYTES); };

    auto load = [&](int kt, int s) {
      const int kg = k_begin + kt * BK;
      const int j = kg / cin, ci = kg - j * cin + ak;  // if vec: the tile's tap
#pragma unroll
      for (int i = 0; i < A_ITERS; ++i) {
        const int am = (tid >> 3) + i * (kThreads / 8);
        if (am >= BM) break;
        float* dst = a_of(s) + am * A_LD + ak;
        const float* src = nullptr;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (a_base[i] >= 0) {
          if (vec) {
            const int li = tap_row(c.mode, a_l[i], j, parity, c.k);
            if (li >= 0 && li < c.seg_in) src = act_ptr(c, a_base[i] + li, ci);
          } else {
            float e[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              e[q] = kg + ak + q < k_end
                         ? stack_elem(c, m0 + am, kg + ak + q, parity)
                         : 0.f;
            v = make_float4(e[0], e[1], e[2], e[3]);
          }
        }
        if (src != nullptr)
          cp_async16(dst, src);
        else
          *reinterpret_cast<float4*>(dst) = v;
      }
      constexpr int kChunksRow = BN / 8;
#pragma unroll
      for (int i = 0; i < BK * kChunksRow / kThreads; ++i) {
        const int ch = tid + i * kThreads;
        const int kk = ch / kChunksRow, nn = (ch % kChunksRow) * 8;
        W* dst = b_of(s) + kk * B_LD + nn;
        const int kgb = kg + kk, n = n0 + nn;
        if (kgb < k_end && n < c.cout)
          cp_async16(dst, w + weight_row(c, kgb, parity) * c.cout + n);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s, s);
      cp_async_commit();
    }
    // fragment coordinates of this lane: A rows g and g + 8, columns 2t..;
    // B through ldmatrix: row within 16, column block of 8
    const int g = lane >> 2, t = lane & 3;
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt landed
      __syncthreads();  // everyone's did, and everyone is done with tile kt-1
      const int pf = kt + STAGES - 1;  // goes into the stage tile kt-1 left
      if (pf < nk) load(pf, pf % STAGES);
      cp_async_commit();
      const float* as = a_of(kt % STAGES) + (wm * 16 + g) * A_LD + 2 * t;
      const W* bs = b_of(kt % STAGES);
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        // the activations become bf16 here, as the TPU casts them before
        // every product
        const float2 x0 = *reinterpret_cast<const float2*>(as + ks);
        const float2 x1 = *reinterpret_cast<const float2*>(as + 8 * A_LD + ks);
        const float2 x2 = *reinterpret_cast<const float2*>(as + ks + 8);
        const float2 x3 =
            *reinterpret_cast<const float2*>(as + 8 * A_LD + ks + 8);
        const unsigned af[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                                pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
        if constexpr (NI == 1) {
          unsigned bf[2];
          ldsm_x2_trans(bf, smem_u32(bs + (ks + (lane & 15)) * B_LD + wn * WTN));
          mma_bf16(acc, af, bf[0], bf[1]);
        } else {
#pragma unroll
          for (int ni = 0; ni < NI; ni += 2) {
            unsigned bf[4];
            ldsm_x4_trans(bf, smem_u32(bs + (ks + lrow) * B_LD + wn * WTN +
                                       ni * 8 + lcol));
            mma_bf16(acc + ni * 4, af, bf[0], bf[1]);
            mma_bf16(acc + ni * 4 + 4, af, bf[2], bf[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the caller's next tile
  }

  // f(m, n, v0, v1) on every pair of neighbouring columns (n even) that
  // this thread holds of the tile at (m0, n0); f may change v0, v1.
  template <class F>
  static __device__ __forceinline__ void pairs(float (&acc)[ACC], int m0,
                                               int n0, F f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int m = m0 + (warp % WM) * 16 + (lane >> 2);
    const int n = n0 + (warp / WM) * WTN + 2 * (lane & 3);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      f(m, n + ni * 8, acc[ni * 4], acc[ni * 4 + 1]);
      f(m + 8, n + ni * 8, acc[ni * 4 + 2], acc[ni * 4 + 3]);
    }
  }
};

// ---- f32 weights: CUDA cores, full f32 ------------------------------------
//
// The same sum with f32 activations and weights: a 32x32 tile, 2x2 outputs
// per thread (rows ty and ty + 16, columns 2tx and 2tx + 1), fmaf over K
// ascending. Both operands travel with cp.async. At the batch-1 shapes
// (8-32 rows) a block's K loop is bound by instruction latency, not bytes:
// the loads find their addresses without a division (the next tile's tap
// and weight row advance one tile at a time), and rows past M skip the
// products, so at 8 rows four warps, one on each scheduler, do them.
struct F32Tile {
  using W = float;
  static constexpr int BM = 32, BN = 32, ACC = 4;
  static constexpr int A_LD = BK + 4;  // padded rows, in floats
  static constexpr int A_BYTES = BM * A_LD * 4, B_BYTES = BK * BN * 4;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = 4;
  static_assert(STAGES * STAGE <= kConvSmemBytes, "ring");

  // acc += the K tile: A rows at `as` (and 16 rows on, if TWO) times the B
  // columns at `bs`, k ascending
  template <bool TWO>
  static __device__ __forceinline__ void mac(const float* as, const float* bs,
                                             float& a00, float& a01,
                                             float& a10, float& a11) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk);
      const float4 a1 =
          TWO ? *reinterpret_cast<const float4*>(as + 16 * A_LD + kk) : a0;
      const float a0v[4] = {a0.x, a0.y, a0.z, a0.w};
      const float a1v[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 b = *reinterpret_cast<const float2*>(bs + (kk + i) * BN);
        a00 = fmaf(a0v[i], b.x, a00);
        a01 = fmaf(a0v[i], b.y, a01);
        if (TWO) {
          a10 = fmaf(a1v[i], b.x, a10);
          a11 = fmaf(a1v[i], b.y, a11);
        }
      }
    }
  }

  static __device__ __forceinline__ void product(
      const ConvIn& c, const W* __restrict__ w, int parity, int m0, int n0,
      int k_begin, int k_end, unsigned char* smem, float (&acc)[ACC]) {
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;  // outputs (ty.., 2tx..)
    const int cin = c.cin_a + c.cin_b;
    const bool vec = aligned_k(c);
    const int nk = (k_end - k_begin + BK - 1) / BK;

    // this thread's share of an A tile (4 channels of one row) and of a B
    // tile (4 columns of one K row)
    const int am = tid >> 3, ak = (tid & 7) * 4;
    const int m = m0 + am;
    const bool a_row = m < c.M;
    const int seg_m = c.mode == kDown ? c.seg_in >> 1 : c.seg_in;
    const int seg_i = a_row ? m / seg_m : 0;
    const int l = m - seg_i * seg_m, seg_base = seg_i * c.seg_in;
    const int bk = tid >> 3, bn = (tid & 7) * 4;
    const bool b_col = n0 + bn < c.cout;

    auto a_of = [&](int s) { return (float*)(smem + s * STAGE); };
    auto b_of = [&](int s) { return (float*)(smem + s * STAGE + A_BYTES); };

    // aligned path: the tap, the channel within the tap and the first
    // weight row of the next K tile to load (a K tile lies inside one tap)
    int nj = k_begin / cin, nci = k_begin - nj * cin;
    int nrow = weight_tap(c.mode, nj, parity) * cin + nci;
    int nli = tap_row(c.mode, l, nj, parity, c.k);

    auto load = [&](int kt, int s) {  // called for kt = 0, 1, 2, ... in turn
      const int kg = k_begin + kt * BK;
      float* da = a_of(s) + am * A_LD + ak;
      float* db = b_of(s) + bk * BN + bn;
      if (vec) {
        if (a_row && nli >= 0 && nli < c.seg_in)
          cp_async16(da, act_ptr(c, seg_base + nli, nci + ak));
        else
          *reinterpret_cast<float4*>(da) = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kg + bk < k_end && b_col)
          cp_async16(db, w + (size_t)(nrow + bk) * c.cout + n0 + bn);
        else
          *reinterpret_cast<float4*>(db) = make_float4(0.f, 0.f, 0.f, 0.f);
        nci += BK;
        nrow += BK;
        if (nci == cin) {
          nci = 0;
          ++nj;
          nrow = weight_tap(c.mode, nj, parity) * cin;
          nli = tap_row(c.mode, l, nj, parity, c.k);
        }
        return;
      }
      float e[4];  // ragged: element by element
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = a_row && kg + ak + i < k_end
                   ? stack_elem(c, m, kg + ak + i, parity)
                   : 0.f;
      *reinterpret_cast<float4*>(da) = make_float4(e[0], e[1], e[2], e[3]);
      const int kgb = kg + bk;
      if (kgb < k_end && b_col)
        cp_async16(db, w + weight_row(c, kgb, parity) * c.cout + n0 + bn);
      else
        *reinterpret_cast<float4*>(db) = make_float4(0.f, 0.f, 0.f, 0.f);
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s, s);
      cp_async_commit();
    }
    // rows past M take part in the loads and barriers but not the products
    const bool live = m0 + ty < c.M, two = m0 + ty + 16 < c.M;
    float acc00 = acc[0], acc01 = acc[1], acc10 = acc[2], acc11 = acc[3];
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int pf = kt + STAGES - 1;
      if (pf < nk) load(pf, pf % STAGES);
      cp_async_commit();
      const float* as = a_of(kt % STAGES) + ty * A_LD;
      const float* bs = b_of(kt % STAGES) + 2 * tx;
      if (two)
        mac<true>(as, bs, acc00, acc01, acc10, acc11);
      else if (live)
        mac<false>(as, bs, acc00, acc01, acc10, acc11);
    }
    cp_async_wait<0>();
    __syncthreads();
    acc[0] = acc00;
    acc[1] = acc01;
    acc[2] = acc10;
    acc[3] = acc11;
  }

  template <class F>
  static __device__ __forceinline__ void pairs(float (&acc)[ACC], int m0,
                                               int n0, F f) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    f(m0 + ty, n0 + 2 * tx, acc[0], acc[1]);
    f(m0 + ty + 16, n0 + 2 * tx, acc[2], acc[3]);
  }
};

// Runs the statement(s) given last with `Tile` naming the tile the host
// chose (ops/conv_tiling.py tile_shape); sets ok to false if there is no
// such tile.
#define DADIFF_WITH_TILE(w_bf16, bm, bn, ok, ...)              \
  do {                                                         \
    ok = true;                                                 \
    if (!(w_bf16) && (bm) == 32 && (bn) == 32) {               \
      using Tile = dadiff::F32Tile;                            \
      __VA_ARGS__;                                             \
    } else if ((w_bf16) && (bm) == 64 && (bn) == 128) {        \
      using Tile = dadiff::MmaTile<64, 128>;                   \
      __VA_ARGS__;                                             \
    } else if ((w_bf16) && (bm) == 64 && (bn) == 64) {         \
      using Tile = dadiff::MmaTile<64, 64>;                    \
      __VA_ARGS__;                                             \
    } else if ((w_bf16) && (bm) == 32 && (bn) == 64) {         \
      using Tile = dadiff::MmaTile<32, 64>;                    \
      __VA_ARGS__;                                             \
    } else if ((w_bf16) && (bm) == 16 && (bn) == 64) {         \
      using Tile = dadiff::MmaTile<16, 64>;                    \
      __VA_ARGS__;                                             \
    } else {                                                   \
      ok = false;                                              \
    }                                                          \
  } while (0)

// Sums over splits of partial[sp][idx], in split order. The loads of
// kBatch splits are started together, since each is an L2 round trip; a split
// past the last adds 0, so a fan-in of up to kBatch is one round trip.
constexpr int kBatch = 16;

__device__ __forceinline__ float sum_partials(const float* partial, int splits,
                                              size_t plane, size_t idx) {
  const float* p = partial + idx;
  float s = 0.f;
  for (int sp = 0; sp < splits; sp += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      v[i] = sp + i < splits ? __ldcg(p + (sp + i) * plane) : 0.f;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) s += v[i];
  }
  return s;
}

// Split-K across blocks, deterministic. Every block of an output tile
// stores its partial tile into its plane of `partial` ([parity][split][M]
// [cout]) and counts its arrival; the block that arrives last returns true
// with acc = the sum of the tile's partials in split order, so the result
// does not depend on which block that is. Eight splits are loaded at a time
// for all of a thread's pairs: independent loads, one round trip to L2. The
// counter (zero before the first arrival) is left at zero. `sync` joins the
// threads that hold the tile (the whole block, or wgmma's consumers), thread
// 0 among them.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

template <class Tile, class Sync = BlockSync>
__device__ __forceinline__ bool split_k_last(float (&acc)[Tile::ACC],
                                             float* partial, int parity,
                                             int split, int splits, int M,
                                             int cout, int m0, int n0,
                                             unsigned int* counter,
                                             Sync sync = Sync()) {
  const size_t plane = (size_t)M * cout;
  float* mine = partial + (size_t)(parity * splits + split) * plane;
  Tile::pairs(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
    if (m < M && n < cout)
      *reinterpret_cast<float2*>(mine + (size_t)m * cout + n) =
          make_float2(v0, v1);
  });
  __threadfence();
  sync();
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1u) == (unsigned)splits - 1;
  sync();
  if (!last) return false;
  __threadfence();
  const float* first = partial + (size_t)parity * splits * plane;
  Tile::pairs(acc, m0, n0,
              [](int, int, float& v0, float& v1) { v0 = v1 = 0.f; });
  for (int sp0 = 0; sp0 < splits; sp0 += 8)
    Tile::pairs(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
      const bool in = m < M && n < cout;
      const float* p =
          first + sp0 * plane + (in ? (size_t)m * cout + n : (size_t)0);
      float2 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = in && sp0 + i < splits
                   ? __ldcg(reinterpret_cast<const float2*>(p + i * plane))
                   : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v0 += v[i].x;
        v1 += v[i].y;
      }
    });
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next conv
  return true;
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
