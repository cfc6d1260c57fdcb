// The conv tile product of K2 on Hopper's warpgroup MMA: at large row
// counts (the on-device evaluator's 1,024-chain wave: 8,192-32,768 GEMM
// rows) WgTile<BN, STAGES>, a 128 x BN output tile per block; at the
// served waves' rows ClusterTile (below), a 64 x 128 tile whose K splits
// meet in a thread-block cluster.
//
// Replaces, like MmaTile of common.cuh, the JAX package's
// ops/pallas_unet.py _conv_stack (:184) and _dot (:192) inside
// ops/pallas_planner.py make_pallas_planner_chain (:95): the same implicit
// shifted-stack GEMM, out[M, cout] = stack[M, K] @ w[K, cout], K = tap * cin
// + ci, with the activations rounded to bf16 where MmaTile rounds them.
//
// What bounds it on an H100: at 32,768 rows a step's 35 convs are 0.298
// TFLOP, 0.30 ms of tensor-core work at the bf16 peak, against ~0.40 ms of
// bytes moved once through HBM (activations f32 in and out, bf16 weights):
// the bytes bound it, and inside the card the f32 activations that every
// tap and every column tile reads again from L2. MmaTile, designed for
// 8-256 rows (common.cuh), moves its 16 KB per 0.5 MFLOP K tile with
// 16-byte cp.async from every thread and reached ~2 TB/s out of L2, 7-8% of
// the bf16 peak. The design here:
// - one block of 384 threads: warpgroup 2 produces, warpgroups 0 and 1
//   consume, each owning 64 of the tile's 128 rows (setmaxnreg moves the
//   registers to the consumers);
// - a ring of STAGES stages of BK = 64 in dynamic shared memory (~193-209
//   KB), each stage a full and an empty mbarrier, no __syncthreads in the K
//   loop;
// - both operands travel by TMA, issued by one thread, with the 128-byte
//   swizzle. B, the bf16 weights as they lie ((taps * cin, cout)
//   row-major), in boxes of 64 rows x 64 columns; wgmma reads it MN-major
//   (its transpose bit), so the weights are never repacked. A, the f32
//   activations as they lie, in boxes of 32 channels x the tile's rows,
//   through a 3-D map (channels, rows of a segment, segments), or a 4-D one
//   that takes every other row for the stride-2 conv: the tap's row shift
//   is a coordinate, and rows outside a segment read as zeros, the
//   per-segment SAME padding. Where a K tile does not lie in one tap (the
//   first conv's cin = 8) the producer warpgroup gathers A by cp.async
//   instead, into the same swizzled layout. The tensor maps are encoded by
//   the host at each launch from the very pointers they describe
//   (planner.cu weight_map, act_maps);
// - each consumer rounds its 64-row slice of A to bf16 in the registers of
//   wgmma's A fragment (where MmaTile rounds it): the register-A form,
//   m64nBNk16, bf16 x bf16 -> f32; the two consumer warpgroups take turns
//   on the tensor cores;
// - no split-K at these shapes (ops/planner.py): the GroupNorm of
//   rows_conv_gn then lives in the tile's own registers (planner.cu
//   wg_gn_epilogue).

#pragma once

#include <cuda.h>  // CUtensorMap (types only: no driver library is linked)

#include "common.cuh"

namespace dadiff {

// ---- PTX wrappers: mbarrier, cp.async with zero fill, TMA, wgmma ---------

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// the executing thread's earlier cp.async count as one arrival when done
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// 16 (or 4) bytes global -> shared; src_ok false writes zeros and reads
// nothing
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool src_ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool src_ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_ok ? 4 : 0)
               : "memory");
}

// a box of the 2-D tensor map at (column c0, row c1) into shared memory,
// completing on bar
__device__ __forceinline__ void tma_load_2d(void* smem, const CUtensorMap* map,
                                            int c0, int c1,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// boxes of 3- and 4-D tensor maps (the activations), coordinates
// innermost first
__device__ __forceinline__ void tma_load_3d(void* smem, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* smem, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory descriptor of a B operand stored MN-major with the 128-byte
// swizzle, as TMA writes it: rows of 128 bytes (64 columns) along K, the
// 8-row swizzle atoms 1024 bytes apart (stride byte offset), the 64-column
// boxes lbo bytes apart (leading byte offset).
__device__ __forceinline__ unsigned long long wg_desc_b128(const void* smem,
                                                          int lbo) {
  return (unsigned long long)((smem_u32(smem) & 0x3FFFF) >> 4) |
         ((unsigned long long)(lbo >> 4) << 16) |
         ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x N f32, this warpgroup's rows) += a (64 x 16 bf16, this thread's
// fragment as mma.sync m16n8k16 lays it out per warp) * B (16 x N bf16 at
// desc_b, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const unsigned (&a)[4],
                                              unsigned long long desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const unsigned (&a)[4],
                                              unsigned long long desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const unsigned (&a)[4],
                                         unsigned long long desc_b) {
  if constexpr (BN == 128)
    wgmma_rs_n128(d, a, desc_b);
  else
    wgmma_rs_n256(d, a, desc_b);
}

// Named barrier of the two consumer warpgroups (threads 0-255); barrier 0
// is __syncthreads.
struct ConsumerSync {
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }
};

// ---- the tile -------------------------------------------------------------
//
// acc += sum over K in [k_begin, k_end) of
//   bf16(x[in_row(m0 + m, j), ci]) * w[weight_tap(j) * cin + ci, n0 + n]
// for a 128 x BN tile; consumer thread ct (0-255) holds, as mma.sync's C
// fragments of warp (ct / 32), rows 64 * (ct / 128) + 16 * (ct / 32 % 4) + g
// and + 8 (g = lane / 4), columns 8 i + 2 t, + 1 (t = lane % 4).
//
// A stage holds B's BN / 64 boxes (BK rows x 128 bytes each), then A's
// 64 channels as two halves of 32 (128 rows x 128 bytes each), both with
// the 128-byte swizzle: 16-byte chunk c of row r lies at chunk c ^ (r % 8).

// The activations' tensor maps (without them the producer warpgroup
// gathers A by cp.async) and the fused epilogue's residual's.
struct ActMaps {
  CUtensorMap xa, xb;  // (cin, [2,] rows in a segment, segments), f32
  CUtensorMap res;     // rows_conv_gn's residual (cout, M), f32
  int tma;             // 1: A travels by TMA
  int has_res;         // 1: TMA brings the residual tile
};

template <int BN_, int STAGES_, int BM_ = 128>
struct WgTile {
  using W = __nv_bfloat16;
  static constexpr int BM = BM_, BN = BN_, BK = 64, STAGES = STAGES_;
  // one consumer warpgroup per 64 rows; 128 rows: a producer warpgroup
  // (it may gather A), 64 rows (ClusterTile): one producer warp, TMA only
  static constexpr int kConsumers = 2 * BM, kProducers = BM == 128 ? 128 : 32;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr bool kCluster = false;
  static constexpr int kMinBlocks = 1;
  static_assert(BM == 128 || BM == 64, "one or two consumer warpgroups");
  static constexpr int ACC = BN / 2, NI = BN / 8;
  static constexpr int BOX = BK * 128;  // one 64-column box of B, swizzled
  static constexpr int HALF = BM * 32;  // floats of one 32-channel half of A
  static constexpr int B_BYTES = BK * BN * 2, A_BYTES = BM * BK * 4;
  static constexpr int STAGE = B_BYTES + A_BYTES;
  // the fused epilogue's sums per (8-row piece, group) and statistics per
  // (segment, group) (groups of a tile: at most BN / 8, of 8 columns or
  // more); its per-column operands (bias, scale, shift), time rows (one per
  // segment: at most kPieces) and the residual tile, which TMA brings in
  // four 32-column boxes while the K loop runs
  static constexpr int kPieces = BM / 8, kMaxGroups = BN / 8;
  // bytes from the 1024-aligned start of the ring (the block's dynamic
  // shared memory has 1024 bytes more, to align it)
  static constexpr int RING = STAGES * STAGE;
  static constexpr int TOP = RING + (2 * STAGES + 1) * 8 + BM * 8;
  static constexpr int GN_EXTRA = 2 * kPieces * kMaxGroups * 8 +
                                  3 * BN * 4 + kPieces * BN * 4;
  static constexpr int RES_AT = (TOP + GN_EXTRA + 1023) / 1024 * 1024;
  static constexpr int SMEM = 1024 + TOP;                      // rows_conv
  static constexpr int SMEM_GN = 1024 + RES_AT + BM * BN * 4;  // rows_conv_gn
  static_assert(STAGE % 1024 == 0 && BN % 64 == 0, "swizzle atoms");
  static_assert(SMEM <= 232448, "shared memory of a block");
  // registers after setmaxnreg: 128 x 56 + 256 x 224 = 384 x 168
  static constexpr int kProducerRegs = 56, kConsumerRegs = 224;

  struct Smem {
    unsigned char* ring;        // STAGES x (B boxes, then A halves)
    unsigned long long* full;   // per stage: A and B landed
    unsigned long long* empty;  // per stage: every consumer warp is done
    unsigned long long* resbar; // the residual tile landed
    int2* rows;                 // per tile row (gather): (segment's first
                                // row, row inside it), or (-1, 0) past M
    // rows_conv_gn only
    float2* red;                // [kPieces][kMaxGroups] sums x, x^2
    float2* stat;               // [segments][groups] mean, rstd
    float* par;                 // [3][BN] bias, scale, shift
    float* te;                  // [segments][BN] time rows
    float* res;                 // 4 boxes of [BM][32], swizzled
  };

  static __device__ __forceinline__ Smem carve(unsigned char* raw) {
    Smem s;
    const unsigned pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
    s.ring = raw + pad;
    s.full = reinterpret_cast<unsigned long long*>(s.ring + RING);
    s.empty = s.full + STAGES;
    s.resbar = s.empty + STAGES;
    s.rows = reinterpret_cast<int2*>(s.resbar + 1);
    s.red = reinterpret_cast<float2*>(s.rows + BM);
    s.stat = s.red + kPieces * kMaxGroups;
    s.par = reinterpret_cast<float*>(s.stat + kPieces * kMaxGroups);
    s.te = s.par + 3 * BN;
    s.res = reinterpret_cast<float*>(s.ring + RES_AT);
    return s;
  }

  // float offset of (row r, column c) in the residual tile
  static __device__ __forceinline__ int res_at(int r, int c) {
    return (c >> 5) * (BM * 32) + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) +
           (c & 3);
  }

  // float offset of (row r, 16-byte chunk q of the tile's 64 channels) in a
  // stage's A
  static __device__ __forceinline__ int a_at(int r, int q) {
    return (q >> 3) * HALF + r * 32 + (((q & 7) ^ (r & 7)) << 2);
  }

  // barriers and the row table, by every thread; ends with __syncthreads
  static __device__ __forceinline__ void setup(const ConvIn& c, int m0,
                                               bool tma_a, const Smem& s) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < STAGES; ++i) {
        // the TMA thread's arrival, and each gathering thread's
        mbar_init(s.full + i, tma_a ? 1 : kProducers + 1);
        mbar_init(s.empty + i, kConsumers / 32);
      }
      mbar_init(s.resbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (threadIdx.x < BM) {
      const int seg_m = c.mode == kDown ? c.seg_in >> 1 : c.seg_in;
      const int m = m0 + threadIdx.x, si = m / seg_m;
      s.rows[threadIdx.x] =
          m < c.M ? make_int2(si * c.seg_in, m - si * seg_m) : make_int2(-1, 0);
    }
    __syncthreads();
  }

  // The producer warpgroup. Per K tile: wait for the stage to be free; A
  // either by TMA (two 32-channel boxes of the tile's rows, shifted by the
  // tap; rows outside a segment read as zeros: the per-segment padding) or
  // gathered by the warpgroup's cp.async (16 bytes where a chunk lies in
  // one tap and one of xa / xb, else element by element); B by TMA.
  static __device__ __forceinline__ void produce(
      const ConvIn& c, const CUtensorMap* wmap, const ActMaps& am, int parity,
      int m0, int n0, int k_begin, int k_end, const Smem& s) {
    const int pt = threadIdx.x - kConsumers;
    const int cin = c.cin_a + c.cin_b;
    const bool tile_in_tap = c.cin_a % BK == 0 && c.cin_b % BK == 0;
    const bool quads = c.cin_a % 4 == 0 && c.cin_b % 4 == 0;
    const int nk = (k_end - k_begin + BK - 1) / BK;
    if (pt == 0 && am.has_res) {  // the residual tile, for the epilogue
      mbar_expect_tx(s.resbar, BM * BN * 4);
#pragma unroll
      for (int b = 0; b < BN / 32; ++b)
        tma_load_2d(s.res + b * (BM * 32), &am.res, n0 + 32 * b, m0,
                    s.resbar);
    }
    if (am.tma && pt != 0) return;
    const int seg_m = c.mode == kDown ? c.seg_in >> 1 : c.seg_in;
    const int s0 = m0 / seg_m, l0 = m0 - s0 * seg_m;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % STAGES;
      if (kt >= STAGES) mbar_wait(s.empty + st, (kt / STAGES - 1) & 1);
      unsigned char* stage = s.ring + st * STAGE;
      float* a = reinterpret_cast<float*>(stage + B_BYTES);
      const int kg = k_begin + kt * BK;
      const int j = kg / cin, ci0 = kg - j * cin;  // the tile's tap if in one
      if (am.tma) {
        mbar_expect_tx(s.full + st, A_BYTES + B_BYTES);
        const CUtensorMap* xm = ci0 < c.cin_a ? &am.xa : &am.xb;
        const int cx = ci0 < c.cin_a ? ci0 : ci0 - c.cin_a;
        const int r = tap_row(c.mode, 0, j, parity, c.k);  // shift of row 0
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (c.mode == kDown)  // rows 2 l + r: (parity of r, l + r / 2)
            tma_load_4d(a + h * HALF, xm, cx + 32 * h, r & 1, l0 + (r >> 1),
                        s0, s.full + st);
          else
            tma_load_3d(a + h * HALF, xm, cx + 32 * h, l0 + r, s0,
                        s.full + st);
        }
      } else if constexpr (kProducers == 128) {
#pragma unroll 4
        for (int i = 0; i < BM / 8; ++i) {
          const int row = (pt >> 4) + 8 * i, q = pt & 15;
          const int2 rt = s.rows[row];
          float* dst = a + a_at(row, q);
          const int kq0 = kg + 4 * q;
          if (quads) {
            const int jq = kq0 / cin, cq = kq0 - jq * cin;
            const int li = tap_row(c.mode, rt.y, jq, parity, c.k);
            const bool ok = rt.x >= 0 && kq0 < k_end && li >= 0 &&
                            li < c.seg_in;
            cp_async16_zfill(dst, ok ? act_ptr(c, rt.x + li, cq) : c.xa, ok);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kq = kq0 + e;
              bool ok = rt.x >= 0 && kq < k_end;
              const float* src = c.xa;
              if (ok) {
                const int jq = kq / cin, cq = kq - jq * cin;
                const int li = tap_row(c.mode, rt.y, jq, parity, c.k);
                ok = li >= 0 && li < c.seg_in;
                if (ok) src = act_ptr(c, rt.x + li, cq);
              }
              cp_async4_zfill(dst + e, src, ok);
            }
          }
        }
        mbar_arrive_cp_async(s.full + st);
        if (pt == 0) mbar_expect_tx(s.full + st, B_BYTES);
      }
      if (pt == 0) {
        // B's rows: one tap's (a K tile inside one tap), or K rows kg..
        // (SAME and DOWN, whose taps lie in order); rows past the weight
        // read zeros
        const int wrow =
            tile_in_tap ? weight_tap(c.mode, j, parity) * cin + ci0 : kg;
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_2d(stage + b * BOX, wmap, n0 + 64 * b, wrow, s.full + st);
      }
    }
    if (!am.tma) cp_async_wait<0>();  // its copies landed before it leaves
  }

  // One K tile of a consumer warpgroup: wait for the stage, build the
  // fragments of its rows (f32 -> bf16), run 4 wgmmas, and when they are
  // done release the stage. The two consumer warpgroups take turns on the
  // tensor cores while the other builds its fragments.
  static __device__ __forceinline__ void consume_tile(int kt, const Smem& s,
                                                      float (&acc)[ACC]) {
    const int ct = threadIdx.x, lane = ct & 31, t = lane & 3;
    const int row = (ct >> 7) * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
    const int st = kt % STAGES;
    mbar_wait(s.full + st, (kt / STAGES) & 1);
    const unsigned char* stage = s.ring + st * STAGE;
    const float* as = reinterpret_cast<const float*>(stage + B_BYTES);
    unsigned f[16];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // columns 16 ks + 2 t and + 8 of rows `row` and + 8 (row % 8 == g for
      // both); the activations become bf16 here, as in MmaTile
      const int q = 4 * ks + (t >> 1), w = 2 * (t & 1);
      const float2 x0 = *reinterpret_cast<const float2*>(as + a_at(row, q) + w);
      const float2 x1 =
          *reinterpret_cast<const float2*>(as + a_at(row + 8, q) + w);
      const float2 x2 =
          *reinterpret_cast<const float2*>(as + a_at(row, q + 2) + w);
      const float2 x3 =
          *reinterpret_cast<const float2*>(as + a_at(row + 8, q + 2) + w);
      f[4 * ks] = pack_bf16(x0.x, x0.y);
      f[4 * ks + 1] = pack_bf16(x1.x, x1.y);
      f[4 * ks + 2] = pack_bf16(x2.x, x2.y);
      f[4 * ks + 3] = pack_bf16(x3.x, x3.y);
    }
    wgmma_fence();
    const unsigned long long desc = wg_desc_b128(stage, BOX);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const unsigned a[4] = {f[4 * ks], f[4 * ks + 1], f[4 * ks + 2],
                             f[4 * ks + 3]};
      // 16 K rows of 128 bytes further: 2048 bytes, whole swizzle atoms
      wgmma_rs<BN>(acc, a, desc + (unsigned long long)((16 * 128 * ks) >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(s.empty + st);
  }

  static __device__ __forceinline__ void consume(int nk, const Smem& s,
                                                 float (&acc)[ACC]) {
    for (int kt = 0; kt < nk; ++kt) consume_tile(kt, s, acc);
  }

  // f(m, n, v0, v1) on every pair of neighbouring columns (n even) that
  // this consumer thread holds of the tile at (m0, n0); f may change v0, v1.
  template <class F>
  static __device__ __forceinline__ void pairs(float (&acc)[ACC], int m0,
                                               int n0, F f) {
    const int ct = threadIdx.x, lane = ct & 31;
    const int m = m0 + (ct >> 7) * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
    const int n = n0 + 2 * (lane & 3);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      f(m, n + ni * 8, acc[ni * 4], acc[ni * 4 + 1]);
      f(m + 8, n + ni * 8, acc[ni * 4 + 2], acc[ni * 4 + 3]);
    }
  }
};

// The served wave's tile (the micro-batched server's waves of 16-64 chains:
// 512-2,048 GEMM rows): a 64 x 128 wgmma tile whose K splits are the blocks
// of one thread-block cluster. One consumer warpgroup owns the 64 rows
// (m64n128k16, A rounded to bf16 in its registers as in WgTile), one
// producer warp issues both operands' TMA loads (A always by TMA: the
// launcher gives this tile only convs whose K tiles lie in one tap and one
// of xa / xb, and whose 64 rows are whole segments or lie in one). After
// the K loop a block keeps its partial tile in its own shared memory, over
// the ring, rows LDP floats apart (conflict-free float2 stores from the
// accumulators); the cluster's blocks then meet through distributed shared
// memory (planner.cu cl_conv).
//
// Replaces the 16 x 64 MmaTile of common.cuh at these rows, whose 640-768
// blocks a fused conv of the 64-chain wave walked up to 27 serial K tiles
// of 32 in three rounds, met through global partial planes and an atomic
// arrival per group block, and re-read every weight from L2 32-128 times
// (1.16 GB a step against 30.5 MB of weights). What bounds it: a 64-chain
// step is 18.6 GFLOP, 18.8 us of tensor-core work at the bf16 peak, over
// 30.5 MB of weights that stay in L2 and ~2-4 MB of f32 activations a conv;
// a launch is bound by its K loop's latency and by L2. At 64 chains a 64 x
// 128 tile leaves 32 output tiles at every level (2,048 x 128, 1,024 x
// 256, 512 x 512), a segment (32 / 16 / 8 rows) and a group (16 / 32 / 64
// channels) inside one tile, and four K splits fill 128 of the 132 SMs in
// one round. Why a cluster: the splits must meet before the GroupNorm,
// which needs each (segment, group) sum whole; a cluster's blocks run at
// once on neighbouring SMs, so after one cluster barrier a block reads its
// peers' partial tiles from their shared memory: no global partial plane,
// no counter, and the splits are added in a fixed order. A ring of 3
// stages (96 KB) leaves room for two blocks an SM: on the card 2 stages
// tied it and 4 (one block an SM) lost at most shapes (sweep_kernels conv
// --chains 8|16|32|64 on an H100).
struct ClusterTile : WgTile<128, 3, 64> {
  using Base = WgTile<128, 3, 64>;
  static constexpr bool kCluster = true;
  static constexpr int kMaxSplits = 8;  // the portable cluster size
  static constexpr int LDP = Base::BN + 8;
  static constexpr int SMEM = 1024 + Base::TOP + Base::GN_EXTRA;
  // two blocks an SM where the ring leaves room
  static constexpr int kMinBlocks = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(Base::BM * LDP * 4 <= Base::RING, "the partial tile");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

// Runs the statement(s) given last with `Tile` naming the wgmma tile of
// (bn, stages) (ops/conv_tiling.py WG_TILES, WG_STAGES); sets ok to false
// if there is no such tile.
#define DADIFF_WITH_WG_TILE(bn, stages, ok, ...)          \
  do {                                                    \
    ok = true;                                            \
    if ((bn) == 128 && (stages) == 4) {                   \
      using Tile = dadiff::WgTile<128, 4>;                \
      __VA_ARGS__;                                        \
    } else if ((bn) == 128 && (stages) == 3) {            \
      using Tile = dadiff::WgTile<128, 3>;                \
      __VA_ARGS__;                                        \
    } else if ((bn) == 256 && (stages) == 3) {            \
      using Tile = dadiff::WgTile<256, 3>;                \
      __VA_ARGS__;                                        \
    } else {                                              \
      ok = false;                                         \
    }                                                     \
  } while (0)

}  // namespace dadiff
