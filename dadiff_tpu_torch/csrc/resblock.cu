// K4: one ResidualTemporalBlock in ONE launch (dadiff_tpu_torch/ops/resblock.py).
//
// Replaces: the JAX package's ops/pallas_resblock.py:132 residual_block_pallas
// (body `_kernel` :82):
//
//   conv1(k) -> GroupNorm -> Mish -> + te -> conv2(k) -> GroupNorm -> Mish
//   -> + (1x1 conv of x, or x)
//
// f32 throughout, zero-padded 'same' convs, statistics per batch row and
// group over (H, C/G) with var = E[x^2] - mean^2, eps 1e-5.
//
// On the TPU one program owns a whole batch row and h never leaves VMEM. At
// batch 1 that design uses one SM of 132 here, and a block's weights (up to
// 10.5 MB in f32) are what bounds it: they must stream from memory once per
// call. So K4 is K3's layer program (program.cuh) run for one block: one
// persistent cooperative launch, one block per SM, walks the block's ops
//
//   CONV w1 (k taps) [+ CONV wr (1x1), in the same phase]  | barrier
//   GN with te (one row per batch row: te_seg_stride)      | barrier
//   CONV w2 (k taps)                                       | barrier
//   GN with the residual (x, or the 1x1 conv's partials), writing out
//
// Batch rows are the segments (seg_in = H, rows_in = B*H). Every conv is
// split over K into items that run F32Tile (full f32 fmaf on the CUDA
// cores, both operands through a cp.async ring), so all SMs stream a share
// of the weights; a GroupNorm item sums the partials in split order, so a
// launch repeats bit for bit. h and the partials travel through L2.
//
// The host builds a block's ops once (ops/resblock.py, with ops/chain.py's
// builder) and passes them by value as a __grid_constant__ parameter, with
// placeholders where x, te and out go; resblock_run patches those three
// pointers in on the host and launches. No upload per call.
//
// Bound on an H100: bytes (the block's weights, 0.3-10.5 MB; 58.5 MB for
// the 12 blocks of a flagship step, 17.4 us at 3.35 TB/s) at batch 1. What
// stays above it: the launch, three grid barriers, and the GroupNorm
// phases, which have B * 8 items.

#include <cooperative_groups.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "program.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dadiff;

constexpr int kMaxOps = 5;  // conv1, conv_r, GN, conv2, GN
// placeholders of the template's pointers, patched by resblock_run; the
// same values as ops/resblock.py's X, TE, OUT
constexpr uintptr_t kArgX = 1, kArgTe = 2, kArgOut = 3;
constexpr int kPointers = 16;  // the pointer fields that lead ChainOp
static_assert(offsetof(ChainOp, kind) == kPointers * sizeof(void*),
              "ChainOp starts with its pointers");

struct BlockProgram {
  ChainOp ops[kMaxOps];
  int n_ops;
};

// `prof` as chain_kernel's: thread 0 of block 0's clock cycles by op kind
// (slots 0-3) and at the barriers (slot 4). One block per SM, so the
// compiler may use up to 255 registers (158 at sm_90a, no spills; left to
// itself it kept to 128 and spilled).
__global__ void __launch_bounds__(kThreads, 1)
resblock_kernel(const __grid_constant__ BlockProgram prog,
                long long* __restrict__ prof) {
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(128) unsigned char smem[kConvSmemBytes];
  __shared__ float red1[kThreads / 32], red2[kThreads / 32], stat[2];
  __shared__ ChainOp op;
  for (int i = 0; i < prog.n_ops; ++i) {
    __syncthreads();  // every thread is done with the previous op
    load_op(&prog.ops[i], &op);
    __syncthreads();
    const bool timed = prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
    long long t0 = timed ? clock64() : 0;
    if (op.kind == kOpConv)
      conv_items<F32Tile>(op, smem);  // the host sends only f32 32x32 convs
    else
      gn_items(op, 0, reinterpret_cast<float*>(smem), red1, red2, stat);
    if (timed) {
      const long long t1 = clock64();
      prof[op.kind] += t1 - t0;
      t0 = t1;
    }
    if (op.sync_after) grid.sync();
    if (timed) prof[kBarrier] += clock64() - t0;
  }
}

}  // namespace

// out[0] = blocks of resblock_kernel co-resident on one SM, out[1] = SM
// count, out[2] = 1 if the device can launch cooperatively, out[3] =
// sizeof(ChainOp); as chain_limits.
extern "C" int resblock_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], resblock_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&out[2], cudaDevAttrCooperativeLaunch, dev);
  out[3] = (int)sizeof(ChainOp);
  return (int)e;
}

// One cooperative launch of the n_ops ops at `tmpl` (host memory), with
// every pointer field that holds kArgX, kArgTe or kArgOut replaced by x, te
// or out. `grid` must not exceed out[0] * out[1] of resblock_limits. `prof`
// is null or 5 zeroed int64 on the device. Returns cudaErrorInvalidValue
// for more than kMaxOps ops.
extern "C" int resblock_run(const void* tmpl, int n_ops, const float* x,
                            const float* te, float* out, int grid,
                            long long* prof, void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps) return (int)cudaErrorInvalidValue;
  BlockProgram p;
  memcpy(p.ops, tmpl, n_ops * sizeof(ChainOp));
  p.n_ops = n_ops;
  for (int i = 0; i < n_ops; ++i) {
    void* ptrs[kPointers];
    memcpy(ptrs, &p.ops[i], sizeof(ptrs));
    for (void*& q : ptrs) {
      const uintptr_t v = (uintptr_t)q;
      if (v == kArgX) q = (void*)x;
      else if (v == kArgTe) q = (void*)te;
      else if (v == kArgOut) q = (void*)out;
    }
    memcpy(&p.ops[i], ptrs, sizeof(ptrs));
  }
  void* args[] = {(void*)&p, (void*)&prof};
  return (int)cudaLaunchCooperativeKernel((void*)resblock_kernel, dim3(grid),
                                          dim3(kThreads), args, 0,
                                          (cudaStream_t)stream);
}
