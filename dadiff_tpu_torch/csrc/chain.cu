// K3: the whole batch-1 reverse chain in ONE launch
// (dadiff_tpu_torch/ops/chain.py).
//
// Replaces: the JAX package's ops/pallas_unet.py:334 make_pallas_chain (body
// `kernel` :362, `_unet_forward` :258): T DDPM steps, each the full U-Net
// forward, x0 = recip*x - recipm1*eps, clip, x = c1*x0 + c2*x + sigma*noise,
// optional row-0 conditioning, with nothing returning to the host in between.
//
// On the TPU the grid (T,) runs in order on one core with every weight
// resident in VMEM. A Hopper SM has 227 KB, so here one persistent kernel,
// launched cooperatively with at most as many blocks as are co-resident,
// walks a LAYER PROGRAM that the host wrote to device memory: a list of ops
// (conv, GroupNorm+Mish, DDPM step, init), run once as a prologue
// (x_T conditioning and the time-dense rows of all T steps) and then once per
// step. Each op's work items are spread over the blocks and a grid-wide
// barrier separates dependent ops. The ops and their conv and GroupNorm
// items are program.cuh's, which K4 (resblock.cu) runs too. Weights stay in global memory and are
// served by the 50 MB L2 (31.5 MB in bf16 at the flagship); only the iterate,
// the activations (a few KB each) and the split-K partials move between ops.
//
// At 32, 16 and 8 rows a conv has 1-16 output tiles of 16x64 (chosen by the
// host: ops/conv_tiling.py), so every conv is split over K: an item
// is (tile, parity, K split), runs the tile product of common.cuh (mma.sync
// on bf16 weights, a cp.async ring over its K tiles) and stores its partial
// tile; the op that consumes the conv (GroupNorm, DDPM step) sums the
// partials in split order, so a run repeats bit for bit. A conv whose output
// another conv reads (the down- and upsampling convs, the time-dense tables)
// needs no op and no barrier for that: the last item of a tile to arrive
// sums it, as in rows_conv (split_k_last of common.cuh). The host caps
// the splits at sixteen, which a consumer loads in one round trip to L2.
// GroupNorm statistics are one block per (segment, group), var = E[x^2] -
// mean^2 in f32 as K1; a value's partials are summed once and kept in shared
// memory between the statistics pass and the output pass. With bf16 weights
// the activations are rounded to bf16 before every product, at the same
// points as rows_conv (common.cuh).
//
// Bound on an H100 (flagship, batch 1): 29.1 GFLOP of products per chain,
// 0.029 ms at the bf16 tensor-core peak, with each weight read once (31.5 MB,
// 0.009 ms). This design re-reads the weights every step (L2) and pays 56
// grid barriers per step, ~1.1 us each at one block per SM: the barriers are
// its floor.

#include <cooperative_groups.h>

#include "program.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dadiff;

// The DDPM update of this step on x (in place), eps = bias + partials of the
// final 1x1 conv; then the row-0 conditioning.
__device__ void step_items(const ChainOp& op, int step) {
  const int D = op.cout;
  const int total = op.rows_in * D;
  const float* scal = op.scal + (size_t)step * 8;
  const float* noise = op.noise + (size_t)step * total;
  for (int e = first_item(op.rot) * kThreads + threadIdx.x; e < total;
       e += gridDim.x * kThreads) {
    const float eps = op.bias[e % D] + sum_partials(op.partial, op.splits,
                                                    (size_t)total, e);
    float xn = ddpm_update(__ldcg(op.out + e), eps, noise[e], scal, op.clip,
                           op.predict_eps);
    if (op.cond != nullptr && (e / D) % op.seg_in == 0) xn = op.cond[e];
    op.out[e] = xn;
  }
}

// x = x_T with row 0 conditioned before the first model call
__device__ void init_items(const ChainOp& op) {
  const int D = op.cout;
  const int total = op.rows_in * D;
  for (int e = first_item(op.rot) * kThreads + threadIdx.x; e < total;
       e += gridDim.x * kThreads)
    op.out[e] = (op.cond != nullptr && (e / D) % op.seg_in == 0) ? op.cond[e]
                                                                 : op.xa[e];
}

// `prof`, when not null, takes the clock cycles that thread 0 of block 0
// spent in the ops of each kind (slots 0-3) and waiting at the barriers
// (slot 4): where a chain's time goes, as one block sees it.
__global__ void __launch_bounds__(kThreads)
chain_kernel(const ChainOp* __restrict__ prog, int n_pre, int n_step, int T,
             long long* __restrict__ prof) {
  cg::grid_group grid = cg::this_grid();
  // the conv ring; between convs the GroupNorm items keep their values here
  __shared__ __align__(128) unsigned char smem[kConvSmemBytes];
  __shared__ float red1[kThreads / 32], red2[kThreads / 32], stat[2];
  __shared__ ChainOp op;
  const int total = n_pre + T * n_step;
  for (int it = 0; it < total; ++it) {
    const int step = it < n_pre ? 0 : (it - n_pre) / n_step;
    const int idx = it < n_pre ? it : n_pre + (it - n_pre) % n_step;
    __syncthreads();  // every thread is done with the previous op
    load_op(prog + idx, &op);
    __syncthreads();
    const bool timed = prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
    long long t0 = timed ? clock64() : 0;
    switch (op.kind) {
      case kOpConv: {
        bool known;  // the host takes its tiles from the same table
        DADIFF_WITH_TILE(op.w_bf16, op.bm, op.bn, known,
                         conv_items<Tile>(op, smem));
        (void)known;
        break;
      }
      case kOpGn:
        gn_items(op, step, reinterpret_cast<float*>(smem), red1, red2, stat);
        break;
      case kOpStep: step_items(op, step); break;
      case kOpInit: init_items(op); break;
    }
    if (timed) {
      const long long t1 = clock64();
      prof[op.kind] += t1 - t0;
      t0 = t1;
    }
    if (op.sync_after) grid.sync();
    if (timed) prof[kBarrier] += clock64() - t0;
  }
}

__global__ void __launch_bounds__(kThreads) grid_sync_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

}  // namespace

// out[0] = blocks of chain_kernel co-resident on one SM, out[1] = SM count,
// out[2] = 1 if the device can launch cooperatively, out[3] = sizeof(ChainOp).
extern "C" int chain_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], chain_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&out[2], cudaDevAttrCooperativeLaunch, dev);
  out[3] = (int)sizeof(ChainOp);
  return (int)e;
}

// One cooperative launch runs the n_pre prologue ops, then the n_step ops of
// a denoise step T times. `grid` must not exceed out[0] * out[1] of
// chain_limits: a grid that is not co-resident is refused, not run. `prof`
// is null or 5 zeroed int64 on the device (see chain_kernel).
extern "C" int chain_run(const void* prog, int n_pre, int n_step, int T,
                         int grid, long long* prof, void* stream) {
  void* args[] = {(void*)&prog, (void*)&n_pre, (void*)&n_step, (void*)&T,
                  (void*)&prof};
  return (int)cudaLaunchCooperativeKernel((void*)chain_kernel, dim3(grid),
                                          dim3(kThreads), args, 0,
                                          (cudaStream_t)stream);
}

// n grid-wide barriers and nothing else: the cost of one barrier.
extern "C" int grid_sync_probe(int n, int grid, void* stream) {
  void* args[] = {(void*)&n};
  return (int)cudaLaunchCooperativeKernel((void*)grid_sync_kernel, dim3(grid),
                                          dim3(kThreads), args, 0,
                                          (cudaStream_t)stream);
}
