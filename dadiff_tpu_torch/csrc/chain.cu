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
// (conv, reduce, GroupNorm+Mish, DDPM step, init), run once as a prologue
// (x_T conditioning and the time-dense rows of all T steps) and then once per
// step. Each op's work items are spread over the blocks and a grid-wide
// barrier separates dependent ops. Weights stay in global memory and are
// served by the 50 MB L2 (31.5 MB in bf16 at the flagship); only the iterate,
// the activations (a few KB each) and the split-K partials move between ops.
//
// At 32 rows a conv has 1-16 output tiles of 32x32, so every conv is split
// over K: an item is (tile, parity, K split) and stores its partial tile;
// the op that consumes the conv (reduce, GroupNorm, DDPM step) sums the
// partials in split order, so a run repeats bit for bit. GroupNorm statistics
// are one block per (segment, group), var = E[x^2] - mean^2 in f32 as K1.
// With bf16 weights the activations are rounded to bf16 before every
// product, at the same points as rows_conv (common.cuh).
//
// Bound on an H100 (flagship, batch 1): 29.1 GFLOP of products per chain,
// 0.029 ms at the bf16 tensor-core peak, with each weight read once (31.5 MB,
// 0.009 ms). This design re-reads the weights every step (L2) and pays ~60
// grid barriers per step; the barriers are its floor.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// One op of the layer program. The field order and sizes are those of
// ChainOp in ops/chain.py (ctypes.Structure).
struct ChainOp {
  const float* xa;           // conv input (or x0 for init)
  const float* xb;           // conv input, second half of a channel concat
  const void* w;             // conv weight, flattened (taps*cin, cout)
  const float* bias;         // bias of the conv whose partials are read
  float* partial;            // conv: partial tiles out; consumers: partials in
  const float* scale;        // GroupNorm scale
  const float* gbias;        // GroupNorm bias
  const float* te;           // GN: time-dense table (T, C), row = step
  const float* res;          // GN: residual read directly
  const float* res_partial;  // GN: residual as partials of a 1x1 conv
  const float* res_bias;     // GN: bias of that conv
  float* out;                // reduce / GN / init output; step: x in place
  const float* noise;        // step: (T, H, D)
  const float* scal;         // step: (T, 8)
  const float* cond;         // init / step: row-0 conditioning or null
  int kind, sync_after, rot;
  int cin_a, cin_b, rows_in, seg_in, cout, mode, k, w_bf16, splits;
  int res_splits, te_stride, clip, predict_eps, groups, pad_;
};

namespace {

using namespace dadiff;

constexpr int kOpConv = 0, kOpReduce = 1, kOpGn = 2, kOpStep = 3, kOpInit = 4;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ int first_item(int rot) {
  const int G = gridDim.x;
  return (blockIdx.x + G - rot % G) % G;
}

// sum over splits of partial[sp][idx], in split order; the loads of eight
// splits are issued together, since each is an L2 round trip
__device__ __forceinline__ float sum_partials(const float* partial, int splits,
                                              size_t plane, size_t idx) {
  const float* p = partial + idx;
  float s = 0.f;
  int sp = 0;
  for (; sp + 8 <= splits; sp += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __ldcg(p + (sp + i) * plane);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[i];
  }
  for (; sp < splits; ++sp) s += __ldcg(p + sp * plane);
  return s;
}

template <typename WT, bool kBf16Act>
__device__ void conv_items(const ChainOp& op, float (*As)[BM + 1],
                           float (*Bs)[BN]) {
  const int M = op.mode == kDown ? op.rows_in / 2 : op.rows_in;
  const int cin = op.cin_a + op.cin_b;
  const int K = (op.mode == kUp ? 2 : op.k) * cin;
  const int tiles_n = (op.cout + BN - 1) / BN, tiles_m = (M + BM - 1) / BM;
  const int parities = op.mode == kUp ? 2 : 1;
  const int k_tiles = (K + BK - 1) / BK;
  const int per_split = (k_tiles + op.splits - 1) / op.splits;
  const int n_items = tiles_n * tiles_m * parities * op.splits;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int item = first_item(op.rot); item < n_items; item += gridDim.x) {
    const int tn = item % tiles_n;
    const int t = item / tiles_n;
    const int tm = t % tiles_m;
    const int z = t / tiles_m;  // parity * splits + split
    const int split = z % op.splits, parity = z / op.splits;
    const int k_begin = split * per_split * BK;
    const int k_end = min(K, k_begin + per_split * BK);
    const int m0 = tm * BM, n0 = tn * BN;
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    conv_tile_acc<WT, kBf16Act>(op.xa, op.xb, op.cin_a, op.cin_b,
                                (const WT*)op.w, M, op.seg_in, op.cout, op.mode,
                                op.k, parity, m0, n0, k_begin, k_end, As, Bs,
                                acc);
    float* mine = op.partial + ((size_t)z * M) * op.cout;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 2 * ty + i;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int n = n0 + 2 * tx + jn;
        if (m < M && n < op.cout) mine[(size_t)m * op.cout + n] = acc[i][jn];
      }
    }
  }
}

// out[out_row(m, parity)] = bias + sum of the conv's partials
__device__ void reduce_items(const ChainOp& op) {
  const int M = op.mode == kDown ? op.rows_in / 2 : op.rows_in;
  const int parities = op.mode == kUp ? 2 : 1;
  const size_t plane = (size_t)M * op.cout;
  const int total = parities * M * op.cout;
  for (int e = first_item(op.rot) * kThreads + threadIdx.x; e < total;
       e += gridDim.x * kThreads) {
    const int n = e % op.cout;
    const int m = (e / op.cout) % M;
    const int parity = e / (op.cout * M);
    const float v = op.bias[n] + sum_partials(
        op.partial + (size_t)parity * op.splits * plane, op.splits, plane,
        (size_t)m * op.cout + n);
    op.out[(size_t)out_row(op.mode, m, parity, op.seg_in) * op.cout + n] = v;
  }
}

// GroupNorm + Mish of (bias + partials), then + te row of this step and
// + residual (direct, or bias + partials of the 1x1 conv). One block per
// (segment, group), two passes as K1.
__device__ void gn_items(const ChainOp& op, int step, float* red1, float* red2,
                         float* stat) {
  const int C = op.cout, rows = op.rows_in, seg = op.seg_in;
  const int cgp = C / op.groups;
  const int n = seg * cgp;
  const size_t plane = (size_t)rows * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_items = (rows / seg) * op.groups;
  for (int item = first_item(op.rot); item < n_items; item += gridDim.x) {
    const int s = item / op.groups, g = item - s * op.groups;
    const size_t base = (size_t)s * seg * C + (size_t)g * cgp;
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / cgp, c = i - r * cgp;
      const float v = op.bias[g * cgp + c] + sum_partials(
          op.partial, op.splits, plane, base + (size_t)r * C + c);
      s1 += v;
      s2 += v * v;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red1[warp] = s1;
      red2[warp] = s2;
    }
    __syncthreads();
    if (warp == 0) {
      s1 = lane < kThreads / 32 ? red1[lane] : 0.f;
      s2 = lane < kThreads / 32 ? red2[lane] : 0.f;
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        const float mean = s1 / (float)n;
        stat[0] = mean;
        stat[1] = rsqrtf(s2 / (float)n - mean * mean + kEps);
      }
    }
    __syncthreads();
    const float mean = stat[0], rstd = stat[1];
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / cgp, c = i - r * cgp;
      const int ch = g * cgp + c;
      const size_t idx = base + (size_t)r * C + c;
      const float v = op.bias[ch] + sum_partials(op.partial, op.splits, plane,
                                                 idx);
      float y = mish((v - mean) * rstd * op.scale[ch] + op.gbias[ch]);
      if (op.te != nullptr) y += __ldcg(op.te + (size_t)step * op.te_stride + ch);
      if (op.res != nullptr) y += __ldcg(op.res + idx);
      if (op.res_partial != nullptr)
        y += op.res_bias[ch] + sum_partials(op.res_partial, op.res_splits,
                                            plane, idx);
      op.out[idx] = y;
    }
    __syncthreads();  // stat and red are reused by the next item
  }
}

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
// spent in the ops of each kind (slots 0-4) and waiting at the barriers
// (slot 5): where a chain's time goes, as one block sees it.
__global__ void __launch_bounds__(kThreads)
chain_kernel(const ChainOp* __restrict__ prog, int n_pre, int n_step, int T,
             long long* __restrict__ prof) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  __shared__ float red1[kThreads / 32], red2[kThreads / 32], stat[2];
  __shared__ ChainOp op;
  constexpr int kWords = sizeof(ChainOp) / sizeof(int);
  const int total = n_pre + T * n_step;
  for (int it = 0; it < total; ++it) {
    const int step = it < n_pre ? 0 : (it - n_pre) / n_step;
    const int idx = it < n_pre ? it : n_pre + (it - n_pre) % n_step;
    __syncthreads();  // every thread is done with the previous op
    if (threadIdx.x < kWords)
      ((int*)&op)[threadIdx.x] = ((const int*)(prog + idx))[threadIdx.x];
    __syncthreads();
    const bool timed = prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
    long long t0 = timed ? clock64() : 0;
    switch (op.kind) {
      case kOpConv:
        if (op.w_bf16)
          conv_items<__nv_bfloat16, true>(op, As, Bs);
        else
          conv_items<float, false>(op, As, Bs);
        break;
      case kOpReduce: reduce_items(op); break;
      case kOpGn: gn_items(op, step, red1, red2, stat); break;
      case kOpStep: step_items(op, step); break;
      case kOpInit: init_items(op); break;
    }
    if (timed) {
      const long long t1 = clock64();
      prof[op.kind] += t1 - t0;
      t0 = t1;
    }
    if (op.sync_after) grid.sync();
    if (timed) prof[5] += clock64() - t0;
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
// is null or 6 zeroed int64 on the device (see chain_kernel).
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
