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
// barrier separates dependent ops. Weights stay in global memory and are
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
  float* out;                // GN / init output; step: x in place; conv:
                             // null, or where a tile's last item sums it
  const float* noise;        // step: (T, H, D)
  const float* scal;         // step: (T, 8)
  const float* cond;         // init / step: row-0 conditioning or null
  unsigned int* counters;    // conv with out: one zeroed counter per tile
  int kind, sync_after, rot;
  int cin_a, cin_b, rows_in, seg_in, cout, mode, k, w_bf16, splits;
  int res_splits, te_stride, clip, predict_eps, groups;
  int bm, bn, pad_;          // conv: the tile of common.cuh that runs it
};

namespace {

using namespace dadiff;

constexpr int kOpConv = 0, kOpGn = 1, kOpStep = 2, kOpInit = 3, kBarrier = 4;
constexpr float kEps = 1e-5f;
constexpr int kStash = kConvSmemBytes / 4;  // floats of the conv ring

__device__ __forceinline__ int first_item(int rot) {
  const int G = gridDim.x;
  return (blockIdx.x + G - rot % G) % G;
}

template <class Tile>
__device__ void conv_items(const ChainOp& op, unsigned char* smem) {
  const int M = op.mode == kDown ? op.rows_in / 2 : op.rows_in;
  const int cin = op.cin_a + op.cin_b;
  const int K = (op.mode == kUp ? 2 : op.k) * cin;
  const int tiles_n = (op.cout + Tile::BN - 1) / Tile::BN;
  const int tiles_m = (M + Tile::BM - 1) / Tile::BM;
  const int parities = op.mode == kUp ? 2 : 1;
  const int k_tiles = (K + BK - 1) / BK;
  const int per_split = (k_tiles + op.splits - 1) / op.splits;
  const int n_items = tiles_n * tiles_m * parities * op.splits;
  const int cout = op.cout;
  const ConvIn c{op.xa,     op.xb,   op.cin_a, op.cin_b, M,
                 op.seg_in, op.cout, op.mode,  op.k};
  for (int item = first_item(op.rot); item < n_items; item += gridDim.x) {
    const int tn = item % tiles_n;
    const int t = item / tiles_n;
    const int tm = t % tiles_m;
    const int z = t / tiles_m;  // parity * splits + split
    const int split = z % op.splits, parity = z / op.splits;
    const int k_begin = split * per_split * BK;
    const int k_end = min(K, k_begin + per_split * BK);
    const int m0 = tm * Tile::BM, n0 = tn * Tile::BN;
    float acc[Tile::ACC];
#pragma unroll
    for (int i = 0; i < Tile::ACC; ++i) acc[i] = 0.f;
    Tile::product(c, (const typename Tile::W*)op.w, parity, m0, n0, k_begin,
                  k_end, smem, acc);
    if (op.out == nullptr) {  // the consumer sums the partial tiles
      float* mine = op.partial + ((size_t)z * M) * cout;
      Tile::pairs(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
        if (m < M && n < cout)
          *reinterpret_cast<float2*>(mine + (size_t)m * cout + n) =
              make_float2(v0, v1);
      });
    } else if (split_k_last<Tile>(
                   acc, op.partial, parity, split, op.splits, M, cout, m0, n0,
                   &op.counters[(parity * tiles_m + tm) * tiles_n + tn])) {
      Tile::pairs(acc, m0, n0, [&](int m, int n, float& v0, float& v1) {
        if (m >= M || n >= cout) return;
        const size_t o =
            (size_t)out_row(op.mode, m, parity, op.seg_in) * cout + n;
        *reinterpret_cast<float2*>(op.out + o) =
            make_float2(v0 + op.bias[n], v1 + op.bias[n + 1]);
      });
    }
  }
}

// GroupNorm + Mish of (bias + partials), then + te row of this step and
// + residual (direct, or bias + partials of the 1x1 conv). One block per
// (segment, group), two passes as K1. Where a group fits `stash` (kStash
// floats: always at the U-Net's shapes), the first pass keeps there each
// value, its scale and bias and everything added after the Mish, two values
// per thread with all their loads in flight together, and the second pass
// reads nothing from global memory again.
__device__ void gn_items(const ChainOp& op, int step, float* stash, float* red1,
                         float* red2, float* stat) {
  const int C = op.cout, rows = op.rows_in, seg = op.seg_in;
  const int cgp = C / op.groups;
  const int n = seg * cgp;
  const size_t plane = (size_t)rows * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_items = (rows / seg) * op.groups;
  const bool keep = 4 * n <= kStash;
  float* stash_add = stash + n;
  float* stash_scale = stash + 2 * n;
  float* stash_gbias = stash + 3 * n;
  for (int item = first_item(op.rot); item < n_items; item += gridDim.x) {
    const int s = item / op.groups, g = item - s * op.groups;
    const size_t base = (size_t)s * seg * C + (size_t)g * cgp;
    auto index = [&](int i, int& ch) {
      const int r = i / cgp, c = i - r * cgp;
      ch = g * cgp + c;
      return base + (size_t)r * C + c;
    };
    auto addend = [&](size_t idx, int ch) {
      float a = 0.f;
      if (op.te != nullptr) a += __ldcg(op.te + (size_t)step * op.te_stride + ch);
      if (op.res != nullptr) a += __ldcg(op.res + idx);
      if (op.res_partial != nullptr)
        a += op.res_bias[ch] +
             sum_partials(op.res_partial, op.res_splits, plane, idx);
      return a;
    };
    const bool res_p = op.res_partial != nullptr;
    const int fan_in = max(op.splits, res_p ? op.res_splits : 0);
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < n; i += 2 * kThreads) {
      const int i2 = i + kThreads;
      const bool two = i2 < n;
      int ch1, ch2;
      const size_t idx1 = index(i, ch1), idx2 = index(two ? i2 : i, ch2);
      // everything this pair of values reads crosses L2: start the loads of
      // the addends and of both values' partials, the residual conv's too,
      // before the first sum waits for one of them
      const float b1 = op.bias[ch1], b2 = op.bias[ch2];
      const float sc1 = op.scale[ch1], sc2 = op.scale[ch2];
      const float gb1 = op.gbias[ch1], gb2 = op.gbias[ch2];
      float a1 = 0.f, a2 = 0.f;
      if (op.te != nullptr) {
        a1 = __ldcg(op.te + (size_t)step * op.te_stride + ch1);
        a2 = __ldcg(op.te + (size_t)step * op.te_stride + ch2);
      }
      float d1 = 0.f, d2 = 0.f;
      if (op.res != nullptr) {
        d1 = __ldcg(op.res + idx1);
        d2 = __ldcg(op.res + idx2);
      }
      float v1 = 0.f, v2 = 0.f, q1 = 0.f, q2 = 0.f;
      for (int sp = 0; sp < fan_in; sp += kBatch) {
        float m1[kBatch], m2[kBatch], r1[kBatch], r2[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const bool in = sp + b < op.splits;
          const size_t off = (size_t)(sp + b) * plane;
          m1[b] = in ? __ldcg(op.partial + off + idx1) : 0.f;
          m2[b] = in ? __ldcg(op.partial + off + idx2) : 0.f;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const bool in = res_p && sp + b < op.res_splits;
          const size_t off = (size_t)(sp + b) * plane;
          r1[b] = in ? __ldcg(op.res_partial + off + idx1) : 0.f;
          r2[b] = in ? __ldcg(op.res_partial + off + idx2) : 0.f;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          v1 += m1[b];
          v2 += m2[b];
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          q1 += r1[b];
          q2 += r2[b];
        }
      }
      v1 += b1;
      v2 += b2;
      s1 += v1;
      s2 += v1 * v1;
      if (two) {
        s1 += v2;
        s2 += v2 * v2;
      }
      if (keep) {
        stash[i] = v1;
        stash_add[i] = a1 + d1 + (res_p ? op.res_bias[ch1] + q1 : 0.f);
        stash_scale[i] = sc1;
        stash_gbias[i] = gb1;
        if (two) {
          stash[i2] = v2;
          stash_add[i2] = a2 + d2 + (res_p ? op.res_bias[ch2] + q2 : 0.f);
          stash_scale[i2] = sc2;
          stash_gbias[i2] = gb2;
        }
      }
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
      int ch;
      const size_t idx = index(i, ch);
      // a thread reads back only what it stored itself
      const float v = keep ? stash[i]
                           : op.bias[ch] + sum_partials(op.partial, op.splits,
                                                        plane, idx);
      const float scale = keep ? stash_scale[i] : op.scale[ch];
      const float gbias = keep ? stash_gbias[i] : op.gbias[ch];
      const float y = mish((v - mean) * rstd * scale + gbias);
      op.out[idx] = y + (keep ? stash_add[i] : addend(idx, ch));
    }
    __syncthreads();  // stat, red and stash are reused by the next item
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
