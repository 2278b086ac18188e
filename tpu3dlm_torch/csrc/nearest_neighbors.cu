// Brute-force nearest neighbour in 3D, for Hopper (sm_90a).
//
// Replaces tpu3dlm/ops/pallas/pairwise.py::nearest_neighbors_pallas (TPU
// kernel _nn_kernel). Same semantics: for every query a_i of a (N, 3) and
// the targets b_j of b (M, 3)
//     m_i   = min_j ( |b_j|^2 - 2 a_i . b_j )      (f32)
//     idx_i = the lowest j that attains m_i
//     d2_i  = max(m_i + |a_i|^2, 0)
// |a_i|^2 is constant per query, so it leaves the argmin unchanged and is
// added once at the end. Targets past M never win (they are never read).
//
// The TPU kernel splits each coordinate into three bf16 limbs so that its
// matrix unit gives an exact f32 cross term. With K = 3 the cross term here
// is three f32 FMAs on the CUDA cores, exact to f32 rounding, so no limbs and
// no tensor cores: a TF32 product would flip most picks on scan geometry,
// the fault the reference measured (pairwise.py:91-95).
//
// Bound on an H100 SXM: every pair costs three FMAs (-2a is pre-scaled and
// |b|^2 is the addend of the first) = 6 flops, so 16384 x 1,048,576 queries
// by targets are 103 GFLOP = 1.54 ms at 67 TFLOP/s of f32. The inputs are
// 12.6 MB (4 us at 3.35 TB/s), so it is bound by operations.
//
// What the design does about it: a running (min, argmin) costs a compare and
// two selects per pair on top of the three FMAs (six instruction slots where the
// bound counts three). Here the minimum is taken in two levels on the same
// exact FMA chain:
//  * per chunk of kChunk targets, each query folds fminf over the chunk,
//    seeded with its running best: one min per pair (four slots);
//  * per chunk, one strict < against the running best records the chunk
//    that improved it, so ties go to the earliest chunk;
//  * at the end of each shared-memory tile, for a query whose best fell in
//    it, the winning chunk's kChunk values are recomputed from the tile
//    with the same fmaf order (bit-identical) and the first j that equals
//    the minimum is the pick.
// So the picks and d^2 are the running minimum's bit for bit: the lowest
// index that attains the minimum within the split, then nn_fold_kernel.
//
// Two kernels:
//  * nn_partial_kernel: a block of 128 threads owns 1024 queries (eight per
//    thread, held in registers as -2a) and one contiguous range ("split") of
//    the targets. It streams that range through a double-buffered shared
//    tile of 1024 targets stored as float4 (x, y, z, |b|^2): each thread
//    loads its share of the next tile into registers before the current
//    tile's sweep, so the load latency hides under it, and one barrier per
//    tile remains. Every thread reads the same target at once (a broadcast).
//    Splitting the target axis gives enough blocks to fill the card when
//    the queries alone would not (16384 queries are only 16 blocks).
//  * nn_fold_kernel (nn_fold.cuh, shared with B4): one thread per query
//    folds the per-split minima in split order with a strict <, so ties go
//    to the lowest split and so to the lowest index overall, then adds
//    |a|^2 and clamps at 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nn_fold.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQueriesPerThread = 8;
constexpr int kQueriesPerBlock = kThreads * kQueriesPerThread;
constexpr int kTile = 1024;   // targets per shared-memory tile (16 KB)
constexpr int kChunk = 32;    // targets per first-level minimum
constexpr int kLoads = kTile / kThreads;  // targets each thread stages per tile
constexpr float kBig = 1e30f;  // initial minimum, as the reference's _BIG

static_assert(kTile % kChunk == 0, "a chunk never straddles a tile");

// (x, y, z, |b|^2) of target j, or a target that never wins past the split
__device__ __forceinline__ float4 load_target(const float* __restrict__ b, int j, int j_end) {
  if (j >= j_end) return make_float4(0.f, 0.f, 0.f, INFINITY);
  const float x = b[3 * (size_t)j], y = b[3 * (size_t)j + 1], z = b[3 * (size_t)j + 2];
  return make_float4(x, y, z, fmaf(z, z, fmaf(y, y, __fmul_rn(x, x))));
}

// |b|^2 - 2 a.b with -2a pre-scaled: the one FMA chain both levels use
__device__ __forceinline__ float cross(float ax, float ay, float az, float4 v) {
  return fmaf(ax, v.x, fmaf(ay, v.y, fmaf(az, v.z, v.w)));
}

__global__ void __launch_bounds__(kThreads)
nn_partial_kernel(const float* __restrict__ a, const float* __restrict__ b, int n, int m,
                  int targets_per_split, float* __restrict__ part_d,
                  int* __restrict__ part_i) {
  __shared__ float4 tile[2][kTile];

  const int q0 = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  float ax[kQueriesPerThread], ay[kQueriesPerThread], az[kQueriesPerThread];
  float best[kQueriesPerThread];
  int best_j[kQueriesPerThread];
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    const int q = q0 + k * kThreads;
    float x = 0.f, y = 0.f, z = 0.f;
    if (q < n) {
      x = a[3 * (size_t)q];
      y = a[3 * (size_t)q + 1];
      z = a[3 * (size_t)q + 2];
    }
    ax[k] = -2.f * x;  // exact: a power-of-two scale
    ay[k] = -2.f * y;
    az[k] = -2.f * z;
    best[k] = kBig;
    best_j[k] = 0;  // no target below kBig: index 0, as the running minimum leaves it
  }

  const int j_begin = blockIdx.y * targets_per_split;
  const int j_end = min(m, j_begin + targets_per_split);
  float4 next[kLoads];
#pragma unroll
  for (int l = 0; l < kLoads; ++l) next[l] = load_target(b, j_begin + threadIdx.x + l * kThreads, j_end);
  int buf = 0;
  for (int t0 = j_begin; t0 < j_end; t0 += kTile, buf ^= 1) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) tile[buf][threadIdx.x + l * kThreads] = next[l];
    __syncthreads();  // tile[buf] is whole; tile[buf ^ 1] was consumed before this barrier
    if (t0 + kTile < j_end) {
#pragma unroll
      for (int l = 0; l < kLoads; ++l)
        next[l] = load_target(b, t0 + kTile + threadIdx.x + l * kThreads, j_end);
    }
    const float4* cur = tile[buf];
    int won[kQueriesPerThread];  // first target (in the tile) of the chunk that last lowered best
#pragma unroll
    for (int k = 0; k < kQueriesPerThread; ++k) won[k] = -1;
    for (int c = 0; c < kTile; c += kChunk) {
      float mn[kQueriesPerThread];
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) mn[k] = best[k];
#pragma unroll 8
      for (int s = 0; s < kChunk; ++s) {
        const float4 v = cur[c + s];
#pragma unroll
        for (int k = 0; k < kQueriesPerThread; ++k) mn[k] = fminf(mn[k], cross(ax[k], ay[k], az[k], v));
      }
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) {
        if (mn[k] < best[k]) {
          best[k] = mn[k];
          won[k] = c;
        }
      }
    }
    // the pick, while the tile is resident: the first target of the winning
    // chunk whose value, recomputed with the same FMA chain, equals best
#pragma unroll
    for (int k = 0; k < kQueriesPerThread; ++k) {
      if (won[k] < 0) continue;
#pragma unroll 1
      for (int s = 0; s < kChunk; ++s) {
        const float d = cross(ax[k], ay[k], az[k], cur[won[k] + s]);
        if (d == best[k]) {
          best[k] = d;  // the target's own value (+0 where fminf may have kept -0)
          best_j[k] = t0 + won[k] + s;
          break;
        }
      }
    }
  }

  const size_t row = (size_t)blockIdx.y * n;
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    const int q = q0 + k * kThreads;
    if (q < n) {
      part_d[row + q] = best[k];
      part_i[row + q] = best_j[k];
    }
  }
}

}  // namespace

extern "C" {

int nn_queries_per_block() { return kQueriesPerBlock; }

int nn_tile() { return kTile; }

// a (n, 3) and b (m, 3) f32 row-major on the device; part_d / part_i hold
// splits * n scratch values each; idx (n,) int64 and d2 (n,) f32 are the
// results. Each split covers targets_per_split targets. Returns the CUDA
// error of the launches (0 on success).
int nn_launch(const float* a, const float* b, int n, int m, int splits, int targets_per_split,
              float* part_d, int* part_i, int64_t* idx, float* d2, void* stream) {
  if (n <= 0) return 0;
  if (m <= 0 || splits <= 0 || splits > 65535 || targets_per_split <= 0 ||
      targets_per_split % kTile != 0 || (long long)splits * targets_per_split < m)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, splits);
  nn_partial_kernel<<<grid, kThreads, 0, s>>>(a, b, n, m, targets_per_split, part_d, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_fold_kernel<<<(n + 255) / 256, 256, 0, s>>>(a, n, splits, part_d, part_i, idx, d2);
  return (int)cudaGetLastError();
}

}  // extern "C"
