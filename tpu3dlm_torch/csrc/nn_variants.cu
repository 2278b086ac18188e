// Nearest-neighbour probe variants with a bf16 cross term on the tensor
// cores, for Hopper (sm_90a).
//
// Replaces scripts/bench_nn_variants.py::nn_variant (TPU kernels _kernel_v1
// and _kernel_v2): the reference's probe of one bf16 pass of the matrix
// unit for the cross term, without the limbs of the production kernel.
// Same semantics: for queries a (n, 3) and targets b (m, 3), with
// b2_j = |b_j|^2 in f32 from the exact coordinates,
//     dp_ij = b2_j - 2 * bf16(a_i) . bf16(b_j)   (products exact, f32 sums)
//     idx_i = the lowest j that attains min_j dp_ij
//     d2_i  = max(min_j dp_ij + |a_i|^2, 0)       (|a|^2 added once, at emit)
// The picks are the bf16-noisy ones the reference retired (a near-tie can
// flip); this is a probe of speed, verified against the exact kernel B2 by
// the true f64 distance of every pick.
//
// The cross term is one mma.sync m16n8k8 (bf16 in, f32 accumulate) per
// 16 queries x 8 targets: A = -2 bf16(a) (the scale by -2 is exact), B =
// bf16(b), K = 3 padded to 8 with zeros, and the accumulator seeded with
// b2, so dp comes out of the MMA. K = 8 is the shallowest bf16 mma.sync,
// half the padded tensor work of m16n8k16. Targets are staged through
// shared memory as ready-made B fragments (x|y and z|0 as bf16 pairs) and
// b2; targets past the block's range are never read (their b2 is +inf), so
// no 1e15 sentinel is needed.
//
// Two kernels, which differ in how they keep the minimum:
//  * v1 (the reference's _kernel_v1): a running (min, argmin) per query
//    held in registers, a compare and two selects per pair, as B2 does.
//  * v2 (_kernel_v2, the "two-level minimum"): per chunk of 64 targets the
//    lane's minimum first (one fminf per pair); only where that beats the
//    running minimum with a strict <, the lowest column that attains it
//    (the iota-min). Ties keep the lowest index either way.
// A lane holds two query rows of each 16-row tile and two of every eight
// target columns; the four lanes of a quad merge (min, lowest index) at
// the end. Both kernels take the target range of a split, as B2 does, and
// B2's fold (nn_fold.cuh) folds the per-split minima and adds |a|^2. The
// probe's v3 and v4 are launch configurations of v1 (split targets; 128
// instead of 64 queries per block), not kernels.
//
// Bound on an H100 SXM at 16384 x 1,048,576: one compare per pair is
// 1.72e10 instructions, 0.51 ms at 33.5 T instructions/s (67 TFLOP/s of
// f32 FMA counted as two flops), above the cross term's 2 * 3 flops per
// pair at 989 TFLOP/s (0.10 ms) and the 12.8 MB of inputs and outputs
// (4 us at 3.35 TB/s): bound by operations. v1 issues about three CUDA-core
// instructions per pair, v2 about one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nn_fold.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;   // targets per shared-memory tile (12 KB)
constexpr int kChunk = 8;     // v2: 8-target column tiles per chunk (64 targets)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x8, row) * B(8x8, col) + C, bf16 in, f32 accumulate. With g =
// lane / 4 and t = lane % 4 (PTX ISA, mma.m16n8k8 .bf16): a0 = A[g][2t..2t+1],
// a1 = A[g+8][2t..2t+1]; b0 = B[2t..2t+1][g]; c0..1 = C[g][2t..2t+1],
// c2..3 = C[g+8][2t..2t+1].
__device__ __forceinline__ void mma_1688(float* d, uint32_t a0, uint32_t a1, uint32_t b0,
                                         float c0, float c1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%7,%8};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(c0), "f"(c1));
}

// (v, i) <- the smaller of (v, i) and (ov, oi), the lower index on a tie
__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// QT: 16-query row tiles per warp (64 * QT queries per block).
// TWO_LEVEL: false = v1, true = v2.
template <int QT, bool TWO_LEVEL>
__global__ void __launch_bounds__(kThreads)
nn_variant_kernel(const float* __restrict__ a, const float* __restrict__ b, int n, int m,
                  int targets_per_split, float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ uint32_t frag[kTile * 2];  // per target: bf16 (x, y) and (z, 0)
  __shared__ __align__(8) float b2s[kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (blockIdx.x * kWarps + warp) * 16 * QT;

  // A fragments of -2 bf16(a), held for the whole sweep; k = 2t, 2t+1
  uint32_t fa[QT][2];
#pragma unroll
  for (int mt = 0; mt < QT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = q0 + mt * 16 + g + 8 * half;
      uint32_t v = 0u;
      if (q < n && t < 2) {
        const float* p = a + 3 * size_t(q);
        v = t == 0 ? pack_bf16(-2.f * p[0], -2.f * p[1]) : pack_bf16(-2.f * p[2], 0.f);
      }
      fa[mt][half] = v;
    }
  }

  // running minimum of this lane's columns, rows g and g + 8 of each tile
  float best[QT][2];
  int best_j[QT][2];
#pragma unroll
  for (int mt = 0; mt < QT; ++mt) {
    best[mt][0] = best[mt][1] = INFINITY;
    best_j[mt][0] = best_j[mt][1] = 0;
  }

  const int j_begin = blockIdx.y * targets_per_split;
  const int j_end = min(m, j_begin + targets_per_split);
  for (int t0 = j_begin; t0 < j_end; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int s = threadIdx.x; s < kTile; s += kThreads) {
      const int j = t0 + s;
      uint32_t xy = 0u, z0 = 0u;
      float w = INFINITY;  // past the range: dp = +inf never wins
      if (j < j_end) {
        const float x = b[3 * size_t(j)], y = b[3 * size_t(j) + 1], z = b[3 * size_t(j) + 2];
        xy = pack_bf16(x, y);
        z0 = pack_bf16(z, 0.f);
        w = fmaf(z, z, fmaf(y, y, x * x));
      }
      frag[2 * s] = xy;
      frag[2 * s + 1] = z0;
      b2s[s] = w;
    }
    __syncthreads();

    if constexpr (!TWO_LEVEL) {
#pragma unroll 4
      for (int s = 0; s < kTile; s += 8) {
        const uint32_t fb = t < 2 ? frag[2 * (s + g) + t] : 0u;
        const float2 c = *reinterpret_cast<const float2*>(b2s + s + 2 * t);
        const int j = t0 + s + 2 * t;
#pragma unroll
        for (int mt = 0; mt < QT; ++mt) {
          float d[4];
          mma_1688(d, fa[mt][0], fa[mt][1], fb, c.x, c.y);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (d[e] < best[mt][e >> 1]) {
              best[mt][e >> 1] = d[e];
              best_j[mt][e >> 1] = j + (e & 1);
            }
          }
        }
      }
    } else {
      for (int s0 = 0; s0 < kTile; s0 += 8 * kChunk) {
        float d[kChunk][QT][4];
        float cmin[QT][2];
#pragma unroll
        for (int mt = 0; mt < QT; ++mt) cmin[mt][0] = cmin[mt][1] = INFINITY;
#pragma unroll
        for (int c8 = 0; c8 < kChunk; ++c8) {
          const int s = s0 + 8 * c8;
          const uint32_t fb = t < 2 ? frag[2 * (s + g) + t] : 0u;
          const float2 c = *reinterpret_cast<const float2*>(b2s + s + 2 * t);
#pragma unroll
          for (int mt = 0; mt < QT; ++mt) {
            mma_1688(d[c8][mt], fa[mt][0], fa[mt][1], fb, c.x, c.y);
            cmin[mt][0] = fminf(cmin[mt][0], fminf(d[c8][mt][0], d[c8][mt][1]));
            cmin[mt][1] = fminf(cmin[mt][1], fminf(d[c8][mt][2], d[c8][mt][3]));
          }
        }
        // the rare second level: where the chunk beats the running minimum,
        // the first (lowest) column that attains the chunk's minimum
#pragma unroll
        for (int mt = 0; mt < QT; ++mt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (cmin[mt][r] < best[mt][r]) {
              int jj = 0x7fffffff;
#pragma unroll
              for (int c8 = kChunk - 1; c8 >= 0; --c8) {
                const int j = t0 + s0 + 8 * c8 + 2 * t;
                if (d[c8][mt][2 * r + 1] <= cmin[mt][r]) jj = j + 1;
                if (d[c8][mt][2 * r] <= cmin[mt][r]) jj = j;
              }
              best[mt][r] = cmin[mt][r];
              best_j[mt][r] = jj;
            }
          }
        }
      }
    }
  }

  // merge the quad's four column sets, then one lane writes each row
#pragma unroll
  for (int mt = 0; mt < QT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = best[mt][r];
      int i = best_j[mt][r];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        merge(v, i, __shfl_xor_sync(0xffffffffu, v, off), __shfl_xor_sync(0xffffffffu, i, off));
      const int q = q0 + mt * 16 + g + 8 * r;
      if (t == 0 && q < n) {
        part_d[size_t(blockIdx.y) * n + q] = v;
        part_i[size_t(blockIdx.y) * n + q] = i;
      }
    }
  }
}

template <int QT, bool TWO_LEVEL>
cudaError_t launch_partial(const float* a, const float* b, int n, int m, int splits, int per_split,
                           float* part_d, int* part_i, cudaStream_t s) {
  const int per_block = kWarps * 16 * QT;
  const dim3 grid((n + per_block - 1) / per_block, splits);
  nn_variant_kernel<QT, TWO_LEVEL><<<grid, kThreads, 0, s>>>(a, b, n, m, per_split, part_d, part_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// queries per block of a kernel with `qt` row tiles per warp
int nnv_queries_per_block(int qt) { return kWarps * 16 * qt; }

int nnv_tile() { return kTile; }

// kernel 1 (v1) or 2 (v2), qt 1 or 2; a (n, 3) and b (m, 3) f32 row-major
// on the device; part_d / part_i hold splits * n scratch values each; idx
// (n,) int64 and d2 (n,) f32 are the results; each split covers
// targets_per_split targets. Returns the CUDA error of the launches.
int nnv_launch(int kernel, int qt, const float* a, const float* b, int n, int m, int splits,
               int targets_per_split, float* part_d, int* part_i, int64_t* idx, float* d2,
               void* stream) {
  if (n <= 0) return 0;
  if (m <= 0 || splits <= 0 || splits > 65535 || targets_per_split <= 0 ||
      (long long)splits * targets_per_split < m)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kernel == 1 && qt == 1)
    err = launch_partial<1, false>(a, b, n, m, splits, targets_per_split, part_d, part_i, s);
  else if (kernel == 1 && qt == 2)
    err = launch_partial<2, false>(a, b, n, m, splits, targets_per_split, part_d, part_i, s);
  else if (kernel == 2 && qt == 1)
    err = launch_partial<1, true>(a, b, n, m, splits, targets_per_split, part_d, part_i, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  nn_fold_kernel<<<(n + 255) / 256, 256, 0, s>>>(a, n, splits, part_d, part_i, idx, d2);
  return (int)cudaGetLastError();
}

}  // extern "C"
