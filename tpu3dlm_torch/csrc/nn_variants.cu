// Nearest-neighbour probe variants with a bf16 cross term on the tensor
// cores, for Hopper (sm_90a): kernel B4.
//
// Replaces scripts/bench_nn_variants.py::nn_variant, the TPU kernels
// _kernel_v1 (:51) and _kernel_v2 (:86): the reference's probe of one bf16
// pass of the matrix unit for the cross term, without the limbs of the
// production kernel. Same semantics: for queries a (n, 3) and targets
// b (m, 3), with b2_j = |b_j|^2 in f32 from the exact coordinates,
//     dp_ij = b2_j - 2 * bf16(a_i) . bf16(b_j)   (products exact, f32 sums)
//     idx_i = the lowest j that attains min_j dp_ij
//     d2_i  = max(min_j dp_ij + |a_i|^2, 0)       (|a|^2 added once, at emit)
// The picks are the bf16-noisy ones the reference retired (a near-tie can
// flip); this is a probe of speed, verified against the exact kernel B2 by
// the true f64 distance of every pick.
//
// Bound on an H100 SXM at 16384 x 1,048,576: one compare per pair is
// 1.72e10 instructions, 0.51 ms at 33.5 T instructions/s (67 TFLOP/s of
// f32 FMA counted as two flops), above the cross term's 2 * 3 flops per
// pair at 989 TFLOP/s (0.10 ms) and the 12.8 MB of inputs and outputs
// (4 us at 3.35 TB/s): bound by operations. This design pads the MMA depth
// to 16, so its tensor work is 2 * 16 flops per pair, 5.5e14 flop = 0.56 ms
// at 989 TFLOP/s: its own floor, above the bound. Measured on an H100
// 80GB HBM3 at 700 W (PERF.md §6, by scripts/nn_variants_ablation.py):
// without its minimum the sweep takes 0.60-0.64 ms, near that floor;
// without its MMAs v2's takes 0.60 ms and v1's 3.72, against 1.90 and 2.38
// for the whole. The parts do not add up to the whole, and what takes the
// rest is an open question (PERF.md §7).
//
// The design, against the four causes that held the mma.sync form of this
// kernel at 9-14% of the bound:
//  * Targets packed once per call (nn_pack_kernel, before the sweep): one
//    32-byte row per target, bf16 (x, y, z, L1, L2, L3, 0 x 10), where
//    L1 + L2 + L3 = b2 exactly (three bf16 limbs hold f32's 24-bit
//    significand), and rows past m up to a whole ring stage carry L1 = +inf
//    so that they never win. A query's row is (-2 bf16(a), 1, 1, 1, 0 x 10)
//    (the scale by -2 is exact), so the MMA emits dp from a zero
//    accumulator and the inner loop reads nothing but the MMA's operands
//    (the mma.sync form read a B fragment and a float2 of b2 from shared
//    memory per 16 x 8 MMA, and every block packed all targets again).
//  * TMA into a ring: the packed rows arrive by cp.async.bulk.tensor in
//    boxes of 256 rows (32-byte swizzle), kStages stages of kStageTargets
//    targets, each guarded by a full and an empty mbarrier. One thread of
//    a producer warp keeps the ring full, so copies stay in flight under
//    the MMAs (the mma.sync form staged synchronously between two
//    barriers).
//  * wgmma: each consumer warpgroup writes its A (R row tiles of 64
//    queries) once into shared memory and runs m64nNk16 with A and B
//    straight from the swizzled tiles. Two accumulator sets alternate
//    within a stage: tile u + 1's MMA is in flight while the thread folds
//    tile u's N/2 accumulators, which are independent of each other, so
//    the latency is hidden by that ILP and by the other warpgroups rather
//    than paid by one dependent chain per warp (the mma.sync form's compare
//    waited on the MMA before it, about 76 cycles per MMA). The last tile
//    of a stage is waited with wait_group 0, so no MMA is in flight across
//    a loop back-edge: ptxas serializes every wgmma of a kernel that reads
//    an accumulator while a wgmma of that loop may still be in flight.
//  * Enough work in flight: a CTA is four consumer warpgroups sharing one
//    ring (256 * R queries against every target they load, which halves
//    the bytes per pair against 128), one CTA per SM, four consumer warps
//    on each SM sub-partition; the wrapper's plan splits the target axis so
//    the grid covers the SMs, and nn_fold.cuh folds the per-split minima in
//    split order, as B2 does.
//
// Two kernels (one template), which differ in how they keep the minimum:
//  * v1 (_kernel_v1): a running (min, argmin) per accumulator element: a
//    compare on the ALU pipe and two selects as predicated multiply-adds
//    on the FMA pipe (keep_min), keeping the column tile's first target
//    (the element's column is added at the end).
//  * v2 (_kernel_v2, the two-level minimum): per column tile (a chunk of N
//    targets) and row, the thread's minimum first (one fminf per pair, four
//    chains); only where that beats the running minimum with a strict <,
//    the lowest column that attains it (one warp-uniform branch a tile).
// Ties go to the lowest index everywhere: an element's chain and v2's
// chunks run in increasing target order with a strict <; a thread's
// columns (8i + 2t + c in the wgmma accumulator layout) and the 4 lanes of
// a quad merge (value, index) with the lower index on equal values; splits
// fold in split order. The query rows are distinct per warpgroup, so no
// merge crosses warpgroups. Both kernels compute dp with the same wgmma on
// the same operands, so every variant's picks and d^2 are bit-identical.
// The probe's v3 and v4 are launch configurations of v1 (more target
// splits; two row tiles per warpgroup), not kernels.
//
// Column tiles (N) and row tiles (R) per variant: v1 and v3 N = 32, R = 1;
// v2 N = 64, R = 1; v4 N = 16, R = 2. Seventeen warps a CTA put five on
// one SM sub-partition, so a thread has at most 96 registers. v1 keeps a
// running (min, index) per accumulator element, so two accumulator sets
// and its minima need 2 * N (R = 1) or 4 * N (R = 2) registers: at v2's
// N = 64, or at v1's N = 32 with R = 2, they spill. v2 keeps two minima a
// row tile and takes N = 64, which halves its warp votes per target.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nn_fold.cuh"

// Each kernel's column tile (the wgmma's N), set here; the defaults are the
// shipped ones. NNV_SKIP builds a diagnostic copy without a part of the
// sweep: 1 leaves out the minimum, 2 the MMAs. Neither changes the shipped
// build; tpu3dlm_torch/scripts/nn_variants_ablation.py builds and times them.
#ifndef NNV_V1_N
#define NNV_V1_N 32  // v1, v3
#endif
#ifndef NNV_V2_N
#define NNV_V2_N 64
#endif
#ifndef NNV_V4_N
#define NNV_V4_N 16
#endif
#ifndef NNV_SKIP
#define NNV_SKIP 0
#endif

namespace {

constexpr int kK = 16;                   // MMA depth: a packed row is 16 bf16
constexpr int kRowBytes = kK * 2;        // 32 bytes, one 32-byte swizzle span
constexpr int kBoxRows = 256;            // targets per TMA box (the box limit)
constexpr int kStageTargets = 512;       // targets per ring stage; the split granularity
constexpr int kStageBytes = kStageTargets * kRowBytes;
constexpr int kStages = 4;
constexpr int kConsumers = 4;            // consumer warpgroups per CTA
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp (one thread works)
constexpr int kAlign = 1024;             // stage bases on the swizzle period
constexpr int kATileBytes = 64 * kRowBytes;   // one 64-query row tile of A
constexpr int kMaxRows = 2;                     // row tiles per consumer warpgroup, at most
constexpr int kABytes = kConsumers * kMaxRows * kATileBytes;
constexpr int kSmem = kAlign + kStages * kStageBytes + kABytes + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins the accumulators in place around the asynchronous MMA: their reads
// are not moved above the wait, nor their registers reused across it.
template <int A>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int e = 0; e < A; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile of 32-byte rows in the
// TMA's 32-byte swizzle (layout 3): 8-row groups 256 bytes apart (SBO); the
// tile is one swizzle span wide, so the leading offset is unused (1).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t sbo = 8 * kRowBytes;
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | ((sbo >> 4) << 32) |
         (uint64_t(3) << 62);
}

// wgmma.mma_async m64nNk16, bf16 in, f32 out, A and B K-major by
// descriptor, the accumulator overwritten (scale-d = 0): d[N/2] per thread,
// element e = 4i + 2h + c at row g + 8h, column 8i + 2t + c (g = lane / 4,
// t = lane % 4, the row within the warp's 16).
template <int N>
__device__ void wgmma_ss(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %10, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (best, best_j) <- (d, jt) where d < best: the compare on the ALU pipe,
// the two selects as predicated multiply-adds on the FMA pipe, which is
// twice as wide (FSEL and SEL would put all three on the ALU). fma(d, 1, 0)
// is d but for -0, which it makes +0: equal under every compare here, and
// the same d^2. The index is bits(d) * zero + jt with zero = 0 known to the
// compiler only at run time, so it stays one multiply-add per element and
// is not hoisted into a select.
__device__ __forceinline__ void keep_min(float& best, int& best_j, float d, int jt, int zero) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.f32 p, %2, %0;\n\t"
      "@p fma.rn.f32 %0, %2, 0f3F800000, 0f00000000;\n\t"
      "@p mad.lo.s32 %1, %3, %4, %5;\n\t}"
      : "+f"(best), "+r"(best_j)
      : "f"(d), "r"(__float_as_int(d)), "r"(zero), "r"(jt));
}

// (v, i) <- the smaller of (v, i) and (ov, oi), the lower index on a tie
__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The R wgmmas of column tile u of a stage (N targets) into acc.
template <int N, int R>
__device__ __forceinline__ void issue_tile(float (&acc)[R][N / 2], uint32_t a_tile, uint32_t stage,
                                           int u) {
  const uint64_t db = smem_desc(stage + u * N * kRowBytes);
#pragma unroll
  for (int r = 0; r < R; ++r) fence_acc<N / 2>(acc[r]);
  wgmma_fence();
#if NNV_SKIP != 2
#pragma unroll
  for (int r = 0; r < R; ++r) wgmma_ss<N>(acc[r], smem_desc(a_tile + r * kATileBytes), db);
#endif
  wgmma_commit();
}

// Folds a column tile's completed accumulators, whose first target is jt,
// into the running minima. v1: per accumulator element, a compare and two
// selects, keeping jt (the element's column is added at the end). v2: per
// row, the tile's minimum over the thread's N/4 values (four fminf chains);
// only where it beats the running one (strict <), the lowest column that
// attains it.
template <int N, int R, bool TWO_LEVEL, int S>
__device__ __forceinline__ void retire_tile(float (&acc)[R][N / 2], int jt, float (&best)[R][S],
                                            int (&best_j)[R][S], int zero) {
  constexpr int kAcc = N / 2;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    fence_acc<kAcc>(acc[r]);
    if constexpr (NNV_SKIP == 1) {
      continue;
    } else if constexpr (!TWO_LEVEL) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e) keep_min(best[r][e], best_j[r][e], acc[r][e], jt, zero);
    } else {
      float cmin[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mn[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) mn[c] = acc[r][4 * (c >> 1) + 2 * h + (c & 1)];
#pragma unroll
        for (int i = 2; i < N / 8; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) mn[2 * (i & 1) + c] = fminf(mn[2 * (i & 1) + c], acc[r][4 * i + 2 * h + c]);
        }
        cmin[h] = fminf(fminf(mn[0], mn[1]), fminf(mn[2], mn[3]));
      }
      // rare: where a row's tile minimum beats its running one (strict <),
      // the lowest column that attains it; one warp-uniform branch a tile
      const bool lo = cmin[0] < best[r][0], hi = cmin[1] < best[r][1];
      if (__any_sync(0xffffffffu, lo || hi)) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int col = 0;
          float val = cmin[h];
#pragma unroll
          for (int i = N / 8 - 1; i >= 0; --i) {
#pragma unroll
            for (int c = 1; c >= 0; --c) {
              const float d = acc[r][4 * i + 2 * h + c];
              col = d == cmin[h] ? 8 * i + c : col;
              val = d == cmin[h] ? d : val;  // the target's own value (+0 where fminf kept -0)
            }
          }
          const bool better = h == 0 ? lo : hi;
          best[r][h] = better ? val : best[r][h];
          best_j[r][h] = better ? jt + col : best_j[r][h];
        }
      }
    }
  }
}

// N: targets per column tile (the wgmma's N); R: 64-query row tiles per
// consumer warpgroup; TWO_LEVEL: false = v1, true = v2.
template <int N, int R, bool TWO_LEVEL>
__global__ void __launch_bounds__(kThreads, 1)
nn_variant_kernel(const __grid_constant__ CUtensorMap map_b, const float* __restrict__ a, int n,
                  int m_pad, int per_split, float* __restrict__ part_d, int* __restrict__ part_i) {
  constexpr int kSub = kStageTargets / N;  // column tiles per stage
  constexpr int kAcc = N / 2;              // accumulators per thread per row tile
  static_assert(kSub % 2 == 0, "the two accumulator sets alternate within a stage");
  static_assert(R <= kMaxRows, "the A tiles hold kMaxRows row tiles per warpgroup");
  constexpr int kSlots = TWO_LEVEL ? 2 : kAcc;  // running minima per row tile

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~uintptr_t(kAlign - 1));
  const uint32_t stage0 = smem_u32(smem);
  const uint32_t a0 = stage0 + kStages * kStageBytes;     // the A tiles
  const uint32_t full0 = a0 + kABytes;                    // a stage landed
  const uint32_t empty0 = full0 + kStages * 8;            // a stage consumed by every consumer warp

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty0 + 8 * s, kConsumers * 4);    // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int j_begin = blockIdx.y * per_split;
  const int n_stages = (min(m_pad, j_begin + per_split) - j_begin) / kStageTargets;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= kConsumers * 4) {
    // ---- producer warp: one thread keeps the ring full ----
    if (lane == 0) {
      for (int st = 0; st < n_stages; ++st) {
        const int s = st % kStages, use = st / kStages;
        mbar_wait(empty0 + 8 * s, (use & 1) ^ 1);  // released by every consumer warp
        mbar_expect_tx(full0 + 8 * s, kStageBytes);
#pragma unroll
        for (int box = 0; box < kStageTargets / kBoxRows; ++box)
          tma_load_2d(stage0 + s * kStageBytes + box * kBoxRows * kRowBytes, &map_b, full0 + 8 * s,
                      0, j_begin + st * kStageTargets + box * kBoxRows);
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes R row tiles of 64 queries ----
    const int wg = warp >> 2, w = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    // query of this lane's row g in row tile 0 (row g + 8 is 8 further)
    const int q0 = (blockIdx.x * kConsumers + wg) * 64 * R + 16 * w + g;

    // A = (-2 bf16(a), 1, 1, 1, 0...) per query, rows past n zero: the
    // warpgroup's R row tiles of 64 rows of 32 bytes, written once in the
    // 32-byte swizzle (16-byte chunk c of row x at chunk c ^ bit 2 of x)
    const uint32_t a_tile = a0 + wg * R * kATileBytes;
    for (int x = threadIdx.x & 127; x < 64 * R; x += 128) {
      const int q = (blockIdx.x * kConsumers + wg) * 64 * R + x;
      uint32_t w0 = 0u, w1 = 0u, w2 = 0u;
      if (q < n) {
        const float* p = a + 3 * size_t(q);
        w0 = pack_bf16(-2.f * p[0], -2.f * p[1]);
        w1 = pack_bf16(-2.f * p[2], 1.f);
        w2 = pack_bf16(1.f, 1.f);
      }
      const uint32_t row = a_tile + x * kRowBytes, swz = ((x >> 2) & 1) * 16;
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(row + swz), "r"(w0), "r"(w1),
                   "r"(w2), "r"(0u) : "memory");
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};" ::"r"(row + (16 ^ swz)), "r"(0u)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // seen by the wgmmas
    // the warpgroup's rows are all written (named barrier 1 + wg, its 128 threads)
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");

    const int zero = int(blockDim.x) / kThreads - 1;  // 0, opaque to the compiler
    float best[R][kSlots];
    int best_j[R][kSlots];  // v1: the column tile's first target; v2: the target less 2t
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < kSlots; ++e) {
        best[r][e] = INFINITY;
        best_j[r][e] = 0;
      }
    }
    float acc0[R][kAcc], acc1[R][kAcc];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc0[r][e] = acc1[r][e] = 0.f;
    }

    // per stage: wait for it to land, then its kSub column tiles with two
    // accumulator sets, tile u + 1's wgmmas in flight while tile u is
    // folded; the last wait (group 0) drains the stage, which is then
    // released, so no wgmma is in flight from one stage to the next
    for (int st = 0; st < n_stages; ++st) {
      const int s = st % kStages;
      mbar_wait(full0 + 8 * s, (st / kStages) & 1);
      const uint32_t stage = stage0 + s * kStageBytes;
      const int j0 = j_begin + st * kStageTargets;
      issue_tile<N, R>(acc0, a_tile, stage, 0);
#pragma unroll
      for (int u = 0; u < kSub; u += 2) {
        issue_tile<N, R>(acc1, a_tile, stage, u + 1);
        wgmma_wait<1>();
        retire_tile<N, R, TWO_LEVEL>(acc0, j0 + u * N, best, best_j, zero);
        if (u + 2 < kSub) {
          issue_tile<N, R>(acc0, a_tile, stage, u + 2);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
        retire_tile<N, R, TWO_LEVEL>(acc1, j0 + (u + 1) * N, best, best_j, zero);
      }
    }

    // each row's (min, lowest index) over the thread's columns, then over
    // the quad's four column sets; one lane writes the row
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v;
        int i;
        if constexpr (!TWO_LEVEL) {
          v = best[r][2 * h];
          i = best_j[r][2 * h] + 2 * t;
#pragma unroll
          for (int x = 0; x < N / 8; ++x) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              if (x > 0 || c > 0) {
                const int e = 4 * x + 2 * h + c;
                merge(v, i, best[r][e], best_j[r][e] + 8 * x + 2 * t + c);
              }
            }
          }
        } else {
          v = best[r][h];
          i = best_j[r][h] + 2 * t;
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          merge(v, i, __shfl_xor_sync(0xffffffffu, v, off), __shfl_xor_sync(0xffffffffu, i, off));
        const int q = q0 + 64 * r + 8 * h;
        if (t == 0 && q < n) {
          part_d[size_t(blockIdx.y) * n + q] = v;
          part_i[size_t(blockIdx.y) * n + q] = i;
        }
      }
    }
  }
}

// The kernels' B operand: row j < m_pad of packed is bf16 (x, y, z, L1, L2,
// L3, 0 x 10) with L1 = bf16(b2), L2 = bf16(b2 - L1), L3 = bf16(b2 - L1 -
// L2) (each subtraction exact), so L1 + L2 + L3 = b2; rows past m are zero
// but L1 = +inf. The same bits as the wrapper's pack_targets_reference.
__global__ void nn_pack_kernel(const float* __restrict__ b, const float* __restrict__ b2, int m,
                               int m_pad, uint4* __restrict__ packed) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m_pad) return;
  uint4 lo = make_uint4(0u, 0x7F800000u, 0u, 0u);  // z = 0, L1 = +inf
  if (j < m) {
    const float w = b2[j];
    const float l1 = __bfloat162float(__float2bfloat16_rn(w));
    const float r1 = w - l1;
    const float l2 = __bfloat162float(__float2bfloat16_rn(r1));
    const float* p = b + 3 * size_t(j);
    lo = make_uint4(pack_bf16(p[0], p[1]), pack_bf16(p[2], l1), pack_bf16(l2, r1 - l2), 0u);
  }
  packed[2 * size_t(j)] = lo;
  packed[2 * size_t(j) + 1] = make_uint4(0u, 0u, 0u, 0u);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no link against libcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// 2-D map (16, m_pad) of the packed bf16 rows, box (16, kBoxRows), 32-byte swizzle
cudaError_t encode_map(CUtensorMap* map, const void* packed, int m_pad) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cuuint64_t(kK), cuuint64_t(m_pad)};
  const cuuint64_t strides[1] = {cuuint64_t(kRowBytes)};
  const cuuint32_t box[2] = {cuuint32_t(kK), cuuint32_t(kBoxRows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(packed), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N, int R, bool TWO_LEVEL>
cudaError_t launch_partial(const CUtensorMap& map, const float* a, int n, int m_pad, int splits,
                           int per_split, float* part_d, int* part_i, cudaStream_t s) {
  auto kernel = nn_variant_kernel<N, R, TWO_LEVEL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  constexpr int per_block = kConsumers * 64 * R;
  const dim3 grid((n + per_block - 1) / per_block, splits);
  kernel<<<grid, kThreads, kSmem, s>>>(map, a, n, m_pad, per_split, part_d, part_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// queries per CTA with `rows` 64-query row tiles per consumer warpgroup
int nnv_queries_per_block(int rows) { return kConsumers * 64 * rows; }

// targets per ring stage: m_pad and every split's range are multiples
int nnv_stage_targets() { return kStageTargets; }

// Packs the targets (nn_pack_kernel) into `packed`, (m_pad, 16) bf16 on the
// device. b (m, 3) f32 row-major, b2 (m,) its |b|^2 in f32.
int nnv_pack(const float* b, const float* b2, int m, int m_pad, void* packed, void* stream) {
  if (m <= 0 || m_pad < m || m_pad % kStageTargets != 0) return (int)cudaErrorInvalidValue;
  nn_pack_kernel<<<(m_pad + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      b, b2, m, m_pad, static_cast<uint4*>(packed));
  return (int)cudaGetLastError();
}

// kernel 1 (v1) or 2 (v2), rows 1 or 2 (v1 only): the sweep over the
// packed targets (nnv_pack's (m_pad, 16) bf16 rows), then the fold. a
// (n, 3) f32 row-major on the device; part_d / part_i hold splits * n
// scratch values each; idx (n,) int64 and d2 (n,) f32 are the results;
// split s covers targets [s * per_split, min(m_pad, (s + 1) * per_split)),
// none empty. Returns the CUDA error of the launches.
int nnv_sweep(int kernel, int rows, const float* a, const void* packed, int n, int m_pad, int splits,
              int per_split, float* part_d, int* part_i, int64_t* idx, float* d2, void* stream) {
  if (n <= 0) return 0;
  using Launch = cudaError_t (*)(const CUtensorMap&, const float*, int, int, int, int, float*, int*,
                                 cudaStream_t);
  Launch partial = nullptr;
  if (kernel == 1 && rows == 1) partial = launch_partial<NNV_V1_N, 1, false>;
  else if (kernel == 1 && rows == 2) partial = launch_partial<NNV_V4_N, 2, false>;
  else if (kernel == 2 && rows == 1) partial = launch_partial<NNV_V2_N, 1, true>;
  if (partial == nullptr || m_pad <= 0 || m_pad % kStageTargets != 0 || splits <= 0 ||
      splits > 65535 || per_split <= 0 || per_split % kStageTargets != 0 ||
      (long long)splits * per_split < m_pad || (long long)(splits - 1) * per_split >= m_pad)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err = encode_map(&map, packed, m_pad);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = partial(map, a, n, m_pad, splits, per_split, part_d, part_i, s);
  if (err != cudaSuccess) return (int)err;
  nn_fold_kernel<<<(n + 255) / 256, 256, 0, s>>>(a, n, splits, part_d, part_i, idx, d2);
  return (int)cudaGetLastError();
}

}  // extern "C"
