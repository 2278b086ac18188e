// BEiT self-attention, for Hopper (sm_90a), in two layouts.
//
// Replaces two TPU kernels of tpu3dlm/ops/pallas/attention.py with one
// kernel body that takes the layout as strides:
//  * B1, beit_attention_packed_pallas (TPU kernel _attn_kernel_packed):
//    q, k, v are the raw (B, N, h*d) Dense outputs; entry
//    beit_attention_packed_launch.
//  * B3, beit_attention_pallas (TPU kernel _attn_kernel): q, k, v are
//    head-major (h, B, N, d); entry beit_attention_headmajor_launch.
// Same semantics for both: for every batch row b and head h
//     s = q_h k_h^T * (1/sqrt(d)) + bias[h]      (f32)
//     p = softmax(s) in f32, then cast to the input type
//     o_h = p v_h, accumulated in f32, written back in the input type.
// Row r of head h of batch row b starts at element b*sb + h*sh + r*sn:
//     packed      sb = N*h*d   sh = d        sn = h*d
//     head-major  sb = N*d     sh = B*N*d    sn = d
// so either layout is read and written in place: no transposed copy of q,
// k, v or o ever exists (on the TPU the head-major kernel's transposes cost
// 78% of its time, attention.py:170-178), and the (B, h, N, N) score
// tensor never leaves the SM.
//
// Bound on an H100 SXM at the production shape (bf16, B=384, N=197, h=12,
// d=64), the same in both layouts: the function must move q, k, v, o
// (4*384*197*768*2 B = 464.8 MB) plus the f32 bias (1.9 MB), 139 us at
// 3.35 TB/s, while its 45.8 GFLOP take 46 us at the bf16 tensor-core rate
// and its 179 M exps about as long at the special-function rate:
// memory-bound, but only if the loads, the MMAs and the exps overlap.
//
// bf16 (the serving path), attention_bf16_tma. What the design does:
//  * Each byte as few times as the bias allows. A CTA owns 128 query rows
//    (two consumer warpgroups of 64) of one head and walks a run of
//    (head, batch row) items; the ceil(N/128) CTAs that own the row tiles
//    of the same items form one thread-block cluster. K and V of an item
//    come from L2 once per cluster: the cluster's CTAs load them by TMA in
//    8- and 16-row boxes, spread over the CTAs, each box multicast into
//    every CTA. Each CTA keeps its f32 bias rows (128 x N, pre-scaled by
//    log2 e) in shared memory for as long as its items stay on one head,
//    and the items of a cluster are consecutive batch rows of one head (a
//    head change reloads them), so the bias is read about once per CTA, not
//    once per (b, h). Every CTA still receives all of K and V: 128-row CTAs
//    halve that fill against 64-row ones, and 128 bias rows are as many as
//    fit beside the K/V ring.
//  * Loads by TMA with mbarriers. 4-D tensor maps (d, N, heads, B) over the
//    layout's strides: a box past a batch row's N tokens is zero-filled by
//    the hardware and never reads the next row. A producer warpgroup (its
//    registers given to the consumers by setmaxnreg) keeps a ring of K/V
//    stages in flight from one thread and the CTA's Q tile from another;
//    the Q tile refills as soon as both warpgroups' scores are done.
//  * Persistent grid: as many clusters as fit on the card at once
//    (cudaOccupancyMaxActiveClusters), each with an equal share of the
//    heads*B items, so there is no tail wave.
//  * MMAs on wgmma, operands straight from the TMA's swizzled tiles:
//    S = Q K^T as m64nNk16 with N = keys padded to 32 (both operands
//    K-major in shared memory), the f32 score tile in registers; scale,
//    bias and the softmax in f32 (base 2, quad shuffles, four partial
//    maxima and sums per row); the probabilities rounded to bf16 become the
//    register A operand of O = P V (m64ndk16, V MN-major in shared memory,
//    its rows past the box zeroed once). An mma.sync form of this kernel,
//    fed by ldmatrix, spent two thirds of its time on the MMAs (PERF.md).
//  * O leaves the accumulator by a transpose inside each quad of lanes, so
//    every lane writes 16 contiguous bytes of a row.
//
// Every f32 shape (the parity and finetune path), and the bf16 shapes the
// TMA kernel does not take (N > 256, or d not in {16, 32, 64}):
// attention_simt, CUDA cores, templated on the input type and on d (every
// multiple of 16 up to 128), any N. At the finetune shape (f32, B=64, N=197,
// h=12, d=64) its 7.63 GFLOP take 114 us at the 67 TFLOP/s f32 rate, against
// 47 us to move q, k, v, o and the bias at 3.35 TB/s: bound by operations. What the
// design does about that:
//  * Register tiles. A CTA of 4 warps takes 64 query rows of one (batch
//    row, head) item; each thread holds a 4 x 4 tile of S and a 4 x d/8
//    tile of O, so four channels of S take eight 16-byte loads (4 rows of
//    q, 4 of k) for 64 FMAs, and one key of P V takes one 16-byte load of
//    4 p values and d/32 of v for d/2 FMAs. Rows and keys are interleaved (rows rg + 16i,
//    keys kg + 8i) and rows padded by 16 bytes, so those loads are
//    conflict-free and broadcast within a warp.
//  * Key blocks of 32 with an online softmax in f32: a running maximum per
//    row (a shuffle over the 8 lanes of a row group), O rescaled once per
//    block, the division by the row sum at the end; p rounded to the input
//    type before P V, as the twin does. No bound on N, and no (N, N) tile.
//  * The next block's K and V in flight by cp.async (two stages) while the
//    current one is computed; keys and rows past N are zero-filled and the
//    padded keys' scores are -inf. The bias is read from L2 per block.
//  * A persistent flat grid (as many CTAs as fit at once, each walking
//    tiles), so no grid dimension caps the batch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxKeys = 256;  // the TMA kernel's N <= 256

// ---------------------------------------------------------------------------
// bf16: TMA + mbarrier ring, cluster multicast, wgmma from swizzled tiles
// ---------------------------------------------------------------------------

constexpr int kTileRows = 64;                      // query rows per consumer warpgroup
constexpr int kConsumerGroups = 2;                 // warpgroups, the rows of one CTA
constexpr int kCtaRows = kTileRows * kConsumerGroups;  // query rows per CTA
constexpr int kConsumerThreads = 128 * kConsumerGroups;
constexpr int kTmaThreads = kConsumerThreads + 128;  // + the producer warpgroup (one thread works)
constexpr int kMaxStages = 3;
constexpr int kKBox = 8;   // K rows per TMA box (k_rows is a multiple)
constexpr int kVBox = 16;  // V rows per TMA box (v_rows is a multiple)
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use on an H100
constexpr int kAlign = 1024;        // a swizzle pattern repeats every 1024 bytes
constexpr int kBarrierBytes = (2 * kMaxStages + 2) * 8;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory geometry of one launch; the same on the host and the card:
// a ring of stages, each the K and V of one item; the CTA's Q tile; the
// resident bias rows (pre-scaled by log2 e); the mbarriers.
struct TmaPlan {
  int k_rows;      // K box rows: N rounded up to 8 (the score wgmma's N covers them)
  int v_rows;      // V box rows: N rounded up to 16; the tile holds keys_pad rows
  int keys_pad;    // N rounded up to 32: the score wgmma's N and the P V wgmmas' K
  int k_bytes;     // K tile, rounded up to the swizzle period; V follows it
  int stage_bytes;
  int q_bytes;     // the CTA's Q tile (kCtaRows rows)
  int bias_pitch;  // floats per bias row, = 8 (mod 32): conflict-free float2 reads
  int bias_bytes;
  int stages;
  int smem;        // dynamic shared memory requested, with the alignment slack
};

__host__ __device__ inline TmaPlan tma_plan(int D, int N) {
  TmaPlan p;
  p.k_rows = round_up(N, 8);
  p.v_rows = round_up(N, 16);
  p.keys_pad = round_up(N, 32);
  p.q_bytes = round_up(kCtaRows * D * 2, kAlign);
  p.k_bytes = round_up(p.k_rows * D * 2, kAlign);
  p.stage_bytes = p.k_bytes + round_up(p.keys_pad * D * 2, kAlign);
  p.bias_pitch = p.k_rows + ((8 - p.k_rows % 32) + 32) % 32;
  p.bias_bytes = round_up(kCtaRows * p.bias_pitch * 4, kAlign);
  const int room = kSmemLimit - kAlign - kBarrierBytes - p.bias_bytes - p.q_bytes;
  p.stages = room / p.stage_bytes < kMaxStages ? room / p.stage_bytes : kMaxStages;
  p.smem = kAlign + p.stages * p.stage_bytes + p.q_bytes + p.bias_bytes +
           kBarrierBytes;
  return p;
}

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

// arrive on the barrier at the same offset in CTA `cta` of the cluster
// (the default .release.cta: what the arrive orders is this thread's
// shared-memory reads, not its global stores)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n\t}" ::"r"(bar), "r"(cta)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the same box into the same offset of every CTA in `mask`, each CTA's
// barrier at `bar` counting the bytes
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, uint16_t mask, int c0, int c1,
                                                   int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Shared-memory matrix descriptor of a tile of 2D-byte rows in the TMA's
// swizzle for that width (layout 1 / 2 / 3 = 128B / 64B / 32B): 8-row
// groups 8*2D bytes apart (SBO). The tile is one swizzle atom wide, so the
// leading offset is unused (1). K-major operands step 16 elements along a
// row by adding 32 bytes (2 in the address field); the MN-major V steps 16
// keys by adding 16 rows.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = D == 64 ? 1 : D == 32 ? 2 : 3;
  constexpr uint64_t sbo = 8 * D * 2;
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | ((sbo >> 4) << 32) | (layout << 62);
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulate, d[N/2] per thread in
// the accumulator layout of the PTX ISA. wgmma_ss: A and B from shared
// memory by descriptor, both K-major. wgmma_rs: A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B by descriptor,
// transposed (MN-major). `accumulate` = 0 overwrites d.
template <int N>
__device__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate);
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %50, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47}, %48, %49, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<160>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %82, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79}, %80, %81, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %98, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95}, %96, %97, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<224>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %114, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111}, %112, %113, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, %128, %129, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %13, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %21, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// In each quad of lanes (tq = lane % 4), lane tq holds w_i = its 2 columns
// of 8-column tile i, i = 0..3. Returns the 8 columns of tile tq: word k
// from lane k. Round r takes from lane tq + r the word it holds for lane tq.
__device__ __forceinline__ uint4 quad_transpose(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                                int tq, int lane) {
  uint32_t out[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int give = (tq - r) & 3;  // the lane this one's word goes to
    const uint32_t send = give == 0 ? w0 : give == 1 ? w1 : give == 2 ? w2 : w3;
    const uint32_t got = r == 0 ? send : __shfl_sync(0xffffffffu, send, (lane & ~3) | ((tq + r) & 3));
    const int k = (tq + r) & 3;  // the lane it came from
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k == i) out[i] = got;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// The items of cluster c of `clusters`: [lo, hi) of the heads*B (head-major,
// batch-minor) sequence, runs that differ in length by at most one.
__device__ __forceinline__ void cluster_items(int c, int clusters, int items, int& lo, int& hi) {
  lo = int(int64_t(c) * items / clusters);
  hi = int(int64_t(c + 1) * items / clusters);
}

// NT = number of 8-key column tiles: keys padded to a multiple of 32, the
// N of the score wgmma and the rows of the K/V boxes.
template <int D, int NT>
__global__ void __launch_bounds__(kTmaThreads, 1)
attention_bf16_tma(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ o, int N, int B, int heads, int64_t sb,
                   int64_t sh, int sn, float scale, int clusters) {
  constexpr int kRowBytes = D * 2;
  const TmaPlan plan = tma_plan(D, N);
  const int T = int(gridDim.x) / clusters;  // CTAs per cluster = row tiles
  const int rank = int(cluster_rank());
  const int cluster = int(blockIdx.x) / T;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~uintptr_t(kAlign - 1));
  // [stages: K | V] [the CTA's Q tile] [bias rows] [barriers]
  const uint32_t stage0 = smem_u32(smem);
  const uint32_t q0 = stage0 + plan.stages * plan.stage_bytes;
  float* bias_s = reinterpret_cast<float*>(smem + plan.stages * plan.stage_bytes +
                                           plan.q_bytes);
  const uint32_t full0 = smem_u32(bias_s) + plan.bias_bytes;  // K and V of a stage landed
  const uint32_t empty0 = full0 + kMaxStages * 8;              // a stage released by the cluster
  const uint32_t qfull0 = empty0 + kMaxStages * 8;             // the CTA's Q landed
  const uint32_t qempty0 = qfull0 + 8;                         // the CTA's Q consumed

  if (threadIdx.x == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);       // the producer's expect_tx
      mbar_init(empty0 + 8 * s, kConsumerThreads / 32 * T);  // every consumer warp of the cluster
    }
    mbar_init(qfull0, 1);
    mbar_init(qempty0, kConsumerThreads / 32);  // the CTA's consumer warps
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync_all();  // every CTA's barriers exist before any multicast or remote arrive

  int lo, hi;
  cluster_items(cluster, clusters, heads * B, lo, hi);
  const int n_items = hi - lo;
  const int row0 = rank * kCtaRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= kConsumerThreads / 32) {
    // ---- producer warpgroup: one thread keeps the K/V ring full, another
    // the CTA's Q tile, so neither waits behind the other ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int pw = warp - kConsumerThreads / 32;
    if (pw == 0 && lane == 0) {
      const uint32_t kv_tx = uint32_t((plan.k_rows + plan.v_rows) * kRowBytes);
      const uint16_t everyone = uint16_t((1u << T) - 1);
      for (int j = 0; j < n_items; ++j) {
        const int s = j % plan.stages, use = j / plan.stages;
        const int h = (lo + j) / B, b = (lo + j) % B;
        const uint32_t st = stage0 + s * plan.stage_bytes;
        mbar_wait(empty0 + 8 * s, (use & 1) ^ 1);  // released by all CTAs of the cluster
        mbar_expect_tx(full0 + 8 * s, kv_tx);
        // K and V in boxes of kKBox / kVBox rows, spread over the CTAs of
        // the cluster, each multicast to all of them
        for (int r = kKBox * rank; r < plan.k_rows; r += kKBox * T) {
          if (T > 1)
            tma_load_multicast(st + r * kRowBytes, &map_k, full0 + 8 * s, everyone, 0, r, h, b);
          else
            tma_load(st + r * kRowBytes, &map_k, full0 + 8 * s, 0, r, h, b);
        }
        for (int r = kVBox * rank; r < plan.v_rows; r += kVBox * T) {
          const uint32_t dst = st + plan.k_bytes + r * kRowBytes;
          if (T > 1)
            tma_load_multicast(dst, &map_v, full0 + 8 * s, everyone, 0, r, h, b);
          else
            tma_load(dst, &map_v, full0 + 8 * s, 0, r, h, b);
        }
      }
      // tail: every stage released by every CTA, so no peer arrives on this
      // CTA's barriers after it exits
      for (int j = n_items; j < n_items + plan.stages; ++j)
        mbar_wait(empty0 + 8 * (j % plan.stages), ((j / plan.stages) & 1) ^ 1);
    } else if (pw == 1 && lane == 0) {
      for (int j = 0; j < n_items; ++j) {
        const int h = (lo + j) / B, b = (lo + j) % B;
        mbar_wait(qempty0, (j & 1) ^ 1);  // the last item's scores are done
        mbar_expect_tx(qfull0, uint32_t(kCtaRows * kRowBytes));
        tma_load(q0, &map_q, qfull0, 0, row0, h, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes rows 64wg..64wg+63 of every item ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, wq = warp & 3;  // wq: this warp's 16 rows of its warpgroup's 64
    const int g = lane >> 2, tq = lane & 3;
    const int rl_lo = wg * kTileRows + wq * 16 + g, rl_hi = rl_lo + 8;  // this lane's two CTA rows
    const float* bl = bias_s + rl_lo * plan.bias_pitch;
    const float* bh = bias_s + rl_hi * plan.bias_pitch;
    const uint32_t qt = q0 + wg * kTileRows * kRowBytes;
    const int live_t = (N + 7) >> 3;  // 8-key tiles with a key < N
    constexpr float kLog2e = 1.4426950408889634f;
    const float sl = scale * kLog2e;  // softmax in base 2: the bias is pre-scaled too

    // V rows past the box never load: zero them once, so that the P V
    // wgmmas over all keys_pad keys multiply P's zeros by zeros
    const int tail = (plan.keys_pad - plan.v_rows) * kRowBytes / 16;
    for (int idx = threadIdx.x; idx < plan.stages * tail; idx += kConsumerThreads) {
      const int st = idx / tail, i = idx % tail;
      const uint32_t at = stage0 + st * plan.stage_bytes + plan.k_bytes + plan.v_rows * kRowBytes + 16 * i;
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};" ::"r"(at), "r"(0) : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // seen by the wgmmas

    for (int seg = 0; seg < n_items;) {
      // one head at a time: its bias rows stay resident for all its items
      const int h = (lo + seg) / B;
      const int seg_end = min(n_items, (h + 1) * B - lo);
      asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");  // the last head is done
      const int rows = min(kCtaRows, N - row0);
      const float* src = bias + (size_t(h) * N + row0) * N;
      const int c = threadIdx.x;  // one column per thread: k_rows <= 256 = kConsumerThreads
      if (c < plan.k_rows) {
#pragma unroll 8
        for (int r = 0; r < rows; ++r)
          bias_s[r * plan.bias_pitch + c] = c < N ? src[size_t(r) * N + c] * kLog2e : -INFINITY;
      }
      asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");

      for (int j = seg; j < seg_end; ++j) {
        const int s = j % plan.stages, use = j / plan.stages;
        const int b = (lo + j) % B;
        const uint32_t kt = stage0 + s * plan.stage_bytes, vt = kt + plan.k_bytes;

        // S = Q K^T over 8*NT keys (rows past the K box are never used):
        // D/16 wgmmas, both operands from the tiles
        float sc[NT * 4];
        mbar_wait(qfull0, j & 1);
        mbar_wait(full0 + 8 * s, use & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<8 * NT>(sc, smem_desc<D>(qt) + 2 * kk, smem_desc<D>(kt) + 2 * kk, kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        __syncwarp();
        if (lane == 0) mbar_arrive(qempty0);  // Q may refill

        // softmax over keys in base 2, f32, per row; lane holds sc[4t..4t+3]
        // = S[rl_lo][8t+2tq..+1], S[rl_hi][8t+2tq..+1], so a row's values
        // are spread over the 4 lanes of a quad: two xor-shuffles reduce it.
        // Keys in [N, k_rows) meet a bias of -inf (their K rows are zeros);
        // tiles past live_t are never read. Four partial maxima and sums
        // per row keep the dependent chains short.
        float mlo[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
        float mhi[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          if (t < live_t) {
            const int c = t * 8 + 2 * tq;
            const float2 blo = *reinterpret_cast<const float2*>(bl + c);
            const float2 bhi = *reinterpret_cast<const float2*>(bh + c);
            sc[4 * t] = fmaf(sc[4 * t], sl, blo.x);
            sc[4 * t + 1] = fmaf(sc[4 * t + 1], sl, blo.y);
            sc[4 * t + 2] = fmaf(sc[4 * t + 2], sl, bhi.x);
            sc[4 * t + 3] = fmaf(sc[4 * t + 3], sl, bhi.y);
            mlo[t & 3] = fmaxf(mlo[t & 3], fmaxf(sc[4 * t], sc[4 * t + 1]));
            mhi[t & 3] = fmaxf(mhi[t & 3], fmaxf(sc[4 * t + 2], sc[4 * t + 3]));
          }
        }
        float mx_lo = fmaxf(fmaxf(mlo[0], mlo[1]), fmaxf(mlo[2], mlo[3]));
        float mx_hi = fmaxf(fmaxf(mhi[0], mhi[1]), fmaxf(mhi[2], mhi[3]));
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
          mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
        }
        float slo[4] = {0.f, 0.f, 0.f, 0.f}, shi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          if (t < live_t) {  // masked keys: ex2(-inf) = 0
            sc[4 * t] = ex2(sc[4 * t] - mx_lo);
            sc[4 * t + 1] = ex2(sc[4 * t + 1] - mx_lo);
            sc[4 * t + 2] = ex2(sc[4 * t + 2] - mx_hi);
            sc[4 * t + 3] = ex2(sc[4 * t + 3] - mx_hi);
            slo[t & 3] += sc[4 * t] + sc[4 * t + 1];
            shi[t & 3] += sc[4 * t + 2] + sc[4 * t + 3];
          } else {  // keys past the last live tile weigh nothing
            sc[4 * t] = sc[4 * t + 1] = sc[4 * t + 2] = sc[4 * t + 3] = 0.f;
          }
        }
        float sum_lo = (slo[0] + slo[1]) + (slo[2] + slo[3]);
        float sum_hi = (shi[0] + shi[1]) + (shi[2] + shi[3]);
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
          sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
        }
        const float inv_lo = 1.f / sum_lo, inv_hi = 1.f / sum_hi;

        // O = P V: P rounded to bf16 is the register A operand (the
        // accumulator layout of two adjacent 8-key tiles is the A layout of
        // one 16-key step); V, MN-major, by descriptor, 16 keys per wgmma
        uint32_t pa[NT / 2][4];
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          const float* s0 = sc + 8 * kk;
          pa[kk][0] = pack_bf16(s0[0] * inv_lo, s0[1] * inv_lo);
          pa[kk][1] = pack_bf16(s0[2] * inv_hi, s0[3] * inv_hi);
          pa[kk][2] = pack_bf16(s0[4] * inv_lo, s0[5] * inv_lo);
          pa[kk][3] = pack_bf16(s0[6] * inv_hi, s0[7] * inv_hi);
        }
        float acc[D / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk)
          wgmma_rs<D>(acc, pa[kk], smem_desc<D>(vt + kk * 16 * kRowBytes), kk > 0);
        wgmma_commit();
        wgmma_wait_all();

        // the stage is consumed (both wgmmas have completed): release it
        // before the stores, so the release waits for none of them
        __syncwarp();
        if (lane == 0)
          for (int cta = 0; cta < T; ++cta) mbar_arrive_cluster(empty0 + 8 * s, uint32_t(cta));

        // O straight from the accumulator with 16-byte stores: in each quad
        // the 4 lanes hold 2 columns each of 8-column tiles; a transpose
        // over 4 tiles gives lane tq the 8 columns of tile 4m + tq
        const int64_t base = int64_t(b) * sb + int64_t(h) * sh;
        const int r_lo = row0 + rl_lo, r_hi = row0 + rl_hi;
        __nv_bfloat16* o_lo = o + base + int64_t(r_lo) * sn;
        __nv_bfloat16* o_hi = o + base + int64_t(r_hi) * sn;
        if constexpr (D >= 32) {
#pragma unroll
          for (int m = 0; m < D / 32; ++m) {
            const float* a4 = acc + 16 * m;  // tiles 4m..4m+3
            const uint4 lo = quad_transpose(pack_bf16(a4[0], a4[1]), pack_bf16(a4[4], a4[5]),
                                            pack_bf16(a4[8], a4[9]), pack_bf16(a4[12], a4[13]), tq, lane);
            const uint4 hi = quad_transpose(pack_bf16(a4[2], a4[3]), pack_bf16(a4[6], a4[7]),
                                            pack_bf16(a4[10], a4[11]), pack_bf16(a4[14], a4[15]), tq, lane);
            const int col = 8 * (4 * m + tq);
            if (r_lo < N) *reinterpret_cast<uint4*>(o_lo + col) = lo;
            if (r_hi < N) *reinterpret_cast<uint4*>(o_hi + col) = hi;
          }
        } else {  // d = 16: 4-byte stores
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            if (r_lo < N) *reinterpret_cast<uint32_t*>(o_lo + 8 * n + 2 * tq) = pack_bf16(acc[4 * n], acc[4 * n + 1]);
            if (r_hi < N) *reinterpret_cast<uint32_t*>(o_hi + 8 * n + 2 * tq) = pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
          }
        }
      }
      seg = seg_end;
    }
  }
}

// Where the rows live: B batch rows of `heads` heads of N rows each, row r
// of head h of batch row b at element b*sb + h*sh + r*sn.
struct Layout {
  int B, heads, N;
  int64_t sb, sh;
  int sn;
};

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

// 4-D map (d, N, heads, B) of bf16 over the layout's strides, box
// (d, rows, 1, 1), the swizzle of a 2d-byte row; reads past N fill zeros
cudaError_t encode_map(CUtensorMap* map, const void* ptr, const Layout& L, int d, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(L.N), cuuint64_t(L.heads), cuuint64_t(L.B)};
  const cuuint64_t strides[3] = {cuuint64_t(L.sn) * 2, cuuint64_t(L.sh) * 2, cuuint64_t(L.sb) * 2};
  const cuuint32_t box[4] = {cuuint32_t(d), cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// launch configuration of the bf16 kernel: ceil(N/128) CTAs per cluster
template <int D, int NT>
cudaError_t bf16_config(int N, int clusters, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                        cudaLaunchAttribute* attr) {
  const TmaPlan plan = tma_plan(D, N);
  if (plan.stages < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_tma<D, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  const int T = (N + kCtaRows - 1) / kCtaRows;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(T * clusters);
  cfg.blockDim = dim3(kTmaThreads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = T;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of the bf16 kernel fit on the current device at once
// (cudaOccupancyMaxActiveClusters). Asked once per device and N, since a
// CTA's shared memory depends on N: an instance serves 32 token counts.
template <int D, int NT>
cudaError_t resident_clusters(int N, int& n) {
  constexpr int kDevices = 16;
  static int fit[kDevices][32];  // 0 until asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* slot = dev < kDevices ? &fit[dev][(N - 1) % 32] : nullptr;
  if (slot != nullptr && *slot > 0) {
    n = *slot;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = bf16_config<D, NT>(N, 1, nullptr, cfg, attr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, attention_bf16_tma<D, NT>, &cfg);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  if (slot != nullptr) *slot = n;
  return cudaSuccess;
}

// Runs the persistent grid: as many clusters as fit at once, but no more
// than there are (head, batch row) items.
template <int D, int NT>
cudaError_t launch_bf16_t(const void* q, const void* k, const void* v, const void* bias, void* o,
                          const Layout& L, float scale, cudaStream_t stream) {
  int clusters = 0;
  cudaError_t err = resident_clusters<D, NT>(L.N, clusters);
  if (err != cudaSuccess) return err;
  if (clusters > L.B * L.heads) clusters = L.B * L.heads;
  CUtensorMap mq, mk, mv;
  err = encode_map(&mq, q, L, D, kCtaRows);
  if (err == cudaSuccess) err = encode_map(&mk, k, L, D, kKBox);
  if (err == cudaSuccess) err = encode_map(&mv, v, L, D, kVBox);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = bf16_config<D, NT>(L.N, clusters, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, attention_bf16_tma<D, NT>, mq, mk, mv,
                           static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(o), L.N,
                           L.B, L.heads, L.sb, L.sh, L.sn, scale, clusters);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* o,
                        const Layout& L, float scale, cudaStream_t s) {
  switch ((L.N + 31) / 32) {  // keys padded to a multiple of 32: NT = 4 * ceil(N / 32)
    case 1: return launch_bf16_t<D, 4>(q, k, v, bias, o, L, scale, s);
    case 2: return launch_bf16_t<D, 8>(q, k, v, bias, o, L, scale, s);
    case 3: return launch_bf16_t<D, 12>(q, k, v, bias, o, L, scale, s);
    case 4: return launch_bf16_t<D, 16>(q, k, v, bias, o, L, scale, s);
    case 5: return launch_bf16_t<D, 20>(q, k, v, bias, o, L, scale, s);
    case 6: return launch_bf16_t<D, 24>(q, k, v, bias, o, L, scale, s);
    case 7: return launch_bf16_t<D, 28>(q, k, v, bias, o, L, scale, s);
    case 8: return launch_bf16_t<D, 32>(q, k, v, bias, o, L, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// CUDA cores: every f32 shape, and the bf16 shapes the TMA kernel does not take
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 128;  // 4 warps
constexpr int kSimtRows = 64;      // query rows per tile: thread rows rg + 16i, i < 4
constexpr int kSimtKeys = 32;      // keys per block: thread keys kg + 8i, i < 4
constexpr int kPPitch = kSimtRows + 4;  // floats per key row of P^T: conflict-free float4 stores

// Shared memory of one CTA: the Q tile, two stages of a K and a V block, P^T.
// Rows keep the input type and are padded by 16 bytes, so the 8 different
// rows read by one 16-byte (f32) or 8-byte (bf16) load fall in 8 different
// bank groups.
template <typename T, int D>
struct SimtPlan {
  static constexpr int kPitch = D + 16 / int(sizeof(T));  // elements per staged row
  static constexpr int kRowBytes = kPitch * int(sizeof(T));
  static constexpr int kQBytes = kSimtRows * kRowBytes;
  static constexpr int kBlockBytes = kSimtKeys * kRowBytes;  // one K or V block
  static constexpr int kPBytes = kSimtKeys * kPPitch * 4;
  static constexpr int kSmem = kQBytes + 4 * kBlockBytes + kPBytes;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  // src_bytes = 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// 4 (or 2) consecutive elements of a staged row, as f32
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// p rounded to the input type (the identity for f32)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store_out(float* o, const float* x, int n) {
  if (n == 4)
    *reinterpret_cast<float4*>(o) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(o) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void store_out(__nv_bfloat16* o, const float* x, int n) {
  if (n == 4)
    *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  else
    *reinterpret_cast<uint32_t*>(o) = pack_bf16(x[0], x[1]);
}

// Rows [r0, r0 + rows) of one (batch row, head) item into shared memory at
// `dst` (row pitch kRowBytes), in 16-byte cp.async copies; rows past N are
// zero-filled, so their scores are finite and their V rows weigh 0 * 0.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(uint32_t dst, const T* __restrict__ src, int64_t base,
                                           int r0, int rows, int N, int sn) {
  constexpr int kChunks = D * int(sizeof(T)) / 16;
  constexpr int kPer = 16 / int(sizeof(T));
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kSimtThreads) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool live = r0 + r < N;
    const T* g = src + base + int64_t(live ? r0 + r : 0) * sn + c * kPer;
    cp_async16(dst + r * SimtPlan<T, D>::kRowBytes + c * 16, g, live ? 16 : 0);
  }
}

// One CTA walks tiles (item, 64-row tile), item = head * B + batch row, over
// a persistent flat grid. Per tile: Q once, then key blocks of 32 with the
// next block's K and V in flight (cp.async, two stages) while the current
// one is computed. Each thread owns a 4 x 4 tile of S (rows rg + 16i, keys
// kg + 8i') and a 4 x D/8 tile of O; the 8 threads of a row group are 8
// lanes of one warp, so row maxima and sums are shuffles and P passes
// through a per-warp slice of shared memory with a __syncwarp.
template <typename T, int D>
__global__ void __launch_bounds__(kSimtThreads)
attention_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ bias, T* __restrict__ o, int N, int B, int64_t sb,
               int64_t sh, int sn, float scale, int tiles) {
  using Plan = SimtPlan<T, D>;
  constexpr int kPitch = Plan::kPitch;
  constexpr int kVW = D % 32 == 0 ? 4 : 2;  // V and O columns per load
  constexpr int kCols = D / 8;              // O columns per thread
  constexpr int kChunks = kCols / kVW;      // column chunks m: columns 8*kVW*m + kVW*kg + [0, kVW)

  extern __shared__ __align__(16) unsigned char smem_s[];
  const T* Qs = reinterpret_cast<const T*>(smem_s);
  float* Pt = reinterpret_cast<float*>(smem_s + Plan::kQBytes + 4 * Plan::kBlockBytes);
  const uint32_t q_dst = smem_u32(smem_s);
  const uint32_t kv_dst = q_dst + Plan::kQBytes;  // stage s: K at + 2s blocks, V one block later

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp * 4 + (lane >> 3);  // row group: this warp holds row groups 4warp..4warp+3
  const int kg = lane & 7;                // key group within a row group
  const int row_tiles = (N + kSimtRows - 1) / kSimtRows;
  const int blocks = (N + kSimtKeys - 1) / kSimtKeys;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int item = tile / row_tiles;
    const int row0 = (tile - item * row_tiles) * kSimtRows;
    const int h = item / B, b = item - h * B;
    const int64_t base = int64_t(b) * sb + int64_t(h) * sh;

    stage_rows<T, D>(q_dst, q, base, row0, kSimtRows, N, sn);
    stage_rows<T, D>(kv_dst, k, base, 0, kSimtKeys, N, sn);
    stage_rows<T, D>(kv_dst + Plan::kBlockBytes, v, base, 0, kSimtKeys, N, sn);
    cp_async_commit();

    float acc[4][kCols];
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
    }

    for (int kb = 0; kb < blocks; ++kb) {
      const int stage = kb & 1;
      if (kb + 1 < blocks) {
        const uint32_t nxt = kv_dst + (stage ^ 1) * 2 * Plan::kBlockBytes;
        stage_rows<T, D>(nxt, k, base, (kb + 1) * kSimtKeys, kSimtKeys, N, sn);
        stage_rows<T, D>(nxt + Plan::kBlockBytes, v, base, (kb + 1) * kSimtKeys, kSimtKeys, N, sn);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // block kb (and Q) landed for every thread
      const T* Ks = reinterpret_cast<const T*>(smem_s + Plan::kQBytes + stage * 2 * Plan::kBlockBytes);
      const T* Vs = Ks + kSimtKeys * kPitch;
      const int j0 = kb * kSimtKeys;

      // the bias of this thread's 16 scores, read from L2 while S is computed;
      // keys past N get -inf (weight 0), rows past N a bias of 0 (never stored)
      float s[4][4], bs[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + rg + 16 * i;
        const float* brow = bias + (size_t(h) * N + (r < N ? r : 0)) * N;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = j0 + kg + 8 * t;
          bs[i][t] = j < N ? (r < N ? __ldg(brow + j) : 0.f) : -INFINITY;
          s[i][t] = 0.f;
        }
      }

      // S = Q K^T: per 4 channels, 4 q and 4 k loads for 64 FMAs
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        float4 qa[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = load4(Qs + (rg + 16 * i) * kPitch + c);
#pragma unroll
        for (int t = 0; t < 4; ++t) ka[t] = load4(Ks + (kg + 8 * t) * kPitch + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            s[i][t] = fmaf(qa[i].x, ka[t].x, s[i][t]);
            s[i][t] = fmaf(qa[i].y, ka[t].y, s[i][t]);
            s[i][t] = fmaf(qa[i].z, ka[t].z, s[i][t]);
            s[i][t] = fmaf(qa[i].w, ka[t].w, s[i][t]);
          }
      }

      // online softmax in f32: running maximum per row over the 8 lanes of
      // its row group, O and this lane's partial sum rescaled once per block
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float bm = -INFINITY;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          s[i][t] = fmaf(s[i][t], scale, bs[i][t]);
          bm = fmaxf(bm, s[i][t]);
        }
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 4));
        const float mn = fmaxf(m[i], bm);  // finite: every block has a key < N
        const float alpha = expf(m[i] - mn);  // 0 on the first block
        m[i] = mn;
        l[i] *= alpha;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float p = expf(s[i][t] - mn);  // keys past N: exp(-inf) = 0
          l[i] += p;
          s[i][t] = round_to(p, q);
        }
      }

      // P^T[key][4 rg + i] = p of row rg + 16i: this warp's rows only
      __syncwarp();  // this warp's reads of the last block's P are done
#pragma unroll
      for (int t = 0; t < 4; ++t)
        *reinterpret_cast<float4*>(Pt + (kg + 8 * t) * kPPitch + 4 * rg) =
            make_float4(s[0][t], s[1][t], s[2][t], s[3][t]);
      __syncwarp();

      // O += P V: per key, the 4 rows' p in one load, kCols columns of V
#pragma unroll 8
      for (int j = 0; j < kSimtKeys; ++j) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pt + j * kPPitch + 4 * rg);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const T* vp = Vs + j * kPitch + 8 * kVW * ch + kVW * kg;
          float vv[4];
          if constexpr (kVW == 4) {
            const float4 x = load4(vp);
            vv[0] = x.x, vv[1] = x.y, vv[2] = x.z, vv[3] = x.w;
          } else {
            const float2 x = load2(vp);
            vv[0] = x.x, vv[1] = x.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < kVW; ++e) acc[i][kVW * ch + e] = fmaf(pr[i], vv[e], acc[i][kVW * ch + e]);
        }
      }
      __syncthreads();  // every warp is done with this stage before it refills
    }

    // the row sums over the 8 lanes of each row group; O / sum in the input type
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
      const int r = row0 + rg + 16 * i;
      if (r < N) {
        T* orow = o + base + int64_t(r) * sn;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          float x[4];
#pragma unroll
          for (int e = 0; e < kVW; ++e) x[e] = acc[i][kVW * ch + e] / l[i];
          store_out(orow + 8 * kVW * ch + kVW * kg, x, kVW);
        }
      }
    }
  }
}

// Runs the persistent grid: as many CTAs as fit on the card at once
// (asked once per device), but no more than there are tiles.
template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* bias, void* o,
                        const Layout& L, float scale, cudaStream_t stream) {
  constexpr int kDevices = 16;
  static int resident[kDevices];  // 0 until asked
  auto kernel = attention_simt<T, D>;
  constexpr int smem = SimtPlan<T, D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int fit = dev < kDevices ? resident[dev] : 0;
  if (fit == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSimtThreads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    fit = per_sm * sms;
    if (dev < kDevices) resident[dev] = fit;
  }
  const int tiles = L.heads * L.B * ((L.N + kSimtRows - 1) / kSimtRows);
  kernel<<<tiles < fit ? tiles : fit, kSimtThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(o), L.N, L.B, L.sb, L.sh, L.sn, scale, tiles);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_simt_d(int is_bf16, const void* q, const void* k, const void* v,
                          const void* bias, void* o, const Layout& L, float scale, cudaStream_t s) {
  return is_bf16 ? launch_simt<__nv_bfloat16, D>(q, k, v, bias, o, L, scale, s)
                 : launch_simt<float, D>(q, k, v, bias, o, L, scale, s);
}

enum Route { kNoKernel = 0, kTmaRoute = 1, kSimtRoute = 2 };

// Which kernel takes a shape: bf16 with N <= 256 and d in {16, 32, 64} the
// TMA kernel; every other shape with d a multiple of 16 up to 128 the
// CUDA-core kernel; nothing else.
Route route(int is_bf16, int N, int d) {
  if (N <= 0 || d <= 0 || d % 16 != 0 || d > 128) return kNoKernel;
  if (is_bf16 && N <= kMaxKeys && (d == 16 || d == 32 || d == 64)) return kTmaRoute;
  return kSimtRoute;
}

int run(int is_bf16, int d, const void* q, const void* k, const void* v, const void* bias,
        void* o, const Layout& L, void* stream) {
  if (L.B <= 0 || L.heads <= 0 || L.N <= 0) return int(cudaErrorInvalidValue);
  // tile and item indices are ints
  if (int64_t(L.B) * L.heads * ((L.N + kSimtRows - 1) / kSimtRows) > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(float(d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route(is_bf16, L.N, d)) {
    case kTmaRoute:
      switch (d) {
        case 16: return int(launch_bf16<16>(q, k, v, bias, o, L, scale, s));
        case 32: return int(launch_bf16<32>(q, k, v, bias, o, L, scale, s));
        default: return int(launch_bf16<64>(q, k, v, bias, o, L, scale, s));
      }
    case kSimtRoute:
      switch (d) {
        case 16: return int(launch_simt_d<16>(is_bf16, q, k, v, bias, o, L, scale, s));
        case 32: return int(launch_simt_d<32>(is_bf16, q, k, v, bias, o, L, scale, s));
        case 48: return int(launch_simt_d<48>(is_bf16, q, k, v, bias, o, L, scale, s));
        case 64: return int(launch_simt_d<64>(is_bf16, q, k, v, bias, o, L, scale, s));
        case 80: return int(launch_simt_d<80>(is_bf16, q, k, v, bias, o, L, scale, s));
        case 96: return int(launch_simt_d<96>(is_bf16, q, k, v, bias, o, L, scale, s));
        case 112: return int(launch_simt_d<112>(is_bf16, q, k, v, bias, o, L, scale, s));
        default: return int(launch_simt_d<128>(is_bf16, q, k, v, bias, o, L, scale, s));
      }
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both entries: bias is (num_heads, N, N) f32 contiguous; q, k, v, o are
// contiguous and 16-byte aligned, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// N >= 1; d a multiple of 16 up to 128 (beit_attention_route says which
// kernel runs the shape). They launch on `stream` (on the current device)
// and return cudaGetLastError() (cudaErrorInvalidValue for a shape they do
// not take).

// The kernel that runs a shape: 1 attention_bf16_tma, 2 attention_simt,
// 0 none (the launch would return cudaErrorInvalidValue).
extern "C" int beit_attention_route(int is_bf16, int N, int d) { return int(route(is_bf16, N, d)); }

// B1: q, k, v, o are (B, N, H) with H = num_heads * d.
extern "C" int beit_attention_packed_launch(const void* q, const void* k, const void* v,
                                            const void* bias, void* o, int B, int N, int H,
                                            int num_heads, int is_bf16, void* stream) {
  if (num_heads <= 0 || H % num_heads != 0) return int(cudaErrorInvalidValue);
  const int d = H / num_heads;
  const Layout L{B, num_heads, N, int64_t(N) * H, d, H};
  return run(is_bf16, d, q, k, v, bias, o, L, stream);
}

// B3: q, k, v, o are (num_heads, B, N, d), head-major.
extern "C" int beit_attention_headmajor_launch(const void* q, const void* k, const void* v,
                                               const void* bias, void* o, int num_heads, int B,
                                               int N, int d, int is_bf16, void* stream) {
  const Layout L{B, num_heads, N, int64_t(N) * d, int64_t(B) * N * d, d};
  return run(is_bf16, d, q, k, v, bias, o, L, stream);
}
