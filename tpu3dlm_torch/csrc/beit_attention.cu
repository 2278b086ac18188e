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
// 3.35 TB/s, while its 45.8 GFLOP take 46 us at the bf16 tensor-core rate:
// memory-bound.
//
// Two kernels, both one block per (query-row tile, head, batch row) with
// the head's K and V staged once per block in dynamic shared memory. The
// blocks of one batch row run next to each other, so in the head-major
// layout too each head's (N, N) bias stays in L2 across the sweep:
//
// * bf16 (the serving path): four warps, 16 query rows each, on the tensor
//   cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). A warp keeps
//   its whole 16 x N f32 score tile in registers (fragment layout of the
//   PTX ISA), adds scale and bias, does the softmax in f32 with quad
//   shuffles, rounds the probabilities to bf16 and feeds them back as the
//   A operand of O = P V without leaving registers (the accumulator layout
//   of two adjacent 8-key tiles is the A layout of one 16-key step). K and
//   V rows are padded by 8 bf16 so each fragment load hits 32 banks. The
//   inputs are read about once from device memory (the row tiles of one
//   head re-read K/V and the bias rows mostly from L2).
// * f32 (the parity path): CUDA cores, exact f32. One warp per query row;
//   each lane owns keys lane, lane+32, ...; K is stored with an odd row
//   stride so the 32 lanes hit 32 banks; p.V accumulates with each lane
//   owning output channels. Bound by the shared-memory load behind every
//   FMA, far from the memory bound; it serves correctness, not speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxKeys = 256;  // N <= 256

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fragments kept in registers)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;  // query rows per block
constexpr int kVec = 8;                 // bf16 per 16-byte load
constexpr int kPad = 8;                 // bf16 of padding per staged K/V row

// D += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate. Fragment
// layout (PTX ISA, mma.m16n8k16): with g = lane / 4 and q = lane % 4,
// a[0] = A[g][2q..2q+1], a[1] = A[g+8][2q..], a[2] = A[g][2q+8..],
// a[3] = A[g+8][2q+8..]; b[0] = B[2q..2q+1][g], b[1] = B[2q+8..][g];
// c[0..1] = C[g][2q..2q+1], c[2..3] = C[g+8][2q..2q+1].
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// NT = number of 8-key column tiles (keys padded to NT * 8, a multiple of 32)
template <int D, int NT>
__global__ void __launch_bounds__(kTcWarps * 32, 3)
attention_bf16_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ o, int N, int64_t sb, int64_t sh, int sn,
                  float scale) {
  constexpr int NP = NT * 8;
  constexpr int RS = D + kPad;  // row stride: a fragment's 8 rows fall in distinct banks
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // NP x RS, rows >= N zero
  __nv_bfloat16* Vs = Ks + NP * RS;                             // NP x RS, rows >= N zero

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t base = b * sb + h * sh;
  constexpr int kRowVecs = D / kVec;

#pragma unroll  // every load of the staging in flight at once
  for (int idx = threadIdx.x; idx < NP * kRowVecs; idx += kTcWarps * 32) {
    const int j = idx / kRowVecs, c = (idx % kRowVecs) * kVec;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (j < N) {
      const int64_t gi = base + int64_t(j) * sn + c;
      kv = *reinterpret_cast<const uint4*>(k + gi);
      vv = *reinterpret_cast<const uint4*>(v + gi);
    }
    *reinterpret_cast<uint4*>(Ks + j * RS + c) = kv;
    *reinterpret_cast<uint4*>(Vs + j * RS + c) = vv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * kTcRows + warp * 16;
  if (row0 >= N) return;  // no block-wide barrier follows
  const int r_lo = row0 + g, r_hi = row0 + g + 8;  // the two query rows this lane holds

  // Q fragments straight from device memory (rows >= N read as zero)
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r_hi : r_lo;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(q + base + int64_t(r) * sn + c);
      qa[kk][half] = r < N ? src[0] : 0u;
      qa[kk][2 + half] = r < N ? src[4] : 0u;  // columns c + 8, c + 9
    }
  }

  // S = Q K^T: NT tiles of 16 x 8, f32, in registers
  float s[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    const __nv_bfloat16* krow = Ks + (t * 8 + g) * RS + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[2];
      kb[0] = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
      kb[1] = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
      mma_16816(s[t], qa[kk], kb);
    }
  }

  // softmax over keys, f32, per row; a row's values are spread over the 4
  // lanes of a quad, so the reductions are two xor-shuffles
  const float* b_lo = bias + (size_t(h) * N + min(r_lo, N - 1)) * N;
  const float* b_hi = bias + (size_t(h) * N + min(r_hi, N - 1)) * N;
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = t * 8 + 2 * tq + e;
      s[t][e] = c < N ? s[t][e] * scale + b_lo[c] : -INFINITY;
      s[t][2 + e] = c < N ? s[t][2 + e] * scale + b_hi[c] : -INFINITY;
      mx_lo = fmaxf(mx_lo, s[t][e]);
      mx_hi = fmaxf(mx_hi, s[t][2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[t][e] = expf(s[t][e] - mx_lo);  // padded keys: exp(-inf) = 0
      s[t][2 + e] = expf(s[t][2 + e] - mx_hi);
      sum_lo += s[t][e];
      sum_hi += s[t][2 + e];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
  }

  // O = P V; P's A fragments are the bf16 score tiles 2kk and 2kk+1
  const float inv_lo = 1.f / sum_lo, inv_hi = 1.f / sum_hi;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0] * inv_lo, s[2 * kk][1] * inv_lo);
    pa[1] = pack_bf16(s[2 * kk][2] * inv_hi, s[2 * kk][3] * inv_hi);
    pa[2] = pack_bf16(s[2 * kk + 1][0] * inv_lo, s[2 * kk + 1][1] * inv_lo);
    pa[3] = pack_bf16(s[2 * kk + 1][2] * inv_hi, s[2 * kk + 1][3] * inv_hi);
    const __nv_bfloat16* v0 = Vs + (kk * 16 + 2 * tq) * RS + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* vp = v0 + n * 8;
      uint32_t vb[2];
      vb[0] = pack_bf16(vp[0], vp[RS]);
      vb[1] = pack_bf16(vp[8 * RS], vp[9 * RS]);
      mma_16816(acc[n], pa, vb);
    }
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * tq;
    if (r_lo < N)
      *reinterpret_cast<uint32_t*>(o + base + int64_t(r_lo) * sn + c) = pack_bf16(acc[n][0], acc[n][1]);
    if (r_hi < N)
      *reinterpret_cast<uint32_t*>(o + base + int64_t(r_hi) * sn + c) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

// Where the rows live: B batch rows of `heads` heads of N rows each, row r
// of head h of batch row b at element b*sb + h*sh + r*sn.
struct Layout {
  int B, heads, N;
  int64_t sb, sh;
  int sn;
};

template <int D, int NT>
cudaError_t launch_bf16_t(const void* q, const void* k, const void* v, const void* bias, void* o,
                          const Layout& L, float scale, cudaStream_t stream) {
  const size_t smem = size_t(2) * NT * 8 * (D + kPad) * sizeof(__nv_bfloat16);
  auto kernel = attention_bf16_tc<D, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L.N + kTcRows - 1) / kTcRows, L.heads, L.B);
  kernel<<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(o), L.N, L.sb, L.sh, L.sn, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* o,
                        const Layout& L, float scale, cudaStream_t s) {
  switch ((L.N + 31) / 32) {  // keys padded to a multiple of 32
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
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;

template <int D, int JT>
constexpr size_t f32_smem_floats() {
  return size_t(32 * JT) * (D + 1) + size_t(32 * JT) * D + size_t(kWarps) * 32 * JT +
         size_t(kWarps) * D;
}

template <int D, int JT>
__global__ void __launch_bounds__(kThreads)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ o, int N, int64_t sb, int64_t sh, int sn, float scale) {
  constexpr int NP = 32 * JT;  // key rows padded to whole warps
  constexpr int KS = D + 1;    // odd stride: lane j reading K[j][c] is conflict-free
  extern __shared__ float smem_f[];
  float* Ks = smem_f;           // NP * KS
  float* Vs = Ks + NP * KS;     // NP * D
  float* Ps = Vs + NP * D;      // kWarps * NP
  float* Qs = Ps + kWarps * NP; // kWarps * D

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t base = b * sb + h * sh;

  for (int idx = threadIdx.x; idx < NP * D; idx += kThreads) {
    const int j = idx / D, c = idx % D;
    float kv = 0.f, vv = 0.f;
    if (j < N) {
      const int64_t g = base + int64_t(j) * sn + c;
      kv = k[g];
      vv = v[g];
    }
    Ks[j * KS + c] = kv;
    Vs[j * D + c] = vv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* P = Ps + warp * NP;
  float* Q = Qs + warp * D;
  const int row_end = min(int(blockIdx.x + 1) * kRowsPerBlock, N);
  for (int i = int(blockIdx.x) * kRowsPerBlock + warp; i < row_end; i += kWarps) {
    const int64_t row = base + int64_t(i) * sn;
    for (int c = lane; c < D; c += 32) Q[c] = q[row + c];
    __syncwarp();

    float s[JT];
#pragma unroll
    for (int t = 0; t < JT; ++t) s[t] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qc = Q[c];
#pragma unroll
      for (int t = 0; t < JT; ++t) s[t] = fmaf(qc, Ks[(lane + 32 * t) * KS + c], s[t]);
    }

    const float* brow = bias + (size_t(h) * N + i) * N;
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = lane + 32 * t;
      s[t] = j < N ? s[t] * scale + brow[j] : -INFINITY;
      mx = fmaxf(mx, s[t]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      s[t] = expf(s[t] - mx);  // padded keys: exp(-inf) = 0
      sum += s[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < JT; ++t) P[lane + 32 * t] = s[t] / sum;
    __syncwarp();

    for (int c = lane; c < D; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(P[j], Vs[j * D + c], acc);
      o[row + c] = acc;
    }
    __syncwarp();
  }
}

template <int D, int JT>
cudaError_t launch_f32_t(const void* q, const void* k, const void* v, const void* bias, void* o,
                         const Layout& L, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * f32_smem_floats<D, JT>();
  auto kernel = attention_f32<D, JT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L.N + kRowsPerBlock - 1) / kRowsPerBlock, L.heads, L.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(o), L.N, L.sb, L.sh, L.sn, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                       const Layout& L, float scale, cudaStream_t s) {
  switch ((L.N + 31) / 32) {
    case 1: return launch_f32_t<D, 1>(q, k, v, bias, o, L, scale, s);
    case 2: return launch_f32_t<D, 2>(q, k, v, bias, o, L, scale, s);
    case 3: return launch_f32_t<D, 3>(q, k, v, bias, o, L, scale, s);
    case 4: return launch_f32_t<D, 4>(q, k, v, bias, o, L, scale, s);
    case 5: return launch_f32_t<D, 5>(q, k, v, bias, o, L, scale, s);
    case 6: return launch_f32_t<D, 6>(q, k, v, bias, o, L, scale, s);
    case 7: return launch_f32_t<D, 7>(q, k, v, bias, o, L, scale, s);
    case 8: return launch_f32_t<D, 8>(q, k, v, bias, o, L, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v, const void* bias,
                   void* o, const Layout& L, float scale, cudaStream_t s) {
  return is_bf16 ? launch_bf16<D>(q, k, v, bias, o, L, scale, s)
                 : launch_f32<D>(q, k, v, bias, o, L, scale, s);
}

int run(int is_bf16, int d, const void* q, const void* k, const void* v, const void* bias,
        void* o, const Layout& L, void* stream) {
  if (L.B <= 0 || L.B > 65535 || L.heads <= 0 || L.heads > 65535 || L.N <= 0 || L.N > kMaxKeys)
    return int(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(float(d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return int(launch<16>(is_bf16, q, k, v, bias, o, L, scale, s));
    case 32: return int(launch<32>(is_bf16, q, k, v, bias, o, L, scale, s));
    case 64: return int(launch<64>(is_bf16, q, k, v, bias, o, L, scale, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both entries: bias is (num_heads, N, N) f32 contiguous; q, k, v, o are
// contiguous and 16-byte aligned, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// d in {16, 32, 64}; 1 <= N <= 256. They launch on `stream` and return
// cudaGetLastError() (cudaErrorInvalidValue for a shape they do not take).

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
