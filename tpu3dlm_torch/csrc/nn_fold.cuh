// The last step of the nearest-neighbour kernels B2 (nearest_neighbors.cu)
// and B4 (nn_variants.cu): each splits the target axis across blocks and
// leaves per split, per query, the minimum of |b|^2 - 2 a.b and its lowest
// index; this kernel folds them.
//
// One thread per query folds the per-split minima in split order with a
// strict <, so ties go to the lowest split and so to the lowest index
// overall, then adds |a|^2 and clamps at 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void nn_fold_kernel(const float* __restrict__ a, int n, int splits,
                               const float* __restrict__ part_d,
                               const int* __restrict__ part_i, int64_t* __restrict__ idx,
                               float* __restrict__ d2) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  float best = part_d[q];
  int best_j = part_i[q];
  for (int s = 1; s < splits; ++s) {
    const float d = part_d[(size_t)s * n + q];
    if (d < best) {
      best = d;
      best_j = part_i[(size_t)s * n + q];
    }
  }
  const float x = a[3 * (size_t)q], y = a[3 * (size_t)q + 1], z = a[3 * (size_t)q + 2];
  // (x*x + y*y) + z*z without contraction, the reference's sum order
  const float a2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  idx[q] = best_j;
  d2[q] = fmaxf(best + a2, 0.f);
}

}  // namespace
