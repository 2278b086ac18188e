// Grid-PCA normal estimation: the host normals core of the port's
// alignment and Poisson meshing.
//
// A copy of the JAX package's native normals (tpu3dlm/native/src/normals.cpp),
// kept byte for byte in its code so both packages give every point the same
// normal, sign included: per-voxel covariance PCA, smallest-eigenvalue
// direction, cells with < 3 points fall back to the global dominant-plane
// normal, optional viewpoint orientation. One hash-accumulate pass and one
// assign pass. Built by tpu3dlm_torch/kernels/build.py with the system C++
// compiler and called through ctypes from tpu3dlm_torch/native.py
// (ops/pointcloud.py); the numpy code there is its plain twin.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Acc {
  double n = 0;
  double s[3] = {0, 0, 0};
  double q[6] = {0, 0, 0, 0, 0, 0};  // xx, xy, xz, yy, yz, zz
  float normal[3] = {0, 0, 0};
  bool ok = false;
};

// smallest-eigenvalue unit eigenvector of a symmetric 3x3 (analytic:
// trigonometric eigenvalues, then the best cross product of rows of A-xI)
void smallest_eigvec(const double c[6], float out[3]) {
  const double a = c[0], b = c[3], cz = c[5], d = c[1], e = c[4], f = c[2];
  // c layout: [xx, xy, xz, yy, yz, zz] -> A = [[a,d,f],[d,b,e],[f,e,cz]]
  const double p1 = d * d + f * f + e * e;
  double lmin;
  if (p1 < 1e-24) {  // already diagonal
    lmin = a;
    int k = 0;
    if (b < lmin) { lmin = b; k = 1; }
    if (cz < lmin) { lmin = cz; k = 2; }
    out[0] = k == 0; out[1] = k == 1; out[2] = k == 2;
    return;
  }
  const double tr = a + b + cz;
  const double m = tr / 3.0;
  const double a2 = a - m, b2 = b - m, c2 = cz - m;
  const double p2 = a2 * a2 + b2 * b2 + c2 * c2 + 2.0 * p1;
  const double p = std::sqrt(p2 / 6.0);
  // det((A - mI)/p) / 2
  const double ia = a2 / p, ib = b2 / p, ic = c2 / p;
  const double id = d / p, ie = e / p, if_ = f / p;
  double r = (ia * (ib * ic - ie * ie) - id * (id * ic - ie * if_) +
              if_ * (id * ie - ib * if_)) / 2.0;
  if (r < -1.0) r = -1.0;
  if (r > 1.0) r = 1.0;
  const double phi = std::acos(r) / 3.0;
  // eig3 <= eig2 <= eig1; the smallest:
  lmin = m + 2.0 * p * std::cos(phi + 2.0 * M_PI / 3.0);

  // rows of A - lmin*I
  const double R[3][3] = {
      {a - lmin, d, f}, {d, b - lmin, e}, {f, e, cz - lmin}};
  double best[3] = {0, 0, 0};
  double best_n = -1.0;
  const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  for (auto& pr : pairs) {
    const double* u = R[pr[0]];
    const double* v = R[pr[1]];
    const double cx = u[1] * v[2] - u[2] * v[1];
    const double cy = u[2] * v[0] - u[0] * v[2];
    const double cc = u[0] * v[1] - u[1] * v[0];
    const double nn = cx * cx + cy * cy + cc * cc;
    if (nn > best_n) { best_n = nn; best[0] = cx; best[1] = cy; best[2] = cc; }
  }
  if (best_n < 1e-30) {  // repeated eigenvalue: any unit vector in the plane
    out[0] = 1; out[1] = 0; out[2] = 0;
    return;
  }
  const double inv = 1.0 / std::sqrt(best_n);
  out[0] = static_cast<float>(best[0] * inv);
  out[1] = static_cast<float>(best[1] * inv);
  out[2] = static_cast<float>(best[2] * inv);
}

inline void cell_of(const float* p, double inv_voxel, int64_t c[3]) {
  for (int k = 0; k < 3; ++k)
    c[k] = static_cast<int64_t>(std::floor(p[k] * inv_voxel));
}

}  // namespace

extern "C" int tpu3dlm_grid_normals(
    const float* pts,       // (n, 3)
    int64_t n,
    double voxel,
    const float* viewpoint,  // (3,) or nullptr
    float* out               // (n, 3)
) {
  if (n <= 0 || voxel <= 0) return -1;
  const double inv_voxel = 1.0 / voxel;

  // pass 0: min cell coords so keys pack into 21 bits/axis
  int64_t cmin[3] = {INT64_MAX, INT64_MAX, INT64_MAX};
  for (int64_t i = 0; i < n; ++i) {
    int64_t c[3];
    cell_of(pts + 3 * i, inv_voxel, c);
    for (int k = 0; k < 3; ++k)
      if (c[k] < cmin[k]) cmin[k] = c[k];
  }

  auto key_of = [&](const float* p) -> uint64_t {
    int64_t c[3];
    cell_of(p, inv_voxel, c);
    const uint64_t x = static_cast<uint64_t>(c[0] - cmin[0]);
    const uint64_t y = static_cast<uint64_t>(c[1] - cmin[1]);
    const uint64_t z = static_cast<uint64_t>(c[2] - cmin[2]);
    return (x << 42) | (y << 21) | z;
  };

  // pass 1: accumulate per-cell + global moments
  std::unordered_map<uint64_t, Acc> cells;
  cells.reserve(static_cast<size_t>(n / 8 + 16));
  double gn = 0, gs[3] = {0, 0, 0}, gq[6] = {0, 0, 0, 0, 0, 0};
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + 3 * i;
    Acc& a = cells[key_of(p)];
    const double x = p[0], y = p[1], z = p[2];
    a.n += 1; gn += 1;
    a.s[0] += x; a.s[1] += y; a.s[2] += z;
    gs[0] += x; gs[1] += y; gs[2] += z;
    a.q[0] += x * x; a.q[1] += x * y; a.q[2] += x * z;
    a.q[3] += y * y; a.q[4] += y * z; a.q[5] += z * z;
    gq[0] += x * x; gq[1] += x * y; gq[2] += x * z;
    gq[3] += y * y; gq[4] += y * z; gq[5] += z * z;
  }

  auto cov_of = [](double cnt, const double s[3], const double q[6],
                   double c[6]) {
    const double mx = s[0] / cnt, my = s[1] / cnt, mz = s[2] / cnt;
    c[0] = q[0] / cnt - mx * mx;
    c[1] = q[1] / cnt - mx * my;
    c[2] = q[2] / cnt - mx * mz;
    c[3] = q[3] / cnt - my * my;
    c[4] = q[4] / cnt - my * mz;
    c[5] = q[5] / cnt - mz * mz;
  };

  float gnormal[3];
  {
    double c[6];
    cov_of(gn, gs, gq, c);
    smallest_eigvec(c, gnormal);
  }

  for (auto& kv : cells) {
    Acc& a = kv.second;
    if (a.n < 3) {
      std::memcpy(a.normal, gnormal, sizeof(gnormal));
    } else {
      double c[6];
      cov_of(a.n, a.s, a.q, c);
      smallest_eigvec(c, a.normal);
    }
    a.ok = true;
  }

  // pass 2: assign + orient
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + 3 * i;
    const Acc& a = cells[key_of(p)];
    float nx = a.normal[0], ny = a.normal[1], nz = a.normal[2];
    if (viewpoint) {
      const double dx = viewpoint[0] - p[0];
      const double dy = viewpoint[1] - p[1];
      const double dz = viewpoint[2] - p[2];
      if (nx * dx + ny * dy + nz * dz < 0) { nx = -nx; ny = -ny; nz = -nz; }
    }
    out[3 * i + 0] = nx;
    out[3 * i + 1] = ny;
    out[3 * i + 2] = nz;
  }
  return 0;
}
