// Marching tetrahedra, leakage cull and trilinear splat: the host legs of
// the port's meshers (tpu3dlm_torch/mapper/meshing.py, mapper/poisson.py).
//
// A copy of the JAX package's native meshing legs
// (tpu3dlm/native/src/poisson.cpp), kept byte for byte in its code so both
// packages emit the same vertices and faces in the same order: the 6-tet
// cube decomposition around diagonal 0-7, the 16-case table, edge
// interpolation and the winding rule, and the weld quantisation
// (round-half-even at voxel*1e-3). The JAX package's numpy versions of these
// legs are its fallbacks; they give the same triangle set in another order
// and, interpolating in float32 where this file uses double, vertices that
// agree only to ~1 ulp. The port has no fallback: built by
// tpu3dlm_torch/kernels/build.py with the system C++ compiler and called
// through ctypes from tpu3dlm_torch/native.py.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// cube corner k offset: (k&1, (k>>1)&1, (k>>2)&1)  [meshing._CUBE_OFFSETS]
const int OFF[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};
// 6-tet decomposition around diagonal 0-7  [meshing._TETS]
const int TETS[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};
// tet edges (pairs of tet-local vertex ids)  [meshing._TET_EDGES]
const int TET_EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

int edge_id(int a, int b) {
  int lo = a < b ? a : b, hi = a < b ? b : a;
  for (int e = 0; e < 6; ++e)
    if (TET_EDGES[e][0] == lo && TET_EDGES[e][1] == hi) return e;
  return -1;
}

// 16-case triangle table, built exactly like meshing._case_triangles()
struct CaseTable {
  int ntris[16];
  int tris[16][2][3];  // up to 2 triangles of 3 edge ids
  CaseTable() {
    for (int mask = 0; mask < 16; ++mask) {
      int in[4], out[4], ni = 0, no = 0;
      for (int v = 0; v < 4; ++v)
        (mask & (1 << v)) ? in[ni++] = v : out[no++] = v;
      ntris[mask] = 0;
      if (ni == 1) {
        int v = in[0];
        int* t = tris[mask][ntris[mask]++];
        t[0] = edge_id(v, out[0]);
        t[1] = edge_id(v, out[1]);
        t[2] = edge_id(v, out[2]);
      } else if (ni == 3) {
        int v = out[0];
        int* t = tris[mask][ntris[mask]++];
        t[0] = edge_id(v, in[0]);
        t[1] = edge_id(v, in[1]);
        t[2] = edge_id(v, in[2]);
      } else if (ni == 2) {
        int i = in[0], j = in[1], k = out[0], l = out[1];
        int e_ik = edge_id(i, k), e_il = edge_id(i, l);
        int e_jk = edge_id(j, k), e_jl = edge_id(j, l);
        int* t0 = tris[mask][ntris[mask]++];
        t0[0] = e_ik; t0[1] = e_il; t0[2] = e_jl;
        int* t1 = tris[mask][ntris[mask]++];
        t1[0] = e_ik; t1[1] = e_jl; t1[2] = e_jk;
      }
    }
  }
};
const CaseTable CASES;

struct VKey {
  int64_t x, y, z;
  bool operator==(const VKey& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};
struct VKeyHash {
  size_t operator()(const VKey& k) const {
    uint64_t h = 1469598103934665603ull;
    auto mix = [&h](uint64_t v) {
      h ^= v;
      h *= 1099511628211ull;
    };
    mix((uint64_t)k.x);
    mix((uint64_t)k.y);
    mix((uint64_t)k.z);
    return (size_t)h;
  }
};

}  // namespace

extern "C" {

void tpu3dlm_free(void* p) { std::free(p); }

// Iso-surface of a (nx, ny, nz) float32 field, welded.
// origin3/voxel place vertices in world units. Returns 0 on success;
// *verts_out / *faces_out are malloc'd (caller frees via tpu3dlm_free).
int tpu3dlm_march_tets(const float* field, int64_t nx, int64_t ny, int64_t nz,
                       double iso, int normals_toward_positive,
                       const float* origin3, double voxel, int do_weld,
                       float** verts_out, int64_t* nverts,
                       int32_t** faces_out, int64_t* nfaces) {
  *verts_out = nullptr;
  *faces_out = nullptr;
  *nverts = *nfaces = 0;
  if (nx < 2 || ny < 2 || nz < 2) return 0;

  const int64_t syx = ny * nz, sy = nz;
  std::vector<float> verts;
  std::vector<int32_t> faces;
  std::unordered_map<VKey, int32_t, VKeyHash> weld;
  verts.reserve(1 << 16);
  faces.reserve(1 << 16);
  const double q = voxel * 1e-3;  // weld quantum (meshing.py weld key)

  // emit one vertex (grid units) → welded index in world units
  auto emit_vertex = [&](const double p[3]) -> int32_t {
    float w[3];
    for (int a = 0; a < 3; ++a)
      w[a] = (float)(p[a] * voxel) + origin3[a];  // f32 like numpy
    if (!do_weld) {
      int32_t id = (int32_t)(verts.size() / 3);
      verts.insert(verts.end(), w, w + 3);
      return id;
    }
    VKey k;
    // np.round = round-half-even = nearbyint under default FE mode
    k.x = (int64_t)std::nearbyint((double)w[0] / q);
    k.y = (int64_t)std::nearbyint((double)w[1] / q);
    k.z = (int64_t)std::nearbyint((double)w[2] / q);
    auto it = weld.find(k);
    if (it != weld.end()) return it->second;
    int32_t id = (int32_t)(verts.size() / 3);
    verts.insert(verts.end(), w, w + 3);
    weld.emplace(k, id);
    return id;
  };

  double corner_pos[8][3];
  float cval[8];
  double epts[6][3];
  bool ecomp[6];

  for (int64_t i = 0; i + 1 < nx; ++i) {
    for (int64_t j = 0; j + 1 < ny; ++j) {
      const float* col = field + i * syx + j * sy;
      for (int64_t k = 0; k + 1 < nz; ++k) {
        // gather corners; crossing test (finite, min<=iso<max)
        float lo = INFINITY, hi = -INFINITY;
        bool finite = true;
        for (int c = 0; c < 8; ++c) {
          float v = col[OFF[c][0] * syx + OFF[c][1] * sy + OFF[c][2] + k];
          cval[c] = v;
          finite &= std::isfinite(v);
          lo = v < lo ? v : lo;
          hi = v > hi ? v : hi;
        }
        if (!finite || !(lo <= iso) || !(hi > iso)) continue;

        for (int c = 0; c < 8; ++c) {
          corner_pos[c][0] = (double)(i + OFF[c][0]);
          corner_pos[c][1] = (double)(j + OFF[c][1]);
          corner_pos[c][2] = (double)(k + OFF[c][2]);
        }

        for (int t = 0; t < 6; ++t) {
          double tv[4];
          const double* tpos[4];
          int mask = 0;
          for (int v = 0; v < 4; ++v) {
            tv[v] = (double)cval[TETS[t][v]];
            tpos[v] = corner_pos[TETS[t][v]];
            if (tv[v] > iso) mask |= 1 << v;
          }
          int nt = CASES.ntris[mask];
          if (nt == 0) continue;

          for (int e = 0; e < 6; ++e) ecomp[e] = false;
          // winding reference: mean of inside-vertex positions
          double ref[3] = {0, 0, 0};
          int nin = 0;
          for (int v = 0; v < 4; ++v)
            if (mask & (1 << v)) {
              ref[0] += tpos[v][0];
              ref[1] += tpos[v][1];
              ref[2] += tpos[v][2];
              ++nin;
            }
          ref[0] /= nin;
          ref[1] /= nin;
          ref[2] /= nin;

          for (int r = 0; r < nt; ++r) {
            double p[3][3];
            for (int c = 0; c < 3; ++c) {
              int e = CASES.tris[mask][r][c];
              if (!ecomp[e]) {
                int a = TET_EDGES[e][0], b = TET_EDGES[e][1];
                double va = tv[a], vb = tv[b];
                double denom = vb - va;
                double tt =
                    std::fabs(denom) > 1e-12 ? (iso - va) / denom : 0.5;
                tt = tt < 0.0 ? 0.0 : (tt > 1.0 ? 1.0 : tt);
                for (int ax = 0; ax < 3; ++ax)
                  epts[e][ax] = tpos[a][ax] + tt * (tpos[b][ax] - tpos[a][ax]);
                ecomp[e] = true;
              }
              std::memcpy(p[c], epts[e], sizeof(epts[e]));
            }
            // coherent winding: normal toward the inside (field > iso)
            // side iff normals_toward_positive
            double u[3] = {p[1][0] - p[0][0], p[1][1] - p[0][1],
                           p[1][2] - p[0][2]};
            double v2[3] = {p[2][0] - p[0][0], p[2][1] - p[0][1],
                            p[2][2] - p[0][2]};
            double n[3] = {u[1] * v2[2] - u[2] * v2[1],
                           u[2] * v2[0] - u[0] * v2[2],
                           u[0] * v2[1] - u[1] * v2[0]};
            double cen[3] = {(p[0][0] + p[1][0] + p[2][0]) / 3.0,
                             (p[0][1] + p[1][1] + p[2][1]) / 3.0,
                             (p[0][2] + p[1][2] + p[2][2]) / 3.0};
            double s = n[0] * (ref[0] - cen[0]) + n[1] * (ref[1] - cen[1]) +
                       n[2] * (ref[2] - cen[2]);
            bool flip = normals_toward_positive ? (s < 0.0) : (s > 0.0);

            int32_t i0 = emit_vertex(p[0]);
            int32_t i1 = emit_vertex(flip ? p[2] : p[1]);
            int32_t i2 = emit_vertex(flip ? p[1] : p[2]);
            if (do_weld && (i0 == i1 || i1 == i2 || i0 == i2))
              continue;  // degenerate after welding (numpy drops these too)
            faces.push_back(i0);
            faces.push_back(i1);
            faces.push_back(i2);
          }
        }
      }
    }
  }

  *nverts = (int64_t)(verts.size() / 3);
  *nfaces = (int64_t)(faces.size() / 3);
  if (*nverts) {
    *verts_out = (float*)std::malloc(verts.size() * sizeof(float));
    if (!*verts_out) return 1;
    std::memcpy(*verts_out, verts.data(), verts.size() * sizeof(float));
  }
  if (*nfaces) {
    *faces_out = (int32_t*)std::malloc(faces.size() * sizeof(int32_t));
    if (!*faces_out) {
      std::free(*verts_out);
      *verts_out = nullptr;
      return 1;
    }
    std::memcpy(*faces_out, faces.data(), faces.size() * sizeof(int32_t));
  }
  return 0;
}

// Leakage cull (mapper/poisson._cull_leakage): mark faces whose centroid
// lies within one dilated occupancy cell of the input cloud. Builds the
// boolean occupancy grid over `points`, dilates it by one cell
// (26-neighbourhood), and writes keep_mask[f] ∈ {0,1} per face.
int tpu3dlm_cull_leakage(const float* verts, const int32_t* faces,
                         int64_t nfaces, const float* points, int64_t npts,
                         const float* origin3, double cell, int64_t cx,
                         int64_t cy, int64_t cz, uint8_t* keep_mask) {
  const int64_t total = cx * cy * cz;
  std::vector<uint8_t> occ(total, 0), dil(total, 0);
  // grid-cell assignment MUST match the numpy fallback bit-for-bit:
  // (f32 - f32) / f32 then floor — the splat pads bounds by whole cells,
  // so plane clouds land EXACTLY on cell boundaries and a double-reciprocal
  // shortcut flips systematic swaths of cells (238 faces on the plane
  // fixture), not just measure-zero stragglers
  const float cellf = (float)cell;
  auto clampi = [](int64_t v, int64_t hi) {
    return v < 0 ? 0 : (v >= hi ? hi - 1 : v);
  };
  for (int64_t p = 0; p < npts; ++p) {
    int64_t x = clampi(
        (int64_t)std::floor((points[3 * p] - origin3[0]) / cellf), cx);
    int64_t y = clampi(
        (int64_t)std::floor((points[3 * p + 1] - origin3[1]) / cellf), cy);
    int64_t z = clampi(
        (int64_t)std::floor((points[3 * p + 2] - origin3[2]) / cellf), cz);
    occ[(x * cy + y) * cz + z] = 1;
  }
  for (int64_t x = 0; x < cx; ++x)
    for (int64_t y = 0; y < cy; ++y)
      for (int64_t z = 0; z < cz; ++z) {
        if (!occ[(x * cy + y) * cz + z]) continue;
        for (int64_t dx = -1; dx <= 1; ++dx)
          for (int64_t dy = -1; dy <= 1; ++dy)
            for (int64_t dz = -1; dz <= 1; ++dz) {
              int64_t xx = x + dx, yy = y + dy, zz = z + dz;
              if (xx < 0 || yy < 0 || zz < 0 || xx >= cx || yy >= cy ||
                  zz >= cz)
                continue;
              dil[(xx * cy + yy) * cz + zz] = 1;
            }
      }
  for (int64_t f = 0; f < nfaces; ++f) {
    // centroid in f32 like verts[faces].mean(axis=1): (a + b) + c, / 3
    const float* p0 = verts + 3 * (int64_t)faces[3 * f];
    const float* p1 = verts + 3 * (int64_t)faces[3 * f + 1];
    const float* p2 = verts + 3 * (int64_t)faces[3 * f + 2];
    float m0 = ((p0[0] + p1[0]) + p2[0]) / 3.0f;
    float m1 = ((p0[1] + p1[1]) + p2[1]) / 3.0f;
    float m2 = ((p0[2] + p1[2]) + p2[2]) / 3.0f;
    int64_t x = (int64_t)std::floor((m0 - origin3[0]) / cellf);
    int64_t y = (int64_t)std::floor((m1 - origin3[1]) / cellf);
    int64_t z = (int64_t)std::floor((m2 - origin3[2]) / cellf);
    keep_mask[f] =
        (x >= 0 && y >= 0 && z >= 0 && x < cx && y < cy && z < cz)
            ? dil[(x * cy + y) * cz + z]
            : 0;
  }
  return 0;
}

// Trilinear 8-corner scatter of per-point values (C channels; values ==
// nullptr → unit mass, C must be 1) onto a (nx, ny, nz) grid. `accum` is a
// caller-zeroed (nx*ny*nz, C) float64 buffer (row-major), matching
// meshing.trilinear_scatter's f64 accumulation; out-of-grid mass clamps to
// the border voxel exactly like the numpy path.
int tpu3dlm_trilinear_splat(const float* points, int64_t n,
                            const float* values, int64_t channels,
                            const float* lo3, double voxel, int64_t nx,
                            int64_t ny, int64_t nz, double* accum) {
  const float vox = (float)voxel;
  const int64_t sy = nz, sx = ny * nz;
  for (int64_t p = 0; p < n; ++p) {
    // numpy computes g in float32, then frac = g - floor(g) promoted to f64
    float gx = (points[3 * p + 0] - lo3[0]) / vox;
    float gy = (points[3 * p + 1] - lo3[1]) / vox;
    float gz = (points[3 * p + 2] - lo3[2]) / vox;
    int64_t x0 = (int64_t)std::floor(gx);
    int64_t y0 = (int64_t)std::floor(gy);
    int64_t z0 = (int64_t)std::floor(gz);
    double fx = (double)gx - (double)x0;
    double fy = (double)gy - (double)y0;
    double fz = (double)gz - (double)z0;
    for (int c8 = 0; c8 < 8; ++c8) {
      int dx = OFF[c8][0], dy = OFF[c8][1], dz = OFF[c8][2];
      double w = (dx ? fx : 1.0 - fx) * (dy ? fy : 1.0 - fy) *
                 (dz ? fz : 1.0 - fz);
      int64_t xi = x0 + dx, yi = y0 + dy, zi = z0 + dz;
      xi = xi < 0 ? 0 : (xi >= nx ? nx - 1 : xi);
      yi = yi < 0 ? 0 : (yi >= ny ? ny - 1 : yi);
      zi = zi < 0 ? 0 : (zi >= nz ? nz - 1 : zi);
      double* cell = accum + (xi * sx + yi * sy + zi) * channels;
      if (values == nullptr) {
        cell[0] += w;
      } else {
        const float* val = values + p * channels;
        for (int64_t c = 0; c < channels; ++c) cell[c] += w * (double)val[c];
      }
    }
  }
  return 0;
}

}  // extern "C"
