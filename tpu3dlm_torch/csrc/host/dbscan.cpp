// Grid-hash DBSCAN: the host clustering core of the port's map stage.
//
// Labels every point as the JAX package's native DBSCAN
// (tpu3dlm/native/src/dbscan.cpp) does: points hash into eps-sized voxels,
// neighbourhoods are the 27 adjacent voxels, core points (at least
// min_pts points within eps, themselves included, by the same float
// distance) BFS into clusters numbered in the order of their first core
// point, and a border point joins the first cluster that reaches it. The
// work is arranged otherwise: each voxel's points are stored contiguously,
// every point's neighbour count comes from one pass over each pair of
// adjacent voxels, and a cluster's expansion scans only the points not yet
// visited (which the reference's loop skips in effect: a visited point is
// labelled). The points a cluster reaches do not depend on the order it
// reaches them, so the labels are the reference's (held by
// tests/test_torch_meshing.py). C++17 standard library only. Built by
// tpu3dlm_torch/kernels/build.py with the system C++ compiler and called
// through ctypes from tpu3dlm_torch/native.py (mapper/clustering.py); there
// is no Python fallback.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct CellKey {
    int64_t x, y, z;
    bool operator==(const CellKey& o) const { return x == o.x && y == o.y && z == o.z; }
};

struct CellHash {
    size_t operator()(const CellKey& k) const {
        uint64_t h = static_cast<uint64_t>(k.x) * 73856093ULL ^
                     static_cast<uint64_t>(k.y) * 19349663ULL ^
                     static_cast<uint64_t>(k.z) * 83492791ULL;
        return static_cast<size_t>(h);
    }
};

}  // namespace

extern "C" {

// labels_out: n int32 entries, -1 = noise. Returns number of clusters.
int tpu3dlm_dbscan(const float* pts, int64_t n, double eps, int min_pts,
                   int32_t* labels_out) {
    if (n <= 0) return 0;
    const double eps2 = eps * eps;

    // cells numbered in order of first appearance; each cell's points in
    // ascending index order, stored contiguously (coordinates and indices)
    std::unordered_map<CellKey, int64_t, CellHash> cell_id;
    cell_id.reserve(static_cast<size_t>(n));
    std::vector<CellKey> keys;
    std::vector<int64_t> cell_of(n), count;
    for (int64_t i = 0; i < n; ++i) {
        CellKey k{static_cast<int64_t>(std::floor(pts[3 * i + 0] / eps)),
                  static_cast<int64_t>(std::floor(pts[3 * i + 1] / eps)),
                  static_cast<int64_t>(std::floor(pts[3 * i + 2] / eps))};
        auto it = cell_id.find(k);
        int64_t c;
        if (it == cell_id.end()) {
            c = static_cast<int64_t>(keys.size());
            cell_id.emplace(k, c);
            keys.push_back(k);
            count.push_back(0);
        } else {
            c = it->second;
        }
        cell_of[i] = c;
        ++count[c];
    }
    const int64_t ncells = static_cast<int64_t>(keys.size());
    std::vector<int64_t> start(ncells + 1, 0);
    for (int64_t c = 0; c < ncells; ++c) start[c + 1] = start[c] + count[c];
    std::vector<int64_t> idx(n), fill(start.begin(), start.end() - 1);
    std::vector<float> sx(n), sy(n), sz(n);
    for (int64_t i = 0; i < n; ++i) {
        int64_t at = fill[cell_of[i]]++;
        idx[at] = i;
        sx[at] = pts[3 * i];
        sy[at] = pts[3 * i + 1];
        sz[at] = pts[3 * i + 2];
    }
    // each cell's adjacent cells (itself included) in (dx, dy, dz) order
    std::vector<int64_t> adj_start(ncells + 1, 0), adj;
    adj.reserve(static_cast<size_t>(ncells) * 9);
    for (int64_t c = 0; c < ncells; ++c) {
        const CellKey& k = keys[c];
        for (int dx = -1; dx <= 1; ++dx)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dz = -1; dz <= 1; ++dz) {
                    auto it = cell_id.find(CellKey{k.x + dx, k.y + dy, k.z + dz});
                    if (it != cell_id.end()) adj.push_back(it->second);
                }
        adj_start[c + 1] = static_cast<int64_t>(adj.size());
    }

    // the largest float whose double is within eps2: (double)d2 <= eps2
    // exactly when d2 <= thr
    float thr = static_cast<float>(eps2);
    if (static_cast<double>(thr) > eps2) thr = std::nextafter(thr, -INFINITY);

    // every point's neighbour count (itself included), each pair of
    // adjacent cells once
    std::vector<int32_t> cnt(n, 0);  // by position in the cell order
    for (int64_t c = 0; c < ncells; ++c) {
        for (int64_t a = adj_start[c]; a < adj_start[c + 1]; ++a) {
            const int64_t c2 = adj[a];
            if (c2 < c) continue;
            const int64_t b2 = start[c2], e2 = start[c2 + 1];
            for (int64_t p = start[c]; p < start[c + 1]; ++p) {
                const float xp = sx[p], yp = sy[p], zp = sz[p];
                const int64_t q0 = c2 == c ? p + 1 : b2;
                const float dx0 = xp - xp, dy0 = yp - yp, dz0 = zp - zp;  // itself: 0, or NaN
                int32_t hits = c2 == c ? int32_t(dx0 * dx0 + dy0 * dy0 + dz0 * dz0 <= thr) : 0;
                for (int64_t q = q0; q < e2; ++q) {
                    const float ddx = sx[q] - xp;
                    const float ddy = sy[q] - yp;
                    const float ddz = sz[q] - zp;
                    const int32_t in = (ddx * ddx + ddy * ddy + ddz * ddz) <= thr;
                    cnt[q] += in;
                    hits += in;
                }
                cnt[p] += hits;
            }
        }
    }
    std::vector<int32_t> core_count(n);  // by point
    for (int64_t k = 0; k < n; ++k) core_count[idx[k]] = cnt[k];

    // Each cell keeps its unvisited points first in its range (live[c] of
    // them): a visited point is swapped past them. Visited points are
    // labelled, so the reference's loop over them does nothing, and the
    // points a cluster reaches do not depend on the order it reaches them.
    std::vector<int64_t> pos(n), live(count);
    for (int64_t k = 0; k < n; ++k) pos[idx[k]] = k;
    auto visit = [&](int64_t k2) {  // k2 unvisited: mark it, move it past the live ones
        const int64_t c = cell_of[k2];
        const int64_t at = pos[k2], last = start[c] + --live[c];
        const int64_t other = idx[last];
        std::swap(idx[at], idx[last]);
        std::swap(sx[at], sx[last]);
        std::swap(sy[at], sy[last]);
        std::swap(sz[at], sz[last]);
        pos[other] = at;
        pos[k2] = last;
    };

    std::memset(labels_out, 0xFF, sizeof(int32_t) * static_cast<size_t>(n));  // -1
    std::queue<int64_t> q;
    int32_t cid = 0;
    auto expand = [&](int64_t i) {  // i is core: its unvisited neighbours join
        const int64_t c = cell_of[i];
        const float xi = pts[3 * i], yi = pts[3 * i + 1], zi = pts[3 * i + 2];
        for (int64_t a = adj_start[c]; a < adj_start[c + 1]; ++a) {
            const int64_t c2 = adj[a];
            for (int64_t j = start[c2]; j < start[c2] + live[c2];) {
                const float ddx = sx[j] - xi;
                const float ddy = sy[j] - yi;
                const float ddz = sz[j] - zi;
                if (ddx * ddx + ddy * ddy + ddz * ddz <= thr) {
                    const int64_t k2 = idx[j];
                    labels_out[k2] = cid;
                    visit(k2);
                    q.push(k2);
                } else {
                    ++j;
                }
            }
        }
    };

    for (int64_t i = 0; i < n; ++i) {
        if (labels_out[i] != -1 || core_count[i] < min_pts) continue;  // visited, or not core (yet)
        labels_out[i] = cid;
        visit(i);
        expand(i);
        while (!q.empty()) {
            int64_t j = q.front();
            q.pop();
            if (core_count[j] >= min_pts) expand(j);
        }
        ++cid;
    }
    return cid;
}

}  // extern "C"
