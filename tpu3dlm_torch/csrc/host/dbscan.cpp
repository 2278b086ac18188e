// Grid-hash DBSCAN: the host clustering core of the port's map stage.
//
// A copy of the JAX package's native DBSCAN (tpu3dlm/native/src/dbscan.cpp),
// kept byte for byte in its code so both packages label every point alike:
// points hash into eps-sized voxels, neighbourhoods are the 27 adjacent
// voxels, core points BFS into clusters. O(N·k) time, C++17 standard
// library only. Built by tpu3dlm_torch/kernels/build.py with the system C++
// compiler and called through ctypes from tpu3dlm_torch/native.py
// (mapper/clustering.py); there is no Python fallback.

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
        // large-prime mix; coordinates are small after /eps
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

    std::unordered_map<CellKey, std::vector<int64_t>, CellHash> grid;
    grid.reserve(static_cast<size_t>(n));
    std::vector<CellKey> cell_of(n);
    for (int64_t i = 0; i < n; ++i) {
        CellKey k{static_cast<int64_t>(std::floor(pts[3 * i + 0] / eps)),
                  static_cast<int64_t>(std::floor(pts[3 * i + 1] / eps)),
                  static_cast<int64_t>(std::floor(pts[3 * i + 2] / eps))};
        cell_of[i] = k;
        grid[k].push_back(i);
    }

    auto neighbours = [&](int64_t i, std::vector<int64_t>& out) {
        out.clear();
        const CellKey& c = cell_of[i];
        const float xi = pts[3 * i], yi = pts[3 * i + 1], zi = pts[3 * i + 2];
        for (int dx = -1; dx <= 1; ++dx)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dz = -1; dz <= 1; ++dz) {
                    auto it = grid.find(CellKey{c.x + dx, c.y + dy, c.z + dz});
                    if (it == grid.end()) continue;
                    for (int64_t j : it->second) {
                        const float ddx = pts[3 * j] - xi;
                        const float ddy = pts[3 * j + 1] - yi;
                        const float ddz = pts[3 * j + 2] - zi;
                        if (ddx * ddx + ddy * ddy + ddz * ddz <= eps2)
                            out.push_back(j);
                    }
                }
    };

    std::memset(labels_out, 0xFF, sizeof(int32_t) * static_cast<size_t>(n));  // -1
    std::vector<int64_t> nb;
    nb.reserve(256);
    std::vector<uint8_t> visited(n, 0);
    int32_t cid = 0;

    for (int64_t i = 0; i < n; ++i) {
        if (visited[i]) continue;
        neighbours(i, nb);
        if (static_cast<int>(nb.size()) < min_pts) continue;  // not core (yet)
        // BFS a new cluster from core point i
        visited[i] = 1;
        labels_out[i] = cid;
        std::queue<int64_t> q;
        for (int64_t j : nb) {
            if (labels_out[j] == -1) labels_out[j] = cid;
            if (!visited[j]) { visited[j] = 1; q.push(j); }
        }
        while (!q.empty()) {
            int64_t j = q.front();
            q.pop();
            neighbours(j, nb);
            if (static_cast<int>(nb.size()) >= min_pts) {  // j is core: expand
                for (int64_t k2 : nb) {
                    if (labels_out[k2] == -1) labels_out[k2] = cid;
                    if (!visited[k2]) { visited[k2] = 1; q.push(k2); }
                }
            }
        }
        ++cid;
    }
    return cid;
}

}  // extern "C"
