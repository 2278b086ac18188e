"""Per-point normals for point-to-plane ICP (port of
``tpu3dlm/ops/pointcloud.py::estimate_normals_grid``, its numpy path).

Host numpy, run once per gold cloud and cached with it by the alignment.
The reference prefers a native C++ core (``tpu3dlm/native``) and keeps this
numpy path as its fallback; the port keeps the numpy path only.
Point-to-plane ICP cannot tell a normal from its negation (H = JᵀJ and
g = Jᵀr are unchanged when n flips, and rmse squares r), so eigenvector sign
conventions do not move its result.
"""

from __future__ import annotations

import numpy as np


def estimate_normals_grid(points, voxel: float = 0.08, viewpoint=None) -> np.ndarray:
    """(N, 3) float32 unit normals from per-voxel PCA.

    Points bin into ``voxel``-sized cells; each cell's 3×3 covariance
    accumulates by bincount, a batched eigh gives the smallest-eigenvalue
    direction, and every point takes its cell's normal. Cells with < 3
    points take the global dominant-plane normal. With ``viewpoint`` the
    normals are flipped to face it."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    if n == 0:
        return np.zeros((0, 3), np.float32)
    cells = np.floor(pts / voxel).astype(np.int64)
    cells -= cells.min(axis=0)
    dims = cells.max(axis=0) + 1
    # flat int64 cell key: unique on a 1-D array is far faster than a
    # row-wise unique(axis=0)
    key = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
    _, inv = np.unique(key, return_inverse=True)
    inv = inv.reshape(-1)
    v = int(inv.max()) + 1

    counts = np.bincount(inv, minlength=v).astype(np.float64)
    c1 = np.maximum(counts, 1)
    sums = np.zeros((v, 3))
    for k in range(3):
        sums[:, k] = np.bincount(inv, weights=pts[:, k], minlength=v)
    means = sums / c1[:, None]
    # single-pass covariance E[xyᵀ] − μμᵀ: the f64 cancellation (~1e-15 m²)
    # is negligible against a within-cell variance of ~voxel²/12
    cov = np.zeros((v, 3, 3))
    for a in range(3):
        for b in range(a, 3):
            cab = np.bincount(inv, weights=pts[:, a] * pts[:, b], minlength=v) / c1
            cab -= means[:, a] * means[:, b]
            cov[:, a, b] = cab
            cov[:, b, a] = cab

    _, vecs = np.linalg.eigh(cov + 1e-12 * np.eye(3))
    normals_v = vecs[:, :, 0]  # smallest eigenvector = plane normal
    bad = counts < 3
    if bad.any():
        if n >= 3:
            _, gv = np.linalg.eigh(np.cov(pts.T) + 1e-12 * np.eye(3))
            normals_v[bad] = gv[:, 0]
        else:
            # 1-2 points define no plane (np.cov of one point is NaN)
            normals_v[bad] = np.array([0.0, 0.0, 1.0])

    normals = normals_v[inv].astype(np.float32)
    if viewpoint is not None:
        to_vp = np.asarray(viewpoint, np.float32)[None] - pts.astype(np.float32)
        flip = np.einsum("ij,ij->i", normals, to_vp) < 0
        normals[flip] = -normals[flip]
    return normals
