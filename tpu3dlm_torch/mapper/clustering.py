"""Grid-hash DBSCAN for point-cloud preprocessing (port of
``tpu3dlm/mapper/clustering.py``).

Open3D's ``cluster_dbscan`` semantics: points hash into eps-sized voxels, a
point's neighbourhood is the 27 adjacent voxels, core points (≥ min_points
neighbours within eps, self included) grow clusters, border points join a
neighbouring core's cluster, noise is -1. The pointer-chasing BFS stays on
the host, in the C++ core the JAX package prefers
(``csrc/host/dbscan.cpp``, a copy of its ``native/src/dbscan.cpp``), so the
labels are the same numbers. There is no numpy fallback: a missing compiler
raises.
"""

from __future__ import annotations

import numpy as np

from tpu3dlm_torch import native


def dbscan(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """(N, 3) → (N,) int32 cluster labels (-1 = noise)."""
    return native.dbscan(points, eps, min_points)


def largest_cluster(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """Indices of the largest DBSCAN cluster; every index when no point is
    clustered."""
    labels = dbscan(points, eps, min_points)
    valid = labels >= 0
    if not valid.any():
        return np.arange(points.shape[0])
    largest = np.argmax(np.bincount(labels[valid]))
    return np.nonzero(labels == largest)[0]
