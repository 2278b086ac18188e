"""Depth maps to point clouds, and per-point normals for point-to-plane ICP
and Poisson meshing (port of ``tpu3dlm/ops/pointcloud.py``).

``depth_to_points`` unprojects every pixel of one depth map through the
pinhole model (and a pose, when given) in torch on the map's device;
``scan_to_pointcloud`` does it for every frame of a scan at once on
``device``, with the intrinsics scaled from RGB to depth resolution.

``estimate_normals_grid`` runs the host C++ core that the JAX package's
default route runs (``csrc/host/normals.cpp``, a copy of
``tpu3dlm/native/src/normals.cpp``), so both packages give every point the
same normal, sign included; a failed build raises. Once per gold cloud,
cached with it by the alignment. ``estimate_normals_grid_numpy`` is its
plain twin, the JAX package's numpy fallback: the same lines, each with the
sign its eigensolver happens to pick (about a third opposite without a
viewpoint). Nothing on the main path calls the twin.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dlm_torch.device import as_device_tensor, resolve_device
from tpu3dlm_torch.ops import geometry as G


def depth_to_points(depth: torch.Tensor, fx, fy, cx, cy, pose: torch.Tensor | None = None,
                    scale_depth: float = 1000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """One (H, W) depth map in ``scale_depth`` units (mm by default) →
    ((H·W, 3) points, (H·W,) valid mask), camera frame, or world frame
    through a (7,) camera→world ``pose``. ``fx`` … ``cy`` are scalars or
    0-d tensors at the map's resolution."""
    h, w = depth.shape
    ys = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :].expand(h, w)
    pts = G.unproject(xs, ys, depth / scale_depth, fx, fy, cx, cy).reshape(-1, 3)
    valid = (depth > 1e-6).reshape(-1)
    if pose is not None:
        pts = G.transform_points(G.pose_to_matrix(pose), pts)
    return pts, valid


def scan_to_pointcloud(depth, intrinsics, rgb_size, poses, scale_depth: float = 1000.0,
                       device: str | torch.device = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """A whole scan → ((F, H·W, 3) world points, (F, H·W) valid) on
    ``device``: depth (F, H, W), intrinsics (F, 4) fx, fy, cx, cy at RGB
    resolution, rgb_size (F, 2), poses (F, 7)."""
    dev = resolve_device(device)
    depth = as_device_tensor(depth, dev, torch.float32)
    intr = as_device_tensor(intrinsics, dev, torch.float32)
    wh = as_device_tensor(rgb_size, dev, torch.float32)
    poses = as_device_tensor(poses, dev, torch.float32)
    F, h, w = depth.shape
    fx, fy, cx, cy = (v[:, None, None] for v in G.scale_intrinsics(
        intr[:, 0], intr[:, 1], intr[:, 2], intr[:, 3], wh[:, 0], w))
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    pts = G.unproject(xs, ys, depth / scale_depth, fx, fy, cx, cy).reshape(F, -1, 3)
    return G.transform_points(G.pose_to_matrix(poses), pts), (depth > 1e-6).reshape(F, -1)


def estimate_normals_grid(points, voxel: float = 0.08, viewpoint=None) -> np.ndarray:
    """(N, 3) float32 unit normals from per-voxel PCA (host C++): points bin
    into ``voxel``-sized cells, each cell's smallest-eigenvalue direction is
    the normal of its points, cells with < 3 points take the global
    dominant-plane normal; with ``viewpoint`` the normals face it."""
    from tpu3dlm_torch.native import grid_normals

    if np.shape(points)[0] == 0:
        return np.zeros((0, 3), np.float32)
    return grid_normals(points, voxel, viewpoint)


def estimate_normals_grid_numpy(points, voxel: float = 0.08, viewpoint=None) -> np.ndarray:
    """The plain twin of ``estimate_normals_grid`` in numpy.

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
