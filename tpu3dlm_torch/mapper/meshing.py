"""Surface meshing: TSDF fusion on the device, density splat and marching
tetrahedra on the host (port of ``tpu3dlm/mapper/meshing.py``).

Two scalar fields feed one host triangulator:

* ``tsdf_from_scan``: truncated-signed-distance fusion of a scan's depth
  frames over a dense voxel grid, in PyTorch on ``device``: a loop over
  frames, each a vectorised project → nearest pixel → truncated SDF →
  running sums over all voxels. Unobserved voxels are NaN.
* ``density_field``: the trilinear point-splat density of a bare cloud;
  the iso-surface of the result is a shell around the points.

``marching_tetrahedra`` splits each grid cube into 6 tetrahedra around its
main diagonal and emits 0-2 triangles per tetrahedron, welded. The march
and the splat are the JAX package's C++ (``csrc/host/meshing.cpp``, a copy
of its ``native/src/poisson.cpp``), so the same field gives the same
vertices and faces in the same order; there is no numpy fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dlm_torch import native
from tpu3dlm_torch.device import as_device_tensor, resolve_device
from tpu3dlm_torch.ops import geometry as G


def marching_tetrahedra(
    field: np.ndarray,  # (Nx, Ny, Nz) scalar field
    iso: float,
    origin: np.ndarray,  # (3,) world position of voxel (0, 0, 0)
    voxel: float,
    weld: bool = True,
    normals_toward_positive: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Iso-surface of ``field`` at ``iso`` → ((V, 3) vertices, (F, 3) faces).

    Faces wind coherently: with ``normals_toward_positive`` each face's
    right-hand normal points to the field > iso side (free space of a
    TSDF), otherwise to the field < iso side (outward of a density shell).
    Cubes with a NaN corner emit nothing.
    """
    return native.march_tets(field, iso, origin, voxel, weld, normals_toward_positive)


def grid_bounds(
    points: np.ndarray,
    voxel: float,
    pad: int = 2,
    max_voxels: int = 40_000_000,
    fast_len=None,
    min_dim: int = 2,
) -> tuple[np.ndarray, tuple[int, int, int], float]:
    """Padded grid covering the cloud → (lo, dims, effective_voxel).

    Above ``max_voxels`` the voxel grows by 1.26 (about twice the volume a
    step) and the pad, counted in voxels, is measured again with it.
    ``fast_len`` rounds each dim up (to FFT-friendly lengths).
    """
    pts = np.asarray(points, np.float32)
    while True:
        lo = pts.min(axis=0) - pad * voxel
        hi = pts.max(axis=0) + pad * voxel
        dims = np.maximum(min_dim, np.ceil((hi - lo) / voxel).astype(np.int64) + 1)
        if fast_len is not None:
            dims = np.array([fast_len(int(d)) for d in dims], np.int64)
        if int(dims.prod()) <= max_voxels:
            return lo.astype(np.float32), (int(dims[0]), int(dims[1]), int(dims[2])), voxel
        voxel *= 1.26


def trilinear_scatter(
    points: np.ndarray,
    values: np.ndarray | None,
    lo: np.ndarray,
    dims: tuple[int, int, int],
    voxel: float,
) -> np.ndarray:
    """Trilinear 8-corner scatter of per-point values onto a grid (host C++,
    f64 accumulation). ``values=None`` splats unit mass → (Nx, Ny, Nz);
    (N, C) values → (Nx, Ny, Nz, C). Mass outside the grid clamps to the
    border voxel."""
    return native.trilinear_splat(points, values, lo, dims, voxel)


def trilinear_sample(field: np.ndarray, pts_grid: np.ndarray) -> np.ndarray:
    """Sample an (Nx, Ny, Nz) field at (N, 3) grid-unit positions (host)."""
    nx, ny, nz = field.shape
    g0 = np.floor(pts_grid).astype(np.int64)
    frac = pts_grid - g0
    out = np.zeros(pts_grid.shape[0], np.float32)
    for k in range(8):
        dx, dy, dz = (k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1
        w = (
            (frac[:, 0] if dx else 1 - frac[:, 0])
            * (frac[:, 1] if dy else 1 - frac[:, 1])
            * (frac[:, 2] if dz else 1 - frac[:, 2])
        )
        out += w * field[
            np.clip(g0[:, 0] + dx, 0, nx - 1),
            np.clip(g0[:, 1] + dy, 0, ny - 1),
            np.clip(g0[:, 2] + dz, 0, nz - 1),
        ]
    return out


def density_field(
    points: np.ndarray,
    voxel: float = 0.04,
    pad: int = 2,
    max_voxels: int = 40_000_000,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Trilinear point-splat density → (field (Nx, Ny, Nz), origin (3,),
    effective voxel); the voxel is returned because the ``max_voxels``
    ladder may have grown it."""
    pts = np.asarray(points, np.float32)
    if pts.shape[0] == 0:
        return np.zeros((2, 2, 2), np.float32), np.zeros(3, np.float32), voxel
    lo, dims, voxel = grid_bounds(pts, voxel, pad=pad, max_voxels=max_voxels)
    return trilinear_scatter(pts, None, lo, dims, voxel), lo, voxel


def mesh_point_cloud(
    points: np.ndarray,
    voxel: float = 0.04,
    iso_quantile: float = 0.35,
) -> tuple[np.ndarray, np.ndarray]:
    """Cloud → shell mesh ((V, 3), (F, 3)): density splat, iso at the
    ``iso_quantile`` of the non-zero densities, marching tetrahedra with
    normals toward the sparse side."""
    field, origin, voxel = density_field(points, voxel)
    nz = field[field > 0]
    if nz.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    iso = float(np.quantile(nz, iso_quantile))
    return marching_tetrahedra(field, iso, origin, voxel, normals_toward_positive=False)


# ---------------------------------------------------------------------------
# TSDF fusion (PyTorch on the device, one pass over frames)
# ---------------------------------------------------------------------------


def tsdf_from_scan(
    scan,
    voxel: float = 0.04,
    trunc: float | None = None,
    bounds: tuple[np.ndarray, np.ndarray] | None = None,
    max_voxels: int = 20_000_000,
    device: str | torch.device = "cuda",
):
    """Fuse a Scan's depth frames into a TSDF grid on ``device``.

    Returns (tsdf (Nx, Ny, Nz) float32 numpy in [-1, 1], NaN where no frame
    observed the voxel; origin (3,); effective voxel). Mesh it with
    ``marching_tetrahedra(tsdf, 0.0, origin, voxel)``. Bounds come from a
    sparse unprojection of every frame unless given. Above ``max_voxels``
    the voxel grows by 1.26 a step, and a default ``trunc`` (4 voxels)
    grows with it; an explicit ``trunc`` is kept.
    """
    dev = resolve_device(device)
    lo, dims, voxel, trunc, intr_d = tsdf_grid(scan, voxel, trunc, bounds, max_voxels)
    field = _fuse_tsdf(dims, lo, voxel, trunc, scan.poses, intr_d, scan.depth, dev)
    return field.cpu().numpy().reshape(dims), lo, voxel


def tsdf_grid(scan, voxel: float, trunc: float | None, bounds, max_voxels: int):
    """The host half of ``tsdf_from_scan``: (lo, dims, effective voxel,
    trunc, (F, 4) intrinsics at depth resolution)."""
    trunc_explicit = trunc is not None
    trunc = trunc if trunc_explicit else 4 * voxel
    depth = np.asarray(scan.depth, np.float32)  # (F, Hd, Wd) mm
    F, Hd, Wd = depth.shape
    intr = np.asarray(scan.intrinsics, np.float32)
    wh = np.asarray(scan.rgb_size, np.float32)
    # intrinsics at depth resolution, all frames at once
    intr_d = np.stack(
        G.scale_intrinsics(intr[:, 0], intr[:, 1], intr[:, 2], intr[:, 3], wh[:, 0], Wd), axis=1
    )

    if bounds is None:
        sub = 8
        T_all = G.pose_to_matrix(torch.from_numpy(np.asarray(scan.poses, np.float32))).numpy()
        pts = []
        for f in range(F):
            d = depth[f, ::sub, ::sub] / 1000.0
            vv, uu = np.mgrid[0:Hd:sub, 0:Wd:sub].astype(np.float32)
            ok = d > 1e-4
            if not ok.any():
                continue
            fx, fy, cx, cy = intr_d[f]
            X = (uu[ok] - cx) / fx * d[ok]
            Y = (vv[ok] - cy) / fy * d[ok]
            cam = np.stack([X, Y, d[ok]], axis=1)
            T = T_all[f]
            pts.append(cam @ T[:3, :3].T + T[:3, 3])
        if not pts:
            raise ValueError("scan has no valid depth to fuse")
        cloud = np.concatenate(pts)
        lo = cloud.min(axis=0) - 2 * voxel
        hi = cloud.max(axis=0) + 2 * voxel
    else:
        lo, hi = (np.asarray(b, np.float32) for b in bounds)

    dims = np.maximum(2, np.ceil((hi - lo) / voxel).astype(np.int64) + 1)
    while int(dims.prod()) > max_voxels:
        voxel *= 1.26
        if not trunc_explicit:
            trunc = 4 * voxel
        dims = np.maximum(2, np.ceil((hi - lo) / voxel).astype(np.int64) + 1)
    return lo.astype(np.float32), tuple(int(d) for d in dims), voxel, trunc, intr_d


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c rounded once to f32, as a fused multiply-add rounds it.

    XLA's CPU backend contracts these expressions into FMAs; separate f32
    ops round twice and move a voxel centre or a pixel coordinate by an ulp,
    which flips pixels at rounding boundaries. The product of two f32
    numbers is exact in f64, so one f64 add rounded to f32 gives the fused
    result on every device."""
    return (a.double() * b + c).float()


def _fuse_tsdf(dims, lo, voxel: float, trunc: float, poses, intr, depth, device: torch.device) -> torch.Tensor:
    """The fusion over all ``dims`` voxels → (N,) float32 on ``device``.

    Voxel centres are made on the device from ``lo``, ``voxel`` and the
    strides. For each frame: world → camera with the inverted pose, →
    pixel, rounded half to even as ``jnp.round``; the nearest depth,
    sdf = d − z, weight 1 where the voxel is in view, the depth valid and
    sdf > −trunc; the clipped sdf/trunc added to running sums.

    Every rounding is the one XLA's CPU backend compiles the reference's
    fusion to, so the field is bit-identical to the JAX package's: centres
    and pixel coordinates as fused multiply-adds (``_fma``), the camera
    transform's three products accumulated in order, mm → m as a product
    with the f32 reciprocal of 1000. The world → camera matrices are built
    on the host in f32 and uploaded, and each step is an exactly rounded
    elementwise op, so the card computes the same numbers as the CPU."""
    nx, ny, nz = dims
    n = nx * ny * nz
    depth_t = as_device_tensor(np.ascontiguousarray(depth, np.float32), device)
    F, Hd, Wd = depth_t.shape
    f32 = dict(dtype=torch.float32, device=device)
    E = G.invert_se3(G.pose_to_matrix(torch.from_numpy(np.asarray(poses, np.float32)))).to(torch.float64)
    E = as_device_tensor(E.numpy(), device)  # f64 holding f32 values
    intr_t = as_device_tensor(np.asarray(intr, np.float64), device)
    voxel_t = torch.tensor(voxel, dtype=torch.float32).item()
    lo_d = np.asarray(lo, np.float32).astype(np.float64)
    trunc_t = torch.tensor(trunc, **f32)
    milli = torch.tensor(1e-3, dtype=torch.float32).item()

    flat = torch.arange(n, dtype=torch.int64, device=device)
    gi, gj, gk = flat // (ny * nz), (flat % (ny * nz)) // nz, flat % nz
    del flat
    centre = [_fma(g.to(torch.float32), voxel_t, float(o)) for g, o in zip((gi, gj, gk), lo_d)]
    del gi, gj, gk

    tsdf_sum = torch.zeros(n, **f32)
    w_sum = torch.zeros(n, **f32)
    for f in range(F):
        R, t = E[f, :3, :3], E[f, :3, 3]
        x, y, z = (
            (_fma(centre[2], R[r, 2], _fma(centre[1], R[r, 1], centre[0] * R[r, 0].float())) + t[r].float())
            for r in range(3)
        )
        zc = torch.clamp(z, min=1e-6)
        fx, fy, cx, cy = intr_t[f].unbind()
        u = _fma(x / zc, fx, cx)
        v = _fma(y / zc, fy, cy)
        del x, y
        # clamped before the cast: out-of-view voxels get weight 0, and a
        # far-off u would not fit the integer type
        ui = torch.round(u).clamp_(0, Wd - 1).to(torch.int64)
        vi = torch.round(v).clamp_(0, Hd - 1).to(torch.int64)
        in_view = (z > 1e-3) & (u >= 0) & (u <= Wd - 1) & (v >= 0) & (v <= Hd - 1)
        # mm → m as XLA compiles the reference's division by the constant
        # 1000: a product with the f32 reciprocal
        d = depth_t[f].reshape(-1)[vi * Wd + ui] * milli
        sdf = d - z
        w = (in_view & (d > 1e-4) & (sdf > -trunc_t)).to(torch.float32)
        t_sdf = torch.clamp(sdf / trunc_t, -1.0, 1.0)
        tsdf_sum += w * t_sdf
        w_sum += w
    return torch.where(w_sum > 0, tsdf_sum / torch.clamp(w_sum, min=1e-6),
                       torch.tensor(float("nan"), **f32))


def mesh_scan(scan, voxel: float = 0.04, device: str | torch.device = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """Scan → TSDF fused on ``device`` → triangle mesh ((V, 3), (F, 3))."""
    field, origin, voxel = tsdf_from_scan(scan, voxel, device=device)
    return marching_tetrahedra(field, 0.0, origin, voxel)
