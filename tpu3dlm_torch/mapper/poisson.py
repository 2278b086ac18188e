"""Poisson surface reconstruction by an FFT spectral solve (port of
``tpu3dlm/mapper/poisson.py``).

1. **Normal splat** (host C++): each point's unit normal, negated (∇χ
   points from free space into the solid), is spread trilinearly over a
   regular grid → V ≈ ∇χ.
2. **Spectral solve** (``device``): ∇²χ = ∇·V with ``torch.fft.rfftn`` /
   ``irfftn``. Divergence and Laplacian use the central-difference symbol
   i·sin(2πk/N)/h; the modes where it vanishes are zeroed, and a Gaussian
   low-pass exp(−σ²|k|²/2) smooths. V goes to the device rounded to bf16 and
   is widened to f32 there, as in the JAX package; the rounding is part of
   the result on every device.
3. **Iso-extraction** (host): χ sampled trilinearly at ≤ 200k of the points,
   their mean the iso value; marching tetrahedra with the interior on the
   χ > iso side, then a cull of faces far from every point (the periodic
   solve's wraparound leakage).

Each grid axis rounds up to a 5-smooth length, and the ``max_voxels``
ladder of ``grid_bounds`` coarsens the voxel to bound memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu3dlm_torch import native
from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.mapper.meshing import grid_bounds, marching_tetrahedra, trilinear_sample, trilinear_scatter


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth (2^a·3^b·5^c) integer ≥ n."""
    if n <= 2:
        return max(n, 1)
    best = 1 << (n - 1).bit_length()  # pow2 upper bound
    f5 = 1
    while f5 < best:
        f35 = f5
        while f35 < best:
            quot = -(-n // f35)  # ceil(n / f35)
            p2 = 1 << max(0, (quot - 1).bit_length())
            best = min(best, f35 * p2)
            f35 *= 3
        f5 *= 5
    return best


def _solve_indicator(V: torch.Tensor, *, voxel: float, sigma_voxels: float) -> torch.Tensor:
    """∇²χ = ∇·V solved spectrally on V's device; V is (Nx, Ny, Nz, 3) f32."""
    nx, ny, nz = V.shape[:3]
    f32 = dict(dtype=torch.float32, device=V.device)
    h = torch.tensor(voxel, **f32)
    # central-difference derivative symbol per axis: i·sin(2πk/N)/h (the
    # last axis keeps the half spectrum of rfftn)
    kx = torch.fft.fftfreq(nx, **f32)
    ky = torch.fft.fftfreq(ny, **f32)
    kz = torch.fft.rfftfreq(nz, **f32)
    sx = torch.sin(2 * math.pi * kx)[:, None, None] / h
    sy = torch.sin(2 * math.pi * ky)[None, :, None] / h
    sz = torch.sin(2 * math.pi * kz)[None, None, :] / h

    div = 1j * (
        sx * torch.fft.rfftn(V[..., 0])
        + sy * torch.fft.rfftn(V[..., 1])
        + sz * torch.fft.rfftn(V[..., 2])
    )
    lam = -(sx * sx + sy * sy + sz * sz)  # div∘grad symbol (≤ 0)

    # Gaussian low-pass on the continuum |k|² (no zeros at Nyquist)
    w2 = (
        (2 * math.pi * kx[:, None, None] / h) ** 2
        + (2 * math.pi * ky[None, :, None] / h) ** 2
        + (2 * math.pi * kz[None, None, :] / h) ** 2
    )
    smooth = torch.exp(-0.5 * (sigma_voxels * voxel) ** 2 * w2)

    safe = torch.abs(lam) > torch.tensor(1e-12, **f32) / (h * h)
    chi_hat = torch.where(safe, div * smooth / torch.where(safe, lam, torch.ones_like(lam)), 0.0)
    return torch.fft.irfftn(chi_hat, s=(nx, ny, nz)).to(torch.float32)


def poisson_indicator(
    points: np.ndarray,
    normals: np.ndarray | None = None,
    voxel: float = 0.04,
    pad: int = 6,
    sigma_voxels: float = 1.5,
    max_voxels: int = 40_000_000,
    viewpoint: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray, float, float]:
    """Cloud (+ optional oriented normals) → (χ field, origin, voxel, iso),
    the solve on ``device``.

    ``normals`` point away from the solid (toward the sensor); when None
    they are grid-PCA estimates (``ops/pointcloud.py``, cells of
    max(2·voxel, 0.08)) turned toward ``viewpoint`` (default: the cloud's
    centroid). The interior is the χ > iso side.
    """
    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    if pts.shape[0] == 0:
        return np.zeros((2, 2, 2), np.float32), np.zeros(3, np.float32), voxel, 0.0
    if normals is None:
        from tpu3dlm_torch.ops.pointcloud import estimate_normals_grid

        vp = np.asarray(viewpoint, np.float32) if viewpoint is not None else pts.mean(axis=0)
        normals = estimate_normals_grid(pts, voxel=max(2.0 * voxel, 0.08), viewpoint=vp)
    normals = np.asarray(normals, np.float32)

    # the pad, in voxels, keeps surface mass away from the periodic boundary
    lo, dims, voxel = grid_bounds(pts, voxel, pad=pad, max_voxels=max_voxels, fast_len=next_fast_len,
                                  min_dim=4)
    V = trilinear_scatter(pts, -normals, lo, dims, voxel)
    # to the device in bf16 (half the bytes), widened to f32 there
    Vd = torch.from_numpy(V).to(torch.bfloat16).to(dev).to(torch.float32)
    del V
    chi = _solve_indicator(Vd, voxel=voxel, sigma_voxels=sigma_voxels).cpu().numpy()
    # Kazhdan's iso rule: the mean of χ at the input points, on ≤ 200k
    # evenly strided points
    step = max(1, pts.shape[0] // 200_000)
    sub = pts[::step]
    iso = float(np.mean(trilinear_sample(chi, (sub - lo) / voxel)))
    return chi, lo.astype(np.float32), voxel, iso


def _cull_leakage(
    verts: np.ndarray,
    faces: np.ndarray,
    points: np.ndarray,
    origin: np.ndarray,
    cell: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Drop triangles whose centroid lies outside the 1-cell dilation of the
    cloud's occupancy grid (host C++), then drop unused vertices."""
    if len(faces) == 0:
        return verts, faces
    span_cells = np.maximum(2, np.ceil((points.max(axis=0) - origin) / cell).astype(np.int64) + 2)
    keep = native.cull_keep_mask(verts, faces, points, origin, cell, span_cells)
    faces = faces[keep]
    used_mask = np.zeros(len(verts), bool)
    used_mask[faces] = True
    remap = np.cumsum(used_mask, dtype=np.int64) - 1
    return verts[used_mask], remap[faces].astype(np.int32)


def mesh_poisson(
    points: np.ndarray,
    normals: np.ndarray | None = None,
    voxel: float = 0.04,
    viewpoint: np.ndarray | None = None,
    sigma_voxels: float = 1.5,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Poisson-reconstruct a cloud → ((V, 3) verts, (F, 3) faces): a smooth,
    single-layer surface, the solve on ``device``."""
    pts = np.asarray(points, np.float32)
    chi, origin, voxel, iso = poisson_indicator(
        pts, normals, voxel=voxel, viewpoint=viewpoint, sigma_voxels=sigma_voxels, device=device
    )
    if not np.isfinite(chi).all() or chi.max() <= chi.min():
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    # interior is χ > iso → outward face normals toward the χ < iso side
    verts, faces = marching_tetrahedra(chi, iso, origin, voxel, normals_toward_positive=False)
    # 2-voxel cells + a 1-cell dilation keep the rim of open sheets within
    # ~3 voxels of the samples
    return _cull_leakage(verts, faces, pts, origin, cell=2.0 * voxel)
