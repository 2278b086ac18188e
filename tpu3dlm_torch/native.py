"""ctypes bindings of the port's host C++ for normals and the map stage
(port of the normals, meshing and clustering part of
``tpu3dlm/native/__init__.py``).

``csrc/host/normals.cpp``, ``csrc/host/dbscan.cpp`` and
``csrc/host/meshing.cpp`` are copies of the JAX package's
``native/src/normals.cpp``, ``dbscan.cpp`` and ``poisson.cpp``; the same code
built with the same flags gives the same normals, labels, splats, meshes and
keep masks. Each library is built at first use by ``kernels/build.py``. The JAX
package returns ``None`` when its library is missing and falls back to
numpy; here a missing compiler or a failed build raises, and so does a
non-zero return code.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpu3dlm_torch.kernels.build import load_host_library

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64 = ctypes.c_int64
_dbl = ctypes.c_double


def _dbscan_lib() -> ctypes.CDLL:
    lib = load_host_library("dbscan")
    if not getattr(lib, "_typed", False):
        lib.tpu3dlm_dbscan.restype = ctypes.c_int
        lib.tpu3dlm_dbscan.argtypes = [_f32p, _i64, _dbl, ctypes.c_int, _i32p]
        lib._typed = True
    return lib


def _normals_lib() -> ctypes.CDLL:
    lib = load_host_library("normals")
    if not getattr(lib, "_typed", False):
        lib.tpu3dlm_grid_normals.restype = ctypes.c_int
        lib.tpu3dlm_grid_normals.argtypes = [_f32p, _i64, _dbl, _f32p, _f32p]
        lib._typed = True
    return lib


def _meshing_lib() -> ctypes.CDLL:
    lib = load_host_library("meshing")
    if not getattr(lib, "_typed", False):
        lib.tpu3dlm_march_tets.restype = ctypes.c_int
        lib.tpu3dlm_march_tets.argtypes = [
            _f32p, _i64, _i64, _i64, _dbl, ctypes.c_int, _f32p, _dbl, ctypes.c_int,
            ctypes.POINTER(_f32p), ctypes.POINTER(_i64), ctypes.POINTER(_i32p), ctypes.POINTER(_i64),
        ]
        lib.tpu3dlm_trilinear_splat.restype = ctypes.c_int
        lib.tpu3dlm_trilinear_splat.argtypes = [
            _f32p, _i64, _f32p, _i64, _f32p, _dbl, _i64, _i64, _i64, ctypes.POINTER(ctypes.c_double),
        ]
        lib.tpu3dlm_cull_leakage.restype = ctypes.c_int
        lib.tpu3dlm_cull_leakage.argtypes = [
            _f32p, _i32p, _i64, _f32p, _i64, _f32p, _dbl, _i64, _i64, _i64, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.tpu3dlm_free.restype = None
        lib.tpu3dlm_free.argtypes = [ctypes.c_void_p]
        lib._typed = True
    return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"tpu3dlm_torch: host {what} returned {rc}")


def grid_normals(points: np.ndarray, voxel: float, viewpoint=None) -> np.ndarray:
    """(N, 3) → (N, 3) float32 unit normals (``tpu3dlm_grid_normals``)."""
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    out = np.empty_like(pts)
    vp = None if viewpoint is None else np.ascontiguousarray(viewpoint, np.float32).reshape(3)
    rc = _normals_lib().tpu3dlm_grid_normals(
        _ptr(pts, _f32p), pts.shape[0], float(voxel), _f32p() if vp is None else _ptr(vp, _f32p),
        _ptr(out, _f32p))
    _check(rc, "grid_normals")
    return out


def dbscan(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """(N, 3) → (N,) int32 labels, -1 for noise (``tpu3dlm_dbscan``)."""
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    labels = np.empty(pts.shape[0], np.int32)
    # the return value is the cluster count, not a status
    _dbscan_lib().tpu3dlm_dbscan(_ptr(pts, _f32p), pts.shape[0], float(eps), int(min_points),
                                 _ptr(labels, _i32p))
    return labels


def march_tets(field: np.ndarray, iso: float, origin: np.ndarray, voxel: float, weld: bool,
               normals_toward_positive: bool) -> tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a 3-D float32 field → ((V, 3) float32, (F, 3) int32)."""
    lib = _meshing_lib()
    f = np.ascontiguousarray(field, np.float32)
    if f.ndim != 3:
        raise ValueError(f"march_tets needs a 3-D field, got shape {f.shape}")
    org = np.ascontiguousarray(origin, np.float32).reshape(3)
    verts_p, faces_p = _f32p(), _i32p()
    nv, nf = _i64(), _i64()
    rc = lib.tpu3dlm_march_tets(
        _ptr(f, _f32p), f.shape[0], f.shape[1], f.shape[2], float(iso),
        int(bool(normals_toward_positive)), _ptr(org, _f32p), float(voxel), int(bool(weld)),
        ctypes.byref(verts_p), ctypes.byref(nv), ctypes.byref(faces_p), ctypes.byref(nf),
    )
    try:
        _check(rc, "march_tets")
        verts = (np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy() if nv.value
                 else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(faces_p, shape=(nf.value, 3)).copy() if nf.value
                 else np.zeros((0, 3), np.int32))
    finally:
        if nv.value:
            lib.tpu3dlm_free(verts_p)
        if nf.value:
            lib.tpu3dlm_free(faces_p)
    return verts.astype(np.float32), faces.astype(np.int32)


def trilinear_splat(points: np.ndarray, values: np.ndarray | None, lo: np.ndarray,
                    dims: tuple[int, int, int], voxel: float) -> np.ndarray:
    """Trilinear scatter with f64 accumulation and border clamp → (Nx, Ny,
    Nz) float32 for unit mass, (Nx, Ny, Nz, C) for (N, C) values."""
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    nx, ny, nz = (int(d) for d in dims)
    scalar = values is None
    channels = 1 if scalar else int(values.shape[1])
    vals = None if scalar else np.ascontiguousarray(values, np.float32)
    if vals is not None and vals.shape[0] != pts.shape[0]:
        raise ValueError(f"{vals.shape[0]} values for {pts.shape[0]} points")
    accum = np.zeros((nx * ny * nz, channels), np.float64)
    lo32 = np.ascontiguousarray(lo, np.float32).reshape(3)
    rc = _meshing_lib().tpu3dlm_trilinear_splat(
        _ptr(pts, _f32p), pts.shape[0], _f32p() if scalar else _ptr(vals, _f32p), channels,
        _ptr(lo32, _f32p), float(voxel), nx, ny, nz, _ptr(accum, ctypes.POINTER(ctypes.c_double)),
    )
    _check(rc, "trilinear_splat")
    shaped = accum.reshape(nx, ny, nz, channels).astype(np.float32)
    return shaped[..., 0] if scalar else shaped


def cull_keep_mask(verts: np.ndarray, faces: np.ndarray, points: np.ndarray, origin: np.ndarray,
                   cell: float, span_cells) -> np.ndarray:
    """Per-face keep mask: centroid inside the 1-cell dilation of the
    cloud's occupancy grid (``tpu3dlm_cull_leakage``)."""
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    p = np.ascontiguousarray(points, np.float32)
    org = np.ascontiguousarray(origin, np.float32).reshape(3)
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("face index out of range")
    keep = np.empty(len(f), np.uint8)
    rc = _meshing_lib().tpu3dlm_cull_leakage(
        _ptr(v, _f32p), _ptr(f, _i32p), len(f), _ptr(p, _f32p), len(p), _ptr(org, _f32p), float(cell),
        int(span_cells[0]), int(span_cells[1]), int(span_cells[2]),
        _ptr(keep, ctypes.POINTER(ctypes.c_uint8)),
    )
    _check(rc, "cull_leakage")
    return keep.astype(bool)
