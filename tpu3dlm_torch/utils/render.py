"""Shaded mesh renderer in numpy on the host (port of
``tpu3dlm/utils/render.py``, which renders on the host too).

Lambert-shaded triangles are sampled on a barycentric lattice and splatted
back to front (the painter's algorithm): marching-tetrahedra triangles are
about a voxel across, so lattice samples at 2×2 px cover the surface, and
one global depth sort over every mesh of the scene gives the mutual
occlusion. The numpy calls and their order are the reference's:
``np.argsort(-z)`` is not a stable sort and samples on shared vertices tie
in z, so only the same calls resolve the ties the same way and give the
same frames byte for byte.
"""

from __future__ import annotations

import numpy as np


def look_at(eye: np.ndarray, center: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """4×4 world→camera matrix looking from eye at center.

    Default up is -y (the capture convention: +y points down in camera
    frames throughout the pipeline)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    f = center - eye
    f = f / (np.linalg.norm(f) + 1e-12)
    u = np.asarray(up, np.float32)
    r = np.cross(f, u)
    if np.linalg.norm(r) < 1e-6:
        # view direction parallel to up (e.g. orbit elevation ±90°): the
        # cross product vanishes and the view matrix would be rank-1 —
        # fall back to any axis not parallel to the view direction
        u = (
            np.array([1.0, 0.0, 0.0], np.float32)
            if abs(f[0]) < 0.9
            else np.array([0.0, 0.0, 1.0], np.float32)
        )
        r = np.cross(f, u)
    r = r / (np.linalg.norm(r) + 1e-12)
    d = np.cross(f, r)  # camera "down" completing the right-handed frame
    R = np.stack([r, d, f])  # rows: right, down, forward
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = -R @ eye
    return T


def _bary_lattice(level: int) -> np.ndarray:
    """(K, 3) barycentric sample weights on a triangular lattice."""
    pts = []
    for i in range(level + 1):
        for j in range(level + 1 - i):
            k = level - i - j
            pts.append((i / level, j / level, k / level))
    return np.asarray(pts, np.float32)


def render_mesh(
    verts: np.ndarray,  # (V, 3) world
    faces: np.ndarray,  # (F, 3) int
    base_colors: np.ndarray,  # (F, 3) float [0,1] per-face albedo
    view: np.ndarray,  # (4, 4) world→camera (look_at)
    image_hw: tuple[int, int] = (480, 640),
    focal: float | None = None,  # px; default frames the scene
    light_dir=(0.3, -0.5, -0.8),
    background: int = 255,
    lattice_level: int = 3,
    splat: int = 2,
) -> np.ndarray:
    """Render triangles → (H, W, 3) uint8 image."""
    h, w = image_hw
    canvas = np.full((h, w, 3), background, np.uint8)
    if len(faces) == 0:
        return canvas
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)

    cam = verts @ view[:3, :3].T + view[:3, 3]
    tri = cam[faces]  # (F, 3, 3) camera-space triangles

    # Lambert shade from camera-space normals (double-sided: tet-mesh
    # orientation is not guaranteed)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-12)
    ld = np.asarray(light_dir, np.float32)
    ld = ld / np.linalg.norm(ld)
    lam = np.abs(n @ ld)
    shade = (0.35 + 0.65 * lam)[:, None] * np.asarray(base_colors, np.float32)

    if focal is None:
        # frame the scene by the ANGULAR extent of the in-front vertices:
        # max(|xy|/z) is the widest ray the image must contain (vertices at
        # or behind the camera plane take no part)
        zf = tri[..., 2].reshape(-1)
        xy = np.abs(tri[..., :2]).reshape(-1, 2).max(axis=1)
        front = zf > 1e-3
        if front.any():
            ratio = float((xy[front] / zf[front]).max()) + 1e-6
            focal = 0.45 * min(h, w) / ratio
        else:
            focal = float(min(h, w))

    bw = _bary_lattice(lattice_level)  # (K, 3)
    samples = np.einsum("kj,fjc->fkc", bw, tri).reshape(-1, 3)  # (F*K, 3)
    colors = np.repeat(shade, bw.shape[0], axis=0)

    z = samples[:, 2]
    ok = z > 1e-3
    samples, colors, z = samples[ok], colors[ok], z[ok]
    u = (samples[:, 0] / z * focal + w / 2).astype(np.int32)
    v = (samples[:, 1] / z * focal + h / 2).astype(np.int32)
    inside = (u >= 0) & (u < w - splat + 1) & (v >= 0) & (v < h - splat + 1)
    u, v, z, colors = u[inside], v[inside], z[inside], colors[inside]

    order = np.argsort(-z)  # back-to-front
    u, v = u[order], v[order]
    c8 = np.clip(colors[order] * 255.0, 0, 255).astype(np.uint8)
    # ONE assignment with every sample's splat offsets adjacent in the
    # back-to-front order, so a far sample's offsets never land after a
    # nearer sample's
    offs = np.array(
        [(dy, dx) for dy in range(splat) for dx in range(splat)], np.int32
    )
    K = len(offs)
    vv = np.repeat(v, K) + np.tile(offs[:, 0], len(v))
    uu = np.repeat(u, K) + np.tile(offs[:, 1], len(u))
    canvas[vv, uu] = np.repeat(c8, K, axis=0)
    return canvas


def render_scene(
    meshes: list[tuple[np.ndarray, np.ndarray, tuple[float, float, float]]],
    view: np.ndarray,
    image_hw: tuple[int, int] = (480, 640),
    **kwargs,
) -> np.ndarray:
    """Render several (verts, faces, color) meshes with correct mutual
    occlusion (one global depth sort)."""
    all_v, all_f, all_c = [], [], []
    off = 0
    for verts, faces, color in meshes:
        if len(faces) == 0:
            continue
        all_v.append(np.asarray(verts, np.float32))
        all_f.append(np.asarray(faces, np.int64) + off)
        all_c.append(np.tile(np.asarray(color, np.float32), (len(faces), 1)))
        off += len(verts)
    if not all_f:
        h, w = image_hw
        return np.full((h, w, 3), kwargs.get("background", 255), np.uint8)
    return render_mesh(
        np.concatenate(all_v),
        np.concatenate(all_f),
        np.concatenate(all_c),
        view,
        image_hw,
        **kwargs,
    )


def orbit_eye(center: np.ndarray, radius: float, azimuth: float, elevation: float = 0.35):
    """Camera position orbiting `center` at `azimuth` radians."""
    center = np.asarray(center, np.float32)
    return center + radius * np.array(
        [np.sin(azimuth) * np.cos(elevation),
         -np.sin(elevation),
         -np.cos(azimuth) * np.cos(elevation)],
        np.float32,
    )
