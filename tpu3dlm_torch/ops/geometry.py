"""Geometry core for projection, 3D NMS, ICP and the map stage (port of the
parts of ``tpu3dlm/ops/geometry.py`` that those stages use).

Every function is batched over leading axes: where the JAX package vmaps a
per-box function, these take the frame and box axes as leading dimensions.

Conventions: pose row ``[tx, ty, tz, qx, qy, qz, qw]``; ``pose_to_matrix``
is camera→world; 2D boxes are ``[x1, y1, x2, y2]`` pixels; depth is mm.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (qx, qy, qz, qw) → (..., 3, 3); normalises the quaternion."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ]
    return torch.stack(rows, -2)


def pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """(..., 7) [tx,ty,tz,qx,qy,qz,qw] → (..., 4, 4) camera→world SE(3)."""
    T = torch.zeros(pose.shape[:-1] + (4, 4), dtype=pose.dtype, device=pose.device)
    T[..., :3, :3] = quat_to_rotmat(pose[..., 3:7])
    T[..., :3, 3] = pose[..., :3]
    T[..., 3, 3] = 1.0
    return T


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) SE(3) matrices: [Rᵀ, −Rᵀt]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    Ti = torch.zeros_like(T)
    Ti[..., :3, :3] = Rt
    Ti[..., :3, 3] = -(Rt @ T[..., :3, 3:4])[..., 0]
    Ti[..., 3, 3] = 1.0
    return Ti


def camera_direction(pose: torch.Tensor, forward: torch.Tensor | None = None) -> torch.Tensor:
    """(..., 7) poses → (..., 3) unit view directions (the rotated +Z axis,
    or ``forward``)."""
    if forward is None:
        forward = torch.tensor([0.0, 0.0, 1.0], dtype=pose.dtype, device=pose.device)
    return (quat_to_rotmat(pose[..., 3:7]) @ forward[:, None])[..., 0]


def create_3d_bounding_box(corners4: torch.Tensor, depth_buffer: float) -> torch.Tensor:
    """Planar (..., 4, 3) quads → (..., 8, 3) boxes extruded along each
    quad's normal: the corners − n·buffer, then + n·buffer."""
    v1 = corners4[..., 1, :] - corners4[..., 0, :]
    v2 = corners4[..., 3, :] - corners4[..., 0, :]
    n = torch.linalg.cross(v1, v2)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    n = n[..., None, :]
    return torch.cat([corners4 - n * depth_buffer, corners4 + n * depth_buffer], dim=-2)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., P, 3) points (full f32: the
    device module switches TF32 off)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def scale_bbox(bbox: torch.Tensor, from_wh: torch.Tensor, to_wh: torch.Tensor) -> torch.Tensor:
    """Rescale (..., 4) [x1,y1,x2,y2] between resolutions; ``from_wh`` and
    ``to_wh`` are (..., 2) width/height broadcastable against the boxes."""
    sx = to_wh[..., 0] / from_wh[..., 0]
    sy = to_wh[..., 1] / from_wh[..., 1]
    return bbox * torch.stack([sx, sy, sx, sy], -1)


def bbox_corners_2d(bbox: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x1,y1,x2,y2] → (..., 4, 2) corners TL, BL, BR, TR."""
    x1, y1, x2, y2 = bbox.unbind(-1)
    return torch.stack(
        [
            torch.stack([x1, y1], -1),
            torch.stack([x1, y2], -1),
            torch.stack([x2, y2], -1),
            torch.stack([x2, y1], -1),
        ],
        -2,
    )


def scale_intrinsics(fx, fy, cx, cy, rgb_width, depth_width):
    """Scale RGB-resolution intrinsics to depth resolution."""
    s = rgb_width / depth_width
    return fx / s, fy / s, cx / s, cy / s


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Median over the last axis where ``mask``, with numpy semantics (mean
    of the two middle elements for even counts). Returns (median, valid);
    an empty mask gives (0, False)."""
    n = mask.sum(-1)
    s = torch.sort(torch.where(mask, values, float("inf")), dim=-1).values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = (
        torch.gather(s, -1, lo[..., None])[..., 0]
        + torch.gather(s, -1, hi[..., None])[..., 0]
    ) * 0.5
    valid = n > 0
    return torch.where(valid, med, torch.zeros_like(med)), valid


def bbox_sampled_median_depth(
    depth: torch.Tensor,  # (F, Hd, Wd) mm
    bbox: torch.Tensor,  # (F, B, 4) in depth pixels
    samples: int = 32,
    min_depth: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Median depth over a cell-centred samples×samples grid inside each box
    → ((F, B) median, (F, B) valid).

    The JAX package selects the grid with one-hot matmuls (``geometry.py``
    345-350), a device for the TPU's matrix unit; here the same rounded
    coordinates index the depth map directly. The selected values are the
    same numbers, so the median is bit-identical.
    """
    F, hd, wd = depth.shape
    x1 = torch.minimum(bbox[..., 0], bbox[..., 2])
    x2 = torch.maximum(bbox[..., 0], bbox[..., 2])
    y1 = torch.minimum(bbox[..., 1], bbox[..., 3])
    y2 = torch.maximum(bbox[..., 1], bbox[..., 3])
    frac = (torch.arange(samples, dtype=torch.float32, device=depth.device) + 0.5) / samples
    xs = torch.clamp(torch.round(x1[..., None] + frac * (x2 - x1)[..., None]), 0.0, wd - 1.0)
    ys = torch.clamp(torch.round(y1[..., None] + frac * (y2 - y1)[..., None]), 0.0, hd - 1.0)
    xs, ys = xs.long(), ys.long()  # (F, B, S)
    f = torch.arange(F, device=depth.device)[:, None, None, None]
    vals = depth[f, ys[..., :, None], xs[..., None, :]]  # (F, B, S, S)
    vals = vals.reshape(vals.shape[:2] + (samples * samples,))
    return masked_median(vals, vals > min_depth)


def skew(k: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix [k]× of a 3-vector."""
    z = torch.zeros((), dtype=k.dtype, device=k.device)
    return torch.stack([
        torch.stack([z, -k[2], k[1]]),
        torch.stack([k[2], z, -k[0]]),
        torch.stack([-k[1], k[0], z]),
    ])


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Axis-angle 3-vector → 3×3 rotation (Rodrigues); identity below
    1e-8 rad, where the axis is undefined."""
    theta = torch.linalg.vector_norm(omega)
    K = skew(omega / torch.clamp(theta, min=1e-12))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    R = eye + torch.sin(theta) * K + (1 - torch.cos(theta)) * (K @ K)
    return torch.where(theta < 1e-8, eye, R)


def unproject(px, py, z, fx, fy, cx, cy) -> torch.Tensor:
    """Pixel (px, py) at depth z → camera-frame (..., 3) points."""
    X = (px - cx) * z / fx
    Y = (py - cy) * z / fy
    return torch.stack([X, Y, z.expand_as(X)], -1)
