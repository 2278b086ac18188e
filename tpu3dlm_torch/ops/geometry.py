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


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3×3 rotation → (qx, qy, qz, qw): the four-branch construction, every
    branch computed and the one with the largest pivot selected."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    sw = safe_sqrt(tr + 1.0) * 2.0
    qw_b = torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, 0.25 * sw])
    sx = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    qx_b = torch.stack([0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx])
    sy = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    qy_b = torch.stack([(m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy, (m02 - m20) / sy])
    sz = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    qz_b = torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz, (m10 - m01) / sz])

    use_w = tr > 0.0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)
    q = torch.where(use_w, qw_b, torch.where(use_x, qx_b, torch.where(use_y, qy_b, qz_b)))
    return q / torch.linalg.vector_norm(q)


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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """3×3 rotation → axis-angle 3-vector (|ω| = angle), over the whole
    range: near π (θ > 3) the skew part vanishes, so the axis comes from
    the dominant column of (R + Rᵀ)/2 − cos θ·I = (1 − cos θ)·uuᵀ, its sign
    from the skew part."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    # the trace summed left to right, as XLA sums it: near π, θ = acos(·)
    # magnifies one ulp of it about 1/sin θ times
    cos_theta = torch.clamp(((R[0, 0] + R[1, 1] + R[2, 2]) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    scale = torch.where(theta < 1e-6, 0.5, theta / (2.0 * torch.sin(torch.clamp(theta, min=1e-12))))
    generic = w * scale
    N = 0.5 * (R + R.T) - cos_theta * eye
    col = N[:, torch.argmax(torch.linalg.vector_norm(N, dim=0))]
    axis = col / torch.clamp(torch.linalg.vector_norm(col), min=1e-12)
    axis = axis * torch.where(torch.dot(axis, w) < 0.0, -1.0, 1.0)
    return torch.where(theta > 3.0, axis * theta, generic)


def _se3_V(om: torch.Tensor) -> torch.Tensor:
    """The V matrix of the SE(3) logarithm (t = V·ρ), with the series
    values below 1e-6 rad."""
    th = torch.linalg.vector_norm(om)
    safe = torch.clamp(th, min=1e-12)
    K = skew(om / safe)
    small = th < 1e-6
    A = torch.where(small, 0.5, (1 - torch.cos(th)) / safe**2)
    B = torch.where(small, 1.0 / 6.0, (th - torch.sin(th)) / safe**3)
    return torch.eye(3, dtype=om.dtype, device=om.device) + A * (K * safe) + B * ((K @ K) * safe**2)


def se3_interpolate(T: torch.Tensor, alpha) -> torch.Tensor:
    """T^α of a 4×4 rigid transform (geodesic interpolation): ω and
    ρ = V(ω)⁻¹t scaled by α, then mapped back."""
    omega = so3_log(T[:3, :3])
    rho = torch.linalg.solve(_se3_V(omega), T[:3, 3])
    om_a = omega * alpha
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = so3_exp(om_a)
    out[:3, 3] = _se3_V(om_a) @ (rho * alpha)
    return out


def bbox_region_mask(bbox: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(height, width) mask of the pixels inside [x1, y1, x2, y2], the
    corners floored and ceiled outward (inclusive)."""
    ys = torch.arange(height, dtype=torch.float32, device=bbox.device)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=bbox.device)[None, :]
    x1 = torch.floor(torch.minimum(bbox[0], bbox[2]))
    x2 = torch.ceil(torch.maximum(bbox[0], bbox[2]))
    y1 = torch.floor(torch.minimum(bbox[1], bbox[3]))
    y2 = torch.ceil(torch.maximum(bbox[1], bbox[3]))
    return (xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)


def bbox_median_depth(depth: torch.Tensor, bbox: torch.Tensor,
                      min_depth: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact median of the depth values above ``min_depth`` inside one box
    of an (H, W) map → (median, valid); one sort of the whole map (the
    projection uses ``bbox_sampled_median_depth``)."""
    h, w = depth.shape
    mask = bbox_region_mask(bbox, h, w) & (depth > min_depth)
    return masked_median(depth.reshape(-1), mask.reshape(-1))


def unproject(px, py, z, fx, fy, cx, cy) -> torch.Tensor:
    """Pixel (px, py) at depth z → camera-frame (..., 3) points."""
    X = (px - cx) * z / fx
    Y = (py - cy) * z / fy
    return torch.stack([X, Y, z.expand_as(X)], -1)
