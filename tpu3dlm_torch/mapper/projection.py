"""2D→3D box projection (port of ``tpu3dlm/mapper/projection.py``).

Each box becomes four world-frame corners: intrinsics and box are scaled
from RGB to depth resolution, all four corners share one z (the sampled
median depth over the box, mm → m), and the camera-frame corners go to the
world through the pose. The JAX package vmaps a per-box function over boxes
and frames; ``project_boxes`` writes both axes out as leading dimensions.
``frame_view_geometry`` gives the geometry of the reference's live 3D view
of one frame (its cloud, boxes and camera frustum).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from tpu3dlm_torch.data.scan import to_numpy
from tpu3dlm_torch.device import as_device_tensor
from tpu3dlm_torch.ops import geometry as G


@dataclasses.dataclass
class GlobalBoxes:
    """Padded per-frame global 3D boxes (4 planar corners each)."""

    corners: Any  # (F, B, 4, 3) float32 — world-frame quad corners
    damage: Any  # (F, B) int32
    conf: Any  # (F, B) float32
    label: Any  # (F, B) int32
    mask: Any  # (F, B) bool — valid box AND valid median depth

    def to_frame_dict(self) -> dict[int, list[list]]:
        """{frame: [[c0, c1, c2, c3, damage, conf, label]]}, each corner a
        length-3 array — the reference's 3D record shape."""
        corners, damage, conf, label, mask = (
            to_numpy(a)
            for a in (self.corners, self.damage, self.conf, self.label, self.mask)
        )
        out: dict[int, list[list]] = {}
        for f in range(corners.shape[0]):
            rows = []
            for b in range(corners.shape[1]):
                if mask[f, b]:
                    rows.append(
                        [corners[f, b, i] for i in range(4)]
                        + [int(damage[f, b]), float(conf[f, b]), int(label[f, b])]
                    )
            out[f] = rows
        return out


def project_boxes(
    boxes: torch.Tensor,  # (F, B, 4) RGB pixels
    box_mask: torch.Tensor,  # (F, B) bool
    depth: torch.Tensor,  # (F, Hd, Wd) mm
    intrinsics: torch.Tensor,  # (F, 4) fx, fy, cx, cy at RGB resolution
    rgb_size: torch.Tensor,  # (F, 2) width, height
    poses: torch.Tensor,  # (F, 7)
    scale_depth: float = 1000.0,
    median_samples: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All frames × boxes → ((F, B, 4, 3) world corners, (F, B) valid).

    ``median_samples`` is the side of the depth-median grid; the library
    default is 32 as in the reference, the serving step passes 16.
    """
    boxes = boxes.float()
    depth = depth.float()
    intrinsics = intrinsics.float()
    rgb_size = rgb_size.float()
    poses = poses.float()
    hd, wd = depth.shape[1], depth.shape[2]
    depth_wh = as_device_tensor([wd, hd], depth.device, torch.float32)

    fx, fy, cx, cy = G.scale_intrinsics(
        intrinsics[:, 0], intrinsics[:, 1], intrinsics[:, 2], intrinsics[:, 3],
        rgb_size[:, 0], depth_wh[0],
    )  # each (F,)
    scaled = G.scale_bbox(boxes, rgb_size[:, None, :], depth_wh)  # (F, B, 4)
    z_mm, z_valid = G.bbox_sampled_median_depth(depth, scaled, samples=median_samples)
    z = z_mm / scale_depth  # (F, B) metres

    corners = G.bbox_corners_2d(scaled)  # (F, B, 4, 2)
    col = lambda a: a[:, None, None]  # noqa: E731 — (F,) → (F, 1, 1)
    cam = G.unproject(
        corners[..., 0], corners[..., 1], z[..., None],
        col(fx), col(fy), col(cx), col(cy),
    )  # (F, B, 4, 3)
    T = G.pose_to_matrix(poses)  # (F, 4, 4)
    world = G.transform_points(T[:, None], cam)
    return world, box_mask & z_valid


def project_detections(scan, det, scale_depth: float = 1000.0, median_samples: int = 16,
                       device: str | torch.device = "cuda") -> GlobalBoxes:
    """Scan + 2D Detections → GlobalBoxes (world-frame quads) on ``device``,
    host arrays back: the staged route's projection and the Pipeline's
    resume path. The frame axis is padded to a bucket as in the reference
    (padded frames carry ``mask=False`` and zero depth)."""
    import numpy as np

    from tpu3dlm_torch.device import resolve_device
    from tpu3dlm_torch.utils.shapes import next_bucket, pad_axis0, pad_poses

    dev = resolve_device(device)
    F = int(np.asarray(det.mask).shape[0])
    Fb = next_bucket(F)
    up = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), device=dev).to(dtype)  # noqa: E731
    corners, mask = project_boxes(
        up(pad_axis0(det.boxes, Fb)),
        up(pad_axis0(det.mask, Fb, fill=False), torch.bool),
        up(pad_axis0(scan.depth, Fb)),
        up(pad_axis0(scan.intrinsics, Fb, fill=1)),
        up(pad_axis0(scan.rgb_size, Fb, fill=1)),
        up(pad_poses(scan.poses, Fb)),
        scale_depth=scale_depth,
        median_samples=median_samples,
    )
    return GlobalBoxes(
        corners=to_numpy(corners)[:F],
        damage=np.asarray(det.damage),
        conf=np.asarray(det.conf),
        label=np.asarray(det.label),
        mask=to_numpy(mask)[:F],
    )


def frame_view_geometry(scan, gboxes: GlobalBoxes, frame_index: int, depth_buffer: float = 0.03,
                        frustum_depth: float = 0.3, device: str | torch.device = "cuda") -> dict:
    """The geometry of the reference's live 3D view of one frame during
    projection, as host arrays:

      * ``cloud_points`` (N, 3): the frame's depth map unprojected to the
        world on ``device`` (valid pixels only);
      * ``boxes``: an (8, 3) box extruded by ``depth_buffer`` for each valid
        projected box of the frame;
      * ``frustum``: {points (5, 3), lines} of the camera frustum at the
        pose (``Visualiser._overlay_camera_frustum``).
    """
    import numpy as np

    from tpu3dlm_torch.device import resolve_device
    from tpu3dlm_torch.ops.pointcloud import depth_to_points
    from tpu3dlm_torch.utils.visualisation import Visualiser

    dev = resolve_device(device)
    depth = as_device_tensor(np.asarray(to_numpy(scan.depth)[frame_index], np.float32), dev)
    wh = np.asarray(to_numpy(scan.rgb_size), np.float32)[frame_index]
    fx, fy, cx, cy = np.asarray(to_numpy(scan.intrinsics), np.float32)[frame_index]
    fx_d, fy_d, cx_d, cy_d = G.scale_intrinsics(fx, fy, cx, cy, wh[0], depth.shape[1])
    pose = as_device_tensor(np.asarray(to_numpy(scan.poses), np.float32)[frame_index], dev)

    pts, valid = depth_to_points(depth, float(fx_d), float(fy_d), float(cx_d), float(cy_d), pose=pose)
    cloud = to_numpy(pts[valid])

    mask = to_numpy(gboxes.mask)[frame_index]
    boxes = []
    if mask.any():
        quads = as_device_tensor(np.asarray(to_numpy(gboxes.corners), np.float32)[frame_index][mask], dev)
        boxes = list(to_numpy(G.create_3d_bounding_box(quads, depth_buffer)))

    T = to_numpy(G.pose_to_matrix(pose))
    frustum = Visualiser()._overlay_camera_frustum(
        T[:3, 3], T[:3, :3], fx_d, fy_d, depth.shape[1], depth.shape[0], depth=frustum_depth,
    )
    return {"cloud_points": cloud, "boxes": boxes, "frustum": frustum}
