"""2D→3D box projection (port of ``tpu3dlm/mapper/projection.py``).

Each box becomes four world-frame corners: intrinsics and box are scaled
from RGB to depth resolution, all four corners share one z (the sampled
median depth over the box, mm → m), and the camera-frame corners go to the
world through the pose. The JAX package vmaps a per-box function over boxes
and frames; ``project_boxes`` writes both axes out as leading dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from tpu3dlm_torch.data.scan import to_numpy
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
    depth_wh = torch.tensor([wd, hd], dtype=torch.float32, device=depth.device)

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
