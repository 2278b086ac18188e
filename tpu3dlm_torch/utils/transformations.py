"""Transforms: host-side numpy adapters over the port's geometry (port of
``tpu3dlm/utils/transformations.py``), so code written against the
reference's API drops in unchanged. Each call runs ``ops/geometry.py`` on
``device`` and returns numpy."""

from __future__ import annotations

import numpy as np
import torch

from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.ops import geometry as G


class Transforms:
    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def get_transformation_matrix(self, pose_data) -> np.ndarray:
        """[tx,ty,tz,qx,qy,qz,qw] → 4×4 camera→world."""
        return G.pose_to_matrix(self._t(pose_data)).cpu().numpy()

    def get_translation(self, pose_data) -> np.ndarray:
        return np.asarray(pose_data, np.float32)[:3]

    def get_rotation(self, pose_data) -> np.ndarray:
        return G.quat_to_rotmat(self._t(pose_data)[3:7]).cpu().numpy()

    def get_camera_direction(self, pose_df) -> np.ndarray:
        """(F, 3) unit view directions of a pose table (``PoseFrame``,
        DataFrame or (F, 7) array)."""
        poses = (
            pose_df[["tx", "ty", "tz", "qx", "qy", "qz", "qw"]].to_numpy()
            if hasattr(pose_df, "columns")
            else np.asarray(pose_df)
        )
        return G.camera_direction(self._t(poses)).cpu().numpy()

    def scale_bounding_box(self, bbox, from_wh, to_wh):
        return G.scale_bbox(self._t(bbox[:4]), self._t(from_wh), self._t(to_wh)).cpu().numpy().tolist() \
            + list(bbox[4:])

    def bbox_to_3d(self, scaled_bbox, img_size=None) -> np.ndarray:
        """[x1,y1,x2,y2,...] → the 4 corner (x, y) pixels."""
        return G.bbox_corners_2d(self._t(scaled_bbox[:4])).cpu().numpy()

    def _depth_to_3d(self, x, y, depth_img, fx, fy, cx, cy, scale_depth):
        """Corner pixel → camera-frame (X, Y, Z) at that pixel's depth."""
        z = float(np.asarray(depth_img)[int(y), int(x)]) / scale_depth
        return np.array([(x - cx) * z / fx, (y - cy) * z / fy, z], np.float32)

    def create_3d_bounding_box(self, corners4, depth_buffer) -> np.ndarray:
        quad = self._t(np.stack([np.asarray(c) for c in corners4]))
        return G.create_3d_bounding_box(quad, float(depth_buffer)).cpu().numpy()
