"""Visualiser kit (port of ``tpu3dlm/utils/visualisation.py``).

The analysis helpers (image parsing, RGB-D assembly, point-cloud
generation, box, pose and frustum geometry) are the reference's numpy. The
reference draws with Open3D when it imports and otherwise returns plain
``{points, lines, color}`` dicts; the port has no Open3D, so every overlay
takes that second branch, and ``display_imgs`` logs "display unavailable"
as the reference does without cv2.
"""

from __future__ import annotations

import logging

import numpy as np

_BOX_EDGES = [
    [0, 1], [1, 2], [2, 3], [3, 0],
    [4, 5], [5, 6], [6, 7], [7, 4],
    [0, 4], [1, 5], [2, 6], [3, 7],
]


class Visualiser:
    def __init__(self):
        self.logger = logging.getLogger(__name__)

    # -- analysis-side helpers ---------------------------------------------

    def parse_images(self, rgb_tensor, depth_tensor):
        """Model tensors → numpy images: (H, W, 3) uint8 or float arrays, or
        channel-first (3, H, W); floats in [0, 1] become uint8."""
        rgb = np.asarray(rgb_tensor)
        if rgb.ndim == 3 and rgb.shape[0] in (1, 3) and rgb.shape[-1] not in (1, 3):
            rgb = np.moveaxis(rgb, 0, -1)
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        depth = np.asarray(depth_tensor, np.float32)
        return rgb, depth

    def gen_rgbd(self, rgb_image, depth_image, scale_depth: float = 1000.0):
        """→ (rgb uint8, depth float32 metres), the "RGBD image"."""
        rgb, depth = self.parse_images(rgb_image, depth_image)
        return rgb, depth / scale_depth

    def gen_point_cloud(self, rgbd, intrinsics: dict, extrinsics: np.ndarray):
        """RGBD + intrinsics + world→camera extrinsics → (N, 3) world points
        and (N, 3) colours of the valid-depth pixels (colours None when the
        image and the depth differ in size)."""
        rgb, depth_m = rgbd
        h, w = depth_m.shape
        fx, fy, cx, cy = intrinsics["fx"], intrinsics["fy"], intrinsics["cx"], intrinsics["cy"]
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        z = depth_m
        X = (xs - cx) * z / fx
        Y = (ys - cy) * z / fy
        pts_cam = np.stack([X, Y, z], axis=-1).reshape(-1, 3)
        valid = (z > 1e-6).reshape(-1)
        T = np.linalg.inv(np.asarray(extrinsics))  # camera→world
        pts = pts_cam @ T[:3, :3].T + T[:3, 3]
        cols = None
        if rgb.shape[:2] == depth_m.shape:
            cols = rgb.reshape(-1, 3)[valid] / 255.0
        return pts[valid], cols

    def overlay_3d_bbox(self, corners8: np.ndarray, color_rgb) -> dict:
        """8-corner box → {points, lines, color} line set."""
        corners8 = np.asarray(corners8, np.float64)
        return {"points": corners8, "lines": list(_BOX_EDGES), "color": list(color_rgb)}

    def overlay_pose(self, pose_df) -> dict:
        """Trajectory positions of a pose table (``PoseFrame`` or DataFrame)
        or an (F, ≥3) array as a point set, {points}."""
        if hasattr(pose_df, "columns"):
            return {"points": pose_df[["tx", "ty", "tz"]].to_numpy()}
        return {"points": np.asarray(pose_df)[:, :3]}

    def overlay_pose_directions(self, points, directions, length: float = 0.2) -> dict:
        """Camera direction rays of ``length`` from each pose position,
        {points, lines}."""
        pts = np.asarray(points)
        if not isinstance(pts, np.ndarray) or pts.dtype == object:
            pts = np.asarray(list(points))
        dirs = np.asarray(directions)
        ends = pts + dirs * length
        allpts = np.concatenate([pts, ends])
        lines = [[i, i + len(pts)] for i in range(len(pts))]
        return {"points": allpts, "lines": lines}

    def _overlay_camera_frustum(self, t, R, fx, fy, width, height, depth: float = 0.3) -> dict:
        """Frustum lines of a camera at (t, R): the centre and the image
        corners' rays at ``depth``, {points (5, 3), lines}."""
        corners_px = np.array([[0, 0], [width, 0], [width, height], [0, height]], np.float32)
        cx, cy = width / 2.0, height / 2.0
        rays = np.stack(
            [(corners_px[:, 0] - cx) / fx, (corners_px[:, 1] - cy) / fy, np.ones(4, np.float32)],
            axis=1,
        ) * depth
        world = rays @ np.asarray(R).T + np.asarray(t)
        pts = np.concatenate([[np.asarray(t)], world])
        lines = [[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]]
        return {"points": pts, "lines": lines}

    def display_imgs(self, rgb, depth, bboxes=None, frame_index=None) -> None:
        """The reference shows the frame in a cv2 window; the port has no
        window toolkit, so it logs what the reference logs without one."""
        self.logger.warning("display unavailable: %s", "no window toolkit in tpu3dlm_torch (cv2 is not used)")
