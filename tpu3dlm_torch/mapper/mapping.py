"""3D map assembly: cloud preprocessing, meshing and overlay geometry (port
of ``tpu3dlm/mapper/mapping.py``).

``Mapping`` loads ``cloud.ply``, keeps the largest DBSCAN cluster
(``preprocess``), and writes the cloud (``make_point_cloud``) or a triangle
mesh (``make_mesh``: the density shell, or the Poisson surface with normals
turned toward the camera trajectory's centroid, its FFT solve on
``device``). ``box_line_sets`` and ``overlay_geometry`` return the overlays
the reference draws (optimised boxes, raw boxes, camera positions and view
directions) as plain arrays. The JAX package also opens an interactive
Open3D window where Open3D imports; the port has no Open3D, so it takes
the reference's path without it: the same return values, no window.

    python -m tpu3dlm_torch.mapper.mapping --data gold_std --model mesh|pc [--device cuda|cpu]

meshes (or writes) the cloud of a scan the Pipeline has already run,
reading its pickle, into ``map_mesh.ply`` / ``map_pc.ply`` beside it.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tpu3dlm_torch.data.ply import load_ply, save_ply, save_ply_mesh
from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.mapper.clustering import largest_cluster
from tpu3dlm_torch.mapper.projection import GlobalBoxes
from tpu3dlm_torch.ops import geometry as G


def _boxes_iter(bboxes):
    """Yield (4, 3) corner quads from GlobalBoxes or frame-dict records."""
    if isinstance(bboxes, GlobalBoxes):
        bboxes = bboxes.to_frame_dict()
    for _, rows in sorted(bboxes.items()):
        for row in rows:
            yield np.stack([np.asarray(c, np.float32) for c in row[:4]])


class Mapping:
    def __init__(
        self,
        global_bboxes_data,
        optimised_bboxes,
        pose,
        eps: float = 0.04,
        min_points: int = 1000,
        ply_filepath: str = "cloud.ply",
        preprocess_point_cloud: bool = True,
        overlay_pose: bool = False,
        bbox_depth_buffer: float = 0.02,
        view_unprocessed_bboxes: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.global_bboxes_data = global_bboxes_data
        self.optimised_bboxes = optimised_bboxes
        self.pose = pose
        self.eps = eps
        self.min_points = min_points
        self.ply_filepath = ply_filepath
        self.preprocess_point_cloud = preprocess_point_cloud
        self.overlay_pose = overlay_pose
        self.bbox_depth_buffer = bbox_depth_buffer
        self.view_unprocessed_bboxes = view_unprocessed_bboxes
        self.logger = logging.getLogger(__name__)

        self.points, self.colors = load_ply(ply_filepath)

    # -- analysis ---------------------------------------------------------

    def preprocess(self) -> np.ndarray:
        """DBSCAN → keep the largest cluster; returns the kept indices."""
        idx = largest_cluster(self.points, self.eps, self.min_points)
        self.logger.info("DBSCAN kept %d/%d points (largest cluster)", len(idx), len(self.points))
        self.points = self.points[idx]
        if self.colors is not None:
            self.colors = self.colors[idx]
        return idx

    def make_point_cloud(self, output_path: str | None = None) -> np.ndarray:
        if self.preprocess_point_cloud:
            self.preprocess()
        if output_path:
            save_ply(output_path, self.points, self.colors)
        return self.points

    def camera_centroid(self) -> np.ndarray | None:
        """Mean camera position of the pose table, or None without one."""
        try:
            return self.pose[["tx", "ty", "tz"]].to_numpy(np.float32).mean(axis=0)
        except (KeyError, TypeError, IndexError, AttributeError):
            return None

    def make_mesh(
        self,
        output_path: str | None = None,
        voxel: float = 0.04,
        mesher: str = "density",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Surface-reconstruct the (preprocessed) cloud → ((V, 3) vertices,
        (F, 3) faces), written as a binary PLY mesh when ``output_path`` is
        given. ``mesher="density"``: density splat + marching tetrahedra, a
        tight double-sided shell; ``"poisson"``: the FFT Poisson solve on
        the device, a smooth single-layer surface, normals toward the
        camera trajectory's centroid (the cloud's without a pose table)."""
        from tpu3dlm_torch.mapper.meshing import mesh_point_cloud
        from tpu3dlm_torch.mapper.poisson import mesh_poisson

        if mesher not in ("density", "poisson"):
            raise ValueError(f"unknown mesher {mesher!r} (cfg `mesher`): use 'density' or 'poisson'")
        if self.preprocess_point_cloud:
            self.preprocess()
        if mesher == "poisson":
            viewpoint = self.camera_centroid()
            if viewpoint is None:
                self.logger.warning(
                    "pose has no tx/ty/tz columns; orienting Poisson normals toward the cloud "
                    "centroid instead of the camera trajectory"
                )
            verts, faces = mesh_poisson(self.points, voxel=voxel, viewpoint=viewpoint, device=self.device)
        else:
            verts, faces = mesh_point_cloud(self.points, voxel=voxel)
        self.logger.info("meshed %d points → %d vertices / %d triangles",
                         len(self.points), len(verts), len(faces))
        if output_path:
            save_ply_mesh(output_path, verts, faces)
        return verts, faces

    def box_line_sets(self, bboxes=None, buffer_scale: float = 1.5) -> list[np.ndarray]:
        """Overlay boxes as (8, 3) corner arrays (the optimised set by
        default), each quad extruded by ``bbox_depth_buffer × buffer_scale``
        along its normal."""
        quads = list(_boxes_iter(bboxes if bboxes is not None else self.optimised_bboxes))
        if not quads:
            return []
        corners = torch.from_numpy(np.stack(quads)).to(self.device)
        boxes = G.create_3d_bounding_box(corners, self.bbox_depth_buffer * buffer_scale)
        return list(boxes.cpu().numpy())

    def overlay_geometry(self) -> dict:
        """Every overlay the reference's viewer draws, as arrays:

        * ``optimised_boxes``: (8, 3) boxes, buffer × 1.5;
        * ``raw_boxes``: the unoptimised boxes, only with
          ``view_unprocessed_bboxes``;
        * ``pose_points`` (F, 3) and ``pose_direction_lines`` (F, 2, 3),
          0.2 m camera-direction segments, only with ``overlay_pose``.
        """
        geo: dict = {
            "optimised_boxes": self.box_line_sets(),
            "raw_boxes": [],
            "pose_points": None,
            "pose_direction_lines": None,
        }
        if self.view_unprocessed_bboxes:
            geo["raw_boxes"] = self.box_line_sets(self.global_bboxes_data, buffer_scale=1.0)
        if self.overlay_pose and self.pose is not None:
            if hasattr(self.pose, "columns"):
                pose_arr = self.pose[["tx", "ty", "tz", "qx", "qy", "qz", "qw"]].to_numpy(dtype=np.float32)
            else:
                pose_arr = np.asarray(self.pose, np.float32)
            pts = pose_arr[:, :3]
            dirs = G.camera_direction(torch.from_numpy(pose_arr).to(self.device)).cpu().numpy()
            geo["pose_points"] = pts
            geo["pose_direction_lines"] = np.stack([pts, pts + 0.2 * dirs], axis=1)
        return geo


def main(argv=None) -> str:
    import argparse
    import os
    import pickle

    from tpu3dlm_torch.utils.config import ConfigLoader

    parser = argparse.ArgumentParser(description="Processing Configuration.")
    parser.add_argument("--data", type=str, default="gold_std")
    parser.add_argument("--model", type=str, default="mesh", choices=["mesh", "pc"])
    parser.add_argument("--config", type=str, default=os.path.join("configs", "variables.cfg"))
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device of the Poisson solve: cuda (default; raises without a GPU) or cpu.")
    args = parser.parse_args(argv)
    cfg = ConfigLoader(args.config, args.data)

    with open(cfg.pickle_path, "rb") as f:
        variables = pickle.load(f)
    mapper = Mapping(
        global_bboxes_data=variables["global_bboxes_data"],
        optimised_bboxes=variables["optimised_bboxes"],
        pose=variables["pose_df"],
        eps=cfg.eps, min_points=cfg.min_points, ply_filepath=cfg.ply_path,
        preprocess_point_cloud=cfg.preprocess_point_cloud,
        overlay_pose=cfg.overlay_pose,
        device=args.device,
    )
    out = os.path.join(os.path.dirname(cfg.ply_path), f"map_{args.model}.ply")
    {"mesh": mapper.make_mesh, "pc": mapper.make_point_cloud}[args.model](output_path=out)
    print(f"map written to {out}")
    return out


if __name__ == "__main__":
    main()
