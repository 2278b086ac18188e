"""Alignment animation: the recorded registration transforms replayed as a
video (port of ``tpu3dlm/alignment/visualise.py``).

Each recorded transform T is split into ``steps`` equal increments
T^(1/steps) (``ops/geometry.py::se3_interpolate`` on ``device``) and a frame
is rendered after each. Both clouds are surface-meshed (the density shell
or the Poisson surface, ``mesher``) and drawn with the host renderer
(``utils/render.py``) under a slow camera orbit; when meshing yields no
triangles, the frames are orthographic point splats. The video is an mp4
through ``imageio`` where that imports and has an encoder; otherwise the
frames go to ``<out>.npz`` (key ``frames``), the reference's rule.

    python -m tpu3dlm_torch.alignment.visualise --data maintenance --config <cfg> [--device cuda|cpu]

replays the registration of a scan the Pipeline has run into
``alignment_visualisation.mp4`` (or ``.npz``) beside its report: the
transforms come from the scan's pickle when it holds them, else the two
clouds are registered again with the config's ICP settings.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.ops.geometry import se3_interpolate

_BASE_COLOR = (0.55, 0.55, 0.58)  # gold-standard map: grey
_COMP_COLOR = (0.85, 0.25, 0.22)  # comparison map: red


def _splat(points: np.ndarray, colors: np.ndarray, canvas: np.ndarray,
           bounds: tuple[np.ndarray, np.ndarray]) -> None:
    """Orthographic xy → image point splat onto ``canvas`` (in place)."""
    lo, hi = bounds
    h, w = canvas.shape[:2]
    span = np.maximum(hi - lo, 1e-6)
    u = ((points[:, 0] - lo[0]) / span[0] * (w - 1)).astype(np.int32)
    v = ((points[:, 1] - lo[1]) / span[1] * (h - 1)).astype(np.int32)
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    canvas[v[ok], u[ok]] = colors if colors.ndim == 1 else colors[ok]


def _magnitude(t) -> float:
    """Rotation angle (+ translation norm for a matrix) of a recorded step."""
    if isinstance(t, tuple):
        R = np.asarray(t[0])
        return abs(float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))
    T = np.asarray(t)
    cos = np.clip((np.trace(T[:3, :3]) - 1) / 2, -1, 1)
    return float(np.linalg.norm(T[:3, 3]) + np.arccos(cos))


class VisualiseAlignment:
    """Renders the stepwise alignment of the comparison map onto the base
    map. Clouds above ``max_points`` are subsampled (seeded draw)."""

    def __init__(
        self,
        base_points: np.ndarray,
        comparison_points: np.ndarray,
        image_hw: tuple[int, int] = (480, 640),
        max_points: int = 50_000,
        renderer: str = "auto",  # "mesh" | "splat" | "auto"
        mesh_voxel: float | None = None,
        mesher: str = "density",  # "density" shell | "poisson" surface
        orbit_sweep: float = 0.9,  # total camera azimuth sweep (radians)
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        rng = np.random.default_rng(0)

        def sub(p):
            p = np.asarray(p, np.float32)
            if p.shape[0] > max_points:
                p = p[rng.choice(p.shape[0], max_points, replace=False)]
            return p

        self.base = sub(base_points)
        self.comparison = sub(comparison_points)
        self.image_hw = image_hw
        self.orbit_sweep = orbit_sweep
        self.frames: list[np.ndarray] = []
        self.logger = logging.getLogger(__name__)

        allpts = np.concatenate([self.base, self.comparison])
        margin = 0.1 * (allpts.max(0) - allpts.min(0) + 1e-6)
        self.bounds = (allpts.min(0) - margin, allpts.max(0) + margin)
        self.center = allpts.mean(0)
        self.radius = 1.6 * float(np.linalg.norm(allpts - self.center, axis=1).max())

        self.base_mesh = self.comp_mesh = None
        if mesher not in ("density", "poisson"):
            raise ValueError(f"unknown mesher {mesher!r} (cfg `mesher`): use 'density' or 'poisson'")
        if renderer in ("mesh", "auto"):
            if mesher == "poisson":
                from tpu3dlm_torch.mapper.poisson import mesh_poisson

                def _mesh(p, voxel):
                    return mesh_poisson(p, voxel=voxel, device=self.device)
            else:
                from tpu3dlm_torch.mapper.meshing import mesh_point_cloud as _mesh

            span = float((allpts.max(0) - allpts.min(0)).max())
            voxel = mesh_voxel or max(span / 72.0, 1e-3)
            bm = _mesh(self.base, voxel=voxel)
            cm = _mesh(self.comparison, voxel=voxel)
            if len(bm[1]) and len(cm[1]):
                self.base_mesh, self.comp_mesh = bm, cm
                self.logger.info("meshed maps for animation: base %d tris, comparison %d tris",
                                 len(bm[1]), len(cm[1]))
            elif renderer == "mesh":
                raise ValueError("meshing produced no triangles; use renderer='splat'")

    @property
    def uses_mesh(self) -> bool:
        return self.base_mesh is not None

    def _render(self, comparison_pts: np.ndarray, comp_verts: np.ndarray | None, azimuth: float) -> np.ndarray:
        from tpu3dlm_torch.utils.render import look_at, orbit_eye, render_scene

        h, w = self.image_hw
        if self.uses_mesh and comp_verts is not None:
            view = look_at(orbit_eye(self.center, self.radius, azimuth), self.center)
            return render_scene(
                [(self.base_mesh[0], self.base_mesh[1], _BASE_COLOR),
                 (comp_verts, self.comp_mesh[1], _COMP_COLOR)],
                view, (h, w),
            )
        canvas = np.full((h, w, 3), 255, np.uint8)
        _splat(self.base, np.array([90, 90, 90], np.uint8), canvas, self.bounds)
        _splat(comparison_pts, np.array([220, 60, 60], np.uint8), canvas, self.bounds)
        return canvas

    def _as_matrix(self, transformation) -> np.ndarray:
        """4×4 rigid transform from a matrix or an (R, center) rotation
        tuple (a rotation about ``center``)."""
        if isinstance(transformation, tuple):
            from tpu3dlm_torch.ops.icp import rotation_about

            R, center = transformation
            as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)  # noqa: E731
            return rotation_about(as_t(R), as_t(center)).cpu().numpy()
        return np.asarray(transformation, np.float32)

    def increment(self, transformation, steps: int = 20) -> np.ndarray:
        """T^(1/steps) of one recorded transform, on ``device``."""
        T = torch.as_tensor(self._as_matrix(transformation), device=self.device)
        return se3_interpolate(T, 1.0 / steps).cpu().numpy()

    def _apply_incremental_transformation(self, transformation, comparison, comp_verts=None,
                                          steps: int = 20, azimuths=None):
        """One recorded transform → ``steps`` interpolated frames."""
        T_inc = self.increment(transformation, steps)
        for s in range(steps):
            comparison = comparison @ T_inc[:3, :3].T + T_inc[:3, 3]
            if comp_verts is not None:
                comp_verts = comp_verts @ T_inc[:3, :3].T + T_inc[:3, 3]
            az = azimuths[s] if azimuths is not None else 0.0
            self.frames.append(self._render(comparison, comp_verts, az))
        return comparison, comp_verts

    @staticmethod
    def moving_steps(transformations: list) -> list:
        """The recorded steps worth replaying: the near-identity increments
        that ICP's early stop pads the record with are dropped (they would
        freeze the tail of the video); at least one step is kept."""
        moving = [t for t in transformations if _magnitude(t) > 1e-6]
        return moving or list(transformations[:1])

    def create_video(self, transformations: list, output_video: str = "alignment_animation.mp4",
                     fps: int = 30, steps: int = 20) -> int:
        """Replay every recorded transform; write the mp4 (or, without an
        encoder, ``<output_video>.npz``). Returns the frame count."""
        if not transformations:
            self.logger.warning("no transformations to animate; skipping video")
            return 0
        comparison = self.comparison
        comp_verts = self.comp_mesh[0].copy() if self.uses_mesh else None
        transformations = self.moving_steps(transformations)

        total = max(len(transformations) * steps, 1)
        az_all = np.linspace(-self.orbit_sweep / 2, self.orbit_sweep / 2, total)
        for i, t in enumerate(transformations):
            self.logger.info("transform %d/%d", i + 1, len(transformations))
            comparison, comp_verts = self._apply_incremental_transformation(
                t, comparison, comp_verts, steps, azimuths=az_all[i * steps:(i + 1) * steps],
            )
        self.written = write_video(self.frames, output_video, fps, self.logger)
        return len(self.frames)


def write_video(frames: list, output_video: str, fps: int = 30, logger=None) -> str:
    """``frames`` → an mp4 through imageio, or ``<output_video>.npz`` when
    imageio or its encoder is missing. Returns the path written."""
    logger = logger or logging.getLogger(__name__)
    try:
        import imageio

        with imageio.get_writer(output_video, fps=fps, format="mp4") as w:
            for frame in frames:
                w.append_data(frame)
        logger.info("Video written to %s", output_video)
        return output_video
    except Exception as e:  # no imageio or no encoder: keep the frames
        fallback = output_video + ".npz"
        np.savez_compressed(fallback, frames=np.stack(frames))
        logger.warning("mp4 encode failed (%s); frames saved to %s", e, fallback)
        return fallback


def main(argv=None) -> int:
    import argparse
    import os
    import pickle

    from tpu3dlm_torch.data.ply import load_ply
    from tpu3dlm_torch.pipeline.task import make_alignment
    from tpu3dlm_torch.utils.config import ConfigLoader

    parser = argparse.ArgumentParser(description="Processing Configuration")
    parser.add_argument("--data", type=str, default="ideal_scan")
    parser.add_argument("--config", type=str, default=os.path.join("configs", "variables.cfg"))
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device of the interpolation and of a re-run registration: cuda (default; "
                             "raises without a GPU) or cpu.")
    args = parser.parse_args(argv)
    if args.data == "gold_std":
        raise ValueError("The parameter 'gold_std' is not allowed for --data.")
    cfg = ConfigLoader(args.config, args.data)
    cfg_gold = ConfigLoader(args.config, "gold_std")

    with open(cfg.pickle_path, "rb") as f:
        variables = pickle.load(f)
    base_pts, _ = load_ply(cfg_gold.ply_path)
    comp_pts, _ = load_ply(cfg.ply_path)
    transformations = variables.get("transformations")
    if transformations is None:
        # the Pipeline writes its pickle before the compare, so the record
        # is not in it: register the two clouds again as the compare does
        with open(cfg_gold.pickle_path, "rb") as f:
            gold_var = pickle.load(f)
        align = make_alignment(cfg, gold_var, variables["pose_df"], variables["optimised_bboxes"],
                               base_pts, comp_pts, args.device)
        _, transformations, _, _ = align.compare(args.data)
    out = os.path.join(os.path.dirname(cfg.csv_output) or ".", "alignment_visualisation.mp4")
    vis = VisualiseAlignment(base_pts, comp_pts, device=args.device)
    n = vis.create_video(transformations, out)
    print(f"{n} frames → {vis.written if n else out}")
    return n


if __name__ == "__main__":
    main()
