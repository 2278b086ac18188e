"""Synthetic RTAB-Map scan generator (port of ``tpu3dlm/data/synthetic.py``).

The capture the ``--setup`` cold start writes and the hard-eval corpus is
made of, in the RTAB-Map export layout the Pipeline reads:

    <root>/<data_folder>/
        data.db                      RTAB-Map-style SQLite (Data/Node tables)
        poses.txt                    trajectory (timestamp tx ty tz qx..qw id)
        cloud.ply                    point cloud of the scene
        gt.json                      closed-form ground truth
        rtabmap_extract/data_rgb/<n>.jpg
        rtabmap_extract/data_depth/<n>.png   CV_8UC4-as-float32 depth PNGs
        rtabmap_extract/calibration/<n>.yaml

Scene: a flat wall at z = wall_z with coloured rectangular "signs" mounted
slightly in front of it; the camera translates along x (small yaw wobble)
looking at the wall. Depth and RGB are rendered analytically per frame, so
every ground-truth quantity (sign corner world coordinates, per-frame 2D
boxes) is known in closed form.

Host numpy, as in the JAX package. Where that calls cv2, the port writes
with its own codecs (``data/codecs.py``): the JPEGs are byte for
byte ``cv2.imencode(".jpg", ...)``'s, and the depth PNGs decode to the same
arrays as cv2's files (their bytes differ: another deflate). Every other
file (poses, calibration YAML, ``gt.json``, ``cloud.ply``, the database
rows but for the image blobs) is the JAX package's, byte for byte.
"""

from __future__ import annotations

import dataclasses
import os
import sqlite3

import numpy as np

from tpu3dlm_torch.data.calibration import write_calibration
from tpu3dlm_torch.data.codecs import encode_jpeg, encode_png
from tpu3dlm_torch.data.ply import save_ply
from tpu3dlm_torch.data.rtabmap_db import encode_depth


@dataclasses.dataclass
class Sign:
    """A rectangular sign on the wall: world-frame axis-aligned rect at z."""

    x0: float
    y0: float
    x1: float
    y1: float
    z: float
    color: tuple[int, int, int]
    label: int = 0
    damage: int = 0  # ground-truth damage class

    @property
    def corners_world(self) -> np.ndarray:
        """(4, 3) TL, BL, BR, TR in world frame (matching bbox_corners_2d order)."""
        return np.array(
            [
                [self.x0, self.y0, self.z],
                [self.x0, self.y1, self.z],
                [self.x1, self.y1, self.z],
                [self.x1, self.y0, self.z],
            ],
            np.float32,
        )


@dataclasses.dataclass
class SyntheticScene:
    signs: list[Sign]
    wall_z: float
    poses: np.ndarray  # (F, 7)
    timestamps: np.ndarray  # (F,)
    rgb_wh: tuple[int, int]
    depth_wh: tuple[int, int]
    intrinsics: tuple[float, float, float, float]  # fx, fy, cx, cy at RGB res
    gt_boxes_2d: dict[int, list[list[float]]]  # frame → [[x1,y1,x2,y2,conf,label]]
    gt_damage_2d: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    # frame → damage class per gt_boxes_2d row (the sign's ground truth)


def default_signs() -> list[Sign]:
    return [
        Sign(-0.6, -0.4, -0.2, 0.1, 2.8, (220, 40, 40), label=0, damage=0),
        Sign(0.3, -0.5, 0.8, 0.0, 2.85, (40, 180, 60), label=1, damage=1),
        Sign(1.2, 0.1, 1.7, 0.55, 2.8, (40, 80, 220), label=0, damage=0),
    ]


def _quat_z(yaw: float) -> np.ndarray:
    return np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)], np.float32)


def _rotmat_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _render_frame(
    cam_t: np.ndarray,
    R: np.ndarray,
    signs: list[Sign],
    wall_z: float,
    width: int,
    height: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    want_rgb: bool = True,
    want_depth: bool = True,
    want_owner: bool = False,
):
    """Analytic render → (rgb (H,W,3) uint8, depth (H,W) float32 metres
    [, owner (H,W) int32]).

    ``want_rgb``/``want_depth`` skip the unused buffer's work: the scan
    generator renders RGB at camera resolution and depth at depth
    resolution, so each call only ever keeps one of the two outputs.

    Objects are drawn in LIST ORDER — a later entry overwrites an earlier
    one where they overlap, so callers pass the list far-to-nearest for
    correct z-layering (the hard-eval corpus stacks occluder panels in
    front of signs; the default non-overlapping scene is order-invariant).
    ``want_owner`` additionally returns the per-pixel index of the drawn
    object (-1 = wall), which is how occlusion-aware ground-truth boxes
    are derived (visible-pixel extent, not full-rect projection)."""
    us = np.arange(width, dtype=np.float32)
    vs = np.arange(height, dtype=np.float32)
    uu, vv = np.meshgrid(us, vs)
    d_cam = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], axis=-1)
    d_world = d_cam @ R.T  # (H, W, 3)

    def plane_hit(z_plane):
        dz = d_world[..., 2]
        t = (z_plane - cam_t[2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
        pt = cam_t[None, None, :] + t[..., None] * d_world
        return t, pt  # camera-frame depth is t (d_cam z-component is 1)

    depth = None
    if want_depth:
        depth_t, _ = plane_hit(wall_z)
        depth = np.where(depth_t > 0, depth_t, 0.0).astype(np.float32)
    rgb = (
        np.full((height, width, 3), 180, np.uint8) if want_rgb else None
    )  # wall grey
    owner = np.full((height, width), -1, np.int32) if want_owner else None

    for i, sign in enumerate(signs):
        t_s, pt_s = plane_hit(sign.z)
        inside = (
            (pt_s[..., 0] >= sign.x0)
            & (pt_s[..., 0] <= sign.x1)
            & (pt_s[..., 1] >= sign.y0)
            & (pt_s[..., 1] <= sign.y1)
            & (t_s > 0)
        )
        if want_depth:
            depth = np.where(inside, t_s.astype(np.float32), depth)
        if want_rgb:
            rgb[inside] = sign.color
        if want_owner:
            owner[inside] = i

    if want_owner:
        return rgb, depth, owner
    return rgb, depth


def _project_sign_bbox(
    sign: Sign,
    cam_t: np.ndarray,
    R: np.ndarray,
    width: int,
    height: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
) -> list[float] | None:
    """Ground-truth 2D bbox of a sign in a frame, or None if out of view."""
    pts_cam = (sign.corners_world - cam_t) @ R  # R^T (world→camera) applied rowwise
    if np.any(pts_cam[:, 2] <= 1e-6):
        return None
    us = pts_cam[:, 0] / pts_cam[:, 2] * fx + cx
    vs = pts_cam[:, 1] / pts_cam[:, 2] * fy + cy
    x1, x2 = float(us.min()), float(us.max())
    y1, y2 = float(vs.min()), float(vs.max())
    if x2 <= 0 or y2 <= 0 or x1 >= width - 1 or y1 >= height - 1:
        return None
    # clip to frame (partial visibility keeps the clipped box)
    x1c, y1c = max(x1, 0.0), max(y1, 0.0)
    x2c, y2c = min(x2, width - 1.0), min(y2, height - 1.0)
    if (x2c - x1c) < 4 or (y2c - y1c) < 4:
        return None
    return [x1c, y1c, x2c, y2c]


def generate_scan(
    root: str,
    data_folder: str = "gold_std",
    num_frames: int = 8,
    rgb_wh: tuple[int, int] = (480, 640),
    depth_wh: tuple[int, int] = (192, 256),
    signs: list[Sign] | None = None,
    wall_z: float = 3.0,
    world_transform: np.ndarray | None = None,
    drop_sign_indices: tuple[int, ...] = (),
    cloud_points_per_m2: int = 4000,
    seed: int = 0,
    distractors: list[Sign] | None = None,
    occluders: list[Sign] | None = None,
    depth_noise_m: float = 0.0,
    depth_dropout: float = 0.0,
    yaw_amplitude: float = 0.08,
    x_span: tuple[float, float] = (-0.5, 1.6),
    yaw_phase: float = 0.0,
) -> SyntheticScene:
    """Generate a full synthetic scan under <root>/<data_folder>/.

    ``world_transform`` (4x4) rigidly moves the whole world (poses + cloud) —
    used to fabricate a maintenance scan whose SLAM origin differs from the
    gold standard, exercising map alignment. ``drop_sign_indices`` removes
    signs (missing objects) from the maintenance scan.

    Hard-eval axes (pipeline/hardeval.py — each stresses one failure mode
    the default corpus cannot):
      ``distractors`` — sign-shaped rects rendered into RGB/depth/cloud but
        NEVER in the ground truth (false-positive pressure);
      ``occluders`` — panels at nearer z drawn OVER the signs; ground-truth
        boxes then come from each sign's VISIBLE pixel extent (an occluded
        sign's box shrinks; a fully hidden sign has none);
      ``depth_noise_m`` / ``depth_dropout`` — Gaussian sensor noise and
        zero-depth holes on the rendered depth maps (3D placement stress;
        2D ground truth unaffected);
      ``yaw_amplitude`` / ``x_span`` — oblique viewing: larger yaw sweeps
        foreshorten the signs and push them to the frame edges;
      ``yaw_phase`` — phase offset of the sinusoidal yaw sweep, so two
        scans of the same scene view it from genuinely different angles
        (the multi-seed eval corpus draws it per seed; default 0 keeps
        every existing fixture bit-identical).
    When distractors or occluders are present the per-frame ground truth is
    derived from the rendered owner mask (pixel-quantised, occlusion-aware)
    instead of corner projection.
    """
    rng = np.random.default_rng(seed)
    signs = list(default_signs() if signs is None else signs)
    signs = [s for i, s in enumerate(signs) if i not in set(drop_sign_indices)]
    distractors = list(distractors or [])
    occluders = list(occluders or [])
    # far-to-near draw order: a nearer panel overwrites whatever it covers
    # (the renderer draws in list order). Ground-truth signs keep their
    # identity through the sort via the paired index.
    draw_entries = sorted(
        [(s, i) for i, s in enumerate(signs)]
        + [(d, -1) for d in distractors]
        + [(o, -1) for o in occluders],
        key=lambda e: -e[0].z,
    )
    draw_list = [e[0] for e in draw_entries]
    owner_to_sign = {k: e[1] for k, e in enumerate(draw_entries)}
    mask_gt = bool(distractors or occluders)

    rgb_w, rgb_h = rgb_wh
    depth_w, depth_h = depth_wh
    fx = 0.9 * rgb_w
    fy = 0.9 * rgb_w
    cx, cy = rgb_w / 2.0, rgb_h / 2.0
    scale = rgb_w / depth_w
    dfx, dfy, dcx, dcy = fx / scale, fy / scale, cx / scale, cy / scale

    # Trajectory: translate along x, sinusoidal yaw (hard-eval "oblique"
    # axis raises the amplitude)
    xs = np.linspace(x_span[0], x_span[1], num_frames)
    yaws = yaw_amplitude * np.sin(
        np.linspace(0, 2 * np.pi, num_frames) + yaw_phase
    )
    poses = np.zeros((num_frames, 7), np.float32)
    timestamps = 1700000000.0 + np.arange(num_frames) * 0.5
    for f in range(num_frames):
        poses[f, :3] = [xs[f], 0.05 * np.sin(f), 0.0]
        poses[f, 3:] = _quat_z(yaws[f])

    Tw = np.eye(4, dtype=np.float32) if world_transform is None else world_transform.astype(np.float32)

    folder = os.path.join(root, data_folder)
    rgb_dir = os.path.join(folder, "rtabmap_extract", "data_rgb")
    depth_dir = os.path.join(folder, "rtabmap_extract", "data_depth")
    calib_dir = os.path.join(folder, "rtabmap_extract", "calibration")
    for d in (rgb_dir, depth_dir, calib_dir):
        os.makedirs(d, exist_ok=True)

    # SQLite db in the RTAB-Map layout the extractor queries
    db_path = os.path.join(folder, "data.db")
    if os.path.exists(db_path):
        os.remove(db_path)
    conn = sqlite3.connect(db_path)
    conn.execute("CREATE TABLE Node (id INTEGER PRIMARY KEY)")
    conn.execute("CREATE TABLE Data (id INTEGER PRIMARY KEY, image BLOB, depth BLOB)")

    gt_boxes: dict[int, list[list[float]]] = {}
    gt_damage: dict[int, list[int]] = {}
    for f in range(num_frames):
        cam_t = poses[f, :3].copy()
        R = _rotmat_z(float(yaws[f]))

        owner = None
        if mask_gt:
            rgb, _, owner = _render_frame(
                cam_t, R, draw_list, wall_z, rgb_w, rgb_h, fx, fy, cx, cy,
                want_depth=False, want_owner=True,
            )
        else:
            rgb, _ = _render_frame(
                cam_t, R, draw_list, wall_z, rgb_w, rgb_h, fx, fy, cx, cy,
                want_depth=False,
            )
        _, depth_m = _render_frame(
            cam_t, R, draw_list, wall_z, depth_w, depth_h, dfx, dfy, dcx, dcy,
            want_rgb=False,
        )
        if depth_noise_m > 0:
            depth_m = np.maximum(
                depth_m + rng.normal(0, depth_noise_m, depth_m.shape), 0.0
            ).astype(np.float32)
        if depth_dropout > 0:
            depth_m = np.where(
                rng.uniform(size=depth_m.shape) < depth_dropout, 0.0, depth_m
            ).astype(np.float32)

        idx = f + 1
        jpg = encode_jpeg(rgb)
        png = encode_png(encode_depth(depth_m))
        with open(os.path.join(rgb_dir, f"{idx}.jpg"), "wb") as fh:
            fh.write(jpg)
        with open(os.path.join(depth_dir, f"{idx}.png"), "wb") as fh:
            fh.write(png)
        write_calibration(
            os.path.join(calib_dir, f"{idx}.yaml"), rgb_w, rgb_h, fx, fy, cx, cy
        )
        conn.execute("INSERT INTO Node (id) VALUES (?)", (idx,))
        conn.execute(
            "INSERT INTO Data (id, image, depth) VALUES (?, ?, ?)",
            (idx, jpg, png),
        )

        frame_boxes = []
        frame_damage = []
        if mask_gt:
            # occlusion-aware ground truth: a sign's box is the extent of
            # its VISIBLE pixels (owner map) — an occluded sign shrinks, a
            # hidden sign disappears, a distractor never appears. Iterate
            # in SIGN order so the per-frame record order matches the
            # corner-projection path exactly.
            sign_to_draw = {v: k for k, v in owner_to_sign.items() if v >= 0}
            for sign_idx in range(len(signs)):
                k = sign_to_draw[sign_idx]
                ys_v, xs_v = np.nonzero(owner == k)
                if ys_v.size < 16:
                    continue
                x1v, x2v = float(xs_v.min()), float(xs_v.max())
                y1v, y2v = float(ys_v.min()), float(ys_v.max())
                if (x2v - x1v) < 4 or (y2v - y1v) < 4:
                    continue
                sign = signs[sign_idx]
                frame_boxes.append([x1v, y1v, x2v, y2v, 0.95, sign.label])
                frame_damage.append(sign.damage)
        else:
            for sign in signs:
                box = _project_sign_bbox(
                    sign, cam_t, R, rgb_w, rgb_h, fx, fy, cx, cy
                )
                if box is not None:
                    frame_boxes.append(box + [0.95, sign.label])
                    frame_damage.append(sign.damage)
        gt_boxes[f] = frame_boxes
        gt_damage[f] = frame_damage
    conn.commit()
    conn.close()

    # poses.txt — apply the world transform so the trajectory lives in the
    # (possibly shifted) maintenance frame
    out_poses = poses.copy()
    if world_transform is not None:
        Rw, tw = Tw[:3, :3], Tw[:3, 3]
        for f in range(num_frames):
            Rf = _rotmat_z(float(yaws[f]))
            Rn = Rw @ Rf
            out_poses[f, :3] = Rw @ poses[f, :3] + tw
            # rotation matrix → quaternion (z-rotations compose in-plane here,
            # but handle the general case)
            out_poses[f, 3:] = _rotmat_to_quat(Rn)
    with open(os.path.join(folder, "poses.txt"), "w") as fh:
        fh.write("# timestamp x y z qx qy qz qw id\n")
        for f in range(num_frames):
            t = timestamps[f]
            p = out_poses[f]
            fh.write(
                f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{p[3]:.6f} {p[4]:.6f} {p[5]:.6f} {p[6]:.6f} {f + 1}\n"
            )

    # cloud.ply — wall + signs (+ distractor/occluder surfaces: they are
    # physical objects the capture would see) in the transformed world frame
    pts, cols = _sample_cloud(
        signs + distractors + occluders, wall_z, rng, cloud_points_per_m2
    )
    if world_transform is not None:
        pts = pts @ Tw[:3, :3].T + Tw[:3, 3]
    save_ply(os.path.join(folder, "cloud.ply"), pts, cols)

    scene = SyntheticScene(
        signs=signs,
        wall_z=wall_z,
        poses=out_poses,
        timestamps=timestamps,
        rgb_wh=rgb_wh,
        depth_wh=depth_wh,
        intrinsics=(fx, fy, cx, cy),
        gt_boxes_2d=gt_boxes,
        gt_damage_2d=gt_damage,
    )
    save_scene_gt(os.path.join(folder, "gt.json"), scene)
    return scene


def save_scene_gt(path: str, scene: SyntheticScene) -> None:
    """Persist the scene ground truth next to the scan so evaluation can run
    from disk alone."""
    import json

    payload = {
        "wall_z": scene.wall_z,
        "rgb_wh": list(scene.rgb_wh),
        "depth_wh": list(scene.depth_wh),
        "intrinsics": list(scene.intrinsics),
        "signs": [
            {
                "x0": s.x0, "y0": s.y0, "x1": s.x1, "y1": s.y1, "z": s.z,
                "color": list(s.color), "label": s.label, "damage": s.damage,
                "corners_world": s.corners_world.tolist(),
            }
            for s in scene.signs
        ],
        "gt_boxes_2d": {str(f): v for f, v in scene.gt_boxes_2d.items()},
        "gt_damage_2d": {str(f): v for f, v in scene.gt_damage_2d.items()},
    }
    with open(path, "w") as f:
        json.dump(payload, f)


def load_scene_gt(path: str) -> dict:
    """Load gt.json → dict with int frame keys and numpy sign corners."""
    import json

    with open(path) as f:
        payload = json.load(f)
    payload["gt_boxes_2d"] = {int(k): v for k, v in payload["gt_boxes_2d"].items()}
    payload["gt_damage_2d"] = {int(k): v for k, v in payload["gt_damage_2d"].items()}
    for s in payload["signs"]:
        s["corners_world"] = np.asarray(s["corners_world"], np.float32)
    return payload


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Numpy rotation-matrix → (qx, qy, qz, qw) for pose serialization."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, 0.25 * s],
            np.float32,
        )
    i = int(np.argmax(np.diag(R)))
    if i == 0:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s, (R[2, 1] - R[1, 2]) / s]
    elif i == 1:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = [(R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s, (R[0, 2] - R[2, 0]) / s]
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = [(R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s, (R[1, 0] - R[0, 1]) / s]
    return np.array(q, np.float32)


def _sample_cloud(
    signs: list[Sign], wall_z: float, rng: np.random.Generator, pts_per_m2: int
) -> tuple[np.ndarray, np.ndarray]:
    wall_w, wall_h = 4.0, 2.5  # metres, centred near origin
    n_wall = int(wall_w * wall_h * pts_per_m2)
    wall = np.stack(
        [
            rng.uniform(-wall_w / 2 + 0.5, wall_w / 2 + 0.5, n_wall),
            rng.uniform(-wall_h / 2, wall_h / 2, n_wall),
            np.full(n_wall, wall_z),
        ],
        axis=1,
    ).astype(np.float32)
    cols = [np.full((n_wall, 3), 180 / 255.0, np.float32)]
    pts = [wall]
    for sign in signs:
        area = (sign.x1 - sign.x0) * (sign.y1 - sign.y0)
        n_s = max(50, int(area * pts_per_m2 * 2))
        sp = np.stack(
            [
                rng.uniform(sign.x0, sign.x1, n_s),
                rng.uniform(sign.y0, sign.y1, n_s),
                np.full(n_s, sign.z),
            ],
            axis=1,
        ).astype(np.float32)
        pts.append(sp)
        cols.append(np.tile(np.array(sign.color, np.float32) / 255.0, (n_s, 1)))
    return np.concatenate(pts), np.concatenate(cols)
