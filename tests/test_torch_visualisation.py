"""The geometry of the views of a run against the JAX package on the CPU:
``so3_log``, ``se3_interpolate``, ``rotmat_to_quat``, the exact box mask
and median, ``rotation_about``, ``Scan.depth_hw``, ``depth_to_points`` and
``scan_to_pointcloud``, ``Transforms``, ``Visualiser``,
``PoseDataExtractor``, ``frame_view_geometry``, and the map viewer's calls
on their no-Open3D path.

Bars: rotations and transforms within 1e-5 (``rotation_about`` and
``Transforms`` 1e-6), masks and medians identical, points within 1e-5 m,
the Visualiser's numpy helpers identical, the frustum's lines identical and
its points within 1e-6."""

import logging
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial.transform import Rotation

from tpu3dlm.data.poses import PoseDataExtractor as JPoses
from tpu3dlm.data.scan import Scan as JScan
from tpu3dlm.mapper import mapping as JMap
from tpu3dlm.mapper.projection import GlobalBoxes as JBoxes
from tpu3dlm.mapper.projection import frame_view_geometry as j_view
from tpu3dlm.ops import geometry as JG
from tpu3dlm.ops import pointcloud as JPC
from tpu3dlm.ops.icp import rotation_about as j_rotation_about
from tpu3dlm.utils.transformations import Transforms as JTransforms
from tpu3dlm.utils.visualisation import Visualiser as JVis
from tpu3dlm_torch.data.poses import PoseDataExtractor, load_poses, poses_to_frame
from tpu3dlm_torch.data.scan import Scan
from tpu3dlm_torch.mapper import mapping as PMap
from tpu3dlm_torch.mapper.projection import GlobalBoxes, frame_view_geometry
from tpu3dlm_torch.ops import geometry as G
from tpu3dlm_torch.ops import pointcloud as PC
from tpu3dlm_torch.ops.icp import rotation_about
from tpu3dlm_torch.utils.transformations import Transforms
from tpu3dlm_torch.utils.visualisation import Visualiser

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
POSES = os.path.join(FIXTURES, "torch_project", "data", "maintenance", "poses.txt")
THETAS = [0.0, 1e-7, 1e-3, 1.0, np.pi - 1e-3, np.pi]
AXES = [(1, 0, 0), (0.3, -0.5, 0.8), (0, 0, 1), (-1, 2, 0.5)]


def rotations() -> list[np.ndarray]:
    """Every θ of the near-0 and near-π branches about four axes, and 64
    random rotations."""
    out = [Rotation.from_rotvec(np.asarray(a, float) / np.linalg.norm(a) * t).as_matrix()
           for t in THETAS for a in AXES]
    out += list(Rotation.random(64, random_state=1).as_matrix())
    return [r.astype(np.float32) for r in out]


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def pose_tables():
    ts, poses = load_poses(POSES)
    frame = poses_to_frame(ts, poses)
    return frame, pd.DataFrame({c: frame[c] for c in frame.columns})


# ---------------------------------------------------------------------------
# ops/geometry.py, ops/icp.py::rotation_about
# ---------------------------------------------------------------------------


def test_so3_log_and_rotmat_to_quat_within_1e5():
    for R in rotations():
        np.testing.assert_allclose(G.so3_log(t32(R)).numpy(), np.asarray(JG.so3_log(jnp.asarray(R))), atol=1e-5)
        np.testing.assert_allclose(G.rotmat_to_quat(t32(R)).numpy(),
                                   np.asarray(JG.rotmat_to_quat(jnp.asarray(R))), atol=1e-5)


@pytest.mark.parametrize("alpha", [0.05, 0.5, 1.0])
def test_se3_interpolate_within_1e5(alpha):
    rng = np.random.default_rng(2)
    for R in rotations():
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, rng.normal(0, 1, 3)
        want = np.asarray(JG.se3_interpolate(jnp.asarray(T), jnp.float32(alpha)))
        np.testing.assert_allclose(G.se3_interpolate(t32(T), alpha).numpy(), want, atol=1e-5)


def test_so3_log_near_pi_keeps_the_rotation():
    """At θ = π the skew part vanishes; the near-π branch returns the axis
    times π (the reference's fix), and exp(log R) is R again."""
    R = Rotation.from_rotvec([0, np.pi, 0]).as_matrix().astype(np.float32)
    w = G.so3_log(t32(R))
    assert abs(float(torch.linalg.vector_norm(w)) - np.pi) < 1e-5
    np.testing.assert_allclose(G.so3_exp(w).numpy(), R, atol=1e-5)


def test_bbox_region_mask_and_median_identical():
    rng = np.random.default_rng(3)
    depth = rng.integers(0, 4000, (48, 64)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.3] = 0.0  # holes
    for _ in range(40):
        box = rng.uniform(-5, 70, 4).astype(np.float32)
        mask = G.bbox_region_mask(t32(box), 48, 64).numpy()
        np.testing.assert_array_equal(mask, np.asarray(JG.bbox_region_mask(jnp.asarray(box), 48, 64)))
        med, ok = G.bbox_median_depth(t32(depth), t32(box))
        w_med, w_ok = JG.bbox_median_depth(jnp.asarray(depth), jnp.asarray(box))
        assert bool(ok) == bool(w_ok) and float(med) == float(w_med)


def test_rotation_about_within_1e6():
    rng = np.random.default_rng(4)
    for R in rotations()[::4]:
        c = rng.normal(0, 2, 3).astype(np.float32)
        want = np.asarray(j_rotation_about(jnp.asarray(R), jnp.asarray(c)))
        np.testing.assert_allclose(rotation_about(t32(R), t32(c)).numpy(), want, atol=1e-6)


# ---------------------------------------------------------------------------
# data/scan.py::depth_hw, ops/pointcloud.py
# ---------------------------------------------------------------------------


def small_scan(F=3, seed=5):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(500, 4000, (F, 24, 32)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.2] = 0.0
    intr = np.tile(np.array([[500.0, 510.0, 320.0, 240.0]], np.float32), (F, 1)) + rng.normal(0, 5, (F, 4)).astype(np.float32)
    wh = np.tile(np.array([[640.0, 480.0]], np.float32), (F, 1))
    q = Rotation.random(F, random_state=seed).as_quat().astype(np.float32)
    poses = np.concatenate([rng.normal(0, 1, (F, 3)).astype(np.float32), q], 1)
    rgb = rng.integers(0, 255, (F, 32, 32, 3), dtype=np.uint8)
    return dict(rgb=rgb, depth=depth, intrinsics=intr, rgb_size=wh, poses=poses)


def test_depth_hw_is_the_reference_property():
    s = small_scan()
    assert Scan(**s).depth_hw == JScan(**s).depth_hw == (24, 32)


def test_depth_to_points_matches_jax():
    s = small_scan()
    for pose in (None, s["poses"][1]):
        got, ok = PC.depth_to_points(t32(s["depth"][1]), 40.0, 41.0, 16.0, 12.0,
                                     pose=None if pose is None else t32(pose))
        want, w_ok = JPC.depth_to_points(jnp.asarray(s["depth"][1]), 40.0, 41.0, 16.0, 12.0,
                                         pose=None if pose is None else jnp.asarray(pose))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(w_ok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_scan_to_pointcloud_matches_jax():
    s = small_scan(F=4)
    got, ok = PC.scan_to_pointcloud(s["depth"], s["intrinsics"], s["rgb_size"], s["poses"], device="cpu")
    want, w_ok = JPC.scan_to_pointcloud(jnp.asarray(s["depth"]), jnp.asarray(s["intrinsics"]),
                                        jnp.asarray(s["rgb_size"]), jnp.asarray(s["poses"]))
    assert got.shape == (4, 24 * 32, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(ok.numpy(), np.asarray(w_ok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# utils/transformations.py, utils/visualisation.py, data/poses.py
# ---------------------------------------------------------------------------


def test_transforms_match_jax_within_1e6():
    frame, df = pose_tables()
    pose = frame[["tx", "ty", "tz", "qx", "qy", "qz", "qw"]].to_numpy(np.float32)[2]
    got, want = Transforms(device="cpu"), JTransforms()
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),  # noqa: E731
                                                    atol=1e-6)
    close(got.get_transformation_matrix(pose), want.get_transformation_matrix(pose))
    close(got.get_translation(pose), want.get_translation(pose))
    close(got.get_rotation(pose), want.get_rotation(pose))
    close(got.get_camera_direction(frame), want.get_camera_direction(df))
    bbox = [10.5, 20.25, 100.0, 80.0, 1, 0.9, 0]
    a, b = got.scale_bounding_box(bbox, (640, 480), (256, 192)), want.scale_bounding_box(bbox, (640, 480), (256, 192))
    close(a[:4], b[:4])
    assert a[4:] == b[4:]
    close(got.bbox_to_3d(bbox), want.bbox_to_3d(bbox))
    depth = np.arange(64 * 48, dtype=np.float32).reshape(48, 64)
    close(got._depth_to_3d(12, 30, depth, 500, 510, 32, 24, 1000.0),
          want._depth_to_3d(12, 30, depth, 500, 510, 32, 24, 1000.0))
    quad = [np.array([0, 0, 3], np.float32), np.array([0, 1, 3.1], np.float32),
            np.array([1, 1, 3.2], np.float32), np.array([1, 0, 3.05], np.float32)]
    close(got.create_3d_bounding_box(quad, 0.03), want.create_3d_bounding_box(quad, 0.03))


def assert_same(a, b):
    """Nested dicts/lists/arrays equal, dtypes included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a == b


def test_visualiser_helpers_identical():
    rng = np.random.default_rng(6)
    got, want = Visualiser(), JVis()
    rgb_f = rng.random((3, 24, 32)).astype(np.float32)  # channel-first floats
    depth = rng.uniform(0, 3000, (24, 32)).astype(np.float32)
    depth[:3] = 0.0
    assert_same(got.parse_images(rgb_f, depth), want.parse_images(rgb_f, depth))
    rgbd = got.gen_rgbd(rgb_f, depth)
    assert_same(rgbd, want.gen_rgbd(rgb_f, depth))
    intr = {"fx": 40.0, "fy": 41.0, "cx": 16.0, "cy": 12.0}
    ext = np.linalg.inv(np.asarray(Transforms(device="cpu").get_transformation_matrix(
        [0.1, -0.2, 0.3, 0.1, 0.2, 0.3, 0.9]), np.float64))
    assert_same(got.gen_point_cloud(rgbd, intr, ext), want.gen_point_cloud(rgbd, intr, ext))
    corners8 = rng.normal(0, 1, (8, 3)).astype(np.float32)
    assert_same(got.overlay_3d_bbox(corners8, (0, 1, 0)), want.overlay_3d_bbox(corners8, (0, 1, 0)))
    frame, df = pose_tables()
    assert_same(got.overlay_pose(frame), want.overlay_pose(df))
    arr = frame[["tx", "ty", "tz", "qx", "qy", "qz", "qw"]].to_numpy(np.float32)
    assert_same(got.overlay_pose(arr), want.overlay_pose(arr))
    dirs = rng.normal(0, 1, (5, 3)).astype(np.float32)
    assert_same(got.overlay_pose_directions(arr[:, :3], dirs), want.overlay_pose_directions(arr[:, :3], dirs))
    R = Rotation.random(random_state=7).as_matrix().astype(np.float32)
    t = np.array([0.5, -1.0, 2.0], np.float32)
    assert_same(got._overlay_camera_frustum(t, R, 200.0, 210.0, 256, 192),
                want._overlay_camera_frustum(t, R, 200.0, 210.0, 256, 192))


def test_display_imgs_logs_display_unavailable(caplog):
    with caplog.at_level(logging.WARNING):
        Visualiser().display_imgs(np.zeros((4, 4, 3), np.uint8), np.zeros((4, 4)), [[0, 0, 2, 2]], 0)
    assert "display unavailable" in caplog.text


def test_pose_data_extractor_matches_jax():
    got, want = PoseDataExtractor(POSES), JPoses(POSES)
    frame, df = got.fetch_data(), want.fetch_data()
    assert frame.columns == list(df.columns)
    for c in df.columns:
        np.testing.assert_array_equal(frame[c], df[c].to_numpy())
    # without Open3D the reference returns the trajectory cloud
    assert_same(got.plot_pose(frame), want.plot_pose(df))


# ---------------------------------------------------------------------------
# mapper/projection.py::frame_view_geometry, mapper/mapping.py's viewer
# ---------------------------------------------------------------------------


def test_frame_view_geometry_matches_jax():
    s = small_scan(F=3, seed=8)
    rng = np.random.default_rng(9)
    corners = rng.normal(0, 1, (3, 4, 4, 3)).astype(np.float32)
    mask = np.array([[True, False, True, True], [False] * 4, [True, True, False, False]])
    cols = dict(damage=np.zeros((3, 4), np.int32), conf=np.full((3, 4), 0.9, np.float32),
                label=np.ones((3, 4), np.int32), mask=mask)
    for f in range(3):
        got = frame_view_geometry(Scan(**s), GlobalBoxes(corners=corners, **cols), f, device="cpu")
        want = j_view(JScan(**s), JBoxes(corners=corners, **cols), f)
        assert got["cloud_points"].shape == want["cloud_points"].shape
        np.testing.assert_allclose(got["cloud_points"], want["cloud_points"], atol=1e-5)
        assert len(got["boxes"]) == len(want["boxes"]) == int(mask[f].sum())
        for a, b in zip(got["boxes"], want["boxes"]):
            np.testing.assert_allclose(a, b, atol=1e-5)
        assert got["frustum"]["lines"] == want["frustum"]["lines"]
        np.testing.assert_allclose(got["frustum"]["points"], want["frustum"]["points"], atol=1e-6)


def test_map_viewer_follows_the_reference_without_open3d(tmp_path):
    """The reference opens its Open3D viewer only where Open3D imports; it
    does not here, and the port has no viewer: ``make_point_cloud`` and
    ``make_mesh`` return what the JAX package returns, and open nothing."""
    assert JMap._o3d is None
    assert not hasattr(PMap.Mapping, "_visualiser") and not hasattr(PMap, "_o3d")
    ply = os.path.join(FIXTURES, "torch_project", "data", "maintenance", "cloud.ply")
    frame, df = pose_tables()
    kw = dict(global_bboxes_data={}, optimised_bboxes={}, eps=0.1, min_points=50, ply_filepath=ply)
    port, ref = PMap.Mapping(pose=frame, device="cpu", **kw), JMap.Mapping(pose=df, **kw)
    np.testing.assert_array_equal(port.make_point_cloud(), ref.make_point_cloud())
    got, want = port.make_mesh(voxel=0.16), ref.make_mesh(voxel=0.16)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
