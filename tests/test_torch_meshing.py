"""The port's meshing modules against the JAX package on the CPU: mesh PLY
I/O, DBSCAN, the trilinear splat, marching tetrahedra, the density mesher,
``grid_bounds`` with its ladder, the overlay geometry, and TSDF fusion on
the committed capture (``tests/fixtures/torch_project``, 5 frames).

Bars: identical where the arithmetic is the same code (the C++ the JAX
package prefers, copied into ``tpu3dlm_torch/csrc/host``; numpy copied
verbatim); the geometry within 1e-6; the TSDF field, its NaN mask and its
mesh identical — the fusion follows the rounding of XLA's CPU program, so
no voxel flips pixel (the bound on flips is 0)."""

import os

import numpy as np
import pytest
import torch

from tpu3dlm.data import ply as JPLY
from tpu3dlm.mapper import clustering as JC
from tpu3dlm.mapper import meshing as JM
from tpu3dlm.ops import geometry as JG
from tpu3dlm_torch import native
from tpu3dlm_torch.data import dataset as PD
from tpu3dlm_torch.data import ply as PPLY
from tpu3dlm_torch.mapper import clustering as PC
from tpu3dlm_torch.mapper import meshing as PM
from tpu3dlm_torch.ops import geometry as PG

CAPTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_project", "data")


def blobs_and_noise(seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([
        rng.randn(1500, 3) * 0.05, rng.randn(900, 3) * 0.04 + [1.0, 0.2, 0.0],
        rng.randn(40, 3) * 0.03 + [-1.0, 1.0, 1.0], rng.uniform(-2, 2, (400, 3)),
    ]).astype(np.float32)


def sphere_field(n=20, r=6.5):
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    return r - np.sqrt(((g - n / 2) ** 2).sum(axis=0))


def load_capture(folder, img_size=128):
    ext = os.path.join(CAPTURE, folder, "rtabmap_extract")
    return PD.load_scan(os.path.join(ext, "data_rgb"), os.path.join(ext, "data_depth"),
                        os.path.join(ext, "calibration"), os.path.join(CAPTURE, folder, "poses.txt"),
                        img_size=img_size)


# ---------------------------------------------------------------------------
# PLY meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("colors", [False, True])
def test_ply_mesh_bytes_identical_and_round_trip(tmp_path, colors):
    rng = np.random.RandomState(1)
    verts = rng.randn(57, 3).astype(np.float32)
    faces = rng.randint(0, 57, (91, 3)).astype(np.int32)
    cols = rng.rand(57, 3).astype(np.float32) if colors else None
    PPLY.save_ply_mesh(str(tmp_path / "p.ply"), verts, faces, cols)
    JPLY.save_ply_mesh(str(tmp_path / "j.ply"), verts, faces, cols)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for load in (PPLY.load_ply_mesh, JPLY.load_ply_mesh):
        v, f = load(str(tmp_path / "p.ply"))
        assert v.dtype == np.float32 and f.dtype == np.int32
        np.testing.assert_array_equal(v, verts)
        np.testing.assert_array_equal(f, faces)


def test_ply_mesh_empty_and_truncated_header(tmp_path):
    PPLY.save_ply_mesh(str(tmp_path / "e.ply"), np.zeros((0, 3)), np.zeros((0, 3)))
    v, f = PPLY.load_ply_mesh(str(tmp_path / "e.ply"))
    assert v.shape == (0, 3) and f.shape == (0, 3)
    (tmp_path / "t.ply").write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n")
    with pytest.raises(ValueError, match="EOF"):
        PPLY.load_ply_mesh(str(tmp_path / "t.ply"))


# ---------------------------------------------------------------------------
# DBSCAN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eps,min_points", [(0.1, 10), (0.05, 5), (0.3, 50), (0.02, 1000)])
def test_dbscan_labels_identical(eps, min_points):
    pts = blobs_and_noise()
    got = PC.dbscan(pts, eps, min_points)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, JC.dbscan(pts, eps, min_points))
    np.testing.assert_array_equal(PC.largest_cluster(pts, eps, min_points),
                                  JC.largest_cluster(pts, eps, min_points))


def test_dbscan_empty_and_all_noise():
    assert PC.dbscan(np.zeros((0, 3), np.float32), 0.1, 5).shape == (0,)
    pts = blobs_and_noise()[-400:]
    assert (PC.dbscan(pts, 0.01, 50) == -1).all()
    np.testing.assert_array_equal(PC.largest_cluster(pts, 0.01, 50), np.arange(400))


# ---------------------------------------------------------------------------
# Splat, grid bounds, density mesher, marching tetrahedra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [None, 3])
def test_trilinear_scatter_bit_identical(channels):
    pts = blobs_and_noise()
    lo, dims, voxel = JM.grid_bounds(pts, 0.1)
    vals = None if channels is None else np.random.RandomState(2).randn(len(pts), channels).astype(np.float32)
    got = PM.trilinear_scatter(pts, vals, lo, dims, voxel)
    want = JM.trilinear_scatter(pts, vals, lo, dims, voxel)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # mass outside the grid clamps to the border voxel on both
    small = (4, 4, 4)
    np.testing.assert_array_equal(PM.trilinear_scatter(pts, vals, lo, small, voxel),
                                  JM.trilinear_scatter(pts, vals, lo, small, voxel))


def test_trilinear_scatter_refuses_mismatched_values():
    pts = blobs_and_noise()
    with pytest.raises(ValueError, match="values"):
        PM.trilinear_scatter(pts, np.zeros((3, 2), np.float32), np.zeros(3, np.float32), (4, 4, 4), 0.1)


@pytest.mark.parametrize("max_voxels", [40_000_000, 5000, 1000])
def test_grid_bounds_identical_on_the_ladder(max_voxels):
    pts = blobs_and_noise()
    got = PM.grid_bounds(pts, 0.02, pad=3, max_voxels=max_voxels)
    want = JM.grid_bounds(pts, 0.02, pad=3, max_voxels=max_voxels)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    if max_voxels < 40_000_000:
        assert got[2] > 0.02  # the ladder coarsened the voxel


def test_density_field_and_mesh_point_cloud_identical():
    pts = blobs_and_noise()
    for voxel in (0.05, 0.1):
        got, want = PM.density_field(pts, voxel), JM.density_field(pts, voxel)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        gv, gf = PM.mesh_point_cloud(pts, voxel)
        wv, wf = JM.mesh_point_cloud(pts, voxel)
        assert len(gf) > 1000
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gf, wf)
    ev, ef = PM.mesh_point_cloud(np.zeros((0, 3), np.float32))
    assert ev.shape == (0, 3) and ef.shape == (0, 3)


def _canon(v, f):
    """Order-free triangle keys: each face's vertices sorted, rounded to 1e-3."""
    t = np.sort(np.round(v[f], 3), axis=1)
    return set(map(tuple, t.reshape(len(f), 9).tolist()))


@pytest.mark.parametrize("toward", [True, False])
def test_marching_tetrahedra_identical_to_native_and_numpy_set(toward):
    field = sphere_field()
    field[10, 10, 4] = np.nan  # the crossing cubes touching a NaN corner emit nothing
    origin = np.array([0.3, -1.2, 2.0], np.float32)
    gv, gf = PM.marching_tetrahedra(field, 0.0, origin, 0.05, normals_toward_positive=toward)
    wv, wf = JM.marching_tetrahedra(field, 0.0, origin, 0.05, normals_toward_positive=toward)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gf, wf)
    nv, nf = JM.marching_tetrahedra(field, 0.0, origin, 0.05, normals_toward_positive=toward,
                                    use_native=False)
    assert gv.shape == nv.shape and gf.shape == nf.shape
    assert _canon(gv, gf) == _canon(nv, nf)
    # unwelded: three vertices per face
    uv, uf = PM.marching_tetrahedra(field, 0.0, origin, 0.05, weld=False)
    assert len(uv) == 3 * len(uf)


def test_marching_tetrahedra_degenerate_fields():
    v, f = PM.marching_tetrahedra(np.zeros((1, 5, 5), np.float32), 0.5, np.zeros(3), 0.1)
    assert v.shape == (0, 3) and f.shape == (0, 3)
    v, f = PM.marching_tetrahedra(np.ones((4, 4, 4), np.float32), 0.5, np.zeros(3), 0.1)
    assert len(f) == 0
    with pytest.raises(ValueError, match="3-D"):
        PM.marching_tetrahedra(np.ones((4, 4), np.float32), 0.5, np.zeros(3), 0.1)


def test_cull_keep_mask_identical_to_native_and_numpy():
    from tpu3dlm.native import native_cull_keep_mask

    field = sphere_field()
    origin = np.zeros(3, np.float32)
    verts, faces = PM.marching_tetrahedra(field, 0.0, origin, 0.1)
    pts = verts[::3] + np.float32(0.01)
    pts = pts[pts[:, 0] < 1.0]  # half the shell unsupported → culled
    cell = 0.2
    span = np.maximum(2, np.ceil((pts.max(axis=0) - origin) / cell).astype(np.int64) + 2)
    keep = native.cull_keep_mask(verts, faces, pts, origin, cell, span)
    np.testing.assert_array_equal(keep, native_cull_keep_mask(verts, faces, pts, origin, cell, span))
    assert 0 < keep.sum() < len(keep)
    with pytest.raises(ValueError, match="out of range"):
        native.cull_keep_mask(verts, faces + len(verts), pts, origin, cell, span)


# ---------------------------------------------------------------------------
# Geometry of the overlays
# ---------------------------------------------------------------------------


def test_invert_se3_camera_direction_and_box_within_1e6():
    rng = np.random.RandomState(3)
    poses = np.concatenate([rng.randn(6, 3), rng.randn(6, 4)], axis=1).astype(np.float32)
    T = PG.pose_to_matrix(torch.from_numpy(poses))
    Ti = PG.invert_se3(T)
    for k in range(6):
        np.testing.assert_allclose(Ti[k].numpy(), np.asarray(JG.invert_se3(JG.pose_to_matrix(poses[k]))),
                                   atol=1e-6)
        np.testing.assert_allclose(PG.camera_direction(torch.from_numpy(poses[k])).numpy(),
                                   np.asarray(JG.camera_direction(poses[k])), atol=1e-6)
    np.testing.assert_allclose((Ti @ T).numpy(), np.broadcast_to(np.eye(4), (6, 4, 4)), atol=1e-5)
    quads = rng.randn(5, 4, 3).astype(np.float32)
    got = PG.create_3d_bounding_box(torch.from_numpy(quads), 0.03).numpy()
    assert got.shape == (5, 8, 3)
    for k in range(5):
        np.testing.assert_allclose(got[k], np.asarray(JG.create_3d_bounding_box(quads[k], 0.03)), atol=1e-6)


# ---------------------------------------------------------------------------
# TSDF fusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("folder", ["gold_std", "maintenance"])
@pytest.mark.parametrize("voxel", [0.08, 0.04])
def test_tsdf_identical_to_jax_on_the_capture(folder, voxel):
    scan = load_capture(folder)
    field, lo, vox = PM.tsdf_from_scan(scan, voxel, device="cpu")
    want, want_lo, want_vox = JM.tsdf_from_scan(scan, voxel)
    np.testing.assert_array_equal(lo, want_lo)
    assert vox == want_vox and field.shape == want.shape and field.dtype == np.float32
    nan, want_nan = np.isnan(field), np.isnan(want)
    flips = int((nan != want_nan).sum())
    assert flips == 0, f"{flips} voxels observed on one side only (pixel-rounding flips)"
    assert 0.5 < (~nan).mean() < 1.0  # the capture leaves some voxels unobserved
    np.testing.assert_allclose(field[~nan], want[~nan], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(field, want)  # measured: the same bits
    gv, gf = PM.mesh_scan(scan, voxel, device="cpu")
    wv, wf = JM.mesh_scan(scan, voxel)
    assert len(gf) > 1000
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gf, wf)


def test_tsdf_ladder_keeps_an_explicit_trunc_and_bounds():
    scan = load_capture("gold_std")
    lo, hi = np.array([-1.0, -1.5, 1.0], np.float32), np.array([2.5, 1.5, 3.5], np.float32)
    for trunc in (None, 0.3):
        got = PM.tsdf_from_scan(scan, 0.02, trunc=trunc, bounds=(lo, hi), max_voxels=60_000, device="cpu")
        want = JM.tsdf_from_scan(scan, 0.02, trunc=trunc, bounds=(lo, hi), max_voxels=60_000)
        assert got[2] == want[2] and got[2] > 0.02 and got[0].size <= 60_000
        np.testing.assert_array_equal(got[1], lo)
        np.testing.assert_array_equal(got[0], want[0])


def test_tsdf_without_depth_raises_and_cuda_is_the_default(monkeypatch):
    scan = load_capture("gold_std")
    empty = PD.Scan(rgb=scan.rgb, depth=np.zeros_like(scan.depth), intrinsics=scan.intrinsics,
                    rgb_size=scan.rgb_size, poses=scan.poses)
    with pytest.raises(ValueError, match="no valid depth"):
        PM.tsdf_from_scan(empty, 0.08, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        PM.mesh_scan(scan, 0.08)
