"""The port's ICP, init scoring, host init helpers and grid normals
(``tpu3dlm_torch.ops.icp``, ``ops.pointcloud``, ``ops.geometry.so3_exp``)
against the JAX package on the CPU, with the same numpy inputs. Scenes are
those of tests/test_icp_matching.py."""

import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm.ops import geometry as JG
from tpu3dlm.ops import icp as J
from tpu3dlm.ops import pointcloud as JP
from tpu3dlm_torch.ops import icp as P
from tpu3dlm_torch.ops.geometry import so3_exp
from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors
from tpu3dlm_torch.ops.pointcloud import estimate_normals_grid

torch.set_num_threads(1)

T_TOL = 1e-4  # transforms and recorded steps
M_TOL = 1e-5  # rmse and inlier fraction


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def rot_z(angle, trans):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(angle), np.sin(angle)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = trans
    return T


def planar_scene(rng, n=6000):
    """Three perpendicular planes + an offset patch (TestPointToPlaneICP)."""
    wall = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), np.full(n, 2.0)], axis=1)
    floor = np.stack([rng.uniform(-2, 2, n // 2), np.full(n // 2, 1.0),
                      rng.uniform(1.0, 2.0, n // 2)], axis=1)
    side = np.stack([np.full(n // 2, -2.0), rng.uniform(-1, 1, n // 2),
                     rng.uniform(1.0, 2.0, n // 2)], axis=1)
    patch = np.stack([rng.uniform(0.8, 1.2, n // 10), rng.uniform(0.1, 0.5, n // 10),
                      np.full(n // 10, 1.85)], axis=1)
    return np.concatenate([wall, floor, side, patch]).astype(np.float32)


def assert_same_result(got, want, steps=True):
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), rtol=0, atol=T_TOL)
    if steps:
        np.testing.assert_allclose(
            got.step_transforms.numpy(), np.asarray(want.step_transforms), rtol=0, atol=T_TOL
        )
    w_rmse, g_rmse = float(want.rmse), float(got.rmse)
    if np.isinf(w_rmse):
        assert np.isinf(g_rmse)
    elif w_rmse < 1e-3:
        # an exact-copy scene converges to rmse ≈ 0, where each d² is the
        # f32 rounding of |a|² − 2a·b + |b|² (~1e-7 m²) and the square root
        # magnifies it: compare the mean squared residual at that rounding
        assert abs(g_rmse**2 - w_rmse**2) <= 1e-7
    else:
        assert abs(g_rmse - w_rmse) <= M_TOL
    assert abs(float(got.inlier_frac) - float(want.inlier_frac)) <= M_TOL


def test_so3_exp_matches_jax():
    for w in ([0.3, -0.2, 0.5], [1e-9, 0.0, 0.0], [0.0, 0.0, 3.0], [1e-4, 2e-4, -1e-4]):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            so3_exp(t(w)).numpy(), np.asarray(JG.so3_exp(jnp.asarray(w))), rtol=0, atol=1e-6
        )


def test_kabsch_matches_jax(rng):
    src = rng.normal(size=(60, 3)).astype(np.float32)
    T = rot_z(0.7, [0.3, -0.2, 0.5])
    dst = src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 1e-3, (60, 3)).astype(np.float32)
    w = (rng.uniform(size=60) > 0.2).astype(np.float32)
    got = P.kabsch(t(src), t(dst), t(w)).numpy()
    want = np.asarray(J.kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, T, rtol=0, atol=1e-2)
    # a reflection in the data still gives a proper rotation
    mirrored = dst * np.asarray([1, 1, -1], np.float32)
    R = P.kabsch(t(src), t(mirrored), t(np.ones(60, np.float32))).numpy()[:3, :3]
    assert np.linalg.det(R) > 0.999


@pytest.mark.parametrize("case", ["recover", "compose", "zero_inliers", "one_iteration"])
def test_icp_matches_jax(case):
    """The TestICP scenes: transform, every step, rmse and inlier fraction."""
    rng = np.random.default_rng(11)
    target = rng.uniform(-1, 1, size=(800, 3)).astype(np.float32)
    kw = dict(iterations=30, max_correspondence_dist=1.0)
    if case == "recover":
        Ti = np.linalg.inv(rot_z(0.15, [0.1, -0.05, 0.08]))
        source = target @ Ti[:3, :3].T + Ti[:3, 3]
    elif case == "compose":
        source = target + np.asarray([0.3, 0.1, -0.2], np.float32)
        kw = dict(iterations=10)
    elif case == "zero_inliers":
        source = target + np.asarray([500.0, 0.0, 0.0], np.float32)
        kw = dict(iterations=3, max_correspondence_dist=0.05)
    else:
        source = target + np.asarray([0.4, 0.0, 0.0], np.float32)
        kw = dict(iterations=1, max_correspondence_dist=0.5)
    source = source.astype(np.float32)
    got = P.icp(t(source), t(target), **kw)
    want = J.icp(jnp.asarray(source), jnp.asarray(target), **kw)
    assert_same_result(got, want)
    assert got.step_transforms.shape == (kw["iterations"], 4, 4)
    if case == "compose":
        T = torch.eye(4)
        for s in got.step_transforms:
            T = s @ T
        np.testing.assert_allclose(T.numpy(), got.transform.numpy(), atol=1e-5)


@pytest.mark.parametrize("partial", [False, True])
def test_point_to_plane_matches_jax(partial):
    """Centroid init, then radii (0.6, 0.15) × 25 iterations, on the full
    and the partial-overlap planar scene; the same normals for both."""
    rng = np.random.default_rng(2)
    base = planar_scene(rng, 3000)
    if partial:
        base = base[base[:, 0] < 1.0]
    T = rot_z(0.08 if partial else 0.1, [0.2, -0.1, 0.08] if partial else [0.25, -0.15, 0.1])
    comp = planar_scene(np.random.default_rng(7), 3000) @ T[:3, :3].T + T[:3, 3]
    src = comp[rng.choice(comp.shape[0], 1024, replace=False)].astype(np.float32)
    normals = estimate_normals_grid(base, voxel=0.15)
    T_run = P.centroid_align_np(src, base)
    got_T, want_T = t(T_run), jnp.asarray(T_run)
    for d in (0.6, 0.15):
        got = P.icp_point_to_plane(t(src), t(base), t(normals), init_transform=got_T,
                                   max_correspondence_dist=d, iterations=25)
        want = J.icp_point_to_plane(jnp.asarray(src), jnp.asarray(base), jnp.asarray(normals),
                                    init_transform=want_T, max_correspondence_dist=d,
                                    iterations=25)
        assert_same_result(got, want)
        got_T, want_T = got.transform, want.transform
    assert np.abs(got_T.numpy() @ T - np.eye(4)).max() < 0.06


def test_skipping_the_measurement_keeps_the_solve():
    rng = np.random.default_rng(4)
    target = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    source = target + np.asarray([0.2, -0.1, 0.05], np.float32)
    before = nearest_neighbors.launches
    full = P.icp(t(source), t(target), iterations=8)
    lean = P.icp(t(source), t(target), iterations=8, _measure=False)
    assert nearest_neighbors.launches == before  # CPU tensors: the twin
    torch.testing.assert_close(lean.transform, full.transform, rtol=0, atol=0)
    torch.testing.assert_close(lean.step_transforms, full.step_transforms, rtol=0, atol=0)
    assert lean.rmse is None and lean.inlier_frac is None


def test_converged_iterations_are_identity():
    rng = np.random.default_rng(8)
    target = rng.uniform(-1, 1, size=(400, 3)).astype(np.float32)
    source = target + np.asarray([0.05, 0.0, 0.0], np.float32)
    res = P.icp(t(source), t(target), iterations=20, early_stop_tol=1e-3)
    mags = [float(P._increment_magnitude(s)) for s in res.step_transforms]
    first = next(i for i, m in enumerate(mags) if m < 1e-3)
    assert first < 19
    eye = torch.eye(4).expand(20 - first - 1, 4, 4)
    torch.testing.assert_close(res.step_transforms[first + 1:], eye, rtol=0, atol=0)


def test_init_residuals_batched_matches_jax():
    rng = np.random.default_rng(9)
    target = planar_scene(rng, 3000)
    source = planar_scene(np.random.default_rng(10), 3000)[:2048]
    Ts = np.stack([rot_z(a, [0.1 * a, 0.0, -0.05]) for a in (0.0, 0.5, 3.0, -1.2, 0.1)])
    got = P.init_residuals_batched(t(source), t(target), t(Ts)).numpy()
    want = np.asarray(J.init_residuals_batched(jnp.asarray(source), jnp.asarray(target),
                                               jnp.asarray(Ts)))
    assert got.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_target", [700, 300_000])  # below and above the moment cap
def test_host_init_helpers_identical(n_target):
    rng = np.random.default_rng(12)
    s = rng.normal(0, [3.0, 1.0, 0.3], (2000, 3)).astype(np.float32)
    tgt = rng.normal(2, [1.0, 2.0, 0.4], (n_target, 3)).astype(np.float32)
    np.testing.assert_array_equal(P._moment_sample(tgt), J._moment_sample(tgt))
    for got, want in zip(P.target_moments_np(tgt), J.target_moments_np(tgt)):
        np.testing.assert_array_equal(got, want)
    moments = P.target_moments_np(tgt)
    for kw in ({}, {"target_moments": moments}):
        np.testing.assert_array_equal(P.centroid_align_np(s, tgt, **kw),
                                      J.centroid_align_np(s, tgt, **kw))
        np.testing.assert_array_equal(P.pca_init_candidates_np(s, tgt, **kw),
                                      J.pca_init_candidates_np(s, tgt, **kw))


@pytest.mark.parametrize("n", [5, 1024, 1025, 70000])
def test_pad_target_bucket_identical(n):
    rng = np.random.default_rng(n)
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (n, 1))
    assert P.PAD_SENTINEL == J.PAD_SENTINEL
    for normals in (None, nrm):
        got, want = P.pad_target_bucket(pts, normals), J.pad_target_bucket(pts, normals)
        np.testing.assert_array_equal(got[0], want[0])
        if normals is None:
            assert got[1] is None and want[1] is None
        else:
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("voxel", [0.08, 0.25])
def test_grid_normals_match_jax_numpy_path(voxel):
    """The port's plain twin (``estimate_normals_grid_numpy``) is the JAX
    package's numpy path (its native core patched out, as
    tests/test_native.py:214): identical, with and without a viewpoint. The
    main path's C++ core agrees with both up to sign: |n·n_ref| > 0.999 on
    ≥ 99.9% of points."""
    from tpu3dlm_torch.ops.pointcloud import estimate_normals_grid_numpy

    rng = np.random.default_rng(13)
    pts = planar_scene(rng, 4000)
    pts += rng.normal(0, 2e-3, pts.shape).astype(np.float32)
    twin = estimate_normals_grid_numpy(pts, voxel=voxel)
    vp = np.array([0.5, 0.0, -1.0], np.float32)
    with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None):
        want = JP.estimate_normals_grid(pts, voxel=voxel)
        want_vp = JP.estimate_normals_grid(pts, voxel=voxel, viewpoint=vp)
    np.testing.assert_array_equal(twin, want)
    np.testing.assert_array_equal(estimate_normals_grid_numpy(pts, voxel=voxel, viewpoint=vp), want_vp)
    got = estimate_normals_grid(pts, voxel=voxel)
    assert got.shape == want.shape and got.dtype == np.float32
    agree = np.abs(np.einsum("ij,ij->i", got, want))
    assert (agree > 0.999).mean() >= 0.999


def test_grid_normals_degenerate_and_viewpoint():
    assert estimate_normals_grid(np.zeros((0, 3), np.float32)).shape == (0, 3)
    for k in (1, 2):
        n = estimate_normals_grid(np.ones((k, 3), np.float32))
        np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)
    rng = np.random.default_rng(14)
    pts = np.stack([rng.uniform(-1, 1, 500), rng.uniform(-1, 1, 500), np.full(500, 3.0)], 1)
    n = estimate_normals_grid(pts.astype(np.float32), voxel=0.3, viewpoint=np.zeros(3))
    assert (n[:, 2] < 0).all()
