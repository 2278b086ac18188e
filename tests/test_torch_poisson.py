"""The port's FFT Poisson mesher against the JAX package on the CPU: the
noisy sphere of ``tests/test_meshing.py`` and the committed capture's gold
``cloud.ply`` (~45k points).

Bars, set before the comparison: the spectral solve on the same V within
1e-5 × max|χ| (pocketfft in both, summed in another order), the iso within
1e-5 relative, the grid's origin and voxel identical; the mesh's face count
within 0.5% and every vertex within 1e-3 m of the other mesh, both ways
(``chip_smoke.hold_mesh``); the cull's keep mask identical (the same C++). ``test_meshing.py``'s quality
gates hold on the port's mesh."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu3dlm.data.ply import load_ply
from tpu3dlm.mapper import poisson as JP
from tpu3dlm_torch.mapper import poisson as PP

CLOUD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_project", "data",
                     "gold_std", "cloud.ply")


def noisy_sphere(n=8000, noise=0.005, seed=0):
    """``test_meshing.py``'s sphere: sensor at the centre, normals toward it."""
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d + rng.randn(n, 3) * noise).astype(np.float32)
    return pts, (-d).astype(np.float32)


def test_next_fast_len_identical():
    assert [PP.next_fast_len(n) for n in range(1, 600)] == [JP.next_fast_len(n) for n in range(1, 600)]


@pytest.mark.parametrize("shape,voxel", [((24, 20, 16), 0.08), ((15, 9, 25), 0.04)])
def test_solve_indicator_within_1e5_of_max(shape, voxel):
    V = np.random.RandomState(4).randn(*shape, 3).astype(np.float32)
    want = np.asarray(JP._solve_indicator(jnp.asarray(V), voxel=voxel, sigma_voxels=1.5))
    got = PP._solve_indicator(torch.from_numpy(V), voxel=voxel, sigma_voxels=1.5)
    assert got.dtype == torch.float32 and got.shape == shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def sphere_case():
    return noisy_sphere(), 0.08, None


def cloud_case():
    pts, _ = load_ply(CLOUD)
    return (pts, None), 0.08, None


@pytest.mark.parametrize("case", [sphere_case, cloud_case])
def test_poisson_indicator_and_mesh_within_bars(case):
    (pts, normals), voxel, viewpoint = case()
    chi, lo, vox, iso = PP.poisson_indicator(pts, normals, voxel=voxel, viewpoint=viewpoint, device="cpu")
    w_chi, w_lo, w_vox, w_iso = JP.poisson_indicator(pts, normals, voxel=voxel, viewpoint=viewpoint)
    np.testing.assert_array_equal(lo, w_lo)
    assert vox == w_vox and chi.shape == w_chi.shape
    assert np.abs(chi - w_chi).max() <= 1e-5 * np.abs(w_chi).max()
    assert abs(iso - w_iso) <= 1e-5 * abs(w_iso)
    got = PP.mesh_poisson(pts, normals, voxel=voxel, device="cpu")
    assert len(got[1]) > 500
    chip_smoke.hold_mesh(got, JP.mesh_poisson(pts, normals, voxel=voxel), voxel)


def test_sphere_radius_and_winding_gates():
    """``test_meshing.py::test_sphere_radius_and_winding`` on the port."""
    pts, normals = noisy_sphere()
    verts, faces = PP.mesh_poisson(pts, normals, voxel=0.08, device="cpu")
    assert len(faces) > 500
    r = np.linalg.norm(verts, axis=1)
    assert abs(float(r.mean()) - 1.0) < 0.02
    assert float(np.quantile(np.abs(r - 1.0), 0.95)) < 0.08
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-9)
    cent = tri.mean(axis=1)
    cent /= np.maximum(np.linalg.norm(cent, axis=1, keepdims=True), 1e-9)
    assert float(((fn * cent).sum(axis=1) < 0).mean()) > 0.99


def test_estimated_normals_toward_a_viewpoint():
    """The no-normals path (grid PCA turned toward the viewpoint) lands on
    the sphere and within the bars of JAX's."""
    pts, _ = noisy_sphere()
    vp = np.zeros(3, np.float32)
    got = PP.mesh_poisson(pts, None, voxel=0.08, viewpoint=vp, device="cpu")
    assert len(got[1]) > 500
    assert abs(float(np.linalg.norm(got[0], axis=1).mean()) - 1.0) < 0.02
    chip_smoke.hold_mesh(got, JP.mesh_poisson(pts, None, voxel=0.08, viewpoint=vp), 0.08)


def test_cull_leakage_identical():
    pts, _ = load_ply(CLOUD)
    chi, origin, voxel, iso = PP.poisson_indicator(pts, voxel=0.08, device="cpu")
    from tpu3dlm_torch.mapper.meshing import marching_tetrahedra

    verts, faces = marching_tetrahedra(chi, iso, origin, voxel, normals_toward_positive=False)
    gv, gf = PP._cull_leakage(verts, faces, pts, origin, 2.0 * voxel)
    wv, wf = JP._cull_leakage(verts, faces, pts, origin, 2.0 * voxel)
    assert len(gf) < len(faces)  # the wraparound leakage is there to cull
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gf, wf)


def test_empty_cloud_and_cuda_by_default(monkeypatch):
    v, f = PP.mesh_poisson(np.zeros((0, 3), np.float32), device="cpu")
    assert v.shape == (0, 3) and f.shape == (0, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        PP.mesh_poisson(noisy_sphere()[0])


def test_normals_up_to_sign_and_identical_toward_a_viewpoint():
    """The port's normals against the JAX package's default route (its
    native core, which the port carries as ``csrc/host/normals.cpp``):
    identical, sign included, with and without a viewpoint, on the seed-0
    sphere and on the committed capture's cloud."""
    from tpu3dlm.ops.pointcloud import estimate_normals_grid as j_normals
    from tpu3dlm_torch.ops.pointcloud import estimate_normals_grid

    pts, _ = noisy_sphere(20000)
    np.testing.assert_array_equal(estimate_normals_grid(pts, 0.16), j_normals(pts, 0.16))
    vp = np.zeros(3, np.float32)
    np.testing.assert_array_equal(estimate_normals_grid(pts, 0.16, vp), j_normals(pts, 0.16, vp))
    cloud, _ = load_ply(CLOUD)
    np.testing.assert_array_equal(estimate_normals_grid(cloud, 0.16), j_normals(cloud, 0.16))
    vp = cloud.mean(axis=0)
    np.testing.assert_array_equal(estimate_normals_grid(cloud, 0.16, vp), j_normals(cloud, 0.16, vp))
