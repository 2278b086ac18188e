"""The renderer (``utils/render.py``) and the alignment animation
(``alignment/visualise.py``) against the JAX package on the CPU.

Bars: ``look_at``, ``orbit_eye`` and ``_bary_lattice`` identical and every
rendered frame byte-identical to the JAX package's on the same inputs.
``VisualiseAlignment`` on the same clouds and recorded steps (matrices, an
(R, center) rotation, identity padding, an ICP-sized increment): the same
meshes and frame count, each increment T^(1/steps) within 1e-5, and the
frames byte-identical while the increments are bit-identical. The
ICP-sized increment's cos differs by one ulp between XLA and PyTorch
(5.96e-8); from there the renderer's non-stable ``argsort`` resolves the
z-ties of shared vertices in another order, so the frames are held by
``chip_smoke.hold_frames``: at most 0.1% of the pixels on another surface
(background, gold, comparison; measured 0 here, ≤ 0.0007% on the whole
scene at 480 × 640), and the differing pixels within a surface counted
(measured here up to 1.6% of a frame on the density mesh and 11.1% on the
Poisson mesh; 9.8% on the whole scene at 480 × 640; ROADMAP §C). The same
holds with the
JAX package's Poisson meshes given to both (the port's own Poisson mesh of
a planar wall differs by FFT rounding, ROADMAP §C, so the port's own
Poisson animation is held to the frame count only)."""

import numpy as np
import pytest

import chip_smoke
from tpu3dlm.alignment import visualise as JVis
from tpu3dlm.utils import render as jax_render
from tpu3dlm_torch.alignment import visualise as PVis
from tpu3dlm_torch.alignment.visualise import VisualiseAlignment
from tpu3dlm_torch.utils import render as port_render


def random_meshes(seed: int, n: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        verts = (rng.normal(0, 0.5, (60, 3)) + [0.3 * k, 0, 3.0]).astype(np.float32)
        faces = rng.integers(0, 60, (90, 3))
        out.append((verts, faces, tuple(rng.uniform(0, 1, 3))))
    return out


def test_look_at_orbit_and_lattice_identical():
    c = np.array([0.2, -0.1, 3.0], np.float32)
    for az in np.linspace(-1.5, 1.5, 7):
        for el in (0.35, np.pi / 2, -np.pi / 2):  # ±90° takes the parallel-up branch
            eye = port_render.orbit_eye(c, 4.0, az, el)
            np.testing.assert_array_equal(eye, jax_render.orbit_eye(c, 4.0, az, el))
            np.testing.assert_array_equal(port_render.look_at(eye, c), jax_render.look_at(eye, c))
    for level in (1, 2, 3, 5):
        np.testing.assert_array_equal(port_render._bary_lattice(level), jax_render._bary_lattice(level))


@pytest.mark.parametrize("kw", [{}, {"focal": 300.0, "splat": 3, "lattice_level": 4}, {"background": 0}])
def test_render_scene_byte_identical(kw):
    meshes = random_meshes(3)
    c = np.array([0.3, 0.0, 3.0], np.float32)
    for az in (-0.4, 0.0, 0.45):
        view = port_render.look_at(port_render.orbit_eye(c, 3.5, az), c)
        got = port_render.render_scene(meshes, view, (96, 128), **kw)
        want = jax_render.render_scene(meshes, view, (96, 128), **kw)
        assert got.dtype == np.uint8 and got.shape == (96, 128, 3)
        assert got.tobytes() == want.tobytes()
    # a mesh in front of and behind the camera, one empty, none at all
    behind = (np.array([[0, 0, -1], [1, 0, -1], [0, 1, 2]], np.float32), np.array([[0, 1, 2]]), (1, 0, 0))
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64), (0, 1, 0))
    view = np.eye(4, dtype=np.float32)
    for scene in ([behind, empty], [empty], []):
        assert port_render.render_scene(scene, view, (32, 40), **kw).tobytes() == \
            jax_render.render_scene(scene, view, (32, 40), **kw).tobytes()


SMALL = dict(max_points=4000, mesh_voxel=0.12)  # the seeded subsample, a coarse mesh


def scene_and_steps():
    """A ~21k-point two-scan scene and a record of the forms the alignment
    writes: a translation, an (R, center) rotation, identity padding, an
    ICP-sized increment."""
    base, comp, _, _, Tw = chip_smoke.two_scan_scene(20000)
    Ti = np.linalg.inv(Tw).astype(np.float32)
    slide = np.eye(4, dtype=np.float32)
    slide[:3, 3] = Ti[:3, 3]
    small = np.eye(4, dtype=np.float32)
    small[:3, :3] = [[np.cos(0.01), -np.sin(0.01), 0], [np.sin(0.01), np.cos(0.01), 0], [0, 0, 1]]
    small[:3, 3] = [0.003, -0.002, 0.001]
    steps = [slide, (Ti[:3, :3].copy(), np.array([0.5, 0.0, 3.0], np.float32)), np.eye(4, dtype=np.float32),
             small, np.eye(4, dtype=np.float32)]
    return base, comp, steps


def hold_increments(port, ref, steps):
    for t in VisualiseAlignment.moving_steps(steps):
        want = np.asarray(JVis.se3_interpolate(JVis.jnp.asarray(ref._as_matrix(t)), JVis.jnp.float32(1 / 5)))
        np.testing.assert_allclose(port.increment(t, 5), want, atol=1e-5)


@pytest.mark.parametrize("renderer", ["mesh", "splat"])
def test_animation_frames_identical_to_jax(tmp_path, renderer):
    base, comp, steps = scene_and_steps()
    kw = dict(image_hw=(60, 80), renderer=renderer, **SMALL)
    port = VisualiseAlignment(base, comp, device="cpu", **kw)
    ref = JVis.VisualiseAlignment(base, comp, **kw)
    assert port.uses_mesh == ref.uses_mesh == (renderer == "mesh")
    if renderer == "mesh":
        for a, b in zip(port.base_mesh + port.comp_mesh, ref.base_mesh + ref.comp_mesh):
            np.testing.assert_array_equal(a, b)
    hold_increments(port, ref, steps)
    n = port.create_video(steps, str(tmp_path / "p.mp4"), steps=5)
    assert n == ref.create_video(steps, str(tmp_path / "j.mp4"), steps=5) == 5 * 3  # the identities are dropped
    held = chip_smoke.hold_frames(port.frames, ref.frames)
    # the first two steps' increments are bit-identical, so are their frames
    assert held["identical_frames"] >= 10 and held["max_surface_share"] <= 1e-3
    assert port.written in (str(tmp_path / "p.mp4"), str(tmp_path / "p.mp4.npz"))
    if port.written.endswith(".npz"):  # no mp4 encoder: the frames themselves
        np.testing.assert_array_equal(np.load(port.written)["frames"], np.stack(port.frames))


def test_poisson_animation_replays_like_jax(tmp_path):
    base, comp, steps = scene_and_steps()
    kw = dict(image_hw=(60, 80), mesher="poisson", **SMALL)
    port = VisualiseAlignment(base, comp, device="cpu", **kw)
    ref = JVis.VisualiseAlignment(base, comp, **kw)
    assert port.uses_mesh and ref.uses_mesh
    n = ref.create_video(steps, str(tmp_path / "j.mp4"), steps=5)
    assert port.create_video(steps, str(tmp_path / "own.mp4"), steps=5) == n == 15
    port.frames.clear()
    port.base_mesh, port.comp_mesh = ref.base_mesh, ref.comp_mesh  # the same meshes on both sides
    port.create_video(steps, str(tmp_path / "p.mp4"), steps=5)
    held = chip_smoke.hold_frames(port.frames, ref.frames)
    assert held["identical_frames"] >= 10 and held["max_surface_share"] <= 1e-3


def test_nothing_to_animate(tmp_path):
    base, comp, _ = scene_and_steps()
    port = VisualiseAlignment(base, comp, image_hw=(24, 32), renderer="splat", device="cpu")
    assert port.create_video([], str(tmp_path / "v.mp4")) == 0 and not list(tmp_path.iterdir())
    with pytest.raises(ValueError, match="unknown mesher"):
        VisualiseAlignment(base, comp, mesher="marching", device="cpu")
    assert PVis._BASE_COLOR == JVis._BASE_COLOR and PVis._COMP_COLOR == JVis._COMP_COLOR
