"""The port's image ops (``tpu3dlm_torch/ops/image.py``) against the JAX
package's (``tpu3dlm/ops/image.py``) on the CPU, function by function, on
the same seeded numpy inputs: f32 pixels in [0, 1] within 1e-5, and the
homography within 1e-5 relative to its largest entry. Sample coordinates
run past every edge, so the clamps are held too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm.ops import image as J
from tpu3dlm_torch.ops import image as P

torch.set_num_threads(1)

PIX = 1e-5  # f32 pixels on the 0–1 scale
H_REL = 1e-5  # homographies, relative to the largest entry


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, want, tol=PIX):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def frames(n, h=40, w=48, c=3, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, h, w, c)).astype(np.float32)


def random_boxes(rng, shape, h=40, w=48):
    """Boxes that start before the frame and end past it as well as inside."""
    x1 = rng.uniform(-4, w, shape)
    y1 = rng.uniform(-4, h, shape)
    return np.stack([x1, y1, x1 + rng.uniform(0.5, 24, shape), y1 + rng.uniform(0.5, 24, shape)],
                    -1).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_bilinear_sample_matches_jax(dtype):
    """Coordinates inside, on integers and past every edge; uint8 images
    are sampled in f32 as the reference does."""
    rng = np.random.default_rng(1)
    img = frames(1)[0]
    img = (img * 255).astype(np.uint8) if dtype == np.uint8 else img
    xs = rng.uniform(-5, 53, (7, 9)).astype(np.float32)
    ys = rng.uniform(-5, 45, (7, 9)).astype(np.float32)
    xs[0, :4], ys[0, :4] = [0, 47, 12, 47.0], [0, 39, 7, 0]
    tol = PIX * (255 if dtype == np.uint8 else 1)
    close(P.bilinear_sample(t(img), t(xs), t(ys)), J.bilinear_sample(jnp.asarray(img), jnp.asarray(xs),
                                                                       jnp.asarray(ys)), tol)


@pytest.mark.parametrize("out_hw", [(20, 24), (57, 31), (40, 48), (1, 5)])
def test_resize_bilinear_matches_jax(out_hw):
    img = frames(1, seed=2)[0]
    close(P.resize_bilinear(t(img), out_hw), J.resize_bilinear(jnp.asarray(img), out_hw))


@pytest.mark.parametrize("seed", range(4))
def test_solve_homography_4pt_matches_jax(seed):
    """A box's corners onto an image's corners (the reference's use) and a
    random quadrilateral onto another."""
    rng = np.random.default_rng(seed)
    if seed == 0:
        src = np.array([[10, 12], [30, 12], [30, 25], [10, 25]], np.float32)
        dst = np.array([[0, 0], [47, 0], [47, 39], [0, 39]], np.float32)
    else:
        src = (np.array([[0, 0], [1, 0], [1, 1], [0, 1]]) * 40 + rng.uniform(-5, 5, (4, 2))).astype(np.float32)
        dst = (np.array([[0, 0], [1, 0], [1, 1], [0, 1]]) * 60 + rng.uniform(-8, 8, (4, 2))).astype(np.float32)
    want = np.asarray(J.solve_homography_4pt(jnp.asarray(src), jnp.asarray(dst)))
    got = P.solve_homography_4pt(t(src), t(dst)).numpy()
    assert got.dtype == np.float32 and got[2, 2] == 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=H_REL * np.abs(want).max())
    mapped = np.c_[src, np.ones(4)] @ got.astype(np.float64).T
    np.testing.assert_allclose(mapped[:, :2] / mapped[:, 2:], dst, atol=1e-3)


@pytest.mark.parametrize("out_hw", [(40, 48), (23, 17)])
def test_warp_homography_matches_jax(out_hw):
    """A noise image warped by a projective H whose sample points fall
    inside, between pixels and off the image. H⁻¹ comes out of the two
    LAPACK inverses up to 2.4e-7 apart, and the noise's gradient carries
    that into the pixels: 6.6e-6 at most here."""
    img = frames(1, seed=10)[0]
    Hm = np.array([[1.05, 0.04, -3.0], [-0.03, 0.97, 2.5], [4e-4, -3e-4, 1.0]], np.float32)
    close(P.warp_homography(t(img), t(Hm), out_hw), J.warp_homography(jnp.asarray(img), jnp.asarray(Hm), out_hw))


@pytest.mark.parametrize("size,hw", [(64, (40, 48)), (32, (48, 20)), (50, (50, 50))])
def test_letterbox_matches_jax(size, hw):
    img = frames(1, *hw, seed=3)[0]
    got, scale, pad = P.letterbox(t(img), size)
    want, w_scale, w_pad = J.letterbox(jnp.asarray(img), size)
    assert scale == w_scale and pad == w_pad
    close(got, want)


@pytest.mark.parametrize("out_hw", [(16, 12), (1, 1), (9, 1)])
def test_rectify_one_matches_jax(out_hw):
    rng = np.random.default_rng(4)
    img = frames(1, seed=4)[0]
    for box in random_boxes(rng, (5,)):
        close(P._rectify_one(t(img), t(box), out_hw), J._rectify_one(jnp.asarray(img), jnp.asarray(box), out_hw))


def test_rectify_crops_matches_jax():
    """The frame-batched gather rectifier, (F, H, W, C) × (F, B, 4)."""
    rng = np.random.default_rng(5)
    imgs, boxes = frames(3, seed=5), random_boxes(rng, (3, 4))
    got = P.rectify_crops(t(imgs), t(boxes), (16, 12))
    assert got.shape == (3, 4, 16, 12, 3)
    close(got, J.rectify_crops(jnp.asarray(imgs), jnp.asarray(boxes), (16, 12)))


@pytest.mark.parametrize("n_out,n_in", [(16, 40), (1, 7), (5, 1)])
def test_interp_matrix_matches_jax(n_out, n_in):
    """One pair of scalar edges, as the reference takes them, and a batch
    of edges (the port's callers)."""
    rng = np.random.default_rng(6)
    lo = rng.uniform(-3, n_in, 6).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 20, 6)).astype(np.float32)
    want = np.stack([np.asarray(J._interp_matrix(jnp.asarray(a), jnp.asarray(b), n_out, n_in))
                     for a, b in zip(lo, hi)])
    close(P._interp_matrix(t(lo), t(hi), n_out, n_in), want)
    close(P._interp_matrix(torch.tensor(lo[0]), torch.tensor(hi[0]), n_out, n_in), want[0])


def test_rectify_one_mxu_matches_jax():
    rng = np.random.default_rng(7)
    img = frames(1, seed=7)[0]
    for box in random_boxes(rng, (4,)):
        close(P._rectify_one_mxu(t(img), t(box), (16, 12)),
              J._rectify_one_mxu(jnp.asarray(img), jnp.asarray(box), (16, 12)))


def test_rectify_crops_mxu_matches_jax():
    """The frame-batched matmul rectifier, (F, H, W, C) × (F, B, 4), and
    the one-frame-per-crop form the port's callers take ((K, 1, 4) boxes)
    against the reference's ``_rectify_one_mxu`` over each crop."""
    rng = np.random.default_rng(8)
    imgs, boxes = frames(3, seed=8), random_boxes(rng, (3, 5))
    got = P.rectify_crops_mxu(t(imgs), t(boxes), (16, 12))
    assert got.shape == (3, 5, 16, 12, 3)
    close(got, J.rectify_crops_mxu(jnp.asarray(imgs), jnp.asarray(boxes), (16, 12)))
    per_crop = P.rectify_crops_mxu(t(imgs), t(boxes[:, :1]), (16, 12))[:, 0]
    close(per_crop, jax.vmap(J._rectify_one_mxu, (0, 0, None))(jnp.asarray(imgs), jnp.asarray(boxes[:, 0]),
                                                                 (16, 12)))


def test_the_two_rectifiers_sample_the_same_positions():
    """``rectify_crops`` (gathers) and ``rectify_crops_mxu`` (matmuls) give
    the same crops within f32 rounding wherever the box lies inside the
    frame, as in the reference."""
    rng = np.random.default_rng(9)
    imgs = frames(2, seed=9)
    x1, y1 = rng.uniform(0, 20, (2, 3)), rng.uniform(0, 15, (2, 3))
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, 20, (2, 3)), y1 + rng.uniform(1, 20, (2, 3))], -1)
    boxes = boxes.astype(np.float32)
    close(P.rectify_crops(t(imgs), t(boxes), (16, 12)), P.rectify_crops_mxu(t(imgs), t(boxes), (16, 12)).numpy())
