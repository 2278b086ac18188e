"""Port parity, module by module: tpu3dlm_torch against the JAX package on
the CPU, the same numpy inputs through both. Each tolerance is stated
beside its check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm.mapper.nms3d import nms3d_mask as jax_nms3d_mask
from tpu3dlm.mapper.projection import project_boxes as jax_project_boxes
from tpu3dlm.models.beit import BeitClassifier as JaxBeit
from tpu3dlm.models.beit import BeitConfig as JaxBeitConfig
from tpu3dlm.models.beit import relative_position_index as jax_rel_index
from tpu3dlm.models.yolov10 import YOLOv10 as JaxYOLOv10
from tpu3dlm.models.yolov10 import postprocess as jax_postprocess
from tpu3dlm.ops import geometry as JG
from tpu3dlm.ops.image import _rectify_one_mxu
from tpu3dlm.utils import shapes as jax_shapes
from tpu3dlm_torch.data import scan as port_scan
from tpu3dlm_torch.mapper.nms3d import nms3d_mask
from tpu3dlm_torch.mapper.projection import project_boxes
from tpu3dlm_torch.models.beit import relative_position_index
from tpu3dlm_torch.models.weights import beit_from_flax, yolov10_from_flax
from tpu3dlm_torch.models.yolov10 import postprocess
from tpu3dlm_torch.ops import geometry as G
from tpu3dlm_torch.ops.image import rectify_crops
from tpu3dlm_torch.utils import shapes

torch.set_num_threads(1)


def random_variables(model, example, seed):
    """Seeded numpy weights for a Flax model without compiling its init
    (``jax.eval_shape`` gives the tree): kernels N(0, 1/fan_in); every
    other leaf off its Flax init value (BatchNorm stats and affine terms,
    biases, layer scales, relative-position tables, cls token), so a
    converter that swaps or drops a leaf cannot pass."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), example)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.normal(0, std, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("scale", "lambda_1", "lambda_2"):
            return (1.0 + rng.normal(0, 0.1, s.shape)).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def yolo_pair():
    model = JaxYOLOv10(nc=8, variant="n")
    variables = random_variables(model, jnp.zeros((1, 64, 64, 3)), 1)
    img = np.random.default_rng(3).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    out = jax.jit(model.apply)(variables, jnp.asarray(img))
    return variables, img, out


class TestYOLOv10:
    def test_raw_head_maps_match_flax(self, yolo_pair):
        """Both heads, every level, NHWC: atol 5e-4 / rtol 1e-3 (the
        tolerance of the Flax-vs-torch golden in test_models.py; f32
        convolutions summed in another order)."""
        variables, img, want = yolo_pair
        port = yolov10_from_flax(variables)
        with torch.no_grad():
            got = port(t(img), one2many=True)
        for branch in ("one2one_split", "one2many_split"):
            for (gb, gc), (wb, wc) in zip(got[branch], want[branch]):
                for g, w in ((gb, wb), (gc, wc)):
                    np.testing.assert_allclose(
                        g.numpy(), np.asarray(w), atol=5e-4, rtol=1e-3, err_msg=branch
                    )

    def test_postprocess_matches_jax(self, yolo_pair):
        """Same raw maps into both postprocesses: identical labels and
        top-k order (stable sort = lax.top_k's tie order), boxes and conf to
        f32 round-off (rtol 1e-6 on boxes of a few hundred px, 1e-6 on
        conf)."""
        _, _, raw = yolo_pair
        want = jax_postprocess(raw["one2one_split"], img_size=64, max_det=20)
        got = postprocess(
            [(t(b), t(c)) for b, c in raw["one2one_split"]], img_size=64, max_det=20
        )
        np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))
        np.testing.assert_allclose(got["conf"].numpy(), np.asarray(want["conf"]), atol=1e-6)
        np.testing.assert_allclose(
            got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=1e-6, atol=1e-5
        )

    def test_postprocess_ties_keep_lower_index(self):
        """Equal confidences: the lower anchor index comes first, as in
        jax.lax.top_k."""
        raw = [
            (np.zeros((1, 64 // s, 64 // s, 64), np.float32),
             np.zeros((1, 64 // s, 64 // s, 2), np.float32))
            for s in (8, 16, 32)
        ]
        want = jax_postprocess(raw, img_size=64, max_det=10)
        got = postprocess([(t(b), t(c)) for b, c in raw], img_size=64, max_det=10)
        np.testing.assert_array_equal(got["boxes"].numpy(), np.asarray(want["boxes"]))


def test_beit_logits_match_flax():
    """A 2-layer BEiT with perturbed weights (incl. relative-position
    tables): logits within 1e-4 of the Flax einsum path (f32; the port's
    attention is kernel B1's twin)."""
    cfg = JaxBeitConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
                        num_heads=2, intermediate_size=64, num_labels=3)
    model = JaxBeit(cfg)
    variables = random_variables(model, jnp.zeros((1, 32, 32, 3)), 2)
    x = np.random.default_rng(4).uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    port = beit_from_flax(variables)
    assert port.cfg.num_layers == 2 and port.cfg.num_heads == 2
    with torch.no_grad():
        got = port(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("image_size,hidden", [(256, 32), (32, 256)], ids=["n257", "d128"])
def test_beit_logits_match_flax_past_the_old_attention_limits(image_size, hidden):
    """ROADMAP C1's two configurations, which the port once refused: 256 px
    (N = 257 tokens) and hidden 256 over 2 heads (head width 128). Logits
    within 1e-4 of the Flax einsum path (f32), as test_beit_logits_match_flax."""
    cfg = JaxBeitConfig(image_size=image_size, patch_size=16, hidden_size=hidden, num_layers=1,
                        num_heads=2, intermediate_size=64, num_labels=2)
    model = JaxBeit(cfg)
    variables = random_variables(model, jnp.zeros((1, image_size, image_size, 3)), 5)
    x = np.random.default_rng(6).uniform(-1, 1, (2, image_size, image_size, 3)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    port = beit_from_flax(variables)
    assert port.cfg.num_patches + 1 == (image_size // 16) ** 2 + 1 and port.cfg.num_heads == 2
    with torch.no_grad():
        got = port(t(x)).numpy()
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_relative_position_index_equal():
    for grid in (2, 7, 14):
        np.testing.assert_array_equal(relative_position_index(grid), jax_rel_index(grid))


def _depth_and_boxes(rng, F=3, B=6, hd=48, wd=64):
    depth = rng.integers(800, 4000, (F, hd, wd)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0  # holes
    depth[0, :, :] = 0.0  # a frame with no valid depth
    x1 = rng.uniform(-5, wd, (F, B))
    y1 = rng.uniform(-5, hd, (F, B))
    boxes = np.stack(
        [x1, y1, x1 + rng.uniform(0.5, 30, (F, B)), y1 + rng.uniform(0.5, 30, (F, B))], -1
    ).astype(np.float32)
    return depth, boxes


def test_sampled_median_depth_bit_identical():
    """Grid 16 (the serving grid): direct gathers select the same values as
    the reference's one-hot matmuls, so the medians are bit-identical."""
    depth, boxes = _depth_and_boxes(np.random.default_rng(7))
    per_box = jax.vmap(
        jax.vmap(lambda d, b: JG.bbox_sampled_median_depth(d, b, samples=16), (None, 0)),
        (0, 0),
    )
    want_z, want_ok = per_box(jnp.asarray(depth), jnp.asarray(boxes))
    got_z, got_ok = G.bbox_sampled_median_depth(t(depth), t(boxes), samples=16)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))


def test_project_boxes_match_jax():
    """World corners within 1e-5 m (f32 round-off of the pose transform),
    validity identical."""
    rng = np.random.default_rng(8)
    F, B = 3, 6
    depth, boxes = _depth_and_boxes(rng, F, B)
    boxes = boxes * 10  # RGB pixels (640×480) for a 64×48 depth map
    mask = rng.uniform(size=(F, B)) < 0.8
    intr = np.tile([[525.0, 520.0, 319.5, 239.5]], (F, 1)).astype(np.float32)
    size = np.tile([[640.0, 480.0]], (F, 1)).astype(np.float32)
    q = rng.normal(size=(F, 4))
    poses = np.concatenate([rng.normal(size=(F, 3)), q], -1).astype(np.float32)
    want_c, want_m = jax_project_boxes(
        *(jnp.asarray(a) for a in (boxes, mask, depth, intr, size, poses)), median_samples=16
    )
    got_c, got_m = project_boxes(
        *(t(a) for a in (boxes, mask, depth, intr, size, poses)), median_samples=16
    )
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)


def test_pose_to_matrix_matches_jax():
    poses = np.random.default_rng(9).normal(size=(5, 7)).astype(np.float32)
    want = np.stack([np.asarray(JG.pose_to_matrix(jnp.asarray(p))) for p in poses])
    np.testing.assert_allclose(G.pose_to_matrix(t(poses)).numpy(), want, atol=1e-6)


def test_nms3d_keep_mask_identical():
    """Clusters of near-duplicate quads seen from several frames, plus
    gated-out ones (tiny, too close to the camera): the keep mask is
    identical to the reference's."""
    rng = np.random.default_rng(10)
    F, B = 4, 6
    base = np.array([[0, 0, 0], [0, -0.5, 0], [0.4, -0.5, 0], [0.4, 0, 0]], np.float32)
    centres = rng.uniform(-2, 2, (3, 3)).astype(np.float32)
    corners = np.zeros((F, B, 4, 3), np.float32)
    for f in range(F):
        for b in range(B):
            corners[f, b] = base + centres[b % 3] + rng.normal(0, 0.03, (1, 3))
    corners[1, 4] *= 0.01  # tiny quad: area gate
    conf = rng.uniform(0.3, 1.0, (F, B)).astype(np.float32)
    conf[2, 1] = conf[0, 1]  # an exact tie
    mask = rng.uniform(size=(F, B)) < 0.9
    cams = np.zeros((F, 3), np.float32) + 10.0
    cams[3] = corners[3, 0, 0]  # camera on a corner: distance gate
    want = jax_nms3d_mask(*(jnp.asarray(a) for a in (corners, conf, mask, cams)))
    got = nms3d_mask(*(t(a) for a in (corners, conf, mask, cams)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.numpy().sum() < mask.sum()  # the check bites


def test_rectify_matches_jax():
    """Crops within 1e-5 on the 0–1 scale (f32 matmuls, summation order)."""
    rng = np.random.default_rng(11)
    imgs = rng.uniform(size=(4, 40, 48, 3)).astype(np.float32)
    x1 = rng.uniform(-3, 40, 4)
    y1 = rng.uniform(-3, 30, 4)
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, 20, 4), y1 + rng.uniform(1, 20, 4)], -1)
    boxes = boxes.astype(np.float32)
    want = jax.vmap(_rectify_one_mxu, (0, 0, None))(jnp.asarray(imgs), jnp.asarray(boxes), (16, 12))
    got = rectify_crops(t(imgs), t(boxes), (16, 12))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_shape_helpers_match_jax():
    for n in range(1, 700):
        assert shapes.next_bucket(n) == jax_shapes.next_bucket(n)
        assert shapes.next_bucket(n, 4, 4) == jax_shapes.next_bucket(n, min_bucket=4, quarter_from=4)
    poses = np.random.default_rng(0).normal(size=(3, 7)).astype(np.float32)
    np.testing.assert_array_equal(shapes.pad_poses(poses, 8), jax_shapes.pad_poses(poses, 8))
    np.testing.assert_array_equal(
        shapes.pad_axis0(poses, 5, fill=1), jax_shapes.pad_axis0(poses, 5, fill=1)
    )


@pytest.mark.parametrize("n", [0, 3, 4, 9])
def test_padded_batches_match_jax(n):
    """Fixed batches of 4 with a zero-padded ragged tail, as the staged
    route's detector and classifier run them."""
    rng = np.random.default_rng(n)
    arrays = [rng.normal(size=(n, 2, 3)).astype(np.float32), np.arange(n, dtype=np.int64)]
    got = list(shapes.padded_batches(arrays, 4))
    want = list(jax_shapes.padded_batches(arrays, 4))
    assert len(got) == len(want) == -(-n // 4)
    for (g_chunks, g_start, g_valid), (w_chunks, w_start, w_valid) in zip(got, want):
        assert (g_start, g_valid) == (w_start, w_valid)
        for g, w in zip(g_chunks, w_chunks):
            assert g.shape[0] == 4 and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_detection_records_round_trip():
    """Reference record shapes: 7-field and 6-field records in, identical
    padded arrays and identical records out."""
    from tpu3dlm.data.scan import detections_from_frame_dict as jax_from_dict

    preds = {
        0: [[1.0, 2.0, 3.0, 4.0, 1, 0.9, 2], [5.0, 6.0, 7.0, 8.0, 0, 0.5, 1]],
        2: [[9.0, 9.5, 10.0, 11.0, 0.7, 3]],
    }
    got = port_scan.detections_from_frame_dict(preds, 3)
    want = jax_from_dict(preds, 3)
    for f in ("boxes", "conf", "label", "damage", "mask"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))
    assert got.to_frame_dict() == want.to_frame_dict()
