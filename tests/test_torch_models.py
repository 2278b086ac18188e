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
from tpu3dlm.models.beit import preprocess_crops as jax_preprocess_crops
from tpu3dlm.models.beit import relative_position_index as jax_rel_index
from tpu3dlm.models.yolov10 import YOLOv10 as JaxYOLOv10
from tpu3dlm.models.yolov10 import postprocess as jax_postprocess
from tpu3dlm.ops import geometry as JG
from tpu3dlm.ops.image import _rectify_one_mxu
from tpu3dlm.utils import shapes as jax_shapes
from tpu3dlm_torch.data import scan as port_scan
from tpu3dlm_torch.mapper.nms3d import nms3d_mask
from tpu3dlm_torch.mapper.projection import project_boxes
from tpu3dlm_torch.models.beit import BeitConfig, preprocess_crops, relative_position_index
from tpu3dlm_torch.models.weights import beit_from_flax, yolov10_from_flax
from tpu3dlm_torch.models.yolov10 import postprocess
from tpu3dlm_torch.ops import geometry as G
from tpu3dlm_torch.ops.image import rectify_crops_mxu
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

    @pytest.mark.parametrize("form", ["split", "concatenated"])
    def test_postprocess_concat_path_bit_identical(self, yolo_pair, form):
        """``per_level=False`` (the reference's A/B baseline: concatenate,
        decode, sigmoid over every class, then max/argmax) gives the
        per-level result bit for bit, from the split maps and from the
        concatenated ones, as the reference pins its own pair; and it
        equals the reference's ``per_level=False`` as the per-level path
        does (labels identical, conf 1e-6, boxes rtol 1e-6)."""
        _, _, raw = yolo_pair
        split = [(t(b), t(c)) for b, c in raw["one2one_split"]]
        port_in = split if form == "split" else [torch.cat(bc, -1) for bc in split]
        jax_in = raw["one2one_split"] if form == "split" else raw["one2one"]
        per_level = postprocess(split, img_size=64, max_det=20)
        got = postprocess(port_in, img_size=64, max_det=20, per_level=False)
        also = postprocess(port_in, img_size=64, max_det=20, per_level=True)
        for k in ("boxes", "conf", "label"):
            np.testing.assert_array_equal(got[k].numpy(), per_level[k].numpy(), err_msg=k)
            np.testing.assert_array_equal(also[k].numpy(), per_level[k].numpy(), err_msg=k)
        want = jax_postprocess(jax_in, img_size=64, max_det=20, per_level=False)
        np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))
        np.testing.assert_allclose(got["conf"].numpy(), np.asarray(want["conf"]), atol=1e-6)
        np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=1e-6, atol=1e-5)

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


A8_CFG = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128, num_labels=3)


def softmax_np(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.fixture(scope="module")
def a8_setting():
    """``tests/test_models.py::test_bf16_fast_path_tracks_f32``'s setting:
    JAX's PRNGKey(0) init of the 2-layer BEiT, every leaf perturbed by
    0.05·N(0, 1) from PRNGKey(1), 16 uint8 crops from default_rng(3); with
    the reference's own f32 and bf16 logits (its einsum attention, the
    route ``attn_impl="auto"`` takes off the TPU)."""
    cfg = JaxBeitConfig(**A8_CFG)
    f32 = JaxBeit(cfg, dtype=jnp.float32)
    variables = f32.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    leaves, treedef = jax.tree.flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    variables = jax.tree.unflatten(
        treedef, [leaf + 0.05 * jax.random.normal(k, leaf.shape, leaf.dtype) for leaf, k in zip(leaves, keys)])
    crops = np.random.default_rng(3).integers(0, 256, size=(16, 32, 32, 3), dtype=np.uint8)
    x = jax_preprocess_crops(jnp.asarray(crops))
    jax_logits = {
        "f32": np.asarray(f32.apply(variables, x), np.float32),
        "bf16": np.asarray(JaxBeit(cfg, dtype=jnp.bfloat16).apply(variables, x), np.float32),
    }
    return variables, preprocess_crops(torch.from_numpy(crops)), jax_logits


def port_logits(setting, attn_impl: str, dtype: torch.dtype) -> np.ndarray:
    variables, x, _ = setting
    model = beit_from_flax(variables, BeitConfig(**A8_CFG, attn_impl=attn_impl)).to(dtype)
    with torch.no_grad():
        return model(x).float().numpy()


@pytest.mark.parametrize("attn_impl", ["auto", "einsum"], ids=["b1_twin", "einsum"])
def test_bf16_tracks_f32(a8_setting, attn_impl):
    """A8: the port's bf16 BEiT against its f32 BEiT at the reference's
    setting and bars (``tests/test_models.py::test_bf16_fast_path_tracks_
    f32``), on both attention routes: softmax drift < 0.05, some crops
    decisive (top-1 margin > 2·drift·max|logit|), and the same top-1 on
    every decisive crop. Measured on the CPU: drift 0.0030 on B1's twin
    (scores f32), 0.0055 on the einsum route (scores bf16); all 16 crops
    decisive."""
    logits32 = port_logits(a8_setting, attn_impl, torch.float32)
    logits16 = port_logits(a8_setting, attn_impl, torch.bfloat16)
    drift = float(np.abs(softmax_np(logits32) - softmax_np(logits16)).max())
    assert drift < 0.05, f"softmax drift {drift}"
    top = np.sort(logits32, axis=-1)
    margin = top[:, -1] - top[:, -2]
    decisive = margin > 2 * drift * np.abs(logits32).max()
    assert decisive.any()  # the check below must bite
    agree = logits32.argmax(-1) == logits16.argmax(-1)
    assert agree[decisive].all(), f"bf16 flipped a decisive top-1: margins {margin[~agree]}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_einsum_beit_matches_jax_einsum(a8_setting, dtype):
    """``attn_impl="einsum"`` against the reference's einsum route on the
    same variables and crops. f32: logits within 1e-5 (measured 1.5e-6).
    bf16: logits within 2 bf16 ulps at their scale (|logit| < 4, an ulp
    0.0156: 0.03125; measured one ulp), softmax within 0.01 (measured
    0.0053), and the same top-1 on every crop whose f32 margin exceeds
    that logit bar."""
    got = port_logits(a8_setting, "einsum", torch.float32 if dtype == "f32" else torch.bfloat16)
    want = a8_setting[2][dtype]
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5)
        return
    assert np.abs(want).max() < 4.0
    np.testing.assert_allclose(got, want, atol=0.03125)
    assert np.abs(softmax_np(got) - softmax_np(want)).max() <= 0.01
    top = np.sort(a8_setting[2]["f32"], axis=-1)
    clear = top[:, -1] - top[:, -2] > 0.03125
    assert clear.any()
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


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
    got = rectify_crops_mxu(t(imgs), t(boxes)[:, None], (16, 12))[:, 0]
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
