"""The self-training loop of the port (tpu3dlm_torch/pipeline/selftrain.py,
parallel/finetune.py's YOLO step, EMA and schedule, the Flax checkpoint
writer) against the JAX package's on the CPU, on the committed capture
(tests/fixtures/torch_project). JAX's random draws are replayed from its
keys (tests/torch_jax_noise.py) and handed to the port as ``noise``; both
start from the same weights (the port's Flax-like init, carried to Flax).
Each tolerance is stated beside its check."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_jax_noise as N

from tpu3dlm.data.dataset import load_scan as jax_load_scan
from tpu3dlm.data.synthetic import load_scene_gt
from tpu3dlm.models import weights as JW
from tpu3dlm.ops import image as JI
from tpu3dlm.models.beit import BeitClassifier as JaxBeit
from tpu3dlm.models.beit import BeitConfig as JaxBeitConfig
from tpu3dlm.models.yolov10 import YOLOv10 as JaxYolo
from tpu3dlm.parallel import finetune as JF
from tpu3dlm.pipeline import selftrain as JS
from tpu3dlm_torch.data.dataset import load_scan
from tpu3dlm_torch.models.beit import BeitClassifier, BeitConfig
from tpu3dlm_torch.models.checkpoint import read_flax_msgpack, serialize_flax_msgpack, write_flax_msgpack
from tpu3dlm_torch.models.layers import init_like_flax_
from tpu3dlm_torch.models.weights import beit_to_flax, yolov10_to_flax
from tpu3dlm_torch.models.yolov10 import YOLOv10
from tpu3dlm_torch.parallel import finetune as PF
from tpu3dlm_torch.parallel.finetune import ADAMW_BETAS, ema_update, warmup_cosine_decay_schedule
from tpu3dlm_torch.pipeline import selftrain as PS

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "fixtures", "torch_project", "data", "gold_std")
BEIT_KW = dict(image_size=32, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, num_labels=2)
STEPS = 3


def scans(img_size: int):
    base = os.path.join(GOLD, "rtabmap_extract")
    kw = dict(image_dir=os.path.join(base, "data_rgb"), depth_image_dir=os.path.join(base, "data_depth"),
              calibration_dir=os.path.join(base, "calibration"), pose_path=os.path.join(GOLD, "poses.txt"),
              img_size=img_size)
    return jax_load_scan(**kw), load_scan(**kw)


@pytest.fixture(scope="module")
def data():
    gt = load_scene_gt(os.path.join(GOLD, "gt.json"))
    jscan, pscan = scans(64)
    return gt, jscan, pscan


def test_training_arrays_and_crops_identical_to_jax(data):
    """The YOLO arrays identical. The crops identical but at truncation
    edges: the reference truncates x·255 of f32 crops, and where a crop
    value is a source pixel p/255 the product lands within an ulp of the
    integer p, so one ulp of the resample (XLA's second contraction rounds
    each of its two products, PyTorch's fuses one) decides p or p − 1. Every
    differing value is off by 1, JAX's x·255 lies within 2e-5 of an integer
    there, and at most 5% of the values differ (measured 2.3%: 912 of
    39,936 at 32 px; ROADMAP §C)."""
    gt, jscan, pscan = data
    want = JS.yolo_training_arrays(gt["gt_boxes_2d"], jscan)
    got = PS.yolo_training_arrays(gt["gt_boxes_2d"], pscan)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w))
    assert want[3].sum() > 0
    for size in (32, 48):
        wc, wl = JS.beit_training_crops(gt["gt_boxes_2d"], gt["gt_damage_2d"], jscan, size)
        gc, gl = PS.beit_training_crops(gt["gt_boxes_2d"], gt["gt_damage_2d"], pscan, size, device="cpu")
        assert gc.dtype == np.uint8 and gc.shape == wc.shape and np.array_equal(gl, wl) and len(gl) > 4
        rgb = np.asarray(jscan.rgb)  # the reference's f32 crops, to locate the truncation edges
        frames = [f for f, recs in gt["gt_boxes_2d"].items() if f < jscan.num_frames for _ in recs]
        raw = [r[:4] for f, recs in gt["gt_boxes_2d"].items() if f < jscan.num_frames for r in recs]
        boxes = JS.scale_boxes_to_frame(np.asarray(raw, np.float32), jscan, np.asarray(frames))
        x = np.asarray(jax.vmap(JI._rectify_one_mxu, in_axes=(0, 0, None))(
            jnp.asarray(rgb[np.asarray(frames)].astype(np.float32) / 255.0), jnp.asarray(boxes), (size, size))) * 255.0
        bad = gc != wc
        assert np.abs(gc.astype(int) - wc.astype(int)).max() <= 1
        assert np.abs(x[bad] - np.round(x[bad])).max() <= 2e-5 and bad.mean() <= 0.05, bad.mean()
    empty = PS.beit_training_crops({}, {}, pscan, 32, device="cpu")
    assert empty[0].shape == (0, 32, 32, 3) and empty[1].shape == (0,)


def adam_step_bound(t: int) -> float:
    """The largest |m̂_t| / √v̂_t Adam can produce at step t (as in
    tests/test_torch_finetune.py)."""
    b1, b2 = ADAMW_BETAS
    geo = sum((b1 * b1 / b2) ** k for k in range(t))
    return (1 - b1) / np.sqrt(1 - b2) * np.sqrt(geo) * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def recording(monkeypatch, module, name, losses):
    """Wrap a package's step maker so each step's loss is kept (JAX's
    steps return (..., loss), the port's the loss)."""
    make = getattr(module, name)

    def maker(*a, **kw):
        step = make(*a, **kw)

        def run(*sa, **skw):
            out = step(*sa, **skw)
            losses.append(float(out[-1] if isinstance(out, tuple) else out))
            return out

        return run

    monkeypatch.setattr(module, name, maker)


def test_finetune_yolo_three_steps_match_jax(data, monkeypatch):
    """Three ``finetune_yolo`` steps of both packages at 64 px with the hard
    recipe's augmentation (erase on), 4 sampled frames a step, the cosine
    schedule and EMA. Each step's loss within 1e-4 relative up to the first
    step after a real update (the schedule's rate is 0 in step 1, so steps
    1 and 2 both run on the initial weights), then within 1e-3: from there
    the parameters differ by up to 2·lr per element wherever Adam's
    normalised step takes the sign of a near-zero gradient, and JAX's f32
    gradient is off by up to 2.9e-3 × max-abs (test_torch_yolo_loss.py);
    measured 5.6e-4 in step 3 (ROADMAP §C). The returned
    EMA parameters within the AdamW bound of tests/test_torch_finetune.py
    (Σ 2·lr·r_t over the steps that moved, plus 1e-6; the EMA is a convex
    combination, so the bound carries over), the median element within
    1e-5. The BatchNorm statistics after the updates are batch statistics
    of parameters that differ as above (2.7e-3 apart at worst, by thread
    layout), so only their tree is held here; one step's statistics are
    held in test_torch_yolo_loss.py."""
    gt, jscan, pscan = data
    images, boxes, labels, mask = PS.yolo_training_arrays(gt["gt_boxes_2d"], pscan)
    aug = dict(erase_p=0.5, erase_count=2, erase_max=0.35, brightness=0.3, contrast=0.3)
    lr, seed, sample = 2e-3, 0, 4
    init = yolov10_to_flax(init_like_flax_(YOLOv10(nc=2), torch.Generator().manual_seed(seed)))
    monkeypatch.setattr(JaxYolo, "init", lambda self, *a, **k: init)
    jax_losses = []
    recording(monkeypatch, JF, "make_yolo_train_step", jax_losses)
    opts = dict(nc=2, img_size=64, steps=STEPS, lr=lr, seed=seed, log_every=0, augment=aug, ema_decay=0.9,
                schedule="cosine", sample_batch=sample)
    want = JS.finetune_yolo(images, boxes, labels, mask, **opts)
    noise = [N.yolo_step_noise(k, len(images), aug, sample) for k in N.finetune_keys(seed, STEPS)]
    got = []
    recording(monkeypatch, PF, "make_yolo_train_step", got)
    model = PS.finetune_yolo(images, boxes, labels, mask, device="cpu", init=init, noise=noise, **opts)
    assert not model.training
    sched = warmup_cosine_decay_schedule(0.0, lr, 1, STEPS, lr * 0.05)
    assert sched(0) == 0.0 and sched(1) == pytest.approx(lr)
    np.testing.assert_allclose(got[:2], jax_losses[:2], rtol=1e-4, atol=0)
    np.testing.assert_allclose(got[2:], jax_losses[2:], rtol=1e-3, atol=0)
    bound = sum(2 * sched(t - 1) * adam_step_bound(t) for t in range(1, STEPS + 1)) + 1e-6
    tree = yolov10_to_flax(model)
    diffs = []
    for path, v in flat(tree["params"]):
        d = np.abs(v - _get(want["params"], path))
        assert d.max() <= bound, (path, d.max(), bound)
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) <= 1e-5  # measured 4.5e-6: the sign flips above, EMA-weighted
    assert {p for p, _ in flat(tree["batch_stats"])} == {p for p, _ in flat(want["batch_stats"])}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_finetune_beit_three_steps_match_jax(data, monkeypatch):
    """Three ``finetune_beit`` steps with crop augmentation on the capture's
    ground-truth crops, cycled as the reference pads: each loss within
    1e-4 relative, the parameters within the AdamW bound."""
    gt, _, pscan = data
    crops, labels = PS.beit_training_crops(gt["gt_boxes_2d"], gt["gt_damage_2d"], pscan, 32, device="cpu")
    lr, seed = 1e-3, 0
    cfg = BeitConfig(**BEIT_KW)
    init = beit_to_flax(init_like_flax_(BeitClassifier(cfg), torch.Generator().manual_seed(seed)))

    def jax_init(beit, rng, lr=1e-4):
        tx = optax.adamw(lr)
        return init, tx, tx.init(init)

    monkeypatch.setattr(JF, "init_finetune", jax_init)
    jax_losses = []
    recording(monkeypatch, JF, "make_beit_train_step", jax_losses)
    want = JS.finetune_beit(crops, labels, JaxBeitConfig(**BEIT_KW), steps=STEPS, lr=lr, seed=seed, log_every=0,
                            augment=True)
    noise = [N.beit_step_noise(k, len(labels), {}) for k in N.finetune_keys(seed, STEPS)]
    losses = []
    recording(monkeypatch, PF, "make_beit_train_step", losses)
    model = PS.finetune_beit(crops, labels, cfg, steps=STEPS, lr=lr, seed=seed, log_every=0, augment=True,
                             device="cpu", init=init, noise=noise)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4, atol=0)
    bound = sum(2 * lr * adam_step_bound(t) for t in range(1, STEPS + 1)) + 1e-6
    for path, v in flat(beit_to_flax(model)["params"]):
        assert np.abs(v - _get(want["params"], path)).max() <= bound, path
    with pytest.raises(ValueError):
        PS.finetune_beit(crops[:0], labels[:0], cfg, steps=1, device="cpu")


def test_ema_update_and_cosine_schedule_match_optax(rng):
    """``warmup_cosine_decay_schedule`` against optax's at every step of a
    200-step run, and past it, within 1e-7 (f32 rounding; the rates are
    ~1e-3); ``ema_update`` against the reference's over 5 steps within
    1e-7."""
    for peak, warm, total in ((2e-3, 20, 200), (1e-3, 1, 3), (5e-4, 400, 4000)):
        want = optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=peak, warmup_steps=warm,
                                                  decay_steps=total, end_value=peak * 0.05)
        got = warmup_cosine_decay_schedule(0.0, peak, warm, total, peak * 0.05)
        counts = list(range(0, min(total, 300))) + [total - 1, total, total + 10]
        np.testing.assert_allclose([got(c) for c in counts], [float(want(c)) for c in counts], atol=1e-7, rtol=0)
    ema = {"a": rng.normal(size=(7, 3)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    port = [torch.from_numpy(ema["a"].copy()), torch.from_numpy(ema["b"].copy())]
    for _ in range(5):
        params = {"a": rng.normal(size=(7, 3)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
        ema = JF.ema_update(ema, params, 0.995)
        ema_update(port, [torch.from_numpy(params["a"]), torch.from_numpy(params["b"])], 0.995)
        for p, k in zip(port, ("a", "b")):
            np.testing.assert_allclose(p.numpy(), np.asarray(ema[k]), atol=1e-7, rtol=0)


@pytest.mark.parametrize("kind", ["yolo", "beit"])
def test_written_checkpoint_reads_back_in_both_packages(tmp_path, kind):
    """``write_flax_msgpack`` writes flax's own bytes for the tree; the JAX
    package's ``load_flax_checkpoint`` (over ``init_template``) and the
    port's ``read_flax_msgpack`` both read back identical arrays."""
    from flax import serialization

    gen = torch.Generator().manual_seed(11)
    if kind == "yolo":
        tree = yolov10_to_flax(init_like_flax_(YOLOv10(nc=2), gen))
        template = JW.init_template(JaxYolo(nc=2), jnp.zeros((1, 64, 64, 3)))
    else:
        tree = beit_to_flax(init_like_flax_(BeitClassifier(BeitConfig(**BEIT_KW)), gen))
        template = JW.init_template(JaxBeit(JaxBeitConfig(**BEIT_KW)), jnp.zeros((1, 32, 32, 3)))
    assert serialize_flax_msgpack(tree) == serialization.to_bytes(tree)
    path = str(tmp_path / f"{kind}.msgpack")
    write_flax_msgpack(path, tree)
    by_jax = JW.load_flax_checkpoint(path, template)
    by_port = read_flax_msgpack(path)
    leaves = dict(flat(tree))
    assert leaves.keys() == dict(flat(by_port)).keys() == dict(flat(jax.device_get(by_jax))).keys()
    for path_, v in flat(jax.device_get(by_jax)):
        assert np.array_equal(np.asarray(v), leaves[path_]) and np.array_equal(_get(by_port, path_), leaves[path_])
    with pytest.raises(ValueError):
        write_flax_msgpack(str(tmp_path / "x.pt"), tree)


def test_tiny_finetune_synthetic_checkpoints_load_in_the_jax_pipeline(tmp_path):
    """``finetune_synthetic`` on the committed gold scan (2 + 2 steps on the
    CPU) writes ``yolo.msgpack`` and ``beit.msgpack`` that the JAX
    Pipeline's own loaders read, with the port's weights."""
    from tpu3dlm.pipeline.task import Pipeline
    from tpu3dlm.utils.config import ConfigLoader

    from tpu3dlm_torch.pipeline.evaluate import _cfg_patch
    from tpu3dlm_torch.utils.config import DEFAULT_CONFIG

    yolo_path, beit_path = PS.finetune_synthetic(GOLD, str(tmp_path / "ck"), img_size=64, yolo_steps=2,
                                                 beit_steps=2, beit_config=BeitConfig(**BEIT_KW), device="cpu")
    text = DEFAULT_CONFIG
    for k, v in _cfg_patch(64, BEIT_KW) + [("yolo_weights =", f"yolo_weights = {yolo_path}"),
                                           ("beit_weights =", f"beit_weights = {beit_path}")]:
        text = text.replace(k, v)
    cfg_path = tmp_path / "variables.cfg"
    cfg_path.write_text(text)
    pipe = Pipeline("gold_std", ConfigLoader(str(cfg_path), "gold_std"))
    yolo = jax.device_get(pipe._load_yolo_weights())
    beit = jax.device_get(pipe._load_beit_weights(2))
    for loaded, path in ((yolo, yolo_path), (beit, beit_path)):
        written = dict(flat(read_flax_msgpack(path)))
        got = dict(flat(loaded))
        assert got.keys() == written.keys()
        assert all(np.array_equal(np.asarray(got[k]), written[k]) for k in written)


def test_evaluate_yolo_map_and_the_val_hook_match_jax(data):
    """``evaluate_yolo_map`` against the reference's on the same weights and
    frames (64 px, conf 0.25): the same detection metrics; and
    ``finetune_yolo(val_every=1)`` scores every step into
    ``val_history``."""
    gt, _, pscan = data
    images, boxes, labels, mask = PS.yolo_training_arrays(gt["gt_boxes_2d"], pscan)
    model = init_like_flax_(YOLOv10(nc=2), torch.Generator().manual_seed(5)).eval()
    imgs = images.astype(np.float32) / 255.0
    want = JS.evaluate_yolo_map(JaxYolo(nc=2), yolov10_to_flax(model), jnp.asarray(imgs), boxes, labels, mask, 64)
    got = PS.evaluate_yolo_map(model, torch.from_numpy(imgs), boxes, labels, mask, 64)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            assert got[k].keys() == want[k].keys(), k
            np.testing.assert_allclose([got[k][c] for c in want[k]], list(want[k].values()), atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert want["num_ground_truth"] > 0
    history = []
    PS.finetune_yolo(images, boxes, labels, mask, nc=2, img_size=64, steps=2, log_every=0, val_every=1,
                     val_history=history, device="cpu", ema_decay=0.9)
    assert [h["step"] for h in history] == [0, 1] and set(want) <= set(history[0])
