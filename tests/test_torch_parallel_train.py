"""The port's data-parallel training (tpu3dlm_torch/parallel/finetune.py
and pipeline/selftrain.py with a ``mesh``) against the JAX package's
``shard_map`` steps (tpu3dlm/parallel/finetune.py, pipeline/selftrain.py)
on two of its virtual CPU devices. The port runs in one 2-rank gloo world
that the module spawns once and that runs every leg
(tests/torch_parallel_legs.py); JAX's per-shard noise (its key folded with
the shard) is replayed to each rank (tests/torch_jax_noise.py). Each
tolerance is stated beside its check."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_jax_noise as N
import torch_parallel_legs as legs

from test_torch_finetune import LR, adam_step_bound, beit_finetune_setup, port_grads_by_name
from test_torch_selftrain import BEIT_KW, _get, data, flat, recording  # noqa: F401 — data: a module fixture
from test_torch_yolo_loss import grad_ratios, gt_batch
from tpu3dlm.models import yolo_loss as JL
from tpu3dlm.models.beit import BeitConfig as JaxBeitConfig
from tpu3dlm.models.beit import preprocess_crops as jax_preprocess
from tpu3dlm.models.yolov10 import YOLOv10 as JaxYolo
from tpu3dlm.ops.augment import augment_crop_batch
from tpu3dlm.parallel import finetune as JF
from tpu3dlm.parallel.mesh import make_mesh
from tpu3dlm.pipeline import selftrain as JS
from tpu3dlm_torch.models.beit import BeitClassifier, BeitConfig
from tpu3dlm_torch.models.layers import init_like_flax_
from tpu3dlm_torch.models.weights import _leaves, _yolo_key, _torch_value, beit_to_flax, yolov10_to_flax
from tpu3dlm_torch.models.yolov10 import YOLOv10
from tpu3dlm_torch.parallel.finetune import warmup_cosine_decay_schedule
from tpu3dlm_torch.parallel.mesh import spawn_world
from tpu3dlm_torch.pipeline import selftrain as PS

torch.set_num_threads(1)

AUG_KEY = 5
YOLO_LR, YOLO_S = 2e-3, 64
STEPS = 3
DET_AUG = dict(erase_p=0.5, erase_count=2, erase_max=0.35, brightness=0.3, contrast=0.3)


def halves(x):
    return x[: len(x) // 2], x[len(x) // 2:]


@pytest.fixture(scope="module")
def beit_setup():
    """tests/test_torch_finetune.py's seeded toy BEiT, optax ``adamw(LR)``
    and its learnable batch of 10 crops (5 a rank)."""
    return beit_finetune_setup()


@pytest.fixture(scope="module")
def yolo_inputs():
    """6 random frames at 64 px with tests/test_torch_yolo_loss.py's ground
    truth draw (3 frames a shard, the condition its gradient bars were
    measured in), and the port's Flax-like init carried to Flax."""
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(6, YOLO_S, YOLO_S, 3)).astype(np.float32)
    boxes, labels, mask = gt_batch(rng, b=6)
    init = yolov10_to_flax(init_like_flax_(YOLOv10(nc=2), torch.Generator().manual_seed(0)))
    return images, boxes, labels, mask, init


@pytest.fixture(scope="module")
def world(beit_setup, yolo_inputs, data):
    """Every training leg in one 2-rank gloo world → each rank's results."""
    _, params, _, _, crops, labels = beit_setup
    key = jax.random.PRNGKey(AUG_KEY)
    noise = [N.beit_step_noise(key, len(labels) // 2, {}, rank=r) for r in range(2)]
    images, boxes, ylabels, mask, init = yolo_inputs
    gt, _, pscan = data
    # finetune_yolo on the unpadded arrays (it pads), the hard recipe's options as tests/test_torch_selftrain.py
    arrays = PS.yolo_training_arrays(gt["gt_boxes_2d"], pscan)
    n_local = -(-len(arrays[0]) // 2)
    yolo_noise = [[N.yolo_step_noise(k, n_local, DET_AUG, 4, rank=r, n_dev=2) for k in N.finetune_keys(0, STEPS)]
                  for r in range(2)]
    crops_b, dmg = PS.beit_training_crops(gt["gt_boxes_2d"], gt["gt_damage_2d"], pscan, 32, device="cpu")
    beit_init = beit_to_flax(init_like_flax_(BeitClassifier(BeitConfig(**BEIT_KW)), torch.Generator().manual_seed(0)))
    n_crops = -(-len(dmg) // 2)
    beit_noise = [[N.beit_step_noise(k, n_crops, {}, rank=r) for k in N.finetune_keys(0, STEPS)] for r in range(2)]
    todo = {
        "beit_step:plain": dict(params=params, crops=crops, labels=labels, lr=LR, augment=None, noise=None),
        "beit_step:augment": dict(params=params, crops=crops, labels=labels, lr=LR, augment={}, noise=noise),
        "yolo_step": dict(variables=init, images=images, boxes=boxes, labels=ylabels,
                          mask=mask, img_size=YOLO_S, lr=YOLO_LR),
        "finetune_yolo": dict(args=arrays, init=init, noise=yolo_noise,
                              opts=dict(nc=2, img_size=YOLO_S, steps=STEPS, lr=YOLO_LR, seed=0, log_every=0,
                                        augment=DET_AUG, ema_decay=0.9, schedule="cosine", sample_batch=4)),
        "finetune_beit": dict(args=(crops_b, dmg, BEIT_KW), init=beit_init, noise=beit_noise,
                              opts=dict(steps=STEPS, lr=1e-3, seed=0, log_every=0, augment=True)),
    }
    return spawn_world(legs.run, 2, device="cpu", args=(todo,))


def jax_beit_loss(beit, params, crops, labels):
    logits = beit.apply(params, jax_preprocess(crops))
    return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()


@pytest.mark.parametrize("mode", ["plain", "augment"])
def test_dp_beit_step_matches_jax(world, beit_setup, mode):
    """One step of ``make_beit_train_step(mesh=...)``, with and without crop
    augmentation (JAX's key folded with each shard, replayed): the loss
    within 1e-5 of JAX's ``shard_map`` step's; every gradient within 1e-5
    (abs and rel) of the mean of JAX's per-shard gradients (its ``pmean``);
    the parameters after the update within the AdamW bound of
    tests/test_torch_finetune.py (2·lr·r_1 + 1e-6, Adam's sign flips on
    near-zero gradients), the median within 1e-6; both ranks identical."""
    beit, params, tx, opt_state, crops, labels = beit_setup
    mesh = make_mesh(2)
    key = jax.random.PRNGKey(AUG_KEY)
    if mode == "plain":
        step = JF.make_beit_train_step(beit, tx, mesh)
        jp, _, loss = step(params, opt_state, jnp.asarray(crops), jnp.asarray(labels))
        shards = [jnp.asarray(c) for c in halves(crops)]
    else:
        step = JF.make_beit_train_step(beit, tx, mesh, augment={})
        jp, _, loss = step(params, opt_state, key, jnp.asarray(crops), jnp.asarray(labels))
        shards = [augment_crop_batch(jax.random.fold_in(key, r), jnp.asarray(c)) for r, c in enumerate(halves(crops))]
    grad_fn = jax.jit(jax.grad(lambda p, c, y: jax_beit_loss(beit, p, c, y)))  # one compile for both shards
    grads = [grad_fn(params, c, jnp.asarray(y)) for c, y in zip(shards, halves(labels))]
    want_grads = port_grads_by_name(jax.tree.map(lambda a, b: (a + b) / 2, *grads)["params"])
    r0, r1 = (res[f"beit_step:{mode}"] for res in world)
    assert abs(r0["loss"] - float(loss)) <= 1e-5 and r0["loss"] == r1["loss"]
    assert r0["grads"].keys() == want_grads.keys()
    for name, want in want_grads.items():
        assert np.abs(r0["grads"][name]).max() > 0, name
        np.testing.assert_allclose(r0["grads"][name], want, atol=1e-5, rtol=1e-5, err_msg=name)
    bound = 2 * LR * adam_step_bound(1) + 1e-6
    diffs = []
    for path, v in flat(r0["params"]["params"]):
        assert np.array_equal(v, _get(r1["params"]["params"], path)), path
        d = np.abs(v - np.asarray(_get(jax.device_get(jp)["params"], path)))
        assert d.max() <= bound, (path, d.max())
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) <= 1e-6


def yolo_f64(variables, images, boxes, labels, mask) -> tuple[float, dict]:
    """One shard's train-mode YOLOv10 loss and gradients in float64 (the
    port's network from the same Flax variables)."""
    from tpu3dlm_torch.models.weights import yolov10_from_flax
    from tpu3dlm_torch.models.yolo_loss import yolov10_loss

    model = yolov10_from_flax(variables).double().train()
    loss = yolov10_loss(model(torch.from_numpy(images).double()), torch.from_numpy(boxes).double(),
                        torch.from_numpy(labels), torch.from_numpy(mask), YOLO_S)
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy() for n, p in model.named_parameters()}


def test_dp_yolo_step_matches_jax(world, yolo_inputs):
    """One step of ``make_yolo_train_step(mesh=...)`` on 6 frames (3 a
    shard), against JAX's ``shard_map`` step and the float64 mean of the
    shards' losses and gradients (the port's network in f64):

    * the loss before any update within 1e-5 relative of the float64 mean
      and of JAX's;
    * the gradients at the bars ROADMAP §C logs for one device (the same
      3-frame condition): within 1e-3 × each tensor's max-abs of float64
      (median 2e-4), and of the mean of JAX's per-shard gradients (its
      ``pmean``) within 1e-2 (median 2e-3);
    * the averaged BatchNorm statistics within 2e-5 of JAX's ``pmean``'d
      ones (§C's one-step bar);
    * both ranks identical."""
    images, boxes, labels, mask, init = yolo_inputs
    mesh = make_mesh(2)
    yolo = JaxYolo(nc=2)
    tx = optax.adamw(YOLO_LR)
    step = JF.make_yolo_train_step(yolo, tx, mesh, YOLO_S)
    args = tuple(jnp.asarray(x) for x in (images, boxes, labels, mask))
    jv, _, loss = step(init, tx.init(init["params"]), *args)

    def loss_fn(params, stats, x, b, lab, m):
        out, mut = yolo.apply({"params": params, "batch_stats": stats}, x, train=True, mutable=["batch_stats"])
        return JL.yolov10_loss(out, b, lab, m, YOLO_S), mut["batch_stats"]

    shards = list(zip(*(halves(x) for x in (images, boxes, labels, mask))))
    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))  # one compile for both shards
    grads = [grad_fn(init["params"], init["batch_stats"], *(jnp.asarray(h) for h in hs))[0] for hs in shards]
    mean = jax.tree.map(lambda a, b: (a + b) / 2, *grads)
    jax_grads = {_yolo_key(p, "params"): _torch_value(p[-1], np.asarray(v)) for p, v in _leaves(jax.device_get(mean))}
    exact = [yolo_f64(init, *hs) for hs in shards]
    exact_loss = (exact[0][0] + exact[1][0]) / 2
    exact_grads = {k: (exact[0][1][k] + exact[1][1][k]) / 2 for k in exact[0][1]}
    r0, r1 = (res["yolo_step"] for res in world)
    assert abs(r0["loss"] - exact_loss) <= 1e-5 * exact_loss and r0["loss"] == r1["loss"]
    assert abs(r0["loss"] - float(loss)) <= 1e-5 * exact_loss
    got = {k: v.astype(np.float64) for k, v in r0["grads"].items()}
    assert set(got) == set(jax_grads) == set(exact_grads)
    for want, worst, median in ((exact_grads, 1e-3, 2e-4), (jax_grads, 1e-2, 2e-3)):
        ratios, zero = grad_ratios(got, want)
        assert len(ratios) > 200 and len(zero) < 60
        assert max(ratios) <= worst and np.median(ratios) <= median, (max(ratios), np.median(ratios))
    assert all(np.array_equal(v, r1["grads"][k]) for k, v in r0["grads"].items())
    stats = jax.device_get(jv)["batch_stats"]
    worst = max(float(np.abs(v - np.asarray(_get(stats, p))).max()) for p, v in flat(r0["stats"]))
    assert worst <= 2e-5, worst
    assert all(np.array_equal(v, _get(r1["stats"], p)) for p, v in flat(r0["stats"]))


def test_finetune_yolo_on_a_mesh_matches_jax(world, data, yolo_inputs, monkeypatch):
    """``finetune_yolo(mesh=...)`` against the reference's on ``make_mesh(2)``:
    the hard recipe's options of tests/test_torch_selftrain.py (erase on, 4
    sampled frames a step, so 2 a shard, cosine schedule, EMA), each rank
    fed its shard's replayed draws. Each step's loss within 1e-4 relative
    up to the first step after a real update (the rate is 0 in step 1),
    then within 5e-3 (the card's bar after an update, ROADMAP §C): Adam's
    normalised step takes the sign of near-zero gradients the two round
    apart, and a shard here is 2 sampled frames, so its train-mode
    BatchNorms normalise over fewer values than on one device; measured
    1.46e-3 in step 3 against 5.6e-4 on one device (ROADMAP §C).
    The returned EMA parameters within that file's AdamW bound (which
    holds whatever the gradients' rounding), the median element within
    3e-5 for the same reason (measured 1.33e-5, 4.5e-6 on one device);
    both ranks identical. Steps 1 and 2 run on the initial weights with
    each rank's own sampled and augmented frames, so their 1e-4 holds the
    per-rank draws."""
    gt, _, pscan = data
    arrays = PS.yolo_training_arrays(gt["gt_boxes_2d"], pscan)
    init = yolo_inputs[4]  # the init of tests/test_torch_selftrain.py's run
    monkeypatch.setattr(JaxYolo, "init", lambda self, *a, **k: init)
    jax_losses = []
    recording(monkeypatch, JF, "make_yolo_train_step", jax_losses)
    want = JS.finetune_yolo(*arrays, nc=2, img_size=YOLO_S, steps=STEPS, lr=YOLO_LR, seed=0, log_every=0,
                            augment=DET_AUG, ema_decay=0.9, schedule="cosine", sample_batch=4, mesh=make_mesh(2))
    r0, r1 = (res["finetune_yolo"] for res in world)
    assert not r0["training"] and r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"][:2], jax_losses[:2], rtol=1e-4, atol=0)
    np.testing.assert_allclose(r0["losses"][2:], jax_losses[2:], rtol=5e-3, atol=0)
    sched = warmup_cosine_decay_schedule(0.0, YOLO_LR, 1, STEPS, YOLO_LR * 0.05)
    bound = sum(2 * sched(t - 1) * adam_step_bound(t) for t in range(1, STEPS + 1)) + 1e-6
    diffs = []
    for path, v in flat(r0["variables"]["params"]):
        assert np.array_equal(v, _get(r1["variables"]["params"], path)), path
        d = np.abs(v - _get(want["params"], path))
        assert d.max() <= bound, (path, d.max(), bound)
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) <= 3e-5


def test_finetune_beit_on_a_mesh_matches_jax(world, data, monkeypatch):
    """``finetune_beit(mesh=...)`` with crop augmentation on the capture's
    ground-truth crops (cycled to the world, as the reference pads): each
    loss within 1e-4 relative of the reference's on ``make_mesh(2)``, the
    parameters within the AdamW bound, both ranks identical."""
    gt, _, pscan = data
    crops, labels = PS.beit_training_crops(gt["gt_boxes_2d"], gt["gt_damage_2d"], pscan, 32, device="cpu")
    init = beit_to_flax(init_like_flax_(BeitClassifier(BeitConfig(**BEIT_KW)), torch.Generator().manual_seed(0)))

    def jax_init(beit, rng, lr=1e-4):
        tx = optax.adamw(lr)
        return init, tx, tx.init(init)

    monkeypatch.setattr(JF, "init_finetune", jax_init)
    jax_losses = []
    recording(monkeypatch, JF, "make_beit_train_step", jax_losses)
    want = JS.finetune_beit(crops, labels, JaxBeitConfig(**BEIT_KW), steps=STEPS, lr=1e-3, seed=0, log_every=0,
                            augment=True, mesh=make_mesh(2))
    r0, r1 = (res["finetune_beit"] for res in world)
    np.testing.assert_allclose(r0["losses"], jax_losses, rtol=1e-4, atol=0)
    bound = sum(2 * 1e-3 * adam_step_bound(t) for t in range(1, STEPS + 1)) + 1e-6
    for path, v in flat(r0["params"]["params"]):
        assert np.array_equal(v, _get(r1["params"]["params"], path)), path
        assert np.abs(v - _get(want["params"], path)).max() <= bound, path
