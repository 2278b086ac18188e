"""The YOLOv10 training loss of the port (tpu3dlm_torch/models/yolo_loss.py,
the train-mode forward of models/yolov10.py, layers.FlaxBatchNorm2d)
against the JAX package's on the CPU. Each tolerance is stated beside its
check; where a bar is looser than 1e-4 on gradients or 1e-6 on statistics,
it is logged in ROADMAP §C with the measured error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from tpu3dlm.models import yolo_loss as JL
from tpu3dlm.models import yolov10 as JY
from tpu3dlm.models.weights import assert_tree_matches
from tpu3dlm_torch.models import yolo_loss as PL
from tpu3dlm_torch.models import yolov10 as PY
from tpu3dlm_torch.models.layers import FlaxBatchNorm2d, init_like_flax_
from tpu3dlm_torch.models.weights import _leaves, _torch_value, _yolo_key, yolov10_from_flax, yolov10_to_flax

torch.set_num_threads(1)

S, B, G = 64, 3, 4


def gt_batch(rng, b=B, g=G, s=S):
    xy = rng.uniform(0, s * 0.6, (b, g, 2))
    wh = rng.uniform(s / 8, s * 0.4, (b, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, 2, (b, g)).astype(np.int32)
    mask = rng.uniform(size=(b, g)) < 0.8
    mask[:, 0] = True
    return boxes, labels, mask


def rand_boxes(rng, shape):
    xy = rng.uniform(0, 50, shape + (2,))
    wh = rng.uniform(0.5, 30, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_iou_and_ciou_match_jax(rng):
    a, b = rand_boxes(rng, (64,)), rand_boxes(rng, (64,))
    b[:8] = a[:8]  # identical boxes
    b[8:16, 0] = a[8:16, 2] + 1  # disjoint
    for jf, pf in ((JL.pairwise_iou, PL.pairwise_iou), (JL.ciou, PL.ciou)):
        np.testing.assert_allclose(pf(torch.from_numpy(a), torch.from_numpy(b)).numpy(), np.asarray(jf(a, b)),
                                   atol=1e-6, rtol=1e-6)


def test_ciou_alpha_is_detached():
    """The gradient of CIoU treats ``alpha`` as a constant, as the
    reference's ``stop_gradient``: equal to JAX's gradient."""
    a = np.array([[1.0, 2.0, 9.0, 5.0]], np.float32)
    b = np.array([[2.0, 1.0, 6.0, 8.0]], np.float32)
    want = jax.grad(lambda x: JL.ciou(x, b).sum())(a)
    t = torch.from_numpy(a).requires_grad_()
    PL.ciou(t, torch.from_numpy(b)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def decode_f64(raw, img_size):
    """``decode_raw``'s boxes computed in float64 from the same f32 raw
    values: the DFL softmax expectation × stride, around the f32 anchors."""
    anchors, strides = (t.double().numpy() for t in PY.make_anchors(img_size))
    flat = np.concatenate([r.reshape(r.shape[0], -1, r.shape[-1]) for r in raw], 1).astype(np.float64)
    box = flat[..., : 4 * 16].reshape(flat.shape[0], flat.shape[1], 4, 16)
    p = np.exp(box - box.max(-1, keepdims=True))
    dist = (p / p.sum(-1, keepdims=True)) @ np.arange(16.0)
    s = strides[None, :, None]
    return np.concatenate([(anchors[None] - dist[..., :2]) * s, (anchors[None] + dist[..., 2:]) * s], -1)


@pytest.mark.parametrize("seed", [0, 1, 2, 392])
def test_make_anchors_and_decode_match_jax(seed):
    """Boxes held against f32 rounding. Over seeds 0-399 of this draw (two
    frames at 128 px, strides 8/16/32) the port's boxes sat within 2.45
    ulp of the float64 value at the largest |coordinate| (377-527 px, so
    one ulp is 3.05e-5 or 6.10e-5 px), JAX's within 2.91, and the two
    apart by up to 4 ulp (1.22e-4 px at seed 392). So each side is held to
    3 ulp of float64, and port against JAX to 6 ulp (the sum). Scores are
    identical, and the split head input gives the same output bit for
    bit."""
    rng = np.random.default_rng(seed)
    a, s = JY.make_anchors(128)
    pa, ps = PY.make_anchors(128)
    assert np.array_equal(pa.numpy(), np.asarray(a)) and np.array_equal(ps.numpy(), np.asarray(s))
    raw = [rng.normal(size=(2, 128 // st, 128 // st, 4 * 16 + 3)).astype(np.float32) for st in (8, 16, 32)]
    jb, jc = JY.decode_raw([jnp.asarray(r) for r in raw], 128)
    pb, pc = PY.decode_raw([torch.from_numpy(r) for r in raw], 128)
    want = decode_f64(raw, 128)
    ulp = float(np.spacing(np.float32(np.abs(want).max())))
    got, jax_boxes = pb.numpy().astype(np.float64), np.asarray(jb, np.float64)
    assert np.abs(got - want).max() <= 3 * ulp
    assert np.abs(jax_boxes - want).max() <= 3 * ulp
    np.testing.assert_allclose(got, jax_boxes, atol=6 * ulp, rtol=0)
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    split = [(torch.from_numpy(r[..., :64]), torch.from_numpy(r[..., 64:])) for r in raw]
    sb, sc = PY.decode_raw(split, 128)
    assert torch.equal(sb, pb) and torch.equal(sc, pc)


@pytest.mark.parametrize("top_k", [1, 10])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_task_aligned_assign_matches_jax_with_ties(top_k, seed):
    """Targets and foreground identical to JAX's, with ties on purpose:
    runs of anchors with the same prediction (equal metrics: the top-k
    keeps the lower index) and duplicated ground truths (the anchor goes to
    the first)."""
    rng = np.random.default_rng(seed)
    A, nc = 84, 2
    anchors = np.stack(np.meshgrid(np.arange(0, 64, 6.0), np.arange(0, 64, 9.0)), -1).reshape(-1, 2)[:A]
    anchors = anchors.astype(np.float32)
    scores = rng.uniform(0.05, 0.95, (B, A, nc)).astype(np.float32)
    pred = rand_boxes(rng, (B, A))
    scores[:, 10:20] = scores[:, 10:11]
    pred[:, 10:20] = pred[:, 10:11]
    gtb, gtl, gtm = gt_batch(rng)
    gtb[:, 1], gtl[:, 1], gtm[:, 1] = gtb[:, 0], gtl[:, 0], True  # a duplicated gt
    pred[:, 10:20] = gtb[:, 0:1] + rng.uniform(-2, 2, (B, 1, 4)).astype(np.float32)  # the tied run inside it
    anchors[10:20] = (gtb[0, 0, :2] + gtb[0, 0, 2:]) / 2
    want = JL.task_aligned_assign(*(jnp.asarray(x) for x in (scores, pred, anchors, gtb, gtl, gtm)), top_k)
    got = PL.task_aligned_assign(*(torch.from_numpy(x) for x in (scores, pred, anchors, gtb, gtl, gtm)), top_k)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))  # foreground
    assert got[2].sum() > 0
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))  # target boxes
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=1e-5)


def test_dfl_and_bce_match_jax(rng):
    import optax

    logits = rng.normal(size=(5, 7, 4, 16)).astype(np.float32)
    target = rng.uniform(-1, 16, (5, 7, 4)).astype(np.float32)  # clipped both sides
    np.testing.assert_allclose(PL.dfl_loss(torch.from_numpy(logits), torch.from_numpy(target)).numpy(),
                               np.asarray(JL._dfl_loss(jnp.asarray(logits), jnp.asarray(target))),
                               atol=1e-6, rtol=1e-6)
    x = rng.normal(0, 4, (50,)).astype(np.float32)
    t = rng.uniform(size=(50,)).astype(np.float32)
    np.testing.assert_allclose(PL.sigmoid_binary_cross_entropy(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
                               np.asarray(optax.sigmoid_binary_cross_entropy(x, t)), atol=1e-6, rtol=1e-6)


def test_batchnorm_train_mode_is_flax(rng):
    """One train-mode BatchNorm against Flax's (momentum 0.97, eps 1e-3):
    output within 1e-5, the updated mean and var within 1e-6 (the biased
    batch variance, where ``nn.BatchNorm2d`` would use the unbiased)."""
    x = (rng.normal(size=(4, 6, 5, 8)) * 3 + 1).astype(np.float32)  # NHWC
    bn = nn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32), "bias": rng.normal(size=8).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=8).astype(np.float32),
                         "var": rng.uniform(0.5, 2, 8).astype(np.float32)}}
    y, mut = bn.apply(v, x, mutable=["batch_stats"])
    port = FlaxBatchNorm2d(8, eps=1e-3, momentum=0.03)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        port.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        port.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        port.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    out = port.train()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), atol=1e-6, rtol=0)
    eval_out = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))  # eval mode is nn.BatchNorm2d's
    assert torch.equal(eval_out, torch.nn.BatchNorm2d.forward(port, torch.from_numpy(x).permute(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def step1():
    """One train-mode loss and gradient of YOLOv10-n (nc 2) at 64 px, JAX
    and port, from the same weights (the port's Flax-like init carried to
    Flax by ``yolov10_to_flax``; one JAX compile for the module), and the
    port's network again in float64 (the loss's f32 decode and the gradient
    it sends back unchanged): the exact value both f32 runs round."""
    import copy

    rng = np.random.default_rng(3)
    imgs = rng.uniform(size=(B, S, S, 3)).astype(np.float32)
    gt = gt_batch(rng)
    init = init_like_flax_(PY.YOLOv10(nc=2, variant="n"), torch.Generator().manual_seed(0))
    variables = yolov10_to_flax(init)
    model = JY.YOLOv10(nc=2, variant="n")

    def loss_fn(params, stats):
        out, mut = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(imgs), train=True,
                               mutable=["batch_stats"])
        return JL.yolov10_loss(out, *(jnp.asarray(x) for x in gt), S), mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"],
                                                                             variables["batch_stats"])

    def port_run(dtype):
        port = copy.deepcopy(init).to(dtype).train()
        aux = {}
        got = PL.yolov10_loss(port(torch.from_numpy(imgs).to(dtype)), *(torch.from_numpy(x) for x in gt), S, aux=aux)
        got.backward()
        return port, got.item(), aux

    flax_names = lambda tree, coll: {_yolo_key(p, coll): _torch_value(p[-1], v)  # noqa: E731
                                     for p, v in _leaves(jax.device_get(tree))}
    port, got, aux = port_run(torch.float32)
    port64, _, _ = port_run(torch.float64)
    return dict(port=port, port64=port64, loss=float(loss), got=got, aux=aux,
                grads=flax_names(grads, "params"), stats=flax_names(stats, "batch_stats"))


def test_yolov10_loss_matches_jax(step1):
    """The loss within 1e-5 relative (measured 4e-7), both heads with
    foreground anchors."""
    assert abs(step1["got"] - step1["loss"]) <= 1e-5 * abs(step1["loss"])
    assert step1["aux"]["fg_one2many"].sum() > step1["aux"]["fg_one2one"].sum() > 0


def grad_ratios(got: dict, want: dict) -> tuple[list, list]:
    """Per tensor max|got − want| / max|want|, over the tensors with a real
    gradient; and the names of those whose gradient is zero but for
    rounding (max|want| < 1e-6 × the model's largest gradient: a BatchNorm
    bias feeding the next BatchNorm through a bias-free conv)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    ratios, zero = [], []
    for name, w in want.items():
        scale = float(np.abs(w).max())
        if scale <= 1e-6 * top:
            zero.append(name)
            assert np.abs(got[name] - w).max() <= 1e-4 * top, name
        else:
            ratios.append(float(np.abs(got[name] - w).max()) / scale)
    return ratios, zero


def test_yolov10_gradients_match_jax(step1):
    """Every parameter's gradient against ``jax.grad``'s.

    A bar of 1e-4 × each tensor's max-abs does not hold against
    JAX's f32 gradient at 64 px: the P5 maps are 2 × 2, so a train-mode
    BatchNorm there normalises over 12 values, and Flax's E[x²] − E[x]²
    variance rounds its backward ~10× worse than torch's. Against the
    port's float64 gradient JAX is off by up to 2.9e-3 × max-abs (median
    7.2e-4), the port's f32 by up to 3.8e-4 (median 7.4e-5). So:

    * the port's f32 gradient within 1e-3 × each tensor's max-abs of the
      float64 one, the median tensor within 2e-4;
    * JAX's within 5e-3 of that same float64 gradient (it computes the same
      function), the median within 2e-3;
    * port against JAX directly within 1e-2, the median within 2e-3.

    Rounding-zero tensors (``grad_ratios``) within 1e-4 × the model's
    largest gradient of each. ROADMAP §C logs these bars."""
    port = {n: p.grad.double().numpy() for n, p in step1["port"].named_parameters()}
    exact = {n: p.grad.numpy() for n, p in step1["port64"].named_parameters()}
    jax_g = step1["grads"]
    assert set(port) == set(jax_g) == set(exact)
    for got, want, worst, median in ((port, exact, 1e-3, 2e-4), (jax_g, exact, 5e-3, 2e-3),
                                     (port, jax_g, 1e-2, 2e-3)):
        ratios, zero = grad_ratios(got, want)
        assert len(ratios) > 200 and len(zero) < 60
        assert max(ratios) <= worst and np.median(ratios) <= median, (max(ratios), np.median(ratios))


def test_batch_stats_after_one_step_match_flax(step1):
    """The running statistics the forward wrote against Flax's mutated
    ``batch_stats``: within 2e-5 (measured 8.8e-6: across the model, conv
    summation order moves the batch variance of the 2 × 2 maps; a bar of
    1e-6 holds for one layer on the same input,
    ``test_batchnorm_train_mode_is_flax``), and the port's within 5e-6 of
    its float64 run's. ROADMAP §C."""
    sd, sd64 = step1["port"].state_dict(), step1["port64"].state_dict()
    assert set(step1["stats"]) == {k for k in sd if k.endswith(("running_mean", "running_var"))}
    worst = max(float(np.abs(sd[k].numpy() - v).max()) for k, v in step1["stats"].items())
    worst64 = max(float((sd[k].double() - sd64[k]).abs().max()) for k in step1["stats"])
    assert worst <= 2e-5 and worst64 <= 5e-6, (worst, worst64)
    moved = max(float(np.abs(sd[k].numpy() - (1.0 if k.endswith("var") else 0.0)).max()) for k in step1["stats"])
    assert moved > 1e-3  # the step did update them


def test_one_to_one_head_reads_detached_features():
    """In train mode no gradient reaches the backbone or the one-to-many
    head from the one-to-one loss; in eval mode the features are not
    detached."""
    rng = np.random.default_rng(5)
    model = init_like_flax_(PY.YOLOv10(nc=2, variant="n"), torch.Generator().manual_seed(1)).train()
    gtb, gtl, gtm = gt_batch(rng)
    out = model(torch.from_numpy(rng.uniform(size=(B, S, S, 3)).astype(np.float32)))
    assert set(out) == {"one2one_split", "one2many_split"}
    loss = PL.detection_loss_one_head(out["one2one_split"], *(torch.from_numpy(x) for x in (gtb, gtl, gtm)), S,
                                      top_k=1)
    loss.backward()
    reached = [n for n, p in model.named_parameters() if p.grad is not None and p.grad.abs().max() > 0]
    assert reached and all(".one2one_" in n for n in reached), reached
    assert all(p.grad is None for n, p in model.named_parameters() if ".one2one_" not in n)
    model.eval()
    feats = model(torch.zeros(1, S, S, 3, requires_grad=True))
    assert set(feats) == {"one2one_split"} and feats["one2one_split"][0][0].requires_grad


def test_flax_round_trip_and_s2d_stem(rng):
    """``yolov10_to_flax`` gives the reference's tree (structure and shapes
    of ``jax.eval_shape`` of its init, for both stems) and
    ``yolov10_from_flax`` takes it back identically; ``space_to_depth``
    equals the reference's."""
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    assert np.array_equal(PY.space_to_depth(torch.from_numpy(x)).numpy(), np.asarray(JY.space_to_depth(x)))
    for stem in ("conv", "s2d"):
        port = init_like_flax_(PY.YOLOv10(nc=2, variant="n", stem=stem), torch.Generator().manual_seed(2))
        tree = yolov10_to_flax(port)
        shapes = jax.eval_shape(JY.YOLOv10(nc=2, variant="n", stem=stem).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)))
        for coll in ("params", "batch_stats"):
            assert assert_tree_matches(tree[coll], jax.tree.map(lambda s: np.zeros(s.shape), shapes[coll])) == []
        back = yolov10_from_flax(tree, nc=2)
        assert back.stem == stem
        for (k, a), (k2, b) in zip(port.state_dict().items(), back.state_dict().items()):
            assert k == k2 and torch.equal(a, b), k


def test_s2d_forward_matches_jax(rng):
    """A YOLOv10-n with the space-to-depth stem, eval mode, against the
    reference on the same weights: the head maps within 1e-4."""
    port = init_like_flax_(PY.YOLOv10(nc=2, variant="n", stem="s2d"), torch.Generator().manual_seed(4)).eval()
    x = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    want = JY.YOLOv10(nc=2, variant="n", stem="s2d").apply(yolov10_to_flax(port), jnp.asarray(x))["one2one_split"]
    with torch.no_grad():
        got = port(torch.from_numpy(x))["one2one_split"]
    for (gb, gc), (wb, wc) in zip(got, want):
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-4, rtol=1e-4)
