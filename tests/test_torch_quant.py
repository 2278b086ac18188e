"""The port's int8 classifier (``tpu3dlm_torch/ops/quant.py``,
``models/beit.py::Int8Dense``, ``models/weights.py::quantize_beit_variables``)
against the JAX package's (``tpu3dlm/ops/quant.py``), on the CPU.

Tolerances: quantised weights, activations and their scales bitwise equal;
int32 accumulators identical; ``dense_int8`` within 1e-6 relative (the
same f32 operations: only the float matmul-free dequantisation); the int8
toy BEiT's f32 logits within 1e-4 of JAX's on every crop but those where
an activation's int8 code flips at a rounding tie (float drift of ~1e-7
between XLA and PyTorch moves one code by one step; at most one such crop
in 16, and it within 1e-3), and the same top-1 in bf16 on decisive crops.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm.models.beit import BeitClassifier as JBeit, BeitConfig as JConfig, preprocess_crops as jpre
from tpu3dlm.models.weights import quantize_beit_variables as j_quantize
from tpu3dlm.ops import quant as JQ
from tpu3dlm_torch.models.beit import BeitConfig, Int8Dense, preprocess_crops, quantize_beit, seeded_beit
from tpu3dlm_torch.models.weights import beit_from_flax, quantize_beit_variables
from tpu3dlm_torch.ops import quant as TQ

TOY = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, num_labels=3)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def toy_variables():
    """tests/test_quant.py's perturbed toy variables (every leaf non-trivial)."""
    model = JBeit(JConfig(**TOY), dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    leaves, treedef = jax.tree.flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    leaves = [leaf + 0.05 * jax.random.normal(k, leaf.shape, leaf.dtype) for leaf, k in zip(leaves, keys)]
    return _np_tree(jax.tree.unflatten(treedef, leaves))


def _weights(seed=0, shape=(96, 64)):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * rng.lognormal(size=(1, shape[1]))).astype(np.float32)
    w[:, 3] = 0.0  # a dead column: scale eps/127
    return w


def test_quantize_weight_and_rows_bitwise_equal_jax():
    w = _weights()
    jq, js = JQ.quantize_weight(jnp.asarray(w))
    tq, ts = TQ.quantize_weight(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    x = np.random.default_rng(1).normal(size=(5, 7, 96)).astype(np.float32) * 3
    x[0, 0] = 0.0  # a zero row stays finite
    jq, js = JQ.quantize_rows(jnp.asarray(x))
    tq, ts = TQ.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    # round half to even on both sides, on exact halves
    half = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0]], np.float32)
    np.testing.assert_array_equal(TQ.quantize_rows(torch.from_numpy(half))[0].numpy(),
                                  np.asarray(JQ.quantize_rows(jnp.asarray(half))[0]))


@pytest.mark.parametrize("m", [1, 16, 17, 40])
def test_int8_matmul_accumulators_identical(m):
    """int32 accumulators of the twin equal XLA's ``dot_general``; rows ≤ 16
    (the card pads them to 17) included."""
    rng = np.random.default_rng(m)
    xq = rng.integers(-127, 128, (m, 3072), dtype=np.int8)
    wq = rng.integers(-127, 128, (3072, 24), dtype=np.int8)
    want = np.asarray(jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(wq), (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))
    got = TQ.int8_product(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), xq.astype(np.int64) @ wq.astype(np.int64))
    xs = rng.uniform(0.01, 1, (m, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 1, (24,)).astype(np.float32)
    np.testing.assert_array_equal(
        TQ.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq), torch.from_numpy(xs), torch.from_numpy(ws)).numpy(),
        np.asarray(JQ.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs), jnp.asarray(ws))))


def test_dense_int8_matches_jax():
    w = _weights(2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 9, 96)).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    jwq, jws = JQ.quantize_weight(jnp.asarray(w))
    want = np.asarray(JQ.dense_int8(jnp.asarray(x), jwq, jws, jnp.asarray(b)))
    twq, tws = TQ.quantize_weight(torch.from_numpy(w))
    got = TQ.dense_int8(torch.from_numpy(x), twq, tws, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the module form, with the kernel read transposed as on the card
    lin = torch.nn.Linear(96, 64)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(Int8Dense.from_linear(lin)(torch.from_numpy(x)).detach().numpy(), want,
                               rtol=1e-6, atol=1e-6)
    bf = TQ.dense_int8(torch.from_numpy(x).bfloat16(), twq, tws, torch.from_numpy(b))
    assert bf.dtype == torch.bfloat16  # cast back to the module dtype


def test_quantized_tree_identical_and_double_quantisation_refused(toy_variables):
    want = _np_tree(j_quantize(toy_variables))
    got = quantize_beit_variables(toy_variables)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert np.asarray(g).dtype == np.asarray(w).dtype, path
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(path))
    with pytest.raises(ValueError, match="already int8-quantized"):
        quantize_beit_variables(got)
    with pytest.raises(ValueError, match="already int8-quantized"):
        quantize_beit(beit_from_flax(got))


def test_int8_toy_beit_tracks_jax(toy_variables):
    """f32: logits within 1e-4 of JAX's int8 model (see the module
    docstring for the one rounding-tie crop); the JAX-quantised tree and
    the port's module quantiser give the same model. bf16: the same top-1
    on decisive crops."""
    crops = np.random.default_rng(3).integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    q_cfg = JConfig(**{**TOY, "quant": "int8"})
    qv = j_quantize(toy_variables)
    want = np.asarray(JBeit(q_cfg, dtype=jnp.float32).apply(qv, jpre(jnp.asarray(crops))))
    x = preprocess_crops(torch.from_numpy(crops))
    model = beit_from_flax(_np_tree(qv))  # a JAX-quantised tree carried across
    assert model.cfg.quant == "int8"
    with torch.no_grad():
        got = model(x).numpy()
        from_module = quantize_beit(beit_from_flax(toy_variables))(x).numpy()
    np.testing.assert_array_equal(from_module, got)
    err = np.abs(got - want).max(axis=1)
    assert (err <= 1e-4).sum() >= 15 and err.max() <= 1e-3, err
    # bf16 activations: dequantisation casts back to bf16, scales stay f32
    want_bf = np.asarray(JBeit(q_cfg, dtype=jnp.bfloat16).apply(qv, jpre(jnp.asarray(crops))), np.float32)
    bf = model.to(torch.bfloat16)
    assert bf.layers[0].attn.query.scale.dtype == torch.float32
    assert bf.layers[0].fc1.weight_q.dtype == torch.int8
    with torch.no_grad():
        got_bf = bf(x).float().numpy()
    assert np.isfinite(got_bf).all()
    top = np.sort(want_bf, axis=-1)
    decisive = (top[:, -1] - top[:, -2]) > 0.1 * np.abs(want_bf).max()
    assert decisive.any()
    assert (got_bf.argmax(-1) == want_bf.argmax(-1))[decisive].all()


def test_int8_tracks_f32_by_the_jax_bar(toy_variables):
    """tests/test_quant.py's bar on the port alone: softmax drift < 0.1
    against f32 and the same top-1 on decisive crops."""
    crops = np.random.default_rng(3).integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    x = preprocess_crops(torch.from_numpy(crops))
    f32 = beit_from_flax(toy_variables)
    with torch.no_grad():
        l32, l8 = f32(x).numpy(), quantize_beit(f32)(x).numpy()
    p32, p8 = (torch.softmax(torch.from_numpy(v), -1).numpy() for v in (l32, l8))
    drift = float(np.abs(p32 - p8).max())
    assert drift < 0.1
    top = np.sort(l32, axis=-1)
    decisive = (top[:, -1] - top[:, -2]) > 2 * drift * np.abs(l32).max()
    assert decisive.any()
    assert (l32.argmax(-1) == l8.argmax(-1))[decisive].all()


def test_damage_detector_int8_agrees_with_float(toy_variables):
    """tests/test_quant.py:224-250's bar: the int8 DamageDetector labels
    every crop the float model is decisive on as the float one does."""
    from tpu3dlm_torch.pipeline.classifier import DamageDetector

    cfg = BeitConfig(**TOY)
    crops = np.random.default_rng(7).integers(0, 256, (9, 32, 32, 3), dtype=np.uint8)
    base = DamageDetector(config=cfg, beit=beit_from_flax(toy_variables), batch_size=4, device="cpu")
    quant = DamageDetector(config=dataclasses.replace(cfg, quant="int8"),
                           beit=beit_from_flax(quantize_beit_variables(toy_variables)), batch_size=4,
                           device="cpu")
    a, b = base.classify_crops(crops), quant.classify_crops(crops)
    with torch.no_grad():
        logits = base.beit(preprocess_crops(torch.from_numpy(crops))).numpy()
    top = np.sort(logits, axis=-1)
    decisive = (top[:, -1] - top[:, -2]) > 0.1 * np.abs(logits).max()
    assert decisive.any()
    assert (a[decisive] == b[decisive]).all()


def test_seeded_int8_is_the_quantised_float_draw():
    cfg = BeitConfig(**TOY)
    f = seeded_beit(cfg, torch.Generator().manual_seed(5))
    q = seeded_beit(dataclasses.replace(cfg, quant="int8"), torch.Generator().manual_seed(5))
    ref = quantize_beit(f)
    for (k, a), (k2, b) in zip(q.state_dict().items(), ref.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    assert sum(isinstance(m, Int8Dense) for m in q.modules()) == 6 * cfg.num_layers


def test_card_product_refusals(monkeypatch):
    """The card path needs K and N multiples of 8 (cuBLASLt); it raises
    rather than leave int8. CPU tensors never take it."""
    calls = []
    monkeypatch.setattr(torch, "_int_mm", lambda a, b: calls.append((a.shape, b.shape)) or a.new_zeros(0))
    xq = torch.zeros(4, 12, dtype=torch.int8)
    wq = torch.zeros(12, 8, dtype=torch.int8)
    assert TQ.int8_product(xq, wq).shape == (4, 8) and not calls
    with pytest.raises(TypeError, match="int8"):
        TQ.int8_product(xq.float(), wq)


@pytest.mark.parametrize("route", ["fused", "staged", "streamed"])
def test_int8_pipeline_runs_on_every_route(tmp_path, monkeypatch, route):
    """``beit_quant = int8`` through the Pipeline on the committed capture
    (fixture checkpoints, f32): the classifier's projections go through the
    int8 product on each route, and on this capture every damage label is
    the float run's."""
    import chip_smoke
    from tpu3dlm_torch.pipeline import task as PT
    from tpu3dlm_torch.utils.config import ConfigLoader

    fixtures = chip_smoke.FIXTURES
    chip_smoke.copy_project(str(tmp_path))
    patch = chip_smoke.PROJECT_PATCH + [
        ("infer_dtype = bf16", "infer_dtype = f32"),
        ("yolo_weights =", f"yolo_weights = {fixtures}/yolo_synthetic.msgpack"),
        ("beit_weights =", f"beit_weights = {fixtures}/beit_synthetic.msgpack")]
    if route != "staged":
        patch.append(("fused_inference = false", "fused_inference = true"))
    if route == "streamed":
        patch.append(("streaming_chunk = 0", "streaming_chunk = 2"))
    products = []
    real = TQ.int8_product
    monkeypatch.setattr(TQ, "int8_product", lambda a, b: products.append(a.shape) or real(a, b))
    damage = {}
    for quant in ("none", "int8"):
        cfg = chip_smoke.write_config(str(tmp_path), patch + [("beit_quant = none", f"beit_quant = {quant}")])
        c = ConfigLoader(cfg, "gold_std")
        assert c.beit_quant == quant
        before = len(products)
        out = PT.setup_pipeline("gold_std", c, None, device="cpu").data_to_save
        assert (len(products) > before) == (quant == "int8")
        damage[quant] = [r[4] for f in sorted(out["predictions"]) for r in out["predictions"][f]]
    assert damage["int8"] and damage["int8"] == damage["none"]
