"""The BEiT finetune step (tpu3dlm_torch/parallel/finetune.py) against the
JAX package's (tpu3dlm/parallel/finetune.py) on the CPU: the same Flax
weights (carried by ``beit_from_flax``) and the same numpy crops through
both, f32. Gradients flow through kernel B1's Function (its twin on the
CPU). Each tolerance is stated beside its check."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from tpu3dlm.models.beit import BeitClassifier as JaxBeit
from tpu3dlm.models.beit import BeitConfig as JaxBeitConfig
from tpu3dlm.models.beit import preprocess_crops as jax_preprocess
from tpu3dlm.parallel import finetune as JF
from tpu3dlm_torch.models.weights import _beit_key, _torch_value, beit_from_flax
from tpu3dlm_torch.ops.kernels.attention import BeitAttentionPackedFn
from tpu3dlm_torch.parallel.finetune import (
    ADAMW_BETAS,
    beit_loss,
    init_finetune,
    make_beit_train_step,
)

torch.set_num_threads(1)

CFG = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, num_labels=3)
LR = 1e-3
STEPS = 3


@pytest.fixture(scope="module")
def setup():
    """Seeded Flax weights in the shapes of the reference's init (taken by
    ``jax.eval_shape``, so nothing compiles), off every init value (a zero
    cls token would put LayerNorm at eps = 1e-12 and scale its gradient by
    1e6): kernels, biases, tables and the cls token N(0, 0.02²), LayerNorm
    scales 1 + N(0, 0.02²), layer scales 0.1 + N(0, 0.02²). Then optax
    ``adamw(LR)``, the reference's optimizer, and a learnable batch: label
    0 dark, 1 mid, 2 bright crops."""
    beit = JaxBeit(JaxBeitConfig(**CFG))
    shapes = jax.eval_shape(beit.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(0)
    centre = {"scale": 1.0, "lambda_1": 0.1, "lambda_2": 0.1}
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: (centre.get(path[-1].key, 0.0) + rng.normal(0, 0.02, s.shape)).astype(np.float32),
        shapes,
    )
    tx = optax.adamw(LR)
    labels = np.tile(np.arange(3, dtype=np.int32), 4)[:10]
    lo = np.array([0, 90, 180])[labels][:, None, None, None]
    crops = (lo + rng.integers(0, 70, (10, 32, 32, 3))).astype(np.uint8)
    return beit, params, tx, tx.init(params), crops, labels


def attention_nodes(root) -> int:
    """How many nodes of the autograd graph under ``root`` are B1's
    Function."""
    seen, stack, n = set(), [root], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        n += getattr(node, "_forward_cls", None) is BeitAttentionPackedFn
        stack.extend(f for f, _ in node.next_functions)
    return n


def port_grads_by_name(jax_grads) -> dict[str, np.ndarray]:
    """A Flax gradient tree in the port's parameter names and layouts."""
    out = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out[_beit_key(path + (k,))] = _torch_value(k, np.asarray(v, np.float32))

    walk(jax_grads)
    return out


def test_loss_and_gradients_match_jax(setup):
    """One loss and its gradient, every parameter: within 1e-5 abs and
    rel of ``jax.value_and_grad`` of the reference's loss (f32; the two
    differ by summation order only). The attention output's ``grad_fn`` is
    B1's Function, so the gradient went through it."""
    beit, params, _, _, crops, labels = setup

    def loss_fn(p):
        logits = beit.apply(p, jax_preprocess(jnp.asarray(crops)))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    port = beit_from_flax(params)
    loss = beit_loss(port, torch.from_numpy(crops), torch.from_numpy(labels))
    assert attention_nodes(loss.grad_fn) == CFG["num_layers"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5, rtol=1e-5)
    want = port_grads_by_name(want_grads["params"])
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert got.keys() == want.keys()
    for name in want:
        assert np.abs(got[name]).max() > 0, name
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=1e-5, err_msg=name)


def adam_step_bound(t: int) -> float:
    """The largest |m̂_t| / √v̂_t Adam can produce at step t, for any
    gradients: by Cauchy–Schwarz over m_t = (1−β1) Σ β1^(t−i) g_i,
    (1−β1)/√(1−β2) · √(Σ_{k<t} (β1²/β2)^k) · √(1−β2^t)/(1−β1^t); 1 at t=1."""
    b1, b2 = ADAMW_BETAS
    geo = sum((b1 * b1 / b2) ** k for k in range(t))
    return (1 - b1) / np.sqrt(1 - b2) * np.sqrt(geo) * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)


def test_three_steps_match_jax(setup):
    """Three AdamW steps of both train steps (JAX on a one-device mesh):
    losses within 1e-5 (f32, summation order), every step's loss finite.

    Parameters: Adam normalises each update, so a gradient element near 0
    whose sign the two summation orders disagree on moves the parameter by
    up to a full ±lr·r_t in opposite directions. Both updates are bounded
    by lr·r_t (``adam_step_bound``) plus the same weight decay, so after T
    steps any element may differ by at most Σ_t 2·lr·r_t (+1e-6 of f32
    rounding): the bound checked here. Elements away from such sign flips
    agree far closer, so the median difference is held to 1e-6."""
    beit, params, tx, opt_state, crops, labels = setup
    mesh = Mesh(np.array(jax.devices()[:1]), ("batch",))
    jax_step = JF.make_beit_train_step(beit, tx, mesh)
    port = beit_from_flax(params)
    opt = init_finetune(port, lr=LR, device="cpu")
    step = make_beit_train_step(port, opt, device="cpu")
    jp, js = params, opt_state
    for _ in range(STEPS):
        jp, js, want = jax_step(jp, js, jnp.asarray(crops), jnp.asarray(labels))
        got = step(crops, labels)
        assert np.isfinite(float(got))
        np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=1e-5)
    bound = sum(2 * LR * adam_step_bound(t) for t in range(1, STEPS + 1)) + 1e-6
    want = port_grads_by_name(jax.device_get(jp)["params"])  # parameters, same mapping
    diffs = []
    for name, p in port.named_parameters():
        d = np.abs(p.detach().numpy() - want[name])
        assert d.max() <= bound, (name, d.max(), bound)
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) <= 1e-6


def test_step_refuses_what_is_not_ported(setup):
    """``augment`` (A19) and a mesh (A22) raise, and so does the CUDA
    default without a card."""
    port = beit_from_flax(setup[1])
    opt = init_finetune(port, device="cpu")
    with pytest.raises(NotImplementedError):
        make_beit_train_step(port, opt, augment={}, device="cpu")
    with pytest.raises(NotImplementedError):
        make_beit_train_step(port, opt, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_beit_train_step(port, opt)
