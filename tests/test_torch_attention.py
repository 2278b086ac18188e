"""Kernels B1 and B3 (tpu3dlm_torch/ops/kernels/attention.py): their plain
twins held against the JAX package's references and its Pallas kernels
(interpret mode, as the package's own CPU tests run them), also at the token counts and head
widths past the wrappers' old limits (ROADMAP C1), both ops' gradients
against ``jax.grad`` through the JAX package's custom VJPs, the wrappers'
dispatch and input checks. The CUDA kernels themselves are held
against the twins on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu3dlm.ops.pallas import attention as JA
from tpu3dlm.ops.pallas.attention import beit_attention_packed_pallas
from tpu3dlm.ops.pallas.attention import beit_attention_packed_reference as jax_reference
from tpu3dlm_torch.ops.kernels.attention import (
    BeitAttentionFn,
    BeitAttentionPackedFn,
    beit_attention,
    beit_attention_packed,
    beit_attention_packed_reference,
    beit_attention_reference,
)

torch.set_num_threads(1)

# (B, N, h, d): the packed-kernel shapes of tests/test_models.py
SHAPES = [(3, 5, 2, 64), (5, 7, 4, 32), (4, 33, 3, 16), (2, 9, 12, 64)]


def qkvb(seed, B, N, h, d):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return mk(B, N, h * d), mk(B, N, h * d), mk(B, N, h * d), mk(h, N, N)


def port(q, k, v, bias, h, dtype=torch.float32, fn=beit_attention_packed_reference):
    args = [torch.from_numpy(a).to(dtype) for a in (q, k, v)] + [torch.from_numpy(bias)]
    return fn(*args, h).float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_jax_reference(shape):
    """f32: atol/rtol 1e-5 (same math, matmuls summed in another order)."""
    B, N, h, d = shape
    q, k, v, bias = qkvb(0, *shape)
    want = np.asarray(jax_reference(*(jnp.asarray(a) for a in (q, k, v, bias)), h))
    np.testing.assert_allclose(port(q, k, v, bias, h), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_pallas_kernel_interpret(shape):
    """Against the TPU kernel itself, run in interpret mode: f32 atol/rtol
    1e-5."""
    B, N, h, d = shape
    q, k, v, bias = qkvb(1, *shape)
    want = np.asarray(
        beit_attention_packed_pallas(
            *(jnp.asarray(a) for a in (q, k, v, bias)), h, block_b=2, interpret=True
        )
    )
    np.testing.assert_allclose(port(q, k, v, bias, h), want, atol=1e-5, rtol=1e-5)


def test_twin_bf16_matches_jax_reference():
    """bf16 operands, f32 scores/softmax, p cast to bf16, f32 accumulation:
    within 1e-2 abs and rel (one bf16 ulp of p and of the output)."""
    q, k, v, bias = qkvb(2, 4, 33, 3, 16)
    want = np.asarray(
        jax_reference(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(bias), 3),
        np.float32,
    )
    got = port(q, k, v, bias, 3, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)


def test_wrapper_runs_twin_on_cpu_without_counting():
    """CPU tensors go to the twin, bit for bit, and are not counted as
    kernel launches."""
    q, k, v, bias = qkvb(3, 2, 9, 2, 16)
    before = beit_attention_packed.launches
    got = port(q, k, v, bias, 2, fn=beit_attention_packed)
    np.testing.assert_array_equal(got, port(q, k, v, bias, 2))
    assert beit_attention_packed.launches == before


@pytest.mark.parametrize(
    "case",
    ["float16", "bias_shape", "bias_bf16", "non_contiguous", "no_tokens", "misaligned",
     "mixed_types", "heads_not_dividing", "no_heads", "rank", "bias_float64", "bias_elsewhere",
     "unsupported_device"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    B, N, h, d = 2, 9, 2, 16
    q, k, v, bias = (torch.from_numpy(a) for a in qkvb(4, B, N, h, d))
    if case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "bias_shape":
        bias = bias[:, :, :-1]
    elif case == "bias_bf16":
        bias = bias.bfloat16()
    elif case == "non_contiguous":
        q = torch.randn(B, h * d, N).transpose(1, 2)
    elif case == "no_tokens":
        q = k = v = torch.zeros(B, 0, h * d)
        bias = torch.zeros(h, 0, 0)
    elif case == "misaligned":  # contiguous, but one element past a 16-byte boundary
        q = torch.zeros(B * N * h * d + 1)[1:].view(B, N, h * d)
    elif case == "mixed_types":
        k = k.bfloat16()
    elif case == "heads_not_dividing":
        h = 3
        bias = torch.zeros(h, N, N)
    elif case == "no_heads":
        h = 0
    elif case == "rank":
        q, k, v = q[None], k[None], v[None]
    elif case == "bias_float64":
        bias = bias.double()
    elif case == "bias_elsewhere":
        bias = bias.to("meta")
    elif case == "unsupported_device":
        q, k, v, bias = (t.to("meta") for t in (q, k, v, bias))
    with pytest.raises(ValueError):
        beit_attention_packed(q, k, v, bias, h)


# ---------------------------------------------------------------------------
# B3: head-major (h, B, N, d)
# ---------------------------------------------------------------------------

# (h, B, N, d), block_b: the head-major shapes of tests/test_models.py
# (TestPallasAttention), with the head width raised to one the kernel takes
# where the JAX test uses 4; plus the BEiT-base head layout
HM_SHAPES = [((2, 3, 5, 16), 8), ((2, 5, 7, 32), 2), ((3, 4, 33, 16), 4), ((12, 2, 9, 64), 16)]


def hm_qkvb(seed, h, B, N, d):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return mk(h, B, N, d), mk(h, B, N, d), mk(h, B, N, d), mk(h, N, N)


def hm_port(q, k, v, bias, dtype=torch.float32, fn=beit_attention_reference):
    args = [torch.from_numpy(a).to(dtype) for a in (q, k, v)] + [torch.from_numpy(bias)]
    return fn(*args).float().numpy()


@pytest.mark.parametrize("shape,bb", HM_SHAPES + [((2, 3, 5, 4), 8), ((2, 5, 7, 4), 2)])
def test_b3_twin_matches_pallas_interpret_and_reference(shape, bb):
    """The twin against the TPU kernel in interpret mode and against the
    JAX einsum twin, at the JAX tests' own shapes too (d = 4, which only
    the twin takes): f32 atol/rtol 1e-5 (summation order only)."""
    q, k, v, bias = hm_qkvb(5, *shape)
    jq = [jnp.asarray(a) for a in (q, k, v, bias)]
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(JA.beit_attention_pallas(*jq, block_b=bb))
    ref = np.asarray(JA.beit_attention_reference(*jq))
    got = hm_port(q, k, v, bias)
    assert got.shape == shape
    np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,bb", HM_SHAPES)
def test_b3_op_matches_pallas_interpret(shape, bb):
    """The public op ``beit_attention`` on CPU tensors (its twin), against
    the TPU kernel in interpret mode: f32 1e-5; no kernel launch counted."""
    q, k, v, bias = hm_qkvb(6, *shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JA.beit_attention_pallas(*(jnp.asarray(a) for a in (q, k, v, bias)), block_b=bb))
    before = beit_attention.launches
    np.testing.assert_allclose(hm_port(q, k, v, bias, fn=beit_attention), want, atol=1e-5, rtol=1e-5)
    assert beit_attention.launches == before


def test_b3_bf16_matches_pallas_interpret():
    """bf16 operands (test_models.py's bf16 case, head width 16): f32
    scores and softmax, p cast to bf16, f32 accumulation; within 1e-2 abs
    and rel (one bf16 ulp of p and of the output)."""
    q, k, v, bias = hm_qkvb(7, 2, 4, 9, 16)
    jq = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)] + [jnp.asarray(bias)]
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(JA.beit_attention_pallas(*jq), np.float32)
    ref = np.asarray(JA.beit_attention_reference(*jq), np.float32)
    for fn in (beit_attention_reference, beit_attention):
        got = hm_port(q, k, v, bias, dtype=torch.bfloat16, fn=fn)
        np.testing.assert_allclose(got, kernel, atol=1e-2, rtol=1e-2)
        np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-2)


def test_b3_matches_b1_through_the_layouts():
    """The counterpart of test_models.py's packed-vs-head-major check: the
    two ops on one input, moved between layouts, within f32 1e-5."""
    B, N, h, d = 3, 11, 2, 32
    q, k, v, bias = (torch.from_numpy(a) for a in qkvb(8, B, N, h, d))
    packed = beit_attention_packed(q, k, v, bias, h)
    split = lambda t: t.reshape(B, N, h, d).permute(2, 0, 1, 3).contiguous()  # noqa: E731
    hm = beit_attention(split(q), split(k), split(v), bias)
    torch.testing.assert_close(hm.permute(1, 2, 0, 3).reshape(B, N, h * d), packed,
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Gradients: both ops against jax.grad through the JAX custom VJPs
# ---------------------------------------------------------------------------


def _port_grads(fn, arrays, weight):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    assert out.requires_grad
    (out * torch.from_numpy(weight)).sum().backward()
    return out, [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("shape", [(3, 4, 33, 16), (2, 2, 7, 32)])
def test_b3_grads_match_jax_custom_vjp(shape):
    """q, k, v and bias gradients of ``beit_attention`` against ``jax.grad``
    through the JAX package's ``beit_attention`` (custom VJP, backward by
    recompute): f32 atol/rtol 1e-5 (the counterpart of test_models.py's
    test_custom_vjp_matches_reference_grads). The output's ``grad_fn`` is
    the port's Function."""
    arrays = hm_qkvb(9, *shape)
    w = np.random.default_rng(10).standard_normal(shape).astype(np.float32)
    loss = lambda q, k, v, b: jnp.sum(JA.beit_attention(q, k, v, b) * w)  # noqa: E731
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays))
    out, got = _port_grads(beit_attention, arrays, w)
    assert out.grad_fn._forward_cls is BeitAttentionFn
    for g, wg in zip(got, want):
        assert g.shape == wg.shape
        np.testing.assert_allclose(g, np.asarray(wg), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 7, 2, 16), (2, 9, 12, 64)])
def test_b1_grads_match_jax_custom_vjp(shape):
    """q, k, v and bias gradients of ``beit_attention_packed`` against
    ``jax.grad`` of (out²).sum() through the JAX package's
    ``beit_attention_packed`` (test_models.py's
    test_packed_custom_vjp_matches_reference_grads): f32 atol/rtol 1e-5."""
    B, N, h, d = shape
    arrays = qkvb(11, *shape)
    loss = lambda q, k, v, b: (JA.beit_attention_packed(q, k, v, b, h) ** 2).sum()  # noqa: E731
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = beit_attention_packed(*ts, h)
    assert out.grad_fn._forward_cls is BeitAttentionPackedFn
    (out ** 2).sum().backward()
    for t, wg in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), atol=1e-5, rtol=1e-5)


def test_b1_gradient_reaches_beit_weights():
    """Through a BEiT layer the query, key and value weights and the
    relative-position-bias table (through the index gather) get non-zero
    gradients, equal to autograd of the plain twin within 1e-5."""
    from tpu3dlm_torch.models import beit as beit_mod
    from tpu3dlm_torch.models.beit import BeitAttention, BeitConfig

    cfg = BeitConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=1, num_heads=4,
                     intermediate_size=128)
    torch.manual_seed(0)
    attn = BeitAttention(cfg)
    with torch.no_grad():
        attn.relative_position_bias_table.normal_()
    x = torch.randn(3, cfg.num_patches + 1, cfg.hidden_size)
    names = ("query.weight", "key.weight", "value.weight", "relative_position_bias_table")

    def grads():
        attn.zero_grad(set_to_none=True)
        attn(x).square().sum().backward()
        params = dict(attn.named_parameters())
        return [params[n].grad.clone() for n in names]

    got = grads()
    real = beit_mod.beit_attention_packed
    beit_mod.beit_attention_packed = beit_attention_packed_reference  # plain autograd
    try:
        want = grads()
    finally:
        beit_mod.beit_attention_packed = real
    for name, g, w in zip(names, got, want):
        assert g.abs().max() > 0, name
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "case",
    ["bias_shape", "rank", "non_contiguous", "empty_batch", "misaligned", "mixed_types",
     "bias_elsewhere"],
)
def test_b3_rejects_what_the_kernel_does_not_take(case):
    h, B, N, d = 2, 3, 9, 16
    q, k, v, bias = (torch.from_numpy(a) for a in hm_qkvb(12, h, B, N, d))
    if case == "bias_shape":
        bias = bias[:1]
    elif case == "rank":
        q, k, v = q[0], k[0], v[0]
    elif case == "non_contiguous":
        q = torch.randn(h, B, d, N).transpose(-1, -2)
    elif case == "empty_batch":
        q = k = v = torch.zeros(h, 0, N, d)
    elif case == "misaligned":  # contiguous, but one element past a 16-byte boundary
        q = torch.zeros(h * B * N * d + 1)[1:].view(h, B, N, d)
    elif case == "mixed_types":
        v = v.bfloat16()
    elif case == "bias_elsewhere":
        bias = bias.to("meta")
    with pytest.raises(ValueError):
        beit_attention(q, k, v, bias)


# (B, N, h, d) past the limits the wrappers once had (ROADMAP C1): N = 257
# and head widths 8 and 128, which the JAX package's einsum path and Pallas
# kernel take. The CPU twins take every N >= 1 and every d; on the card the
# CUDA kernels take N = 257 and d = 128, and d = 8 raises there.
PAST_OLD_LIMITS = {"too_many_tokens": (2, 257, 2, 16), "head_dim_8": (2, 9, 4, 8),
                   "head_dim_128": (3, 9, 2, 128)}


@pytest.mark.parametrize("case", sorted(PAST_OLD_LIMITS))
@pytest.mark.parametrize("layout", ["b1", "b3"])
def test_op_takes_shapes_past_the_old_limits(layout, case):
    """The public ops on CPU tensors (their twins) at shapes the wrappers
    once refused, against the JAX einsum reference and the TPU kernel in
    interpret mode: f32 atol/rtol 1e-5 (summation order only); no kernel
    launch counted."""
    B, N, h, d = PAST_OLD_LIMITS[case]
    q, k, v, bias = qkvb(13, B, N, h, d)
    if layout == "b1":
        jq = [jnp.asarray(a) for a in (q, k, v, bias)]
        kernel = beit_attention_packed_pallas(*jq, h, block_b=2, interpret=True)
        ref = jax_reference(*jq, h)
        op, got = beit_attention_packed, lambda: port(q, k, v, bias, h, fn=beit_attention_packed)
        shape = (B, N, h * d)
    else:
        q, k, v = (a.reshape(B, N, h, d).transpose(2, 0, 1, 3).copy() for a in (q, k, v))
        jq = [jnp.asarray(a) for a in (q, k, v, bias)]
        with pltpu.force_tpu_interpret_mode():
            kernel = JA.beit_attention_pallas(*jq, block_b=2)
        ref = JA.beit_attention_reference(*jq)
        op, got = beit_attention, lambda: hm_port(q, k, v, bias, fn=beit_attention)
        shape = (h, B, N, d)
    before = op.launches
    out = got()
    assert out.shape == shape and op.launches == before
    np.testing.assert_allclose(out, np.asarray(kernel), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)
