"""Kernel B1 (tpu3dlm_torch/ops/kernels/attention.py): its plain twin held
against the JAX package's reference and its Pallas kernel (interpret mode,
as the package's own CPU tests run it), the wrapper's dispatch and input
checks. The CUDA kernel itself is held against the twin on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm.ops.pallas.attention import beit_attention_packed_pallas
from tpu3dlm.ops.pallas.attention import beit_attention_packed_reference as jax_reference
from tpu3dlm_torch.ops.kernels.attention import (
    beit_attention_packed,
    beit_attention_packed_reference,
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
    ["float16", "head_dim_8", "bias_shape", "bias_bf16", "non_contiguous", "too_many_tokens"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    B, N, h, d = 2, 9, 2, 16
    q, k, v, bias = (torch.from_numpy(a) for a in qkvb(4, B, N, h, d))
    if case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "head_dim_8":
        h = 4
        bias = torch.zeros(h, N, N)
    elif case == "bias_shape":
        bias = bias[:, :, :-1]
    elif case == "bias_bf16":
        bias = bias.bfloat16()
    elif case == "non_contiguous":
        q = torch.randn(B, h * d, N).transpose(1, 2)
    elif case == "too_many_tokens":
        N = 257
        q = k = v = torch.zeros(B, N, h * d)
        bias = torch.zeros(h, N, N)
    with pytest.raises(ValueError):
        beit_attention_packed(q, k, v, bias, h)
