"""Tests that need an NVIDIA GPU: the port's CUDA kernels against their
plain PyTorch twins on the card. They skip without one (the kernels have no
CPU or interpret mode). This file imports neither jax nor tpu3dlm, so it
runs on a GPU host without them:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from tpu3dlm_torch.ops.kernels.attention import (
    beit_attention_packed,
    beit_attention_packed_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "dtype,shape,tol",
    [
        (torch.float32, (5, 33, 3, 16), 1e-5),  # summation order only
        (torch.float32, (3, 197, 12, 64), 1e-5),
        (torch.float32, (2, 256, 2, 32), 1e-5),  # N at the kernel's limit
        (torch.bfloat16, (8, 197, 12, 64), 1e-2),  # one bf16 ulp of p / output
        (torch.bfloat16, (5, 9, 2, 64), 1e-2),  # fewer keys than the head width
        (torch.bfloat16, (3, 33, 3, 16), 1e-2),
    ],
)
def test_b1_kernel_matches_twin(cuda_device, dtype, shape, tol):
    B, N, h, d = shape
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, N, h * d, generator=g).to(cuda_device, dtype) for _ in range(3))
    bias = torch.randn(h, N, N, generator=g).to(cuda_device)
    before = beit_attention_packed.launches
    got = beit_attention_packed(q, k, v, bias, h)
    torch.cuda.synchronize()
    assert beit_attention_packed.launches == before + 1
    want = beit_attention_packed_reference(q, k, v, bias, h)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_fused_runner_on_card_matches_cpu(cuda_device):
    """The whole slice in f32 on the card (kernel B1, cuDNN, TF32 off) and
    on the CPU (twin), same weights: chip_smoke.py's slice_parity phase
    (masks, labels and damage equal, boxes within 1e-2 px, corners within
    1e-4 m)."""
    import chip_smoke

    chip_smoke.phase_slice_parity(cuda_device)
