"""Tests that need an NVIDIA GPU: the port's CUDA kernels against their
plain PyTorch twins on the card, and each slice on the card against the CPU. They skip without one (the kernels have no
CPU or interpret mode). This file imports neither jax nor tpu3dlm, so it
runs on a GPU host without them:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from tpu3dlm_torch.ops.kernels.attention import (
    beit_attention,
    beit_attention_packed,
    beit_attention_packed_reference,
    beit_attention_reference,
)
from tpu3dlm_torch.ops.kernels.nn_variants import VARIANTS, nn_variant, nn_variant_reference
from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors, nearest_neighbors_reference

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


@pytest.mark.parametrize("n,m,dup", [
    (1000, 3001, False),  # odd sizes: a ragged query block and target tile
    (4096, 70000, False),
    (777, 3000, True),  # every target three times: ties go to the lowest index
    (1, 1, False),
])
def test_b2_kernel_matches_twin(cuda_device, n, m, dup):
    """≥ 99.9% identical indices, d² within 1e-4 m², and where the indices
    differ the two d² within 1e-5 m² (genuine near-ties)."""
    g = torch.Generator().manual_seed(n + m)
    a = (torch.rand(n, 3, generator=g) * 5 - 2).to(cuda_device)
    b = torch.rand(m // 3 if dup else m, 3, generator=g) * 5 - 2
    b = (torch.cat([b, b, b]) if dup else b).to(cuda_device)
    before = nearest_neighbors.launches
    idx, d2 = nearest_neighbors(a, b)
    torch.cuda.synchronize()
    assert nearest_neighbors.launches == before + 1
    assert idx.dtype == torch.int64 and d2.dtype == torch.float32
    ri, rd2 = nearest_neighbors_reference(a, b)
    assert (idx == ri).float().mean() >= 0.999
    assert (d2 - rd2).abs().max() <= 1e-4
    diff = idx != ri
    if diff.any():
        assert (d2[diff] - rd2[diff]).abs().max() <= 1e-5
    if dup:
        assert (idx < m // 3).all()


def test_compare_on_card_matches_cpu(cuda_device, tmp_path):
    """The two-scan compare on the card (kernel B2) and on the CPU (twin):
    chip_smoke.py's compare_parity phase."""
    import chip_smoke

    chip_smoke.phase_compare_parity(cuda_device, str(tmp_path))


@pytest.mark.parametrize(
    "dtype,shape,tol",
    [
        (torch.float32, (3, 5, 33, 16), 1e-5),  # (h, B, N, d); summation order only
        (torch.float32, (12, 3, 197, 64), 1e-5),
        (torch.float32, (2, 2, 256, 32), 1e-5),  # N at the kernel's limit
        (torch.bfloat16, (12, 8, 197, 64), 1e-2),  # one bf16 ulp of p / output
        (torch.bfloat16, (2, 5, 9, 64), 1e-2),
    ],
)
def test_b3_kernel_matches_twin(cuda_device, dtype, shape, tol):
    h, B, N, d = shape
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(*shape, generator=g).to(cuda_device, dtype) for _ in range(3))
    bias = torch.randn(h, N, N, generator=g).to(cuda_device)
    before = beit_attention.launches
    got = beit_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert beit_attention.launches == before + 1
    want = beit_attention_reference(q, k, v, bias)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_attention_gradients_on_card_match_twins(cuda_device):
    """The repaired fault: on the card B1's and B3's outputs carry
    gradients, equal to plain autograd through the twins within 1e-5 at
    f32, and a BEiT-base layer's q/k/v weights and relative-position table
    get them: chip_smoke.py's attention_grad phase."""
    import chip_smoke

    chip_smoke.phase_attention_grad(cuda_device)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_b4_variant_passes_the_bf16_gate(cuda_device, variant):
    """Each variant against the bf16 twin (d² within 1e-4, ≥ 99.9%
    identical picks on sparse points, differing picks within 1e-5) and
    against f64 (every pick inside the reference's bf16 band); ties to the
    lowest index."""
    g = torch.Generator().manual_seed(2)
    a = (torch.rand(1000, 3, generator=g) * 4 - 2).to(cuda_device)
    b = torch.rand(1500, 3, generator=g) * 4 - 2
    b = torch.cat([b, b]).to(cuda_device)
    kernel = VARIANTS[variant][0]
    before = dict(nn_variant.launches)
    idx, d2 = nn_variant(a, b, variant)
    torch.cuda.synchronize()
    assert nn_variant.launches == {**before, kernel: before[kernel] + 1}
    ri, rd2 = nn_variant_reference(a, b, "bf16")
    assert (idx == ri).float().mean() >= 0.999
    assert (d2 - rd2).abs().max() <= 1e-4
    assert (idx < 1500).all()
    a64, b64 = a.double().cpu(), b.double().cpu()
    true = ((a64[:, None] - b64[None]) ** 2).sum(-1).min(1).values
    picked = ((a64 - b64[idx.cpu()]) ** 2).sum(1)
    band = 2.0 ** -7 * a64.norm(dim=1) * b64.norm(dim=1).max() + 1e-6
    assert (picked - true <= band).all()


def test_finetune_step_on_card_matches_cpu(cuda_device):
    """Three finetune steps of a small BEiT on the card and on the CPU:
    losses within 1e-5 and the first step's gradients within 1e-5:
    chip_smoke.py's finetune_parity phase."""
    import chip_smoke

    chip_smoke.phase_finetune_parity(cuda_device)
