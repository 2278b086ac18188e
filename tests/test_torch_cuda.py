"""Tests that need an NVIDIA GPU: the port's CUDA kernels against their
plain PyTorch twins on the card, and each slice on the card against the CPU. They skip without one (the kernels have no
CPU or interpret mode). This file imports neither jax nor tpu3dlm, so it
runs on a GPU host without them:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tpu3dlm_torch.ops.kernels.attention import (
    beit_attention,
    beit_attention_packed,
    beit_attention_packed_reference,
    beit_attention_reference,
    kernel_route,
)
from tpu3dlm_torch.ops.kernels.nn_variants import (
    VARIANTS,
    nn_variant,
    nn_variant_reference,
    pack_targets,
    pack_targets_reference,
)
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
        (torch.float32, (2, 257, 2, 32), 1e-5),  # N past the bf16 TMA kernel's 256
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


def test_ingestion_matches_expected_digests(tmp_path):
    """``load_scan`` (after ``ImageExtractor.fetch_data``) on the committed
    capture: every array's sha256 equals the JAX package's, recorded in
    tests/fixtures/torch_project/expected.json. It needs no card; it is here
    so that the GPU host, which has no cv2, runs it."""
    import chip_smoke

    checked, extracted, _ = chip_smoke.check_ingestion(str(tmp_path))
    assert checked == 24 and extracted == {"gold_std": 5, "maintenance": 5}


def test_pipeline_on_card_matches_cpu(cuda_device, tmp_path):
    """The two-scan Pipeline on the committed capture on the card (kernels
    B1 and B2) and on the CPU (twins): chip_smoke.py's pipeline_parity."""
    import chip_smoke

    chip_smoke.phase_pipeline_parity(cuda_device, str(tmp_path))


@pytest.mark.parametrize(
    "dtype,shape,tol",
    [
        (torch.float32, (3, 5, 33, 16), 1e-5),  # (h, B, N, d); summation order only
        (torch.float32, (12, 3, 197, 64), 1e-5),
        (torch.float32, (2, 2, 257, 32), 1e-5),  # N past the bf16 TMA kernel's 256
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


def _hold_b4(a, b, idx, d2):
    """The bf16 gate of test_b4_variant_passes_the_bf16_gate on (idx, d2)."""
    ri, rd2 = nn_variant_reference(a, b, "bf16")
    assert (idx == ri).float().mean() >= 0.999
    assert (d2 - rd2).abs().max() <= 1e-4
    differ = idx != ri
    if differ.any():
        assert (d2[differ] - rd2[differ]).abs().max() <= 1e-5
    a64, b64 = a.double().cpu(), b.double().cpu()
    true = ((a64[:, None] - b64[None]) ** 2).sum(-1).min(1).values
    picked = ((a64 - b64[idx.cpu()]) ** 2).sum(1)
    band = 2.0 ** -7 * a64.norm(dim=1) * b64.norm(dim=1).max() + 1e-6
    assert (picked - true <= band).all()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("n,m", [(1, 1), (1, 300), (65, 100), (300, 511), (257, 513), (1000, 3001)])
def test_b4_ragged_shapes(cuda_device, variant, n, m):
    """Ragged edges on the card: one query, one target, fewer targets than a
    ring stage (512) or a TMA box (256), m one past a stage, n not a
    multiple of 64: the padded target rows never win and the padded query
    rows are never written."""
    g = torch.Generator().manual_seed(n * 7919 + m)
    a = (torch.rand(n, 3, generator=g) * 5 - 2).to(cuda_device)
    b = (torch.rand(m, 3, generator=g) * 5 - 2).to(cuda_device)
    idx, d2 = nn_variant(a, b, variant)
    torch.cuda.synchronize()
    assert idx.shape == (n,) and d2.shape == (n,) and bool(torch.isfinite(d2).all())
    assert bool((idx >= 0).all() and (idx < m).all())
    _hold_b4(a, b, idx, d2)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("period", [256, 512, 700])
def test_b4_ties_across_boxes_and_splits(cuda_device, variant, period):
    """Every target three times, `period` apart: copies on the other side of
    a TMA box (256 rows), a ring stage (512) and, for v3, a target split
    (whole stages) have the same dp bit for bit, and every variant keeps
    the first copy; all variants agree with v1 bit for bit."""
    g = torch.Generator().manual_seed(period)
    a = (torch.rand(777, 3, generator=g) * 5 - 2).to(cuda_device)
    base = torch.rand(period, 3, generator=g) * 5 - 2
    b = torch.cat([base, base, base]).to(cuda_device)
    idx, d2 = nn_variant(a, b, variant)
    torch.cuda.synchronize()
    assert bool((idx < period).all())
    _hold_b4(a, b, idx, d2)
    i1, d1 = nn_variant(a, b, "v1")
    assert torch.equal(idx, i1) and torch.equal(d2, d1)


@pytest.mark.parametrize("m", [1, 513, 3001])
def test_b4_pack_kernel_matches_twin(cuda_device, m):
    """nn_pack_kernel, by the pack_targets that nn_variant sweeps, writes
    the twin's bits: bf16 coordinates, the three limbs of the twin's b2,
    zeros, and the +inf rows past m."""
    g = torch.Generator().manual_seed(m)
    b = ((torch.rand(m, 3, generator=g) * 6 - 3) * 10.0 ** (torch.rand(m, 1, generator=g) * 6 - 3)).to(cuda_device)
    got = pack_targets(b)
    torch.cuda.synchronize()
    want = pack_targets_reference(b)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_finetune_step_on_card_matches_cpu(cuda_device):
    """Three finetune steps of a small BEiT on the card and on the CPU:
    losses within 1e-5 and the first step's gradients within 1e-5:
    chip_smoke.py's finetune_parity phase."""
    import chip_smoke

    chip_smoke.phase_finetune_parity(cuda_device)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("N", [1, 8, 63, 64, 65, 197, 256])
@pytest.mark.parametrize("B", [1, 3])
def test_b1_b3_bf16_tma_shapes(cuda_device, B, N, d):
    """The bf16 kernel in both layouts against the twins, and B3 against B1
    through the layouts, at token counts around the 8-, 16-, 64- and
    128-row edges (1e-2: one bf16 ulp of p and of the output). With B = 3
    the middle batch row's keys are large: a K box that read past N of row
    0 would take them in as keys and dominate its softmax."""
    h = 2
    g = torch.Generator().manual_seed(1000 * B + 10 * N + d)
    q, k, v = (torch.randn(B, N, h * d, generator=g) for _ in range(3))
    if B == 3:
        k[1] += 6.0
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    bias = torch.randn(h, N, N, generator=g).to(cuda_device)
    got = beit_attention_packed(q, k, v, bias, h)
    torch.cuda.synchronize()
    want = beit_attention_packed_reference(q, k, v, bias, h)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    split = lambda t: t.view(B, N, h, d).permute(2, 0, 1, 3).contiguous()  # noqa: E731
    hm = beit_attention(split(q), split(k), split(v), bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(hm.float(), beit_attention_reference(split(q), split(k), split(v), bias).float(),
                               atol=1e-2, rtol=1e-2)
    assert torch.equal(hm, split(got))  # one kernel body: the layouts change nothing


@settings(max_examples=24, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(B=st.integers(1, 300), heads=st.integers(1, 16), N=st.integers(1, 256),
       d=st.sampled_from([16, 32, 64]), layout=st.sampled_from(["packed", "headmajor"]))
def test_b1_b3_bf16_schedule_covers_every_row(cuda_device, B, heads, N, d, layout):
    """Random shapes, most of them with more (head, batch row) items than
    the clusters that fit on the card, so a cluster walks a run of items
    across head changes. Every output row matches the twin (1e-2). The
    block the kernel's output is likely to reuse is filled with NaN first,
    so a row that no CTA writes fails."""
    g = torch.Generator().manual_seed(B * 100003 + heads * 1009 + N * 7 + d)
    shape = (B, N, heads * d) if layout == "packed" else (heads, B, N, d)
    q, k, v = (torch.randn(*shape, generator=g).to(cuda_device, torch.bfloat16) for _ in range(3))
    bias = torch.randn(heads, N, N, generator=g).to(cuda_device)
    torch.full_like(q, float("nan"))  # freed at once: a NaN-filled block in the allocator's cache
    if layout == "packed":
        got = beit_attention_packed(q, k, v, bias, heads)
        want = beit_attention_packed_reference(q, k, v, bias, heads)
    else:
        got = beit_attention(q, k, v, bias)
        want = beit_attention_reference(q, k, v, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


def test_b2_ties_across_chunk_tile_and_split_edges(cuda_device):
    """Exact copies of targets placed just across a 32-target chunk edge, a
    1024-target tile edge and a split edge of the kernel's plan: every query
    (a copy of the first target of a pair) picks the lower index, as the
    twin does."""
    from tpu3dlm_torch.ops.kernels.pairwise import device_split_plan

    n, m = 2048, 1 << 20
    g = torch.Generator().manual_seed(7)
    b = torch.rand(m, 3, generator=g) * 5 - 2
    splits, per_split = device_split_plan(cuda_device, n, m, 1024, 1024)
    assert splits > 1 and per_split > 1024, (splits, per_split)
    pairs = [(31, 32), (1023, 1024), (per_split - 1, per_split), (per_split - 40, per_split + 3),
             (2 * per_split - 1, 2 * per_split)]
    for lo, hi in pairs:
        b[hi] = b[lo]
    a = torch.rand(n, 3, generator=g) * 5 - 2
    a[: len(pairs)] = b[[lo for lo, _ in pairs]]
    a, b = a.to(cuda_device), b.to(cuda_device)
    idx, d2 = nearest_neighbors(a, b)
    torch.cuda.synchronize()
    assert idx[: len(pairs)].tolist() == [lo for lo, _ in pairs]
    ri, rd2 = nearest_neighbors_reference(a, b)
    assert torch.equal(idx[: len(pairs)], ri[: len(pairs)])
    assert (idx == ri).float().mean() >= 0.999
    assert (d2 - rd2).abs().max() <= 1e-4


def test_b2_sentinel_padded_targets_never_win(cuda_device):
    """Targets padded to the compare's power-of-two bucket with sentinel
    rows: no pick lands in the padding, and picks and d² equal those on the
    unpadded targets."""
    from tpu3dlm_torch.ops.icp import pad_target_bucket

    g = torch.Generator().manual_seed(8)
    b_np = (torch.rand(70001, 3, generator=g) * 5 - 2).numpy()
    padded, _ = pad_target_bucket(b_np)
    a = (torch.rand(3000, 3, generator=g) * 5 - 2).to(cuda_device)
    idx, d2 = nearest_neighbors(a, torch.as_tensor(padded, device=cuda_device))
    ui, ud2 = nearest_neighbors(a, torch.as_tensor(b_np, device=cuda_device))
    torch.cuda.synchronize()
    assert padded.shape[0] == 1 << 17 and (idx < 70001).all()
    assert torch.equal(idx, ui) and torch.equal(d2, ud2)


def _simt_case(cuda_device, dtype, B, N, d, h=2, seed=0):
    """Kernel attention_simt in both layouts against the twins, and B3
    against B1 through the layouts (one kernel body: bit-equal). The output
    block is NaN-poisoned first (a block of the output's size is filled
    with NaN and freed, so the allocator hands it to the kernel's output):
    a row that no CTA writes fails. Each launch is counted on the CUDA-core
    route."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, N, h * d, generator=g) for _ in range(3))
    if B == 3:
        k[1] += 6.0  # large keys in the middle batch row: a read past N would dominate row 0
    q, k, v = (t.to(cuda_device, dtype) for t in (q, k, v))
    bias = torch.randn(h, N, N, generator=g).to(cuda_device)
    assert kernel_route(dtype, N, d) == "attention_simt"
    split = lambda t: t.view(B, N, h, d).permute(2, 0, 1, 3).contiguous()  # noqa: E731
    qs, ks, vs = split(q), split(k), split(v)
    before = (beit_attention_packed.launches_by_kernel["attention_simt"],
              beit_attention.launches_by_kernel["attention_simt"])
    torch.full_like(q, float("nan"))
    got = beit_attention_packed(q, k, v, bias, h)
    torch.full_like(qs, float("nan"))
    hm = beit_attention(qs, ks, vs, bias)
    torch.cuda.synchronize()
    assert (beit_attention_packed.launches_by_kernel["attention_simt"],
            beit_attention.launches_by_kernel["attention_simt"]) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got.float(), beit_attention_packed_reference(q, k, v, bias, h).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(hm.float(), beit_attention_reference(qs, ks, vs, bias).float(),
                               atol=tol, rtol=tol)
    assert torch.equal(hm, split(got))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("N", [1, 31, 33, 64, 65, 197, 257, 577])
@pytest.mark.parametrize("B", [1, 3])
def test_b1_b3_simt_f32_shapes(cuda_device, B, N, d):
    """f32 on the CUDA-core kernel at token counts around its 32-key block
    and 64-row tile edges and past 256, every head width it is built for
    (1e-5: summation order only)."""
    _simt_case(cuda_device, torch.float32, B, N, d, seed=1000 * B + 10 * N + d)


@pytest.mark.parametrize("N,d", [(N, d) for N in (257, 577) for d in (16, 32, 64, 128)]
                         + [(1, 128), (33, 128), (197, 128)])
@pytest.mark.parametrize("B", [1, 3])
def test_b1_b3_simt_bf16_routed_shapes(cuda_device, B, N, d):
    """bf16 shapes the TMA kernel does not take (N > 256, or d = 128) run
    the CUDA-core kernel (1e-2: one bf16 ulp of p and of the output)."""
    _simt_case(cuda_device, torch.bfloat16, B, N, d, seed=1000 * B + 10 * N + d + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [48, 80, 96, 112])
def test_b1_b3_simt_other_head_widths(cuda_device, dtype, d):
    """The multiples of 16 between the usual head widths, whose O columns
    are read in pairs."""
    _simt_case(cuda_device, dtype, 3, 65, d, seed=d)


def test_simt_batch_past_a_grid_dimension(cuda_device):
    """70,000 batch rows: more than a grid's y or z dimension could hold."""
    g = torch.Generator().manual_seed(3)
    B, N, h, d = 70_000, 2, 1, 16
    q, k, v = (torch.randn(B, N, h * d, generator=g).to(cuda_device) for _ in range(3))
    bias = torch.randn(h, N, N, generator=g).to(cuda_device)
    torch.full_like(q, float("nan"))
    got = beit_attention_packed(q, k, v, bias, h)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, beit_attention_packed_reference(q, k, v, bias, h), atol=1e-5, rtol=1e-5)


def test_route_by_shape(cuda_device):
    """bf16 with N <= 256 and d in {16, 32, 64} runs the TMA kernel; every
    f32 shape and the other bf16 shapes the CUDA-core kernel."""
    assert kernel_route(torch.bfloat16, 197, 64) == "attention_bf16_tma"
    assert kernel_route(torch.bfloat16, 256, 16) == "attention_bf16_tma"
    assert kernel_route(torch.bfloat16, 257, 64) == "attention_simt"
    assert kernel_route(torch.bfloat16, 197, 128) == "attention_simt"
    assert kernel_route(torch.bfloat16, 197, 48) == "attention_simt"
    assert kernel_route(torch.float32, 197, 64) == "attention_simt"
    with pytest.raises(ValueError):
        kernel_route(torch.float32, 197, 8)


@pytest.mark.parametrize("d", [8, 24, 144])
def test_cuda_refuses_head_widths_no_kernel_takes(cuda_device, d):
    """On the card a head width that is not a multiple of 16 up to 128
    raises before any launch, in both layouts (the CPU twins take it)."""
    B, N, h = 2, 9, 2
    q = torch.zeros(B, N, h * d, device=cuda_device)
    bias = torch.zeros(h, N, N, device=cuda_device)
    before = (beit_attention_packed.launches, beit_attention.launches)
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        beit_attention_packed(q, q, q, bias, h)
    hm = torch.zeros(h, B, N, d, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        beit_attention(hm, hm, hm, bias)
    assert (beit_attention_packed.launches, beit_attention.launches) == before


# ---------------------------------------------------------------------------
# The staged route and the anchor-bucketed NN index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,real,c", [(1 << 20, 1_000_000, 8192), (1 << 18, 1 << 18, 2048)])
def test_b2_at_the_index_build_shapes(cuda_device, m, real, c):
    """The anchor-index build's sweep: every target row a query against the
    sampled anchors (1,048,576 × 8192 over a sentinel-padded target,
    262,144 × 2048). Real queries: d² within 1e-4 m² of the twin's, and
    where the picks differ the two d² within 1e-5 m² (f32 near-ties);
    sentinel queries pick a sentinel anchor, as the twin does."""
    from tpu3dlm_torch.ops.ann import sample_anchor_ids
    from tpu3dlm_torch.ops.icp import pad_target_bucket

    g = torch.Generator().manual_seed(m)
    pts = torch.rand(real, 3, generator=g) * torch.tensor([4.0, 2.5, 1.5]) - torch.tensor([1.5, 1.25, 0.0])
    tgt = torch.from_numpy(pad_target_bucket(pts.numpy())[0])
    assert tgt.shape[0] == m
    anchors = tgt[sample_anchor_ids(m, c, 0)]
    a, b = tgt.to(cuda_device), anchors.to(cuda_device)
    before = nearest_neighbors.launches_by_shape[m, c]
    idx, d2 = nearest_neighbors(a, b)
    torch.cuda.synchronize()
    assert nearest_neighbors.launches_by_shape[m, c] == before + 1
    ri, rd2 = nearest_neighbors_reference(a, b)
    far = torch.arange(m, device=cuda_device) >= real
    if bool(far.any()):
        assert bool((b[idx[far]] == a[far]).all()) and torch.equal(idx[far], ri[far])
    near = ~far
    assert (d2[near] - rd2[near]).abs().max() <= 1e-4
    diff = (idx != ri) & near
    assert (idx[near] == ri[near]).float().mean() >= 0.99
    if diff.any():
        assert (d2[diff] - rd2[diff]).abs().max() <= 1e-5


def test_anchor_index_on_card_matches_cpu(cuda_device):
    """``build_anchor_index`` on the card (kernel B2's sweep) against the
    CPU (the twin's) from the same anchors, on a 65,536-row target with
    sentinel padding: anchors identical, a row on another anchor only at an
    f32 near-tie, every other bucket identical (``chip_smoke.hold_index``);
    then ``nn_anchored`` card against CPU and against exact B2
    (``chip_smoke.hold_anchored``)."""
    import chip_smoke
    from tpu3dlm_torch.ops.ann import build_anchor_index, default_index_shape, nn_anchored
    from tpu3dlm_torch.ops.icp import pad_target_bucket

    base = chip_smoke.two_scan_scene(60_000, 9)[0]
    tgt = torch.from_numpy(pad_target_bucket(base)[0])
    c, b = default_index_shape(tgt.shape[0])
    got = build_anchor_index(tgt.to(cuda_device), c, b)
    want = build_anchor_index(tgt, c, b)
    torch.cuda.synchronize()
    chip_smoke.hold_index(got, want, tgt)
    q = torch.from_numpy(base[::7][:4099] + 0.003)
    pi, pd = nn_anchored(q.to(cuda_device), got)
    ci, cd = nn_anchored(q, want)
    ei, ed = nearest_neighbors(q.to(cuda_device), tgt.to(cuda_device))
    torch.cuda.synchronize()
    chip_smoke.hold_anchored(pi, pd, ci, cd, ei, ed)


def test_damage_detector_on_card_matches_cpu(cuda_device):
    """The staged classifier in f32 on the card (kernel B1 in each layer)
    and on the CPU (twin), same seeded BEiT, on 70 valid boxes of a
    synthetic scan (two batches of 64): damage equal."""
    import numpy as np

    import chip_smoke
    from tpu3dlm_torch.data.scan import Detections
    from tpu3dlm_torch.models.beit import BeitConfig
    from tpu3dlm_torch.pipeline.classifier import DamageDetector

    cfg = BeitConfig(image_size=64, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                     num_labels=3)
    scan = chip_smoke.synthetic_scan(12, 128, (48, 64), 3)
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 500, (12, 8, 2))
    wh = rng.uniform(20, 140, (12, 8, 2))
    mask = np.zeros(96, bool)
    mask[rng.choice(96, 70, replace=False)] = True
    det = Detections(boxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
                     conf=np.full((12, 8), 0.9, np.float32), label=np.zeros((12, 8), np.int32),
                     damage=np.full((12, 8), -1, np.int32), mask=mask.reshape(12, 8))
    cpu = DamageDetector(config=cfg, rng_seed=5, dtype=torch.float32, device="cpu")
    gpu = DamageDetector(config=cfg, rng_seed=5, dtype=torch.float32, device=cuda_device)
    gpu.beit.load_state_dict(cpu.beit.state_dict())  # same weights on both
    before = beit_attention_packed.launches
    got = gpu.classify_detections(scan, det)
    torch.cuda.synchronize()
    assert beit_attention_packed.launches - before == 2 * cfg.num_layers
    want = cpu.classify_detections(scan, det)
    np.testing.assert_array_equal(got.damage, want.damage)
    assert (got.damage[det.mask] >= 0).all() and (got.damage[~det.mask] == -1).all()


def test_staged_pipeline_on_card_matches_cpu(cuda_device, tmp_path):
    """The two-scan Pipeline on the staged route (the default
    ``fused_inference = false``) on the card and on the CPU:
    chip_smoke.py's staged_parity."""
    import chip_smoke

    chip_smoke.phase_pipeline_parity(cuda_device, str(tmp_path), fused=False)


def test_streamed_pipeline_on_card_matches_cpu(cuda_device, tmp_path):
    """The two-scan Pipeline streamed in chunks of 2 frames on the card and
    on the CPU, and against the card's whole-scan run: chip_smoke.py's
    stream_parity."""
    import chip_smoke

    chip_smoke.phase_pipeline_parity(cuda_device, str(tmp_path), stream=2)


def test_launch_counters_lose_no_update_under_threads(cuda_device):
    """The serving watcher's workers launch B1 and B2 from several threads:
    with a tiny switch interval, 8 threads × 50 launches each must count
    exactly 400 per wrapper."""
    import sys
    import threading

    g = torch.Generator().manual_seed(0)
    a, b = (torch.rand(n, 3, generator=g).to(cuda_device) for n in (64, 256))
    q, k, v = (torch.randn(2, 9, 64, generator=g).to(cuda_device, torch.bfloat16) for _ in range(3))
    bias = torch.randn(4, 9, 9, generator=g).to(cuda_device)
    before = (nearest_neighbors.launches, beit_attention_packed.launches,
              sum(beit_attention_packed.launches_by_kernel.values()))

    def work():
        for _ in range(50):
            nearest_neighbors(a, b)
            beit_attention_packed(q, k, v, bias, 4)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert nearest_neighbors.launches - before[0] == 400
    assert beit_attention_packed.launches - before[1] == 400
    assert sum(beit_attention_packed.launches_by_kernel.values()) - before[2] == 400


def _capture_scan(folder):
    import chip_smoke
    from tpu3dlm_torch.data.dataset import load_scan

    ext = chip_smoke.PROJECT / "data" / folder / "rtabmap_extract"
    return load_scan(str(ext / "data_rgb"), str(ext / "data_depth"), str(ext / "calibration"),
                     str(chip_smoke.PROJECT / "data" / folder / "poses.txt"), img_size=128)


@pytest.mark.parametrize("voxel", [0.08, 0.04, 0.02])
def test_tsdf_on_card_matches_cpu(cuda_device, voxel):
    """The TSDF field of the committed capture fused on the card against the
    CPU, under mesh_parity's bars (``chip_smoke.hold_tsdf``), and its mesh
    identical."""
    import numpy as np

    import chip_smoke
    from tpu3dlm_torch.mapper.meshing import marching_tetrahedra, tsdf_from_scan

    for folder in chip_smoke.FOLDERS:
        scan = _capture_scan(folder)
        got, want = tsdf_from_scan(scan, voxel, device=cuda_device), tsdf_from_scan(scan, voxel, device="cpu")
        held = chip_smoke.hold_tsdf(got, want)
        if held["identical"]:
            for a, b in zip(marching_tetrahedra(*got[:1], 0.0, *got[1:]),
                            marching_tetrahedra(*want[:1], 0.0, *want[1:])):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("voxel", [0.08, 0.04])
def test_poisson_solve_on_card_matches_cpu(cuda_device, voxel):
    """χ and the iso of a noisy sphere (normals given) and of the capture's
    gold cloud (normals estimated) solved on the card against the CPU, under
    mesh_parity's bars (``chip_smoke.hold_chi``), and the meshes within
    ``hold_mesh``'s (the general bars on the sphere)."""
    import numpy as np

    import chip_smoke
    from tpu3dlm_torch.data.ply import load_ply
    from tpu3dlm_torch.mapper.poisson import mesh_poisson, poisson_indicator

    rng = np.random.RandomState(0)
    d = rng.randn(8000, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sphere = ((d + rng.randn(8000, 3) * 0.005).astype(np.float32), (-d).astype(np.float32))
    cloud, _ = load_ply(str(chip_smoke.PROJECT / "data" / "gold_std" / "cloud.ply"))
    for pts, normals in (sphere, (cloud, None)):
        chip_smoke.hold_chi(poisson_indicator(pts, normals, voxel=voxel, device=cuda_device),
                            poisson_indicator(pts, normals, voxel=voxel, device="cpu"))
    chip_smoke.hold_mesh(mesh_poisson(*sphere, voxel=voxel, device=cuda_device),
                         mesh_poisson(*sphere, voxel=voxel, device="cpu"), voxel)


def test_map_stage_on_card_matches_cpu(cuda_device, tmp_path):
    """``visualise = true`` through the gold Pipeline for each mesh setting,
    card against CPU: chip_smoke.py's mesh_parity phase."""
    import chip_smoke

    chip_smoke.phase_mesh_parity(cuda_device, str(tmp_path))


@pytest.mark.parametrize("m", [1, 16, 17, 300])
@pytest.mark.parametrize("layout", ["row-major", "column-major"])
def test_int8_gemm_on_card_identical_to_twin(cuda_device, m, layout):
    """``torch._int_mm`` (cuBLASLt) through ``ops/quant.py::int8_product``:
    int32 results identical to the CPU twin, rows ≤ 16 padded to 17 and
    sliced; ``Int8Dense`` passes its kernel column-major."""
    from tpu3dlm_torch.ops import quant

    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, 768), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (768, 200), generator=g, dtype=torch.int8)
    bd = b.to(cuda_device)
    if layout == "column-major":
        bd = bd.t().contiguous().t()
    before = quant.launches
    got = quant.int8_product(a.to(cuda_device), bd)
    assert quant.launches == before + 1 and got.dtype == torch.int32 and got.shape == (m, 200)
    assert torch.equal(got.cpu(), quant.int8_product(a, b))
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_product(a[:, :12].to(cuda_device), b[:12].to(cuda_device))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_int8_beit_on_card_matches_cpu(cuda_device, dtype, tol):
    """The int8 BEiT (32 px, hidden 64, 2 layers, 4 heads) on the card
    against the same weights on the CPU: logits within ``tol`` × max(1,
    max|logit|) (f32: the int8 products are exact and the float parts
    differ by summation order, except on a crop where that drift moves an
    activation's int8 code across a rounding tie: at most 10% of the crops,
    each within 5e-3; bf16: the bars of the bf16 path, every crop), the
    same top-1 on decisive crops; B1 once per layer and 6 int8 GEMMs per
    layer."""
    from tpu3dlm_torch.models.beit import BeitConfig, preprocess_crops, seeded_beit
    from tpu3dlm_torch.ops import quant

    cfg = BeitConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=128, num_labels=3, quant="int8")
    model = seeded_beit(cfg, torch.Generator().manual_seed(3))
    crops = torch.randint(0, 256, (40, 32, 32, 3), generator=torch.Generator().manual_seed(4), dtype=torch.uint8)
    with torch.no_grad():
        want = model.to(dtype)(preprocess_crops(crops)).float()
        card = model.to(cuda_device)
        b1, gemms = beit_attention_packed.launches, quant.launches
        got = card(preprocess_crops(crops.to(cuda_device))).float().cpu()
    assert beit_attention_packed.launches == b1 + 2 and quant.launches == gemms + 12
    top = torch.sort(want, -1).values
    decisive = (top[:, -1] - top[:, -2]) > 0.1 * want.abs().max()
    assert decisive.any()
    assert torch.equal(got.argmax(-1)[decisive], want.argmax(-1)[decisive])
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().amax(-1) / scale
    if dtype == torch.float32:
        assert (err > tol).float().mean().item() <= 0.1 and err.max().item() <= 5e-3, err
    else:
        assert err.max().item() <= tol, err


def _random_gboxes(frames: int, seed: int = 0):
    import numpy as np

    from tpu3dlm_torch.mapper.projection import GlobalBoxes

    rng = np.random.default_rng(seed)
    return GlobalBoxes(corners=rng.normal(0, 1, (frames, 6, 4, 3)).astype(np.float32),
                       damage=np.zeros((frames, 6), np.int32), conf=np.full((frames, 6), 0.9, np.float32),
                       label=np.ones((frames, 6), np.int32), mask=rng.random((frames, 6)) < 0.6)


@pytest.mark.parametrize("folder", ["gold_std", "maintenance"])
def test_view_geometry_on_card_matches_cpu(cuda_device, folder):
    """``frame_view_geometry`` of every frame and ``scan_to_pointcloud`` of
    the committed capture's scan on the card against the CPU
    (``chip_smoke.hold_view_geometry``: points and boxes within 1e-5 m,
    masks and frustum lines identical, frustum points within 1e-6 m)."""
    import chip_smoke

    scan = chip_smoke.capture_scan(folder)
    held = chip_smoke.hold_view_geometry(cuda_device, scan, _random_gboxes(scan.num_frames))
    assert held["boxes"] > 0 and held["scan_points"] > 0


def test_scan_to_pointcloud_keeps_the_card(cuda_device):
    """Tensors already on the card stay there; the result is on the card."""
    import chip_smoke
    from tpu3dlm_torch.ops.pointcloud import scan_to_pointcloud

    scan = chip_smoke.capture_scan("gold_std")
    args = [torch.as_tensor(a, device=cuda_device) for a in (scan.depth, scan.intrinsics, scan.rgb_size, scan.poses)]
    pts, ok = scan_to_pointcloud(*args, device=cuda_device)
    assert pts.device.type == ok.device.type == "cuda" and pts.shape[:2] == ok.shape


def test_views_of_a_run_on_card_match_cpu(cuda_device, tmp_path):
    """``view_img``, ``alignment_vis`` and ``comparison_vis`` through the
    staged Pipeline, card against CPU: chip_smoke.py's vis_parity phase."""
    import chip_smoke

    chip_smoke.phase_vis_parity(cuda_device, str(tmp_path))


def test_augmented_yolo_step_on_card_matches_cpu(cuda_device):
    """One YOLOv10-n step at 128 px on 4 frames of the committed capture,
    the hard recipe's augmentation (erase on) on the same noise drawn on
    the CPU, from the same Flax-like init: the loss within 1e-4 relative,
    the augmented batch within 1e-5, both heads' foreground identical, the
    BatchNorm statistics within 1e-4 × max(1, |value|) (batch variances
    of maps of a few values round apart by ~1e-5 between the devices;
    chip_smoke.py's train_parity holds three steps and the gradients)."""
    import copy

    import numpy as np

    import chip_smoke
    from tpu3dlm_torch.models.layers import init_like_flax_
    from tpu3dlm_torch.models.yolov10 import YOLOv10
    from tpu3dlm_torch.parallel.finetune import adamw, draw_yolo_step_noise, make_yolo_train_step
    from tpu3dlm_torch.scripts.hard_eval import HARD_AUGMENT

    (images, boxes, labels, mask), _, _ = chip_smoke.fixture_training_arrays(128, 4)
    imgs = images.astype(np.float32) / 255.0
    gen = torch.Generator().manual_seed(3)
    cpu = init_like_flax_(YOLOv10(nc=2), gen)
    gpu = copy.deepcopy(cpu).to(cuda_device)
    noise = draw_yolo_step_noise(len(imgs), gen, HARD_AUGMENT)
    out = {}
    for name, model, dev in (("cpu", cpu, torch.device("cpu")), ("gpu", gpu, cuda_device)):
        step = make_yolo_train_step(model, adamw(model.parameters(), 2e-3), img_size=128, augment=HARD_AUGMENT,
                                    device=dev)
        aux = {}
        loss = step(*(torch.as_tensor(a, device=dev) for a in (imgs, boxes, labels, mask)), noise=noise, aux=aux)
        out[name] = (float(loss), {k: v.cpu() for k, v in aux.items()}, {k: v.cpu() for k, v in model.state_dict().items()})
    (lc, ac, sc), (lg, ag, sg) = out["cpu"], out["gpu"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert (ag["images"] - ac["images"]).abs().max() <= 1e-5 and torch.equal(ag["mask"], ac["mask"])
    assert torch.equal(ag["fg_one2many"], ac["fg_one2many"]) and torch.equal(ag["fg_one2one"], ac["fg_one2one"])
    stats = [k for k in sc if k.endswith(("running_mean", "running_var"))]
    err = {k: float(((sg[k] - sc[k]).abs() / sc[k].abs().clamp(min=1.0)).max()) for k in stats}
    worst = max(err, key=err.get)
    assert err[worst] <= 1e-4, (worst, err[worst])


def test_augmented_beit_step_on_card_matches_cpu(cuda_device):
    """One toy-BEiT step with crop augmentation on the capture's
    ground-truth crops, same noise and init: the augmented uint8 crops
    identical, the loss within 1e-4 relative, B1 launched once per layer."""
    import copy

    from tpu3dlm_torch.models.beit import BeitClassifier, BeitConfig
    from tpu3dlm_torch.models.layers import init_like_flax_
    from tpu3dlm_torch.ops.augment import augment_crop_batch, draw_crop_noise
    from tpu3dlm_torch.parallel.finetune import init_finetune, make_beit_train_step
    from tpu3dlm_torch.pipeline.evaluate import BEIT_KW

    import chip_smoke

    _, crops, dmg = chip_smoke.fixture_training_arrays(128, 4)
    gen = torch.Generator().manual_seed(4)
    cfg = BeitConfig(**BEIT_KW)
    cpu = init_like_flax_(BeitClassifier(cfg), gen)
    gpu = copy.deepcopy(cpu)
    noise = draw_crop_noise(len(crops), gen)
    assert torch.equal(augment_crop_batch(torch.as_tensor(crops, device=cuda_device), noise=noise).cpu(),
                       augment_crop_batch(torch.as_tensor(crops), noise=noise))
    losses = {}
    for name, model, dev in (("cpu", cpu, torch.device("cpu")), ("gpu", gpu, cuda_device)):
        step = make_beit_train_step(model, init_finetune(model, lr=1e-3, device=dev), augment={}, device=dev)
        before = beit_attention_packed.launches
        losses[name] = float(step(torch.as_tensor(crops, device=dev), torch.as_tensor(dmg, device=dev), noise=noise))
        launched = beit_attention_packed.launches - before
    assert launched == cfg.num_layers
    assert abs(losses["gpu"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])


def _nn_on_one_rank(mesh, n: int, m: int) -> dict:
    """Rank body of ``test_target_sharded_nn_on_two_gloo_ranks``."""
    import numpy as np

    from tpu3dlm_torch.parallel.mesh import shard_batch
    from tpu3dlm_torch.parallel.nn import target_sharded_nn

    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.uniform(-2, 2, (n, 3)).astype(np.float32), device=mesh.device)
    b = torch.as_tensor(rng.uniform(-2, 2, (m, 3)).astype(np.float32), device=mesh.device)
    before = nearest_neighbors.launches
    idx, d2 = target_sharded_nn(mesh)(a, shard_batch(b, mesh))
    want_idx, want_d2 = nearest_neighbors(a, b)
    return dict(same=bool(torch.equal(idx, want_idx) and torch.equal(d2, want_d2)),
                launches=nearest_neighbors.launches - before)


def test_target_sharded_nn_on_a_one_rank_nccl_world(cuda_device):
    """``target_sharded_nn`` in a real 1-rank NCCL world on the card equals
    B2 on the whole target (indices and d²); the world is torn down."""
    from tpu3dlm_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, device=cuda_device, backend="nccl")
    try:
        got = _nn_on_one_rank(mesh, 4096, 1 << 18)
    finally:
        mesh.close()
    assert got == {"same": True, "launches": 2}
    assert not torch.distributed.is_initialized()


def test_target_sharded_nn_on_two_gloo_ranks(cuda_device):
    """Two spawned ranks sharing the card over gloo: each rank's
    target-sharded result equals B2 on the whole target, and each launched
    B2 (its shard, then the check)."""
    from tpu3dlm_torch.parallel.mesh import spawn_world

    ranks = spawn_world(_nn_on_one_rank, 2, device="cuda", backend="gloo", args=(3000, 40000))
    assert ranks == [{"same": True, "launches": 2}] * 2
