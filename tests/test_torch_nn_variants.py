"""Kernel B4 (tpu3dlm_torch/ops/kernels/nn_variants.py) on the CPU: its
plain twin against the JAX probe's ``nn_variant`` (scripts/
bench_nn_variants.py, loaded from its path; its Pallas kernels run in
interpret mode, as the JAX package's CPU tests run theirs), the bf16 twin
against the reference's f64 gate through the port's probe, the
wrapper's dispatch and input checks, the target packing (the pack
kernel's plain twin) and the launch plan. The CUDA kernels are held
against the twins on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu3dlm_torch.ops.kernels.nn_variants import (
    CONSUMERS,
    PACK_WIDTH,
    STAGE_TARGETS,
    VARIANTS,
    launch_plan,
    nn_variant,
    nn_variant_reference,
    pack_targets,
    pack_targets_reference,
)
from tpu3dlm_torch.ops.kernels.pairwise import WAVES, nearest_neighbors_reference, split_plan
from tpu3dlm_torch.scripts import bench_nn_variants as port_probe

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location("jax_bench_nn_variants", REPO / "scripts" / "bench_nn_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sparse_instance(seed, n, m):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, (n, 3)).astype(np.float32),
            rng.uniform(-2, 2, (m, 3)).astype(np.float32))


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("n,m", [(300, 2500), (77, 4100)])
def test_f32_twin_matches_jax_probe(jax_probe, variant, n, m):
    """The twin with ``cross="f32"`` is what the JAX probe computes on the
    CPU (a default-precision f32 dot is a full f32 dot there): on sparse
    uniform points (no near-ties at f32) the indices are identical and d²
    within 1e-5. The probe's kernels run in interpret mode; its padding
    (1024-row query tiles, 2048-column target tiles with 1e15 sentinels) is
    exercised by the odd sizes."""
    a, b = sparse_instance(n + m, n, m)
    with pltpu.force_tpu_interpret_mode():
        want_i, want_d = jax_probe.nn_variant(jnp.asarray(a), jnp.asarray(b), variant)
    got_i, got_d = nn_variant_reference(torch.from_numpy(a), torch.from_numpy(b), cross="f32")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5, rtol=0)


def test_bf16_twin_passes_the_reference_gate():
    """The port's probe verification on the CPU (each variant's wrapper runs
    the ``cross="bf16"`` twin): every pick's true f64 d² no better than the
    exact B2 twin's and within 2⁻⁷·|a|·max|b| + 1e-6 of it — and the bf16
    cross term does flip some near-ties, which the f32 twin does not."""
    a_s, b_s, _, _ = port_probe.probe_inputs(0)
    rows = port_probe.verify(a_s, b_s, "cpu")
    assert set(rows) == set(VARIANTS)
    for row in rows.values():
        assert 0 < row["flips"] < row["queries"] // 2
        assert 0 <= row["max_excess"] <= row["max_band"]
    f32_i = nn_variant_reference(torch.from_numpy(a_s), torch.from_numpy(b_s), "f32")[0]
    exact_i = nearest_neighbors_reference(torch.from_numpy(a_s), torch.from_numpy(b_s))[0]
    assert (f32_i == exact_i).float().mean() >= 0.999


def test_probe_inputs_follow_the_reference_draw_order():
    """The probe draws its four arrays from one generator in the
    reference's order (small a, small b, then the timing a and b)."""
    rng = np.random.default_rng(0)
    want = [rng.uniform(-2, 2, (512, 3)), rng.uniform(-2, 2, (4096, 3)),
            rng.uniform(-3, 3, (16384, 3)), rng.uniform(-3, 3, (1 << 20, 3))]
    for got, w in zip(port_probe.probe_inputs(0), want):
        np.testing.assert_array_equal(got, w.astype(np.float32))


def test_ties_go_to_the_lowest_index():
    """Every target three times: both twins pick the first copy."""
    a, b = sparse_instance(3, 200, 500)
    b3 = torch.from_numpy(np.concatenate([b, b, b]))
    for cross in ("bf16", "f32"):
        idx, _ = nn_variant_reference(torch.from_numpy(a), b3, cross)
        assert (idx < 500).all()


def test_wrapper_runs_twin_on_cpu_without_counting():
    a, b = (torch.from_numpy(x) for x in sparse_instance(4, 50, 300))
    before = dict(nn_variant.launches)
    for variant in VARIANTS:
        got = nn_variant(a, b, variant)
        want = nn_variant_reference(a, b, "bf16")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert nn_variant.launches == before
    assert set(before) == {kernel for kernel, _, _ in VARIANTS.values()}


@pytest.mark.parametrize("case", ["variant", "float64", "shape", "cross"])
def test_rejects_what_the_kernel_does_not_take(case):
    a, b = (torch.from_numpy(x) for x in sparse_instance(5, 10, 20))
    with pytest.raises(ValueError):
        if case == "variant":
            nn_variant(a, b, "v5")
        elif case == "float64":
            nn_variant(a.double(), b.double(), "v1")
        elif case == "shape":
            nn_variant(a[:, :2].contiguous(), b, "v1")
        else:
            nn_variant_reference(a, b, cross="tf32")


@pytest.mark.parametrize("m", [1, 300, STAGE_TARGETS, STAGE_TARGETS + 1, 3001])
def test_pack_targets_holds_the_twins_operands(m):
    """The kernels' B operand: bf16 coordinates equal to the twin's
    ``b.bfloat16()``, three limbs whose exact (f64) sum is the twin's f32
    ``(b * b).sum(1)`` bit for bit — coordinates over six decades, so the
    limbs span all of b2's significand — zeros beyond, and rows past m
    (up to whole ring stages) that never win: L1 = +inf, all else zero."""
    rng = np.random.default_rng(m)
    b = (rng.uniform(-3, 3, (m, 3)) * 10.0 ** rng.uniform(-3, 3, (m, 1))).astype(np.float32)
    bt = torch.from_numpy(b)
    packed = pack_targets(bt)
    m_pad = -(-m // STAGE_TARGETS) * STAGE_TARGETS
    assert packed.shape == (m_pad, PACK_WIDTH) and packed.dtype == torch.bfloat16
    assert torch.equal(packed[:m, :3], bt.bfloat16())
    b2 = (bt * bt).sum(1)
    limbs = packed[:m, 3:6].double()
    assert torch.equal(limbs.sum(1), b2.double())
    assert torch.equal(limbs[:, 0] + limbs[:, 1] + limbs[:, 2], b2.double())
    assert (packed[:m, 6:] == 0).all()
    pad = packed[m:].float()
    assert torch.isinf(pad[:, 3]).all() and (pad[:, 3] > 0).all()
    assert (pad[:, [0, 1, 2, *range(4, PACK_WIDTH)]] == 0).all()


@pytest.mark.parametrize("case", ["cpu", "float64", "shape", "empty"])
def test_pack_targets_runs_twin_on_cpu_and_checks_its_input(case):
    """``pack_targets`` (the one way to the pack kernel, which
    ``nn_variant`` sweeps) runs the plain twin on a CPU tensor and refuses
    what the kernel does not take."""
    b = torch.from_numpy(sparse_instance(6, 1, 700)[1])
    if case == "cpu":
        assert torch.equal(pack_targets(b).view(torch.int16), pack_targets_reference(b).view(torch.int16))
        return
    bad = {"float64": b.double(), "shape": b[:, :2].contiguous(), "empty": b[:0]}[case]
    with pytest.raises(ValueError):
        pack_targets(bad)


@pytest.mark.parametrize("n,m,sm_count", [
    (1, 1, 132), (300, 100, 132), (65, 3001, 132), (1000, 1000, 1), (16384, 1 << 20, 132),
    (16384, 1 << 20, 114), (3000, 1 << 20, 132), (200_000, 1 << 20, 132), (16384, 1_000_003, 132),
])
def test_launch_plan_and_b2_share_one_split_plan(n, m, sm_count):
    """B4's plan cuts the target axis with B2's ``split_plan``: about one
    CTA per SM (``WAVES`` for v3), the count of splits rounded to the
    nearest, where B2 (the defaults) still rounds up to ``WAVES`` per SM.
    Both written out here as plain arithmetic."""
    def cut(qpb, tile, waves, nearest):
        q_blocks, tiles = -(-n // qpb), -(-m // tile)
        want = (waves * sm_count + q_blocks // 2) // q_blocks if nearest else -(-waves * sm_count // q_blocks)
        per = -(-tiles // max(1, min(tiles, want, 65535)))
        return -(-tiles // per), per * tile

    for variant, (_, rows, split) in VARIANTS.items():
        plan = launch_plan(n, m, sm_count, rows, split)
        want = cut(CONSUMERS * 64 * rows, STAGE_TARGETS, WAVES if split else 1, True)
        assert (plan.splits, plan.per_split) == want, variant
    assert split_plan(n, m, sm_count, 1024, 1024) == cut(1024, 1024, WAVES, False)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("n,m,sm_count", [
    (1, 1, 132), (1, 300, 132), (300, 100, 132), (65, 3001, 132), (1000, 1000, 1),
    (512, 4096, 132), (777, 3000, 132), (16384, 1 << 20, 132), (16384, 1 << 20, 114),
    (200_000, 1 << 20, 132), (16384, 1_000_003, 132),
])
def test_launch_plan_covers_every_pair_once(variant, n, m, sm_count):
    """The launch plan is a pure function of (n, m, SM count): CTAs of
    CONSUMERS × 64 × rows queries cover n; m_pad is m rounded up to whole
    ring stages; splits are whole stages, cover m_pad, and none is empty
    (the kernel's sweep runs at least one stage); the grid stays within
    CUDA's y limit."""
    _, rows, split = VARIANTS[variant]
    plan = launch_plan(n, m, sm_count, rows, split)
    assert plan == launch_plan(n, m, sm_count, rows, split)
    qpb = plan.queries_per_block
    assert qpb == CONSUMERS * 64 * rows
    q_blocks, splits = plan.grid
    assert splits == plan.splits and (q_blocks - 1) * qpb < n <= q_blocks * qpb
    assert plan.m_pad % STAGE_TARGETS == 0 and plan.m_pad - STAGE_TARGETS < m <= plan.m_pad
    assert plan.per_split % STAGE_TARGETS == 0
    assert (splits - 1) * plan.per_split < plan.m_pad <= splits * plan.per_split
    assert 1 <= splits <= 65535


def test_launch_plan_fills_the_card_at_the_probe_shape():
    """At 16384 × 1,048,576 on 132 SMs: v1, v2 and v4 put about one CTA on
    every SM (at least 128), v3 about WAVES; v4's CTAs take twice v1's
    queries."""
    plans = {v: launch_plan(16384, 1 << 20, 132, rows, split) for v, (_, rows, split) in VARIANTS.items()}
    for v in ("v1", "v2", "v4"):
        ctas = plans[v].grid[0] * plans[v].grid[1]
        assert 128 <= ctas <= 132, (v, plans[v])
    assert plans["v3"].grid[0] * plans["v3"].grid[1] >= 7 * 132
    assert plans["v4"].queries_per_block == 2 * plans["v1"].queries_per_block
