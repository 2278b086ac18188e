"""Kernel B4 (tpu3dlm_torch/ops/kernels/nn_variants.py) on the CPU: its
plain twin against the JAX probe's ``nn_variant`` (scripts/
bench_nn_variants.py, loaded from its path; its Pallas kernels run in
interpret mode, as the JAX package's CPU tests run theirs), the bf16 twin
against the reference's f64 gate through the port's probe, and the
wrapper's dispatch and input checks. The CUDA kernels are held against the
twin on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu3dlm_torch.ops.kernels.nn_variants import VARIANTS, nn_variant, nn_variant_reference
from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors_reference
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
