"""Kernel B2's plain twin (``tpu3dlm_torch.ops.kernels.pairwise``) against
the JAX package's nearest-neighbour search on the CPU: the XLA path it
copies chunk for chunk, and the Pallas kernel in interpret mode. Both get
the same numpy inputs. The CUDA kernel itself is held against the twin on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm.ops.pallas.pairwise import nearest_neighbors_pallas, nearest_neighbors_xla
from tpu3dlm_torch.ops.icp import PAD_SENTINEL, pad_target_bucket
from tpu3dlm_torch.ops.kernels.pairwise import (
    nearest_neighbors,
    nearest_neighbors_reference,
    split_plan,
)

torch.set_num_threads(1)

SCALE = 10.0  # metres: scan-sized coordinates, as tests/test_precision.py


def scan_like(rng, n):
    """Points on three perpendicular planes with mm jitter: the geometry
    whose near-ties the reference measured."""
    k = n // 3
    planes = [
        np.stack([rng.uniform(-2, 2, k), rng.uniform(-1, 1, k), np.full(k, 2.0)], 1),
        np.stack([rng.uniform(-2, 2, k), np.full(k, 1.0), rng.uniform(1, 2, k)], 1),
        np.stack([np.full(n - 2 * k, -2.0), rng.uniform(-1, 1, n - 2 * k),
                  rng.uniform(1, 2, n - 2 * k)], 1),
    ]
    return (np.concatenate(planes) + rng.normal(0, 1e-3, (n, 3))).astype(np.float32)


def port(a, b):
    idx, d2 = nearest_neighbors(torch.from_numpy(a), torch.from_numpy(b))
    return idx.numpy(), d2.numpy()


@pytest.mark.parametrize("kind,n,m", [
    ("uniform", 1500, 5000),  # neither axis a multiple of the chunks
    ("scan", 2048, 8192),
    ("scan", 700, 4096),
])
def test_twin_matches_xla(kind, n, m):
    rng = np.random.default_rng(n + m)
    if kind == "uniform":  # at scene scale, where f32 rounding of d² is ≤ ~1e-5
        a = rng.uniform(-2, 3, (n, 3)).astype(np.float32)
        b = rng.uniform(-2, 3, (m, 3)).astype(np.float32)
    else:
        a, b = scan_like(rng, n), scan_like(rng, m)
    idx, d2 = port(a, b)
    xi, xd2 = (np.asarray(t) for t in nearest_neighbors_xla(jnp.asarray(a), jnp.asarray(b)))
    assert idx.dtype == np.int64 and d2.dtype == np.float32
    assert (idx == xi).mean() >= 0.999
    np.testing.assert_allclose(d2, xd2, rtol=0, atol=1e-5)


def test_twin_matches_pallas_interpret_and_f64():
    """The bar of tests/test_precision.py:136-148: ≥ 99% picks and every d²
    within 1e-3 of an f64 brute force, and the same against the Pallas
    kernel run in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(3)
    tgt = rng.uniform(0, SCALE, (2048, 3)).astype(np.float32)
    q = rng.uniform(0, SCALE, (256, 3)).astype(np.float32)
    d64 = ((q[:, None, :].astype(np.float64) - tgt[None, :, :]) ** 2).sum(-1)
    with pltpu.force_tpu_interpret_mode():
        pi, pd2 = nearest_neighbors_pallas(jnp.asarray(q), jnp.asarray(tgt), tile_n=128, tile_m=512)
    idx, d2 = port(q, tgt)
    for want_i, want_d2 in ((np.asarray(pi), np.asarray(pd2)), (d64.argmin(1), d64.min(1))):
        assert (idx == want_i).mean() >= 0.99
        np.testing.assert_allclose(d2, want_d2, rtol=0, atol=1e-3)


def test_ties_go_to_the_lowest_index():
    """Every target three times over, the copies in different target
    chunks: each query picks the first copy, as the reference does."""
    rng = np.random.default_rng(5)
    uniq = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    b = np.concatenate([uniq, uniq, uniq])  # copy k of target j at j + 2000·k
    a = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    idx, d2 = port(a, b)
    assert (idx < 2000).all()
    xi, xd2 = (np.asarray(t) for t in nearest_neighbors_xla(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(idx, xi)
    np.testing.assert_allclose(d2, xd2, rtol=0, atol=1e-6)


def test_sentinel_padding_never_wins():
    rng = np.random.default_rng(6)
    b = scan_like(rng, 1500)
    a = scan_like(rng, 400) + np.float32(0.05)
    padded, _ = pad_target_bucket(b)
    assert padded.shape == (2048, 3) and (padded[1500:] == PAD_SENTINEL).all()
    idx, d2 = port(a, padded)
    assert (idx < 1500).all()
    want_i, want_d2 = port(a, b)
    np.testing.assert_array_equal(idx, want_i)
    np.testing.assert_array_equal(d2, want_d2)


def test_queries_alone_and_bad_inputs():
    b = torch.zeros(4, 3)
    idx, d2 = nearest_neighbors(torch.zeros(0, 3), b)
    assert idx.shape == (0,) and d2.shape == (0,)
    with pytest.raises(ValueError, match="float32"):
        nearest_neighbors(torch.zeros(2, 3, dtype=torch.float64), b)
    with pytest.raises(ValueError, match="contiguous"):
        nearest_neighbors(torch.zeros(3, 2).T, b)
    with pytest.raises(ValueError, match="no targets"):
        nearest_neighbors(torch.zeros(2, 3), torch.zeros(0, 3))
    with pytest.raises(ValueError, match=r"\(rows, 3\)"):
        nearest_neighbors(torch.zeros(2, 4), b)


@pytest.mark.parametrize("n,m", [
    (1500, 5000), (1024, 4096), (700, 9000), (5, 70), (2048, 8193), (1, 4097),
])
def test_twin_blocks_in_place_give_the_fresh_blocks_bits(n, m):
    """The twin forms each block in one reused buffer; the picks and d²
    are bit for bit those of ``|a|² − 2 a·bᵀ + |b|²`` with a new block per
    step (``scripts/bench_twin.py::fresh_blocks``), on whole and partial
    chunks of both axes and on near-ties (scan-like planes)."""
    from tpu3dlm_torch.scripts.bench_twin import fresh_blocks

    rng = np.random.default_rng(n * 7 + m)
    a = torch.from_numpy(scan_like(rng, n) if n >= 3 else rng.uniform(0, 1, (n, 3)).astype(np.float32))
    b = torch.from_numpy(scan_like(rng, m))
    got, want = nearest_neighbors_reference(a, b), fresh_blocks(a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_bench_twin_prints_both_forms():
    from tpu3dlm_torch.scripts.bench_twin import main

    out = main(["--queries", "5", "1100", "--targets", "4100", "--reps", "1"])
    assert [r["queries"] for r in out["rows"]] == [5, 1100]
    assert all(r["in_place_s"] > 0 and r["fresh_blocks_s"] > 0 for r in out["rows"])


def test_twin_is_the_cpu_path():
    """On CPU tensors the wrapper runs the twin and launches nothing."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(70, 3)).astype(np.float32))
    before = nearest_neighbors.launches
    got = nearest_neighbors(a, b)
    want = nearest_neighbors_reference(a, b)
    assert nearest_neighbors.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n,m", [
    (16384, 1 << 20), (4096, 1 << 18), (10240, 1 << 16), (1000, 3001), (1, 1), (5, 70000),
])
def test_split_plan_covers_every_target_once(n, m):
    """The target axis is cut into whole tiles, every target in exactly one
    split, with no more blocks than the grid allows."""
    qpb, tile, sms = 1024, 1024, 132
    splits, per_split = split_plan(n, m, sms, qpb, tile)
    assert per_split % tile == 0 and 1 <= splits <= 65535
    assert (splits - 1) * per_split < m <= splits * per_split
