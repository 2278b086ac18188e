"""The port's auction (``tpu3dlm_torch.ops.matching``) against the JAX
package's ``auction_assign`` and scipy's Hungarian solver on the CPU, on
the instances of tests/test_icp_matching.py::TestAuction (the stress sweep
at reduced size)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from tpu3dlm.ops import matching as JM
from tpu3dlm_torch.ops import matching as PM

torch.set_num_threads(1)


def both(cost, unmatch_cost, **kw):
    """(port assign, port matched) after checking them identical to JAX."""
    a, mk = PM.auction_assign(torch.from_numpy(cost), unmatch_cost=unmatch_cost, **kw)
    ja, jm = JM.auction_assign(jnp.asarray(cost), unmatch_cost=unmatch_cost, **kw)
    a, mk = a.numpy(), mk.numpy()
    assert a.dtype == np.int32 and mk.dtype == bool
    np.testing.assert_array_equal(a, np.asarray(ja))
    np.testing.assert_array_equal(mk, np.asarray(jm))
    return a, mk


def total(cost, assign):
    return float(cost[np.arange(len(assign)), assign].sum())


def test_eps_schedule_matches_jax():
    eps_final = 1e-3 / 33
    k = jnp.arange(8, dtype=jnp.float32) / 7
    want = np.asarray(0.25 ** (1.0 - k) * eps_final**k)
    np.testing.assert_allclose(PM._eps_schedule(8, eps_final).numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("shape", [(8, 8), (4, 9), (16, 16)])
def test_matches_jax_and_scipy(shape):
    rng = np.random.default_rng(sum(shape))
    for _ in range(3):
        cost = rng.uniform(0, 10, size=shape).astype(np.float32)
        a, mk = both(cost, 1e6)
        ri, ci = linear_sum_assignment(cost)
        assert mk.all()
        np.testing.assert_allclose(total(cost, a), float(cost[ri, ci].sum()), atol=1e-3)


def test_unmatch_threshold():
    a, mk = both(np.array([[0.1, 5.0], [4.0, 5.0]], np.float32), 1.0)
    assert mk.tolist() == [True, False] and a.tolist() == [0, -1]


def test_forbidden_pairs():
    a, mk = both(np.array([[np.inf, 2.0], [1.0, np.inf]], np.float32), 100.0)
    assert a.tolist() == [1, 0]


def test_all_forbidden():
    a, mk = both(np.full((3, 5), np.inf, np.float32), 10.0)
    assert not mk.any() and a.tolist() == [-1, -1, -1]


def test_tiny_spread_huge_unmatch():
    a, mk = both(np.array([[1.0, np.inf], [np.inf, 1.0]], np.float32), 1e9)
    assert a.tolist() == [0, 1] and mk.all()


def test_max_iters_exhaustion_is_conservative():
    """Two rounds per phase cannot finish: the result is what the JAX
    package returns, in range, column-unique, with incomplete rows −1."""
    rng = np.random.default_rng(1)
    cost = rng.uniform(0, 10, size=(8, 8)).astype(np.float32)
    a, mk = both(cost, 1e6, max_iters=2)
    assert (a[~mk] == -1).all()
    cols = a[mk]
    assert ((cols >= 0) & (cols < 8)).all() and len(set(cols.tolist())) == len(cols)


@pytest.mark.parametrize("kind", ["uniform", "clustered", "neartie"])
def test_stress_sweep_reduced(kind):
    """The stress sweep's cost structures at n = 48: identical to JAX and
    within the auction's 1e-3·spread optimality bound of scipy."""
    rng = np.random.default_rng(7)
    n = 48
    if kind == "uniform":
        cost = rng.uniform(0, 10, size=(n, n)).astype(np.float32)
    elif kind == "clustered":
        centers = rng.uniform(0, 10, size=8)
        cost = (centers[rng.integers(0, 8, size=(n, n))]
                + rng.normal(0, 1e-3, (n, n))).astype(np.float32)
    else:
        cost = (5.0 + rng.normal(0, 1e-4, (n, n))).astype(np.float32)
    a, mk = both(cost, 1e6)
    assert mk.all() and len(set(a.tolist())) == n
    ri, ci = linear_sum_assignment(cost)
    spread = float(cost.max() - cost.min())
    assert total(cost, a) - float(cost[ri, ci].sum()) <= 1e-3 * spread + 1e-3


def test_match_report_sets():
    rep = PM.match_report(torch.tensor([[0.1, 9.0, 9.0], [9.0, 0.2, 9.0]]), unmatch_cost=1.0)
    assert rep["matched_rows"].tolist() == [True, True]
    assert rep["unmatched_rows"].tolist() == [False, False]
    assert rep["unmatched_cols"].tolist() == [False, False, True]


def test_match_report_column_zero_with_an_unmatched_row():
    """Row 0 takes column 0 and row 1 takes its slack: column 0 is taken.
    (The reference scatters the unmatched row's False onto column 0 as well;
    the port marks only matched columns.)"""
    rep = PM.match_report(torch.tensor([[0.1, 9.0], [9.0, 9.0]]), unmatch_cost=1.0)
    assert rep["assign"].tolist() == [0, -1]
    assert rep["unmatched_cols"].tolist() == [False, True]


def test_extra_rounds_after_completion_change_nothing(monkeypatch):
    """Why the host may read the loop condition only every few rounds: once
    every object is owned, further rounds leave owner and prices exactly as
    they were, and the answer does not depend on how often it is read."""
    rng = np.random.default_rng(2)
    cost = rng.uniform(0, 10, size=(6, 9)).astype(np.float32)
    cost[0, 3] = np.inf
    n, m = cost.shape
    problem = PM._Problem(torch.from_numpy(cost), 4.0)
    eps = PM._eps_schedule(8, 1e-3 / (n + m + 1))
    prices = torch.zeros(n + m)
    for e in eps:
        owner = torch.full((n + m,), -1, dtype=torch.int32)
        while bool((owner < 0).any()):
            owner, prices = problem.bidding_round(owner, prices, e)
        for _ in range(5):
            o2, p2 = problem.bidding_round(owner, prices, e)
            torch.testing.assert_close(o2, owner, rtol=0, atol=0)
            torch.testing.assert_close(p2, prices, rtol=0, atol=0)
    results = []
    for k in (1, 3, 8, 64):
        monkeypatch.setattr(PM, "CHECK_EVERY", k)
        results.append(PM.auction_assign(torch.from_numpy(cost), 4.0))
    for a, mk in results[1:]:
        torch.testing.assert_close(a, results[0][0], rtol=0, atol=0)
        torch.testing.assert_close(mk, results[0][1], rtol=0, atol=0)
