"""Bipartite assignment by an ε-scaled Jacobi auction with slack objects
(port of ``tpu3dlm/ops/matching.py``).

Solves the gold-vs-maintenance box matching: every row has a private slack
column priced at the unmatch cost, so "too far to be the same object" is
part of the assignment. The problem is padded symmetric with a class of
``m`` identical dummy bidders that value every object at 0, so every phase
ends with every object owned and prices carry soundly across the 8 phases
of the ε schedule; the class bids as one Bertsekas-style "similar persons"
class (its u unassigned members take the u cheapest objects not yet
class-owned, each at its own price + ε). Benefits are normalised to [0, 1];
a bid's increment is capped at 2.0; the normalised slack is clamped at
−1e12, above the forbidden sentinel. The reference module documents each
of these choices.

The reference's ``lax.while_loop`` becomes a loop on the host over rounds
that run on the device of ``cost``. The host reads the loop condition (is
any object unowned?) every ``CHECK_EVERY`` rounds, not after each round:
once the assignment is complete a round changes nothing (no unassigned real
row bids, and the class has u = 0 members left to place), so the extra
rounds leave owner and prices as they were. The rounds between checks are
capped so that no phase runs past ``max_iters``, exactly as the reference.
"""

from __future__ import annotations

import torch

_NEG = -1e15
CHECK_EVERY = 2  # bidding rounds between host reads of the stop flag


def _eps_schedule(phases: int, eps_final: float) -> torch.Tensor:
    """Geometric ε from 1/4 down to ``eps_final`` in f32, as the reference
    computes it."""
    k = torch.arange(phases, dtype=torch.float32) / max(phases - 1, 1)
    return torch.pow(torch.tensor(0.25), 1.0 - k) * torch.pow(
        torch.tensor(eps_final, dtype=torch.float32), k
    )


def _normalised_benefits(cost: torch.Tensor, unmatch_cost: float) -> torch.Tensor:
    """(n, m + n) benefits of the real rows: the real columns, then the
    private slack columns, under one affine map onto [0, 1] (forbidden
    pairs at ``_NEG``; the slack clamped at −1e12, above them)."""
    n = cost.shape[0]
    dev = cost.device
    cost = cost.to(torch.float32)
    benefit = torch.where(torch.isfinite(cost), -cost, torch.full_like(cost, _NEG))
    finite = benefit > _NEG / 2
    # an all-forbidden matrix has no finite entries: a 0/0 window makes
    # every row take its slack
    any_finite = finite.any()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    b_hi = torch.where(any_finite, torch.where(finite, benefit, -inf).max(), zero)
    b_lo = torch.where(any_finite, torch.where(finite, benefit, inf).min(), zero)
    spread = torch.clamp(b_hi - b_lo, min=1e-6)
    benefit = torch.where(finite, (benefit - b_lo) / spread, torch.full_like(benefit, _NEG))
    unmatch = torch.tensor(unmatch_cost, dtype=torch.float32, device=dev)
    slack = torch.full((n, n), _NEG, dtype=torch.float32, device=dev)
    diag = torch.arange(n, device=dev)
    slack[diag, diag] = torch.clamp((-unmatch - b_lo) / spread, min=-1e12)
    return torch.cat([benefit, slack], dim=1)


def _assign_of(owner: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) object owned by each real row, −1 for none. Unowned and
    class-owned objects scatter into an extra slot n, which is dropped."""
    idx = torch.where((owner >= 0) & (owner < n), owner, n).to(torch.int64)
    out = torch.full((n + 1,), -1, dtype=torch.int32, device=owner.device)
    out[idx] = torch.arange(owner.shape[0], dtype=torch.int32, device=owner.device)
    return out[:n]


class _Problem:
    """One auction: the normalised benefits and the constant tensors every
    bidding round uses, made once. Owner value n marks the dummy class."""

    def __init__(self, cost: torch.Tensor, unmatch_cost: float):
        n, m = cost.shape
        dev = cost.device
        self.n, self.m = n, m
        self.B = _normalised_benefits(cost, unmatch_cost)  # (n, M)
        M = n + m
        self.cols = torch.arange(M, device=dev)
        self.rows = torch.arange(n, dtype=torch.int32, device=dev)
        self.neg_inf = torch.full((n, M), float("-inf"), dtype=torch.float32, device=dev)
        self.inf = torch.full((M,), float("inf"), dtype=torch.float32, device=dev)
        self.earlier = self.cols[None, :] < self.cols[:, None]  # [j, i]: i before j

    def bidding_round(
        self, owner: torch.Tensor, prices: torch.Tensor, eps: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One Jacobi round: (owner, prices) after every unassigned real row
        and the dummy class have bid."""
        n, m, cols, neg_inf = self.n, self.m, self.cols, self.neg_inf
        # a row is assigned when it owns some object
        unassigned = ~(owner[None, :] == self.rows[:, None]).any(dim=1)

        # real rows: Jacobi bids (two max passes)
        values = self.B - prices[None, :]
        v1, best_j = values.max(dim=1)
        masked = torch.where(cols[None, :] == best_j[:, None], neg_inf, values)
        v2 = masked.max(dim=1).values
        # the increment is capped at 2.0 (twice the normalised spread): a
        # row whose only finite option is its slack would otherwise bid ~1e15
        bid = prices[best_j] + torch.clamp(v1 - v2, max=2.0) + eps
        bids = torch.where(unassigned, bid, neg_inf[:, 0])
        bid_matrix = torch.where(best_j[:, None] == cols[None, :], bids[:, None], neg_inf)
        win_bid, win_row = bid_matrix.max(dim=0)

        # dummy class: its u unassigned members take the u cheapest objects
        # it does not own yet, each at its own price + ε. "Cheapest" is the
        # reference's stable argsort; the rank of object j in it is the
        # count of objects cheaper, or as cheap and earlier
        class_owned = owner == n
        u = m - class_owned.sum()
        cp = torch.where(class_owned, self.inf, prices)
        rank = ((cp[None, :] < cp[:, None]) | ((cp[None, :] == cp[:, None]) & self.earlier)).sum(1)
        class_bid_on = (rank < u) & ~class_owned
        class_bid = prices + eps

        # merge: the highest bid per object wins; reals win ties
        class_wins = class_bid_on & (class_bid > win_bid)
        real_wins = torch.isfinite(win_bid) & ~class_wins
        owner = torch.where(
            class_wins, n, torch.where(real_wins, win_row.to(torch.int32), owner)
        ).to(torch.int32)
        prices = torch.where(class_wins, class_bid, torch.where(real_wins, win_bid, prices))
        return owner, prices


def auction_assign(
    cost: torch.Tensor,  # (n, m) costs; inf = forbidden pair
    unmatch_cost: float = 1e9,
    max_iters: int | None = None,
    phases: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimum-cost assignment with a per-row unmatch option, on the device
    of ``cost``.

    Returns (assign (n,) int32, matched (n,) bool): assign[i] is the column
    matched to row i, −1 when the row took its slack. ``max_iters`` bounds
    the bidding rounds of each phase (default: the finest phase's worst
    case, 4·(n+m+1)·1000 + 1000); a bound that runs out mid-phase leaves
    the unowned rows unmatched, never a fabricated match."""
    n, m = cost.shape
    dev = cost.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev), torch.zeros(0, dtype=torch.bool, device=dev)
    if max_iters is None:
        max_iters = min(4 * (n + m + 1) * 1000 + 1000, 2**31 - 2)
    problem = _Problem(cost, unmatch_cost)
    M = N = n + m  # objects: columns + slacks; bidders: rows + dummy class
    eps_final = 1e-3 / (N + 1)  # N·ε_final = 1e-3 of the normalised spread

    # ε from 1/4 down to eps_final; prices carry from phase to phase (every
    # phase ends complete), assignments reset each phase. A phase starts
    # with every object unowned, so the first rounds run before any read.
    prices = torch.zeros(M, dtype=torch.float32, device=dev)
    owner = torch.full((M,), -1, dtype=torch.int32, device=dev)
    for eps in _eps_schedule(phases, eps_final).to(dev):
        owner = torch.full((M,), -1, dtype=torch.int32, device=dev)
        it = 0
        while it < max_iters:
            rounds = min(CHECK_EVERY, max_iters - it)
            for _ in range(rounds):
                owner, prices = problem.bidding_round(owner, prices, eps)
            it += rounds
            if not bool((owner < 0).any()):
                break
    assign = _assign_of(owner, n)
    matched = (assign >= 0) & (assign < m)
    return torch.where(matched, assign, -1).to(torch.int32), matched


def match_report(cost: torch.Tensor, unmatch_cost: float) -> dict[str, torch.Tensor]:
    """Assignment + derived sets: matched pairs, unmatched rows (missing
    objects), unmatched columns (new objects)."""
    n, m = cost.shape
    assign, matched = auction_assign(cost, unmatch_cost)
    col_taken = torch.zeros(m, dtype=torch.bool, device=cost.device)
    col_taken[assign[matched].to(torch.int64)] = True
    return {
        "assign": assign,
        "matched_rows": matched,
        "unmatched_rows": ~matched,
        "unmatched_cols": ~col_taken,
    }
