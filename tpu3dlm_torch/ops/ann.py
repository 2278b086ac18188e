"""Anchor-bucketed nearest neighbour for ICP (port of ``tpu3dlm/ops/ann.py``).

A two-level search that trades a one-off index build, amortised over every
ICP iteration against the same target, for per-query work that touches only
a small, spatially relevant slice of the target:

  build  — sample C anchors from the target, assign every target point to
           its nearest anchor (one exact sweep through kernel B2 with the
           target as the queries), bucket the points per anchor with a cap
           B (stable sort + scatter; points past the cap are dropped).
  query  — rank the C anchors by |a|² − 2 q·a (a plain f32 matmul, TF32
           off), take the P nearest by P argmin-and-mask passes, gather
           their P·B candidates, exact Σ(q − c)² and the first minimum.

Approximation contract (the reference's): the answer is exact whenever the
true nearest neighbour is in one of the query's P buckets and was not
dropped by overflow. ICP's measurement pass stays on the exact kernel
(``ops/icp.py``), so its rmse and inlier fraction are exact for the
transform it returns.

The JAX package computes the query outside any Pallas kernel, so here it is
plain PyTorch; the build's assignment sweep is kernel B2 on CUDA tensors
and its twin on CPU tensors (``ops/kernels/pairwise.nearest_neighbors``),
or the twin on any device with ``use_pallas=False``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors, nearest_neighbors_reference

# coordinate of an empty bucket slot: beyond any scan and beyond the 1e6
# target padding of ops/icp.pad_target_bucket, so an empty slot never wins
# while a real candidate exists; (1e8)²·3 stays finite in f32
_SLOT_SENTINEL = 1.0e8

# queries run in chunks so the gathered (chunk, P·B, 3) candidate block
# stays ~100 MB at the default shapes
_QUERY_CHUNK = 4096


class AnchorIndex(NamedTuple):
    """Two-level NN index over one target cloud, on the target's device.

    anchors     (C, 3) f32 — level-1 routing points, sampled from the target
    buckets     (C, B, 3) f32 — level-2 candidates; empty slots at
                ``_SLOT_SENTINEL``
    bucket_ids  (C, B) int32 — indices into the target (0 on empty slots,
                whose sentinel coordinates never win)
    """

    anchors: torch.Tensor
    buckets: torch.Tensor
    bucket_ids: torch.Tensor

    @property
    def n_anchors(self) -> int:
        return self.anchors.shape[0]

    @property
    def bucket_cap(self) -> int:
        return self.buckets.shape[1]


def default_index_shape(m: int) -> tuple[int, int]:
    """(n_anchors, bucket_cap) for a (power-of-two padded) target of m
    points: C = m/128 anchors (mean occupancy 128), B = 4× the mean, with
    clamps for tiny and huge clouds."""
    c = max(64, min(8192, m // 128))
    c = min(c, m)
    b = max(32, min(4096, 4 * max(m // c, 1)))
    return c, b


def sample_anchor_ids(m: int, c: int, seed: int) -> torch.Tensor:
    """(c,) int64 target rows drawn without replacement: ``torch.randperm``
    on a CPU generator seeded with ``seed``, so the card and the CPU pick
    the same anchors. These are NOT the JAX package's anchors, which come
    from ``jax.random.permutation``; the parity tests feed that
    permutation in here."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randperm(m, generator=g)[:c]


def build_anchor_index(
    target: torch.Tensor,  # (M, 3); may hold pad_target_bucket sentinels
    n_anchors: int,
    bucket_cap: int,
    seed: int = 0,
    use_pallas: bool = True,
) -> AnchorIndex:
    """Sample the anchors, assign every target point to its nearest one
    (kernel B2 on a CUDA target; the twin with ``use_pallas=False``), and
    bucket the points by anchor in target order, dropping those past
    ``bucket_cap``."""
    tgt = target.to(torch.float32).contiguous()
    m = tgt.shape[0]
    c, b = n_anchors, bucket_cap
    if c > m:
        raise ValueError(f"n_anchors {c} > target size {m}")
    anchors = tgt[sample_anchor_ids(m, c, seed).to(tgt.device)].contiguous()
    assign, _ = (nearest_neighbors if use_pallas else nearest_neighbors_reference)(tgt, anchors)

    order = torch.argsort(assign, stable=True)  # ids stay in target order per anchor
    sorted_assign = assign[order]
    counts = torch.bincount(assign, minlength=c)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(m, device=tgt.device) - starts[sorted_assign]
    keep = rank < b  # overflow past the cap is dropped
    slot = sorted_assign[keep] * b + rank[keep]  # unique: the scatter is deterministic
    buckets = torch.full((c * b, 3), _SLOT_SENTINEL, dtype=torch.float32, device=tgt.device)
    buckets[slot] = tgt[order[keep]]
    ids = torch.zeros(c * b, dtype=torch.int32, device=tgt.device)
    ids[slot] = order[keep].to(torch.int32)
    return AnchorIndex(anchors, buckets.reshape(c, b, 3), ids.reshape(c, b))


def _query_chunk(q: torch.Tensor, index: AnchorIndex, a2: torch.Tensor, top_p: int):
    """Exact-within-candidates NN for one (chunk, 3) block of queries."""
    # |q − a|² ranks like |a|² − 2 q·a (|q|² is constant per row)
    rank_d2 = a2[None, :] - 2.0 * (q @ index.anchors.T)  # (chunk, C)
    # top-P by P argmin + mask passes, in the reference's column order:
    # that order decides ties in the flat argmin below
    cols = []
    for _ in range(top_p):
        j = torch.argmin(rank_d2, dim=1)
        cols.append(j)
        rank_d2.scatter_(1, j[:, None], float("inf"))
    top = torch.stack(cols, dim=1)  # (chunk, P)

    cand = index.buckets[top]  # (chunk, P, B, 3)
    diff = q[:, None, None, :] - cand
    flat = (diff * diff).sum(-1).reshape(q.shape[0], -1)  # (chunk, P·B) exact distances
    j = torch.argmin(flat, dim=1, keepdim=True)  # the first minimum
    ids = index.bucket_ids[top].reshape(q.shape[0], -1)
    return torch.gather(ids, 1, j)[:, 0].to(torch.int64), torch.gather(flat, 1, j)[:, 0]


def nn_anchored(
    queries: torch.Tensor,  # (N, 3)
    index: AnchorIndex,
    top_p: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx (N,) int64, d² (N,) f32) into the original target: a drop-in
    for ``nearest_neighbors`` within the approximation contract above (d²
    is not clamped: it is a sum of squares)."""
    q = queries.to(torch.float32)
    n = q.shape[0]
    idx = torch.empty(n, dtype=torch.int64, device=q.device)
    d2 = torch.empty(n, dtype=torch.float32, device=q.device)
    a2 = (index.anchors * index.anchors).sum(1)
    for i0 in range(0, n, _QUERY_CHUNK):
        idx[i0:i0 + _QUERY_CHUNK], d2[i0:i0 + _QUERY_CHUNK] = _query_chunk(
            q[i0:i0 + _QUERY_CHUNK], index, a2, top_p
        )
    return idx, d2
