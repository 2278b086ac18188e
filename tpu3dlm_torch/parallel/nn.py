"""Nearest neighbour over the world of ranks (port of
``tpu3dlm/parallel/nn.py``). Every search is kernel B2
(``ops/kernels/pairwise.py``), on the card, or its twin on the CPU.

* **query-sharded**: the (N, 3) queries shard over the ranks and the target
  replicates; each rank searches its own rows with no collective.
  ``shard_queries`` places the pair; the ICP solvers take a ``mesh`` and
  reduce their sums across the ranks (``ops/icp.py``).
* **target-sharded**: the (M, 3) target shards over the ranks (a cloud too
  large for one card); each rank finds the minima of all queries against
  its shard, the (d², global index) pairs are gathered, and the first
  minimum across the shards wins: the single-device result exactly, ties
  to the lowest global index.
"""

from __future__ import annotations

import torch

from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors
from tpu3dlm_torch.parallel.mesh import Mesh, shard_batch


def shard_queries(mesh: Mesh, a, b) -> tuple[torch.Tensor, torch.Tensor]:
    """(this rank's query rows, the whole target) as f32 tensors on the
    rank's device. The world size must divide the query count
    (``parallel.mesh.pad_to_devices`` pads)."""
    def place(x):
        return torch.as_tensor(x, dtype=torch.float32).to(mesh.device).contiguous()

    return place(shard_batch(a, mesh)), place(b)


def target_sharded_nn(mesh: Mesh):
    """Returns ``nn(a, b_shard) → (idx (N,) int64, d2 (N,) f32)``: ``a``
    is every query (the same on each rank), ``b_shard`` this rank's
    contiguous block of a target whose length the world size divides
    (``shard_batch``). Every rank gets the single-device B2 result over
    the whole target, with global indices."""

    def nn(a: torch.Tensor, b_shard: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        idx, d2 = nearest_neighbors(a, b_shard)
        gidx = idx + mesh.rank * b_shard.shape[0]
        d2_all = mesh.all_gather(d2[None])  # (ranks, N), rank-major
        idx_all = mesh.all_gather(gidx[None])
        best = torch.argmin(d2_all, dim=0, keepdim=True)  # the first minimum: the lowest shard
        return idx_all.gather(0, best)[0], d2_all.gather(0, best)[0]

    return nn
