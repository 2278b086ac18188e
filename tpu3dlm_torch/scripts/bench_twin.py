"""How long kernel B2's plain twin takes on the host, with its blocks
formed in place (``nearest_neighbors_reference``) and with a fresh block
per step (``|a|² − 2 a·bᵀ + |b|²`` written out), on the same inputs.

    python -m tpu3dlm_torch.scripts.bench_twin [--queries 4096 16384] [--targets 65536] [--reps 3]

The shapes are the two-scan compare's ICP sweeps at the parity
configuration. Checks that both forms give the same picks and d² bit for
bit, and prints the host's torch threads and, as its last line, one JSON
object with the best of ``--reps`` seconds of each form at each shape.
Runs on the CPU, where the CPU tests and every card-against-CPU check run
the twin.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tpu3dlm_torch.ops.kernels.pairwise import _BIG, CHUNK, CHUNK_B, nearest_neighbors_reference


def fresh_blocks(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The twin with each (CHUNK × CHUNK_B) block a new tensor."""
    n, m = a.shape[0], b.shape[0]
    idx = torch.zeros(n, dtype=torch.int64)
    d2 = torch.empty(n, dtype=torch.float32)
    b2 = (b * b).sum(1)
    for i0 in range(0, n, CHUNK):
        ac = a[i0:i0 + CHUNK]
        a2 = (ac * ac).sum(1, keepdim=True)
        best = torch.full((ac.shape[0],), _BIG, dtype=torch.float32)
        best_i = idx[i0:i0 + CHUNK]
        for j0 in range(0, m, CHUNK_B):
            d = a2 - 2.0 * (ac @ b[j0:j0 + CHUNK_B].T) + b2[j0:j0 + CHUNK_B][None, :]
            tile_min, tile_arg = torch.min(d, dim=1)
            better = tile_min < best
            best = torch.where(better, tile_min, best)
            best_i.copy_(torch.where(better, tile_arg + j0, best_i))
        d2[i0:i0 + CHUNK] = torch.clamp(best, min=0.0)
    return idx, d2


def best_s(fn, reps: int) -> tuple[float, tuple]:
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return min(times), out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, nargs="+", default=[4096, 16384])
    ap.add_argument("--targets", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    g = torch.Generator().manual_seed(0)
    b = torch.rand(args.targets, 3, generator=g) * 4.0
    rows = []
    for n in args.queries:
        a = torch.rand(n, 3, generator=g) * 4.0
        in_place, want = best_s(lambda: nearest_neighbors_reference(a, b), args.reps)
        fresh, got = best_s(lambda: fresh_blocks(a, b), args.reps)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise SystemExit(f"the two forms differ at {n} x {args.targets}")
        rows.append({"queries": n, "targets": args.targets, "in_place_s": in_place, "fresh_blocks_s": fresh})
    out = {"torch_threads": torch.get_num_threads(), "reps": args.reps, "rows": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
