"""Brute-force nearest neighbour in 3D — kernel B2.

Replaces ``tpu3dlm/ops/pallas/pairwise.py::nearest_neighbors_pallas`` (TPU
kernel ``_nn_kernel``) with the hand-written CUDA kernel in
``csrc/nearest_neighbors.cu``; every ICP correspondence sweep, the final
measurement sweep and the init scoring of the two-scan compare go through
it.

``nearest_neighbors(a, b)`` takes queries ``a`` (N, 3) and targets ``b``
(M, 3), both float32 and contiguous on one device, and returns
``(idx (N,) int64, d2 (N,) float32)``: the index of each query's nearest
target (the lowest index on a tie) and the squared distance, clamped at 0.
CUDA tensors launch the kernel (a refused launch raises; there is no
fallback); CPU tensors run the plain PyTorch twin
``nearest_neighbors_reference``, a chunked copy of the reference's
``nearest_neighbors_xla``, which the CPU tests hold against the JAX package
and ``chip_smoke.py`` holds the kernel against on the card. Callers given
``use_pallas=False`` (the user's ``use_pallas = false``) call the twin
itself, on any device, and the kernel is never launched.

Bound on an H100 SXM: three f32 FMAs (6 flops) per query-target pair at
67 TFLOP/s, e.g. 1.54 ms at 16384 × 1,048,576; the inputs are a few MB, so
operations bind (see the source for the design).
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter

import torch

from tpu3dlm_torch.kernels.build import load_library

_BIG = 1e30  # initial running minimum, as the reference's
CHUNK, CHUNK_B = 1024, 4096  # the twin's query and target chunks, as the reference's
WAVES = 8  # blocks per SM the target split aims for

_fn = None
_sm_count: dict[int, int] = {}


def _kernel():
    global _fn
    if _fn is None:
        lib = load_library("nearest_neighbors")
        for name in ("nn_queries_per_block", "nn_tile"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        fn = lib.nn_launch
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        _fn = (fn, lib.nn_queries_per_block(), lib.nn_tile())
    return _fn


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be (rows, 3), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"a on {a.device} and b on {b.device}: one device expected")
    if b.shape[0] == 0:
        raise ValueError("no targets: b has 0 rows")
    if max(a.shape[0], b.shape[0]) >= 2**31 // 3:
        raise ValueError("more than 2**31 / 3 rows")


def split_plan(n: int, m: int, sm_count: int, queries_per_block: int, tile: int,
               waves: int = WAVES, round_nearest: bool = False) -> tuple[int, int]:
    """(splits, targets_per_split): how the target axis is cut so that
    about ``waves`` blocks run per SM (the count of splits rounded up, or
    to the nearest with ``round_nearest``). Every split but the last covers
    a whole number of tiles, and none is empty."""
    q_blocks = -(-n // queries_per_block)
    tiles = -(-m // tile)
    per_sm = waves * sm_count
    want = (per_sm + q_blocks // 2) // q_blocks if round_nearest else -(-per_sm // q_blocks)
    splits = max(1, min(tiles, want, 65535))
    tiles_per_split = -(-tiles // splits)
    return -(-tiles // tiles_per_split), tiles_per_split * tile


def device_sm_count(device: torch.device) -> int:
    """The SM count of a CUDA ``device``, read once per device."""
    dev = device.index if device.index is not None else torch.cuda.current_device()
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sm_count[dev]


def device_split_plan(device: torch.device, n: int, m: int, queries_per_block: int,
                      tile: int) -> tuple[int, int]:
    """``split_plan`` for the SM count of ``device``."""
    return split_plan(n, m, device_sm_count(device), queries_per_block, tile)


def nearest_neighbors_reference(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin: ``nearest_neighbors_xla`` chunk for chunk.

    Both axes are tiled; each (CHUNK × CHUNK_B) block is
    ``|a|² − 2 a·bᵀ + |b|²`` in f32 with a full-precision product (TF32 is
    off, ``device.py``); a running (min, argmin) folds over target chunks
    with a strict ``<`` (ties: the first chunk, and the first column
    within one); the result is clamped at 0. The reference pads the last
    target chunk with rows at 1e15, which can never win; here the last chunk
    is simply shorter. Each block is formed in place in one buffer
    (``a·bᵀ``, times −2, plus ``|a|²``, plus ``|b|²``: the same roundings
    as ``|a|² − 2 a·bᵀ + |b|²``), since a fresh 16 MB block per step costs
    more than the arithmetic on hosts where large allocations fault in
    their pages each time (``scripts/bench_twin.py``)."""
    _check(a, b)
    n, m = a.shape[0], b.shape[0]
    idx = torch.zeros(n, dtype=torch.int64, device=a.device)
    d2 = torch.empty(n, dtype=torch.float32, device=a.device)
    b2 = (b * b).sum(1)
    block = torch.empty(min(n, CHUNK), min(m, CHUNK_B), dtype=torch.float32, device=a.device)
    for i0 in range(0, n, CHUNK):
        ac = a[i0:i0 + CHUNK]
        a2 = (ac * ac).sum(1, keepdim=True)
        best = torch.full((ac.shape[0],), _BIG, dtype=torch.float32, device=a.device)
        best_i = idx[i0:i0 + CHUNK]
        for j0 in range(0, m, CHUNK_B):
            bc = b[j0:j0 + CHUNK_B]
            d = block[:ac.shape[0]] if bc.shape[0] == block.shape[1] else None
            d = torch.mm(ac, bc.T, out=d) if d is not None else ac @ bc.T
            d.mul_(-2.0).add_(a2).add_(b2[j0:j0 + CHUNK_B][None, :])
            tile_min, tile_arg = torch.min(d, dim=1)
            better = tile_min < best
            best = torch.where(better, tile_min, best)
            best_i.copy_(torch.where(better, tile_arg + j0, best_i))
        d2[i0:i0 + CHUNK] = torch.clamp(best, min=0.0)
    return idx, d2


_COUNT_LOCK = threading.Lock()


def nearest_neighbors(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx (N,) int64, d2 (N,) f32) of each query's nearest target: the
    CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    ``nearest_neighbors.launches`` counts kernel launches and
    ``nearest_neighbors.launches_by_shape`` counts them by (N, M)."""
    _check(a, b)
    if a.device.type == "cpu":
        return nearest_neighbors_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    fn, queries_per_block, tile = _kernel()
    n, m = a.shape[0], b.shape[0]
    idx = torch.empty(n, dtype=torch.int64, device=a.device)
    d2 = torch.empty(n, dtype=torch.float32, device=a.device)
    if n == 0:
        return idx, d2
    splits, per_split = device_split_plan(a.device, n, m, queries_per_block, tile)
    part_d = torch.empty(splits * n, dtype=torch.float32, device=a.device)
    part_i = torch.empty(splits * n, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = fn(
            a.data_ptr(), b.data_ptr(), n, m, splits, per_split,
            part_d.data_ptr(), part_i.data_ptr(), idx.data_ptr(), d2.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nearest_neighbors launch failed: cudaError {err}")
    with _COUNT_LOCK:  # threads (the serving watcher's workers) launch too
        nearest_neighbors.launches += 1
        nearest_neighbors.launches_by_shape[n, m] += 1
    return idx, d2


nearest_neighbors.launches = 0
nearest_neighbors.launches_by_shape = Counter()
