"""Nearest-neighbour probe variants with a bf16 cross term — kernel B4.

Replaces ``scripts/bench_nn_variants.py::nn_variant`` (TPU kernels
``_kernel_v1`` and ``_kernel_v2``) with the hand-written CUDA kernels in
``csrc/nn_variants.cu``. Off the main path: the probe
``tpu3dlm_torch/scripts/bench_nn_variants.py`` verifies and times them
beside kernel B2 (``ops/kernels/pairwise.py``), which stays the production
nearest-neighbour kernel; the bf16 picks are the ones the reference retired.

``nn_variant(a, b, variant)`` takes queries ``a`` (N, 3) and targets ``b``
(M, 3), both float32 and contiguous on one device, and returns
``(idx (N,) int64, d2 (N,) float32)``: with ``b2 = |b|²`` in f32,
``dp = b2 − 2·bf16(a)·bf16(b)`` (the reference's one default-precision pass
of the TPU's matrix unit: operands rounded to bf16, products summed in
f32), ``idx = argmin dp`` (ties to the lowest index) and
``d2 = max(min dp + |a|², 0)``. The variants are the reference's:

* ``v1``: running (min, argmin) per query, 64 queries per block;
* ``v2``: the two-level minimum (the chunk's minimum first, then the lowest
  index that attains it where it beats the running one);
* ``v3``: v1 with the target axis split across blocks (the TPU's megacore
  hint), folded in split order as B2 is;
* ``v4``: v1 with 128 queries per block (the TPU's 2048-row tiles).

So there are two CUDA kernels, ``nn_v1`` (variants v1, v3, v4) and
``nn_v2`` (variant v2); ``nn_variant.launches`` counts each one's launches
under its own name.

CUDA tensors launch the kernel (a refused launch raises; there is no
fallback); CPU tensors run the plain twin ``nn_variant_reference``.

Bound on an H100 SXM at 16384 × 1,048,576: one compare per pair at the f32
instruction rate, 0.51 ms (see the source).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpu3dlm_torch.kernels.build import load_library
from tpu3dlm_torch.ops.kernels.pairwise import CHUNK, CHUNK_B, _check, device_split_plan

# the CUDA kernels by name → the C launcher's kernel number
KERNELS = {"nn_v1": 1, "nn_v2": 2}
# variant → (kernel: nn_v1 = running min, nn_v2 = two-level; query row
# tiles per warp; split the target axis)
VARIANTS = {
    "v1": ("nn_v1", 1, False),
    "v2": ("nn_v2", 1, False),
    "v3": ("nn_v1", 1, True),
    "v4": ("nn_v1", 2, False),
}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = load_library("nn_variants")
        lib.nnv_queries_per_block.argtypes = [ctypes.c_int]
        lib.nnv_queries_per_block.restype = ctypes.c_int
        lib.nnv_tile.argtypes = []
        lib.nnv_tile.restype = ctypes.c_int
        fn = lib.nnv_launch
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        _fn = (fn, lib.nnv_queries_per_block, lib.nnv_tile())
    return _fn


def nn_variant_reference(
    a: torch.Tensor, b: torch.Tensor, cross: str = "bf16"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin, chunked as B2's twin: ``b2 − 2·(a·bᵀ)`` per
    (CHUNK × CHUNK_B) block, the block's (min, argmin) folded over target
    chunks with a strict ``<``, then ``max(min + |a|², 0)``.

    ``cross="bf16"`` is what the kernels compute: a and b rounded to bf16
    and multiplied in f32 (each product of two bf16 is exact in f32).
    ``cross="f32"`` is what the JAX probe computes when it runs on the CPU,
    where a default-precision f32 dot is a full f32 dot."""
    _check(a, b)
    if cross not in ("bf16", "f32"):
        raise ValueError(f"cross must be 'bf16' or 'f32', got {cross!r}")
    ar, br = (a.bfloat16().float(), b.bfloat16().float()) if cross == "bf16" else (a, b)
    n, m = a.shape[0], b.shape[0]
    idx = torch.zeros(n, dtype=torch.int64, device=a.device)
    d2 = torch.empty(n, dtype=torch.float32, device=a.device)
    b2 = (b * b).sum(1)
    for i0 in range(0, n, CHUNK):
        ac = ar[i0:i0 + CHUNK]
        best = torch.full((ac.shape[0],), float("inf"), device=a.device)
        best_i = idx[i0:i0 + CHUNK]
        for j0 in range(0, m, CHUNK_B):
            dp = b2[j0:j0 + CHUNK_B][None, :] - 2.0 * (ac @ br[j0:j0 + CHUNK_B].T)
            tile_min, tile_arg = torch.min(dp, dim=1)
            better = tile_min < best
            best = torch.where(better, tile_min, best)
            best_i.copy_(torch.where(better, tile_arg + j0, best_i))
        a2 = (a[i0:i0 + CHUNK] * a[i0:i0 + CHUNK]).sum(1)
        d2[i0:i0 + CHUNK] = torch.clamp(best + a2, min=0.0)
    return idx, d2


_COUNT_LOCK = threading.Lock()


def nn_variant(a: torch.Tensor, b: torch.Tensor, variant: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx (N,) int64, d2 (N,) f32) of each query's nearest target by the
    bf16 cross term: the CUDA kernel of ``variant`` for CUDA tensors, the
    plain twin (``cross="bf16"``) for CPU tensors.
    ``nn_variant.launches[kernel]`` counts the launches of each CUDA kernel
    (``KERNELS``)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}, got {variant!r}")
    _check(a, b)
    if a.device.type == "cpu":
        return nn_variant_reference(a, b, "bf16")
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    kernel, qt, split = VARIANTS[variant]
    fn, queries_per_block, tile = _kernel()
    n, m = a.shape[0], b.shape[0]
    idx = torch.empty(n, dtype=torch.int64, device=a.device)
    d2 = torch.empty(n, dtype=torch.float32, device=a.device)
    if n == 0:
        return idx, d2
    splits, per_split = 1, -(-m // tile) * tile
    if split:
        splits, per_split = device_split_plan(a.device, n, m, queries_per_block(qt), tile)
    part_d = torch.empty(splits * n, dtype=torch.float32, device=a.device)
    part_i = torch.empty(splits * n, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = fn(
            KERNELS[kernel], qt, a.data_ptr(), b.data_ptr(), n, m, splits, per_split,
            part_d.data_ptr(), part_i.data_ptr(), idx.data_ptr(), d2.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nn_variant {variant} launch failed: cudaError {err}")
    with _COUNT_LOCK:
        nn_variant.launches[kernel] += 1
    return idx, d2


nn_variant.launches = dict.fromkeys(KERNELS, 0)
