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

* ``v1``: running (min, argmin) per accumulator element, 256 queries per
  CTA;
* ``v2``: the two-level minimum (the chunk's minimum first, then the lowest
  index that attains it where it beats the running one);
* ``v3``: v1 with the target axis split into about ``WAVES`` CTAs per SM
  (the TPU's megacore hint), folded in split order as B2 is;
* ``v4``: v1 with twice the queries per CTA (the TPU's 2048-row tiles).

So there are two CUDA kernels, ``nn_v1`` (variants v1, v3, v4) and
``nn_v2`` (variant v2); ``nn_variant.launches`` counts each one's launches
under its own name. A call is ``pack_targets`` (on the card the pack kernel
``nn_pack_kernel``, once per call: bf16 coordinates and three bf16 limbs of
b2 in one 32-byte row, the MMA's B operand) and then ``sweep`` over the
packed rows, cut by ``launch_plan``.

CUDA tensors launch the kernel (a refused launch raises; there is no
fallback); CPU tensors run the plain twin ``nn_variant_reference``.

Bound on an H100 SXM at 16384 × 1,048,576: one compare per pair at the f32
instruction rate, 0.51 ms; the kernels' MMAs, padded to depth 16, take
0.56 ms at the bf16 tensor-core rate (see the source).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from tpu3dlm_torch.kernels.build import load_library
from tpu3dlm_torch.ops.kernels.pairwise import CHUNK, CHUNK_B, WAVES, _check, device_sm_count, split_plan

# the CUDA kernels by name → the C launcher's kernel number
KERNELS = {"nn_v1": 1, "nn_v2": 2}
# variant → (kernel: nn_v1 = running min, nn_v2 = two-level; 64-query row
# tiles per consumer warpgroup; split the target axis into WAVES CTAs per SM)
VARIANTS = {
    "v1": ("nn_v1", 1, False),
    "v2": ("nn_v2", 1, False),
    "v3": ("nn_v1", 1, True),
    "v4": ("nn_v1", 2, False),
}
PACK_WIDTH = 16  # bf16 per packed target row: the MMA depth
STAGE_TARGETS = 512  # targets per stage of the kernels' ring; the split granularity
CONSUMERS = 4  # consumer warpgroups per CTA, one CTA per SM


class Plan(NamedTuple):
    queries_per_block: int
    q_blocks: int
    splits: int
    per_split: int  # targets per split, a multiple of STAGE_TARGETS
    m_pad: int  # rows of the packed targets: m rounded up to STAGE_TARGETS

    @property
    def grid(self) -> tuple[int, int]:
        return self.q_blocks, self.splits


def launch_plan(n: int, m: int, sm_count: int, rows: int, split: bool) -> Plan:
    """How a launch cuts ``n`` ≥ 1 queries by ``m`` ≥ 1 targets: CTAs of
    ``CONSUMERS × 64 × rows`` queries, and the target axis (whole stages of
    ``STAGE_TARGETS``) cut by B2's ``split_plan`` so that the grid holds
    about one CTA per SM (v1, v2, v4) or ``WAVES`` per SM (``split``: v3),
    the count of splits rounded to the nearest, never a split without
    targets."""
    queries_per_block = CONSUMERS * 64 * rows
    splits, per_split = split_plan(n, m, sm_count, queries_per_block, STAGE_TARGETS,
                                   waves=WAVES if split else 1, round_nearest=True)
    m_pad = -(-m // STAGE_TARGETS) * STAGE_TARGETS
    return Plan(queries_per_block, -(-n // queries_per_block), splits, per_split, m_pad)


def pack_targets_reference(b: torch.Tensor) -> torch.Tensor:
    """The kernels' B operand, plain PyTorch (the twin of
    ``nn_pack_kernel``), on ``b``'s device: (m_pad, 16) bf16 rows
    ``(bf16(x), bf16(y), bf16(z), L1, L2, L3, 0, …)`` with ``b2 = |b|²`` in
    f32 as the twin computes it and ``L1 + L2 + L3 = b2`` exactly (each
    limb the bf16 rounding of what the ones before leave; three bf16 hold
    f32's 24-bit significand while b2 is normal). Rows past m, up to a whole
    stage, are zero with ``L1 = +inf``: their dp is +inf and never wins."""
    m = b.shape[0]
    m_pad = -(-m // STAGE_TARGETS) * STAGE_TARGETS
    b2 = (b * b).sum(1)
    l1 = b2.bfloat16().float()
    r1 = b2 - l1
    l2 = r1.bfloat16().float()
    packed = torch.zeros(m_pad, PACK_WIDTH, dtype=torch.bfloat16, device=b.device)
    packed[:m, :6] = torch.cat([b, l1[:, None], l2[:, None], (r1 - l2)[:, None]], 1)
    packed[m:, 3] = float("inf")
    return packed


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures on a loaded build of ``csrc/nn_variants.cu``
    and checks its stage and CTA sizes against ``launch_plan``'s."""
    for name in ("nnv_queries_per_block", "nnv_stage_targets"):
        getattr(lib, name).restype = ctypes.c_int
    lib.nnv_queries_per_block.argtypes = [ctypes.c_int]
    lib.nnv_stage_targets.argtypes = []
    if (lib.nnv_stage_targets(), lib.nnv_queries_per_block(1)) != (STAGE_TARGETS, CONSUMERS * 64):
        raise RuntimeError("csrc/nn_variants.cu and launch_plan disagree on the stage or CTA size")
    lib.nnv_pack.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    lib.nnv_pack.restype = ctypes.c_int
    lib.nnv_sweep.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                              + [ctypes.c_void_p] * 5)
    lib.nnv_sweep.restype = ctypes.c_int
    return lib


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(load_library("nn_variants"))
    return _lib


def pack_targets(b: torch.Tensor) -> torch.Tensor:
    """``pack_targets_reference``'s (m_pad, 16) bf16 rows: on a card by
    the pack kernel ``nn_pack_kernel``, the rows ``nn_variant`` sweeps;
    for a CPU tensor by the plain twin."""
    _check(b, b)  # (m, 3) float32, contiguous, m ≥ 1
    if b.device.type == "cpu":
        return pack_targets_reference(b)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    m = b.shape[0]
    b2 = (b * b).sum(1)  # the twin's b2, bit for bit
    packed = torch.empty(-(-m // STAGE_TARGETS) * STAGE_TARGETS, PACK_WIDTH, dtype=torch.bfloat16,
                         device=b.device)
    with torch.cuda.device(b.device):
        err = _library().nnv_pack(b.data_ptr(), b2.data_ptr(), m, packed.shape[0], packed.data_ptr(),
                                  torch.cuda.current_stream(b.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nn_pack_kernel launch failed: cudaError {err}")
    return packed


def sweep(a: torch.Tensor, packed: torch.Tensor, m: int, variant: str,
          lib: ctypes.CDLL | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx, d2) of the queries ``a`` (n ≥ 1, on a card) against ``m``
    targets packed by ``pack_targets``: the sweep kernel of ``variant``,
    then the fold of its splits, from ``lib`` (a ``bind``-ed build of
    ``csrc/nn_variants.cu``; by default the library ``nn_variant``
    launches). Counts nothing."""
    kernel, rows, split = VARIANTS[variant]
    n = a.shape[0]
    plan = launch_plan(n, m, device_sm_count(a.device), rows, split)
    if packed.shape != (plan.m_pad, PACK_WIDTH) or packed.dtype != torch.bfloat16:
        raise ValueError(f"packed must be ({plan.m_pad}, {PACK_WIDTH}) bf16, got {tuple(packed.shape)}")
    idx = torch.empty(n, dtype=torch.int64, device=a.device)
    d2 = torch.empty(n, dtype=torch.float32, device=a.device)
    part_d = torch.empty(plan.splits * n, dtype=torch.float32, device=a.device)
    part_i = torch.empty(plan.splits * n, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = (lib if lib is not None else _library()).nnv_sweep(
            KERNELS[kernel], rows, a.data_ptr(), packed.data_ptr(), n, plan.m_pad, plan.splits,
            plan.per_split, part_d.data_ptr(), part_i.data_ptr(), idx.data_ptr(), d2.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nn_variant {variant} launch failed: cudaError {err}")
    return idx, d2


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
    n = a.shape[0]
    if n == 0:
        return (torch.empty(0, dtype=torch.int64, device=a.device),
                torch.empty(0, dtype=torch.float32, device=a.device))
    idx, d2 = sweep(a, pack_targets(b), b.shape[0], variant)
    kernel = VARIANTS[variant][0]
    with _COUNT_LOCK:
        nn_variant.launches[kernel] += 1
    return idx, d2


nn_variant.launches = dict.fromkeys(KERNELS, 0)
