"""Fused BEiT attention on packed projections — kernel B1.

Replaces ``tpu3dlm/ops/pallas/attention.py::beit_attention_packed_pallas``
(TPU kernel ``_attn_kernel_packed``) with the hand-written CUDA kernel in
``csrc/beit_attention.cu``.

``beit_attention_packed(q, k, v, bias, num_heads)`` takes the raw q/k/v
Dense outputs (B, N, h·d) and the per-layer (h, N, N) f32 relative-position
bias and returns the packed (B, N, h·d) attention output:
``softmax(q_h k_hᵀ/√d + bias[h])`` in f32, probabilities cast to the input
type, ``p·v_h`` accumulated in f32. CUDA tensors launch the kernel (there is
no fallback: a refused launch raises); CPU tensors run the plain PyTorch
twin ``beit_attention_packed_reference``, which the CPU tests hold against
the JAX package and ``chip_smoke.py`` holds the kernel against on the card.

Bound on an H100 SXM at the production shape (bf16, B=384, N=197, h=12,
d=64): 466.7 MB moved = 139 µs at 3.35 TB/s against 46 µs of bf16
tensor-core work, so memory-bound. The kernel stages each head's K and V
once per block in shared memory, keeps each warp's score tile in registers
(bf16: tensor-core ``mma.sync``), and never materialises the score tensor
or a transposed copy, so its traffic is near that bound; what it loses to
the bound is latency (see the source and PERF.md).
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu3dlm_torch.kernels.build import load_library

HEAD_DIMS = (16, 32, 64)  # head widths the kernel is instantiated for
MAX_TOKENS = 256  # a warp's 16 × N score tile lives in registers

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = load_library("beit_attention")
        fn = lib.beit_attention_packed_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def _check(q, k, v, bias, num_heads: int) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, N, H) shape: {q.shape}, {k.shape}, {v.shape}")
    B, N, H = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16: {q.dtype}, {k.dtype}, {v.dtype}")
    if num_heads <= 0 or H % num_heads:
        raise ValueError(f"hidden width {H} is not a multiple of num_heads={num_heads}")
    if H // num_heads not in HEAD_DIMS:
        raise ValueError(f"head width {H // num_heads} not in {HEAD_DIMS}")
    if not 0 < N <= MAX_TOKENS:
        raise ValueError(f"N={N} outside 1..{MAX_TOKENS}")
    if bias.shape != (num_heads, N, N) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be ({num_heads}, {N}, {N}) float32, got {tuple(bias.shape)} {bias.dtype}")
    if len({t.device for t in (q, k, v, bias)}) != 1:
        raise ValueError("q, k, v and bias must be on one device")
    if not all(t.is_contiguous() for t in (q, k, v, bias)):
        raise ValueError("q, k, v and bias must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")


def beit_attention_packed_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Plain PyTorch twin with the kernel's numerics: f32 scores and
    softmax, probabilities cast to the input type for the AV product, f32
    accumulation, output in the input type."""
    B, N, H = q.shape
    h = num_heads
    d = H // h
    split = lambda t: t.reshape(B, N, h, d).transpose(1, 2)  # noqa: E731 — (B, h, N, d)
    s = split(q).float() @ split(k).float().transpose(-1, -2)
    s = s / math.sqrt(d) + bias.float()[None]
    p = torch.softmax(s, dim=-1)
    o = p.to(v.dtype).float() @ split(v).float()
    return o.to(q.dtype).transpose(1, 2).reshape(B, N, H)


def beit_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """(B, N, h·d) packed fused attention: the CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors. ``beit_attention_packed.launches``
    counts kernel launches."""
    _check(q, k, v, bias, num_heads)
    if q.device.type == "cpu":
        return beit_attention_packed_reference(q, k, v, bias, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    fn = _kernel()
    B, N, H = q.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), o.data_ptr(),
            B, N, H, num_heads, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"beit_attention_packed launch failed: cudaError {err}")
    beit_attention_packed.launches += 1
    return o


beit_attention_packed.launches = 0
