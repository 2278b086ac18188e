"""Fused BEiT attention — kernels B1 (packed layout) and B3 (head-major).

Replaces two TPU kernels of ``tpu3dlm/ops/pallas/attention.py`` with one
hand-written CUDA kernel body in ``csrc/beit_attention.cu`` that takes the
layout as strides:

* B1, ``beit_attention_packed_pallas`` (TPU kernel ``_attn_kernel_packed``):
  ``beit_attention_packed(q, k, v, bias, num_heads)`` takes the raw q/k/v
  Dense outputs (B, N, h·d) and returns the packed (B, N, h·d) output. It
  is what ``models/beit.py`` calls.
* B3, ``beit_attention_pallas`` (TPU kernel ``_attn_kernel``):
  ``beit_attention(q, k, v, bias)`` takes head-major (h, B, N, d) q/k/v and
  returns (h, B, N, d), read and written in place (no transpose).

Both compute ``softmax(q_h k_hᵀ/√d + bias[h])`` in f32 with the per-layer
(h, N, N) f32 relative-position bias, cast the probabilities to the input
type, and accumulate ``p·v_h`` in f32. CUDA tensors launch the kernel
(there is no fallback: a refused launch raises); CPU tensors run the plain
PyTorch twins ``beit_attention_packed_reference`` and
``beit_attention_reference``, which the CPU tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against on the card.

Both ops are ``torch.autograd.Function``s, as the reference's are
``jax.custom_vjp``s (attention.py:260-336): the backward recomputes the
reference's VJP from the saved inputs in plain PyTorch
(``beit_attention_packed_backward``, ``beit_attention_backward``), because
the JAX package too computes it outside any Pallas kernel. So finetuning
differentiates through the kernel's forward.

On a CUDA tensor the C entry routes by shape between two hand-written
kernels (``kernel_route`` asks it which):

* ``attention_bf16_tma`` — bf16 with N ≤ 256 and d ∈ {16, 32, 64}, the
  serving path. Bound at the production shape (bf16, B=384, N=197, h=12,
  d=64), the same in both layouts: 466.7 MB moved = 139 µs at 3.35 TB/s
  against 46 µs of bf16 tensor-core work, so memory-bound. It runs a
  persistent grid of thread-block clusters (one cluster = the ceil(N/128)
  query-row tiles of one head, as many as fit on the card at once, each
  walking an equal run of (head, batch row) items); K and V reach each
  cluster once by TMA multicast, the bias rows stay in shared memory per
  head, and the score tile never leaves registers.
* ``attention_simt`` — every f32 shape (the finetune and parity path) and
  the bf16 shapes outside the TMA kernel (N > 256, or d ∉ {16, 32, 64}):
  CUDA cores, register tiles of S and O, key blocks of 32 with an online
  f32 softmax, so N is not limited. Bound by its f32 operations.

Head widths the card takes are the multiples of 16 up to 128 (``d % 16`` and
``d > 128`` raise ``ValueError`` before any launch); N is not limited. The
CPU twins take every N ≥ 1 and every d, as the JAX package's einsum path
does. See the source and PERF.md.
"""

from __future__ import annotations

import ctypes
import math
import threading
from collections import Counter

import torch

from tpu3dlm_torch.kernels.build import load_library

CUDA_HEAD_DIM_STEP = 16  # the CUDA kernels take head widths 16, 32, ..., 128
CUDA_MAX_HEAD_DIM = 128
KERNELS = {1: "attention_bf16_tma", 2: "attention_simt"}  # beit_attention_route's answers

_fns: dict = {}  # C entry name → its ctypes function


def _kernel(entry: str):
    """The C entry ``beit_attention_{packed,headmajor}_launch``."""
    if entry not in _fns:
        fn = getattr(load_library("beit_attention"), entry)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def kernel_route(dtype: torch.dtype, N: int, d: int) -> str:
    """The name of the CUDA kernel that runs attention of this input type,
    token count and head width, as the C entry routes it
    (``beit_attention_route``); raises for a shape no kernel takes."""
    if "route" not in _fns:
        fn = load_library("beit_attention").beit_attention_route
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        _fns["route"] = fn
    name = KERNELS.get(_fns["route"](int(dtype == torch.bfloat16), N, d))
    if name is None:
        raise ValueError(f"no CUDA kernel takes {dtype} attention with N={N}, d={d}")
    return name


def _check_common(q, k, v, bias, h: int, d: int, N: int) -> None:
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one shape: {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16: {q.dtype}, {k.dtype}, {v.dtype}")
    if d < 1 or N < 1:
        raise ValueError(f"head width and token count must be at least 1, got d={d}, N={N}")
    if bias.shape != (h, N, N) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be ({h}, {N}, {N}) float32, got {tuple(bias.shape)} {bias.dtype}")
    if len({t.device for t in (q, k, v, bias)}) != 1:
        raise ValueError("q, k, v and bias must be on one device")
    if not all(t.is_contiguous() for t in (q, k, v, bias)):
        raise ValueError("q, k, v and bias must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda" and (d % CUDA_HEAD_DIM_STEP or d > CUDA_MAX_HEAD_DIM):
        raise ValueError(
            f"head width {d} is not taken by the CUDA kernels: it must be a multiple of "
            f"{CUDA_HEAD_DIM_STEP} up to {CUDA_MAX_HEAD_DIM}"
        )


def _check(q, k, v, bias, num_heads: int) -> None:
    if q.dim() != 3:
        raise ValueError(f"q, k, v must be (B, N, H), got {tuple(q.shape)}")
    B, N, H = q.shape
    if num_heads <= 0 or H % num_heads:
        raise ValueError(f"hidden width {H} is not a multiple of num_heads={num_heads}")
    _check_common(q, k, v, bias, num_heads, H // num_heads, N)


def _check_headmajor(q, k, v, bias) -> None:
    if q.dim() != 4:
        raise ValueError(f"q, k, v must be (h, B, N, d), got {tuple(q.shape)}")
    h, B, N, d = q.shape
    if B == 0:
        raise ValueError("B must be at least 1")
    _check_common(q, k, v, bias, h, d, N)


def _launch(entry: str, q, k, v, bias, dims: tuple[int, int, int, int]) -> torch.Tensor:
    """Run the CUDA kernel through ``entry`` with its four int arguments;
    returns the output. A refused launch raises. The C entry picks the
    kernel by shape (``kernel_route``)."""
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel(entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), o.data_ptr(),
            *dims, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")
    return o


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, N, h·d) → a (h, B, N, d) view."""
    B, N, H = t.shape
    return t.view(B, N, h, H // h).permute(2, 0, 1, 3)


def _packed(t: torch.Tensor) -> torch.Tensor:
    """(h, B, N, d) → (B, N, h·d)."""
    h, B, N, d = t.shape
    return t.permute(1, 2, 0, 3).reshape(B, N, h * d)


# ---------------------------------------------------------------------------
# Plain PyTorch twins and their VJPs (head-major math; the packed ones are
# views of the same arithmetic)
# ---------------------------------------------------------------------------


def beit_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch twin of B3 (``attention.py:289-304``): (h, B, N, d)
    inputs, f32 scores and softmax, probabilities cast to the input type
    for the AV product, f32 accumulation, output in the input type."""
    d = q.shape[-1]
    s = q.float() @ k.float().transpose(-1, -2)
    s = s / math.sqrt(d) + bias.float()[:, None]
    p = torch.softmax(s, dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def beit_attention_backward(q, k, v, bias, grad_out):
    """(dq, dk, dv, dbias) of ``beit_attention_reference`` at (q, k, v,
    bias) for the cotangent ``grad_out``: the reference's custom-VJP
    backward (``attention.py:327-333``, ``jax.vjp`` of the einsum twin)
    written out. Scores and softmax are recomputed in f32; the cotangent of
    the cast probabilities is rounded to the input type as JAX's transpose
    of the AV product gives it; dq, dk, dv come back in the input type and
    dbias in f32.

    This is plain PyTorch on purpose and is no stand-in for the forward
    kernel: the JAX package has no backward Pallas kernel either."""
    d = q.shape[-1]
    qf, kf, vf, g = q.float(), k.float(), v.float(), grad_out.float()
    s = qf @ kf.transpose(-1, -2) / math.sqrt(d) + bias.float()[:, None]
    p = torch.softmax(s, dim=-1)
    pc = p.to(v.dtype).float()
    dv = pc.transpose(-1, -2) @ g
    dp = (g @ vf.transpose(-1, -2)).to(v.dtype).float()
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dbias = ds.sum(1)
    ds = ds / math.sqrt(d)
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias.to(bias.dtype)


def beit_attention_packed_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Plain PyTorch twin of B1 (``attention.py:225-247``) with the
    kernel's numerics: f32 scores and softmax, probabilities cast to the
    input type for the AV product, f32 accumulation, output in the input
    type."""
    h = num_heads
    return _packed(beit_attention_reference(_heads(q, h), _heads(k, h), _heads(v, h), bias))


def beit_attention_packed_backward(q, k, v, bias, num_heads: int, grad_out):
    """(dq, dk, dv, dbias) of ``beit_attention_packed_reference``: the
    reference's packed custom-VJP backward (``attention.py:273-281``), the
    head-major VJP of ``beit_attention_backward`` through the layouts.

    Plain PyTorch on purpose, no stand-in for the forward kernel (the JAX
    package computes this backward outside any Pallas kernel)."""
    h = num_heads
    dq, dk, dv, dbias = beit_attention_backward(
        _heads(q, h), _heads(k, h), _heads(v, h), bias, _heads(grad_out, h)
    )
    return _packed(dq), _packed(dk), _packed(dv), dbias


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------


# the launch counters are read-modify-writes that threads (the serving
# watcher's workers) can interleave: one lock per wrapper
_PACKED_COUNT_LOCK = threading.Lock()
_HEADMAJOR_COUNT_LOCK = threading.Lock()


class BeitAttentionPackedFn(torch.autograd.Function):
    """B1 under autograd: forward = the kernel (CUDA) or the twin (CPU),
    backward = ``beit_attention_packed_backward`` from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads: int):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, bias)
        if q.device.type == "cpu":
            with torch.no_grad():
                return beit_attention_packed_reference(q, k, v, bias, num_heads)
        B, N, H = q.shape
        o = _launch("beit_attention_packed_launch", q, k, v, bias, (B, N, H, num_heads))
        with _PACKED_COUNT_LOCK:
            beit_attention_packed.launches += 1
            beit_attention_packed.launches_by_kernel[kernel_route(q.dtype, N, H // num_heads)] += 1
        return o

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, bias = ctx.saved_tensors
        return (*beit_attention_packed_backward(q, k, v, bias, ctx.num_heads, grad_out), None)


class BeitAttentionFn(torch.autograd.Function):
    """B3 under autograd: forward = the kernel (CUDA) or the twin (CPU),
    backward = ``beit_attention_backward`` from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        if q.device.type == "cpu":
            with torch.no_grad():
                return beit_attention_reference(q, k, v, bias)
        h, B, N, d = q.shape
        o = _launch("beit_attention_headmajor_launch", q, k, v, bias, (h, B, N, d))
        with _HEADMAJOR_COUNT_LOCK:
            beit_attention.launches += 1
            beit_attention.launches_by_kernel[kernel_route(q.dtype, N, d)] += 1
        return o

    @staticmethod
    def backward(ctx, grad_out):
        return beit_attention_backward(*ctx.saved_tensors, grad_out)


def beit_attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """(B, N, h·d) packed fused attention (B1), differentiable in q, k, v
    and bias: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors. ``beit_attention_packed.launches`` counts forward kernel
    launches (the backward launches none), ``launches_by_kernel`` the same
    by the kernel the shape was routed to."""
    _check(q, k, v, bias, num_heads)
    return BeitAttentionPackedFn.apply(q, k, v, bias, num_heads)


def beit_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """(h, B, N, d) head-major fused attention (B3), differentiable in q,
    k, v and bias: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors. ``beit_attention.launches`` counts forward kernel launches,
    ``launches_by_kernel`` the same by kernel."""
    _check_headmajor(q, k, v, bias)
    return BeitAttentionFn.apply(q, k, v, bias)


beit_attention_packed.launches = 0
beit_attention.launches = 0
beit_attention_packed.launches_by_kernel = Counter()
beit_attention.launches_by_kernel = Counter()
