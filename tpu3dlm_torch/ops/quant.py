"""Int8 post-training quantisation of the BEiT classifier (port of
``tpu3dlm/ops/quant.py``).

The JAX package's recipe, kept exactly: symmetric per-output-channel weight
scales computed offline, symmetric per-row activation scales computed in
the forward, an int8 × int8 → int32 product, and a dequantisation of the
int32 accumulator in f32, ``acc · x_scale · w_scale`` in that order.

The product is a library call on the card: ``torch._int_mm`` (cuBLASLt's
int8 GEMM), as XLA's ``dot_general`` is outside any Pallas kernel in the
reference. cuBLASLt wants more than 16 rows and K and N multiples of 8:
rows are padded with zeros (exact) and the result sliced; K or N off the
multiple of 8 raises rather than leave the int8 path. On CPU tensors the
product is the plain twin, an exact int32 matmul (|acc| ≤ K · 127² < 2³¹
for K ≤ 3072, BEiT-base's widest).
"""

from __future__ import annotations

import torch

_QMAX = 127.0
_EPS = 1e-12

launches = 0  # int8 GEMMs issued on the card since the last reset


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(in, out) float kernel → (int8 kernel, (out,) f32 scale).

    Symmetric per-output-channel: scale = amax(|w|, axis=in)/127; a dead
    column gets scale eps/127 so dequantisation stays finite."""
    w = w.to(torch.float32)
    amax = torch.clamp_min(w.abs().amax(dim=0), _EPS)
    scale = amax / _QMAX
    wq = torch.clamp(torch.round(w / scale), -_QMAX, _QMAX).to(torch.int8)
    return wq, scale


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., in) float activations → (int8, (..., 1) f32 per-row scale)."""
    xf = x.to(torch.float32)
    amax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), _EPS)
    scale = amax / _QMAX
    xq = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX).to(torch.int8)
    return xq, scale


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) → int32 (M, N), exact.

    CUDA tensors: ``torch._int_mm``, rows zero-padded to 17 when there are
    16 or fewer. CPU tensors: an int32 matmul (the plain twin)."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_product takes int8 operands, got {xq.dtype} and {wq.dtype}")
    if xq.device.type != "cuda":
        return xq.to(torch.int32) @ wq.to(torch.int32)
    global launches
    m, k = xq.shape
    n = wq.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"int8 GEMM on the card needs K and N multiples of 8, got K={k}, N={n}")
    if m <= 16:
        xq = torch.cat([xq, xq.new_zeros(17 - m, k)])
    launches += 1
    return torch._int_mm(xq.contiguous(), wq)[:m]


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """int8 (..., in) @ int8 (in, out) → f32 (..., out): the int32
    accumulator dequantised as ``acc · x_scale · w_scale``."""
    lead = xq.shape[:-1]
    acc = int8_product(xq.reshape(-1, xq.shape[-1]), wq).reshape(*lead, wq.shape[1])
    return acc.to(torch.float32) * x_scale * w_scale


def dense_int8(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
               bias: torch.Tensor | None = None, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Quantised Dense forward: per-row activation quantisation, the int8
    product, f32 dequantisation (+ f32 bias), cast to ``out_dtype`` (by
    default ``x``'s dtype)."""
    xq, xs = quantize_rows(x)
    y = int8_matmul(xq, wq, xs, w_scale)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype or x.dtype)
