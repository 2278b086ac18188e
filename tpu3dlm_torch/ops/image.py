"""Crop rectification (port of the separable resample in
``tpu3dlm/ops/image.py``).

For an axis-aligned box the reference's box→image homography is a
bilinear crop-resize with inclusive corner mapping. Written as two
interpolation-weight matmuls, ``crop = Wy · img · Wxᵀ``, batched over
crops. The JAX package runs this outside any kernel too; here it is plain
batched matmuls in f32 (TF32 is off, ``device.set_numerics_policy``).
"""

from __future__ import annotations

import torch


def _interp_matrix(lo: torch.Tensor, hi: torch.Tensor, n_out: int, n_in: int) -> torch.Tensor:
    """(K,) box edges → (K, n_out, n_in) linear-interpolation weights
    sampling [lo, hi] inclusive (hat functions, two nonzeros per row)."""
    o = torch.arange(n_out, dtype=torch.float32, device=lo.device) / max(n_out - 1, 1)
    src = torch.clamp(lo[:, None] + o * (hi - lo)[:, None], 0.0, n_in - 1.0)  # (K, n_out)
    i = torch.arange(n_in, dtype=torch.float32, device=lo.device)
    return torch.clamp(1.0 - torch.abs(src[..., None] - i), min=0.0)


def rectify_crops(
    images: torch.Tensor,  # (K, H, W, C) float32, one source frame per crop
    boxes: torch.Tensor,  # (K, 4) x1, y1, x2, y2 in image pixels
    out_hw: tuple[int, int] = (224, 224),
) -> torch.Tensor:
    """(K, h, w, C) crops; the batched form of the reference's
    ``_rectify_one_mxu``."""
    h, w = out_hw
    K, H, W, C = images.shape
    Wy = _interp_matrix(boxes[:, 1], boxes[:, 3], h, H)  # (K, h, H)
    Wx = _interp_matrix(boxes[:, 0], boxes[:, 2], w, W)  # (K, w, W)
    tmp = torch.bmm(Wy, images.float().reshape(K, H, W * C)).reshape(K, h, W, C)
    return torch.einsum("kpw,kowc->kopc", Wx, tmp)
