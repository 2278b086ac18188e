"""Image ops on tensors (port of ``tpu3dlm/ops/image.py``): bilinear
sampling and resize, the 4-point homography solve and the homography warp,
the letterbox, and crop rectification in its two forms.

For an axis-aligned box the reference's box→image homography is a
bilinear crop-resize with inclusive corner mapping. ``rectify_crops``
samples it by gathers (``_rectify_one`` per box); ``rectify_crops_mxu``
writes it as two interpolation-weight matmuls, ``crop = Wy · img · Wxᵀ``
(``_rectify_one_mxu`` per box), which is the form every caller of the port
takes. Both take the reference's (F, H, W, C) frames and (F, B, 4) boxes
and return (F, B, h, w, C); a caller with one frame per crop passes its
(K, H, W, C) frames with (K, 1, 4) boxes. None of these is a kernel in the
reference: here they are plain PyTorch on the device of their inputs, in
f32 (TF32 is off, ``device.set_numerics_policy``). The gathers clamp and
round as the reference does (``bilinear_sample``), which
``torch.nn.functional.grid_sample`` does not.
"""

from __future__ import annotations

import torch


def bilinear_sample(image: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Sample ``image`` (H, W, C) at float pixel coordinates ``xs``, ``ys``
    (...,), clamped to the edge; returns (..., C) in f32."""
    return _sample(image.to(torch.float32)[None], None, xs, ys)


def _sample(images: torch.Tensor, frame: torch.Tensor | None, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """``bilinear_sample`` of f32 ``images`` (F, H, W, C) at ``xs``, ``ys``
    in frame ``frame`` (an index that broadcasts against them; None: frame
    0)."""
    H, W = images.shape[1], images.shape[2]
    x = torch.clamp(xs, 0.0, W - 1.0)
    y = torch.clamp(ys, 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    f = torch.zeros((), dtype=torch.int64, device=images.device) if frame is None else frame
    v00 = images[f, y0, x0]
    v01 = images[f, y0, x1]
    v10 = images[f, y1, x0]
    v11 = images[f, y1, x1]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def resize_bilinear(image: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(H, W, C) → (h, w, C) bilinear resize (align-corners=False, as cv2)."""
    h, w = out_hw
    H, W = image.shape[0], image.shape[1]
    ys = (torch.arange(h, dtype=torch.float32, device=image.device) + 0.5) * (H / h) - 0.5
    xs = (torch.arange(w, dtype=torch.float32, device=image.device) + 0.5) * (W / w) - 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return bilinear_sample(image, xx, yy)


def solve_homography_4pt(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The homography of 4 point correspondences (DLT, one 8×8 solve).

    src, dst: (4, 2). Returns the 3×3 H with H[2, 2] = 1 that maps src to
    dst."""
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], dim=-1)
    A = torch.stack([r1, r2], dim=1).reshape(8, 8)
    b = torch.stack([u, v], dim=1).reshape(8)
    h = torch.linalg.solve(A, b)
    return torch.cat([h, torch.ones(1, dtype=h.dtype, device=h.device)]).reshape(3, 3)


def warp_homography(image: torch.Tensor, Hmat: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Inverse warp: the output pixel (u, v) is sampled at H⁻¹ (u, v, 1)."""
    h, w = out_hw
    Hinv = torch.linalg.inv(Hmat)
    us = torch.arange(w, dtype=torch.float32, device=image.device)
    vs = torch.arange(h, dtype=torch.float32, device=image.device)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    pts = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1) @ Hinv.T
    return bilinear_sample(image, pts[..., 0] / pts[..., 2], pts[..., 1] / pts[..., 2])


def _linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, 1.0, n)`` as JAX computes it: i / (n − 1), then
    the endpoint 1 exactly."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([t, torch.ones(1, dtype=torch.float32, device=device)])


def _rectify_grid(boxes: torch.Tensor, out_hw: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., h, w) sample coordinates of each box (..., 4), corners
    included."""
    h, w = out_hw
    vv, uu = torch.meshgrid(_linspace01(h, boxes.device), _linspace01(w, boxes.device), indexing="ij")
    b = boxes[..., None, None, :]
    return b[..., 0] + uu * (b[..., 2] - b[..., 0]), b[..., 1] + vv * (b[..., 3] - b[..., 1])


def _rectify_one(image: torch.Tensor, bbox: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """One box (4,) of ``image`` (H, W, C) rectified to (h, w, C): the
    reference's box→full-image homography in its axis-aligned case, a
    bilinear crop-resize with inclusive corner mapping."""
    xs, ys = _rectify_grid(bbox, out_hw)
    return bilinear_sample(image, xs, ys)


def letterbox(image: torch.Tensor, size: int, fill: float = 114.0):
    """Aspect-preserving resize and centred pad to (size, size), the
    ultralytics input convention. Returns (canvas (size, size, C), scale,
    (pad_x, pad_y))."""
    H, W = image.shape[0], image.shape[1]
    scale = min(size / H, size / W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    resized = resize_bilinear(image, (nh, nw))
    pad_y, pad_x = (size - nh) // 2, (size - nw) // 2
    canvas = torch.full((size, size, image.shape[2]), fill, dtype=resized.dtype, device=resized.device)
    canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
    return canvas, scale, (pad_x, pad_y)


def rectify_crops(
    images: torch.Tensor,  # (F, H, W, C)
    boxes: torch.Tensor,  # (F, B, 4) in image pixels
    out_hw: tuple[int, int] = (224, 224),
) -> torch.Tensor:
    """Every box of every frame → (F, B, h, w, C) rectified crops, sampled
    by gathers (``_rectify_one``)."""
    xs, ys = _rectify_grid(boxes, out_hw)  # (F, B, h, w)
    frame = torch.arange(images.shape[0], device=images.device)[:, None, None, None]
    return _sample(images.to(torch.float32), frame, xs, ys)


def _interp_matrix(lo: torch.Tensor, hi: torch.Tensor, n_out: int, n_in: int) -> torch.Tensor:
    """(..., n_out, n_in) linear-interpolation weights sampling [lo, hi]
    inclusive, for box edges ``lo``, ``hi`` of any shape (...): row o
    holds the hat-function weights of lo + o/(n_out − 1)·(hi − lo), at most
    two nonzeros."""
    o = torch.arange(n_out, dtype=torch.float32, device=lo.device) / max(n_out - 1, 1)
    src = torch.clamp(lo[..., None] + o * (hi - lo)[..., None], 0.0, n_in - 1.0)  # (..., n_out)
    i = torch.arange(n_in, dtype=torch.float32, device=lo.device)
    return torch.clamp(1.0 - torch.abs(src[..., None] - i), min=0.0)


def _rectify_one_mxu(image: torch.Tensor, bbox: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """One box (4,) of ``image`` (H, W, C) rectified to (h, w, C) as two
    matmuls, ``Wy · img · Wxᵀ``: ``_rectify_one``'s sample positions."""
    return rectify_crops_mxu(image[None], bbox[None, None], out_hw)[0, 0]


def rectify_crops_mxu(
    images: torch.Tensor,  # (F, H, W, C)
    boxes: torch.Tensor,  # (F, B, 4)
    out_hw: tuple[int, int] = (224, 224),
) -> torch.Tensor:
    """Every box of every frame → (F, B, h, w, C) rectified crops by the
    separable matmuls of ``_rectify_one_mxu``: one batched matmul down
    the rows of each frame for all its boxes, then one across the
    columns."""
    h, w = out_hw
    F, H, W, C = images.shape
    B = boxes.shape[1]
    Wy = _interp_matrix(boxes[..., 1], boxes[..., 3], h, H)  # (F, B, h, H)
    Wx = _interp_matrix(boxes[..., 0], boxes[..., 2], w, W)  # (F, B, w, W)
    tmp = torch.matmul(Wy.reshape(F, B * h, H), images.float().reshape(F, H, W * C)).reshape(F * B, h, W, C)
    out = torch.einsum("kpw,kowc->kopc", Wx.reshape(F * B, w, W), tmp)
    return out.reshape(F, B, h, w, C)
