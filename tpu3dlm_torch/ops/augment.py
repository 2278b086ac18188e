"""In-step augmentation for finetuning (port of ``tpu3dlm/ops/augment.py``).

The reference draws its noise from JAX PRNG keys inside the jitted step.
JAX's streams cannot be reproduced in PyTorch, so every random op is split
in two:

* a draw (``draw_detection_noise``, ``draw_crop_noise``): the outputs of
  the reference's random calls, as a dict of tensors, taken on the CPU
  from an explicit ``torch.Generator`` (so a seed gives the same noise on
  every device);
* an apply (``hflip``, ``color_jitter``, ``crop_zoom``, ``erase_one``,
  ``erase``, and the batch functions), deterministic given that dict.

A test can rebuild the reference's draws from its key and feed them to the
apply; the batch functions draw only when no ``noise`` is given.

Detection noise, per image (F,): ``flip`` (bool), ``brightness``,
``contrast``, ``zoom`` (bool), ``zoom_scale``, ``zoom_x``, ``zoom_y`` (the
window's offsets as uniforms in [0, 1)), and with erasing (F, count):
``erase`` (bool), ``erase_w``, ``erase_h`` (fractions of the side),
``erase_x``, ``erase_y`` (uniforms) and ``erase_color`` (F, count, 3).
Crop noise, per crop (N,): ``gain`` (already exponentiated), ``offset``,
``flip``, ``erase`` and the erase patch's ``erase_w`` … ``erase_color``.

All ops keep static shapes: boxes that leave the view after a crop are
masked, never dropped. Images are float32 NHWC in [0, 1]; boxes (F, B, 4)
xyxy in stored-frame pixels, as ``pipeline/selftrain.yolo_training_arrays``
gives them. The crop-zoom resample is ``ops/image.rectify_crops_mxu``.
"""

from __future__ import annotations

import math

import torch

from tpu3dlm_torch.ops.image import rectify_crops_mxu

# the reference's defaults (tpu3dlm/ops/augment.py:176-241)
DETECTION_DEFAULTS = dict(hflip_p=0.5, brightness=0.2, contrast=0.2, zoom_p=0.5, zoom_min=0.7,
                          erase_p=0.0, erase_count=2, erase_max=0.35)
CROP_DEFAULTS = dict(gain_lo=0.4, gain_hi=1.8, offset=25.0, hflip_p=0.5, erase_p=0.5, erase_max=0.45)


def _uniform(shape, lo: float, hi: float, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator) * (hi - lo) + lo


def _bernoulli(shape, p: float, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator) < p


def _draw_erase(shape: tuple, max_frac: float, generator: torch.Generator) -> dict:
    return {
        "erase_w": _uniform(shape, 0.08, max_frac, generator),
        "erase_h": _uniform(shape, 0.08, max_frac, generator),
        "erase_x": torch.rand(shape, generator=generator),
        "erase_y": torch.rand(shape, generator=generator),
        "erase_color": torch.rand(shape + (3,), generator=generator),
    }


def draw_detection_noise(n: int, generator: torch.Generator, **kw) -> dict:
    """The noise of ``augment_detection_batch`` for ``n`` images, drawn on
    the CPU; ``kw`` as the batch function's."""
    unknown = set(kw) - set(DETECTION_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown detection augmentation options {sorted(unknown)}")
    o = {**DETECTION_DEFAULTS, **kw}
    noise = {
        "flip": _bernoulli((n,), o["hflip_p"], generator),
        "brightness": _uniform((n,), -o["brightness"], o["brightness"], generator),
        "contrast": _uniform((n,), 1.0 - o["contrast"], 1.0 + o["contrast"], generator),
        "zoom": _bernoulli((n,), o["zoom_p"], generator),
        "zoom_scale": _uniform((n,), o["zoom_min"], 1.0, generator),
        "zoom_x": torch.rand((n,), generator=generator),
        "zoom_y": torch.rand((n,), generator=generator),
    }
    if o["erase_p"] > 0.0:
        shape = (n, o["erase_count"])
        noise["erase"] = _bernoulli(shape, o["erase_p"], generator)
        noise.update(_draw_erase(shape, o["erase_max"], generator))
    return noise


def draw_crop_noise(n: int, generator: torch.Generator, **kw) -> dict:
    """The noise of ``augment_crop_batch`` for ``n`` crops, drawn on the
    CPU; ``kw`` as the batch function's. The gain is drawn log-uniform and
    stored exponentiated."""
    unknown = set(kw) - set(CROP_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown crop augmentation options {sorted(unknown)}")
    o = {**CROP_DEFAULTS, **kw}
    log_gain = _uniform((n,), math.log(o["gain_lo"]), math.log(o["gain_hi"]), generator)
    return {
        "gain": torch.exp(log_gain),
        "offset": _uniform((n,), -o["offset"], o["offset"], generator),
        "flip": _bernoulli((n,), o["hflip_p"], generator),
        "erase": _bernoulli((n,), o["erase_p"], generator),
        **_draw_erase((n,), o["erase_max"], generator),
    }


def _per_image(t: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    return t.reshape(t.shape + (1,) * (ndim - t.dim()))


def hflip(images: torch.Tensor, boxes: torch.Tensor, flip: torch.Tensor):
    """Horizontal flip of the images where ``flip``; their boxes mirror in
    x over the coordinate span S − 1."""
    S = images.shape[2]
    x1, y1, x2, y2 = boxes.unbind(-1)
    flipped_boxes = torch.stack([(S - 1.0) - x2, y1, (S - 1.0) - x1, y2], -1)
    return (torch.where(_per_image(flip), images.flip(2), images),
            torch.where(flip[:, None, None], flipped_boxes, boxes))


def color_jitter(images: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor) -> torch.Tensor:
    """Brightness shift, then contrast scale about each image's mean,
    clipped to [0, 1]."""
    m = _per_image(images.mean(dim=(1, 2, 3)))
    return torch.clamp((images + _per_image(brightness) - m) * _per_image(contrast) + m, 0.0, 1.0)


def crop_zoom(images, boxes, mask, zoom, zoom_scale, zoom_x, zoom_y):
    """Resample a sub-window back to full size where ``zoom``, map the
    boxes analytically and mask the boxes that left the view (visible
    extent under 2 px). The window lives in the rectifier's
    inclusive-corner space (span S − 1), so the un-zoomed images are the
    inputs bit for bit."""
    S = images.shape[1]
    span = S - 1.0
    z = torch.where(zoom, zoom_scale, torch.ones((), device=zoom_scale.device))
    we = z * span
    ox = zoom_x * (span - we)
    oy = zoom_y * (span - we)
    window = torch.stack([ox, oy, ox + we, oy + we], -1)
    zoomed = rectify_crops_mxu(images, window[:, None], (S, S))[:, 0]
    images = torch.where(_per_image(zoom), zoomed, images)

    scale = (span / torch.clamp(we, min=1e-6))[:, None]
    o = torch.stack([ox, oy, ox, oy], -1)[:, None, :]
    clipped = torch.clamp((boxes - o) * scale[..., None], 0.0, span)
    visible = ((clipped[..., 2] - clipped[..., 0]) >= 2.0) & ((clipped[..., 3] - clipped[..., 1]) >= 2.0)
    boxes = torch.where(zoom[:, None, None], clipped, boxes)
    mask = torch.where(zoom[:, None], mask & visible, mask)
    return images, boxes, mask


def erase_one(images, erase_w, erase_h, erase_x, erase_y, erase_color) -> torch.Tensor:
    """One uniformly coloured rectangle on each image (boxes untouched):
    side fractions ``erase_w``/``erase_h`` of S, its corner at
    (``erase_x``·(S − w), ``erase_y``·(S − h))."""
    S = images.shape[1]
    w = _per_image(erase_w * S)
    h = _per_image(erase_h * S)
    x0 = _per_image(erase_x) * (S - w)
    y0 = _per_image(erase_y) * (S - h)
    ar = torch.arange(S, dtype=torch.float32, device=images.device)
    xs = ar[None, None, :, None]
    ys = ar[None, :, None, None]
    inside = (xs >= x0) & (xs < x0 + w) & (ys >= y0) & (ys < y0 + h)
    return torch.where(inside, erase_color[:, None, None, :], images)


def erase(images, do, erase_w, erase_h, erase_x, erase_y, erase_color) -> torch.Tensor:
    """Up to ``do.shape[1]`` patches per image, each applied where its
    flag in ``do`` (the noise's ``erase``) is set, in order."""
    for i in range(do.shape[1]):
        patched = erase_one(images, erase_w[:, i], erase_h[:, i], erase_x[:, i], erase_y[:, i],
                            erase_color[:, i])
        images = torch.where(_per_image(do[:, i]), patched, images)
    return images


def _on(noise: dict, device: torch.device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in noise.items()}


def _erase_args(noise: dict) -> list:
    return [noise[k] for k in ("erase_w", "erase_h", "erase_x", "erase_y", "erase_color")]


def augment_detection_batch(images, boxes, mask, noise: dict | None = None,
                            generator: torch.Generator | None = None, **kw):
    """Per-image flip, colour jitter, crop-zoom and (with ``erase_p`` > 0)
    random erasing, as the reference's ``augment_detection_batch``.
    ``images`` (F, S, S, 3) float32 in [0, 1], ``boxes`` (F, B, 4), ``mask``
    (F, B) bool, all on one device. ``noise`` from ``draw_detection_noise``
    (drawn here from ``generator`` when absent; ``kw`` are the draw's
    options). Returns (images, boxes, mask) of the same shapes."""
    if noise is None:
        if generator is None:
            raise ValueError("augment_detection_batch needs noise or a generator")
        noise = draw_detection_noise(images.shape[0], generator, **kw)
    n = _on(noise, images.device)
    images, boxes = hflip(images, boxes, n["flip"])
    images = color_jitter(images, n["brightness"], n["contrast"])
    images, boxes, mask = crop_zoom(images, boxes, mask, n["zoom"], n["zoom_scale"], n["zoom_x"],
                                    n["zoom_y"])
    if "erase" in n:
        images = erase(images, n["erase"], *_erase_args(n))
    return images, boxes, mask


def augment_crop_batch(crops_u8: torch.Tensor, noise: dict | None = None,
                       generator: torch.Generator | None = None, **kw) -> torch.Tensor:
    """Classifier-crop augmentation, as the reference's
    ``augment_crop_batch``: per crop an exposure gain and offset (clipped to
    [0, 255]), a horizontal flip and one erase patch. uint8 (N, S, S, 3) in,
    uint8 out (rounded half to even, as ``jnp.round``)."""
    if noise is None:
        if generator is None:
            raise ValueError("augment_crop_batch needs noise or a generator")
        noise = draw_crop_noise(crops_u8.shape[0], generator, **kw)
    n = _on(noise, crops_u8.device)
    x = crops_u8.float() * _per_image(n["gain"]) + _per_image(n["offset"])
    x = torch.clamp(x, 0.0, 255.0)
    x = torch.where(_per_image(n["flip"]), x.flip(2), x)
    x01 = erase_one(x / 255.0, *_erase_args(n)) * 255.0
    x = torch.where(_per_image(n["erase"]), x01, x)
    return torch.round(x).to(torch.uint8)
