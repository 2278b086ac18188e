"""Finetuning steps on one device (port of ``tpu3dlm/parallel/finetune.py``):
the BEiT classifier's (``init_finetune``, ``make_beit_train_step``) and the
YOLOv10 detector's (``make_yolo_train_step``), the parameter EMA
(``ema_update``) and optax's warmup + cosine schedule.

The BEiT step is the reference's: ``loss = mean(cross_entropy(model(
preprocess_crops(crops_u8)), labels))`` (optax's
``softmax_cross_entropy_with_integer_labels`` then ``.mean()``), its
gradient through the whole BEiT — attention included: kernel B1 is a
``torch.autograd.Function`` whose backward recomputes the reference's VJP —
and one AdamW update with optax ``adamw``'s settings. On one device the
reference's ``pmean`` of loss and gradients is the identity.

The port keeps PyTorch's stateful form instead of the functional
``(params, opt_state, crops, labels) → (params, opt_state, loss)``: the
module holds the parameters, the optimizer its moments, and
``train_step(crops_u8, labels)`` updates both in place and returns the
loss. After a step every parameter's ``.grad`` holds that step's gradient.

The YOLO step runs the model in train mode (Flax's BatchNorm statistics,
the one-to-one head on detached features), ``models/yolo_loss.py::
yolov10_loss`` and one AdamW update; the BatchNorm running statistics are
updated by the forward, as the reference's mutated ``batch_stats``.

With ``augment`` (the options of ``ops/augment.py``'s batch function,
``{}`` for its defaults) a step augments its batch on the device first.
Its noise is an argument (``step(..., noise=...)``), drawn from the
step's ``generator`` when absent: JAX's PRNG streams cannot be matched,
so the tests feed both packages the reference's draws. With
``sample_batch`` the YOLO step trains on that many frames of the corpus,
sampled without replacement (the noise's ``batch_idx``).

A schedule is the caller's: set each parameter group's ``lr`` before the
step (``warmup_cosine_decay_schedule`` gives optax's values). As optax,
``torch.optim.AdamW`` scales the weight decay by that rate too.

Data parallel over a ``mesh`` (``parallel/mesh.py``), the reference's
``shard_map`` with ``pmean``: every rank builds the step over its own copy
of the module, whose parameters and buffers are first broadcast from rank
0, and passes the whole batch to each step; the step takes the rank's
contiguous block of it, runs the forward and backward there, and averages
the gradients and the loss over the ranks (a sum, then a division by the
world size, as ``pmean``) before the update, so the ranks stay identical.
The YOLO step averages the BatchNorm running statistics the same way: each
rank's train-mode forward updates them with its own batch statistics, then
they are averaged (the reference's ``pmean`` of the mutated
``batch_stats``, not a synchronised BatchNorm). Noise is drawn per rank,
as the reference folds the rank into its key: ``noise`` is this rank's
draw for its own block of the batch, and ``sample_batch`` draws
``sample_batch // world size`` of the rank's frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tpu3dlm_torch.device import as_device_tensor, resolve_device
from tpu3dlm_torch.models.beit import BeitClassifier, preprocess_crops
from tpu3dlm_torch.ops.augment import (
    augment_crop_batch,
    augment_detection_batch,
    draw_crop_noise,
    draw_detection_noise,
)
from tpu3dlm_torch.parallel.mesh import Mesh, replicate, shard_batch

# optax.adamw's defaults besides the learning rate; its weight decay (1e-4)
# is not torch's (1e-2), and optax decays every parameter (mask=None)
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def adamw(params, lr: float) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` set as optax ``adamw(lr)``. The two rules are
    one: torch scales p by (1 − lr·wd) before the Adam step, optax adds
    wd·p to the Adam direction before scaling by −lr; both give
    p − lr·(m̂/(√v̂ + eps) + wd·p)."""
    return torch.optim.AdamW(
        params, lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY
    )


def init_finetune(
    beit: BeitClassifier, lr: float = 1e-4, device: str | torch.device = "cuda"
) -> torch.optim.AdamW:
    """Move ``beit`` (its weights as they are: seeded, or carried from Flax
    by ``models.weights.beit_from_flax``) to ``device`` in place and return
    its optimizer. The reference's ``init_finetune`` also initialises the
    parameters; a port module is initialised when it is built."""
    beit.to(resolve_device(device))
    return adamw(beit.parameters(), lr)


def beit_loss(beit: BeitClassifier, crops_u8: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's ``loss_fn``: mean softmax cross-entropy of the
    logits of the preprocessed uint8 crops against integer labels."""
    logits = beit(preprocess_crops(crops_u8))
    return F.cross_entropy(logits.float(), labels.long())


def _step_device(module: torch.nn.Module, mesh: Mesh | None, device) -> torch.device:
    """The step's device (the mesh's on a mesh), where ``module`` must
    already be; on a mesh, rank 0's parameters and buffers are broadcast."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    devices = {p.device for p in module.parameters()}
    if len(devices) > 1:
        raise ValueError(f"parameters on {len(devices)} devices: a step runs on one device (a rank)")
    if devices != {dev}:
        raise ValueError(f"the module is on {devices.pop()}, the step on {dev}; move it first")
    if mesh is not None:
        replicate(module, mesh)
    return dev


@torch.no_grad()
def pmean_(mesh: Mesh, tensors: list) -> None:
    """Each tensor (all of one dtype) replaced, in place, by its mean over
    the ranks: one ``all_reduce`` of them all packed in one buffer, a
    division by the world size, and one multi-tensor copy back."""
    flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
    flat /= mesh.size
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(parts, tensors)])


def _grads(module: torch.nn.Module) -> list:
    return [p.grad for p in module.parameters() if p.grad is not None]


def _generator(generator: torch.Generator | None) -> torch.Generator:
    if generator is None:
        raise ValueError("an augmenting step needs its noise or a generator to draw it from")
    return generator


def make_beit_train_step(
    beit: BeitClassifier,
    optimizer: torch.optim.Optimizer,
    mesh=None,
    augment: dict | None = None,
    device: str | torch.device = "cuda",
    generator: torch.Generator | None = None,
):
    """Returns ``train_step(crops_u8, labels, noise=None) → loss``: one
    forward, backward and optimizer update of ``beit`` on ``device`` (where
    the module must already be, see ``init_finetune``). ``crops_u8`` is
    (B, S, S, 3) uint8 and ``labels`` (B,) integer, numpy or tensors on
    ``device``; the loss comes back as a 0-d f32 tensor on ``device``.

    With ``augment`` (``ops/augment.py::augment_crop_batch``'s options,
    ``{}`` for its defaults) the crops are augmented on the device first,
    with ``noise`` (``draw_crop_noise``'s dict) or, when it is absent, noise
    drawn from ``generator``.

    On a ``mesh`` (data parallel, the module docstring) each step takes the
    rank's block of the batch, whose length the world size must divide;
    ``noise`` covers that block and the loss is the mean over the ranks."""
    dev = _step_device(beit, mesh, device)

    def train_step(crops_u8, labels, noise: dict | None = None) -> torch.Tensor:
        if mesh is not None:
            crops_u8, labels = shard_batch((crops_u8, labels), mesh)
        crops = as_device_tensor(crops_u8, dev)
        if crops.dtype != torch.uint8:
            raise ValueError(f"crops must be uint8, got {crops.dtype}")
        if augment is not None:
            if noise is None:
                noise = draw_crop_noise(crops.shape[0], _generator(generator), **augment)
            crops = augment_crop_batch(crops, noise=noise)
        optimizer.zero_grad(set_to_none=True)
        loss = beit_loss(beit, crops, as_device_tensor(labels, dev))
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            pmean_(mesh, _grads(beit) + [loss])
        optimizer.step()
        return loss

    return train_step


def draw_yolo_step_noise(n_frames: int, generator: torch.Generator, augment: dict,
                         sample_batch: int | None = None) -> dict:
    """One YOLO step's noise, on the CPU: ``batch_idx`` (``sample_batch``
    frames of ``n_frames``, without replacement) when sampling, and the
    detection noise of the batch."""
    noise = {}
    if sample_batch is not None:
        if sample_batch > n_frames:
            raise ValueError(f"sample_batch {sample_batch} > {n_frames} frames (sampling without replacement)")
        noise["batch_idx"] = torch.randperm(n_frames, generator=generator)[:sample_batch]
        n_frames = sample_batch
    noise.update(draw_detection_noise(n_frames, generator, **augment))
    return noise


def make_yolo_train_step(
    yolo,
    optimizer: torch.optim.Optimizer,
    mesh=None,
    img_size: int = 640,
    augment: dict | None = None,
    sample_batch: int | None = None,
    device: str | torch.device = "cuda",
    generator: torch.Generator | None = None,
):
    """Detection finetune step (the YOLOv10 dual-assignment loss).

    Returns ``train_step(images, gt_boxes, gt_labels, gt_mask, noise=None,
    aux=None) → loss``: ``images`` (F, S, S, 3) float32 in [0, 1],
    ``gt_boxes`` (F, G, 4) xyxy px, ``gt_labels`` (F, G), ``gt_mask``
    (F, G) bool, numpy or tensors on ``device``. One train-mode forward of
    ``yolo`` (which updates its BatchNorm running statistics), the loss, its
    gradient (left in ``.grad``) and one ``optimizer`` step.

    With ``augment`` (``augment_detection_batch``'s options) the batch is
    augmented on the device first, with ``noise`` (``draw_yolo_step_noise``'s
    dict) or noise drawn from ``generator``; ``sample_batch`` (needs
    ``augment``, as in the reference) trains each step on that many sampled
    frames. ``aux``, when given, receives the step's (augmented) images,
    boxes and mask and each head's foreground mask.

    On a ``mesh`` each step takes the rank's block of the frames (the world
    size must divide their count), ``noise`` is the rank's draw for it
    (``sample_batch // world size`` of its frames when sampling), and the
    loss, the gradients and the BatchNorm running statistics are averaged
    over the ranks."""
    if sample_batch is not None and augment is None:
        raise ValueError("sample_batch requires augment (the step needs a key)")
    from tpu3dlm_torch.models.yolo_loss import yolov10_loss

    dev = _step_device(yolo, mesh, device)
    local_sample = sample_batch
    if mesh is not None and sample_batch is not None:
        local_sample = max(1, sample_batch // mesh.size)

    def train_step(images, gt_boxes, gt_labels, gt_mask, noise: dict | None = None,
                   aux: dict | None = None) -> torch.Tensor:
        if mesh is not None:
            images, gt_boxes, gt_labels, gt_mask = shard_batch((images, gt_boxes, gt_labels, gt_mask), mesh)
        images = as_device_tensor(images, dev, torch.float32)
        gt_boxes = as_device_tensor(gt_boxes, dev, torch.float32)
        gt_labels = as_device_tensor(gt_labels, dev)
        gt_mask = as_device_tensor(gt_mask, dev, torch.bool)
        if augment is not None:
            if noise is None:
                noise = draw_yolo_step_noise(images.shape[0], _generator(generator), augment, local_sample)
            if sample_batch is not None:
                idx = noise["batch_idx"].to(dev, non_blocking=True)
                images, gt_boxes, gt_labels, gt_mask = images[idx], gt_boxes[idx], gt_labels[idx], gt_mask[idx]
            det = {k: v for k, v in noise.items() if k != "batch_idx"}
            images, gt_boxes, gt_mask = augment_detection_batch(images, gt_boxes, gt_mask, noise=det)
        yolo.train()
        optimizer.zero_grad(set_to_none=True)
        loss = yolov10_loss(yolo(images), gt_boxes, gt_labels, gt_mask, img_size, aux=aux)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:  # the BatchNorm running statistics with the gradients
            pmean_(mesh, _grads(yolo) + [loss] + [b for b in yolo.buffers() if b.is_floating_point()])
        optimizer.step()
        if aux is not None:
            aux.update(images=images, boxes=gt_boxes, mask=gt_mask)
        return loss

    return train_step


@torch.no_grad()
def ema_update(ema_params: list, params, decay: float) -> list:
    """One exponential-moving-average step, in place: ``e ← e·decay +
    p·(1 − decay)`` for each pair, with ``decay`` and ``1 − decay`` in f32 as
    the reference's traced ``decay``, and rounded as XLA compiles it: one
    fused multiply-add of ``e·decay`` onto the rounded ``p·(1 − decay)``
    (emulated in f64, where the product of two f32 is exact). Parameters
    only: BatchNorm statistics come from the live model. Returns
    ``ema_params``."""
    d = torch.tensor(decay, dtype=torch.float32)
    one_minus = 1.0 - d
    for e, p in zip(ema_params, params, strict=True):
        scaled = (p.detach().to(e.dtype) * one_minus.to(e.device)).double()
        e.copy_((e.double() * d.double().to(e.device) + scaled).to(e.dtype))
    return ema_params


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0, exponent: float = 1.0):
    """optax's ``warmup_cosine_decay_schedule``: ``count → lr``, linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine decay
    to ``end_value`` at ``decay_steps`` (warmup included). Evaluated in f32
    step by step as optax's jitted schedule, so the rates are optax's to
    f32 rounding. ``count`` is the number of updates made before."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"the cosine part needs positive decay_steps - warmup_steps, got {cos_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps)))
        decayed = f32(1 - alpha) * cosine ** f32(exponent) + f32(alpha)
        return float(f32(peak_value) * decayed)

    return schedule
