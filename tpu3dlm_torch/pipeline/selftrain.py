"""The self-training loop (port of ``tpu3dlm/pipeline/selftrain.py``): the
port's own YOLOv10 and BEiT checkpoints from a scan with known ground truth.

The reference consumes checkpoints finetuned offline; the JAX package and
this port close that loop: the train steps of ``parallel/finetune.py`` over
the ground-truth boxes of a scan (e.g. the synthetic generator's
``gt.json``), written as Flax msgpack checkpoints that either package's
Pipeline loads through ``yolo_weights`` / ``beit_weights``.

Training starts from the reference's initialisation
(``models.layers.init_like_flax_``, drawn from ``seed``) or from given Flax
variables (``init``); the augmentation noise of step i is drawn from a
generator seeded ``seed + 1`` (per rank on a mesh: ``rank_seed``), or taken
from ``noise[i]`` (this rank's draw).

With a ``mesh`` (``parallel/mesh.py``; every rank calls with the same
arrays) training is data parallel as the reference's: frames pad with
zeros (empty ground truth, pure background) and crops by cycling the real
ones to a multiple of the world size, each rank trains on its block with
the gradients averaged, and rank 0 alone writes the checkpoints.

Usage (CLI):
    python -m tpu3dlm_torch.pipeline.selftrain --data-dir <scan folder> \\
        --out-dir <ckpt dir> [--img-size 96] [--yolo-steps 200] ... \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import copy
import logging
import os

import numpy as np
import torch

logger = logging.getLogger(__name__)


def scale_boxes_to_frame(boxes_px: np.ndarray, scan, frame_idx) -> np.ndarray:
    """(N, 4) original-pixel boxes of given frames → stored-frame pixels
    (handles both square-resize and letterbox scans)."""
    out = np.asarray(boxes_px, np.float32).copy()
    if scan.letterbox is not None:
        lb = np.asarray(scan.letterbox)[frame_idx]
        out[:, [0, 2]] = out[:, [0, 2]] * lb[:, 0:1] + lb[:, 1:2]
        out[:, [1, 3]] = out[:, [1, 3]] * lb[:, 0:1] + lb[:, 2:3]
    else:
        wh = np.asarray(scan.rgb_size)[frame_idx]
        S = float(np.shape(scan.rgb)[1])
        out[:, [0, 2]] *= (S / wh[:, 0:1])
        out[:, [1, 3]] *= (S / wh[:, 1:2])
    return out


def yolo_training_arrays(gt_boxes_2d: dict[int, list[list[float]]], scan, max_gt: int = 8):
    """Ground-truth records ([x1, y1, x2, y2, conf, label] in original
    pixels) → padded detector-space training arrays (images, boxes,
    labels, mask)."""
    F = scan.num_frames
    images = np.asarray(scan.rgb)
    boxes = np.zeros((F, max_gt, 4), np.float32)
    labels = np.zeros((F, max_gt), np.int32)
    mask = np.zeros((F, max_gt), bool)
    for f in range(F):
        recs = gt_boxes_2d.get(f, [])[:max_gt]
        if not recs:
            continue
        raw = np.asarray([r[:4] for r in recs], np.float32)
        scaled = scale_boxes_to_frame(raw, scan, np.full(len(recs), f))
        for b, rec in enumerate(recs):
            boxes[f, b] = scaled[b]
            labels[f, b] = int(rec[5])
            mask[f, b] = True
    return images, boxes, labels, mask


def beit_training_crops(gt_boxes_2d: dict[int, list[list[float]]], gt_damage_2d: dict[int, list[int]],
                        scan, size: int, device="cuda"):
    """Rectified uint8 crops of every ground-truth box on an in-range frame
    + damage labels: rectified in f32 on ``device``
    (``ops/image.rectify_crops``), then ``clip(x·255)`` and a truncating
    uint8 cast on the host, as the reference."""
    from tpu3dlm_torch.device import as_device_tensor, resolve_device
    from tpu3dlm_torch.ops.image import rectify_crops

    frames, flat_boxes, labels = [], [], []
    for f, recs in gt_boxes_2d.items():
        if not (0 <= f < scan.num_frames):
            continue  # load_scan truncates to min(paired frames, pose rows)
        dmg = gt_damage_2d.get(f, [0] * len(recs))
        for rec, d in zip(recs, dmg):
            frames.append(f)
            flat_boxes.append(rec[:4])
            labels.append(int(d))
    if not frames:
        return np.zeros((0, size, size, 3), np.uint8), np.zeros((0,), np.int32)
    dev = resolve_device(device)
    frame_idx = np.asarray(frames)
    boxes = scale_boxes_to_frame(np.asarray(flat_boxes, np.float32), scan, frame_idx)
    rgb_sel = np.asarray(scan.rgb)[frame_idx].astype(np.float32) / 255.0
    crops = rectify_crops(as_device_tensor(rgb_sel, dev), as_device_tensor(boxes, dev), (size, size))
    crops_u8 = np.clip(crops.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
    return crops_u8, np.asarray(labels, np.int32)


def _pad_batch(arrays, n: int):
    """Pad leading axis of each array to a multiple of n (zeros/False)."""
    out = []
    for x in arrays:
        extra = (-x.shape[0]) % n
        if extra:
            x = np.concatenate([x, np.zeros((extra,) + x.shape[1:], x.dtype)])
        out.append(x)
    return out


@torch.no_grad()
def evaluate_yolo_map(yolo, images_f32, gt_boxes: np.ndarray, gt_labels: np.ndarray, gt_mask: np.ndarray,
                      img_size: int, conf_thresh: float = 0.25, max_det: int = 32) -> dict:
    """Detection quality of a training checkpoint: eval-mode forward of
    ``yolo`` on ``images_f32`` (a tensor on its device) + the NMS-free
    postprocess → ``pipeline/metrics`` mAP against the padded gt arrays.
    Returns the DetectionMetrics dict."""
    from tpu3dlm_torch.models.yolov10 import postprocess
    from tpu3dlm_torch.pipeline.metrics import evaluate_detections

    was_training = yolo.training
    yolo.eval()
    out = postprocess(yolo(images_f32)["one2one_split"], img_size=img_size, max_det=max_det)
    yolo.train(was_training)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    preds: dict[int, list] = {}
    gts: dict[int, list] = {}
    for f in range(images_f32.shape[0]):
        keep = out["conf"][f] >= conf_thresh
        preds[f] = [[*out["boxes"][f, i].tolist(), float(out["conf"][f, i]), int(out["label"][f, i])]
                    for i in np.where(keep)[0]]
        gts[f] = [[*np.asarray(gt_boxes[f, b], float).tolist(), 1.0, int(gt_labels[f, b])]
                  for b in np.where(np.asarray(gt_mask[f]))[0]]
    return evaluate_detections(preds, gts).to_dict()


def _augment_kwargs(augment) -> dict | None:
    """``True`` and ``{}`` both mean the defaults; ``None``/``False`` off."""
    if augment is True:
        return {}
    if augment is None or augment is False:
        return None
    return dict(augment)


def _noise_at(noise, i: int):
    return None if noise is None else noise[i]


def rank_seed(seed: int, mesh) -> int:
    """The seed of a rank's noise generator: ``seed + 1`` on one device;
    on a mesh each rank draws its own stream, as the reference folds the
    rank into its key."""
    return seed + 1 if mesh is None else (seed + 1) * 1_000_003 + mesh.rank


def finetune_yolo(
    images_u8: np.ndarray,
    gt_boxes: np.ndarray,
    gt_labels: np.ndarray,
    gt_mask: np.ndarray,
    nc: int,
    img_size: int,
    steps: int = 200,
    lr: float = 2e-3,
    variant: str = "n",
    mesh=None,
    seed: int = 0,
    log_every: int = 50,
    augment: dict | bool | None = None,
    ema_decay: float | None = None,
    schedule: str = "const",
    warmup_frac: float = 0.1,
    val_every: int = 0,
    val_history: list | None = None,
    sample_batch: int | None = None,
    device="cuda",
    init: dict | None = None,
    noise=None,
):
    """Overfit/adapt YOLOv10 on (images, gt) → the trained ``YOLOv10``
    (eval mode, on ``device``).

    Options as the reference's: ``augment`` (``True`` or
    ``augment_detection_batch``'s options) augments each step on the device;
    ``ema_decay`` keeps an exponential moving average of the parameters and
    returns it (with the live model's BatchNorm statistics);
    ``schedule="cosine"`` warms up over ``warmup_frac`` of the steps, then
    decays to 5% of ``lr``; ``val_every=N`` scores eval-mode mAP50 /
    mAP50-95 on the training arrays every N steps (into ``val_history``);
    ``sample_batch`` trains each step on that many sampled frames.

    ``init`` (Flax variables) replaces the seeded initialisation; ``noise``
    (a sequence of ``draw_yolo_step_noise`` dicts, one per step) replaces
    the seeded draws. With a ``mesh`` (data parallel) the frames pad to a
    multiple of the world size and the model lives on the mesh's device."""
    from tpu3dlm_torch.device import resolve_device
    from tpu3dlm_torch.models.layers import init_like_flax_
    from tpu3dlm_torch.models.weights import yolov10_from_flax
    from tpu3dlm_torch.models.yolov10 import YOLOv10
    from tpu3dlm_torch.parallel.finetune import (
        adamw,
        ema_update,
        make_yolo_train_step,
        warmup_cosine_decay_schedule,
    )

    if schedule not in ("const", "cosine"):
        raise ValueError(f"unknown schedule {schedule!r} (const|cosine)")
    aug_kw = _augment_kwargs(augment)
    if noise is not None and aug_kw is None:
        raise ValueError("noise is given but augmentation is off")
    dev = mesh.device if mesh is not None else resolve_device(device)
    images_u8, gt_boxes, gt_labels, gt_mask = _pad_batch(
        [np.asarray(images_u8), np.asarray(gt_boxes), np.asarray(gt_labels), np.asarray(gt_mask)],
        1 if mesh is None else mesh.size)

    if init is None:
        yolo = init_like_flax_(YOLOv10(nc=nc, variant=variant), torch.Generator().manual_seed(seed))
    else:
        yolo = yolov10_from_flax(init, variant=variant, nc=nc)
    yolo.to(dev).train()
    opt = adamw(yolo.parameters(), lr)
    sched = None
    if schedule == "cosine":
        sched = warmup_cosine_decay_schedule(0.0, lr, max(int(steps * warmup_frac), 1), max(steps, 2),
                                             lr * 0.05)
    step = make_yolo_train_step(yolo, opt, mesh, img_size, augment=aug_kw, sample_batch=sample_batch,
                                device=dev, generator=torch.Generator().manual_seed(rank_seed(seed, mesh)))

    imgs = torch.from_numpy(images_u8.astype(np.float32) / 255.0).to(dev)
    gb, gl, gm = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (gt_boxes, gt_labels, gt_mask))
    ema = [p.detach().clone() for p in yolo.parameters()] if ema_decay else None
    for i in range(steps):
        if sched is not None:
            for group in opt.param_groups:
                group["lr"] = sched(i)
        loss = step(imgs, gb, gl, gm, noise=_noise_at(noise, i))
        if ema is not None:
            ema_update(ema, yolo.parameters(), ema_decay)
        if log_every and (i % log_every == 0 or i == steps - 1):
            logger.info("yolo finetune step %d: loss=%.4f", i, float(loss))
        if val_every and (i % val_every == 0 or i == steps - 1):
            scored = yolo
            if ema is not None:
                scored = copy.deepcopy(yolo)
                _load_params(scored, ema)
            m = evaluate_yolo_map(scored, imgs, gt_boxes, gt_labels, gt_mask, img_size)
            logger.info("yolo finetune step %d: mAP50=%.3f mAP50-95=%.3f", i, m["map50"], m["map50_95"])
            if val_history is not None:
                val_history.append({"step": i, **m})
    if ema is not None:
        _load_params(yolo, ema)
    return yolo.eval()


@torch.no_grad()
def _load_params(module: torch.nn.Module, values: list) -> None:
    for p, v in zip(module.parameters(), values, strict=True):
        p.copy_(v)


def finetune_beit(
    crops_u8: np.ndarray,
    labels: np.ndarray,
    config,
    steps: int = 80,
    lr: float = 1e-3,
    mesh=None,
    seed: int = 0,
    log_every: int = 20,
    augment: dict | bool | None = None,
    device="cuda",
    init: dict | None = None,
    noise=None,
):
    """Finetune the BEiT damage classifier on labelled crops → the trained
    ``BeitClassifier`` (eval mode, on ``device``). ``augment`` (``True`` or
    ``augment_crop_batch``'s options) augments each step's crops on the
    device. ``init``, ``noise`` and ``mesh`` as ``finetune_yolo``'s
    (``noise[i]``: a ``draw_crop_noise`` dict); on a mesh the crops pad by
    cycling."""
    from tpu3dlm_torch.models.beit import BeitClassifier
    from tpu3dlm_torch.models.layers import init_like_flax_
    from tpu3dlm_torch.models.weights import beit_from_flax
    from tpu3dlm_torch.parallel.finetune import init_finetune, make_beit_train_step

    if len(labels) == 0:
        # an empty batch makes the mean loss NaN and would write a NaN
        # checkpoint: fail loudly instead
        raise ValueError("finetune_beit: no labelled crops (ground truth has no 2D boxes on any in-range frame)")
    aug_kw = _augment_kwargs(augment)
    if noise is not None and aug_kw is None:
        raise ValueError("noise is given but augmentation is off")
    n_dev = 1 if mesh is None else mesh.size
    # pad by cycling the real crops up to a device multiple, as the
    # reference (keeps every padded slot on-distribution)
    idx = np.arange(-(-max(len(labels), n_dev) // n_dev) * n_dev) % len(labels)
    crops_u8 = np.asarray(crops_u8)[idx]
    labels = np.asarray(labels)[idx]

    if init is None:
        beit = init_like_flax_(BeitClassifier(config), torch.Generator().manual_seed(seed))
    else:
        beit = beit_from_flax(init, config)
    beit.train()
    opt = init_finetune(beit, lr=lr, device=device if mesh is None else mesh.device)
    step = make_beit_train_step(beit, opt, mesh, augment=aug_kw, device=device,
                                generator=torch.Generator().manual_seed(rank_seed(seed, mesh)))
    dev = next(beit.parameters()).device
    c = torch.from_numpy(np.ascontiguousarray(crops_u8)).to(dev)
    y = torch.from_numpy(np.ascontiguousarray(labels)).to(dev)
    for i in range(steps):
        loss = step(c, y, noise=_noise_at(noise, i))
        if log_every and (i % log_every == 0 or i == steps - 1):
            logger.info("beit finetune step %d: loss=%.4f", i, float(loss))
    return beit.eval()


def finetune_synthetic(
    data_dir: str,
    out_dir: str,
    img_size: int = 96,
    yolo_steps: int = 200,
    yolo_lr: float = 2e-3,
    beit_steps: int = 80,
    beit_lr: float = 1e-3,
    beit_config=None,
    variant: str = "n",
    nc: int = 2,
    mesh=None,
    resize_mode: str = "square",
    device="cuda",
) -> tuple[str, str]:
    """Train both models from a scan folder's ``gt.json`` on ``device``
    (data parallel over a ``mesh``); write Flax msgpack checkpoints
    (``yolo.msgpack``, ``beit.msgpack``) into ``out_dir``, on rank 0 alone
    under a mesh. Returns their paths."""
    from tpu3dlm_torch.data.dataset import load_scan
    from tpu3dlm_torch.data.synthetic import load_scene_gt
    from tpu3dlm_torch.models.beit import BeitConfig
    from tpu3dlm_torch.models.checkpoint import write_flax_msgpack
    from tpu3dlm_torch.models.weights import beit_to_flax, yolov10_to_flax

    gt = load_scene_gt(os.path.join(data_dir, "gt.json"))
    base = os.path.join(data_dir, "rtabmap_extract")
    scan = load_scan(
        image_dir=os.path.join(base, "data_rgb"),
        depth_image_dir=os.path.join(base, "data_depth"),
        calibration_dir=os.path.join(base, "calibration"),
        pose_path=os.path.join(data_dir, "poses.txt"),
        img_size=img_size,
        resize_mode=resize_mode,
    )
    images, boxes, labels, mask = yolo_training_arrays(gt["gt_boxes_2d"], scan)
    yolo = finetune_yolo(images, boxes, labels, mask, nc=nc, img_size=img_size, steps=yolo_steps,
                         lr=yolo_lr, variant=variant, mesh=mesh, device=device)

    beit_config = beit_config or BeitConfig(num_labels=2)
    crops, dmg = beit_training_crops(gt["gt_boxes_2d"], gt["gt_damage_2d"], scan, beit_config.image_size,
                                     device=device)
    beit = finetune_beit(crops, dmg, beit_config, steps=beit_steps, lr=beit_lr, mesh=mesh, device=device)

    yolo_path = os.path.join(out_dir, "yolo.msgpack")
    beit_path = os.path.join(out_dir, "beit.msgpack")
    if mesh is None or mesh.rank == 0:
        os.makedirs(out_dir, exist_ok=True)
        write_flax_msgpack(yolo_path, yolov10_to_flax(yolo))
        write_flax_msgpack(beit_path, beit_to_flax(beit))
        logger.info("checkpoints written: %s %s", yolo_path, beit_path)
    if mesh is not None:
        mesh.barrier()  # the files exist on every rank's return
    return yolo_path, beit_path


def main(argv=None) -> None:
    import argparse

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Finetune YOLOv10 and BEiT on a scan folder's gt.json.")
    p.add_argument("--data-dir", required=True, help="scan folder with gt.json")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--img-size", type=int, default=96)
    p.add_argument("--yolo-steps", type=int, default=200)
    p.add_argument("--yolo-lr", type=float, default=2e-3)
    p.add_argument("--beit-steps", type=int, default=80)
    p.add_argument("--beit-lr", type=float, default=1e-3)
    p.add_argument("--variant", default="n")
    p.add_argument("--nc", type=int, default=2)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    finetune_synthetic(
        args.data_dir, args.out_dir, img_size=args.img_size, yolo_steps=args.yolo_steps,
        yolo_lr=args.yolo_lr, beit_steps=args.beit_steps, beit_lr=args.beit_lr,
        variant=args.variant, nc=args.nc, device=args.device,
    )


if __name__ == "__main__":
    main()
