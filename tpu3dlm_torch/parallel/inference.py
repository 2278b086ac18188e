"""The fused scan step: detect → rectify → classify → project in one call
(port of ``tpu3dlm/parallel/inference.py``: ``full_scan_step_fn`` on one
device, ``sharded_full_scan_step`` over a world of ranks).

Stages, all on one device with no host round trip between them:
YOLOv10 forward and NMS-free postprocess; boxes mapped back to original
pixels through the inverse letterbox/resize affine and clipped; the global
top-``crop_budget`` boxes by confidence rectified to the classifier's input
and classified by BEiT (attention through kernel B1); damage scattered back
with -1 for unselected or below-threshold slots; boxes projected to world
quads with the 16×16 sampled depth median.

Sharded over a world (``mesh``), frames split contiguously over the ranks
and each rank detects, rectifies and projects its own. The crop selection
stays global: the ranks gather every candidate confidence, and the
rank-major gather is the single-device flat index, so each rank takes the
same top ``crop_budget`` and classifies (kernel B1) the selected crops in
its own frames. A crop's logits do not depend on its batch, so the damage
equals the single-device step's. The outputs are gathered to every rank
in frame order.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dlm_torch.device import as_device_tensor, module_device, resolve_device
from tpu3dlm_torch.mapper.projection import project_boxes
from tpu3dlm_torch.models.beit import BeitClassifier, preprocess_crops
from tpu3dlm_torch.models.yolov10 import YOLOv10, postprocess, topk_stable
from tpu3dlm_torch.ops.image import rectify_crops_mxu
from tpu3dlm_torch.parallel.mesh import Mesh, shard_batch


def detect(yolo: YOLOv10, x: torch.Tensor, img_size: int, max_det: int) -> dict:
    """(F, S, S, 3) float32 frames in [0, 1] → postprocessed detections in
    detector pixels (boxes (F, D, 4), conf (F, D), label (F, D))."""
    return postprocess(yolo(x)["one2one_split"], img_size=img_size, max_det=max_det)


def boxes_to_original(boxes_sq, box_affine, rgb_size):
    """Detector-pixel boxes → (original-pixel boxes clipped to the frame,
    the clipped boxes mapped back to detector pixels). ``box_affine`` (F, 4)
    is [sx, sy, px, py] with x_det = x·sx + px."""
    sx, sy, px, py = (box_affine[:, None, i] for i in range(4))
    w = rgb_size[:, None, 0]
    h = rgb_size[:, None, 1]
    zero = torch.zeros((), dtype=boxes_sq.dtype, device=boxes_sq.device)
    clip = lambda t, hi: torch.minimum(torch.maximum(t, zero), hi)  # noqa: E731
    boxes_px = torch.stack(
        [
            clip((boxes_sq[..., 0] - px) / sx, w),
            clip((boxes_sq[..., 1] - py) / sy, h),
            clip((boxes_sq[..., 2] - px) / sx, w),
            clip((boxes_sq[..., 3] - py) / sy, h),
        ],
        -1,
    )
    boxes_rect = torch.stack(
        [
            boxes_px[..., 0] * sx + px,
            boxes_px[..., 1] * sy + py,
            boxes_px[..., 2] * sx + px,
            boxes_px[..., 3] * sy + py,
        ],
        -1,
    )
    return boxes_px, boxes_rect


def classify_top_crops(
    beit: BeitClassifier,
    x: torch.Tensor,  # (F, S, S, 3) float32 frames in [0, 1]
    boxes_rect: torch.Tensor,  # (F, D, 4) detector pixels
    conf: torch.Tensor,  # (F, D)
    mask: torch.Tensor,  # (F, D) conf ≥ thresh
    conf_thresh: float,
    crop_budget: int,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """Classify the global top-``crop_budget`` boxes by confidence →
    (F, D) int32 damage, -1 where not selected or below threshold. With a
    ``mesh`` the inputs are this rank's frames and the top k is taken over
    every rank's boxes; this rank classifies the selected ones among its
    own (possibly none)."""
    F, D = conf.shape
    size = beit.cfg.image_size
    flat_conf = torch.where(mask, conf, torch.full_like(conf, -1.0)).reshape(F * D)
    if mesh is not None:
        flat_conf = mesh.all_gather(flat_conf)  # rank-major: the single-device flat index
    top_conf, top_idx = topk_stable(flat_conf, min(crop_budget, flat_conf.shape[0]))
    if mesh is not None:
        top_idx = top_idx - mesh.rank * F * D
        mine = (top_idx >= 0) & (top_idx < F * D)
        top_conf, top_idx = top_conf[mine], top_idx[mine]
    damage = torch.full((F * D,), -1, dtype=torch.int32, device=conf.device)
    if top_idx.numel():
        sel_boxes = boxes_rect.reshape(F * D, 4)[top_idx]
        crops = rectify_crops_mxu(x[top_idx // D], sel_boxes[:, None], (size, size))[:, 0]
        sel = (crops * 255.0).to(torch.uint8)  # the reference's u8 round trip
        ids = beit(preprocess_crops(sel)).argmax(dim=-1).to(torch.int32)
        damage[top_idx] = torch.where(top_conf >= conf_thresh, ids, torch.full_like(ids, -1))
    return damage.reshape(F, D)


@torch.inference_mode()
def full_scan_step(
    yolo: YOLOv10,
    beit: BeitClassifier,
    rgb_u8,  # (F, S, S, 3) uint8
    depth,  # (F, Hd, Wd) float32 mm
    intrinsics,  # (F, 4)
    rgb_size,  # (F, 2) original width, height
    poses,  # (F, 7)
    box_affine,  # (F, 4) [sx, sy, px, py]
    img_size: int,
    max_det: int,
    conf_thresh: float,
    crop_budget: int = 128,
    device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
) -> dict[str, torch.Tensor]:
    """One fused step over a frame batch on ``device``. Inputs may be numpy
    (uploaded) or tensors already on ``device``; both models must live
    there. Returns device tensors: boxes (F, D, 4) original pixels, conf,
    label, damage, mask (box valid AND valid median depth), corners
    (F, D, 4, 3) world metres. With a ``mesh`` the inputs are this rank's
    frames (the same count on every rank) and the outputs every rank's, in
    rank order (``sharded_full_scan_step`` shards a whole batch)."""
    dev = resolve_device(device)
    for name, m in (("yolo", yolo), ("beit", beit)):
        if module_device(m) != dev:
            raise ValueError(f"{name} weights are on {module_device(m)}, the step runs on {dev}")
    # uploads and constants never wait for the device, so a stream of
    # chunks (FusedScanRunner.run_stream) decodes the next chunk while this
    # one runs
    rgb_u8 = as_device_tensor(rgb_u8, dev)
    depth, intrinsics, rgb_size, poses, box_affine = (
        as_device_tensor(a, dev, torch.float32)
        for a in (depth, intrinsics, rgb_size, poses, box_affine)
    )

    x = rgb_u8.float() / 255.0
    det = detect(yolo, x, img_size, max_det)
    mask = det["conf"] >= conf_thresh
    boxes_px, boxes_rect = boxes_to_original(det["boxes"], box_affine, rgb_size)
    damage = classify_top_crops(beit, x, boxes_rect, det["conf"], mask, conf_thresh, crop_budget, mesh)
    corners, valid = project_boxes(
        boxes_px, mask, depth, intrinsics, rgb_size, poses, median_samples=16
    )
    out = {
        "boxes": boxes_px,
        "conf": det["conf"],
        "label": det["label"],
        "damage": damage,
        "mask": valid,
        "corners": corners,
    }
    if mesh is not None:
        out = {k: mesh.all_gather(v) for k, v in out.items()}
    return out


def sharded_full_scan_step(
    mesh: Mesh,
    yolo: YOLOv10,
    beit: BeitClassifier,
    rgb_u8, depth, intrinsics, rgb_size, poses, box_affine,
    img_size: int,
    max_det: int = 32,
    conf_thresh: float = 0.25,
    crop_budget: int = 128,
) -> dict[str, torch.Tensor]:
    """``full_scan_step`` with the frame axis sharded over the world: every
    rank passes the whole batch (numpy or tensors on its device; the world
    size must divide the frame count, ``parallel.mesh.pad_to_devices``
    pads), uploads only its contiguous block of frames, runs the step on
    it with the models on ``mesh.device``, and gets every frame's outputs
    on its device, equal to the single-device step's."""
    local = shard_batch((rgb_u8, depth, intrinsics, rgb_size, poses, box_affine), mesh)
    return full_scan_step(yolo, beit, *local, img_size=img_size, max_det=max_det, conf_thresh=conf_thresh,
                          crop_budget=crop_budget, device=mesh.device, mesh=mesh)


def square_box_affine(rgb_size, img_size: int) -> np.ndarray:
    """(F, 2) original w/h → (F, 4) [sx, sy, 0, 0] square-resize affine."""
    wh = np.asarray(rgb_size, np.float32)
    z = np.zeros(len(wh), np.float32)
    return np.stack([img_size / wh[:, 0], img_size / wh[:, 1], z, z], axis=-1)
