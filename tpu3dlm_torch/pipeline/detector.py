"""Detection stage of the staged route: batched YOLOv10 over a Scan →
padded Detections (port of ``tpu3dlm/pipeline/detector.py``).

The frames go to the device one fixed-size batch of ``batch_size`` at a
time (``utils.shapes.padded_batches``), through the YOLOv10 forward and the
NMS-free one-to-one postprocess (top ``max_det`` boxes, no IoU
suppression; ``iou_thresh`` is accepted for the config and ignored, as in
the reference). Boxes come back to the host and are mapped from detector
pixels to original pixels, inverse letterbox or square resize, and clipped
to the frame, in float32 numpy exactly as the reference does.

With ``save_img`` (``view_img = true``) each frame is written to that
directory as ``image_<f>.png``: the stored (detector-square) frame with
every valid box drawn as cv2's 2-px rectangle would draw it and its class
name above it (``utils/annotate.py``; a bitmap font in place of cv2's
Hershey glyphs), in the class's colour from the reference's seeded table.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from tpu3dlm_torch.data.scan import Detections, Scan, to_numpy
from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.models.layers import init_seeded_
from tpu3dlm_torch.models.yolov10 import YOLOv10
from tpu3dlm_torch.parallel.inference import detect as yolo_detect
from tpu3dlm_torch.utils.shapes import padded_batches


class ObjectDetector:
    """Runs YOLOv10 over a Scan's RGB frames on ``device``.

    ``yolo`` is a port module (e.g. from ``models.weights.
    yolov10_from_flax``); without one a seeded model is built (random
    weights, with a warning). It is moved to ``device`` in ``dtype``."""

    def __init__(
        self,
        conf_thresh: float = 0.25,
        iou_thresh: float = 0.7,  # accepted for the config; the one-to-one head needs no NMS
        img_size: int = 640,
        batch_size: int = 16,
        max_det: int = 64,
        nc: int = 80,
        variant: str = "n",
        yolo: YOLOv10 | None = None,
        rng_seed: int = 0,
        dtype: torch.dtype = torch.float32,
        save_img: str | None = None,  # directory of the annotated frames
        names: dict[int, str] | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.save_img = save_img
        self.names = names or {i: f"class_{i}" for i in range(nc)}
        rng = np.random.default_rng(0)
        self.colors = {i: tuple(int(c) for c in rng.integers(0, 255, 3)) for i in range(nc)}
        self.conf_thresh = conf_thresh
        self.iou_thresh = iou_thresh
        self.img_size = img_size
        self.batch_size = batch_size
        self.max_det = max_det
        self.logger = logging.getLogger(__name__)
        if yolo is None:
            self.logger.warning(
                "ObjectDetector initialised with random weights: convert a finetuned "
                "checkpoint via models/weights.py for real use."
            )
            yolo = init_seeded_(YOLOv10(nc=nc, variant=variant), torch.Generator().manual_seed(rng_seed))
        self.yolo = yolo.to(self.device, dtype).to(memory_format=torch.channels_last).eval()

    def __call__(self, scan: Scan) -> Detections:
        return self.detect(scan)

    @torch.inference_mode()
    def detect(self, scan: Scan) -> Detections:
        """Scan → Detections with boxes in ORIGINAL image pixels."""
        rgb = np.asarray(scan.rgb)
        F = rgb.shape[0]
        if F == 0:
            return Detections(
                boxes=np.zeros((0, self.max_det, 4), np.float32),
                conf=np.zeros((0, self.max_det), np.float32),
                label=np.zeros((0, self.max_det), np.int32),
                damage=np.full((0, self.max_det), -1, np.int32),
                mask=np.zeros((0, self.max_det), bool),
            )
        outs = []
        for (chunk,), _start, n_valid in padded_batches([rgb], self.batch_size):
            x = torch.as_tensor(chunk, device=self.device).float() / 255.0
            res = yolo_detect(self.yolo, x, self.img_size, self.max_det)
            outs.append({k: to_numpy(v)[:n_valid] for k, v in res.items()})
        boxes = np.concatenate([o["boxes"] for o in outs])
        conf = np.concatenate([o["conf"] for o in outs])
        label = np.concatenate([o["label"] for o in outs])

        # detector space (img_size × img_size) → original pixels
        wh = np.asarray(scan.rgb_size)  # (F, 2)
        if scan.letterbox is not None:
            lb = np.asarray(scan.letterbox)  # (F, 3) scale, pad_x, pad_y
            s, px, py = lb[:, 0][:, None], lb[:, 1][:, None], lb[:, 2][:, None]
            boxes = np.stack(
                [(boxes[..., 0] - px) / s, (boxes[..., 1] - py) / s,
                 (boxes[..., 2] - px) / s, (boxes[..., 3] - py) / s],
                axis=-1,
            )
        else:
            sx = (wh[:, 0] / self.img_size)[:, None]
            sy = (wh[:, 1] / self.img_size)[:, None]
            boxes = np.stack(
                [boxes[..., 0] * sx, boxes[..., 1] * sy, boxes[..., 2] * sx, boxes[..., 3] * sy],
                axis=-1,
            )
        boxes[..., [0, 2]] = np.clip(boxes[..., [0, 2]], 0, wh[:, None, 0:1])
        boxes[..., [1, 3]] = np.clip(boxes[..., [1, 3]], 0, wh[:, None, 1:2])
        det = Detections(
            boxes=boxes.astype(np.float32),
            conf=conf.astype(np.float32),
            label=label.astype(np.int32),
            damage=np.full(conf.shape, -1, np.int32),
            mask=conf >= self.conf_thresh,
        )
        if self.save_img:
            self._save_annotated(scan, det)
        return det

    def _save_annotated(self, scan: Scan, det: Detections) -> None:
        """Each stored frame with its valid boxes and class names drawn,
        written to ``save_img/image_<f>.png``; boxes go from original pixels
        back to the stored frame's, as the reference maps them."""
        from tpu3dlm_torch.data.codecs import write_png
        from tpu3dlm_torch.utils.annotate import draw_box, draw_label

        os.makedirs(self.save_img, exist_ok=True)
        rgb = np.asarray(scan.rgb)
        S = rgb.shape[1]
        wh = np.asarray(scan.rgb_size)
        for f in range(rgb.shape[0]):
            img = np.ascontiguousarray(rgb[f][..., ::-1])  # BGR, cv2's layout
            for b in range(det.boxes.shape[1]):
                if not det.mask[f, b]:
                    continue
                if scan.letterbox is not None:
                    s, px, py = np.asarray(scan.letterbox)[f]
                    x1, y1, x2, y2 = det.boxes[f, b] * s + [px, py, px, py]
                else:
                    sx, sy = S / wh[f, 0], S / wh[f, 1]
                    x1, y1, x2, y2 = det.boxes[f, b] * [sx, sy, sx, sy]
                lab = int(det.label[f, b])
                color = self.colors.get(lab, (0, 255, 0))
                draw_box(img, (int(x1), int(y1)), (int(x2), int(y2)), color)
                draw_label(img, self.names.get(lab, str(lab)), (int(x1), max(int(y1) - 6, 10)), color)
            write_png(os.path.join(self.save_img, f"image_{f}.png"), img)
