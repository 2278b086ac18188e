"""`Scan` and `Detections` — the port's data model (port of
``tpu3dlm/data/scan.py``).

Plain dataclasses with the reference's fields and conventions: depth in
millimetres, pose rows ``[tx, ty, tz, qx, qy, qz, qw]``, detections padded
to a static box count with a validity mask. Fields hold numpy arrays on the
host (what ingestion produces and what the runner returns); tensors are
accepted and read back with ``to_numpy``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


def to_numpy(x) -> np.ndarray:
    """Tensor (any device) or array-like → numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class Scan:
    """One RGB-D capture: frames, depths, calibration, trajectory."""

    rgb: Any  # (F, S, S, 3) uint8 — frames resized to the detector square
    depth: Any  # (F, Hd, Wd) float32, millimetres
    intrinsics: Any  # (F, 4) float32 — fx, fy, cx, cy at RGB resolution
    rgb_size: Any  # (F, 2) float32 — width, height of the original RGB frames
    poses: Any  # (F, 7) float32 — tx, ty, tz, qx, qy, qz, qw
    timestamps: Any = None  # (F,) float64 seconds, optional
    letterbox: Any = None  # (F, 3) float32 [scale, pad_x, pad_y] or None

    @property
    def num_frames(self) -> int:
        return int(np.shape(self.depth)[0])

    @property
    def depth_hw(self) -> tuple[int, int]:
        return int(np.shape(self.depth)[1]), int(np.shape(self.depth)[2])


@dataclasses.dataclass
class Detections:
    """Padded per-frame 2D detections; boxes[f, b] means something only
    where mask[f, b]."""

    boxes: Any  # (F, B, 4) float32 — x1, y1, x2, y2 in RGB pixels
    conf: Any  # (F, B) float32
    label: Any  # (F, B) int32
    damage: Any  # (F, B) int32 — damage class, -1 = unset
    mask: Any  # (F, B) bool

    def to_frame_dict(self) -> dict[int, list[list[float]]]:
        """{frame: [[x1, y1, x2, y2, damage, conf, label], ...]} — the
        reference's prediction record shape."""
        boxes, conf, label, damage, mask = (
            to_numpy(a)
            for a in (self.boxes, self.conf, self.label, self.damage, self.mask)
        )
        out: dict[int, list[list[float]]] = {}
        for f in range(boxes.shape[0]):
            rows = []
            for b in range(boxes.shape[1]):
                if mask[f, b]:
                    x1, y1, x2, y2 = (float(v) for v in boxes[f, b])
                    rows.append(
                        [x1, y1, x2, y2, int(damage[f, b]), float(conf[f, b]),
                         int(label[f, b])]
                    )
            out[f] = rows
        return out


def detections_from_frame_dict(
    predictions: dict[int, list[list[float]]],
    num_frames: int,
    max_boxes: int | None = None,
) -> Detections:
    """Padded Detections from the reference-shaped prediction dict (7-field
    records, or 6-field pre-classification records with damage -1)."""
    counts = [len(predictions.get(f, [])) for f in range(num_frames)]
    B = max_boxes if max_boxes is not None else max(1, max(counts, default=1))
    boxes = np.zeros((num_frames, B, 4), np.float32)
    conf = np.zeros((num_frames, B), np.float32)
    label = np.zeros((num_frames, B), np.int32)
    damage = np.full((num_frames, B), -1, np.int32)
    mask = np.zeros((num_frames, B), bool)
    for f in range(num_frames):
        for b, rec in enumerate(predictions.get(f, [])[:B]):
            if len(rec) == 7:
                x1, y1, x2, y2, dmg, c, lab = rec
            else:
                x1, y1, x2, y2, c, lab = rec
                dmg = -1
            boxes[f, b] = [x1, y1, x2, y2]
            conf[f, b] = c
            label[f, b] = int(lab)
            damage[f, b] = int(dmg)
            mask[f, b] = True
    return Detections(boxes=boxes, conf=conf, label=label, damage=damage, mask=mask)
