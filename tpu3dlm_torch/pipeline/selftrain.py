"""Box scaling of the finetuning driver (port of the part of
``tpu3dlm/pipeline/selftrain.py`` that the evaluation needs).

``scale_boxes_to_frame`` maps ground-truth boxes in original pixels onto a
scan's stored frames; the hard eval's crop-occlusion axis paints its
patches through it. The finetuning driver itself (``finetune_yolo``,
``finetune_beit`` and their data) is not ported yet (ROADMAP A19).
"""

from __future__ import annotations

import numpy as np


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
