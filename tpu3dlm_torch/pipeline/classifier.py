"""Damage classification stage of the staged route: batched BEiT over
rectified sign crops (port of ``tpu3dlm/pipeline/classifier.py``).

``classify_detections`` rescales each box from original pixels to the
stored frame, selects the valid (frame, box) pairs, and only those are
rectified (``ops.image.rectify_crops``, the batched form of the
reference's ``_rectify_one_mxu``) and classified, in fixed batches of
``batch_size`` (``utils.shapes.padded_batches``), so BEiT, and kernel B1 in
each of its layers, always sees one shape. Every valid detection is
classified: there is no crop budget on this route.

The rectified crops go to uint8 by ROUNDING, ``clip(round(crop·255), 0,
255)``, as the reference's staged route does: a source pixel of 181 comes
back from the /255 → ·255 round trip as 180.99998, which rounds to 181. The
fused route (``parallel/inference.py``) truncates, as the JAX fused route
does; the two lines are kept apart on purpose.

The scan's frames are uploaded to the device once and gathered there per
batch, where the reference uploads one frame per box; the outputs are the
same.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from tpu3dlm_torch.data.scan import Detections, Scan
from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.models.beit import BeitClassifier, BeitConfig, preprocess_crops, seeded_beit
from tpu3dlm_torch.ops.image import rectify_crops
from tpu3dlm_torch.utils.shapes import padded_batches


def crops_to_u8(crops: torch.Tensor) -> torch.Tensor:
    """Float crops in [0, 1] → uint8 by round half to even and clip: the
    staged route's conversion."""
    return torch.clamp(torch.round(crops * 255.0), 0, 255).to(torch.uint8)


class DamageDetector:
    """Batched BEiT damage classifier over detection crops on ``device``.

    ``beit`` is a port module (e.g. from ``models.weights.beit_from_flax``);
    without one a seeded model is built (random weights, with a warning).
    It is moved to ``device`` in ``dtype``."""

    def __init__(
        self,
        model_type: str = "simple",
        num_labels: int = 2,
        id2label: dict[int, str] | None = None,
        config: BeitConfig | None = None,
        beit: BeitClassifier | None = None,
        batch_size: int = 64,
        rng_seed: int = 0,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        if model_type not in ("simple", "detailed"):
            raise ValueError("Invalid model type. Choose either 'detailed' or 'simple'.")
        self.device = resolve_device(device)
        self.model_type = model_type
        self.config = config or BeitConfig(num_labels=num_labels)
        self.id2label = id2label or {i: f"class_{i}" for i in range(self.config.num_labels)}
        self.batch_size = batch_size
        self.logger = logging.getLogger(__name__)
        if beit is None:
            self.logger.warning(
                "DamageDetector initialised with random weights: convert a finetuned BEiT "
                "checkpoint via models/weights.py for real use."
            )
            beit = seeded_beit(self.config, torch.Generator().manual_seed(rng_seed))
        self.beit = beit.to(self.device, dtype).eval()

    def _classify(self, crops_u8: torch.Tensor) -> torch.Tensor:
        return self.beit(preprocess_crops(crops_u8)).argmax(dim=-1).to(torch.int32)

    @torch.inference_mode()
    def classify_crops(self, crops: np.ndarray) -> np.ndarray:
        """(N, S, S, 3) uint8 crops → (N,) int32 class ids."""
        out = np.zeros(crops.shape[0], np.int32)
        for (chunk,), start, n_valid in padded_batches([crops], self.batch_size):
            ids = self._classify(torch.as_tensor(chunk, device=self.device))
            out[start:start + n_valid] = ids[:n_valid].cpu().numpy()
        return out

    @torch.inference_mode()
    def classify_detections(self, scan: Scan, det: Detections) -> Detections:
        """Rectify each valid detection's crop and classify it; returns
        ``det`` with ``damage`` filled (-1 where the mask is off).

        Boxes are in original-image pixels; the stored frames are at
        detector resolution, so boxes are rescaled before cropping."""
        rgb_np = np.asarray(scan.rgb)
        F, S = rgb_np.shape[0], rgb_np.shape[1]
        wh = np.asarray(scan.rgb_size)
        boxes = np.asarray(det.boxes).copy()
        if scan.letterbox is not None:  # original px → letterboxed frame px
            lb = np.asarray(scan.letterbox)
            boxes[..., 0] = boxes[..., 0] * lb[:, 0][:, None] + lb[:, 1][:, None]
            boxes[..., 2] = boxes[..., 2] * lb[:, 0][:, None] + lb[:, 1][:, None]
            boxes[..., 1] = boxes[..., 1] * lb[:, 0][:, None] + lb[:, 2][:, None]
            boxes[..., 3] = boxes[..., 3] * lb[:, 0][:, None] + lb[:, 2][:, None]
        else:
            boxes[..., 0] *= (S / wh[:, 0])[:, None]
            boxes[..., 2] *= (S / wh[:, 0])[:, None]
            boxes[..., 1] *= (S / wh[:, 1])[:, None]
            boxes[..., 3] *= (S / wh[:, 1])[:, None]

        # select THEN rectify: only valid (frame, box) pairs are resampled
        mask = np.asarray(det.mask)
        mask_flat = mask.reshape(-1)
        damage_flat = np.full(mask_flat.shape[0], -1, np.int32)
        valid_idx = np.nonzero(mask_flat)[0]
        if valid_idx.size:
            frame_idx = valid_idx // mask.shape[1]
            boxes_sel = boxes.reshape(-1, 4)[valid_idx]
            frames = torch.as_tensor(rgb_np, device=self.device)
            size = (self.config.image_size, self.config.image_size)
            for (idx, fi, bsel), _start, n_valid in padded_batches(
                [valid_idx, frame_idx, boxes_sel], self.batch_size
            ):
                x = frames[torch.as_tensor(fi, device=self.device)].float() / 255.0
                crops = rectify_crops(x, torch.as_tensor(bsel, device=self.device), size)
                ids = self._classify(crops_to_u8(crops)).cpu().numpy()
                damage_flat[idx[:n_valid]] = ids[:n_valid]
        return dataclasses.replace(det, damage=damage_flat.reshape(F, -1))

    def get_class_label(self, class_idx):
        """id → lowercase label; a list maps element-wise."""
        if isinstance(class_idx, list):
            return [self._id2label(i) for i in class_idx]
        return self._id2label(class_idx)

    def _id2label(self, idx):
        return self.id2label[int(idx)].lower()
