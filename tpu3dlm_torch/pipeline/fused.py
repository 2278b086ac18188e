"""Fused scan inference: `FusedScanRunner(...)(scan)` → (Detections,
GlobalBoxes) (port of ``tpu3dlm/pipeline/fused.py``).

The runner holds a YOLOv10 and a BEiT on its device, pads the scan's frame
axis to a bucket with inert frames exactly as the reference does, runs
``parallel.inference.full_scan_step`` on the whole scan and returns host
records trimmed to the real frames. ``run_stream`` runs the same step over
a stream of fixed-shape chunks (``data.dataset.iter_scan_chunks``) with at
most ``max_inflight`` chunks on the device.

With ``mesh_devices = n > 1`` the runner joins the running world of n
ranks (``parallel/mesh.py::make_mesh``; each rank builds its own runner
over the same scan) and its models are broadcast from rank 0. Each call
pads the frames with inert zero frames to a multiple of n
(``pad_to_devices``), runs ``parallel.inference.sharded_full_scan_step``
(each rank its block of frames, the crop selection global) and trims
the padding in ``_finalize``; every rank gets every frame's records.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from tpu3dlm_torch.data.scan import Detections, Scan, to_numpy
from tpu3dlm_torch.device import resolve_device
from tpu3dlm_torch.mapper.projection import GlobalBoxes
from tpu3dlm_torch.models.beit import BeitClassifier, BeitConfig, seeded_beit
from tpu3dlm_torch.models.layers import init_seeded_
from tpu3dlm_torch.models.yolov10 import YOLOv10
from tpu3dlm_torch.parallel.inference import full_scan_step, sharded_full_scan_step, square_box_affine
from tpu3dlm_torch.parallel.mesh import make_mesh, pad_to_devices, replicate
from tpu3dlm_torch.utils.shapes import next_bucket, pad_axis0, pad_poses


def _pad_scan_frames(scan: Scan) -> Scan:
    """Pad every frame-axis field to the next bucket with inert frames:
    zero RGB and depth, identity intrinsics/size/letterbox scale (no
    division by zero in the affine inverse), identity-quaternion poses."""
    F = scan.num_frames
    Fb = next_bucket(F, min_bucket=4, quarter_from=4)
    if Fb == F:
        return scan
    letterbox = scan.letterbox
    if letterbox is not None:
        letterbox = pad_axis0(letterbox, Fb)
        letterbox[F:, 0] = 1.0
    return dataclasses.replace(
        scan,
        rgb=pad_axis0(scan.rgb, Fb),
        depth=pad_axis0(scan.depth, Fb),
        intrinsics=pad_axis0(scan.intrinsics, Fb, fill=1),
        rgb_size=pad_axis0(scan.rgb_size, Fb, fill=1),
        poses=pad_poses(scan.poses, Fb),
        letterbox=letterbox,
        timestamps=None if scan.timestamps is None else pad_axis0(scan.timestamps, Fb),
    )


class FusedScanRunner:
    """Whole-scan fused inference on one device, or sharded over the world
    of ``mesh_devices`` ranks (each on its own device of ``device``'s type).

    ``yolo`` / ``beit`` are port modules (e.g. from ``models.weights.
    yolov10_from_flax``); when absent they are built from ``rng_seed`` with
    a seeded ``torch.Generator``. Both are moved to ``device`` in ``dtype``
    (bf16 by default, the serving type; float32 for parity runs).
    """

    def __init__(
        self,
        img_size: int = 640,
        conf_thresh: float = 0.25,
        max_det: int = 64,
        nc: int = 80,
        variant: str = "n",
        beit_config: BeitConfig | None = None,
        yolo: YOLOv10 | None = None,
        beit: BeitClassifier | None = None,
        mesh_devices: int = 1,
        rng_seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        crop_budget: int = 128,
        device: str | torch.device = "cuda",
    ):
        self.mesh = make_mesh(mesh_devices, device=device) if mesh_devices > 1 else None
        self.device = self.mesh.device if self.mesh is not None else resolve_device(device)
        self.img_size = img_size
        self.conf_thresh = conf_thresh
        self.max_det = max_det
        self.crop_budget = crop_budget
        if yolo is None:
            yolo = init_seeded_(YOLOv10(nc=nc, variant=variant), torch.Generator().manual_seed(rng_seed))
        if beit is None:
            beit = seeded_beit(beit_config, torch.Generator().manual_seed(rng_seed + 1))
        self.yolo = yolo.to(self.device, dtype).to(memory_format=torch.channels_last).eval()
        self.beit = beit.to(self.device, dtype).eval()
        if self.mesh is not None:
            replicate(self.yolo, self.mesh)
            replicate(self.beit, self.mesh)

    def _dispatch(self, scan: Scan) -> dict[str, torch.Tensor]:
        """Run the fused step on one scan; returns device tensors."""
        if scan.letterbox is not None:
            lb = np.asarray(scan.letterbox, np.float32)  # (F, 3) s, px, py
            affine = np.stack([lb[:, 0], lb[:, 0], lb[:, 1], lb[:, 2]], axis=-1)
        else:
            affine = square_box_affine(scan.rgb_size, self.img_size)
        args = (
            np.asarray(scan.rgb), np.asarray(scan.depth, np.float32),
            np.asarray(scan.intrinsics, np.float32), np.asarray(scan.rgb_size, np.float32),
            np.asarray(scan.poses, np.float32), affine,
        )
        kw = dict(img_size=self.img_size, max_det=self.max_det, conf_thresh=self.conf_thresh,
                  crop_budget=self.crop_budget)
        if self.mesh is not None:
            # zero frames are inert (no box clears conf_thresh); _finalize trims them
            args, _ = pad_to_devices(args, self.mesh)
            return sharded_full_scan_step(self.mesh, self.yolo, self.beit, *args, **kw)
        return full_scan_step(self.yolo, self.beit, *args, device=self.device, **kw)

    def _finalize(self, out: dict, n_frames: int) -> tuple[Detections, GlobalBoxes]:
        """Device outputs → host records of the first ``n_frames`` frames."""
        out = {k: to_numpy(v)[:n_frames] for k, v in out.items()}
        det = Detections(
            boxes=out["boxes"].astype(np.float32),
            conf=out["conf"].astype(np.float32),
            label=out["label"].astype(np.int32),
            damage=np.where(out["mask"], out["damage"], -1).astype(np.int32),
            mask=out["mask"] & (out["conf"] >= self.conf_thresh),
        )
        gboxes = GlobalBoxes(
            corners=out["corners"], damage=det.damage, conf=det.conf,
            label=det.label, mask=det.mask,
        )
        return det, gboxes

    def __call__(self, scan: Scan) -> tuple[Detections, GlobalBoxes]:
        return self._finalize(self._dispatch(_pad_scan_frames(scan)), scan.num_frames)

    def run_stream(self, chunks, max_inflight: int = 2) -> tuple[Detections, GlobalBoxes]:
        """Run a stream of fixed-shape ``(Scan, valid)`` chunks (see
        ``data.dataset.iter_scan_chunks``); returns the Detections and
        GlobalBoxes of all real frames, concatenated in order.

        The oldest pending chunk is drained to the host before the next one
        is dispatched, so at most ``max_inflight`` chunks hold device
        buffers and memory stays O(chunk_frames · max_inflight) whatever
        the capture's length; kernels run asynchronously, so the host
        decodes chunk i+1 while the device runs chunk i.
        ``self.stream_peak_inflight`` records the high-water mark. An empty
        stream raises ``ValueError``.

        ``crop_budget`` applies per chunk: k = min(crop_budget,
        chunk_frames · max_det) crops are classified per chunk, where the
        whole-scan call selects the global top k across all frames. The two
        agree exactly whenever the budget does not bind (at most
        crop_budget above-threshold boxes per chunk); when it binds,
        streaming classifies at least as many crops as whole-scan.
        """
        pending: deque = deque()
        dets: list[Detections] = []
        gbs: list[GlobalBoxes] = []
        self.stream_peak_inflight = 0

        def drain_one():
            out, valid = pending.popleft()
            det, gb = self._finalize(out, valid)
            dets.append(det)
            gbs.append(gb)

        for scan, valid in chunks:
            while len(pending) >= max_inflight:
                drain_one()
            pending.append((self._dispatch(scan), valid))
            self.stream_peak_inflight = max(self.stream_peak_inflight, len(pending))
        while pending:
            drain_one()
        if not dets:
            raise ValueError("run_stream: empty chunk stream")

        def cat(xs):
            return np.concatenate(xs, axis=0)

        det = Detections(
            boxes=cat([d.boxes for d in dets]),
            conf=cat([d.conf for d in dets]),
            label=cat([d.label for d in dets]),
            damage=cat([d.damage for d in dets]),
            mask=cat([d.mask for d in dets]),
        )
        gb = GlobalBoxes(corners=cat([g.corners for g in gbs]), damage=det.damage, conf=det.conf,
                         label=det.label, mask=det.mask)
        return det, gb
