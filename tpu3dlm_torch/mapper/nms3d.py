"""3D non-maximum suppression over global boxes (port of
``tpu3dlm/mapper/nms3d.py``).

One physical sign is seen from many frames, so it appears as many
near-coincident world quads; suppression keeps the most confident one.
  1. quality gates: minimum quad area and minimum camera-to-box distance;
  2. each quad is extruded ±depth_buffer along its normal into an oriented
     box;
  3. pairwise orientation-aware IoU over the top-K boxes by confidence,
     each pair in the first box's local frame, symmetrised by max;
  4. greedy suppression in confidence order (stable sort: the lower frame
     index wins ties).

Steps 1–3 run on the device as batched tensor ops. Step 4 is inherently
sequential (K ≤ 1024 steps); it runs as a numpy loop on the host over the
(K, K) "IoU above threshold" matrix, one device→host copy of K² bytes.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from tpu3dlm_torch.data.scan import to_numpy
from tpu3dlm_torch.device import as_device_tensor, resolve_device
from tpu3dlm_torch.mapper.projection import GlobalBoxes


def _quad_area(corners: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) planar quads (TL, BL, BR, TR) → (...,) areas."""
    d1 = corners[..., 2, :] - corners[..., 0, :]
    d2 = corners[..., 3, :] - corners[..., 1, :]
    return 0.5 * torch.linalg.vector_norm(torch.linalg.cross(d1, d2), dim=-1)


def _box_frame(corners: torch.Tensor, depth_buffer: float):
    """(K, 4, 3) quads → oriented boxes: (K, 3, 3) rows = local axes,
    (K, 3) centres, (K, 3) half-extents."""
    u = corners[:, 3] - corners[:, 0]  # width axis
    v = corners[:, 1] - corners[:, 0]  # height axis
    w_len = torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-12
    ux = u / w_len
    v_perp = v - (v * ux).sum(-1, keepdim=True) * ux
    h_len = torch.linalg.vector_norm(v_perp, dim=-1, keepdim=True) + 1e-12
    vy = v_perp / h_len
    nz = torch.linalg.cross(ux, vy)
    R = torch.stack([ux, vy, nz], dim=1)
    center = corners.mean(dim=1)
    half = torch.cat([w_len / 2.0, h_len / 2.0, torch.full_like(w_len, depth_buffer)], -1)
    return R, center, half


def _pairwise_oriented_iou(corners: torch.Tensor, depth_buffer: float) -> torch.Tensor:
    """(K, K) IoU of the extruded boxes, box j projected as an AABB into box
    i's frame (extent |R_i R_jᵀ| h_j), symmetrised by max."""
    R, c, h = _box_frame(corners, depth_buffer)
    M = torch.einsum("ikl,jml->ijkm", R, R)
    ext = torch.einsum("ijkm,jm->ijk", M.abs(), h)
    ctr = torch.einsum("ikl,ijl->ijk", R, c[None, :, :] - c[:, None, :])
    lo = torch.maximum(-h[:, None, :], ctr - ext)
    hi = torch.minimum(h[:, None, :], ctr + ext)
    inter = torch.clamp(hi - lo, min=0.0).prod(-1)
    vol = (2.0 * h).prod(-1)
    iou = inter / torch.clamp(vol[:, None] + vol[None, :] - inter, min=1e-12)
    return torch.maximum(iou, iou.T)


def nms3d_mask(
    corners: torch.Tensor,  # (F, B, 4, 3)
    conf: torch.Tensor,  # (F, B)
    mask: torch.Tensor,  # (F, B)
    cam_positions: torch.Tensor,  # (F, 3)
    iou_threshold: float = 0.25,
    depth_buffer: float = 0.03,
    area_min: float = 0.001,
    cam_dist_min: float = 0.01,
    top_k: int = 1024,
) -> torch.Tensor:
    """(F, B) keep mask after the quality gates and 3D NMS."""
    F, B = conf.shape
    N = F * B
    K = min(top_k, N)
    flat_corners = corners.reshape(N, 4, 3).float()
    flat_conf = conf.reshape(N).float()
    flat_mask = mask.reshape(N).bool()

    d_cam = torch.linalg.vector_norm(
        corners.float() - cam_positions.float()[:, None, None, :], dim=-1
    ).reshape(N, 4)
    flat_mask = flat_mask & (_quad_area(flat_corners) >= area_min) & ~(d_cam < cam_dist_min).any(-1)

    score = torch.where(flat_mask, flat_conf, torch.full_like(flat_conf, -float("inf")))
    order = torch.sort(-score, stable=True).indices[:K]
    sel_valid = flat_mask[order]
    over = _pairwise_oriented_iou(flat_corners[order], depth_buffer) > iou_threshold

    over_h = to_numpy(over)
    keep = to_numpy(sel_valid).copy()
    for i in range(K):
        if keep[i]:
            keep[i + 1:] &= ~over_h[i, i + 1:]

    keep_flat = torch.zeros(N, dtype=torch.bool, device=conf.device)
    keep_flat[order] = torch.as_tensor(keep, device=conf.device)
    return (keep_flat & flat_mask).reshape(F, B)


def suppress_bboxes(
    gboxes: GlobalBoxes,
    poses,  # (F, 7)
    iou_threshold: float = 0.25,
    depth_buffer: float = 0.03,
    area_min: float = 0.001,
    cam_dist_min: float = 0.01,
    top_k: int = 1024,
    device: str | torch.device = "cuda",
) -> GlobalBoxes:
    """3D NMS over a scan's GlobalBoxes on ``device`` → GlobalBoxes with the
    pruned mask (host numpy). ``top_k`` caps the O(K²) suppression; beyond
    it the lowest-confidence candidates are dropped, with a warning."""
    dev = resolve_device(device)
    corners = as_device_tensor(gboxes.corners, dev, torch.float32)
    conf = as_device_tensor(gboxes.conf, dev, torch.float32)
    mask = as_device_tensor(gboxes.mask, dev, torch.bool)
    cams = as_device_tensor(np.asarray(to_numpy(poses), np.float32)[:, :3], dev)
    n_candidates = int(mask.sum())
    if n_candidates > top_k:
        logging.getLogger(__name__).warning(
            "3D NMS: %d masked boxes (before the quality gates) exceed the "
            "top-%d confidence cap; the lowest-confidence ones beyond it are "
            "dropped", n_candidates, top_k,
        )
    keep = nms3d_mask(
        corners, conf, mask, cams,
        iou_threshold=iou_threshold, depth_buffer=depth_buffer,
        area_min=area_min, cam_dist_min=cam_dist_min, top_k=top_k,
    )
    return dataclasses.replace(gboxes, mask=to_numpy(keep))
