"""YOLOv10 detection loss: task-aligned assignment + CIoU + DFL (port of
``tpu3dlm/models/yolo_loss.py``).

The consistent-dual-assignment recipe of the YOLOv10 paper: the
one-to-many head trains with TAL top-k 10, the one-to-one head with top-k
1 on detached backbone features (``models/yolov10.py``: train mode).
Ground-truth boxes are padded to a static G per image with a validity
mask; the (B, G, A) assignment stays on the device, with no host loop.

Tie order is the reference's: the top-k per ground truth keeps the lower
anchor index on ties (``topk_stable``, as ``jax.lax.top_k``), and an
anchor claimed by several ground truths goes to the first of the highest
IoU (``torch.argmax``, as ``jnp.argmax``). The class loss is optax's
``sigmoid_binary_cross_entropy`` written out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpu3dlm_torch.models.yolov10 import REG_MAX, decode_raw, flatten_raw, make_anchors, topk_stable


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between (..., 4) xyxy boxes (broadcasting)."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    inter = torch.prod(torch.clamp(rb - lt, min=0.0), dim=-1)
    area_a = torch.prod(torch.clamp(a[..., 2:] - a[..., :2], min=0.0), dim=-1)
    area_b = torch.prod(torch.clamp(b[..., 2:] - b[..., :2], min=0.0), dim=-1)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def ciou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complete IoU between (..., 4) xyxy boxes; the aspect term's weight
    ``alpha`` is detached, as in the reference."""
    iou = pairwise_iou(a, b)
    ctr_a = (a[..., :2] + a[..., 2:]) / 2
    ctr_b = (b[..., :2] + b[..., 2:]) / 2
    rho2 = torch.sum((ctr_a - ctr_b) ** 2, dim=-1)
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:], b[..., 2:])
    diag2 = torch.sum((rb - lt) ** 2, dim=-1) + 1e-9
    wa = torch.clamp(a[..., 2] - a[..., 0], min=1e-9)
    ha = torch.clamp(a[..., 3] - a[..., 1], min=1e-9)
    wb = torch.clamp(b[..., 2] - b[..., 0], min=1e-9)
    hb = torch.clamp(b[..., 3] - b[..., 1], min=1e-9)
    v = (4 / math.pi**2) * (torch.atan(wb / hb) - torch.atan(wa / ha)) ** 2
    alpha = v / torch.clamp(1.0 - iou + v, min=1e-9)
    return iou - rho2 / diag2 - alpha.detach() * v


def task_aligned_assign(
    pred_scores: torch.Tensor,  # (B, A, nc) sigmoid probabilities
    pred_boxes: torch.Tensor,  # (B, A, 4) xyxy px
    anchors_px: torch.Tensor,  # (A, 2) anchor centres in px
    gt_boxes: torch.Tensor,  # (B, G, 4) xyxy px
    gt_labels: torch.Tensor,  # (B, G) integer
    gt_mask: torch.Tensor,  # (B, G) bool
    top_k: int,
    alpha: float = 0.5,
    beta: float = 6.0,
):
    """TAL: returns (target boxes (B, A, 4), target scores (B, A, nc),
    foreground (B, A)).

    metric = score^alpha · IoU^beta over anchors whose centre lies inside
    the gt box; each gt keeps its top-k anchors; an anchor claimed by
    several gts goes to the highest-IoU one. Class targets are the metric
    normalised per gt (soft targets), boxes the assigned gt box."""
    B, A, nc = pred_scores.shape
    G = gt_boxes.shape[1]
    gt_labels = gt_labels.long()

    iou = pairwise_iou(gt_boxes[:, :, None, :], pred_boxes[:, None, :, :])  # (B, G, A)
    cls_score = torch.gather(
        pred_scores.transpose(1, 2), 1, torch.clamp(gt_labels, min=0)[:, :, None].expand(B, G, A)
    )  # (B, G, A)
    metric = cls_score**alpha * torch.clamp(iou, min=0.0) ** beta

    ax, ay = anchors_px[:, 0], anchors_px[:, 1]
    inside = (
        (ax >= gt_boxes[..., 0:1]) & (ax <= gt_boxes[..., 2:3])
        & (ay >= gt_boxes[..., 1:2]) & (ay <= gt_boxes[..., 3:4])
    )  # (B, G, A)
    metric = torch.where(inside & gt_mask[..., None], metric, torch.zeros((), device=metric.device))

    topv, topi = topk_stable(metric, min(top_k, A))  # (B, G, k)
    sel = torch.zeros((B, G, A), dtype=torch.bool, device=metric.device).scatter_(2, topi, topv > 0)

    claim_iou = torch.where(sel, iou, torch.full((), -1.0, device=iou.device))
    best_iou, _ = claim_iou.max(dim=1)  # (B, A)
    best_gt = claim_iou.argmax(dim=1)  # (B, A), the first maximum
    fg = best_iou > -0.5

    t_boxes = torch.gather(gt_boxes, 1, best_gt[..., None].expand(B, A, 4))
    t_labels = torch.gather(gt_labels, 1, best_gt)
    pair_metric = torch.gather(metric, 1, best_gt[:, None, :])[:, 0]  # (B, A)

    max_metric = metric.max(dim=2).values  # (B, G)
    max_iou = torch.where(sel, iou, torch.zeros((), device=iou.device)).max(dim=2).values
    norm = max_iou / torch.clamp(max_metric, min=1e-9)
    norm_a = torch.gather(norm, 1, best_gt)
    t_score_val = torch.where(fg, pair_metric * norm_a, torch.zeros((), device=fg.device))
    t_score_val = torch.clamp(t_score_val, 0.0, 1.0)

    target_scores = F.one_hot(t_labels, nc).to(pred_scores.dtype) * t_score_val[..., None]
    return t_boxes, target_scores, fg


def dfl_loss(box_logits: torch.Tensor, target_ltrb: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss over the two bins around each target
    distance. box_logits (..., 4, REG_MAX); target_ltrb (..., 4) in
    [0, REG_MAX − 1], clipped below REG_MAX − 1 − 1e-3. Mean over the four
    sides."""
    t = torch.clamp(target_ltrb, 0.0, REG_MAX - 1 - 1e-3)
    tl = torch.floor(t)
    wr = t - tl
    wl = 1.0 - wr
    logp = torch.log_softmax(box_logits, dim=-1)
    tl_i = tl.long()
    lp_l = torch.gather(logp, -1, tl_i[..., None])[..., 0]
    lp_r = torch.gather(logp, -1, (tl_i + 1)[..., None])[..., 0]
    return -(wl * lp_l + wr * lp_r).mean(dim=-1)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's elementwise form: −labels·log σ(x) − (1 − labels)·log σ(−x)."""
    return -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))


def detection_loss_one_head(
    raw,  # per-level maps, split or concatenated (models.yolov10.flatten_raw)
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    img_size: int,
    top_k: int,
    w_box: float = 7.5,
    w_cls: float = 0.5,
    w_dfl: float = 1.5,
    aux: dict | None = None,
) -> torch.Tensor:
    """One head's loss: TAL on detached scores and boxes, then BCE over
    all anchors, CIoU and DFL over the foreground, each normalised by the
    sum of the target scores. ``aux``, when given, receives the
    foreground mask under ``"fg"``."""
    pred_boxes, cls_logits = decode_raw(raw, img_size)
    cls_logits = cls_logits.float()
    pred_scores = torch.sigmoid(cls_logits)
    anchors, strides = make_anchors(img_size, cls_logits.device)
    anchors_px = anchors * strides[:, None]

    t_boxes, t_scores, fg = task_aligned_assign(
        pred_scores.detach(), pred_boxes.detach(), anchors_px, gt_boxes, gt_labels, gt_mask, top_k
    )
    if aux is not None:
        aux["fg"] = fg
    denom = torch.clamp(t_scores.sum(), min=1.0)

    cls_loss = sigmoid_binary_cross_entropy(cls_logits, t_scores).sum() / denom
    w = t_scores.sum(-1) * fg
    box_loss = ((1.0 - ciou(pred_boxes, t_boxes)) * w).sum() / denom

    box_logits, _ = flatten_raw(raw)
    lt = (anchors_px - t_boxes[..., :2]) / strides[None, :, None]
    rb = (t_boxes[..., 2:] - anchors_px) / strides[None, :, None]
    dfl = (dfl_loss(box_logits.float(), torch.cat([lt, rb], -1)) * w).sum() / denom
    return w_box * box_loss + w_cls * cls_loss + w_dfl * dfl


def yolov10_loss(outputs: dict, gt_boxes, gt_labels, gt_mask, img_size: int, aux: dict | None = None):
    """Consistent dual assignment: the one-to-many head at top-k 10 plus
    the one-to-one head at top-k 1. ``outputs`` is a train-mode forward's
    (``one2many_split`` and ``one2one_split``). ``aux``, when given,
    receives each head's foreground mask (``fg_one2many``, ``fg_one2one``)."""
    sub_m = {} if aux is not None else None
    sub_o = {} if aux is not None else None
    l_o2m = detection_loss_one_head(outputs["one2many_split"], gt_boxes, gt_labels, gt_mask, img_size,
                                    top_k=10, aux=sub_m)
    l_o2o = detection_loss_one_head(outputs["one2one_split"], gt_boxes, gt_labels, gt_mask, img_size,
                                    top_k=1, aux=sub_o)
    if aux is not None:
        aux["fg_one2many"], aux["fg_one2one"] = sub_m["fg"], sub_o["fg"]
    return l_o2m + l_o2o
