"""Detection and classification quality metrics: mAP50 / mAP50-95, PR,
confusion (port of ``tpu3dlm/pipeline/metrics.py``).

Host numpy, the JAX package's code: every function gives its results
exactly.

  * COCO-style average precision (101-point interpolation) over the IoU
    ladder 0.50:0.95:0.05, per class and aggregated (mAP50, mAP50-95);
  * the ultralytics validator's matching: per IoU threshold, candidate
    (pred, gt) pairs need class agreement and IoU >= threshold, then commit
    greedily in descending-IoU order, each prediction and each ground-truth
    box used at most once;
  * classifier accuracy, per-class precision/recall/F1 and the confusion
    matrix for the damage head.

Record format: per-frame dicts of list records as the pipeline produces
them — ``[x1, y1, x2, y2, conf, label]`` (detector stage) or
``[x1, y1, x2, y2, damage, conf, label]`` (after classification).  In both,
``rec[-2]`` is the confidence and ``rec[-1]`` the class label; ground-truth
records may carry any placeholder confidence.

CLI (evaluate a pipeline pickle against a scene gt.json):
    python -m tpu3dlm_torch.pipeline.metrics --pickle <ckpt.pkl> --gt <gt.json>
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

# the COCO IoU ladder: 0.50, 0.55, ..., 0.95
IOU_THRESHOLDS = np.round(np.arange(0.50, 0.96, 0.05), 2)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of two ``(N, 4)`` / ``(M, 4)`` xyxy box arrays → (N, M)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=-1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=-1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def match_predictions(
    ious: np.ndarray,
    pred_cls: np.ndarray,
    gt_cls: np.ndarray,
    thresholds: np.ndarray = IOU_THRESHOLDS,
) -> np.ndarray:
    """True-positive table ``(num_pred, num_thresholds)`` (ultralytics
    validator semantics).

    For each threshold: candidate pairs need matching class and
    IoU >= threshold; pairs commit greedily in descending-IoU order, each
    prediction and each gt box at most once.
    """
    ious = np.asarray(ious, np.float64)
    pred_cls = np.asarray(pred_cls).reshape(-1)
    gt_cls = np.asarray(gt_cls).reshape(-1)
    n_pred, n_gt = ious.shape
    tp = np.zeros((n_pred, len(thresholds)), bool)
    for t, thr in enumerate(thresholds):
        for p, _ in matched_pairs(ious, pred_cls, gt_cls, float(thr)):
            tp[p, t] = True
    return tp


def matched_pairs(
    ious: np.ndarray,
    pred_cls: np.ndarray,
    gt_cls: np.ndarray,
    threshold: float,
) -> list[tuple[int, int]]:
    """Greedy descending-IoU one-to-one (pred, gt) pairs at one threshold
    (the single-threshold core of :func:`match_predictions`)."""
    ious = np.asarray(ious, np.float64)
    pred_cls = np.asarray(pred_cls).reshape(-1)
    gt_cls = np.asarray(gt_cls).reshape(-1)
    n_pred, n_gt = ious.shape
    if n_pred == 0 or n_gt == 0:
        return []
    cand = np.where(pred_cls[:, None] == gt_cls[None, :], ious, 0.0)
    order = np.argsort(cand, axis=None)[::-1]  # flat indices, IoU desc
    pi, gi = np.unravel_index(order, cand.shape)
    used_p = np.zeros(n_pred, bool)
    used_g = np.zeros(n_gt, bool)
    pairs = []
    for p, g in zip(pi, gi):
        if cand[p, g] < threshold or cand[p, g] <= 0.0:
            break  # sorted desc: nothing below clears the threshold
        if used_p[p] or used_g[g]:
            continue
        used_p[p] = used_g[g] = True
        pairs.append((int(p), int(g)))
    return pairs


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """COCO 101-point-interpolated AP from a PR sequence ordered by
    descending confidence (monotone precision envelope first)."""
    # only real PR points plus the terminal (1, 0) sentinel: prepending a
    # (0, 1) sentinel (as some trapz-based implementations do) would credit
    # an all-FP curve with nonzero AP at the recall=0 sample
    recall = np.concatenate([np.asarray(recall, np.float64), [1.0]])
    precision = np.concatenate([np.asarray(precision, np.float64), [0.0]])
    envelope = np.maximum.accumulate(precision[::-1])[::-1]
    points = np.linspace(0.0, 1.0, 101)
    # precision of the first PR point with recall >= r (envelope is the
    # running max from the right, so any index at/after the crossing works)
    idx = np.searchsorted(recall, points, side="left")
    return float(envelope[idx].mean())


@dataclasses.dataclass
class DetectionMetrics:
    """Aggregated detector quality vs ground truth."""

    map50: float
    map50_95: float
    per_class_ap50: dict[int, float]
    per_class_ap: dict[int, float]  # mean over the IoU ladder
    precision: float  # micro P/R of the supplied (already conf-threshed)
    recall: float     # prediction set at IoU 0.50
    num_predictions: int
    num_ground_truth: int

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["per_class_ap50"] = {int(k): v for k, v in d["per_class_ap50"].items()}
        d["per_class_ap"] = {int(k): v for k, v in d["per_class_ap"].items()}
        return d


def _parse_records(recs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """List of 6- or 7-field records → (boxes, conf, labels)."""
    if recs is None or len(recs) == 0:
        z = np.zeros((0,))
        return np.zeros((0, 4)), z, z.astype(int)
    boxes = np.asarray([r[:4] for r in recs], np.float64)
    conf = np.asarray([float(r[-2]) for r in recs], np.float64)
    labels = np.asarray([int(r[-1]) for r in recs], int)
    return boxes, conf, labels


def evaluate_detections(
    predictions: dict[int, list],
    ground_truth: dict[int, list],
    thresholds: np.ndarray = IOU_THRESHOLDS,
) -> DetectionMetrics:
    """Per-frame prediction records vs ground-truth records → mAP metrics.

    Both arguments are frame-keyed dicts of ``[x1,y1,x2,y2,(damage,)conf,
    label]`` records in the SAME pixel space (the pipeline emits
    original-capture pixels for both predictions and synthetic gt).  Frames
    present in only one dict count fully (missed gt / spurious preds).
    """
    tps, confs, clss = [], [], []
    gt_cls_all = []
    for f in sorted(set(predictions) | set(ground_truth)):
        pb, pc, pl = _parse_records(predictions.get(f))
        gb, _, gl = _parse_records(ground_truth.get(f))
        gt_cls_all.append(gl)
        if len(pb) == 0:
            continue
        tp = match_predictions(box_iou(pb, gb), pl, gl, thresholds)
        tps.append(tp)
        confs.append(pc)
        clss.append(pl)

    gt_cls_all = np.concatenate(gt_cls_all) if gt_cls_all else np.zeros(0, int)
    n_gt = len(gt_cls_all)
    if not tps:
        return DetectionMetrics(0.0, 0.0, {}, {}, 0.0, 0.0, 0, n_gt)
    tp = np.concatenate(tps)
    conf = np.concatenate(confs)
    cls = np.concatenate(clss)
    order = np.argsort(-conf)
    tp, cls = tp[order], cls[order]

    classes = sorted(set(gt_cls_all.tolist()) | set(cls.tolist()))
    per_class_ap50: dict[int, float] = {}
    per_class_ap: dict[int, float] = {}
    for c in classes:
        n_gt_c = int((gt_cls_all == c).sum())
        sel = cls == c
        if n_gt_c == 0:
            # predictions for a class with no gt: AP defined as 0
            per_class_ap50[c] = per_class_ap[c] = 0.0
            continue
        aps = []
        for t in range(tp.shape[1]):
            tp_c = tp[sel, t].astype(np.float64)
            if tp_c.size == 0:
                aps.append(0.0)
                continue
            cum_tp = np.cumsum(tp_c)
            cum_fp = np.cumsum(1.0 - tp_c)
            rec_curve = cum_tp / n_gt_c
            prec_curve = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
            aps.append(compute_ap(rec_curve, prec_curve))
        per_class_ap50[c] = aps[0]
        per_class_ap[c] = float(np.mean(aps))

    # only classes with ground truth participate in the mAP mean (COCO rule)
    with_gt = [c for c in classes if (gt_cls_all == c).sum() > 0]
    map50 = float(np.mean([per_class_ap50[c] for c in with_gt])) if with_gt else 0.0
    map_ = float(np.mean([per_class_ap[c] for c in with_gt])) if with_gt else 0.0
    tp50 = int(tp[:, 0].sum())
    precision = tp50 / max(len(cls), 1)
    recall = tp50 / max(n_gt, 1)
    return DetectionMetrics(
        map50=map50,
        map50_95=map_,
        per_class_ap50=per_class_ap50,
        per_class_ap=per_class_ap,
        precision=float(precision),
        recall=float(recall),
        num_predictions=int(len(cls)),
        num_ground_truth=n_gt,
    )


@dataclasses.dataclass
class ClassificationMetrics:
    """Damage-classifier quality vs ground-truth labels."""

    accuracy: float
    per_class_precision: dict[int, float]
    per_class_recall: dict[int, float]
    per_class_f1: dict[int, float]
    macro_f1: float
    confusion: np.ndarray  # (num_classes, num_classes), rows = true

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["confusion"] = self.confusion.tolist()
        for k in ("per_class_precision", "per_class_recall", "per_class_f1"):
            d[k] = {int(c): v for c, v in d[k].items()}
        return d


def confusion_matrix(
    y_true: np.ndarray, y_pred: np.ndarray, num_classes: int
) -> np.ndarray:
    """(num_classes, num_classes) count matrix; rows = true, cols = pred."""
    y_true = np.asarray(y_true, int).reshape(-1)
    y_pred = np.asarray(y_pred, int).reshape(-1)
    if y_true.shape != y_pred.shape:
        raise ValueError(f"length mismatch: {y_true.shape} vs {y_pred.shape}")
    if y_true.size and (
        y_true.min() < 0 or y_pred.min() < 0
        or y_true.max() >= num_classes or y_pred.max() >= num_classes
    ):
        raise ValueError("labels out of [0, num_classes)")
    m = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(m, (y_true, y_pred), 1)
    return m


def evaluate_classification(
    y_true: np.ndarray, y_pred: np.ndarray, num_classes: int
) -> ClassificationMetrics:
    """Label arrays → accuracy / per-class PRF1 / confusion matrix."""
    m = confusion_matrix(y_true, y_pred, num_classes)
    total = m.sum()
    accuracy = float(np.trace(m) / total) if total else 0.0
    prec, rec, f1 = {}, {}, {}
    for c in range(num_classes):
        tp = float(m[c, c])
        p = tp / max(float(m[:, c].sum()), 1e-12)
        r = tp / max(float(m[c].sum()), 1e-12)
        prec[c], rec[c] = p, r
        f1[c] = 2 * p * r / max(p + r, 1e-12)
    macro_f1 = float(np.mean(list(f1.values()))) if f1 else 0.0
    return ClassificationMetrics(accuracy, prec, rec, f1, macro_f1, m)


def evaluate_pipeline_checkpoint(
    pickle_path: str, gt_path: str
) -> dict:
    """Pipeline checkpoint (``predictions`` key) vs a scene ``gt.json`` →
    JSON-ready report with detection mAP and, when the checkpoint's records
    carry damage fields, damage-classification metrics on matched boxes."""
    import pickle

    from tpu3dlm_torch.data.synthetic import load_scene_gt

    with open(pickle_path, "rb") as f:
        ckpt = pickle.load(f)
    preds = ckpt["predictions"]
    gt = load_scene_gt(gt_path)
    det = evaluate_detections(preds, gt["gt_boxes_2d"])
    report = {"detection": det.to_dict()}

    # damage metrics need 7-field records and per-box gt damage labels
    has_damage = any(len(r) >= 7 for recs in preds.values() for r in recs)
    if has_damage and gt.get("gt_damage_2d"):
        y_true, y_pred = [], []
        for f, recs in preds.items():
            g = gt["gt_boxes_2d"].get(f, [])
            gd = gt["gt_damage_2d"].get(f, [])
            if not g or not recs:
                continue
            pb, _, pl = _parse_records(recs)
            gb, _, gl = _parse_records(g)
            for p, gi in matched_pairs(box_iou(pb, gb), pl, gl, 0.5):
                if gi < len(gd):
                    y_true.append(int(gd[gi]))
                    y_pred.append(int(recs[p][4]))
        if y_true:
            n = max(max(y_true), max(y_pred)) + 1
            report["damage"] = evaluate_classification(y_true, y_pred, n).to_dict()
    return report


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pickle", required=True, help="pipeline checkpoint .pkl")
    ap.add_argument("--gt", required=True, help="scene gt.json")
    args = ap.parse_args()
    print(json.dumps(evaluate_pipeline_checkpoint(args.pickle, args.gt), indent=2))
