"""The port's accuracy metrics (``tpu3dlm_torch/pipeline/metrics.py``)
against the JAX package's (``tpu3dlm/pipeline/metrics.py``) on seeded
random records. Tolerance: none, every result is exact."""

import json
import pickle

import numpy as np
import pytest

from tpu3dlm.pipeline import metrics as JM
from tpu3dlm_torch.pipeline import metrics as TM


def _records(rng, frames: int, n_max: int, damage: bool, classes: int = 3):
    out = {}
    for f in range(frames):
        recs = []
        for _ in range(int(rng.integers(0, n_max + 1))):
            x1, y1 = rng.uniform(0, 400, 2)
            w, h = rng.uniform(2, 120, 2)
            rec = [float(x1), float(y1), float(x1 + w), float(y1 + h)]
            if damage:
                rec.append(int(rng.integers(0, 2)))
            rec += [float(rng.uniform(0.05, 1.0)), int(rng.integers(0, classes))]
            recs.append(rec)
        out[f] = recs
    return out


def _near(rng, gt, jitter: float):
    """Predictions near the ground truth (true positives at several IoUs)
    plus a few spurious ones."""
    out = {}
    for f, recs in gt.items():
        preds = []
        for r in recs:
            if rng.uniform() < 0.8:
                b = (np.asarray(r[:4]) + rng.normal(0, jitter, 4)).tolist()
                preds.append(b + [int(rng.integers(0, 2)), float(rng.uniform(0.1, 1)), r[-1]])
        preds += _records(rng, 1, 2, True)[0]
        out[f] = preds
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_iou_and_matching_identical(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 100, (7, 4))
    a[:, 2:] += a[:, :2]
    b = rng.uniform(0, 100, (5, 4))
    b[:, 2:] += b[:, :2]
    b[0] = [5, 5, 5, 5]  # zero area
    ious = TM.box_iou(a, b)
    np.testing.assert_array_equal(ious, JM.box_iou(a, b))
    pc, gc = rng.integers(0, 2, 7), rng.integers(0, 2, 5)
    np.testing.assert_array_equal(TM.match_predictions(ious, pc, gc), JM.match_predictions(ious, pc, gc))
    for thr in (0.0, 0.3, 0.5, 0.9):
        assert TM.matched_pairs(ious, pc, gc, thr) == JM.matched_pairs(ious, pc, gc, thr)
    assert TM.matched_pairs(np.zeros((0, 3)), [], [0, 1, 1], 0.5) == []
    np.testing.assert_array_equal(TM.IOU_THRESHOLDS, JM.IOU_THRESHOLDS)


def test_compute_ap_identical():
    rng = np.random.default_rng(3)
    for _ in range(20):
        n = int(rng.integers(1, 30))
        tp = rng.uniform(size=n) < 0.6
        cum = np.cumsum(tp)
        rec, prec = cum / max(n, 1), cum / np.arange(1, n + 1)
        assert TM.compute_ap(rec, prec) == JM.compute_ap(rec, prec)


@pytest.mark.parametrize("seed,jitter", [(4, 2.0), (5, 8.0), (6, 0.5)])
def test_evaluate_detections_identical(seed, jitter):
    rng = np.random.default_rng(seed)
    gt = _records(rng, 12, 4, False)
    gt[12] = _records(rng, 1, 3, False)[0]  # a frame with ground truth only
    preds = _near(rng, {f: r for f, r in gt.items() if f != 12}, jitter)
    preds[20] = _records(rng, 1, 2, True)[0]  # predictions only
    assert TM.evaluate_detections(preds, gt).to_dict() == JM.evaluate_detections(preds, gt).to_dict()
    assert TM.evaluate_detections({}, gt).to_dict() == JM.evaluate_detections({}, gt).to_dict()
    assert TM.evaluate_detections(preds, {}).to_dict() == JM.evaluate_detections(preds, {}).to_dict()


def test_classification_metrics_identical():
    rng = np.random.default_rng(7)
    y_true, y_pred = rng.integers(0, 3, 50), rng.integers(0, 3, 50)
    np.testing.assert_array_equal(TM.confusion_matrix(y_true, y_pred, 3), JM.confusion_matrix(y_true, y_pred, 3))
    assert TM.evaluate_classification(y_true, y_pred, 4).to_dict() == \
        JM.evaluate_classification(y_true, y_pred, 4).to_dict()
    assert TM.evaluate_classification([], [], 2).to_dict() == JM.evaluate_classification([], [], 2).to_dict()
    for bad in (([0, 1], [0]), ([0, 3], [0, 1])):
        with pytest.raises(ValueError):
            TM.confusion_matrix(*bad, 3)


def test_evaluate_pipeline_checkpoint_identical(tmp_path):
    """A pickle's 7-field predictions against a scene gt.json written by
    the port's generator: detection and damage reports equal."""
    from tpu3dlm_torch.data.synthetic import generate_scan

    scene = generate_scan(str(tmp_path), "gold_std", num_frames=3, seed=0)
    rng = np.random.default_rng(8)
    preds = _near(rng, scene.gt_boxes_2d, 3.0)
    ckpt = tmp_path / "ckpt.pkl"
    with open(ckpt, "wb") as f:
        pickle.dump({"predictions": preds}, f)
    gt = str(tmp_path / "gold_std" / "gt.json")
    got = TM.evaluate_pipeline_checkpoint(str(ckpt), gt)
    assert "damage" in got
    assert json.dumps(got, sort_keys=True) == json.dumps(JM.evaluate_pipeline_checkpoint(str(ckpt), gt),
                                                         sort_keys=True)
