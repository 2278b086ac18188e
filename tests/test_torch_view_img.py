"""The views of a run through the port's Pipeline, on the CPU.

``view_img``: the annotated frames of ``ObjectDetector._save_annotated``
against the JAX package's PNGs (cv2's ``rectangle`` and ``putText``),
decoded: every pixel outside each label's text box identical, the text box
being ``cv2.getTextSize``'s box at the label's origin (about 55 × 16 px for
``class_N``). Inside the boxes the port writes a bitmap font, not cv2's
Hershey glyphs; measured on this test's frames (12 boxes a 128-px frame,
overlapping boxes counted in each): 157 to 486 differing pixels a label
box square, 160 to 573 letterboxed.

The three switches (``view_img``, ``alignment_vis``, ``comparison_vis``)
through ``Pipeline.run`` on both routes, on the committed capture with the
ICP cut to one iteration a stage and a 1024-point query: the report CSV is
byte-identical to a run with them off; the staged route writes one PNG a
frame, the fused route none (the reference ignores ``view_img`` there);
the animation lands beside the report with 20 frames a moving step. The
animation's renderer is held to the JAX package's in
``test_torch_render.py``; here it runs on clouds subsampled to 1500
points, a 0.4 m mesh and 48 × 64 frames to keep the test short."""

import functools
import os
import pickle
import unittest.mock as mock

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from tpu3dlm.data.scan import Detections as JDetections
from tpu3dlm.data.scan import Scan as JScan
from tpu3dlm.pipeline.detector import ObjectDetector as JaxDetector
from tpu3dlm_torch.alignment import visualise as PV
from tpu3dlm_torch.data.scan import Detections, Scan
from tpu3dlm_torch.pipeline import task as PT
from tpu3dlm_torch.pipeline.detector import ObjectDetector
from tpu3dlm_torch.utils.config import ConfigLoader as PCfg

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SWITCHES = [("view_img = false", "view_img = true"), ("alignment_vis = false", "alignment_vis = true"),
            ("comparison_vis = false", "comparison_vis = true")]


def text_boxes_mask(shape, scan, det, names) -> tuple[np.ndarray, list]:
    """Mask of every label's ``cv2.getTextSize`` box (FONT_HERSHEY_SIMPLEX,
    0.5, 1) at its origin, per frame, and the boxes themselves; origins
    computed as the reference's ``_save_annotated`` computes them."""
    F, S = shape[0], shape[1]
    wh = np.asarray(scan.rgb_size)
    mask = np.zeros(shape[:3], bool)
    boxes = []
    for f in range(F):
        for b in range(det.boxes.shape[1]):
            if not det.mask[f, b]:
                continue
            if scan.letterbox is not None:
                s, px, py = np.asarray(scan.letterbox)[f]
                x1, y1, _, _ = det.boxes[f, b] * s + [px, py, px, py]
            else:
                sx, sy = S / wh[f, 0], S / wh[f, 1]
                x1, y1, _, _ = det.boxes[f, b] * [sx, sy, sx, sy]
            x, y = int(x1), max(int(y1) - 6, 10)
            (w, h), base = cv2.getTextSize(names[int(det.label[f, b])], cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
            box = (f, max(y - h, 0), y + base + 1, max(x, 0), x + w + 1)
            mask[box[0], box[1]:box[2], box[3]:box[4]] = True
            boxes.append(box)
    return mask, boxes


def hold_annotated(port_dir, jax_dir, scan, det, names) -> list[int]:
    """The two packages' PNGs of every frame, decoded: identical outside the
    text boxes; returns the differing pixels inside each text box."""
    frames = []
    for f in range(np.asarray(scan.rgb).shape[0]):
        got = cv2.imread(os.path.join(port_dir, f"image_{f}.png"), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(os.path.join(jax_dir, f"image_{f}.png"), cv2.IMREAD_UNCHANGED)
        assert got is not None and want is not None and got.shape == want.shape
        frames.append((got, want))
    got = np.stack([g for g, _ in frames])
    want = np.stack([w for _, w in frames])
    inside, boxes = text_boxes_mask(got.shape, scan, det, names)
    differ = (got != want).any(-1)
    assert not (differ & ~inside).any(), np.argwhere(differ & ~inside)[:10]
    return [int(differ[f, y0:y1, x0:x1].sum()) for f, y0, y1, x0, x1 in boxes]


def random_detections(F, B, wh, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, wh[0], (F, B, 2)), -1)
    y = np.sort(rng.uniform(0, wh[1], (F, B, 2)), -1)
    boxes = np.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1).astype(np.float32)
    boxes[0, 0] = [0, 0, wh[0], wh[1]]  # the whole frame: edges on the border
    boxes[0, 1] = [3.5, 2.0, 3.9, 2.2]  # a box under a pixel
    cols = dict(boxes=boxes, conf=np.full((F, B), 0.9, np.float32),
                label=rng.integers(0, 2, (F, B)).astype(np.int32), damage=np.full((F, B), -1, np.int32),
                mask=rng.random((F, B)) < 0.7)
    cols["mask"][0, :2] = True
    return cols


@pytest.mark.parametrize("resize_mode", ["square", "letterbox"])
def test_annotated_frames_match_jax_outside_text_boxes(tmp_path, resize_mode):
    F, S, wh = 4, 128, (640.0, 480.0)
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 255, (F, S, S, 3), dtype=np.uint8)
    scan = dict(rgb=rgb, depth=np.zeros((F, 4, 4), np.float32), intrinsics=np.ones((F, 4), np.float32),
                rgb_size=np.tile(np.asarray([wh], np.float32), (F, 1)), poses=np.zeros((F, 7), np.float32))
    if resize_mode == "letterbox":
        scan["letterbox"] = np.tile(np.asarray([[0.2, 0.0, 16.0]], np.float32), (F, 1))
    det = random_detections(F, 12, wh, seed=2)
    port = ObjectDetector(nc=2, img_size=S, save_img=str(tmp_path / "port"), device="cpu")
    ref = JaxDetector(nc=2, img_size=S, save_img=str(tmp_path / "jax"), variables={})
    assert port.colors == ref.colors and port.names == ref.names
    port._save_annotated(Scan(**scan), Detections(**det))
    ref._save_annotated(JScan(**scan), JDetections(**det))
    diffs = hold_annotated(str(tmp_path / "port"), str(tmp_path / "jax"), Scan(**scan), Detections(**det), ref.names)
    assert len(diffs) == int(det["mask"].sum()) and min(diffs) > 0


# ---------------------------------------------------------------------------
# The three switches through Pipeline.run
# ---------------------------------------------------------------------------

CUT = [("infer_dtype = bf16", "infer_dtype = f32"), ("icp_max_points = 16384", "icp_max_points = 1024"),
       ("icp_iterations = 30", "icp_iterations = 1"),
       ("yolo_weights =", f"yolo_weights = {FIXTURES}/yolo_synthetic.msgpack"),
       ("beit_weights =", f"beit_weights = {FIXTURES}/beit_synthetic.msgpack")]
REAL = PV.VisualiseAlignment
SMALL_ANIMATION = functools.partial(PV.VisualiseAlignment, max_points=1500, image_hw=(48, 64), mesh_voxel=0.4)


def csv_and_animation(cfg) -> tuple[bytes, list]:
    with open(cfg.csv_output, "rb") as f:
        csv = f.read()
    folder = os.path.dirname(cfg.csv_output)
    return csv, sorted(n for n in os.listdir(folder) if n.startswith("alignment_animation"))


@pytest.fixture(scope="module", params=["staged", "fused"])
def route(request, tmp_path_factory):
    """Gold with the switches on, then maintenance with them off and on
    (two config files side by side, so the same data and report paths)."""
    root = str(tmp_path_factory.mktemp(request.param))
    chip_smoke.copy_project(root)
    fused = [("fused_inference = false", "fused_inference = true")] if request.param == "fused" else []
    cfg_off = chip_smoke.write_config(root, chip_smoke.PROJECT_PATCH + CUT + fused)
    text = open(cfg_off).read()
    for old, new in SWITCHES:
        text = text.replace(old, new)
    cfg_on = os.path.join(os.path.dirname(cfg_off), "switches_on.cfg")
    with open(cfg_on, "w") as f:
        f.write(text)
    gold_cfg, on_cfg, off_cfg = PCfg(cfg_on, "gold_std"), PCfg(cfg_on, "maintenance"), PCfg(cfg_off, "maintenance")
    assert off_cfg.csv_output == on_cfg.csv_output and not off_cfg.view_img
    assert on_cfg.view_img and on_cfg.alignment_vis and on_cfg.comparison_vis
    with mock.patch.object(PV, "VisualiseAlignment", SMALL_ANIMATION):
        gold = PT.setup_pipeline("gold_std", gold_cfg, None, device="cpu")
        gold_var = PT.load_gold_std(gold_cfg.pickle_path)
        off = PT.setup_pipeline("maintenance", off_cfg, gold_cfg, gold_var, device="cpu")
        csv_off, anim_off = csv_and_animation(off_cfg)
        maint_frames_off = os.path.isdir(on_cfg.processing_path)
        on = PT.setup_pipeline("maintenance", on_cfg, gold_cfg, gold_var, device="cpu")
        csv_on, anim_on = csv_and_animation(on_cfg)
    return dict(route=request.param, gold=gold, off=off, on=on, gold_cfg=gold_cfg, on_cfg=on_cfg,
                csv_off=csv_off, csv_on=csv_on, anim_off=anim_off, anim_on=anim_on,
                maint_frames_off=maint_frames_off)


def test_switches_leave_the_report_csv_byte_identical(route):
    assert route["csv_off"] and route["csv_on"] == route["csv_off"]
    assert route["on"].data_to_save["comparison_rows"] == route["off"].data_to_save["comparison_rows"]
    for key in ("predictions", "global_bboxes_data", "optimised_bboxes"):
        assert chip_smoke._records_err(route["on"].data_to_save[key], route["off"].data_to_save[key], 4) == 0


def test_view_img_writes_frames_on_the_staged_route_only(route):
    """C3: ``view_img = true`` on the fused route is ignored (no frame
    written), as the reference's fused route ignores it; the staged route
    writes ``image_<f>.png`` for every frame of both scans."""
    assert not route["maint_frames_off"]  # the run with view_img off wrote none
    for p, cfg in ((route["gold"], route["gold_cfg"]), (route["on"], route["on_cfg"])):
        written = sorted(os.listdir(cfg.processing_path)) if os.path.isdir(cfg.processing_path) else []
        if route["route"] == "fused":
            assert written == []
        else:
            assert written == sorted(f"image_{f}.png" for f in range(len(p.data_to_save["predictions"])))
            img = cv2.imread(os.path.join(cfg.processing_path, "image_0.png"))
            assert img.shape == (128, 128, 3)


def test_alignment_vis_writes_the_animation_beside_the_report(route):
    assert route["anim_off"] == []
    steps = route["on"].data_to_save["transformations"]
    moving = REAL.moving_steps(steps)
    assert 1 <= len(moving) <= len(steps) <= 4  # init + one iteration a stage
    (name,) = route["anim_on"]
    assert name in ("alignment_animation.mp4", "alignment_animation.mp4.npz")
    if name.endswith(".npz"):  # no mp4 encoder on this host
        frames = np.load(os.path.join(os.path.dirname(route["on_cfg"].csv_output), name))["frames"]
        assert frames.shape == (20 * len(moving), 48, 64, 3) and frames.dtype == np.uint8


def test_comparison_vis_is_accepted_and_changes_nothing(route):
    """C3: ``comparison_vis = true``, a no-op in the reference
    (``BBoxComparison`` stores it), runs and leaves the report as it is."""
    assert route["on_cfg"].comparison_vis and route["on"].data_to_save["comparison_rows"]
    assert route["on"].data_to_save["alignment_verdict"] == route["off"].data_to_save["alignment_verdict"]


def test_visualise_harness_replays_the_scan(route, monkeypatch, capsys):
    """``python -m tpu3dlm_torch.alignment.visualise --data maintenance``:
    the Pipeline's pickle is written before the compare and holds no
    record, so the harness registers the two clouds again with the
    config's settings (the same steps as the Pipeline's compare) and writes
    ``alignment_visualisation.mp4`` (or ``.npz``) beside the report."""
    monkeypatch.setattr(PV, "VisualiseAlignment", SMALL_ANIMATION)
    cfg = route["on_cfg"]
    with open(cfg.pickle_path, "rb") as f:
        assert "transformations" not in pickle.load(f)
    args = ["--data", "maintenance", "--config", os.path.join(os.path.dirname(cfg.csv_output), "..", "..",
                                                                 "switches_on.cfg"), "--device", "cpu"]
    n = PV.main(args)
    steps = route["on"].data_to_save["transformations"]
    assert n == 20 * len(REAL.moving_steps(steps))
    folder = os.path.dirname(cfg.csv_output)
    assert [x for x in os.listdir(folder) if x.startswith("alignment_visualisation")]
    assert f"{n} frames" in capsys.readouterr().out
    with pytest.raises(ValueError, match="gold_std"):
        PV.main(["--data", "gold_std", "--config", args[3], "--device", "cpu"])
