"""The port's synthetic capture generator (``tpu3dlm_torch/data/
synthetic.py``), its JPEG encoder and calibration writer, and the hard-eval
corpus (``pipeline/hardeval.py``) against the JAX package, on the CPU.

Tolerances: none. Every file the JAX package writes is written byte for
byte (the JPEGs are cv2's bytes), except the depth PNGs, whose deflate
stream differs: those decode to identical arrays. The corpus's scene
parameters, ground truth and perturbations (the blur included) are
identical.
"""

import dataclasses
import filecmp
import os
import sqlite3

import cv2
import numpy as np
import pytest

from tpu3dlm.data import synthetic as JS
from tpu3dlm.pipeline import hardeval as JH
from tpu3dlm_torch.data import synthetic as TS
from tpu3dlm_torch.data.codecs import decode_png, encode_jpeg
from tpu3dlm_torch.pipeline import hardeval as TH

TW = np.eye(4, dtype=np.float32)
TW[:3, 3] = [0.4, -0.3, 0.1]
SCANS = {
    "gold": dict(data_folder="gold_std", num_frames=3, seed=0),
    "maintenance": dict(data_folder="maintenance", num_frames=3, seed=1, world_transform=TW,
                        drop_sign_indices=(2,)),
}


def _cv2_jpeg(rgb):
    return cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))[1].tobytes()


def _same_capture(a: str, b: str, frames: int) -> None:
    for rel in ["poses.txt", "cloud.ply", "gt.json"]:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel
    ex = "rtabmap_extract"
    for i in range(1, frames + 1):
        for rel in (f"{ex}/calibration/{i}.yaml", f"{ex}/data_rgb/{i}.jpg"):
            assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel
        rel = f"{ex}/data_depth/{i}.png"
        np.testing.assert_array_equal(decode_png(open(os.path.join(b, rel), "rb").read()),
                                      cv2.imread(os.path.join(a, rel), cv2.IMREAD_UNCHANGED))
    rows = []
    for root in (a, b):
        with sqlite3.connect(os.path.join(root, "data.db")) as conn:
            rows.append(conn.execute("SELECT id, image, depth FROM Data ORDER BY id").fetchall())
            assert [r[0] for r in conn.execute("SELECT id FROM Node ORDER BY id")] == list(range(1, frames + 1))
    for (ia, ja, da), (ib, jb, db) in zip(*rows):
        assert ia == ib and ja == jb
        np.testing.assert_array_equal(decode_png(db), cv2.imdecode(np.frombuffer(da, np.uint8),
                                                                   cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("kind", sorted(SCANS))
def test_generate_scan_matches_jax(tmp_path, kind):
    kw = SCANS[kind]
    want = JS.generate_scan(str(tmp_path / "jax"), **kw)
    got = TS.generate_scan(str(tmp_path / "port"), **kw)
    folder = kw["data_folder"]
    _same_capture(str(tmp_path / "jax" / folder), str(tmp_path / "port" / folder), kw["num_frames"])
    assert got.gt_boxes_2d == want.gt_boxes_2d and got.gt_damage_2d == want.gt_damage_2d
    np.testing.assert_array_equal(got.poses, want.poses)
    gt = TS.load_scene_gt(str(tmp_path / "port" / folder / "gt.json"))
    assert gt["gt_boxes_2d"] == want.gt_boxes_2d


def test_rendered_frames_identical_and_jpeg_bytes_are_cv2s():
    """The analytic render before encoding, RGB, depth and owner mask, and
    ``encode_jpeg`` on it against ``cv2.imencode`` (the generator's frames
    and an occluded hard-eval frame)."""
    signs = TS.default_signs() + TH.occluder_set()
    jsigns = JS.default_signs() + JH.occluder_set()
    R = JS._rotmat_z(0.05)
    cam = np.array([0.3, 0.02, 0.0], np.float32)
    got = TS._render_frame(cam, R, signs, 3.0, 480, 640, 432.0, 432.0, 240.0, 320.0, want_owner=True)
    want = JS._render_frame(cam, R, jsigns, 3.0, 480, 640, 432.0, 432.0, 240.0, 320.0, want_owner=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert encode_jpeg(got[0]) == _cv2_jpeg(got[0])
    box = TS._project_sign_bbox(signs[1], cam, R, 480, 640, 432.0, 432.0, 240.0, 320.0)
    assert box == JS._project_sign_bbox(jsigns[1], cam, R, 480, 640, 432.0, 432.0, 240.0, 320.0)
    np.testing.assert_array_equal(TS._rotmat_to_quat(R @ JS._rotmat_z(0.4)), JS._rotmat_to_quat(R @ JS._rotmat_z(0.4)))


@pytest.mark.parametrize("hw", [(640, 480), (480, 640), (17, 23), (1, 1), (33, 8), (128, 128)])
def test_encode_jpeg_bytes_equal_cv2(hw):
    """Bytes identical for noise, flat and smooth images, including sizes
    that need edge replication and dummy blocks."""
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    h, w = hw
    flat = np.full((h, w, 3), 180, np.uint8)
    flat[h // 4:h // 2 + 1, w // 5:w // 2 + 1] = (220, 40, 40)
    for img in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), flat,
                rng.normal(128, 25, (h, w, 3)).clip(0, 255).astype(np.uint8)):
        assert encode_jpeg(img) == _cv2_jpeg(img)
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4), np.uint8))


def test_calibration_yaml_is_pyyaml_bytes(tmp_path):
    from tpu3dlm.data.calibration import write_calibration as jw
    from tpu3dlm_torch.data.calibration import load_calibration, write_calibration

    for args in [(480, 640, 432.0, 432.0, 240.0, 320.0), (7, 9, 1e17, 3.3333333, 0.1, 1e-7)]:
        jw(str(tmp_path / "a.yaml"), *args)
        write_calibration(str(tmp_path / "b.yaml"), *args)
        assert (tmp_path / "a.yaml").read_bytes() == (tmp_path / "b.yaml").read_bytes()
        c = load_calibration(str(tmp_path / "b.yaml"))
        assert (c["image_width"], c["image_height"], c["fx"], c["cy"]) == (args[0], args[1], args[2], args[5])


def _asdict(v):
    if isinstance(v, dict):
        return {k: _asdict(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_asdict(x) for x in v]
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    return v


@pytest.mark.parametrize("seed", [11, 23, 37, 53, 71])
def test_axis_kwargs_identical(seed):
    for axis in JH.AXES:
        got, want = TH.axis_kwargs(axis, seed), JH.axis_kwargs(axis, seed)
        assert _asdict(got) == _asdict(want), axis
    assert _asdict(TH.AXES) == _asdict(JH.AXES)
    assert TH.EVAL_SEEDS == JH.EVAL_SEEDS and TH.DAMAGE_AXES == JH.DAMAGE_AXES


def test_generate_axis_scan_ground_truth_identical(tmp_path):
    for axis in JH.AXES:
        want = JH.generate_axis_scan(str(tmp_path / "jax"), axis, num_frames=3, seed=11)
        got = TH.generate_axis_scan(str(tmp_path / "port"), axis, num_frames=3, seed=11)
        assert got.gt_boxes_2d == want.gt_boxes_2d and got.gt_damage_2d == want.gt_damage_2d, axis
        a, b = tmp_path / "jax" / f"{axis}_s11", tmp_path / "port" / f"{axis}_s11"
        for rel in ("gt.json", "cloud.ply", "rtabmap_extract/data_rgb/2.jpg"):
            assert filecmp.cmp(a / rel, b / rel, shallow=False), (axis, rel)


@pytest.mark.parametrize("axis", ["blur", "exposure", "crop_occlusion"])
def test_perturbations_identical(tmp_path, axis):
    """``_perturb_scan_rgb`` on the stored frames of a corpus scan, the blur
    through ``gaussian_blur`` against cv2's; ``_jitter_boxes``."""
    from tpu3dlm.data.dataset import load_scan

    scene = JS.generate_scan(str(tmp_path), "s", num_frames=3, seed=11, **JH.axis_kwargs("base", 11))
    base = tmp_path / "s" / "rtabmap_extract"
    scan = load_scan(str(base / "data_rgb"), str(base / "data_depth"), str(base / "calibration"),
                     str(tmp_path / "s" / "poses.txt"), img_size=128)
    rgb = np.asarray(scan.rgb)
    seq = np.random.SeedSequence([11, 0xDA3A6E])
    want = JH._perturb_scan_rgb(rgb, axis, np.random.default_rng(seq), gt_boxes_px=scene.gt_boxes_2d,
                                scan=scan)
    got = TH._perturb_scan_rgb(rgb, axis, np.random.default_rng(seq), gt_boxes_px=scene.gt_boxes_2d,
                               scan=scan)
    assert not np.array_equal(got, rgb)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 400, (3, 8, 4)).astype(np.float32)
    mask = rng.uniform(size=(3, 8)) < 0.6
    np.testing.assert_array_equal(TH._jitter_boxes(boxes, mask, np.random.default_rng(1)),
                                  JH._jitter_boxes(boxes, mask, np.random.default_rng(1)))


@pytest.mark.parametrize("sigma", [0.8, 3.0, 5.0])
def test_gaussian_blur_identical_to_cv2(sigma):
    rng = np.random.default_rng(int(sigma * 10))
    for img in (rng.integers(0, 256, (128, 128, 3), dtype=np.uint8),
                rng.integers(0, 256, (37, 53), dtype=np.uint8),
                np.where(rng.uniform(size=(64, 48, 3)) < 0.1, 255, 20).astype(np.uint8)):
        np.testing.assert_array_equal(TH.gaussian_blur(img, sigma), cv2.GaussianBlur(img, (0, 0), sigma))
