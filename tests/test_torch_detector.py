"""The staged route's detector (``tpu3dlm_torch/pipeline/detector.py``)
against the JAX package's ``ObjectDetector`` on the CPU, f32: the fixture
YOLOv10-n (``tests/fixtures/yolo_synthetic.msgpack``) at 128 px on the
committed capture's gold scan, square and letterbox, 5 frames in batches
of 2 (a ragged last batch). Boxes within 1e-3 px (f32 convolutions summed
in another order, magnified by the DFL expectation), conf within 1e-5,
labels and masks equal, damage all −1."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm.data.dataset import load_scan
from tpu3dlm.models import weights as JW
from tpu3dlm.models.yolov10 import YOLOv10 as JaxYOLOv10
from tpu3dlm.pipeline.detector import ObjectDetector as JaxDetector
from tpu3dlm_torch.data.scan import Scan
from tpu3dlm_torch.models.checkpoint import read_flax_msgpack
from tpu3dlm_torch.models.weights import yolov10_from_flax
from tpu3dlm_torch.pipeline.detector import ObjectDetector

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
YOLO = os.path.join(FIXTURES, "yolo_synthetic.msgpack")
SCAN = os.path.join(FIXTURES, "torch_project", "data", "gold_std")
KW = dict(conf_thresh=0.25, img_size=128, batch_size=2, max_det=8, nc=2)


def fixture_scan(resize_mode: str):
    ext = os.path.join(SCAN, "rtabmap_extract")
    return load_scan(os.path.join(ext, "data_rgb"), os.path.join(ext, "data_depth"),
                     os.path.join(ext, "calibration"), os.path.join(SCAN, "poses.txt"),
                     img_size=128, resize_mode=resize_mode)


def port_scan(scan) -> Scan:
    return Scan(**{f.name: getattr(scan, f.name) for f in dataclasses.fields(Scan)})


@pytest.fixture(scope="module")
def detectors():
    model = JaxYOLOv10(nc=2, variant="n")
    variables = JW.load_flax_checkpoint(YOLO, JW.init_template(model, jnp.zeros((1, 128, 128, 3), jnp.float32)))
    jax_det = JaxDetector(variables=variables, dtype=jnp.float32, **KW)
    port_det = ObjectDetector(yolo=yolov10_from_flax(read_flax_msgpack(YOLO), nc=2),
                              dtype=torch.float32, device="cpu", **KW)
    return jax_det, port_det


@pytest.mark.parametrize("resize_mode", ["square", "letterbox"])
def test_detections_match_jax(detectors, resize_mode):
    jax_det, port_det = detectors
    scan = fixture_scan(resize_mode)
    assert scan.num_frames == 5 and (scan.letterbox is not None) == (resize_mode == "letterbox")
    want = jax_det(scan)
    got = port_det(port_scan(scan))
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    assert 0 < got.mask.sum() < got.mask.size  # the threshold keeps some and drops some
    np.testing.assert_array_equal(got.label, np.asarray(want.label))
    np.testing.assert_array_equal(got.damage, np.full((5, 8), -1, np.int32))
    np.testing.assert_allclose(got.boxes, np.asarray(want.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.conf, np.asarray(want.conf), rtol=0, atol=1e-5)
    for name, dtype in (("boxes", np.float32), ("conf", np.float32), ("label", np.int32),
                        ("damage", np.int32), ("mask", bool)):
        assert getattr(got, name).dtype == dtype, name
    # clipped to the original frame
    wh = np.asarray(scan.rgb_size)[:, None, :]
    assert (got.boxes >= 0).all() and (got.boxes[..., [0, 2]] <= wh[..., :1]).all()
    assert (got.boxes[..., [1, 3]] <= wh[..., 1:]).all()


def test_empty_scan(detectors):
    _, port_det = detectors
    scan = port_scan(fixture_scan("square"))
    empty = dataclasses.replace(scan, rgb=scan.rgb[:0], depth=scan.depth[:0])
    got = port_det(empty)
    assert got.boxes.shape == (0, 8, 4) and got.mask.shape == (0, 8) and got.damage.shape == (0, 8)
    assert got.boxes.dtype == np.float32 and got.label.dtype == np.int32 and got.mask.dtype == bool


def test_save_img_is_not_ported(tmp_path, detectors):
    """``save_img`` was refused before the views of a run were ported; now
    both detectors write each frame annotated, and the PNGs agree outside
    the labels' text boxes (``test_torch_view_img.hold_annotated``)."""
    from test_torch_view_img import hold_annotated

    jax_det, port_det = detectors
    scan = fixture_scan("letterbox")
    jax_det.save_img, port_det.save_img = str(tmp_path / "jax"), str(tmp_path / "port")
    try:
        want, got = jax_det(scan), port_det(port_scan(scan))
    finally:
        jax_det.save_img = port_det.save_img = None
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    assert sorted(os.listdir(tmp_path / "port")) == [f"image_{f}.png" for f in range(5)]
    diffs = hold_annotated(str(tmp_path / "port"), str(tmp_path / "jax"), port_scan(scan), got, jax_det.names)
    assert len(diffs) == int(got.mask.sum()) > 0


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ObjectDetector(**KW)
