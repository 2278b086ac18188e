"""The staged route's classifier (``tpu3dlm_torch/pipeline/classifier.py``)
against the JAX package's ``DamageDetector`` on the CPU, f32: the fixture
BEiT (``tests/fixtures/beit_synthetic.msgpack``, 32 px, 2 layers) over the
detections of the fixture YOLOv10-n on the committed capture's gold scan,
square and letterbox, in batches of 4 (a ragged last batch). Damage equal
(an argmax: no tolerance); every valid detection classified.

The staged route ROUNDS its crops to uint8 where the fused route truncates:
a pixel of 181 comes back from the /255 → ·255 round trip as 180.99998."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm.data.dataset import load_scan
from tpu3dlm.models import weights as JW
from tpu3dlm.models.beit import BeitClassifier as JaxBeit
from tpu3dlm.models.beit import BeitConfig as JaxBeitConfig
from tpu3dlm.models.yolov10 import YOLOv10 as JaxYOLOv10
from tpu3dlm.pipeline.classifier import DamageDetector as JaxDamage
from tpu3dlm.pipeline.detector import ObjectDetector as JaxDetector
from tpu3dlm_torch.data.scan import Detections, Scan
from tpu3dlm_torch.models.beit import BeitConfig
from tpu3dlm_torch.models.checkpoint import read_flax_msgpack
from tpu3dlm_torch.models.weights import beit_from_flax
from tpu3dlm_torch.ops.image import rectify_crops_mxu
from tpu3dlm_torch.pipeline import classifier as PCLS
from tpu3dlm_torch.pipeline.classifier import DamageDetector

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SCAN = os.path.join(FIXTURES, "torch_project", "data", "gold_std")
BEIT_KW = dict(image_size=32, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, num_labels=2)
LABELS = {0: "Undamaged", 1: "Damaged"}


def fixture_scan(resize_mode: str):
    ext = os.path.join(SCAN, "rtabmap_extract")
    return load_scan(os.path.join(ext, "data_rgb"), os.path.join(ext, "data_depth"),
                     os.path.join(ext, "calibration"), os.path.join(SCAN, "poses.txt"),
                     img_size=128, resize_mode=resize_mode)


def port_scan(scan) -> Scan:
    return Scan(**{f.name: getattr(scan, f.name) for f in dataclasses.fields(Scan)})


def port_det(det) -> Detections:
    return Detections(**{f.name: np.asarray(getattr(det, f.name)) for f in dataclasses.fields(Detections)})


@pytest.fixture(scope="module")
def models():
    path = os.path.join(FIXTURES, "yolo_synthetic.msgpack")
    yolo = JaxYOLOv10(nc=2, variant="n")
    yv = JW.load_flax_checkpoint(path, JW.init_template(yolo, jnp.zeros((1, 128, 128, 3), jnp.float32)))
    detector = JaxDetector(conf_thresh=0.1, img_size=128, batch_size=8, max_det=8, nc=2, variables=yv,
                           dtype=jnp.float32)
    path = os.path.join(FIXTURES, "beit_synthetic.msgpack")
    jcfg = JaxBeitConfig(**BEIT_KW)
    bv = JW.load_flax_checkpoint(path, JW.init_template(JaxBeit(jcfg), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    jax_cls = JaxDamage(num_labels=2, id2label=LABELS, config=jcfg, variables=bv, batch_size=4,
                        dtype=jnp.float32)
    port_cls = DamageDetector(num_labels=2, id2label=LABELS, config=BeitConfig(**BEIT_KW),
                              beit=beit_from_flax(read_flax_msgpack(path), BeitConfig(**BEIT_KW)),
                              batch_size=4, dtype=torch.float32, device="cpu")
    return detector, jax_cls, port_cls


@pytest.mark.parametrize("resize_mode", ["square", "letterbox"])
def test_classify_detections_matches_jax(models, resize_mode):
    detector, jax_cls, port_cls = models
    scan = fixture_scan(resize_mode)
    det = detector(scan)
    n_valid = int(np.asarray(det.mask).sum())
    assert n_valid > 4 and n_valid % 4  # more than one batch, the last one ragged
    want = jax_cls.classify_detections(scan, det)
    got = port_cls.classify_detections(port_scan(scan), port_det(det))
    np.testing.assert_array_equal(got.damage, np.asarray(want.damage))
    assert got.damage.dtype == np.int32
    m = np.asarray(det.mask)
    assert (got.damage[m] >= 0).all() and (got.damage[~m] == -1).all()  # every valid box, no budget
    for name in ("boxes", "conf", "label", "mask"):  # the rest passes through
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(det, name)))


def test_classify_crops_matches_jax(models):
    _, jax_cls, port_cls = models
    crops = np.random.default_rng(0).integers(0, 256, (10, 32, 32, 3), dtype=np.uint8)
    want = jax_cls.classify_crops(crops)
    got = port_cls.classify_crops(crops)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and len(set(got.tolist())) == 2  # both classes occur


def test_crops_round_where_the_fused_route_truncates():
    """A crop pixel that comes back as 180.99998 gives 181 on the staged
    route (the fused route's truncation gives 180); and on a real resample,
    every pixel that falls just short of an integer rounds up to it."""
    crop = torch.tensor([180.99998]) / 255.0
    assert float(crop * 255.0) < 181
    assert PCLS.crops_to_u8(crop).tolist() == [181]
    assert (crop * 255.0).to(torch.uint8).tolist() == [180]
    # half to even, and the clip
    assert PCLS.crops_to_u8(torch.tensor([0.5, 1.5, 2.5, -3.0, 300.0]) / 255.0).tolist() == [0, 2, 2, 0, 255]

    frame = torch.randint(0, 256, (1, 16, 16, 3), generator=torch.Generator().manual_seed(0),
                          dtype=torch.uint8)
    crops = rectify_crops_mxu(frame.float() / 255.0, torch.tensor([[[2.0, 3.0, 9.0, 12.0]]]), (16, 16))[:, 0]
    scaled = crops * 255.0
    short = scaled - scaled.floor() > 0.999
    assert int(short.sum()) > 0  # this resample has such pixels
    u8 = PCLS.crops_to_u8(crops)
    assert torch.equal(u8[short], scaled[short].ceil().to(torch.uint8))
    assert torch.equal(scaled.to(torch.uint8)[short] + 1, u8[short])


def test_classify_detections_feeds_rounded_crops(models, monkeypatch):
    """The crops that reach BEiT on the staged route are the rounded ones."""
    _, _, port_cls = models
    seen = []
    monkeypatch.setattr(port_cls, "_classify", lambda u8: seen.append(u8) or torch.zeros(u8.shape[0], dtype=torch.int32))
    scan = Scan(rgb=np.full((2, 64, 64, 3), 181, np.uint8), depth=np.zeros((2, 8, 8), np.float32),
                intrinsics=np.ones((2, 4), np.float32), rgb_size=np.full((2, 2), 64, np.float32),
                poses=np.tile(np.float32([0, 0, 0, 0, 0, 0, 1]), (2, 1)))
    det = Detections(boxes=np.tile(np.float32([3.5, 7.0, 50.25, 61.0]), (2, 3, 1)),
                     conf=np.full((2, 3), 0.9, np.float32), label=np.zeros((2, 3), np.int32),
                     damage=np.full((2, 3), -1, np.int32), mask=np.array([[1, 0, 1], [1, 1, 0]], bool))
    out = port_cls.classify_detections(scan, det)
    assert len(seen) == 1 and seen[0].shape == (4, 32, 32, 3) and bool((seen[0][:3] == 181).all())
    np.testing.assert_array_equal(out.damage, [[0, -1, 0], [0, 0, -1]])


def test_get_class_label_and_model_type():
    cls = DamageDetector(id2label=LABELS, config=BeitConfig(**BEIT_KW), device="cpu")
    assert cls.get_class_label(1) == "damaged"
    assert cls.get_class_label(np.int64(0)) == "undamaged"
    assert cls.get_class_label([1, 0]) == ["damaged", "undamaged"]
    assert DamageDetector(config=BeitConfig(**BEIT_KW), device="cpu").get_class_label(1) == "class_1"
    with pytest.raises(ValueError, match="Invalid model type"):
        DamageDetector(model_type="coarse", device="cpu")
    assert DamageDetector(model_type="detailed", config=BeitConfig(**BEIT_KW), device="cpu").model_type == "detailed"
