"""The whole first slice of the port against the JAX package on the CPU:
one synthetic capture through the JAX ``FusedScanRunner`` (f32) and the
port's runner on ``device="cpu"`` with the same carried weights, then 3D
NMS on both. The only CPU guard of the slice as a whole, so it stays in
the quick tier (~15 s)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm.data import synthetic
from tpu3dlm.data.dataset import load_scan
from tpu3dlm.mapper.nms3d import suppress_bboxes as jax_suppress
from tpu3dlm.models.beit import BeitClassifier as JaxBeit
from tpu3dlm.models.beit import BeitConfig as JaxBeitConfig
from tpu3dlm.models.yolov10 import YOLOv10 as JaxYOLOv10
from tpu3dlm.pipeline.fused import FusedScanRunner as JaxRunner
from test_torch_models import random_variables
from tpu3dlm_torch.data.scan import Scan
from tpu3dlm_torch.mapper.nms3d import suppress_bboxes
from tpu3dlm_torch.models.weights import beit_from_flax, yolov10_from_flax
from tpu3dlm_torch.parallel.inference import full_scan_step
from tpu3dlm_torch.pipeline.fused import FusedScanRunner

torch.set_num_threads(1)

# the SMALL_BEIT of tests/test_fused.py
SMALL_BEIT = JaxBeitConfig(
    image_size=32, hidden_size=32, num_layers=1, num_heads=2,
    intermediate_size=64, num_labels=2,
)
KW = dict(img_size=128, conf_thresh=0.3, max_det=8, nc=3)


def port_scan(scan) -> Scan:
    return Scan(**{f.name: getattr(scan, f.name) for f in dataclasses.fields(Scan)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scans"))
    synthetic.generate_scan(root, "gold_std", num_frames=3)
    base = os.path.join(root, "gold_std", "rtabmap_extract")
    scan = load_scan(
        image_dir=os.path.join(base, "data_rgb"),
        depth_image_dir=os.path.join(base, "data_depth"),
        calibration_dir=os.path.join(base, "calibration"),
        pose_path=os.path.join(root, "gold_std", "poses.txt"),
        img_size=128,
    )
    yv = random_variables(JaxYOLOv10(nc=3, variant="n"), jnp.zeros((1, 128, 128, 3)), 0)
    bv = random_variables(JaxBeit(SMALL_BEIT), jnp.zeros((1, 32, 32, 3)), 1)
    jax_runner = JaxRunner(
        beit_config=SMALL_BEIT, yolo_variables=yv, beit_variables=bv, dtype=jnp.float32, **KW
    )
    port_runner = FusedScanRunner(
        yolo=yolov10_from_flax(yv), beit=beit_from_flax(bv), dtype=torch.float32,
        device="cpu", **KW,
    )
    return scan, jax_runner(scan), port_runner(port_scan(scan)), port_runner


def test_fused_slice_matches_jax(runs):
    """Masks, labels and damage equal; boxes within 1e-3 px; world corners
    within 1e-4 m (f32 both sides, convolutions and matmuls summed in
    another order)."""
    _, (d_j, g_j), (d_p, g_p), _ = runs
    np.testing.assert_array_equal(d_p.mask, np.asarray(d_j.mask))
    assert d_p.mask.any()
    np.testing.assert_array_equal(d_p.label, np.asarray(d_j.label))
    np.testing.assert_array_equal(d_p.damage, np.asarray(d_j.damage))
    assert (d_p.damage[d_p.mask] >= 0).any()  # classification reached the records
    np.testing.assert_allclose(d_p.boxes, np.asarray(d_j.boxes), atol=1e-3)
    np.testing.assert_allclose(d_p.conf, np.asarray(d_j.conf), atol=1e-5)
    m = d_p.mask
    np.testing.assert_allclose(g_p.corners[m], np.asarray(g_j.corners)[m], atol=1e-4)
    assert g_p.to_frame_dict().keys() == g_j.to_frame_dict().keys()


def test_suppress_bboxes_matches_jax(runs):
    scan, (_, g_j), (_, g_p), _ = runs
    want = np.asarray(jax_suppress(g_j, scan.poses).mask)
    got = suppress_bboxes(g_p, scan.poses, device="cpu").mask
    np.testing.assert_array_equal(got, want)


def test_frame_bucket_padding_exact(runs):
    """3 frames pad to a bucket of 4 with inert frames; the result equals
    the unpadded step's exactly."""
    scan, _, (d_pad, g_pad), runner = runs
    s = port_scan(scan)
    d_exact, g_exact = runner._finalize(runner._dispatch(s), s.num_frames)
    for a, b in [(d_pad.mask, d_exact.mask), (d_pad.boxes, d_exact.boxes),
                 (d_pad.damage, d_exact.damage), (g_pad.corners, g_exact.corners)]:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("entry", ["runner", "step", "nms"])
def test_entry_points_refuse_cuda_without_a_card(entry):
    """No silent fallback: device='cuda' (the default) raises on a host
    without CUDA instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "runner":
            FusedScanRunner(**KW)
        elif entry == "step":
            full_scan_step(None, None, *([None] * 6), img_size=128, max_det=8, conf_thresh=0.3)
        else:
            suppress_bboxes(None, None)
