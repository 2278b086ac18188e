"""The staged route end to end against the JAX package on the CPU: the
two-scan Pipeline through the port's CLI under the default
``fused_inference = false`` (``ObjectDetector``, then ``DamageDetector``
over every valid box, then projection in the map stage), against the JAX
package's staged Pipelines on a ``make_project`` capture (3 frames a scan,
800 points/m², the fixture checkpoints, ``infer_dtype = f32``, every other
setting at its default, ``icp_ann = auto`` included). Masks, labels and
damage equal, boxes within 1e-3 px, corners within 1e-4 m, the NMS
keep-mask identical, every ICP step within 1e-4, report rows and CSV bytes
identical, exactly one missing sign. Torch runs single-threaded, as in
``test_torch_pipeline.py``."""

import os
import shutil
import unittest.mock as mock

import pytest
import torch

import chip_smoke
from test_torch_pipeline import records_close, two_scans
from tpu3dlm.pipeline import evaluate
from tpu3dlm.pipeline import task as JT
from tpu3dlm.utils.config import ConfigLoader as JCfg
from tpu3dlm_torch import cli
from tpu3dlm_torch.pipeline import task as PT

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
EXTRA = [("infer_dtype = bf16", "infer_dtype = f32")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax"))
    cfg_jax, _, _, _ = evaluate.make_project(
        root, os.path.join(FIXTURES, "yolo_synthetic.msgpack"),
        os.path.join(FIXTURES, "beit_synthetic.msgpack"), extra_cfg=EXTRA, num_frames=3,
        cloud_points_per_m2=800)
    port_root = str(tmp_path_factory.mktemp("port"))
    shutil.copytree(os.path.join(root, "configs"), os.path.join(port_root, "configs"))
    cfg_port = os.path.join(port_root, "configs", "variables.cfg")
    text = open(cfg_port).read()
    assert "fused_inference = false" in text and "icp_ann = auto" in text
    with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None):
        jax_runs = two_scans(cfg_jax, JT, JCfg)
    seen, staged = [], []
    real_setup, real_detect = PT.setup_pipeline, PT.Pipeline._detect_signs

    def detect_signs(self, scan):
        staged.append(self.data_folder)
        return real_detect(self, scan)

    with mock.patch.object(PT, "setup_pipeline", lambda *a, **k: seen.append(real_setup(*a, **k)) or seen[-1]), \
            mock.patch.object(PT.Pipeline, "_detect_signs", detect_signs):
        cli.main(["--data", "maintenance", "--config", cfg_port, "--device", "cpu"])
    assert [p.data_folder for p in seen] == ["gold_std", "maintenance"]
    assert staged == ["gold_std", "maintenance"]  # both scans took the staged route
    return dict(jax=jax_runs, port=tuple(seen))


def test_staged_detections_boxes_and_nms_match_jax(runs):
    for j, p in zip(runs["jax"], runs["port"]):
        a, b = p.data_to_save, j.data_to_save
        n = sum(len(v) for v in b["predictions"].values())
        assert n > 0
        # every valid detection was classified
        assert all(rec[4] >= 0 for recs in a["predictions"].values() for rec in recs)
        records_close(a["predictions"], b["predictions"], 1e-3)
        records_close(a["global_bboxes_data"], b["global_bboxes_data"], 1e-4)
        records_close(a["optimised_bboxes"], b["optimised_bboxes"], 1e-4)
        assert list(p.stage_times) == list(j.stage_times)


def test_staged_compare_and_csv_match_jax(runs):
    a, b = runs["port"][1].data_to_save, runs["jax"][1].data_to_save
    assert chip_smoke._steps_err(a["transformations"], b["transformations"]) <= 1e-4
    assert a["alignment_verdict"]["reasons"] == b["alignment_verdict"]["reasons"]
    assert a["comparison_rows"] == b["comparison_rows"]
    assert sum(r["status"] == "missing" for r in a["comparison_rows"]) == 1
    csv = [open(runs[k][1].cfg.csv_output, "rb").read() for k in ("port", "jax")]
    assert csv[0] == csv[1] and csv[0].count(b"missing") == 1
