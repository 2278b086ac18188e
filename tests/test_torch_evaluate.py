"""The slice's whole path on the CPU: the port's ``make_project`` and
``verify`` (``tpu3dlm_torch/pipeline/evaluate.py``) and the CLI's cold start
(``--setup``), with the committed fixture checkpoints.

Tolerances: ``verify``'s own ground-truth assertions (placement ≤ 0.1 m,
exactly the dropped sign missing, matched rows with ground-truth damage);
against the JAX package's ``verify`` on the project its ``make_project``
writes (``tests/fixtures/torch_eval/verify_jax_cpu.json``, written by
``make_reports.py`` there): placement errors within 1e-4 m,
``missing_flagged`` and ``rows`` equal, detection metrics within 1e-3. All
runs use ``VERIFY_CFG``: f32 inference and a 2048-point, 10-iteration ICP.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from tpu3dlm_torch.data.synthetic import Sign, SyntheticScene
from tpu3dlm_torch.pipeline.evaluate import make_project, verify

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
YOLO, BEIT = str(FIXTURES / "yolo_synthetic.msgpack"), str(FIXTURES / "beit_synthetic.msgpack")
WANT = json.loads((FIXTURES / "torch_eval" / "verify_jax_cpu.json").read_text())
VERIFY_CFG = [tuple(p) for p in WANT["config_patch"]]


def test_port_project_passes_port_verify(tmp_path):
    cfg, data_root, gold, tw = make_project(str(tmp_path), YOLO, BEIT, extra_cfg=VERIFY_CFG)
    assert sorted(os.listdir(data_root)) == ["gold_std", "maintenance"]
    rep = verify(cfg, gold, device="cpu")
    assert max(rep["placement_errors_m"].values()) <= 0.1
    assert rep["missing_flagged"] == 1 and rep["rows"] == len(gold.signs)
    assert rep["detection"]["num_ground_truth"] == sum(len(v) for v in gold.gt_boxes_2d.values())


def _scene_from_gt(path: Path) -> SyntheticScene:
    gt = json.loads(path.read_text())
    signs = [Sign(s["x0"], s["y0"], s["x1"], s["y1"], s["z"], tuple(s["color"]), s["label"], s["damage"])
             for s in gt["signs"]]
    return SyntheticScene(signs=signs, wall_z=gt["wall_z"], poses=np.zeros((0, 7)), timestamps=np.zeros(0),
                          rgb_wh=tuple(gt["rgb_wh"]), depth_wh=tuple(gt["depth_wh"]),
                          intrinsics=tuple(gt["intrinsics"]),
                          gt_boxes_2d={int(k): v for k, v in gt["gt_boxes_2d"].items()},
                          gt_damage_2d={int(k): v for k, v in gt["gt_damage_2d"].items()})


def test_verify_on_a_jax_project_equals_jax_report(tmp_path):
    from tpu3dlm.pipeline.evaluate import make_project as j_make_project

    cfg, data_root, _, _ = j_make_project(str(tmp_path), YOLO, BEIT, extra_cfg=VERIFY_CFG)
    rep = verify(cfg, _scene_from_gt(Path(data_root, "gold_std", "gt.json")), device="cpu")
    for k, v in WANT["placement_errors_m"].items():
        assert abs(rep["placement_errors_m"][int(k)] - v) <= 1e-4, (k, rep["placement_errors_m"])
    assert (rep["missing_flagged"], rep["rows"]) == (WANT["missing_flagged"], WANT["rows"])
    got, want = rep["detection"], WANT["detection"]
    for key in ("map50", "map50_95", "precision", "recall"):
        assert abs(got[key] - want[key]) <= 1e-3, key
    for key in ("per_class_ap50", "per_class_ap"):
        assert {str(c): pytest.approx(v, abs=1e-3) for c, v in got[key].items()} == want[key]
    assert (got["num_predictions"], got["num_ground_truth"]) == (want["num_predictions"],
                                                                 want["num_ground_truth"])


def test_cli_setup_gold_then_maintenance(tmp_path, monkeypatch):
    """``--data gold_std --setup`` then ``--data maintenance --setup``: each
    writes its capture (8 frames, the generator's defaults) and runs the
    Pipeline on it; the maintenance run compares against gold."""
    from tpu3dlm_torch import cli
    from tpu3dlm_torch.pipeline.evaluate import IMG_SIZE, _cfg_patch
    from tpu3dlm_torch.utils.config import DEFAULT_CONFIG, ConfigLoader

    text = DEFAULT_CONFIG
    for old, new in _cfg_patch(IMG_SIZE, {"image_size": 32, "hidden_size": 32, "num_layers": 2, "num_heads": 2,
                                          "intermediate_size": 64}) + [
            ("yolo_weights =", f"yolo_weights = {YOLO}"), ("beit_weights =", f"beit_weights = {BEIT}")] + VERIFY_CFG:
        assert old in text
        text = text.replace(old, new)
    cfg = tmp_path / "configs" / "variables.cfg"
    cfg.parent.mkdir(parents=True)
    cfg.write_text(text)
    monkeypatch.chdir(tmp_path)
    cli.main(["--data", "gold_std", "--setup", "--config", str(cfg), "--device", "cpu"])
    gold = ConfigLoader(str(cfg), "gold_std")
    assert len(os.listdir(gold.image_dir)) == 8 and os.path.exists(gold.pickle_path)
    cli.main(["--data", "maintenance", "--setup", "--config", str(cfg), "--device", "cpu"])
    maint = ConfigLoader(str(cfg), "maintenance")
    assert os.path.exists(maint.csv_output) and os.path.exists(maint.pickle_path)
