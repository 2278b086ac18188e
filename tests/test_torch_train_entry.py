"""The training entry points of the port on the CPU at a tiny size:
``python -m tpu3dlm_torch.scripts.hard_eval --train`` (its corpus is the
reference's ``training_specs``, the same numpy streams),
``python -m tpu3dlm_torch.scripts.e2e_accuracy`` and
``python -m tpu3dlm_torch.pipeline.selftrain``."""

import importlib.util
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu3dlm_torch.models.checkpoint import read_flax_msgpack
from tpu3dlm_torch.scripts import hard_eval as SH

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def reference_hard_eval():
    spec = importlib.util.spec_from_file_location("reference_hard_eval", REPO / "scripts" / "hard_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_training_specs_are_the_reference_corpus():
    """Every scene's keyword set equal to the reference's, signs,
    distractors and occluders field for field."""
    want = reference_hard_eval().training_specs()
    got = SH.training_specs()
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            if key in ("signs", "distractors", "occluders"):
                assert [vars(s) for s in g[key]] == [vars(s) for s in w[key]], key
            else:
                assert g[key] == w[key], key


def test_hard_eval_train_refuses_fixtures_docs_and_tests(tmp_path):
    with pytest.raises(SystemExit, match="update-fixtures"):
        SH.main(["--out", str(tmp_path), "--train", "--update-fixtures", "--device", "cpu"])
    with pytest.raises(SystemExit, match="tests"):
        SH.main(["--out", str(tmp_path), "--train", "--out-dir", str(REPO / "tests" / "fixtures"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="docs"):
        SH.main(["--out", str(tmp_path), "--train", "--out-dir", str(REPO / "docs" / "x"), "--device", "cpu"])


def test_hard_eval_train_end_to_end_tiny(tmp_path, capsys):
    """``--train`` with 2 YOLO and 2 BEiT steps on the whole corpus, then
    both evals on one seed of 2 frames: the checkpoints land in
    ``--out-dir`` in Flax's layout, and both reports carry the training
    seconds and their gate verdicts."""
    out, ck = tmp_path / "out", tmp_path / "ck"
    SH.main(["--out", str(out), "--train", "--steps", "2", "--beit-steps", "2", "--out-dir", str(ck),
             "--device", "cpu", "--seeds", "11", "--frames", "2"])
    assert sorted(os.listdir(ck)) == ["beit_hard.msgpack", "yolo_hard.msgpack"]
    assert set(read_flax_msgpack(str(ck / "yolo_hard.msgpack"))) == {"params", "batch_stats"}
    for name in ("hard_eval.json", "damage_eval.json"):
        rep = json.loads((out / name).read_text())
        assert rep["training_seconds"] > 0 and rep["yolo_steps"] == 2 and rep["beit_steps"] == 2
        assert rep["hardware"] == "cpu" and "gate_verdict" in rep
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_e2e_accuracy_verifies_the_fixture_checkpoints(tmp_path, monkeypatch):
    """``e2e_accuracy --skip-train`` over checkpoints already in
    ``--out-dir`` (the committed fixtures): the port's Pipeline both ways
    holds the scene's ground truth (placement ≤ 0.1 m, one missing sign,
    three rows), as the reference's run on them. The project takes
    tests/test_torch_evaluate.py's cut (f32, a 2048-point 10-iteration
    ICP), which keeps the CPU run short."""
    from tpu3dlm_torch.pipeline import evaluate
    from tpu3dlm_torch.scripts import e2e_accuracy

    cut = json.loads((REPO / "tests" / "fixtures" / "torch_eval" / "verify_jax_cpu.json").read_text())
    make_project = evaluate.make_project
    monkeypatch.setattr(evaluate, "make_project", lambda *a, **k: make_project(
        *a, extra_cfg=[tuple(p) for p in cut["config_patch"]], **k))

    fixtures = REPO / "tests" / "fixtures"
    shutil.copy(fixtures / "yolo_synthetic.msgpack", tmp_path / "yolo_synthetic.msgpack")
    shutil.copy(fixtures / "beit_synthetic.msgpack", tmp_path / "beit_synthetic.msgpack")
    report = e2e_accuracy.main(["--skip-train", "--out-dir", str(tmp_path), "--device", "cpu"])
    assert "training_seconds" not in report
    assert max(report["placement_errors_m"].values()) <= 0.1
    assert report["missing_flagged"] == 1 and report["rows"] == 3 and report["hardware"] == "cpu"


def test_selftrain_cli_writes_both_checkpoints(tmp_path):
    from tpu3dlm_torch.pipeline import selftrain

    gold = REPO / "tests" / "fixtures" / "torch_project" / "data" / "gold_std"
    selftrain.main(["--data-dir", str(gold), "--out-dir", str(tmp_path), "--img-size", "64", "--yolo-steps", "1",
                    "--beit-steps", "1", "--device", "cpu"])
    beit = read_flax_msgpack(str(tmp_path / "beit.msgpack"))["params"]
    assert np.shape(beit["patch_embed"]["kernel"]) == (16, 16, 3, 768)  # the default BEiT-base
    assert "batch_stats" in read_flax_msgpack(str(tmp_path / "yolo.msgpack"))
