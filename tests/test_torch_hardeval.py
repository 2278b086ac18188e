"""The port's hard eval (``tpu3dlm_torch/pipeline/hardeval.py``) against the
JAX package's reports on the CPU, and the port's copy of the artifact gates
(``tpu3dlm_torch/scripts/hard_eval.py``) against ``bench_e2e.py``'s.

The JAX reports are committed (``tests/fixtures/torch_eval/*_reduced_jax_
cpu.json``, written by ``make_reports.py`` there): the reduced corpus at
the artifacts' settings — seed 11, 4 frames, detector axes base, occlusion
and depth_noise, damage axes clean and crop_occlusion, img_size 128, conf
0.3, the committed fixture checkpoints. Tolerances: ``n_gt``, ``n_pred``
and ``n_pairs`` identical; mAP50 and accuracy within 0.02; the worst
placement within 1e-3 m. The gate verdicts are equal.
"""

import copy
import json
from pathlib import Path

import pytest

import bench_e2e
from tpu3dlm_torch.pipeline import hardeval as TH
from tpu3dlm_torch.scripts import hard_eval as SH

REPO = Path(__file__).resolve().parent.parent
EVAL = REPO / "tests" / "fixtures" / "torch_eval"
YOLO = str(REPO / "tests" / "fixtures" / "yolo_synthetic.msgpack")
BEIT = str(REPO / "tests" / "fixtures" / "beit_synthetic.msgpack")
REDUCED = dict(img_size=128, nc=2, conf=0.3, num_frames=4, seeds=(11,), device="cpu")


def _load(name: str) -> dict:
    return json.loads((EVAL / name).read_text())


def test_detector_hard_eval_matches_jax(tmp_path):
    want = _load("hard_eval_reduced_jax_cpu.json")
    got = TH.run_hard_eval(YOLO, str(tmp_path), axes=list(want["axes"]), **REDUCED)
    assert set(got["axes"]) == set(want["axes"]) == {"base", "occlusion", "depth_noise"}
    for axis, w in want["axes"].items():
        g = got["axes"][axis]
        assert (g["n_gt"], g["n_pred"]) == (w["n_gt"], w["n_pred"]), axis
        assert abs(g["map50"] - w["map50"]) <= 0.02, (axis, g["map50"], w["map50"])
        if "worst_placement_m" in w:
            assert abs(g["worst_placement_m"] - w["worst_placement_m"]) <= 1e-3, axis
    assert set(got["stage_seconds"]) >= {"generate", "load", "detect"}


def test_damage_hard_eval_matches_jax(tmp_path):
    want = _load("damage_eval_reduced_jax_cpu.json")
    got = TH.run_damage_hard_eval(YOLO, BEIT, str(tmp_path), axes=tuple(want["axes"]), **REDUCED)
    for axis, w in want["axes"].items():
        g = got["axes"][axis]
        assert g["n_pairs"] == w["n_pairs"] > 0, axis
        assert abs(g["accuracy"] - w["accuracy"]) <= 0.02, (axis, g["accuracy"], w["accuracy"])
    q = TH.run_damage_hard_eval(YOLO, BEIT, str(tmp_path / "q"), axes=("clean",), quant="int8", **REDUCED)
    assert q["quant"] == "int8" and q["axes"]["clean"]["n_pairs"] == want["axes"]["clean"]["n_pairs"]
    assert abs(q["axes"]["clean"]["accuracy"] - got["axes"]["clean"]["accuracy"]) <= 0.03


ARTIFACTS = ["ACCURACY_HARD_EVAL.json", "ACCURACY_HARD_EVAL_FULL.json", "ACCURACY_HARD_EVAL_FULL_S.json"]


def _patched(rep: dict, kind: str) -> dict:
    rep = copy.deepcopy(rep)
    gate = rep["gate"]
    if kind == "floor":
        rep["axes"]["combined"]["map50"] = gate["combined_map50_min"] - 0.01
    elif kind == "ceiling":
        rep["axes"]["combined"]["map50"] = min(1.0, gate["combined_map50_max"] + 0.01)
    elif kind == "collapsed":
        axis = sorted(gate.get("axis_map50_min", {"base": 0}))[0]
        rep["axes"][axis]["map50"] = 0.0
    elif kind == "power":
        rep["axes"]["base"]["n_gt"] = 3
    return rep


@pytest.mark.parametrize("kind", ["as_committed", "floor", "ceiling", "collapsed", "power"])
@pytest.mark.parametrize("name", ARTIFACTS)
def test_hard_eval_gate_copy_gives_bench_e2e_verdicts(tmp_path, monkeypatch, name, kind):
    rep = json.loads((REPO / "docs" / name).read_text())
    if kind != "as_committed":
        rep = _patched(rep, kind)
    path = tmp_path / name
    path.write_text(json.dumps(rep))
    want = bench_e2e.check_hard_eval_report(str(path))
    assert SH.check_hard_eval_report(str(path)) == want
    assert SH.check_hard_eval_report(rep, rep["gate"]) == want
    if kind != "as_committed" and kind != "power":
        assert want["ok"] is False


DAMAGE = ["ACCURACY_DAMAGE_EVAL.json", "ACCURACY_DAMAGE_EVAL_FULL.json"]


@pytest.mark.parametrize("kind", ["as_committed", "collapsed", "power", "f1"])
@pytest.mark.parametrize("name", DAMAGE)
def test_damage_gate_copy_gives_bench_e2e_verdicts(tmp_path, name, kind):
    rep = json.loads((REPO / "docs" / name).read_text())
    if kind == "collapsed":
        rep["axes"]["crop_occlusion"]["accuracy"] = 0.1
    elif kind == "power":
        rep["axes"]["clean"]["n_pairs"] = 3
    elif kind == "f1":
        rep["axes"]["clean"]["macro_f1"] = 0.0
    path = tmp_path / name
    path.write_text(json.dumps(rep))
    want = bench_e2e.check_damage_eval_report(str(path))
    assert SH.check_damage_eval_report(str(path)) == want
    if kind != "as_committed":
        assert want["ok"] is False


def test_gates_applied_to_the_jax_cpu_reports():
    """The committed JAX CPU reports of the full fixture corpus under the
    committed artifacts' gates: both pass (printed in ``eval_parity``)."""
    gate = json.loads((REPO / "docs" / "ACCURACY_HARD_EVAL.json").read_text())["gate"]
    assert SH.check_hard_eval_report(_load("hard_eval_jax_cpu.json"), gate)["ok"]
    gate = json.loads((REPO / "docs" / "ACCURACY_DAMAGE_EVAL.json").read_text())["gate"]
    assert SH.check_damage_eval_report(_load("damage_eval_jax_cpu.json"), gate)["ok"]
    assert SH.check_hard_eval_report({"axes": {}}) == {"ok": False, "ungated": True}


def test_entry_point_refuses_docs_and_writes_reports(tmp_path, capsys):
    with pytest.raises(SystemExit, match="docs"):
        SH.main(["--out", str(REPO / "docs"), "--device", "cpu"])
    SH.main(["--out", str(tmp_path), "--device", "cpu", "--seeds", "11", "--frames", "2", "--skip-detector"])
    rep = json.loads((tmp_path / "damage_eval.json").read_text())
    assert set(rep["axes"]) == set(TH.DAMAGE_AXES) and "gate_verdict" in rep
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["report"].endswith("damage_eval.json")
