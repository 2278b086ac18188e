"""The hard evaluation of the port (the eval-only half of
``scripts/hard_eval.py``; training, ``--train``, is not ported yet: ROADMAP
A19).

    python -m tpu3dlm_torch.scripts.hard_eval --out <dir> [--device cuda|cpu]
        [--yolo ckpt.msgpack] [--beit ckpt.msgpack] [--quant none|int8]
        [--img-size 128] [--frames 14] [--seeds 11,23,37,53,71]
        [--skip-detector] [--skip-damage]

Runs ``pipeline/hardeval.py``'s detector corpus (``run_hard_eval``) and
damage corpus (``run_damage_hard_eval``) at the committed artifacts'
operating point (conf 0.3, 2 classes) with the given Flax checkpoints
(default: the committed fixtures, ``tests/fixtures/yolo_synthetic.msgpack``
and ``beit_synthetic.msgpack``) and writes ``hard_eval.json`` and
``damage_eval.json`` under ``--out``, a directory the caller names; it
refuses ``docs/``, where the committed artifacts live. Each report gets the
verdict of the committed artifact's gate under ``gate_verdict``
(``docs/ACCURACY_HARD_EVAL.json`` and ``ACCURACY_DAMAGE_EVAL.json``; their
``_FULL`` versions at ``--img-size 640``), and one JSON line per report
goes to stdout.

``check_hard_eval_report`` and ``check_damage_eval_report`` are the port's
copy of ``bench_e2e.py``'s gate checks: they apply a gate (by default the
report's own) to a report and give the same verdict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FIXTURES = REPO / "tests" / "fixtures"
DOCS = REPO / "docs"


def _report(report) -> dict:
    if isinstance(report, (str, os.PathLike)):
        with open(report) as f:
            return json.load(f)
    return report


def check_hard_eval_report(report, gate: dict | None = None) -> dict:
    """Gate a detector hard-eval report (a dict or a JSON path): the
    'combined' mAP50 inside [combined_map50_min, combined_map50_max], every
    axis above its floor, at least ``min_n_gt_per_axis`` ground-truth boxes
    per axis and the worst placement within ``placement_max_m``. ``gate``
    defaults to the report's own; a report with none fails as ungated."""
    rep = _report(report)
    gate = gate if gate is not None else rep.get("gate")
    if gate is None:
        print("SANITY FAILURE: hard-eval report carries no gate", file=sys.stderr)
        return {"ok": False, "ungated": True}
    combined = rep["axes"]["combined"]["map50"]
    ok = gate["combined_map50_min"] <= combined <= gate["combined_map50_max"]
    axis_fails = {
        a: rep["axes"][a]["map50"]
        for a, floor in gate.get("axis_map50_min", {}).items()
        if rep["axes"][a]["map50"] < floor
    }
    ok = ok and not axis_fails
    min_gt = gate.get("min_n_gt_per_axis")
    gt_fails = {}
    if min_gt:
        gt_fails = {a: e["n_gt"] for a, e in rep["axes"].items() if e.get("n_gt", 0) < min_gt}
        ok = ok and not gt_fails
    pmax = gate.get("placement_max_m")
    if pmax is not None:
        worst = max(v["worst_placement_m"] for v in rep["axes"].values() if "worst_placement_m" in v)
        ok = ok and worst <= pmax
    if not ok:
        print(
            f"SANITY FAILURE: hard-eval report outside gate (combined {combined} vs "
            f"[{gate['combined_map50_min']}, {gate['combined_map50_max']}], "
            f"axis fails {axis_fails}, n_gt fails {gt_fails})",
            file=sys.stderr,
        )
    return {
        "combined_map50": combined,
        "base_map50": rep["axes"]["base"]["map50"],
        "gate": gate,
        "ok": ok,
    }


def check_damage_eval_report(report, gate: dict | None = None) -> dict:
    """Gate a damage hard-eval report (a dict or a JSON path): per-axis
    accuracy floors, the clean axis's macro-F1 floor and at least
    ``min_pairs_per_axis`` matched pairs per axis. ``gate`` defaults to the
    report's own."""
    rep = _report(report)
    gate = gate if gate is not None else rep["gate"]
    axis_fails = {
        a: rep["axes"][a]["accuracy"]
        for a, floor in gate.get("axis_accuracy_min", {}).items()
        if rep["axes"][a]["accuracy"] < floor
    }
    ok = not axis_fails
    f1_min = gate.get("macro_f1_min")
    if f1_min is not None:
        ok = ok and rep["axes"]["clean"]["macro_f1"] >= f1_min
    min_pairs = gate.get("min_pairs_per_axis")
    pair_fails = {}
    if min_pairs:
        pair_fails = {a: e["n_pairs"] for a, e in rep["axes"].items() if e.get("n_pairs", 0) < min_pairs}
        ok = ok and not pair_fails
    if not ok:
        print(
            f"SANITY FAILURE: damage-eval report outside gate "
            f"(axis fails {axis_fails}, pair fails {pair_fails})",
            file=sys.stderr,
        )
    return {
        "clean_accuracy": rep["axes"]["clean"]["accuracy"],
        "worst_axis_accuracy": min(e["accuracy"] for e in rep["axes"].values()),
        "gate": gate,
        "ok": ok,
    }


def _artifact_gate(name: str, img_size: int) -> dict:
    suffix = "_FULL" if img_size == 640 else ""
    return _report(DOCS / f"ACCURACY_{name}{suffix}.json")["gate"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Hard evaluation of the port (eval only).")
    ap.add_argument("--out", required=True, help="directory for hard_eval.json and damage_eval.json")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--yolo", default=str(FIXTURES / "yolo_synthetic.msgpack"))
    ap.add_argument("--beit", default=str(FIXTURES / "beit_synthetic.msgpack"))
    ap.add_argument("--quant", default="none", choices=("none", "int8"), help="damage classifier weights")
    ap.add_argument("--img-size", type=int, default=128)
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--seeds", default="11,23,37,53,71")
    ap.add_argument("--skip-detector", action="store_true")
    ap.add_argument("--skip-damage", action="store_true")
    args = ap.parse_args(argv)

    out = Path(args.out).resolve()
    if out == DOCS or DOCS in out.parents:
        raise SystemExit(f"--out {out}: the committed artifacts in docs/ are not written here")
    from tpu3dlm_torch.device import resolve_device
    from tpu3dlm_torch.pipeline.hardeval import run_damage_hard_eval, run_hard_eval, write_report

    device = resolve_device(args.device)
    seeds = tuple(int(s) for s in args.seeds.split(","))
    common = dict(img_size=args.img_size, nc=2, conf=0.3, num_frames=args.frames, seeds=seeds, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        if not args.skip_detector:
            rep = run_hard_eval(args.yolo, os.path.join(tmp, "det"), **common)
            rep["gate_verdict"] = check_hard_eval_report(rep, _artifact_gate("HARD_EVAL", args.img_size))
            write_report(rep, str(out / "hard_eval.json"))
            print(json.dumps({"report": str(out / "hard_eval.json"), **rep["gate_verdict"]}), flush=True)
        if not args.skip_damage:
            rep = run_damage_hard_eval(args.yolo, args.beit, os.path.join(tmp, "dmg"), quant=args.quant,
                                       **common)
            rep["gate_verdict"] = check_damage_eval_report(rep, _artifact_gate("DAMAGE_EVAL", args.img_size))
            write_report(rep, str(out / "damage_eval.json"))
            print(json.dumps({"report": str(out / "damage_eval.json"), **rep["gate_verdict"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
