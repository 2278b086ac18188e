"""The hard evaluation of the port, and the training that precedes it (port
of ``scripts/hard_eval.py``).

    python -m tpu3dlm_torch.scripts.hard_eval --out <dir> [--device cuda|cpu]
        [--yolo ckpt.msgpack] [--beit ckpt.msgpack] [--quant none|int8]
        [--img-size 128] [--frames 14] [--seeds 11,23,37,53,71]
        [--skip-detector] [--skip-damage]
        [--train [--full-scale] [--variant n|s|m] [--steps N]
         [--beit-steps N] [--out-dir <ckpt dir>]]

With ``--train`` it first trains both checkpoints on the reference's
domain-randomized corpus (``training_specs``: 14 scenes from
``SeedSequence([5000, i])``, the round-5 augmentation with random erasing,
a cosine schedule and EMA; 3000 YOLO steps at 128 px and 120 toy-BEiT
steps, or with ``--full-scale`` 4000 steps at 640² with 16 sampled frames a
step and 160 BEiT-base steps) and writes them under ``--out-dir``
(``yolo_hard[_full][_<variant>].msgpack``, ``beit_hard...``), never into
``tests/`` or ``docs/``; the reports then evaluate those. The reports carry
``training_seconds`` and ``hardware``. ``--update-fixtures`` is refused:
the committed fixtures are the reference's.

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

import torch

REPO = Path(__file__).resolve().parents[2]
FIXTURES = REPO / "tests" / "fixtures"
DOCS = REPO / "docs"
# the round-5 training recipe's detection augmentation (random erasing on,
# stronger photometric jitter)
HARD_AUGMENT = dict(erase_p=0.5, erase_count=2, erase_max=0.35, brightness=0.3, contrast=0.3)


def training_specs(n_scenes: int = 14, rng_seed: int = 5000) -> list[dict]:
    """The reference's domain-randomized training corpus: ``n_scenes``
    ``generate_scan`` keyword sets whose sign positions, sizes and colours
    are jittered wider than the eval's, mixing desaturation, oblique
    sweeps, distractors, occluders and depth noise, each from
    ``SeedSequence([rng_seed, i])`` (disjoint from the eval seeds). The
    same numpy streams as the reference, so the same scenes."""
    import numpy as np

    from tpu3dlm_torch.data.synthetic import Sign, default_signs
    from tpu3dlm_torch.pipeline.hardeval import distractor_set, jitter_signs, occluder_set

    specs = []
    for i in range(n_scenes):
        rng = np.random.default_rng(np.random.SeedSequence([rng_seed, i]))
        signs = jitter_signs(default_signs(), rng, pos=0.1, size=0.12, color=20.0)
        blend = float(rng.choice([0.0, 0.0, 0.2, 0.35, 0.5]))
        if blend:
            signs = [
                Sign(s.x0, s.y0, s.x1, s.y1, s.z,
                     tuple(int(round(v + blend * (180 - v))) for v in s.color),
                     label=s.label, damage=s.damage)
                for s in signs
            ]
        oblique = bool(rng.uniform() < 0.3)
        dx = float(rng.uniform(-0.2, 0.2))
        span = (-1.1 + dx, 2.2 + dx) if oblique else (-0.5 + dx, 1.6 + dx)
        kw = dict(
            num_frames=int(rng.integers(5, 10)),
            seed=1000 + i,
            signs=signs,
            yaw_phase=float(rng.uniform(0.0, 2 * np.pi)),
            yaw_amplitude=0.35 if oblique else float(rng.uniform(0.05, 0.2)),
            x_span=span,
        )
        r = float(rng.uniform())
        if r < 0.35:
            kw["distractors"] = jitter_signs(distractor_set(), rng, pos=0.15, size=0.15, color=15.0)
        if 0.25 < r < 0.65:
            kw["occluders"] = jitter_signs(occluder_set(), rng, pos=0.1, size=0.12, color=12.0)
        if rng.uniform() < 0.3:
            kw["depth_noise_m"] = 0.02
            kw["depth_dropout"] = 0.15
        specs.append(kw)
    return specs


def train_checkpoints(out_dir: str, img_size: int, nc: int, steps: int, beit_steps: int, full_scale: bool,
                      n_scenes: int = 14, variant: str = "n", device="cuda") -> tuple[str, str | None]:
    """Write the ``training_specs`` corpus, train both models on ``device``
    with the reference's recipe and write their checkpoints under
    ``out_dir`` → (yolo_ckpt, beit_ckpt or None when ``beit_steps`` is 0)."""
    import logging

    import numpy as np

    from tpu3dlm_torch.data import synthetic
    from tpu3dlm_torch.data.dataset import load_scan
    from tpu3dlm_torch.data.synthetic import load_scene_gt
    from tpu3dlm_torch.models.beit import BeitConfig
    from tpu3dlm_torch.models.checkpoint import write_flax_msgpack
    from tpu3dlm_torch.models.weights import beit_to_flax, yolov10_to_flax
    from tpu3dlm_torch.pipeline.evaluate import BEIT_KW, FULL_BEIT_KW
    from tpu3dlm_torch.pipeline.selftrain import (
        beit_training_crops,
        finetune_beit,
        finetune_yolo,
        yolo_training_arrays,
    )

    arrays, crops_all, dmg_all = [], [], []
    beit_kw = FULL_BEIT_KW if full_scale else BEIT_KW
    with tempfile.TemporaryDirectory(prefix="tpu3dlm_torch_hard_train_") as root:
        for i, spec in enumerate(training_specs(n_scenes)):
            folder = f"train_{i}"
            synthetic.generate_scan(root, folder, cloud_points_per_m2=800, **spec)
            base = os.path.join(root, folder, "rtabmap_extract")
            scan = load_scan(
                image_dir=os.path.join(base, "data_rgb"),
                depth_image_dir=os.path.join(base, "data_depth"),
                calibration_dir=os.path.join(base, "calibration"),
                pose_path=os.path.join(root, folder, "poses.txt"),
                img_size=img_size,
            )
            gt = load_scene_gt(os.path.join(root, folder, "gt.json"))
            arrays.append(yolo_training_arrays(gt["gt_boxes_2d"], scan))
            c, d = beit_training_crops(gt["gt_boxes_2d"], gt["gt_damage_2d"], scan, beit_kw["image_size"],
                                       device=device)
            crops_all.append(c)
            dmg_all.append(d)
    images, boxes, labels, mask = (np.concatenate([a[k] for a in arrays]) for k in range(4))
    logging.info("training corpus: %d frames, %d gt boxes", images.shape[0], int(mask.sum()))
    yolo = finetune_yolo(images, boxes, labels, mask, nc=nc, img_size=img_size, steps=steps,
                         augment=HARD_AUGMENT, variant=variant, schedule="cosine", ema_decay=0.995,
                         sample_batch=16 if full_scale else None, device=device)
    os.makedirs(out_dir, exist_ok=True)
    suffix = ("_full" if full_scale else "") + (f"_{variant}" if variant != "n" else "")
    yolo_path = os.path.join(out_dir, f"yolo_hard{suffix}.msgpack")
    write_flax_msgpack(yolo_path, yolov10_to_flax(yolo))
    beit_path = None
    if beit_steps > 0:
        cfg = BeitConfig(num_labels=2, **{k: v for k, v in beit_kw.items() if k != "num_labels"})
        beit = finetune_beit(np.concatenate(crops_all), np.concatenate(dmg_all), cfg, steps=beit_steps,
                             augment=True, device=device)
        beit_path = os.path.join(out_dir, f"beit_hard{suffix}.msgpack")
        write_flax_msgpack(beit_path, beit_to_flax(beit))
    return yolo_path, beit_path


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


def _refuse_inside(path: Path, roots: tuple[Path, ...], flag: str) -> None:
    path = path.resolve()
    for root in roots:
        if path == root or root in path.parents:
            raise SystemExit(f"{flag} {path}: the committed files under {root} are not written here")


def main(argv=None) -> int:
    import logging

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="Hard evaluation of the port, optionally after training.")
    ap.add_argument("--out", required=True, help="directory for hard_eval.json and damage_eval.json")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--yolo", default=None, help="detector checkpoint (default: the fixture, or the trained one)")
    ap.add_argument("--beit", default=None, help="classifier checkpoint (default: the fixture, or the trained one)")
    ap.add_argument("--quant", default="none", choices=("none", "int8"), help="damage classifier weights")
    ap.add_argument("--img-size", type=int, default=None, help="default 128, 640 with --full-scale")
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--seeds", default="11,23,37,53,71")
    ap.add_argument("--skip-detector", action="store_true")
    ap.add_argument("--skip-damage", action="store_true")
    ap.add_argument("--train", action="store_true", help="train both checkpoints on the training corpus first")
    ap.add_argument("--full-scale", action="store_true", help="YOLOv10 at 640², BEiT-base at 224²")
    ap.add_argument("--variant", default="n", choices=["n", "s", "m"], help="YOLOv10 width variant")
    ap.add_argument("--steps", type=int, default=None, help="YOLO steps (3000; 4000 with --full-scale)")
    ap.add_argument("--beit-steps", type=int, default=None, help="BEiT steps (120; 160 with --full-scale)")
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "tpu3dlm_torch_hard_ckpt"),
                    help="where --train writes its checkpoints")
    ap.add_argument("--update-fixtures", action="store_true", help="refused: the fixtures are the reference's")
    args = ap.parse_args(argv)

    if args.update_fixtures:
        raise SystemExit("--update-fixtures is not ported: tests/fixtures/*.msgpack are the reference's "
                         "checkpoints; write trained ones with --out-dir")
    out = Path(args.out).resolve()
    _refuse_inside(out, (DOCS,), "--out")
    _refuse_inside(Path(args.out_dir), (DOCS, REPO / "tests"), "--out-dir")
    import time

    from tpu3dlm_torch.device import resolve_device
    from tpu3dlm_torch.pipeline.evaluate import BEIT_KW, FULL_BEIT_KW
    from tpu3dlm_torch.pipeline.hardeval import run_damage_hard_eval, run_hard_eval, write_report

    device = resolve_device(args.device)
    img_size = args.img_size or (640 if args.full_scale else 128)
    yolo_ckpt = args.yolo or str(FIXTURES / "yolo_synthetic.msgpack")
    beit_ckpt = args.beit or str(FIXTURES / "beit_synthetic.msgpack")
    trained = {}
    if args.train:
        steps = args.steps or (4000 if args.full_scale else 3000)
        beit_steps = args.beit_steps if args.beit_steps is not None else (160 if args.full_scale else 120)
        if args.skip_damage and args.beit_steps is None:
            beit_steps = 0  # the classifier would go unused
        t0 = time.perf_counter()
        y, b = train_checkpoints(args.out_dir, img_size, 2, steps, beit_steps, args.full_scale,
                                 variant=args.variant, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        trained = {"training_seconds": time.perf_counter() - t0, "yolo_steps": steps, "beit_steps": beit_steps}
        yolo_ckpt = args.yolo or y
        beit_ckpt = args.beit or b or beit_ckpt
    hardware = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    seeds = tuple(int(s) for s in args.seeds.split(","))
    common = dict(img_size=img_size, nc=2, conf=0.3, num_frames=args.frames, seeds=seeds, device=device,
                  variant=args.variant)
    with tempfile.TemporaryDirectory() as tmp:
        if not args.skip_detector:
            rep = run_hard_eval(yolo_ckpt, os.path.join(tmp, "det"), **common)
            rep.update(hardware=hardware, checkpoint=os.path.basename(yolo_ckpt), **trained)
            rep["gate_verdict"] = check_hard_eval_report(rep, _artifact_gate("HARD_EVAL", img_size))
            write_report(rep, str(out / "hard_eval.json"))
            print(json.dumps({"report": str(out / "hard_eval.json"), **rep["gate_verdict"]}), flush=True)
        if not args.skip_damage:
            beit_kw = FULL_BEIT_KW if args.full_scale else BEIT_KW
            rep = run_damage_hard_eval(yolo_ckpt, beit_ckpt, os.path.join(tmp, "dmg"), quant=args.quant,
                                       beit_kw={k: v for k, v in beit_kw.items() if k != "num_labels"},
                                       **common)
            rep.update(hardware=hardware, checkpoint=os.path.basename(beit_ckpt), **trained)
            rep["gate_verdict"] = check_damage_eval_report(rep, _artifact_gate("DAMAGE_EVAL", img_size))
            write_report(rep, str(out / "damage_eval.json"))
            print(json.dumps({"report": str(out / "damage_eval.json"), **rep["gate_verdict"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
