"""The alignment convergence-envelope sweep of the port (port of
``scripts/alignment_envelope.py``).

    python -m tpu3dlm_torch.scripts.alignment_envelope [--quick] [--seeds 3]
        [--device cuda|cpu] [--out alignment_envelope.json]

Sweeps the registration problem over the four axes that decide whether a
capture lands in the ICP basin — initial rotation (0-180°), overlap
fraction, outlier rate, point noise — one axis at a time off the nominal
point (full overlap, no outliers, 5 mm noise), on synthetic wall + signs
scenes with a known transform, for ``global_init`` centroid, pca and auto.
Each cell is one ``Alignment.compare`` on ``device`` (2048-point query, 25
iterations a stage). It reports each cell's success (rotation error < 5°
and translation error < 0.1 m against the known T⁻¹) and whether the
registration verdict flagged it, and the verdict's quality: of the failed
cells the share flagged (catch rate), of the passed the share flagged
(false-alarm rate). The scenes, the perturbations, the numpy streams and
the JSON are the reference script's, so the report compares cell by cell
with ``docs/ALIGNMENT_ENVELOPE.json``; ``--out`` is a file the caller
names outside ``docs/`` (where that reference artifact lives), and the
gate quality goes to stdout as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

DOCS = Path(__file__).resolve().parents[2] / "docs"


def make_scene(rng: np.random.Generator, n_wall: int = 3000):
    """Wall + three sign blocks + an off-plane ledge (so the scene is not
    degenerate-planar), and the sign box records for the anchor term."""
    wall = np.stack([
        rng.uniform(-2.0, 2.5, n_wall),
        rng.uniform(-1.25, 1.25, n_wall),
        np.full(n_wall, 3.0) + rng.normal(0, 0.002, n_wall),
    ], axis=1)
    cents = [(-0.4, -0.15, 2.8), (0.55, -0.25, 2.85), (1.45, 0.3, 2.8)]
    labels = [0, 1, 0]
    signs = []
    for c in cents:
        m = 400
        signs.append(np.stack([
            rng.uniform(c[0] - 0.2, c[0] + 0.2, m),
            rng.uniform(c[1] - 0.2, c[1] + 0.2, m),
            np.full(m, c[2]) + rng.normal(0, 0.002, m),
        ], axis=1))
    ledge = np.stack([
        rng.uniform(-2.0, 2.5, 600),
        np.full(600, -1.25) + rng.normal(0, 0.002, 600),
        rng.uniform(2.5, 3.0, 600),
    ], axis=1)
    cloud = np.concatenate([wall] + signs + [ledge]).astype(np.float32)

    boxes = {0: []}
    for c, lab in zip(cents, labels):
        c = np.asarray(c, np.float32)
        corners = [c + [-0.2, -0.2, 0], c + [-0.2, 0.2, 0], c + [0.2, 0.2, 0], c + [0.2, -0.2, 0]]
        boxes[0].append([np.asarray(x, np.float32) for x in corners] + [0, 0.9, lab])
    return cloud, boxes, cents, labels


def _rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def perturb(cloud, boxes, rng, rot_deg, overlap, outlier_rate, noise_m):
    """The comparison capture: the scene cropped to the overlap fraction
    (by x), noise and uniform-box outliers added, the world moved by T =
    rot_z + offset. Returns (comp_cloud, comp_boxes, T)."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = _rot_z(np.radians(rot_deg))
    T[:3, 3] = [0.5, -0.3, 0.15]

    x_lo = np.quantile(cloud[:, 0], 1.0 - overlap)
    keep = cloud[:, 0] >= x_lo
    comp = cloud[keep]
    if noise_m > 0:
        comp = comp + rng.normal(0, noise_m, comp.shape)
    if outlier_rate > 0:
        n_out = int(len(comp) * outlier_rate)
        lo, hi = comp.min(0) - 0.5, comp.max(0) + 0.5
        comp = np.concatenate([comp, rng.uniform(lo, hi, (n_out, 3))])
    comp = (comp @ T[:3, :3].T + T[:3, 3]).astype(np.float32)

    comp_boxes = {0: []}
    for row in boxes[0]:
        c = np.stack(row[:4]).mean(0)
        if c[0] < x_lo:  # sign left outside the captured region
            continue
        corners = [(np.asarray(x) @ T[:3, :3].T + T[:3, 3]).astype(np.float32) for x in row[:4]]
        comp_boxes[0].append(corners + row[4:])
    return comp, comp_boxes, T


def run_cell(cloud, boxes, rng, rot_deg, overlap, outlier_rate, noise_m, global_init,
             device="cuda") -> dict:
    """One registration of the perturbed capture onto the scene on
    ``device``: success against the known transform, and the verdict."""
    from tpu3dlm_torch.alignment.align import Alignment

    comp, comp_boxes, T = perturb(cloud, boxes, rng, rot_deg, overlap, outlier_rate, noise_m)
    poses = np.zeros((2, 7), np.float32)
    poses[:, 6] = 1.0
    a = Alignment(
        poses, poses, boxes, comp_boxes,
        base_cloud=cloud, comparison_cloud=comp,
        max_points=2048, icp_iterations=25,
        max_correspondence_dist=(1.0, 0.25, 0.1),
        global_init=global_init, device=device,
    )
    a.compare("cell")
    got = a.final_transform
    want = np.linalg.inv(T)
    R_err = got[:3, :3] @ want[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    t_err = float(np.linalg.norm(got[:3, 3] - want[:3, 3]))
    success = bool(ang < 5.0 and t_err < 0.1)
    v = a.last_verdict
    return {
        "success": success,
        "rot_err_deg": round(float(ang), 2),
        "t_err_m": round(t_err, 3),
        "flagged": bool(v is not None and not v.ok),
        "reasons": list(v.reasons) if v is not None else [],
        "inlier": round(v.inlier_frac, 3) if v else None,
        "rmse": round(v.rmse, 4) if v else None,
    }


def sweep(quick: bool = False, seeds: int = 3) -> list[tuple[dict, str, int]]:
    """Every cell of the sweep as (axes, init, seed), in the reference's
    order: the rotations at the nominal point, then overlap, outliers and
    noise at 30°, each against every init and seed."""
    if quick:
        rotations, overlaps, outliers, noises = [0, 45, 90, 150], [1.0, 0.5], [0.0, 0.2], [0.0, 0.01]
        inits, seeds = ["centroid", "auto"], 1
    else:
        rotations = [0, 15, 30, 45, 60, 90, 120, 150, 180]
        overlaps, outliers, noises = [1.0, 0.7, 0.5, 0.3], [0.0, 0.1, 0.3], [0.0, 0.005, 0.02]
        inits = ["centroid", "pca", "auto"]
    nominal = dict(overlap=1.0, outlier_rate=0.0, noise_m=0.005)
    axes = [dict(nominal, rot_deg=r) for r in rotations]
    axes += [dict(nominal, rot_deg=30, overlap=o) for o in overlaps[1:]]
    axes += [dict(nominal, rot_deg=30, outlier_rate=u) for u in outliers[1:]]
    axes += [dict(nominal, rot_deg=30, noise_m=z) for z in noises if z != 0.005]
    return [(cfg, init, s) for cfg in axes for init in inits for s in range(seeds)]


def cell_rng(cfg: dict, seed: int) -> np.random.Generator:
    """The reference's stream for one cell: scene, then perturbation."""
    return np.random.default_rng(np.random.SeedSequence([
        seed, int(cfg["rot_deg"] * 10), int(cfg["overlap"] * 100),
        int(cfg["outlier_rate"] * 100), int(cfg["noise_m"] * 1e4)]))


def gate_quality(cells: list[dict]) -> dict:
    """Catch rate on the failed cells, false-alarm rate on the passed."""
    fails = [c for c in cells if not c["success"]]
    passes = [c for c in cells if c["success"]]
    caught = sum(1 for c in fails if c["flagged"])
    false_alarm = sum(1 for c in passes if c["flagged"])
    return {
        "n_fail": len(fails),
        "n_pass": len(passes),
        "catch_rate": round(caught / len(fails), 3) if fails else None,
        "false_alarm_rate": round(false_alarm / len(passes), 3) if passes else None,
    }


def run_sweep(quick: bool = False, seeds: int = 3, device="cuda", log=None) -> dict:
    """The whole sweep → the report (the reference's JSON schema)."""
    t0 = time.time()
    cells = []
    for cfg, init, s in sweep(quick, seeds):
        rng = cell_rng(cfg, s)
        cloud, boxes, _, _ = make_scene(rng)
        res = run_cell(cloud, boxes, rng, global_init=init, device=device, **cfg)
        cells.append({**cfg, "init": init, "seed": s, **res})
        if log is not None:
            print(f"rot={cfg['rot_deg']:>3} ov={cfg['overlap']:.1f} out={cfg['outlier_rate']:.1f} "
                  f"nz={cfg['noise_m']:.3f} {init:>8} s{s}: {'OK ' if res['success'] else 'FAIL'} "
                  f"rot_err={res['rot_err_deg']:>6} flagged={res['flagged']} {res['reasons']}", file=log)
    return {
        "metric": "alignment_convergence_envelope",
        "date": time.strftime("%Y-%m-%d"),
        "wall_seconds": round(time.time() - t0, 1),
        "quick": quick,
        "seeds": 1 if quick else seeds,
        "cells": cells,
        "gate_quality": gate_quality(cells),
        "auto_init_gate": {"ratio": 0.7, "angle_deg": 30.0, "derivation": "see docs/ALIGNMENT_ENVELOPE.md"},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Alignment convergence-envelope sweep of the port.")
    ap.add_argument("--quick", action="store_true", help="the reduced sweep (4 rotations, 2 inits, 1 seed)")
    ap.add_argument("--out", default="alignment_envelope.json",
                    help="report path (default: ./alignment_envelope.json)")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if DOCS in Path(args.out).resolve().parents:
        raise SystemExit(f"--out {args.out}: docs/ holds the JAX package's reports; name a file elsewhere")
    report = run_sweep(args.quick, args.seeds, args.device, log=sys.stderr)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    print(json.dumps(report["gate_quality"]))
    return report


if __name__ == "__main__":
    main()
