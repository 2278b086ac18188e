"""Hard evaluation corpus and its evaluation (port of
``tpu3dlm/pipeline/hardeval.py``).

A corpus of synthetic scenes whose axes each stress one failure mode the
easy corpus cannot (``AXES``: base, distractors, occlusion, oblique,
confusable, depth_noise, combined; each evaluated on ``EVAL_SEEDS``
independently jittered scene instances), and the damage classifier's
stress axes (``DAMAGE_AXES``: clean, blur, exposure, crop_occlusion,
box_jitter) through the real detect → rectify → classify path. The corpus
(``axis_kwargs``, ``generate_axis_scan``, the perturbations) is the JAX
package's, scene for scene: the same seeds give the same files and ground
truth. The models run on ``device`` through the port: the detector's
YOLOv10, and the classifier's BEiT on kernel B1, in float or, with
``quant="int8"``, quantised (``models/weights.py::
quantize_beit_variables``).

Scoring: ``pipeline/metrics.evaluate_detections`` (COCO mAP50 / mAP50-95)
on the detector's frame records against the corpus ground truth; the depth
axis adds the worst sign placement error through ``project_detections`` +
3D NMS against the closed-form corners; the damage axes score the damage
confusion of IoU-matched (prediction, ground-truth) pairs. Each report
carries ``stage_seconds``: wall-clock seconds of corpus generation, scan
loading, detection and (damage) classification.

The blur axis's ``cv2.GaussianBlur(img, (0, 0), 3.0)`` is ``gaussian_blur``
here: OpenCV's bit-exact fixed-point path for 8-bit images, in numpy.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time

import numpy as np
import torch

from tpu3dlm_torch.data.synthetic import Sign, default_signs

logger = logging.getLogger(__name__)


def distractor_set() -> list[Sign]:
    """Sign-shaped non-signs in colors between/near the trained classes.

    label=-1 marks them non-ground-truth (generate_scan never emits GT for
    distractor entries regardless of label; -1 is documentation)."""
    return [
        Sign(-1.35, -0.1, -0.95, 0.35, 2.82, (150, 60, 50), label=-1),   # dull red
        Sign(0.95, -0.55, 1.35, -0.2, 2.84, (60, 130, 80), label=-1),    # dull green
        Sign(1.95, -0.35, 2.35, 0.05, 2.8, (90, 90, 150), label=-1),     # grey-blue
        Sign(-0.05, 0.25, 0.4, 0.6, 2.86, (200, 120, 60), label=-1),     # orange
    ]


def occluder_set() -> list[Sign]:
    """Vertical panels between the camera and the wall, crossing signs 0
    and 2 of the default set (and wherever the confusable set places its
    signs) — a sign behind a panel keeps only its visible extent as GT."""
    return [
        Sign(-0.45, -1.2, -0.28, 1.2, 2.3, (110, 95, 80), label=-1),
        Sign(1.38, -1.2, 1.52, 1.2, 2.25, (95, 105, 90), label=-1),
    ]


def confusable_signs(strength: float = 0.45) -> list[Sign]:
    """The default signs with colors blended toward the wall grey (180) —
    the detector's color cue degrades continuously with ``strength``
    (0 = original saturated colors, 1 = invisible against the wall)."""
    base = default_signs()
    out = []
    for s in base:
        c = tuple(
            int(round(v + strength * (180 - v))) for v in s.color
        )
        out.append(
            Sign(s.x0, s.y0, s.x1, s.y1, s.z, c, label=s.label, damage=s.damage)
        )
    return out


AXES: dict[str, dict] = {
    "base": {},
    "distractors": {"distractors": distractor_set()},
    "occlusion": {"occluders": occluder_set()},
    "oblique": {"yaw_amplitude": 0.35, "x_span": (-1.1, 2.2)},
    "confusable": {"signs": confusable_signs(0.45)},
    "depth_noise": {"depth_noise_m": 0.025, "depth_dropout": 0.25},
    # the flagship below-ceiling number: every axis at MODERATE severity —
    # full-severity axes stacked multiply into ~0, which is as blind as a
    # saturated 1.0; the gate needs a value that MOVES when any one thing
    # regresses
    "combined": {
        "signs": confusable_signs(0.25),
        "distractors": distractor_set(),
        "occluders": occluder_set()[:1],
        "yaw_amplitude": 0.18,
        "x_span": (-0.8, 1.9),
        "depth_noise_m": 0.015,
        "depth_dropout": 0.1,
    },
}

# The evaluation seed set: each axis is scored on len(EVAL_SEEDS)
# independently jittered scene instances and reported as mean +/- spread,
# so one flipped detection moves the axis number by ~1 point.
EVAL_SEEDS: tuple[int, ...] = (11, 23, 37, 53, 71)


def jitter_signs(
    signs: list[Sign],
    rng: np.random.Generator,
    pos: float = 0.06,
    size: float = 0.08,
    color: float = 14.0,
    z_jitter: float = 0.02,
) -> list[Sign]:
    """Per-seed scene variation: translate/rescale each sign and shift its
    color, keeping labels/damage. Magnitudes are bounded so the structural
    invariants every axis depends on survive (occluder panels still cross
    the signs they were placed to occlude; distractor colors stay NEAR but
    not ON the class colors)."""
    out = []
    for s in signs:
        dx, dy = rng.uniform(-pos, pos, 2)
        sw = (s.x1 - s.x0) * (1.0 + rng.uniform(-size, size))
        sh = (s.y1 - s.y0) * (1.0 + rng.uniform(-size, size))
        cx = (s.x0 + s.x1) / 2 + dx
        cy = (s.y0 + s.y1) / 2 + dy
        c = tuple(
            int(np.clip(v + rng.uniform(-color, color), 0, 255))
            for v in s.color
        )
        out.append(
            Sign(
                cx - sw / 2, cy - sh / 2, cx + sw / 2, cy + sh / 2,
                s.z + float(rng.uniform(-z_jitter, z_jitter)),
                c, label=s.label, damage=s.damage,
            )
        )
    return out


def axis_kwargs(axis: str, seed: int) -> dict:
    """Seeded `generate_scan` config for one axis instance.

    Every axis (including `base`) draws jittered sign geometry/colors, a
    trajectory x-offset, and a yaw phase from `seed`, so different seeds
    view genuinely different scenes from different angles — the severity
    knobs (distractors/occluders/desaturation/noise) stay per-axis fixed
    so the axis still measures ONE failure mode."""
    import zlib

    # zlib.crc32, NOT hash(): str hashes are salted per-process and would
    # silently break cross-run corpus determinism
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(axis.encode())])
    )
    signs = jitter_signs(default_signs(), rng)
    dx = float(rng.uniform(-0.12, 0.12))
    traj = {
        "yaw_phase": float(rng.uniform(0.0, 2 * np.pi)),
        "x_span": (-0.5 + dx, 1.6 + dx),
    }

    def blend(sgns, strength):
        return [
            Sign(
                s.x0, s.y0, s.x1, s.y1, s.z,
                tuple(int(round(v + strength * (180 - v))) for v in s.color),
                label=s.label, damage=s.damage,
            )
            for s in sgns
        ]

    # occluders/distractors jitter gently (x +/- 0.04 keeps the panels
    # crossing the signs' jittered x-ranges; see occluder_set geometry)
    dis = jitter_signs(distractor_set(), rng, pos=0.08, size=0.1, color=10.0)
    occ = jitter_signs(occluder_set(), rng, pos=0.04, size=0.06, color=8.0)

    if axis == "base":
        return {"signs": signs, **traj}
    if axis == "distractors":
        return {"signs": signs, "distractors": dis, **traj}
    if axis == "occlusion":
        return {"signs": signs, "occluders": occ, **traj}
    if axis == "oblique":
        return {
            "signs": signs,
            "yaw_amplitude": 0.35,
            "yaw_phase": traj["yaw_phase"],
            "x_span": (-1.1 + dx, 2.2 + dx),
        }
    if axis == "confusable":
        return {"signs": blend(signs, 0.45), **traj}
    if axis == "depth_noise":
        return {
            "signs": signs, "depth_noise_m": 0.025, "depth_dropout": 0.25,
            **traj,
        }
    if axis == "combined":
        return {
            "signs": blend(signs, 0.25),
            "distractors": dis,
            "occluders": occ[:1],
            "yaw_amplitude": 0.18,
            "yaw_phase": traj["yaw_phase"],
            "x_span": (-0.8 + dx, 1.9 + dx),
            "depth_noise_m": 0.015,
            "depth_dropout": 0.1,
        }
    raise KeyError(f"unknown hard-eval axis {axis!r} (have {list(AXES)})")


def generate_axis_scan(root: str, axis: str, num_frames: int = 7, seed: int = 7):
    """Write one seeded axis instance under <root>/<axis>_s<seed>/ and
    return its scene. The scan folder is seed-qualified so multi-seed
    sweeps coexist under one root."""
    from tpu3dlm_torch.data import synthetic

    return synthetic.generate_scan(
        root, f"{axis}_s{seed}", num_frames=num_frames, seed=seed,
        cloud_points_per_m2=1200, **axis_kwargs(axis, seed),
    )


def _gaussian_kernel_u16(sigma: float) -> np.ndarray:
    """OpenCV's 8-bit Gaussian taps in 8 fraction bits: ksize
    ``round(6σ + 1) | 1``, the bit-exact double kernel
    (``getGaussianKernelBitExact``) rounded by error diffusion from the
    edges in, the centre tap taking what makes the sum exactly 256
    (``getGaussianKernelFixedPoint_ED``)."""
    n = int(round(sigma * 3 * 2 + 1)) | 1
    scale2x = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    values = [math.exp(float(x * x) * scale2x) for x in range(1 - n, 1 - n + 2 * half, 2)]
    total = 0.0
    for t in values:
        total += t
    total = total * 2.0 + 1.0
    mul = 1.0 / total
    taps = np.zeros(n, np.int64)
    err = 0.0
    acc = 0
    for i in range(half):
        adj = values[i] * mul * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        taps[i] = taps[n - 1 - i] = v
        acc += v
    taps[half] = 256 - 2 * acc
    return taps


def gaussian_blur(img: np.ndarray, sigma: float = 3.0) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` on a uint8 (H, W[, C]) image:
    BORDER_REFLECT_101, the rows filtered in 8 fraction bits, then the
    columns in 16, rounded half up (OpenCV's fixed-point path)."""
    k = _gaussian_kernel_u16(sigma)
    r = len(k) // 2
    x = np.asarray(img)
    if x.dtype != np.uint8:
        raise ValueError(f"gaussian_blur takes uint8 images, got {x.dtype}")
    h, w = x.shape[:2]
    if min(h, w) <= r:
        raise ValueError(f"gaussian_blur: image {x.shape} smaller than the kernel radius {r}")
    pad = [(0, 0), (r, r)] + [(0, 0)] * (x.ndim - 2)
    xp = np.pad(x.astype(np.int64), pad, mode="reflect")
    rows = sum(k[i] * xp[:, i:i + w] for i in range(len(k)))
    pad = [(r, r), (0, 0)] + [(0, 0)] * (x.ndim - 2)
    rp = np.pad(rows, pad, mode="reflect")
    cols = sum(k[i] * rp[i:i + h] for i in range(len(k)))
    return np.clip((cols + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def _load_detector(yolo_ckpt, img_size: int, nc: int, conf: float, max_det: int = 16,
                   variant: str = "n", device="cuda", dtype: torch.dtype = torch.float32):
    """The port's ``ObjectDetector`` on a Flax ``.msgpack`` checkpoint (the
    port's reader) or on a given ``YOLOv10`` module."""
    from tpu3dlm_torch.models.checkpoint import read_flax_msgpack
    from tpu3dlm_torch.models.weights import yolov10_from_flax
    from tpu3dlm_torch.pipeline.detector import ObjectDetector

    yolo = (yolov10_from_flax(read_flax_msgpack(yolo_ckpt), variant=variant, nc=nc)
            if isinstance(yolo_ckpt, (str, os.PathLike)) else yolo_ckpt)
    return ObjectDetector(conf_thresh=conf, img_size=img_size, nc=nc, yolo=yolo, max_det=max_det,
                          variant=variant, device=device, dtype=dtype)


def _load_scan(out_root: str, folder: str, img_size: int):
    from tpu3dlm_torch.data.dataset import load_scan

    base = os.path.join(out_root, folder, "rtabmap_extract")
    return load_scan(
        image_dir=os.path.join(base, "data_rgb"),
        depth_image_dir=os.path.join(base, "data_depth"),
        calibration_dir=os.path.join(base, "calibration"),
        pose_path=os.path.join(out_root, folder, "poses.txt"),
        img_size=img_size,
    )


# host threads that write the corpus and decode each scan: the renderer's
# numpy, the codecs and zlib release the GIL
WORKERS = min(8, os.cpu_count() or 1)


def _generate_all(jobs: dict, clock) -> dict:
    """Write every scene of ``jobs`` ({key: thunk}) up front on ``WORKERS``
    threads. Each scene depends on its own seed only, so the files are the
    ones a sequential loop writes."""
    from concurrent.futures import ThreadPoolExecutor

    def run():
        with ThreadPoolExecutor(WORKERS) as pool:
            futures = {key: pool.submit(fn) for key, fn in jobs.items()}
            return {key: f.result() for key, f in futures.items()}

    return clock("generate", run)


class _Clock:
    """Wall-clock seconds per stage, each ending in a device synchronise."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: dict[str, float] = {}

    def __call__(self, stage: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[stage] = self.seconds.get(stage, 0.0) + time.perf_counter() - t0
        return out


def _placement_error(scan, det, scene, device="cuda") -> float:
    """Worst sign placement error (m) through projection + 3D NMS —
    the 3D metric the depth-noise axis exists to stress."""
    from tpu3dlm_torch.mapper.nms3d import suppress_bboxes
    from tpu3dlm_torch.mapper.projection import project_detections

    gb = project_detections(scan, det, device=device)
    opt = suppress_bboxes(gb, np.asarray(scan.poses), device=device).to_frame_dict()
    worst = 0.0
    for sign in scene.signs:
        best = np.inf
        for recs in opt.values():
            for rec in recs:
                corners = np.stack([np.asarray(c) for c in rec[:4]])
                e_c = np.linalg.norm(
                    corners.mean(0) - sign.corners_world.mean(0)
                )
                e_ext = np.abs(
                    np.sort(np.ptp(corners, axis=0))
                    - np.sort(np.ptp(sign.corners_world, axis=0))
                ).max()
                best = min(best, float(max(e_c, e_ext)))
        worst = max(worst, best)
    return worst


def run_hard_eval(
    yolo_ckpt,
    out_root: str,
    img_size: int = 128,
    nc: int = 2,
    conf: float = 0.5,
    num_frames: int = 14,
    axes: list[str] | None = None,
    seeds: tuple[int, ...] = EVAL_SEEDS,
    variant: str = "n",
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Detect over every (axis, seed) scene instance; returns the report.

    ``yolo_ckpt`` is a Flax ``.msgpack`` path or a port ``YOLOv10``. Per
    axis the report carries the across-seed mean of each metric, plus
    ``map50_per_seed``, ``map50_spread`` (max - min across seeds) and
    ``map50_std``; ``n_gt``/``n_pred`` are pooled totals (``n_gt_per_seed``
    beside them). The corpus is written first, on ``WORKERS`` threads."""
    from tpu3dlm_torch.pipeline.metrics import evaluate_detections

    clock = _Clock(device)
    detector = _load_detector(yolo_ckpt, img_size, nc, conf, variant=variant, device=device, dtype=dtype)
    report: dict = {"axes": {}, "img_size": img_size, "conf_thresh": conf,
                    "num_frames": num_frames, "seeds": list(seeds),
                    "yolo_variant": variant}
    axes = axes or list(AXES)
    scenes = _generate_all(
        {(a, s): (lambda a=a, s=s: generate_axis_scan(out_root, a, num_frames=num_frames, seed=s))
         for a in axes for s in seeds}, clock)
    for axis in axes:
        per_seed: list[dict] = []
        for seed in seeds:
            scene = scenes[(axis, seed)]
            scan = clock("load", _load_scan, out_root, f"{axis}_s{seed}", img_size)
            det = clock("detect", detector.detect, scan)
            metrics = evaluate_detections(
                det.to_frame_dict(), scene.gt_boxes_2d
            )
            one = {
                "map50": float(metrics.map50),
                "map50_95": float(metrics.map50_95),
                "precision": float(metrics.precision),
                "recall": float(metrics.recall),
                "n_gt": int(metrics.num_ground_truth),
                "n_pred": int(metrics.num_predictions),
            }
            if axis in ("base", "depth_noise"):
                one["worst_placement_m"] = clock("place", _placement_error, scan, det, scene, device)
            per_seed.append(one)

        m50 = np.array([s["map50"] for s in per_seed])
        entry = {
            "map50": round(float(m50.mean()), 4),
            "map50_per_seed": [round(float(v), 4) for v in m50],
            "map50_spread": round(float(m50.max() - m50.min()), 4),
            "map50_std": round(float(m50.std()), 4),
            "map50_95": round(
                float(np.mean([s["map50_95"] for s in per_seed])), 4
            ),
            "precision": round(
                float(np.mean([s["precision"] for s in per_seed])), 4
            ),
            "recall": round(
                float(np.mean([s["recall"] for s in per_seed])), 4
            ),
            "n_gt": int(sum(s["n_gt"] for s in per_seed)),
            "n_gt_per_seed": [s["n_gt"] for s in per_seed],
            "n_pred": int(sum(s["n_pred"] for s in per_seed)),
        }
        if axis in ("base", "depth_noise"):
            entry["worst_placement_m"] = round(
                max(s["worst_placement_m"] for s in per_seed), 4
            )
        report["axes"][axis] = entry
        logger.info("hard-eval %s: %s", axis, entry)
    report["stage_seconds"] = clock.seconds
    return report


# ---------------------------------------------------------------------------
# Damage-classifier stress axes: perturb what the CLASSIFIER sees through
# the real path (detect → rectify → classify) and score damage confusion
# per axis.

DAMAGE_AXES: tuple[str, ...] = (
    "clean", "blur", "exposure", "crop_occlusion", "box_jitter"
)


def _perturb_scan_rgb(rgb: np.ndarray, axis: str, rng: np.random.Generator,
                      gt_boxes_px: dict[int, list[list[float]]] | None = None,
                      scan=None) -> np.ndarray:
    """Stored-frame perturbations for the image-level damage axes.

    blur            Gaussian sigma 3.0 at stored resolution
                    (``gaussian_blur``, cv2's fixed-point result);
    exposure        frames alternate DARK (gain 0.4-0.55) and BRIGHT
                    (gain 1.5-1.8) plus an offset;
    crop_occlusion  a patch covering ~56% of every GT sign is painted a
                    random dull color (positions drawn per frame from
                    ``rng``).
    """
    out = np.asarray(rgb).copy()
    if axis == "blur":
        for f in range(out.shape[0]):
            out[f] = gaussian_blur(out[f], 3.0)
    elif axis == "exposure":
        for f in range(out.shape[0]):
            gain = (
                float(rng.uniform(0.4, 0.55)) if f % 2 == 0
                else float(rng.uniform(1.5, 1.8))
            )
            off = float(rng.uniform(-25, 25))
            out[f] = np.clip(
                out[f].astype(np.float32) * gain + off, 0, 255
            ).astype(np.uint8)
    elif axis == "crop_occlusion":
        if gt_boxes_px is None or scan is None:
            raise ValueError("crop_occlusion needs the ground-truth boxes and the scan")
        from tpu3dlm_torch.pipeline.selftrain import scale_boxes_to_frame

        for f, recs in gt_boxes_px.items():
            if not recs or not (0 <= f < out.shape[0]):
                continue
            raw = np.asarray([r[:4] for r in recs], np.float32)
            boxes = scale_boxes_to_frame(raw, scan, np.full(len(recs), f))
            for b in boxes:
                x1, y1, x2, y2 = b
                w, h = x2 - x1, y2 - y1
                if w < 4 or h < 4:
                    continue
                pw, ph = 0.75 * w, 0.75 * h  # ~56% of the box area
                px = x1 + rng.uniform(0, max(w - pw, 1e-3))
                py = y1 + rng.uniform(0, max(h - ph, 1e-3))
                color = rng.integers(60, 160, 3)
                out[f, int(py):int(py + ph), int(px):int(px + pw)] = color
    return out


def _jitter_boxes(boxes: np.ndarray, mask: np.ndarray,
                  rng: np.random.Generator, frac: float = 0.25) -> np.ndarray:
    """Rectification jitter: shift/scale each detection box by up to
    ``frac`` of its size (loose detector boxes are what the rectifier sees
    in production — the crop gains background or loses sign margin)."""
    out = np.asarray(boxes, np.float32).copy()
    w = out[..., 2] - out[..., 0]
    h = out[..., 3] - out[..., 1]
    for k, s in ((0, w), (1, h), (2, w), (3, h)):
        out[..., k] += rng.uniform(-frac, frac, out.shape[:2]) * s
    return np.where(mask[..., None], out, boxes)


def _damage_classifier(beit_ckpt, beit_kw: dict | None, quant: str, device, dtype):
    """The port's ``DamageDetector`` on a Flax ``.msgpack`` checkpoint or on
    a given float ``BeitClassifier``; ``quant="int8"`` quantises it."""
    from tpu3dlm_torch.models.beit import BeitConfig, quantize_beit
    from tpu3dlm_torch.models.checkpoint import read_flax_msgpack
    from tpu3dlm_torch.models.weights import beit_from_flax, quantize_beit_variables
    from tpu3dlm_torch.pipeline.classifier import DamageDetector

    if quant not in ("none", "int8"):
        raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
    if isinstance(beit_ckpt, (str, os.PathLike)):
        beit_kw = beit_kw or dict(image_size=32, hidden_size=32, num_layers=2,
                                  num_heads=2, intermediate_size=64)
        cfg = BeitConfig(num_labels=2, quant=quant,
                         **{k: v for k, v in beit_kw.items() if k != "num_labels"})
        variables = read_flax_msgpack(beit_ckpt)
        if quant == "int8":
            variables = quantize_beit_variables(variables)
        beit = beit_from_flax(variables, cfg)
    else:
        beit = quantize_beit(beit_ckpt) if quant == "int8" else beit_ckpt
        cfg = beit.cfg
    return DamageDetector(config=cfg, beit=beit, device=device, dtype=dtype)


def run_damage_hard_eval(
    yolo_ckpt,
    beit_ckpt,
    out_root: str,
    img_size: int = 128,
    nc: int = 2,
    conf: float = 0.5,
    beit_kw: dict | None = None,
    num_frames: int = 14,
    axes: tuple[str, ...] | None = None,
    seeds: tuple[int, ...] = EVAL_SEEDS,
    variant: str = "n",
    quant: str = "none",
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Score the damage classifier through detect → rectify → classify on
    every (axis, seed) scene instance.

    ``yolo_ckpt`` / ``beit_ckpt`` are Flax ``.msgpack`` paths or port
    modules; ``quant="int8"`` scores the int8 classifier on the same
    corpus. Per axis: detections matched one-to-one to ground-truth boxes
    (IoU >= 0.5, class-consistent — ``pipeline/metrics.matched_pairs``);
    the matched pairs' (gt damage, predicted damage) feed accuracy /
    per-class PRF1 / confusion, reported as across-seed mean accuracy +/-
    spread with the pooled confusion. The corpus is written first, as in
    ``run_hard_eval``."""
    from tpu3dlm_torch.data import synthetic as _syn
    from tpu3dlm_torch.pipeline.metrics import box_iou, evaluate_classification, matched_pairs

    clock = _Clock(device)
    detector = _load_detector(yolo_ckpt, img_size, nc, conf, variant=variant, device=device, dtype=dtype)
    classifier = _damage_classifier(beit_ckpt, beit_kw, quant, device, dtype)

    report: dict = {"axes": {}, "img_size": img_size, "conf_thresh": conf,
                    "num_frames": num_frames, "seeds": list(seeds),
                    "metric": "damage_classifier_hard_eval", "quant": quant}
    axes = axes or DAMAGE_AXES

    def write(axis, seed):
        # all damage axes share the seed's jittered BASE scene: the
        # perturbation is the only difference from `clean`
        return _syn.generate_scan(out_root, f"dmg_{axis}_s{seed}", num_frames=num_frames, seed=seed,
                                  cloud_points_per_m2=1200, **axis_kwargs("base", seed))

    scenes = _generate_all({(a, s): (lambda a=a, s=s: write(a, s)) for a in axes for s in seeds}, clock)
    for axis in axes:
        per_seed_acc: list[float] = []
        y_true_all: list[int] = []
        y_pred_all: list[int] = []
        for seed in seeds:
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, 0xDA3A6E])
            )
            scene = scenes[(axis, seed)]
            scan = clock("load", _load_scan, out_root, f"dmg_{axis}_s{seed}", img_size)
            if axis in ("blur", "exposure"):
                scan = dataclasses.replace(
                    scan,
                    rgb=_perturb_scan_rgb(
                        scan.rgb, axis, rng,
                        gt_boxes_px=scene.gt_boxes_2d, scan=scan,
                    ),
                )
            det = clock("detect", detector.detect, scan)
            if axis == "box_jitter":
                det = dataclasses.replace(
                    det,
                    boxes=_jitter_boxes(
                        np.asarray(det.boxes), np.asarray(det.mask), rng
                    ),
                )
            if axis == "crop_occlusion":
                # perturbed AFTER detection: this axis scores the classifier
                # under occluded crops, not the detector
                scan = dataclasses.replace(
                    scan,
                    rgb=_perturb_scan_rgb(
                        scan.rgb, axis, rng,
                        gt_boxes_px=scene.gt_boxes_2d, scan=scan,
                    ),
                )
            det = clock("classify", classifier.classify_detections, scan, det)

            y_true: list[int] = []
            y_pred: list[int] = []
            boxes = np.asarray(det.boxes)
            labels = np.asarray(det.label)
            damage = np.asarray(det.damage)
            mask = np.asarray(det.mask)
            for f, gt_rows in scene.gt_boxes_2d.items():
                if not gt_rows or not (0 <= f < scan.num_frames):
                    continue
                valid = np.nonzero(mask[f])[0]
                if valid.size == 0:
                    continue
                gt_b = np.asarray([r[:4] for r in gt_rows], np.float32)
                gt_l = np.asarray([r[5] for r in gt_rows], int)
                gt_d = scene.gt_damage_2d.get(f, [0] * len(gt_rows))
                ious = box_iou(boxes[f][valid], gt_b)
                for p, g in matched_pairs(ious, labels[f][valid], gt_l, 0.5):
                    y_true.append(int(gt_d[g]))
                    y_pred.append(int(damage[f][valid[p]]))
            if y_true:
                m = evaluate_classification(
                    np.asarray(y_true), np.asarray(y_pred), 2
                )
                per_seed_acc.append(float(m.accuracy))
            y_true_all += y_true
            y_pred_all += y_pred

        pooled = evaluate_classification(
            np.asarray(y_true_all, int), np.asarray(y_pred_all, int), 2
        )
        acc = np.asarray(per_seed_acc) if per_seed_acc else np.zeros(1)
        entry = {
            "accuracy": round(float(acc.mean()), 4),
            "accuracy_per_seed": [round(float(v), 4) for v in acc],
            "accuracy_spread": round(float(acc.max() - acc.min()), 4),
            "macro_f1": round(pooled.macro_f1, 4),
            "per_class_f1": {
                int(c): round(v, 4) for c, v in pooled.per_class_f1.items()
            },
            "confusion": pooled.confusion.tolist(),
            "n_pairs": len(y_true_all),
        }
        report["axes"][axis] = entry
        logger.info("damage hard-eval %s: %s", axis, entry)
    report["stage_seconds"] = clock.seconds
    return report


def write_report(report: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
