"""End-to-end accuracy loop of the port: finetune → detect → map → align →
match against ground truth (port of ``scripts/e2e_accuracy.py``).

    python -m tpu3dlm_torch.scripts.e2e_accuracy [--out-dir <ckpt dir>]
        [--full-scale] [--steps N] [--beit-steps N] [--skip-train]
        [--device cuda|cpu]

Writes a two-scan synthetic project (``pipeline/evaluate.py::make_project``:
gold standard, and maintenance with a rigid world offset and one sign
removed), finetunes YOLOv10 and BEiT on the gold scan's ground truth
(``pipeline/selftrain.py::finetune_synthetic``), runs the port's Pipeline
both ways on those checkpoints (``verify``) and prints its report as one
JSON line; a ground-truth violation raises. Defaults: YOLOv10-n at 128 px
for 300 steps and the toy BEiT for 80; ``--full-scale``: YOLOv10-n at 640²
for 1500 steps and BEiT-base at 224² in f32 for 120
(``docs/ACCURACY_FULL_SCALE.json``'s recipe and bars). The checkpoints are
``yolo_synthetic[_full].msgpack`` and ``beit_synthetic[_full].msgpack``
under ``--out-dir`` (a temporary directory by default); ``--skip-train``
reuses them when both exist.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import time


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="Finetune on a synthetic scan, then verify the Pipeline.")
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "tpu3dlm_torch_e2e_ckpt"))
    ap.add_argument("--steps", type=int, default=None, help="YOLO steps (300; 1500 with --full-scale)")
    ap.add_argument("--beit-steps", type=int, default=None, help="BEiT steps (80; 120 with --full-scale)")
    ap.add_argument("--skip-train", action="store_true", help="reuse the checkpoints in --out-dir")
    ap.add_argument("--full-scale", action="store_true", help="YOLOv10-n at 640², BEiT-base at 224²")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import torch

    from tpu3dlm_torch.device import resolve_device
    from tpu3dlm_torch.models.beit import BeitConfig
    from tpu3dlm_torch.pipeline.evaluate import (
        BEIT_KW, FULL_BEIT_KW, FULL_IMG_SIZE, IMG_SIZE, NC, make_project, verify,
    )
    from tpu3dlm_torch.pipeline.selftrain import finetune_synthetic

    device = resolve_device(args.device)
    img_size = FULL_IMG_SIZE if args.full_scale else IMG_SIZE
    beit_kw = FULL_BEIT_KW if args.full_scale else BEIT_KW
    suffix = "_full" if args.full_scale else ""
    steps = args.steps if args.steps is not None else (1500 if args.full_scale else 300)
    beit_steps = args.beit_steps if args.beit_steps is not None else (120 if args.full_scale else 80)

    yolo_ckpt = os.path.join(args.out_dir, f"yolo_synthetic{suffix}.msgpack")
    beit_ckpt = os.path.join(args.out_dir, f"beit_synthetic{suffix}.msgpack")
    with tempfile.TemporaryDirectory(prefix="tpu3dlm_torch_e2e_") as root:
        cfg_path, data_root, gold, _ = make_project(root, yolo_ckpt, beit_ckpt, img_size=img_size,
                                                    beit_kw=beit_kw)
        report = {}
        # --skip-train holds only when BOTH checkpoints exist
        if not (args.skip_train and os.path.exists(yolo_ckpt) and os.path.exists(beit_ckpt)):
            t0 = time.perf_counter()
            y, b = finetune_synthetic(
                os.path.join(data_root, "gold_std"), args.out_dir, img_size=img_size, yolo_steps=steps,
                yolo_lr=2e-3, beit_steps=beit_steps, beit_lr=1e-3, beit_config=BeitConfig(**beit_kw), nc=NC,
                device=device,
            )
            os.replace(y, yolo_ckpt)
            os.replace(b, beit_ckpt)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            report["training_seconds"] = time.perf_counter() - t0
            print(f"training: {report['training_seconds']:.0f}s", file=sys.stderr)
        t0 = time.perf_counter()
        report.update(verify(cfg_path, gold, device=device))
    report["verify_seconds"] = time.perf_counter() - t0
    report["img_size"] = img_size
    report["beit"] = "base-224" if args.full_scale else "toy-32"
    report["hardware"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
