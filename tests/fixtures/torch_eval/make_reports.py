"""Write the JAX package's evaluation reports on the CPU, with the committed
fixture checkpoints, to which the port is held:

- ``hard_eval_jax_cpu.json`` and ``damage_eval_jax_cpu.json``: the hard eval
  at the settings of ``docs/ACCURACY_HARD_EVAL.json`` and
  ``docs/ACCURACY_DAMAGE_EVAL.json`` (img_size 128, conf 0.3, 14 frames,
  seeds 11, 23, 37, 53, 71, nc 2);
- ``hard_eval_reduced_jax_cpu.json`` and ``damage_eval_reduced_jax_cpu.json``:
  the same at ``REDUCED`` (seed 11, 4 frames, three detector axes and two
  damage axes), which the port's CPU test runs;
- ``verify_jax_cpu.json``: ``tpu3dlm.pipeline.evaluate.verify`` on the
  project ``make_project`` writes, with ``VERIFY_CFG`` (f32 inference and a
  shorter ICP, so the port's CPU test of the same stays short).

    JAX_PLATFORMS=cpu python tests/fixtures/torch_eval/make_reports.py [--only verify|reduced]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)

YOLO = os.path.join(REPO, "tests", "fixtures", "yolo_synthetic.msgpack")
BEIT = os.path.join(REPO, "tests", "fixtures", "beit_synthetic.msgpack")
SETTINGS = dict(img_size=128, nc=2, conf=0.3, num_frames=14)
REDUCED = dict(seeds=(11,), num_frames=4)
REDUCED_AXES = (["base", "occlusion", "depth_noise"], ("clean", "crop_occlusion"))
VERIFY_CFG = [
    ("icp_max_points = 16384", "icp_max_points = 2048"),
    ("icp_iterations = 30", "icp_iterations = 10"),
    ("infer_dtype = bf16", "infer_dtype = f32"),
]


def write_verify_report(path: str) -> None:
    import json

    from tpu3dlm.pipeline.evaluate import make_project, verify

    with tempfile.TemporaryDirectory() as tmp:
        cfg, _, gold, _ = make_project(tmp, YOLO, BEIT, extra_cfg=VERIFY_CFG)
        rep = verify(cfg, gold)
    rep["config_patch"] = VERIFY_CFG
    with open(path, "w") as f:
        json.dump(rep, f, indent=1, sort_keys=True)


def write_reduced_reports() -> None:
    from tpu3dlm.pipeline.hardeval import run_damage_hard_eval, run_hard_eval, write_report

    kw = {**SETTINGS, **REDUCED}
    with tempfile.TemporaryDirectory() as tmp:
        det = run_hard_eval(YOLO, os.path.join(tmp, "det"), axes=REDUCED_AXES[0], **kw)
        write_report(det, os.path.join(HERE, "hard_eval_reduced_jax_cpu.json"))
        dmg = run_damage_hard_eval(YOLO, BEIT, os.path.join(tmp, "dmg"), axes=REDUCED_AXES[1], **kw)
        write_report(dmg, os.path.join(HERE, "damage_eval_reduced_jax_cpu.json"))


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpu3dlm.pipeline.hardeval import run_damage_hard_eval, run_hard_eval, write_report

    if sys.argv[1:] == ["--only", "reduced"]:
        write_reduced_reports()
        return
    write_verify_report(os.path.join(HERE, "verify_jax_cpu.json"))
    if sys.argv[1:] == ["--only", "verify"]:
        return
    write_reduced_reports()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        det = run_hard_eval(YOLO, os.path.join(tmp, "det"), **SETTINGS)
        det["eval_seconds_cpu"] = round(time.perf_counter() - t0, 1)
        det["checkpoint"] = "tests/fixtures/yolo_synthetic.msgpack"
        write_report(det, os.path.join(HERE, "hard_eval_jax_cpu.json"))
        t0 = time.perf_counter()
        dmg = run_damage_hard_eval(YOLO, BEIT, os.path.join(tmp, "dmg"), **SETTINGS)
        dmg["eval_seconds_cpu"] = round(time.perf_counter() - t0, 1)
        dmg["checkpoint"] = "tests/fixtures/yolo_synthetic.msgpack + tests/fixtures/beit_synthetic.msgpack"
        write_report(dmg, os.path.join(HERE, "damage_eval_jax_cpu.json"))


if __name__ == "__main__":
    main()
