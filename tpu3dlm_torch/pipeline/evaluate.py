"""Ground-truth accuracy harness for the full pipeline on synthetic scans
(port of ``tpu3dlm/pipeline/evaluate.py``).

``make_project`` writes a two-scan project (gold standard, and maintenance
with a rigid world offset and dropped signs) with the port's generator;
``verify`` runs the complete port Pipeline both ways on ``device`` and
checks the outputs against the closed-form scene ground truth:

  * every gold sign must have an optimised 3D box within ``tol`` metres
    (centroid + sorted-extent error);
  * the maintenance comparison must flag exactly the dropped signs as
    missing, with damage labels equal to ground truth.

The gold run classifies through kernel B1 and the maintenance compare's
nearest neighbours run on kernel B2.
"""

from __future__ import annotations

import os

import numpy as np

IMG_SIZE = 128
NC = 2
CONF = 0.5
BEIT_KW = dict(image_size=32, hidden_size=32, num_layers=2, num_heads=2,
               intermediate_size=64, num_labels=2)
# full production scale: YOLOv10-n at 640² with a BEiT-base classifier at
# 224²
FULL_IMG_SIZE = 640
FULL_BEIT_KW = dict(image_size=224, hidden_size=768, num_layers=12,
                    num_heads=12, intermediate_size=3072, num_labels=2)


def _cfg_patch(img_size: int, beit_kw: dict) -> list[tuple[str, str]]:
    return [
        ("img_size = 640", f"img_size = {img_size}"),
        ("batch_size = 64", "batch_size = 8"),
        ("conf_thresh = 0.5", f"conf_thresh = {CONF}"),
        ("max_det = 64", "max_det = 8"),
        ("num_classes = 80", f"num_classes = {NC}"),
        ("min_points = 1000", "min_points = 50"),
        ("beit_image_size = 224", f"beit_image_size = {beit_kw['image_size']}"),
        ("beit_hidden_size = 768", f"beit_hidden_size = {beit_kw['hidden_size']}"),
        ("beit_num_layers = 12", f"beit_num_layers = {beit_kw['num_layers']}"),
        ("beit_num_heads = 12", f"beit_num_heads = {beit_kw['num_heads']}"),
        ("beit_intermediate_size = 3072",
         f"beit_intermediate_size = {beit_kw['intermediate_size']}"),
    ]


def make_project(
    root: str,
    yolo_ckpt: str,
    beit_ckpt: str,
    dropped: tuple[int, ...] = (2,),
    cloud_points_per_m2: int = 4000,
    extra_cfg: list[tuple[str, str]] | None = None,
    img_size: int = IMG_SIZE,
    beit_kw: dict | None = None,
    num_frames: int = 5,
):
    """Write config + gold/maintenance synthetic scans under <root>.

    Returns (cfg_path, data_root, gold_scene, world_transform)."""
    from tpu3dlm_torch.data import synthetic
    from tpu3dlm_torch.utils.config import write_default_config

    cfg_path = os.path.join(root, "configs", "variables.cfg")
    write_default_config(cfg_path)
    text = open(cfg_path).read()
    for k, v in _cfg_patch(img_size, beit_kw or BEIT_KW) + [
        ("yolo_weights =", f"yolo_weights = {yolo_ckpt}"),
        ("beit_weights =", f"beit_weights = {beit_ckpt}"),
    ] + (extra_cfg or []):
        assert k in text, k
        text = text.replace(k, v)
    open(cfg_path, "w").write(text)

    data_root = os.path.join(root, "configs", "data")
    Tw = np.eye(4, dtype=np.float32)
    Tw[:3, 3] = [0.4, -0.3, 0.1]
    gold = synthetic.generate_scan(
        data_root, "gold_std", num_frames=num_frames, seed=0,
        cloud_points_per_m2=cloud_points_per_m2,
    )
    synthetic.generate_scan(
        data_root, "maintenance", num_frames=num_frames, seed=1,
        world_transform=Tw, drop_sign_indices=dropped,
        cloud_points_per_m2=cloud_points_per_m2,
    )
    return cfg_path, data_root, gold, Tw


def verify(cfg_path: str, gold_scene, dropped=(2,), tol: float = 0.1, device="cuda") -> dict:
    """Run gold + maintenance pipelines on ``device``; return the accuracy
    report (raises AssertionError on any ground-truth violation)."""
    from tpu3dlm_torch.pipeline.task import load_gold_std, setup_pipeline
    from tpu3dlm_torch.utils.config import ConfigLoader

    cfg_gold = ConfigLoader(cfg_path, "gold_std")
    cfg_maint = ConfigLoader(cfg_path, "maintenance")

    p1 = setup_pipeline("gold_std", cfg_gold, None, device=device)
    opt = p1.data_to_save["optimised_bboxes"]

    errors = {}
    for i, sign in enumerate(gold_scene.signs):
        best = np.inf
        for _, recs in opt.items():
            for rec in recs:
                corners = np.stack([np.asarray(c) for c in rec[:4]])
                # corner order may rotate/flip → compare centroid + extents
                e_c = np.linalg.norm(corners.mean(0) - sign.corners_world.mean(0))
                e_ext = np.abs(
                    np.sort(np.ptp(corners, axis=0))
                    - np.sort(np.ptp(sign.corners_world, axis=0))
                ).max()
                best = min(best, max(e_c, e_ext))
        errors[i] = float(best)
        assert best <= tol, f"sign {i}: best 3D placement error {best:.3f} > {tol}"

    gold_var = load_gold_std(cfg_gold.pickle_path)
    p2 = setup_pipeline("maintenance", cfg_maint, cfg_gold, gold_var, device=device)
    rows = p2.data_to_save["comparison_rows"]

    missing = [r for r in rows if r["status"] == "missing"]
    assert len(missing) == len(dropped), f"missing rows: {missing}"
    drop_labels = sorted(gold_scene.signs[i].label for i in dropped)
    assert sorted(r["label"] for r in missing) == drop_labels, missing

    # the same mapping the pipeline's row strings are built from
    # (task.py damage_labels) — re-stating {0: "undamaged", ...} here
    # would spuriously fail any project that overrides damage_labels
    labels = getattr(
        cfg_maint, "damage_labels", "undamaged,damaged"
    ).split(",")
    id2dmg = {i: name.strip() for i, name in enumerate(labels)}
    matched = [r for r in rows if r["status"] in ("matched", "damaged")]
    kept = [s for i, s in enumerate(gold_scene.signs) if i not in set(dropped)]
    assert len(matched) >= len(kept), rows
    for r in matched:
        assert r["status"] == "matched", f"spurious damage change: {r}"
        want = {id2dmg[s.damage] for s in kept if s.label == r["label"]}
        assert r["base_damage"] in want and r["comparison_damage"] in want, r

    # 2D detector quality on the gold scan (pipeline/metrics.py): both the
    # prediction records and the synthetic gt are in original-capture pixels
    from tpu3dlm_torch.pipeline.metrics import evaluate_detections

    det = evaluate_detections(
        p1.data_to_save["predictions"], gold_scene.gt_boxes_2d
    )

    return {
        "placement_errors_m": errors,
        "missing_flagged": len(missing),
        "rows": len(rows),
        "detection": det.to_dict(),
    }
