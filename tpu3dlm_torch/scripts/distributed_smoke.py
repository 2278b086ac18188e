"""Multi-process smoke of the port's world of ranks (port of
``scripts/distributed_smoke.py``): N spawned ranks in one world run four
legs through the port's entry points, and the parent holds them against
the same legs on one device.

    python -m tpu3dlm_torch.scripts.distributed_smoke [--procs 2] \\
        [--backend nccl|gloo] [--device cuda|cpu]

1. the sharded fused scan step: ``FusedScanRunner(mesh_devices=N)`` on 4
   frames at 64 px (a seeded YOLOv10-n with calibrated BatchNorm, a toy
   BEiT, f32), confidence threshold 0 and a crop budget of 12 of the 16
   slots, so the global selection binds and every rank classifies crops;
2. one data-parallel finetune step of the toy BEiT on 8 crops
   (``make_beit_train_step(mesh=...)``);
3. query-sharded ICP: ``Alignment(mesh=...).compare`` of two ~6k-point
   clouds (999 query points: padded by repetition to the world), init
   scoring, three point-to-plane stages;
4. the target-sharded nearest neighbour (``parallel.nn.target_sharded_nn``)
   of 512 queries against 8192 targets.

Bars against the single-device run: masks, labels and damage equal, boxes
within 1e-2 px, conf within 1e-4, corners within 1e-4 m (the card's f32
bars: another batch per call can take other convolution algorithms); the
finetune loss and parameters within 1e-5; the ICP transform within 1e-3
(30 Gauss-Newton steps amplify the sums' rounding, as the reference's
smoke allows); the NN indices identical and d² within 1e-5. The ranks
agree exactly on the finetune parameters and the transform. On CUDA each
rank must have launched kernel B1 (legs 1 and 2) and kernel B2 (legs 3
and 4). Every leg runs twice and its second, warm run is timed (wall ms,
on each rank and on one device; ranks sharing a card are no scaling
measurement, and the widths are small). Prints one JSON line,
``{"metric": "distributed_<N>proc_smoke", "ok": ..., ...}``, and exits 1
when a bar fails. NCCL needs a card per rank; ``--backend gloo``
puts the ranks on shared cards (or the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

F, S, D, BUDGET = 4, 64, 4, 12
BEIT = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            num_labels=3)


def _scan():
    from tpu3dlm_torch.data.scan import Scan

    rng = np.random.default_rng(42)
    rgb = rng.integers(0, 96, (F, S, S, 3), dtype=np.uint8)
    for f in range(F):
        for _ in range(3):
            x0, y0 = rng.integers(0, S - S // 4, 2)
            w, h = rng.integers(S // 8, S // 3, 2)
            rgb[f, y0:y0 + h, x0:x0 + w] = rng.integers(128, 256, 3, dtype=np.uint8)
    depth = np.round(1500.0 + 800.0 * rng.uniform(size=(F, 48, 64))).astype(np.float32)
    quat = np.concatenate([rng.normal(0, 0.05, (F, 3)), np.ones((F, 1))], -1)
    poses = np.concatenate([np.stack([np.linspace(0, 2, F), np.zeros(F), np.zeros(F)], -1), quat], -1)
    return Scan(rgb=rgb, depth=depth, intrinsics=np.tile([[80.0, 80.0, 31.5, 23.5]], (F, 1)).astype(np.float32),
                rgb_size=np.tile([[64.0, 48.0]], (F, 1)).astype(np.float32), poses=poses.astype(np.float32))


def _models(scan):
    from tpu3dlm_torch.models.beit import BeitConfig, seeded_beit
    from tpu3dlm_torch.models.layers import calibrate_batchnorm_, init_seeded_
    from tpu3dlm_torch.models.yolov10 import YOLOv10

    yolo = init_seeded_(YOLOv10(nc=3, variant="n"), torch.Generator().manual_seed(0))
    calibrate_batchnorm_(yolo, torch.from_numpy(scan.rgb).float() / 255.0)
    return yolo, seeded_beit(BeitConfig(**BEIT), torch.Generator().manual_seed(1))


def _clouds():
    """(target ~6k points: a wall, a floor and a side wall; query: 999
    points of a second draw moved by 6° about z and a few cm)."""
    rng = np.random.default_rng(7)

    def scene(n):
        return np.concatenate([
            np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), np.full(n, 3.0)], 1),
            np.stack([rng.uniform(-1.5, 1.5, n // 2), np.full(n // 2, 1.0), rng.uniform(2, 3, n // 2)], 1),
            np.stack([np.full(n // 2, -1.5), rng.uniform(-1, 1, n // 2), rng.uniform(2, 3, n // 2)], 1),
        ]).astype(np.float32)

    ang = np.radians(6.0)
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    return scene(3000), (scene(3000) @ R.T + np.array([0.05, -0.03, 0.04], np.float32)).astype(np.float32)


def _crops():
    rng = np.random.default_rng(3)
    labels = np.arange(8, dtype=np.int64) % 3
    lo = np.array([0, 90, 180])[labels][:, None, None, None]
    return (lo + rng.integers(0, 70, (8, 32, 32, 3))).astype(np.uint8), labels


def _twice(fn, dev, ms: dict, name: str):
    """``fn()`` twice; the second call's wall ms (ending in a synchronize
    on a card) into ``ms[name]``, and its result."""
    import time

    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms[name] = (time.perf_counter() - t0) * 1e3
    return out


def run_legs(mesh, device) -> dict:
    """The four legs on ``mesh`` (None: one device), each run twice (the
    second run timed, warm) → host results of the second runs, their wall
    ms and this rank's launches of B1 and B2 over both."""
    from tpu3dlm_torch.alignment.align import Alignment
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors
    from tpu3dlm_torch.parallel.finetune import init_finetune, make_beit_train_step
    from tpu3dlm_torch.parallel.mesh import shard_batch
    from tpu3dlm_torch.parallel.nn import target_sharded_nn
    from tpu3dlm_torch.pipeline.fused import FusedScanRunner

    torch.set_num_threads(1)
    dev = mesh.device if mesh is not None else torch.device(device)
    n = 1 if mesh is None else mesh.size
    b1, b2 = beit_attention_packed.launches, nearest_neighbors.launches
    out, ms = {}, {}

    scan = _scan()
    yolo, beit = _models(scan)
    runner = FusedScanRunner(img_size=S, conf_thresh=0.0, max_det=D, nc=3, yolo=yolo, beit=beit,
                             mesh_devices=n, dtype=torch.float32, crop_budget=BUDGET, device=dev)
    det, gb = _twice(lambda: runner(scan), dev, ms, "scan_step")
    out.update(boxes=det.boxes, conf=det.conf, label=det.label, damage=det.damage, mask=det.mask,
               corners=gb.corners)

    from tpu3dlm_torch.models.beit import BeitConfig, seeded_beit

    model = seeded_beit(BeitConfig(**BEIT), torch.Generator().manual_seed(2))
    step = make_beit_train_step(model, init_finetune(model, lr=1e-3, device=dev), mesh, device=dev)
    crops, labels = _crops()
    out["loss"] = float(_twice(lambda: step(crops, labels), dev, ms, "finetune_step"))
    out["param"] = next(model.parameters()).detach().cpu().numpy()

    base, comp = _clouds()
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (4, 1))

    def compare():
        align = Alignment(poses, poses, {}, {}, base_cloud=base, comparison_cloud=comp, max_points=999,
                          icp_iterations=10, ann="off", mesh=mesh, device=dev)
        align.compare("distributed_smoke")
        return align.final_transform

    out["icp_T"] = _twice(compare, dev, ms, "icp_compare")

    rng = np.random.default_rng(11)
    a = torch.as_tensor(rng.uniform(-1, 1, (512, 3)).astype(np.float32), device=dev)
    b = torch.as_tensor(rng.uniform(-1, 1, (8192, 3)).astype(np.float32), device=dev)
    nn = nearest_neighbors if mesh is None else lambda q, t: target_sharded_nn(mesh)(q, shard_batch(t, mesh))
    idx, d2 = _twice(lambda: nn(a, b), dev, ms, "nn")
    out.update(nn_idx=idx.cpu().numpy(), nn_d2=d2.cpu().numpy(), ms=ms)
    out["b1_launches"] = beit_attention_packed.launches - b1
    out["b2_launches"] = nearest_neighbors.launches - b2
    return out


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def hold(ranks: list, ref: dict, on_card: bool) -> dict:
    """Each rank's legs against the single-device ones (the module
    docstring's bars) → the record, with ``ok``."""
    r0 = ranks[0]
    m = ref["mask"]
    rec = {
        "fused_equal": {k: all(np.array_equal(r[k], ref[k]) for r in ranks) for k in ("mask", "label", "damage")},
        "fused_box_err_px": max(_max_err(r["boxes"], ref["boxes"]) for r in ranks),
        "fused_conf_err": max(_max_err(r["conf"], ref["conf"]) for r in ranks),
        "fused_corner_err_m": max(_max_err(r["corners"][m], ref["corners"][m]) for r in ranks),
        "crops_classified": int((ref["damage"] >= 0).sum()),
        "finetune_loss_err": abs(r0["loss"] - ref["loss"]),
        "finetune_param_err": _max_err(r0["param"], ref["param"]),
        "finetune_rank_divergence": max(_max_err(r["param"], r0["param"]) for r in ranks),
        "icp_transform_err": _max_err(r0["icp_T"], ref["icp_T"]),
        "icp_rank_divergence": max(_max_err(r["icp_T"], r0["icp_T"]) for r in ranks),
        "nn_indices_exact": all(np.array_equal(r["nn_idx"], ref["nn_idx"]) for r in ranks),
        "nn_d2_err": max(_max_err(r["nn_d2"], ref["nn_d2"]) for r in ranks),
        "b1_launches_by_rank": [r["b1_launches"] for r in ranks],
        "b2_launches_by_rank": [r["b2_launches"] for r in ranks],
        "warm_ms_by_rank": [r["ms"] for r in ranks],
        "warm_ms_one_device": ref["ms"],
    }
    ok = (all(rec["fused_equal"].values()) and 0 < rec["crops_classified"] <= BUDGET
          and rec["fused_box_err_px"] <= 1e-2 and rec["fused_conf_err"] <= 1e-4
          and rec["fused_corner_err_m"] <= 1e-4
          and rec["finetune_loss_err"] <= 1e-5 and rec["finetune_param_err"] <= 1e-5
          and rec["finetune_rank_divergence"] == 0.0
          and rec["icp_transform_err"] <= 1e-3 and rec["icp_rank_divergence"] == 0.0
          and rec["nn_indices_exact"] and rec["nn_d2_err"] <= 1e-5)
    if on_card:
        ok = ok and min(rec["b1_launches_by_rank"]) > 0 and min(rec["b2_launches_by_rank"]) > 0
    rec["ok"] = bool(ok)
    return rec


def main(argv=None) -> int:
    from tpu3dlm_torch.device import resolve_device
    from tpu3dlm_torch.parallel.mesh import default_backend, spawn_world

    p = argparse.ArgumentParser(description="The port's legs over N ranks against one device.")
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on cuda, gloo on cpu")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    backend = args.backend or default_backend(dev)
    ranks = spawn_world(run_legs, args.procs, device=dev, backend=backend, args=(dev.type,))
    ref = run_legs(None, str(dev))
    rec = {"metric": f"distributed_{args.procs}proc_smoke", "procs": args.procs, "backend": backend,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           **hold(ranks, ref, dev.type == "cuda")}
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
