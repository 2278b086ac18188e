#!/usr/bin/env python3
"""Drive the tpu3dlm_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``tpu3dlm_torch/csrc`` (into
``tpu3dlm_torch/_build``), then runs four phases, each printing one JSON
line; any failure raises and the script exits non-zero without a result:

1. ``kernel_b1``: kernel B1 (BEiT attention) against its plain PyTorch twin
   at the production shape in bf16 (tolerance 1e-2 abs and rel: one bf16
   ulp of p and of the output) and at small shapes in f32 (1e-5: summation
   order only), with CUDA-event times of the kernel, the twin and
   ``F.scaled_dot_product_attention`` (the library yardstick; the port never
   calls it) beside the kernel's bound.
2. ``slice_parity``: the fused runner in f32 on the card (kernel, cuDNN,
   TF32 off) against the same runner on the CPU (twin) on a small scan:
   masks, labels and damage equal, boxes within 1e-2 px, corners within
   1e-4 m.
3. ``fused_full_width``: the main path a user runs — ``FusedScanRunner``
   (YOLOv10-n at 640², BEiT-base at 224, bf16, 128 frames, crop budget 384)
   and ``suppress_bboxes`` — once with the launch counts set to 0, then
   timed over warm runs, with a per-stage split.
4. ``kernels``: one line listing every ported kernel with its launches on
   the main path, error, times and bound.

The card's name and power limit (nvidia-smi) are printed before the last
line; the last line is ``{"ok": true, "device": {...}}``. Inputs and
weights are made from fixed seeds. Without CUDA the script exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok, what) -> None:
    """A failed check raises (unlike ``assert``, it survives ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_memory_rate(name: str) -> float:
    """Device-memory bandwidth (B/s): 2.0 TB/s for an H100 PCIe, else the
    H100 SXM's 3.35 TB/s."""
    return 2.0e12 if "PCIe" in name else 3.35e12


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, runs: int = 5) -> tuple[float, list[float]]:
    """Median wall time of ``runs`` calls, each ending in a synchronize."""
    samples = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples), samples


def attention_bound_ms(B, N, h, d, dtype, mem_rate) -> tuple[float, str]:
    """Least time for the attention function: each of q, k, v, o moved
    once plus the f32 bias, against 4·h·B·N²·d operations at the peak rate
    for the input type; the larger of the two."""
    elt = torch.finfo(dtype).bits // 8
    t_bytes = (4 * B * N * h * d * elt + h * N * N * 4) / mem_rate
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops = 4 * h * B * N * N * d / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel_b1(dev, mem_rate) -> dict:
    import torch.nn.functional as F

    from tpu3dlm_torch.ops.kernels.attention import (
        beit_attention_packed,
        beit_attention_packed_reference,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    checks = []
    for dtype, (B, N, h, d), tol in [
        (torch.bfloat16, (384, 197, 12, 64), 1e-2),
        (torch.bfloat16, (5, 9, 2, 64), 1e-2),
        (torch.float32, (5, 33, 3, 16), 1e-5),
        (torch.float32, (16, 197, 12, 64), 1e-5),
    ]:
        q, k, v = (torch.randn(B, N, h * d, generator=g, device=dev).to(dtype) for _ in range(3))
        bias = torch.randn(h, N, N, generator=g, device=dev)
        out = beit_attention_packed(q, k, v, bias, h)
        torch.cuda.synchronize()
        ref = beit_attention_packed_reference(q, k, v, bias, h)
        err = (out.float() - ref.float()).abs()
        max_err = float(err.max())
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        checks.append({"dtype": str(dtype).split(".")[-1], "shape": [B, N, h, d],
                       "max_abs_err": max_err, "tol": tol})
        if (B, N, h, d) == (384, 197, 12, 64):
            prod = dict(q=q, k=k, v=v, bias=bias, B=B, N=N, h=h, d=d, max_err=max_err)

    q, k, v, bias = prod["q"], prod["k"], prod["v"], prod["bias"]
    B, N, h, d = prod["B"], prod["N"], prod["h"], prod["d"]
    kernel_ms = cuda_ms(lambda: beit_attention_packed(q, k, v, bias, h))
    plain_ms = cuda_ms(lambda: beit_attention_packed_reference(q, k, v, bias, h))
    heads = lambda t: t.view(B, N, h, d).transpose(1, 2)  # noqa: E731
    mask = bias.to(q.dtype)[None]
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=mask)
    )
    bound_ms, bound_by = attention_bound_ms(B, N, h, d, q.dtype, mem_rate)
    result = {
        "phase": "kernel_b1", "checks": checks, "shape": [B, N, h, d], "dtype": "bfloat16",
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": prod["max_err"],
    }
    emit(result)
    return result


def synthetic_scan(F: int, img: int, depth_hw: tuple[int, int], seed: int):
    """A capture made with numpy: frames with bright rectangles on noise,
    planar depth in mm with holes, fixed intrinsics at 640×480, a camera
    path along x with small rotations."""
    from tpu3dlm_torch.data.scan import Scan

    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 96, (F, img, img, 3), dtype=np.uint8)
    for f in range(F):
        for _ in range(3):
            x0, y0 = rng.integers(0, img - img // 4, 2)
            w, hh = rng.integers(img // 16, img // 4, 2)
            rgb[f, y0:y0 + hh, x0:x0 + w] = rng.integers(128, 256, 3, dtype=np.uint8)
    hd, wd = depth_hw
    depth = (1500.0 + 800.0 * rng.uniform(size=(F, 1, 1))
             + 0.5 * np.arange(wd)[None, None, :]).repeat(hd, 1).astype(np.float32)
    depth = np.round(depth)
    depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
    quat = np.concatenate([rng.normal(0, 0.05, (F, 3)), np.ones((F, 1))], -1)
    poses = np.concatenate([np.stack([np.linspace(0, 5, F), np.zeros(F), np.zeros(F)], -1), quat], -1)
    return Scan(
        rgb=rgb,
        depth=depth,
        intrinsics=np.tile([[525.0, 525.0, 319.5, 239.5]], (F, 1)).astype(np.float32),
        rgb_size=np.tile([[640.0, 480.0]], (F, 1)).astype(np.float32),
        poses=poses.astype(np.float32),
    )


def phase_slice_parity(dev) -> dict:
    from tpu3dlm_torch.models.beit import BeitConfig
    from tpu3dlm_torch.models.layers import calibrate_batchnorm_
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
    from tpu3dlm_torch.pipeline.fused import FusedScanRunner

    cfg = BeitConfig(image_size=64, patch_size=16, hidden_size=64, num_layers=2,
                     num_heads=4, intermediate_size=128, num_labels=2)
    kw = dict(img_size=128, conf_thresh=0.97, max_det=16, nc=80, beit_config=cfg,
              dtype=torch.float32, crop_budget=32, rng_seed=SEED)
    scan = synthetic_scan(4, 128, (48, 64), SEED + 1)
    cpu = FusedScanRunner(device="cpu", **kw)
    calibrate_batchnorm_(cpu.yolo, torch.from_numpy(scan.rgb).float() / 255.0)
    gpu = FusedScanRunner(device=dev, **kw)
    gpu.yolo.load_state_dict(cpu.yolo.state_dict())  # same weights on both
    gpu.beit.load_state_dict(cpu.beit.state_dict())
    d_c, g_c = cpu(scan)
    before = beit_attention_packed.launches
    d_g, g_g = gpu(scan)
    launches = beit_attention_packed.launches - before
    check(launches == cfg.num_layers, launches)
    check(0 < d_c.mask.sum() < d_c.mask.size, "the threshold must keep some boxes and drop some")
    np.testing.assert_array_equal(d_g.mask, d_c.mask)
    np.testing.assert_array_equal(d_g.label, d_c.label)
    np.testing.assert_array_equal(d_g.damage, d_c.damage)
    m = d_c.mask
    conf_err = float(np.abs(d_g.conf - d_c.conf).max())
    box_err = float(np.abs(d_g.boxes - d_c.boxes).max())
    corner_err = float(np.abs(g_g.corners[m] - g_c.corners[m]).max())
    # boxes 1e-2 px: the DFL expectation turns the f32 round-off of ~60
    # conv layers (cuDNN vs CPU, TF32 off) into up to ~7e-3 px here
    check(box_err <= 1e-2 and corner_err <= 1e-4, (box_err, corner_err))
    result = {"phase": "slice_parity", "frames": 4, "detections": int(m.sum()),
              "damage_labelled": int((d_c.damage[m] >= 0).sum()), "b1_launches": launches,
              "max_conf_err": conf_err, "max_box_err_px": box_err, "max_corner_err_m": corner_err}
    emit(result)
    return result


def phase_fused_full_width(dev) -> dict:
    from tpu3dlm_torch.mapper.nms3d import suppress_bboxes
    from tpu3dlm_torch.mapper.projection import project_boxes
    from tpu3dlm_torch.models.beit import BeitConfig
    from tpu3dlm_torch.models.layers import calibrate_batchnorm_
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
    from tpu3dlm_torch.parallel.inference import (
        boxes_to_original, classify_top_crops, detect, square_box_affine,
    )
    from tpu3dlm_torch.pipeline.fused import FusedScanRunner

    F, crop_budget = 128, 384
    cfg = BeitConfig()  # BEiT-base: 12 layers, 768 wide, 12 heads, 224 px, N = 197
    runner = FusedScanRunner(img_size=640, conf_thresh=0.25, max_det=64, nc=80, variant="n",
                             beit_config=cfg, dtype=torch.bfloat16, crop_budget=crop_budget,
                             rng_seed=SEED, device=dev)
    scan = synthetic_scan(F, 640, (192, 256), SEED + 2)
    calibrate_batchnorm_(runner.yolo, torch.as_tensor(scan.rgb[:16], device=dev).float() / 255.0)
    crops_seen: list[int] = []
    runner.beit.register_forward_pre_hook(lambda mod, args: crops_seen.append(args[0].shape[0]))

    # the main path, once, with the counts at 0
    beit_attention_packed.launches = 0
    det, gboxes = runner(scan)
    kept = suppress_bboxes(gboxes, scan.poses, device=dev)
    main_launches = beit_attention_packed.launches
    check(crops_seen == [crop_budget], crops_seen)
    check(main_launches == cfg.num_layers, main_launches)
    check(det.boxes.shape == (F, 64, 4) and gboxes.corners.shape == (F, 64, 4, 3),
          (det.boxes.shape, gboxes.corners.shape))
    m = det.mask
    check(m.any() and np.isfinite(gboxes.corners[m]).all() and np.isfinite(det.boxes).all(),
          "finite boxes and corners for the kept detections")
    check(set(np.unique(det.damage)) <= {-1, 0, 1}, np.unique(det.damage))
    check(kept.mask.sum() <= m.sum(), "3D NMS keeps a subset")

    # warm timings of the same entry points
    torch.cuda.reset_peak_memory_stats()
    beit_attention_packed.launches = 0
    step_ms, step_samples = host_ms(lambda: runner(scan), runs=5)
    check(beit_attention_packed.launches == 5 * cfg.num_layers, beit_attention_packed.launches)
    nms_ms, nms_samples = host_ms(lambda: suppress_bboxes(gboxes, scan.poses, device=dev), runs=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # per-stage split on device tensors (same functions the step chains)
    up = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    rgb = torch.as_tensor(scan.rgb, device=dev)
    depth, intr, size, poses = up(scan.depth), up(scan.intrinsics), up(scan.rgb_size), up(scan.poses)
    affine = up(square_box_affine(scan.rgb_size, 640))
    with torch.inference_mode():
        x = rgb.float() / 255.0
        d = detect(runner.yolo, x, 640, 64)
        mask = d["conf"] >= 0.25
        boxes_px, boxes_rect = boxes_to_original(d["boxes"], affine, size)
        detect_ms, _ = host_ms(lambda: detect(runner.yolo, rgb.float() / 255.0, 640, 64))
        classify_ms, _ = host_ms(lambda: classify_top_crops(
            runner.beit, x, boxes_rect, d["conf"], mask, 0.25, crop_budget))
        project_ms, _ = host_ms(lambda: project_boxes(
            boxes_px, mask, depth, intr, size, poses, median_samples=16))
    result = {
        "phase": "fused_full_width", "frames": F, "img_size": 640, "crop_budget": crop_budget,
        "dtype": "bfloat16", "detections": int(m.sum()), "kept_after_nms": int(kept.mask.sum()),
        "crops_classified": crops_seen[0], "b1_launches_main_path": main_launches,
        "step_ms": step_ms, "step_ms_samples": step_samples,
        "frames_per_s": F / (step_ms / 1e3),
        "nms_ms": nms_ms, "nms_ms_samples": nms_samples,
        "stage_ms": {"detect": detect_ms, "rectify_classify": classify_ms, "project": project_ms},
        "peak_mem_gb": peak_gb,
    }
    emit(result)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from tpu3dlm_torch.device import resolve_device
    from tpu3dlm_torch.kernels.build import build_all

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    mem_rate = card_memory_rate(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    libs = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(str(p.name) for p in libs.values())})

    b1 = phase_kernel_b1(dev, mem_rate)
    phase_slice_parity(dev)
    full = phase_fused_full_width(dev)
    emit({"kernels": [{
        "name": "beit_attention_packed", "route": "cuda",
        "source": "tpu3dlm_torch/csrc/beit_attention.cu",
        "replaces": "tpu3dlm/ops/pallas/attention.py:159",
        "launches": full["b1_launches_main_path"],
        "max_abs_err": b1["max_abs_err"], "ms": b1["kernel_ms"], "kernel_ms": b1["kernel_ms"],
        "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
        "library_ms": b1["library_ms"],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
