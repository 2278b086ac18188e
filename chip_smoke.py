#!/usr/bin/env python3
"""Drive the tpu3dlm_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``tpu3dlm_torch/csrc`` (into
``tpu3dlm_torch/_build``, one ``nvcc`` per source and one ``c++`` for the
host C++ sources, all at once), then runs thirty-five phases, each printing one
JSON line; any failure raises and the script exits non-zero without a result:

1. ``kernel_b1``: kernel B1 (BEiT attention) against its plain PyTorch twin
   at the production shape in bf16 (tolerance 1e-2 abs and rel: one bf16
   ulp of p and of the output) and in f32 (1e-5: summation order only) at
   small shapes, N = 257 with d = 128, and the finetune shape, each case
   with the kernel the C entry routed it to (``attention_bf16_tma`` or
   ``attention_simt``, whose count must move); CUDA-event times of the
   kernel, the twin and ``F.scaled_dot_product_attention`` (the library
   yardstick; the port never calls it) beside the kernel's bound, for the
   bf16 path at (384, 197, 12, 64) and the f32 path at the finetune's
   (64, 197, 12, 64) (SDPA in f32 with TF32 off).
2. ``beit_past_old_limits``: the BEiT shapes of ROADMAP C1 (256 px, so
   N = 257; head width 128) at f32 on the card against the CPU, logits
   within 1e-5, one ``attention_simt`` launch per layer.
3. ``slice_parity``: the fused runner in f32 on the card (kernel, cuDNN,
   TF32 off) against the same runner on the CPU (twin) on a small scan:
   masks, labels and damage equal, boxes within 1e-2 px, corners within
   1e-4 m.
4. ``fused_full_width``: the scan-step main path — ``FusedScanRunner``
   (YOLOv10-n at 640², BEiT-base at 224, bf16, 128 frames, crop budget 384)
   and ``suppress_bboxes`` — once with the launch counts set to 0, then
   timed over warm runs, with a per-stage split.
5. ``kernel_b2``: kernel B2 (nearest neighbour) against its twin at the
   compare's shapes (16384 × 1,048,576 with sentinel padding, 10240 ×
   65,536, 4096 × 262,144), the Pipeline's (16384 and 4096 × 65,536), the
   anchor-index builds' (1,048,576 × 8192 and 262,144 × 2048, the target
   as the queries), an odd small shape and a tie case: every d²
   within 1e-4 m², and where the indices differ the two d² within 1e-5 m²
   (a genuine near-tie); against an f64 brute force on 2048 queries, d²
   within 1e-3 and every pick's true d² within 1e-5 m² of the minimum;
   identical-pick shares of ≥ 99.9% (twin) and ≥ 99% (f64) on the sparse
   shapes (``phase_kernel_b2`` says why not on the dense ones). Times of the
   kernel and the twin at every compare, Pipeline and index-build shape,
   and of a chunked ``torch.cdist(...).min(1)`` at the compare's (a
   yardstick: no single PyTorch call computes this function), beside the
   bound.
6. ``compare_parity``: ``Alignment.compare`` + ``BBoxComparison`` on the
   card against the same on the CPU (twin) on a ~20k-point two-scan scene:
   final transform and every recorded step within 1e-4, rmse and inlier
   fraction within 1e-5, the same verdict reasons, assignment and CSV rows.
7. ``compare_full_width``: the two-scan main path at full width — two ~1M
   point clouds, a 16384-point query, three ICP stages of 30 iterations,
   ``global_init="auto"``, point-to-plane, fused matching — once with the
   launch counts at 0 and a cold gold cache, then 5 warm captures, with the
   split into gold-side host work, NN sweeps and the rest, and B2's calls
   of one capture by shape (count and CUDA-event ms per (n, m)).
8. ``ann_parity``: the anchor-bucketed NN index (``ops/ann.py``) over the
   scene's padded gold target (1,048,576 rows, 8192 anchors) built on the
   card against the CPU from the same anchors (anchors identical; a row on
   another anchor only at an f32 near-tie, ≤ 1e-5 m² in f64; every other
   bucket identical), and ``nn_anchored`` on 16384 queries, card against
   CPU (the same pick or d² within 1e-5 m²) and against exact B2 (recall ≥
   99.5% by the JAX package's rule); times of the build and of one
   anchored sweep beside exact B2, at the final and the coarse stage.
9. ``compare_full_width_ann``: ``compare_full_width`` at ``ann="auto"``,
   the default: a cold capture with an empty index cache (one B2 launch at
   each index-build shape, the builds timed), 5 warm captures in turns
   with 5 at ``ann="off"`` (no build launch), a split into anchored and
   exact sweeps; the registration sanity and the final transform within
   5e-3 of the ``ann="off"`` capture's.
10. ``kernel_b3``: kernel B3 (head-major attention) against its twin at
   (h, B, N, d) = (12, 384, 197, 64) bf16 (1e-2) and small f32 shapes
   (1e-5; N = 33, B = 5), and against B1 through the layouts on every
   input; B3's path — the public op ``beit_attention`` forward and backward
   at the production shape — once with the count at 0; times of the
   kernel, the twin and ``F.scaled_dot_product_attention`` beside the
   bound.
11. ``attention_grad``: B1's and B3's outputs carry gradients on the card,
   and their q, k, v and bias gradients equal plain autograd through the
   twins at f32 within 1e-5; a BEiT-base attention layer's q/k/v weights
   and relative-position table get non-zero gradients.
12. ``finetune_parity``: three finetune steps of a small BEiT (32 px,
   hidden 64, 2 layers, 4 heads, 3 labels) at f32 on the card and on the
   CPU: losses within 1e-5, the first step's gradients within 1e-5.
13. ``finetune_full_width``: the finetune main path — ``init_finetune`` and
    ``make_beit_train_step`` on BEiT-base at 224, f32, batch 64 — one
    warm-up step with the counts at 0 (12 B1 launches, all on
    ``attention_simt``, each one's output
    held against the twin on that layer's own q, k, v and bias within
    1e-5), 5 timed steps (the loss must fall), peak memory and a profiled
    step.
14. ``kernel_b4``: kernel B4's variants against their bf16 twin and f64
    (and bit-equal to each other) at small shapes; then the probe's path
    (``tpu3dlm_torch/scripts/bench_nn_variants.py``: verify, then time at
    16384 × 1,048,576 beside B2) with the counts of both CUDA kernels at 0,
    its JSON lines, and each variant's output of that timing run held
    against the twin on the same inputs by the small shapes' bars (f64 on
    every 64th query); the twin's time and the bound.
15. ``ingest_parity``: the committed capture (``tests/fixtures/
    torch_project``, two 5-frame scans written by the JAX package's
    ``make_project``) through ``ImageExtractor.fetch_data`` and
    ``load_scan`` at img_size 128 and 640 on this host, which has no cv2:
    every array's sha256 equal to the JAX package's (``expected.json``);
    host decode ms per frame (JPEG, depth PNG, resizes) and ``load_scan``
    frames/s of a 128-frame scan with 0 and 8 decode workers.
16. ``pipeline_parity``: ``bench_e2e.py``'s flow on that capture
    (make_project's config, fused route, fixture checkpoints, f32): gold and
    maintenance Pipelines on the card against the CPU — masks, labels and
    damage equal, boxes within 1e-2 px, corners within 1e-4 m, the same
    kept boxes, every ICP step within 1e-4, verdict reasons identical,
    report rows and CSV identical but for the 0.1 mm-rounded box distance
    (within 2e-4 m), exactly one missing sign; B1 and B2 launched.
17. ``pipeline_full_width``: the user's path, ``tpu3dlm_torch.cli.main(
    ["--data", "maintenance", ...])``, on the capture tiled to 128 frames a
    scan at 640², crop budget 384, bf16, a seeded BEiT-base, once with the
    counts at 0 (B1: 12 launches per scan on ``attention_bf16_tma``; B2 by
    shape), then 5 warm maintenance runs: per-stage ms, frames/s of detect
    + map, capture ms, peak memory. Sanity bars only.
18. ``staged_parity``: ``pipeline_parity`` on the staged route (the default
    ``fused_inference = false``, as ``BENCH_E2E_FUSED=0`` runs
    ``bench_e2e.py``): ``ObjectDetector``, then ``DamageDetector`` over
    every valid box; the same bars, and B1 launched once per layer for
    each classifier batch.
19. ``staged_full_width``: ``pipeline_full_width`` on the staged route
    (the default detector batch of 64): B1 launches per scan by kernel,
    the crops classified, B2 by shape, then 5 warm maintenance runs.
20. ``stream_parity``: ``pipeline_parity`` streamed in chunks of 2 frames
    (``streaming_chunk = 2``: chunks of 2, 2 and 1 + padding): the same
    bars card against CPU, and the card's streamed run against its
    whole-scan fused run; at most 2 chunks in flight, B1 once per layer and
    chunk, the valid boxes per chunk (the per-chunk crop budget never
    binds).
21. ``stream_full_width``: the serving path — the capture tiled to 512
    frames a scan at 640², YOLOv10-n, a seeded BEiT-base in bf16, crop
    budget 384, 8 decode threads, ``streaming_chunk = 32`` — through the
    CLI with the counts at 0 (B1 12 launches per chunk at B = 256 on
    ``attention_bf16_tma``, one chunk's output held against the twin within
    1e-2 absolute and relative); then 3 warm streamed maintenance runs in
    turns with 3 whole-scan ones, one profiled streamed run (device idle
    share), and with
    ``scan_cache = true`` one writing run and 3 decode-free runs on each
    route: stage and capture ms, frames/s of extract + detect, device and
    host peaks, chunks in flight, valid boxes; the same report rows on
    every leg as in the CLI's run (the missing count is recorded: at 640²
    the 128-px fixture detector keeps one box a scan).
22. ``watch_full_width``: ``ScanWatcher`` on the default config (staged
    route) over ``gold_std`` and 3 maintenance captures of 128 frames at
    640², at concurrency 1 and then 2 on fresh copies: DONE for every
    maintenance capture with the missing count of a plain CLI run, the same
    report rows at both and as that run, no thread left after ``close()``,
    and at concurrency 2
    B1's and B2's launch counts equal to the sum of the captures' own;
    per-capture wall clock and captures per minute.
23. ``mesh_parity``: the map stage (``visualise = true``) on the card
    against the CPU on the committed capture at ``bench_e2e.py``'s small
    configuration, ``eps = 0.1``, ``mesh_voxel = 0.04``: the gold
    Pipeline's ``map_mesh.ply`` for ``mesh_source = tsdf``,
    ``cloud``/``density`` and ``cloud``/``poisson`` — TSDF and density
    meshes identical, the Poisson mesh within the planar-sheet bars of
    ``hold_mesh`` — then the TSDF field of both scans at 0.08 and 0.04
    (NaN-mask flips and values more than 1e-5 apart counted, ≤ 1e-4 of the
    voxels) and the Poisson χ and iso of the DBSCAN-kept gold cloud within
    1e-5 × max|χ| (cuFFT against pocketfft). No port kernel runs there.
24. ``mesh_full_width``: (a) the CLI's gold run with ``visualise = true``
    on the capture tiled to 128 frames at 640² for each mesh setting at
    ``mesh_voxel = 0.04``: the median of 3 warm ``plot`` stages, the
    device peak and idle share of one, and the legs of one (DBSCAN,
    normals, splat, FFT solve, fuse, iso sample, march, cull, PLY write,
    the rest — uploads and downloads — apart; CUDA events on the device
    legs); (b)
    ``Mapping.make_mesh`` on the ~1M-point gold cloud of
    ``two_scan_scene(1_000_000)``, DBSCAN at ``eps = 0.1``, ``min_points =
    50`` (the default 0.04 / 1000 leaves no core point, checked), both
    meshers at 0.04 and 0.01, with ``tests/test_meshing.py``'s two-sided
    distance gate; (c) the TSDF of the 128-frame scan at 0.01. Effective
    voxel, grid dims and voxel count, vertices and faces of each.
25. ``int8_full_width``: the int8 classifier (``beit_quant = int8``) at
    full width — the card's int8 GEMM (``torch._int_mm`` through
    ``ops/quant.py``) against the CPU twin, int32 identical, at rows ≤ 16
    (padded) and at the forward's shapes, with the kernel row- and
    column-major, and fc1's projection split into its steps beside a bf16
    GEMM; BEiT-base at 224², seeded and quantised by the port, on
    384 crops: the int8 model in f32 and in bf16 against f32 (softmax drift
    < 0.1, the same top-1 on decisive crops), one int8 forward with the
    counts at 0 (12 B1 launches on ``attention_bf16_tma``, 72 int8 GEMMs),
    classify ms of int8 and bf16 in turns (median of 5 warm runs) with the
    device peak; then ``fused_full_width``'s scan step with the int8
    classifier beside bf16: step ms and the classify stage's ms.
26. ``eval_parity``: the accuracy loop at fixture scale — the whole
    hard-eval corpus (7 axes × 5 seeds × 14 frames, img_size 128, conf
    0.3, the committed checkpoints, f32) through the detector and the
    damage corpus (5 axes) through detect → rectify → classify (B1 on
    ``attention_simt``), held to the JAX package's CPU reports in
    ``tests/fixtures/torch_eval``: ``n_gt`` / ``n_pairs`` identical on
    every axis, mAP50 within max(0.06, the axis's ``map50_spread``),
    accuracy within max(0.03, the axis's ``accuracy_spread``); the damage
    corpus again with the int8 classifier, each axis within 0.03 of the
    float run; ``verify`` on a fresh ``make_project`` (placement ≤ 0.1 m,
    one missing sign, B1 and B2 launched) and the CLI's ``--setup`` for
    ``gold_std`` then ``maintenance``; the committed artifacts' gate
    verdicts on the port's reports, printed.
27. ``eval_full_width``: the same corpus at the ``*_FULL`` artifacts'
    operating point (YOLOv10-n at 640², BEiT-base at 224² in bf16 and in
    int8, seeded weights, seed 11 only): finite metrics and the ground
    truth of ``eval_parity``'s seed 11 (accuracy is not held: no 640-pixel
    checkpoint is in the repo); host generation ms per scan, JPEG encode
    ms per frame, detect frames/s, classify ms per batch of 64 in bf16 and
    int8, and the device idle share of one profiled axis.
28. ``vis_parity``: the views of a run (``view_img``, ``alignment_vis``,
    ``comparison_vis``) through gold and maintenance on the staged route
    at ``bench_e2e.py``'s configuration (fixture checkpoints, f32), the ICP
    cut to one iteration a stage so the animation has at most 80 frames,
    on the card against the CPU: the card's report CSV byte-identical with
    the switches off, both runs held by ``pipeline_parity``'s bars; the
    annotated PNGs identical but where a drawn box corner straddles an
    integer between card and CPU (those frames and pixels counted); the
    animation's frame count equal and its frames within 1% of the pixels
    on another surface (background, gold, comparison); ``frame_view_
    geometry`` and ``scan_to_pointcloud`` of both scans within 1e-5 m; B1
    and B2 launched.
29. ``vis_full_width``: (a) the animation of ``compare_full_width``'s
    capture (two ~1M-point clouds, subsampled to 50,000 as the Pipeline
    does, density mesh at span/72, 480 × 640) over its first 2 moving
    steps (40 frames): mesh, render per frame, write, host peak, and the
    whole record's frame count and reckoned time; (b) ``view_img`` on
    ``staged_full_width``'s 128-frame maintenance capture at 640²: the
    detect stage with and without it, the drawing and PNG ms per frame; (c)
    ``scan_to_pointcloud`` of that scan on the card.
30. ``envelope_parity``: the convergence-envelope sweep
    (``python -m tpu3dlm_torch.scripts.alignment_envelope``: 3 seeds, 144
    registrations) on the card against ``docs/ALIGNMENT_ENVELOPE.json``:
    every cell's success and verdict flag equal, or (printed) within 0.5° /
    0.01 m of the success line or near a verdict floor; the verdict's catch
    and false-alarm rates within 0.05; B2's launches and the wall time.
31. ``train_parity``: training on the card against the port's CPU run on
    the same noise drawn once on the CPU and the same Flax-like init:
    YOLOv10-n at 128 px on 4 frames of the committed capture with the hard
    recipe's augmentation, 3 steps (losses, step 1's augmented batch, TAL
    foreground, BatchNorm statistics and gradients, the last also against
    a float64 run), and the toy BEiT with crop augmentation, 3 steps
    (losses, the augmented uint8 crops identical, B1 launched);
    ``phase_train_parity`` states each bar.
32. ``train_full_width``: ``python -m tpu3dlm_torch.scripts.e2e_accuracy
    --full-scale`` through its ``main`` (YOLOv10-n at 640², 1500 steps on
    the 5-frame gold scan; BEiT-base at 224² in f32, 120 steps; ``verify``
    over both scans) with the counts at 0: ``docs/ACCURACY_FULL_SCALE.json``'s
    bars, training seconds, each model's median step ms, the first and
    last loss, the device peak, B1's launches in training and B1's and
    B2's in ``verify``; then the hard recipe's 640² step (16 sampled
    frames, erase, cosine, EMA) on 4 corpus scenes: step ms and peak.
33. ``dist_full_width``: the world of ranks (``tpu3dlm_torch/parallel``)
    at full width in a real 1-rank NCCL world on the card: the sharded
    scan step (``fused_full_width``'s shape), ``target_sharded_nn`` at
    16384 × 1,048,576, the data-parallel BEiT-base f32 step at batch 64 and
    the data-parallel YOLOv10-n step at 640², each held to its unsharded
    twin (``phase_dist_full_width`` states the bars) and timed beside it in
    turns: the collectives' own cost at world 1.
34. ``dist_parity``: ``python -m tpu3dlm_torch.scripts.distributed_smoke
    --procs 2 --backend gloo``, two ranks sharing the card, the four legs
    held against one device, B1 and B2 launched on every rank; over NCCL
    too when two cards are visible (a line says when that does not apply).
35. ``kernels``: one line listing every ported kernel (B1 on its two
    routes — ``attention_bf16_tma`` counted on the scan step,
    ``attention_simt`` on the finetune step — B2, B3, B4 v1 and v2) with
    its launches, the path they were counted on (``launches_on``), error,
    times and bound; every B1 case with its route, and B2's main-path
    launches and its times and bounds by shape. B1's and B2's rows also
    carry their launches on the Pipeline (``launches_on_pipeline``, from
    ``pipeline_full_width``); B1's on the staged route
    (``launches_on_staged``, from ``staged_full_width``) and B2's on the
    ANN compare (``launches_on_ann``, from ``compare_full_width_ann``); B1's
    on the streamed path (``launches_on_stream``, its shape and error, from
    ``stream_full_width``); B1's and B2's on the watcher
    (``launches_on_watch``, from ``watch_full_width``); B1's in the int8
    forward and the int8 scan step (``launches_on_int8``, from
    ``int8_full_width``) and per damage-eval run (``launches_on_damage_
    eval``, from ``eval_parity``); B1's and B2's in ``verify``
    (``launches_on_verify``); B1's and B2's on the views of a run
    (``launches_on_vis``, from ``vis_parity``) and B2's on the envelope
    sweep (``launches_on_envelope``); B1's in training (``launches_on_train``)
    and B1's and B2's in the ``verify`` after it (``launches_on_train_verify``),
    from ``train_full_width``; B1's and B2's on the world's paths
    (``launches_on_dist``, from ``dist_full_width`` and, by rank,
    ``dist_parity``).

The script's total seconds are printed on the line before the card's name
and power limit (nvidia-smi), which come before the last line; the last
line is ``{"ok": true, "device": {...}}``. Inputs and weights are made from
fixed seeds. Without CUDA the script exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
# the __global__ functions of tpu3dlm_torch/csrc, as the profiler names them
PORT_KERNELS = ("attention_bf16_tma", "attention_simt", "nn_partial_kernel", "nn_fold_kernel",
                "nn_variant_kernel")


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
        kernel_route,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    checks = []
    inputs = {}
    for dtype, (B, N, h, d), tol in [
        (torch.bfloat16, (384, 197, 12, 64), 1e-2),
        (torch.bfloat16, (5, 9, 2, 64), 1e-2),
        (torch.bfloat16, (3, 257, 2, 64), 1e-2),  # past the TMA kernel's 256 tokens
        (torch.float32, (5, 33, 3, 16), 1e-5),
        (torch.float32, (16, 197, 12, 64), 1e-5),
        (torch.float32, (2, 257, 2, 128), 1e-5),  # the shapes of ROADMAP C1
        (torch.float32, (64, 197, 12, 64), 1e-5),  # the finetune step's shape
    ]:
        q, k, v = (torch.randn(B, N, h * d, generator=g, device=dev).to(dtype) for _ in range(3))
        bias = torch.randn(h, N, N, generator=g, device=dev)
        kernel = kernel_route(dtype, N, d)
        before = beit_attention_packed.launches_by_kernel[kernel]
        out = beit_attention_packed(q, k, v, bias, h)
        torch.cuda.synchronize()
        check(beit_attention_packed.launches_by_kernel[kernel] == before + 1, (kernel, B, N, h, d))
        ref = beit_attention_packed_reference(q, k, v, bias, h)
        max_err = float((out.float() - ref.float()).abs().max())
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        checks.append({"dtype": str(dtype).split(".")[-1], "shape": [B, N, h, d], "kernel": kernel,
                       "max_abs_err": max_err, "tol": tol})
        inputs[dtype, B] = dict(q=q, k=k, v=v, bias=bias, shape=(B, N, h, d), max_err=max_err,
                                kernel=kernel)

    def timed(case) -> dict:
        q, k, v, bias = case["q"], case["k"], case["v"], case["bias"]
        B, N, h, d = case["shape"]
        heads = lambda t: t.view(B, N, h, d).transpose(1, 2)  # noqa: E731
        mask = bias.to(q.dtype)[None]
        bound_ms, bound_by = attention_bound_ms(B, N, h, d, q.dtype, mem_rate)
        return {
            "shape": [B, N, h, d], "dtype": str(q.dtype).split(".")[-1], "kernel": case["kernel"],
            "kernel_ms": cuda_ms(lambda: beit_attention_packed(q, k, v, bias, h)),
            "plain_ms": cuda_ms(lambda: beit_attention_packed_reference(q, k, v, bias, h)),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=mask)),
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": case["max_err"],
        }

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for the f32 yardstick")
    result = {"phase": "kernel_b1", "checks": checks, **timed(inputs[torch.bfloat16, 384]),
              "f32_path": timed(inputs[torch.float32, 64])}
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
    beit_attention_packed.launches_by_kernel.clear()
    det, gboxes = runner(scan)
    kept = suppress_bboxes(gboxes, scan.poses, device=dev)
    main_launches = beit_attention_packed.launches
    by_kernel = dict(beit_attention_packed.launches_by_kernel)
    check(crops_seen == [crop_budget], crops_seen)
    check(main_launches == cfg.num_layers and by_kernel == {"attention_bf16_tma": main_launches},
          (main_launches, by_kernel))
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
        "b1_launches_by_kernel_main_path": by_kernel,
        "step_ms": step_ms, "step_ms_samples": step_samples,
        "frames_per_s": F / (step_ms / 1e3),
        "nms_ms": nms_ms, "nms_ms_samples": nms_samples,
        "stage_ms": {"detect": detect_ms, "rectify_classify": classify_ms, "project": project_ms},
        "peak_mem_gb": peak_gb,
    }
    emit(result)
    return result


# ---------------------------------------------------------------------------
# The two-scan compare (kernel B2)
# ---------------------------------------------------------------------------

# The signs of the synthetic gold scan: (x0, y0, x1, y1, z, label, damage),
# rectangles on the wall at z = 3 m.
SIGNS = [
    (-0.6, -0.4, -0.2, 0.1, 2.8, 0, 0),
    (0.3, -0.5, 0.8, 0.0, 2.85, 1, 1),
    (1.2, 0.1, 1.7, 0.55, 2.8, 0, 0),
]


def two_scan_scene(n_target: int, seed: int = SEED):
    """Two clouds of ~``n_target`` points related by a known SE(3), made
    with numpy: a 4 × 2.5 m wall at z = 3 with sign rectangles in front of
    it (sampled at twice the density), a perpendicular floor and a side
    wall. The maintenance scan misses the last sign and is moved by ``Tw``
    (12° about z, [0.4, −0.25, 0.15] m). Returns (base, comp, base_boxes,
    comp_boxes, Tw); boxes in the reference's dict-of-frames shape."""
    per_m2 = max(1000, int(n_target / 21.0))  # wall 10 + floor 6 + side 3.75 m² + signs

    def scene(signs, rng):
        n_wall = int(4.0 * 2.5 * per_m2)
        parts = [np.stack([rng.uniform(-1.5, 2.5, n_wall), rng.uniform(-1.25, 1.25, n_wall),
                           np.full(n_wall, 3.0)], 1)]
        for x0, y0, x1, y1, z, _, _ in signs:
            k = max(50, int((x1 - x0) * (y1 - y0) * per_m2 * 2))
            parts.append(np.stack([rng.uniform(x0, x1, k), rng.uniform(y0, y1, k),
                                   np.full(k, z)], 1))
        n_floor, n_side = int(6.0 * per_m2), int(3.75 * per_m2)
        parts.append(np.stack([rng.uniform(-1.5, 2.5, n_floor), np.full(n_floor, 1.25),
                               rng.uniform(1.5, 3.0, n_floor)], 1))
        parts.append(np.stack([np.full(n_side, -1.5), rng.uniform(-1.25, 1.25, n_side),
                               rng.uniform(1.5, 3.0, n_side)], 1))
        return np.concatenate(parts).astype(np.float32)

    def boxes(signs, T=None):
        rows = []
        for x0, y0, x1, y1, z, label, damage in signs:
            c = np.array([[x0, y0, z], [x0, y1, z], [x1, y1, z], [x1, y0, z]], np.float32)
            if T is not None:
                c = c @ T[:3, :3].T + T[:3, 3]
            rows.append([c[0], c[1], c[2], c[3], damage, 0.9, label])
        return {0: rows}

    ang = 0.12
    Tw = np.eye(4, dtype=np.float32)
    Tw[:3, :3] = [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    Tw[:3, 3] = [0.4, -0.25, 0.15]
    base = scene(SIGNS, np.random.default_rng(seed))
    comp = scene(SIGNS[:-1], np.random.default_rng(seed + 1)) @ Tw[:3, :3].T + Tw[:3, 3]
    return base, comp.astype(np.float32), boxes(SIGNS), boxes(SIGNS[:-1], Tw), Tw


IDENTITY_POSES = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (4, 1))


def run_compare(scene, device, csv_path, **kw):
    """One capture the way the pipeline runs it: ``Alignment.compare`` then
    ``BBoxComparison.match_bboxes`` with the fused assignment and verdict
    (``ann="off"`` unless ``kw`` says otherwise). Returns (alignment,
    aligned boxes, report rows)."""
    from tpu3dlm_torch.alignment.align import Alignment
    from tpu3dlm_torch.alignment.comparison import BBoxComparison

    base, comp, base_boxes, comp_boxes, _ = scene
    align = Alignment(IDENTITY_POSES, IDENTITY_POSES, base_boxes, comp_boxes, base_cloud=base,
                      comparison_cloud=comp, device=device, **{"ann": "off", **kw})
    aligned, _, _, _ = align.compare("chip_smoke")
    rows = BBoxComparison(base_boxes, aligned, None, csv_output_file=csv_path,
                          precomputed_match=align.last_match,
                          alignment_verdict=align.last_verdict.to_dict(),
                          device=device).match_bboxes()
    return align, aligned, rows


def nn_bound_ms(n: int, m: int, mem_rate: float) -> tuple[float, str]:
    """Least time for the NN function: three f32 FMAs (6 flops) per pair at
    the f32 peak, against the inputs read once ((n + m)·12 B) and the
    outputs written once (n·12 B: int64 index + f32 d²); the larger."""
    t_ops = 6.0 * n * m / PEAK_F32_FLOPS
    t_bytes = ((n + m) * 12 + n * 12) / mem_rate
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def cdist_min(a, b, chunk: int = 65536):
    """Yardstick only: nearest neighbour by chunked ``torch.cdist`` + min
    (distances, not squared; never called by the port)."""
    best_d = best_i = None
    for j0 in range(0, b.shape[0], chunk):
        d, i = torch.cdist(a, b[j0:j0 + chunk]).min(dim=1)
        if best_d is None:
            best_d, best_i = d, i
        else:
            better = d < best_d
            best_d = torch.where(better, d, best_d)
            best_i = torch.where(better, i + j0, best_i)
    return best_i, best_d


def f64_nearest(a, b, chunk: int = 65536):
    """(true d² f64, index) of each query's nearest target, brute force in
    f64 on the card (|a|² − 2a·b + |b|² in f64: cancellation ~1e-15 m²)."""
    a64, b64 = a.double(), b.double()
    a2 = (a64 * a64).sum(1, keepdim=True)
    best = torch.full((a.shape[0],), float("inf"), dtype=torch.float64, device=a.device)
    best_i = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    for j0 in range(0, b.shape[0], chunk):
        bc = b64[j0:j0 + chunk]
        dmin, darg = (a2 - 2 * a64 @ bc.T + (bc * bc).sum(1)[None]).min(1)
        better = dmin < best
        best, best_i = torch.where(better, dmin, best), torch.where(better, darg + j0, best_i)
    return best.clamp(min=0), best_i


def kernel_b2_cases(scene) -> list:
    """Kernel B2's cases, (name, queries, targets, sparse): the compare's
    three shapes on the scene (the final stage's 1,048,576 targets padded
    with sentinels; the init scoring's 10240 × 65,536 is also the
    Pipeline's), the Pipeline's two ICP shapes against a 65,536-point
    target, the anchor-index builds over the padded full target (8192
    anchors) and the coarse target (2048) with the target as the queries,
    an odd sparse shape and every target three times."""
    from tpu3dlm_torch.ops.ann import default_index_shape, sample_anchor_ids
    from tpu3dlm_torch.ops.icp import pad_target_bucket

    base, comp = scene[0], scene[1]
    rng = np.random.default_rng(SEED + 3)
    pick = lambda x, k: x[rng.choice(x.shape[0], k, replace=False)]  # noqa: E731
    q16 = pick(comp, 16384)
    init_q = np.concatenate([q16[:2048] + np.float32(0.05 * k) for k in range(5)])
    dup = rng.uniform(-2, 3, (1000, 3)).astype(np.float32)
    full = pad_target_bucket(base)[0]  # 1,048,576 with 1e6 sentinels
    coarse = base[np.random.default_rng(1).choice(base.shape[0], 262144, replace=False)]  # the compare's draw
    t65 = pick(base, 65536)
    anchors = lambda t: t[sample_anchor_ids(t.shape[0], default_index_shape(t.shape[0])[0], 0).numpy()]  # noqa: E731
    return [
        ("final_stage", q16, full, False),
        ("init_scoring", init_q, t65, False),
        ("coarse_stage", q16[:4096], pick(base, 262144), False),
        ("pipeline_final_stage", q16, t65, False),
        ("pipeline_coarse_stage", q16[:4096], t65, False),
        ("index_build_full", full, anchors(full), False),
        ("index_build_coarse", coarse, anchors(coarse), False),
        ("odd", rng.uniform(-2, 3, (1000, 3)), rng.uniform(-2, 3, (3001, 3)), True),
        ("ties", rng.uniform(-2, 3, (777, 3)), np.concatenate([dup, dup, dup]), True),
    ]


B2_TIMED = ("final_stage", "init_scoring", "coarse_stage", "pipeline_final_stage", "pipeline_coarse_stage",
            "index_build_full", "index_build_coarse")
B2_CDIST = ("final_stage", "init_scoring", "coarse_stage")  # cdist's (n, m) output fits on the card


def phase_kernel_b2(dev, mem_rate, scene) -> dict:
    """B2 against its twin, and against f64, at the compare's shapes, the
    Pipeline's and the anchor-index builds'.

    On the 1M-point scene the points lie ~4.6 mm apart, so many queries
    have a second neighbour whose d² is within the f32 rounding of the
    expansion (~4e-6 m² at |x|² ≈ 10) of the first: kernel and twin round
    differently and pick different members of such near-ties. The checks
    that bind on every shape are therefore: every d² within 1e-4 m² of the
    twin's; where the picks differ, the two d² within 1e-5 m²; and against
    f64, the true d² of the kernel's pick at most 1e-5 m² above the true
    minimum. The share of identical picks (≥ 99.9% against the twin, ≥ 99%
    against f64) binds on the sparse uniform shapes, where near-ties are
    rare; on the scene shapes it is recorded. In the index build over the
    padded target the 1e6 sentinel rows are queries too: their d² (~3e12
    m² to a real anchor) is compared only through the pick, which must be a
    point equal to the query (a sentinel anchor)."""
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors, nearest_neighbors_reference

    up = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)  # noqa: E731
    cases = kernel_b2_cases(scene)
    checks = []
    timing = None
    for name, a_np, b_np, sparse in cases:
        a, b = up(a_np), up(b_np)
        idx, d2 = nearest_neighbors(a, b)
        torch.cuda.synchronize()
        ri, rd2 = nearest_neighbors_reference(a, b)
        far = (a.abs() >= 1e5).any(1)  # sentinel queries
        if bool(far.any()):
            check(bool((b[idx[far]] == a[far]).all() and (b[ri[far]] == a[far]).all()), (name, "sentinels"))
        near = ~far
        same = float((idx[near] == ri[near]).float().mean())
        err = float((d2[near] - rd2[near]).abs().max())
        diff = (idx != ri) & near
        tie_err = float((d2[diff] - rd2[diff]).abs().max()) if bool(diff.any()) else 0.0
        check(err <= 1e-4 and tie_err <= 1e-5 and (same >= 0.999 or not sparse),
              (name, same, err, tie_err))
        # against f64 on (up to) 2048 queries
        k = min(2048, a.shape[0])
        true_d2, true_i = f64_nearest(a[:k], b)
        picked = ((a[:k].double() - b[idx[:k]].double()) ** 2).sum(1)
        f64_same = float((idx[:k] == true_i).float().mean())
        f64_err = float((d2[:k].double() - true_d2).abs().max())
        excess = float((picked - true_d2).max())
        check(f64_err <= 1e-3 and excess <= 1e-5 and (f64_same >= 0.99 or not sparse),
              (name, "f64", f64_same, f64_err, excess))
        if name == "ties":
            check(bool((idx < 1000).all()), "ties must go to the lowest index")
        row = {"case": name, "shape": [a.shape[0], b.shape[0]], "same_index_frac": same,
               "max_abs_err": err, "max_err_where_index_differs": tie_err,
               "f64_same_index_frac": f64_same, "f64_max_abs_err": f64_err,
               "f64_max_excess_of_pick": excess, "sentinel_queries": int(far.sum())}
        if name in B2_TIMED:
            n, m = a.shape[0], b.shape[0]
            big = n * m >= 1 << 33
            row["kernel_ms"] = cuda_ms(lambda: nearest_neighbors(a, b))
            row["plain_ms"] = cuda_ms(lambda: nearest_neighbors_reference(a, b),
                                      iters=2 if big else 5, warmup=1)
            if name in B2_CDIST:
                row["cdist_yardstick_ms"] = cuda_ms(lambda: cdist_min(a, b), iters=3, warmup=1)
            row["bound_ms"], row["bound_by"] = nn_bound_ms(n, m, mem_rate)
            if name == "final_stage":
                timing = row
        checks.append(row)
    result = {"phase": "kernel_b2", "checks": checks, "max_abs_err": timing["max_abs_err"],
              "kernel_ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
              "cdist_yardstick_ms": timing["cdist_yardstick_ms"], "bound_ms": timing["bound_ms"],
              "bound_by": timing["bound_by"], "shape": timing["shape"]}
    emit(result)
    return result


def _steps_err(a_steps, b_steps) -> float:
    check(len(a_steps) == len(b_steps), (len(a_steps), len(b_steps)))
    err = 0.0
    for x, y in zip(a_steps, b_steps):
        xs, ys = (x, y) if isinstance(x, tuple) else ((x,), (y,))
        for u, v in zip(xs, ys):
            err = max(err, float(np.abs(np.asarray(u) - np.asarray(v)).max()))
    return err


def phase_compare_parity(dev, tmp) -> dict:
    """The compare on the card (kernel B2) against the same on the CPU
    (twin) on a small two-scan scene."""
    import os

    from tpu3dlm_torch.alignment.comparison import BBoxComparison
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors

    scene = two_scan_scene(20000, SEED + 4)
    kw = dict(max_points=2048, icp_iterations=10, global_init="auto")
    cpu, _, cpu_rows = run_compare(scene, "cpu", os.path.join(tmp, "cpu.csv"), **kw)
    before = nearest_neighbors.launches
    gpu, aligned, gpu_rows = run_compare(scene, dev, os.path.join(tmp, "gpu.csv"), **kw)
    launches = nearest_neighbors.launches - before
    check(launches >= 5, launches)
    t_err = float(np.abs(gpu.final_transform - cpu.final_transform).max())
    step_err = _steps_err(gpu.transformations, cpu.transformations)
    v_g, v_c = gpu.last_verdict, cpu.last_verdict
    rmse_err, inl_err = abs(v_g.rmse - v_c.rmse), abs(v_g.inlier_frac - v_c.inlier_frac)
    check(t_err <= 1e-4 and step_err <= 1e-4, (t_err, step_err))
    check(rmse_err <= 1e-5 and inl_err <= 1e-5, (rmse_err, inl_err))
    check(v_g.reasons == v_c.reasons, (v_g.reasons, v_c.reasons))
    check(np.array_equal(gpu.last_match["assign"], cpu.last_match["assign"]),
          (gpu.last_match, cpu.last_match))
    check(gpu_rows == cpu_rows, (gpu_rows, cpu_rows))
    with open(os.path.join(tmp, "cpu.csv")) as f1, open(os.path.join(tmp, "gpu.csv")) as f2:
        check(f1.read() == f2.read(), "CSV bytes differ")
    # the auction on the card (no precomputed match) gives the same report
    solved = BBoxComparison(scene[2], aligned, None, csv_output_file=os.path.join(tmp, "a.csv"),
                            device=dev).match_bboxes()
    check([r["status"] for r in solved] == [r["status"] for r in gpu_rows], solved)
    result = {"phase": "compare_parity", "points": [int(scene[0].shape[0]), int(scene[1].shape[0])],
              "b2_launches": launches, "max_transform_err": t_err, "max_step_err": step_err,
              "rmse_err": rmse_err, "inlier_err": inl_err, "reasons": list(v_g.reasons),
              "rows": len(gpu_rows), "missing": sum(r["status"] == "missing" for r in gpu_rows)}
    emit(result)
    return result


def profile_capture(capture) -> dict:
    """One warm capture under ``torch.profiler``: the device's busy time
    (the time of the device's own events — kernels, copies — summed;
    an aten op's device time repeats its kernels' and is left out) against
    the wall time, the device events counted and split by kind (GEMMs, the
    port's kernels, the rest), the largest ones, and the host ops with the
    most self time. The profiler's own host cost is in ``wall_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        capture()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))  # noqa: E731
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in on_device) / 1e3
    top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    by_kind = {"gemm": 0.0, "port_kernels": 0.0, "other": 0.0}
    for e in on_device:
        port = any(f"(anonymous namespace)::{k}" in e.key for k in PORT_KERNELS)
        kind = "port_kernels" if port else "gemm" if "gemm" in e.key.lower() else "other"
        by_kind[kind] += dev_us(e) / 1e3
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms if busy_ms > 0 else None,
        "device_idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else None,
        "device_events": sum(e.count for e in on_device), "device_ms_by_kind": by_kind,
        "top_host_self_ms": {e.key: e.self_cpu_time_total / 1e3 for e in top},
        "top_device_ms": {
            e.key[:120]: dev_us(e) / 1e3 for e in sorted(on_device, key=dev_us, reverse=True)[:8]
        },
    }


def phase_compare_full_width(dev, tmp, scene) -> dict:
    import os

    from tpu3dlm_torch.alignment import align as align_mod
    from tpu3dlm_torch.ops import icp as icp_mod
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors
    from tpu3dlm_torch.ops.pointcloud import estimate_normals_grid

    base, comp, _, _, Tw = scene
    csv_path = os.path.join(tmp, "full.csv")
    capture = lambda: run_compare(scene, dev, csv_path)  # noqa: E731  (the defaults)

    # the main path, once, with the counts at 0 and a cold gold cache
    align_mod._GOLD_CACHE.clear()
    torch.cuda.reset_peak_memory_stats()
    nearest_neighbors.launches = 0
    nearest_neighbors.launches_by_shape.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    align, _, rows = capture()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    main_launches = nearest_neighbors.launches
    main_by_shape = {f"{n}x{m}": c for (n, m), c in sorted(nearest_neighbors.launches_by_shape.items())}
    check(1 + 3 <= main_launches <= 1 + 3 * 31, main_launches)
    check(sum(main_by_shape.values()) == main_launches, main_by_shape)
    err = float(np.abs(align.final_transform @ Tw - np.eye(4)).max())
    n_missing = sum(r["status"] == "missing" for r in rows)
    check(err <= 0.15 and n_missing == 1, (err, n_missing))
    check(np.isfinite(align.final_transform).all() and np.isfinite(align.last_verdict.rmse),
          "finite transform and rmse")
    check(len(align.transformations) >= 1 + 3 * 30, len(align.transformations))

    warm_ms, warm_samples = host_ms(capture, runs=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # split of one more warm capture: NN sweeps by CUDA events around each
    # call (no extra synchronisation), gold-side host work timed apart
    spans = []
    real_nn = icp_mod.nearest_neighbors

    def timed_nn(a, b):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = real_nn(a, b)
        e.record()
        spans.append((s, e, (int(a.shape[0]), int(b.shape[0]))))
        return out

    icp_mod.nearest_neighbors = timed_nn
    try:
        split_ms, _ = host_ms(capture, runs=1)
    finally:
        icp_mod.nearest_neighbors = real_nn
    nn_ms = sum(s.elapsed_time(e) for s, e, _ in spans)
    by_shape: dict = {}
    for s, e, shape in spans:
        row = by_shape.setdefault(f"{shape[0]}x{shape[1]}", {"n": shape[0], "m": shape[1], "calls": 0, "ms": 0.0})
        row["calls"] += 1
        row["ms"] += s.elapsed_time(e)
    host_part = lambda fn: host_ms(fn, runs=3)[0]  # noqa: E731
    fingerprint_ms = host_part(lambda: align_mod._target_fingerprint(base))
    normals_ms = host_part(lambda: estimate_normals_grid(base))
    query_draw_ms = host_part(lambda: align_mod._subsample(comp, align.max_points))
    # the box assignment on its own, at the compare's bucket shape
    from tpu3dlm_torch.ops.matching import auction_assign

    cost = torch.full((16, 16), float("inf"), device=dev)
    cost[:3, :2] = torch.rand(3, 2, generator=torch.Generator().manual_seed(SEED)).to(dev)
    auction_ms = host_part(lambda: auction_assign(cost, unmatch_cost=0.5)[0].cpu())
    profile = profile_capture(capture)

    result = {
        "phase": "compare_full_width", "points": [int(base.shape[0]), int(comp.shape[0])],
        "query": align.max_points, "stages": list(align.max_correspondence_dist),
        "iterations": align.icp_iterations, "global_init": align.global_init, "ann": "off",
        "b2_launches_main_path": main_launches, "b2_launches_by_shape_main_path": main_by_shape,
        "transform_err": err, "missing": n_missing,
        "rmse": align.last_verdict.rmse, "inlier_frac": align.last_verdict.inlier_frac,
        "verdict_ok": align.last_verdict.ok,
        "first_capture_cold_gold_ms": first_s * 1e3,
        "warm_capture_ms": warm_ms, "warm_capture_ms_samples": warm_samples,
        "split_capture_ms": split_ms,
        "split_ms": {"nn_sweeps": nn_ms, "nn_calls": len(spans), "nn_by_shape": by_shape,
                     "gold_fingerprint_host": fingerprint_ms,
                     "rest": split_ms - nn_ms - fingerprint_ms},
        "rest_parts_ms": {"query_draw_host": query_draw_ms, "auction_16x16": auction_ms},
        "gold_side_host_ms_cold_only": {"normals": normals_ms},
        "profile": profile,
        "peak_mem_gb": peak_gb,
        "final_transform": align.final_transform.tolist(),
    }
    emit(result)
    return result


# ---------------------------------------------------------------------------
# Slice 5: the anchor-bucketed NN index (kernel B2 builds it)
# ---------------------------------------------------------------------------


def anchor_assignment(index, m: int) -> torch.Tensor:
    """(m,) the anchor whose bucket holds each target row, −1 where the row
    was dropped by overflow."""
    C, B = index.bucket_ids.shape
    filled = index.buckets[..., 0] < 1e7  # empty slots hold 1e8
    slot_anchor = torch.arange(C, device=filled.device)[:, None].expand(C, B)
    out = torch.full((m,), -1, dtype=torch.int64, device=filled.device)
    out[index.bucket_ids[filled].long()] = slot_anchor[filled]
    return out


def hold_index(got, want, tgt: torch.Tensor) -> dict:
    """An index built on the card (kernel B2's assignment sweep) against the
    one built on the CPU (the twin's) from the same anchors. The anchors
    must be identical. The assignment of a target row to an anchor is an
    argmin over anchors in f32, where kernel and twin round differently
    (``phase_kernel_b2``): every row that went to another anchor must be a
    near-tie (its f64 d² to the two anchors within 1e-5 m², B2's bar), and
    every bucket that no such row touches must be identical, slot for slot
    (coordinates and ids). Returns the counts."""
    check(torch.equal(got.anchors.cpu(), want.anchors.cpu()), "anchors differ")
    m = tgt.shape[0]
    a_g, a_c = anchor_assignment(got, m).cpu(), anchor_assignment(want, m).cpu()
    moved = (a_g != a_c) & (a_g >= 0) & (a_c >= 0)
    anchors = want.anchors.cpu().double()
    p = tgt.cpu().double()[moved]
    d_g = ((p - anchors[a_g[moved]]) ** 2).sum(1)
    d_c = ((p - anchors[a_c[moved]]) ** 2).sum(1)
    tie = float((d_g - d_c).abs().max()) if bool(moved.any()) else 0.0
    check(tie <= 1e-5, ("assignment differs beyond a near-tie", tie))
    touched = torch.zeros(want.anchors.shape[0], dtype=torch.bool)
    for a in (a_g, a_c):
        touched[a[moved | ((a_g < 0) != (a_c < 0))].clamp(min=0)] = True
    same_b = torch.equal(got.buckets.cpu()[~touched], want.buckets.cpu()[~touched])
    same_i = torch.equal(got.bucket_ids.cpu()[~touched], want.bucket_ids.cpu()[~touched])
    check(same_b and same_i, "untouched buckets differ")
    identical = all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(got, want))
    return {"identical": identical, "rows_on_another_anchor": int(moved.sum()),
            "max_near_tie_d2_gap": tie, "anchors_touched": int(touched.sum()),
            "dropped_rows": {"card": int((a_g < 0).sum()), "cpu": int((a_c < 0).sum())}}


def hold_anchored(pi, pd, ci, cd, ei, ed) -> dict:
    """Anchored picks on the card (pi, pd) against the CPU (ci, cd) — the
    same pick, or d² within 1e-5 m² — and against exact B2 (ei, ed) by the
    JAX package's recall rule (tests/test_ann.py): the same pick or d²
    isclose(rtol 1e-3, atol 1e-4) for ≥ 99.5% of queries, and every miss
    within 4× the exact d² + 1e-3 m²."""
    pi, pd, ci, cd, ei, ed = (t.cpu() for t in (pi, pd, ci, cd, ei, ed))
    differ = pi != ci
    gap = float((pd[differ] - cd[differ]).abs().max()) if bool(differ.any()) else 0.0
    check(gap <= 1e-5, ("anchored picks card vs CPU", gap))
    exact = (pi == ei) | torch.isclose(pd, ed, rtol=1e-3, atol=1e-4)
    recall = float(exact.float().mean())
    worst = float((pd[~exact] - 4 * ed[~exact]).max()) if bool((~exact).any()) else -1.0
    check(recall >= 0.995 and worst <= 1e-3, ("recall against exact B2", recall, worst))
    return {"same_pick_card_cpu": float((~differ).float().mean()), "max_d2_gap_where_picks_differ": gap,
            "recall_vs_exact": recall, "worst_miss_excess": worst}


def phase_ann_parity(dev, scene) -> dict:
    """``build_anchor_index`` on the 1M-point scene's padded gold target
    (1,048,576 rows, 8192 anchors, buckets of 512) on the card against the
    CPU with the same anchor ids (``hold_index``), and ``nn_anchored`` on
    16384 queries (the maintenance cloud moved onto the gold one) card
    against CPU and against exact B2 (``hold_anchored``). Then CUDA-event
    times: the build (after a first one) and one anchored sweep at the
    final stage's 16384 queries and at the coarse stage's 4096 against the
    coarse target's index (262,144 rows, 2048 anchors), each beside exact
    B2 at the same shape."""
    from tpu3dlm_torch.alignment.align import _subsample
    from tpu3dlm_torch.ops import ann
    from tpu3dlm_torch.ops.icp import pad_target_bucket
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors

    base, comp, _, _, Tw = scene
    Ti = np.linalg.inv(Tw).astype(np.float32)
    tgt = torch.from_numpy(pad_target_bucket(base)[0])
    coarse = torch.from_numpy(base[np.random.default_rng(1).choice(base.shape[0], min(262144, base.shape[0]),
                                                                    replace=False)])
    q = _subsample(comp, 16384) @ Ti[:3, :3].T + Ti[:3, 3]
    q = torch.from_numpy(np.ascontiguousarray(q, np.float32))
    out = {"phase": "ann_parity"}
    for name, t, qq in (("full", tgt, q), ("coarse", coarse, q[:4096])):
        m = t.shape[0]
        c, b = ann.default_index_shape(m)
        t_g, q_g = t.to(dev), qq.to(dev)
        before = nearest_neighbors.launches_by_shape[m, c]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx_g = ann.build_anchor_index(t_g, c, b)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        check(nearest_neighbors.launches_by_shape[m, c] == before + 1, (m, c))
        row = {"target": m, "anchors": c, "bucket_cap": b, "first_build_ms": first_ms}
        pi, pd = ann.nn_anchored(q_g, idx_g)
        ei, ed = nearest_neighbors(q_g, t_g)
        if name == "full":  # the CPU side at the full target only (the twin's sweep takes ~30 s)
            t0 = time.perf_counter()
            idx_c = ann.build_anchor_index(t, c, b)
            row["cpu_build_s"] = time.perf_counter() - t0
            row["index"] = hold_index(idx_g, idx_c, t)
            ci, cd = ann.nn_anchored(qq, idx_c)
            row["anchored"] = hold_anchored(pi, pd, ci, cd, ei, ed)
        row["build_ms"] = cuda_ms(lambda: ann.build_anchor_index(t_g, c, b), iters=3, warmup=0)
        row["anchored_sweep_ms"] = cuda_ms(lambda: ann.nn_anchored(q_g, idx_g))
        row["exact_b2_ms"] = cuda_ms(lambda: nearest_neighbors(q_g, t_g))
        row["queries"] = qq.shape[0]
        out[name] = row
    emit(out)
    return out


def phase_compare_full_width_ann(dev, tmp, scene, off_transform) -> dict:
    """``compare_full_width``'s scene and settings with ``ann="auto"``, the
    default: one cold capture with an empty index cache (B2 builds the
    indices over the 1,048,576-row full target and the 262,144-row coarse
    target, one launch each, timed), then 5 warm captures in turns with 5
    at ``ann="off"`` (the cache hits: no build launch), and one more warm
    capture split by CUDA events into anchored sweeps and exact B2 sweeps.
    Bars: the registration sanity of ``compare_full_width`` and the final
    transform within 5e-3 of the ``ann="off"`` capture's (the JAX
    package's bar, tests/test_ann.py)."""
    import os

    from tpu3dlm_torch.alignment import align as align_mod
    from tpu3dlm_torch.ops import icp as icp_mod
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors

    Tw = scene[4]
    csv_path = os.path.join(tmp, "ann.csv")
    builds = [(1_048_576, 8192), (262_144, 2048)]
    build_ms = {}  # "rows x anchors" → ms, in the order the stages built them
    real_build = align_mod.build_anchor_index

    def timed_build(tj, n_anchors, bucket_cap):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_build(tj, n_anchors=n_anchors, bucket_cap=bucket_cap)
        torch.cuda.synchronize()
        build_ms[f"{tj.shape[0]}x{n_anchors}"] = (time.perf_counter() - t0) * 1e3
        return out

    align_mod._ANN_INDEX_CACHE.clear()
    nearest_neighbors.launches = 0
    nearest_neighbors.launches_by_shape.clear()
    align_mod.build_anchor_index = timed_build
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        align, _, rows = run_compare(scene, dev, csv_path, ann="auto")
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
    finally:
        align_mod.build_anchor_index = real_build
    cold_launches = nearest_neighbors.launches
    cold_by_shape = {f"{n}x{m}": c for (n, m), c in sorted(nearest_neighbors.launches_by_shape.items())}
    check(all(nearest_neighbors.launches_by_shape[s] == 1 for s in builds) and len(build_ms) == 2,
          (cold_by_shape, build_ms))
    err = float(np.abs(align.final_transform @ Tw - np.eye(4)).max())
    n_missing = sum(r["status"] == "missing" for r in rows)
    check(err <= 0.15 and n_missing == 1, (err, n_missing))
    vs_off = float(np.abs(align.final_transform - np.asarray(off_transform)).max())
    check(vs_off <= 5e-3, ("ann=auto vs ann=off transform", vs_off))

    # warm: auto and off in turns, the index cache hit every time
    samples = {"auto": [], "off": []}
    for _ in range(5):
        for ann_mode in ("auto", "off"):
            samples[ann_mode].append(host_ms(lambda: run_compare(scene, dev, csv_path, ann=ann_mode), runs=1)[0])
    check(all(nearest_neighbors.launches_by_shape[s] == 1 for s in builds), "a warm capture rebuilt an index")

    # split of one more warm capture: anchored and exact sweeps by CUDA events
    spans = {"anchored": [], "exact": []}
    real = {"anchored": icp_mod.nn_anchored, "exact": icp_mod.nearest_neighbors}

    def timed(kind):
        def fn(*args, **kwargs):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = real[kind](*args, **kwargs)
            e.record()
            spans[kind].append((s, e))
            return out
        return fn

    icp_mod.nn_anchored, icp_mod.nearest_neighbors = timed("anchored"), timed("exact")
    try:
        split_ms, _ = host_ms(lambda: run_compare(scene, dev, csv_path, ann="auto"), runs=1)
    finally:
        icp_mod.nn_anchored, icp_mod.nearest_neighbors = real["anchored"], real["exact"]
    sweep_ms = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
    result = {
        "phase": "compare_full_width_ann", "ann": "auto", "points": [int(scene[0].shape[0]), int(scene[1].shape[0])],
        "b2_launches_cold_capture": cold_launches, "b2_launches_by_shape_cold_capture": cold_by_shape,
        "index_build_ms": build_ms,
        "cold_capture_ms": cold_ms, "transform_err": err, "missing": n_missing,
        "max_abs_diff_vs_ann_off": vs_off, "rmse": align.last_verdict.rmse,
        "inlier_frac": align.last_verdict.inlier_frac, "verdict_ok": align.last_verdict.ok,
        "warm_capture_ms_median": {k: statistics.median(v) for k, v in samples.items()},
        "warm_capture_ms_samples": samples,
        "split_capture_ms": split_ms,
        "split_ms": {"anchored_sweeps": sweep_ms["anchored"], "anchored_calls": len(spans["anchored"]),
                     "exact_sweeps": sweep_ms["exact"], "exact_calls": len(spans["exact"]),
                     "rest": split_ms - sweep_ms["anchored"] - sweep_ms["exact"]},
    }
    emit(result)
    return result


# ---------------------------------------------------------------------------
# Slice 3: kernel B3, gradients through the attention kernels, the BEiT
# finetune step, kernel B4 (the NN-variant probe)
# ---------------------------------------------------------------------------


def phase_kernel_b3(dev, mem_rate) -> dict:
    """B3 (head-major attention) against its twin and against B1 through
    the layouts, with times beside the bound and SDPA; B3's path, the
    public op ``beit_attention`` forward and backward at the production
    shape, once with the count at 0."""
    import torch.nn.functional as F

    from tpu3dlm_torch.ops.kernels.attention import (
        beit_attention,
        beit_attention_packed,
        beit_attention_reference,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    prod_shape = (12, 384, 197, 64)  # (h, B, N, d)
    checks = []
    for dtype, (h, B, N, d), tol in [
        (torch.bfloat16, prod_shape, 1e-2),
        (torch.bfloat16, (2, 5, 9, 64), 1e-2),
        (torch.float32, (3, 5, 33, 16), 1e-5),  # N = 33, B = 5 fills no tile
        (torch.float32, (12, 16, 197, 64), 1e-5),
        (torch.float32, (2, 7, 257, 32), 1e-5),  # N past the bf16 TMA kernel's 256
    ]:
        q, k, v = (torch.randn(h, B, N, d, generator=g, device=dev).to(dtype) for _ in range(3))
        bias = torch.randn(h, N, N, generator=g, device=dev)
        out = beit_attention(q, k, v, bias)
        torch.cuda.synchronize()
        ref = beit_attention_reference(q, k, v, bias)
        max_err = float((out.float() - ref.float()).abs().max())
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        # B3 against B1 through the layouts, on the same input
        packed = lambda t: t.permute(1, 2, 0, 3).reshape(B, N, h * d)  # noqa: E731
        b1 = beit_attention_packed(packed(q), packed(k), packed(v), bias, h)
        layout_err = float((packed(out).float() - b1.float()).abs().max())
        check(layout_err <= tol, ("B3 vs B1", (h, B, N, d), layout_err))
        checks.append({"dtype": str(dtype).split(".")[-1], "shape": [h, B, N, d], "tol": tol,
                       "max_abs_err": max_err, "max_abs_err_vs_b1": layout_err})
        if (h, B, N, d) == prod_shape:
            prod = dict(q=q, k=k, v=v, bias=bias, max_err=max_err)

    q, k, v, bias = prod["q"], prod["k"], prod["v"], prod["bias"]
    h, B, N, d = prod_shape
    # the path: the public op under autograd, once, with the count at 0
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    beit_attention.launches = 0
    out = beit_attention(qg, kg, vg, bias)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    path_launches = beit_attention.launches
    check(path_launches == 1 and all(torch.isfinite(t.grad).all() for t in (qg, kg, vg)), path_launches)

    kernel_ms = cuda_ms(lambda: beit_attention(q, k, v, bias))
    plain_ms = cuda_ms(lambda: beit_attention_reference(q, k, v, bias))
    mask = bias.to(q.dtype)[:, None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    bound_ms, bound_by = attention_bound_ms(B, N, h, d, q.dtype, mem_rate)
    result = {
        "phase": "kernel_b3", "checks": checks, "shape": list(prod_shape), "dtype": "bfloat16",
        "launches_on_path": path_launches, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "max_abs_err": prod["max_err"],
    }
    emit(result)
    return result


def _grads(fn, inputs, weight):
    """Gradients of (fn(*inputs)·weight).sum() with respect to the inputs,
    and whether the output carried a gradient."""
    ts = [t.detach().requires_grad_() for t in inputs]
    out = fn(*ts)
    (out.float() * weight).sum().backward()
    return out.requires_grad, [t.grad for t in ts]


def phase_attention_grad(dev) -> dict:
    """On the card, B1's and B3's outputs carry gradients, and their q, k,
    v and bias gradients equal plain autograd through the twins at f32
    within 1e-5 (summation order only); through a BEiT-base attention
    layer the query, key and value weights and the relative-position-bias
    table get non-zero gradients."""
    from tpu3dlm_torch.models import beit as beit_mod
    from tpu3dlm_torch.models.beit import BeitAttention, BeitConfig
    from tpu3dlm_torch.ops.kernels.attention import (
        beit_attention,
        beit_attention_packed,
        beit_attention_packed_reference,
        beit_attention_reference,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    rows = []
    cases = [("b1", (3, 33, 4, 16)), ("b1", (2, 197, 12, 64)),
             ("b3", (4, 3, 33, 16)), ("b3", (12, 2, 197, 64))]
    for op, shape in cases:
        if op == "b1":
            B, N, h, d = shape
            qkv_shape = (B, N, h * d)
            kernel = lambda q, k, v, b, h=h: beit_attention_packed(q, k, v, b, h)  # noqa: E731
            twin = lambda q, k, v, b, h=h: beit_attention_packed_reference(q, k, v, b, h)  # noqa: E731
        else:
            h, B, N, d = shape
            qkv_shape = shape
            kernel, twin = beit_attention, beit_attention_reference
        inputs = [torch.randn(qkv_shape, generator=g, device=dev) for _ in range(3)]
        inputs.append(torch.randn(h, N, N, generator=g, device=dev))
        w = torch.randn(qkv_shape, generator=g, device=dev)
        carried, got = _grads(kernel, inputs, w)
        _, want = _grads(twin, inputs, w)
        check(carried, (op, shape, "the kernel's output carries no gradient"))
        errs = []
        for name, a, b in zip("qkvb", got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=f"{op} {shape} d{name}")
            errs.append(float((a - b).abs().max()))
        rows.append({"op": op, "shape": list(shape), "max_abs_err_dq_dk_dv_dbias": errs})

    cfg = BeitConfig()
    torch.manual_seed(SEED)
    layer = BeitAttention(cfg).to(dev)
    with torch.no_grad():
        layer.relative_position_bias_table.normal_(0, 0.02, generator=g)
    x = torch.randn(2, cfg.num_patches + 1, cfg.hidden_size, generator=g, device=dev)
    names = ("query.weight", "key.weight", "value.weight", "relative_position_bias_table")

    def layer_grads():
        layer.zero_grad(set_to_none=True)
        layer(x).square().mean().backward()
        params = dict(layer.named_parameters())
        return [params[n].grad.clone() for n in names]

    got = layer_grads()
    real = beit_mod.beit_attention_packed
    beit_mod.beit_attention_packed = beit_attention_packed_reference  # plain autograd
    try:
        want = layer_grads()
    finally:
        beit_mod.beit_attention_packed = real
    layer_rows = {}
    for n, a, b in zip(names, got, want):
        check(bool(a.abs().max() > 0), f"zero gradient for {n}")
        rel = float((a - b).abs().max() / b.abs().max())
        check(rel <= 1e-4, (n, rel))
        layer_rows[n] = {"max_abs": float(a.abs().max()), "max_rel_err_vs_twin": rel}
    result = {"phase": "attention_grad", "ops": rows, "beit_base_layer": layer_rows}
    emit(result)
    return result


def bright_dark_crops(n: int, size: int, labels: int, seed: int):
    """Seeded uint8 crops whose class is their brightness band (the
    learnable task of tests/test_parallel.py's finetune test)."""
    rng = np.random.default_rng(seed)
    y = np.tile(np.arange(labels, dtype=np.int64), -(-n // labels))[:n]
    lo = np.linspace(0, 180, labels).astype(np.int64)[y][:, None, None, None]
    crops = np.clip(lo + rng.integers(0, 70, (n, size, size, 3)), 0, 255).astype(np.uint8)
    return crops, y


def seeded_beit(cfg, seed: int):
    """A port BEiT with torch's seeded init and the cls token and
    relative-position tables drawn from N(0, 0.02²), so that no LayerNorm
    sees an all-zero row."""
    from tpu3dlm_torch.models.beit import BeitClassifier

    torch.manual_seed(seed)
    model = BeitClassifier(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "cls_token" or name.endswith("relative_position_bias_table"):
                p.normal_(0, 0.02)
    return model


def phase_beit_past_old_limits(dev) -> dict:
    """ROADMAP C1 on the card: a BEiT at 256 px (N = 257 tokens) and one
    with head width 128 (hidden 256 over 2 heads), f32, on the card (kernel
    ``attention_simt``, one launch per layer) against the same weights on
    the CPU (twin): logits within 1e-5 abs and rel (summation order only)."""
    import copy

    from tpu3dlm_torch.models.beit import BeitConfig
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed

    rows = []
    for image_size, hidden in ((256, 32), (32, 256)):
        cfg = BeitConfig(image_size=image_size, patch_size=16, hidden_size=hidden, num_layers=1,
                         num_heads=2, intermediate_size=64, num_labels=2)
        cpu = seeded_beit(cfg, SEED + 12).eval()
        gpu = copy.deepcopy(cpu).to(dev)
        gen = torch.Generator().manual_seed(SEED + 13)
        x = torch.rand(2, image_size, image_size, 3, generator=gen) * 2 - 1
        before = beit_attention_packed.launches_by_kernel["attention_simt"]
        with torch.no_grad():
            want = cpu(x)
            got = gpu(x.to(dev)).cpu()
        launches = beit_attention_packed.launches_by_kernel["attention_simt"] - before
        check(launches == cfg.num_layers, launches)
        check(got.shape == (2, 2) and bool(torch.isfinite(got).all()), got)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        rows.append({"image_size": image_size, "tokens": cfg.num_patches + 1,
                     "head_width": hidden // cfg.num_heads, "simt_launches": launches,
                     "max_abs_logit_err": float((got - want).abs().max())})
    result = {"phase": "beit_past_old_limits", "dtype": "float32", "configs": rows}
    emit(result)
    return result


def phase_finetune_parity(dev) -> dict:
    """Three finetune steps of a small BEiT at f32 on the card (kernel B1,
    backward by recompute) and on the CPU (twin), same weights and crops:
    losses within 1e-5; the first step's gradients within 1e-5 abs and
    rel (summation order only)."""
    import copy

    from tpu3dlm_torch.models.beit import BeitConfig
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
    from tpu3dlm_torch.parallel.finetune import init_finetune, make_beit_train_step

    cfg = BeitConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=128, num_labels=3)
    cpu = seeded_beit(cfg, SEED + 7)
    gpu = copy.deepcopy(cpu)
    steps = {}
    for name, model, device in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        opt = init_finetune(model, lr=1e-4, device=device)
        steps[name] = make_beit_train_step(model, opt, device=device)
    crops, labels = bright_dark_crops(12, 32, 3, SEED + 8)
    losses = {"cpu": [], "gpu": []}
    grad_err = {}
    before = beit_attention_packed.launches
    for i in range(3):
        for name, step in steps.items():
            losses[name].append(float(step(crops, labels)))
        if i == 0:
            for (n, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
                gc, gg = pc.grad, pg.grad.cpu()
                torch.testing.assert_close(gg, gc, atol=1e-5, rtol=1e-5, msg=f"d{n}")
                grad_err[n] = float((gg - gc).abs().max())
    launches = beit_attention_packed.launches - before
    check(launches == 3 * cfg.num_layers, launches)
    loss_err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["gpu"]))
    check(loss_err <= 1e-5 and all(np.isfinite(losses["gpu"])), (losses, loss_err))
    result = {"phase": "finetune_parity", "losses": losses, "max_loss_err": loss_err,
              "max_grad_err_step1": max(grad_err.values()), "b1_launches": launches,
              "params": len(grad_err)}
    emit(result)
    return result


def phase_finetune_full_width(dev) -> dict:
    """The finetune main path at BEiT-base width: f32 (the classifier's
    default type, as in the JAX step), 2 labels, batch 64 seeded crops of
    the bright/dark task, lr 1e-4. One warm-up step with the counts at 0,
    in which every layer's B1 output is held against the twin on that
    layer's own q, k, v and bias (1e-5); then 5 timed steps and one
    profiled step."""
    from tpu3dlm_torch.models.beit import BeitAttention, BeitConfig
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed, beit_attention_packed_reference
    from tpu3dlm_torch.parallel.finetune import init_finetune, make_beit_train_step

    cfg = BeitConfig()  # BEiT-base: 12 layers, 768 wide, 12 heads, 224 px, N = 197
    batch = 64
    model = seeded_beit(cfg, SEED + 9)
    step = make_beit_train_step(model, init_finetune(model, lr=1e-4, device=dev), device=dev)
    crops, labels = bright_dark_crops(batch, cfg.image_size, cfg.num_labels, SEED + 10)
    crops, labels = torch.as_tensor(crops, device=dev), torch.as_tensor(labels, device=dev)

    # hooks: B1's output is the input of each attention's output Dense
    b1_out, b1_err = {}, []

    def keep_b1_output(dense, args):
        b1_out[dense] = args[0].detach()

    def hold_b1(attn, args, _out):
        (x,) = args
        with torch.no_grad():
            bias = attn.relative_position_bias_table[attn.rel_index]
            bias = bias.reshape(x.shape[1], x.shape[1], attn.num_heads).permute(2, 0, 1).contiguous()
            want = beit_attention_packed_reference(attn.query(x), attn.key(x), attn.value(x), bias,
                                                   attn.num_heads)
        got = b1_out.pop(attn.output)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5, msg=f"B1 at {tuple(x.shape)}")
        b1_err.append(float((got - want).abs().max()))

    attns = [m for m in model.modules() if isinstance(m, BeitAttention)]
    hooks = [a.output.register_forward_pre_hook(keep_b1_output) for a in attns]
    hooks += [a.register_forward_hook(hold_b1) for a in attns]
    torch.cuda.reset_peak_memory_stats()
    beit_attention_packed.launches = 0
    beit_attention_packed.launches_by_kernel.clear()
    losses = [float(step(crops, labels))]
    launches = beit_attention_packed.launches
    by_kernel = dict(beit_attention_packed.launches_by_kernel)
    for hook in hooks:
        hook.remove()
    check(launches == cfg.num_layers and len(b1_err) == cfg.num_layers, (launches, len(b1_err)))
    check(by_kernel == {"attention_simt": launches}, by_kernel)
    step_ms, samples = host_ms(lambda: losses.append(float(step(crops, labels))), runs=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(beit_attention_packed.launches == 6 * cfg.num_layers, beit_attention_packed.launches)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], losses)
    profile = profile_capture(lambda: step(crops, labels))
    result = {
        "phase": "finetune_full_width", "batch": batch, "image_size": cfg.image_size,
        "layers": cfg.num_layers, "hidden": cfg.hidden_size, "dtype": "float32", "lr": 1e-4,
        "b1_launches_per_step": launches, "b1_launches_by_kernel": by_kernel,
        "b1_max_abs_err_vs_twin": max(b1_err), "losses": losses,
        "step_ms": step_ms, "step_ms_samples": samples, "crops_per_s": batch / (step_ms / 1e3),
        "peak_mem_gb": peak_gb, "profile": profile,
    }
    emit(result)
    return result


def nn_variant_padded_bound_ms(n: int, m: int) -> float:
    """A derived bound, like ``bound_ms`` and not measured: the least time
    of the redesigned B4's own MMAs, which pad the cross term's depth from
    3 to 16 (x, y, z, three limbs of |b|², zeros), 2·16 flops a pair at
    the bf16 tensor-core rate."""
    return 2.0 * 16 * n * m / PEAK_BF16_FLOPS * 1e3


def nn_variant_bound_ms(n: int, m: int, mem_rate: float) -> tuple[float, str]:
    """Least time for the probe's function: one compare per pair at the
    f32 instruction rate (67 TFLOP/s of FMA counted as 2 flops, so 33.5 T
    instructions/s), against the cross term's 6 flops per pair (K = 3) at
    the bf16 tensor-core rate and the inputs and outputs moved once; the
    larger."""
    t_cmp = n * m / (PEAK_F32_FLOPS / 2)
    t_mma = 6.0 * n * m / PEAK_BF16_FLOPS
    t_bytes = ((n + m) * 12 + n * 12) / mem_rate
    t_ops = max(t_cmp, t_mma)
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def hold_b4(case, variant, a, b, idx, d2, twin, true_d2, sub=None) -> dict:
    """One B4 variant's (idx, d2) against the bf16 twin's on the same
    inputs: ≥ 99.9% identical picks, d² within 1e-4 and within 1e-5 where
    the picks differ (a near-tie of the twin's f32 sums); and every pick of
    the queries ``sub`` (all where None) inside the reference's bf16 band
    above the f64 minimum ``true_d2`` of those queries."""
    ri, rd2 = twin
    same = float((idx == ri).float().mean())
    err = float((d2 - rd2).abs().max())
    diff = idx != ri
    tie_err = float((d2[diff] - rd2[diff]).abs().max()) if bool(diff.any()) else 0.0
    check(err <= 1e-4 and tie_err <= 1e-5 and same >= 0.999, (case, variant, same, err, tie_err))
    a_s, i_s = (a, idx) if sub is None else (a[sub], idx[sub])
    band = 2.0 ** -7 * a_s.double().norm(dim=1) * b.double().norm(dim=1).max() + 1e-6
    excess = ((a_s.double() - b[i_s].double()) ** 2).sum(1) - true_d2
    check(bool((excess <= band).all()), (case, variant, "f64 band", float(excess.max())))
    return {"case": case, "variant": variant, "shape": [a.shape[0], b.shape[0]],
            "same_index_frac": same, "max_abs_err": err, "max_err_where_index_differs": tie_err,
            "f64_queries": a_s.shape[0], "f64_max_excess_of_pick": float(excess.max())}


def phase_kernel_b4(dev, mem_rate) -> dict:
    """B4 (the NN-variant probe's kernels): every variant against the bf16
    twin and against f64 at small shapes (not counted); then the probe's
    own path — verify on the seeded 512 × 4096 instance, time at
    16384 × 1,048,576 beside B2 — with the counts at 0, and each variant's
    output of that timing run held against the twin on the same inputs
    (f64 on every 64th query)."""
    from tpu3dlm_torch.ops.kernels.nn_variants import VARIANTS, nn_variant, nn_variant_reference
    from tpu3dlm_torch.scripts import bench_nn_variants as probe

    a_s, b_s, a_np, b_np = probe.probe_inputs(SEED)
    rng = np.random.default_rng(SEED + 11)
    up = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)  # noqa: E731
    dup = rng.uniform(-2, 3, (1000, 3))
    cases = [("probe_verify", a_s, b_s), ("odd", rng.uniform(-2, 3, (1000, 3)), rng.uniform(-2, 3, (3001, 3))),
             ("ties", rng.uniform(-2, 3, (777, 3)), np.concatenate([dup, dup, dup])),
             ("one", rng.uniform(-2, 3, (1, 3)), rng.uniform(-2, 3, (1, 3)))]
    checks = []
    for name, a_c, b_c in cases:
        a, b = up(a_c), up(b_c)
        twin = nn_variant_reference(a, b, "bf16")
        true_d2, _ = f64_nearest(a, b)
        first = None
        for variant in VARIANTS:
            idx, d2 = nn_variant(a, b, variant)
            torch.cuda.synchronize()
            checks.append(hold_b4(name, variant, a, b, idx, d2, twin, true_d2))
            if name == "ties":
                check(bool((idx < 1000).all()), (variant, "ties must go to the lowest index"))
            # every variant computes the same dp with the same MMA: picks and d² equal
            if first is None:
                first = (idx, d2)
            check(torch.equal(idx, first[0]) and torch.equal(d2, first[1]), (name, variant, "vs v1"))

    # the probe's path, once, with the counts at 0
    nn_variant.launches = dict.fromkeys(nn_variant.launches, 0)
    verified = probe.verify(a_s, b_s, dev)
    ms, outs = probe.time_variants(a_np, b_np, dev)
    launches = dict(nn_variant.launches)
    per_variant = 1 + 1 + probe.ITERS  # verify, warm-up, timed
    for kernel, count in launches.items():
        check(count == per_variant * sum(k == kernel for k, _, _ in VARIANTS.values()), (kernel, count))
    # the timing run's outputs against the twin on the same inputs
    a, b = up(a_np), up(b_np)
    n, m = a.shape[0], b.shape[0]
    twin = nn_variant_reference(a, b, "bf16")
    plain_ms = cuda_ms(lambda: nn_variant_reference(a, b, "bf16"), iters=2, warmup=0)
    sub = torch.arange(0, n, 64, device=dev)
    true_d2, _ = f64_nearest(a[sub], b)
    for variant in VARIANTS:
        idx, d2 = outs[variant]
        checks.append(hold_b4("probe_time", variant, a, b, idx, d2, twin, true_d2, sub))
        check(torch.equal(idx, outs["v1"][0]) and torch.equal(d2, outs["v1"][1]),
              ("probe_time", variant, "vs v1"))
    bound_ms, bound_by = nn_variant_bound_ms(n, m, mem_rate)
    lines = probe.result_lines(ms, torch.cuda.get_device_name(0))
    for line in lines:
        emit(line)
    result = {"phase": "kernel_b4", "checks": checks, "verify": verified, "shape": [n, m],
              "ms": ms, "launches_on_probe": launches, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "padded_mma_bound_ms": nn_variant_padded_bound_ms(n, m),
              "max_abs_err": {v: max(c["max_abs_err"] for c in checks if c["variant"] == v)
                              for v in VARIANTS}}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# Slice 4: ingestion, the Pipeline and the CLI on the committed capture
# ---------------------------------------------------------------------------

FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"
PROJECT = FIXTURES / "torch_project"
# make_project's config patches (tpu3dlm/pipeline/evaluate.py::_cfg_patch at
# its img_size 128 and compact BEiT), which bench_e2e.py runs with;
# tests/test_torch_pipeline.py holds this list equal to the reference's
PROJECT_PATCH = [
    ("img_size = 640", "img_size = 128"),
    ("batch_size = 64", "batch_size = 8"),
    ("conf_thresh = 0.5", "conf_thresh = 0.5"),
    ("max_det = 64", "max_det = 8"),
    ("num_classes = 80", "num_classes = 2"),
    ("min_points = 1000", "min_points = 50"),
    ("beit_image_size = 224", "beit_image_size = 32"),
    ("beit_hidden_size = 768", "beit_hidden_size = 32"),
    ("beit_num_layers = 12", "beit_num_layers = 2"),
    ("beit_num_heads = 12", "beit_num_heads = 2"),
    ("beit_intermediate_size = 3072", "beit_intermediate_size = 64"),
]
FOLDERS = ("gold_std", "maintenance")


def write_config(root: str, patches: list) -> str:
    """``<root>/configs/variables.cfg``: the default config with ``patches``
    (each a (text, replacement) pair that must occur) applied."""
    from tpu3dlm_torch.utils.config import DEFAULT_CONFIG

    text = DEFAULT_CONFIG
    for old, new in patches:
        check(old in text, f"config text {old!r} not found")
        text = text.replace(old, new)
    path = Path(root, "configs", "variables.cfg")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return str(path)


def drop_sign(scan: Path, label: int = 0, margin_px: float = 16.0) -> int:
    """The sign of ``label`` is taken out of the capture's depth: every
    depth pixel under its ground-truth boxes (gt.json, RGB pixels, widened
    by ``margin_px``) reads 0, no return, in the files and in data.db. Its
    detections then project to no 3D box. Returns the boxes blanked.

    In the maintenance capture the sign of label 0 is the red one, the only
    sign the fixture YOLOv10-n (trained at 128 px) finds at 640²; gold keeps
    it, so a full-width report has one missing sign, as at 128 px, while
    maintenance still has detections to classify."""
    import sqlite3

    from tpu3dlm_torch.data import codecs

    gt = json.loads((scan / "gt.json").read_text())
    depth_dir = scan / "rtabmap_extract" / "data_depth"
    conn = sqlite3.connect(scan / "data.db")
    blanked = 0
    for frame, boxes in gt["gt_boxes_2d"].items():
        path = depth_dir / f"{int(frame) + 1}.png"
        depth = codecs.read_png(str(path))
        sx, sy = depth.shape[1] / gt["rgb_wh"][0], depth.shape[0] / gt["rgb_wh"][1]
        for x0, y0, x1, y1, _, lab in boxes:
            if lab != label:
                continue
            c0, r0 = (max(int((v - margin_px) * s), 0) for v, s in ((x0, sx), (y0, sy)))
            c1, r1 = (int(np.ceil((v + margin_px) * s)) for v, s in ((x1, sx), (y1, sy)))
            depth[r0:r1, c0:c1] = 0
            blanked += 1
        blob = codecs.encode_png(depth)
        path.write_bytes(blob)
        conn.execute("UPDATE Data SET depth = ? WHERE id = ?", (blob, int(frame) + 1))
    conn.commit()
    conn.close()
    return blanked


def copy_project(root: str, frames: int | None = None, dropped_sign: bool = False) -> str:
    """The committed capture copied to ``<root>/configs/data`` (the layout
    make_project writes), each scan tiled to ``frames`` frames when given:
    frame k (1-based) is source frame (k − 1) mod 5 + 1, in the files, in
    data.db (Data and Node rows k) and in poses.txt (row k, id k), so every
    stem pairs with its own pose row. With ``dropped_sign``, maintenance
    loses the red sign first (``drop_sign``)."""
    import shutil
    import sqlite3

    data = Path(root, "configs", "data")
    shutil.copytree(PROJECT / "data", data)
    if dropped_sign:
        check(drop_sign(data / "maintenance") == 4, "the red sign is in 4 maintenance frames")
    if frames is None:
        return str(data)
    for folder in FOLDERS:
        scan = data / folder
        ext = scan / "rtabmap_extract"
        src_n = len(list((ext / "data_rgb").glob("*.jpg")))
        src = lambda k: (k - 1) % src_n + 1  # noqa: E731
        for sub, suffix in (("data_rgb", "jpg"), ("data_depth", "png"), ("calibration", "yaml")):
            for k in range(src_n + 1, frames + 1):
                shutil.copyfile(ext / sub / f"{src(k)}.{suffix}", ext / sub / f"{k}.{suffix}")
        lines = (scan / "poses.txt").read_text().splitlines()
        rows = [ln.split() for ln in lines[1:]]
        out = [lines[0]] + [" ".join(rows[src(k) - 1][:8] + [str(k)]) for k in range(1, frames + 1)]
        (scan / "poses.txt").write_text("\n".join(out) + "\n")
        db = scan / "data.db"
        conn = sqlite3.connect(db)
        blobs = dict((i, (im, dp)) for i, im, dp in conn.execute("SELECT id, image, depth FROM Data"))
        conn.executemany("INSERT INTO Data (id, image, depth) VALUES (?, ?, ?)",
                         [(k, *blobs[src(k)]) for k in range(src_n + 1, frames + 1)])
        conn.executemany("INSERT INTO Node (id) VALUES (?)", [(k,) for k in range(src_n + 1, frames + 1)])
        conn.commit()
        conn.close()
    return str(data)


def sha256_of(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def check_ingestion(root: str) -> tuple[int, dict, str]:
    """The committed capture copied under ``root``, ``ImageExtractor.
    fetch_data`` from each scan's data.db, then ``load_scan`` at img_size
    128 and 640: every array's sha256, dtype and shape must equal the JAX
    package's (``expected.json``). Returns (arrays checked, frames
    extracted per scan, data directory)."""
    import os

    from tpu3dlm_torch.data.dataset import load_scan
    from tpu3dlm_torch.data.rtabmap_db import ImageExtractor

    expected = json.loads((PROJECT / "expected.json").read_text())
    data = copy_project(root)
    checked, extracted = 0, {}
    for folder in FOLDERS:
        scan_dir = os.path.join(data, folder)
        ext = os.path.join(scan_dir, "rtabmap_extract")
        extractor = ImageExtractor(os.path.join(scan_dir, "data.db"), os.path.join(ext, "data_depth"),
                                   os.path.join(ext, "data_rgb"))
        extracted[folder] = extractor.fetch_data()
        extractor.close()
        for size in (128, 640):
            scan = load_scan(os.path.join(ext, "data_rgb"), os.path.join(ext, "data_depth"),
                             os.path.join(ext, "calibration"), os.path.join(scan_dir, "poses.txt"),
                             img_size=size)
            for field, want in expected[f"{folder}/{size}"].items():
                got = getattr(scan, field)
                check(sha256_of(got) == want["sha256"] and list(np.shape(got)) == want["shape"]
                      and str(np.asarray(got).dtype) == want["dtype"], (folder, size, field))
                checked += 1
    check(extracted == {"gold_std": 5, "maintenance": 5}, extracted)
    return checked, extracted, data


def phase_ingest_parity(tmp: str, tiled_root: str) -> dict:
    """The port's ingestion on this host (no cv2 here): ``check_ingestion``.
    Then host times: per-frame JPEG decode, depth PNG
    decode and the 480×640 → 640² and → 128² resizes (median over the
    capture's frames, 5 passes), and ``load_scan`` frames/s of a 128-frame
    scan at 640 with ``decode_workers`` 0 and 8."""
    import os

    from tpu3dlm_torch.data import codecs
    from tpu3dlm_torch.data.dataset import load_scan

    checked, extracted, data = check_ingestion(os.path.join(tmp, "ingest"))
    ext = os.path.join(data, "gold_std", "rtabmap_extract")
    jpgs = sorted(Path(ext, "data_rgb").glob("*.jpg"))
    pngs = sorted(Path(ext, "data_depth").glob("*.png"))
    frame = codecs.read_jpeg(str(jpgs[0]))

    def per_frame_ms(fn, items) -> float:
        samples = []
        for _ in range(5):
            for it in items:
                t0 = time.perf_counter()
                fn(it)
                samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples)

    decode_ms = {
        "jpeg_decode": per_frame_ms(lambda p: codecs.read_jpeg(str(p)), jpgs),
        "png_decode_depth": per_frame_ms(lambda p: codecs.read_png(str(p)), pngs),
        "resize_to_640": per_frame_ms(lambda f: codecs.resize_linear(f, (640, 640)), [frame] * 5),
        "resize_to_128": per_frame_ms(lambda f: codecs.resize_linear(f, (128, 128)), [frame] * 5),
    }
    tiled = os.path.join(tiled_root, "configs", "data", "gold_std")
    t_ext = os.path.join(tiled, "rtabmap_extract")
    rates = {}
    for workers in (0, 8):
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            scan = load_scan(os.path.join(t_ext, "data_rgb"), os.path.join(t_ext, "data_depth"),
                             os.path.join(t_ext, "calibration"), os.path.join(tiled, "poses.txt"),
                             img_size=640, workers=workers)
            samples.append(time.perf_counter() - t0)
        check(scan.num_frames == 128, scan.num_frames)
        rates[str(workers)] = {"frames_per_s": 128 / statistics.median(samples),
                               "ms_samples": [x * 1e3 for x in samples]}
    result = {"phase": "ingest_parity", "arrays_checked": checked, "frames_extracted": extracted,
              "host_cpus": os.cpu_count(), "decode_ms_per_frame": decode_ms,
              "frame_hw": list(frame.shape[:2]), "load_scan_640_128_frames_by_workers": rates}
    emit(result)
    return result


def pipeline_config(root: str, extra: list) -> str:
    return write_config(root, PROJECT_PATCH + [("fused_inference = false", "fused_inference = true")] + extra)


def run_two_scans(cfg_path: str, device):
    """Gold, then maintenance, through ``setup_pipeline`` as ``bench_e2e.py``
    runs them. Returns (gold pipeline, maintenance pipeline)."""
    from tpu3dlm_torch.pipeline.task import load_gold_std, setup_pipeline
    from tpu3dlm_torch.utils.config import ConfigLoader

    cfg_gold, cfg_maint = ConfigLoader(cfg_path, "gold_std"), ConfigLoader(cfg_path, "maintenance")
    gold = setup_pipeline("gold_std", cfg_gold, None, device=device)
    maint = setup_pipeline("maintenance", cfg_maint, cfg_gold, load_gold_std(cfg_gold.pickle_path),
                           device=device)
    return gold, maint


def _records_err(a: dict, b: dict, n_coords: int) -> float:
    """Largest coordinate difference of two reference-shaped record dicts
    ({frame: [[coords..., damage, conf, label]]}) whose frames, record
    counts, damage and labels must be equal."""
    check(a.keys() == b.keys(), (sorted(a), sorted(b)))
    err = 0.0
    for f in a:
        check(len(a[f]) == len(b[f]), (f, len(a[f]), len(b[f])))
        for ra, rb in zip(a[f], b[f]):
            check(ra[n_coords] == rb[n_coords] and ra[n_coords + 2] == rb[n_coords + 2],
                  (f, "damage/label", ra[n_coords:], rb[n_coords:]))
            ca = np.asarray(ra[:n_coords], np.float64)
            cb = np.asarray(rb[:n_coords], np.float64)
            err = max(err, float(np.abs(ca - cb).max()))
    return err


def _report_err(a: list, b: list) -> float:
    """Report rows (dicts, as ``match_bboxes`` returns them or a CSV reads
    back) must agree in every field; the box distance, which the report
    rounds to 0.1 mm, is compared by value. Returns its largest
    difference."""
    check(len(a) == len(b), (a, b))
    err = 0.0
    for ra, rb in zip(a, b):
        check({k: v for k, v in ra.items() if k != "distance"} == {k: v for k, v in rb.items() if k != "distance"},
              (ra, rb))
        err = max(err, abs(float(ra["distance"]) - float(rb["distance"])))
    return err


def _read_csv(path: str) -> tuple[list, list]:
    """(header, rows as dicts) of a comparison CSV."""
    import csv

    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


class StreamRecorder:
    """Wraps ``FusedScanRunner.run_stream`` while in use: records each
    stream's chunk count and ``stream_peak_inflight``."""

    def __enter__(self):
        from tpu3dlm_torch.pipeline.fused import FusedScanRunner

        self.streams: list[dict] = []
        self._cls, self._real = FusedScanRunner, FusedScanRunner.run_stream
        recorder = self

        def run_stream(runner, chunks, max_inflight: int = 2):
            rec = {"chunks": 0, "max_inflight": max_inflight}
            recorder.streams.append(rec)

            def counted():
                for item in chunks:
                    rec["chunks"] += 1
                    yield item

            out = recorder._real(runner, counted(), max_inflight)
            rec["peak_inflight"] = runner.stream_peak_inflight
            return out

        FusedScanRunner.run_stream = run_stream
        return self

    def __exit__(self, *exc):
        self._cls.run_stream = self._real
        return False


def hold_pipelines(a: tuple, b: tuple) -> dict:
    """Two runs of gold and maintenance held to the parity bars: masks,
    labels and damage equal, boxes within 1e-2 px, corners of every
    projected and kept box within 1e-4 m, every ICP step within 1e-4,
    verdict reasons identical, report rows and CSV identical but for the
    0.1 mm-rounded distance (within 2e-4 m), one missing sign in both.
    Returns the largest errors."""
    errs = {"box_px": 0.0, "corner_m": 0.0, "kept_corner_m": 0.0}
    for x, y in zip(a, b):
        c, g = x.data_to_save, y.data_to_save
        errs["box_px"] = max(errs["box_px"], _records_err(c["predictions"], g["predictions"], 4))
        errs["corner_m"] = max(errs["corner_m"], _records_err(c["global_bboxes_data"], g["global_bboxes_data"], 4))
        errs["kept_corner_m"] = max(errs["kept_corner_m"],
                                    _records_err(c["optimised_bboxes"], g["optimised_bboxes"], 4))
    check(errs["box_px"] <= 1e-2 and errs["corner_m"] <= 1e-4 and errs["kept_corner_m"] <= 1e-4, errs)
    c, g = a[1].data_to_save, b[1].data_to_save
    errs["step"] = _steps_err(g["transformations"], c["transformations"])
    check(errs["step"] <= 1e-4, errs["step"])
    check(g["alignment_verdict"]["reasons"] == c["alignment_verdict"]["reasons"],
          (g["alignment_verdict"], c["alignment_verdict"]))
    dist_err = _report_err(g["comparison_rows"], c["comparison_rows"])
    csv_rows = [_read_csv(x[1].cfg.csv_output) for x in (a, b)]
    check(csv_rows[0][0] == csv_rows[1][0], "CSV headers differ")
    errs["report_distance_m"] = max(dist_err, _report_err(csv_rows[1][1], csv_rows[0][1]))
    check(errs["report_distance_m"] <= 2e-4, errs["report_distance_m"])
    for x in (a, b):
        missing = sum(r["status"] == "missing" for r in x[1].data_to_save["comparison_rows"])
        check(missing == 1, x[1].data_to_save["comparison_rows"])
    return errs


def phase_pipeline_parity(dev, tmp: str, fused: bool = True, stream: int = 0) -> dict:
    """``bench_e2e.py``'s flow on the committed capture (make_project's
    config, fixture checkpoints, f32), on the fused route
    (``pipeline_parity``), on the staged route under the default
    ``fused_inference = false`` (``fused=False``: ``staged_parity``, as
    ``BENCH_E2E_FUSED=0`` runs it), or on the fused route streamed in
    chunks of ``stream`` frames (``stream_parity``): gold and maintenance
    Pipelines on the card and on the CPU, held by ``hold_pipelines`` (the
    box distance of the report is rounded to 0.1 mm and may move by that
    last digit: card and CPU transforms differ by ~1e-5 over a ~3 m lever).
    B1 and B2 launched on the card run, B1 once per layer for each classify
    call (fused: one per scan; staged: one per batch of 64 valid
    detections; streamed: one per chunk). Streamed, also the card's
    whole-scan fused run held to the streamed card run by the same bars,
    at most 2 chunks in flight, and the valid boxes per chunk, which show
    that the per-chunk crop budget never binds."""
    import os

    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors

    phase = "stream_parity" if stream else "pipeline_parity" if fused else "staged_parity"
    extra = [("infer_dtype = bf16", "infer_dtype = f32"),
             ("yolo_weights =", f"yolo_weights = {FIXTURES / 'yolo_synthetic.msgpack'}"),
             ("beit_weights =", f"beit_weights = {FIXTURES / 'beit_synthetic.msgpack'}")]
    legs = [("cpu", "cpu", stream), ("gpu", dev, stream)] + ([("gpu_whole", dev, 0)] if stream else [])
    runs, launches, streams = {}, {}, {}
    for name, device, chunk in legs:
        root = os.path.join(tmp, f"{phase}_{name}")
        copy_project(root)
        more = [("streaming_chunk = 0", f"streaming_chunk = {chunk}")] if chunk else []
        cfg = pipeline_config(root, extra + more) if fused else write_config(root, PROJECT_PATCH + extra)
        b1, b2 = beit_attention_packed.launches, nearest_neighbors.launches
        t0 = time.perf_counter()
        with StreamRecorder() as rec:
            runs[name] = run_two_scans(cfg, device)
        runs[name + "_s"] = time.perf_counter() - t0
        launches[name] = {"b1": beit_attention_packed.launches - b1, "b2": nearest_neighbors.launches - b2}
        streams[name] = rec.streams
        check(len(rec.streams) == (2 if chunk else 0), rec.streams)
    detections = {s: sum(len(v) for v in runs["gpu"][i].data_to_save["predictions"].values())
                  for i, s in enumerate(FOLDERS)}
    layers = 2  # make_project's compact BEiT
    if stream:
        classify_calls = sum(r["chunks"] for r in streams["gpu"])
        check(all(r["peak_inflight"] <= 2 for r in streams["gpu"] + streams["cpu"]), streams)
    else:
        classify_calls = 2 if fused else sum(-(-n // 64) for n in detections.values())
    check(classify_calls > 0 and launches["gpu"]["b1"] == layers * classify_calls
          and launches["gpu"]["b2"] >= 5, (launches, detections))
    if not fused:  # the staged route classifies every valid detection
        check(all(r[4] >= 0 for p in runs["gpu"] for recs in p.data_to_save["predictions"].values()
                  for r in recs), "damage")
    errs = hold_pipelines(runs["cpu"], runs["gpu"])
    g = runs["gpu"][1].data_to_save
    result = {"phase": phase, "launches_gpu_run": launches["gpu"], "detections": detections,
              "classify_calls": classify_calls, "b1_launches_per_classify_call": layers,
              "kept_boxes_maintenance": sum(len(v) for v in g["optimised_bboxes"].values()),
              "max_box_err_px": errs["box_px"], "max_corner_err_m": errs["corner_m"],
              "max_kept_corner_err_m": errs["kept_corner_m"], "max_step_err": errs["step"],
              "max_report_distance_err_m": errs["report_distance_m"],
              "rows": len(g["comparison_rows"]), "missing": sum(r["status"] == "missing" for r in g["comparison_rows"]),
              "verdict": g["alignment_verdict"],
              "wall_s": {k: runs[k + "_s"] for k, _, _ in legs},
              "stage_s_gpu": {s: runs["gpu"][i].stage_times for i, s in enumerate(FOLDERS)}}
    if stream:
        # per chunk: k = min(crop_budget, chunk · max_det) crops are
        # classified; the budget binds only when a chunk has more valid boxes
        valid = [[len(v) for _, v in sorted(p.data_to_save["predictions"].items())] for p in runs["gpu"]]
        per_chunk = [[sum(v[i:i + stream]) for i in range(0, len(v), stream)] for v in valid]
        budget = min(128, stream * 8)  # make_project's crop_budget (the default) and max_det
        check(max(max(c) for c in per_chunk) <= budget, per_chunk)
        whole = hold_pipelines(runs["gpu"], runs["gpu_whole"])
        result.update({"chunk_frames": stream, "streams_gpu": streams["gpu"], "streams_cpu": streams["cpu"],
                       "valid_boxes_per_chunk": dict(zip(FOLDERS, per_chunk)), "crops_per_chunk": budget,
                       "vs_card_whole_scan": whole,
                       "launches_gpu_whole_run": launches["gpu_whole"]})
    emit(result)
    return result


FULL_WIDTH_PATCH = [
    # make_project's detector settings with the serving image size, the
    # scan step's crop budget and a host decode pool of 8 threads; the
    # fixture YOLOv10-n (trained at 128 px) scores below 0.5 at 640², so
    # the threshold is the ultralytics default 0.25 (as in fused_full_width)
    ("batch_size = 64", "batch_size = 8"),
    ("conf_thresh = 0.5", "conf_thresh = 0.25"),
    ("max_det = 64", "max_det = 8"),
    ("num_classes = 80", "num_classes = 2"),
    ("min_points = 1000", "min_points = 50"),
    ("crop_budget = 128", "crop_budget = 384"),
    ("decode_workers = 0", "decode_workers = 8"),
    ("fused_inference = false", "fused_inference = true"),
    ("yolo_weights =", f"yolo_weights = {FIXTURES / 'yolo_synthetic.msgpack'}"),
]
# the staged route at the same settings, but with the default detector
# batch (64 frames) and the default fused_inference = false; crop_budget
# is the fused route's knob and is left at its default
STAGED_FULL_WIDTH_PATCH = [p for p in FULL_WIDTH_PATCH
                           if p[0] not in ("batch_size = 64", "crop_budget = 128", "fused_inference = false")]


def phase_pipeline_full_width(dev, tiled_root: str, fused: bool = True) -> dict:
    """The user's path: ``tpu3dlm_torch.cli.main(["--data", "maintenance",
    "--config", cfg])`` on the capture tiled to 128 frames a scan (it runs
    gold, then maintenance), at 640², bf16, the fixture YOLOv10-n and a
    seeded BEiT-base at 224 (``beit_weights`` empty), ``icp_ann`` at its
    default — on the fused route with crop budget 384
    (``pipeline_full_width``) or, with ``fused=False``, on the staged route
    under the default config's ``fused_inference = false`` and detector
    batch of 64 (``staged_full_width``) — once with the launch counts at 0
    (B1 per scan by kernel, 12 per classify call: one per scan when fused,
    one per batch of 64 valid detections when staged; the crops classified;
    B2 by shape), then 5 warm maintenance runs through ``setup_pipeline``:
    per-stage ms, frames/s of detect + map, capture ms, peak memory. Sanity
    bars only (the CSV parses, every row has a verdict, finite outputs):
    random BEiT-base weights and a detector trained at 128 px make the
    missing count meaningless here."""
    import csv
    import os

    from tpu3dlm_torch import cli
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors
    from tpu3dlm_torch.pipeline import task
    from tpu3dlm_torch.utils.config import ConfigLoader

    phase = "pipeline_full_width" if fused else "staged_full_width"
    cfg_path = write_config(tiled_root, FULL_WIDTH_PATCH if fused else STAGED_FULL_WIDTH_PATCH)
    seen, b1_by_scan = [], []
    real_setup = task.setup_pipeline

    def recording_setup(*args, **kwargs):
        before = dict(beit_attention_packed.launches_by_kernel)
        seen.append(real_setup(*args, **kwargs))
        b1_by_scan.append({k: v - before.get(k, 0) for k, v in beit_attention_packed.launches_by_kernel.items()
                           if v != before.get(k, 0)})
        return seen[-1]

    torch.cuda.reset_peak_memory_stats()
    beit_attention_packed.launches = 0
    beit_attention_packed.launches_by_kernel.clear()
    nearest_neighbors.launches = 0
    nearest_neighbors.launches_by_shape.clear()
    task.setup_pipeline = recording_setup
    try:
        t0 = time.perf_counter()
        cli.main(["--data", "maintenance", "--config", cfg_path, "--device", str(dev)])
        cli_s = time.perf_counter() - t0
    finally:
        task.setup_pipeline = real_setup
    b1_by_kernel = dict(beit_attention_packed.launches_by_kernel)
    b2 = nearest_neighbors.launches
    b2_by_shape = {f"{n}x{m}": c for (n, m), c in sorted(nearest_neighbors.launches_by_shape.items())}
    check([p.data_folder for p in seen] == ["gold_std", "maintenance"], [p.data_folder for p in seen])
    # crops classified per scan: the top crop_budget of the 128 × 8 box
    # slots when fused, every valid detection when staged
    crops = [384 if fused else sum(len(v) for v in p.data_to_save["predictions"].values())
             for p in seen]
    calls = [1 if fused else -(-n // 64) for n in crops]
    check(b1_by_scan == [{"attention_bf16_tma": 12 * c} if c else {} for c in calls], (b1_by_scan, crops))
    check(b1_by_kernel == {"attention_bf16_tma": 12 * sum(calls)}, b1_by_kernel)
    check(b2 >= 4 and sum(nearest_neighbors.launches_by_shape.values()) == b2, b2_by_shape)
    gold, maint = seen
    out = maint.data_to_save
    if not fused:
        check(all(r[4] >= 0 for p in seen for recs in p.data_to_save["predictions"].values() for r in recs),
              "every valid detection classified")
    with open(maint.cfg.csv_output, newline="") as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == len(out["comparison_rows"]) and all(r.get("alignment") for r in rows), rows)
    check(all(np.isfinite(np.asarray(T, np.float64)).all() for T in out["transformations"]
              if not isinstance(T, tuple)), "finite transformations")
    for p in seen:
        for key in ("global_bboxes_data", "optimised_bboxes"):
            for recs in p.data_to_save[key].values():
                check(all(np.isfinite(np.asarray(r[:4], np.float64)).all() for r in recs), key)
    first = {"gold": gold.stage_times, "maintenance": maint.stage_times}

    # warm maintenance runs: the capture a user checks against the gold map
    cfg_gold, cfg_maint = ConfigLoader(cfg_path, "gold_std"), ConfigLoader(cfg_path, "maintenance")
    gold_var = task.load_gold_std(cfg_gold.pickle_path)
    stages: dict = {}
    walls = []
    beit_attention_packed.launches = 0
    for _ in range(5):
        t0 = time.perf_counter()
        p = task.setup_pipeline("maintenance", cfg_maint, cfg_gold, gold_var, device=dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        for k, v in p.stage_times.items():
            stages.setdefault(k, []).append(v * 1e3)
    check(beit_attention_packed.launches == 5 * 12 * calls[1], beit_attention_packed.launches)
    n_frames = len(p.data_to_save["predictions"])
    check(n_frames == 128, n_frames)
    med = {k: statistics.median(v) for k, v in stages.items()}
    result = {
        "phase": phase, "route": "fused" if fused else "staged", "frames_per_scan": n_frames,
        "img_size": 640, "dtype": "bfloat16", "decode_workers": 8, "conf_thresh": 0.25,
        **({"crop_budget": 384} if fused else {"detector_batch": 64, "classifier_batch": 64}),
        "cli_s": cli_s, "cli_stage_ms": {s: {k: v * 1e3 for k, v in t.items()} for s, t in first.items()},
        "crops_classified_by_scan": dict(zip(FOLDERS, crops)),
        "b1_launches_cli_by_scan": dict(zip(FOLDERS, b1_by_scan)),
        "b1_launches_cli_by_kernel": b1_by_kernel, "b2_launches_cli": b2,
        "b2_launches_cli_by_shape": b2_by_shape,
        "detections_maintenance": sum(len(v) for v in out["predictions"].values()),
        "kept_boxes_maintenance": sum(len(v) for v in out["optimised_bboxes"].values()),
        "rows": len(rows), "missing": sum(r["status"] == "missing" for r in rows),
        "verdict": out["alignment_verdict"],
        "warm_stage_ms_median": med, "warm_stage_ms_samples": stages,
        "warm_capture_ms_median": statistics.median(walls), "warm_capture_ms_samples": walls,
        "detect_map_frames_per_s": n_frames / ((med["detect"] + med["map"]) / 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(result)
    return result


def maintenance_run(cfg_maint, cfg_gold, gold_var, dev):
    """One maintenance Pipeline; returns (pipeline, capture ms)."""
    from tpu3dlm_torch.pipeline import task

    t0 = time.perf_counter()
    p = task.setup_pipeline("maintenance", cfg_maint, cfg_gold, gold_var, device=dev)
    return p, (time.perf_counter() - t0) * 1e3


def host_peak_mb(fn) -> tuple:
    """(``fn()``, the peak of the host allocations while it ran in MB);
    numpy arrays report theirs to tracemalloc."""
    import tracemalloc

    tracemalloc.start()
    try:
        out = fn()
        return out, tracemalloc.get_traced_memory()[1] / 1e6
    finally:
        tracemalloc.stop()


def valid_boxes(p) -> int:
    return sum(len(v) for v in p.data_to_save["predictions"].values())


def phase_stream_full_width(dev, root: str, mem_rate: float, frames: int = 512, chunk: int = 32) -> dict:
    """The serving path at full width: the committed capture tiled to 512
    frames a scan at 640², the fixture YOLOv10-n, a seeded BEiT-base in
    bf16, crop budget 384, 8 decode threads, ``streaming_chunk = 32``
    (``scripts/bench_stream.py``'s chunk); maintenance has lost the red
    sign (``drop_sign``). The CLI's maintenance run (gold, then
    maintenance) once with the counts at 0: B1 12 launches per chunk
    (16 chunks a scan) at B = 256 crops on ``attention_bf16_tma``, one
    chunk's B1 output held against the twin at that shape (1e-2 absolute
    and relative, as ``kernel_b1`` holds bf16) and timed there. Then,
    with each scan's data.db moved aside (the warm runs read the extracted
    files, as a watched capture is served; extraction from the database
    rewrites every file and with it the cache's fingerprint): 3 warm
    maintenance runs streamed, in turns with 3 whole-scan fused runs
    (``streaming_chunk = 0``); one profiled streamed run (device idle
    share); then ``scan_cache = true``: one writing run, then 3 decode-free
    runs on each route in turns. The first run of each route runs under
    tracemalloc for the host peak of its frame arrays; its time, which also
    carries the route's first-run costs, is kept apart from the medians of
    the other two. Per leg: stage ms,
    capture ms, frames/s of extract + detect, device peak memory (reset per
    run), host peak, streams' peak in flight, valid boxes. Sanity: finite
    outputs, every frame's records, exactly one missing sign in the CLI's
    report and the same report rows on every leg (the 0.1 mm distance
    within 2e-4 m)."""
    import os
    import shutil

    from tpu3dlm_torch import cli
    from tpu3dlm_torch.data import dataset
    from tpu3dlm_torch.models import beit as beit_module
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed, beit_attention_packed_reference
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors
    from tpu3dlm_torch.pipeline import task
    from tpu3dlm_torch.utils.config import ConfigLoader

    copy_project(root, frames=frames, dropped_sign=True)
    cfg_path = write_config(root, FULL_WIDTH_PATCH + [("streaming_chunk = 0", f"streaming_chunk = {chunk}")])
    seen, b1_by_scan, held = [], [], {}
    real_setup, real_b1 = task.setup_pipeline, beit_module.beit_attention_packed

    def recording_setup(*args, **kwargs):
        before = dict(beit_attention_packed.launches_by_kernel)
        seen.append(real_setup(*args, **kwargs))
        b1_by_scan.append({k: v - before.get(k, 0) for k, v in beit_attention_packed.launches_by_kernel.items()
                           if v != before.get(k, 0)})
        return seen[-1]

    b1_batches: dict = {}

    def keeping_b1(q, k, v, bias, num_heads):
        out = real_b1(q, k, v, bias, num_heads)
        b1_batches[q.shape[0]] = b1_batches.get(q.shape[0], 0) + 1
        if not held and q.shape[0] == chunk * 8:  # one chunk's crops: chunk frames × max_det
            held.update(q=q.clone(), k=k.clone(), v=v.clone(), bias=bias.clone(), h=num_heads, out=out.clone())
        return out

    beit_attention_packed.launches = 0
    beit_attention_packed.launches_by_kernel.clear()
    nearest_neighbors.launches = 0
    nearest_neighbors.launches_by_shape.clear()
    task.setup_pipeline, beit_module.beit_attention_packed = recording_setup, keeping_b1
    try:
        with StreamRecorder() as rec:
            t0 = time.perf_counter()
            cli.main(["--data", "maintenance", "--config", cfg_path, "--device", str(dev)])
            cli_s = time.perf_counter() - t0
    finally:
        task.setup_pipeline, beit_module.beit_attention_packed = real_setup, real_b1
    b1_by_kernel = dict(beit_attention_packed.launches_by_kernel)
    b2 = nearest_neighbors.launches
    check([p.data_folder for p in seen] == list(FOLDERS), [p.data_folder for p in seen])
    n_chunks = -(-frames // chunk)
    check([r["chunks"] for r in rec.streams] == [n_chunks, n_chunks]
          and all(r["peak_inflight"] <= 2 for r in rec.streams), rec.streams)
    check(b1_by_scan == [{"attention_bf16_tma": 12 * n_chunks}] * 2, b1_by_scan)
    check(b1_batches == {chunk * 8: 2 * 12 * n_chunks}, b1_batches)
    check(b2 >= 4, b2)
    want = beit_attention_packed_reference(held["q"], held["k"], held["v"], held["bias"], held["h"])
    b1_err = float((held["out"].float() - want.float()).abs().max())
    # kernel_b1's bf16 bar: 1e-2 absolute and relative, one bf16 ulp of p and of the output
    torch.testing.assert_close(held["out"].float(), want.float(), atol=1e-2, rtol=1e-2)
    b1_shape = list(held["q"].shape[:2]) + [held["h"], held["q"].shape[2] // held["h"]]
    # B1 at this launch shape, after the counted run (these launches are not counted as the path's)
    b1_ms = cuda_ms(lambda: beit_attention_packed(held["q"], held["k"], held["v"], held["bias"], held["h"]))
    b1_bound_ms, b1_bound_by = attention_bound_ms(*b1_shape, torch.bfloat16, mem_rate)
    del held
    cli_rows = seen[1].data_to_save["comparison_rows"]
    check(sum(r["status"] == "missing" for r in cli_rows) == 1, cli_rows)

    for folder in FOLDERS:
        db = Path(root, "configs", "data", folder, "data.db")
        shutil.move(str(db), str(db) + ".aside")
    cfg_gold, cfg_maint = ConfigLoader(cfg_path, "gold_std"), ConfigLoader(cfg_path, "maintenance")
    gold_var = task.load_gold_std(cfg_gold.pickle_path)
    legs: dict = {}
    runs: dict = {}

    def leg(name, route_chunk, cache, traced=False):
        cfg_maint.streaming_chunk, cfg_maint.scan_cache = route_chunk, cache
        torch.cuda.reset_peak_memory_stats()
        run = lambda: maintenance_run(cfg_maint, cfg_gold, gold_var, dev)  # noqa: E731
        with StreamRecorder() as r:
            (p, ms), host_peak = host_peak_mb(run) if traced else (run(), None)
        entry = legs.setdefault(name, {"capture_ms": [], "stage_ms": {}, "peak_mem_gb": [],
                                       "peak_inflight": [], "valid_boxes": []})
        if traced:  # tracemalloc slows the host: this run is timed apart
            entry["host_peak_mb"], entry["traced_capture_ms"] = host_peak, ms
        else:
            entry["capture_ms"].append(ms)
            for k, v in p.stage_times.items():
                entry["stage_ms"].setdefault(k, []).append(v * 1e3)
        entry["peak_mem_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
        entry["peak_inflight"].append([x["peak_inflight"] for x in r.streams])
        entry["valid_boxes"].append(valid_boxes(p))
        runs.setdefault(name, []).append(p)

    for traced in (True, False, False):
        leg("stream", chunk, False, traced)
        leg("whole_scan", 0, False, traced)
    cfg_maint.streaming_chunk, cfg_maint.scan_cache = chunk, False
    profile = profile_capture(lambda: maintenance_run(cfg_maint, cfg_gold, gold_var, dev))
    leg("cache_write_stream", chunk, True)
    pack = dataset._pack_path(cfg_maint.image_dir, 640)
    check(os.path.exists(pack + ".src"), "the streamed run wrote and finalised the pack")
    decodes = []
    real_decode = dataset._decode_frames
    dataset._decode_frames = lambda pairs, *a, **k: decodes.append(len(pairs)) or real_decode(pairs, *a, **k)
    try:
        for traced in (True, False, False):
            leg("cached_stream", chunk, True, traced)
            leg("cached_whole_scan", 0, True, traced)
    finally:
        dataset._decode_frames = real_decode
    check(decodes == [], f"cached runs decoded {sum(decodes)} frames")

    ref = runs["stream"][0].data_to_save
    dist_err = _report_err(cli_rows, ref["comparison_rows"])
    for name, ps in runs.items():
        for p in ps:
            out = p.data_to_save
            dist_err = max(dist_err, _report_err(out["comparison_rows"], ref["comparison_rows"]))
            check(all(np.isfinite(np.asarray(r[:4], np.float64)).all()
                      for recs in out["optimised_bboxes"].values() for r in recs), name)
            check(len(out["predictions"]) == frames, name)
    check(dist_err <= 2e-4, dist_err)
    summary = {}
    for name, e in legs.items():
        med = {k: statistics.median(v) for k, v in e["stage_ms"].items()}
        summary[name] = {
            "runs": len(e["capture_ms"]), "capture_ms_median": statistics.median(e["capture_ms"]),
            "capture_ms_samples": e["capture_ms"], "stage_ms_median": med, "stage_ms_samples": e["stage_ms"],
            "extract_detect_frames_per_s": frames / ((med["extract"] + med["detect"]) / 1e3),
            "device_peak_gb": max(e["peak_mem_gb"]), "host_peak_mb": e.get("host_peak_mb"),
            "traced_capture_ms": e.get("traced_capture_ms"),
            "stream_peak_inflight": e["peak_inflight"], "valid_boxes": e["valid_boxes"],
        }
    result = {
        "phase": "stream_full_width", "frames_per_scan": frames, "chunk_frames": chunk, "img_size": 640,
        "dtype": "bfloat16", "crop_budget": 384, "crops_per_chunk": min(384, chunk * 8), "decode_workers": 8,
        "cli_s": cli_s, "cli_stage_ms": {p.data_folder: {k: v * 1e3 for k, v in p.stage_times.items()} for p in seen},
        "chunks_per_scan": n_chunks, "b1_launches_cli_by_scan": dict(zip(FOLDERS, b1_by_scan)),
        "b1_launches_cli_by_kernel": b1_by_kernel, "b1_launch_shape": b1_shape, "b1_max_abs_err_vs_twin": b1_err,
        "b1_ms_at_launch_shape": b1_ms, "b1_bound_ms_at_launch_shape": b1_bound_ms, "b1_bound_by": b1_bound_by,
        "b2_launches_cli": b2, "valid_boxes_cli": {p.data_folder: valid_boxes(p) for p in seen},
        "report_rows": len(cli_rows), "missing": sum(r["status"] == "missing" for r in cli_rows),
        "max_report_distance_err_m": dist_err, "legs": summary,
        "profile_stream_run": profile,
    }
    emit(result)
    return result


def phase_watch_full_width(dev, tmp: str, frames: int = 128) -> dict:
    """The serving watcher on the default config (staged route) at full
    width: a data root of ``gold_std`` and 3 maintenance captures, each the
    committed capture tiled to 128 frames at 640², the maintenance ones
    without the red sign (``drop_sign``), a seeded BEiT-base in bf16.
    ``ScanWatcher(poll_interval=0.05, max_scans=4)`` on the card at
    ``concurrency = 1``, then on fresh copies at ``concurrency = 2``. Bars:
    every maintenance capture gets DONE with one missing sign, as does a
    plain CLI run of the same capture, and the report rows agree across the
    two runs and with that CLI run (the 0.1 mm distance within 2e-4 m); the
    thread count after ``close()`` equals the count before; at ``concurrency = 2`` the B1 and
    B2 launch counts equal the sum of the captures' own counts, taken one
    by one at ``concurrency = 1`` (lost counter updates would break this).
    Per-capture wall clock and captures per minute are records only."""
    import os
    import shutil
    import threading

    from tpu3dlm_torch import cli
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors
    from tpu3dlm_torch.pipeline import task
    from tpu3dlm_torch.pipeline.watch import DONE_SENTINEL, ScanWatcher

    captures = ["maintenance", "maintenance_2", "maintenance_3"]
    out: dict = {}
    own: dict = {}
    rows: dict = {}
    for concurrency in (1, 2):
        root = os.path.join(tmp, f"watch_{concurrency}")
        data = copy_project(root, frames=frames, dropped_sign=True)
        for name in captures[1:]:
            shutil.copytree(os.path.join(data, "maintenance"), os.path.join(data, name))
        cfg = write_config(root, STAGED_FULL_WIDTH_PATCH)
        real_setup = task.setup_pipeline

        def counting_setup(folder, *a, **k):
            b1, b2 = beit_attention_packed.launches, nearest_neighbors.launches
            p = real_setup(folder, *a, **k)
            if concurrency == 1:  # one capture at a time: its own counts
                own[folder] = {"b1": beit_attention_packed.launches - b1, "b2": nearest_neighbors.launches - b2}
            return p

        beit_attention_packed.launches = nearest_neighbors.launches = 0
        threads = threading.active_count()
        task.setup_pipeline = counting_setup
        try:
            w = ScanWatcher(cfg, poll_interval=0.05, max_scans=4, concurrency=concurrency, device=dev)
            t0 = time.perf_counter()
            w.run()
            wall_s = time.perf_counter() - t0
        finally:
            task.setup_pipeline = real_setup
        check(threading.active_count() == threads, (threading.active_count(), threads))
        check(sorted(w.processed) == sorted(["gold_std"] + captures) and not w.suspect, (w.processed, w.suspect))
        recs = {f: json.loads(Path(data, f, DONE_SENTINEL).read_text()) for f in ["gold_std"] + captures}
        check(all("missing" in recs[f] for f in captures), recs)
        rows[concurrency] = {f: _read_csv(os.path.join(data, f, "comparison_output.csv"))[1] for f in captures}
        launches = {"b1": beit_attention_packed.launches, "b2": nearest_neighbors.launches}
        maint_s = wall_s - recs["gold_std"]["wall_clock_s"]
        out[concurrency] = {
            "wall_s": wall_s, "captures_per_min": 4 * 60 / wall_s,
            "maintenance_captures_per_min": len(captures) * 60 / maint_s,
            "capture_wall_clock_s": {f: r["wall_clock_s"] for f, r in recs.items()},
            "capture_stage_s": {f: r["stage_times"] for f, r in recs.items()},
            "launches": launches, "threads_before_after": [threads, threading.active_count()],
            "missing": {f: recs[f]["missing"] for f in captures},
        }
        if concurrency == 1:
            # a plain CLI run of the same capture, against its gold pickle
            cli.main(["--data", "maintenance", "--config", cfg, "--device", str(dev)])
            cli_rows = _read_csv(os.path.join(data, "maintenance", "comparison_output.csv"))[1]
    total = {k: sum(c[k] for c in own.values()) for k in ("b1", "b2")}
    check(out[2]["launches"] == total and total["b1"] > 0 and total["b2"] > 0, (out[2]["launches"], own))
    dist_err = _report_err(cli_rows, rows[1]["maintenance"])
    missing = sum(r["status"] == "missing" for r in cli_rows)
    check(missing == 1 and all(out[c]["missing"][f] == 1 for c in out for f in captures), (missing, out))
    for f in captures:
        dist_err = max(dist_err, _report_err(rows[2][f], rows[1][f]), _report_err(rows[1][f], rows[1]["maintenance"]))
    check(dist_err <= 2e-4, dist_err)
    result = {"phase": "watch_full_width", "frames_per_capture": frames, "img_size": 640, "route": "staged",
              "captures": ["gold_std"] + captures, "poll_interval_s": 0.05, "missing_cli": missing,
              "by_concurrency": out, "launches_per_capture": own, "b1_launches_on_watch": out[2]["launches"]["b1"],
              "b2_launches_on_watch": out[2]["launches"]["b2"], "max_report_distance_err_m": dist_err}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# Slice 7: the 3D map (mapping, meshing, Poisson, TSDF)
# ---------------------------------------------------------------------------


def mesh_gap(got, want) -> dict:
    """Two meshes ((V, 3), (F, 3)) side by side: the face counts, their
    relative gap, and the two-sided vertex distance (each vertex to the
    nearest vertex of the other mesh): the largest, and the share of
    vertices farther than 1 mm (the larger of the two directions)."""
    from scipy.spatial import cKDTree

    (gv, gf), (wv, wf) = got, want
    out = {"faces": [len(gf), len(wf)], "face_gap": abs(len(gf) - len(wf)) / max(len(wf), 1)}
    if len(gv) == 0 or len(wv) == 0:
        return {**out, "max_m": 0.0 if len(gv) == len(wv) else float("inf"), "far_share": 0.0}
    d1, d2 = cKDTree(wv).query(gv)[0], cKDTree(gv).query(wv)[0]
    return {**out, "max_m": float(max(d1.max(), d2.max())),
            "far_share": float(max((d1 > 1e-3).mean(), (d2 > 1e-3).mean()))}


def hold_mesh(got, want, voxel: float, sheet: bool = False) -> dict:
    """The Poisson meshes' bars. In general: face counts within 0.5%, every
    vertex within 1e-3 m of the other mesh. On a planar sheet (``sheet``:
    the committed capture's DBSCAN-kept cloud, a wall at z = 3 m that the
    grid puts on its nodes; χ steps across the sheet, the iso is ≈ 0 and
    the sheet's nodes hold χ within FFT rounding of it, so rounding decides
    which cubes cross, in the JAX package as here): face counts within 8%,
    ≤ 20% of the vertices farther than 1e-3 m, every vertex within one
    voxel (ROADMAP §C: measured up to 6.1%, 14.2% and 0.69 voxel)."""
    gap = mesh_gap(got, want)
    if sheet:
        check(gap["face_gap"] <= 0.08 and gap["far_share"] <= 0.2 and gap["max_m"] <= voxel, gap)
    else:
        check(gap["face_gap"] <= 0.005 and gap["max_m"] <= 1e-3, gap)
    return gap


# the mesh settings of the Pipeline's map stage, as config patches
MESH_SETTINGS = {"tsdf": [("mesh_source = cloud", "mesh_source = tsdf")],
                 "cloud/density": [],
                 "cloud/poisson": [("mesher = density", "mesher = poisson")]}
# visualise on, with tests/test_meshing.py's DBSCAN radius (the committed
# capture's cloud holds ~2k points a m², so at the default 0.04 no point has
# min_points = 50 neighbours and DBSCAN keeps everything)
MESH_PATCH = [("eps = 0.04", "eps = 0.1"), ("visualise = false", "visualise = true")]


def hold_tsdf(got, want) -> dict:
    """Two TSDF fields ((field, origin, voxel) each): the same grid; voxels
    observed on one side only (NaN-mask flips) and voxels observed on both
    but more than 1e-5 apart are counted, and together may be at most 1e-4
    of the voxels (pixel-rounding flips; each step of the fusion rounds
    exactly on both devices, so 0 is expected)."""
    (a, lo_a, v_a), (b, lo_b, v_b) = got, want
    check(a.shape == b.shape and np.array_equal(lo_a, lo_b) and v_a == v_b,
          (a.shape, b.shape, lo_a, lo_b, v_a, v_b))
    na, nb = np.isnan(a), np.isnan(b)
    both = ~na & ~nb
    diff = np.abs(a[both] - b[both])
    out = {"dims": list(a.shape), "voxels": int(a.size), "voxel": v_a, "observed": int((~nb).sum()),
           "nan_flips": int((na != nb).sum()), "off_by_more_than_1e-5": int((diff > 1e-5).sum()),
           "max_abs_err": float(diff.max()) if diff.size else 0.0,
           "identical": bool(np.array_equal(a, b, equal_nan=True))}
    check(out["nan_flips"] + out["off_by_more_than_1e-5"] <= 1e-4 * a.size, out)
    return out


def hold_chi(got, want) -> dict:
    """Two Poisson indicators ((χ, origin, voxel, iso) each): the same grid,
    χ within 1e-5 × max|χ| (cuFFT against pocketfft) and the iso within
    1e-5 × max|χ| (a sheet's iso is ≈ 0, so its own size is no scale)."""
    (a, lo_a, v_a, iso_a), (b, lo_b, v_b, iso_b) = got, want
    check(a.shape == b.shape and np.array_equal(lo_a, lo_b) and v_a == v_b, (a.shape, b.shape, v_a, v_b))
    scale = float(np.abs(b).max())
    out = {"dims": list(a.shape), "voxel": v_a, "max_abs_chi": scale,
           "chi_err_rel_max": float(np.abs(a - b).max()) / scale,
           "iso": [iso_a, iso_b], "iso_err_rel_max": abs(iso_a - iso_b) / scale}
    check(out["chi_err_rel_max"] <= 1e-5 and out["iso_err_rel_max"] <= 1e-5, out)
    return out


def two_sided_gate(verts, points, voxel: float, gate: bool = True) -> dict:
    """``tests/test_meshing.py::test_synthetic_cloud_two_sided_distance`` on
    a 2000-point subsample: mesh → cloud (every 7th point) mean under 2
    voxels and max under 5, cloud → mesh mean under 2 voxels. Checked when
    ``gate`` (the single-layer Poisson surface the gate was made for);
    otherwise only measured (the density shell lies on both sides of the
    points)."""
    from scipy.spatial import cKDTree

    rs = np.random.RandomState(0)
    vi = rs.choice(len(verts), min(2000, len(verts)), replace=False)
    d_vc = cKDTree(points[::7]).query(verts[vi])[0]
    pi = rs.choice(len(points), min(2000, len(points)), replace=False)
    d_cv = cKDTree(verts).query(points[pi])[0]
    out = {"mesh_to_cloud_mean_voxels": float(d_vc.mean()) / voxel,
           "mesh_to_cloud_max_voxels": float(d_vc.max()) / voxel,
           "cloud_to_mesh_mean_voxels": float(d_cv.mean()) / voxel}
    check(not gate or (out["mesh_to_cloud_mean_voxels"] < 2 and out["mesh_to_cloud_max_voxels"] < 5
                       and out["cloud_to_mesh_mean_voxels"] < 2), out)
    return {**out, "gated": gate}


def port_launches() -> dict:
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors

    return {"b1": beit_attention_packed.launches, "b2": nearest_neighbors.launches}


def phase_mesh_parity(dev, tmp: str) -> dict:
    """The map stage on the card against the CPU, on the committed capture at
    ``bench_e2e.py``'s small configuration (make_project's config, fused
    route, fixture checkpoints, f32) with ``visualise = true``, ``eps =
    0.1`` and the default ``mesh_voxel = 0.04``: the gold Pipeline's
    ``map_mesh.ply`` for each mesh setting, the density and TSDF meshes
    identical, the Poisson mesh within ``hold_mesh``'s sheet bars; then the
    device legs alone: the TSDF field of both scans at 0.08 and 0.04
    (``hold_tsdf``) and χ of the DBSCAN-kept gold cloud at 0.08 and 0.04
    (``hold_chi``). DBSCAN, the splat, the march and the cull are the same
    host code on both sides. No port kernel runs in the map stage."""
    import os

    from tpu3dlm_torch.data.dataset import load_scan
    from tpu3dlm_torch.data.ply import load_ply, load_ply_mesh
    from tpu3dlm_torch.mapper.clustering import largest_cluster
    from tpu3dlm_torch.mapper.meshing import tsdf_from_scan
    from tpu3dlm_torch.mapper.poisson import mesh_poisson, poisson_indicator
    from tpu3dlm_torch.pipeline import task
    from tpu3dlm_torch.utils.config import ConfigLoader

    t_start = time.perf_counter()
    extra = [("infer_dtype = bf16", "infer_dtype = f32"),
             ("yolo_weights =", f"yolo_weights = {FIXTURES / 'yolo_synthetic.msgpack'}"),
             ("beit_weights =", f"beit_weights = {FIXTURES / 'beit_synthetic.msgpack'}")] + MESH_PATCH
    meshes, plot_ms, launches = {}, {}, []
    real_plot = task.Pipeline._plot_map

    def counted_plot(self, *args):
        before = port_launches()
        out = real_plot(self, *args)
        launches.append({k: v - before[k] for k, v in port_launches().items()})
        return out

    task.Pipeline._plot_map = counted_plot
    try:
        for name, device in (("cpu", "cpu"), ("gpu", dev)):
            root = os.path.join(tmp, f"mesh_parity_{name}")
            copy_project(root)
            for setting, patch in MESH_SETTINGS.items():
                cfg = ConfigLoader(pipeline_config(root, extra + patch), "gold_std")
                p = task.Pipeline("gold_std", cfg, device=device)
                p.run()
                out = os.path.join(os.path.dirname(cfg.ply_path), "map_mesh.ply")
                meshes[name, setting] = load_ply_mesh(out)
                plot_ms[f"{name} {setting}"] = p.stage_times["plot"] * 1e3
    finally:
        task.Pipeline._plot_map = real_plot
    voxel = cfg.mesh_voxel
    result = {"phase": "mesh_parity", "mesh_voxel": voxel, "eps": cfg.eps, "min_points": cfg.min_points,
              "plot_ms": plot_ms, "meshes": {}}
    for setting in MESH_SETTINGS:
        got, want = meshes["gpu", setting], meshes["cpu", setting]
        check(len(want[1]) > 1000, (setting, len(want[1])))
        if setting == "cloud/poisson":
            result["meshes"][setting] = hold_mesh(got, want, voxel, sheet=True)
        else:
            check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]), f"{setting} mesh")
            result["meshes"][setting] = {"faces": len(got[1]), "identical": True}

    tsdf = {}
    for folder in FOLDERS:
        ext = PROJECT / "data" / folder / "rtabmap_extract"
        scan = load_scan(str(ext / "data_rgb"), str(ext / "data_depth"), str(ext / "calibration"),
                         str(PROJECT / "data" / folder / "poses.txt"), img_size=128)
        for v in (0.08, 0.04):
            tsdf[f"{folder} {v}"] = hold_tsdf(tsdf_from_scan(scan, v, device=dev),
                                              tsdf_from_scan(scan, v, device="cpu"))
    pts, _ = load_ply(str(PROJECT / "data" / "gold_std" / "cloud.ply"))
    pts = pts[largest_cluster(pts, 0.1, 50)]
    vp = np.loadtxt(PROJECT / "data" / "gold_std" / "poses.txt", skiprows=1, ndmin=2)[:, 1:4].astype(
        np.float32).mean(axis=0)
    chi = {}
    for v in (0.08, 0.04):
        chi[str(v)] = hold_chi(poisson_indicator(pts, voxel=v, viewpoint=vp, device=dev),
                               poisson_indicator(pts, voxel=v, viewpoint=vp, device="cpu"))
        chi[str(v)]["mesh"] = hold_mesh(mesh_poisson(pts, voxel=v, viewpoint=vp, device=dev),
                                        mesh_poisson(pts, voxel=v, viewpoint=vp, device="cpu"), v, sheet=True)
    check(len(launches) == 6 and all(n == {"b1": 0, "b2": 0} for n in launches), launches)
    result.update({"tsdf": tsdf, "chi_kept_gold_cloud": chi, "kept_points": len(pts),
                   "port_kernel_launches_in_plot_stages": launches, "wall_s": time.perf_counter() - t_start})
    emit(result)
    return result


class StageLegs:
    """Times the legs of the map stage while it runs: the functions it calls
    are wrapped in their modules, for the ``with`` block, by timers (host
    clock around a synchronize on both sides; CUDA events beside it for the
    device legs, the FFT solve and the TSDF fusion with its depth upload).
    ``ms`` holds each leg's total; ``other_ms`` (set by ``stage``) the rest
    of the stage: uploads, downloads and the glue between legs."""

    def __init__(self):
        self.ms: dict = {}
        self._undo: list = []

    def _wrap(self, module, attr: str, leg: str, device: bool = False) -> None:
        real = getattr(module, attr)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if device:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            out = real(*args, **kwargs)
            if device:
                end.record()
            torch.cuda.synchronize()
            self.ms[leg] = self.ms.get(leg, 0.0) + (time.perf_counter() - t0) * 1e3
            if device:
                self.ms[leg + "_cuda_event"] = self.ms.get(leg + "_cuda_event", 0.0) + start.elapsed_time(end)
            return out

        setattr(module, attr, timed)
        self._undo.append((module, attr, real))

    def __enter__(self):
        from tpu3dlm_torch.data import ply
        from tpu3dlm_torch.mapper import mapping, meshing, poisson
        from tpu3dlm_torch.ops import pointcloud

        for module, attr, leg, device in (
            (mapping, "load_ply", "ply_read", False),
            (mapping, "largest_cluster", "dbscan", False),
            (pointcloud, "estimate_normals_grid", "normals", False),
            (meshing, "trilinear_scatter", "splat", False),
            (poisson, "trilinear_scatter", "splat", False),
            (poisson, "_solve_indicator", "fft_solve", True),
            (poisson, "trilinear_sample", "iso_sample", False),
            (meshing, "tsdf_grid", "tsdf_bounds", False),
            (meshing, "_fuse_tsdf", "fuse_with_depth_upload", True),
            (meshing, "marching_tetrahedra", "march", False),
            (poisson, "marching_tetrahedra", "march", False),
            (poisson, "_cull_leakage", "cull", False),
            (mapping, "save_ply_mesh", "ply_write", False),
            (ply, "save_ply_mesh", "ply_write", False),
        ):
            self._wrap(module, attr, leg, device)
        return self

    def __exit__(self, *exc):
        for module, attr, real in reversed(self._undo):
            setattr(module, attr, real)
        self._undo.clear()

    def stage(self, fn) -> float:
        """Runs ``fn`` with the legs timed; returns its wall ms."""
        with self:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        self.ms["other_ms"] = wall - sum(v for k, v in self.ms.items() if not k.endswith("_cuda_event"))
        return wall


def mesh_stats(verts, faces) -> dict:
    check(len(faces) > 1000 and np.isfinite(verts).all(), len(faces))
    return {"vertices": len(verts), "faces": len(faces)}


def mesh_grid(points, voxel: float, mesher: str) -> dict:
    """The grid a cloud mesher builds: effective voxel, dims, voxel count."""
    from tpu3dlm_torch.mapper.meshing import grid_bounds
    from tpu3dlm_torch.mapper.poisson import next_fast_len

    kw = dict(pad=6, fast_len=next_fast_len, min_dim=4) if mesher == "poisson" else {}
    _, dims, vox = grid_bounds(points, voxel, **kw)
    return {"voxel": vox, "dims": list(dims), "voxels": int(np.prod(dims))}


def tsdf_grid_of(scan, voxel: float) -> dict:
    from tpu3dlm_torch.mapper.meshing import tsdf_grid

    _, dims, vox, _, _ = tsdf_grid(scan, voxel, None, None, 20_000_000)
    return {"voxel": vox, "dims": list(dims), "voxels": int(np.prod(dims))}


def no_core_point(points, eps: float, min_points: int) -> dict:
    """DBSCAN's core test at (eps, min_points) for every point at once:
    the neighbours within eps, the point itself included, counted by a
    k-d tree (in f64; DBSCAN compares f32 differences, which moves a count
    only at the ball's edge). With no point at ``min_points``, DBSCAN labels
    every point noise and ``largest_cluster`` keeps them all."""
    from scipy.spatial import cKDTree

    counts = cKDTree(points).query_ball_point(points, r=eps, return_length=True, workers=-1)
    most = int(counts.max())
    return {"eps": eps, "min_points": min_points, "most_neighbours": most,
            "no_core_point": most < min_points, "kept_points": len(points) if most < min_points else None}


def phase_mesh_full_width(dev, tmp: str) -> dict:
    """The map stage at full width. (a) The CLI's gold run with ``visualise
    = true`` on the capture tiled to 128 frames (``FULL_WIDTH_PATCH``:
    640², bf16, fused) for each mesh setting at the default ``mesh_voxel =
    0.04`` (``eps = 0.1``, ``min_points = 50``): the stage's ms in the CLI
    run, then the median of 3 warm ``plot`` stages on that Pipeline, the
    device peak of one, one under ``torch.profiler`` (device idle share) and
    one with its legs timed (``StageLegs``). (b) ``Mapping.make_mesh`` on
    the ~1M-point gold cloud of ``two_scan_scene(1_000_000)`` written as a
    PLY (a trajectory at the origin, inside the scene): DBSCAN at ``eps =
    0.1``, ``min_points = 50`` once (the default 0.04 / 1000 checked by
    ``no_core_point``), then both meshers at 0.04 and 0.01, each call with
    its legs timed and its device peak. (c) ``mesh_scan`` (``tsdf_from_scan``
    and the march) on the 128-frame scan at 0.01. Sanity: > 1000 faces
    each; the two-sided gate of ``tests/test_meshing.py`` on (b)'s Poisson
    meshes (measured on the density shells); the TSDF meshes' median z in
    the scene's band (2.5–3.2 m). No port kernel runs in the map stage."""
    import os

    from tpu3dlm_torch import cli
    from tpu3dlm_torch.data.ply import load_ply, load_ply_mesh, save_ply
    from tpu3dlm_torch.data.poses import poses_to_frame
    from tpu3dlm_torch.mapper.clustering import largest_cluster
    from tpu3dlm_torch.mapper.mapping import Mapping
    from tpu3dlm_torch.mapper.meshing import mesh_scan
    from tpu3dlm_torch.pipeline import task

    t_start = time.perf_counter()
    root = os.path.join(tmp, "mesh_full")
    copy_project(root, frames=128)
    result: dict = {"phase": "mesh_full_width", "pipeline": {}, "cloud_1m": {}}
    scan = kept = None
    real_setup = task.setup_pipeline
    for setting, patch in MESH_SETTINGS.items():
        cfg_path = write_config(root, FULL_WIDTH_PATCH + MESH_PATCH + patch)
        seen = []
        task.setup_pipeline = lambda *a, **k: seen.append(real_setup(*a, **k)) or seen[-1]
        try:
            cli.main(["--data", "gold_std", "--config", cfg_path, "--device", str(dev)])
        finally:
            task.setup_pipeline = real_setup
        p = seen[0]
        cfg = p.cfg
        cli_plot_ms = p.stage_times["plot"] * 1e3
        if scan is None:
            scan = p._extract_images()
            cloud, _ = load_ply(cfg.ply_path)
            kept = cloud[largest_cluster(cloud, cfg.eps, cfg.min_points)]
        rec = p.data_to_save
        args = (scan, rec["global_bboxes_data"], rec["optimised_bboxes"], rec["pose_df"])
        warm = []
        for _ in range(3):
            p._timed("plot", p._plot_map, *args)
            warm.append(p.stage_times["plot"] * 1e3)
        torch.cuda.reset_peak_memory_stats()
        before = port_launches()
        p._plot_map(*args)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(port_launches() == before, "no port kernel in the map stage")
        prof = profile_capture(lambda: p._plot_map(*args))
        legs = StageLegs()
        legs_wall = legs.stage(lambda: p._plot_map(*args))
        verts, faces = load_ply_mesh(os.path.join(os.path.dirname(cfg.ply_path), "map_mesh.ply"))
        if setting == "tsdf":
            grid = tsdf_grid_of(scan, cfg.mesh_voxel)
            check(2.5 < float(np.median(verts[:, 2])) < 3.2, "TSDF mesh z band")
        else:
            grid = {**mesh_grid(kept, cfg.mesh_voxel, cfg.mesher), "cloud_points": len(cloud),
                    "kept_points": len(kept)}
        result["pipeline"][setting] = {
            **grid, **mesh_stats(verts, faces), "cli_plot_ms": cli_plot_ms,
            "cli_stage_ms": {k: v * 1e3 for k, v in p.stage_times.items() if k != "plot"},
            "warm_plot_ms_median": statistics.median(warm), "warm_plot_ms_samples": warm,
            "timed_legs_stage_ms": legs_wall, "split_ms": legs.ms, "device_peak_gb": peak, "profile": prof,
        }

    # (b) the ~1M-point gold cloud of the compare's scene
    cloud_dir = os.path.join(tmp, "mesh_1m")
    os.makedirs(cloud_dir, exist_ok=True)
    ply = os.path.join(cloud_dir, "cloud.ply")
    save_ply(ply, two_scan_scene(1_000_000)[0])
    pose = poses_to_frame(np.zeros(1), IDENTITY_POSES[:1])
    mapper = Mapping({}, {}, pose, eps=0.1, min_points=50, ply_filepath=ply, device=dev)
    n_cloud = len(mapper.points)
    t0 = time.perf_counter()
    default = no_core_point(mapper.points, 0.04, 1000)
    default["check_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mapper.preprocess()
    dbscan_ms = (time.perf_counter() - t0) * 1e3
    kept = mapper.points
    check(len(kept) >= 0.5 * n_cloud, (len(kept), n_cloud))
    result["cloud_1m"].update({"points": n_cloud, "kept_points": len(kept), "dbscan_ms": dbscan_ms,
                               "default_eps_check": default})
    for mesher in ("density", "poisson"):
        for voxel in (0.04, 0.01):
            m = Mapping({}, {}, pose, eps=0.1, min_points=50, ply_filepath=ply,
                        preprocess_point_cloud=False, device=dev)
            m.points = kept
            out = os.path.join(cloud_dir, f"{mesher}_{voxel}.ply")
            torch.cuda.reset_peak_memory_stats()
            legs = StageLegs()
            call_ms = legs.stage(lambda: m.make_mesh(out, voxel=voxel, mesher=mesher))
            verts, faces = load_ply_mesh(out)
            result["cloud_1m"][f"{mesher} {voxel}"] = {
                **mesh_grid(kept, voxel, mesher), **mesh_stats(verts, faces), "make_mesh_ms": call_ms,
                "split_ms": legs.ms, "device_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "two_sided_gate": two_sided_gate(verts, kept, mesh_grid(kept, voxel, mesher)["voxel"],
                                                 gate=mesher == "poisson"),
            }

    # (c) the TSDF of the 128-frame scan at 0.01
    torch.cuda.reset_peak_memory_stats()
    legs = StageLegs()
    mesh = {}
    wall = legs.stage(lambda: mesh.update(zip(("verts", "faces"), mesh_scan(scan, 0.01, device=dev))))
    check(2.5 < float(np.median(mesh["verts"][:, 2])) < 3.2, "TSDF mesh z band")
    result["tsdf_001"] = {**tsdf_grid_of(scan, 0.01), **mesh_stats(mesh["verts"], mesh["faces"]),
                          "frames": scan.num_frames, "mesh_scan_ms": wall, "split_ms": legs.ms,
                          "device_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    result["wall_s"] = time.perf_counter() - t_start
    emit(result)
    return result


# ---------------------------------------------------------------------------
# Slice 8: the int8 classifier and the accuracy evals
# ---------------------------------------------------------------------------

EVAL_FIXTURES = FIXTURES / "torch_eval"
FIXTURE_YOLO = str(FIXTURES / "yolo_synthetic.msgpack")
FIXTURE_BEIT = str(FIXTURES / "beit_synthetic.msgpack")
# the committed artifacts' operating point (docs/ACCURACY_HARD_EVAL.json)
EVAL_SETTINGS = dict(img_size=128, nc=2, conf=0.3, num_frames=14)


def reset_launches() -> None:
    from tpu3dlm_torch.ops import quant
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors

    beit_attention_packed.launches = 0
    beit_attention_packed.launches_by_kernel.clear()
    nearest_neighbors.launches = 0
    quant.launches = 0


def read_launches() -> dict:
    from tpu3dlm_torch.ops import quant
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors

    return {"b1": beit_attention_packed.launches, "b1_by_kernel": dict(beit_attention_packed.launches_by_kernel),
            "b2": nearest_neighbors.launches, "int8_gemm": quant.launches}


def hold_eval(got: dict, want: dict, key: str, floor: float) -> dict:
    """Per axis: ``n_gt`` (detector) or ``n_pairs`` (damage) identical to
    ``want``'s, and the axis metric ``key`` (``map50``, ``accuracy``) within
    max(``floor``, the axis's spread across seeds in ``want``), the
    tolerance tests/test_hard_eval_repro.py:56 gives backend numerics."""
    count = "n_gt" if key == "map50" else "n_pairs"
    rows = {}
    for axis, w in want["axes"].items():
        g = got["axes"][axis]
        tol = max(floor, w[f"{key}_spread"])
        rows[axis] = {key: g[key], "jax_cpu": w[key], "tol": tol, count: g[count], f"jax_{count}": w[count]}
        if key == "map50":
            rows[axis].update(n_pred=g["n_pred"], jax_n_pred=w["n_pred"])
        check(g[count] == w[count], f"{axis}: {count} {g[count]} vs the JAX CPU report's {w[count]}")
        check(abs(g[key] - w[key]) <= tol, f"{axis}: {key} {g[key]} vs {w[key]} (tol {tol})")
    return rows


def gate_verdicts(det: dict, dmg: dict) -> dict:
    """The committed artifacts' gates applied to the port's reports
    (``tpu3dlm_torch/scripts/hard_eval.py``): printed, not asserted — the
    artifacts were made with checkpoints that are not in the repo."""
    from tpu3dlm_torch.scripts.hard_eval import check_damage_eval_report, check_hard_eval_report

    docs = Path(__file__).resolve().parent / "docs"
    det_gate = json.loads((docs / "ACCURACY_HARD_EVAL.json").read_text())["gate"]
    dmg_gate = json.loads((docs / "ACCURACY_DAMAGE_EVAL.json").read_text())["gate"]
    return {"ACCURACY_HARD_EVAL.json": check_hard_eval_report(det, det_gate)["ok"],
            "ACCURACY_DAMAGE_EVAL.json": check_damage_eval_report(dmg, dmg_gate)["ok"]}


def phase_eval_parity(dev, tmp: str) -> dict:
    """The accuracy loop on the card at fixture scale: the whole hard-eval
    corpus (7 axes × 5 seeds × 14 frames, img_size 128, conf 0.3, the
    committed checkpoints, f32) through the detector and through detect →
    rectify → classify, held to the JAX package's CPU reports
    (``tests/fixtures/torch_eval``); the damage corpus again with the int8
    classifier, held to the float run; ``verify`` on a fresh
    ``make_project`` and the CLI's ``--setup`` cold start."""
    import os

    from tpu3dlm_torch import cli
    from tpu3dlm_torch.pipeline.evaluate import make_project, verify
    from tpu3dlm_torch.pipeline.hardeval import run_damage_hard_eval, run_hard_eval
    from tpu3dlm_torch.utils.config import ConfigLoader

    t0 = time.perf_counter()
    want_det = json.loads((EVAL_FIXTURES / "hard_eval_jax_cpu.json").read_text())
    want_dmg = json.loads((EVAL_FIXTURES / "damage_eval_jax_cpu.json").read_text())
    common = dict(EVAL_SETTINGS, device=dev)
    reset_launches()
    det = run_hard_eval(FIXTURE_YOLO, str(Path(tmp, "eval_det")), **common)
    det_rows = hold_eval(det, want_det, "map50", 0.06)
    reset_launches()
    dmg = run_damage_hard_eval(FIXTURE_YOLO, FIXTURE_BEIT, str(Path(tmp, "eval_dmg")), **common)
    dmg_launches = read_launches()
    dmg_rows = hold_eval(dmg, want_dmg, "accuracy", 0.03)
    check(dmg_launches["b1"] > 0 and dmg_launches["b1_by_kernel"] == {"attention_simt": dmg_launches["b1"]},
          dmg_launches)
    reset_launches()
    dmg8 = run_damage_hard_eval(FIXTURE_YOLO, FIXTURE_BEIT, str(Path(tmp, "eval_dmg8")), quant="int8", **common)
    dmg8_launches = read_launches()
    check(dmg8_launches["b1"] == dmg_launches["b1"] and dmg8_launches["int8_gemm"] == 6 * dmg_launches["b1"],
          (dmg8_launches, dmg_launches))
    int8_rows = {}
    for axis, e in dmg["axes"].items():
        q = dmg8["axes"][axis]
        int8_rows[axis] = {"accuracy_int8": q["accuracy"], "accuracy_f32": e["accuracy"],
                           "n_pairs_int8": q["n_pairs"], "n_pairs_f32": e["n_pairs"]}
        check(abs(q["accuracy"] - e["accuracy"]) <= 0.03, (axis, int8_rows[axis]))

    # verify on a fresh make_project: the Pipeline both ways, B1 and B2
    root = str(Path(tmp, "verify"))
    cfg, _, gold, _ = make_project(root, FIXTURE_YOLO, FIXTURE_BEIT)
    reset_launches()
    t_verify = time.perf_counter()
    rep = verify(cfg, gold, device=dev)
    verify_s = time.perf_counter() - t_verify
    verify_launches = read_launches()
    check(max(rep["placement_errors_m"].values()) <= 0.1 and rep["missing_flagged"] == 1, rep)
    check(verify_launches["b1"] > 0 and verify_launches["b2"] > 0, verify_launches)

    # the cold start: --setup writes each capture, then runs the Pipeline
    setup_root = Path(tmp, "setup")
    (setup_root / "configs").mkdir(parents=True)
    setup_cfg = str(setup_root / "configs" / "variables.cfg")
    Path(setup_cfg).write_text(Path(cfg).read_text())
    cwd = os.getcwd()
    os.chdir(setup_root)
    try:
        t_setup = time.perf_counter()
        for folder in FOLDERS:
            cli.main(["--data", folder, "--setup", "--config", setup_cfg, "--device", str(dev)])
        setup_s = time.perf_counter() - t_setup
    finally:
        os.chdir(cwd)
    setup_rows = _read_csv(ConfigLoader(setup_cfg, "maintenance").csv_output)[1]
    check(len(setup_rows) >= 1 and Path(ConfigLoader(setup_cfg, "gold_std").pickle_path).exists(), setup_rows)

    result = {
        "phase": "eval_parity", "settings": EVAL_SETTINGS, "seeds": det["seeds"],
        "hard_eval": det_rows, "damage_eval": dmg_rows, "damage_eval_int8_vs_f32": int8_rows,
        "combined_map50": det["axes"]["combined"]["map50"],
        "hard_eval_n_gt_seed0": {a: e["n_gt_per_seed"][0] for a, e in det["axes"].items()},
        "gate_verdicts": gate_verdicts(det, dmg),
        "gate_verdicts_int8_damage": gate_verdicts(det, dmg8)["ACCURACY_DAMAGE_EVAL.json"],
        "stage_seconds": {"hard_eval": det["stage_seconds"], "damage_eval": dmg["stage_seconds"],
                          "damage_eval_int8": dmg8["stage_seconds"]},
        "b1_launches_damage_eval": dmg_launches["b1"], "b1_launches_damage_eval_int8": dmg8_launches["b1"],
        "int8_gemms_damage_eval_int8": dmg8_launches["int8_gemm"],
        "verify": {"placement_errors_m": rep["placement_errors_m"], "missing_flagged": rep["missing_flagged"],
                   "rows": rep["rows"], "map50": rep["detection"]["map50"], "seconds": verify_s,
                   "b1_launches": verify_launches["b1"], "b2_launches": verify_launches["b2"]},
        "setup_cli": {"seconds": setup_s, "maintenance_rows": len(setup_rows),
                      "missing": sum(r["status"] == "missing" for r in setup_rows)},
        "seconds": time.perf_counter() - t0,
    }
    emit(result)
    return result


def phase_int8_full_width(dev) -> dict:
    """The int8 classifier at full width: BEiT-base at 224², seeded weights
    quantised by the port, on 384 crops (the scan step's crop budget) —
    the card's int8 GEMM against the CPU twin (int32 identical on a sample
    of 512 rows, padded rows included), and one projection at fc1's shape
    split into row quantisation, int8 GEMM and dequantisation beside a bf16
    GEMM (CUDA events); the int8 model in f32 against f32 (softmax drift < 0.1,
    the same top-1 on decisive crops, tests/test_quant.py:162-194's bar)
    and in bf16 (the same top-1 on those crops); one int8 forward with the
    counts at 0 (12 B1 launches, 72 int8 GEMMs); classify ms in int8 and
    bf16, median of 5 warm runs, with the device peak; then the fused scan
    step (``fused_full_width``'s configuration) with ``beit_quant = int8``
    beside bf16, the classify stage split out."""
    import copy

    from tpu3dlm_torch.models.beit import BeitConfig, preprocess_crops, quantize_beit
    from tpu3dlm_torch.models.layers import calibrate_batchnorm_
    from tpu3dlm_torch.ops import quant
    from tpu3dlm_torch.parallel.inference import boxes_to_original, classify_top_crops, detect, square_box_affine
    from tpu3dlm_torch.pipeline.fused import FusedScanRunner

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    cases = []
    for m, k, n in ((5, 768, 768), (16, 768, 3072), (17, 3072, 768), (384 * 197, 768, 3072)):
        a = rng.integers(-127, 128, (m, k), dtype=np.int8)
        b = rng.integers(-127, 128, (k, n), dtype=np.int8)
        rows = np.sort(rng.choice(m, min(m, 512), replace=False))  # the CPU twin on a sample of rows
        want = quant.int8_product(torch.from_numpy(a[rows]), torch.from_numpy(b))
        bd = torch.as_tensor(b, device=dev)
        for layout, wq in (("row-major", bd), ("column-major", bd.t().contiguous().t())):
            got = quant.int8_product(torch.as_tensor(a, device=dev), wq).cpu()
            check(got.dtype == torch.int32 and got.shape == (m, n) and torch.equal(got[rows], want),
                  (m, k, n, layout))
        cases.append([m, k, n])

    # where an int8 projection's time goes, at fc1's shape on 384 crops
    # (75,648 tokens × 768 → 3072): the row quantisation, the int8 GEMM, the
    # dequantisation, against one bf16 GEMM (CUDA events)
    xs = torch.randn(384 * 197, 768, device=dev).to(torch.bfloat16)
    w = torch.randn(3072, 768, device=dev) / 768 ** 0.5
    bias = torch.zeros(3072, device=dev)
    wq, ws = quant.quantize_weight(w.t())
    wq_cm, wq_rm = wq.t().contiguous().t(), wq.contiguous()
    xq, xscale = quant.quantize_rows(xs)
    acc = quant.int8_product(xq, wq_cm)
    w16 = w.to(torch.bfloat16)
    split = {
        "bf16_linear": cuda_ms(lambda: torch.nn.functional.linear(xs, w16)),
        "quantize_rows": cuda_ms(lambda: quant.quantize_rows(xs)),
        "int8_gemm": cuda_ms(lambda: quant.int8_product(xq, wq_cm)),
        "int8_gemm_row_major_kernel": cuda_ms(lambda: quant.int8_product(xq, wq_rm)),
        "dequantize": cuda_ms(lambda: ((acc.float() * xscale * ws) + bias).to(torch.bfloat16)),
        "dense_int8": cuda_ms(lambda: quant.dense_int8(xs, wq_cm, ws, bias)),
    }
    del xs, xq, acc

    cfg = BeitConfig()
    f32_cpu = seeded_beit(cfg, SEED + 22).eval()
    int8_cpu = quantize_beit(f32_cpu)
    models = {
        "f32": copy.deepcopy(f32_cpu).to(dev),
        "int8_f32": copy.deepcopy(int8_cpu).to(dev),
        "bf16": copy.deepcopy(f32_cpu).to(dev, torch.bfloat16),
        "int8": copy.deepcopy(int8_cpu).to(dev, torch.bfloat16),
    }
    crops, _ = bright_dark_crops(384, 224, 2, SEED + 23)
    x = preprocess_crops(torch.as_tensor(crops, device=dev))
    with torch.inference_mode():
        logits = {name: m(x).float().cpu().numpy() for name, m in models.items()}
        reset_launches()
        models["int8"](x)
        torch.cuda.synchronize()
        one = read_launches()
    check(one["b1"] == cfg.num_layers and one["b1_by_kernel"] == {"attention_bf16_tma": cfg.num_layers}, one)
    check(one["int8_gemm"] == 6 * cfg.num_layers, one)
    for name, v in logits.items():
        check(np.isfinite(v).all(), f"{name} logits finite")
    soft = {k: torch.softmax(torch.from_numpy(v), -1).numpy() for k, v in logits.items()}
    drift = float(np.abs(soft["f32"] - soft["int8_f32"]).max())
    drift_bf16 = float(np.abs(soft["f32"] - soft["int8"]).max())
    l32 = logits["f32"]
    top = np.sort(l32, axis=-1)
    decisive = (top[:, -1] - top[:, -2]) > 2 * max(drift, drift_bf16) * np.abs(l32).max()
    check(drift < 0.1 and decisive.any(), (drift, int(decisive.sum())))
    for name in ("int8_f32", "int8", "bf16"):
        check((logits[name].argmax(-1) == l32.argmax(-1))[decisive].all(), f"{name} top-1 on decisive crops")
    timing = {}
    with torch.inference_mode():
        for name in ("bf16", "int8", "int8", "bf16"):  # in turns
            models[name](x)
            torch.cuda.reset_peak_memory_stats()
            ms, samples = host_ms(lambda: models[name](x), runs=5)
            timing.setdefault(name, []).append({"ms": ms, "samples": samples,
                                                "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    del models

    # the fused scan step with beit_quant = int8 beside bf16
    F, budget = 128, 384
    scan = synthetic_scan(F, 640, (192, 256), SEED + 2)
    runners = {}
    for name, c in (("bf16", cfg), ("int8", BeitConfig(quant="int8"))):
        r = FusedScanRunner(img_size=640, conf_thresh=0.25, max_det=64, nc=80, variant="n", beit_config=c,
                            dtype=torch.bfloat16, crop_budget=budget, rng_seed=SEED, device=dev)
        calibrate_batchnorm_(r.yolo, torch.as_tensor(scan.rgb[:16], device=dev).float() / 255.0)
        runners[name] = r
    reset_launches()
    det8, _ = runners["int8"](scan)
    step_launches = read_launches()
    check(step_launches["b1"] == cfg.num_layers and step_launches["int8_gemm"] == 6 * cfg.num_layers,
          step_launches)
    det16, _ = runners["bf16"](scan)
    check(np.array_equal(det8.mask, det16.mask), "int8 and bf16 steps share the detector")
    agree = float((det8.damage[det8.mask] == det16.damage[det16.mask]).mean())
    step = {}
    rgb = torch.as_tensor(scan.rgb, device=dev)
    size = torch.as_tensor(scan.rgb_size, device=dev)
    affine = torch.as_tensor(square_box_affine(scan.rgb_size, 640), device=dev)
    for name in ("bf16", "int8", "int8", "bf16"):
        r = runners[name]
        ms, samples = host_ms(lambda: r(scan), runs=5)
        with torch.inference_mode():
            xs = rgb.float() / 255.0
            d = detect(r.yolo, xs, 640, 64)
            mask = d["conf"] >= 0.25
            _, boxes_rect = boxes_to_original(d["boxes"], affine, size)
            cls_ms, _ = host_ms(lambda: classify_top_crops(r.beit, xs, boxes_rect, d["conf"], mask, 0.25, budget))
        step.setdefault(name, []).append({"step_ms": ms, "step_ms_samples": samples, "classify_ms": cls_ms})
    med = lambda rows, key: statistics.median(x[key] for x in rows)  # noqa: E731
    result = {
        "phase": "int8_full_width", "crops": 384, "image_size": 224, "model": "BEiT-base, seeded",
        "int8_gemm_cases_identical": cases, "fc1_split_ms": split,
        "softmax_drift_int8_f32_vs_f32": drift, "softmax_drift_int8_bf16_vs_f32": drift_bf16,
        "decisive_crops": int(decisive.sum()),
        "b1_launches_per_forward": one["b1"], "int8_gemms_per_forward": one["int8_gemm"],
        "classify_ms": {k: med(v, "ms") for k, v in timing.items()}, "classify_runs": timing,
        "classify_peak_gb": {k: max(x["peak_gb"] for x in v) for k, v in timing.items()},
        "fused_step": {"frames": F, "crop_budget": budget, "runs": step,
                       "step_ms": {k: med(v, "step_ms") for k, v in step.items()},
                       "classify_ms": {k: med(v, "classify_ms") for k, v in step.items()},
                       "b1_launches_int8_step": step_launches["b1"],
                       "int8_gemms_int8_step": step_launches["int8_gemm"],
                       "damage_agreement_int8_vs_bf16": agree},
        "seconds": time.perf_counter() - t0,
    }
    emit(result)
    return result


def phase_eval_full_width(dev, tmp: str, parity: dict) -> dict:
    """The eval corpus at the ``*_FULL`` artifacts' operating point:
    YOLOv10-n at 640² (seeded, BatchNorm calibrated on corpus frames, bf16),
    BEiT-base at 224² (seeded) in bf16 and in int8, conf 0.3, 14 frames,
    seed 11 only (the time limit). No 640-pixel checkpoint is in the repo,
    so accuracy is not held: every metric finite, the ground truth per axis
    that of ``eval_parity``'s seed 11, B1 launched in both damage runs.
    Host generation ms per scan and JPEG encode ms per frame, detect
    frames/s, classify ms per batch of 64 in bf16 and int8 (CUDA events),
    and the device idle share of one profiled axis."""
    from tpu3dlm_torch.data.codecs import encode_jpeg, read_jpeg
    from tpu3dlm_torch.models.beit import BeitConfig, preprocess_crops, quantize_beit
    from tpu3dlm_torch.models.layers import calibrate_batchnorm_, init_seeded_
    from tpu3dlm_torch.models.yolov10 import YOLOv10
    from tpu3dlm_torch.pipeline import hardeval
    from tpu3dlm_torch.pipeline.hardeval import (
        EVAL_SEEDS, _load_scan, generate_axis_scan, run_damage_hard_eval, run_hard_eval,
    )

    t0 = time.perf_counter()
    seeds = (EVAL_SEEDS[0],)
    common = dict(img_size=640, nc=2, conf=0.3, num_frames=14, seeds=seeds, device=dev, dtype=torch.bfloat16)
    calib_root = str(Path(tmp, "full_calib"))
    generate_axis_scan(calib_root, "base", num_frames=14, seed=seeds[0])
    frames = _load_scan(calib_root, f"base_s{seeds[0]}", 640).rgb
    yolo = init_seeded_(YOLOv10(nc=2, variant="n"), torch.Generator().manual_seed(SEED)).to(dev)
    calibrate_batchnorm_(yolo, torch.as_tensor(frames[:8], device=dev).float() / 255.0)
    jpg = Path(calib_root, f"base_s{seeds[0]}", "rtabmap_extract", "data_rgb", "1.jpg")
    rgb = read_jpeg(str(jpg))
    t_enc = time.perf_counter()
    for _ in range(20):
        encode_jpeg(rgb)
    jpeg_ms = (time.perf_counter() - t_enc) / 20 * 1e3

    reset_launches()
    det = run_hard_eval(yolo, str(Path(tmp, "full_det")), **common)
    for axis, e in det["axes"].items():
        check(all(np.isfinite(e[k]) for k in ("map50", "map50_95", "precision", "recall")), axis)
        check(e["n_gt_per_seed"][0] == parity["hard_eval_n_gt_seed0"][axis], (axis, e["n_gt_per_seed"]))
    beit = seeded_beit(BeitConfig(num_labels=2), SEED + 24).eval()
    dmg = {}
    launches = {}
    for quant_mode in ("none", "int8"):
        reset_launches()
        dmg[quant_mode] = run_damage_hard_eval(yolo, beit, str(Path(tmp, f"full_dmg_{quant_mode}")),
                                               quant=quant_mode, **common)
        launches[quant_mode] = read_launches()
        for axis, e in dmg[quant_mode]["axes"].items():
            check(np.isfinite(e["accuracy"]) and e["n_pairs"] >= 0, (quant_mode, axis))
    check(launches["none"]["b1"] > 0 and launches["int8"]["b1"] == launches["none"]["b1"], launches)
    crops, _ = bright_dark_crops(64, 224, 2, SEED + 25)
    x = preprocess_crops(torch.as_tensor(crops, device=dev))
    batch_ms = {}
    with torch.inference_mode():
        for name, m in (("bf16", beit), ("int8", quantize_beit(beit))):
            m = m.to(dev, torch.bfloat16)
            batch_ms[name] = cuda_ms(lambda: m(x), iters=10, warmup=2)
    prof = profile_capture(lambda: run_hard_eval(yolo, str(Path(tmp, "full_prof")), axes=["base"], **common))
    n_scans = len(det["axes"]) * len(seeds)
    gen = det["stage_seconds"]["generate"]
    result = {
        "phase": "eval_full_width", "img_size": 640, "seeds": list(seeds), "yolo": "YOLOv10-n seeded, bf16",
        "beit": "BEiT-base seeded, bf16 and int8",
        "hard_eval": {a: {k: e[k] for k in ("map50", "n_gt", "n_pred")} for a, e in det["axes"].items()},
        "damage_eval": {q: {a: {k: e[k] for k in ("accuracy", "n_pairs")} for a, e in r["axes"].items()}
                        for q, r in dmg.items()},
        "stage_seconds": {"hard_eval": det["stage_seconds"],
                          **{f"damage_{q}": r["stage_seconds"] for q, r in dmg.items()}},
        "generate_ms_per_scan_threads": gen / n_scans * 1e3, "generate_workers": hardeval.WORKERS,
        "jpeg_encode_ms_per_frame": jpeg_ms,
        "detect_frames_per_s": n_scans * 14 / det["stage_seconds"]["detect"],
        "classify_ms_per_batch64": batch_ms,
        "b1_launches_damage": {q: v["b1"] for q, v in launches.items()},
        "int8_gemms_damage_int8": launches["int8"]["int8_gemm"],
        "profiled_axis": {"axis": "base", **{k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                                   "device_idle_share", "device_events")}},
        "seconds": time.perf_counter() - t0,
    }
    emit(result)
    return result


# ---------------------------------------------------------------------------
# Slice 9: the views of a run and the convergence-envelope sweep
# ---------------------------------------------------------------------------


def frame_classes(frame: np.ndarray) -> np.ndarray:
    """Each pixel of an animation frame as background (0), the gold map's
    grey (1) or the comparison map's red (2)."""
    f = frame.astype(np.int16)
    background = (f == 255).all(-1)
    red = (f[..., 0] - f[..., 1]) > 40
    return np.where(background, 0, np.where(red, 2, 1))


def hold_frames(got: list, want: list, bar: float = 1e-3) -> dict:
    """Two renders of one animation: the same frame count and, per frame,
    at most ``bar`` of the pixels on another surface (background, gold or
    comparison). A last-ulp difference in the replayed points reorders the
    renderer's z-ties (its ``argsort`` is not stable), which reshades
    pixels within a surface; the share of differing pixels is returned, not
    held."""
    check(len(got) == len(want), (len(got), len(want)))
    pixels = [float((a != b).any(-1).mean()) for a, b in zip(got, want)]
    classes = [float((frame_classes(a) != frame_classes(b)).mean()) for a, b in zip(got, want)]
    check(max(classes, default=0.0) <= bar, classes)
    return {"frames": len(got), "identical_frames": sum(p == 0.0 for p in pixels),
            "max_pixel_share": max(pixels, default=0.0), "max_surface_share": max(classes, default=0.0)}


VIS_SWITCHES = [("view_img = false", "view_img = true"), ("alignment_vis = false", "alignment_vis = true"),
                ("comparison_vis = false", "comparison_vis = true")]
# one ICP iteration a stage: 4 recorded steps, so at most 80 frames a run
# (the default 30 record 91 moving steps, 1820 frames)
VIS_CUT = [("icp_iterations = 30", "icp_iterations = 1")]


def capture_scan(folder: str, img_size: int = 128):
    """One scan of the committed capture through ``load_scan``."""
    from tpu3dlm_torch.data.dataset import load_scan

    ext = PROJECT / "data" / folder / "rtabmap_extract"
    return load_scan(str(ext / "data_rgb"), str(ext / "data_depth"), str(ext / "calibration"),
                     str(PROJECT / "data" / folder / "poses.txt"), img_size=img_size)


def hold_view_geometry(dev, scan, gboxes) -> dict:
    """``frame_view_geometry`` of every frame and ``scan_to_pointcloud`` of
    the scan on ``dev`` against the CPU: cloud points and boxes within 1e-5
    m, the valid masks and the frustum's lines identical, its points within
    1e-6 m. Returns the largest errors."""
    from tpu3dlm_torch.mapper.projection import frame_view_geometry
    from tpu3dlm_torch.ops.pointcloud import scan_to_pointcloud

    errs = {"cloud_m": 0.0, "box_m": 0.0, "frustum_m": 0.0, "boxes": 0}
    for f in range(scan.num_frames):
        got = frame_view_geometry(scan, gboxes, f, device=dev)
        want = frame_view_geometry(scan, gboxes, f, device="cpu")
        check(got["cloud_points"].shape == want["cloud_points"].shape, (got["cloud_points"].shape, f))
        errs["cloud_m"] = max(errs["cloud_m"], float(np.abs(got["cloud_points"] - want["cloud_points"]).max()))
        check(len(got["boxes"]) == len(want["boxes"]), f)
        errs["boxes"] += len(got["boxes"])
        for a, b in zip(got["boxes"], want["boxes"]):
            errs["box_m"] = max(errs["box_m"], float(np.abs(a - b).max()))
        check(got["frustum"]["lines"] == want["frustum"]["lines"], f)
        errs["frustum_m"] = max(errs["frustum_m"], float(np.abs(got["frustum"]["points"] - want["frustum"]["points"]).max()))
    args = (scan.depth, scan.intrinsics, scan.rgb_size, scan.poses)
    pts, ok = scan_to_pointcloud(*args, device=dev)
    w_pts, w_ok = scan_to_pointcloud(*args, device="cpu")
    check(torch.equal(ok.cpu(), w_ok), "scan_to_pointcloud valid masks")
    errs["scan_cloud_m"] = float((pts.cpu() - w_pts).abs().max())
    errs["scan_points"] = int(w_ok.sum())
    check(max(errs["cloud_m"], errs["box_m"], errs["scan_cloud_m"]) <= 1e-5 and errs["frustum_m"] <= 1e-6, errs)
    return errs


def drawn_corners(record) -> list:
    """Per frame, the integer corners ``_save_annotated`` draws each valid
    box at (the stored frame's pixels), from a recorded (rgb_size, frame
    side, boxes, mask, letterbox)."""
    wh, S, boxes, mask, lb = record
    out = []
    for f in range(boxes.shape[0]):
        row = []
        for b in range(boxes.shape[1]):
            if mask[f, b]:
                if lb is not None:
                    s, px, py = lb[f]
                    c = boxes[f, b] * s + [px, py, px, py]
                else:
                    sx, sy = S / wh[f, 0], S / wh[f, 1]
                    c = boxes[f, b] * [sx, sy, sx, sy]
                row.append(tuple(int(v) for v in c))
        out.append(row)
    return out


class VisRecorder:
    """Records, while active, what the views of a run produce: each
    ``VisualiseAlignment`` that wrote a video (with its seconds), and the
    detections each ``_save_annotated`` drew, by output directory."""

    def __enter__(self):
        from tpu3dlm_torch.alignment import visualise as vis_mod
        from tpu3dlm_torch.pipeline.detector import ObjectDetector

        self.animations, self.annotated = [], {}
        self._vis_mod, self._real_vis = vis_mod, vis_mod.VisualiseAlignment
        self._detector, self._real_save = ObjectDetector, ObjectDetector._save_annotated
        rec = self

        class Recording(vis_mod.VisualiseAlignment):
            def create_video(self, *args, **kwargs):
                t0 = time.perf_counter()
                n = super().create_video(*args, **kwargs)
                self.video_s = time.perf_counter() - t0
                rec.animations.append(self)
                return n

        def save(detector, scan, det):
            lb = None if scan.letterbox is None else np.asarray(scan.letterbox)
            rec.annotated[detector.save_img] = (np.asarray(scan.rgb_size), np.asarray(scan.rgb).shape[1],
                                                np.asarray(det.boxes).copy(), np.asarray(det.mask).copy(), lb)
            return rec._real_save(detector, scan, det)

        vis_mod.VisualiseAlignment = Recording
        ObjectDetector._save_annotated = save
        return self

    def __exit__(self, *exc):
        self._vis_mod.VisualiseAlignment = self._real_vis
        self._detector._save_annotated = self._real_save


def hold_annotated_frames(gpu: dict, cpu: dict) -> dict:
    """The annotated PNGs of the card's and the CPU's runs, directory by
    directory: a frame whose drawn corners are the same on both is
    byte-identical once decoded; a frame where a box coordinate straddles an
    integer between the two (card boxes are within 1e-2 px) is counted,
    with its differing pixels."""
    import os

    from tpu3dlm_torch.data.codecs import read_png

    out = {"frames": 0, "straddled_frames": 0, "straddled_pixels": 0}
    for (g_dir, g_rec), (c_dir, c_rec) in zip(sorted(gpu.items()), sorted(cpu.items())):
        for f, (a, b) in enumerate(zip(drawn_corners(g_rec), drawn_corners(c_rec), strict=True)):
            got = read_png(os.path.join(g_dir, f"image_{f}.png"))
            want = read_png(os.path.join(c_dir, f"image_{f}.png"))
            differ = int((got != want).any(-1).sum())
            out["frames"] += 1
            if a == b:
                check(differ == 0, (g_dir, f, differ))
            else:
                out["straddled_frames"] += 1
                out["straddled_pixels"] += differ
    return out


def phase_vis_parity(dev, tmp: str) -> dict:
    """The views of a run on the card against the CPU on the committed
    capture at ``bench_e2e.py``'s configuration on the staged route (f32,
    fixture checkpoints), the ICP cut to one iteration a stage (``VIS_CUT``):
    gold and maintenance with ``view_img``, ``alignment_vis`` and
    ``comparison_vis`` on, on the card (the launch counts at 0 just before)
    and on the CPU; the card's maintenance again with them off. Bars: the
    card's report CSV byte-identical with the switches off and on, and held
    to the CPU run by ``hold_pipelines``; the annotated PNGs by
    ``hold_annotated_frames``; the animation's frame count equal to the CPU
    run's, its frames within 1% of the pixels on another surface
    (``hold_frames``; the card's ICP steps differ from the CPU's within
    1e-4); ``frame_view_geometry`` and ``scan_to_pointcloud`` of both scans
    by ``hold_view_geometry``; B1 and B2 launched."""
    import os

    from tpu3dlm_torch.data.scan import detections_from_frame_dict
    from tpu3dlm_torch.mapper.projection import project_detections
    from tpu3dlm_torch.pipeline import task
    from tpu3dlm_torch.utils.config import ConfigLoader

    t_phase = time.perf_counter()
    extra = [("infer_dtype = bf16", "infer_dtype = f32"),
             ("yolo_weights =", f"yolo_weights = {FIXTURES / 'yolo_synthetic.msgpack'}"),
             ("beit_weights =", f"beit_weights = {FIXTURES / 'beit_synthetic.msgpack'}")] + VIS_CUT
    runs, recs, legs_s = {}, {}, {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        root = os.path.join(tmp, f"vis_parity_{name}")
        copy_project(root)
        cfg_off = write_config(root, PROJECT_PATCH + extra)
        text = Path(cfg_off).read_text()
        for old, new in VIS_SWITCHES:
            text = text.replace(old, new)
        cfg_on = str(Path(cfg_off).with_name("switches_on.cfg"))
        Path(cfg_on).write_text(text)
        t0 = time.perf_counter()
        with VisRecorder() as rec:
            if name == "gpu":
                reset_launches()  # the counts at 0 just before the path
            runs[name] = run_two_scans(cfg_on, device)
            if name == "gpu":
                launches = read_launches()
        legs_s[name] = time.perf_counter() - t0
        recs[name] = rec
        csv_on = Path(runs[name][1].cfg.csv_output).read_bytes()
        if name == "gpu":  # the same maintenance capture with the switches off
            cfg_gold = ConfigLoader(cfg_on, "gold_std")
            off = task.setup_pipeline("maintenance", ConfigLoader(cfg_off, "maintenance"), cfg_gold,
                                      task.load_gold_std(cfg_gold.pickle_path), device=dev)
            check(Path(off.cfg.csv_output).read_bytes() == csv_on, "CSV with the switches off and on")
            check(off.data_to_save["comparison_rows"] == runs[name][1].data_to_save["comparison_rows"], "rows")
    errs = hold_pipelines(runs["cpu"], runs["gpu"])
    check(launches["b1"] > 0 and launches["b2"] > 0, launches)
    png = hold_annotated_frames(recs["gpu"].annotated, recs["cpu"].annotated)
    check(png["frames"] == 10, png)  # both 5-frame scans, every frame written
    (g_vis,), (c_vis,) = recs["gpu"].animations, recs["cpu"].animations
    frames = hold_frames(g_vis.frames, c_vis.frames, bar=0.01)
    check(frames["frames"] == 20 * len(g_vis.moving_steps(runs["gpu"][1].data_to_save["transformations"])), frames)
    geometry = {}
    for folder, p in zip(FOLDERS, runs["gpu"]):
        scan = capture_scan(folder)
        det = detections_from_frame_dict(p.data_to_save["predictions"], scan.num_frames)
        geometry[folder] = hold_view_geometry(dev, scan, project_detections(scan, det, device="cpu"))
    written = sorted(n for n in os.listdir(os.path.dirname(runs["gpu"][1].cfg.csv_output))
                     if n.startswith("alignment_animation"))
    result = {"phase": "vis_parity", "route": "staged", "icp_iterations": 1, "launches_gpu_run": launches,
              "csv_identical_with_switches_off": True, "max_report_distance_err_m": errs["report_distance_m"],
              "max_box_err_px": errs["box_px"], "max_step_err": errs["step"],
              "annotated": png, "animation": {**frames, "file": written,
                                              "mesh_triangles": [len(g_vis.base_mesh[1]), len(g_vis.comp_mesh[1])]
                                              if g_vis.uses_mesh else None,
                                              "video_s": {"gpu": g_vis.video_s, "cpu": c_vis.video_s}},
              "view_geometry": geometry, "wall_s": legs_s, "seconds": time.perf_counter() - t_phase}
    emit(result)
    return result


def phase_vis_full_width(dev, staged_root: str, scene) -> dict:
    """The views at full width. (a) The animation at the compare cell's
    size: ``compare_full_width``'s capture again (two ~1M-point clouds,
    ``ann="off"``) for its recorded steps and raw comparison points, then
    ``VisualiseAlignment`` as the Pipeline makes it (50,000-point seeded
    subsample, density mesh at span/72, 480 × 640) over the first 2
    moving steps (40 frames; cut from 5 to keep the script's time): mesh ms, render ms per frame, write ms (the
    ``.npz`` where imageio has no encoder), host peak; the whole record's
    frame count and its time reckoned from those. (b) ``view_img`` on
    ``staged_full_width``'s 128-frame maintenance capture at 640²: the
    detect stage (detector + classifier) with and without it, 3 runs each
    in turns, and the drawing and PNG writing per frame. (c)
    ``scan_to_pointcloud`` of that scan on the card: ms and points."""
    import os

    from tpu3dlm_torch.alignment import visualise as vis_mod
    from tpu3dlm_torch.data import codecs
    from tpu3dlm_torch.ops.pointcloud import scan_to_pointcloud
    from tpu3dlm_torch.pipeline import task
    from tpu3dlm_torch.pipeline.detector import ObjectDetector
    from tpu3dlm_torch.utils.config import ConfigLoader

    t_phase = time.perf_counter()
    # (a) the animation of the 1M compare
    align, _, _ = run_compare(scene, dev, os.path.join(staged_root, "vis_full.csv"))
    steps = align.transformations
    t0 = time.perf_counter()
    vis, host_peak_mesh = host_peak_mb(lambda: vis_mod.VisualiseAlignment(scene[0], align.comparison_points,
                                                                          device=dev))
    mesh_ms = (time.perf_counter() - t0) * 1e3
    check(vis.uses_mesh, "the subsampled clouds meshed")
    moving = vis.moving_steps(steps)
    render_ms, write = [], {}
    real_render, real_write = vis._render, vis_mod.write_video

    def timed_render(*args):
        t = time.perf_counter()
        out = real_render(*args)
        render_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_write(*args, **kwargs):
        t = time.perf_counter()
        write["path"] = real_write(*args, **kwargs)
        write["ms"] = (time.perf_counter() - t) * 1e3
        return write["path"]

    vis._render, vis_mod.write_video = timed_render, timed_write
    try:
        t0 = time.perf_counter()
        n, host_peak_video = host_peak_mb(lambda: vis.create_video(
            moving[:2], os.path.join(staged_root, "alignment_animation.mp4")))
        video_ms = (time.perf_counter() - t0) * 1e3
    finally:
        vis_mod.write_video = real_write
    check(n == 40 and all(np.isfinite(f).all() and f.shape == (480, 640, 3) for f in vis.frames[:1]), n)
    frame_ms = statistics.median(render_ms)
    record_frames = 20 * len(moving)
    animation = {
        "points": [int(scene[0].shape[0]), int(align.comparison_points.shape[0])],
        "subsampled_to": [len(vis.base), len(vis.comparison)],
        "mesh_triangles": [len(vis.base_mesh[1]), len(vis.comp_mesh[1])],
        "recorded_steps": len(steps), "moving_steps": len(moving), "record_frames": record_frames,
        "frames_rendered": n, "mesh_ms": mesh_ms, "render_ms_per_frame_median": frame_ms,
        "render_ms_per_frame_max": max(render_ms), "write_ms": write["ms"], "file": os.path.basename(write["path"]),
        "file_mb": os.path.getsize(write["path"]) / 1e6, "video_ms": video_ms,
        "host_peak_mb": max(host_peak_mesh, host_peak_video),
        "record_reckoned_s": (mesh_ms + record_frames * frame_ms + write["ms"] * record_frames / n) / 1e3,
    }
    del vis

    # (b) view_img on the staged 128-frame capture
    cfg_path = Path(staged_root, "configs", "variables.cfg")
    on_path = cfg_path.with_name("view_img.cfg")
    on_path.write_text(cfg_path.read_text().replace("view_img = false", "view_img = true"))
    p_off = task.Pipeline("maintenance", ConfigLoader(str(cfg_path), "maintenance"), device=dev)
    p_on = task.Pipeline("maintenance", ConfigLoader(str(on_path), "maintenance"), device=dev)
    check(p_on.cfg.view_img and not p_off.cfg.view_img, "view_img switch")
    scan = p_off._extract_images()
    draw, png = [], []
    real_save, real_png = ObjectDetector._save_annotated, codecs.write_png

    def timed_save(detector, *args):
        t = time.perf_counter()
        real_save(detector, *args)
        draw.append((time.perf_counter() - t) * 1e3)

    def timed_png(*args):
        t = time.perf_counter()
        real_png(*args)
        png.append((time.perf_counter() - t) * 1e3)

    detect = {"off": [], "on": []}
    ObjectDetector._save_annotated, codecs.write_png = timed_save, timed_png
    try:
        for _ in range(3):
            for key, p in (("off", p_off), ("on", p_on)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                p._detect_signs(scan)
                torch.cuda.synchronize()
                detect[key].append((time.perf_counter() - t) * 1e3)
    finally:
        ObjectDetector._save_annotated, codecs.write_png = real_save, real_png
    frames = scan.num_frames
    written = sorted(os.listdir(p_on.cfg.processing_path))
    check(len(written) == frames == 128 and len(draw) == 3 and len(png) == 3 * frames, (len(written), len(draw)))
    # per run: the annotation's ms, of which the PNG writes, per frame
    png_runs = [sum(png[i * frames:(i + 1) * frames]) for i in range(3)]
    view_img = {"frames": frames, "frame_px": list(np.asarray(scan.rgb).shape[1:3]),
                "detect_ms_median": {k: statistics.median(v) for k, v in detect.items()},
                "detect_ms_samples": detect,
                "annotate_ms_per_frame": statistics.median(draw) / frames,
                "png_ms_per_frame": statistics.median(png_runs) / frames,
                "draw_ms_per_frame": statistics.median(d - w for d, w in zip(draw, png_runs)) / frames}

    # (c) the scan's point cloud on the card
    args = (scan.depth, scan.intrinsics, scan.rgb_size, scan.poses)
    up = [torch.as_tensor(np.asarray(a), device=dev) for a in args]
    _, ok = scan_to_pointcloud(*up, device=dev)
    cloud_ms, _ = host_ms(lambda: scan_to_pointcloud(*up, device=dev), runs=5)
    cloud = {"frames": frames, "depth_hw": list(scan.depth_hw), "points": int(ok.numel()),
             "valid_points": int(ok.sum()), "ms_median": cloud_ms,
             "cuda_ms": cuda_ms(lambda: scan_to_pointcloud(*up, device=dev))}
    result = {"phase": "vis_full_width", "animation": animation, "view_img": view_img,
              "scan_to_pointcloud": cloud, "seconds": time.perf_counter() - t_phase}
    emit(result)
    return result


def phase_envelope_parity(dev) -> dict:
    """The convergence-envelope sweep on the card
    (``tpu3dlm_torch.scripts.alignment_envelope``: 3 seeds, 144 cells)
    against the JAX package's record ``docs/ALIGNMENT_ENVELOPE.json``: each
    cell's ``success`` and ``flagged`` equal; a cell that differs is printed
    with its errors and must lie within 0.5° / 0.01 m of the 5° / 0.1 m
    success line, or (a verdict that differs) within 0.02 of the inlier
    floor 0.35 or 0.01 m of the rmse ceiling 0.08; ``gate_quality``'s catch
    and false-alarm rates within 0.05. B2's launches over the sweep (the
    counts at 0 just before)."""
    import json

    from tpu3dlm_torch.scripts import alignment_envelope as env

    with open(env.DOCS / "ALIGNMENT_ENVELOPE.json") as f:
        ref = json.load(f)
    reset_launches()
    t0 = time.perf_counter()
    report = env.run_sweep(False, 3, dev)
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    axes = ("rot_deg", "overlap", "outlier_rate", "noise_m", "init", "seed")
    check(len(report["cells"]) == len(ref["cells"]) == 144, len(report["cells"]))
    differ = []
    for got, want in zip(report["cells"], ref["cells"]):
        check(all(got[k] == want[k] for k in axes), (got, want))
        if got["success"] == want["success"] and got["flagged"] == want["flagged"]:
            continue
        row = {**{k: got[k] for k in axes}, "card": {k: got[k] for k in ("success", "flagged", "rot_err_deg",
                                                                          "t_err_m", "inlier", "rmse", "reasons")},
               "reference": {k: want[k] for k in ("success", "flagged", "rot_err_deg", "t_err_m", "inlier", "rmse",
                                                  "reasons")}}
        print(json.dumps({"envelope_cell_differs": row}), flush=True)
        differ.append(row)
        if got["success"] != want["success"]:
            check(any(abs(c["rot_err_deg"] - 5.0) <= 0.5 or abs(c["t_err_m"] - 0.1) <= 0.01 for c in (got, want)),
                  row)
        if got["flagged"] != want["flagged"]:
            check(any((c["inlier"] is not None and abs(c["inlier"] - 0.35) <= 0.02)
                      or (c["rmse"] is not None and abs(c["rmse"] - 0.08) <= 0.01) for c in (got, want)), row)
    gq, rq = report["gate_quality"], ref["gate_quality"]
    for key in ("catch_rate", "false_alarm_rate"):
        check(abs(gq[key] - rq[key]) <= 0.05, (key, gq, rq))
    check(launches["b2"] > 0, launches)
    result = {"phase": "envelope_parity", "cells": len(report["cells"]), "cells_differing": len(differ),
              "gate_quality": gq, "gate_quality_reference": rq,
              "success_by_init": {i: sum(c["success"] for c in report["cells"] if c["init"] == i)
                                  for i in ("centroid", "pca", "auto")},
              "success_by_init_reference": {i: sum(c["success"] for c in ref["cells"] if c["init"] == i)
                                            for i in ("centroid", "pca", "auto")},
              "b2_launches": launches["b2"], "wall_s": wall_s}
    emit(result)
    return result


def grad_ratios(got: dict, want: dict) -> dict:
    """Gradients ``got`` against ``want`` ({name: tensor}), each tensor's
    max|got − want| over its own max-abs in ``want``: the worst and the
    median over the tensors, and apart the tensors whose gradient is zero
    but for rounding (a BatchNorm bias feeding the next BatchNorm through a
    bias-free conv, whose shift the second one removes), recognised by a
    max-abs under 1e-6 × the model's largest gradient and measured against
    that largest gradient."""
    top = max(float(w.abs().max()) for w in want.values())
    ratios, zero = {}, {}
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name] - w).abs().max())
        if scale > 1e-6 * top:
            ratios[name] = err / scale
        else:
            zero[name] = err / top
    worst = max(ratios, key=ratios.get)
    return {"worst": ratios[worst], "worst_tensor": worst, "median": statistics.median(ratios.values()),
            "tensors": len(ratios), "rounding_zero_tensors": len(zero),
            "rounding_zero_worst": max(zero.values(), default=0.0)}


def fixture_training_arrays(img_size: int, frames: int):
    """The committed capture's gold scan at ``img_size`` with its
    ground-truth boxes (``yolo_training_arrays``), its first ``frames``
    frames, and its ground-truth crops for the toy BEiT."""
    from tpu3dlm_torch.data.synthetic import load_scene_gt
    from tpu3dlm_torch.pipeline.hardeval import _load_scan
    from tpu3dlm_torch.pipeline.selftrain import beit_training_crops, yolo_training_arrays

    scan = _load_scan(str(PROJECT / "data"), "gold_std", img_size)
    gt = load_scene_gt(str(PROJECT / "data" / "gold_std" / "gt.json"))
    arrays = [a[:frames] for a in yolo_training_arrays(gt["gt_boxes_2d"], scan)]
    crops, dmg = beit_training_crops(gt["gt_boxes_2d"], gt["gt_damage_2d"], scan, 32, device="cpu")
    return arrays, crops, dmg


def phase_train_parity(dev) -> dict:
    """Training on the card against the port's CPU run, on the same
    injected noise drawn once on the CPU and the same Flax-like init:

    * YOLOv10-n at 128 px, nc 2, on 4 frames of the committed capture's
      gold scan with their ground-truth boxes, the hard recipe's
      augmentation (erase on), AdamW at 2e-3, 3 steps: step 1's loss
      within 1e-4 relative, the later ones within 5e-3 (after an update
      Adam's normalised step has taken the sign of near-zero gradients the
      two devices round apart: 8.1e-5 and 1.7e-3 on an NVIDIA H100 80GB
      HBM3 against its host's CPU; ROADMAP §C); in step 1 the augmented
      images within 1e-5, both heads' TAL foreground masks identical, the
      BatchNorm statistics within 1e-4 × max(1, |value|) (8.5e-6 there:
      batch variances of maps of a few values, as the gradients below),
      and the gradients (``grad_ratios``) of the card and of the CPU each
      within 1e-2 × every tensor's max-abs of the gradient of the model in
      float64 on the CPU's augmented batch (the same foreground), the
      median tensor within 2e-3, and card against CPU by the same bars. A
      bar of 1e-4 card against CPU would sit below the f32 rounding of
      this train-mode network: a CPU's own f32 gradient is off its float64
      one by 1.1e-3–3.4e-3 × max-abs at worst, 4.0e-4–9.8e-4 at the median
      (two x86 hosts; ROADMAP §C);
    * the toy BEiT (``BEIT_KW``) on the capture's ground-truth crops with
      ``augment=True``, 3 steps: losses within 1e-4 relative, the augmented
      uint8 crops identical, B1 launched once per layer and step.

    Every bar is evaluated and the phase's line printed before the first
    failed bar raises."""
    import copy

    from tpu3dlm_torch.models.beit import BeitClassifier, BeitConfig
    from tpu3dlm_torch.models.layers import init_like_flax_
    from tpu3dlm_torch.models.yolov10 import YOLOv10
    from tpu3dlm_torch.ops.augment import augment_crop_batch, draw_crop_noise
    from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
    from tpu3dlm_torch.parallel.finetune import (
        adamw,
        draw_yolo_step_noise,
        init_finetune,
        make_beit_train_step,
        make_yolo_train_step,
    )
    from tpu3dlm_torch.pipeline.evaluate import BEIT_KW
    from tpu3dlm_torch.scripts.hard_eval import HARD_AUGMENT

    t0 = time.perf_counter()
    img_size, steps = 128, 3
    (images, boxes, labels, mask), crops, dmg = fixture_training_arrays(img_size, 4)
    imgs = images.astype(np.float32) / 255.0
    gen = torch.Generator().manual_seed(SEED + 20)
    cpu = init_like_flax_(YOLOv10(nc=2, variant="n"), gen)
    gpu = copy.deepcopy(cpu).to(dev)
    noise = [draw_yolo_step_noise(len(imgs), gen, HARD_AUGMENT) for _ in range(steps)]
    yolo_steps = {name: make_yolo_train_step(m, adamw(m.parameters(), 2e-3), img_size=img_size,
                                             augment=HARD_AUGMENT, device=d)
                  for name, m, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev))}
    exact = copy.deepcopy(cpu).double()
    exact_step = make_yolo_train_step(exact, adamw(exact.parameters(), 2e-3), img_size=img_size, device="cpu")
    yolo_losses = {"cpu": [], "gpu": []}
    out: dict = {}
    bars = []
    for i in range(steps):
        aux = {"cpu": {}, "gpu": {}}
        for name, step in yolo_steps.items():
            d = "cpu" if name == "cpu" else dev
            args = [torch.as_tensor(a, device=d) for a in (imgs, boxes, labels, mask)]
            yolo_losses[name].append(float(step(*args, noise=noise[i], aux=aux[name])))
        if i == 0:
            a, b = aux["cpu"], {k: v.cpu() for k, v in aux["gpu"].items()}
            exact_aux = {}
            exact_step(a["images"].double(), a["boxes"], torch.as_tensor(labels), a["mask"], aux=exact_aux)
            out["fg_flips_cpu_f64_vs_f32"] = {h: int((exact_aux[h] != a[h]).sum()) for h in ("fg_one2many", "fg_one2one")}
            out["aug_image_max_abs_err"] = float((a["images"] - b["images"]).abs().max())
            bars.append((out["aug_image_max_abs_err"] <= 1e-5, "augmented images"))
            bars.append((torch.equal(a["mask"], b["mask"]), "augmented masks"))
            for head in ("fg_one2many", "fg_one2one"):
                bars.append((torch.equal(a[head], b[head]), f"{head} differs in step 1"))
            out["fg_anchors_step1"] = {h: int(a[h].sum()) for h in ("fg_one2many", "fg_one2one")}
            grads = {"gpu": {n: p.grad.cpu().double() for n, p in gpu.named_parameters()},
                     "cpu": {n: p.grad.double() for n, p in cpu.named_parameters()},
                     "cpu_f64": {n: p.grad for n, p in exact.named_parameters()}}
            out["grad_err_step1"] = {
                "gpu_vs_cpu_f64": grad_ratios(grads["gpu"], grads["cpu_f64"]),
                "cpu_vs_cpu_f64": grad_ratios(grads["cpu"], grads["cpu_f64"]),
                "gpu_vs_cpu": grad_ratios(grads["gpu"], grads["cpu"]),
            }
            for key, worst, median in (("gpu_vs_cpu_f64", 1e-2, 2e-3), ("cpu_vs_cpu_f64", 1e-2, 2e-3),
                                       ("gpu_vs_cpu", 1e-2, 2e-3)):
                r = out["grad_err_step1"][key]
                bars.append((r["worst"] <= worst and r["median"] <= median and r["rounding_zero_worst"] <= 1e-4,
                             f"gradients {key}: {r}"))
            gsd = gpu.state_dict()
            stats = {k: (v, gsd[k].cpu()) for k, v in cpu.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            out["batch_stats_max_err_step1"] = max(float(((x - y).abs() / y.abs().clamp(min=1.0)).max())
                                                   for y, x in stats.values())
            bars.append((out["batch_stats_max_err_step1"] <= 1e-4, "batch_stats after step 1"))
    rel = [abs(g - c) / abs(c) for c, g in zip(yolo_losses["cpu"], yolo_losses["gpu"])]
    yolo_rel = max(rel)
    bars.append((rel[0] <= 1e-4 and max(rel[1:]) <= 5e-3 and all(np.isfinite(yolo_losses["gpu"])),
                 ("yolo losses", yolo_losses)))

    cfg = BeitConfig(**BEIT_KW)
    bgen = torch.Generator().manual_seed(SEED + 21)
    bcpu = init_like_flax_(BeitClassifier(cfg), bgen)
    bgpu = copy.deepcopy(bcpu)
    bnoise = [draw_crop_noise(len(crops), bgen) for _ in range(steps)]
    crop_flips = sum(int((augment_crop_batch(torch.as_tensor(crops), noise=n).cpu()
                          != augment_crop_batch(torch.as_tensor(crops, device=dev), noise=n).cpu()).sum())
                     for n in bnoise)
    bars.append((crop_flips == 0, f"{crop_flips} augmented crop values differ"))
    beit_steps = {name: make_beit_train_step(m, init_finetune(m, lr=1e-3, device=d), augment={}, device=d)
                  for name, m, d in (("cpu", bcpu, "cpu"), ("gpu", bgpu, dev))}
    beit_losses = {"cpu": [], "gpu": []}
    before = beit_attention_packed.launches
    for i in range(steps):
        for name, step in beit_steps.items():
            d = "cpu" if name == "cpu" else dev
            beit_losses[name].append(float(step(torch.as_tensor(crops, device=d), torch.as_tensor(dmg, device=d),
                                                noise=bnoise[i])))
    b1 = beit_attention_packed.launches - before
    bars.append((b1 == steps * cfg.num_layers, f"B1 launches {b1}"))
    beit_rel = max(abs(g - c) / abs(c) for c, g in zip(beit_losses["cpu"], beit_losses["gpu"]))
    bars.append((beit_rel <= 1e-4 and all(np.isfinite(beit_losses["gpu"])), ("beit losses", beit_losses)))
    result = {"phase": "train_parity", "yolo": {"img_size": img_size, "frames": len(imgs), "losses": yolo_losses,
                                                "max_loss_rel_err": yolo_rel, **out},
              "beit": {"crops": len(crops), "losses": beit_losses, "max_loss_rel_err": beit_rel,
                       "augmented_crop_values_differing": crop_flips, "b1_launches": b1},
              "seconds": time.perf_counter() - t0}
    emit(result)
    for ok, what in bars:
        check(ok, what)
    return result


class StepRecorder:
    """Wraps ``parallel.finetune``'s step makers while it is entered, so the
    steps an entry point builds record, per step, CUDA-event milliseconds,
    the loss (a device tensor, read at the end) and B1's launches."""

    def __init__(self):
        self.steps = {"yolo": [], "beit": []}

    def __enter__(self):
        from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
        from tpu3dlm_torch.parallel import finetune

        self._saved = (finetune.make_yolo_train_step, finetune.make_beit_train_step)

        def wrap(kind, make):
            def maker(*a, **kw):
                step = make(*a, **kw)

                def timed(*sa, **skw):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    before = beit_attention_packed.launches
                    start.record()
                    loss = step(*sa, **skw)
                    end.record()
                    self.steps[kind].append((start, end, loss, beit_attention_packed.launches - before))
                    return loss

                return timed

            return maker

        finetune.make_yolo_train_step = wrap("yolo", self._saved[0])
        finetune.make_beit_train_step = wrap("beit", self._saved[1])
        return self

    def __exit__(self, *exc):
        from tpu3dlm_torch.parallel import finetune

        finetune.make_yolo_train_step, finetune.make_beit_train_step = self._saved
        return False

    def summary(self, kind: str) -> dict:
        torch.cuda.synchronize()
        rows = self.steps[kind]
        ms = [s.elapsed_time(e) for s, e, _, _ in rows]
        return {"steps": len(rows), "step_ms_median": statistics.median(ms), "step_ms_max": max(ms),
                "loss_first": float(rows[0][2]), "loss_last": float(rows[-1][2]),
                "b1_launches": sum(r[3] for r in rows)}


def phase_train_full_width(dev, tmp: str) -> dict:
    """The training main path at full width, through the entry point a user
    calls: ``python -m tpu3dlm_torch.scripts.e2e_accuracy --full-scale``
    (``main``), the reference's own full-scale recipe — YOLOv10-n at 640²,
    1500 steps from the Flax-like init on the 5-frame gold scan, then
    BEiT-base at 224² in f32 for 120 steps, then ``verify`` over both scans
    — with the counts at 0 just before: the bars of
    ``docs/ACCURACY_FULL_SCALE.json`` (every placement error ≤ its
    tolerance, the expected missing sign flagged, its row count), training
    seconds, each model's median step ms (CUDA events), the loss at the
    first and last step, the device peak, B1's launches in the BEiT steps
    and B1's and B2's in ``verify``. Then the hard recipe's 640² step
    (``augment`` with erase, ``sample_batch = 16``, cosine, EMA) on the
    first 4 ``training_specs`` scenes: 3 warm and 10 timed steps, step ms
    and peak."""
    from tpu3dlm_torch.scripts import e2e_accuracy

    t0 = time.perf_counter()
    ref = json.loads((Path(__file__).resolve().parent / "docs" / "ACCURACY_FULL_SCALE.json").read_text())
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with StepRecorder() as rec:
        report = e2e_accuracy.main(["--full-scale", "--device", "cuda", "--out-dir", str(Path(tmp, "e2e_ckpt"))])
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    yolo, beit = rec.summary("yolo"), rec.summary("beit")
    check(yolo["steps"] == 1500 and beit["steps"] == 120, (yolo, beit))
    errors = report["placement_errors_m"]
    check(len(errors) == len(ref["placement_errors_m"]), errors)
    check(all(e <= ref["placement_tolerance_m"] for e in errors.values()), errors)
    check(report["missing_flagged"] == ref["missing_expected"] and report["rows"] == ref["rows"], report)
    check(beit["b1_launches"] == 120 * 12, beit)
    verify_b1 = launches["b1"] - beit["b1_launches"]
    check(verify_b1 > 0 and launches["b2"] > 0, launches)
    e2e = {"report": report, "training_seconds": report["training_seconds"],
           "verify_seconds": report["verify_seconds"], "yolo": yolo, "beit": beit, "peak_mem_gb": peak_gb,
           "b1_launches_train": beit["b1_launches"], "b1_launches_verify": verify_b1,
           "b2_launches_verify": launches["b2"], "reference_bars": {
               "placement_tolerance_m": ref["placement_tolerance_m"], "missing_expected": ref["missing_expected"],
               "rows": ref["rows"]}}
    hard = time_hard_recipe_step(dev, tmp)
    result = {"phase": "train_full_width", "e2e": e2e, "hard_recipe_step": hard,
              "seconds": time.perf_counter() - t0}
    emit(result)
    return result


def time_hard_recipe_step(dev, tmp: str, scenes: int = 4) -> dict:
    """``hard_eval --train --full-scale``'s YOLO step at 640² on the first
    ``scenes`` corpus scenes: augmentation with erase, 16 sampled frames a
    step, the cosine schedule and EMA as ``finetune_yolo`` runs them; 3 warm
    and 10 timed steps (median host ms, each ending in a synchronise)."""
    from tpu3dlm_torch.data import synthetic
    from tpu3dlm_torch.data.synthetic import load_scene_gt
    from tpu3dlm_torch.models.layers import init_like_flax_
    from tpu3dlm_torch.models.yolov10 import YOLOv10
    from tpu3dlm_torch.parallel.finetune import (
        adamw,
        ema_update,
        make_yolo_train_step,
        warmup_cosine_decay_schedule,
    )
    from tpu3dlm_torch.pipeline.hardeval import _load_scan
    from tpu3dlm_torch.pipeline.selftrain import yolo_training_arrays
    from tpu3dlm_torch.scripts.hard_eval import HARD_AUGMENT, training_specs

    root = str(Path(tmp, "hard_corpus"))
    arrays = []
    t0 = time.perf_counter()
    for i, spec in enumerate(training_specs()[:scenes]):
        synthetic.generate_scan(root, f"train_{i}", cloud_points_per_m2=800, **spec)
        gt = load_scene_gt(str(Path(root, f"train_{i}", "gt.json")))
        arrays.append(yolo_training_arrays(gt["gt_boxes_2d"], _load_scan(root, f"train_{i}", 640)))
    corpus_s = time.perf_counter() - t0
    images, boxes, labels, mask = (np.concatenate([a[k] for a in arrays]) for k in range(4))
    yolo = init_like_flax_(YOLOv10(nc=2, variant="n"), torch.Generator().manual_seed(SEED + 22)).to(dev)
    opt = adamw(yolo.parameters(), 2e-3)
    sched = warmup_cosine_decay_schedule(0.0, 2e-3, 400, 4000, 2e-3 * 0.05)
    step = make_yolo_train_step(yolo, opt, img_size=640, augment=HARD_AUGMENT, sample_batch=16, device=dev,
                                generator=torch.Generator().manual_seed(SEED + 23))
    ema = [p.detach().clone() for p in yolo.parameters()]
    imgs = torch.as_tensor(images.astype(np.float32) / 255.0, device=dev)
    gt = [torch.as_tensor(a, device=dev) for a in (boxes, labels, mask)]
    count = [0]
    losses = []

    def one():
        for group in opt.param_groups:
            group["lr"] = sched(count[0])
        losses.append(step(imgs, *gt))
        ema_update(ema, yolo.parameters(), 0.995)
        count[0] += 1

    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        one()
    step_ms, samples = host_ms(one, runs=10)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), losses)
    return {"scenes": scenes, "frames": int(images.shape[0]), "sample_batch": 16, "img_size": 640,
            "corpus_seconds": corpus_s, "step_ms": step_ms, "step_ms_samples": samples,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses}


# ---------------------------------------------------------------------------
# The world of ranks (A22): collectives on the card
# ---------------------------------------------------------------------------


def in_turns(plain, sharded, runs: int = 5) -> dict:
    """Median wall ms (``host_ms``) of the plain and the sharded call, run in
    turns (plain, sharded, sharded, plain), and the difference: what the
    world's collectives cost at this size."""
    a, sa = host_ms(plain, runs)
    b, sb = host_ms(sharded, runs)
    c, sc = host_ms(sharded, runs)
    d, sd = host_ms(plain, runs)
    p, q = statistics.median(sa + sd), statistics.median(sb + sc)
    return {"plain_ms": p, "sharded_ms": q, "overhead_ms": q - p, "plain_samples": sa + sd,
            "sharded_samples": sb + sc}


def phase_dist_full_width(dev) -> dict:
    """The world's paths at full width in a real 1-rank NCCL world on this
    card (``make_mesh(1, backend="nccl")``), each held to its unsharded twin
    on the same card and timed beside it in turns (the difference is the
    collectives' own cost at world 1):

    * ``sharded_full_scan_step`` (YOLOv10-n at 640², BEiT-base bf16, 128
      frames, crop budget 384, ``fused_full_width``'s scan) against
      ``full_scan_step``: masks, labels and damage equal, boxes within
      1e-2 px, corners within 1e-4 m; B1 launched once per layer;
    * ``target_sharded_nn`` at 16384 × 1,048,576 against B2: indices
      identical, d² equal; one B2 launch;
    * the data-parallel BEiT-base f32 step at batch 64 against the plain
      step (``finetune_full_width``'s task) on copies of one model: the
      loss within 1e-5, every gradient within 1e-5 (``finetune_parity``'s
      bars), B1 launched once per layer;
    * the data-parallel YOLOv10-n step at 640² (8 frames, 4 random boxes
      each, AdamW 2e-3) against the plain step: the loss within 1e-5
      relative, the gradients by ``grad_ratios`` within 1e-2 × max-abs
      (median 2e-3) and the BatchNorm statistics within 1e-4 × max(1,
      |value|) (``train_parity``'s bars).

    The world is torn down (and its store removed) however the phase ends."""
    from tpu3dlm_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, device=dev, backend="nccl")
    try:
        result = {"phase": "dist_full_width", "world": repr(mesh), **_dist_full_width(dev, mesh)}
    finally:
        mesh.close()
    check(not torch.distributed.is_initialized(), "the world is torn down")
    emit(result)
    return result


def _dist_full_width(dev, mesh, frames: int = 128, img: int = 640, nn_shape: tuple = (16384, 1 << 20),
                     beit_cfg=None, batch: int = 64, yolo_frames: int = 8) -> dict:
    """``phase_dist_full_width``'s work at its widths (smaller ones rehearse
    it on the CPU)."""
    import copy

    from tpu3dlm_torch.models.beit import BeitConfig
    from tpu3dlm_torch.models.layers import calibrate_batchnorm_, init_like_flax_
    from tpu3dlm_torch.models.yolov10 import YOLOv10
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors
    from tpu3dlm_torch.parallel.finetune import adamw, init_finetune, make_beit_train_step, make_yolo_train_step
    from tpu3dlm_torch.parallel.inference import full_scan_step, sharded_full_scan_step, square_box_affine
    from tpu3dlm_torch.parallel.mesh import shard_batch
    from tpu3dlm_torch.parallel.nn import target_sharded_nn
    from tpu3dlm_torch.pipeline.fused import FusedScanRunner

    out = {}
    # the sharded scan step
    F, crop_budget = frames, 384
    cfg = beit_cfg or BeitConfig()  # BEiT-base by default
    runner = FusedScanRunner(img_size=img, conf_thresh=0.25, max_det=64, nc=80, variant="n", beit_config=cfg,
                             dtype=torch.bfloat16, crop_budget=crop_budget, rng_seed=SEED, device=dev)
    scan = synthetic_scan(F, img, (192, 256), SEED + 2)
    calibrate_batchnorm_(runner.yolo, torch.as_tensor(scan.rgb[:16], device=dev).float() / 255.0)
    args = (scan.rgb, scan.depth, scan.intrinsics, scan.rgb_size, scan.poses, square_box_affine(scan.rgb_size, img))
    kw = dict(img_size=img, max_det=64, conf_thresh=0.25, crop_budget=crop_budget)
    reset_launches()
    got = sharded_full_scan_step(mesh, runner.yolo, runner.beit, *args, **kw)
    torch.cuda.synchronize()
    step_launches = read_launches()
    want = full_scan_step(runner.yolo, runner.beit, *args, device=dev, **kw)
    got, want = ({k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy() for k, v in o.items()}
                 for o in (got, want))
    for k in ("mask", "label", "damage"):
        check(np.array_equal(got[k], want[k]), f"sharded step {k}")
    m = want["mask"]
    box_err = float(np.abs(got["boxes"] - want["boxes"]).max())
    corner_err = float(np.abs(got["corners"][m] - want["corners"][m]).max()) if m.any() else 0.0
    check(m.any() and box_err <= 1e-2 and corner_err <= 1e-4, (int(m.sum()), box_err, corner_err))
    check(step_launches["b1"] == cfg.num_layers and step_launches["b2"] == 0, step_launches)
    out["scan_step"] = {
        "frames": F, "crop_budget": crop_budget, "detections": int(m.sum()), "max_box_err_px": box_err,
        "max_corner_err_m": corner_err, "b1_launches": step_launches["b1"],
        "b1_launches_by_kernel": step_launches["b1_by_kernel"],
        **in_turns(lambda: full_scan_step(runner.yolo, runner.beit, *args, device=dev, **kw),
                   lambda: sharded_full_scan_step(mesh, runner.yolo, runner.beit, *args, **kw)),
    }
    del runner

    # the target-sharded nearest neighbour
    rng = np.random.default_rng(SEED + 20)
    a = torch.as_tensor(rng.uniform(-3, 3, (nn_shape[0], 3)).astype(np.float32), device=dev)
    b = torch.as_tensor(rng.uniform(-3, 3, (nn_shape[1], 3)).astype(np.float32), device=dev)
    nn = target_sharded_nn(mesh)
    b_local = shard_batch(b, mesh)
    reset_launches()
    idx, d2 = nn(a, b_local)
    torch.cuda.synchronize()
    nn_launches = read_launches()["b2"]
    want_idx, want_d2 = nearest_neighbors(a, b)
    check(torch.equal(idx, want_idx) and torch.equal(d2, want_d2), "target-sharded NN equals B2")
    check(nn_launches == 1, nn_launches)
    plain_ms, sharded_ms = cuda_ms(lambda: nearest_neighbors(a, b)), cuda_ms(lambda: nn(a, b_local))
    out["target_sharded_nn"] = {"shape": list(nn_shape), "b2_launches": nn_launches, "plain_ms": plain_ms,
                                "sharded_ms": sharded_ms, "overhead_ms": sharded_ms - plain_ms,
                                "timing": "CUDA events, 10 calls after 2"}
    del a, b, b_local

    # the data-parallel BEiT-base step
    model = seeded_beit(cfg, SEED + 9)
    twin = copy.deepcopy(model)
    dp = make_beit_train_step(model, init_finetune(model, lr=1e-4, device=dev), mesh=mesh)
    plain = make_beit_train_step(twin, init_finetune(twin, lr=1e-4, device=dev), device=dev)
    crops, labels = bright_dark_crops(batch, cfg.image_size, cfg.num_labels, SEED + 10)
    crops, labels = torch.as_tensor(crops, device=dev), torch.as_tensor(labels, device=dev)
    reset_launches()
    loss_dp = float(dp(crops, labels))
    beit_launches = read_launches()
    loss_plain = float(plain(crops, labels))
    grad_err = max(float((p.grad - q.grad).abs().max()) for p, q in zip(model.parameters(), twin.parameters()))
    check(abs(loss_dp - loss_plain) <= 1e-5 and grad_err <= 1e-5, (loss_dp, loss_plain, grad_err))
    check(beit_launches["b1"] == cfg.num_layers, beit_launches)
    out["dp_beit_step"] = {"batch": batch, "dtype": "float32", "loss": loss_dp, "loss_err": abs(loss_dp - loss_plain),
                           "max_grad_err": grad_err, "b1_launches": beit_launches["b1"],
                           "b1_launches_by_kernel": beit_launches["b1_by_kernel"],
                           **in_turns(lambda: plain(crops, labels), lambda: dp(crops, labels))}
    del model, twin, dp, plain, crops, labels

    # the data-parallel YOLOv10-n step at 640²
    frames = yolo_frames
    images = torch.as_tensor(synthetic_scan(frames, img, (48, 64), SEED + 21).rgb, device=dev).float() / 255.0
    xy = rng.uniform(0, img * 0.6, (frames, 4, 2))
    wh = rng.uniform(img / 8, img * 0.4, (frames, 4, 2))
    boxes = torch.as_tensor(np.concatenate([xy, xy + wh], -1).astype(np.float32), device=dev)
    glabels = torch.as_tensor(rng.integers(0, 2, (frames, 4)).astype(np.int32), device=dev)
    gmask = torch.ones((frames, 4), dtype=torch.bool, device=dev)
    yolo = init_like_flax_(YOLOv10(nc=2), torch.Generator().manual_seed(SEED)).to(dev).train()
    ytwin = copy.deepcopy(yolo)
    ydp = make_yolo_train_step(yolo, adamw(yolo.parameters(), 2e-3), mesh, img)
    yplain = make_yolo_train_step(ytwin, adamw(ytwin.parameters(), 2e-3), None, img, device=dev)
    loss_dp = float(ydp(images, boxes, glabels, gmask))
    loss_plain = float(yplain(images, boxes, glabels, gmask))
    ratios = grad_ratios({n: p.grad for n, p in yolo.named_parameters()},
                         {n: p.grad for n, p in ytwin.named_parameters()})
    sd, sd_twin = yolo.state_dict(), ytwin.state_dict()
    stats_err = max(float(((sd[k] - sd_twin[k]).abs() / sd_twin[k].abs().clamp(min=1)).max())
                    for k in sd if k.endswith(("running_mean", "running_var")))
    check(abs(loss_dp - loss_plain) <= 1e-5 * abs(loss_plain), (loss_dp, loss_plain))
    check(ratios["worst"] <= 1e-2 and ratios["median"] <= 2e-3 and stats_err <= 1e-4, (ratios, stats_err))
    out["dp_yolo_step"] = {"frames": frames, "img_size": img, "loss": loss_dp, "loss_err": abs(loss_dp - loss_plain),
                           "grad_ratios": ratios, "max_stats_err": stats_err,
                           **in_turns(lambda: yplain(images, boxes, glabels, gmask),
                                      lambda: ydp(images, boxes, glabels, gmask)),
                           "profile_plain": profile_capture(lambda: yplain(images, boxes, glabels, gmask)),
                           "profile_sharded": profile_capture(lambda: ydp(images, boxes, glabels, gmask))}
    return out


def phase_dist_parity(dev) -> dict:
    """``python -m tpu3dlm_torch.scripts.distributed_smoke --procs 2 --backend
    gloo``: two spawned ranks sharing this card, the four legs at a small
    width held against one device by the script's bars, and B1 and B2
    launched on every rank. With two cards or more, the same over NCCL,
    one card a rank; with one card that leg does not apply (a line says
    so). The rank processes end before the script returns."""
    repo = Path(__file__).resolve().parent

    def smoke(backend: str) -> dict:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "tpu3dlm_torch.scripts.distributed_smoke", "--procs", "2",
                              "--backend", backend], cwd=repo, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        check(out.returncode == 0, f"distributed_smoke ({backend}) rc {out.returncode}: {out.stderr[-3000:]}"
              f"{out.stdout[-2000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        check(rec["ok"] and min(rec["b1_launches_by_rank"]) > 0 and min(rec["b2_launches_by_rank"]) > 0, rec)
        return {**rec, "seconds": seconds}

    result = {"phase": "dist_parity", "gloo_two_ranks_one_card": smoke("gloo"),
              "note": "two ranks share one card: not a scaling measurement"}
    if torch.cuda.device_count() >= 2:
        result["nccl_two_cards"] = smoke("nccl")
    else:
        print("dist_parity: the NCCL leg over two cards does not apply "
              f"({torch.cuda.device_count()} card visible)", flush=True)
        result["nccl_two_cards"] = "does not apply: one card"
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
    t_script = t0 = time.perf_counter()
    libs = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(str(p.name) for p in libs.values())})

    b1 = phase_kernel_b1(dev, mem_rate)
    phase_beit_past_old_limits(dev)
    phase_slice_parity(dev)
    full = phase_fused_full_width(dev)
    scene = two_scan_scene(1_000_000, SEED)
    b2 = phase_kernel_b2(dev, mem_rate, scene)
    with tempfile.TemporaryDirectory() as tmp:
        phase_compare_parity(dev, tmp)
        compare = phase_compare_full_width(dev, tmp, scene)
        phase_ann_parity(dev, scene)
        compare_ann = phase_compare_full_width_ann(dev, tmp, scene, compare["final_transform"])
    b3 = phase_kernel_b3(dev, mem_rate)
    phase_attention_grad(dev)
    phase_finetune_parity(dev)
    finetune = phase_finetune_full_width(dev)
    b4 = phase_kernel_b4(dev, mem_rate)
    with tempfile.TemporaryDirectory() as tmp:
        tiled_root = str(Path(tmp, "full"))
        copy_project(tiled_root, frames=128)
        phase_ingest_parity(tmp, tiled_root)
        phase_pipeline_parity(dev, tmp)
        pipe = phase_pipeline_full_width(dev, tiled_root)
        phase_pipeline_parity(dev, tmp, fused=False)
        staged_root = str(Path(tmp, "staged"))
        copy_project(staged_root, frames=128)
        staged = phase_pipeline_full_width(dev, staged_root, fused=False)
        phase_pipeline_parity(dev, tmp, stream=2)
        stream = phase_stream_full_width(dev, str(Path(tmp, "stream")), mem_rate)
        watch = phase_watch_full_width(dev, tmp)
        phase_mesh_parity(dev, tmp)
        phase_mesh_full_width(dev, tmp)
        vis = phase_vis_parity(dev, tmp)
        phase_vis_full_width(dev, staged_root, scene)
    envelope = phase_envelope_parity(dev)
    int8 = phase_int8_full_width(dev)
    with tempfile.TemporaryDirectory() as tmp:
        evals = phase_eval_parity(dev, tmp)
        phase_eval_full_width(dev, tmp, evals)
    phase_train_parity(dev)
    with tempfile.TemporaryDirectory() as tmp:
        train = phase_train_full_width(dev, tmp)
    t_dist = time.perf_counter()
    dist = phase_dist_full_width(dev)
    dist_parity = phase_dist_parity(dev)
    emit({"phase": "dist_seconds", "seconds": time.perf_counter() - t_dist})
    from tpu3dlm_torch.ops.kernels.nn_variants import VARIANTS

    b4_rows = []
    for kernel, line in (("nn_v1", 51), ("nn_v2", 86)):
        variants = [v for v, (k, _, _) in VARIANTS.items() if k == kernel]
        v = variants[0]  # the reference's variant of that kernel (v1, v2)
        b4_rows.append({
            "name": f"nn_variant_{v}", "route": "cuda", "source": "tpu3dlm_torch/csrc/nn_variants.cu",
            "replaces": f"scripts/bench_nn_variants.py:{line}",
            "launches": b4["launches_on_probe"][kernel],
            "launches_on": "the probe (tpu3dlm_torch/scripts/bench_nn_variants.py): verify and "
                           f"time of the variants {variants}, which launch the kernel {kernel}",
            "max_abs_err": max(b4["max_abs_err"][x] for x in variants),
            "ms": b4["ms"][v], "kernel_ms": b4["ms"][v],
            "variant_ms": {x: b4["ms"][x] for x in variants},
            "plain_ms": b4["plain_ms"], "bound_ms": b4["bound_ms"], "bound_by": b4["bound_by"],
            # no single PyTorch call computes this function; kernel B2 is the yardstick
            "library_ms": None, "b2_yardstick_ms": b4["ms"]["v0_production"],
            "redesigned": "for Hopper: wgmma over a TMA ring of packed targets",
            # derived, as bound_ms is: the MMAs at depth 16 at the bf16 peak
            "padded_mma_bound_ms": b4["padded_mma_bound_ms"],
        })
    emit({"kernels": [
        {
            "name": "beit_attention_packed", "route": "cuda", "kernel": "attention_bf16_tma",
            "source": "tpu3dlm_torch/csrc/beit_attention.cu",
            "replaces": "tpu3dlm/ops/pallas/attention.py:159",
            "launches": full["b1_launches_by_kernel_main_path"]["attention_bf16_tma"],
            "launches_on": "fused_full_width: one scan step (BEiT-base classify, bf16)",
            "max_abs_err": b1["max_abs_err"], "ms": b1["kernel_ms"], "kernel_ms": b1["kernel_ms"],
            "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
            "library_ms": b1["library_ms"],
            # every kernel_b1 case with the kernel the C entry routed it to
            "cases": b1["checks"],
            "launches_on_pipeline": pipe["b1_launches_cli_by_kernel"]["attention_bf16_tma"],
            "launches_on_pipeline_path": "pipeline_full_width: the CLI's gold and maintenance "
                                         "runs (128 frames a scan, BEiT-base bf16)",
            "launches_on_staged": staged["b1_launches_cli_by_kernel"]["attention_bf16_tma"],
            "launches_on_staged_by_scan": staged["b1_launches_cli_by_scan"],
            "launches_on_staged_path": "staged_full_width: the CLI's gold and maintenance runs on "
                                       "the staged route (every valid box classified, batches of 64)",
            "launches_on_stream": stream["b1_launches_cli_by_kernel"]["attention_bf16_tma"],
            "launches_on_stream_shape": stream["b1_launch_shape"],
            "launches_on_stream_max_abs_err": stream["b1_max_abs_err_vs_twin"],
            "ms_at_stream_shape": stream["b1_ms_at_launch_shape"],
            "bound_ms_at_stream_shape": stream["b1_bound_ms_at_launch_shape"],
            "launches_on_stream_path": "stream_full_width: the CLI's gold and maintenance runs streamed "
                                       f"in chunks of {stream['chunk_frames']} frames (512 a scan, 12 "
                                       "launches per chunk)",
            "launches_on_watch": watch["b1_launches_on_watch"],
            "launches_on_watch_path": "watch_full_width: ScanWatcher at concurrency 2 over gold_std and "
                                      "3 maintenance captures (staged route, 128 frames each)",
            "launches_on_int8": int8["b1_launches_per_forward"],
            "launches_on_int8_path": "int8_full_width: one forward of the int8 BEiT-base (bf16 activations) "
                                     f"on 384 crops, beside {int8['int8_gemms_per_forward']} int8 GEMMs",
            "launches_on_int8_step": int8["fused_step"]["b1_launches_int8_step"],
            "launches_on_dist": {
                "sharded_scan_step": dist["scan_step"]["b1_launches"],
                "dp_beit_step": dist["dp_beit_step"]["b1_launches"],
                "two_ranks_by_rank": dist_parity["gloo_two_ranks_one_card"]["b1_launches_by_rank"],
            },
            "launches_on_dist_path": "dist_full_width: the sharded scan step (bf16) and the data-parallel "
                                     "BEiT-base f32 step in a 1-rank NCCL world; dist_parity: each of two "
                                     "gloo ranks on one card, its scan step and finetune step run twice",
        },
        {
            # B1's other route: every f32 shape and the bf16 shapes past the
            # TMA kernel, timed at the finetune step's shape beside SDPA in
            # f32 (TF32 off)
            "name": "beit_attention_packed_simt", "route": "cuda", "kernel": "attention_simt",
            "source": "tpu3dlm_torch/csrc/beit_attention.cu",
            "replaces": "tpu3dlm/ops/pallas/attention.py:159",
            "launches": finetune["b1_launches_by_kernel"]["attention_simt"],
            "launches_on": "finetune_full_width: one finetune step (BEiT-base, f32, batch 64)",
            "max_abs_err": b1["f32_path"]["max_abs_err"], "ms": b1["f32_path"]["kernel_ms"],
            "kernel_ms": b1["f32_path"]["kernel_ms"], "plain_ms": b1["f32_path"]["plain_ms"],
            "bound_ms": b1["f32_path"]["bound_ms"], "bound_by": b1["f32_path"]["bound_by"],
            "library_ms": b1["f32_path"]["library_ms"], "shape": b1["f32_path"]["shape"],
            "launches_on_damage_eval": evals["b1_launches_damage_eval"],
            "launches_on_damage_eval_int8": evals["b1_launches_damage_eval_int8"],
            "launches_on_damage_eval_path": "eval_parity: the damage corpus (5 axes x 5 seeds x 14 frames) "
                                            "through DamageDetector, fixture BEiT (2 layers) in f32, "
                                            "2 launches per batch of 64 crops",
            "launches_on_verify": evals["verify"]["b1_launches"],
            "launches_on_vis": vis["launches_gpu_run"]["b1"],
            "launches_on_vis_path": "vis_parity: gold and maintenance on the staged route with view_img, "
                                    "alignment_vis and comparison_vis on (fixture BEiT, f32, attention_simt)",
            "launches_on_train": train["e2e"]["b1_launches_train"],
            "launches_on_train_path": "train_full_width: e2e_accuracy --full-scale, the 120 BEiT-base f32 "
                                      "training steps (forward; the backward is the plain recompute)",
            "launches_on_train_verify": train["e2e"]["b1_launches_verify"],
        },
        {
            "name": "nearest_neighbors", "route": "cuda",
            "source": "tpu3dlm_torch/csrc/nearest_neighbors.cu",
            "replaces": "tpu3dlm/ops/pallas/pairwise.py:148",
            "launches": compare["b2_launches_main_path"],
            "launches_on": "compare_full_width: one two-scan compare",
            "max_abs_err": b2["max_abs_err"], "ms": b2["kernel_ms"], "kernel_ms": b2["kernel_ms"],
            "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
            # no single PyTorch call computes this function: the chunked
            # cdist + min is a yardstick, not a library version
            "library_ms": None, "cdist_yardstick_ms": b2["cdist_yardstick_ms"],
            "launches_by_shape": compare["b2_launches_by_shape_main_path"],
            "launches_on_pipeline": pipe["b2_launches_cli"],
            "launches_on_pipeline_by_shape": pipe["b2_launches_cli_by_shape"],
            "launches_on_ann": compare_ann["b2_launches_cold_capture"],
            "launches_on_ann_by_shape": compare_ann["b2_launches_by_shape_cold_capture"],
            "launches_on_ann_path": "compare_full_width_ann: the cold capture at ann='auto' "
                                    "(index builds, init scoring, exact measurement)",
            "launches_on_watch": watch["b2_launches_on_watch"],
            "launches_on_watch_path": "watch_full_width: ScanWatcher at concurrency 2 over gold_std and "
                                      "3 maintenance captures (3 compares)",
            "launches_on_verify": evals["verify"]["b2_launches"],
            "launches_on_verify_path": "eval_parity: verify on a fresh make_project (the maintenance compare)",
            "launches_on_vis": vis["launches_gpu_run"]["b2"],
            "launches_on_vis_path": "vis_parity: the maintenance compare whose record the animation replays",
            "launches_on_envelope": envelope["b2_launches"],
            "launches_on_envelope_path": "envelope_parity: the 144 registrations of the convergence-envelope sweep",
            "launches_on_train_verify": train["e2e"]["b2_launches_verify"],
            "launches_on_train_verify_path": "train_full_width: verify after e2e_accuracy --full-scale's "
                                             "training (the maintenance compare at 640²)",
            "launches_on_dist": {
                "target_sharded_nn": dist["target_sharded_nn"]["b2_launches"],
                "two_ranks_by_rank": dist_parity["gloo_two_ranks_one_card"]["b2_launches_by_rank"],
            },
            "launches_on_dist_path": "dist_full_width: target_sharded_nn at 16384 x 1,048,576 in a 1-rank "
                                     "NCCL world; dist_parity: each of two gloo ranks on one card, its "
                                     "query-sharded compare and target-sharded NN run twice",
            "ms_by_shape": {f"{c['shape'][0]}x{c['shape'][1]}": {
                "case": c["case"], **{k: c[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by")}}
                for c in b2["checks"] if "kernel_ms" in c},
        },
        {
            "name": "beit_attention", "route": "cuda", "kernel": "attention_bf16_tma",
            "source": "tpu3dlm_torch/csrc/beit_attention.cu",
            "replaces": "tpu3dlm/ops/pallas/attention.py:77",
            "launches": b3["launches_on_path"],
            "launches_on": "kernel_b3: the public op beit_attention, forward and backward, "
                           f"at {tuple(b3['shape'])} bf16",
            "max_abs_err": b3["max_abs_err"], "ms": b3["kernel_ms"], "kernel_ms": b3["kernel_ms"],
            "plain_ms": b3["plain_ms"], "bound_ms": b3["bound_ms"], "bound_by": b3["bound_by"],
            "library_ms": b3["library_ms"],
        },
        *b4_rows,
    ]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_script})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
