"""The port's three benches (``tpu3dlm_torch/scripts/bench*.py``) against the
reference's (``bench.py``, ``bench_align.py``, ``bench_e2e.py``) on the CPU
at small sizes; each tolerance is stated beside its check."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
import bench_align as jax_bench_align
import bench_e2e as jax_bench_e2e
from tpu3dlm.models.yolov10 import postprocess as jax_postprocess
from tpu3dlm_torch.models.weights import yolov10_to_flax
from tpu3dlm_torch.models.yolov10 import postprocess
from tpu3dlm_torch.pipeline import evaluate as PE
from tpu3dlm_torch.scripts import bench, bench_align, bench_e2e

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def step_pair():
    """2 frames at 64 px (the port's synthetic capture, tiled), the bench's
    own model in f32 (seeded YOLOv10-n, 80 classes, BatchNorm calibrated on
    16 noise frames) and the same weights as Flax variables. Calibrated on
    the 2 frames alone, the coarse level's BatchNorms would normalise over 8
    values a channel and turn f32 round-off into reordered near-ties. The
    one-to-one class head's biases are lowered by 2 so that the step's
    conf >= 0.25 keeps some anchors and drops others (calibrated, every
    conf sits above 0.5)."""
    arrays = bench.build_inputs(2, 64)
    noise = np.random.default_rng(0).integers(0, 256, (16, 64, 64, 3), dtype=np.uint8)
    port_yolo = bench.build_model("n", torch.float32, "conv", CPU, calibrate_on=noise)
    with torch.no_grad():
        for level in port_yolo.model[-1].one2one_cv3:
            level[2].bias -= 2.0
    return arrays, yolov10_to_flax(port_yolo), port_yolo


def test_bench_step_matches_the_reference(step_pair, monkeypatch):
    """The port's step in f32 against ``bench.make_step`` with
    ``BENCH_DTYPE=f32``, same inputs and weights: ``valid`` identical,
    corners within 1e-4 m, conf within 1e-5, and the detector boxes inside
    the step within 1e-3 px."""
    monkeypatch.setenv("BENCH_DTYPE", "f32")
    arrays, variables, port_yolo = step_pair
    yolo, jax_step = jax_bench.make_step(64, max_det=64)
    assert yolo.dtype == jnp.float32
    want = jax_step(variables, *(jnp.asarray(a) for a in arrays))
    got = bench.make_step(port_yolo, 64)(*bench.upload(arrays, CPU))
    assert 0 < int(np.asarray(want[1]).sum()) < np.asarray(want[1]).size  # the threshold bites
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    v = np.asarray(want[1])
    np.testing.assert_allclose(got[0].numpy()[v], np.asarray(want[0])[v], atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5)
    x = arrays[0].astype(np.float32) / 255.0
    want_det = jax_postprocess(yolo.apply(variables, jnp.asarray(x))["one2one_split"], img_size=64, max_det=64)
    with torch.no_grad():
        got_det = postprocess(port_yolo(torch.from_numpy(x))["one2one_split"], img_size=64, max_det=64)
    np.testing.assert_allclose(got_det["boxes"].numpy(), np.asarray(want_det["boxes"]), atol=1e-3, rtol=0)


def test_bench_concat_postprocess_gives_the_same_step(step_pair):
    """``--postprocess concat`` (the reference's A/B baseline) gives the
    per-level step's outputs bit for bit."""
    arrays, _, port_yolo = step_pair
    args = bench.upload(arrays, CPU)
    a = bench.make_step(port_yolo, 64)(*args)
    b = bench.make_step(port_yolo, 64, postprocess="concat")(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flop_count_is_positive_and_scales_with_frames(step_pair):
    """``FlopCounterMode`` over one step: positive, and two frames cost
    exactly twice one frame (every counted op is per frame)."""
    arrays, _, port_yolo = step_pair
    step = bench.make_step(port_yolo, 64)
    one = bench.step_flops(step, bench.upload([a[:1] for a in arrays], CPU))
    two = bench.step_flops(step, bench.upload(arrays, CPU))
    assert one > 0 and two == 2 * one
    fps = 1e6  # frames/s: enough for an MFU above the 4-decimal rounding
    fields = bench.mfu_fields(two, 2, fps, "NVIDIA H100 80GB HBM3")
    assert fields["gflop_per_frame"] == round(one / 1e9, 2)
    assert fields["mfu_vs_bf16_peak"] == round(fps * one / 1e12 / 989.4, 4) > 0
    assert "mfu_vs_bf16_peak" not in bench.mfu_fields(two, 2, fps, "some other card")


def test_bench_main_prints_one_json_line(capsys, tmp_path, monkeypatch):
    """``main`` on the CPU at 64 px: one JSON line with the reference's
    metric, unit and fields; on the CPU ``vs_baseline`` is 1.0, as the
    reference sets it when the default device is the CPU."""
    monkeypatch.setattr(bench, "BASELINE_FILE", tmp_path / "bench_baseline.json")
    bench.main(["--frames", "2", "--img", "64", "--iters", "1", "--reps", "2", "--dtype", "f32", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "rgbd_detect_project_frames_per_sec_per_chip" and rec["unit"] == "frames/s"
    assert rec["value"] > 0 and rec["vs_baseline"] == 1.0 and len(rec["steady_samples_fps"]) == 2
    assert rec["gflop_per_frame"] > 0 and rec["device"] == "cpu" and "mfu_vs_bf16_peak" not in rec
    assert not (tmp_path / "bench_baseline.json").exists()


@pytest.mark.parametrize("module", [bench, bench_align, bench_e2e])
def test_benches_refuse_a_missing_card(module):
    """The benches run on the card unless ``device="cpu"``; without CUDA
    they raise before any work, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="not available"):
        module.run(device="cuda")


def test_stored_baseline_is_the_ports_own(tmp_path, monkeypatch):
    """``--cpu-baseline off`` reads the port's git-ignored store, merging
    the benches' keys; the JAX benches' BENCH_BASELINE.json is untouched."""
    store = tmp_path / "bench_baseline.json"
    monkeypatch.setattr(bench, "BASELINE_FILE", store)
    bench.store_baseline({"a": 1.0})
    bench.store_baseline({"b": 2.0})
    assert bench.read_baseline() == {"a": 1.0, "b": 2.0}
    assert bench.BASELINE_FILE.name != "BENCH_BASELINE.json"
    assert bench_align.read_baseline is bench.read_baseline and bench_e2e.store_baseline is bench.store_baseline


def test_build_clouds_byte_identical_to_the_reference():
    """The scene of ``bench_align.py`` from the port's sampler: every array
    and box byte for byte the reference's for the same seed."""
    for seed in (0, 3):
        got, want = bench_align.build_clouds(20_000, seed), jax_bench_align.build_clouds(20_000, seed)
        for i in (0, 1, 4):
            assert got[i].dtype == want[i].dtype and got[i].tobytes() == want[i].tobytes()
        for g, w in zip(got[2:4], want[2:4]):
            assert g.keys() == w.keys()
            for rg, rw in zip(g[0], w[0]):
                assert all(np.array_equal(a, b) for a, b in zip(rg[:4], rw[:4])) and rg[4:] == rw[4:]


def test_align_run_once_meets_the_sanity_check(tmp_path):
    """One capture at ~20k points on the CPU (17 sweeps of B2's twin at
    16384 × 32,768: the stages stop early): the recovered transform inverts
    the applied one (max|T·Tw − I| ≤ 0.15) and exactly one sign is
    missing."""
    scene = bench_align.build_clouds(20_000)
    align, rows = bench_align.run_once(scene, 30, CPU, str(tmp_path))
    check = bench_align.sanity(align, rows, scene[4])
    assert check["ok"], check
    assert os.path.exists(tmp_path / "bench_align_comparison.csv")


def test_e2e_two_scan_run_flags_one_missing_sign(monkeypatch):
    """One two-scan run of ``bench_e2e`` on the CPU (no warm-up, no steady
    reruns): exactly one missing sign, every stage timed, the committed
    artifacts' gates reported. The project is cut for the CPU as
    ``tests/test_torch_parallel_pipeline.py`` cuts it (3 frames a scan, 800
    cloud points/m², 4096 ICP points, 10 iterations a stage): the bench's
    own 16384 × 30 compare takes ~2 min on a CPU."""
    real = PE.make_project

    def small_project(root, yolo, beit, extra_cfg=None):
        cut = [("icp_max_points = 16384", "icp_max_points = 4096"), ("icp_iterations = 30", "icp_iterations = 10")]
        return real(root, yolo, beit, extra_cfg=(extra_cfg or []) + cut, num_frames=3, cloud_points_per_m2=800)

    monkeypatch.setattr(PE, "make_project", small_project)
    rec = bench_e2e.run(device="cpu", steady=False, warm_up=False)
    assert rec["metric"] == "e2e_two_scan_pipeline_seconds" and rec["unit"] == "s" and rec["value"] > 0
    assert rec["sanity"]["missing"] == 1 and rec["vs_baseline"] == 1.0
    assert {"gold.detect", "maint.compare"} <= set(rec["stage_times"])
    assert rec["full_scale_accuracy"]["ok"] and "hard_eval_full_accuracy" in rec


@pytest.mark.parametrize("change", [None, "placement", "missing"])
def test_full_scale_gate_copy_gives_the_reference_verdict(tmp_path, monkeypatch, change):
    """The port's copy of ``check_full_scale_report`` on the committed
    artifact and on copies pushed out of tolerance: the reference's
    verdict and fields."""
    rep = json.loads(open(bench_e2e.FULL_SCALE_REPORT).read())
    if change == "placement":
        key = next(iter(rep["placement_errors_m"]))
        rep["placement_errors_m"][key] = rep["placement_tolerance_m"] * 2
    elif change == "missing":
        rep["missing_flagged"] = rep["missing_expected"] + 1
    path = tmp_path / "full_scale.json"
    path.write_text(json.dumps(rep))
    monkeypatch.setattr(jax_bench_e2e, "FULL_SCALE_REPORT", str(path))
    want = jax_bench_e2e.check_full_scale_report()
    got = bench_e2e.check_full_scale_report(path)
    assert got == want and got["ok"] == (change is None)
