"""Jobs over a world of ranks (``tpu3dlm_torch/parallel/mesh.py::JobWorld``)
and the watcher on them (``pipeline/watch.py``), on a 2-rank gloo world on
the CPU that the module spawns once (tests/torch_parallel_legs.py holds the
ranks' legs): a rank that fails a job releases the other from the job's
collectives within seconds, not at the world's timeout (120 s here), and
the world stays in step for the next job; the watcher retries a capture
that failed on rank 1 and quarantines one that keeps failing, as the
one-process watcher does; rank 1 writes nothing and builds the gold cache
once; and the fused runner shards a scan whose frame count the world does
not divide (a fault of the port, ROADMAP §C)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
import torch_parallel_legs as legs
from tpu3dlm_torch.parallel import mesh as PM
from tpu3dlm_torch.pipeline.watch import DONE_SENTINEL, FAILED_SENTINEL

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
WORLD_TIMEOUT_S = 120.0
RELEASE_S = 15.0  # a failed job ends on every rank within this, far inside the timeout


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """The committed capture with two more maintenance captures, at the
    parity configuration (fixture checkpoints, fused route, f32) on 2
    ranks, the ICP cut to 1024 query points and 5 iterations a stage."""
    root = str(tmp_path_factory.mktemp("watch"))
    data = chip_smoke.copy_project(root)
    for name in ("maint_bad", "maint_flaky"):
        shutil.copytree(os.path.join(data, "maintenance"), os.path.join(data, name))
    cfg = chip_smoke.pipeline_config(root, [
        ("infer_dtype = bf16", "infer_dtype = f32"), ("mesh_devices = 1", "mesh_devices = 2"),
        ("icp_max_points = 16384", "icp_max_points = 1024"), ("icp_iterations = 30", "icp_iterations = 5"),
        ("yolo_weights =", f"yolo_weights = {FIXTURES}/yolo_synthetic.msgpack"),
        ("beit_weights =", f"beit_weights = {FIXTURES}/beit_synthetic.msgpack")])
    return dict(config=cfg, data=data)


@pytest.fixture(scope="module")
def world(capture):
    todo = {"job_world_faults": {}, "job_world_threads": {}, "odd_frame_step": {},
            "watch_world_faults": dict(config=capture["config"], flaky="maint_flaky", bad="maint_bad")}
    return PM.spawn_world(legs.run, 2, device="cpu", timeout_s=WORLD_TIMEOUT_S, args=(todo,))


def test_a_failed_job_releases_every_rank_and_the_world_goes_on(world):
    """Each failing job raises ``JobFailed`` on rank 0 with the failing
    rank's error first, ends within 15 s whichever rank failed and wherever
    (before any collective, after a gather, between two), and the next job
    gives the right sums on both ranks: the collective a rank still owed
    was reissued, so the group is in step."""
    runs = world[0]["job_world_faults"]["runs"]
    assert world[1]["job_world_faults"]["followed"] == len(runs) == 7
    for r in runs:
        assert r["seconds"] < RELEASE_S, r
        if r["job"] == "ok":
            assert r["out"] == [3.0, 3.0] and r["errors"] is None
            continue
        assert r["out"] is None and len(r["errors"]) == 2
        culprit = 0 if r["job"].startswith("rank0") else 1
        assert r["errors"][0].startswith(f"rank {culprit}:") and "ValueError" in r["errors"][0]
        assert r["errors"][1].startswith(f"rank {1 - culprit}:") and "JobAborted" in r["errors"][1]


@pytest.mark.cuda
def test_a_failed_job_on_nccl_releases_every_rank_and_the_world_goes_on():
    """The same jobs on two ranks over NCCL, one card each, where the
    watchdog aborts the jobs' group: each failing job raises ``JobFailed``
    on rank 0 with the failing rank's error first and ends within 15 s
    (a rank the abort released may finish its job with what the collective
    left, or raise), and the next job gives the right sums on the group the
    ranks made anew."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: NCCL runs one rank per card")
    got = PM.spawn_world(legs.run, 2, device="cuda", timeout_s=WORLD_TIMEOUT_S, args=({"job_world_faults": {}},))
    runs = got[0]["job_world_faults"]["runs"]
    assert got[1]["job_world_faults"]["followed"] == len(runs) == 7
    for r in runs:
        assert r["seconds"] < RELEASE_S, r
        if r["job"] == "ok":
            assert r["out"] == [3.0, 3.0] and r["errors"] is None
            continue
        culprit = 0 if r["job"].startswith("rank0") else 1
        assert r["out"] is None and 1 <= len(r["errors"]) <= 2
        assert r["errors"][0].startswith(f"rank {culprit}:") and "ValueError" in r["errors"][0]
        assert all(e.startswith(f"rank {1 - culprit}:") for e in r["errors"][1:])


def test_the_nccl_watchdog_aborts_the_jobs_group_once_the_job_is_marked_failed(monkeypatch):
    """NCCL's release, on stand-ins for the group (the CPU has no NCCL):
    ``JobWorld._watch`` leaves the jobs' group alone while the job runs,
    aborts it once the job is marked failed and marks the job aborted, so
    the rank's next collective raises ``JobAborted``; it stops without an
    abort when the job ends first. ``_renew`` aborts the group unless the
    watchdog did, and makes a new one."""
    import threading
    import time

    import torch.distributed as dist

    aborted, made = [], []
    monkeypatch.setattr(dist.distributed_c10d, "_abort_process_group", aborted.append)
    monkeypatch.setattr(dist, "new_group", lambda **kw: made.append(kw) or f"group {len(made)}")
    world = PM.JobWorld.__new__(PM.JobWorld)
    world._group = "group 0"
    marked = threading.Event()
    state = PM._Job(marked.is_set, polled=False)
    watchdog = threading.Thread(target=world._watch, args=(state, threading.Event()))
    watchdog.start()
    time.sleep(3 * PM._WATCH_S)
    assert aborted == [] and not state.aborted.is_set()
    marked.set()
    watchdog.join(timeout=5)
    assert not watchdog.is_alive() and aborted == ["group 0"] and state.aborted.is_set()
    with pytest.raises(PM.JobAborted):
        PM.Mesh(None, 0, 1, torch.device("cpu"), "nccl", job=state).all_reduce(torch.ones(1))
    world._renew(state)
    assert aborted == ["group 0"] and made == [dict(backend="nccl")] and world._group == "group 1"

    ended, done = PM._Job(lambda: False, polled=False), threading.Event()
    watchdog = threading.Thread(target=world._watch, args=(ended, done))
    watchdog.start()
    done.set()
    watchdog.join(timeout=5)
    assert not watchdog.is_alive() and not ended.aborted.is_set()
    world._renew(ended)
    assert aborted == ["group 0", "group 1"] and world._group == "group 2"


def test_jobs_posted_by_many_threads_run_one_at_a_time(world):
    """8 threads of rank 0 post 5 jobs each at once (switch interval 1 µs):
    every job returns its own sum, 2·(2·job + 1), no thread is left, and
    rank 1 ran all 40 (the lock keeps two jobs' collectives apart)."""
    got = world[0]["job_world_threads"]
    assert got["alive"] == 0 and world[1]["job_world_threads"]["followed"] == 40
    want = {f"{k}.{j}": 2.0 * (2.0 * (100 * k + j) + 1.0) for k in range(got["threads"]) for j in range(got["jobs"])}
    assert got["got"] == want


def test_the_watcher_retries_and_quarantines_as_in_one_process(world, capture):
    """``maint_flaky`` fails on rank 1 once, is retried on every rank and
    gets DONE; ``maint_bad`` fails on rank 1 at both of its 2 attempts and
    is quarantined with rank 1's traceback; ``gold_std`` and
    ``maintenance`` get DONE with one missing sign; each failed attempt
    ends within 15 s; rank 1 ran every job rank 0 posted."""
    got = world[0]["watch_world_faults"]
    data = capture["data"]
    assert sorted(got["processed"]) == ["gold_std", "maint_flaky", "maintenance"]
    tries = [f for f, _ in got["jobs"]]
    assert tries.count("maint_bad") == 2 and tries.count("maint_flaky") == 2 and tries[0] == "gold_std"
    assert world[1]["watch_world_faults"]["followed"] == len(tries)
    bad = open(os.path.join(data, "maint_bad", FAILED_SENTINEL)).read()
    assert "rank 1 cannot read maint_bad" in bad and bad.index("rank 1:") < bad.index("rank 0:")
    assert not os.path.exists(os.path.join(data, "maint_bad", DONE_SENTINEL))
    for f in ("maintenance", "maint_flaky"):
        assert json.load(open(os.path.join(data, f, DONE_SENTINEL)))["missing"] == 1
    assert max(s for f, s in got["jobs"] if f == "maint_bad") < RELEASE_S
    assert open(os.path.join(data, "maint_flaky", "comparison_output.csv")).read() == \
        open(os.path.join(data, "maintenance", "comparison_output.csv")).read()


def test_rank_0_alone_writes_and_each_rank_builds_the_gold_cache_once(world):
    """Rank 1 opens nothing for writing under the data root (frames,
    pickles, CSVs and sentinels are rank 0's); rank 0 writes each
    processed capture's pickle and CSV; each rank builds the gold moments
    once for its three compares."""
    ranks = [world[r]["watch_world_faults"] for r in (0, 1)]
    assert ranks[1]["writes"] == []
    written = set(ranks[0]["writes"])
    for f in ("maintenance", "maint_flaky"):
        assert os.path.join(f, "comparison_output.csv") in written
        assert os.path.join(f, DONE_SENTINEL) in written
    assert [r["gold_builds"] for r in ranks] == [1, 1]


def test_the_runner_broadcasts_cached_models_once_per_group(monkeypatch):
    """The Pipeline builds a fused runner per capture over the models it
    caches: in a 1-rank gloo world the runner broadcasts them the first
    time only, on the world's group and on a job's mesh of that group
    alike, and again on a new group (as after a failed NCCL job)."""
    import torch.distributed as dist

    from tpu3dlm_torch.models.beit import BeitConfig, seeded_beit
    from tpu3dlm_torch.models.layers import init_seeded_
    from tpu3dlm_torch.models.yolov10 import YOLOv10
    from tpu3dlm_torch.pipeline import fused as PF

    sent = []
    real = PF.replicate
    monkeypatch.setattr(PF, "replicate", lambda model, mesh: sent.append(model) or real(model, mesh))
    cfg = BeitConfig(image_size=32, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, num_labels=2)
    yolo = init_seeded_(YOLOv10(nc=3, variant="n"), torch.Generator().manual_seed(0))
    beit = seeded_beit(cfg, torch.Generator().manual_seed(1))
    kw = dict(img_size=64, nc=3, beit_config=cfg, yolo=yolo, beit=beit, dtype=torch.float32, device="cpu")
    mesh = PM.make_mesh(1, device="cpu", backend="gloo")
    try:
        PF.FusedScanRunner(mesh=mesh, **kw)
        PF.FusedScanRunner(mesh=mesh, **kw)
        PF.FusedScanRunner(mesh=PM.Mesh(mesh.group, 0, 1, mesh.device, "gloo"), **kw)
        assert [id(m) for m in sent] == [id(yolo), id(beit)]
        renewed = dist.new_group(backend="gloo")
        PF.FusedScanRunner(mesh=PM.Mesh(renewed, 0, 1, mesh.device, "gloo"), **kw)
        assert [id(m) for m in sent] == [id(yolo), id(beit)] * 2
    finally:
        mesh.close()


def test_a_scan_the_world_does_not_divide_shards_as_on_one_device(world):
    """Five frames over two ranks (the world pads one inert frame): every
    rank's records equal the one-device runner's, masks, labels and
    damage exactly, boxes and corners within 1e-4 (ROADMAP §C: the
    reference's zero padding crashed the port's depth gather)."""
    for r in (0, 1):
        got = world[r]["odd_frame_step"]
        a, b = got["world"], got["one"]
        assert a["boxes"].shape[0] == 5
        for k in ("mask", "label", "damage"):
            np.testing.assert_array_equal(a[k], b[k])
        for k in ("boxes", "conf", "corners"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4)
        assert (a["damage"] >= 0).any()
