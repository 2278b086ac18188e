"""The port's serving watcher (``tpu3dlm_torch/pipeline/watch.py``): every
behaviour of the reference's ``tests/test_watch.py`` — discovery,
quiescence, sentinels, gold bootstrapping, retry and quarantine, the worker
pool, ``max_scans`` and a bounded ``close()`` — with ``setup_pipeline``
replaced by a fake, then one watcher run of the real Pipeline on the CPU."""

import json
import logging
import os
import threading
import time

import pytest
import torch

from tpu3dlm_torch import cli
from tpu3dlm_torch.pipeline import task
from tpu3dlm_torch.pipeline.watch import (
    DONE_SENTINEL,
    FAILED_SENTINEL,
    SUSPECT_SENTINEL,
    ScanWatcher,
    _folder_fingerprint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _make_capture(data_root: str, name: str) -> str:
    path = os.path.join(data_root, name)
    os.makedirs(os.path.join(path, "rtabmap_extract", "data_rgb"), exist_ok=True)
    with open(os.path.join(path, "poses.txt"), "w") as f:
        f.write("1.0 0 0 0 0 0 0 1 1\n")
    return path


class _FakePipeline:
    stage_times = {"detect": 0.1}
    data_to_save = {"predictions": {0: []}}


def _write_pickle(cfg):
    os.makedirs(os.path.dirname(cfg.pickle_path), exist_ok=True)
    with open(cfg.pickle_path, "wb") as f:
        f.write(b"x")


def _plant_gold_pickle(watcher):
    """The gold pickle exists, so a failing fake setup is the capture's
    fault, not the gold bootstrap's (gold failures defer)."""
    _write_pickle(watcher.cfg_goldstd)


def _ok_setup(calls=None):
    def setup(folder, cfg, cfg_goldstd=None, goldstd_var=None, device=None):
        assert device == torch.device("cpu")
        if calls is not None:
            calls.append(folder)
        _write_pickle(cfg)
        return _FakePipeline()

    return setup


@pytest.fixture
def watcher(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(task, "setup_pipeline", _ok_setup(calls))
    monkeypatch.setattr(task, "load_gold_std", lambda p: {"stub": True})
    w = ScanWatcher(str(tmp_path / "variables.cfg"), poll_interval=0.01, device="cpu")
    w._calls = calls
    return w


class TestScanWatcher:
    def test_quiescence_two_poll_claim(self, watcher):
        _make_capture(watcher.data_root, "scan_a")
        assert watcher.run_once() == []  # first sight: fingerprint recorded
        assert watcher.run_once() == ["scan_a"]

    def test_modified_folder_not_claimed(self, watcher):
        path = _make_capture(watcher.data_root, "scan_b")
        watcher.run_once()
        with open(os.path.join(path, "rtabmap_extract", "late.png"), "w") as f:
            f.write("more bytes")  # upload still in progress
        assert watcher.run_once() == []
        assert watcher.run_once() == ["scan_b"]

    def test_done_sentinel_skips_and_records(self, watcher):
        path = _make_capture(watcher.data_root, "scan_c")
        watcher.run_once()
        watcher.run_once()
        rec = json.load(open(os.path.join(path, DONE_SENTINEL)))
        assert rec["folder"] == "scan_c" and rec["frames"] == 1
        assert "wall_clock_s" in rec and rec["stage_times"] == {"detect": 0.1}
        assert watcher.run_once() == []  # never rerun

    def test_gold_std_bootstrapped_first(self, watcher):
        _make_capture(watcher.data_root, "maint")
        watcher.run_once()
        watcher.run_once()
        assert watcher._calls == ["gold_std", "maint"]

    def test_missing_count_recorded_and_suspect_quarantined(self, watcher, monkeypatch):
        """A maintenance run records its missing count; one whose
        registration fails the confidence gate gets the SUSPECT sentinel
        with the verdict instead of DONE, and counts as handled."""
        verdicts = {"ok_scan": {"ok": True, "reasons": []},
                    "bad_scan": {"ok": False, "reasons": ["low_overlap"]}}

        def setup(folder, cfg, cfg_goldstd=None, goldstd_var=None, device=None):
            p = _FakePipeline()
            p.data_to_save = {"predictions": {0: [], 1: []}, "alignment_verdict": verdicts[folder],
                              "comparison_rows": [{"status": "missing"}, {"status": "matched"}]}
            return p

        _plant_gold_pickle(watcher)
        monkeypatch.setattr(task, "setup_pipeline", setup)
        ok, bad = (_make_capture(watcher.data_root, n) for n in ("ok_scan", "bad_scan"))
        watcher.run_once()
        assert sorted(watcher.run_once()) == ["bad_scan", "ok_scan"]
        assert json.load(open(os.path.join(ok, DONE_SENTINEL)))["missing"] == 1
        rec = json.load(open(os.path.join(bad, SUSPECT_SENTINEL)))
        assert rec["alignment_verdict"]["reasons"] == ["low_overlap"] and rec["frames"] == 2
        assert not os.path.exists(os.path.join(bad, DONE_SENTINEL))
        assert watcher.suspect == ["bad_scan"] and sorted(watcher.processed) == ["bad_scan", "ok_scan"]
        assert watcher.run_once() == []

    def test_failure_quarantined(self, watcher, monkeypatch):
        def boom(folder, cfg, cfg_goldstd=None, goldstd_var=None, device=None):
            raise RuntimeError("corrupt capture")

        _plant_gold_pickle(watcher)
        monkeypatch.setattr(task, "setup_pipeline", boom)
        watcher.max_attempts = 1
        path = _make_capture(watcher.data_root, "scan_bad")
        watcher.run_once()
        assert watcher.run_once() == ["scan_bad"]
        assert "corrupt capture" in open(os.path.join(path, FAILED_SENTINEL)).read()
        assert watcher.run_once() == []

    def test_transient_failure_retried_before_quarantine(self, watcher, monkeypatch):
        boom_calls = []

        def boom(folder, cfg, cfg_goldstd=None, goldstd_var=None, device=None):
            boom_calls.append(folder)
            raise RuntimeError("tunnel blip")

        _plant_gold_pickle(watcher)
        monkeypatch.setattr(task, "setup_pipeline", boom)
        watcher.max_attempts = 2
        path = _make_capture(watcher.data_root, "scan_flaky")
        watcher.run_once()
        assert watcher.run_once() == []  # attempt 1 fails, no sentinel yet
        assert not os.path.exists(os.path.join(path, FAILED_SENTINEL))
        assert watcher.run_once() == []  # inside the backoff window
        assert boom_calls == ["scan_flaky"]
        time.sleep(watcher.poll_interval * 4 + 0.05)
        assert watcher.run_once() == ["scan_flaky"]  # attempt 2 → quarantine
        assert os.path.exists(os.path.join(path, FAILED_SENTINEL))
        assert boom_calls == ["scan_flaky", "scan_flaky"]

    def test_transient_failure_recovers(self, watcher, monkeypatch):
        real_setup = task.setup_pipeline
        state = {"failed": False}

        def flaky(folder, cfg, cfg_goldstd=None, goldstd_var=None, device=None):
            if not state["failed"]:
                state["failed"] = True
                raise RuntimeError("one-off blip")
            return real_setup(folder, cfg, cfg_goldstd, goldstd_var=goldstd_var, device=device)

        _plant_gold_pickle(watcher)
        monkeypatch.setattr(task, "setup_pipeline", flaky)
        path = _make_capture(watcher.data_root, "scan_recover")
        watcher.run_once()
        assert watcher.run_once() == []
        time.sleep(watcher.poll_interval * 4 + 0.05)
        assert watcher.run_once() == ["scan_recover"]
        assert os.path.exists(os.path.join(path, DONE_SENTINEL))
        assert not os.path.exists(os.path.join(path, FAILED_SENTINEL))
        assert "scan_recover" not in watcher._attempts

    def test_gold_failure_defers_maintenance_not_quarantines(self, watcher, monkeypatch):
        _plant_gold_pickle(watcher)

        def bad_load(p):
            raise RuntimeError("gold pickle unreadable")

        monkeypatch.setattr(task, "load_gold_std", bad_load)
        path = _make_capture(watcher.data_root, "maint_ok")
        watcher.run_once()
        assert watcher.run_once() == []  # deferred, not quarantined
        assert not os.path.exists(os.path.join(path, FAILED_SENTINEL))
        assert "maint_ok" not in watcher._attempts
        monkeypatch.setattr(task, "load_gold_std", lambda p: {"stub": True})
        assert watcher.run_once() == ["maint_ok"]
        assert os.path.exists(os.path.join(path, DONE_SENTINEL))

    def test_corrupt_gold_pickle_defers_not_done(self, watcher, monkeypatch):
        _plant_gold_pickle(watcher)
        monkeypatch.setattr(task, "load_gold_std", lambda p: None)
        path = _make_capture(watcher.data_root, "maint_x")
        watcher.run_once()
        assert watcher.run_once() == []
        assert not os.path.exists(os.path.join(path, DONE_SENTINEL))
        assert not os.path.exists(os.path.join(path, FAILED_SENTINEL))
        monkeypatch.setattr(task, "load_gold_std", lambda p: {"stub": True})
        assert watcher.run_once() == ["maint_x"]
        assert os.path.exists(os.path.join(path, DONE_SENTINEL))

    def test_quarantined_gold_warns_once_and_defers(self, watcher, caplog):
        gold = _make_capture(watcher.data_root, "gold_std")
        with open(os.path.join(gold, FAILED_SENTINEL), "w") as f:
            f.write("boom")
        path = _make_capture(watcher.data_root, "maint_late")
        watcher.run_once()
        with caplog.at_level(logging.WARNING, logger="tpu3dlm_torch.pipeline.watch"):
            assert watcher.run_once() == []
            assert watcher.run_once() == []
        assert sum("QUARANTINED" in r.getMessage() for r in caplog.records) == 1
        assert not os.path.exists(os.path.join(path, FAILED_SENTINEL))

    def test_max_scans_bounds_run(self, watcher):
        _make_capture(watcher.data_root, "s1")
        _make_capture(watcher.data_root, "s2")
        watcher.max_scans = 1
        watcher.run_once()
        watcher.run()  # returns after 1 scan
        assert len(watcher.processed) == 1

    def test_fingerprint_tracks_content(self, tmp_path):
        p = _make_capture(str(tmp_path), "x")
        f1 = _folder_fingerprint(p)
        with open(os.path.join(p, "poses.txt"), "a") as f:
            f.write("2.0 0 0 0 0 0 0 1 2\n")
        assert _folder_fingerprint(p) != f1


class TestGoldBootstrapSafety:
    def test_maintenance_deferred_until_watched_gold_processed(self, watcher):
        _make_capture(watcher.data_root, "maint")
        assert watcher.run_once() == []
        _make_capture(watcher.data_root, "gold_std")  # gold lands later
        assert watcher.run_once() == []  # maint quiescent, but gold blocks it
        assert not os.path.exists(os.path.join(watcher.data_root, "maint", DONE_SENTINEL))
        assert watcher.run_once() == ["gold_std", "maint"]
        assert watcher._calls == ["gold_std", "maint"]


class TestConcurrentWatcher:
    def _watcher(self, tmp_path, monkeypatch, setup, concurrency=2):
        monkeypatch.setattr(task, "setup_pipeline", setup)
        monkeypatch.setattr(task, "load_gold_std", lambda p: {"stub": True})
        return ScanWatcher(str(tmp_path / "variables.cfg"), poll_interval=0.01, concurrency=concurrency,
                           device="cpu")

    def test_two_captures_overlap_and_complete(self, tmp_path, monkeypatch):
        """Both captures are inside setup_pipeline at once (a serial watcher
        would break the barrier); both get DONE."""
        barrier = threading.Barrier(2, timeout=10)
        inner = _ok_setup()

        def setup(folder, cfg, cfg_goldstd=None, goldstd_var=None, device=None):
            barrier.wait()
            return inner(folder, cfg, cfg_goldstd, goldstd_var, device)

        w = self._watcher(tmp_path, monkeypatch, setup)
        _plant_gold_pickle(w)
        a, b = (_make_capture(w.data_root, n) for n in ("scan_a", "scan_b"))
        assert w.run_once() == []
        assert w.run_once() == []  # both submitted
        assert sorted(w.drain()) == ["scan_a", "scan_b"]
        for path in (a, b):
            assert os.path.exists(os.path.join(path, DONE_SENTINEL))
        assert w.run_once() == []
        w.close()

    def test_gold_runs_alone_before_maintenance(self, tmp_path, monkeypatch):
        calls = []
        w = self._watcher(tmp_path, monkeypatch, _ok_setup(calls))
        for n in ("gold_std", "maint_a", "maint_b"):
            _make_capture(w.data_root, n)
        assert w.run_once() == []
        assert w.run_once() == ["gold_std"] and calls[0] == "gold_std"
        w.drain()
        assert sorted(calls[1:]) == ["maint_a", "maint_b"]
        for f in ("gold_std", "maint_a", "maint_b"):
            assert os.path.exists(os.path.join(w.data_root, f, DONE_SENTINEL))
        w.close()

    def test_worker_failure_quarantined(self, tmp_path, monkeypatch):
        def boom(folder, cfg, cfg_goldstd=None, goldstd_var=None, device=None):
            raise RuntimeError("bad capture")

        w = self._watcher(tmp_path, monkeypatch, boom)
        w.max_attempts = 1
        _plant_gold_pickle(w)
        path = _make_capture(w.data_root, "scan_bad")
        w.run_once()
        w.run_once()
        assert w.drain() == ["scan_bad"]
        assert "bad capture" in open(os.path.join(path, FAILED_SENTINEL)).read()
        assert w.run_once() == []
        w.close()

    def test_stress_many_captures_mixed_outcomes(self, tmp_path, monkeypatch):
        """4 workers × 12 captures, interleaved failures: every capture ends
        with exactly one sentinel, none lost, none processed twice."""
        counts: dict[str, int] = {}
        lock = threading.Lock()

        def setup(folder, cfg, cfg_goldstd=None, goldstd_var=None, device=None):
            with lock:
                counts[folder] = counts.get(folder, 0) + 1
            if folder.endswith(("3", "7")):
                raise RuntimeError(f"{folder} corrupt")
            _write_pickle(cfg)
            return _FakePipeline()

        w = self._watcher(tmp_path, monkeypatch, setup, concurrency=4)
        w.max_attempts = 1
        names = [f"scan_{i:02d}" for i in range(12)]
        _plant_gold_pickle(w)
        for n in names:
            _make_capture(w.data_root, n)
        w.run_once()
        for _ in range(20):
            w.run_once()
            w.drain()
            if all(os.path.exists(os.path.join(w.data_root, n, s)) for n in names
                   for s in [DONE_SENTINEL if not n.endswith(("3", "7")) else FAILED_SENTINEL]):
                break
        for n in names:
            done = os.path.exists(os.path.join(w.data_root, n, DONE_SENTINEL))
            failed = os.path.exists(os.path.join(w.data_root, n, FAILED_SENTINEL))
            assert done != failed and failed == n.endswith(("3", "7")), n
            assert counts[n] == 1, n
        assert sorted(w.processed) == [n for n in names if not n.endswith(("3", "7"))]
        w.close()

    def test_concurrency_respects_max_scans_and_close_leaks_no_threads(self, tmp_path, monkeypatch):
        calls = []
        before = threading.active_count()
        w = self._watcher(tmp_path, monkeypatch, _ok_setup(calls))
        w.max_scans = 2
        _plant_gold_pickle(w)
        for name in ("s1", "s2", "s3"):
            _make_capture(w.data_root, name)
        w.run()  # drains and closes
        assert len(w.processed) == 2 and len(calls) == 2
        assert sum(os.path.exists(os.path.join(w.data_root, f, DONE_SENTINEL)) for f in ("s1", "s2", "s3")) == 2
        assert w._pool is None and threading.active_count() == before


class TestEntryPoints:
    def test_cli_watch_flag_runs_service(self, tmp_path, monkeypatch):
        """``cli --watch --max-scans N --device cpu`` serves until N captures
        are processed."""
        monkeypatch.setattr(task, "setup_pipeline", _ok_setup())
        monkeypatch.setattr(task, "load_gold_std", lambda p: {"stub": True})
        monkeypatch.chdir(tmp_path)
        cfg_path = str(tmp_path / "configs" / "variables.cfg")
        w = ScanWatcher(cfg_path, poll_interval=0.01, device="cpu")  # learns the data root
        _make_capture(w.data_root, "scan_cli")
        cli.main(["--config", cfg_path, "--watch", "--poll-interval", "0.01", "--max-scans", "1",
                  "--watch-concurrency", "2", "--device", "cpu"])
        assert os.path.exists(os.path.join(w.data_root, "scan_cli", DONE_SENTINEL))

    def test_watch_main(self, tmp_path, monkeypatch):
        monkeypatch.setattr(task, "setup_pipeline", _ok_setup())
        monkeypatch.setattr(task, "load_gold_std", lambda p: {"stub": True})
        from tpu3dlm_torch.pipeline import watch

        cfg_path = str(tmp_path / "variables.cfg")
        w = ScanWatcher(cfg_path, device="cpu")
        _make_capture(w.data_root, "scan_main")
        watch.main(["--config", cfg_path, "--poll", "0.01", "--max-scans", "1", "--device", "cpu"])
        assert os.path.exists(os.path.join(w.data_root, "scan_main", DONE_SENTINEL))

    def test_watch_main_is_the_cli_watch(self, tmp_path, monkeypatch):
        """``python -m tpu3dlm_torch.pipeline.watch`` runs ``cli.py
        --watch`` with its flags: with ``mesh_devices = 2`` the CLI spawns
        the two ranks (tests/test_torch_watch_world.py runs that for real),
        and in one process ``--max-attempts`` reaches the watcher."""
        import chip_smoke
        from tpu3dlm_torch.parallel import mesh as PM
        from tpu3dlm_torch.pipeline import watch

        cfg = chip_smoke.write_config(str(tmp_path / "world"), [("mesh_devices = 1", "mesh_devices = 2")])
        spawned = []
        monkeypatch.setattr(PM, "spawn_world", lambda fn, n, **kw: spawned.append((fn, n, kw)))
        watch.main(["--config", cfg, "--poll", "0.01", "--max-scans", "1", "--max-attempts", "2", "--device", "cpu"])
        assert spawned == [(cli._rank_main, 2, dict(device=torch.device("cpu"), args=([
            "--watch", "--config", cfg, "--poll-interval", "0.01", "--max-attempts", "2",
            "--watch-concurrency", "1", "--device", "cpu", "--max-scans", "1"],)))]

        built = []
        monkeypatch.setattr(watch.ScanWatcher, "run", lambda self: built.append(self))
        one = chip_smoke.write_config(str(tmp_path / "one"), [])
        watch.main(["--config", one, "--poll", "0.5", "--max-attempts", "5", "--concurrency", "2", "--device", "cpu"])
        (w,) = built
        assert (w.poll_interval, w.max_attempts, w.concurrency, w.max_scans, w.world) == (0.5, 5, 2, None, None)

    def test_cuda_is_the_default_device(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("this host has a GPU: the default device resolves")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ScanWatcher(str(tmp_path / "variables.cfg"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--config", str(tmp_path / "variables.cfg"), "--watch", "--max-scans", "1"])


def test_real_pipeline_watcher_run(tmp_path):
    """The watcher over the committed capture with the real Pipeline on the
    CPU (fused route, f32, fixture checkpoints, ``scan_cache = true``; ICP
    on 1024 query points for 5 iterations a stage, to keep the CPU compare
    short): gold first, then maintenance; both get DONE with their stage
    times, the maintenance record one missing sign, and the watcher leaves
    no thread."""
    import chip_smoke

    chip_smoke.copy_project(str(tmp_path))
    cfg = chip_smoke.pipeline_config(str(tmp_path), [
        ("infer_dtype = bf16", "infer_dtype = f32"), ("scan_cache = false", "scan_cache = true"),
        ("icp_max_points = 16384", "icp_max_points = 1024"), ("icp_iterations = 30", "icp_iterations = 5"),
        ("yolo_weights =", f"yolo_weights = {FIXTURES}/yolo_synthetic.msgpack"),
        ("beit_weights =", f"beit_weights = {FIXTURES}/beit_synthetic.msgpack")])
    before = threading.active_count()
    w = ScanWatcher(cfg, poll_interval=0.01, max_scans=2, device="cpu")
    w.run()
    assert w.processed == ["gold_std", "maintenance"] and threading.active_count() == before
    recs = {f: json.load(open(os.path.join(w.data_root, f, DONE_SENTINEL))) for f in w.processed}
    assert recs["maintenance"]["missing"] == 1 and recs["maintenance"]["frames"] == 5
    assert list(recs["maintenance"]["stage_times"]) == ["extract", "detect", "map", "compare"]
    assert "missing" not in recs["gold_std"]
    for f in w.processed:
        assert os.path.exists(os.path.join(w.data_root, f, "rtabmap_extract", "scan_128.pack"))
