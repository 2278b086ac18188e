"""Serving mode: watch a data root and run each capture as it lands (port
of ``tpu3dlm/pipeline/watch.py``).

``ScanWatcher(config_path, ..., device=...)`` turns the one-shot Pipeline
into a long-running service on one device:

- it polls the data root for capture folders (``poses.txt`` plus an
  ``rtabmap_extract`` tree) and claims a folder only after its fingerprint
  (file count, bytes, max mtime) is equal across two polls, so an upload in
  progress is never half-ingested;
- ``gold_std`` runs first when its pickle is missing (the CLI's mode
  logic), then each new folder runs as a maintenance check against it; a
  watched ``gold_std`` folder that is not processed yet defers the
  maintenance captures instead of bootstrapping from a partial upload, and
  a quarantined one is warned about once;
- completion writes ``.tpu3dlm_done`` (JSON: wall clock, per-stage times,
  frames, missing count), so a restart skips processed captures;
- a failure retries with exponential backoff (``max_attempts``) and then
  quarantines the capture with ``.tpu3dlm_failed`` and the traceback;
- a failure of the shared gold baseline (bootstrap error, unreadable gold
  pickle) defers the maintenance capture, unpenalised, and never
  quarantines it;
- a capture whose registration fails the confidence gate
  (``RegistrationVerdict``) is quarantined with
  ``.tpu3dlm_alignment_suspect`` and the verdict, so a bad registration
  never publishes its MISSING rows as findings;
- ``concurrency > 1`` runs maintenance captures on a pool of worker
  threads, all issuing work on the device's default stream, which keeps
  the shared gold and index caches ordered on the device; ``gold_std``
  always runs alone. ``close()`` drains and joins the pool.

The device is resolved when the watcher is built: ``device="cuda"`` (the
default) raises without a card; pass ``device="cpu"`` for the CPU.

Over a world of ranks (``mesh_devices = N``, the reference's watcher on
its mesh), every rank calls ``serve_world``: rank 0 alone watches the data
root, with all of the above, and runs each capture's Pipeline as a job of a
``parallel.mesh.JobWorld``: the job (the folder, and for a maintenance
capture the gold baseline rank 0 read) goes to every rank, and every rank
runs the Pipeline on the job's mesh (the fused step sharded by frames, the
compare's ICP by queries); rank 0 alone writes the pickle, the CSV and the
sentinel. Jobs run one at a time across the world: with ``concurrency >
1`` rank 0's worker threads take turns at the world (``JobWorld.run``
holds a lock), so two captures' collectives never interleave, and the
threads overlap only rank 0's own host work. A capture that fails on any
rank fails on rank 0, which retries or quarantines it as above; the other
ranks are released from the capture's collectives at once and run the
retry when rank 0 posts it. When rank 0 stops (``max_scans``, an error, an
interrupt) it stops every rank, and each leaves the world. The gold and
anchor-index caches of ``alignment/align.py`` are keyed by the rank, not
the capture, so each rank builds them once.
"""

from __future__ import annotations

import json
import logging
import os
import time
import traceback

import torch

from tpu3dlm_torch.device import resolve_device

DONE_SENTINEL = ".tpu3dlm_done"
FAILED_SENTINEL = ".tpu3dlm_failed"
# the capture was processed but its alignment failed the confidence gate:
# retrying cannot help (the verdict is deterministic), an operator reviews it
SUSPECT_SENTINEL = ".tpu3dlm_alignment_suspect"


def _folder_fingerprint(path: str) -> tuple:
    """(file count, total bytes, max mtime) over the capture tree: a cheap
    stability probe for uploads in progress."""
    count, total, mtime = 0, 0, 0.0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                st = os.stat(os.path.join(root, f))
            except OSError:
                continue
            count += 1
            total += st.st_size
            mtime = max(mtime, st.st_mtime)
    return count, total, mtime


def _is_capture(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "poses.txt")) and os.path.isdir(
        os.path.join(path, "rtabmap_extract"))


class ScanWatcher:
    """Poll ``data_root`` and run the maintenance pipeline on new captures.

    Parameters
    ----------
    config_path: variables.cfg path (written with defaults if absent).
    poll_interval: seconds between directory scans.
    max_scans: stop after this many processed captures (None = forever).
    max_attempts: failures tolerated per capture before quarantine.
    concurrency: captures processed at once.
    device: where every Pipeline runs.
    world: a ``parallel.mesh.JobWorld`` (rank 0's) to run every Pipeline
        on every rank of; its mesh's device replaces ``device``, and the
        config's ``mesh_devices`` must be its size.
    """

    def __init__(
        self,
        config_path: str,
        poll_interval: float = 5.0,
        max_scans: int | None = None,
        max_attempts: int = 3,
        concurrency: int = 1,
        device: str | torch.device = "cuda",
        world=None,
    ):
        from tpu3dlm_torch.utils.config import ConfigLoader, write_default_config

        self.world = world
        self.device = world.mesh.device if world is not None else resolve_device(device)
        if not os.path.exists(config_path):
            write_default_config(config_path)
        self.config_path = config_path
        self.poll_interval = poll_interval
        self.max_scans = max_scans
        self.max_attempts = max(1, max_attempts)
        self.concurrency = max(1, int(concurrency))
        self._pool = None
        self._inflight: dict = {}  # folder → Future
        self._loader = ConfigLoader
        self.cfg_goldstd = ConfigLoader(config_path, "gold_std")
        self.data_root = os.path.dirname(os.path.dirname(self.cfg_goldstd.pose_path))
        self.logger = logging.getLogger(__name__)
        self._pending_fp: dict[str, tuple] = {}
        self._attempts: dict[str, int] = {}
        self._retry_after: dict[str, float] = {}
        self._warned_gold_failed = False
        self.processed: list[str] = []
        self.suspect: list[str] = []
        n = getattr(self.cfg_goldstd, "mesh_devices", 1)
        if world is not None and n != world.mesh.size:
            raise ValueError(f"the world has {world.mesh.size} ranks, the config's mesh_devices is {n}")

    # -- discovery ---------------------------------------------------------

    def _ready_folders(self) -> list[str]:
        """Capture folders that are complete, unprocessed and quiescent."""
        ready = []
        if not os.path.isdir(self.data_root):
            return ready
        for name in sorted(os.listdir(self.data_root)):
            path = os.path.join(self.data_root, name)
            if not os.path.isdir(path) or not _is_capture(path):
                continue
            if any(os.path.exists(os.path.join(path, s))
                   for s in (DONE_SENTINEL, FAILED_SENTINEL, SUSPECT_SENTINEL)):
                continue
            if name in self._inflight:
                continue
            if time.monotonic() < self._retry_after.get(name, 0.0):
                continue  # failed recently: backing off
            fp = _folder_fingerprint(path)
            if self._pending_fp.get(name) == fp:
                ready.append(name)
            self._pending_fp[name] = fp
        return ready

    # -- processing --------------------------------------------------------

    def _gold_pending(self) -> bool:
        """True when the gold baseline must come from a watched ``gold_std``
        folder that has not finished processing: bootstrapping from a half-
        uploaded gold folder would bake a partial capture into the baseline,
        so maintenance captures wait for quiescent discovery to claim it."""
        if os.path.exists(self.cfg_goldstd.pickle_path):
            return False
        gold_path = os.path.join(self.data_root, "gold_std")
        pending = (os.path.isdir(gold_path) and _is_capture(gold_path)
                   and not os.path.exists(os.path.join(gold_path, DONE_SENTINEL)))
        if pending and os.path.exists(os.path.join(gold_path, FAILED_SENTINEL)):
            if not self._warned_gold_failed:
                self.logger.warning(
                    "gold_std capture is QUARANTINED (%s) — every maintenance scan is deferred "
                    "until the sentinel is cleared and gold_std reprocesses",
                    os.path.join(gold_path, FAILED_SENTINEL))
                self._warned_gold_failed = True
        else:
            self._warned_gold_failed = False
        return pending

    def _ensure_gold(self):
        """Bootstrap the gold baseline from the configured gold data folder
        (reached only when gold data is not a watched capture folder)."""
        from tpu3dlm_torch.pipeline import task

        if not os.path.exists(self.cfg_goldstd.pickle_path):
            self.logger.info("gold_std pickle absent — running setup pipeline")
            self._run_pipeline("gold_std", self.cfg_goldstd)

    def _run_pipeline(self, folder: str, cfg, cfg_goldstd=None, goldstd_var=None):
        """One capture's Pipeline: here, or as a job on every rank of the
        world."""
        from tpu3dlm_torch.pipeline import task

        if self.world is None:
            return task.setup_pipeline(folder, cfg, cfg_goldstd, goldstd_var=goldstd_var, device=self.device)
        # every rank, this one too, reads the configs from the path (run_capture)
        job = {"config": self.config_path, "folder": folder, "with_gold": cfg_goldstd is not None,
               "goldstd_var": goldstd_var}
        return self.world.run(job, run_capture)

    def _process(self, folder: str) -> bool:
        """Run one capture; True when it was handled (a sentinel written or
        quarantined), False when deferred to a later cycle."""
        from tpu3dlm_torch.pipeline import task

        path = os.path.join(self.data_root, folder)
        t0 = time.perf_counter()
        goldstd_var = None
        if folder != "gold_std":
            if self._gold_pending():
                self.logger.info("scan %s deferred: gold_std capture not processed yet", folder)
                return False
            try:
                self._ensure_gold()
                goldstd_var = task.load_gold_std(self.cfg_goldstd.pickle_path)
                if goldstd_var is None:
                    # running on would skip the compare and stamp the capture
                    # DONE without the report
                    raise RuntimeError(f"gold pickle {self.cfg_goldstd.pickle_path} exists but is unreadable")
            except Exception:
                # the shared baseline failed, not this capture: defer it
                self.logger.exception("gold baseline unavailable — scan %s deferred", folder)
                return False
        try:
            if folder == "gold_std":
                pipeline = self._run_pipeline("gold_std", self.cfg_goldstd)
            else:
                pipeline = self._run_pipeline(folder, self._loader(self.config_path, folder), self.cfg_goldstd,
                                              goldstd_var)
        except Exception:
            return self._record_failure(folder, path)
        self._attempts.pop(folder, None)
        self._retry_after.pop(folder, None)
        record = {
            "folder": folder,
            "wall_clock_s": round(time.perf_counter() - t0, 3),
            "stage_times": {k: round(v, 4) for k, v in pipeline.stage_times.items()},
            "frames": len(pipeline.data_to_save.get("predictions", {})),
        }
        rows = pipeline.data_to_save.get("comparison_rows")
        if rows is not None:
            record["missing"] = sum(1 for r in rows if r.get("status") == "missing")
        verdict = pipeline.data_to_save.get("alignment_verdict")
        if verdict is not None and not verdict.get("ok", True):
            record["alignment_verdict"] = verdict
            try:
                with open(os.path.join(path, SUSPECT_SENTINEL), "w") as f:
                    json.dump(record, f, indent=1)
            except OSError:
                self.logger.exception("scan %s alignment-suspect but sentinel write failed", folder)
            self.suspect.append(folder)
            # handled for max_scans: the sentinel keeps it from rediscovery;
            # it is the report that is untrusted, not the service
            self.processed.append(folder)
            self.logger.warning("scan %s QUARANTINED: alignment suspect (%s)", folder,
                                ",".join(verdict.get("reasons", ())))
            return True
        try:
            with open(os.path.join(path, DONE_SENTINEL), "w") as f:
                json.dump(record, f, indent=1)
        except OSError:
            # the capture reprocesses after a restart, which is safe
            self.logger.exception("scan %s processed but DONE sentinel write failed", folder)
        self.processed.append(folder)
        self.logger.info("scan %s done in %.2f s", folder, record["wall_clock_s"])
        return True

    def _record_failure(self, folder: str, path: str) -> bool:
        """Handle a processing failure (called from an except block): retry
        with exponential backoff up to ``max_attempts``, then quarantine
        with the FAILED sentinel."""
        n = self._attempts.get(folder, 0) + 1
        self._attempts[folder] = n
        if n < self.max_attempts:
            delay = self.poll_interval * (2 ** n)
            self._retry_after[folder] = time.monotonic() + delay
            self.logger.exception("scan %s failed (attempt %d/%d) — retrying in %.0f s",
                                  folder, n, self.max_attempts, delay)
            return False
        try:
            with open(os.path.join(path, FAILED_SENTINEL), "w") as f:
                f.write(traceback.format_exc())
        except OSError:
            # the quarantine write failing must not take the service down;
            # the backoff entry stops a hot retry loop
            self._retry_after[folder] = time.monotonic() + self.poll_interval * (2 ** n)
            self.logger.exception("scan %s failed AND its FAILED sentinel could not be written — "
                                  "will re-attempt after backoff", folder)
            return False
        self.logger.exception("scan %s failed %d times — quarantined", folder, n)
        return True

    # -- loop --------------------------------------------------------------

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(self.concurrency, thread_name_prefix="tpu3dlm-scan")

    def _harvest(self) -> list[str]:
        """Collect finished in-flight captures; returns the handled ones."""
        done = []
        for folder, fut in list(self._inflight.items()):
            if fut.done():
                del self._inflight[folder]
                if fut.result():
                    done.append(folder)
        return done

    def drain(self) -> list[str]:
        """Block until every in-flight capture finishes; returns the ones
        handled during the wait."""
        if self._inflight:
            from concurrent.futures import wait

            wait(list(self._inflight.values()))
        return self._harvest()

    def run_once(self) -> list[str]:
        """One poll cycle; returns the folders that finished this cycle.
        gold_std runs first when present. With ``concurrency > 1``
        maintenance captures go to worker threads and are reported by the
        harvest of a later cycle."""
        done = self._harvest() if self._inflight else []
        ready = sorted(self._ready_folders(), key=lambda f: f != "gold_std")
        if self.concurrency == 1:
            for folder in ready:
                if self._process(folder):
                    done.append(folder)
                if self.max_scans is not None and len(self.processed) >= self.max_scans:
                    break
            return done
        if ready and ready[0] == "gold_std":
            # gold runs alone and synchronously: its pickle must be complete
            # before a worker loads it, and work in flight on the previous
            # baseline finishes first
            if self._inflight:
                return done
            if self._process("gold_std"):
                done.append("gold_std")
            ready = ready[1:]
        for folder in ready:
            if self.max_scans is not None and len(self.processed) + len(self._inflight) >= self.max_scans:
                break
            self._ensure_pool()
            self._inflight[folder] = self._pool.submit(self._process, folder)
        return done

    def run(self) -> None:
        self.logger.info("watching %s every %.1f s (concurrency %d, device %s, %d rank(s))",
                         self.data_root, self.poll_interval, self.concurrency, self.device,
                         1 if self.world is None else self.world.mesh.size)
        try:
            while True:
                self.run_once()
                if self.max_scans is not None:
                    if len(self.processed) + len(self._inflight) >= self.max_scans:
                        self.drain()
                    if len(self.processed) >= self.max_scans:
                        return
                time.sleep(self.poll_interval)
        finally:
            self.close()

    def close(self) -> None:
        """Drain in-flight captures and join the worker pool: a bounded run
        leaks no threads into the host process."""
        self.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def run_capture(job: dict, mesh):
    """A world job (``ScanWatcher._run_pipeline``'s): the capture's
    Pipeline on this rank, on the job's mesh."""
    from tpu3dlm_torch.pipeline import task
    from tpu3dlm_torch.utils.config import ConfigLoader

    cfg = ConfigLoader(job["config"], job["folder"])
    cfg_goldstd = ConfigLoader(job["config"], "gold_std") if job["with_gold"] else None
    return task.setup_pipeline(job["folder"], cfg, cfg_goldstd, goldstd_var=job["goldstd_var"], device=mesh.device,
                               mesh=mesh)


def serve_world(config_path: str, device: str | torch.device = "cuda", **watch_kw):
    """The watcher over the running world; every rank calls it. Rank 0
    builds ``ScanWatcher(config_path, world=..., **watch_kw)``, runs it and
    returns it; the other ranks run the captures it posts and return how
    many they ran. Returns once rank 0 stops."""
    from tpu3dlm_torch.parallel.mesh import JobWorld

    world = JobWorld(device=device)
    try:
        if world.mesh.rank != 0:
            return world.follow(run_capture)
        try:
            watcher = ScanWatcher(config_path, device=device, world=world, **watch_kw)
            watcher.run()
        finally:
            world.stop()
        return watcher
    finally:
        world.close()


def watch(config_path: str, device: str | torch.device = "cuda", **watch_kw) -> None:
    """Serve the config's data root until the watcher stops: over the
    running world (``serve_world``), else in this process. The CLI starts
    the world for ``mesh_devices = N > 1`` (``cli.py``)."""
    import torch.distributed as dist

    if dist.is_initialized():
        serve_world(config_path, device=device, **watch_kw)
    else:
        ScanWatcher(config_path, device=device, **watch_kw).run()


def main(argv=None):
    """``python -m tpu3dlm_torch.pipeline.watch``: the reference's flags,
    run as ``cli.py --watch`` (which starts the world for ``mesh_devices =
    N > 1``)."""
    import argparse

    from tpu3dlm_torch import cli

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="Continuous maintenance service: process scans as they arrive.")
    ap.add_argument("--config", type=str, default=os.path.join("configs", "variables.cfg"))
    ap.add_argument("--poll", type=float, default=5.0)
    ap.add_argument("--max-scans", type=int, default=None, help="Exit after N scans (default: run forever).")
    ap.add_argument("--max-attempts", type=int, default=3,
                    help="Failures tolerated per capture (with backoff) before quarantine.")
    ap.add_argument("--concurrency", type=int, default=1,
                    help="Captures processed at once (gold_std always runs alone).")
    ap.add_argument("--device", type=str, default="cuda",
                    help="Device to run on: cuda (default; raises without a GPU) or cpu.")
    args = ap.parse_args(argv)
    cli.main(["--watch", "--config", args.config, "--poll-interval", str(args.poll), "--max-attempts",
              str(args.max_attempts), "--watch-concurrency", str(args.concurrency), "--device", args.device]
             + ([] if args.max_scans is None else ["--max-scans", str(args.max_scans)]))


if __name__ == "__main__":
    main()
