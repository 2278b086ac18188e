"""The port's side of the parallel tests (tests/test_torch_parallel*.py):
legs that every rank of a 2-rank gloo world runs on the CPU. The test files
spawn the world once per file (``tpu3dlm_torch.parallel.mesh.spawn_world``
with ``run`` and the legs to run); each rank is a fresh interpreter, so
this module imports no JAX and takes its inputs as numpy arrays and Flax
trees of numpy arrays. Each leg returns host data."""

import numpy as np
import torch

from tpu3dlm_torch.models.weights import beit_from_flax, beit_to_flax, yolov10_from_flax, yolov10_to_flax
from tpu3dlm_torch.parallel import finetune as PF


def collectives(mesh) -> dict:
    """A sum, a gather and a broadcast across the world."""
    t = torch.full((4,), float(mesh.rank + 1))
    mesh.all_reduce(t)
    g = mesh.all_gather(torch.tensor([[mesh.rank, 10 + mesh.rank]]))
    b = mesh.broadcast(torch.tensor([float(mesh.rank) + 7.0]))
    return dict(rank=mesh.rank, size=mesh.size, axis_names=mesh.axis_names, device=str(mesh.device),
                backend=mesh.backend, all_reduce=t.numpy(), all_gather=g.numpy(), broadcast=b.numpy())


def target_nn(mesh, a, b) -> dict:
    from tpu3dlm_torch.parallel.mesh import shard_batch
    from tpu3dlm_torch.parallel.nn import target_sharded_nn

    idx, d2 = target_sharded_nn(mesh)(torch.from_numpy(a), torch.from_numpy(shard_batch(b, mesh)))
    return dict(idx=idx.numpy(), d2=d2.numpy())


def scan_step(mesh, yolo_vars, beit_vars, batch, kw) -> dict:
    from tpu3dlm_torch.parallel.inference import sharded_full_scan_step

    yolo = yolov10_from_flax(yolo_vars).eval()
    beit = beit_from_flax(beit_vars).eval()
    out = sharded_full_scan_step(mesh, yolo, beit, *batch, **kw)
    return {k: v.numpy() for k, v in out.items()}


def icp_compare(mesh, base, comp, base_boxes, comp_boxes, kw) -> dict:
    from tpu3dlm_torch.alignment.align import Alignment

    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (4, 1))
    align = Alignment(poses, poses, base_boxes, comp_boxes, base_cloud=base, comparison_cloud=comp, mesh=mesh,
                      **kw)
    align.compare("test")
    return dict(T=align.final_transform, steps=align.transformations, verdict=align.last_verdict.to_dict(),
                match=align.last_match)


def fail_on_rank1(mesh) -> None:
    """Rank 1 raises; rank 0 would go on working (it is stopped when rank 1
    fails: a collective here would fail too, and race rank 1 to be the
    error reported)."""
    import time

    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(600)


def hang_on_rank1(mesh) -> None:
    """Rank 1 never joins the collective rank 0 waits in."""
    import time

    if mesh.rank == 1:
        time.sleep(600)
    mesh.all_reduce(torch.zeros(1))


def beit_step(mesh, params, crops, labels, lr, augment, noise) -> dict:
    """One data-parallel BEiT step from Flax ``params``; ``noise`` is a list
    with each rank's draw (or None)."""
    beit = beit_from_flax(params)
    opt = PF.init_finetune(beit, lr=lr, device=mesh.device)
    step = PF.make_beit_train_step(beit, opt, mesh, augment=augment, device=mesh.device)
    loss = step(crops, labels, noise=None if noise is None else noise[mesh.rank])
    grads = {n: p.grad.numpy().copy() for n, p in beit.named_parameters()}
    return dict(loss=float(loss), grads=grads, params=beit_to_flax(beit))


def yolo_step(mesh, variables, images, boxes, labels, mask, img_size, lr) -> dict:
    """One data-parallel YOLOv10 step from Flax ``variables``."""
    yolo = yolov10_from_flax(variables).train()
    step = PF.make_yolo_train_step(yolo, PF.adamw(yolo.parameters(), lr), mesh, img_size, device=mesh.device)
    loss = step(images, boxes, labels, mask)
    grads = {n: p.grad.numpy().copy() for n, p in yolo.named_parameters()}
    return dict(loss=float(loss), grads=grads, stats=yolov10_to_flax(yolo)["batch_stats"])


def _recording(name: str, losses: list):
    """Wrap ``parallel.finetune``'s step maker so every step's loss is kept."""
    make = getattr(PF, name)

    def maker(*a, **kw):
        step = make(*a, **kw)

        def run(*sa, **skw):
            out = step(*sa, **skw)
            losses.append(float(out))
            return out

        return run

    return maker


def finetune_yolo(mesh, args, opts, init, noise) -> dict:
    """``selftrain.finetune_yolo(mesh=...)``; ``noise[r]`` is rank r's list
    of per-step draws."""
    from tpu3dlm_torch.pipeline import selftrain as PS

    losses = []
    real = PF.make_yolo_train_step
    PF.make_yolo_train_step = _recording("make_yolo_train_step", losses)
    try:
        model = PS.finetune_yolo(*args, mesh=mesh, init=init, noise=noise[mesh.rank], **opts)
    finally:
        PF.make_yolo_train_step = real
    return dict(losses=losses, variables=yolov10_to_flax(model), training=model.training)


def finetune_beit(mesh, args, opts, init, noise) -> dict:
    from tpu3dlm_torch.models.beit import BeitConfig
    from tpu3dlm_torch.pipeline import selftrain as PS

    losses = []
    real = PF.make_beit_train_step
    PF.make_beit_train_step = _recording("make_beit_train_step", losses)
    try:
        crops, labels, cfg = args
        model = PS.finetune_beit(crops, labels, BeitConfig(**cfg), mesh=mesh, init=init, noise=noise[mesh.rank],
                                 **opts)
    finally:
        PF.make_beit_train_step = real
    return dict(losses=losses, params=beit_to_flax(model))


def pipeline_walk(mesh, argv) -> dict:
    """The CLI's run of ``argv`` in this world, with every compare's ICP
    walk (``Alignment.transformations``) and final transform kept; rank
    0's report CSV."""
    from tpu3dlm_torch import cli
    from tpu3dlm_torch.alignment import align as PA
    from tpu3dlm_torch.utils.config import ConfigLoader

    walks = []
    real = PA.Alignment.compare

    def compare(self, *a, **kw):
        out = real(self, *a, **kw)
        walks.append(([np.asarray(s) for s in self.transformations], np.asarray(self.final_transform)))
        return out

    PA.Alignment.compare = compare
    try:
        cli.main(argv)
    finally:
        PA.Alignment.compare = real
    cfg = ConfigLoader(argv[argv.index("--config") + 1], argv[argv.index("--data") + 1])
    return dict(walks=walks, csv=open(cfg.csv_output).read() if mesh.rank == 0 else None)


def cli_default_config(mesh, config) -> dict:
    """``python -m tpu3dlm_torch.cli --config <missing>`` on this rank of a
    running world, the Pipeline itself stubbed: whether this rank wrote the
    default config, and the config every rank then read."""
    from tpu3dlm_torch import cli
    from tpu3dlm_torch.pipeline import task
    from tpu3dlm_torch.utils import config as C

    wrote, ran = [], []
    real_write, real_setup = C.write_default_config, task.setup_pipeline
    C.write_default_config = lambda path: wrote.append(path) or real_write(path)
    task.setup_pipeline = lambda folder, cfg, *a, **kw: ran.append((folder, cfg.mesh_devices))
    try:
        cli.main(["--data", "gold_std", "--config", config, "--device", "cpu"])
    finally:
        C.write_default_config, task.setup_pipeline = real_write, real_setup
    return dict(wrote=wrote, ran=ran)


def icp_steps(mesh, stages, starts) -> dict:
    """One point-to-plane ICP iteration from each of ``starts`` ((stage,
    4×4 transform) pairs); ``stages[s]`` is stage s's (query, target,
    normals, max distance), the query sharded over the world, and also
    whole on this rank alone (one device)."""
    from tpu3dlm_torch.ops.icp import icp_point_to_plane
    from tpu3dlm_torch.parallel.mesh import shard_batch

    out = {}
    for name, m in (("world", mesh), ("one", None)):
        incs = []
        for s, T in starts:
            q, t, n, d = stages[s]
            q = q if m is None else shard_batch(q, m)
            r = icp_point_to_plane(torch.from_numpy(q.copy()), torch.from_numpy(t.copy()), torch.from_numpy(n.copy()),
                                   init_transform=torch.from_numpy(T), max_correspondence_dist=d, iterations=1,
                                   early_stop_tol=0.0, mesh=m, _measure=False)
            incs.append(r.step_transforms[0].numpy())
        out[name] = incs
    return out


def _job(job, mesh):
    """A toy world job: a gather, a barrier and a sum; ``job`` names where
    a rank fails instead."""
    if job == "rank1_fails_first" and mesh.rank == 1:
        raise ValueError("rank 1 fails before any collective")
    mesh.all_gather(torch.ones(3, dtype=torch.bool, device=mesh.device))
    if job == "rank0_fails_after_a_gather" and mesh.rank == 0:
        raise ValueError("rank 0 fails after a gather")
    mesh.barrier()
    if job == "rank1_fails_in_the_middle" and mesh.rank == 1:
        raise ValueError("rank 1 fails between two collectives")
    t = torch.full((2,), float(mesh.rank + 1), device=mesh.device)
    mesh.all_reduce(t)
    return mesh.broadcast(t * (mesh.rank + 1)).tolist()


def job_world_faults(mesh) -> dict:
    """A JobWorld (tests/test_torch_job_world.py) on this world's device
    running good and failing toy jobs in turns: rank 0's result or error
    and seconds for each, and how many jobs the other rank took."""
    import time

    from tpu3dlm_torch.parallel.mesh import JobFailed, JobWorld

    world = JobWorld(device=mesh.device.type)
    try:
        if mesh.rank != 0:
            return dict(followed=world.follow(_job))
        runs = []
        for job in ("ok", "rank1_fails_first", "ok", "rank0_fails_after_a_gather", "ok",
                    "rank1_fails_in_the_middle", "ok"):
            t0 = time.perf_counter()
            try:
                out, errors = world.run(job, _job), None
            except JobFailed as e:
                out, errors = None, e.errors
            runs.append(dict(job=job, out=out, errors=errors, seconds=time.perf_counter() - t0))
        world.stop()
        return dict(runs=runs)
    finally:
        world.close()


def _sum_job(job, mesh):
    """A toy world job: the ranks' ``job`` + rank gathered and summed, that
    sum all-reduced and broadcast: 2·(2·job + 1) on two ranks."""
    g = mesh.all_gather(torch.tensor([float(job + mesh.rank)]))
    t = g.sum().reshape(1)
    mesh.all_reduce(t)
    return float(mesh.broadcast(t)[0])


def job_world_threads(mesh, threads: int = 8, jobs: int = 5) -> dict:
    """Rank 0's ``threads`` threads each post ``jobs`` jobs at once, with
    the switch interval cut to 1 µs so the threads interleave as often as
    they can: every job must come back with its own sum (the world runs
    them one at a time, in the order rank 0 posted them)."""
    import sys
    import threading

    from tpu3dlm_torch.parallel.mesh import JobWorld

    world = JobWorld(device="cpu")
    try:
        if mesh.rank != 0:
            return dict(followed=world.follow(_sum_job))
        got, interval = {}, sys.getswitchinterval()

        def post(k):
            for j in range(jobs):
                got[k, j] = world.run(100 * k + j, _sum_job)

        sys.setswitchinterval(1e-6)
        try:
            pool = [threading.Thread(target=post, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            alive = sum(t.is_alive() for t in pool)
        finally:
            sys.setswitchinterval(interval)
        world.stop()
        return dict(got={f"{k}.{j}": v for (k, j), v in got.items()}, alive=alive, threads=threads, jobs=jobs)
    finally:
        world.close()


def odd_frame_step(mesh) -> dict:
    """The fused runner on a 5-frame scan (a bucket of 5: odd, so the
    world pads a frame) sharded over the world and on this rank alone, with
    a crop budget that does not bind (every box of 6 frames fits)."""
    import chip_smoke
    from tpu3dlm_torch.models.beit import BeitConfig
    from tpu3dlm_torch.pipeline.fused import FusedScanRunner

    scan = chip_smoke.synthetic_scan(5, 64, (48, 64), 3)
    kw = dict(img_size=64, conf_thresh=0.0, max_det=4, nc=3, crop_budget=24, dtype=torch.float32, device="cpu",
              beit_config=BeitConfig(image_size=32, hidden_size=32, num_layers=1, num_heads=2,
                                     intermediate_size=64, num_labels=2))
    out = {}
    for name, m in (("world", mesh), ("one", None)):
        det, gb = FusedScanRunner(mesh=m, **kw)(scan)
        out[name] = dict(boxes=det.boxes, conf=det.conf, label=det.label, damage=det.damage, mask=det.mask,
                         corners=gb.corners)
    return out


def watch_world_faults(mesh, config: str, flaky: str, bad: str) -> dict:
    """The watcher over this world on the real Pipeline, where rank 1
    fails capture ``flaky`` on its first attempt and ``bad`` on every one,
    inside the Pipeline (its frame load, while rank 0 has gone on to the
    next collective). Rank 0 polls until every capture has a sentinel.
    Every rank reports what it opened for writing under the data root and
    how often it built the gold moments (the gold cache); rank 0 its
    processed captures and each job's outcome and seconds."""
    import builtins
    import os
    import time

    from tpu3dlm_torch.alignment import align as PA
    from tpu3dlm_torch.parallel.mesh import JobWorld
    from tpu3dlm_torch.pipeline import task as PT
    from tpu3dlm_torch.pipeline import watch as PW

    torch.set_num_threads(1)
    root = os.path.join(os.path.dirname(config), "data")
    writes, moments, failed_once = [], [], set()
    real_open, real_moments, real_load = builtins.open, PA.target_moments_np, PT.load_scan

    def spy_open(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax+") and os.path.abspath(str(file)).startswith(root):
            writes.append(os.path.relpath(str(file), root))
        return real_open(file, mode, *a, **kw)

    def load_scan(*a, **kw):
        folder = os.path.basename(os.path.dirname(os.path.dirname(kw["image_dir"])))
        if mesh.rank == 1 and (folder == bad or (folder == flaky and folder not in failed_once)):
            failed_once.add(folder)
            raise RuntimeError(f"rank 1 cannot read {folder}")
        return real_load(*a, **kw)

    builtins.open, PT.load_scan = spy_open, load_scan
    PA.target_moments_np = lambda *a, **kw: moments.append(1) or real_moments(*a, **kw)
    world = JobWorld(device="cpu")
    try:
        if mesh.rank != 0:
            return dict(followed=world.follow(PW.run_capture), writes=writes, gold_builds=len(moments))
        w = PW.ScanWatcher(config, poll_interval=0.01, max_attempts=2, device="cpu", world=world)
        jobs = []
        real_run = world.run

        def timed_run(job, fn):
            t0 = time.perf_counter()
            try:
                return real_run(job, fn)
            finally:
                jobs.append((job["folder"], time.perf_counter() - t0))

        world.run = timed_run
        names = sorted(n for n in os.listdir(root) if PW._is_capture(os.path.join(root, n)))
        sentinels = (PW.DONE_SENTINEL, PW.FAILED_SENTINEL, PW.SUSPECT_SENTINEL)
        for _ in range(400):
            w.run_once()
            if all(any(os.path.exists(os.path.join(root, n, s)) for s in sentinels) for n in names):
                break
            time.sleep(0.01)
        w.close()
        world.stop()
        return dict(processed=w.processed, jobs=jobs, writes=writes, gold_builds=len(moments))
    finally:
        world.close()
        builtins.open, PT.load_scan, PA.target_moments_np = real_open, real_load, real_moments


LEGS = dict(collectives=collectives, target_nn=target_nn, scan_step=scan_step, icp_compare=icp_compare,
            beit_step=beit_step, yolo_step=yolo_step, finetune_yolo=finetune_yolo, finetune_beit=finetune_beit,
            pipeline_walk=pipeline_walk, icp_steps=icp_steps,
            cli_default_config=cli_default_config, job_world_faults=job_world_faults,
            job_world_threads=job_world_threads,
            odd_frame_step=odd_frame_step, watch_world_faults=watch_world_faults)


def run(mesh, legs: dict) -> dict:
    """Each leg named in ``legs`` (``"<leg>"`` or ``"<leg>:<tag>"`` to run a
    leg twice → its keyword arguments) on this rank, single-threaded as the
    JAX package's CPU reductions."""
    torch.set_num_threads(1)
    out = {}
    for name, kw in legs.items():
        base = name.split(":")[0]
        out[name] = LEGS[base](mesh, **kw)
    return out
