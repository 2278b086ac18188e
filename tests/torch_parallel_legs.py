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


LEGS = dict(collectives=collectives, target_nn=target_nn, scan_step=scan_step, icp_compare=icp_compare,
            beit_step=beit_step, yolo_step=yolo_step, finetune_yolo=finetune_yolo, finetune_beit=finetune_beit,
            pipeline_walk=pipeline_walk, icp_steps=icp_steps,
            cli_default_config=cli_default_config)


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
