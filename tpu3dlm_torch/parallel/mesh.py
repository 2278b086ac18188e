"""The device mesh on ``torch.distributed`` (port of
``tpu3dlm/parallel/mesh.py``).

JAX drives N devices from one controller; PyTorch's idiom is one process
per device. So the port's mesh is a 1-D world of ranks over the ``batch``
axis, and each rank owns one device: ``cuda:<local rank>`` (modulo the
visible cards), or the CPU when the caller asks for it. The collectives
are ``torch.distributed``'s ``all_gather`` (list form), ``all_reduce`` and
``broadcast``, which NCCL and gloo both run on CUDA tensors.

The backend is explicit: ``"nccl"`` by default on CUDA, ``"gloo"`` on the
CPU. gloo on CUDA runs only when the caller names it; that is how several
ranks share one card (NCCL refuses two ranks on one GPU), and nothing here
picks it for the caller.

Worlds meet through a ``FileStore`` in a temporary directory, never a fixed
TCP port. ``spawn_world`` starts N ranks (spawn, never fork), runs a
function in each and tears the world down and removes its store even when
a rank fails; the failure still propagates. Every world carries a timeout,
so a hung rank fails its collectives instead of hanging the caller.

    mesh = make_mesh(2)           # inside a running world of 2 ranks
    (x,), n = pad_to_devices((x,), mesh)
    local = shard_batch(x, mesh)  # this rank's contiguous rows
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from tpu3dlm_torch.device import resolve_device

# seconds a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT_S = 600.0


def default_backend(device: str | torch.device) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _check_world(n: int, device_type: str, backend: str) -> None:
    if n < 1:
        raise ValueError(f"a world needs at least one rank, got {n}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: use 'nccl' or 'gloo'")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'; the CPU runs on gloo")
        resolve_device("cuda")  # raises without a card
        cards = torch.cuda.device_count()
        if n > cards:
            raise ValueError(
                f"requested {n} ranks on nccl, have {cards} visible cards (NCCL runs one rank "
                "per card; name backend='gloo' to share a card)"
            )


def _rank_device(rank: int, device_type: str) -> torch.device:
    """This rank's device: the CPU, or card LOCAL_RANK (the rank when
    unset) modulo the visible cards, made the current card."""
    if device_type != "cuda":
        return resolve_device(device_type)
    resolve_device("cuda")
    index = int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return resolve_device(f"cuda:{index}")


class Mesh:
    """A 1-D world of ranks: the process group, this rank, the world size,
    this rank's device and ``axis_names == ("batch",)``. ``key`` names the
    world for caches (its size, this rank, its device, the backend), as the
    reference keys on the mesh's device ids."""

    axis_names = ("batch",)

    def __init__(self, group, rank: int, size: int, device: torch.device, backend: str,
                 store_dir: str | None = None):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self._store_dir = store_dir  # set when this mesh brought the world up

    def __repr__(self) -> str:
        return f"Mesh(rank={self.rank}, size={self.size}, device={self.device}, backend={self.backend!r})"

    @property
    def key(self) -> tuple:
        return (self.size, self.rank, str(self.device), self.backend)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each), concatenated on the
        leading axis in rank order."""
        t = t.contiguous()
        wire = t.view(torch.uint8) if t.dtype == torch.bool else t
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        out = torch.cat(parts)
        return out.view(torch.bool) if t.dtype == torch.bool else out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
        dist.broadcast(t, src=src, group=self.group)
        return t

    def barrier(self) -> None:
        if self.device.type == "cuda" and self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def close(self) -> None:
        """Tear down a world this mesh brought up (``make_mesh(1)`` with no
        world running) and remove its store; a joined world is its
        owner's to close."""
        if self._store_dir is None:
            return
        try:
            if dist.is_initialized():
                dist.destroy_process_group()
        finally:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None


def make_mesh(n_devices: int | None = None, device: str | torch.device = "cuda",
              backend: str | None = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A 1-D mesh of ``n_devices`` ranks (the whole running world by
    default). Joins the running world, which must have exactly that many
    ranks; with no world running, ``n_devices`` 1 (or None) brings up a
    real 1-rank group, which ``Mesh.close`` tears down. Raises
    ``ValueError`` when more ranks are asked for than the world or the
    visible cards hold; n is never shrunk."""
    device_type = torch.device(device).type
    if dist.is_initialized():
        world = dist.get_world_size()
        n = world if n_devices is None else n_devices
        if n != world:
            raise ValueError(f"requested {n} ranks, the running world has {world}")
        backend = dist.get_backend()
        _check_world(n, device_type, backend)
        rank = dist.get_rank()
        return Mesh(dist.group.WORLD, rank, world, _rank_device(rank, device_type), backend)
    n = 1 if n_devices is None else n_devices
    if n != 1:
        raise ValueError(
            f"requested {n} ranks but no world is running: start the ranks with spawn_world, "
            "torchrun or distributed_init"
        )
    backend = backend or default_backend(device_type)
    _check_world(1, device_type, backend)
    store_dir = tempfile.mkdtemp(prefix="tpu3dlm_torch_world_")
    try:
        dist.init_process_group(backend, init_method=f"file://{store_dir}/store", world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=timeout_s))
        return Mesh(dist.group.WORLD, 0, 1, _rank_device(0, device_type), backend, store_dir)
    except BaseException:
        shutil.rmtree(store_dir, ignore_errors=True)
        raise


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def pad_to_devices(arrays, mesh: Mesh):
    """Pad every leaf's leading axis with zeros up to a multiple of the
    world size (numpy, as the reference). Returns (padded tree, original
    length); slice outputs back with it."""
    n = mesh.size
    lead = None

    def pad(x):
        nonlocal lead
        x = np.asarray(x)
        lead = x.shape[0] if lead is None else lead
        extra = (-x.shape[0]) % n
        if extra:
            x = np.concatenate([x, np.zeros((extra,) + x.shape[1:], x.dtype)])
        return x

    return _map(pad, arrays), lead


def shard_batch(arrays, mesh: Mesh):
    """This rank's contiguous slice of every leaf's leading axis (numpy
    arrays or tensors, left where they are); the world size must divide it
    (``pad_to_devices`` first)."""
    def rows(x):
        if x.shape[0] % mesh.size:
            raise ValueError(f"leading axis {x.shape[0]} is not a multiple of the world size {mesh.size}")
        per = x.shape[0] // mesh.size
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    return _map(rows, arrays)


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Rank 0's values on every rank, in place: a tensor, a tree of tensors
    or a module (its parameters and buffers). Returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        for t in [*tree.parameters(), *tree.buffers()]:
            mesh.broadcast(t.data)
        return tree
    _map(lambda t: mesh.broadcast(t) if isinstance(t, torch.Tensor) else t, tree)
    return tree


def distributed_init(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device = "cuda",
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Mesh | None:
    """Bring the world up (the reference's ``jax.distributed.initialize``
    wrapper, with its contract).

    With no arguments it performs a real 1-process bring-up through a
    ``FileStore`` in a temporary directory and returns its ``Mesh``, whose
    ``close`` tears it down and removes the store. ``coordinator`` is an init
    method: ``host:port`` (read as ``tcp://host:port``), any URL such as
    ``file:///path``, or ``env://`` for the variables ``torchrun`` sets.
    No-op when a world is already up.

    A failed init is swallowed only when the world is known to be one
    process (``num_processes=1``, or no arguments at all). Any init that
    could mean more than one process (``num_processes > 1``, or a
    coordinator or process id with the world size left to the
    environment) re-raises: swallowing it would turn every collective into
    a local no-op."""
    if dist.is_initialized():
        return None
    multi = (
        num_processes > 1
        if num_processes is not None
        else coordinator is not None or process_id is not None
    )
    device_type = torch.device(device).type
    backend = backend or default_backend(device_type)
    try:
        if coordinator is None and num_processes is None and process_id is None:
            return make_mesh(1, device=device_type, backend=backend, timeout_s=timeout_s)
        _check_world(num_processes or 1, device_type, backend)
        init = coordinator if coordinator is None or "://" in coordinator else f"tcp://{coordinator}"
        kw = {}
        if num_processes is not None:
            kw["world_size"] = num_processes
        if process_id is not None:
            kw["rank"] = process_id
        dist.init_process_group(backend, init_method=init, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    except (RuntimeError, ValueError):
        if multi:
            raise
    return None


def _rank_main(rank: int, n: int, backend: str, device_type: str, timeout_s: float, store_dir: str,
               fn: Callable, args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    distributed_init(f"file://{store_dir}/store", n, rank, device=device_type, backend=backend,
                     timeout_s=timeout_s)
    try:
        out = fn(make_mesh(n, device=device_type), *args)
        with open(os.path.join(store_dir, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable, n: int, *, device: str | torch.device = "cuda", backend: str | None = None,
                timeout_s: float = DEFAULT_TIMEOUT_S, args: tuple = ()) -> list[Any]:
    """Run ``fn(mesh, *args)`` in each of ``n`` new rank processes (spawned:
    a fresh interpreter each, as CUDA needs), all in one world on
    ``device`` (rank r on card r modulo the visible cards, or the CPU);
    returns the ranks' return values in rank order. ``fn`` must be importable by name and
    return picklable host data. The world is torn down and its store
    removed however the ranks end; a rank that raises or dies makes this
    raise (``torch.multiprocessing.ProcessRaisedException`` /
    ``ProcessExitedException``) after the others are stopped."""
    device_type = torch.device(device).type
    backend = backend or default_backend(device_type)
    _check_world(n, device_type, backend)
    store_dir = tempfile.mkdtemp(prefix="tpu3dlm_torch_world_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(n, backend, device_type, timeout_s, store_dir, fn, args), nprocs=n, join=False,
            start_method="spawn",
        )
        try:
            while not ctx.join():
                pass
        finally:
            for proc in ctx.processes:  # left running only if the wait itself was cut
                if proc.is_alive():
                    proc.terminate()
                    proc.join()
            for path in ctx.error_files:  # a failed rank's traceback, read by join
                if os.path.exists(path):
                    os.remove(path)
        out = []
        for r in range(n):
            with open(os.path.join(store_dir, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
