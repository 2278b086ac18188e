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

``JobWorld`` runs jobs on every rank of a running world, one at a time:
rank 0 posts each job (``run``) and the other ranks take them (``follow``)
until rank 0 stops (``stop``). A rank that fails a job releases the others
at once instead of at the world's timeout: on NCCL a watchdog thread
aborts the jobs' group and the ranks make a new one; on gloo, whose waits
no abort releases, the job's collectives watch the world's store while
they wait, and the ranks then reissue the one collective some of them
still owe. ``leave_world`` tears down the world this process is in.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from tpu3dlm_torch.device import resolve_device

# seconds a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT_S = 600.0
# seconds a rank of a JobWorld may wait for its next job (a service idles)
IDLE_TIMEOUT_S = 30 * 86400.0
# seconds between the NCCL watchdog's looks at the store for a failed job:
# each look takes the GIL from the rank's host-bound work, so it looks no
# more often than a prompt release needs
_WATCH_S = 0.1
# while a gloo collective waits: seconds between looks at the store, and
# the sleep between looks at the collective itself
_FAILED_POLL_S = 0.01
_SPIN_S = 1e-4


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


class JobAborted(RuntimeError):
    """A collective of a job gave up waiting: another rank failed the job."""


class JobFailed(RuntimeError):
    """A job failed on some rank of the world; ``errors`` holds each failed
    rank's traceback, the ranks that failed first before those that were
    released by their failure."""

    def __init__(self, errors: list[str]):
        self.errors = errors
        super().__init__("\n".join(errors))


class _Job:
    """One job's collectives on this rank. On NCCL they are issued as
    anywhere else, and once the watchdog has aborted the jobs' group
    (``aborted``) the next one raises ``JobAborted``. On gloo (``polled``)
    each is issued async and its wait polled, watching for another rank's
    failure of the job; the job counts what it issued and records the one
    it waits on (kind, shape, dtype, source rank)."""

    def __init__(self, failed: Callable[[], bool], polled: bool):
        self.failed = failed
        self.polled = polled
        self.aborted = threading.Event()
        self.issued = 0
        self.pending: tuple | None = None

    def run(self, issue: Callable, op: tuple) -> None:
        if self.aborted.is_set():
            raise JobAborted(f"another rank failed the job before this rank's {op[0]}")
        if not self.polled:
            issue(False)
            return
        work = issue(True)
        self.issued += 1
        self.pending = op
        next_look = 0.0
        while not work.is_completed():
            now = time.monotonic()
            if now >= next_look:
                if self.failed():
                    raise JobAborted(f"another rank failed the job while this rank waited in {op[0]}")
                next_look = now + _FAILED_POLL_S
            time.sleep(_SPIN_S)
        work.wait()
        self.pending = None


class Mesh:
    """A 1-D world of ranks: the process group, this rank, the world size,
    this rank's device and ``axis_names == ("batch",)``. ``key`` names the
    world for caches (its size, this rank, its device, the backend), as the
    reference keys on the mesh's device ids. A mesh given a ``job``
    (``JobWorld``'s) runs its collectives through it."""

    axis_names = ("batch",)

    def __init__(self, group, rank: int, size: int, device: torch.device, backend: str,
                 store_dir: str | None = None, job: _Job | None = None):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.job = job
        self._store_dir = store_dir  # set when this mesh brought the world up

    def __repr__(self) -> str:
        return f"Mesh(rank={self.rank}, size={self.size}, device={self.device}, backend={self.backend!r})"

    @property
    def key(self) -> tuple:
        return (self.size, self.rank, str(self.device), self.backend)

    def _run(self, op: tuple, issue: Callable) -> None:
        """Issue one collective (``issue(async_op)``)."""
        if self.job is None:
            issue(False)
        else:
            self.job.run(issue, op)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each), concatenated on the
        leading axis in rank order."""
        t = t.contiguous()
        wire = t.view(torch.uint8) if t.dtype == torch.bool else t
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        self._run(("all_gather", tuple(wire.shape), wire.dtype, 0),
                  lambda a: dist.all_gather(parts, wire, group=self.group, async_op=a))
        out = torch.cat(parts)
        return out.view(torch.bool) if t.dtype == torch.bool else out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, in place; returns ``t``."""
        self._run(("all_reduce", tuple(t.shape), t.dtype, 0),
                  lambda a: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group, async_op=a))
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
        self._run(("broadcast", tuple(t.shape), t.dtype, src),
                  lambda a: dist.broadcast(t, src=src, group=self.group, async_op=a))
        return t

    def barrier(self) -> None:
        if self.device.type == "cuda" and self.backend == "nccl":
            issue = lambda a: dist.barrier(group=self.group, device_ids=[self.device.index], async_op=a)  # noqa: E731
        else:
            issue = lambda a: dist.barrier(group=self.group, async_op=a)  # noqa: E731
        self._run(("barrier", (), None, 0), issue)

    def reissue(self, op: tuple) -> None:
        """Issue the collective ``op`` (as ``_Job.pending`` records it) on
        zeros and wait for it, outside any job: the collective this rank
        owes ranks that are still waiting in it."""
        kind, shape, dtype, src = op
        plain = Mesh(self.group, self.rank, self.size, self.device, self.backend)
        if kind == "barrier":
            plain.barrier()
            return
        t = torch.zeros(shape, dtype=dtype, device=self.device)
        if kind == "broadcast":
            plain.broadcast(t, src)
        else:
            getattr(plain, kind)(t)

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
        leave_world()


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


def leave_world() -> None:
    """Tear down the world this process is in (its default group and every
    group made in it); no-op outside a world."""
    if dist.is_initialized():
        dist.destroy_process_group()


class JobWorld:
    """Jobs that every rank of the running world runs, one at a time.

    Rank 0 posts each job with ``run(job, fn)``; the other ranks wait for it
    in ``follow(fn)``; every rank runs ``fn(job, mesh)`` on a mesh of the
    world. A rank whose ``fn`` raises marks the job failed in the world's
    store, and the others are released from the job's collectives at once:

    * NCCL: the job's collectives are issued as anywhere else (the host
      never waits on them). They run on a group of the jobs' own, and while
      a job runs a watchdog thread looks at the store every ``_WATCH_S``;
      when the job is marked failed it aborts that
      group, which ends the collectives a failed rank left the others in,
      and the rank raises ``JobAborted`` at its next collective. After a
      failed job every rank aborts the group (if its watchdog has not) and
      the ranks make a new one together.
    * gloo: no abort releases a gloo collective, so each is issued async
      and its wait looks at the store; a released rank raises
      ``JobAborted``. The ranks then trade outcomes, and those that issued
      one collective fewer than the rest issue it once on zeros, which
      completes the collective the others gave up on and leaves the
      world's group in step for the next job.

    ``run`` returns rank 0's result, or raises ``JobFailed`` on rank 0 when
    any rank failed the job; an interrupt of ``fn`` (``KeyboardInterrupt``)
    counts as a failure, then propagates. ``run`` holds a lock, so threads
    of rank 0 post their jobs one after another and no two jobs'
    collectives ever interleave. Posts and outcomes travel on a gloo group
    of their own whose timeout, ``IDLE_TIMEOUT_S``, bounds how long a rank
    waits for its next job. ``stop()`` (rank 0) ends every rank's
    ``follow``; ``close()`` removes the groups. Every rank of the world
    builds the ``JobWorld`` together."""

    def __init__(self, device: str | torch.device = "cuda"):
        if not dist.is_initialized():
            raise ValueError("a JobWorld needs a running world: start it with spawn_world, torchrun, "
                             "distributed_init or make_mesh(1)")
        self.mesh = make_mesh(None, device=device)
        self._control = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=IDLE_TIMEOUT_S))
        self._abortable = self.mesh.backend == "nccl"
        self._group = dist.new_group(backend="nccl") if self._abortable else self.mesh.group
        base = dist.distributed_c10d._get_default_store()
        world_id = self._post(base.add("tpu3dlm_torch_jobs/worlds", 1) if self.mesh.rank == 0 else None)
        self._store = dist.PrefixStore(f"tpu3dlm_torch_jobs/{world_id}/", base)
        self._seq = 0
        self._lock = threading.Lock()

    def _post(self, msg: Any = None) -> Any:
        """Rank 0's ``msg`` on every rank."""
        box = [msg]
        dist.broadcast_object_list(box, src=0, group=self._control)
        return box[0]

    def _gather(self, obj: Any) -> list:
        out = [None] * self.mesh.size
        dist.all_gather_object(out, obj, group=self._control)
        return out

    def run(self, job: Any, fn: Callable) -> Any:
        """Rank 0: post ``job`` and run ``fn(job, mesh)`` here as every
        rank does; returns this rank's result."""
        if self.mesh.rank != 0:
            raise RuntimeError("only rank 0 posts jobs; the other ranks follow")
        with self._lock:
            self._post(("job", job))
            return self._execute(job, fn)

    def follow(self, fn: Callable) -> int:
        """The other ranks: run each job rank 0 posts until it stops;
        returns the number of jobs run. A failed job is rank 0's to
        record."""
        done = 0
        while True:
            kind, job = self._post()
            if kind == "stop":
                return done
            done += 1
            try:
                self._execute(job, fn)
            except JobFailed:
                pass

    def stop(self) -> None:
        """Rank 0: end every rank's ``follow``."""
        with self._lock:
            self._post(("stop", None))

    def close(self) -> None:
        if self._control is not None:
            if self._abortable:
                dist.destroy_process_group(self._group)
            dist.destroy_process_group(self._control)
            self._control = None

    def _watch(self, state: _Job, done: threading.Event) -> None:
        """NCCL: abort the jobs' group once the running job is marked
        failed, unless the job ends first."""
        while not done.wait(_WATCH_S):
            if state.failed():
                state.aborted.set()
                dist.distributed_c10d._abort_process_group(self._group)
                return

    def _execute(self, job: Any, fn: Callable) -> Any:
        self._seq += 1
        key = f"failed/{self._seq}"
        state = _Job(lambda: self._store.check([key]), polled=not self._abortable)
        m = self.mesh
        mesh = Mesh(self._group, m.rank, m.size, m.device, m.backend, job=state)
        done = threading.Event()
        watchdog = threading.Thread(target=self._watch, args=(state, done), daemon=True) if self._abortable else None
        out, err, interrupt = None, None, None
        if watchdog is not None:
            watchdog.start()
        try:
            out = fn(job, mesh)
        except BaseException as e:  # noqa: BLE001 - an interrupt is a failure first, then re-raised
            released = isinstance(e, JobAborted) or state.aborted.is_set()
            self._store.set(key, str(m.rank))
            err = (released, f"rank {m.rank}: {traceback.format_exc()}")
            if not isinstance(e, Exception):
                interrupt = e
        finally:
            done.set()
            if watchdog is not None:
                watchdog.join()
        errors = [e for e in self._gather(err) if e is not None]
        if errors:
            if self._abortable:
                self._renew(state)
            else:
                self._settle(mesh, state)
        if interrupt is not None:
            raise interrupt
        if errors:
            raise JobFailed([text for _, text in sorted(errors, key=lambda e: e[0])])
        return out

    def _renew(self, state: _Job) -> None:
        """NCCL, after a failed job: abort the jobs' group here (unless the
        watchdog did), which ends whatever collective of it is still
        queued, and make a new one with the other ranks."""
        if not state.aborted.is_set():
            dist.distributed_c10d._abort_process_group(self._group)
        self._group = dist.new_group(backend="nccl")

    def _settle(self, mesh: Mesh, state: _Job) -> None:
        """gloo, after a failed job: a rank that issued one collective
        fewer than the others issues the one they wait in (every rank that
        issued more is waiting in that same one)."""
        counts = self._gather((state.issued, state.pending))
        most = max(n for n, _ in counts)
        if state.issued == most:
            return
        owed = next((op for n, op in counts if n == most and op is not None), None)
        if state.issued != most - 1 or owed is None:
            raise RuntimeError(f"the world's collectives are out of step after a failed job: {counts}")
        mesh.reissue(owed)
