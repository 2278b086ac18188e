"""The port's world of ranks (tpu3dlm_torch/parallel/mesh.py, nn.py, the
sharded scan step of inference.py, the query-sharded compare of
alignment/align.py) against the JAX package's mesh programs
(tpu3dlm/parallel) on the CPU: JAX on two of the virtual CPU devices
(``make_mesh(2)``), the port in a 2-rank gloo world that the module spawns
once and that runs every leg (tests/torch_parallel_legs.py). Each
tolerance is stated beside its check."""

import os
import subprocess
import sys
import tempfile
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_parallel_legs as legs
from test_torch_models import random_variables
from tpu3dlm.alignment import align as JA
from tpu3dlm.models.beit import BeitClassifier as JaxBeit
from tpu3dlm.models.beit import BeitConfig as JaxBeitConfig
from tpu3dlm.models.yolov10 import YOLOv10 as JaxYOLOv10
from tpu3dlm.ops.pallas.pairwise import nearest_neighbors_xla
from tpu3dlm.parallel import mesh as JM
from tpu3dlm.parallel.inference import sharded_full_scan_step as jax_sharded_step
from tpu3dlm.parallel.inference import square_box_affine
from tpu3dlm.parallel.nn import target_sharded_nn as jax_target_sharded_nn
from tpu3dlm_torch.models.weights import beit_from_flax, yolov10_from_flax
from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors
from tpu3dlm_torch.parallel import mesh as PM
from tpu3dlm_torch.parallel.inference import full_scan_step
from tpu3dlm_torch.parallel.nn import shard_queries

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, S, D, BUDGET = 8, 64, 4, 6
TINY_BEIT = JaxBeitConfig(image_size=32, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                          num_labels=2)
ICP_KW = dict(max_points=1023, icp_iterations=10, global_init="auto", ann="off")  # 1023: odd, padded to 1024


def fake_mesh(rank: int, size: int = 2) -> PM.Mesh:
    """A mesh's rank and size without a world (the helpers that only read them)."""
    return PM.Mesh(None, rank, size, torch.device("cpu"), "gloo")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(256, 3)).astype(np.float32)
    b = rng.normal(size=(2 * 1200, 3)).astype(np.float32)
    b[1700] = b[100]  # one target in both shards: the lower global index must win
    a[0] = b[100]
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 255, size=(F, S, S, 3)).astype(np.uint8)
    depth = np.full((F, 64, 48), 2000.0, np.float32)
    intr = np.tile(np.array([100.0, 100.0, 32.0, 32.0], np.float32), (F, 1))
    rgb_size = np.tile(np.array([S, S], np.float32), (F, 1))
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (F, 1))
    batch = (rgb, depth, intr, rgb_size, poses, square_box_affine(rgb_size, S))
    yv = random_variables(JaxYOLOv10(nc=3, variant="n"), jnp.zeros((1, S, S, 3)), 0)
    bv = random_variables(JaxBeit(TINY_BEIT), jnp.zeros((1, 32, 32, 3)), 1)
    base, comp, bb, cb, _ = chip_smoke.two_scan_scene(20000, 3)
    return dict(nn=(a, b), step=(yv, bv, batch), icp=(base, comp, bb, cb))


@pytest.fixture(scope="module")
def cli_config(tmp_path_factory):
    """Where the CLI leg finds no config (and its rank 0 writes one)."""
    return str(tmp_path_factory.mktemp("cli") / "configs" / "variables.cfg")


@pytest.fixture(scope="module")
def world(inputs, cli_config):
    """Every leg in one 2-rank gloo world → each rank's results."""
    yv, bv, batch = inputs["step"]
    base, comp, bb, cb = inputs["icp"]
    todo = {
        "collectives": {},
        "target_nn": dict(a=inputs["nn"][0], b=inputs["nn"][1]),
        "scan_step": dict(yolo_vars=yv, beit_vars=bv, batch=batch,
                          kw=dict(img_size=S, max_det=D, conf_thresh=0.0, crop_budget=BUDGET)),
        "icp_compare": dict(base=base, comp=comp, base_boxes=bb, comp_boxes=cb, kw=ICP_KW),
        "cli_default_config": dict(config=cli_config),
    }
    return PM.spawn_world(legs.run, 2, device="cpu", args=(todo,))


@pytest.fixture(scope="module")
def jax_side(inputs):
    mesh = JM.make_mesh(2)
    a, b = inputs["nn"]
    nn = jax_target_sharded_nn(mesh)(jnp.asarray(a), jnp.asarray(b))
    yv, bv, batch = inputs["step"]
    step = jax_sharded_step(mesh, JaxYOLOv10(nc=3, variant="n"), JaxBeit(TINY_BEIT), img_size=S, max_det=D,
                            conf_thresh=0.0, crop_budget=BUDGET)
    out = step(JM.replicate(yv, mesh), JM.replicate(bv, mesh),
               *JM.shard_batch(tuple(jnp.asarray(x) for x in batch), mesh))
    base, comp, bb, cb = inputs["icp"]
    JA._GOLD_CACHE.clear()
    with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None):
        ja = JA.Alignment(chip_smoke.IDENTITY_POSES, chip_smoke.IDENTITY_POSES, bb, cb, base_cloud=base,
                          comparison_cloud=comp, mesh=mesh, **ICP_KW)
        ja.compare("test")
    JA._GOLD_CACHE.clear()
    return dict(nn=tuple(np.asarray(x) for x in nn), step={k: np.asarray(v) for k, v in out.items()}, align=ja)


def test_pad_and_shard_match_the_reference():
    """``pad_to_devices`` pads bit for bit as the reference's (zeros, the
    original length back) and ``shard_batch`` gives each rank its
    contiguous rows."""
    x = np.arange(13 * 4, dtype=np.float32).reshape(13, 4)
    y = (np.arange(13) % 3 == 0)
    (want_x, want_y), want_n = JM.pad_to_devices((x, y), JM.make_mesh(2))
    (got_x, got_y), n = PM.pad_to_devices((x, y), fake_mesh(0))
    assert n == want_n == 13 and got_x.shape == (14, 4)
    for g, w in ((got_x, want_x), (got_y, want_y)):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w))
    parts = [PM.shard_batch({"x": got_x, "t": torch.from_numpy(got_x)}, fake_mesh(r)) for r in range(2)]
    assert np.array_equal(np.concatenate([p["x"] for p in parts]), got_x)
    assert torch.equal(parts[1]["t"], torch.from_numpy(got_x[7:]))
    with pytest.raises(ValueError, match="multiple"):
        PM.shard_batch(x, fake_mesh(0))
    q, t = shard_queries(fake_mesh(1), got_x, x)  # this rank's queries, the whole target
    assert q.dtype == t.dtype == torch.float32 and torch.equal(q, torch.from_numpy(got_x[7:]))
    assert torch.equal(t, torch.from_numpy(x))


def test_make_mesh_never_shrinks_the_world():
    """More ranks than the running world (here none) raise, as the
    reference's ``make_mesh`` raises past its devices; so does NCCL on the
    CPU. No world is left behind."""
    for n in (2, 10_000):
        with pytest.raises(ValueError, match="no world is running"):
            PM.make_mesh(n, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        PM.make_mesh(1, device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()


_BRINGUP = """
import os, sys, tempfile
import torch, torch.distributed as dist
from tpu3dlm_torch.parallel.mesh import distributed_init
tmp = tempfile.mkdtemp()
mesh = distributed_init(device="cpu")
assert dist.get_world_size() == 1 and mesh.size == 1 and mesh.rank == 0
t = torch.arange(4.0)
mesh.all_reduce(t)
assert float(t.sum()) == 6.0
assert distributed_init(device="cpu") is None  # already up: a no-op
store = mesh._store_dir
mesh.close()
assert not dist.is_initialized() and not os.path.exists(store)
# a 1-process init that fails is swallowed (the world is known to be one)
distributed_init(os.path.join(tmp, "missing", "dir"), num_processes=1, process_id=0, device="cpu",
                 timeout_s=2)
assert not dist.is_initialized()
# one that means 2 processes re-raises instead of running alone
try:
    distributed_init("file://" + os.path.join(tmp, "store"), num_processes=2, process_id=0, device="cpu",
                     timeout_s=2)
except RuntimeError:
    print("bringup-ok")
"""


def test_distributed_init_single_process_bringup():
    """``distributed_init()`` brings up a real 1-process world (a
    FileStore in a temporary directory, removed by ``close``), is a no-op
    when a world is up, swallows a failed 1-process init and re-raises a
    failed 2-process one (the reference's rule). In a fresh interpreter, as
    the reference's test."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _BRINGUP], capture_output=True, text=True, timeout=120, env=env)
    assert "bringup-ok" in out.stdout, out.stderr[-1500:]


def test_two_process_collective(world):
    """Two OS processes in one world (``spawn_world``, rendezvous through
    ``distributed_init`` on a FileStore): the sum, the gather in rank order
    and rank 0's broadcast agree on both."""
    for r, res in enumerate(world):
        got = res["collectives"]
        assert got["rank"] == r and got["size"] == 2 and got["axis_names"] == ("batch",)
        assert got["device"] == "cpu" and got["backend"] == "gloo"
        assert np.array_equal(got["all_reduce"], np.full(4, 3.0, np.float32))
        assert np.array_equal(got["all_gather"], [[0, 10], [1, 11]])
        assert np.array_equal(got["broadcast"], [7.0])


def test_target_sharded_nn_matches_jax_and_b2(world, jax_side, inputs):
    """Indices identical to JAX's target-sharded program and to B2 on the
    whole target (the duplicated target resolves to its lower index, 100),
    d² within 1e-5 of JAX's and equal to B2's, on both ranks."""
    a, b = inputs["nn"]
    want_idx, want_d2 = jax_side["nn"]
    one_idx, one_d2 = nearest_neighbors(torch.from_numpy(a), torch.from_numpy(b))
    for res in world:
        got = res["target_nn"]
        assert np.array_equal(got["idx"], want_idx) and np.array_equal(got["idx"], one_idx.numpy())
        assert got["idx"][0] == 100
        np.testing.assert_allclose(got["d2"], want_d2, atol=1e-5, rtol=0)
        assert np.array_equal(got["d2"], one_d2.numpy())
    ref_idx, _ = nearest_neighbors_xla(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(want_idx, np.asarray(ref_idx))


def test_sharded_step_with_a_binding_budget_matches_jax(world, jax_side):
    """``crop_budget`` 6 of the 32 slots at ``conf_thresh`` 0, so the global
    selection binds: damage and labels identical to JAX's sharded step,
    boxes within 1e-3 px, conf within 1e-5, corners within 1e-4 m (the
    single-device bars of tests/test_torch_fused.py), on both ranks."""
    want = jax_side["step"]
    n = int((want["damage"] >= 0).sum())
    assert 0 < n <= BUDGET
    for res in world:
        got = res["scan_step"]
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["damage"], want["damage"])
        np.testing.assert_array_equal(got["label"], want["label"])
        np.testing.assert_array_equal(got["mask"], want["mask"])
        np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(got["conf"], want["conf"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["corners"], want["corners"], atol=1e-4, rtol=0)


def test_sharded_step_equals_the_single_device_step(world, inputs):
    """The sharded step against the port's own step on one device over the
    same 8 frames: the same selection and classification (damage, labels,
    masks identical) and the same numbers (each frame's detection does not
    depend on its batch here: equal within 1e-6)."""
    yv, bv, batch = inputs["step"]
    want = full_scan_step(yolov10_from_flax(yv).eval(), beit_from_flax(bv).eval(), *batch, img_size=S,
                          max_det=D, conf_thresh=0.0, crop_budget=BUDGET, device="cpu")
    for res in world:
        got = res["scan_step"]
        for k in ("damage", "label", "mask"):
            np.testing.assert_array_equal(got[k], want[k].numpy())
        for k in ("boxes", "conf", "corners"):
            np.testing.assert_allclose(got[k], want[k].numpy(), atol=1e-6, rtol=0)


def test_query_sharded_compare_matches_jax(world, jax_side):
    """``Alignment(mesh=...)`` with 1023 query points (padded by repetition
    to 1024): the final transform and every recorded step within 1e-4 of
    JAX's sharded run, the verdict's reasons equal and its rmse and inlier
    fraction within 1e-5; both ranks hold the same transform, and rank 0
    alone the box assignment, equal to JAX's."""
    ja = jax_side["align"]
    r0, r1 = (res["icp_compare"] for res in world)
    np.testing.assert_allclose(r0["T"], ja.final_transform, atol=1e-4, rtol=0)
    assert np.array_equal(r0["T"], r1["T"])
    assert len(r0["steps"]) == len(ja.transformations) == 1 + 3 * ICP_KW["icp_iterations"]
    for x, y in zip(r0["steps"], ja.transformations):
        for u, v in zip(*((x, y) if isinstance(x, tuple) else ((x,), (y,)))):
            np.testing.assert_allclose(np.asarray(u), np.asarray(v), atol=1e-4, rtol=0)
    jv = ja.last_verdict.to_dict()
    assert r0["verdict"]["reasons"] == tuple(jv["reasons"]) and r0["verdict"]["ok"] == jv["ok"]
    for k in ("rmse", "inlier_frac"):
        assert abs(r0["verdict"][k] - jv[k]) <= 1e-5, k
    assert r1["match"] is None
    np.testing.assert_array_equal(r0["match"]["assign"], ja.last_match["assign"])


def test_cli_in_a_world_writes_the_default_config_on_rank_0(world, cli_config):
    """The CLI run by every rank of a world (as under ``torchrun``) with no
    config at ``--config``: rank 0 alone writes the defaults, and every
    rank reads them after the barrier and runs."""
    from tpu3dlm_torch.utils.config import DEFAULT_CONFIG

    for r, res in enumerate(world):
        got = res["cli_default_config"]
        assert got["wrote"] == ([cli_config] if r == 0 else [])
        assert got["ran"] == [("gold_std", 1)]
    assert open(cli_config).read() == DEFAULT_CONFIG


def test_a_failed_or_hung_rank_fails_the_world(tmp_path, monkeypatch):
    """A rank that raises, and a rank that never joins a collective (cut by
    the world's 3 s timeout, not the suite's clock), each make
    ``spawn_world`` raise; each world's store is removed."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="fails on purpose"):
        PM.spawn_world(legs.fail_on_rank1, 2, device="cpu", timeout_s=60)
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        PM.spawn_world(legs.hang_on_rank1, 2, device="cpu", timeout_s=3)
    assert os.listdir(tmp_path) == []


@pytest.mark.slow
def test_four_rank_smoke():
    """Four gloo ranks on the CPU through ``distributed_smoke`` (the
    reference's 4-process leg, ``tests/test_parallel.py``'s
    ``test_four_process_icp_alignment_legs``, is slow-tier too): every leg
    within the script's bars of one device, the ranks in agreement."""
    import json

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "tpu3dlm_torch.scripts.distributed_smoke", "--procs", "4",
                          "--device", "cpu"], capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-1500:] + out.stdout[-1500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["ok"] and rec["procs"] == 4 and rec["icp_rank_divergence"] == 0.0 and rec["nn_indices_exact"]
