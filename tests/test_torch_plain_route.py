"""``use_pallas = false`` in the port (the reference's escape hatch from its
kernels) on the CPU: the Pipeline through the CLI against the JAX
package's Pipeline with the same setting, and each function that gained
``use_pallas`` against its kernel route. On CPU tensors both routes are
B2's twin, so the functions must agree bit for bit, and the plain route
must never call the kernel's wrapper."""

import os
import shutil
import unittest.mock as mock

import numpy as np
import pytest
import torch

from tpu3dlm.pipeline import evaluate
from tpu3dlm.pipeline import task as JT
from tpu3dlm.utils.config import ConfigLoader as JCfg
from tpu3dlm_torch import cli
from tpu3dlm_torch.alignment import align as PA
from tpu3dlm_torch.ops import ann as PANN
from tpu3dlm_torch.ops import icp as PICP
from tpu3dlm_torch.parallel import nn as PNN
from tpu3dlm_torch.parallel.mesh import make_mesh, shard_batch
from tpu3dlm_torch.utils.config import ConfigLoader as PCfg

# one thread, as tests/test_torch_pipeline.py: the ICP sums then split as
# the JAX package's CPU reductions do, and the CSV's 4-decimal distances hold
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PLAIN = [("use_pallas = true", "use_pallas = false"), ("infer_dtype = bf16", "infer_dtype = f32")]


def cloud(rng, n):
    """Wall + floor + clutter (tests/test_torch_ann.py's geometry)."""
    n_wall, n_floor = n // 2, n // 3
    n_clut = n - n_wall - n_floor
    wall = np.stack([rng.uniform(0, 8, n_wall), rng.normal(0, 0.01, n_wall), rng.uniform(0, 3, n_wall)], -1)
    floor = np.stack([rng.uniform(0, 8, n_floor), rng.uniform(0, 5, n_floor), rng.normal(0, 0.01, n_floor)], -1)
    clut = rng.uniform([0, 0, 0], [8, 5, 3], (n_clut, 3))
    return torch.from_numpy(np.concatenate([wall, floor, clut]).astype(np.float32))


@pytest.fixture
def no_kernel_wrapper(monkeypatch):
    """Every module's B2 wrapper made to fail: the plain route must not
    touch it."""
    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called on the plain route")

    for module in (PICP, PANN, PNN):
        monkeypatch.setattr(module, "nearest_neighbors", refuse)


def test_cli_with_use_pallas_false_writes_the_jax_csv(tmp_path):
    """A ``make_project`` capture (3 frames a scan, 800 points/m², fixture
    checkpoints, f32, the default config's staged route and compare) with
    ``use_pallas = false``: the JAX two-scan Pipeline, and on a copy the
    port's CLI (``--data maintenance``: gold, then maintenance), which runs
    BEiT's einsum attention and B2's twin. The report CSV is byte-identical
    and flags one missing sign; the port's runs never call the B2 wrapper
    or the B1 op. (Cut to 4096 ICP points and 10 iterations a stage, the
    walks part at an f32 near-tie and one distance moves by 1e-4 m, as
    ROADMAP §C records for the 2-rank compare; the fused route's CSV is held
    to JAX's in tests/test_torch_pipeline.py.)"""
    fused = False
    extra = PLAIN
    root = str(tmp_path / "jax")
    cfg_jax, _, _, _ = evaluate.make_project(
        root, os.path.join(FIXTURES, "yolo_synthetic.msgpack"), os.path.join(FIXTURES, "beit_synthetic.msgpack"),
        extra_cfg=extra, num_frames=3, cloud_points_per_m2=800)
    port_root = str(tmp_path / "port")
    shutil.copytree(os.path.join(root, "configs"), os.path.join(port_root, "configs"))
    cfg_port = os.path.join(port_root, "configs", "variables.cfg")
    gold_cfg = JCfg(cfg_jax, "gold_std")
    assert not gold_cfg.use_pallas and gold_cfg.fused_inference == fused
    with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None):
        JT.setup_pipeline("gold_std", gold_cfg, None)
        maint = JT.setup_pipeline("maintenance", JCfg(cfg_jax, "maintenance"), gold_cfg,
                                  JT.load_gold_std(gold_cfg.pickle_path))

    def refuse(*a, **k):
        raise AssertionError("a kernel's wrapper was called under use_pallas = false")

    with mock.patch.object(PICP, "nearest_neighbors", refuse), mock.patch.object(PANN, "nearest_neighbors", refuse), \
            mock.patch("tpu3dlm_torch.models.beit.beit_attention_packed", refuse):
        cli.main(["--data", "maintenance", "--config", cfg_port, "--device", "cpu"])
    want = open(maint.cfg.csv_output, "rb").read()
    got = open(PCfg(cfg_port, "maintenance").csv_output, "rb").read()
    assert got == want
    assert sum(r["status"] == "missing" for r in maint.data_to_save["comparison_rows"]) == 1


def test_icp_plain_route_equals_the_kernel_route(no_kernel_wrapper):
    """Both solvers with ``use_pallas=False`` give the default route's
    transform, increments, rmse and inlier fraction exactly on CPU
    tensors (the same twin), without calling the wrapper."""
    rng = np.random.default_rng(0)
    tgt = cloud(rng, 4096)
    T = torch.eye(4)
    T[:3, 3] = torch.tensor([0.05, -0.03, 0.02])
    src = (tgt[::3] @ T[:3, :3].T + T[:3, 3]).contiguous()
    normals = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32)), dim=1)
    from tpu3dlm_torch.ops.kernels import pairwise

    for solve, args in ((PICP.icp, (src, tgt)), (PICP.icp_point_to_plane, (src, tgt, normals))):
        plain = solve(*args, iterations=5, use_pallas=False)
        with mock.patch.object(PICP, "nearest_neighbors", pairwise.nearest_neighbors):
            kernel = solve(*args, iterations=5)
        for a, b in zip((plain.transform, plain.step_transforms, plain.rmse, plain.inlier_frac),
                        (kernel.transform, kernel.step_transforms, kernel.rmse, kernel.inlier_frac)):
            assert torch.equal(a, b)


def test_init_scoring_and_anchor_index_plain_route(no_kernel_wrapper):
    """``init_residuals_batched`` and ``build_anchor_index`` with
    ``use_pallas=False``: identical to the kernel route on CPU tensors."""
    from tpu3dlm_torch.ops.kernels import pairwise

    rng = np.random.default_rng(1)
    tgt = cloud(rng, 8192)
    Ts = torch.eye(4).repeat(3, 1, 1)
    Ts[1, :3, 3] = 0.1
    Ts[2, :3, 3] = -0.2
    plain_res = PICP.init_residuals_batched(tgt[:512], tgt, Ts, use_pallas=False)
    plain_index = PANN.build_anchor_index(tgt, 128, 256, use_pallas=False)
    with mock.patch.object(PICP, "nearest_neighbors", pairwise.nearest_neighbors), \
            mock.patch.object(PANN, "nearest_neighbors", pairwise.nearest_neighbors):
        kernel_res = PICP.init_residuals_batched(tgt[:512], tgt, Ts)
        kernel_index = PANN.build_anchor_index(tgt, 128, 256)
    assert torch.equal(plain_res, kernel_res)
    for a, b in zip(plain_index, kernel_index):
        assert torch.equal(a, b)


def test_target_sharded_nn_plain_route(no_kernel_wrapper):
    """``target_sharded_nn(mesh, use_pallas=False)`` over a real 1-rank
    gloo world: B2's twin over the whole target, indices and d²."""
    from tpu3dlm_torch.ops.kernels.pairwise import nearest_neighbors_reference

    rng = np.random.default_rng(2)
    a, b = cloud(rng, 1000), cloud(rng, 5000)
    mesh = make_mesh(1, device="cpu")
    try:
        idx, d2 = PNN.target_sharded_nn(mesh, use_pallas=False)(a, torch.from_numpy(shard_batch(b.numpy(), mesh)))
    finally:
        mesh.close()
    want_idx, want_d2 = nearest_neighbors_reference(a, b)
    assert torch.equal(idx, want_idx) and torch.equal(d2, want_d2)


def test_compare_plain_route_equals_the_kernel_route(no_kernel_wrapper):
    """``Alignment(use_pallas=False).compare`` on a two-scan scene (ann
    "on": the index build and the anchored iterations, then the exact
    measurement) gives the default route's transform, steps and assignment
    exactly on the CPU; its gold and index cache entries are its own."""
    from tpu3dlm_torch.ops.kernels import pairwise
    from tpu3dlm_torch.scripts.bench_align import POSES, build_clouds

    base, comp, bb, cb, _ = build_clouds(20_000)
    kw = dict(base_cloud=base, comparison_cloud=comp, max_points=2048, icp_iterations=3, ann="on", device="cpu")
    PA._GOLD_CACHE.clear()
    PA._ANN_INDEX_CACHE.clear()
    plain = PA.Alignment(POSES, POSES, bb, cb, use_pallas=False, **kw)
    plain.compare("plain")
    assert plain.use_pallas is False and len(PA._GOLD_CACHE) == 1
    with mock.patch.object(PICP, "nearest_neighbors", pairwise.nearest_neighbors), \
            mock.patch.object(PANN, "nearest_neighbors", pairwise.nearest_neighbors):
        kernel = PA.Alignment(POSES, POSES, bb, cb, **kw)
        kernel.compare("kernel")
    assert kernel.use_pallas is True and len(PA._GOLD_CACHE) == 2  # keyed apart
    np.testing.assert_array_equal(plain.final_transform, kernel.final_transform)
    assert len(plain.transformations) == len(kernel.transformations)
    for a, b in zip(plain.transformations, kernel.transformations):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(plain.last_match["assign"], kernel.last_match["assign"])
    PA._GOLD_CACHE.clear()
    PA._ANN_INDEX_CACHE.clear()
