"""The watcher over a world of ranks against the JAX package's watcher on a
mesh, on the CPU. The port runs its user path, ``python -m
tpu3dlm_torch.cli --watch`` with ``mesh_devices = 2``: the CLI spawns two
gloo ranks, rank 0 watches the data root and every rank runs each
capture's Pipeline (fused step sharded by frames, compare query-sharded);
the ranks run single-threaded, as the JAX package's CPU reductions. JAX
runs ``ScanWatcher`` on the same config, its Pipeline on a mesh of two
virtual CPU devices. Both watch the committed capture (tests/fixtures/
torch_project) with a second maintenance capture beside it, at the
parity configuration (fixture checkpoints, fused route, f32), with the ICP
cut to 1024 query points and 5 iterations a stage for time (as
tests/test_torch_watch.py's real run). The bar is
tests/test_torch_parallel_pipeline.py's (ROADMAP §C): every report
field identical but the 0.1 mm-rounded distance, within 5e-4 m."""

import json
import os
import pickle
import shutil
import unittest.mock as mock

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_pipeline import records_close
from tpu3dlm.pipeline.watch import ScanWatcher as JaxWatcher
from tpu3dlm_torch import cli
from tpu3dlm_torch.pipeline.watch import DONE_SENTINEL

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CAPTURES = ["gold_std", "maintenance", "maintenance_2"]
DISTANCE_BAR_M = 5e-4


def watched_project(root: str) -> tuple[str, str]:
    data = chip_smoke.copy_project(root)
    shutil.copytree(os.path.join(data, "maintenance"), os.path.join(data, "maintenance_2"))
    cfg = chip_smoke.pipeline_config(root, [
        ("infer_dtype = bf16", "infer_dtype = f32"), ("mesh_devices = 1", "mesh_devices = 2"),
        ("icp_max_points = 16384", "icp_max_points = 1024"), ("icp_iterations = 30", "icp_iterations = 5"),
        ("yolo_weights =", f"yolo_weights = {FIXTURES}/yolo_synthetic.msgpack"),
        ("beit_weights =", f"beit_weights = {FIXTURES}/beit_synthetic.msgpack")])
    return cfg, data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg_jax, data_jax = watched_project(str(tmp_path_factory.mktemp("jax")))
    cfg_port, data_port = watched_project(str(tmp_path_factory.mktemp("port")))
    with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None):
        jax_watcher = JaxWatcher(cfg_jax, poll_interval=0.01, max_scans=3)
        jax_watcher.run()
    with mock.patch.dict(os.environ, {"OMP_NUM_THREADS": "1"}):
        cli.main(["--config", cfg_port, "--watch", "--poll-interval", "0.01", "--max-scans", "3",
                  "--device", "cpu"])
    return dict(jax=data_jax, port=data_port, jax_processed=jax_watcher.processed)


def test_cli_watches_over_two_ranks_and_writes_the_jax_reports(runs):
    """Every capture gets DONE in both packages; each maintenance report
    has JAX's header and rows, every field but the distance identical, the
    distance within 5e-4 m, one missing sign."""
    assert runs["jax_processed"] == CAPTURES
    for f in CAPTURES:
        assert os.path.exists(os.path.join(runs["port"], f, DONE_SENTINEL))
    for f in CAPTURES[1:]:
        got = open(os.path.join(runs["port"], f, "comparison_output.csv")).read().splitlines()
        want = open(os.path.join(runs["jax"], f, "comparison_output.csv")).read().splitlines()
        assert got[0] == want[0] and len(got) == len(want) == 4
        col = want[0].split(",").index("distance")
        for g, w in zip(got[1:], want[1:]):
            g, w = g.split(","), w.split(",")
            assert g[:col] + g[col + 1:] == w[:col] + w[col + 1:]
            assert abs(float(g[col]) - float(w[col])) <= DISTANCE_BAR_M
        assert sum(",missing," in line for line in got) == 1


def test_world_sentinels_match_jax(runs):
    """The DONE records: the same keys, frames, stages and missing count
    as the JAX watcher's."""
    for f in CAPTURES:
        got = json.load(open(os.path.join(runs["port"], f, DONE_SENTINEL)))
        want = json.load(open(os.path.join(runs["jax"], f, DONE_SENTINEL)))
        assert sorted(got) == sorted(want) and got["folder"] == want["folder"] == f
        assert got["frames"] == want["frames"] == 5
        assert list(got["stage_times"]) == list(want["stage_times"])
        assert got.get("missing") == want.get("missing")


def test_world_pickles_match_jax(runs):
    """Each capture's pickle, written by rank 0: detections within 1e-3 px,
    projected and kept boxes within 1e-4 m, labels and damage equal."""
    for f in CAPTURES:
        with open(os.path.join(runs["port"], f, "variables.pkl"), "rb") as fh:
            got = pickle.load(fh)
        with open(os.path.join(runs["jax"], f, "variables.pkl"), "rb") as fh:
            want = pickle.load(fh)
        assert sum(len(v) for v in want["predictions"].values()) > 0
        records_close(got["predictions"], want["predictions"], 1e-3)
        records_close(got["global_bboxes_data"], want["global_bboxes_data"], 1e-4)
        records_close(got["optimised_bboxes"], want["optimised_bboxes"], 1e-4)
        for c in ("tx", "ty", "tz", "qx", "qy", "qz", "qw"):
            np.testing.assert_array_equal(np.asarray(got["pose_df"][c], np.float32),
                                          want["pose_df"][c].to_numpy(dtype=np.float32))
