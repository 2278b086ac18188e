"""The two-scan Pipeline with ``mesh_devices = 2`` (fused route: frames
sharded over the ranks; the compare's ICP queries sharded) against the JAX
package's run with ``mesh_devices = 2`` on two of its virtual CPU devices,
on a ``make_project`` capture (3 frames a scan, the fixture checkpoints,
f32), as tests/test_torch_pipeline.py holds the single-device run, with
the compare cut for time to 4096 ICP points and 10 iterations a stage
(the config's 16384 and 30 take ~2 minutes here; tests/torch_icp_walk.py
runs both sizes). The port
runs through its CLI, which starts the 2-rank gloo world itself (no world
is running) and whose rank 0 writes the files; the ranks run single-threaded
(``OMP_NUM_THREADS=1``), as the JAX package's CPU reductions."""

import os
import pickle
import shutil
import unittest.mock as mock

import numpy as np
import pytest
import torch

from test_torch_pipeline import EXTRA, FIXTURES, records_close, two_scans
from tpu3dlm.pipeline import evaluate
from tpu3dlm.pipeline import task as JT
from tpu3dlm.utils.config import ConfigLoader as JCfg
from tpu3dlm_torch import cli
from tpu3dlm_torch.utils.config import ConfigLoader as PCfg

torch.set_num_threads(1)

ICP_CUT = [("icp_max_points = 16384", "icp_max_points = 4096"), ("icp_iterations = 30", "icp_iterations = 10")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax"))
    cfg_jax, _, _, _ = evaluate.make_project(
        root, os.path.join(FIXTURES, "yolo_synthetic.msgpack"), os.path.join(FIXTURES, "beit_synthetic.msgpack"),
        extra_cfg=EXTRA + [("mesh_devices = 1", "mesh_devices = 2")] + ICP_CUT, num_frames=3,
        cloud_points_per_m2=800)
    port_root = str(tmp_path_factory.mktemp("port"))
    shutil.copytree(os.path.join(root, "configs"), os.path.join(port_root, "configs"))
    cfg_port = os.path.join(port_root, "configs", "variables.cfg")
    with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None):
        jax_runs = two_scans(cfg_jax, JT, JCfg)
    with mock.patch.dict(os.environ, {"OMP_NUM_THREADS": "1"}):
        cli.main(["--data", "maintenance", "--config", cfg_port, "--device", "cpu"])
    return dict(jax=jax_runs, cfg_port=cfg_port)


def test_two_rank_pipeline_writes_the_jax_csv(runs):
    """The report CSV equal to the JAX package's two-device run, exactly one
    missing sign, every field identical but the 0.1 mm-rounded distance,
    held within 5e-4 m. On this capture one distance comes out 1e-4 m
    apart (0.0316 against 0.0317; at the config's ICP size two, 2e-4 m).
    tests/torch_icp_walk.py shows why: replayed from JAX's own transform,
    the port's two-rank ICP iteration equals JAX's two-device one within
    1.7e-7 wherever the two pick the same correspondences, and its own
    one-device iteration within 4.1e-7; at 4 of the 30 iterations B2's
    twin and XLA pick another of two near-equidistant targets for 1 or 2
    of the 4096 query rows, which moves that increment by up to 1.1e-5.
    Every stage runs to its iteration cap (the increments never fall below
    the 1e-5 tolerance; the f32 step is ~1.1e-5 from float64 either way),
    so the gaps add up: the final transforms 2.6e-5 apart (ROADMAP §C)."""
    assert PCfg(runs["cfg_port"], "maintenance").mesh_devices == 2
    got = open(PCfg(runs["cfg_port"], "maintenance").csv_output).read().splitlines()
    want = open(runs["jax"][1].cfg.csv_output).read().splitlines()
    assert got[0] == want[0] and len(got) == len(want) == 4
    col = want[0].split(",").index("distance")
    for g, w in zip(got[1:], want[1:]):
        g, w = g.split(","), w.split(",")
        assert g[:col] + g[col + 1:] == w[:col] + w[col + 1:]
        assert abs(float(g[col]) - float(w[col])) <= 5e-4
    assert sum(",missing," in line for line in got) == 1


def test_two_rank_pickles_match_jax(runs):
    """Each scan's pickle, written by rank 0: the same keys and stages as
    the JAX run's, detections within 1e-3 px, projected and kept boxes
    within 1e-4 m, with equal labels and damage."""
    for folder, j in zip(("gold_std", "maintenance"), runs["jax"]):
        with open(PCfg(runs["cfg_port"], folder).pickle_path, "rb") as f:
            got = pickle.load(f)
        want = j.data_to_save
        assert list(got) == ["predictions", "global_bboxes_data", "optimised_bboxes", "pose_df", "stage_times"]
        assert list(got["stage_times"]) == list(j.stage_times)[:len(got["stage_times"])]
        assert sum(len(v) for v in want["predictions"].values()) > 0
        records_close(got["predictions"], want["predictions"], 1e-3)
        records_close(got["global_bboxes_data"], want["global_bboxes_data"], 1e-4)
        records_close(got["optimised_bboxes"], want["optimised_bboxes"], 1e-4)
        for c in ("tx", "ty", "tz", "qx", "qy", "qz", "qw"):
            np.testing.assert_array_equal(np.asarray(got["pose_df"][c], np.float32),
                                          want["pose_df"][c].to_numpy(dtype=np.float32))
