"""The port's map stage (``mapper/mapping.py`` and the Pipeline's
``visualise = true``) against the JAX package on the CPU, on the committed
capture (``tests/fixtures/torch_project``: two 5-frame scans, ~45k-point
clouds) at ``test_meshing.py``'s mesh settings (``eps = 0.1``,
``min_points = 50``, ``mesh_voxel = 0.08``).

The JAX Pipeline's own mesh test is slow (~4 min a setting), so the
reference here is the JAX package's functions on the same inputs:
``Mapping.make_mesh`` on the same ``cloud.ply`` and pose table, and
``mesh_scan`` on the same scan. Bars: the density and TSDF meshes
byte-identical (the same C++, and a fusion that follows XLA's rounding);
the Poisson solve's χ and iso within 1e-5 × max|χ| on the same points,
and its mesh within the planar-sheet bars of ``chip_smoke.hold_mesh`` (the
kept cloud is a wall on the grid's nodes, where rounding decides the
crossings: faces within 8%, ≤ 20% of the vertices farther than 1 mm from
the other mesh, every vertex within a voxel); the overlay geometry within
1e-6. With ``visualise`` on, the
maintenance CSV and report equal those of a run with it off, and a streamed
run skips the map with the reference's warning."""

import logging
import os

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from tpu3dlm.data.ply import load_ply_mesh as j_load_mesh
from tpu3dlm.data.ply import save_ply_mesh as j_save_mesh
from tpu3dlm.mapper import mapping as JMap
from tpu3dlm.mapper.meshing import mesh_scan as j_mesh_scan
from tpu3dlm_torch.data import dataset as PD
from tpu3dlm_torch.data.poses import load_poses, poses_to_frame
from tpu3dlm_torch.mapper import mapping as PMap
from tpu3dlm_torch.pipeline import task as PT
from tpu3dlm_torch.utils.config import ConfigLoader as PCfg

# as in test_torch_pipeline.py: one thread keeps the ICP sums in one order
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TEST_MESH_PATCH = [("eps = 0.04", "eps = 0.1"), ("mesh_voxel = 0.04", "mesh_voxel = 0.08")]
BASE_PATCH = chip_smoke.PROJECT_PATCH + TEST_MESH_PATCH + [
    ("fused_inference = false", "fused_inference = true"),
    ("infer_dtype = bf16", "infer_dtype = f32"),
    ("icp_max_points = 16384", "icp_max_points = 1024"),
    ("icp_iterations = 30", "icp_iterations = 3"),
    ("yolo_weights =", f"yolo_weights = {FIXTURES}/yolo_synthetic.msgpack"),
    ("beit_weights =", f"beit_weights = {FIXTURES}/beit_synthetic.msgpack"),
]
SETTINGS = chip_smoke.MESH_SETTINGS


def capture_frame(folder: str):
    """The committed capture's cloud path and pose table (PoseFrame and the
    JAX package's DataFrame with the same columns)."""
    ply = os.path.join(FIXTURES, "torch_project", "data", folder, "cloud.ply")
    ts, poses = load_poses(os.path.join(FIXTURES, "torch_project", "data", folder, "poses.txt"))
    frame = poses_to_frame(ts, poses)
    return ply, frame, pd.DataFrame({c: frame[c] for c in frame.columns})


def boxes_of(seed=5):
    rng = np.random.RandomState(seed)
    return {f: [[*rng.randn(4, 3).astype(np.float32), 0, 0.9, 1] for _ in range(f + 1)] for f in range(3)}


def hold_sheet(got, want, voxel=0.08):
    """The Poisson bars of a planar sheet (``chip_smoke.hold_mesh``): the
    capture's DBSCAN-kept cloud is a wall on the grid's nodes, its iso ≈ 0,
    and FFT rounding decides the crossings there. Measured at 0.08 with the
    trajectory's viewpoint: faces 3918 against 3974 (gold) and 4064 against
    4080 (maintenance), ≤ 5.5% of the vertices farther than 1 mm, the
    farthest 5.2 cm; with the centroid (gold) 4679 against 4829, 8.6%."""
    return chip_smoke.hold_mesh(got, want, voxel, sheet=True)


def hold_solve(points, voxel, viewpoint):
    """χ within 1e-5 × max|χ| and the iso within 1e-5 × max|χ| (the iso of a
    sheet is ≈ 0, so its own magnitude is no scale) on the same points."""
    from tpu3dlm.mapper.poisson import poisson_indicator as j_indicator
    from tpu3dlm_torch.mapper.poisson import poisson_indicator

    chi, lo, vox, iso = poisson_indicator(points, voxel=voxel, viewpoint=viewpoint, device="cpu")
    w_chi, w_lo, w_vox, w_iso = j_indicator(points, voxel=voxel, viewpoint=viewpoint)
    np.testing.assert_array_equal(lo, w_lo)
    scale = np.abs(w_chi).max()
    assert vox == w_vox and np.abs(chi - w_chi).max() <= 1e-5 * scale and abs(iso - w_iso) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# Mapping against the JAX Mapping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesher", ["density", "poisson"])
def test_make_mesh_matches_jax_mapping(tmp_path, mesher):
    ply, frame, df = capture_frame("gold_std")
    kw = dict(global_bboxes_data={}, optimised_bboxes={}, eps=0.1, min_points=50, ply_filepath=ply)
    port = PMap.Mapping(pose=frame, device="cpu", **kw)
    ref = JMap.Mapping(pose=df, **kw)
    got = port.make_mesh(str(tmp_path / "p.ply"), voxel=0.08, mesher=mesher)
    want = ref.make_mesh(str(tmp_path / "j.ply"), voxel=0.08, mesher=mesher)
    np.testing.assert_array_equal(port.points, ref.points)  # DBSCAN kept the same points
    assert 0.5 * 45399 < len(port.points) < 45399 and len(got[1]) > 1000
    if mesher == "density":
        assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    else:
        hold_solve(port.points, 0.08, port.camera_centroid())
        hold_sheet(got, want)
        hold_sheet(j_load_mesh(str(tmp_path / "p.ply")), want)


def test_poisson_without_a_pose_table_uses_the_centroid(tmp_path, caplog):
    ply, _, _ = capture_frame("gold_std")
    port = PMap.Mapping({}, {}, None, eps=0.1, min_points=50, ply_filepath=ply, device="cpu")
    ref = JMap.Mapping({}, {}, None, eps=0.1, min_points=50, ply_filepath=ply)
    with caplog.at_level(logging.WARNING):
        got = port.make_mesh(voxel=0.08, mesher="poisson")
    assert "cloud centroid" in caplog.text
    hold_sheet(got, ref.make_mesh(voxel=0.08, mesher="poisson"))
    with pytest.raises(ValueError, match="unknown mesher"):
        port.make_mesh(mesher="marching")


def test_make_point_cloud_matches_jax(tmp_path):
    ply, frame, df = capture_frame("maintenance")
    port = PMap.Mapping({}, {}, frame, eps=0.1, min_points=50, ply_filepath=ply, device="cpu")
    ref = JMap.Mapping({}, {}, df, eps=0.1, min_points=50, ply_filepath=ply)
    np.testing.assert_array_equal(port.make_point_cloud(str(tmp_path / "p.ply")),
                                  ref.make_point_cloud(str(tmp_path / "j.ply")))
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_overlay_geometry_within_1e6():
    ply, frame, df = capture_frame("gold_std")
    raw, opt = boxes_of(5), boxes_of(6)
    kw = dict(eps=0.1, min_points=50, ply_filepath=ply, overlay_pose=True, view_unprocessed_bboxes=True)
    got = PMap.Mapping(raw, opt, frame, device="cpu", **kw).overlay_geometry()
    want = JMap.Mapping(raw, opt, df, **kw).overlay_geometry()
    for key in ("optimised_boxes", "raw_boxes"):
        assert len(got[key]) == len(want[key]) == 6
        np.testing.assert_allclose(np.stack(got[key]), np.stack(want[key]), atol=1e-6)
    for key in ("pose_points", "pose_direction_lines"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6)
    plain = PMap.Mapping({}, {}, frame[["tx", "ty", "tz", "qx", "qy", "qz", "qw"]].to_numpy(np.float32),
                         eps=0.1, min_points=50, ply_filepath=ply, overlay_pose=True, device="cpu")
    np.testing.assert_allclose(plain.overlay_geometry()["pose_direction_lines"],
                               want["pose_direction_lines"], atol=1e-6)
    assert plain.box_line_sets() == []


# ---------------------------------------------------------------------------
# The whole slice: visualise = true through the Pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """The committed capture, gold then maintenance with ``visualise`` off:
    the records, CSV and report that the plotting runs must leave as they
    are."""
    root = str(tmp_path_factory.mktemp("map"))
    chip_smoke.copy_project(root)
    cfg = chip_smoke.write_config(root, BASE_PATCH)
    gold_cfg, maint_cfg = PCfg(cfg, "gold_std"), PCfg(cfg, "maintenance")
    gold = PT.setup_pipeline("gold_std", gold_cfg, None, device="cpu")
    gold_var = PT.load_gold_std(gold_cfg.pickle_path)
    maint = PT.setup_pipeline("maintenance", maint_cfg, gold_cfg, gold_var, device="cpu")
    assert "plot" not in maint.stage_times and maint.data_to_save["comparison_rows"]
    with open(maint_cfg.csv_output, "rb") as f:
        csv = f.read()
    return dict(root=root, gold=gold.data_to_save, csv=csv, rows=maint.data_to_save["comparison_rows"],
                gold_var=gold_var)


RECORDS = ("predictions", "global_bboxes_data", "optimised_bboxes")


def same_records(a: dict, b: dict) -> bool:
    return all(chip_smoke._records_err(a[k], b[k], 4) == 0 for k in RECORDS)


def vis_config(root: str, setting: str) -> str:
    return chip_smoke.write_config(root, BASE_PATCH + SETTINGS[setting] + [("visualise = false", "visualise = true")])


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_visualise_writes_the_map_mesh_of_the_reference(project, tmp_path, setting):
    """``Pipeline("gold_std", cfg).run()`` with ``visualise = true`` writes
    ``map_mesh.ply`` equal to the JAX package's functions' mesh on the same
    cloud or scan, and leaves the records as a run without it."""
    cfg = PCfg(vis_config(project["root"], setting), "gold_std")
    assert cfg.visualise
    p = PT.Pipeline("gold_std", cfg, device="cpu")
    out = p.run()
    assert "plot" in p.stage_times and "plot" not in out["stage_times"]
    assert same_records(out, project["gold"])
    mesh = os.path.join(os.path.dirname(cfg.ply_path), "map_mesh.ply")
    got = j_load_mesh(mesh)
    assert len(got[1]) > 1000
    ref = str(tmp_path / "ref.ply")
    if setting == "tsdf":
        scan = PD.load_scan(cfg.image_dir, cfg.depth_image_dir, cfg.calibration_dir, cfg.pose_path,
                            img_size=cfg.img_size, depth_width=cfg.depth_width, depth_height=cfg.depth_height)
        j_save_mesh(ref, *j_mesh_scan(scan, voxel=0.08))
        assert 2.5 < float(np.median(got[0][:, 2])) < 3.2  # the scene's z band
    else:
        frame = out["pose_df"]
        df = pd.DataFrame({c: frame[c] for c in frame.columns})
        JMap.Mapping({}, {}, df, eps=0.1, min_points=50, ply_filepath=cfg.ply_path).make_mesh(
            ref, voxel=0.08, mesher=cfg.mesher)
    if setting == "cloud/poisson":
        hold_sheet(got, j_load_mesh(ref))
    else:
        with open(mesh, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()


def test_visualise_leaves_the_report_and_csv_unchanged(project):
    """The maintenance run with ``visualise = true`` (the TSDF map): the same
    CSV bytes and report rows as without it, and its map written."""
    cfg_path = vis_config(project["root"], "tsdf")
    cfg, gold = PCfg(cfg_path, "maintenance"), PCfg(cfg_path, "gold_std")
    p = PT.Pipeline("maintenance", cfg, gold, project["gold_var"], device="cpu")
    out = p.run()
    assert list(p.stage_times) == ["extract", "detect", "map", "plot", "compare"]
    with open(cfg.csv_output, "rb") as f:
        assert f.read() == project["csv"]
    assert out["comparison_rows"] == project["rows"]
    assert len(j_load_mesh(os.path.join(os.path.dirname(cfg.ply_path), "map_mesh.ply"))[1]) > 1000


def test_streamed_run_skips_the_map_with_a_warning(project, caplog):
    cfg_path = chip_smoke.write_config(project["root"], BASE_PATCH + [
        ("visualise = false", "visualise = true"), ("streaming_chunk = 0", "streaming_chunk = 2")])
    cfg = PCfg(cfg_path, "gold_std")
    mesh = os.path.join(os.path.dirname(cfg.ply_path), "map_mesh.ply")
    if os.path.exists(mesh):
        os.remove(mesh)
    with caplog.at_level(logging.WARNING):
        p = PT.Pipeline("gold_std", cfg, device="cpu")
        p.run()
    assert "visualise skipped" in caplog.text
    assert "plot" not in p.stage_times and not os.path.exists(mesh)


def test_mapping_harness_writes_the_map(project):
    cfg_path = chip_smoke.write_config(project["root"], BASE_PATCH)
    out = PMap.main(["--data", "gold_std", "--model", "pc", "--config", cfg_path, "--device", "cpu"])
    cfg = PCfg(cfg_path, "gold_std")
    assert out == os.path.join(os.path.dirname(cfg.ply_path), "map_pc.ply")
    ref = JMap.Mapping({}, {}, None, eps=0.1, min_points=50, ply_filepath=cfg.ply_path).make_point_cloud()
    from tpu3dlm.data.ply import load_ply

    np.testing.assert_array_equal(load_ply(out)[0], ref)
