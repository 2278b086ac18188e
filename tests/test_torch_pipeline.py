"""The whole fourth slice of the port against the JAX package on the CPU:
the two-scan Pipeline (fused route) and the CLI on a ``make_project``
capture — 3 frames a scan, 800 points/m², the fixture checkpoints,
``fused_inference = true``, ``infer_dtype = f32`` — with the bars of
``chip_smoke.py``'s ``pipeline_parity`` at CPU-vs-JAX tolerances: masks,
labels and damage equal, boxes within 1e-3 px, corners within 1e-4 m, the
NMS keep-mask identical, transforms and every ICP step within 1e-4, verdict
reasons, report rows and CSV bytes identical, exactly one missing sign.

The port runs once, through the CLI (``--data maintenance`` on a capture
without a gold pickle runs gold, then maintenance), and its two Pipelines
are held against one JAX two-scan run. The JAX normals take their numpy
path (as in ``test_torch_alignment.py``), which the port reproduces."""

import os
import pickle
import shutil
import unittest.mock as mock

import numpy as np
import pytest
import torch

import chip_smoke
from tpu3dlm.pipeline import evaluate
from tpu3dlm.pipeline import task as JT
from tpu3dlm.utils.config import ConfigLoader as JCfg
from tpu3dlm_torch import cli
from tpu3dlm_torch.pipeline import task as PT
from tpu3dlm_torch.utils.config import ConfigLoader as PCfg

# one thread, as the JAX package's CPU reductions: with more, torch splits
# the ICP sums differently and the report's 4-decimal distances can flip
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
EXTRA = [("fused_inference = false", "fused_inference = true"),
         ("infer_dtype = bf16", "infer_dtype = f32")]


def two_scans(cfg_path, T, Cfg, **kw):
    gold_cfg, maint_cfg = Cfg(cfg_path, "gold_std"), Cfg(cfg_path, "maintenance")
    gold = T.setup_pipeline("gold_std", gold_cfg, None, **kw)
    maint = T.setup_pipeline("maintenance", maint_cfg, gold_cfg, T.load_gold_std(gold_cfg.pickle_path), **kw)
    return gold, maint


def run_both(tmp_path_factory, extra):
    """One make_project capture through the JAX two-scan Pipeline and, on a
    copy, through the port's CLI on the CPU."""
    root = str(tmp_path_factory.mktemp("jax"))
    cfg_jax, _, _, _ = evaluate.make_project(
        root, os.path.join(FIXTURES, "yolo_synthetic.msgpack"),
        os.path.join(FIXTURES, "beit_synthetic.msgpack"), extra_cfg=extra, num_frames=3,
        cloud_points_per_m2=800)
    port_root = str(tmp_path_factory.mktemp("port"))
    shutil.copytree(os.path.join(root, "configs"), os.path.join(port_root, "configs"))
    cfg_port = os.path.join(port_root, "configs", "variables.cfg")
    with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None):
        jax_runs = two_scans(cfg_jax, JT, JCfg)
    seen = []
    real = PT.setup_pipeline
    with mock.patch.object(PT, "setup_pipeline", lambda *a, **k: seen.append(real(*a, **k)) or seen[-1]):
        cli.main(["--data", "maintenance", "--config", cfg_port, "--device", "cpu"])
    assert [p.data_folder for p in seen] == ["gold_std", "maintenance"]
    return dict(jax=jax_runs, port=tuple(seen), cfg_jax=cfg_jax, cfg_port=cfg_port)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory, EXTRA)


@pytest.fixture(scope="module")
def stream_runs(tmp_path_factory):
    """The same, streamed in chunks of 2 frames (the last one padded)."""
    return run_both(tmp_path_factory, EXTRA + [("streaming_chunk = 0", "streaming_chunk = 2")])


def records_close(got: dict, want: dict, tol: float):
    """Same frames, record counts, damage and labels; coordinates within tol."""
    assert got.keys() == want.keys()
    for f in want:
        assert len(got[f]) == len(want[f]), f
        for a, b in zip(got[f], want[f]):
            assert a[4] == b[4] and a[6] == b[6], (f, a[4:], b[4:])
            np.testing.assert_allclose(np.asarray(a[:4], np.float64), np.asarray(b[:4], np.float64),
                                       rtol=0, atol=tol)
            assert abs(a[5] - b[5]) <= 1e-4


def test_detections_boxes_and_nms_match_jax(runs):
    for j, p in zip(runs["jax"], runs["port"]):
        a, b = p.data_to_save, j.data_to_save
        assert sum(len(v) for v in b["predictions"].values()) > 0
        records_close(a["predictions"], b["predictions"], 1e-3)
        records_close(a["global_bboxes_data"], b["global_bboxes_data"], 1e-4)
        records_close(a["optimised_bboxes"], b["optimised_bboxes"], 1e-4)
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(a["pose_df"][chip_smoke_cols()].to_numpy(dtype=np.float32),
                                      b["pose_df"][chip_smoke_cols()].to_numpy(dtype=np.float32))
        np.testing.assert_array_equal(a["pose_df"]["timestamp"].astype(np.int64),
                                      b["pose_df"]["timestamp"].values.astype(np.int64))


def chip_smoke_cols():
    return ["tx", "ty", "tz", "qx", "qy", "qz", "qw"]


def test_streaming_pipeline_matches_jax_and_writes_the_same_csv(stream_runs, runs):
    """``streaming_chunk = 2`` on both packages: detections, boxes and NMS
    as above, the comparison CSV byte-identical to the JAX package's, and
    the same records as the whole-scan run (the crop budget does not
    bind)."""
    for j, p, w in zip(stream_runs["jax"], stream_runs["port"], runs["port"]):
        a, b = p.data_to_save, j.data_to_save
        assert p.cfg.streaming_chunk == 2 and sum(len(v) for v in b["predictions"].values()) > 0
        records_close(a["predictions"], b["predictions"], 1e-3)
        records_close(a["global_bboxes_data"], b["global_bboxes_data"], 1e-4)
        records_close(a["optimised_bboxes"], b["optimised_bboxes"], 1e-4)
        records_close(a["optimised_bboxes"], w.data_to_save["optimised_bboxes"], 1e-4)
        assert list(p.stage_times) == list(j.stage_times)
    csv = [open(stream_runs[k][1].cfg.csv_output, "rb").read() for k in ("port", "jax")]
    assert csv[0] == csv[1] and csv[0].count(b"missing") == 1


def test_compare_matches_jax(runs):
    a, b = runs["port"][1].data_to_save, runs["jax"][1].data_to_save
    assert len(a["transformations"]) == len(b["transformations"])
    assert chip_smoke._steps_err(a["transformations"], b["transformations"]) <= 1e-4
    va, vb = a["alignment_verdict"], b["alignment_verdict"]
    assert va["reasons"] == vb["reasons"] and va["ok"] == vb["ok"]
    assert abs(va["rmse"] - vb["rmse"]) <= 1e-5 and abs(va["inlier_frac"] - vb["inlier_frac"]) <= 1e-5
    assert a["comparison_rows"] == b["comparison_rows"]
    assert sum(r["status"] == "missing" for r in a["comparison_rows"]) == 1
    assert a["aligned_bboxes"].keys() == b["aligned_bboxes"].keys()
    csv = [open(runs[k][1].cfg.csv_output, "rb").read() for k in ("port", "jax")]
    assert csv[0] == csv[1]


def test_pickle_keys_and_stage_names_match_jax(runs):
    for j, p in zip(runs["jax"], runs["port"]):
        with open(p.cfg.pickle_path, "rb") as f:
            got = pickle.load(f)
        with open(j.cfg.pickle_path, "rb") as f:
            want = pickle.load(f)
        assert list(got) == list(want) == ["predictions", "global_bboxes_data", "optimised_bboxes",
                                           "pose_df", "stage_times"]
        assert list(got["stage_times"]) == list(want["stage_times"])
        assert list(p.stage_times) == list(j.stage_times)
    assert list(runs["port"][1].stage_times) == ["extract", "detect", "map", "compare"]


def test_resume_skips_detect_and_reprojects(runs):
    gold = runs["port"][0]
    resumed = PT.Pipeline("gold_std", gold.cfg, device="cpu")
    out = resumed.run(resume=True)
    assert "detect" not in resumed.stage_times
    assert out["predictions"] == gold.data_to_save["predictions"]
    records_close(out["global_bboxes_data"], gold.data_to_save["global_bboxes_data"], 1e-4)
    records_close(out["optimised_bboxes"], gold.data_to_save["optimised_bboxes"], 1e-4)


def test_cli_writes_the_same_csv(runs):
    got = open(PCfg(runs["cfg_port"], "maintenance").csv_output, "rb").read()
    want = open(runs["jax"][1].cfg.csv_output, "rb").read()
    assert got == want and got.count(b"missing") == 1


def test_project_patch_is_make_projects():
    assert chip_smoke.PROJECT_PATCH == evaluate._cfg_patch(evaluate.IMG_SIZE, evaluate.BEIT_KW)


def test_cli_mode_logic(tmp_path, monkeypatch):
    """Gold alone for ``--data gold_std``; otherwise gold first when its
    pickle is missing or unreadable, then the folder with the baseline."""
    cfg = str(tmp_path / "configs" / "variables.cfg")
    calls = []

    def fake_setup(folder, c, c_gold=None, goldstd_var=None, device=None):
        calls.append((folder, c_gold is not None, goldstd_var))
        if folder == "gold_std":
            os.makedirs(os.path.dirname(c.pickle_path), exist_ok=True)
            with open(c.pickle_path, "wb") as f:
                pickle.dump({"gold": 1}, f)

    monkeypatch.setattr(PT, "setup_pipeline", fake_setup)
    cli.main(["--data", "gold_std", "--config", cfg, "--device", "cpu"])  # writes the default config
    assert os.path.exists(cfg) and calls == [("gold_std", False, None)]
    calls.clear()
    cli.main(["--data", "maintenance", "--config", cfg, "--device", "cpu"])
    assert calls == [("maintenance", True, {"gold": 1})]
    calls.clear()
    os.remove(PCfg(cfg, "gold_std").pickle_path)
    cli.main(["--data", "maintenance", "--config", cfg, "--device", "cpu"])
    assert calls == [("gold_std", False, None), ("maintenance", True, {"gold": 1})]
    calls.clear()
    with open(PCfg(cfg, "gold_std").pickle_path, "wb") as f:
        f.write(b"\x80\x04truncated")
    cli.main(["--data", "maintenance", "--config", cfg, "--device", "cpu"])
    assert calls == [("gold_std", False, None), ("maintenance", True, {"gold": 1})]
    calls.clear()
    cli.main(["--data", "gold_std", "--setup", "--config", cfg, "--device", "cpu"])  # writes the capture first
    gold = PCfg(cfg, "gold_std")
    assert calls == [("gold_std", False, None)] and len(os.listdir(gold.image_dir)) == 8


@pytest.mark.parametrize("line,item", [
    ("view_img = false", "A18"),
    ("alignment_vis = false", "A18"),
    ("comparison_vis = false", "A18"),
    ("use_pallas = true", "plain PyTorch"),
    ("mesh_devices = 1", "A22"),
])
def test_unported_settings_raise_before_work(tmp_path, line, item):
    """The settings the port cannot run raise before any work. The three
    views of a run (A18) are ported now: they no longer raise, and are not
    listed by ``unsupported_settings``. So is ``mesh_devices > 1`` (A22):
    it is not listed, and the Pipeline joins the running world of that many
    ranks; with none running (a world smaller than asked) it raises
    ``ValueError`` before any work. tests/test_torch_parallel_pipeline.py
    runs it, through the CLI, on 2 ranks."""
    change = {"view_img = false": "view_img = true",
              "alignment_vis = false": "alignment_vis = true", "comparison_vis = false": "comparison_vis = true",
              "use_pallas = true": "use_pallas = false",
              "mesh_devices = 1": "mesh_devices = 2"}[line]
    cfg = chip_smoke.write_config(str(tmp_path), [("fused_inference = false", "fused_inference = true"),
                                                 (line, change)])
    c = PCfg(cfg, "gold_std")
    if item == "A18":
        assert PT.unsupported_settings(c) == [] and getattr(c, line.split()[0])
        PT.Pipeline("gold_std", c, device="cpu")
        return
    if item == "A22":
        assert PT.unsupported_settings(c) == [] and c.mesh_devices == 2
        with pytest.raises(ValueError, match="no world is running"):
            PT.setup_pipeline("gold_std", c, None, device="cpu")
        assert not os.path.exists(c.pickle_path) and not os.path.exists(c.depth_image_dir)
        assert not torch.distributed.is_initialized()
        return
    with pytest.raises(NotImplementedError, match=item):
        PT.setup_pipeline("gold_std", c, None, device="cpu")
    assert not os.path.exists(c.pickle_path) and not os.path.exists(c.depth_image_dir)


def test_streaming_chunk_is_ignored_on_the_staged_route(tmp_path, caplog):
    """Under ``fused_inference = false`` the reference warns that
    ``streaming_chunk`` needs the fused route and runs on; so does the
    port (the staged route, on the committed capture)."""
    chip_smoke.copy_project(str(tmp_path))
    cfg = chip_smoke.write_config(str(tmp_path), chip_smoke.PROJECT_PATCH + [
        ("streaming_chunk = 0", "streaming_chunk = 32"), ("infer_dtype = bf16", "infer_dtype = f32"),
        ("yolo_weights =", f"yolo_weights = {FIXTURES}/yolo_synthetic.msgpack"),
        ("beit_weights =", f"beit_weights = {FIXTURES}/beit_synthetic.msgpack")])
    c = PCfg(cfg, "gold_std")
    assert c.streaming_chunk == 32 and not c.fused_inference
    with caplog.at_level("WARNING"):
        p = PT.setup_pipeline("gold_std", c, None, device="cpu")
    assert any("streaming_chunk = 32 ignored" in r.getMessage() for r in caplog.records)
    assert list(p.stage_times) == ["extract", "detect", "map"] and os.path.exists(c.pickle_path)
    assert len(p.data_to_save["predictions"]) == 5


def test_cuda_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device resolves")
    cfg = chip_smoke.write_config(str(tmp_path), [("fused_inference = false", "fused_inference = true")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.Pipeline("gold_std", PCfg(cfg, "gold_std"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--data", "gold_std", "--config", cfg])
