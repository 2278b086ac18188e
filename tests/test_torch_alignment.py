"""The whole second slice of the port against the JAX package on the CPU:
``Alignment.compare`` + ``BBoxComparison.match_bboxes`` on a small two-scan
scene (``chip_smoke.two_scan_scene``, the scene of ``bench_align.py``) with
``global_init="auto"`` and ``ann="off"``, JAX normals forced onto their numpy
path. The transform, every recorded step, the verdict, the assignment and
the CSV bytes must agree."""

import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu3dlm.alignment import align as JA
from tpu3dlm.alignment import comparison as JC
from tpu3dlm_torch.alignment import align as PA
from tpu3dlm_torch.alignment import comparison as PC

torch.set_num_threads(1)

POSES = chip_smoke.IDENTITY_POSES
KW = dict(max_points=1024, icp_iterations=10, global_init="auto", ann="off")


def steps_close(a, b, tol):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert isinstance(x, tuple) == isinstance(y, tuple)
        for u, v in zip(*((x, y) if isinstance(x, tuple) else ((x,), (y,)))):
            np.testing.assert_allclose(np.asarray(u), np.asarray(v), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compare")
    scene = chip_smoke.two_scan_scene(20000, 3)
    base, comp, bb, cb, Tw = scene
    JA._GOLD_CACHE.clear()
    PA._GOLD_CACHE.clear()
    with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None):
        ja = JA.Alignment(POSES, POSES, bb, cb, base_cloud=base, comparison_cloud=comp, **KW)
        j_out = ja.compare("test")
    JA._GOLD_CACHE.clear()
    pa = PA.Alignment(POSES, POSES, bb, cb, base_cloud=base, comparison_cloud=comp,
                      device="cpu", **KW)
    p_out = pa.compare("test")
    paths = {k: str(tmp / f"{k}.csv") for k in ("jax", "port")}
    j_rows = JC.BBoxComparison(bb, j_out[0], None, csv_output_file=paths["jax"],
                               precomputed_match=ja.last_match,
                               alignment_verdict=ja.last_verdict.to_dict()).match_bboxes()
    p_rows = PC.BBoxComparison(bb, p_out[0], None, csv_output_file=paths["port"],
                               precomputed_match=pa.last_match,
                               alignment_verdict=pa.last_verdict.to_dict(),
                               device="cpu").match_bboxes()
    return dict(scene=scene, ja=ja, pa=pa, j_out=j_out, p_out=p_out, j_rows=j_rows,
                p_rows=p_rows, paths=paths, tmp=tmp)


def test_compare_matches_jax(runs):
    ja, pa, Tw = runs["ja"], runs["pa"], runs["scene"][4]
    np.testing.assert_allclose(pa.final_transform, ja.final_transform, rtol=0, atol=1e-4)
    assert len(pa.transformations) == 1 + 3 * KW["icp_iterations"]
    steps_close(pa.transformations, ja.transformations, 1e-4)
    assert np.abs(pa.final_transform @ Tw - np.eye(4)).max() <= 0.15
    jv, pv = ja.last_verdict, pa.last_verdict
    assert pv.reasons == jv.reasons and pv.ok == jv.ok
    assert abs(pv.rmse - jv.rmse) <= 1e-5 and abs(pv.inlier_frac - jv.inlier_frac) <= 1e-5
    assert pv.n_anchor_boxes == jv.n_anchor_boxes
    np.testing.assert_array_equal(pa.last_match["assign"], ja.last_match["assign"])
    assert {k: v for k, v in pa.last_match.items() if k != "assign"} == \
        {k: v for k, v in ja.last_match.items() if k != "assign"}
    # the returned maps and aligned boxes
    j_boxes, _, j_base, j_comp = runs["j_out"]
    p_boxes, _, p_base, p_comp = runs["p_out"]
    np.testing.assert_array_equal(p_base, j_base)
    np.testing.assert_allclose(p_comp, j_comp, rtol=0, atol=1e-3)
    assert p_boxes.keys() == j_boxes.keys()


def test_report_csv_bytes_identical(runs):
    assert runs["p_rows"] == runs["j_rows"]
    assert sum(r["status"] == "missing" for r in runs["p_rows"]) == 1
    with open(runs["paths"]["port"], "rb") as f1, open(runs["paths"]["jax"], "rb") as f2:
        assert f1.read() == f2.read()


def test_auction_report_matches_jax(runs):
    """No precomputed match: the port's auction over the bucket-padded cost,
    with a damage-name map, writes the same CSV as the JAX package's."""
    bb = runs["scene"][2]
    names = {0: "intact", 1: "damaged"}
    out = {}
    for key, mod, aligned, extra in (("jax", JC, runs["j_out"][0], {}),
                                     ("port", PC, runs["p_out"][0], {"device": "cpu"})):
        path = str(runs["tmp"] / f"auction_{key}.csv")
        mod.BBoxComparison(bb, aligned, None, csv_output_file=path, id2damage=names,
                           **extra).match_bboxes()
        out[key] = open(path, "rb").read()
    assert out["port"] == out["jax"]
    assert b"missing" in out["port"] and b"alignment" not in out["port"]


def test_box_anchor_residuals_match_jax_and_host(rng):
    base = [{"frame": 0, "corners": rng.uniform(-2, 2, (4, 3)).astype(np.float32),
             "damage": 0, "conf": 0.9, "label": i % 3} for i in range(5)]
    comp = [{"frame": 0, "corners": rng.uniform(-2, 2, (4, 3)).astype(np.float32),
             "damage": 0, "conf": 0.9, "label": 7 if i == 2 else i % 3} for i in range(4)]
    Ts = np.stack([np.eye(4, dtype=np.float32)] * 3)
    Ts[1, :3, 3] = [0.3, -0.2, 0.1]
    Ts[2, :3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    arrays = [*PA._pad_box_arrays(base), *PA._pad_box_arrays(comp)]
    for got, want in zip(arrays, [*JA._pad_box_arrays(base), *JA._pad_box_arrays(comp)]):
        np.testing.assert_array_equal(got, want)
    got = PA._box_anchor_residuals(torch.from_numpy(Ts), *map(torch.from_numpy, arrays)).numpy()
    want = np.asarray(JA._box_anchor_residuals(jnp.asarray(Ts), *map(jnp.asarray, arrays)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    align = PA.Alignment(np.zeros((1, 7)), np.zeros((1, 7)), {}, {}, device="cpu")
    align.base_records, align.comparison_records = base, comp
    host = [align._box_residual(T) for T in Ts]
    np.testing.assert_allclose(got, host, rtol=1e-5, atol=1e-5)


def test_host_helpers_identical(rng):
    x = rng.normal(size=(50_000, 3)).astype(np.float32)
    assert PA._target_fingerprint(x) == JA._target_fingerprint(x)
    for n in (100, 20_000, 60_000):
        np.testing.assert_array_equal(PA._subsample(x, n), JA._subsample(x, n))
        np.testing.assert_array_equal(PA._subsample(x, n, seed=1), JA._subsample(x, n, seed=1))

    class Frame:  # duck-typed DataFrame: the port never imports pandas
        columns = ["tx", "ty", "tz", "qx", "qy", "qz", "qw"]

        def __init__(self, arr):
            self.arr = arr

        def __getitem__(self, cols):
            return Frame(self.arr[:, [self.columns.index(c) for c in cols]])

        def to_numpy(self, dtype):
            return self.arr.astype(dtype)

    poses = rng.normal(size=(6, 7))
    np.testing.assert_array_equal(PA._poses_to_array(Frame(poses)), poses.astype(np.float32))
    np.testing.assert_array_equal(PA._poses_to_array(poses), JA._poses_to_array(poses))


def test_compare_with_the_anchor_index_matches_jax(tmp_path, monkeypatch):
    """``ann="on"``: every ICP stage iterates on the anchor index over the
    padded target (32,768 points: 256 anchors, buckets of 512), built by the
    port from the anchors JAX draws; the compare's bars as above."""
    import jax

    from tpu3dlm_torch.ops import ann as PANN

    def jax_anchor_ids(m, c, seed):
        perm = jax.random.permutation(jax.random.PRNGKey(seed), m)[:c]
        return torch.from_numpy(np.asarray(perm).astype(np.int64))

    monkeypatch.setattr(PANN, "sample_anchor_ids", jax_anchor_ids)
    base, comp, bb, cb, Tw = chip_smoke.two_scan_scene(20000, 3)
    kw = {**KW, "ann": "on"}
    JA._GOLD_CACHE.clear()
    JA._ANN_INDEX_CACHE.clear()
    PA._GOLD_CACHE.clear()
    PA._ANN_INDEX_CACHE.clear()
    with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None):
        ja = JA.Alignment(POSES, POSES, bb, cb, base_cloud=base, comparison_cloud=comp, **kw)
        j_out = ja.compare("test")
    pa = PA.Alignment(POSES, POSES, bb, cb, base_cloud=base, comparison_cloud=comp, device="cpu", **kw)
    p_out = pa.compare("test")
    assert len(JA._ANN_INDEX_CACHE) == len(PA._ANN_INDEX_CACHE) == 1
    (p_index,) = PA._ANN_INDEX_CACHE.values()
    (j_index,) = JA._ANN_INDEX_CACHE.values()
    assert p_index.buckets.shape == (256, 512, 3)
    for got, want in zip(p_index, j_index):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(pa.final_transform, ja.final_transform, rtol=0, atol=1e-4)
    steps_close(pa.transformations, ja.transformations, 1e-4)
    assert np.abs(pa.final_transform @ Tw - np.eye(4)).max() <= 0.15
    jv, pv = ja.last_verdict, pa.last_verdict
    assert pv.reasons == jv.reasons and pv.ok == jv.ok
    assert abs(pv.rmse - jv.rmse) <= 1e-5 and abs(pv.inlier_frac - jv.inlier_frac) <= 1e-5
    np.testing.assert_array_equal(pa.last_match["assign"], ja.last_match["assign"])
    paths = {k: str(tmp_path / f"{k}.csv") for k in ("jax", "port")}
    j_rows = JC.BBoxComparison(bb, j_out[0], None, csv_output_file=paths["jax"],
                               precomputed_match=ja.last_match,
                               alignment_verdict=jv.to_dict()).match_bboxes()
    p_rows = PC.BBoxComparison(bb, p_out[0], None, csv_output_file=paths["port"],
                               precomputed_match=pa.last_match, alignment_verdict=pv.to_dict(),
                               device="cpu").match_bboxes()
    assert p_rows == j_rows and sum(r["status"] == "missing" for r in p_rows) == 1
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    # a second capture against the same gold cloud reuses the index
    PA.Alignment(POSES, POSES, bb, cb, base_cloud=base, comparison_cloud=comp, device="cpu", **kw).compare()
    assert list(PA._ANN_INDEX_CACHE.values()) == [p_index]


def test_index_for_engages_like_the_reference(monkeypatch):
    """"off" never, "auto" from 131,072 padded points, "on" always; one
    build per (content, size, shape, use_pallas, device), an LRU of 4; the
    build gets the Alignment's ``use_pallas`` (True by default)."""
    built, routes = [], []
    monkeypatch.setattr(PA, "build_anchor_index", lambda tj, n_anchors, bucket_cap, use_pallas: built.append(
        (int(tj.shape[0]), n_anchors, bucket_cap)) or routes.append(use_pallas) or object())
    PA._ANN_INDEX_CACHE.clear()
    align = lambda ann: PA.Alignment(POSES, POSES, {}, {}, ann=ann, device="cpu")  # noqa: E731
    small, big = torch.zeros(131_071, 3), torch.zeros(131_072, 3)
    assert align("off")._index_for(big, ("fp",)) is None
    assert align("auto")._index_for(small, ("fp",)) is None
    first = align("auto")._index_for(big, ("fp",))
    assert align("auto")._index_for(big, ("fp",)) is first  # cached across Alignments
    assert align("on")._index_for(small, ("fp",)) is not None
    assert built == [(131_072, 1024, 512), (131_071, 1023, 512)]
    for i in range(4):
        align("on")._index_for(torch.zeros(1024, 3), (f"fp{i}",))
    assert len(PA._ANN_INDEX_CACHE) == 4 and len(built) == 6
    assert align("auto")._index_for(big, ("fp",)) is not first  # evicted, rebuilt
    plain = PA.Alignment(POSES, POSES, {}, {}, ann="auto", use_pallas=False, device="cpu")
    assert plain._index_for(big, ("fp",)) is not None and len(built) == 8  # its own cache entry
    assert routes == [True] * 7 + [False]
    PA._ANN_INDEX_CACHE.clear()


def test_unported_settings_raise(runs):
    """Unknown ``ann`` and ``global_init`` raise. A mesh (A22) is ported: a
    mesh larger than the world raises, and the scene's compare over a real
    1-rank gloo world gives the compare without one (every ICP step equal;
    tests/test_torch_parallel.py runs 2 ranks)."""
    from tpu3dlm_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="ann"):
        PA.Alignment(POSES, POSES, {}, {}, ann="nope", device="cpu")
    with pytest.raises(ValueError, match="global_init"):
        PA.Alignment(POSES, POSES, {}, {}, global_init="nope", device="cpu")
    with pytest.raises(ValueError, match="world"):
        make_mesh(2, device="cpu")
    base, comp, bb, cb, _ = runs["scene"]
    mesh = make_mesh(1, device="cpu")
    try:
        pa = PA.Alignment(POSES, POSES, bb, cb, base_cloud=base, comparison_cloud=comp, mesh=mesh, **KW)
        pa.compare("test")
    finally:
        mesh.close()
    assert not torch.distributed.is_initialized()
    np.testing.assert_array_equal(pa.final_transform, runs["pa"].final_transform)
    steps_close(pa.transformations, runs["pa"].transformations, 0.0)
    np.testing.assert_array_equal(pa.last_match["assign"], runs["pa"].last_match["assign"])


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PA.Alignment(POSES, POSES, {}, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PC.BBoxComparison({}, {})


def test_ply_round_trip_with_the_reference(tmp_path, rng):
    from tpu3dlm.data import ply as jply
    from tpu3dlm_torch.data import ply as pply

    pts = rng.normal(size=(300, 3)).astype(np.float32)
    pts[5] = np.nan
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    for binary in (True, False):
        for colors in (None, cols):
            a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
            pply.save_ply(a, pts, colors, binary=binary)
            jply.save_ply(b, pts, colors, binary=binary)
            assert open(a, "rb").read() == open(b, "rb").read()
            got, want = pply.load_ply(a), jply.load_ply(a)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[0].shape == (299, 3)
            if colors is None:
                assert got[1] is None and want[1] is None
            else:
                np.testing.assert_array_equal(got[1], want[1])
