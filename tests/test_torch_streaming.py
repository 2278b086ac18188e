"""Streaming ingestion and the scanpack cache against the JAX package on the
CPU, on the committed capture (``tests/fixtures/torch_project``, 5 frames,
128 px): ``iter_scan_chunks`` chunk for chunk and byte for byte (padding and
``valid`` included) with the cache off and on, packs served across the two
packages, ``load_scan(cache=True)``, and ``FusedScanRunner.run_stream`` on
the fixture checkpoints against JAX's ``run_stream`` and against the port's
own whole-scan call."""

import dataclasses
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm import native as JN
from tpu3dlm.data import dataset as JD
from tpu3dlm.models.beit import BeitConfig as JaxBeitConfig
from tpu3dlm.pipeline.fused import FusedScanRunner as JaxRunner
from tpu3dlm_torch.data import dataset as PD
from tpu3dlm_torch.data import scanpack as PS
from tpu3dlm_torch.data.scan import Scan
from tpu3dlm_torch.models.beit import BeitConfig
from tpu3dlm_torch.models.checkpoint import read_flax_msgpack
from tpu3dlm_torch.models.weights import beit_from_flax, yolov10_from_flax
from tpu3dlm_torch.pipeline.fused import FusedScanRunner

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
CAPTURE = os.path.join(FIXTURES, "torch_project", "data", "gold_std")
FIELDS = ("rgb", "depth", "intrinsics", "rgb_size", "poses", "timestamps", "letterbox")
SIZE = 128


@pytest.fixture
def capture(tmp_path):
    """A writable copy of the committed gold scan → load_scan's four paths."""
    dst = tmp_path / "gold_std"
    shutil.copytree(CAPTURE, dst)
    ext = dst / "rtabmap_extract"
    return tuple(str(p) for p in (ext / "data_rgb", ext / "data_depth", ext / "calibration",
                                  dst / "poses.txt"))


def stream(module, args, chunk=2, **kw):
    return list(module.iter_scan_chunks(*args, chunk_frames=chunk, img_size=SIZE, **kw))


def assert_scans_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def assert_streams_equal(got, want):
    assert [v for _, v in got] == [v for _, v in want]
    for (a, _), (b, _) in zip(got, want):
        assert_scans_equal(a, b)


def refuse_decode(monkeypatch, module):
    def boom(*a, **k):
        raise AssertionError("decoded a frame on a cached pass")

    monkeypatch.setattr(module, "_decode_frames", boom)


def count_decodes(monkeypatch, module):
    calls = []
    real = module._decode_frames

    def counted(pairs, *a, **k):
        calls.append(len(pairs))
        return real(pairs, *a, **k)

    monkeypatch.setattr(module, "_decode_frames", counted)
    return calls


@pytest.mark.parametrize("mode,chunk", [("square", 2), ("square", 5), ("square", 3), ("letterbox", 2)])
def test_chunks_identical_to_jax(capture, mode, chunk):
    got = stream(PD, capture, chunk, resize_mode=mode)
    want = stream(JD, capture, chunk, resize_mode=mode)
    assert [v for _, v in got] == {2: [2, 2, 1], 5: [5], 3: [3, 2]}[chunk]
    assert_streams_equal(got, want)
    last, valid = got[-1]
    if valid < chunk:  # the padding: zero frames, identity poses, rgb_size 1
        assert not last.rgb[valid:].any() and not last.depth[valid:].any()
        np.testing.assert_array_equal(last.poses[valid:], [[0, 0, 0, 0, 0, 0, 1]] * (chunk - valid))
        assert (last.rgb_size[valid:] == 1).all()


def test_cached_stream_identical_and_served_across_packages(capture, monkeypatch, tmp_path):
    """Cache on: the writing pass equals JAX's uncached chunks; a second
    pass is decode-free and equal; the JAX package serves the port's pack
    decode-free, and the port serves one the JAX package wrote."""
    want = stream(JD, capture)
    assert_streams_equal(stream(PD, capture, cache=True), want)
    pack = os.path.join(os.path.dirname(capture[0]), f"scan_{SIZE}.pack")
    assert JN.scanpack_memmap(pack)["dims"] == (5, SIZE, SIZE, 256, 192)
    with monkeypatch.context() as m:
        refuse_decode(m, PD)
        assert_streams_equal(stream(PD, capture, cache=True), want)
    with monkeypatch.context() as m:
        refuse_decode(m, JD)
        assert_streams_equal(stream(JD, capture, cache=True), want)
    # the other way round, on a fresh copy
    other = tmp_path / "other"
    shutil.copytree(CAPTURE, other)
    ext = other / "rtabmap_extract"
    args = tuple(str(p) for p in (ext / "data_rgb", ext / "data_depth", ext / "calibration",
                                  other / "poses.txt"))
    assert_streams_equal(stream(JD, args, cache=True), want)
    with monkeypatch.context() as m:
        refuse_decode(m, PD)
        assert_streams_equal(stream(PD, args, cache=True), want)


def test_abandoned_stream_leaves_an_ignored_pack(capture, monkeypatch):
    chunks = PD.iter_scan_chunks(*capture, chunk_frames=2, img_size=SIZE, cache=True)
    next(chunks)
    chunks.close()
    pack = os.path.join(os.path.dirname(capture[0]), f"scan_{SIZE}.pack")
    assert os.path.exists(pack) and not os.path.exists(pack + ".src")
    assert PS.scanpack_memmap(pack) is None and JN.scanpack_memmap(pack) is None
    assert PD.load_scan(*capture, img_size=SIZE, cache=True).num_frames == 5  # rebuilt, not served
    calls = count_decodes(monkeypatch, PD)
    assert_streams_equal(stream(PD, capture, cache=True), stream(JD, capture))
    assert calls == []  # the rebuilt pack serves the stream


@pytest.mark.parametrize("what", ["rgb", "depth", "calibration"])
def test_reexported_source_invalidates_the_pack(capture, monkeypatch, what):
    """Same frame count, a source file re-exported in place (newer mtime):
    the pack is rebuilt, never served stale."""
    stream(PD, capture, cache=True)
    name = {"rgb": "3.jpg", "depth": "3.png", "calibration": "3.yaml"}[what]
    path = os.path.join(capture[{"rgb": 0, "depth": 1, "calibration": 2}[what]], name)
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 10))
    calls = count_decodes(monkeypatch, PD)
    assert_streams_equal(stream(PD, capture, cache=True), stream(JD, capture))
    assert sum(calls[:3]) == 5  # the port's pass decoded every frame
    scan_calls = len(calls)
    PD.load_scan(*capture, img_size=SIZE, cache=True)
    assert len(calls) == scan_calls  # the rewritten pack serves load_scan


def test_cache_hit_serves_the_live_poses(capture, monkeypatch):
    stream(PD, capture, cache=True)
    PD.load_scan(*capture, img_size=SIZE, cache=True)
    lines = open(capture[3]).read().splitlines()
    rows = [ln.split() for ln in lines[1:]]
    for r in rows:
        r[1] = f"{float(r[1]) + 0.25:.6f}"  # a re-run pose-graph optimisation
    open(capture[3], "w").write("\n".join([lines[0]] + [" ".join(r) for r in rows]) + "\n")
    with monkeypatch.context() as m:
        refuse_decode(m, PD)
        got = stream(PD, capture, cache=True)
        scan = PD.load_scan(*capture, img_size=SIZE, cache=True)
    assert_streams_equal(got, stream(JD, capture))
    assert_scans_equal(scan, JD.load_scan(*capture, img_size=SIZE, cache=True))
    np.testing.assert_array_equal(scan.poses, JD.load_scan(*capture, img_size=SIZE).poses)


def test_load_scan_cache_round_trip_equals_jax(capture, monkeypatch, tmp_path):
    want = JD.load_scan(*capture, img_size=SIZE)
    assert_scans_equal(PD.load_scan(*capture, img_size=SIZE, cache=True), want)
    with monkeypatch.context() as m:
        refuse_decode(m, PD)
        assert_scans_equal(PD.load_scan(*capture, img_size=SIZE, cache=True), want)
    with monkeypatch.context() as m:
        refuse_decode(m, JD)  # the JAX package serves the port's pack
        assert_scans_equal(JD.load_scan(*capture, img_size=SIZE, cache=True), want)
    # a frame removed: the count no longer matches, so it decodes again
    for d, ext in ((0, ".jpg"), (1, ".png")):
        os.remove(os.path.join(capture[d], "5" + ext))
    calls = count_decodes(monkeypatch, PD)
    got = PD.load_scan(*capture, img_size=SIZE, cache=True)
    assert got.num_frames == 4 and calls == [4]
    assert_scans_equal(got, JD.load_scan(*capture, img_size=SIZE))


def test_failed_cache_write_warns_and_continues(capture, monkeypatch, caplog):
    def full_disk(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(PS, "scanpack_write", full_disk)
    monkeypatch.setattr(PS, "scanpack_finalize", full_disk)
    with caplog.at_level("WARNING"):
        scan = PD.load_scan(*capture, img_size=SIZE, cache=True)
        got = stream(PD, capture, cache=True)
    assert sum("continuing uncached" in r.getMessage() for r in caplog.records) == 2
    assert_scans_equal(scan, JD.load_scan(*capture, img_size=SIZE))
    assert_streams_equal(got, stream(JD, capture))


# ---------------------------------------------------------------------------
# run_stream
# ---------------------------------------------------------------------------

BEIT = dict(image_size=32, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, num_labels=2)
KW = dict(img_size=SIZE, conf_thresh=0.5, max_det=8, nc=2)


@pytest.fixture(scope="module")
def runners():
    """The fixture checkpoints in the JAX runner and carried into the
    port's (f32 both sides)."""
    yv = read_flax_msgpack(os.path.join(FIXTURES, "yolo_synthetic.msgpack"))
    bv = read_flax_msgpack(os.path.join(FIXTURES, "beit_synthetic.msgpack"))
    jax_runner = JaxRunner(beit_config=JaxBeitConfig(**BEIT), yolo_variables=yv, beit_variables=bv,
                           dtype=jnp.float32, **KW)
    port_runner = FusedScanRunner(yolo=yolov10_from_flax(yv, nc=2), beit=beit_from_flax(bv, BeitConfig(**BEIT)),
                                  dtype=torch.float32, device="cpu", **KW)
    return jax_runner, port_runner


def port_stream(args):
    return PD.iter_scan_chunks(*args, chunk_frames=2, img_size=SIZE)


def assert_results_close(got, want, box_tol, corner_tol):
    (d_p, g_p), (d_j, g_j) = got, want
    np.testing.assert_array_equal(d_p.mask, np.asarray(d_j.mask))
    assert d_p.mask.any() and (d_p.damage[d_p.mask] >= 0).any()
    np.testing.assert_array_equal(d_p.label, np.asarray(d_j.label))
    np.testing.assert_array_equal(d_p.damage, np.asarray(d_j.damage))
    np.testing.assert_allclose(d_p.boxes, np.asarray(d_j.boxes), atol=box_tol)
    m = d_p.mask
    np.testing.assert_allclose(g_p.corners[m], np.asarray(g_j.corners)[m], atol=corner_tol)


@pytest.mark.parametrize("max_inflight", [1, 2])
def test_run_stream_matches_jax_and_whole_scan(runners, capture, max_inflight):
    """Chunks of 2 (the last one padded): masks, labels and damage equal to
    JAX's run_stream, boxes within 1e-3 px, corners within 1e-4 m; equal
    to the port's whole-scan call (the budget does not bind); at most
    ``max_inflight`` chunks pending, draining interleaved with production."""
    jax_runner, port_runner = runners
    want = jax_runner.run_stream(JD.iter_scan_chunks(*capture, chunk_frames=2, img_size=SIZE),
                                 max_inflight=max_inflight)
    events = []

    def tracked():
        for i, item in enumerate(port_stream(capture)):
            events.append(("produce", i))
            yield item

    real = port_runner._finalize

    def finalize(out, n):
        events.append(("drain", n))
        return real(out, n)

    port_runner._finalize = finalize
    try:
        got = port_runner.run_stream(tracked(), max_inflight=max_inflight)
    finally:
        del port_runner._finalize
    assert got[0].boxes.shape == (5, 8, 4) and got[1].corners.shape == (5, 8, 4, 3)
    assert_results_close(got, want, 1e-3, 1e-4)
    assert port_runner.stream_peak_inflight == max_inflight
    # chunk i+1 is decoded while chunk i is in flight, and the oldest chunk
    # drains before the next dispatch
    p, d = "produce", "drain"
    assert events == {1: [(p, 0), (p, 1), (d, 2), (p, 2), (d, 2), (d, 1)],
                      2: [(p, 0), (p, 1), (p, 2), (d, 2), (d, 2), (d, 1)]}[max_inflight]
    scan = Scan(**{f.name: getattr(PD.load_scan(*capture, img_size=SIZE), f.name)
                   for f in dataclasses.fields(Scan)})
    assert_results_close(got, port_runner(scan), 1e-5, 1e-5)


def test_concurrent_streams_match_serial(runners, capture):
    """Two captures streaming at once (the watcher's workers: one runner
    each, shared modules) give the serial result."""
    _, ref = runners
    want = ref.run_stream(port_stream(capture), max_inflight=1)
    barrier = threading.Barrier(2, timeout=60)

    def one(_):
        runner = FusedScanRunner(yolo=ref.yolo, beit=ref.beit, dtype=torch.float32, device="cpu", **KW)

        def chunks():
            barrier.wait()
            yield from port_stream(capture)

        return runner.run_stream(chunks(), max_inflight=1)

    with ThreadPoolExecutor(2) as pool:
        results = list(pool.map(one, range(2)))
    for got in results:
        assert_results_close(got, want, 0.0, 0.0)


def test_empty_stream_raises(runners):
    with pytest.raises(ValueError, match="empty chunk stream"):
        runners[1].run_stream(iter(()))

