"""The port's scanpack format (``tpu3dlm_torch/data/scanpack.py``) against
the JAX package's (``tpu3dlm/native``: C++ ``scanpack.cpp`` and the numpy
memmap helpers) on the CPU: the same bytes, packs read across packages, and
the reference's rules for packs that must read as absent."""

import os

import numpy as np
import pytest

from tpu3dlm import native as JN
from tpu3dlm_torch.data import scanpack as PS

FIELDS = ("rgb", "depth", "intr", "rgb_size", "poses")


def arrays(f=3, h=8, w=6, hd=5, wd=4, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, (f, h, w, 3), dtype=np.uint8),
        rng.random((f, hd, wd), dtype=np.float32) * 4000,
        rng.random((f, 4), dtype=np.float32) * 500,
        rng.random((f, 2), dtype=np.float32) * 640,
        rng.standard_normal((f, 7), dtype=np.float32),
    )


@pytest.fixture(autouse=True)
def binary_reference():
    """The JAX package writes the binary pack only with its C++ library
    (else a ``.npz``): these tests need the binary one."""
    assert JN.get_lib() is not None, "the reference's native scanpack library did not build"


def assert_same(got, want):
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dims", [(3, 8, 6, 5, 4), (1, 1, 1, 1, 1), (7, 16, 16, 12, 9)])
def test_pack_bytes_identical_and_cross_readable(tmp_path, dims):
    data = arrays(*dims)
    port, ref = str(tmp_path / "port.pack"), str(tmp_path / "jax.pack")
    PS.scanpack_write(port, *data)
    assert JN.scanpack_write(ref, *data)
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert_same(JN.scanpack_read(port), data)
    assert_same(PS.scanpack_read(ref), data)
    for read in (PS.scanpack_memmap, JN.scanpack_memmap):
        for path in (port, ref):
            views = read(path)
            assert views["dims"] == dims
            assert_same([views[k] for k in FIELDS], data)


def test_incremental_pack_equals_whole_write(tmp_path):
    data = arrays(5)
    port, ref = str(tmp_path / "inc.pack"), str(tmp_path / "whole.pack")
    f, h, w, _ = data[0].shape
    views = PS.scanpack_create(port, f, h, w, *data[1].shape[1:])
    for start in (0, 2, 4):  # chunks of 2, as iter_scan_chunks writes them
        for k, a in zip(FIELDS, data):
            views[k][start:start + 2] = a[start:start + 2]
    assert PS.scanpack_read(port) is None and JN.scanpack_read(port) is None  # no magic yet
    assert PS.scanpack_memmap(port) is None and JN.scanpack_memmap(port) is None
    for k in FIELDS:
        views[k].flush()
    PS.scanpack_finalize(port)
    JN.scanpack_write(ref, *data)
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert_same(JN.scanpack_read(port), data)


def _corrupt(path, case):
    raw = bytearray(open(path, "rb").read())
    if case == "truncated":
        raw = raw[:-5]
    elif case == "short_header":
        raw = raw[:30]
    elif case == "negative_dims":
        raw[8:16] = np.asarray([-3], "<i8").tobytes()
    elif case == "absurd_dims":
        raw[16:24] = np.asarray([10**9 + 1], "<i8").tobytes()
    elif case == "unfinalised":
        raw[:8] = b"\x00" * 8
    elif case == "wrong_magic":
        raw[:8] = b"TPSCAN2\x00"
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("case", ["truncated", "short_header", "negative_dims", "absurd_dims",
                                  "unfinalised", "wrong_magic"])
def test_invalid_packs_read_as_absent(tmp_path, case):
    """Both packages read the same broken pack as absent (None)."""
    path = str(tmp_path / "bad.pack")
    PS.scanpack_write(path, *arrays())
    _corrupt(path, case)
    assert PS.scanpack_read(path) is None
    assert PS.scanpack_memmap(path) is None
    assert JN.scanpack_read(path) is None
    assert JN.scanpack_memmap(path) is None


def test_missing_pack_reads_as_absent(tmp_path):
    path = str(tmp_path / "none.pack")
    assert PS.scanpack_read(path) is None and PS.scanpack_memmap(path) is None


def test_dims_changed_since_the_probe_are_refused(tmp_path, monkeypatch):
    """Another process re-caches the capture with another frame count
    between the probe and the read: the read is refused, not overrun."""
    path = str(tmp_path / "race.pack")
    PS.scanpack_write(path, *arrays(3))
    real = PS._pack_offsets

    def rewrite_between(*dims):
        PS.scanpack_write(path, *arrays(4, seed=1))
        return real(*dims)

    monkeypatch.setattr(PS, "_pack_offsets", rewrite_between)
    assert PS.scanpack_read(path) is None


def test_npz_fallback_is_not_read_and_a_stale_one_is_removed(tmp_path):
    """The port has one format: the JAX package's ``.npz`` fallback reads
    as absent, and writing a pack removes a stale ``.npz`` sibling (both
    share one ``.src`` fingerprint)."""
    path = str(tmp_path / "scan.pack")
    data = arrays()
    np.savez(path + ".npz", **dict(zip(("rgb", "depth", "intr", "rgb_size", "poses"), data)))
    assert PS.scanpack_read(path) is None and PS.scanpack_memmap(path) is None
    PS.scanpack_write(path, *data)
    assert not os.path.exists(path + ".npz")
    assert_same(PS.scanpack_read(path), data)
