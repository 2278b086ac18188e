"""The scanpack cache format (port of the pack functions of
``tpu3dlm/native/__init__.py`` and ``tpu3dlm/native/src/scanpack.cpp``).

A pack is one little-endian file that holds a decoded capture, so a repeat
load is one sequential read (``scanpack_read``) or a memory map
(``scanpack_memmap``) instead of a JPEG/PNG decode per frame:

    magic "TPSCAN1\\0" | int64 F, H, W, Hd, Wd
    | rgb uint8 F·H·W·3 | depth float32 F·Hd·Wd
    | intr float32 F·4 | rgb_size float32 F·2 | poses float32 F·7

The reference writes and reads it with sequential ``fwrite``/``fread`` in
C++; numpy's ``tofile``/``fromfile`` at the same offsets give the same
bytes, so a pack written by either package is served by the other. The
magic is stamped last, so a pack cut short by a crash or a full disk, or
one whose incremental write (``scanpack_create``) was never finalised,
reads as absent (``None``); so do a truncated file, dims ≤ 0 or above 1e9,
and a read whose dims changed since the probe (another process rewrote the
pack in between). The JAX package writes a ``.npz`` sibling instead when it
has no C++ compiler; the port has one format only, writes no ``.npz`` and
reads one as absent.
"""

from __future__ import annotations

import os

import numpy as np

_PACK_MAGIC = b"TPSCAN1\x00"
_PACK_HEADER = 48  # 8-byte magic + 5 × int64 dims
_FIELDS = ("rgb", "depth", "intr", "rgb_size", "poses")
_DIM_CAP = 10**9


def _pack_offsets(f: int, h: int, w: int, hd: int, wd: int) -> dict:
    """Byte offset + (shape, dtype) of each array in the pack layout."""
    out, off = {}, _PACK_HEADER
    for name, shape, dt in (
        ("rgb", (f, h, w, 3), np.uint8),
        ("depth", (f, hd, wd), np.float32),
        ("intr", (f, 4), np.float32),
        ("rgb_size", (f, 2), np.float32),
        ("poses", (f, 7), np.float32),
    ):
        out[name] = (off, shape, dt)
        off += int(np.prod(shape)) * np.dtype(dt).itemsize
    out["total"] = off
    return out


def _header(f: int, h: int, w: int, hd: int, wd: int, magic: bytes) -> bytes:
    return magic + np.asarray([f, h, w, hd, wd], "<i8").tobytes()


def _read_dims(fp) -> tuple | None:
    """The five dims of a finalised pack's header, or None (no magic, short
    header, or dims out of range: corrupt bytes behind a valid magic)."""
    hdr = fp.read(_PACK_HEADER)
    if len(hdr) != _PACK_HEADER or hdr[:8] != _PACK_MAGIC:
        return None
    dims = tuple(int(x) for x in np.frombuffer(hdr, "<i8", 5, 8))
    if min(dims) <= 0 or max(dims) > _DIM_CAP:
        return None
    return dims


def scanpack_write(path: str, rgb, depth, intr, rgb_size, poses) -> None:
    """Write a whole decoded capture as one pack; the magic goes in last.
    An ``OSError`` (disk full, directory gone) propagates, as the caller
    decides whether a cache failure matters. A stale ``.npz`` sibling of
    the JAX package's fallback is removed, since both share one ``.src``
    fingerprint."""
    arrays = (
        np.ascontiguousarray(rgb, np.uint8),
        np.ascontiguousarray(depth, np.float32),
        np.ascontiguousarray(intr, np.float32),
        np.ascontiguousarray(rgb_size, np.float32),
        np.ascontiguousarray(poses, np.float32),
    )
    f, h, w, _ = arrays[0].shape
    hd, wd = arrays[1].shape[1:]
    with open(path, "wb") as fp:
        fp.write(_header(f, h, w, hd, wd, b"\x00" * 8))
        for a in arrays:
            a.tofile(fp)
        fp.flush()
        fp.seek(0)
        fp.write(_PACK_MAGIC)
    try:
        os.unlink(path + ".npz")
    except OSError:
        pass


def scanpack_read(path: str):
    """→ (rgb, depth, intr, rgb_size, poses), or None when the pack is
    absent, unfinalised, truncated, has corrupt dims, or was rewritten with
    other dims between the probe and the read."""
    try:
        with open(path, "rb") as fp:
            probe = _read_dims(fp)
        if probe is None:
            return None
        offs = _pack_offsets(*probe)
        out = [np.empty(offs[name][1], offs[name][2]) for name in _FIELDS]
        with open(path, "rb") as fp:
            if _read_dims(fp) != probe:
                return None
            for a in out:  # straight into the arrays, as the C++ reader does
                if fp.readinto(memoryview(a).cast("B")) != a.nbytes:
                    return None  # truncated
    except OSError:
        return None
    return tuple(out)


def scanpack_memmap(path: str, mode: str = "r"):
    """Memory-mapped views over a pack (no copy, O(pages) resident — the
    streaming reader's decode-free source). Returns ``{"rgb": memmap,
    "depth": ..., "intr": ..., "rgb_size": ..., "poses": ..., "dims": (f,
    h, w, hd, wd)}``, or None when the pack is absent, unfinalised,
    truncated or has corrupt dims."""
    try:
        with open(path, "rb") as fp:
            dims = _read_dims(fp)
        if dims is None:
            return None
        offs = _pack_offsets(*dims)
        if os.path.getsize(path) < offs["total"]:
            return None  # truncated
    except OSError:
        return None
    return _views(path, dims, offs, mode)


def _views(path: str, dims: tuple, offs: dict, mode: str) -> dict:
    out = {"dims": dims}
    for name in _FIELDS:
        off, shape, dt = offs[name]
        out[name] = np.memmap(path, dtype=dt, mode=mode, offset=off, shape=shape)
    return out


def scanpack_create(path: str, f: int, h: int, w: int, hd: int, wd: int) -> dict:
    """Preallocate a pack for incremental (chunk-by-chunk) writing. The
    magic is not written yet: readers treat the file as absent until
    ``scanpack_finalize`` stamps it, so a stream that stops early never
    leaves a half-pack that later loads as a whole scan. Returns writable
    memmap views (the keys of ``scanpack_memmap``)."""
    offs = _pack_offsets(f, h, w, hd, wd)
    with open(path, "wb") as fp:
        fp.write(_header(f, h, w, hd, wd, b"\x00" * 8))
        fp.truncate(offs["total"])
    return _views(path, (f, h, w, hd, wd), offs, "r+")


def scanpack_finalize(path: str) -> None:
    """Stamp the magic after every frame is written: the pack becomes valid."""
    with open(path, "r+b") as fp:
        fp.write(_PACK_MAGIC)
