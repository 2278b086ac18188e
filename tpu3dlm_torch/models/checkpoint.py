"""Flax msgpack checkpoints without flax or msgpack (the reading half of
``tpu3dlm/models/weights.py::load_flax_checkpoint``).

``flax.serialization.msgpack_serialize`` writes a msgpack map of maps whose
array leaves are ext type 1: a nested msgpack array ``(shape, dtype name,
C-order bytes)``; numpy scalars are ext type 3 with the same payload and
Python complex numbers ext type 2. Arrays above flax's chunk size are
written as ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks":
{"0": ..., ...}}`` and joined back here. ``read_flax_msgpack`` returns the
tree ``msgpack_restore`` returns — nested dicts of numpy arrays — which
``models.weights.yolov10_from_flax`` / ``beit_from_flax`` take as is.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one buffer (the format's every type)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data is truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def text(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype_name, buf = _Reader(payload, raw=True).value()
            name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
            if name == "bfloat16":
                raise ValueError("bfloat16 arrays in a checkpoint are not supported (numpy has no bfloat16)")
            arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
            return arr[()] if code == _EXT_NPSCALAR else arr
        if code == _EXT_COMPLEX:
            re_, im_ = _Reader(payload).value()
            return complex(re_, im_)
        raise ValueError(f"unknown msgpack ext type {code}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.text(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore_flax_msgpack(data: bytes):
    """``flax.serialization.msgpack_restore`` of ``data``."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack checkpoint")
    return _unchunk(tree)


def read_flax_msgpack(path: str):
    """A flax ``.msgpack`` checkpoint file → nested dicts of numpy arrays.
    A ``.pt`` (PyTorch) checkpoint raises: its converters are not ported."""
    if not path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: only flax .msgpack checkpoints are read; .pt checkpoints "
            "(load_torch_state_dict and its converters) are not ported yet (ROADMAP A24)"
        )
    with open(path, "rb") as f:
        data = f.read()
    try:
        return restore_flax_msgpack(data)
    except (ValueError, struct.error) as e:
        raise ValueError(f"unreadable flax checkpoint {path}: {e}") from None
