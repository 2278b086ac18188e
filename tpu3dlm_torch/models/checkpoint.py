"""Flax msgpack checkpoints without flax or msgpack (the port of
``tpu3dlm/models/weights.py::load_flax_checkpoint`` and
``save_flax_checkpoint``).

``flax.serialization.msgpack_serialize`` writes a msgpack map of maps whose
array leaves are ext type 1: a nested msgpack array ``(shape, dtype name,
C-order bytes)``; numpy scalars are ext type 3 with the same payload and
Python complex numbers ext type 2. Arrays above flax's chunk size are
written as ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks":
{"0": ..., ...}}`` and joined back here. ``read_flax_msgpack`` returns the
tree ``msgpack_restore`` returns — nested dicts of numpy arrays — which
``models.weights.yolov10_from_flax`` / ``beit_from_flax`` take as is.
``write_flax_msgpack`` writes such a tree back, byte for byte what
``flax.serialization.to_bytes`` writes for it.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2**30  # flax.serialization's: arrays above it are chunked


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
    Any other file raises: ``.pt``/``.safetensors`` checkpoints are read by
    ``tpu3dlm_torch.models.weights.load_torch_state_dict``."""
    if not path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: only flax .msgpack checkpoints are read here; load .pt/.safetensors "
            "checkpoints with tpu3dlm_torch.models.weights.load_torch_state_dict"
        )
    with open(path, "rb") as f:
        data = f.read()
    try:
        return restore_flax_msgpack(data)
    except (ValueError, struct.error) as e:
        raise ValueError(f"unreadable flax checkpoint {path}: {e}") from None


class _Writer:
    """A msgpack encoder for what a flax checkpoint holds: maps with string
    keys, numpy arrays / scalars as ext types 1 / 3, and inside those and
    the chunked form lists, strings, bytes, bools and ints (the smallest
    encoding of each, as msgpack-python's ``packb(use_bin_type=True)``)."""

    def __init__(self):
        self.out = bytearray()

    def header(self, n: int, fix: int, fix_max: int, b16: int, b32: int) -> None:
        if n <= fix_max:
            self.out.append(fix | n)
        elif n < 1 << 16:
            self.out += struct.pack(">BH", b16, n)
        else:
            self.out += struct.pack(">BI", b32, n)

    def sized(self, n: int, codes: tuple) -> None:
        if n < 1 << 8:
            self.out += struct.pack(">BB", codes[0], n)
        elif n < 1 << 16:
            self.out += struct.pack(">BH", codes[1], n)
        else:
            self.out += struct.pack(">BI", codes[2], n)

    def int(self, v: int) -> None:
        if 0 <= v <= 0x7F:
            self.out.append(v)
        elif -32 <= v < 0:
            self.out.append(v & 0xFF)
        elif v >= 0:
            for code, fmt, lim in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16), (0xCE, ">BI", 1 << 32),
                                   (0xCF, ">BQ", 1 << 64)):
                if v < lim:
                    self.out += struct.pack(fmt, code, v)
                    return
            raise ValueError(f"integer {v} too large for msgpack")
        else:
            for code, fmt, lim in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15), (0xD2, ">Bi", 1 << 31),
                                   (0xD3, ">Bq", 1 << 63)):
                if v >= -lim:
                    self.out += struct.pack(fmt, code, v)
                    return
            raise ValueError(f"integer {v} too small for msgpack")

    def ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.out += struct.pack(">Bb", fixed[n], code)
        else:
            self.sized(n, (0xC7, 0xC8, 0xC9))
            self.out += struct.pack(">b", code)
        self.out += payload

    def value(self, v) -> None:
        if v is True or v is False:
            self.out.append(0xC3 if v else 0xC2)
        elif isinstance(v, np.ndarray):
            self.ext(_EXT_NDARRAY, _ndarray_bytes(v))
        elif isinstance(v, np.generic):
            self.ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
        elif isinstance(v, int):
            self.int(v)
        elif isinstance(v, str):
            b = v.encode("utf-8")
            if len(b) <= 31:
                self.out.append(0xA0 | len(b))
            else:
                self.sized(len(b), (0xD9, 0xDA, 0xDB))
            self.out += b
        elif isinstance(v, bytes):
            self.sized(len(v), (0xC4, 0xC5, 0xC6))
            self.out += v
        elif isinstance(v, (list, tuple)):
            self.header(len(v), 0x90, 15, 0xDC, 0xDD)
            for x in v:
                self.value(x)
        elif isinstance(v, dict):
            self.header(len(v), 0x80, 15, 0xDE, 0xDF)
            for k, x in v.items():
                if not isinstance(k, str):
                    raise TypeError(f"checkpoint keys must be strings, got {k!r}")
                self.value(k)
                self.value(x)
        else:
            raise TypeError(f"cannot write {type(v).__name__} into a flax checkpoint")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's array payload: msgpack of (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    w = _Writer()
    w.value([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(w.out)


def _chunk(tree):
    """Arrays above ``MAX_CHUNK_SIZE`` bytes → flax's chunked form."""
    if isinstance(tree, dict):
        return {k: _chunk(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
        return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def serialize_flax_msgpack(tree) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts (string
    keys, in their order) with numpy leaves."""
    w = _Writer()
    w.value(_chunk(tree))
    return bytes(w.out)


def write_flax_msgpack(path: str, tree) -> None:
    """Write ``tree`` (e.g. ``models.weights.yolov10_to_flax``'s) as a flax
    ``.msgpack`` checkpoint, which ``read_flax_msgpack`` and the JAX
    package's ``load_flax_checkpoint`` read back."""
    if not str(path).endswith(".msgpack"):
        raise ValueError(f"{path}: flax checkpoints are written as .msgpack")
    data = serialize_flax_msgpack(tree)
    with open(path, "wb") as f:
        f.write(data)
