"""Image codecs of the port: the part of ``cv2`` that ingestion uses.

The reference decodes frames with ``cv2.imread`` / ``cv2.imdecode`` and
resizes them with ``cv2.resize``. The card host has no cv2, so the port
carries its own, held to cv2's output byte for byte:

- ``decode_jpeg`` / ``read_jpeg``: baseline sequential Huffman JPEG → RGB
  uint8 (the only frame format of RTAB-Map exports), equal to ``cvtColor(imread(p, IMREAD_COLOR), COLOR_BGR2RGB)``
  (libjpeg-turbo's islow IDCT, fancy upsampling and fixed-point colour
  conversion, in ``csrc/host/codecs.cpp``). Progressive, arithmetic-coded,
  lossless, 12-bit and CMYK files raise ``ValueError``.
- ``decode_png`` / ``read_png``: PNG → the array ``imread(p,
  IMREAD_UNCHANGED)`` gives: 8-bit gray (H, W), RGB as BGR (H, W, 3), RGBA
  as BGRA (H, W, 4), 16-bit gray (H, W) uint16. Python parses the chunks,
  checks CRCs and inflates IDAT (``zlib``); the C++ source undoes the row
  filters. Interlaced, palette, gray+alpha and other bit depths raise.
- ``write_png``: the inverse for the same layouts (filter None), so a file
  it writes decodes under ``imread(IMREAD_UNCHANGED)`` to its input.
- ``resize_linear``: ``cv2.resize(..., INTER_LINEAR)`` on uint8 (fixed-point
  weights, OpenCV's vector rounding); ``resize_nearest``: ``INTER_NEAREST``.

Decoding errors raise ``ValueError`` naming the file. The C++ library is
built at first use (``kernels/build.py``); without a C++ compiler the
codecs raise — there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from tpu3dlm_torch.kernels.build import load_host_library

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_ERRLEN = 256


def _lib() -> ctypes.CDLL:
    lib = load_host_library("codecs")
    if not getattr(lib, "_typed", False):
        u8p, i = ctypes.c_void_p, ctypes.c_int
        lib.tl_jpeg_header.argtypes = [u8p, ctypes.c_size_t, ctypes.POINTER(i), ctypes.POINTER(i),
                                       ctypes.c_char_p, i]
        lib.tl_jpeg_decode.argtypes = [u8p, ctypes.c_size_t, u8p, i, i, ctypes.c_char_p, i]
        lib.tl_png_unfilter.argtypes = [u8p, i, i, i, u8p]
        lib.tl_resize_linear_u8.argtypes = [u8p, i, i, i, u8p, i, i]
        for fn in (lib.tl_jpeg_header, lib.tl_jpeg_decode, lib.tl_png_unfilter):
            fn.restype = i
        lib.tl_resize_linear_u8.restype = None
        lib._typed = True
    return lib


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes → (H, W, 3) RGB uint8; ``ValueError`` naming ``name``."""
    lib = _lib()
    src = np.frombuffer(data, np.uint8)
    buf = src.ctypes.data
    err = ctypes.create_string_buffer(_ERRLEN)
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.tl_jpeg_header(buf, len(data), ctypes.byref(w), ctypes.byref(h), err, _ERRLEN) != 0:
        raise ValueError(f"undecodable JPEG {name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.tl_jpeg_decode(buf, len(data), out.ctypes.data, w.value, h.value, err, _ERRLEN) != 0:
        raise ValueError(f"undecodable JPEG {name}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    return decode_jpeg(_read(path), path)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

# (colour type, bit depth) → channels
_PNG_LAYOUTS = {(0, 8): 1, (2, 8): 3, (6, 8): 4, (0, 16): 1}


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes → the array ``cv2.imdecode(..., IMREAD_UNCHANGED)`` gives
    (BGR/BGRA channel order); ``ValueError`` naming ``name``."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"undecodable PNG {name}: no PNG signature")
    pos, ihdr, idat = 8, None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"undecodable PNG {name}: truncated chunk")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"undecodable PNG {name}: truncated chunk {ctype!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"undecodable PNG {name}: CRC mismatch in chunk {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            if length != 13:
                raise ValueError(f"undecodable PNG {name}: bad IHDR")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"undecodable PNG {name}: no IHDR or IDAT")
    width, height, depth, color, compression, filt, interlace = ihdr
    if interlace != 0:
        raise ValueError(f"unsupported PNG {name}: interlaced images are not supported")
    if compression != 0 or filt != 0:
        raise ValueError(f"undecodable PNG {name}: unknown compression or filter method")
    channels = _PNG_LAYOUTS.get((color, depth))
    if channels is None:
        raise ValueError(
            f"unsupported PNG {name}: colour type {color} at {depth} bits (8-bit gray/RGB/RGBA "
            "and 16-bit gray only)")
    if width == 0 or height == 0:
        raise ValueError(f"undecodable PNG {name}: empty image")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"undecodable PNG {name}: {e}") from None
    bpp = channels * depth // 8
    rowbytes = width * bpp
    if len(raw) < height * (rowbytes + 1):
        raise ValueError(f"undecodable PNG {name}: image data is short (truncated)")
    raw = np.frombuffer(raw, np.uint8)
    out = np.empty(height * rowbytes, np.uint8)
    if _lib().tl_png_unfilter(raw.ctypes.data, height, rowbytes, bpp, out.ctypes.data) != 0:
        raise ValueError(f"undecodable PNG {name}: unknown row filter type")
    if depth == 16:
        return out.view(">u2").reshape(height, width).astype(np.uint16)
    img = out.reshape(height, width, channels) if channels > 1 else out.reshape(height, width)
    if channels >= 3:  # cv2 order: RGB(A) on disk → BGR(A)
        img = img[..., [2, 1, 0, 3][:channels]]
    return np.ascontiguousarray(img)


def read_png(path: str) -> np.ndarray:
    return decode_png(_read(path), path)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def encode_png(img: np.ndarray) -> bytes:
    """Array in cv2's layout (uint8 (H, W), BGR (H, W, 3), BGRA (H, W, 4);
    uint16 (H, W)) → PNG bytes, every row with filter None."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        color, depth, rows = 0, 16, img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        channels = 1 if img.ndim == 2 else img.shape[2]
        color, depth = {1: 0, 3: 2, 4: 6}[channels], 8
        if channels >= 3:
            img = img[..., [2, 1, 0, 3][:channels]]  # BGR(A) → RGB(A) on disk
        rows = np.ascontiguousarray(img).reshape(img.shape[0], -1)
    else:
        raise ValueError(f"write_png: unsupported array {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# ---------------------------------------------------------------------------
# Any frame, and the resizes
# ---------------------------------------------------------------------------


def resize_linear(img: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size_wh, interpolation=INTER_LINEAR)`` for uint8
    (H, W) or (H, W, C) images."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear takes uint8 images, got {img.dtype}")
    dw, dh = int(size_wh[0]), int(size_wh[1])
    if dw < 1 or dh < 1 or img.ndim not in (2, 3) or min(img.shape[:2]) < 1:
        raise ValueError(f"resize_linear: cannot resize {img.shape} to {dw}x{dh}")
    src = np.ascontiguousarray(img)
    sh, sw = src.shape[:2]
    cn = 1 if src.ndim == 2 else src.shape[2]
    if (sh, sw) == (dh, dw):
        return src.copy()
    out = np.empty((dh, dw) + src.shape[2:], np.uint8)
    _lib().tl_resize_linear_u8(src.ctypes.data, sh, sw, cn, out.ctypes.data, dh, dw)
    return out


def resize_nearest(img: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size_wh, interpolation=INTER_NEAREST)``: source
    index ``floor(d · (1 / (dst / src)))``, clamped to the last one."""
    dw, dh = int(size_wh[0]), int(size_wh[1])
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / sw))).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / sh))).astype(np.int64), sh - 1)
    return np.ascontiguousarray(img[ys[:, None], xs[None, :]])
