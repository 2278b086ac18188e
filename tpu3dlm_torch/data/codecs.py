"""Image codecs of the port: the part of ``cv2`` that ingestion uses.

The reference decodes frames with ``cv2.imread`` / ``cv2.imdecode`` and
resizes them with ``cv2.resize``. The card host has no cv2, so the port
carries its own, held to cv2 5.0's output (libjpeg-turbo 3.1, libpng 1.6,
libtiff 4.7, libwebp, OpenJPEG 2.5 and cv2's own decoders) byte for byte:

- ``read_image`` / ``decode_image``: any frame → (H, W, 3) RGB uint8,
  ``cvtColor(imread(p, IMREAD_COLOR), COLOR_BGR2RGB)`` (``imdecode`` for
  bytes), the format told apart by its signature as cv2 does, whatever the
  file's extension; ``read_unchanged`` / ``decode_unchanged``: the same
  under IMREAD_UNCHANGED (the depth path), in cv2's layout and dtype. JPEG
  and PNG are decoded here; TIFF (BigTIFF, CCITT, JPEG, YCbCr and CIELab
  too), BMP, PNM/PAM/PFM, Sun raster, Radiance HDR and GIF in
  ``data/containers.py``; WebP (lossless, lossy, alpha,
  EXIF, an animation's first frame) in ``data/webp.py``; JPEG 2000 (JP2
  files and raw codestreams, 5/3 and 9/7, RCT/ICT) in ``data/jpeg2000.py``.
  AVIF raises ``ValueError`` naming the format as not yet ported, OpenEXR
  (cv2 here is built without it) and unknown data as undecodable. Where cv2's
  ``imread`` and ``imdecode`` differ, so do the file and bytes forms.
- ``decode_jpeg`` / ``read_jpeg``: JPEG → RGB as IMREAD_COLOR gives it:
  sequential, progressive or lossless (SOF3), Huffman or arithmetic coded,
  1, 3 or 4 components (YCbCr, RGB, gray, YCCK, Adobe CMYK), sampling
  factors 1-4 with integral ratios, restart markers, block smoothing of
  incomplete progressions, EXIF orientation (``csrc/host/codecs.cpp``);
  under IMREAD_UNCHANGED through ``*_unchanged``. The bytes form fails on
  data cut short, as ``imdecode`` does; the file form pads it, as
  ``imread`` does. What libjpeg-turbo or cv2 refuse raises: 12- and 16-bit
  precision, hierarchical and arithmetic lossless frames, YCbCr or YCCK
  lossless files and a gray lossless file asked for colour.
- ``decode_png`` / ``read_png``: PNG of every colour type and bit depth
  (gray 1-16, RGB 8/16, palette 1-8, gray+alpha and RGBA 8/16), tRNS, Adam7
  → the array ``imread(p, IMREAD_UNCHANGED)`` gives (BGR/BGRA order);
  through ``*_image`` the RGB of IMREAD_COLOR with an eXIf orientation.
  Python parses the chunks, checks CRCs and inflates IDAT (``zlib``); the
  C++ source undoes the filters, deinterlaces and unpacks the samples.
- ``encode_jpeg``: RGB uint8 → the bytes ``cv2.imencode(".jpg", ...)``
  writes at its defaults (quality 95, 4:2:0, libjpeg-turbo's fixed-point
  colour conversion, islow DCT and Annex K tables).
- ``encode_png`` / ``write_png``: every layout ``decode_png`` returns
  (filter None), as ``cv2.imwrite`` lays it out.
- ``resize_linear``: ``cv2.resize(..., INTER_LINEAR)`` on uint8 (fixed-point
  weights, OpenCV's vector rounding); ``resize_nearest``: ``INTER_NEAREST``.

Decoding errors raise ``ValueError`` naming the file. The C++ libraries are
built at first use (``kernels/build.py``); without a C++ compiler the
codecs raise — there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from tpu3dlm_torch.data import containers, jpeg2000, webp
from tpu3dlm_torch.kernels.build import load_host_library

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_ERRLEN = 256


def _lib() -> ctypes.CDLL:
    lib = load_host_library("codecs")
    if not getattr(lib, "_typed", False):
        u8p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.tl_jpeg_info.argtypes = [u8p, sz, i, ctypes.POINTER(i), ctypes.c_char_p, i]
        lib.tl_jpeg_decode.argtypes = [u8p, sz, i, u8p, i, i, i, ctypes.c_char_p, i]
        lib.tl_jpeg_decode_colour.argtypes = [u8p, sz, i, u8p, i, i, i, ctypes.c_char_p, i]
        lib.tl_exif_orientation.argtypes = [u8p, sz]
        lib.tl_png_samples.argtypes = [u8p, sz, i, i, i, i, i, u8p]
        lib.tl_resize_linear_u8.argtypes = [u8p, i, i, i, u8p, i, i]
        lib.tl_jpeg_encode.argtypes = [u8p, i, i, i, u8p, sz, ctypes.POINTER(sz), ctypes.c_char_p, i]
        for fn in (lib.tl_jpeg_info, lib.tl_jpeg_decode, lib.tl_jpeg_decode_colour, lib.tl_exif_orientation,
                   lib.tl_png_samples, lib.tl_jpeg_encode):
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


def _jpeg(data: bytes, name: str, file: bool, unchanged: bool) -> np.ndarray:
    lib = _lib()
    src = np.frombuffer(data, np.uint8)
    buf = src.ctypes.data
    err = ctypes.create_string_buffer(_ERRLEN)
    info = (ctypes.c_int * 4)()
    if lib.tl_jpeg_info(buf, len(data), int(file), info, err, _ERRLEN) != 0:
        raise ValueError(f"undecodable JPEG {name}: {err.value.decode()}")
    w, h, ncomp, orientation = info
    gray = unchanged and ncomp == 1
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    if lib.tl_jpeg_decode(buf, len(data), int(file), out.ctypes.data, w, h, 1 if gray else 3, err, _ERRLEN) != 0:
        raise ValueError(f"undecodable JPEG {name}: {err.value.decode()}")
    if unchanged:
        return out if gray else np.ascontiguousarray(out[..., ::-1])
    return containers.orient(out, orientation)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes → (H, W, 3) RGB uint8, ``cvtColor(imdecode(b,
    IMREAD_COLOR), COLOR_BGR2RGB)`` with its EXIF orientation applied. Data
    that ends before EOI fails, as in cv2. ``ValueError`` naming ``name``."""
    return _jpeg(data, name, False, False)


def read_jpeg(path: str) -> np.ndarray:
    """``decode_jpeg`` of a file as ``cv2.imread`` reads it: a file cut
    short decodes with its missing data left out (libjpeg's fake EOI)."""
    return _jpeg(_read(path), path, True, False)


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) RGB uint8 → baseline JPEG bytes, those of
    ``cv2.imencode(".jpg", cvtColor(rgb, COLOR_RGB2BGR))`` (4:2:0, Annex K
    tables, JFIF header; ``csrc/host/codecs.cpp``)."""
    img = np.ascontiguousarray(rgb)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8 RGB, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    lib, err, n = _lib(), ctypes.create_string_buffer(_ERRLEN), ctypes.c_size_t()
    cap = h * w + 4096
    while True:
        out = np.empty(cap, np.uint8)
        rc = lib.tl_jpeg_encode(img.ctypes.data, w, h, int(quality), out.ctypes.data, cap, ctypes.byref(n),
                                err, _ERRLEN)
        if rc == 0:
            return out[:n.value].tobytes()
        if rc != 1:
            raise ValueError(f"encode_jpeg: {err.value.decode()}")
        cap = n.value


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

# colour type → (channels per pixel, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}


def _png_chunks(data: bytes, name: str) -> dict:
    if data[:8] != _PNG_SIG:
        raise ValueError(f"undecodable PNG {name}: no PNG signature")
    pos, chunks = 8, {"IDAT": []}
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
        key = ctype.decode("latin-1")
        if key == "IDAT":
            chunks["IDAT"].append(body)
        elif key == "IEND":
            return chunks
        elif key in ("IHDR", "PLTE", "tRNS", "eXIf"):
            chunks.setdefault(key, body)


def _png(data: bytes, name: str, color: bool) -> np.ndarray:
    c = _png_chunks(data, name)
    if len(c.get("IHDR", b"")) != 13 or not c["IDAT"]:
        raise ValueError(f"undecodable PNG {name}: no IHDR or IDAT")
    width, height, depth, ctype, compression, filt, interlace = struct.unpack(">IIBBBBB", c["IHDR"])
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1]:
        raise ValueError(f"undecodable PNG {name}: colour type {ctype} at {depth} bits is not in the PNG spec")
    if compression != 0 or filt != 0 or interlace > 1:
        raise ValueError(f"undecodable PNG {name}: unknown compression, filter or interlace method")
    if width == 0 or height == 0:
        raise ValueError(f"undecodable PNG {name}: empty image")
    if ctype == 3 and "PLTE" not in c:
        raise ValueError(f"undecodable PNG {name}: palette image without PLTE")
    try:
        raw = zlib.decompress(b"".join(c["IDAT"]))
    except zlib.error as e:
        raise ValueError(f"undecodable PNG {name}: {e}") from None
    channels = _PNG_TYPES[ctype][0]
    samples = np.empty((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    raw = np.frombuffer(raw, np.uint8)
    rc = _lib().tl_png_samples(raw.ctypes.data, raw.size, width, height, depth, channels, interlace,
                               samples.ctypes.data)
    if rc == -2:
        raise ValueError(f"undecodable PNG {name}: image data is short (truncated)")
    if rc != 0:
        raise ValueError(f"undecodable PNG {name}: unknown row filter type")
    img = _png_layout(samples, ctype, depth, c.get("PLTE"), c.get("tRNS"), color)
    if color:  # cv2 applies an eXIf orientation under IMREAD_COLOR
        exif = c.get("eXIf")
        if exif:
            e = np.frombuffer(exif, np.uint8)
            img = containers.orient(img, _lib().tl_exif_orientation(e.ctypes.data, e.size))
    return img


def _png_layout(s: np.ndarray, ctype: int, depth: int, plte, trns, color: bool) -> np.ndarray:
    """PNG samples → what OpenCV's PNG decoder asks libpng for: palette
    expanded, gray of 1/2/4 bits scaled to 8, gray → BGR and alpha dropped
    under IMREAD_COLOR (16 bits stripped to their high byte), and under
    IMREAD_UNCHANGED gray (H, W), BGR, or BGRA where the file has alpha or a
    tRNS chunk on RGB or a palette. Returns RGB(A) for ``color``, cv2's
    BGR(A) channel order otherwise."""
    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        p = np.frombuffer(plte, np.uint8)[: len(plte) // 3 * 3].reshape(-1, 3)[:256]
        pal[: len(p), :3] = p
        if trns:
            t = np.frombuffer(trns, np.uint8)[:256]
            pal[: len(t), 3] = t
        s = pal[s[..., 0]]
        if not trns or color:
            s = s[..., :3]
    elif ctype == 0 and depth < 8:
        s = s * np.uint8(255 // ((1 << depth) - 1))
    elif ctype == 2 and trns and not color and len(trns) == 6:
        key = np.array(struct.unpack(">HHH", trns), np.uint16).astype(s.dtype)
        alpha = np.where((s == key).all(-1), 0, np.iinfo(s.dtype).max).astype(s.dtype)
        s = np.concatenate([s, alpha[..., None]], -1)
    if s.shape[-1] == 2:  # gray + alpha
        s = s[..., [0, 0, 0, 1]]
    if color:
        if s.dtype == np.uint16:
            s = (s >> 8).astype(np.uint8)
        s = s[..., [0, 0, 0]] if s.shape[-1] == 1 else s[..., :3]
        return np.ascontiguousarray(s)
    if s.shape[-1] == 1:
        return np.ascontiguousarray(s[..., 0])
    return np.ascontiguousarray(s[..., [2, 1, 0, 3][: s.shape[-1]]])


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes → the array ``cv2.imdecode(..., IMREAD_UNCHANGED)`` gives
    (BGR/BGRA channel order, uint8 or uint16); ``ValueError`` naming
    ``name``. ``decode_image`` gives IMREAD_COLOR's."""
    return _png(data, name, False)


def read_png(path: str) -> np.ndarray:
    return decode_png(_read(path), path)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def encode_png(img: np.ndarray) -> bytes:
    """Array in cv2's layout ((H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA,
    uint8 or uint16: every layout ``decode_png`` returns) → PNG bytes, every
    row with filter None, as ``cv2.imwrite`` lays it out: 8- or 16-bit gray,
    RGB or RGBA."""
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if img.dtype not in (np.uint8, np.uint16) or channels not in (1, 3, 4):
        raise ValueError(f"write_png: unsupported array {img.shape} {img.dtype}")
    color, depth = {1: 0, 3: 2, 4: 6}[channels], img.dtype.itemsize * 8
    if channels >= 3:
        img = img[..., [2, 1, 0, 3][:channels]]  # BGR(A) → RGB(A) on disk
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# ---------------------------------------------------------------------------
# Any frame, told apart by its signature as cv2 does, and the resizes
# ---------------------------------------------------------------------------

# containers cv2 decodes that the port does not yet
_NOT_PORTED = ((lambda d: d[4:12] in (b"ftypavif", b"ftypavis"), "AVIF"),)


def _format(data: bytes, name: str) -> str:
    """``"jpeg"``, ``"png"`` or a container of ``containers.DECODERS``,
    from the leading bytes as cv2 tells them apart; ``ValueError`` naming
    ``name`` for a format the port does not decode yet, for OpenEXR (cv2 is
    built without it and returns None) and for no known signature."""
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:8] == _PNG_SIG:
        return "png"
    fmt = containers.sniff(data)
    if fmt:
        return fmt
    if webp.sniff(data):
        return "webp"
    if jpeg2000.sniff(data):
        return "jpeg2000"
    for test, fmt in _NOT_PORTED:
        if test(data):
            raise ValueError(f"unsupported image {name}: {fmt} is not yet ported (cv2 decodes it)")
    if data[:4] == b"v/1\x01":
        raise ValueError(f"undecodable image {name}: OpenEXR (cv2 is built without it and returns None)")
    raise ValueError(f"undecodable image {name}: unknown format (no signature cv2 reads)")


def _color(data: bytes, name: str, file: bool) -> np.ndarray:
    fmt = _format(data, name)
    if fmt == "jpeg":
        return _jpeg(data, name, file, False)
    if fmt == "png":
        return _png(data, name, True)
    if fmt == "webp":
        return np.ascontiguousarray(webp.decode(data, name, True)[..., ::-1])
    if fmt == "jpeg2000":
        return np.ascontiguousarray(jpeg2000.decode(data, name, True)[..., ::-1])
    bgr = containers.decode(fmt, data, name, True, file)
    if bgr.ndim != 3:  # a gray PFM: cv2.cvtColor(BGR2RGB) refuses one channel
        raise ValueError(f"undecodable image {name}: {fmt} decodes to one channel under IMREAD_COLOR")
    return np.ascontiguousarray(bgr[..., ::-1])


def _unchanged(data: bytes, name: str, file: bool) -> np.ndarray:
    fmt = _format(data, name)
    if fmt == "jpeg":
        return _jpeg(data, name, file, True)
    if fmt == "png":
        return _png(data, name, False)
    if fmt == "webp":
        return webp.decode(data, name, False)
    if fmt == "jpeg2000":
        return jpeg2000.decode(data, name, False)
    return containers.decode(fmt, data, name, False, file)


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Image bytes → (H, W, 3) RGB uint8: ``cvtColor(imdecode(b,
    IMREAD_COLOR), COLOR_BGR2RGB)`` of any format the port reads, told apart
    by signature."""
    return _color(data, name, False)


def read_image(path: str) -> np.ndarray:
    """``decode_image`` of a file as ``cv2.imread(path, IMREAD_COLOR)``
    reads it (a cut JPEG file decodes padded), whatever its extension."""
    return _color(_read(path), path, True)


def decode_unchanged(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """``cv2.imdecode(b, IMREAD_UNCHANGED)``: cv2's layout and dtype (BGR or
    BGRA order; uint8, uint16 or float32)."""
    return _unchanged(data, name, False)


def read_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_UNCHANGED)`` of a file, whatever its
    extension."""
    return _unchanged(_read(path), path, True)


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
