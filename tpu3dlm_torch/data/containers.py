"""The image containers cv2 reads besides JPEG and PNG, decoded as cv2 5.0
decodes them (``data/codecs.py`` tells them apart and calls ``decode``).

Each decoder returns the array ``cv2.imdecode`` gives, in cv2's channel
order (BGR, BGRA), under IMREAD_COLOR (``color=True``) or IMREAD_UNCHANGED,
or the one ``cv2.imread`` gives of the same bytes as a file (``file``), or
raises ``ValueError`` where cv2 returns ``None``. Python reads the headers
and inflates Deflate data (``zlib``); the bit-level work (text samples, run
lengths, LZW, RGBE scanlines) is ``csrc/host/containers.cpp``. The rules
are cv2's own, including its odd ones:

- PNM (P1-P6): binary samples are taken as they are, text samples of 8
  bits scaled by 255 / maxval and clamped to it, 16-bit samples (maxval >
  255) kept under IMREAD_UNCHANGED and ``>> 8`` under IMREAD_COLOR; P1/P4
  read 1 as black. PAM (P7): the tuple types BLACKANDWHITE, GRAYSCALE,
  GRAYSCALE_ALPHA, RGB and RGB_ALPHA at their own depth (a PAM without
  TUPLTYPE only as 8-bit gray or RGB), samples unscaled and in file order
  (RGB is not swapped), maxval 1 read as packed bits; under IMREAD_COLOR
  cv2 writes only the first ceil(W / depth) pixels of a row of an alpha
  PAM (the rest are left as allocated; here zero). PFM: float32, rows
  bottom-up, divided by |scale|; IMREAD_COLOR rounds and saturates with no
  ×255, and leaves a gray PFM one channel.
- BMP: 1/4/8 bpp with a palette (gray palettes give one channel under
  IMREAD_UNCHANGED), RLE4/RLE8, 15/16 bpp (555 or 565 bit fields), 24 bpp,
  32 bpp (BI_RGB: 3 channels; BI_BITFIELDS: BGRA under IMREAD_UNCHANGED),
  OS/2 headers, bottom-up or top-down.
- TIFF and BigTIFF (libtiff 4.7 as cv2's TiffDecoder drives it): strips
  or tiles, chunky or planar; no compression, LZW, Deflate, PackBits, JPEG
  (each strip or tile an abbreviated stream after the JPEGTables, decoded
  by ``codecs.py``'s libjpeg-turbo decoder; YCbCr made RGB by it) and CCITT
  (Modified Huffman, its word-aligned form, T.4 1-D and 2-D, T.6, either
  FillOrder; ``csrc/host/tiff.cpp``); the horizontal and floating point
  predictors (LZW and Deflate only, as in libtiff). 8-bit results come
  through libtiff's RGBA reader (gray maps, MinIsWhite, 16-bit gray by its
  high byte and colour by a rounded /257, unassociated alpha premultiplied,
  palettes, CMYK, YCbCr sampling units through TIFFYCbCrToRGB, CIELab
  through TIFFCIELabToRGB with the sRGB display); 10, 12, 14, 16, 32 and
  64-bit results are the samples (10 to 14 bits moved to the top of 16).
  The Orientation tag turns the image. What cv2's libtiff is built without
  (old JPEG, PixarLog, JBIG, LZMA, ZSTD, WebP, LERC) is refused saying so;
  NeXT, ThunderScan and SGILog are not yet ported.
- Sun raster: 1/8/24/32 bits, colour maps; 24 and 32 bits as B, G, R.
  Radiance HDR: flat or new run-length RGBE scanlines → float32 BGR,
  ×255 and saturated under IMREAD_COLOR. GIF: the first image on its
  logical screen, BGRA where it has a transparent index.
"""

from __future__ import annotations

import ctypes
import re
import struct
import zlib

import numpy as np

from tpu3dlm_torch.kernels.build import load_host_library


def _lib() -> ctypes.CDLL:
    lib = load_host_library("containers")
    if not getattr(lib, "_typed", False):
        p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.tl_pnm_ascii.argtypes = [p, sz, ctypes.POINTER(sz), sz, i, p]
        lib.tl_bmp_rle.argtypes = [p, sz, i, i, i, i, p, p, p]
        lib.tl_tiff_lzw.argtypes = [p, sz, p, sz]
        lib.tl_packbits.argtypes = [p, sz, p, sz]
        lib.tl_hdr_rgbe.argtypes = [p, sz, i, i, p]
        lib.tl_gif_lzw.argtypes = [p, sz, i, p, sz]
        lib.tl_gif_lzw.restype = ctypes.c_int64
        for fn in (lib.tl_pnm_ascii, lib.tl_bmp_rle, lib.tl_hdr_rgbe):
            fn.restype = i
        for fn in (lib.tl_tiff_lzw, lib.tl_packbits):
            fn.restype = ctypes.c_int64
        lib._typed = True
    return lib


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation: EXIF orientation 2-8 as flips and a
    transpose (1 and anything else leave the image as it is)."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    if flip:
        img = np.flip(img, flip)
    return np.ascontiguousarray(img)


def _fail(fmt: str, name: str, why: str):
    raise ValueError(f"undecodable {fmt} {name}: {why}")


def _size(fmt: str, name: str, w: int, h: int, channels: int = 1) -> None:
    """cv2's limits on a decoded image (CV_IO_MAX_IMAGE_WIDTH, _HEIGHT and
    _PIXELS), checked before anything is allocated for it."""
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20 and w * h * channels <= 1 << 30):
        _fail(fmt, name, f"image of {w}x{h}x{channels} outside cv2's limits")


def _u8(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


# ---------------------------------------------------------------------------
# PNM, PAM, PFM
# ---------------------------------------------------------------------------


def _ascii_numbers(data: bytes, pos: int, count: int, maxdigits: int, name: str):
    """``count`` numbers of a PNM's text from ``pos``: (int32 array, the
    position after them)."""
    src = _u8(data)
    out = np.empty(count, np.int32)
    at = ctypes.c_size_t(pos)
    rc = _lib().tl_pnm_ascii(src.ctypes.data, src.size, ctypes.byref(at), count, maxdigits, out.ctypes.data)
    if rc == -2:
        _fail("PNM", name, "data ends early (truncated)")
    if rc != 0:
        _fail("PNM", name, "bad character or number in the text samples")
    return out, at.value


def _need(data: bytes, pos: int, n: int, fmt: str, name: str) -> bytes:
    if pos + n > len(data):
        _fail(fmt, name, "data ends early (truncated)")
    return data[pos:pos + n]


def _unpack_bits(rows: np.ndarray, width: int) -> np.ndarray:
    """(H, bytes) packed MSB-first → (H, width) of 0/1."""
    return np.unpackbits(rows, axis=1)[:, :width]


def _gray_to(img: np.ndarray, color: bool) -> np.ndarray:
    return np.ascontiguousarray(np.repeat(img[..., None], 3, -1)) if color else img


def _pnm(data: bytes, name: str, color: bool, file: bool = False) -> np.ndarray:
    kind = data[1] - ord("0")
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    binary = kind >= 4
    (w, h), pos = _ascii_numbers(data, 2, 2, 0, name)
    maxval = 1
    if bpp != 1:
        (maxval,), pos = _ascii_numbers(data, pos, 1, 0, name)
        if maxval > 65535:
            _fail("PNM", name, f"maxval {maxval} above 65535")
    if w <= 0 or h <= 0 or maxval <= 0:
        _fail("PNM", name, "empty image or maxval 0")
    _size("PNM", name, w, h, 3)
    deep = maxval > 255
    nch = 3 if bpp == 24 else 1
    if bpp == 1:
        if binary:
            rows = _u8(_need(data, pos, h * ((w + 7) // 8), "PNM", name)).reshape(h, -1)
            bits = _unpack_bits(rows, w)
        else:
            bits = (_ascii_numbers(data, pos, w * h, 1, name)[0] != 0).reshape(h, w)
        return _gray_to(np.where(bits == 1, 0, 255).astype(np.uint8), color)
    n = w * h * nch
    if binary:
        raw = _need(data, pos, n * (2 if deep else 1), "PNM", name)
        s = np.frombuffer(raw, ">u2" if deep else np.uint8).reshape(h, w, nch)
    else:
        codes = np.minimum(_ascii_numbers(data, pos, n, 0, name)[0], maxval).reshape(h, w, nch)
        if deep:
            s = codes.astype(np.uint16)
        else:
            s = (codes * 255 // maxval).astype(np.uint8)
    s = s.astype(np.uint16 if deep else np.uint8)
    if color and deep:
        s = (s >> 8).astype(np.uint8)
    if nch == 3:
        return np.ascontiguousarray(s[..., ::-1])
    return _gray_to(np.ascontiguousarray(s[..., 0]), color)


# tuple type → its depth (channels)
_PAM_TYPES = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2, "RGB": 3, "RGB_ALPHA": 4}


def _pam_header(data: bytes, name: str):
    """cv2's PAM header: lines of IDENT value up to ENDHDR; returns
    (fields, offset of the samples)."""
    if data[2:3] not in (b"\n", b"\r"):
        _fail("PAM", name, "no line break after P7")
    pos, fields = 3, {}
    n = len(data)

    def byte():
        nonlocal pos
        if pos >= n:
            _fail("PAM", name, "header ends early (truncated)")
        pos += 1
        return data[pos - 1]

    while True:
        c = byte()
        while _isspace(c):
            c = byte()
        if c == ord("#"):
            while c not in (10, 13):
                c = byte()
            continue
        ident = bytearray()
        while len(ident) < 8 and not _isspace(c):
            ident.append(c)
            c = byte()
        if not _isspace(c):
            _fail("PAM", name, "header identifier too long")
        key = ident.decode("latin-1")
        if key not in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE", "ENDHDR"):
            _fail("PAM", name, f"unknown header field {key!r}")
        value = ""
        if c not in (10, 13):
            c = byte()
            while _isspace(c):
                c = byte()
            buf = bytearray()
            while len(buf) < 255 and c not in (10, 13):
                buf.append(c)
                c = byte()
            if c not in (10, 13):
                _fail("PAM", name, "header value too long")
            value = buf.decode("latin-1").rstrip(" \t\n\v\f\r")
        if key == "ENDHDR":
            return fields, pos
        if key == "TUPLTYPE":
            if value not in _PAM_TYPES:
                _fail("PAM", name, f"tuple type {value!r} is not one cv2 reads")
            fields[key] = value
            continue
        if key in fields:
            _fail("PAM", name, f"{key} given twice")
        if not re.fullmatch(r"[0-9]+", value):  # cv2's ParseNumber: decimal digits only
            _fail("PAM", name, f"bad {key} {value!r}")
        v = int(value)
        if key == "MAXVAL" and v > 65535:
            _fail("PAM", name, f"maxval {v} above 65535")
        fields[key] = v


def _isspace(c: int) -> bool:
    return c == 32 or 9 <= c <= 13


def _pam(data: bytes, name: str, color: bool, file: bool = False) -> np.ndarray:
    f, pos = _pam_header(data, name)
    if not all(k in f for k in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL")):
        _fail("PAM", name, "WIDTH, HEIGHT, DEPTH or MAXVAL missing")
    w, h, depth, maxval = f["WIDTH"], f["HEIGHT"], f["DEPTH"], f["MAXVAL"]
    tupl = f.get("TUPLTYPE")
    if tupl is None:  # cv2 guesses only these
        if depth == 1 and maxval == 1:
            tupl = "BLACKANDWHITE"
        elif depth == 1 and maxval < 256:
            tupl = "GRAYSCALE"
        elif depth == 3 and maxval < 256:
            tupl = "RGB"
        else:
            _fail("PAM", name, f"no TUPLTYPE, and cv2 guesses none for depth {depth} at maxval {maxval}")
    if _PAM_TYPES[tupl] != depth:
        _fail("PAM", name, f"TUPLTYPE {tupl} at depth {depth}")
    if w <= 0 or h <= 0 or maxval <= 0:
        _fail("PAM", name, "empty image or maxval 0")
    _size("PAM", name, w, h, depth)
    deep = maxval > 255
    raw = _need(data, pos, w * h * depth * (2 if deep else 1), "PAM", name)
    if maxval == 1:  # cv2 reads packed bits from the first bytes of each row's samples
        if not color and depth not in (1, 3):
            _fail("PAM", name, f"maxval 1 at depth {depth}")
        bits = _unpack_bits(_u8(raw).reshape(h, w * depth), w).astype(np.uint8) * 255
        return _gray_to(bits, color or depth == 3)
    s = np.frombuffer(raw, ">u2" if deep else np.uint8).reshape(h, w, depth).astype(np.uint16 if deep else np.uint8)
    if not color:
        return np.ascontiguousarray(s[..., 0] if depth == 1 else s)
    if deep:
        s = (s >> 8).astype(np.uint8)
    if depth == 1:
        return _gray_to(np.ascontiguousarray(s[..., 0]), True)
    if depth == 3:
        return np.ascontiguousarray(s)
    out = np.zeros((h, w, 3), np.uint8)
    k = -(-w // depth)  # the pixels cv2's basic_conversion writes
    out[:, :k] = s[:, :k, [2, 1, 0]] if depth == 4 else s[:, :k, [0, 0, 0]]
    return out


def _pfm(data: bytes, name: str, color: bool, file: bool = False) -> np.ndarray:
    nch = 3 if data[1:2] == b"F" else 1
    if data[2:3] != b"\n":
        _fail("PFM", name, "no line break after the signature")
    pos, tokens = 3, []
    for _ in range(3):  # cv2's read_number: the bytes up to one whitespace
        end = pos
        while end < len(data) and not _isspace(data[end]):
            end += 1
        if end >= len(data):
            _fail("PFM", name, "header ends early (truncated)")
        tokens.append(data[pos:end].decode("latin-1"))
        pos = end + 1
    w, h = (_atoi(t) for t in tokens[:2])
    scale = _atof(tokens[2])
    if w <= 0 or h <= 0:
        _fail("PFM", name, "empty image")
    _size("PFM", name, w, h, nch)
    if scale == 0:
        _fail("PFM", name, "scale 0")
    raw = _need(data, pos, w * h * nch * 4, "PFM", name)
    img = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").reshape(h, w, nch)[::-1].astype(np.float32)
    if nch == 3:
        img = img[..., ::-1]
    img = img * np.float32(1.0 / abs(scale))
    img = np.ascontiguousarray(img if nch == 3 else img[..., 0])
    return saturate_u8(img) if color else img


def _atoi(t: str) -> int:
    m = re.match(r"\s*[+-]?\d+", t)
    return int(m.group(0)) if m else 0


def _atof(t: str) -> float:
    m = re.match(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|nan)", t, re.I)
    return float(m.group(0)) if m else 0.0


def saturate_u8(x: np.ndarray) -> np.ndarray:
    """cv2's ``convertTo(CV_8U)`` of float samples: round half to even,
    clamp to [0, 255]; NaN and values outside int32 (the SIMD conversion's
    0x80000000) give 0."""
    r = np.rint(np.asarray(x).astype(np.float64))
    bad = ~np.isfinite(r) | (r < -2147483648.0) | (r > 2147483647.0)
    return np.where(bad, 0, np.clip(np.nan_to_num(r), 0, 255)).astype(np.uint8)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3


def _bmp(data: bytes, name: str, color: bool, file: bool = False) -> np.ndarray:
    hdr = _need(data, 0, 18, "BMP", name)
    offset, size = struct.unpack("<iI", hdr[10:18])
    pos = 18
    iscolor = False
    palette = np.zeros((256, 4), np.uint8)  # B, G, R, A
    if size >= 36:
        w, h, bpp, comp = struct.unpack("<iiIi", _need(data, pos, 16, "BMP", name))
        bpp >>= 16
        if not 0 <= comp <= _BI_BITFIELDS:
            _fail("BMP", name, f"compression {comp}")
        (clrused,) = struct.unpack("<i", _need(data, pos + 28, 4, "BMP", name))
        pos = 14 + size
        ok = w > 0 and h != 0 and ((bpp in (1, 4, 8, 24, 32) and comp == _BI_RGB)
                                   or (bpp in (16, 32) and comp in (_BI_RGB, _BI_BITFIELDS))
                                   or (bpp == 4 and comp == _BI_RLE4) or (bpp == 8 and comp == _BI_RLE8))
        if not ok:
            _fail("BMP", name, f"{bpp} bpp with compression {comp}")
        iscolor = True
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                _fail("BMP", name, f"{clrused} palette entries")
            n = clrused or 1 << bpp
            palette[:n] = _u8(_need(data, pos, 4 * n, "BMP", name)).reshape(n, 4)
            p = palette[: 1 << bpp]
            iscolor = bool(((p[:, 0] != p[:, 1]) | (p[:, 0] != p[:, 2])).any())
        elif bpp == 16 and comp == _BI_BITFIELDS:
            r, g, b = struct.unpack("<III", _need(data, pos, 12, "BMP", name))
            if (b, g, r) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (b, g, r) != (0x1F, 0x7E0, 0xF800):
                _fail("BMP", name, "16-bit bit fields other than 555 and 565")
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        w, h, bpp = struct.unpack("<HHI", _need(data, pos, 8, "BMP", name))
        bpp >>= 16
        comp = _BI_RGB
        pos = 26
        if not (w > 0 and h != 0 and bpp in (1, 4, 8, 24, 32)):
            _fail("BMP", name, f"OS/2 bitmap of {bpp} bpp")
        if bpp <= 8:
            n = 1 << bpp
            palette[:n, :3] = _u8(_need(data, pos, 3 * n, "BMP", name)).reshape(n, 3)
    else:
        _fail("BMP", name, f"header of {size} bytes")
    bottom_up = h > 0
    h = abs(h)
    _size("BMP", name, w, h, 4)
    channels = (4 if bpp == 32 and comp != _BI_RGB else 3) if iscolor else 1
    if color:
        channels = 3
    nch = 3 if channels > 1 else 1
    if offset < 0 or offset > len(data):
        _fail("BMP", name, "pixel data offset past the end")
    body = data[offset:]
    bgr = np.ascontiguousarray(palette[:, :3])
    gray = _gray_palette(bgr) if nch == 1 else None
    if comp in (_BI_RLE4, _BI_RLE8):
        out = np.zeros((h, w, nch), np.uint8)
        src = _u8(body)
        g = gray if gray is not None else np.zeros(256, np.uint8)
        rc = _lib().tl_bmp_rle(src.ctypes.data, src.size, 8 if comp == _BI_RLE8 else 4, w, h, nch, bgr.ctypes.data,
                               g.ctypes.data, out.ctypes.data)
        if rc == -2:
            _fail("BMP", name, "RLE data ends early (truncated)")
        if rc != 0:
            _fail("BMP", name, "RLE run past the end of a line")
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        rows = _u8(_need(body, 0, pitch * h, "BMP", name)).reshape(h, pitch)
        if bpp <= 8:
            if bpp == 8:
                idx = rows[:, :w]
            elif bpp == 4:
                idx = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
            else:
                idx = _unpack_bits(rows, w)
            out = bgr[idx] if nch == 3 else gray[idx][..., None]
        elif bpp in (15, 16):
            t = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
            if bpp == 15:
                out = np.stack([t << 3, (t >> 2) & ~7, (t >> 7) & ~7], -1).astype(np.uint8)
            else:
                out = np.stack([t << 3, (t >> 3) & ~3, (t >> 8) & ~7], -1).astype(np.uint8)
        elif bpp == 24:
            out = rows[:, :3 * w].reshape(h, w, 3)
        else:
            out = rows[:, :4 * w].reshape(h, w, 4)[..., :max(channels, 3)]
        if nch == 1 and bpp > 8:  # an OS/2 colour bitmap cv2 takes for gray
            out = _gray_palette(out.reshape(-1, out.shape[-1])[:, :3]).reshape(h, w, 1)
    if bottom_up:
        out = out[::-1]
    out = np.ascontiguousarray(out)
    return out[..., 0] if out.shape[-1] == 1 else out


def _gray_palette(bgr: np.ndarray) -> np.ndarray:
    """cv2's CvtPaletteToGray: (B·1868 + G·9617 + R·4899 + 8192) >> 14."""
    b, g, r = (bgr[:, i].astype(np.int32) for i in range(3))
    return ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14).astype(np.uint8)



# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
               13: "I"}
_BIGTIFF_TYPES = {16: "Q", 17: "q", 18: "Q"}  # LONG8, SLONG8, IFD8: BigTIFF only
# the compressions the port decodes: none, CCITT (RLE, T.4, T.6, RLEW), LZW,
# JPEG, Deflate, PackBits
_TIFF_DECODED = (1, 2, 3, 4, 5, 7, 8, 32771, 32773, 32946)
# what cv2's libtiff is built without: it returns None ("... compression
# support is not configured")
_TIFF_CV2_LACKS = {6: "old JPEG", 32909: "PixarLog", 34661: "JBIG", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP",
                   34887: "LERC"}
# what cv2's libtiff decodes and the port does not yet
_TIFF_NOT_PORTED = {32766: "NeXT", 32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24"}
_FAX = (2, 3, 4, 32771)


def _tiff_codec(comp: int, name: str) -> None:
    """Refuses a compression the port does not decode, saying why."""
    if comp in _TIFF_DECODED:
        return
    if comp in _TIFF_CV2_LACKS:
        _fail("TIFF", name, f"{_TIFF_CV2_LACKS[comp]} compression ({comp}): cv2's libtiff is built without it "
                            "(cv2 returns None)")
    if comp in _TIFF_NOT_PORTED:
        _fail("TIFF", name, f"{_TIFF_NOT_PORTED[comp]} compression ({comp}) is not yet ported (cv2 decodes it)")
    _fail("TIFF", name, f"compression {comp} has no decoder in libtiff (cv2 returns an image of undefined content)")


def _tiff_ifd(data: bytes, name: str) -> tuple[str, dict]:
    """The first IFD of a classic TIFF or a BigTIFF: (byte order, {tag:
    values}). BigTIFF (version 43) has 8-byte offsets and counts and 20-byte
    entries whose values fit in 8 bytes inline."""
    bo = "<" if data[:2] == b"II" else ">"
    hdr = _need(data, 0, 8, "TIFF", name)
    types = _TIFF_TYPES
    if struct.unpack(bo + "H", hdr[2:4])[0] == 43:
        bytesize, zero, off = struct.unpack(bo + "HHQ", _need(data, 4, 12, "TIFF", name))
        if bytesize != 8 or zero != 0:
            _fail("TIFF", name, f"BigTIFF header with offsets of {bytesize} bytes")
        (n,) = struct.unpack(bo + "Q", _need(data, off, 8, "TIFF", name))
        head, esize, inline, at, ofmt = "HHQ", 20, 8, off + 8, "Q"
        types = {**_TIFF_TYPES, **_BIGTIFF_TYPES}
    else:
        (off,) = struct.unpack(bo + "I", hdr[4:8])
        (n,) = struct.unpack(bo + "H", _need(data, off, 2, "TIFF", name))
        head, esize, inline, at, ofmt = "HHI", 12, 4, off + 2, "I"
    ents = _need(data, at, esize * n, "TIFF", name)
    hsize = struct.calcsize(bo + head)
    tags = {}
    for i in range(n):
        e = ents[esize * i:esize * (i + 1)]
        tag, typ, count = struct.unpack(bo + head, e[:hsize])
        if typ not in types:
            continue
        code = types[typ]
        size = struct.calcsize(code) * count
        raw = e[hsize:] if size <= inline else _need(
            data, struct.unpack(bo + ofmt, e[hsize:])[0], size, "TIFF", name)
        tags[tag] = list(struct.unpack(bo + code * count, raw[:size]))
    return bo, tags


def _tiff_floats(t: dict, tag: int, default) -> list[float]:
    """A RATIONAL (or FLOAT) tag as libtiff reads it into floats."""
    if tag not in t:
        return list(default)
    v = t[tag]
    if all(isinstance(x, float) for x in v):
        return [float(np.float32(x)) for x in v]
    pairs = zip(v[0::2], v[1::2])
    return [0.0 if d == 0 else float(np.float32(nu / d)) for nu, d in pairs]


def _tiff_chunk(lib, comp: int, raw: bytes, n: int, name: str) -> np.ndarray:
    """One strip or tile decompressed to its n bytes."""
    out = np.zeros(n, np.uint8)
    if comp == 1:
        got = min(len(raw), n)
        out[:got] = _u8(raw[:got])
    elif comp == 5:
        src = _u8(raw)
        got = lib.tl_tiff_lzw(src.ctypes.data, src.size, out.ctypes.data, n)
        if got < 0:
            _fail("TIFF", name, "LZW code not yet in the table")
    elif comp in (8, 32946):
        try:
            d = zlib.decompressobj().decompress(raw, n)
        except zlib.error as e:
            _fail("TIFF", name, f"Deflate: {e}")
        got = len(d)
        out[:got] = _u8(d)
    else:
        src = _u8(raw)
        got = lib.tl_packbits(src.ctypes.data, src.size, out.ctypes.data, n)
    if got < n:
        _fail("TIFF", name, "strip or tile data ends early (truncated)")
    return out


def _tiff_fax(raw: bytes, comp: int, t: dict, tw: int, rows: int, runs: np.ndarray, name: str) -> np.ndarray:
    """One strip or tile of CCITT data (tif_fax3.c through
    ``csrc/host/tiff.cpp``, with ``runs``, the image's run array) → (rows,
    tw, 1) bits, 1 black. Data that ends inside the strip leaves the rows
    after it as libtiff leaves its buffer (not defined): the port refuses
    them."""
    out = np.zeros((rows, (tw + 7) // 8), np.uint8)
    src = _u8(raw)
    twod = comp == 3 and bool(t.get(292, [0])[0] & 1)
    got = _tiff_lib().tl_tiff_fax(src.ctypes.data, src.size, comp, int(twod), int(t.get(266, [1])[0] == 2), tw, rows,
                                  runs.ctypes.data, out.ctypes.data)
    if got < 0:
        _fail("TIFF", name, "CCITT row with more changes than libtiff's run buffer holds")
    if got < rows:
        _fail("TIFF", name, f"CCITT data ends before row {got + 1} of {rows} of a strip or tile is whole (the rows "
                            "from there on are not defined in cv2)")
    return np.unpackbits(out, axis=1)[:, :tw, None]


def _tiff_jpeg(raw: bytes, t: dict, ph: int, tw: int, rows: int, name: str) -> np.ndarray:
    """One strip or tile of JPEG-in-TIFF (tif_jpeg.c): an abbreviated stream
    read after the JPEGTables (tag 347), decoded by the port's libjpeg-turbo
    decoder as a file (a cut stream padded with libjpeg's fake EOI, as
    tif_jpeg.c's source manager does), YCbCr converted to RGB by libjpeg
    (JPEGCOLORMODE_RGB, fancy upsampling inside this strip or tile), any
    other photometric left as its components → (rows, tw, components)."""
    import ctypes as ct

    from tpu3dlm_torch.data.codecs import _ERRLEN, _lib as codecs_lib

    tables = bytes(t[347]) if 347 in t else b""
    if tables[:2] == b"\xff\xd8" and tables[-2:] == b"\xff\xd9":
        stream = tables[:-2] + raw[2:] if raw[:2] == b"\xff\xd8" else raw
    else:
        stream = raw
    lib = codecs_lib()
    src = _u8(stream)
    err = ct.create_string_buffer(_ERRLEN)
    info = (ct.c_int * 4)()
    if lib.tl_jpeg_info(src.ctypes.data, src.size, 1, info, err, _ERRLEN) != 0:
        _fail("TIFF", name, f"JPEG strip or tile: {err.value.decode()}")
    w, h, ncomp = info[0], info[1], info[2]
    if w > tw or h > rows:
        _fail("TIFF", name, f"JPEG strip or tile of {w}x{h} exceeds the expected {tw}x{rows}")
    if (w, h) != (tw, rows):
        _fail("TIFF", name, f"JPEG strip or tile of {w}x{h}, short of the expected {tw}x{rows} (not defined in cv2)")
    colour = 1 if ph == 6 else 0
    channels = 3 if colour else ncomp
    out = np.empty((h, w, channels), np.uint8)
    if lib.tl_jpeg_decode_colour(src.ctypes.data, src.size, 1, out.ctypes.data, w, h, colour, err, _ERRLEN) != 0:
        _fail("TIFF", name, f"JPEG strip or tile: {err.value.decode()}")
    return out


def _tiff_ycbcr_units(buf: np.ndarray, t: dict, rows: int, w: int, hs: int, vs: int, stride: int,
                      name: str) -> np.ndarray:
    """The first ``rows`` x ``w`` pixels of a strip or tile of 8-bit YCbCr
    sampling units (a row of units every ``stride`` bytes) as RGB (rows, w,
    3), as tif_getimage.c converts them (``csrc/host/tiff.cpp``)."""
    luma = np.asarray(_tiff_floats(t, 529, (0.299, 0.587, 0.114)), np.float32)
    rbw = np.asarray(_tiff_floats(t, 532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)), np.float32)
    if luma.size != 3 or rbw.size != 6 or np.isnan(luma).any() or luma[1] == 0:
        _fail("TIFF", name, "invalid YCbCrCoefficients (libtiff's RGBA reader refuses them)")
    if not ((rbw > np.float32(-0x7FFFFFFF + 128)) & (rbw < np.float32(0x7FFFFFFF))).all():
        _fail("TIFF", name, "invalid ReferenceBlackWhite (libtiff's RGBA reader refuses it)")
    out = np.empty((rows, w, 3), np.uint8)
    buf = np.ascontiguousarray(buf)
    _tiff_lib().tl_tiff_ycbcr(buf.ctypes.data, w, rows, hs, vs, stride, luma.ctypes.data, rbw.ctypes.data,
                              out.ctypes.data)
    return out


def _tiff_lib() -> ctypes.CDLL:
    lib = load_host_library("tiff")
    if not getattr(lib, "_typed", False):
        p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.tl_tiff_fax.argtypes = [p, sz, i, i, i, i, i, p, p]
        lib.tl_tiff_ycbcr.argtypes = [p, i, i, i, i, sz, p, p, p]
        lib.tl_tiff_cielab.argtypes = [p, sz, i, i, ctypes.c_float, ctypes.c_float, p]
        for fn in (lib.tl_tiff_fax, lib.tl_tiff_ycbcr, lib.tl_tiff_cielab):
            fn.restype = i
        lib._typed = True
    return lib


def _unpack_samples(buf: np.ndarray, rows: int, n: int, bps: int) -> np.ndarray:
    """(rows, bytes) of samples of ``bps`` bits packed MSB first, each row
    from a byte boundary → (rows, n) uint8 (bps < 8) or uint16."""
    bits = np.unpackbits(buf.reshape(rows, -1), axis=1)[:, :n * bps].reshape(rows, n, bps)
    weights = (1 << np.arange(bps - 1, -1, -1)).astype(np.uint32)
    v = bits.astype(np.uint32) @ weights
    return v.astype(np.uint8 if bps < 8 else np.uint16)


def _tiff_samples(data: bytes, name: str, bo: str, t: dict, w: int, h: int, spp: int, bps: int, fmt: int):
    """Every strip or tile decoded: ((H, W, spp) samples in the file's sample
    type (bytes of 1- and 4-bit samples unpacked to one a sample, 10-, 12-
    and 14-bit ones to uint16; JPEG's decoded pixels; subsampled YCbCr's
    RGB), the chunky tiles' bytes, the compression, whether the samples are
    YCbCr converted to RGB)."""
    comp = t.get(259, [1])[0]
    planar = t.get(284, [1])[0]
    ph = t[262][0]
    # libtiff runs the predictor in the LZW and Deflate codecs only
    pred = t.get(317, [1])[0] if comp in (5, 8, 32946) else 1
    per = spp if planar == 1 else 1
    planes = 1 if planar == 1 else spp
    tiled = 322 in t
    if tiled:
        tw, th = t[322][0], t[323][0]
        offsets, counts = t.get(324, []), t.get(325, [])
    else:
        tw, th = w, min(t.get(278, [h])[0], h) or h
        offsets, counts = t.get(273, []), t.get(279, [])
    if tw <= 0 or th <= 0 or tw * th * per * max(bps // 8, 1) >= 1 << 30:  # cv2's 1 GiB tile limit
        _fail("TIFF", name, "tile or strip of no size or over 1 GiB")
    across, down = -(-w // tw), -(-h // th)
    if len(offsets) < across * down * planes or len(counts) < len(offsets):
        _fail("TIFF", name, "fewer strips or tiles than the image needs")
    if pred == 2 and bps not in (8, 16, 32, 64):
        _fail("TIFF", name, f"horizontal predictor with {bps}-bit samples")
    if pred == 3 and fmt != 3:
        _fail("TIFF", name, "floating point predictor on integer samples")
    if pred not in (1, 2, 3):
        _fail("TIFF", name, f"predictor {pred}")
    if comp in _FAX and (bps != 1 or per != 1):
        _fail("TIFF", name, f"CCITT compression of {bps}-bit samples ({per} a pixel)")
    hs, vs = t.get(530, [2, 2])[:2] if ph == 6 else (1, 1)
    units = ph == 6 and comp != 7 and planar == 1 and (hs, vs) != (1, 1)  # subsampled YCbCr sampling units
    if units and pred != 1:
        _fail("TIFF", name, "a predictor on subsampled YCbCr")
    if comp == 7 and (planar != 1 or bps != 8):
        _fail("TIFF", name, f"JPEG compression of {bps}-bit samples, planar {planar}")
    dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}.get(bps, np.uint8 if bps < 8 else np.uint16)
    if fmt == 3:
        dtype = {32: np.float32, 64: np.float64}[bps]
    elif fmt == 2:
        dtype = {8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}[bps]
    rowbytes = (tw * per * bps + 7) // 8
    lib = _lib()
    if comp in _FAX:  # Fax3SetupState's run array, zeroed once for the image
        refline = comp == 4 or (comp == 3 and t.get(292, [0])[0] & 1)
        fax_runs = np.zeros(2 * (-(-(tw + 1) // 32) * 32 * (2 if refline else 1)) + 2, np.uint32)
    out = None
    tiles = []  # (y0, x0, tile bytes in native order) of chunky tiles
    k = 0
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                rows = th if tiled else min(th, h - ty * th)
                off, cnt = offsets[k], counts[k]
                k += 1
                raw = data[off:off + cnt]
                y0, x0 = ty * th, tx * tw
                hh, ww = min(rows, h - y0), min(tw, w - x0)
                if comp in _FAX:
                    v = _tiff_fax(raw, comp, t, tw, rows, fax_runs, name)
                elif comp == 7:
                    v = _tiff_jpeg(raw, t, ph, tw, rows, name)
                elif units:
                    unit, urow = hs * vs + 2, -(-tw // hs) * (hs * vs + 2)
                    buf = _tiff_chunk(lib, comp, raw, -(-rows // vs) * urow, name)
                    if not tiled:
                        # gtStripContig reads (rows rounded up to vs) x TIFFScanlineSize
                        # bytes of a strip, the scanline a unit row / vs rounded down
                        # (4x4: 2 bytes short for an odd count of units), into a buffer
                        # zeroed for each TIFFReadRGBAStrip cv2 makes
                        buf[-(-rows // vs) * vs * (urow // vs):] = 0
                    # tif_getimage.c skips a tile's columns past the image by
                    # (skipped pixels / hs) units of hs * 2 + 2 bytes for 4x4
                    # (putcontig8bitYCbCr44tile), of their own size otherwise
                    skip = (tw - ww) // hs * (hs * 2 + 2 if (hs, vs) == (4, 4) else unit)
                    stride = -(-ww // hs) * unit + skip
                    if (-(-hh // vs) - 1) * stride + -(-ww // hs) * unit > buf.size:
                        _fail("TIFF", name, "YCbCr tile rows past its data (not defined in cv2)")
                    v = _tiff_ycbcr_units(buf, t, hh, ww, hs, vs, stride, name)
                else:
                    buf = _tiff_chunk(lib, comp, raw, rows * rowbytes, name).reshape(rows, rowbytes)
                    if bps < 8 or bps in (10, 12, 14):
                        v = _unpack_samples(buf, rows, tw * per, bps).reshape(rows, tw, per)
                    elif pred == 3:
                        nb = bps // 8
                        b = buf.reshape(rows, rowbytes)
                        b = np.cumsum(b.reshape(rows, -1, per), axis=1, dtype=np.uint8).reshape(rows, rowbytes) \
                            if per > 1 else np.cumsum(b, axis=1, dtype=np.uint8)
                        b = b.reshape(rows, nb, tw * per).transpose(0, 2, 1)
                        v = np.ascontiguousarray(b).view(np.dtype(dtype).newbyteorder(">")).reshape(rows, tw, per)
                    else:
                        v = buf.view(np.dtype(dtype).newbyteorder(bo)).reshape(rows, tw, per)
                        if pred == 2:
                            u = v.view(np.dtype(f"u{v.dtype.itemsize}").newbyteorder(bo)).astype(f"u{v.dtype.itemsize}")
                            v = np.cumsum(u, axis=1, dtype=u.dtype).view(dtype)
                if out is None:
                    out = np.zeros((h, w, v.shape[2] if planar == 1 else spp), v.dtype.newbyteorder("="))
                out[y0:y0 + hh, x0:x0 + ww, plane:plane + v.shape[2]] = v[:hh, :ww]
                if tiled and bps >= 8 and comp != 7 and not units:
                    tiles.append((y0, x0, np.ascontiguousarray(v).astype(v.dtype.newbyteorder("<")).view(np.uint8)))
    return out, tiles, comp, units


# YCbCrSubSampling pairs with a putcontig8bitYCbCr* routine in tif_getimage.c
_YCBCR_SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
# libtiff's default WhitePoint (tif_aux.c): D50's chromaticity, in float
_D50 = np.float32(96.4250), np.float32(100.0), np.float32(82.4680)
_D50_XY = (float(_D50[0] / (_D50[0] + _D50[1] + _D50[2])), float(_D50[1] / (_D50[0] + _D50[1] + _D50[2])))


def _tiff(data: bytes, name: str, color: bool, file: bool = False) -> np.ndarray:
    bo, t = _tiff_ifd(data, name)
    if 256 not in t or 257 not in t or 262 not in t:
        _fail("TIFF", name, "no ImageWidth, ImageLength or PhotometricInterpretation")
    w, h, ph = t[256][0], t[257][0], t[262][0]
    bps = t.get(258, [1])[0]
    spp = t.get(277, [1])[0]
    fmt = t.get(339, [1])[0]
    comp = t.get(259, [1])[0]
    if w <= 0 or h <= 0:
        _fail("TIFF", name, "empty image")
    _size("TIFF", name, w, h, max(spp, 1))
    if spp > 4:
        _fail("TIFF", name, f"{spp} samples a pixel (cv2 takes 1 to 4)")
    _tiff_codec(comp, name)
    # cv2's TiffDecoder::readHeader: the type IMREAD_UNCHANGED asks for
    if bps == 1 or (bps == 4 and ph == 3) or bps == 8:
        if fmt not in (1, 2):
            _fail("TIFF", name, f"{bps}-bit samples of format {fmt}")
        depth, nch = (np.int8 if fmt == 2 else np.uint8), (3 if ph == 3 else (spp if ph > 1 else 1)) if bps != 1 else 1
    elif bps in (10, 12, 14, 16):
        if fmt not in (1, 2):
            _fail("TIFF", name, f"{bps}-bit samples of format {fmt}")
        depth, nch = (np.int16 if fmt == 2 else np.uint16), (spp if ph > 1 else 1)
        if spp not in (1, 3, 4) or ph > 2:  # cv2 reads these through the RGBA interface, as 8 bits
            depth, nch = np.uint8, (3 if ph > 1 else 1)
    elif bps in (32, 64):
        if bps == 64 and fmt != 3:
            _fail("TIFF", name, f"64-bit samples of format {fmt}")
        depth = {3: np.float32 if bps == 32 else np.float64, 2: np.int32, 1: np.uint32}.get(fmt)
        if depth is None:
            _fail("TIFF", name, f"32-bit samples of format {fmt}")
        nch = spp
    else:
        _fail("TIFF", name, f"{bps}-bit samples (cv2 takes 1, 8, 10, 12, 14, 16, 32 and 64, and 4 with a palette)")
    if color:
        depth, nch = np.uint8, 3
    rgba = np.dtype(depth).itemsize == 1  # libtiff's RGBA interface (TIFFReadRGBAStrip / Tile)
    planar = t.get(284, [1])[0] == 2 and spp > 1
    if rgba and (bps not in (1, 4, 8, 16) or fmt == 3):
        _fail("TIFF", name, f"{bps}-bit samples of format {fmt} have no 8-bit form in libtiff")
    if rgba:
        _tiff_rgba_ok(t, ph, bps, spp, planar, comp, name)
    tiled = 322 in t
    if rgba and tiled and comp == 1 and not file:  # as cv2.imdecode (not imread) refuses them
        if ph == 6 and not planar:
            hs, vs = t.get(530, [2, 2])[:2]
            tile_bytes = -(-t[322][0] // hs) * -(-t[323][0] // vs) * (hs * vs + 2)
        else:
            tile_bytes = t[322][0] * t[323][0] * (1 if planar else spp) * bps // 8
        if tile_bytes % 1024:
            _fail("TIFF", name, "uncompressed tiles of a size libtiff's RGBA reader refuses from memory")
    samples, tiles, comp, as_rgb = _tiff_samples(data, name, bo, t, w, h, spp, bps, fmt)
    if rgba:
        if comp == 7 and samples.shape[2] != spp:
            _fail("TIFF", name, f"JPEG of {samples.shape[2]} components in a TIFF of {spp} samples")
        if as_rgb or (comp == 7 and ph == 6):  # YCbCr made RGB
            rgb, alpha = samples, None
        elif ph == 6:
            units = np.ascontiguousarray(samples.reshape(h, w * 3))
            rgb = _tiff_ycbcr_units(units, t, h, w, 1, 1, w * 3, name)
            alpha = None
        elif ph == 8:
            rgb, alpha = _tiff_cielab(samples, t, bps, name), None
        else:
            rgb, alpha = _tiff_rgba(samples, t, ph, bps, spp, planar, name)
            if tiles and not planar and ph in (0, 1) and (bps == 16 or spp > 1):
                _tiff_gray_tile_skew(rgb, tiles, t, bps, spp, ph)
        if nch == 3:
            img = rgb[..., ::-1]
        elif nch == 4:
            img = np.concatenate([rgb[..., ::-1], np.full((h, w, 1), 255, np.uint8) if alpha is None
                                  else alpha[..., None]], -1)
        else:
            img = _gray_palette(rgb.reshape(-1, 3)[:, ::-1]).reshape(h, w)
        img = np.ascontiguousarray(img).view(depth)
    else:
        if ph == 3:
            _fail("TIFF", name, f"a {bps}-bit palette image")
        img = samples.astype(samples.dtype.newbyteorder("="))
        if bps in (10, 12, 14):  # cv2 moves the samples to the top bits of its 16
            img = (img.view(np.uint16) << np.uint16(16 - bps)).view(depth)
        if nch == 1:
            img = img[..., 0]
        elif nch >= 3:
            img = img[..., [2, 1, 0, 3][:nch]]
    orientation = t.get(274, [1])[0]
    if file and orientation in (5, 6, 7, 8) and h != w:  # cv2.imread's check that the decoder kept its buffer
        _fail("TIFF", name, f"orientation {orientation} transposes a non-square image, which cv2.imread refuses")
    return orient(img, orientation)


def _tiff_rgba_ok(t: dict, ph: int, bps: int, spp: int, planar: bool, comp: int, name: str) -> None:
    """What libtiff's RGBA interface (TIFFRGBAImageOK, PickContigCase,
    PickSeparateCase) refuses for YCbCr, CIELab and the Lab variants, and
    for CCITT and JPEG data of another shape; cv2 returns None for each."""
    if ph == 6 and comp != 7:
        sub = tuple(t.get(530, [2, 2])[:2])
        if bps != 8 or spp != 3 or (planar and sub != (1, 1)) or sub not in _YCBCR_SUBSAMPLINGS:
            _fail("TIFF", name, f"YCbCr of {bps}-bit samples, {spp} a pixel, subsampling {sub}, planar {planar}: "
                                "libtiff's RGBA reader has no routine for it (cv2 returns None)")
    if ph == 8 and (spp != 3 or bps not in (8, 16) or planar):
        _fail("TIFF", name, f"CIELab of {spp} {bps}-bit samples a pixel, planar {planar}: libtiff's RGBA reader "
                            "has no routine for it (cv2 returns None)")
    if ph in (9, 10):
        _fail("TIFF", name, f"photometric {'ICCLab' if ph == 9 else 'ITULab'} ({ph}): libtiff's RGBA reader "
                            "refuses it (cv2 returns None)")
    if comp == 7 and (ph not in (1, 2, 5, 6) or bps != 8 or planar):
        _fail("TIFF", name, f"JPEG compression with photometric {ph}, {bps}-bit samples, planar {planar}")


def _tiff_cielab(s: np.ndarray, t: dict, bps: int, name: str) -> np.ndarray:
    """CIELab samples (8-bit L with signed a and b, or 16-bit) → RGB as
    tif_getimage.c's putcontig8bitCIELab8 / 16 convert them, with the
    WhitePoint tag (318; D50 by default) (``csrc/host/tiff.cpp``)."""
    wx, wy = _tiff_floats(t, 318, _D50_XY)[:2]
    if wy == 0:
        _fail("TIFF", name, "WhitePoint with y 0 (libtiff's RGBA reader refuses it)")
    h, w = s.shape[:2]
    src = np.ascontiguousarray(s[..., :3].view(np.uint8 if bps == 8 else np.uint16))
    out = np.empty((h, w, 3), np.uint8)
    _tiff_lib().tl_tiff_cielab(src.ctypes.data, h * w, 3, bps, wx, wy, out.ctypes.data)
    return out


def _tiff_rgba(s: np.ndarray, t: dict, ph: int, bps: int, spp: int, planar: bool, name: str):
    """libtiff's tif_getimage.c: the samples as 8-bit (RGB, alpha or None).
    Planes (gray with alpha too) go through its RGB "separate" routines: no
    gray map, 16 bits as a rounded /257, unassociated alpha premultiplied."""
    h, w = s.shape[:2]
    extra = t.get(338, [])
    if bps == 16:  # grey 16 uses its high byte; colour its rounded /257
        s16 = s.view(np.uint16) if s.dtype.itemsize == 2 else s
    if planar and ph in (0, 1, 2):
        c = ((s16.astype(np.uint32) + 128) // 257).astype(np.uint8) if bps == 16 else s.view(np.uint8)
        colour = 1 if ph in (0, 1) else 3
        if spp < colour:
            _fail("TIFF", name, f"RGB with {spp} samples")
        rgb = np.ascontiguousarray(c[..., [0, 0, 0]] if colour == 1 else c[..., :3])
        alpha = _tiff_alpha(extra, spp, ph)
        a = c[..., colour] if alpha else None
        if alpha == 2:
            rgb = ((rgb.astype(np.uint32) * a[..., None].astype(np.uint32) + 127) // 255).astype(np.uint8)
        return rgb, a
    if ph in (0, 1):
        if bps == 16:
            v = (s16[..., 0] >> 8).astype(np.uint8)
        elif bps == 1:
            v = (s[..., 0] * 255).astype(np.uint8)
        else:
            v = s[..., 0].view(np.uint8)
        if ph == 0:
            v = 255 - v
        return np.repeat(v[..., None], 3, -1), None
    if ph == 2:
        if spp < 3:
            _fail("TIFF", name, f"RGB with {spp} samples")
        if bps == 16:
            c = ((s16.astype(np.uint32) + 128) // 257).astype(np.uint8)
        elif bps == 8:
            c = s.view(np.uint8)
        else:
            _fail("TIFF", name, f"{bps}-bit RGB")
        rgb, a = c[..., :3], (c[..., 3] if spp > 3 else None)
        if a is not None and _tiff_alpha(extra, spp, ph) == 2:  # unassociated alpha → premultiplied (UaToAa)
            rgb = ((rgb.astype(np.uint32) * a[..., None].astype(np.uint32) + 127) // 255).astype(np.uint8)
        return rgb, a
    if ph == 3:
        if bps > 8:
            _fail("TIFF", name, f"a {bps}-bit palette image (libtiff's RGBA reader has no routine for it)")
        cmap = np.asarray(t.get(320, []), np.uint32)
        n = 1 << bps
        if cmap.size != 3 * n:
            _fail("TIFF", name, "palette image without a colour map of its size")
        cmap = cmap.reshape(3, n).T
        if (cmap >= 256).any():  # libtiff's checkcmap: a 16-bit map is cut to its high bytes
            cmap = cmap >> 8
        return cmap.astype(np.uint8)[s[..., 0]], None
    if ph == 5 and bps == 8 and t.get(332, [1])[0] == 1 and spp - len(extra) >= 4:  # putRGBcontig8bitCMYKtile
        k = 255 - s[..., 3:4].astype(np.uint32)
        return (k * (255 - s[..., :3].astype(np.uint32)) // 255).astype(np.uint8), None
    if ph == 5:  # TIFFRGBAImageOK: 8-bit CMYK (InkSet 1, four inks) only
        _fail("TIFF", name, f"separated (CMYK) of {bps}-bit samples, {spp} a pixel: libtiff's RGBA reader has no "
                            "routine for it (cv2 returns None)")
    if ph in (32844, 32845):
        _fail("TIFF", name, f"photometric {'LogL' if ph == 32844 else 'LogLuv'} is not yet ported")
    _fail("TIFF", name, f"photometric {ph}: libtiff's RGBA reader refuses it (cv2 returns None)")


def _tiff_gray_tile_skew(rgb: np.ndarray, tiles: list, t: dict, bps: int, spp: int, ph: int) -> None:
    """libtiff's putgreytile, putagreytile and put16bitbwtile step from one
    row of a tile to the next by (tile width - pixels put) bytes without
    scaling it by the pixel's bytes, so on a tile cut by the image's right
    edge each row after the first reads the tile's bytes from too early.
    Redo the gray of such tiles as they read them."""
    h, w = rgb.shape[:2]
    tw = t[322][0]
    px = spp * bps // 8
    for y0, x0, buf in tiles:
        ww = min(tw, w - x0)
        if ww == tw:
            continue
        hh = min(t[323][0], h - y0)
        raw = buf.reshape(-1)
        stride = ww * px + (tw - ww)
        starts = (np.arange(hh) * stride)[:, None] + np.arange(ww)[None, :] * px
        if bps == 16:  # the high byte of a little-endian uint16, at any byte offset
            v = raw[starts + 1]
        else:
            v = raw[starts]
        if ph == 0:
            v = 255 - v
        rgb[y0:y0 + hh, x0:x0 + ww] = v[..., None]


def _tiff_alpha(extra: list, spp: int, ph: int) -> int:
    """libtiff's TIFFRGBAImageBegin: 1 associated alpha, 2 unassociated, 0
    none (an unspecified extra sample is alpha past 3 samples, and RGB of 4
    samples with no ExtraSamples has associated alpha)."""
    if extra:
        return {0: 1 if spp > 3 else 0, 1: 1, 2: 2}.get(extra[0], 0)
    return 1 if spp == 4 and ph == 2 else 0


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------


def _sun(data: bytes, name: str, color: bool, file: bool = False) -> np.ndarray:
    hdr = _need(data, 0, 32, "Sun raster", name)
    _, w, h, bpp, _, encoding, maptype, maplength = struct.unpack(">8i", hdr)
    pal_size = (1 << bpp) * 3 if 0 < bpp <= 8 else 0
    if not (w > 0 and h > 0 and bpp in (1, 8, 24, 32)):
        _fail("Sun raster", name, f"{w}x{h} at {bpp} bits")
    _size("Sun raster", name, w, h, 3)
    if encoding == 2:  # cv2 5.0 returns None for every run-length encoded raster tried
        _fail("Sun raster", name, "run-length encoded (type 2), which cv2 does not decode")
    if encoding not in (0, 1) or not ((maptype == 0 and maplength == 0)
                                      or (maptype == 1 and 0 < maplength <= pal_size and bpp <= 8)):
        _fail("Sun raster", name, f"encoding {encoding} with colour map type {maptype} of {maplength} bytes")
    palette = np.zeros((256, 3), np.uint8)  # B, G, R
    if maplength:
        m = _u8(_need(data, 32, maplength, "Sun raster", name))
        n = maplength // 3
        palette[:n] = np.stack([m[2 * n:3 * n], m[n:2 * n], m[:n]], -1)
        p = palette[: 1 << bpp]
        iscolor = bool(((p[:, 0] != p[:, 1]) | (p[:, 0] != p[:, 2])).any())
    else:
        iscolor = bpp > 8
        if not iscolor:  # FillGrayPalette
            palette[: 1 << bpp] = (np.arange(1 << bpp) * (255 // ((1 << bpp) - 1)))[:, None]
    nch = 3 if (color or iscolor) else 1
    # cv2 fills its gray lookup only from a colour map: mapless gray reads 0
    gray = _gray_palette(palette) if maptype == 1 else np.zeros(256, np.uint8)
    pos = 32 + maplength
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    body = data[pos:]
    rows = _u8(_need(body, 0, pitch * h, "Sun raster", name)).reshape(h, pitch)
    if bpp == 1:
        idx = _unpack_bits(rows, w)
    elif bpp == 8:
        idx = rows[:, :w]
    if bpp <= 8:
        return np.ascontiguousarray(palette[idx]) if nch == 3 else gray[idx]
    px = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)
    bgr = px[..., 1:4] if bpp == 32 else px  # the bytes as B, G, R, whatever the type
    if nch == 3:
        return np.ascontiguousarray(bgr)
    return _gray_palette(bgr.reshape(-1, 3)).reshape(h, w)


# ---------------------------------------------------------------------------
# Radiance HDR
# ---------------------------------------------------------------------------


def _hdr(data: bytes, name: str, color: bool, file: bool = False) -> np.ndarray:
    pos = 0

    def line():  # C fgets into a 128-byte buffer: up to 127 bytes, or to a newline
        nonlocal pos
        if pos >= len(data):
            _fail("Radiance HDR", name, "header ends early (truncated)")
        end = data.find(b"\n", pos, pos + 127)
        end = pos + 127 if end < 0 else end + 1
        out = data[pos:end]
        pos = end
        return out

    buf = line()
    while True:  # rgbe.cpp's RGBE_ReadHeader
        if buf[:1] in (b"", b"\n", b"\x00"):
            _fail("Radiance HDR", name, "no FORMAT specifier")
        if buf == b"FORMAT=32-bit_rle_rgbe\n":
            break
        buf = line()
    if line() != b"\n":
        _fail("Radiance HDR", name, "no blank line after FORMAT")
    m = re.match(rb"-Y\s*([+-]?\d+)\s+\+X\s*([+-]?\d+)", line())
    if not m:
        _fail("Radiance HDR", name, "no -Y H +X W size line")
    h, w = int(m.group(1)), int(m.group(2))
    if w <= 0 or h <= 0:
        _fail("Radiance HDR", name, "empty image")
    _size("Radiance HDR", name, w, h, 4)
    rgbe = np.empty((h, w, 4), np.uint8)
    src = _u8(data[pos:])
    rc = _lib().tl_hdr_rgbe(src.ctypes.data, src.size, w, h, rgbe.ctypes.data)
    if rc == -2:  # cv2 leaves the rest of its buffer as allocated: the port refuses
        _fail("Radiance HDR", name, "pixel data ends early (truncated)")
    if rc != 0:
        _fail("Radiance HDR", name, "bad run-length scanline")
    e = rgbe[..., 3].astype(np.int32)
    f = np.ldexp(np.ones_like(e, np.float64), e - 136).astype(np.float32)
    img = np.where(e[..., None] != 0, rgbe[..., :3].astype(np.float32) * f[..., None], np.float32(0))
    img = np.ascontiguousarray(img[..., ::-1], np.float32)  # R, G, B in the file; cv2 returns BGR
    if not color:
        return img
    with np.errstate(over="ignore"):  # past float32 the product is inf, which cv2's cast makes 0
        return saturate_u8(img * np.float32(255))


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def _gif(data: bytes, name: str, color: bool, file: bool = False) -> np.ndarray:
    """The first image of a GIF on its logical screen, as cv2 5.0's own
    decoder draws it: the screen filled with the global colour table's
    background entry, the image placed at its offset through its local or
    the global table (gray, the index itself but 1 white, where there is
    none); with a
    transparent index in the image's Graphic Control Extension the result
    is BGRA, alpha 0 on the transparent pixels and off the image."""
    sw, sh, flags, bg = struct.unpack("<HHBB", _need(data, 6, 6, "GIF", name))
    _size("GIF", name, sw, sh, 4)
    pos = 13
    table = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        table = _u8(_need(data, pos, 3 * n, "GIF", name)).reshape(n, 3)
        pos += 3 * n
        if bg >= n:
            _fail("GIF", name, f"background index {bg} past the global colour table")
    transparent = None
    while True:
        kind = _need(data, pos, 1, "GIF", name)[0]
        pos += 1
        if kind == 0x21:  # an extension: label, then sub-blocks
            label = _need(data, pos, 1, "GIF", name)[0]
            pos += 1
            blocks, pos = _gif_blocks(data, pos, name)
            if label == 0xF9 and len(blocks) >= 4 and blocks[0] & 1:
                transparent = blocks[3]
            continue
        if kind != 0x2C:
            _fail("GIF", name, "no image before the trailer" if kind == 0x3B else f"unknown block 0x{kind:02x}")
        break
    left, top, w, h, lflags = struct.unpack("<HHHHB", _need(data, pos, 9, "GIF", name))
    pos += 9
    if not (w > 0 and h > 0 and left + w <= sw and top + h <= sh):
        _fail("GIF", name, "image outside the logical screen")
    if lflags & 0x80:
        n = 2 << (lflags & 7)
        table = _u8(_need(data, pos, 3 * n, "GIF", name)).reshape(n, 3)
        pos += 3 * n
    min_size = _need(data, pos, 1, "GIF", name)[0]
    pos += 1
    if not 2 <= min_size <= 11:
        _fail("GIF", name, f"LZW minimum code size {min_size}")
    lzw, pos = _gif_blocks(data, pos, name)
    idx = np.zeros(w * h, np.uint8)
    src = _u8(lzw)
    got = _lib().tl_gif_lzw(src.ctypes.data, src.size, min_size, idx.ctypes.data, idx.size)
    if got < 0:
        _fail("GIF", name, "LZW code past the table")
    if got < idx.size:
        _fail("GIF", name, "image data ends early (truncated)")
    idx = idx.reshape(h, w)
    if lflags & 0x40:  # interlaced rows: every 8th from 0, every 8th from 4, every 4th from 2, every 2nd from 1
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    lut = np.zeros((256, 3), np.uint8)
    if table is None:  # cv2's default table: the index as gray, but entry 1 white
        lut[:] = np.arange(256, dtype=np.uint8)[:, None]
        lut[1] = 255
    else:
        lut[:len(table)] = table[:256]
    alpha = transparent is not None and not color
    out = np.zeros((sh, sw, 4 if alpha else 3), np.uint8)
    out[..., :3] = lut[bg][::-1]
    frame = np.concatenate([lut[idx][..., ::-1], np.full((h, w, 1), 255, np.uint8)], -1)
    if transparent is not None:
        keep = idx != transparent
        region = out[top:top + h, left:left + w]
        region[keep] = frame[keep][:, :out.shape[-1]]
    else:
        out[top:top + h, left:left + w] = frame[..., :out.shape[-1]]
    return out


def _gif_blocks(data: bytes, pos: int, name: str) -> tuple[bytes, int]:
    """Sub-blocks from pos up to the zero-length terminator: (payload, end)."""
    parts = []
    while True:
        n = _need(data, pos, 1, "GIF", name)[0]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(_need(data, pos, n, "GIF", name))
        pos += n


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

# each container by the signature its cv2 decoder checks, and its decoder
DECODERS = {
    "BMP": (lambda d: d[:2] == b"BM", _bmp),
    "PNM": (lambda d: len(d) > 2 and d[:1] == b"P" and d[1] in b"123456" and _isspace(d[2]), _pnm),
    "PAM": (lambda d: len(d) > 2 and d[:2] == b"P7" and _isspace(d[2]), _pam),
    "PFM": (lambda d: len(d) > 2 and d[:2] in (b"PF", b"Pf") and _isspace(d[2]), _pfm),
    "TIFF": (lambda d: d[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"), _tiff),
    "Sun raster": (lambda d: d[:4] == b"\x59\xa6\x6a\x95", _sun),
    "Radiance HDR": (lambda d: d[:10] == b"#?RADIANCE" or d[:6] == b"#?RGBE", _hdr),
    "GIF": (lambda d: d[:6] in (b"GIF87a", b"GIF89a"), _gif),
}


def sniff(data: bytes) -> str | None:
    """The container whose signature ``data`` starts with, or None."""
    for fmt, (test, _) in DECODERS.items():
        if test(data):
            return fmt
    return None


def decode(fmt: str, data: bytes, name: str, color: bool, file: bool = False) -> np.ndarray:
    """``cv2.imdecode(data, IMREAD_COLOR if color else IMREAD_UNCHANGED)``
    of a ``fmt`` container (a key of ``DECODERS``), in cv2's channel order,
    or ``cv2.imread`` of the file the bytes came from with ``file``;
    ``ValueError`` naming ``name`` where cv2 returns None."""
    return DECODERS[fmt][1](data, name, color, file)
