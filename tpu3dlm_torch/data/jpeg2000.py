"""JPEG 2000 as cv2 5.0 reads it (``data/codecs.py`` tells it apart and
calls ``decode``): the JP2 boxes and cv2's conversion here, the codestream in
``csrc/host/jpeg2000.cpp`` (OpenJPEG 2.5's decode: tier 2, EBCOT with the MQ
coder, the 5/3 and 9/7 wavelets, RCT/ICT).

cv2 reads a file as JPEG 2000 when it starts with the JP2 signature box or
with a raw codestream's SOC and SIZ markers (``sniff``). Then, as
OpenJPEG's ``opj_read_header`` and ``opj_decode`` and cv2's decoder do:

- A JP2 file's boxes are read up to ``jp2c`` (``_boxes``: the signature and
  ``ftyp`` boxes first; ``jp2h`` with ``ihdr``, ``colr``, ``bpcc``,
  ``pclr``, ``cmap`` and ``cdef``, its other sub-boxes such as ``res``
  skipped; unknown boxes skipped); the codestream runs from ``jp2c``'s
  contents to the end of the data, whatever the box's length.
- cv2 refuses a header with more than 4 components, a signed component or a
  precision under 8 bits. IMREAD_UNCHANGED asks for as many channels as the
  codestream has components (2 is refused), CV_8U at 8 bits and CV_16U up to
  16 (deeper ones are refused); IMREAD_COLOR for 3 channels of CV_8U. Every
  sample is shifted right by the largest precision less the output's 8 or
  16 bits and cast (keeping its low bits).
- After the decode, the JP2 palette (``pclr`` with ``cmap``) and channel
  definitions (``cdef``) are applied as OpenJPEG applies them, then cv2
  converts by the colour space of ``colr``: sRGB, and an unknown or absent
  one taken as sRGB (components 2, 1, 0 as BGR, 3 as alpha; one or two
  components cannot make BGR; three make gray through ``BGR2GRAY``);
  greyscale (component 0 in every channel); sYCC (``YUV2BGR`` of components
  0-2). CMYK, e-sYCC and the rest are refused, as are subsampled components
  and an image offset.

Where cv2 returns None ``decode`` raises ``ValueError`` naming the file.
``imread`` and ``imdecode`` read JPEG 2000 alike, so there is one form.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from tpu3dlm_torch.data import containers
from tpu3dlm_torch.kernels.build import load_host_library

_ERRLEN = 256
_JP2_SIG = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
_J2K_SIG = b"\xffO\xffQ"
_SRGB, _GRAY, _SYCC = 16, 17, 18
_REFUSED_SPACES = {12: "CMYK", 24: "e-YCC"}


def _lib() -> ctypes.CDLL:
    lib = load_host_library("jpeg2000")
    if not getattr(lib, "_typed", False):
        p, i, sz, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t, ctypes.c_uint32
        lib.tl_j2k_header.argtypes = [p, sz, u32, u32, p, i, ctypes.c_char_p, i]
        lib.tl_j2k_decode.argtypes = [p, sz, u32, u32, p, ctypes.c_char_p, i]
        lib.tl_j2k_header.restype = lib.tl_j2k_decode.restype = i
        lib._typed = True
    return lib


def sniff(data: bytes) -> bool:
    """cv2's two JPEG 2000 signatures: the JP2 signature box, or SOC + SIZ."""
    return data[:12] == _JP2_SIG or data[:4] == _J2K_SIG


def _fail(name: str, why: str):
    raise ValueError(f"undecodable JPEG 2000 {name}: {why} (cv2 returns None)")


def _not_ported(name: str, feature: str):
    raise ValueError(f"unsupported image {name}: JPEG 2000 {feature} is not yet ported (cv2 decodes it)")


def _be(d: bytes, o: int, n: int) -> int:
    return int.from_bytes(d[o:o + n], "big")


# ---------------------------------------------------------------------------
# JP2 boxes (OpenJPEG's jp2.c)
# ---------------------------------------------------------------------------


def _jp2h(jp: dict, d: bytes, name: str) -> None:
    """The sub-boxes of ``jp2h`` (opj_jp2_read_jp2h)."""
    pos, has_ihdr = 0, False
    while pos < len(d):
        if len(d) - pos < 8:
            _fail(name, "jp2h sub-box shorter than 8 bytes")
        length, btype, hdr = _be(d, pos, 4), d[pos + 4:pos + 8], 8
        if length == 1:
            if len(d) - pos < 16:
                _fail(name, "XL box of less than 16 bytes")
            if _be(d, pos + 8, 4):
                _fail(name, "box size above 2^32")
            length, hdr = _be(d, pos + 12, 4), 16
        if length == 0:
            _fail(name, "box of undefined size in jp2h")
        if length < hdr or length > len(d) - pos:
            _fail(name, "box length is inconsistent in jp2h")
        body = d[pos + hdr:pos + length]
        handler = _IMG_BOXES.get(btype)
        if handler:
            handler(jp, body, name)
        has_ihdr |= btype == b"ihdr"
        pos += length
    if not has_ihdr:
        _fail(name, "no ihdr box in jp2h")
    jp["jp2h"] = True


def _ihdr(jp: dict, b: bytes, name: str) -> None:
    if "ihdr" in jp:
        return  # OpenJPEG keeps the first
    if len(b) != 14:
        _fail(name, "bad image header box size")
    h, w, nc, bpc = struct.unpack(">IIHB", b[:11])
    if not 1 <= nc <= 16384:
        _fail(name, "invalid number of components in ihdr")
    jp["ihdr"] = (w, h, nc, bpc)


def _colr(jp: dict, b: bytes, name: str) -> None:
    if len(b) < 3:
        _fail(name, "bad colr box size")
    if jp.get("has_colr"):
        return  # a reader ignores every colr box after the first
    meth = b[0]
    if meth == 1:
        if len(b) < 7:
            _fail(name, "bad colr box size")
        jp["enumcs"] = _be(b, 3, 4)
        jp["has_colr"] = True
    elif meth == 2:
        jp["has_colr"] = True  # an ICC profile: the colour space stays unknown


def _bpcc(jp: dict, b: bytes, name: str) -> None:
    if len(b) != jp.get("ihdr", (0, 0, 0, 0))[2]:
        _fail(name, "bad bpcc box size")


def _pclr(jp: dict, b: bytes, name: str) -> None:
    if "pclr" in jp or len(b) < 3:
        _fail(name, "second or short pclr box")
    entries, channels = _be(b, 0, 2), b[2]
    if not 1 <= entries <= 1024:
        _fail(name, f"pclr box with {entries} entries")
    if channels == 0 or len(b) < 3 + channels:
        _fail(name, "pclr box with no palette columns")
    sizes = [(v & 0x7F) + 1 for v in b[3:3 + channels]]  # bit 7, the sign, cv2 never looks at
    table, pos = np.zeros((entries, channels), np.int32), 3 + channels
    for j in range(entries):
        for i in range(channels):
            n = min((sizes[i] + 7) >> 3, 4)
            if len(b) < pos + n:
                _fail(name, "pclr box ends inside its palette")
            v = _be(b, pos, n)
            table[j, i] = v - (1 << 32) if v >= 1 << 31 else v  # OPJ_UINT32 read into an OPJ_INT32
            pos += n
    jp["pclr"] = {"table": table, "sizes": sizes, "cmap": None}


def _cmap(jp: dict, b: bytes, name: str) -> None:
    pclr = jp.get("pclr")
    if pclr is None:
        _fail(name, "cmap box before pclr")
    if pclr["cmap"] is not None:
        _fail(name, "only one cmap box is allowed")
    n = len(pclr["sizes"])
    if len(b) < 4 * n:
        _fail(name, "insufficient data for cmap box")
    pclr["cmap"] = [[_be(b, 4 * i, 2), b[4 * i + 2], b[4 * i + 3]] for i in range(n)]


def _cdef(jp: dict, b: bytes, name: str) -> None:
    if "cdef" in jp or len(b) < 2:
        _fail(name, "second or short cdef box")
    n = _be(b, 0, 2)
    if n == 0:
        _fail(name, "no channel description in cdef box")
    if len(b) < 2 + 6 * n:
        _fail(name, "insufficient data for cdef box")
    jp["cdef"] = [list(struct.unpack_from(">HHH", b, 2 + 6 * i)) for i in range(n)]


_IMG_BOXES = {b"ihdr": _ihdr, b"colr": _colr, b"bpcc": _bpcc, b"pclr": _pclr, b"cmap": _cmap, b"cdef": _cdef}


def _boxes(d: bytes, name: str) -> dict:
    """A JP2 file's boxes up to ``jp2c`` (opj_jp2_read_header_procedure):
    the header's fields and ``offset``, where the codestream starts."""
    jp: dict = {"state": 0}
    pos = 0
    while len(d) - pos >= 8:
        length, btype, hdr = _be(d, pos, 4), d[pos + 4:pos + 8], 8
        if length == 0:
            length = len(d) - pos  # the last box
        elif length == 1:
            if len(d) - pos < 16:
                break
            if _be(d, pos + 8, 4):  # OpenJPEG stops reading boxes there: the codestream follows
                jp["offset"] = pos + 16
                break
            length, hdr = _be(d, pos + 12, 4), 16
        if btype == b"jp2c":
            if not jp.get("jp2h"):
                _fail(name, "codestream box before the JP2 header")
            jp["offset"] = pos + hdr
            break
        if length < hdr:
            _fail(name, f"invalid size of box {btype!r}")
        size = length - hdr
        body_at = pos + hdr
        if btype in (b"jP  ", b"ftyp", b"jp2h") or btype in _IMG_BOXES:
            if btype in _IMG_BOXES and not jp.get("jp2h"):  # misplaced, before jp2h: skipped
                if len(d) - body_at < size:
                    _fail(name, "box runs past the data")
                pos = body_at + size
                continue
            if size > len(d) - body_at:
                _fail(name, f"box {btype!r} runs past the data")
            body = d[body_at:body_at + size]
            if btype == b"jP  ":
                if jp["state"] != 0:
                    _fail(name, "the signature box must be the first box")
                if size != 4 or body != b"\r\n\x87\n":
                    _fail(name, "bad JP2 signature box")
                jp["state"] = 1
            elif btype == b"ftyp":
                if jp["state"] != 1:
                    _fail(name, "the ftyp box must be the second box")
                if size < 8 or (size - 8) & 3:
                    _fail(name, "bad ftyp box size")
                jp["state"] = 3
            elif btype == b"jp2h":
                if jp["state"] & 2 != 2:
                    _fail(name, "jp2h box before ftyp")
                _jp2h(jp, body, name)
            else:
                _IMG_BOXES[btype](jp, body, name)
        else:
            if jp["state"] & 1 == 0:
                _fail(name, "first box must be the JPEG 2000 signature box")
            if jp["state"] & 2 == 0:
                _fail(name, "second box must be the file type box")
            if size > len(d) - body_at:
                _fail(name, "box runs past the data")
        pos = body_at + size
    if not jp.get("jp2h"):
        _fail(name, "JP2H box missing")
    if "ihdr" not in jp:
        _fail(name, "IHDR box missing")
    if "offset" not in jp:
        _fail(name, "no codestream box")
    return jp


# ---------------------------------------------------------------------------
# The JP2 colour transforms (opj_jp2_check_color, _apply_pclr, _apply_cdef)
# ---------------------------------------------------------------------------


def _check_color(jp: dict, ncomp: int, name: str) -> None:
    pclr, cdef = jp.get("pclr"), jp.get("cdef")
    if cdef:
        nr = len(pclr["sizes"]) if pclr and pclr["cmap"] is not None else ncomp
        for cn, _typ, asoc in cdef:
            if cn >= nr or (asoc not in (0, 65535) and asoc - 1 >= nr):
                _fail(name, "invalid component index in cdef")
        for want in range(nr):
            if not any(cn == want for cn, _, _ in cdef):
                _fail(name, "incomplete channel definitions")
    if pclr and pclr["cmap"] is not None:
        cmap, nr = pclr["cmap"], len(pclr["sizes"])
        sane, used = True, [False] * nr
        for cmp, _, _ in cmap:
            if cmp >= ncomp:
                sane = False
        for i, (_, mtyp, pcol) in enumerate(cmap):
            if mtyp not in (0, 1) or pcol >= nr or (used[pcol] and mtyp == 1) or (mtyp == 0 and pcol != 0) \
                    or (mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        for i in range(nr):
            if not used[i] and cmap[i][1] != 0:
                sane = False
        if sane and ncomp == 1 and not all(used):  # OpenJPEG's fix of a weird cmap
            for i in range(nr):
                cmap[i][1], cmap[i][2] = 1, i
        if not sane:
            _fail(name, "inconsistent cmap box")


def _apply_pclr(comps: list, pclr: dict) -> list:
    """Each cmap channel: a component used directly, or its samples (clipped
    to the palette) looked up in the palette's column."""
    table, top = pclr["table"], len(pclr["table"]) - 1
    return [comps[cmp].copy() if mtyp == 0 else table[np.clip(comps[cmp], 0, top), i]
            for i, (cmp, mtyp, _pcol) in enumerate(pclr["cmap"])]


def _apply_cdef(comps: list, cdef: list) -> list:
    info = [row[:] for row in cdef]
    comps = list(comps)
    for i, (cn, typ, asoc) in enumerate(info):
        if cn >= len(comps) or asoc in (0, 65535):
            continue
        acn = asoc - 1
        if acn >= len(comps):
            continue
        if cn != acn and typ == 0:
            comps[cn], comps[acn] = comps[acn], comps[cn]
            for row in info[i + 1:]:
                if row[0] == cn:
                    row[0] = acn
                elif row[0] == acn:
                    row[0] = cn
    return comps


# ---------------------------------------------------------------------------
# cv2's conversion (grfmt_jpeg2000_openjpeg.cpp) and its two cvtColor calls
# ---------------------------------------------------------------------------


def _copy(comps: list, dtype, shift: int) -> np.ndarray:
    """cv2's copy of components into a Mat: each sample shifted right, then
    cast to the Mat's depth (its low bits: a palette entry wider than the
    output wraps)."""
    out = np.empty(comps[0].shape + (len(comps),), dtype)
    for k, c in enumerate(comps):
        out[..., k] = c >> shift if shift else c  # numpy's cast keeps the low bits, as C's does
    return out


def _bgr2gray(bgr: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(BGR2GRAY) on CV_8U and CV_16U (15-bit fixed point)."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15).astype(bgr.dtype)[..., None]


def _yuv2bgr(yuv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(YUV2BGR) on CV_8U and CV_16U (14-bit fixed point)."""
    hi = np.iinfo(yuv.dtype).max
    half = (hi + 1) // 2
    y, u, v = (yuv[..., i].astype(np.int64) for i in range(3))
    u, v = u - half, v - half

    def descale(x):
        return (x + 8192) >> 14

    b = y + descale(u * 33292)
    g = y + descale(u * -6472 + v * -9519)
    r = y + descale(v * 18678)
    return np.clip(np.stack([b, g, r], -1), 0, hi).astype(yuv.dtype)


def _to_mat(comps: list, space: int, channels: int, dtype, shift: int, name: str) -> np.ndarray:
    n = len(comps)
    if space == _GRAY:
        if channels in (1, 3):
            return _copy([comps[0]] * channels, dtype, shift)
    elif space == _SYCC:
        if channels == 1:
            return _copy([comps[0]], dtype, shift)
        if channels == 3 and n >= 3:
            return _yuv2bgr(_copy(comps[:3], dtype, shift))
    else:  # sRGB, or unknown taken as sRGB
        if channels == 1:
            if n <= 2:
                return _copy([comps[0]], dtype, shift)
            return _bgr2gray(_copy([comps[2], comps[1], comps[0]], dtype, shift))
        if channels == 3 and n >= 3:
            return _copy([comps[2], comps[1], comps[0]], dtype, shift)
        if channels == 4 and n >= 4:
            return _copy([comps[2], comps[1], comps[0], comps[3]], dtype, shift)
    _fail(name, f"cv2 cannot convert {n} components to {channels} channels in colour space {space}")


def _space(jp: dict | None) -> int:
    """OpenJPEG's colour space from colr's enumerated value (0: unknown)."""
    cs = jp.get("enumcs", 0) if jp else 0
    return cs if cs in (_SRGB, _GRAY, _SYCC, 12, 24) else 0


def decode(data: bytes, name: str, color: bool) -> np.ndarray:
    """``cv2.imdecode(data, IMREAD_COLOR if color else IMREAD_UNCHANGED)``
    of JPEG 2000 data (``imread`` is the same): BGR(A) or gray in uint8 or
    uint16; ``ValueError`` naming ``name`` where cv2 returns None."""
    jp = _boxes(data, name) if data[:12] == _JP2_SIG else None
    cs = data[jp["offset"]:] if jp else data
    ihdr_w, ihdr_h = (jp["ihdr"][0], jp["ihdr"][1]) if jp else (0, 0)
    lib, err = _lib(), ctypes.create_string_buffer(_ERRLEN)
    src = np.frombuffer(cs, np.uint8)
    info = np.zeros(5 + 4 * 4, np.int64)
    rc = lib.tl_j2k_header(src.ctypes.data, src.size, ihdr_w, ihdr_h, info.ctypes.data, 4, err, _ERRLEN)
    if rc == -2:
        _not_ported(name, err.value.decode())
    if rc != 0:
        _fail(name, err.value.decode())
    x0, y0, x1, y1, ncomp = (int(v) for v in info[:5])
    if not 1 <= ncomp <= 4:
        _fail(name, f"{ncomp} components")
    prec, sgnd, dx, dy = (info[5:5 + 4 * ncomp].reshape(ncomp, 4)[:, k].tolist() for k in range(4))
    if any(sgnd):
        _fail(name, "a signed component")
    max_prec = max(prec)
    if max_prec < 8:
        _fail(name, "precision under 8 bits")
    w, h = x1 - x0, y1 - y0
    channels = 3 if color else ncomp
    containers._size("JPEG 2000", name, w, h)  # cv2's validateInputImageSize
    if channels == 2:
        _fail(name, "2 output channels")
    out_prec = 8 if color else (8 if max_prec == 8 else 16 if max_prec <= 16 else 0)
    if out_prec == 0:
        _fail(name, f"{max_prec}-bit components under IMREAD_UNCHANGED")
    if x0 or y0 or any(v != 1 for v in dx + dy):
        _fail(name, "an image offset or subsampled components")
    space = _space(jp)
    if space in _REFUSED_SPACES:
        _fail(name, f"colour space {_REFUSED_SPACES[space]}")
    planes = np.zeros((ncomp, h, w), np.int32)
    rc = lib.tl_j2k_decode(src.ctypes.data, src.size, ihdr_w, ihdr_h, planes.ctypes.data, err, _ERRLEN)
    if rc == -2:
        _not_ported(name, err.value.decode())
    if rc != 0:
        _fail(name, err.value.decode())
    comps = list(planes)
    if jp:
        _check_color(jp, ncomp, name)
        if jp.get("pclr") and jp["pclr"]["cmap"] is not None:
            comps = _apply_pclr(comps, jp["pclr"])
        if jp.get("cdef"):
            comps = _apply_cdef(comps, jp["cdef"])
    dtype = np.uint8 if out_prec == 8 else np.uint16
    shift = max(0, max_prec - out_prec)
    img = _to_mat(comps, space, channels, dtype, shift, name)
    return img[..., 0] if channels == 1 else img
