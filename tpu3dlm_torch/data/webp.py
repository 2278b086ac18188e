"""WebP as cv2 5.0 reads it (``data/codecs.py`` tells it apart and calls
``decode``): the RIFF container here, the two bitstreams in
``csrc/host/webp.cpp``.

cv2's WebP decoder takes a file when libwebp's ``WebPGetFeatures`` accepts
its first 32 bytes (``sniff``): a ``RIFF....WEBP`` file, and also a bare
``VP8 ``/``VP8L`` chunk or a raw VP8L bitstream, as libwebp does. Those 32
bytes decide the channels: 4 (BGRA) where VP8X's alpha flag is set or, in a
simple lossless file, VP8L's alpha hint; else 3. Then:

- A still image goes through libwebp's simple decoding API on the whole
  data (``WebPDecodeBGRInto``/``BGRAInto``, default options): RIFF and chunk
  sizes checked as libwebp checks them (a RIFF size past the data fails,
  trailing bytes do not), optional chunks skipped up to the first ``VP8 ``
  or ``VP8L`` (odd sizes padded), the last ``ALPH`` before a ``VP8 `` frame
  decoded whatever the channels (corrupt alpha fails the image), the frame
  decoded from its chunk to the end of the data.
- An animation (VP8X's animation flag) goes through ``WebPAnimDecoder``:
  the whole file demuxed (``_demux``, libwebp's demux.c rules), the first
  frame decoded into a transparent black canvas at its offset (a first frame
  is a key frame: the background colour and the blend and dispose bits do
  not touch it).
- Under IMREAD_COLOR the alpha is dropped (not blended), and an EXIF
  orientation is applied where the file demuxes, VP8X's EXIF flag is set and
  the first ``EXIF`` chunk holds a TIFF header with one; IMREAD_UNCHANGED
  applies none.

Where cv2 returns None (a cut file, a bad chunk size, an invalid bitstream,
a file under 32 bytes) ``decode`` raises ``ValueError`` naming the file.
``imread`` and ``imdecode`` read WebP alike, so there is one form.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from tpu3dlm_torch.data import containers
from tpu3dlm_torch.kernels.build import load_host_library

_ERRLEN = 256
_HEADER = 32  # cv2's WEBP_HEADER_SIZE
_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
_ALPHA_FLAG, _ANIMATION_FLAG, _EXIF_FLAG, _XMP_FLAG, _ICCP_FLAG = 0x10, 0x02, 0x08, 0x04, 0x20
_ALL_VALID_FLAGS = _ALPHA_FLAG | _ANIMATION_FLAG | _EXIF_FLAG | _XMP_FLAG | _ICCP_FLAG
# libwebp's VP8StatusCode values that matter here, and demux.c's ParseStatus
_OK, _ERROR, _NOT_ENOUGH, _UNSUPPORTED = 0, 3, 7, 4
_PARSE_OK, _PARSE_MORE, _PARSE_ERROR = 0, 1, 2


def _lib() -> ctypes.CDLL:
    lib = load_host_library("webp")
    if not getattr(lib, "_typed", False):
        p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.tl_webp_vp8l.argtypes = [p, sz, i, i, i, p, i, ctypes.c_char_p, i]
        lib.tl_webp_vp8.argtypes = [p, sz, p, sz, i, i, i, p, i, ctypes.c_char_p, i]
        lib.tl_webp_vp8l.restype = lib.tl_webp_vp8.restype = i
        lib._typed = True
    return lib


def _le16(d: bytes, o: int) -> int:
    return d[o] | (d[o + 1] << 8)


def _le24(d: bytes, o: int) -> int:
    return d[o] | (d[o + 1] << 8) | (d[o + 2] << 16)


def _le32(d: bytes, o: int) -> int:
    return struct.unpack_from("<I", d, o)[0]


def _vp8_info(d: bytes, pos: int, size: int, chunk_size: int):
    """libwebp's VP8GetInfo: (width, height) of a key frame, or None."""
    if size < 10 or d[pos + 3:pos + 6] != b"\x9d\x01\x2a":
        return None
    bits = _le24(d, pos)
    w, h = _le16(d, pos + 6) & 0x3FFF, _le16(d, pos + 8) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size or not w or not h:
        return None
    return w, h


def _vp8l_check(d: bytes, pos: int, size: int) -> bool:
    return size >= 5 and d[pos] == 0x2F and (d[pos + 4] >> 5) == 0


def _vp8l_info(d: bytes, pos: int, size: int):
    """libwebp's VP8LGetInfo: (width, height, alpha hint), or None."""
    if not _vp8l_check(d, pos, size):
        return None
    bits = _le32(d, pos + 1)
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


def _optional_chunks(d: bytes, pos: int, size: int, riff_size: int):
    """libwebp's ParseOptionalChunks: skip chunks up to VP8/VP8L, keeping
    the last ALPH; (status, pos, size, (alpha offset, alpha size) or None)."""
    total = 4 + 8 + 10
    alpha = None
    while True:
        if size < 8:
            return _NOT_ENOUGH, pos, size, alpha
        chunk_size = _le32(d, pos + 4)
        if chunk_size > _MAX_CHUNK_PAYLOAD:
            return _ERROR, pos, size, alpha
        disk = (8 + chunk_size + 1) & ~1
        total += disk
        if riff_size > 0 and total > riff_size:
            return _ERROR, pos, size, alpha
        if d[pos:pos + 4] in (b"VP8 ", b"VP8L"):
            return _OK, pos, size, alpha
        if size < disk:
            return _NOT_ENOUGH, pos, size, alpha
        if d[pos:pos + 4] == b"ALPH":
            alpha = (pos + 8, chunk_size)
        pos += disk
        size -= disk


def _parse(d: bytes, headers: bool) -> tuple[int, dict]:
    """libwebp's ParseHeadersInternal over all of ``d``: ``headers`` as
    WebPParseHeaders asks (all data present; the frame's offset), else as
    WebPGetFeatures (size, alpha, animation, possibly from a prefix)."""
    info = {"width": 0, "height": 0, "alpha": False, "animation": False, "lossless": False, "offset": 0,
            "alpha_chunk": None}
    n = len(d)
    if n < 12:
        return _NOT_ENOUGH, info
    pos, size, riff_size = 0, n, 0
    if d[:4] == b"RIFF":
        if d[8:12] != b"WEBP":
            return _ERROR, info
        riff_size = _le32(d, 4)
        if riff_size < 12 or riff_size > _MAX_CHUNK_PAYLOAD:
            return _ERROR, info
        if headers and riff_size > n - 8:
            return _NOT_ENOUGH, info
        pos, size = 12, n - 12
    found_riff = riff_size > 0
    if size < 8:
        return _NOT_ENOUGH, info
    found_vp8x, flags, cw, ch = False, 0, 0, 0
    if d[pos:pos + 4] == b"VP8X":
        if _le32(d, pos + 4) != 10:
            return _ERROR, info
        if size < 18:
            return _NOT_ENOUGH, info
        flags = _le32(d, pos + 8)
        cw, ch = 1 + _le24(d, pos + 12), 1 + _le24(d, pos + 15)
        if cw * ch >= _MAX_IMAGE_AREA:
            return _ERROR, info
        pos, size, found_vp8x = pos + 18, size - 18, True
    if not found_riff and found_vp8x:
        return _ERROR, info
    info.update(alpha=bool(flags & _ALPHA_FLAG), animation=bool(flags & _ANIMATION_FLAG))
    width, height = cw, ch
    status = _OK
    if found_vp8x and info["animation"] and not headers:
        pass
    elif size < 4:
        status = _NOT_ENOUGH
    else:
        if (found_riff and found_vp8x) or (not found_riff and not found_vp8x and d[pos:pos + 4] == b"ALPH"):
            status, pos, size, info["alpha_chunk"] = _optional_chunks(d, pos, size, riff_size)
        if status == _OK:  # ParseVP8Header
            if size < 8:
                status = _NOT_ENOUGH
            elif d[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                csize = _le32(d, pos + 4)
                if riff_size >= 12 and csize > riff_size - 12:
                    return _ERROR, info
                if headers and csize > size - 8:
                    status = _NOT_ENOUGH
                else:
                    info["lossless"] = d[pos:pos + 4] == b"VP8L"
                    pos, size = pos + 8, size - 8
            else:
                info["lossless"] = _vp8l_check(d, pos, size)
                csize = size
        if status == _OK:
            if csize > _MAX_CHUNK_PAYLOAD:
                return _ERROR, info
            if not info["lossless"]:
                if size < 10:
                    status = _NOT_ENOUGH
                else:
                    wh = _vp8_info(d, pos, size, csize)
                    if wh is None:
                        return _ERROR, info
                    width, height = wh
            elif size < 5:
                status = _NOT_ENOUGH
            else:
                whA = _vp8l_info(d, pos, size)
                if whA is None:
                    return _ERROR, info
                width, height, info["alpha"] = whA[0], whA[1], bool(whA[2])
            if status == _OK:
                if found_vp8x and (cw, ch) != (width, height):
                    return _ERROR, info
                info["offset"] = pos
    if status == _OK or (status == _NOT_ENOUGH and found_vp8x and not headers):
        info["alpha"] = info["alpha"] or info["alpha_chunk"] is not None
        info["width"], info["height"] = width, height
        return _OK, info
    return status, info


def sniff(data: bytes) -> bool:
    """cv2's WebPDecoder::checkSignature: WebPGetFeatures accepts the first
    32 bytes."""
    return len(data) >= _HEADER and _parse(data[:_HEADER], False)[0] == _OK


# ---------------------------------------------------------------------------
# demux.c: the whole file's chunk structure, for animations and EXIF
# ---------------------------------------------------------------------------


class _Demux:
    def __init__(self, d: bytes):
        self.d, self.start, self.end, self.riff_end = d, 0, len(d), 0
        self.state = 0  # 0 parsing header, 1 parsed header, 2 done
        self.flags, self.canvas, self.loop_count = 0, (-1, -1), 1
        self.frames: list[dict] = []
        self.chunks: list[tuple[bytes, int, int]] = []  # (fourcc, payload offset, payload size)
        self.is_ext, self.num_frames = False, 0

    def avail(self) -> int:
        return self.end - self.start

    def invalid(self, n: int) -> bool:
        return n > self.riff_end - self.start

    def store_frame(self, frame_num: int, min_size: int, frame: dict) -> int:
        alpha_chunks = image_chunks = 0
        if self.avail() < 8 or self.avail() < min_size:
            return _PARSE_MORE
        status, done = _PARSE_OK, False
        while not done and status == _PARSE_OK:
            chunk_start = self.start
            fourcc, payload = self.d[self.start:self.start + 4], _le32(self.d, self.start + 4)
            self.start += 8
            if payload > _MAX_CHUNK_PAYLOAD:
                return _PARSE_ERROR
            padded = payload + (payload & 1)
            available = min(padded, self.avail())
            chunk_size = 8 + available
            if self.invalid(padded):
                return _PARSE_ERROR
            if padded > self.avail():
                status = _PARSE_MORE
            if fourcc == b"VP8L" and alpha_chunks > 0:
                return _PARSE_ERROR  # VP8L carries its own alpha
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks += 1
                frame.update(alpha=(chunk_start, chunk_size), frame_num=frame_num)
                self.start += available
            elif fourcc in (b"VP8L", b"VP8 ") and image_chunks == 0:
                st, feat = _parse(self.d[chunk_start:chunk_start + chunk_size], False)
                if status == _PARSE_MORE and st == _NOT_ENOUGH:
                    return _PARSE_MORE
                if st != _OK:
                    return _PARSE_ERROR
                image_chunks += 1
                frame.update(image=(chunk_start, chunk_size), width=feat["width"], height=feat["height"],
                             frame_num=frame_num, complete=status == _PARSE_OK)
                self.start += available
            else:  # a chunk of the next level: step back and stop
                self.start -= 8
                done = True
            if self.start == self.riff_end:
                done = True
            elif self.avail() < 8:
                status = _PARSE_MORE
        return status

    def single_image(self) -> int:
        if self.frames or self.invalid(8):
            return _PARSE_ERROR
        if self.avail() < 8:
            return _PARSE_MORE
        frame: dict = {}
        status = self.store_frame(1, 0, frame)
        if status != _PARSE_ERROR:
            if not self.flags & _ALPHA_FLAG:
                frame["alpha"] = None  # demux.c drops an ALPH chunk the flags do not announce
            if not self.is_ext and frame.get("width", 0) > 0 and frame.get("height", 0) > 0:
                self.state = 1
                self.canvas = (frame["width"], frame["height"])
            self.frames.append(frame)
            self.num_frames = 1
        return status

    def animation_frame(self, chunk_padded: int) -> int:
        is_anim = bool(self.flags & _ANIMATION_FLAG)
        if self.invalid(16) or chunk_padded < 16:
            return _PARSE_ERROR
        if self.avail() < 16:
            return _PARSE_MORE
        d, s = self.d, self.start
        frame = {"x": 2 * _le24(d, s), "y": 2 * _le24(d, s + 3), "width": 1 + _le24(d, s + 6),
                 "height": 1 + _le24(d, s + 9)}  # then duration and the blend/dispose bits: a first frame ignores them
        self.start += 16
        if frame["width"] * frame["height"] >= _MAX_IMAGE_AREA:
            return _PARSE_ERROR
        start = self.start
        status = self.store_frame(self.num_frames + 1, chunk_padded - 16, frame)
        if status != _PARSE_ERROR and self.start - start > chunk_padded - 16:
            status = _PARSE_ERROR
        if status != _PARSE_ERROR and is_anim and frame.get("frame_num", 0) > 0:
            self.frames.append(frame)
            self.num_frames += 1
        return status

    def vp8x(self) -> int:
        if self.avail() < 8:
            return _PARSE_MORE
        self.is_ext = True
        self.start += 4
        size = _le32(self.d, self.start)
        self.start += 4
        if size > _MAX_CHUNK_PAYLOAD or size < 10:
            return _PARSE_ERROR
        size += size & 1
        if self.invalid(size):
            return _PARSE_ERROR
        if self.avail() < size:
            return _PARSE_MORE
        d, s = self.d, self.start
        self.flags = d[s]
        self.canvas = (1 + _le24(d, s + 4), 1 + _le24(d, s + 7))
        if self.canvas[0] * self.canvas[1] >= _MAX_IMAGE_AREA:
            return _PARSE_ERROR
        self.start += size
        self.state = 1
        if self.invalid(8):
            return _PARSE_ERROR
        if self.avail() < 8:
            return _PARSE_MORE
        return self.vp8x_chunks()

    def vp8x_chunks(self) -> int:
        is_anim = bool(self.flags & _ANIMATION_FLAG)
        anim_chunks, status = 0, _PARSE_OK
        while status == _PARSE_OK:
            chunk_start = self.start
            fourcc, size = self.d[self.start:self.start + 4], _le32(self.d, self.start + 4)
            self.start += 8
            if size > _MAX_CHUNK_PAYLOAD:
                return _PARSE_ERROR
            padded = size + (size & 1)
            if self.invalid(padded):
                return _PARSE_ERROR
            store, skip = True, False
            if fourcc == b"VP8X":
                return _PARSE_ERROR
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or is_anim:
                    return _PARSE_ERROR
                self.start -= 8
                status = self.single_image()
            elif fourcc == b"ANIM":
                if padded < 6:
                    return _PARSE_ERROR
                if self.avail() < padded:
                    status = _PARSE_MORE
                elif anim_chunks == 0:
                    anim_chunks += 1
                    self.loop_count = _le16(self.d, self.start + 4)  # after the background colour
                    self.start += padded
                else:
                    store, skip = False, True
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    return _PARSE_ERROR
                status = self.animation_frame(padded)
            else:
                skip = True
                flag = {b"ICCP": _ICCP_FLAG, b"EXIF": _EXIF_FLAG, b"XMP ": _XMP_FLAG}.get(fourcc)
                if flag is not None:
                    store = bool(self.flags & flag)
            if skip:
                if padded <= self.avail():
                    if store:
                        self.chunks.append((fourcc, chunk_start + 8, size))
                    self.start += padded
                else:
                    status = _PARSE_MORE
            if self.start == self.riff_end:
                break
            if self.avail() < 8:
                status = _PARSE_MORE
        return status

    def valid_simple(self) -> bool:
        if self.state == 0:
            return True
        if self.canvas[0] <= 0 or self.canvas[1] <= 0:
            return False
        if self.state == 2 and not self.frames:
            return False
        f = self.frames[0]
        return f.get("width", 0) > 0 and f.get("height", 0) > 0

    def valid_extended(self) -> bool:
        is_anim = bool(self.flags & _ANIMATION_FLAG)
        if self.state == 0:
            return True
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or self.loop_count < 0:
            return False
        if self.state == 2 and not self.frames:
            return False
        if self.flags & ~_ALL_VALID_FLAGS:
            return False
        for k, f in enumerate(self.frames):
            image, alpha = f.get("image"), f.get("alpha")
            if not is_anim and f.get("frame_num", 0) > 1:
                return False
            if f.get("complete"):
                if not alpha and not image:
                    return False
                if alpha and image and alpha[0] > image[0]:
                    return False
                if f.get("width", 0) <= 0 or f.get("height", 0) <= 0:
                    return False
            else:
                if self.state == 2:
                    return False
                if alpha and image and alpha[0] > image[0]:
                    return False
                if k + 1 < len(self.frames):
                    return False
            w, h = f.get("width", 0), f.get("height", 0)
            if w > 0 and h > 0:
                x, y = f.get("x", 0), f.get("y", 0)
                if not is_anim:
                    if x or y or (w, h) != self.canvas:
                        return False
                elif x + w > self.canvas[0] or y + h > self.canvas[1]:
                    return False
        return True


def _demux(d: bytes) -> _Demux | None:
    """libwebp's WebPDemux (all data present) of a RIFF file, or None where
    it fails. Raw bitstreams are not demuxed here: they hold no chunks."""
    if len(d) < 20 or d[:4] != b"RIFF" or d[8:12] != b"WEBP":
        return None
    m = _Demux(d)
    riff_size = _le32(d, 4)
    if riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
        return None
    m.riff_end = riff_size + 8
    if m.end > m.riff_end:
        m.end = m.riff_end
    m.start = 12
    if m.end < m.riff_end:  # partial data
        return None
    tag = d[12:16]
    if tag in (b"VP8 ", b"VP8L"):
        status, valid = m.single_image(), m.valid_simple
    elif tag == b"VP8X":
        status, valid = m.vp8x(), m.valid_extended
    else:
        return None
    if status == _PARSE_OK:
        m.state = 2
    if status == _PARSE_MORE:
        status = _PARSE_ERROR
    if status != _PARSE_ERROR and not valid():
        status = _PARSE_ERROR
    return None if status == _PARSE_ERROR else m


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _fail(name: str, why: str):
    raise ValueError(f"undecodable WebP {name}: {why} (cv2 returns None)")


def _headers(d: bytes, name: str) -> dict:
    """libwebp's WebPParseHeaders over all of ``d``, as DecodeInto runs it."""
    status, info = _parse(d, True)
    if status == _OK and info["animation"]:
        status = _UNSUPPORTED
    if status != _OK:
        _fail(name, {_NOT_ENOUGH: "data ends early", _UNSUPPORTED: "animation in a still decode"}.get(
            status, "bad RIFF or chunk header"))
    return info


def _decode_into(d: bytes, info: dict, out: np.ndarray, name: str) -> None:
    """libwebp's DecodeInto after the headers (``info``): the VP8 or VP8L
    decoder on the rest of the data, into ``out``, an (H, W, 3|4) uint8 view
    of the frame's size whose rows may be strided."""
    h, w, cn = out.shape
    src = np.frombuffer(d, np.uint8)[info["offset"]:]
    err = ctypes.create_string_buffer(_ERRLEN)
    lib, stride = _lib(), out.strides[0]
    if info["lossless"]:
        rc = lib.tl_webp_vp8l(src.ctypes.data, src.size, w, h, cn, out.ctypes.data, stride, err, _ERRLEN)
    else:
        alpha = info["alpha_chunk"]
        a = np.frombuffer(d, np.uint8)[alpha[0]:alpha[0] + alpha[1]] if alpha else None
        rc = lib.tl_webp_vp8(src.ctypes.data, src.size, None if a is None else a.ctypes.data,
                             0 if a is None else a.size, w, h, cn, out.ctypes.data, stride, err, _ERRLEN)
    if rc != 0:
        _fail(name, err.value.decode())


def _first_frame(d: bytes, width: int, height: int, name: str) -> np.ndarray:
    """WebPAnimDecoderGetNext's first frame: BGRA canvas of zeros with the
    first frame decoded at its offset."""
    m = _demux(d)
    if m is None or not m.frames:
        _fail(name, "animation does not demux")
    if m.canvas != (width, height):
        _fail(name, "canvas differs from the header's")
    f = m.frames[0]
    image, alpha = f["image"], f.get("alpha")
    start = alpha[0] if alpha else image[0]
    fragment = d[start:image[0] + image[1]]
    info = _headers(fragment, name)
    canvas = np.zeros((height, width, 4), np.uint8)
    x, y = f["x"], f["y"]
    _decode_into(fragment, info, canvas[y:y + info["height"], x:x + info["width"]], name)
    return canvas


def decode(data: bytes, name: str, color: bool) -> np.ndarray:
    """``cv2.imdecode(data, IMREAD_COLOR if color else IMREAD_UNCHANGED)``
    of WebP data (``imread`` is the same): (H, W, 3) BGR or, unchanged and
    with alpha, (H, W, 4) BGRA uint8; ``ValueError`` naming ``name`` where
    cv2 returns None."""
    if len(data) < _HEADER:
        _fail(name, "shorter than 32 bytes")
    status, feat = _parse(data[:_HEADER], False)
    if status != _OK:
        _fail(name, "no WebP header")
    w, h = feat["width"], feat["height"]
    containers._size("WebP", name, w, h)  # cv2's validateInputImageSize
    cn = 4 if feat["alpha"] else 3
    if feat["animation"]:
        img = _first_frame(data, w, h, name)[..., :cn]
    else:
        info = _headers(data, name)
        img = np.empty((h, w, cn), np.uint8)
        _decode_into(data, info, img, name)
    if not color:
        return np.ascontiguousarray(img)
    img = img[..., :3]
    m = _demux(data)
    if m is not None and m.flags & _EXIF_FLAG:
        exif = next(((o, n) for c, o, n in m.chunks if c == b"EXIF"), None)
        if exif:
            from tpu3dlm_torch.data import codecs

            e = np.frombuffer(data, np.uint8)[exif[0]:exif[0] + exif[1]]
            return containers.orient(img, codecs._lib().tl_exif_orientation(e.ctypes.data, e.size))
    return np.ascontiguousarray(img)
