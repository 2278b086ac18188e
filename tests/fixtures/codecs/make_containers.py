"""Writers for the container fixtures of ``tests/fixtures/codecs/containers``
and the encoders the tests build cases with.

- ``lossless_jpeg``: a lossless JPEG (ITU-T T.81 Annex H) written by hand,
  as no library here writes one: Huffman (SOF3) coding with one table
  covering every difference category, predictors 1-7, a point transform,
  restart intervals of whole MCU rows, sampling factors, interleaved or
  one scan per component, precision 2-16; the same frame under another SOF
  marker (SOF11, the hierarchical ones) for cv2's refusals.
- ``bmp`` (and its RLE4/RLE8 encoders and random streams), ``tiff`` (LZW,
  Deflate and PackBits, strips, tiles, planes, both predictors),
  ``sun_raster``, ``hdr`` (flat or run-length RGBE) and ``gif`` (LZW,
  tables, interlace, transparency): the layouts cv2 and PIL do not write.
- ``fixtures()``: every committed container fixture, by name, from these
  writers and from cv2 ``imencode`` and PIL.

Run ``python tests/fixtures/codecs/make_digests.py`` from the repository
root: it writes these fixtures and the digests of cv2's decode.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# Lossless JPEG
# ---------------------------------------------------------------------------

# One Huffman table for the 17 difference categories 0..16: code lengths
# 3 (0-5), 5 (6-9), 6 (10-12), 7 (13-14), 8 (15-16); no code is all ones.
_LL_BITS = [0, 0, 6, 0, 4, 3, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0]
_LL_VALS = list(range(17))


def _huff_codes(bits, vals):
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(body) + 2) + body


def _predict(p: int, ra: int, rb: int, rc: int) -> int:
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
            7: (ra + rb) >> 1}[p]


def _diff_rows(x: np.ndarray, width: int, rows: int, predictor: int, precision: int, pt: int,
               first_rows: set) -> np.ndarray:
    """Differences of one component's (rows, width) reduced samples as the
    decoder undifferences them (jdpred.c): the first row of the image and of
    each restart interval by the row's first sample and then Ra, the other
    rows' first sample by Rb."""
    d = np.zeros_like(x, dtype=np.int64)
    for r in range(rows):
        row = x[r].astype(np.int64)
        if r in first_rows:
            pred = np.empty(width, np.int64)
            pred[0] = 1 << (precision - pt - 1)
            pred[1:] = row[:-1]
        else:
            prev = x[r - 1].astype(np.int64)
            pred = np.empty(width, np.int64)
            pred[0] = prev[0]
            ra, rb, rc = row[:-1], prev[1:], prev[:-1]
            pred[1:] = _predict(predictor, ra, rb, rc)
        d[r] = (row - pred) & 0xFFFF
    return d


def lossless_jpeg(samples: np.ndarray, predictor: int = 1, pt: int = 0, precision: int = 8,
                  restart_rows: int = 0, sampling=None, interleaved: bool = True, marker: int = 0xC3,
                  jfif: bool = False, adobe: int | None = None, ids=None) -> bytes:
    """(H, W) or (H, W, C) integer samples (C = 1, 3 or 4) → a lossless JPEG.
    ``sampling`` is one (h, v) per component, the components' planes taken
    by keeping every (hmax/h, vmax/v)-th sample; ``restart_rows`` puts a
    DRI of that many MCU rows; ``interleaved=False`` writes one scan per
    component. ``marker`` writes the frame under another SOF (0xCB, 0xC5
    ...) with the same scan data."""
    s = samples if samples.ndim == 3 else samples[..., None]
    h, w, nc = s.shape
    sampling = sampling or [(1, 1)] * nc
    hmax = max(a for a, _ in sampling)
    vmax = max(b for _, b in sampling)
    ids = ids or list(range(1, nc + 1))
    codes = _huff_codes(_LL_BITS, _LL_VALS)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    planes = []
    for c, (ch, cv) in enumerate(sampling):
        plane = s[::vmax // cv, ::hmax // ch, c].astype(np.int64) >> pt
        cw, chh = -(-w * ch // hmax), -(-h * cv // vmax)
        planes.append(plane[:chh, :cw])
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    frame = struct.pack(">BHHB", precision, h, w, nc)
    for c in range(nc):
        frame += bytes([ids[c], (sampling[c][0] << 4) | sampling[c][1], 0])
    out += _segment(marker, frame)
    out += _segment(0xC4, bytes([0x00]) + bytes(_LL_BITS) + bytes(_LL_VALS))
    scans = [list(range(nc))] if interleaved and nc > 1 else [[c] for c in range(nc)]
    for comps in scans:
        if len(comps) == 1:
            c = comps[0]
            unit_w, unit_h = planes[c].shape[1], planes[c].shape[0]
            blocks = [(c, 1, 1)]
            cols, rows_of_mcus = unit_w, unit_h
        else:
            blocks = [(c, sampling[c][0], sampling[c][1]) for c in comps]
            cols, rows_of_mcus = mcux, mcuy
        if restart_rows:
            out += _segment(0xDD, struct.pack(">H", restart_rows * cols))
        diffs = {}
        for c, bh, bv in blocks:
            plane = planes[c]
            ph, pw = plane.shape
            pad_h, pad_w = rows_of_mcus * bv, cols * bh
            padded = np.zeros((pad_h, pad_w), np.int64)
            padded[:ph, :pw] = plane
            first = {r * bv for r in range(0, rows_of_mcus, restart_rows or rows_of_mcus)}
            d = np.zeros((pad_h, pad_w), np.int64)
            d[:ph, :pw] = _diff_rows(plane, pw, ph, predictor, precision, pt, first)
            diffs[c] = d
        sos = bytes([len(comps)]) + b"".join(bytes([ids[c], 0x00]) for c in comps) + bytes([predictor, 0, pt])
        out += _segment(0xDA, sos)
        bw = _BitWriter()
        for my in range(rows_of_mcus):
            if restart_rows and my and my % restart_rows == 0:
                bw.flush()
                out += bw.out + bytes([0xFF, 0xD0 + (my // restart_rows - 1) % 8])
                bw = _BitWriter()
            for mx in range(cols):
                for c, bh, bv in blocks:
                    for yy in range(bv):
                        for xx in range(bh):
                            v = int(diffs[c][my * bv + yy, mx * bh + xx])
                            if v > 32768:
                                v -= 65536
                            cat = 0 if v == 0 else min(abs(v).bit_length(), 16)
                            code, length = codes[cat]
                            bw.put(code, length)
                            if 0 < cat < 16:
                                bw.put(v if v > 0 else (v - 1) & ((1 << cat) - 1), cat)
        bw.flush()
        out += bw.out
    return bytes(out + b"\xff\xd9")


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def bmp(pixels: bytes, width: int, height: int, bpp: int, compression: int = 0, palette=None, header: int = 40,
        clrused: int | None = None, masks=None, top_down: bool = False) -> bytes:
    """A BMP with the pixel bytes given as they lie in the file (rows padded
    to 4 bytes, bottom-up unless ``top_down``): a BITMAPINFOHEADER (40), an
    OS/2 1.x (12) or 2.x (64) header, or a V4 (108) / V5 (124) header;
    ``palette`` rows of (B, G, R) (3 bytes each under a 12-byte header),
    ``masks`` (R, G, B) written after the header as BI_BITFIELDS wants."""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes(list(p)[:3]) + (b"" if header == 12 else b"\x00") for p in palette)
    extra = struct.pack("<III", *masks) if masks else b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bpp)
    else:
        n = len(palette) if palette is not None else 0
        info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1, bpp, compression,
                           len(pixels), 2835, 2835, n if clrused is None else clrused, 0)
        info += b"\x00" * (header - len(info))
    offset = 14 + len(info) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + extra + pal + pixels


def bmp_rows(idx: np.ndarray, bpp: int, bottom_up: bool = True) -> bytes:
    """(H, W) indices or (H, W·bytes) samples → rows padded to 4 bytes at
    ``bpp`` bits a pixel (1, 4, 8, or whole bytes for more), bottom-up
    unless ``bottom_up`` is false."""
    h = idx.shape[0]
    if bpp == 1:
        rows = np.packbits(idx.astype(np.uint8), axis=1)
    elif bpp == 4:
        a = idx.astype(np.uint8)
        if a.shape[1] % 2:
            a = np.concatenate([a, np.zeros((h, 1), np.uint8)], 1)
        rows = (a[:, 0::2] << 4) | a[:, 1::2]
    else:
        rows = idx.astype(np.uint8).reshape(h, -1)
    pad = (-rows.shape[1]) % 4
    rows = np.concatenate([rows, np.zeros((h, pad), np.uint8)], 1)
    return (rows[::-1] if bottom_up else rows).tobytes()


def bmp_rle8(idx: np.ndarray) -> bytes:
    """(H, W) indices → an RLE8 stream as encoders write it: runs of up to
    255, absolute runs for stretches of distinct values, an end of line
    after each row and an end of bitmap (rows bottom-up)."""
    out = bytearray()
    for row in idx[::-1]:
        x, w = 0, len(row)
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 3 or w - x < 3:
                out += bytes([n, row[x]])
                x += n
                continue
            m = 1
            while x + m < w and m < 255 and (x + m + 2 >= w or not (row[x + m] == row[x + m + 1] == row[x + m + 2])):
                m += 1
            if m < 3:
                out += bytes([1, row[x]])
                x += 1
                continue
            out += bytes([0, m]) + bytes(row[x:x + m].tolist()) + (b"\x00" if m % 2 else b"")
            x += m
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_rle4(idx: np.ndarray, delta: int = 0) -> bytes:
    """(H, W) indices below 16 → an RLE4 stream: repeats as encoded runs,
    the rest in absolute runs (pairs of indices a byte), an end of line per
    row; with ``delta`` the first row starts with a delta of that many
    pixels (cv2 fills them with entry 0)."""
    out = bytearray()
    for r, row in enumerate(idx[::-1].tolist()):
        x, w = 0, len(row)
        if r == 0 and delta:
            out += bytes([0, 2, delta, 0])
            x = delta
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 4 or w - x < 3:
                n = min(n, w - x) if n >= 4 else w - x
                pair = (row[x] << 4) | (row[x + 1] if n > 1 and n < 4 else row[x])
                out += bytes([n, pair])
                x += n
                continue
            m = min(w - x, 16)
            vals = row[x:x + m] + [0]
            body = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, m, 2))
            out += bytes([0, m]) + body + (b"\x00" if len(body) % 2 else b"")
            x += m
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_rle_random(rng, width: int, height: int, bits: int, ops: int = 60) -> bytes:
    """A random RLE4/RLE8 stream of encoded and absolute runs, ends of line,
    deltas and an end of bitmap; some runs cross a line's end (cv2 gives up)."""
    out = bytearray()
    for _ in range(ops):
        k = rng.integers(0, 10)
        if k < 4:
            out += bytes([int(rng.integers(1, width + 2)), int(rng.integers(0, 256))])
        elif k < 7:
            n = int(rng.integers(3, max(width, 2) + 2))
            nbytes = n if bits == 8 else (n + 1) // 2
            body = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
            pad = (-nbytes) % 2
            out += bytes([0, n]) + body + b"\x00" * pad
        elif k < 9:
            out += b"\x00\x00"
        else:
            out += bytes([0, 2, int(rng.integers(0, width)), int(rng.integers(0, 2))])
    if rng.integers(0, 4):
        out += b"\x00\x01"
    return bytes(out)


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, 9 to 12 bits, the width growing one code
    early as libtiff writes it), a Clear code first and EOI last."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:  # the table is full: Clear, as libtiff's LZWEncode
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
        w = bytes([b])
    if w:
        put(table[w])
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits runs: a literal of up to 128 bytes or a repeat of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _predict_h(s: np.ndarray) -> np.ndarray:
    """Horizontal differencing (predictor 2) along each row, per sample, on
    the samples' bits as unsigned words (float samples too, as libtiff)."""
    u = s.view(f"u{s.dtype.itemsize}")
    d = u.copy()
    d[:, 1:] = u[:, 1:] - u[:, :-1]
    return d.view(s.dtype)


def _predict_float(s: np.ndarray) -> np.ndarray:
    """Floating point predictor (3), as libtiff's fpDiff: each row's
    samples split into byte planes, most significant first, then
    differenced bytewise with a stride of the samples per pixel."""
    h, w, spp = s.shape
    b = s.astype(s.dtype.newbyteorder(">")).view(np.uint8).reshape(h, w * spp, s.dtype.itemsize)
    planes = b.transpose(0, 2, 1).reshape(h, -1)
    d = planes.copy()
    d[:, spp:] = planes[:, spp:] - planes[:, :-spp]
    return d


def tiff(samples: np.ndarray, photometric: int, compression: int = 1, predictor: int = 1, rows_per_strip=None,
         tile=None, planar: int = 1, order: str = "<", bits: int | None = None, sample_format: int | None = None,
         extra=None, colormap=None, orientation: int | None = None, extra_tags=None, subsampling=None,
         big: bool = False) -> bytes:
    """(H, W, spp) samples → a one-image TIFF (classic, or BigTIFF with
    ``big``; byte order ``order``): strips of ``rows_per_strip`` rows or ``tile`` = (tw, th)
    tiles, chunky (1) or planar (2), compression none (1), LZW (5), Deflate
    (8 or 32946) or PackBits (32773), predictor 1, 2 or 3. Samples of
    ``bits`` other than 8, 16, 32 and 64 (1, 2, 4, 10, 12, 14) are packed
    per row, most significant bit first. With ``subsampling`` = (hs, vs),
    YCbCr samples (photometric 6, chunky) are written as sampling units:
    hs x vs luma samples, then the Cb and Cr of the unit's top left pixel,
    the strip or tile padded to whole units by repeating its last row and
    column."""
    s = samples if samples.ndim == 3 else samples[..., None]
    h, w, spp = s.shape
    bits = bits or s.dtype.itemsize * 8
    dt = s.dtype.newbyteorder(order) if s.dtype.itemsize > 1 else s.dtype

    def encode(block: np.ndarray) -> bytes:  # (rows, cols, n) samples of one strip / tile / plane
        if subsampling:
            hs, vs = subsampling
            b = np.pad(block, ((0, -block.shape[0] % vs), (0, -block.shape[1] % hs), (0, 0)), mode="edge")
            uy, ux = b.shape[0] // vs, b.shape[1] // hs
            luma = b[..., 0].reshape(uy, vs, ux, hs).transpose(0, 2, 1, 3).reshape(uy, ux, vs * hs)
            units = np.concatenate([luma, b[::vs, ::hs, 1:3]], -1).astype(np.uint8)
            block = units.reshape(uy, 1, -1)
        if bits % 8:  # every sample of a row packed MSB first, the row padded to a byte
            v = block.reshape(block.shape[0], -1).astype(np.uint32)
            b = ((v[..., None] >> np.arange(bits - 1, -1, -1, dtype=np.uint32)) & 1).astype(np.uint8)
            raw = np.packbits(b.reshape(v.shape[0], -1), axis=1).tobytes()
        elif predictor == 3:
            raw = _predict_float(block).tobytes()
        else:
            b = block.reshape(block.shape[0], -1)
            if predictor == 2:
                b = _predict_h(block).reshape(block.shape[0], -1) if block.shape[2] == 1 else _predict_h(
                    block.reshape(block.shape[0], block.shape[1], -1)).reshape(block.shape[0], -1)
            raw = np.ascontiguousarray(b).astype(dt).tobytes()
        if compression == 5:
            return tiff_lzw(raw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        if compression == 32773:
            rowlen = len(raw) // block.shape[0]
            return b"".join(packbits(raw[r * rowlen:(r + 1) * rowlen]) for r in range(block.shape[0]))
        return raw

    chunks = []
    planes = [s] if planar == 1 else [s[..., c:c + 1] for c in range(spp)]
    if tile:
        tw, th = tile
        for p in planes:
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, p.shape[2]), s.dtype)
                    part = p[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk))
    else:
        rps = rows_per_strip or h
        for p in planes:
            for y in range(0, h, rps):
                chunks.append(encode(p[y:y + rps]))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if subsampling:
        entries[530] = (3, list(subsampling))
    if tile:
        entries[322], entries[323] = (4, [tile[0]]), (4, [tile[1]])
    else:
        entries[278] = (4, [rows_per_strip or h])
    if sample_format:
        entries[339] = (3, [sample_format] * spp)
    if extra is not None:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(np.asarray(colormap, np.uint16).T.reshape(-1)))
    if orientation:
        entries[274] = (3, [orientation])
    for k, v in (extra_tags or {}).items():
        entries[k] = v
    # layout: header, chunk data, then the IFD and its out-of-line values
    if big:  # version 43: 8-byte offsets, 8-byte counts, 20-byte entries
        data = bytearray((b"II+\x00" if order == "<" else b"MM\x00+") + struct.pack(order + "HHQ", 8, 0, 0))
        head, count_fmt, inline, long_type = "HHQ", "Q", 8, 16
    else:
        data = bytearray(b"II*\x00" if order == "<" else b"MM\x00*") + b"\x00" * 4
        head, count_fmt, inline, long_type = "HHI", "H", 4, 4
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) % 2:
            data += b"\x00"
    entries[324 if tile else 273] = (long_type, offsets)
    entries[325 if tile else 279] = (long_type, [len(c) for c in chunks])
    ifd_at = len(data)
    tags = sorted(entries)
    entry = struct.calcsize(order + head) + inline
    values_at = ifd_at + struct.calcsize(order + count_fmt) + entry * len(tags) + inline
    ifd, values = bytearray(struct.pack(order + count_fmt, len(tags))), bytearray()
    for t in tags:
        typ, vals = entries[t]  # RATIONAL (5) values as numerator, denominator pairs
        blob = struct.pack(order + {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}[typ] * len(vals), *vals)
        count = len(vals) // 2 if typ == 5 else len(vals)
        if len(blob) <= inline:
            ifd += struct.pack(order + head, t, typ, count) + blob + b"\x00" * (inline - len(blob))
        else:
            ifd += struct.pack(order + head, t, typ, count) + struct.pack(order + ("Q" if big else "I"),
                                                                            values_at + len(values))
            values += blob + (b"\x00" if len(blob) % 2 else b"")
    ifd += b"\x00" * inline
    data += ifd + values
    if big:
        data[8:16] = struct.pack(order + "Q", ifd_at)
    else:
        data[4:8] = struct.pack(order + "I", ifd_at)
    return bytes(data)


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------


def sun_raster(body: bytes, width: int, height: int, depth: int, ras_type: int = 1, colormap: bytes = b"") -> bytes:
    """A Sun raster: its 32-byte big-endian header, an RGB colour map (all
    reds, then greens, then blues) and the body as given."""
    return struct.pack(">8I", 0x59A66A95, width, height, depth, len(body), ras_type, 1 if colormap else 0,
                       len(colormap)) + colormap + body


def sun_rle(rng, width: int, height: int, ops: int = 40) -> bytes:
    """A random RLE body: literal bytes, escaped 0x80s, runs (0x80 n v) and
    the zero byte cv2 wants at each line's end, some of them wrong."""
    out = bytearray()
    for _ in range(ops):
        k = rng.integers(0, 10)
        if k < 5:
            out += bytes(int(v) for v in rng.integers(0, 128, int(rng.integers(1, width + 1))))
        elif k < 6:
            out += b"\x80\x00"
        elif k < 9:
            out += bytes([0x80, int(rng.integers(1, 2 * width + 2)), int(rng.integers(0, 256))])
        else:
            out += b"\x00" if rng.integers(0, 4) else b"\x07"
    return bytes(out)


# ---------------------------------------------------------------------------
# Radiance HDR
# ---------------------------------------------------------------------------


def hdr(rgbe: np.ndarray, rle: bool = True, header: bytes = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
        size_line: bytes | None = None) -> bytes:
    """(H, W, 4) RGBE bytes → a Radiance file: flat pixels, or each
    scanline in the new run-length form (channels one after another, runs
    of 3 or more as 128 + n, literals of up to 128)."""
    h, w = rgbe.shape[:2]
    out = bytearray(header + (size_line or b"-Y %d +X %d\n" % (h, w)))
    if not rle:
        return bytes(out + rgbe.astype(np.uint8).tobytes())
    for row in rgbe.astype(np.uint8):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            ch, i = row[:, c].tolist(), 0
            while i < w:
                j = i
                while j < w and j - i < 127 and ch[j] == ch[i]:
                    j += 1
                if j - i >= 3:
                    out += bytes([128 + j - i, ch[i]])
                    i = j
                    continue
                j = i + 1
                while j < w and j - i < 128 and not (j + 2 < w and ch[j] == ch[j + 1] == ch[j + 2]):
                    j += 1
                out += bytes([j - i]) + bytes(ch[i:j])
                i = j
    return bytes(out)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def gif_lzw(indices: bytes, min_size: int, clear_every: int = 0) -> bytes:
    """GIF LZW (LSB-first codes from min_size + 1 bits to 12), a Clear code
    first, again when the table is full (or every ``clear_every`` codes),
    and End last; the data sub-blocks are not added here."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nacc = bytearray(), 0, 0
    width = min_size + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def reset():
        return {bytes([i]): i for i in range(clear)}, end + 1, min_size + 1

    table, nxt, width = reset()
    put(clear)
    w, emitted = b"", 0
    for b in indices:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        emitted += 1
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        if nxt == 4096 or (clear_every and emitted % clear_every == 0):
            put(clear)
            table, nxt, width = reset()
        w = bytes([b])
    if w:
        put(table[w])
    put(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)) + b"\x00"


def gif(frames, screen, global_palette=None, background: int = 0, version: bytes = b"89a") -> bytes:
    """A GIF of ``frames``: dicts with ``indices`` (h, w), ``left``, ``top``,
    optional ``palette`` (local), ``transparent`` index, ``interlace``,
    ``disposal`` and ``min_size``; ``screen`` is (width, height)."""
    sw, sh = screen
    flags = 0
    gp = b""
    if global_palette is not None:
        n = len(global_palette)
        size = max(1, (n - 1).bit_length()) - 1
        gp = bytes(np.asarray(global_palette, np.uint8).reshape(-1)) + b"\x00" * (3 * ((2 << size) - n))
        flags = 0x80 | (7 << 4) | size
    out = bytearray(b"GIF" + version + struct.pack("<HHBBB", sw, sh, flags, background, 0) + gp)
    for f in frames:
        idx = np.asarray(f["indices"], np.uint8)
        h, w = idx.shape
        if "transparent" in f or "disposal" in f:
            packed = (f.get("disposal", 0) << 2) | (1 if "transparent" in f else 0)
            out += b"\x21\xf9\x04" + struct.pack("<BHB", packed, 0, f.get("transparent", 0)) + b"\x00"
        lflags = 0
        lp = b""
        if f.get("palette") is not None:
            n = len(f["palette"])
            size = max(1, (n - 1).bit_length()) - 1
            lp = bytes(np.asarray(f["palette"], np.uint8).reshape(-1)) + b"\x00" * (3 * ((2 << size) - n))
            lflags = 0x80 | size
        rows = idx
        if f.get("interlace"):
            lflags |= 0x40
            order = list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4)) + list(range(1, h, 2))
            rows = idx[order]
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), w, h, lflags) + lp
        min_size = f.get("min_size", 8)
        out += bytes([min_size]) + _sub_blocks(gif_lzw(rows.tobytes(), min_size, f.get("clear_every", 0)))
    return bytes(out + b"\x3b")


# ---------------------------------------------------------------------------
# The committed fixtures
# ---------------------------------------------------------------------------


def _pil(img, fmt: str, **kw) -> bytes:
    from PIL import Image

    bio = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(bio, fmt, **kw)
    return bio.getvalue()


def fixtures() -> dict:
    """Every committed container fixture, name → bytes (cv2 and PIL write
    some, so this needs both; the names' extensions are the usual ones, the
    decoders go by signature). Each mode the port decodes, and each case
    where cv2 returns None."""
    import cv2

    rng = np.random.default_rng(19)
    h, w = 21, 26

    def smooth(shape, hi=256):  # a gradient with noise: runs for the run-length coders
        y, x = np.mgrid[:shape[0], :shape[1]]
        base = (x * 7 + y * 3)[..., None] if len(shape) == 3 else (x * 7 + y * 3)
        return ((base + rng.integers(0, 4, shape)) % hi).astype(np.uint8 if hi <= 256 else np.uint16)

    g, c, a = smooth((h, w)), smooth((h, w, 3)), smooth((h, w, 4))
    g16 = smooth((h, w), 65536) * 97
    c16 = smooth((h, w, 3), 65536) * 89
    f = (rng.standard_normal((h, w)) * 40).astype(np.float32)
    f3 = (rng.random((h, w, 3)) * 4).astype(np.float32)
    enc = lambda ext, img, *p: cv2.imencode(ext, img, list(p))[1].tobytes()  # noqa: E731
    out = {}
    # lossless JPEG
    out["ll_gray_p1.jpg"] = lossless_jpeg(g, 1)
    out["ll_gray_p7_pt2_rst.jpg"] = lossless_jpeg(g, 7, pt=2, restart_rows=4)
    out["ll_gray_7bit_p3.jpg"] = lossless_jpeg(g >> 1, 3, precision=7)
    out["ll_rgb_p4.jpg"] = lossless_jpeg(c, 4)
    out["ll_rgb_p6_rst.jpg"] = lossless_jpeg(c, 6, restart_rows=5, ids=[82, 71, 66])
    out["ll_rgb_adobe_p2.jpg"] = lossless_jpeg(c, 2, adobe=0)
    out["ll_rgb_420_p5.jpg"] = lossless_jpeg(c, 5, sampling=[(2, 2), (1, 1), (1, 1)])
    out["ll_rgb_scans_p2.jpg"] = lossless_jpeg(c, 2, interleaved=False, restart_rows=3)
    out["ll_cmyk_p1.jpg"] = lossless_jpeg(a, 1)
    full = lossless_jpeg(c, 4, restart_rows=3)
    out["ll_rgb_cut.jpg"] = full[: len(full) * 2 // 3]
    out["ll_gray_12bit.jpg"] = lossless_jpeg(g.astype(np.int64) << 4, 1, precision=12)
    out["ll_rgb_16bit.jpg"] = lossless_jpeg(c.astype(np.int64) << 8, 1, precision=16)
    out["ll_ycc_jfif.jpg"] = lossless_jpeg(c, 1, jfif=True)
    out["ll_ycck.jpg"] = lossless_jpeg(a, 1, adobe=2)
    out["ll_arith_sof11.jpg"] = lossless_jpeg(g, 1, marker=0xCB)
    out["hierarchical_sof5.jpg"] = lossless_jpeg(g, 1, marker=0xC5)
    out["ll_bad_restart.jpg"] = lossless_jpeg(g, 1, restart_rows=2).replace(
        b"\xff\xdd\x00\x04" + struct.pack(">H", 2 * w), b"\xff\xdd\x00\x04" + struct.pack(">H", w + 1))
    # PNM, PAM, PFM
    out["p1.pbm"] = enc(".pbm", (g > 128).astype(np.uint8) * 255, cv2.IMWRITE_PXM_BINARY, 0)
    out["p4.pbm"] = enc(".pbm", (g > 100).astype(np.uint8) * 255)
    out["p2_maxval100.pgm"] = b"P2\n# maxval 100\n%d %d\n100\n" % (w, h) + " ".join(
        str(v) for v in (g.reshape(-1) % 110)).encode() + b"\n"
    out["p5.pgm"] = enc(".pgm", g)
    out["p5_maxval1000.pgm"] = b"P5\n%d %d\n1000\n" % (w, h) + (g.astype(">u2") * 3).tobytes()
    out["p5_16.pgm"] = enc(".pgm", g16)
    out["p3.ppm"] = enc(".ppm", c, cv2.IMWRITE_PXM_BINARY, 0)
    out["p6.ppm"] = enc(".ppm", c)
    out["p6_16.ppm"] = enc(".ppm", c16)
    out["pam_gray.pam"] = enc(".pam", g)
    out["pam_rgb.pam"] = enc(".pam", c)
    out["pam_bw.pam"] = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 1\nMAXVAL 1\nTUPLTYPE BLACKANDWHITE\nENDHDR\n" % (w, h) + g.tobytes()
    out["pam_gray16.pam"] = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 1\nMAXVAL 65535\nTUPLTYPE GRAYSCALE\nENDHDR\n" % (
        w, h) + g16.astype(">u2").tobytes()
    out["pam_rgba_no_tupltype.pam"] = enc(".pam", a)
    out["pam_gray16_no_tupltype.pam"] = enc(".pam", g16)
    out["pfm_gray.pfm"] = enc(".pfm", f)
    out["pfm_rgb.pfm"] = enc(".pfm", f3)
    out["pfm_rgb_be_scale4.pfm"] = b"PF\n%d %d\n4.0\n" % (w, h) + (f3[::-1, :, ::-1] * 4).astype(">f4").tobytes()
    # BMP
    pal16 = rng.integers(0, 256, (16, 3))
    pal256 = rng.integers(0, 256, (256, 3))
    gray16 = [(v * 17,) * 3 for v in range(16)]
    out["bmp1.bmp"] = _pil((g > 128).astype(np.uint8) * 255, "BMP")
    out["bmp4_pal.bmp"] = bmp(bmp_rows(g % 16, 4), w, h, 4, palette=pal16)
    out["bmp4_gray.bmp"] = bmp(bmp_rows(g % 16, 4), w, h, 4, palette=gray16)
    out["bmp8_gray.bmp"] = enc(".bmp", g)
    out["bmp8_pal_clrused.bmp"] = bmp(bmp_rows(g % 40, 8), w, h, 8, palette=pal256[:40])
    out["bmp_rle8.bmp"] = bmp(bmp_rle8(g // 16), w, h, 8, 1, pal256)
    out["bmp_rle8_random.bmp"] = bmp(bmp_rle_random(rng, w, h, 8, 80), w, h, 8, 1, pal256)
    out["bmp_rle4_random.bmp"] = bmp(bmp_rle_random(rng, w, h, 4, 80), w, h, 4, 2, pal16)
    out["bmp_rle4_delta.bmp"] = bmp(bmp_rle4((g // 16) % 16, delta=3), w, h, 4, 2, pal16)
    out["bmp555.bmp"] = bmp(bmp_rows(rng.integers(0, 256, (h, 2 * w)), 16), w, h, 16)
    out["bmp565_bitfields.bmp"] = bmp(bmp_rows(rng.integers(0, 256, (h, 2 * w)), 16), w, h, 16, 3,
                                      masks=(0xF800, 0x7E0, 0x1F))
    out["bmp24_top_down.bmp"] = bmp(bmp_rows(c.reshape(h, -1), 24, bottom_up=False), w, h, 24, top_down=True)
    out["bmp24_v4.bmp"] = bmp(bmp_rows(c.reshape(h, -1), 24), w, h, 24, header=108)
    out["bmp32_rgb.bmp"] = bmp(bmp_rows(a.reshape(h, -1), 32), w, h, 32)
    out["bmp32_bgra_v5.bmp"] = enc(".bmp", a)
    out["bmp_os2_8.bmp"] = bmp(bmp_rows(g, 8), w, h, 8, palette=pal256, header=12)
    out["bmp_os2_24.bmp"] = bmp(bmp_rows(c.reshape(h, -1), 24), w, h, 24, header=12)
    out["bmp_cut.bmp"] = enc(".bmp", c)[:-40]
    # TIFF
    out["tiff_gray8_cv2.tif"] = enc(".tiff", g)
    out["tiff_rgba_cv2.tif"] = enc(".tiff", a)
    out["tiff_gray16_cv2.tif"] = enc(".tiff", g16)
    out["tiff_rgb16_cv2.tif"] = enc(".tiff", c16)
    out["tiff_float32_cv2.tif"] = enc(".tiff", f)
    out["tiff_rgb_deflate_pred2.tif"] = tiff(c, 2, 8, predictor=2, rows_per_strip=5)
    out["tiff_rgb_adobe_deflate.tif"] = tiff(c, 2, 32946, order=">")
    out["tiff_rgba_unassoc_packbits.tif"] = tiff(a, 2, 32773, extra=[2], rows_per_strip=7)
    out["tiff_rgba16_unassoc_lzw.tif"] = tiff(c16[..., [0, 1, 2, 0]], 2, 5, extra=[2])
    out["tiff_gray16_min_is_white.tif"] = tiff(g16, 0, 5, predictor=2)
    out["tiff_gray_alpha8.tif"] = tiff(a[..., :2], 1, 8, extra=[2])
    out["tiff_pal4.tif"] = tiff(g % 16, 3, 5, bits=4, colormap=rng.integers(0, 65536, (16, 3)))
    out["tiff_pal8.tif"] = tiff(g, 3, 8, colormap=pal256)
    out["tiff_bilevel.tif"] = tiff((g > 128).astype(np.uint8), 0, 32773, bits=1)
    out["tiff_tiled_lzw.tif"] = tiff(c, 2, 5, tile=(16, 16))
    out["tiff_tiled_gray16_deflate.tif"] = tiff(g16, 1, 8, tile=(16, 32))
    out["tiff_planar_rgb_lzw.tif"] = tiff(c, 2, 5, planar=2, rows_per_strip=8)
    out["tiff_float32_pred3.tif"] = tiff(f3, 2, 8, predictor=3, sample_format=3)
    out["tiff_cmyk.tif"] = tiff(a, 5, 8)
    out["tiff_int16.tif"] = tiff(g16.astype(np.int16), 1, 5, sample_format=2)
    out["tiff_orientation6.tif"] = tiff(c, 2, 8, orientation=6, rows_per_strip=4)
    out["tiff_2bit_gray.tif"] = tiff(g % 4, 1, 1, bits=2)
    out["tiff_5_samples.tif"] = tiff(np.concatenate([c, c[..., :2]], -1), 2, 8, extra=[0, 0])
    out["tiff_cut.tif"] = enc(".tiff", c)[:200]
    # Sun raster
    out["sun8_gray.ras"] = enc(".ras", g)
    out["sun24.ras"] = enc(".ras", c)
    out["sun32.ras"] = enc(".ras", a)
    out["sun8_map.ras"] = sun_raster(g.tobytes(), w, h, 8, 1,
                                     bytes(rng.integers(0, 256, 768, dtype=np.uint8)))
    out["sun1.ras"] = sun_raster(np.packbits(g > 128, axis=1).tobytes(), w, h, 1, 1)
    out["sun_rle.ras"] = sun_raster(b"\x80\x05\x07" * 200, w, h, 8, 2)
    # Radiance HDR
    rgbe = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.choice([0, 120, 128, 130, 140], (h, w))
    rgbe[: h // 2, : w // 2] = rgbe[0, 0]
    out["hdr_cv2.hdr"] = enc(".hdr", f3)
    out["hdr_rle.hdr"] = hdr(rgbe)
    out["hdr_flat_rgbe_sig.hdr"] = hdr(rgbe, rle=False, header=b"#?RGBE\nEXPOSURE=2\nFORMAT=32-bit_rle_rgbe\n\n")
    out["hdr_cut.hdr"] = hdr(rgbe)[:-50]
    # GIF
    pal = rng.integers(0, 256, (64, 3))
    idx = (g // 4).astype(np.uint8)
    out["gif_cv2.gif"] = enc(".gif", c)
    out["gif_interlaced.gif"] = gif([dict(indices=idx, interlace=True, min_size=6)], (w, h), pal, background=3)
    out["gif_transparent_offset.gif"] = gif([dict(indices=idx[3:15, 2:20], left=4, top=5, transparent=int(idx[3, 2]),
                                                   min_size=6)], (w, h), pal, background=9)
    out["gif_local_table.gif"] = gif([dict(indices=idx % 16, palette=pal16, min_size=4)], (w, h), pal)
    out["gif_no_table.gif"] = gif([dict(indices=idx, min_size=6)], (w, h), None, background=1)
    out["gif_two_frames.gif"] = gif([dict(indices=idx, min_size=6), dict(indices=63 - idx, min_size=6)], (w, h), pal)
    out["gif_cut.gif"] = out["gif_interlaced.gif"][:-60]
    # what cv2 here returns None for: OpenEXR (not built in)
    out["openexr_header.exr"] = b"v/1\x01\x02\x00\x00\x00channels\x00chlist\x00" + b"\x00" * 64
    return out


def tiff_fixtures() -> dict:
    """The TIFF fixtures written here (``tests/fixtures/codecs/tiff``
    beside ``make_tiff.c``'s from the system libtiff), name → bytes: PIL's
    BigTIFF, CCITT (Modified Huffman, T.4, T.6), JPEG (YCbCr, RGB, gray,
    CMYK), YCbCr and CIELab writes; this writer's subsampled YCbCr units,
    CIELab of 16 bits and another white point, 10-, 12- and 14-bit samples,
    BigTIFF layouts; and files cv2 returns None for: the compressions its
    libtiff lacks, ICCLab and ITULab, YCbCr subsamplings libtiff's RGBA
    reader has no routine for, a predictor on 12-bit samples."""
    from PIL import Image

    rng = np.random.default_rng(23)
    h, w = 29, 37
    y, x = np.mgrid[:h, :w]
    c = ((x * 6 + y * 4)[..., None] + np.array([0, 70, 140]) + rng.integers(0, 16, (h, w, 3))).astype(np.uint8)
    im = Image.fromarray(c)
    bits = Image.fromarray(((x // 5 + y // 3) % 3 == 0) ^ (rng.random((h, w)) < 0.05))
    out = {}
    out["pil_bigtiff_rgb.tif"] = _pil(im, "TIFF", big_tiff=True)
    out["pil_bigtiff_gray.tif"] = _pil(im.convert("L"), "TIFF", big_tiff=True)
    for comp in ("tiff_ccitt", "group3", "group4"):
        out[f"pil_{comp}.tif"] = _pil(bits, "TIFF", compression=comp)
    for mode in ("RGB", "L", "CMYK"):
        out[f"pil_jpeg_{mode.lower()}.tif"] = _pil(im.convert(mode), "TIFF", compression="jpeg", quality=80)
    out["pil_ycbcr.tif"] = _pil(im.convert("YCbCr"), "TIFF")
    out["pil_lab.tif"] = _pil(im.convert("LAB"), "TIFF")
    out["pil_lab_lzw.tif"] = _pil(im.convert("LAB"), "TIFF", compression="tiff_lzw")
    ycc = np.asarray(im.convert("YCbCr"))
    for sub, comp, lay in (((2, 2), 8, {}), ((2, 1), 5, dict(rows_per_strip=6)), ((1, 2), 32773, {}),
                           ((4, 2), 1, dict(tile=(16, 16))), ((4, 4), 5, dict(tile=(32, 16))), ((4, 1), 1, {}),
                           ((1, 1), 8, dict(tile=(16, 16)))):
        out[f"ycbcr_{sub[0]}{sub[1]}_{comp}.tif"] = tiff(ycc, 6, comp, subsampling=sub, **lay)
    out["ycbcr_22_bt709_studio.tif"] = tiff(ycc, 6, 1, subsampling=(2, 2), extra_tags={
        529: (5, [2126, 10000, 7152, 10000, 722, 10000]), 532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])})
    out["ycbcr_planar_11.tif"] = tiff(ycc, 6, 8, planar=2, extra_tags={530: (3, [1, 1])})
    lab = np.asarray(im.convert("LAB"))
    out["cielab16.tif"] = tiff((lab.astype(np.uint16) * 257) ^ rng.integers(0, 256, lab.shape).astype(np.uint16), 8, 8)
    out["cielab8_d65.tif"] = tiff(lab, 8, 5, extra_tags={318: (5, [3127, 10000, 3290, 10000])})
    deep = [(rng.integers(0, 1 << b, (h, w, n)).astype(np.uint16), b, n) for b, n in ((10, 1), (12, 3), (14, 4))]
    for s, b, n in deep:
        out[f"deep{b}_{n}.tif"] = tiff(s, 1 if n == 1 else 2, 5, bits=b, extra=[2] if n == 4 else None)
        out[f"deep{b}_{n}_deflate_be.tif"] = tiff(s, 1 if n == 1 else 2, 8, bits=b, order=">",
                                                extra=[2] if n == 4 else None)
    g16 = (c[..., 0].astype(np.uint16) * 251) ^ rng.integers(0, 256, (h, w)).astype(np.uint16)
    out["bigtiff_lzw_pred2.tif"] = tiff(c, 2, 5, predictor=2, rows_per_strip=8, big=True)
    out["bigtiff_gray16_deflate_tiles_be.tif"] = tiff(g16, 1, 8, tile=(16, 16), order=">", big=True)
    out["bigtiff_planar_packbits.tif"] = tiff(c, 2, 32773, planar=2, big=True)
    out["bigtiff_pal4.tif"] = tiff(c[..., 0] % 16, 3, 5, bits=4, colormap=rng.integers(0, 65536, (16, 3)), big=True)
    out["bigtiff_ycbcr_42.tif"] = tiff(ycc, 6, 5, subsampling=(4, 2), big=True)
    # what cv2 returns None for
    for comp, name in ((34925, "lzma"), (50000, "zstd"), (50001, "webp"), (34887, "lerc"), (34661, "jbig"),
                       (6, "old_jpeg"), (32909, "pixarlog")):
        raw = bytearray(tiff(c, 2, 1))
        raw = raw.replace(struct.pack("<HHIHH", 259, 3, 1, 1, 0), struct.pack("<HHIHH", 259, 3, 1, comp, 0))
        out[f"refused_{name}.tif"] = bytes(raw)
    out["refused_icclab.tif"] = tiff(lab, 9, 1)
    out["refused_itulab.tif"] = tiff(lab, 10, 1)
    out["refused_ycbcr_24.tif"] = tiff(ycc, 6, 1, subsampling=(2, 4))
    out["refused_deep12_pred2.tif"] = tiff(deep[1][0], 2, 5, bits=12, predictor=2)
    return out
