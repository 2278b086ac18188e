"""The JPEG 2000 fixtures (``tests/fixtures/codecs/jpeg2000``), written by
``make_digests.py``: ``capture()`` is the committed capture's maintenance
frames as cv2 and PIL write them, ``fixtures()`` every other case. cv2 writes
only JP2 with the reversible 5/3 wavelet and no colour transform; PIL
(OpenJPEG's encoder) writes the rest: the 9/7 wavelet, RCT/ICT, every
progression order, 1-6 resolutions, code-block and precinct sizes, tiles,
layers, raw codestreams and PLT markers. The helpers below edit what
neither writes: JP2 boxes (``cdef`` orders, ``pclr``/``cmap`` on a gray
codestream, ``colr`` spaces, ``res``, misplaced and XL boxes), SIZ's
precision, sign and subsampling bytes, and, from the packet lengths of a
PLT marker, SOP markers before every packet, several tile-parts per tile
and a POC marker whose entries reorder the packets, and from EPH markers
the packet headers moved into PPT or PPM markers
(``make_jpeg2000_opj.py`` has OpenJPEG's encoder write the code-block
styles, SOP/EPH, ROI, tile-parts and POC). HT code-blocks need an encoder
that writes them; there is none here.
"""

from __future__ import annotations

import io
import os
import sqlite3
import struct

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
CAPTURE_DB = os.path.join(os.path.dirname(HERE), "torch_project", "data", "maintenance", "data.db")


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def colr(enumcs: int) -> bytes:
    return box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def jp2(cs: bytes, ncomp: int, h: int, w: int, bpc: int = 7, colour: bytes | None = None, extra: bytes = b"",
        post: bytes = b"") -> bytes:
    """A JP2 file around codestream ``cs``: signature, ftyp, jp2h (ihdr,
    ``colour`` or an sRGB/greyscale colr, ``extra`` boxes), jp2c, ``post``."""
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, ncomp, bpc, 7, 0, 0))
    if colour is None:
        colour = colr(16 if ncomp >= 3 else 17)
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + box(b"jp2h", ihdr + colour + extra)
            + box(b"jp2c", cs) + post)


def siz_edit(cs: bytes, ssiz=None, dx=None) -> bytes:
    """Every component's Ssiz (precision - 1, sign in bit 7) or XRsiz set."""
    cs = bytearray(cs)
    i = cs.index(b"\xff\x51")
    for c in range(int.from_bytes(cs[i + 38:i + 40], "big")):
        if ssiz is not None:
            cs[i + 40 + 3 * c] = ssiz[c] if isinstance(ssiz, (list, tuple)) else ssiz
        if dx is not None:
            cs[i + 41 + 3 * c] = dx[c]
    return bytes(cs)


def picture(h: int, w: int, channels: int, seed: int, noise: int = 10) -> np.ndarray:
    """A smooth image with some noise: every sub-band carries data."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(1, h // 5), max(1, w // 5), channels), dtype=np.uint8)
    base = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR).reshape(h, w, channels)
    out = np.clip(base.astype(int) + rng.integers(-noise, noise + 1, base.shape), 0, 255).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


def pil(arr: np.ndarray, **options) -> bytes:
    """PIL's JPEG 2000 of an array (RGB order, or gray, LA, RGBA, I;16)."""
    b = io.BytesIO()
    img = Image.fromarray(arr) if arr.dtype == np.uint8 else Image.frombytes("I;16", arr.shape[::-1], arr.tobytes())
    img.save(b, "JPEG2000", **options)
    return b.getvalue()


# ---------------------------------------------------------------------------
# Codestream surgery
# ---------------------------------------------------------------------------


def split(cs: bytes):
    """(main header segments, [(Isot, TPsot, TNsot, header segments, data)])
    of a codestream whose tile-parts all give Psot."""
    pos, main = 2, []
    while cs[pos:pos + 2] != b"\xff\x90":
        n = struct.unpack(">H", cs[pos + 2:pos + 4])[0]
        main.append((cs[pos:pos + 2], cs[pos + 4:pos + 2 + n]))
        pos += 2 + n
    parts = []
    while cs[pos:pos + 2] == b"\xff\x90":
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", cs[pos + 4:pos + 12])
        end, q, segs = pos + psot, pos + 12, []
        while cs[q:q + 2] != b"\xff\x93":
            n = struct.unpack(">H", cs[q + 2:q + 4])[0]
            segs.append((cs[q:q + 2], cs[q + 4:q + 2 + n]))
            q += 2 + n
        parts.append((isot, tpsot, tnsot, segs, cs[q + 2:end]))
        pos = end
    assert cs[pos:pos + 2] == b"\xff\xd9", "EOC"
    return main, parts


def join(main, parts) -> bytes:
    seg = lambda m, body: m + struct.pack(">H", len(body) + 2) + body  # noqa: E731
    out = b"\xffO" + b"".join(seg(m, b) for m, b in main)
    for isot, tpsot, tnsot, segs, data in parts:
        head = b"".join(seg(m, b) for m, b in segs)
        out += b"\xff\x90" + struct.pack(">HHIBB", 10, isot, 12 + len(head) + 2 + len(data), tpsot, tnsot)
        out += head + b"\xff\x93" + data
    return out + b"\xff\xd9"


def packet_lengths(segs) -> list:
    """The packet lengths of a tile-part header's PLT markers."""
    out, v = [], 0
    for m, body in segs:
        if m == b"\xff\x58":
            for byte in body[1:]:
                v = (v << 7) | (byte & 0x7F)
                if not byte & 0x80:
                    out.append(v)
                    v = 0
    return out


def packets(part) -> list:
    lengths = packet_lengths(part[3])
    data, out, pos = part[4], [], 0
    for n in lengths:
        out.append(data[pos:pos + n])
        pos += n
    assert pos == len(data)
    return out


def no_plt(segs) -> list:
    return [(m, b) for m, b in segs if m != b"\xff\x58"]


def tile_parts(cs: bytes, n: int, counted: bool = True) -> bytes:
    """Each tile's packets cut into ``n`` tile-parts (TNsot = n, or 0)."""
    main, parts = split(cs)
    out = []
    for part in parts:
        pk = packets(part)
        for t, idx in enumerate(np.array_split(np.arange(len(pk)), n)):
            out.append((part[0], t, n if counted else 0, no_plt(part[3]) if t == 0 else [], b"".join(pk[i] for i in idx)))
    return join(main, out)


def with_sop(cs: bytes) -> bytes:
    """An SOP marker before every packet, announced in COD's Scod."""
    main, parts = split(cs)
    main = [(m, bytes([b[0] | 2]) + b[1:] if m == b"\xff\x52" else b) for m, b in main]
    out, k = [], 0
    for part in parts:
        body = b""
        for p in packets(part):
            body += b"\xff\x91\x00\x04" + struct.pack(">H", k & 0xFFFF) + p
            k += 1
        out.append((part[0], part[1], part[2], no_plt(part[3]), body))
    return join(main, out)


def packed_headers(cs: bytes, ppm: bool, pieces: int = 1) -> bytes:
    """The packet headers of a codestream with EPH and PLT markers moved
    out of the data into PPT markers (each tile-part's, in ``pieces``
    segments given last first) or into PPM markers of the main header (an
    Nppm and the headers per tile-part, cut into ``pieces`` segments). A
    header ends at its EPH: the bit stuffing after 0xFF keeps 0xFF92 out of
    headers and the MQ coder keeps it out of code-block data."""
    main, parts = split(cs)
    out, stream, zppt = [], b"", {}
    for part in parts:
        heads, bodies = [], []
        for p in packets(part):
            sop = 6 if p[:2] == b"\xff\x91" else 0  # an SOP marker stays in the data
            end = p.index(b"\xff\x92") + 2
            heads.append(p[sop:end])
            bodies.append(p[:sop] + p[end:])
        heads = b"".join(heads)
        segs = no_plt(part[3])
        if ppm:
            stream += struct.pack(">I", len(heads)) + heads
        else:  # Zppt counts on over a tile's tile-parts
            step, z = -(-len(heads) // pieces), zppt.get(part[0], 0)
            segs = segs + [(b"\xff\x61", bytes([z + k]) + heads[k * step:(k + 1) * step])
                           for k in range(pieces)][::-1]
            zppt[part[0]] = z + pieces
        out.append((part[0], part[1], part[2], segs, b"".join(bodies)))
    if ppm:
        step = -(-len(stream) // pieces)
        main = main + [(b"\xff\x60", bytes([k]) + stream[k * step:(k + 1) * step]) for k in range(pieces)]
    return join(main, out)


def with_poc(cs: bytes, layers: int, resolutions: int, comps: int) -> bytes:
    """A single-tile, single-precinct LRCP codestream reordered by a POC
    marker: resolutions 0-1 in RLCP, then the rest in CPRL (each packet
    identified by its (layer, resolution, component) in LRCP order)."""
    main, parts = split(cs)
    assert len(parts) == 1
    pk = packets(parts[0])
    lrcp = [(l, r, c) for l in range(layers) for r in range(resolutions) for c in range(comps)]
    assert len(pk) == len(lrcp)
    order = [(l, r, c) for r in range(2) for l in range(layers) for c in range(comps)]
    order += [(l, r, c) for c in range(comps) for r in range(2, resolutions) for l in range(layers)]
    by_id = dict(zip(lrcp, pk))
    poc = struct.pack(">BBHBBB", 0, 0, layers, 2, comps, 1) + struct.pack(">BBHBBB", 2, 0, layers, resolutions, comps, 4)
    main = main + [(b"\xff\x5f", poc)]
    isot, tpsot, tnsot, segs, _ = parts[0]
    return join(main, [(isot, tpsot, tnsot, no_plt(segs), b"".join(by_id[k] for k in order))])


# ---------------------------------------------------------------------------
# The fixtures
# ---------------------------------------------------------------------------


def capture() -> dict:
    """The committed capture's 5 maintenance frames as cv2 writes JP2 (the
    images and the CV_8UC4 depth blobs, lossless on these frames) and as
    PIL writes the images with the 9/7 wavelet and the ICT at rate 12."""
    conn = sqlite3.connect(CAPTURE_DB)
    out = {}
    for i, image, depth in conn.execute("SELECT id, image, depth FROM Data ORDER BY id"):
        bgr = cv2.imdecode(np.frombuffer(image, np.uint8), cv2.IMREAD_COLOR)
        bgra = cv2.imdecode(np.frombuffer(depth, np.uint8), cv2.IMREAD_UNCHANGED)
        out[f"capture_maintenance_{i}_lossless.jp2"] = cv2.imencode(".jp2", bgr)[1].tobytes()
        out[f"capture_maintenance_{i}_irreversible_q12.jp2"] = pil(bgr[..., ::-1].copy(), irreversible=True, mct=1,
                                                                   quality_mode="rates", quality_layers=[12])
        out[f"capture_maintenance_{i}_depth.jp2"] = cv2.imencode(".jp2", bgra)[1].tobytes()
    conn.close()
    return out


def fixtures() -> dict:
    out = {}
    rgb = picture(37, 53, 3, 1)
    rgba = picture(37, 53, 4, 2)
    gray = picture(37, 53, 1, 3)
    # cv2's own writes: 5/3, no MCT, 6 resolutions, truncated at low rates
    for kind, img in (("bgr", picture(45, 67, 3, 4)), ("bgra", picture(45, 67, 4, 5)), ("gray", picture(45, 67, 1, 6)),
                      ("gray16", (picture(45, 67, 1, 7).astype(np.uint16) * 257))):
        for c in (10, 100, 1000):
            out[f"cv2_{kind}_c{c}.jp2"] = cv2.imencode(".jp2", img, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, c])[1].tobytes()
    # PIL: wavelets and transforms, orders, resolutions, blocks, precincts, tiles, layers
    for irr in (False, True):
        for mct in (0, 1):
            out[f"pil_{'97' if irr else '53'}_mct{mct}.jp2"] = pil(rgb, irreversible=irr, mct=mct)
    for order in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        for irr in (False, True):
            out[f"pil_{order.lower()}_{'97' if irr else '53'}.jp2"] = pil(
                rgb, irreversible=irr, progression=order, precinct_size=(32, 32), codeblock_size=(8, 8),
                num_resolutions=4, quality_mode="rates", quality_layers=[40, 12, 4])
    for n in range(1, 7):
        out[f"pil_resolutions_{n}.jp2"] = pil(rgb, num_resolutions=n, irreversible=n % 2 == 0)
    for cb in ((4, 4), (4, 64), (64, 4), (16, 32), (64, 64)):
        out[f"pil_codeblock_{cb[0]}x{cb[1]}.jp2"] = pil(rgb, codeblock_size=cb)
    for p, n in ((8, 2), (16, 3), (32, 4), (128, 6)):
        out[f"pil_precinct_{p}.jp2"] = pil(rgb, precinct_size=(p, p), codeblock_size=(4, 4), progression="RPCL",
                                           num_resolutions=n)
    out["refused_precinct_16_6_resolutions.jp2"] = pil(rgb, precinct_size=(16, 16))
    for ts, irr in (((16, 16), False), ((17, 23), False), ((17, 23), True), ((9, 40), True), ((53, 5), False)):
        out[f"pil_tiles_{ts[0]}x{ts[1]}_{'97' if irr else '53'}.jp2"] = pil(rgb, tile_size=ts, irreversible=irr,
                                                                             num_resolutions=3)
    for layers in ([20], [60, 20, 5], [80, 40, 20, 10, 5]):
        out[f"pil_layers_{len(layers)}_97.jp2"] = pil(rgb, irreversible=True, quality_mode="rates",
                                                      quality_layers=layers)
    out["pil_layers_dB_53.jp2"] = pil(rgb, quality_mode="dB", quality_layers=[20, 30, 40])
    out["pil_raw_rgb.j2k"] = pil(rgb, no_jp2=True)
    out["pil_raw_gray.j2k"] = pil(gray, no_jp2=True)
    out["pil_raw_rgba_97.j2k"] = pil(rgba, no_jp2=True, irreversible=True)
    out["pil_plt.jp2"] = pil(rgb, plt=True)
    out["pil_gray.jp2"] = pil(gray)
    out["pil_gray_alpha.jp2"] = pil(np.dstack([gray, picture(37, 53, 1, 8)]))
    out["pil_rgba_97.jp2"] = pil(rgba, irreversible=True)
    out["pil_gray16.jp2"] = pil(picture(37, 53, 1, 9).astype(np.uint16) * 16)
    out["pil_odd_1x1.jp2"] = pil(picture(1, 1, 3, 10), num_resolutions=1)
    out["pil_odd_3x97.jp2"] = pil(picture(3, 97, 3, 11), num_resolutions=2, irreversible=True)
    out["pil_odd_61x2.jp2"] = pil(picture(61, 2, 3, 12), num_resolutions=2)
    # codestream surgery from PLT's packet lengths
    layered = pil(rgb, plt=True, quality_mode="rates", quality_layers=[40, 10], no_jp2=True)
    out["sop_markers.j2k"] = with_sop(layered)
    out["tile_parts_3.j2k"] = tile_parts(layered, 3)
    out["tile_parts_3_uncounted.j2k"] = tile_parts(layered, 3, counted=False)
    tiled = pil(rgb, plt=True, tile_size=(20, 20), no_jp2=True, irreversible=True)
    out["tiles_tile_parts_2_97.j2k"] = tile_parts(tiled, 2)
    out["tiles_sop_97.j2k"] = with_sop(tiled)
    out["poc_rlcp_cprl.j2k"] = with_poc(layered, 2, 6, 3)
    # JP2 boxes
    cs_rgb, cs_gray, cs_rgba = pil(rgb, no_jp2=True, mct=0), pil(gray, no_jp2=True), pil(rgba, no_jp2=True)
    cdef = lambda rows: box(b"cdef", struct.pack(">H", len(rows)) + b"".join(struct.pack(">HHH", *r) for r in rows))  # noqa: E731
    for tag, rows in (("bgr", [(0, 0, 3), (1, 0, 2), (2, 0, 1)]), ("gbr", [(0, 0, 2), (1, 0, 3), (2, 0, 1)]),
                      ("listed_backwards", [(2, 0, 3), (1, 0, 2), (0, 0, 1)]), ("incomplete", [(0, 0, 1), (1, 0, 2)]),
                      ("bad_assoc", [(0, 0, 1), (1, 0, 2), (2, 0, 4)])):
        out[f"box_cdef_{tag}.jp2"] = jp2(cs_rgb, 3, 37, 53, extra=cdef(rows))
    out["box_cdef_alpha_first.jp2"] = jp2(cs_rgba, 4, 37, 53, extra=cdef([(3, 0, 1), (1, 0, 2), (2, 0, 3), (0, 1, 0)]))
    pal = np.random.default_rng(13).integers(0, 256, (256, 3))

    def pclr(sizes=(7, 7, 7), table=pal):
        body = struct.pack(">HB", len(table), len(sizes)) + bytes(sizes)
        for row in table:
            for size, v in zip(sizes, row):
                n = min(((size & 0x7F) + 8) >> 3, 4)
                body += (int(v) & ((1 << 8 * n) - 1)).to_bytes(n, "big")
        return box(b"pclr", body)

    cmap = lambda rows: box(b"cmap", b"".join(struct.pack(">HBB", *r) for r in rows))  # noqa: E731
    direct = [(0, 1, 0), (0, 1, 1), (0, 1, 2)]
    out["box_pclr.jp2"] = jp2(cs_gray, 1, 37, 53, colour=colr(16), extra=pclr() + cmap(direct))
    out["box_pclr_100_entries.jp2"] = jp2(cs_gray, 1, 37, 53, colour=colr(16), extra=pclr(table=pal[:100]) + cmap(direct))
    out["box_pclr_16bit.jp2"] = jp2(cs_gray, 1, 37, 53, colour=colr(16),
                                    extra=pclr((15, 15, 15), np.random.default_rng(14).integers(0, 65536, (256, 3)))
                                    + cmap(direct))
    out["box_pclr_weird_cmap.jp2"] = jp2(cs_gray, 1, 37, 53, colour=colr(16), extra=pclr() + cmap([(0, 0, 0)] * 3))
    out["box_pclr_no_cmap.jp2"] = jp2(cs_gray, 1, 37, 53, colour=colr(16), extra=pclr())
    out["box_pclr_cdef.jp2"] = jp2(cs_gray, 1, 37, 53, colour=colr(16),
                                   extra=pclr() + cmap(direct) + cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)]))
    out["box_cmap_before_pclr.jp2"] = jp2(cs_gray, 1, 37, 53, colour=colr(16), extra=cmap(direct) + pclr())
    for name, colour in (("gray", colr(17)), ("sycc", colr(18)), ("cmyk", colr(12)), ("esycc", colr(24)),
                         ("cielab", colr(14)), ("unknown_99", colr(99)), ("icc", box(b"colr", b"\x02\x00\x00" + bytes(64))),
                         ("meth3", box(b"colr", b"\x03\x00\x00\x00\x00\x00\x10")), ("none", b""),
                         ("two_gray_first", colr(17) + colr(16))):
        out[f"box_colr_{name}.jp2"] = jp2(cs_rgb, 3, 37, 53, colour=colour)
    out["box_colr_srgb_on_gray.jp2"] = jp2(cs_gray, 1, 37, 53, colour=colr(16))
    out["box_colr_sycc_rgba.jp2"] = jp2(cs_rgba, 4, 37, 53, colour=colr(18))
    out["box_res.jp2"] = jp2(cs_rgb, 3, 37, 53, extra=box(b"res ", box(b"resc", struct.pack(">HHHHBB", 1, 1, 1, 1, 0, 0))))
    out["box_bpcc.jp2"] = jp2(cs_rgb, 3, 37, 53, bpc=255, extra=box(b"bpcc", b"\x07\x07\x07"))
    out["box_xl_jp2c.jp2"] = (jp2(cs_rgb, 3, 37, 53).split(box(b"jp2c", cs_rgb))[0] + struct.pack(">I", 1) + b"jp2c"
                              + struct.pack(">Q", 16 + len(cs_rgb)) + cs_rgb)
    out["box_jp2c_length_0.jp2"] = jp2(cs_rgb, 3, 37, 53).replace(struct.pack(">I", 8 + len(cs_rgb)) + b"jp2c",
                                                                    b"\0\0\0\0jp2c")
    out["box_trailing_xml.jp2"] = jp2(cs_rgb, 3, 37, 53, post=box(b"xml ", b"<a/>"))
    head = box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", 37, 53, 3, 7, 7, 0, 0))
    out["box_uuid_before_jp2h.jp2"] = head + box(b"uuid", bytes(20)) + box(b"jp2h", ihdr + colr(16)) + box(b"jp2c", cs_rgb)
    out["box_colr_after_jp2h.jp2"] = head + box(b"jp2h", ihdr) + colr(17) + box(b"jp2c", cs_rgb)
    # SIZ edits: precision, sign, subsampling
    cs97 = pil(rgb, no_jp2=True, irreversible=True)
    for tag, ssiz in (("8bit_as_9", 8), ("8bit_as_12", 11), ("8bit_as_16", 15), ("8bit_as_20", 19),
                      ("mixed_8_8_12", [7, 7, 11]), ("mixed_4_8_8", [3, 7, 7])):
        out[f"siz_{tag}.jp2"] = jp2(siz_edit(cs_rgb, ssiz), 3, 37, 53)
        out[f"siz_{tag}_97.jp2"] = jp2(siz_edit(cs97, ssiz), 3, 37, 53)
    out["siz_gray_12bit.jp2"] = jp2(siz_edit(cs_gray, 11), 1, 37, 53)
    out["siz_sycc_12bit.jp2"] = jp2(siz_edit(cs_rgb, 11), 3, 37, 53, colour=colr(18))
    # refusals
    out["refused_siz_7bit.jp2"] = jp2(siz_edit(cs_gray, 6), 1, 37, 53)
    out["refused_siz_signed.jp2"] = jp2(siz_edit(cs_rgb, [7, 7, 0x87]), 3, 37, 53)
    out["refused_siz_subsampled.jp2"] = jp2(siz_edit(cs_rgb, dx=[1, 2, 2]), 3, 37, 53)
    out["refused_offset.jp2"] = pil(rgb, offset=(3, 5), tile_offset=(1, 2), tile_size=(16, 16))
    out["refused_ihdr_size.jp2"] = jp2(cs_rgb, 3, 38, 53)
    out["refused_no_jp2h.jp2"] = head + box(b"jp2c", cs_rgb)
    out["refused_ftyp_missing.jp2"] = box(b"jP  ", b"\r\n\x87\n") + box(b"jp2h", ihdr + colr(16)) + box(b"jp2c", cs_rgb)
    cut = cv2.imencode(".jp2", picture(45, 67, 3, 4))[1].tobytes()
    for at in (40, 120, len(cut) // 2, len(cut) - 2):
        out[f"refused_cut_{at}.jp2"] = cut[:at]
    out["refused_raw_cut.j2k"] = out["pil_raw_rgb.j2k"][:-1]
    return out
