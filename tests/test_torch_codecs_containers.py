"""The port's codecs on the image containers cv2 reads besides baseline JPEG
and PNG, against cv2 5.0 as the reference calls it (``cv2.imread`` and
``cv2.imdecode`` under IMREAD_COLOR and IMREAD_UNCHANGED), byte for byte:
shape, dtype and every byte, or the same refusal (cv2's None).

- Lossless JPEG (SOF3): predictors 1-7, point transforms, restarts, 1, 3
  and 4 components, sampling factors, one scan per component, precision
  2-8; the files cut short (``imread`` pads them, ``imdecode`` refuses);
  cv2's refusals (12 and 16 bits, YCbCr and YCCK lossless, gray lossless
  under IMREAD_COLOR, SOF11, hierarchical frames, bad scan parameters).
- PNM (P1-P6, text and binary, maxvals), PAM (tuple types and cv2's
  refusals), PFM (both byte orders, scales, NaN and inf).
- BMP: 1/4/8/15/16/24/32 bpp, palettes, RLE4 and RLE8 (random streams),
  bit fields, OS/2 and V4/V5 headers, top-down rows.
- TIFF: none, LZW, Deflate and PackBits; strips, tiles, planes; the
  horizontal and floating point predictors; gray 1/8/16, RGB and RGBA 8/16
  with either alpha, palettes of 1, 4 and 8 bits, MinIsWhite, CMYK, signed
  and float samples; the Orientation tag. BigTIFF, CCITT, JPEG, YCbCr,
  CIELab and 10/12/14-bit samples are ``test_torch_codecs_tiff.py``'s, as
  are the compressions cv2's libtiff is built without (LZMA, ZSTD, WebP,
  LERC, JBIG, old JPEG, PixarLog), which both refuse.
- Sun raster, Radiance HDR and GIF.
- The committed fixtures (``tests/fixtures/codecs/containers``) and their
  digests, which ``chip_smoke.py`` holds the port to on the card host.
- The JAX package's ``load_rgb_image``, ``load_depth_image``,
  ``ImageExtractor`` and ``load_scan`` against the port's on frames and
  blobs in these containers, and the two-scan CLI on a TIFF/BMP capture.

Where cv2's own output is not defined (the part of a row of an alpha PAM it
leaves unwritten under IMREAD_COLOR, the planes of a planar TIFF read
through its raw path) the tests hold what is defined."""

import glob
import hashlib
import json
import os
import shutil
import sqlite3
import struct
import sys

import cv2
import numpy as np
import pytest

from tpu3dlm_torch.data import codecs
from tpu3dlm_torch.data.dataset import load_depth_image, load_rgb_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "codecs")
CONT = os.path.join(FIX, "containers")
CAPTURE = os.path.join(REPO, "tests", "fixtures", "torch_project", "data")
sys.path.insert(0, FIX)

import make_containers as mk  # noqa: E402

FIXTURES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONT, "*")) if not p.endswith(".json"))
FLAGS = {"color": cv2.IMREAD_COLOR, "unchanged": cv2.IMREAD_UNCHANGED}


def digest(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(), "shape": list(a.shape), "dtype": str(a.dtype)}


def port(kind: str, src):
    """The port's decode of bytes (``src`` bytes) or a file (a path) as cv2
    lays it out (BGR order), or None where it refuses."""
    file = isinstance(src, str)
    fn = {("color", False): codecs.decode_image, ("color", True): codecs.read_image,
          ("unchanged", False): codecs.decode_unchanged, ("unchanged", True): codecs.read_unchanged}[kind, file]
    try:
        img = fn(src)
    except ValueError:
        return None
    return np.ascontiguousarray(img[..., ::-1]) if kind == "color" else img


def reference(kind: str, src):
    if isinstance(src, str):
        return cv2.imread(src, FLAGS[kind])
    return cv2.imdecode(np.frombuffer(src, np.uint8), FLAGS[kind])


def assert_same(got, want, what, columns=None):
    if want is None:
        assert got is None, f"{what}: cv2 refuses, the port gives {got.shape} {got.dtype}"
        return
    assert got is not None, f"{what}: cv2 gives {want.shape} {want.dtype}, the port refuses"
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, got.dtype, want.shape, want.dtype)
    if columns is not None:
        got, want = got[:, :columns], want[:, :columns]
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def hold(data: bytes, tmp_path, what="", columns=None, skip=()):
    """Both flags, both forms: the port's array equals cv2's or both refuse.
    ``columns`` limits IMREAD_COLOR to the columns cv2 writes; ``skip``
    names (kind, form) pairs whose cv2 output is not defined."""
    path = str(tmp_path / "case.bin")
    with open(path, "wb") as f:
        f.write(data)
    for kind in FLAGS:
        for src, form in ((data, "bytes"), (path, "file")):
            if (kind, form) in skip:
                continue
            want = reference(kind, src)
            if kind == "color" and want is not None and want.ndim == 2:
                # imdecode of a gray PFM: one channel, which the reference's
                # cvtColor(BGR2RGB) refuses, as the port's decode_image does
                with pytest.raises(ValueError, match="one channel"):
                    codecs.decode_image(src)
                continue
            assert_same(port(kind, src), want, (what, kind, form), columns if kind == "color" else None)


def hold_all(cases, tmp_path, **kw):
    for what, data in cases:
        hold(data, tmp_path, what, **kw)


def rng_of(*seed):
    return np.random.default_rng(list(seed))


# ---------------------------------------------------------------------------
# The committed fixtures
# ---------------------------------------------------------------------------


def test_container_fixture_count():
    assert len(FIXTURES) == 95


@pytest.mark.parametrize("name", FIXTURES)
def test_container_fixture_matches_cv2(name, tmp_path):
    with open(os.path.join(CONT, name), "rb") as f:
        data = f.read()
    hold(data, tmp_path, name)


def test_container_digests_match_cv2_and_the_port():
    """``containers/digests.json`` (what ``chip_smoke.py`` holds the port to
    on the card host) is cv2's ``imread`` of every fixture, ``null`` where
    it returns None, and the port's file form gives it."""
    with open(os.path.join(CONT, "digests.json")) as f:
        digests = json.load(f)
    assert sorted(digests) == FIXTURES
    assert sum(v[k] is None for v in digests.values() for k in v) >= 40
    for name, want in digests.items():
        path = os.path.join(CONT, name)
        for kind in FLAGS:
            ref = reference(kind, path)
            assert want[kind] == (None if ref is None else digest(ref)), (name, kind)
            got = port(kind, path)
            assert (None if got is None else digest(got)) == want[kind], (name, kind)


def test_fixtures_are_what_the_generator_writes():
    made = mk.fixtures()
    assert sorted(made) == FIXTURES
    for name in ("ll_rgb_p4.jpg", "tiff_rgb_deflate_pred2.tif", "bmp_rle4_delta.bmp", "hdr_rle.hdr"):
        with open(os.path.join(CONT, name), "rb") as f:
            assert f.read() == made[name], name


# ---------------------------------------------------------------------------
# Lossless JPEG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("nc", [1, 3, 4])
def test_lossless_jpeg_predictors_match_cv2(nc, predictor, tmp_path):
    rng = rng_of(nc, predictor)
    cases = []
    for h, w in ((13, 17), (1, 1), (8, 3), (31, 9)):
        x = rng.integers(0, 256, (h, w, nc)).astype(np.uint8)
        x[: h // 2] = np.cumsum(x[: h // 2], 1).astype(np.uint8)
        for pt in (0, 2):
            for restart in (0, 1, 3):
                cases.append(((h, w, pt, restart), mk.lossless_jpeg(x if nc > 1 else x[..., 0], predictor, pt=pt,
                                                                     restart_rows=restart)))
    hold_all(cases, tmp_path)


LOSSLESS_LAYOUTS = {
    "rgb_ids": dict(ids=[82, 71, 66]), "other_ids": dict(ids=[5, 6, 7]), "adobe_rgb": dict(adobe=0),
    "scans": dict(interleaved=False), "scans_restart": dict(interleaved=False, restart_rows=2),
    "h2v2": dict(sampling=[(2, 2), (1, 1), (1, 1)]), "mixed": dict(sampling=[(1, 1), (2, 1), (1, 2)], restart_rows=2),
    "h4v1": dict(sampling=[(4, 1), (1, 1), (2, 1)]), "h3v1_fractional": dict(sampling=[(3, 1), (1, 1), (2, 1)]),
    "h2v2_scans": dict(sampling=[(2, 2), (1, 1), (1, 1)], interleaved=False),
    "precision7": dict(precision=7), "precision2": dict(precision=2),
    "refused_jfif_ycc": dict(jfif=True), "refused_adobe_ycc": dict(adobe=1), "refused_12bit": dict(precision=12),
    "refused_16bit": dict(precision=16), "refused_sof11": dict(marker=0xCB), "refused_sof7": dict(marker=0xC7),
}


@pytest.mark.parametrize("layout", list(LOSSLESS_LAYOUTS))
def test_lossless_jpeg_layouts_match_cv2(layout, tmp_path):
    kw = LOSSLESS_LAYOUTS[layout]
    rng = rng_of(len(layout))
    precision = kw.get("precision", 8)
    cases = []
    for h, w in ((13, 17), (6, 5), (2, 33)):
        x = rng.integers(0, 1 << min(precision, 8), (h, w, 3)).astype(np.int64) << max(precision - 8, 0)
        for predictor in (1, 5):
            cases.append(((h, w, predictor), mk.lossless_jpeg(x, predictor, **kw)))
    if layout == "scans":
        x4 = rng.integers(0, 256, (9, 7, 4))
        cases += [("cmyk", mk.lossless_jpeg(x4, 3, **kw)), ("ycck", mk.lossless_jpeg(x4, 3, adobe=2, **kw))]
    hold_all(cases, tmp_path)
    if layout.startswith("refused"):
        assert all(reference("unchanged", b) is None for _, b in cases)


def test_lossless_jpeg_scan_parameters_cv2_refuses(tmp_path):
    base = bytearray(mk.lossless_jpeg(rng_of(3).integers(0, 256, (9, 11)).astype(np.uint8), 1))
    sos = base.index(b"\xff\xda")
    cases = []
    for name, at, value in (("predictor 0", 7, 0), ("predictor 8", 7, 8), ("Se 1", 8, 1), ("Ah 1", 9, 0x10),
                            ("Al 8", 9, 8), ("Al 7", 9, 7), ("Al 1", 9, 1)):
        data = bytearray(base)
        data[sos + at] = value
        cases.append((name, bytes(data)))
    restart = mk.lossless_jpeg(rng_of(4).integers(0, 256, (9, 11)).astype(np.uint8), 1, restart_rows=2)
    cases.append(("restart of 7 MCUs in rows of 11", restart.replace(b"\xff\xdd\x00\x04\x00\x16", b"\xff\xdd\x00\x04\x00\x07")))
    hold_all(cases, tmp_path)
    with pytest.raises(ValueError, match=r"lossless JPEG \(SOF3\) with predictor 8"):
        codecs.decode_unchanged(cases[1][1])


@pytest.mark.parametrize("layout", ["interleaved", "restarts", "scans", "h2v2_restarts"])
def test_lossless_jpeg_cut_files_pad_as_imread_and_fail_as_imdecode(layout, tmp_path):
    """``imread`` of a cut lossless file decodes it (libjpeg's fake EOI:
    the rows after the data runs out are 1 << (P - 1), a component with no
    scan fails); ``imdecode`` of the same bytes refuses."""
    kw = {"interleaved": {}, "restarts": dict(restart_rows=2), "scans": dict(interleaved=False),
          "h2v2_restarts": dict(sampling=[(2, 2), (1, 1), (1, 1)], restart_rows=1)}[layout]
    rng = rng_of(len(layout))
    padded = 0
    for nc in (1, 3):
        if nc == 1 and "sampling" in kw:
            continue
        x = rng.integers(0, 256, (15, 13, nc)).astype(np.uint8)
        full = mk.lossless_jpeg(x if nc > 1 else x[..., 0], 4, **kw)
        for cut in range(2, len(full), max(1, len(full) // 25)):
            part = full[:cut]
            hold(part, tmp_path, (nc, cut))
            padded += reference("unchanged", str(tmp_path / "case.bin")) is not None
    assert padded >= 10


# ---------------------------------------------------------------------------
# PNM, PAM, PFM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("maxval", [1, 7, 100, 255, 256, 1000, 65535])
def test_pnm_maxvals_match_cv2(maxval, tmp_path):
    rng = rng_of(maxval)
    cases = []
    for h, w in ((3, 5), (1, 1), (7, 9)):
        for kind in "25":
            v = rng.integers(0, maxval + 1 + maxval // 3, (h, w))
            body = (" ".join(map(str, v.reshape(-1))).encode() + b"\n" if kind == "2" else
                    np.minimum(v, 65535 if maxval > 255 else 255).astype(">u2" if maxval > 255 else np.uint8).tobytes())
            cases.append((f"P{kind}", b"P%s\n# a comment\n%d %d\n%d\n" % (kind.encode(), w, h, maxval) + body))
            v3 = rng.integers(0, maxval + 1, (h, w, 3))
            body = (" ".join(map(str, v3.reshape(-1))).encode() + b"\n" if kind == "2" else
                    v3.astype(">u2" if maxval > 255 else np.uint8).tobytes())
            cases.append((f"P{int(kind) + 1}", b"P%d\n%d %d %d\n" % (int(kind) + 1, w, h, maxval) + body))
    hold_all(cases, tmp_path)


def test_pnm_written_by_cv2_and_bitmaps_match_cv2(tmp_path):
    rng = rng_of(5)
    cases = []
    for h, w in ((3, 5), (1, 1), (7, 9), (4, 16)):
        g, c = rng.integers(0, 256, (h, w), dtype=np.uint8), rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for ext, img in ((".pgm", g), (".ppm", c), (".pbm", g), (".pgm", g.astype(np.uint16) * 257),
                         (".ppm", c.astype(np.uint16) * 251), (".pam", g), (".pam", c)):
            for binary in (1, 0):
                ok, b = cv2.imencode(ext, img, [cv2.IMWRITE_PXM_BINARY, binary])
                if ok:
                    cases.append((ext, b.tobytes()))
        bits = rng.integers(0, 2, (h, w))
        cases += [("P1 spaced", b"P1\n%d %d\n" % (w, h) + " ".join(map(str, bits.reshape(-1))).encode() + b"\n"),
                  ("P1 packed", b"P1\n%d %d\n" % (w, h) + "".join(map(str, bits.reshape(-1))).encode()),
                  ("P4", b"P4 %d %d\n" % (w, h) + np.packbits(bits, axis=1).tobytes()),
                  ("P4 cut", b"P4 %d %d\n" % (w, h) + np.packbits(bits, axis=1).tobytes()[:-1])]
    cases += [("no whitespace", b"P61 1 255\n\x01\x02\x03"), ("cut", b"P6\n2 2\n255\n\x01\x02\x03"),
              ("no trailing byte", b"P2\n3 1\n100\n0 50 100"), ("junk", b"P2\n3 1\n100\n0 x 100\n"),
              ("maxval 0", b"P5\n1 1\n0\n\x00"), ("maxval 70000", b"P5\n1 1\n70000\n\x00\x00")]
    hold_all(cases, tmp_path)


PAM_TYPES = [(1, b"BLACKANDWHITE"), (1, b"GRAYSCALE"), (2, b"GRAYSCALE_ALPHA"), (3, b"RGB"), (4, b"RGB_ALPHA"),
             (1, None), (2, None), (3, None), (4, None), (3, b"GRAYSCALE"), (1, b"RGB"), (1, b"FOO")]


@pytest.mark.parametrize("depth,tupltype", PAM_TYPES)
def test_pam_tuple_types_match_cv2(depth, tupltype, tmp_path):
    """Under IMREAD_COLOR cv2 writes only the first ceil(W / depth) pixels
    of each row of an alpha PAM and leaves the rest as allocated: those
    columns are held, the rest is not defined."""
    rng = rng_of(depth, len(tupltype or b""))
    for maxval in (1, 15, 255, 4095, 65535):
        for h, w in ((3, 10), (2, 7), (1, 1)):
            v = rng.integers(0, 256 if maxval < 256 else 65536, (h, w, depth))
            hdr = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (w, h, depth, maxval)
            hdr += (b"TUPLTYPE " + tupltype + b"\n" if tupltype else b"") + b"ENDHDR\n"
            data = hdr + v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
            hold(data, tmp_path, (maxval, h, w), columns=-(-w // depth) if depth in (2, 4) else None)


def test_pam_headers_match_cv2(tmp_path):
    body = b"HEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x01\x02"
    cases = [(v, b"P7\nWIDTH " + v + b"\n" + body) for v in (b"0x2", b"2abc", b"02", b" 2", b"2 ", b"+2", b"2.0",
                                                               b"2 3", b"00002")]
    cases += [(sep, b"P7" + sep + b"WIDTH 2\n" + body) for sep in (b"\n", b" ", b"\r", b"\r\n", b"\t", b"x", b"")]
    cases += [("ENDHDR and a space", b"P7\nWIDTH 2\n" + body.replace(b"ENDHDR\n", b"ENDHDR \n")),
              ("lower case", b"P7\nwidth 2\n" + body), ("twice", b"P7\nWIDTH 2\nWIDTH 2\n" + body),
              ("comment", b"P7\n# c\nWIDTH 2\n" + body.replace(b"DEPTH 1\n", b"DEPTH 1\nTUPLTYPE GRAYSCALE  \n"))]
    hold_all(cases, tmp_path)


def test_pfm_matches_cv2(tmp_path):
    rng = rng_of(7)
    cases = []
    for h, w in ((3, 5), (1, 1), (7, 9)):
        f = (rng.standard_normal((h, w, 3)) * 100).astype(np.float32)
        f[0, 0, 0], f[-1, -1, -1], f[0, -1, 0], f[-1, 0, 0] = np.nan, np.inf, 2.5, 3e10
        for scale in (b"-1", b"1", b"-3.5", b"0.25", b"-1.0e0"):
            order = "<f4" if scale.startswith(b"-") else ">f4"
            cases.append((("PF", scale), b"PF\n%d %d\n%s\n" % (w, h, scale) + f[::-1].astype(order).tobytes()))
            cases.append((("Pf", scale), b"Pf\n%d %d\n%s\n" % (w, h, scale) + f[::-1, :, 0].astype(order).tobytes()))
        cases.append(("cv2", cv2.imencode(".pfm", f)[1].tobytes()))
        cases.append(("cv2 gray", cv2.imencode(".pfm", f[..., 0])[1].tobytes()))
    cases += [("CR LF", b"PF\r\n1 1\n-1\n" + b"\x00" * 12), ("one line", b"Pf\n1 1 -1\n" + b"\x00" * 4),
              ("cut", b"Pf\n2 2\n-1\n" + b"\x00" * 15)]
    hold_all(cases, tmp_path)
    assert any(d[:2] == b"Pf" and reference("color", d) is not None and reference("color", d).ndim == 2
               for _, d in cases)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bpp", [1, 4, 8])
def test_bmp_palettes_and_headers_match_cv2(bpp, tmp_path):
    rng = rng_of(bpp)
    n = 1 << bpp
    cases = []
    for h, w in ((3, 5), (1, 1), (7, 9), (4, 8)):
        for gray in (False, True):
            for clr in (None, n // 2 or 1, 0):
                pal = [(v, v, v) if gray else tuple(rng.integers(0, 256, 3)) for v in rng.integers(0, 256, clr or n)]
                idx = rng.integers(0, len(pal), (h, w))
                for header in (40, 12, 64, 108, 124):
                    if header == 12 and clr:
                        continue
                    for top_down in ((False, True) if header != 12 else (False,)):
                        full = pal if header != 12 else pal + [(0, 0, 0)] * (n - len(pal))
                        cases.append(((h, w, gray, clr, header, top_down),
                                      mk.bmp(mk.bmp_rows(idx, bpp), w, h, bpp, palette=full, header=header,
                                             clrused=clr, top_down=top_down)))
    hold_all(cases, tmp_path)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("seed", range(5))
def test_bmp_rle_streams_match_cv2(bits, seed, tmp_path):
    """Random RLE streams (encoded and absolute runs, ends of line, deltas,
    an end of bitmap or none, runs past a line's end), colour and gray
    palettes: cv2's BmpDecoder walks them its own way (RLE8 skips an end of
    line right after a run that filled the line, RLE4 fills only to the
    line's end on a delta or an end of bitmap)."""
    rng = rng_of(bits, seed)
    cases = []
    for trial in range(60):
        h, w = [(1, 1), (2, 3), (3, 2), (4, 8), (5, 5)][trial % 5]
        s = mk.bmp_rle_random(rng, w, h, bits, ops=int(rng.integers(1, 12)))
        pal = ([tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(1 << bits)] if trial % 3 else
               [(v * (255 // ((1 << bits) - 1)),) * 3 for v in range(1 << bits)])
        cases.append((trial, mk.bmp(s, w, h, bits, 2 if bits == 4 else 1, pal)))
    idx = rng.integers(0, 1 << bits, (9, 26))
    idx[:, :13] = 3
    pal = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(1 << bits)]
    if bits == 8:
        cases.append(("encoder", mk.bmp(mk.bmp_rle8(idx), 26, 9, 8, 1, pal)))
    else:
        cases += [("encoder", mk.bmp(mk.bmp_rle4(idx), 26, 9, 4, 2, pal)),
                  ("encoder with a delta", mk.bmp(mk.bmp_rle4(idx, delta=5), 26, 9, 4, 2, pal))]
    hold_all(cases, tmp_path)
    assert sum(reference("color", b) is not None for _, b in cases) >= 5


def test_bmp_written_by_cv2_pil_and_by_hand_match_cv2(tmp_path):
    import io

    from PIL import Image

    rng = rng_of(9)
    cases = []
    for h, w in ((3, 5), (1, 1), (7, 9), (4, 8)):
        for img in (rng.integers(0, 256, (h, w), dtype=np.uint8), rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                    rng.integers(0, 256, (h, w, 4), dtype=np.uint8)):
            cases.append(("cv2", cv2.imencode(".bmp", img)[1].tobytes()))
        for mode in ("1", "L", "P", "RGB", "RGBA"):
            im = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            im = im.quantize(int(rng.integers(2, 40))) if mode == "P" else im.convert(mode)
            bio = io.BytesIO()
            im.save(bio, "BMP")
            cases.append((f"PIL {mode}", bio.getvalue()))
        for bpp, comp, masks in ((16, 0, None), (16, 3, (0x7C00, 0x3E0, 0x1F)), (16, 3, (0xF800, 0x7E0, 0x1F)),
                                 (16, 3, (0xF00, 0xF0, 0xF)), (24, 0, None), (32, 0, None), (32, 3, (0xFF0000, 0xFF00, 0xFF))):
            raw = rng.integers(0, 256, (h, w * bpp // 8), dtype=np.uint8)
            for header in (40, 108, 12):
                if header == 12 and comp:
                    continue
                cases.append(((bpp, comp, masks, header), mk.bmp(mk.bmp_rows(raw, bpp), w, h, bpp, comp, header=header,
                                                                 masks=masks if header == 40 else None)))
        cases.append(("24 cut", mk.bmp(mk.bmp_rows(rng.integers(0, 256, (h, w * 3)), 24)[:-1], w, h, 24)))
    hold_all(cases, tmp_path)


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

TIFF_LAYOUTS = {"strip": {}, "strips_of_2": dict(rows_per_strip=2), "tiles": dict(tile=(16, 16)),
                "planes": dict(planar=2), "tiles_planes": dict(tile=(16, 32), planar=2), "big_endian": dict(order=">")}


def tiff_kinds(rng, h, w):
    """(samples, photometric, keywords) of every sample layout held."""
    g, c, a = (rng.integers(0, 256, s, dtype=np.uint8) for s in ((h, w), (h, w, 3), (h, w, 4)))
    g16, c16, a16 = (rng.integers(0, 65536, s, dtype=np.uint16) for s in ((h, w), (h, w, 3), (h, w, 4)))
    f, f3 = rng.standard_normal((h, w)).astype(np.float32), rng.standard_normal((h, w, 3)).astype(np.float32)
    return [(g, 1, {}), (g, 0, {}), (c, 2, {}), (a, 2, dict(extra=[2])), (a, 2, dict(extra=[1])), (a, 2, {}),
            (g16, 1, {}), (g16, 0, {}), (c16, 2, {}), (a16, 2, dict(extra=[2])), (a16, 2, dict(extra=[1])),
            (rng.integers(0, 256, (h, w, 2), dtype=np.uint8), 1, dict(extra=[2])),
            (rng.integers(0, 65536, (h, w, 2), dtype=np.uint16), 1, dict(extra=[2])),
            (a, 5, {}), (g.astype(np.int8), 1, dict(sample_format=2)), (g16.astype(np.int16), 1, dict(sample_format=2)),
            (f, 1, dict(sample_format=3)), (f3, 2, dict(sample_format=3)),
            (rng.integers(0, 9, (h, w), dtype=np.int32), 1, dict(sample_format=2)),
            (rng.integers(0, 9, (h, w), dtype=np.uint32), 1, {})]


@pytest.mark.parametrize("layout", list(TIFF_LAYOUTS))
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_tiff_layouts_match_cv2(compression, layout, tmp_path):
    """Every sample layout in strips, tiles and planes, with and without the
    horizontal predictor (libtiff runs it in LZW and Deflate only). A
    planar image of 16 or 32 bits read under IMREAD_UNCHANGED goes through
    cv2's raw path, which reads the planes as if chunky: not defined, so
    the port's array is held to the planes' own samples instead."""
    lay = TIFF_LAYOUTS[layout]
    rng = rng_of(compression, len(layout))
    for h, w in ((5, 7), (1, 1), (37, 21)):
        for img, ph, kw in tiff_kinds(rng, h, w):
            if lay.get("planar") and img.ndim == 2:
                continue
            for predictor in (1, 2):
                data = mk.tiff(img, ph, compression=compression, predictor=predictor, **lay, **kw)
                raw_planes = lay.get("planar") and img.dtype.itemsize > 1 and not (img.ndim == 3 and img.shape[2] == 2)
                skip = {("unchanged", "bytes"), ("unchanged", "file")} if raw_planes else ()
                hold(data, tmp_path, (h, w, img.dtype, img.shape, ph, kw, predictor), skip=skip)
                if raw_planes and (predictor == 1 or compression in (5, 8)):  # libtiff ignores it elsewhere
                    want = img[..., [2, 1, 0, 3][:img.shape[2]]] if ph == 2 else img
                    np.testing.assert_array_equal(codecs.decode_unchanged(data), want)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_tiff_palettes_bilevel_and_float_predictor_match_cv2(compression, tmp_path):
    rng = rng_of(compression)
    cases = []
    for h, w in ((5, 7), (1, 1), (37, 21)):
        for bits in (1, 2, 4, 8):
            v = rng.integers(0, 1 << bits, (h, w), dtype=np.uint8)
            for cmap in (rng.integers(0, 65536, (1 << bits, 3)), rng.integers(0, 256, (1 << bits, 3))):
                cases.append((("palette", bits), mk.tiff(v, 3, compression, bits=bits, colormap=cmap)))
            cases.append((("gray", bits), mk.tiff(v, 1, compression, bits=bits)))
            cases.append((("white", bits), mk.tiff(v, 0, compression, bits=bits, rows_per_strip=3)))
        f = rng.standard_normal((h, w)).astype(np.float32)
        f3 = rng.standard_normal((h, w, 3)).astype(np.float32)
        for lay in ({}, dict(tile=(16, 16))):
            cases.append(("float rgb", mk.tiff(f3, 2, compression, predictor=3, sample_format=3, **lay)))
            cases.append(("float gray", mk.tiff(f, 1, compression, predictor=3, sample_format=3, order=">", **lay)))
    hold_all(cases, tmp_path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_matches_cv2(orientation, tmp_path):
    """cv2 turns a TIFF by its Orientation tag under both flags; the five
    to eight that transpose a non-square image make ``imread`` refuse it
    (its check that the decoder kept the buffer it was given)."""
    rng = rng_of(orientation)
    cases = []
    for h, w in ((10, 6), (8, 8), (1, 2)):
        c = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        c16 = rng.integers(0, 65536, (h, w, 3), dtype=np.uint16)
        f = rng.standard_normal((h, w)).astype(np.float32)
        cases += [("rgb", mk.tiff(c, 2, 8, orientation=orientation, rows_per_strip=3)),
                  ("tiles", mk.tiff(c, 2, 8, orientation=orientation, tile=(16, 16))),
                  ("rgb16", mk.tiff(c16, 2, 5, orientation=orientation)),
                  ("float", mk.tiff(f, 1, 1, orientation=orientation, sample_format=3))]
    hold_all(cases, tmp_path)


def test_tiff_written_by_cv2_and_pil_match_cv2(tmp_path):
    import io

    from PIL import Image

    rng = rng_of(11)
    cases = []
    for h, w in ((5, 7), (1, 1), (60, 45)):
        g, c, a = (rng.integers(0, 256, s, dtype=np.uint8) for s in ((h, w), (h, w, 3), (h, w, 4)))
        g16 = rng.integers(0, 65536, (h, w), dtype=np.uint16)
        f = rng.standard_normal((h, w)).astype(np.float32)
        for img in (g, c, a, g16, rng.integers(0, 65536, (h, w, 3), dtype=np.uint16), f):
            cases.append(("cv2", cv2.imencode(".tiff", img)[1].tobytes()))
        for mode in ("1", "L", "P", "RGB", "RGBA", "I;16", "F", "CMYK", "LA"):
            im = {"P": lambda: Image.fromarray(c).quantize(40), "I;16": lambda: Image.fromarray(g16),
                  "F": lambda: Image.fromarray(f)}.get(mode, lambda: Image.fromarray(c).convert(mode))()
            for comp in ("raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "packbits"):
                bio = io.BytesIO()
                try:
                    im.save(bio, "TIFF", compression=comp)
                except (OSError, ValueError):  # PIL writes some modes without libtiff's codecs
                    continue
                cases.append((("PIL", mode, comp), bio.getvalue()))
    hold_all(cases, tmp_path)


def test_tiff_refusals_name_what_is_not_ported(tmp_path):
    """JPEG (7), YCbCr and 12-bit samples, once refused here, decode as cv2
    decodes them (``test_torch_codecs_tiff.py`` holds each in full); what
    cv2's libtiff is built without (LZMA, ZSTD) raises saying so, not that
    it is not yet ported; what cv2 decodes and the port does not yet (NeXT)
    raises naming it; a cut file fails as cv2 fails."""
    import io

    from PIL import Image

    c = rng_of(12).integers(0, 256, (20, 16, 3), dtype=np.uint8)
    cases = []
    for comp in ("jpeg", "lzma", "zstd"):
        bio = io.BytesIO()
        Image.fromarray(c).save(bio, "TIFF", compression=comp)
        cases.append((comp, bio.getvalue()))
    cases += [("ycbcr", mk.tiff(c, 6, 1)), ("12-bit", mk.tiff(c[..., 0].astype(np.uint16), 1, 1, bits=12))]
    hold_all(cases, tmp_path)
    jpeg, lzma, zstd, ycc, deep = (data for _, data in cases)
    assert codecs.decode_image(jpeg).shape == (20, 16, 3) and codecs.decode_image(ycc).shape == (20, 16, 3)
    assert codecs.decode_unchanged(deep).dtype == np.uint16
    for data, codec in ((lzma, r"LZMA compression \(34925\)"), (zstd, r"ZSTD compression \(50000\)")):
        with pytest.raises(ValueError, match=codec + ": cv2's libtiff is built without it"):
            codecs.decode_image(data)
    next_tiff = bytearray(mk.tiff(c, 2, 1))
    next_tiff = next_tiff.replace(struct.pack("<HHIHH", 259, 3, 1, 1, 0), struct.pack("<HHIHH", 259, 3, 1, 32766, 0))
    with pytest.raises(ValueError, match=r"NeXT compression \(32766\) is not yet ported"):
        codecs.decode_image(bytes(next_tiff))
    whole = cv2.imencode(".tiff", c)[1].tobytes()
    hold_all([(n, whole[:n]) for n in (10, len(whole) // 2, len(whole) - 3)], tmp_path)


# ---------------------------------------------------------------------------
# Sun raster, Radiance HDR, GIF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 8, 24, 32])
def test_sun_raster_matches_cv2(depth, tmp_path):
    """Mapless gray reads 0 under IMREAD_UNCHANGED (cv2 fills its gray
    lookup from a colour map only), 24 and 32 bits are taken as B, G, R
    whatever the type, and cv2 returns None for run-length encoding."""
    rng = rng_of(depth)
    cases = []
    for h, w in ((3, 5), (1, 1), (7, 8), (4, 9)):
        if depth in (8, 24, 32):
            shape = {8: (h, w), 24: (h, w, 3), 32: (h, w, 4)}[depth]
            cases.append(("cv2", cv2.imencode(".ras", rng.integers(0, 256, shape, dtype=np.uint8))[1].tobytes()))
        pitch = ((w * depth + 7) // 8 + 1) & -2
        body = rng.integers(0, 256, pitch * h, dtype=np.uint8).tobytes()
        for typ in (0, 1, 2, 3, 5):
            cases.append((("type", typ), mk.sun_raster(body, w, h, depth, typ)))
            if depth <= 8:
                for n in (1 << depth, max(1, (1 << depth) // 2)):
                    cases.append((("map", typ, n), mk.sun_raster(body, w, h, depth, typ,
                                                                 rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes())))
                    g = rng.integers(0, 256, n, dtype=np.uint8)
                    cases.append((("gray map", typ, n), mk.sun_raster(body, w, h, depth, typ, np.concatenate([g, g, g]).tobytes())))
        cases.append(("cut", mk.sun_raster(body[:-1], w, h, depth, 1)))
    if depth == 8:
        cases += [(("rle", k), mk.sun_raster(mk.sun_rle(rng, 8, 7, 20), 8, 7, 8, 2)) for k in range(10)]
    hold_all(cases, tmp_path)


def test_radiance_hdr_matches_cv2(tmp_path):
    rng = rng_of(13)
    cases = []
    for h, w in ((3, 5), (1, 1), (4, 9), (7, 8), (2, 40)):
        f = (rng.random((h, w, 3)) ** 3 * rng.choice([1e-3, 1, 300], (h, w, 1))).astype(np.float32)
        cases += [("cv2", cv2.imencode(".hdr", f)[1].tobytes()), ("cv2 gray", cv2.imencode(".hdr", f[..., 0])[1].tobytes())]
        rgbe = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        rgbe[..., 3] = rng.choice([0, 1, 100, 128, 136, 140, 200, 255], (h, w))
        rgbe[0, :2] = [7, 7, 7, 130]
        for rle in (True, False):
            cases += [(("rle", rle), mk.hdr(rgbe, rle)),
                      (("RGBE signature", rle), mk.hdr(rgbe, rle, header=b"#?RGBE\nEXPOSURE=1\nFORMAT=32-bit_rle_rgbe\n\n"))]
        cases += [("no blank line", mk.hdr(rgbe, header=b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n")),
                  ("blank line first", mk.hdr(rgbe, header=b"#?RADIANCE\n\nFORMAT=32-bit_rle_rgbe\n\n")),
                  ("+Y", mk.hdr(rgbe, size_line=b"+Y %d +X %d\n" % (h, w))),
                  ("spaces", mk.hdr(rgbe, size_line=b"-Y  %d  +X  %d\n" % (h, w))),
                  ("cut", mk.hdr(rgbe)[:-2]), ("XYZE", mk.hdr(rgbe, header=b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n"))]
    hold_all(cases, tmp_path)


@pytest.mark.parametrize("colours", [2, 4, 16, 256])
def test_gif_matches_cv2(colours, tmp_path):
    """The first image on the logical screen: background entry, offsets,
    local and global tables, cv2's default table, interlace, transparency
    (BGRA under IMREAD_UNCHANGED), Clear codes, the files cut short and
    random LZW data."""
    import io

    from PIL import Image

    rng = rng_of(colours)
    cases = []
    for h, w in ((4, 5), (1, 1), (17, 9), (60, 70)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cases.append(("cv2", cv2.imencode(".gif", img)[1].tobytes()))
        pim = Image.fromarray(img).quantize(colours)
        for kw in ({}, dict(interlace=True), dict(transparency=1), dict(transparency=0, interlace=True)):
            bio = io.BytesIO()
            pim.save(bio, "GIF", **kw)
            cases.append((("PIL", kw), bio.getvalue()))
        gp = rng.integers(0, 256, (colours, 3))
        idx = rng.integers(0, colours, (h, w))
        if h > 10:
            idx[: h // 2] = idx[0, 0]
        ms = max(2, (colours - 1).bit_length())
        for kw in ({}, dict(interlace=True), dict(transparent=int(idx[0, 0])), dict(transparent=min(colours + 5, 255)),
                   dict(clear_every=7)):
            cases.append(((kw,), mk.gif([dict(indices=idx, min_size=ms, **kw)], (w, h), gp,
                                        background=int(rng.integers(0, colours)))))
        cases += [("offset", mk.gif([dict(indices=idx[: max(1, h // 2), : max(1, w // 2)], left=w // 3, top=h // 4,
                                          min_size=ms, transparent=1)], (w, h), gp, background=colours - 1)),
                  ("local", mk.gif([dict(indices=idx, min_size=ms, palette=rng.integers(0, 256, (colours, 3)))], (w, h), gp)),
                  ("local only", mk.gif([dict(indices=idx, min_size=ms, palette=rng.integers(0, 256, (colours, 3)))],
                                        (w, h), None, background=1)),
                  ("no table", mk.gif([dict(indices=idx, min_size=ms)], (w, h), None, background=1)),
                  ("outside", mk.gif([dict(indices=idx, min_size=ms, left=1)], (w, h), gp)),
                  ("background past the table", mk.gif([dict(indices=idx, min_size=ms)], (w + 1, h), gp, background=255))]
        whole = mk.gif([dict(indices=idx, min_size=ms)], (w, h), gp)
        cases += [("cut", whole[: len(whole) // 2]), ("cut end", whole[:-4])]
    head = mk.gif([dict(indices=np.zeros((6, 7), np.uint8), min_size=3)], (7, 6), rng.integers(0, 256, (8, 3)))
    at = head.index(b"\x2c") + 10
    for k in range(30):
        ms = int(rng.integers(2, 9))
        payload = rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
        if k % 2:
            payload = bytes([(1 << ms) & 255]) + payload
        cases.append((("random LZW", k), head[:at] + bytes([ms]) + mk._sub_blocks(payload) + b"\x3b"))
    hold_all(cases, tmp_path)


# ---------------------------------------------------------------------------
# Formats the port refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ext,fmt", [(".avif", "AVIF")])
def test_not_yet_ported_formats_raise_naming_the_format(ext, fmt, tmp_path):
    img = rng_of(14).integers(0, 256, (48, 64, 3), dtype=np.uint8)  # OpenJPEG writes no smaller here
    data = cv2.imencode(ext, img)[1].tobytes()
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is not None
    path = tmp_path / f"frame{ext}"
    path.write_bytes(data)
    for fn, src in ((codecs.decode_image, data), (codecs.read_unchanged, str(path))):
        with pytest.raises(ValueError, match=f"{fmt} is not yet ported"):
            fn(src)


def test_openexr_is_undecodable_as_in_cv2(tmp_path):
    data = open(os.path.join(CONT, "openexr_header.exr"), "rb").read()
    hold(data, tmp_path, "exr")
    with pytest.raises(ValueError, match="OpenEXR"):
        codecs.decode_unchanged(data)


def test_container_refusals_name_the_format():
    for name, msg in (("ll_gray_12bit.jpg", "12-bit lossless JPEG"), ("ll_ycc_jfif.jpg", "YCbCr lossless"),
                      ("ll_arith_sof11.jpg", r"lossless arithmetic-coded JPEG \(SOF11\)"),
                      ("hierarchical_sof5.jpg", r"hierarchical JPEG \(SOF5\)"), ("pam_rgba_no_tupltype.pam", "PAM"),
                      ("tiff_float32_cv2.tif", "TIFF"), ("sun_rle.ras", "run-length"), ("gif_cut.gif", "GIF"),
                      ("bmp_cut.bmp", "BMP"), ("hdr_cut.hdr", "Radiance HDR")):
        with pytest.raises(ValueError, match=msg):
            codecs.read_image(os.path.join(CONT, name))
    with pytest.raises(ValueError, match="a gray lossless JPEG has no conversion to colour"):
        codecs.read_image(os.path.join(CONT, "ll_gray_p1.jpg"))


# ---------------------------------------------------------------------------
# The chip script's writers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["lossless_jpeg", "tiff", "bmp", "ppm"])
def test_chip_writers_decode_to_their_source_in_cv2(writer):
    """``chip_smoke.py`` writes the capture's frames in these containers on
    the card host, where no cv2 is: each file must decode in cv2 (and the
    port) to the array it was written from."""
    import chip_smoke

    rng = rng_of(len(writer))
    sources = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((48, 64), (1, 1), (13, 7))]
    frame = cv2.imread(os.path.join(CAPTURE, "maintenance", "rtabmap_extract", "data_rgb", "1.jpg"), cv2.IMREAD_COLOR)
    sources.append(frame)
    if writer in ("tiff", "bmp"):
        depth = cv2.imread(os.path.join(CAPTURE, "maintenance", "rtabmap_extract", "data_depth", "1.png"),
                           cv2.IMREAD_UNCHANGED)
        sources += [depth, rng.integers(0, 256, (5, 3, 4), dtype=np.uint8)]
    write = {"lossless_jpeg": chip_smoke.write_lossless_jpeg, "tiff": chip_smoke.write_tiff,
             "bmp": chip_smoke.write_bmp, "ppm": chip_smoke.write_ppm}[writer]
    for src in sources:
        data = write(src)
        flag = cv2.IMREAD_UNCHANGED if src.shape[2] == 4 else cv2.IMREAD_COLOR
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), flag), src)
        got = codecs.decode_unchanged(data) if src.shape[2] == 4 else codecs.decode_image(data)[..., ::-1]
        np.testing.assert_array_equal(got, src)


# ---------------------------------------------------------------------------
# The reference's readers on frames and blobs in these containers
# ---------------------------------------------------------------------------


def frame_files(tmp_path):
    """One RGB frame and one depth frame of the committed capture written in
    every container (name → bytes), plus refused ones."""
    import chip_smoke

    ext = os.path.join(CAPTURE, "maintenance", "rtabmap_extract")
    bgr = cv2.imread(os.path.join(ext, "data_rgb", "2.jpg"), cv2.IMREAD_COLOR)
    bgra = cv2.imread(os.path.join(ext, "data_depth", "2.png"), cv2.IMREAD_UNCHANGED)
    mm = (bgra.copy().view(np.float32)[..., 0] * 1000).astype(np.uint16)
    rgb = {"lossless.jpg": chip_smoke.write_lossless_jpeg(bgr), "deflate.tif": chip_smoke.write_tiff(bgr),
           "lzw.tif": cv2.imencode(".tiff", bgr)[1].tobytes(), "frame.bmp": chip_smoke.write_bmp(bgr),
           "frame.ppm": chip_smoke.write_ppm(bgr), "frame.pam": cv2.imencode(".pam", bgr)[1].tobytes(),
           "frame.ras": cv2.imencode(".ras", bgr)[1].tobytes(), "frame.gif": cv2.imencode(".gif", bgr)[1].tobytes(),
           "frame.hdr": cv2.imencode(".hdr", bgr.astype(np.float32) / 255)[1].tobytes(),
           "gray.pgm": cv2.imencode(".pgm", bgr[..., 0])[1].tobytes(),
           "refused.jpg": open(os.path.join(CONT, "ll_gray_12bit.jpg"), "rb").read()}
    depth = {"rgba.tif": chip_smoke.write_tiff(bgra), "bgra.bmp": chip_smoke.write_bmp(bgra),
             "mm16.tif": cv2.imencode(".tiff", mm)[1].tobytes(), "mm16.pgm": cv2.imencode(".pgm", mm)[1].tobytes(),
             "mm16_ascii.pgm": cv2.imencode(".pgm", mm, [cv2.IMWRITE_PXM_BINARY, 0])[1].tobytes(),
             "float.pfm": cv2.imencode(".pfm", bgra.view(np.float32)[..., 0])[1].tobytes(),
             "rgb.ppm": chip_smoke.write_ppm(bgr[:256, :192]),
             "refused.ras": open(os.path.join(CONT, "sun_rle.ras"), "rb").read()}
    return rgb, depth


def outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return e


def test_load_rgb_and_depth_images_follow_the_reference(tmp_path):
    from tpu3dlm.data.dataset import load_depth_image as jax_depth
    from tpu3dlm.data.dataset import load_rgb_image as jax_rgb

    rgb, depth = frame_files(tmp_path)
    for name, data in rgb.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        for size in (None, (96, 96)):
            got, want = outcome(load_rgb_image, path, size), outcome(jax_rgb, path, size)
            assert isinstance(got, ValueError) == isinstance(want, ValueError), (name, got, want)
            if not isinstance(want, ValueError):
                np.testing.assert_array_equal(got, want, err_msg=name)
    for name, data in depth.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        for hw in ((256, 192), (128, 96)):
            got, want = outcome(load_depth_image, path, *hw), outcome(jax_depth, path, *hw)
            assert isinstance(got, ValueError) == isinstance(want, ValueError), (name, hw, got, want)
            if isinstance(want, ValueError):
                continue
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_extractor_rows_follow_the_reference(tmp_path):
    """``fetch_data`` and ``fetch_arrays`` on a data.db whose blobs are the
    new containers keep the rows the reference keeps and skip the rows it
    skips, with identical arrays; a float depth blob is written as
    ``cv2.imwrite`` writes it (cast to 8 bits)."""
    from tpu3dlm.data import rtabmap_db as JR

    from tpu3dlm_torch.data import rtabmap_db as PR

    rgb, depth = frame_files(tmp_path)
    scan = tmp_path / "maintenance"
    shutil.copytree(os.path.join(CAPTURE, "maintenance"), scan)
    db = str(scan / "data.db")
    conn = sqlite3.connect(db)
    rows = [r for r, in conn.execute("SELECT id FROM Data ORDER BY id")]
    plan = {rows[0]: ("lossless.jpg", "rgba.tif"), rows[1]: ("deflate.tif", "bgra.bmp"),
            rows[2]: ("frame.bmp", "mm16.pgm"), rows[3]: ("refused.jpg", "mm16.tif"), rows[4]: ("frame.gif", "refused.ras")}
    for i, (im, dp) in plan.items():
        conn.execute("UPDATE Data SET image = ?, depth = ? WHERE id = ?", (rgb[im], depth[dp], i))
    conn.commit()
    conn.close()
    outs = {}
    for key, module in (("port", PR), ("jax", JR)):
        ex = module.ImageExtractor(db, str(tmp_path / key / "d"), str(tmp_path / key / "r"))
        n = ex.fetch_data()
        kept_files = list(ex.node_ordinals)
        arrays = ex.fetch_arrays()
        outs[key] = (n, kept_files, arrays, list(ex.node_ordinals))
        ex.close()
    (pn, pfiles, (prgb, pdep), pord), (jn, jfiles, (jrgb, jdep), jord) = outs["port"], outs["jax"]
    assert (pn, pfiles, pord) == (jn, jfiles, jord) == (4, [1, 2, 3, 4], [1, 2, 3])
    for a, b in zip(prgb + pdep, jrgb + jdep):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for sub in ("d", "r"):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub))
        for name in names:
            p, j = (str(tmp_path / k / sub / name) for k in ("port", "jax"))
            np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), cv2.imread(j, cv2.IMREAD_UNCHANGED))
    float_db = str(tmp_path / "float.db")
    shutil.copyfile(db, float_db)
    conn = sqlite3.connect(float_db)
    conn.execute("UPDATE Data SET depth = ? WHERE id = ?", (depth["float.pfm"], rows[0]))
    conn.commit()
    conn.close()
    for key, module in (("port", PR), ("jax", JR)):
        ex = module.ImageExtractor(float_db, str(tmp_path / key / "fd"))
        assert ex.fetch_data() == 4
        ex.close()
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / "fd" / "1.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "jax" / "fd" / "1.png"), cv2.IMREAD_UNCHANGED))


def test_load_scan_on_container_frames_follows_the_reference(tmp_path):
    """A capture folder whose RGB frames are TIFF, BMP, PPM and lossless
    JPEG (named ``<n>.jpg``, as ``fetch_data`` names every RGB blob) and
    whose depth frames are 4-channel TIFF and BMP and 16-bit PGM (named
    ``<n>.png``): ``load_scan`` identical to the JAX package's."""
    import chip_smoke

    from tpu3dlm.data import dataset as JD

    from tpu3dlm_torch.data import dataset as PD

    scan = tmp_path / "maintenance"
    shutil.copytree(os.path.join(CAPTURE, "maintenance"), scan)
    ext = scan / "rtabmap_extract"
    writers = [chip_smoke.write_tiff, chip_smoke.write_bmp, chip_smoke.write_ppm, chip_smoke.write_lossless_jpeg,
               lambda a: cv2.imencode(".tiff", a)[1].tobytes()]
    depth_writers = [chip_smoke.write_tiff, chip_smoke.write_bmp, None, chip_smoke.write_tiff, None]
    for k in range(1, 6):
        rgb_path, depth_path = ext / "data_rgb" / f"{k}.jpg", ext / "data_depth" / f"{k}.png"
        rgb_path.write_bytes(writers[k - 1](cv2.imread(str(rgb_path), cv2.IMREAD_COLOR)))
        bgra = cv2.imread(str(depth_path), cv2.IMREAD_UNCHANGED)
        if depth_writers[k - 1]:
            depth_path.write_bytes(depth_writers[k - 1](bgra))
        elif k == 3:
            depth_path.write_bytes(cv2.imencode(".pgm", (bgra.view(np.float32)[..., 0] * 1000).astype(np.uint16))[1].tobytes())
    args = (str(ext / "data_rgb"), str(ext / "data_depth"), str(ext / "calibration"), str(scan / "poses.txt"))
    for mode, size in (("square", 128), ("letterbox", 96)):
        got = PD.load_scan(*args, img_size=size, resize_mode=mode, workers=2)
        want = JD.load_scan(*args, img_size=size, resize_mode=mode)
        for field in ("rgb", "depth", "intrinsics", "rgb_size", "poses", "timestamps", "letterbox"):
            a, b = getattr(got, field), getattr(want, field)
            if b is None:
                assert a is None
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_two_scan_cli_on_a_tiff_and_bmp_capture_writes_the_jax_csv(tmp_path):
    """The maintenance data.db of the committed capture with its image blobs
    in Deflate TIFF and BMP and its depth blobs in 4-channel TIFF and BMP:
    the port's CLI report equals the JAX CLI's (one missing sign), at the
    small ICP of ``test_torch_codecs_modes.py``."""
    import unittest.mock as mock

    import chip_smoke
    import torch
    from test_torch_codecs_modes import capture_project

    from tpu3dlm import cli as jax_cli
    from tpu3dlm.utils.config import ConfigLoader as JCfg
    from tpu3dlm_torch import cli
    from tpu3dlm_torch.utils.config import ConfigLoader

    def convert(root):
        cfg = capture_project(root, None)
        db = os.path.join(root, "configs", "data", "maintenance", "data.db")
        conn = sqlite3.connect(db)
        rows = conn.execute("SELECT id, image, depth FROM Data").fetchall()
        for i, im, dp in rows:
            bgr = cv2.imdecode(np.frombuffer(im, np.uint8), cv2.IMREAD_COLOR)
            bgra = cv2.imdecode(np.frombuffer(dp, np.uint8), cv2.IMREAD_UNCHANGED)
            write = chip_smoke.write_tiff if i % 2 else chip_smoke.write_bmp
            conn.execute("UPDATE Data SET image = ?, depth = ? WHERE id = ?", (write(bgr), write(bgra), i))
        conn.commit()
        conn.close()
        return cfg

    torch.set_num_threads(1)
    cfg = convert(str(tmp_path / "port"))
    cli.main(["--data", "maintenance", "--config", cfg, "--device", "cpu"])
    got = open(ConfigLoader(cfg, "maintenance").csv_output, "rb").read()
    jax_cfg = convert(str(tmp_path / "jax"))
    with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None):
        jax_cli.main(["--data", "maintenance", "--config", jax_cfg])
    want = open(JCfg(jax_cfg, "maintenance").csv_output, "rb").read()
    assert got == want
    assert got.count(b"missing") == 1
    head = open(os.path.join(str(tmp_path / "port"), "configs", "data", "maintenance", "rtabmap_extract", "data_rgb",
                             "1.jpg"), "rb").read(4)
    assert head in (b"II*\x00", b"BM")  # the extracted frames kept their container
