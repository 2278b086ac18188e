"""The port's codecs on every JPEG and PNG frame that cv2 reads, against cv2
5.0 (its bundled libjpeg-turbo 3.1 and libpng 1.6) as the reference calls
it, byte for byte: shape, dtype and every byte.

- JPEG: progressive and arithmetic (sequential and progressive) coding,
  YCCK and CMYK, luma sampling 4x1, 3x1, 1x4 and 4x2, partial progressions
  (block smoothing), EXIF orientations 1-8 in both byte orders, and files
  cut short: padded as ``cv2.imread`` pads them, refused as ``cv2.imdecode``
  refuses the same bytes. Cases come from cv2 and PIL here and from the
  committed fixtures of ``tests/fixtures/codecs/make_fixtures.c``.
- PNG: every colour type and bit depth, with and without tRNS and Adam7,
  under IMREAD_UNCHANGED and IMREAD_COLOR, and an eXIf orientation; built
  here from numpy and zlib.
- Frames told apart by signature, whatever their extension; the repairs of
  ROADMAP §C C5 (EXIF orientation) and C6 (non-baseline frames), each held
  to the JAX package; and the two-scan CLI on captures whose maintenance
  blobs are progressive-arithmetic JPEGs or PNGs."""

import glob
import hashlib
import io
import json
import os
import re
import shutil
import sqlite3
import struct
import zlib

import cv2
import numpy as np
import pytest

from tpu3dlm_torch.data import codecs
from tpu3dlm_torch.data.dataset import load_depth_image, load_rgb_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "codecs")
CAPTURE = os.path.join(REPO, "tests", "fixtures", "torch_project", "data")
JPEG_FIXTURES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(FIX, "*.jpg")))
PNG_FIXTURES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(FIX, "*.png")))


def assert_same(got: np.ndarray, want: np.ndarray):
    assert want is not None
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


def rgb(bgr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(bgr[..., ::-1])


def cv2_decode(data: bytes, flag: int):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flag)


def digest(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(), "shape": list(a.shape), "dtype": str(a.dtype)}


def test_fixture_count():
    assert len(JPEG_FIXTURES) == 57 and len(PNG_FIXTURES) == 5


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", JPEG_FIXTURES)
def test_jpeg_fixture_matches_cv2(name):
    path = os.path.join(FIX, name)
    data = open(path, "rb").read()
    assert_same(codecs.read_jpeg(path), rgb(cv2.imread(path, cv2.IMREAD_COLOR)))
    assert_same(codecs.decode_jpeg(data, name), rgb(cv2_decode(data, cv2.IMREAD_COLOR)))
    assert_same(codecs.decode_unchanged(data, name), cv2_decode(data, cv2.IMREAD_UNCHANGED))


def test_capture_transcodes_keep_the_baseline_pixels():
    """The transcodes are coefficient-exact: the same pixels as the
    committed capture's baseline frames."""
    names = [n for n in JPEG_FIXTURES if n.startswith("capture_")]
    assert len(names) == 30
    for name in names:
        scan, k, _ = re.fullmatch(r"capture_(gold_std|maintenance)_(\d)_(\w+)\.jpg", name).groups()
        base = os.path.join(CAPTURE, scan, "rtabmap_extract", "data_rgb", f"{k}.jpg")
        assert_same(codecs.read_jpeg(os.path.join(FIX, name)), codecs.read_jpeg(base))


CV2_MODES = {
    "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "progressive_q40_rst": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 40,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    "411": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411],
    "411_progressive": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
                        cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "440_progressive": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                        cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
}


def pattern_image(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) % 256], -1)
    return np.clip(img + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", list(CV2_MODES))
@pytest.mark.parametrize("hw", [(96, 128), (61, 85), (17, 9), (1, 1)])
def test_cv2_written_modes_match_cv2(mode, hw):
    img = pattern_image(*hw, seed=hw[0] * 31 + hw[1])
    for src in (img, img[..., 0]):  # colour and gray
        ok, enc = cv2.imencode(".jpg", src, CV2_MODES[mode])
        assert ok
        data = enc.tobytes()
        assert_same(codecs.decode_jpeg(data), rgb(cv2_decode(data, cv2.IMREAD_COLOR)))
        assert_same(codecs.decode_unchanged(data), cv2_decode(data, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("kind", ["cmyk", "cmyk_progressive", "progressive", "progressive_gray"])
def test_pil_written_modes_match_cv2(kind):
    from PIL import Image

    img = Image.fromarray(pattern_image(61, 85, seed=3))
    if kind.startswith("cmyk"):
        img = img.convert("CMYK")
    elif kind.endswith("gray"):
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=85, progressive="progressive" in kind)
    data = buf.getvalue()
    if kind.startswith("cmyk"):
        assert b"Adobe" in data  # an Adobe CMYK file
    assert_same(codecs.decode_jpeg(data, kind), rgb(cv2_decode(data, cv2.IMREAD_COLOR)))
    assert_same(codecs.decode_unchanged(data, kind), cv2_decode(data, cv2.IMREAD_UNCHANGED))


def exif_app1(orientation: int, order: str) -> bytes:
    """An APP1 "Exif" segment whose IFD0 holds only Orientation."""
    e = "<" if order == "II" else ">"
    tiff = order.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
    tiff += struct.pack(e + "HHI", 0x0112, 3, 1) + struct.pack(e + "HH", orientation, 0) + struct.pack(e + "I", 0)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def with_exif(jpeg: bytes, orientation: int, order: str = "MM") -> bytes:
    """``jpeg`` with an EXIF APP1 after its JFIF APP0."""
    at = 2 + 2 + struct.unpack(">H", jpeg[4:6])[0] if jpeg[2:4] == b"\xff\xe0" else 2
    return jpeg[:at] + exif_app1(orientation, order) + jpeg[at:]


@pytest.mark.parametrize("order", ["MM", "II"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(orientation, order, tmp_path):
    base = cv2.imencode(".jpg", pattern_image(37, 53, seed=orientation), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
    data = with_exif(base.tobytes(), orientation, order)
    path = tmp_path / "o.jpg"
    path.write_bytes(data)
    want = rgb(cv2.imread(str(path), cv2.IMREAD_COLOR))
    assert want.shape[:2] == ((53, 37) if orientation >= 5 else (37, 53))
    assert_same(codecs.decode_jpeg(data), rgb(cv2_decode(data, cv2.IMREAD_COLOR)))
    assert_same(codecs.read_jpeg(str(path)), want)
    assert_same(codecs.read_image(str(path)), want)
    # IMREAD_UNCHANGED does not rotate
    assert_same(codecs.read_unchanged(str(path)), cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


CUT_SOURCES = ["baseline", "baseline_rst", "progressive", "progressive_rst", "arith_seq_420",
               "arith_prog_rst_dac", "partial_6", "ycck_prog", "samp_31_prog", "partial_1_gray",
               "capture_gold_std_1_prog"]


def cut_source(name: str) -> bytes:
    if name.startswith(("baseline", "progressive")):
        img = pattern_image(61, 85, seed=11)
        params = ([cv2.IMWRITE_JPEG_PROGRESSIVE, 1] if name.startswith("progressive") else [])
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 2] if name.endswith("rst") else []
        return cv2.imencode(".jpg", img, params)[1].tobytes()
    return open(os.path.join(FIX, name + ".jpg"), "rb").read()


@pytest.mark.parametrize("source", CUT_SOURCES)
def test_cut_files_pad_as_imread_and_fail_as_imdecode(source, tmp_path):
    """A file cut short: ``cv2.imread`` decodes what is there (libjpeg's
    fake EOI; a progressive file is smoothed) or returns None when the cut
    is in the headers, and ``cv2.imdecode`` of the same bytes returns None.
    The port's file form and bytes form do the same."""
    data = cut_source(source)
    n = len(data)
    rng = np.random.default_rng(n)
    cuts = sorted({n // 2, n - 2, n - 10, n // 3, 2 * n // 3, n - 1, min(200, n - 3),
                   *rng.integers(min(150, n // 2), n, 8).tolist()})
    padded = 0
    for cut in cuts:
        part = data[:cut]
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(part)
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if want is None:
            with pytest.raises(ValueError, match=f"cut{cut}.jpg"):
                codecs.read_jpeg(str(path))
        else:
            assert_same(codecs.read_jpeg(str(path)), rgb(want))
            assert_same(load_rgb_image(str(path)), rgb(want))
            padded += 1
        assert cv2_decode(part, cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="undecodable JPEG"):
            codecs.decode_jpeg(part)
    assert padded >= 3


def test_lossless_12bit_and_hierarchical_raise_naming_the_format(tmp_path):
    base = cv2.imencode(".jpg", pattern_image(16, 16, seed=1))[1].tobytes()
    sof = base.index(b"\xff\xc0")
    cases = {"lossless.jpg": (b"\xff\xc3", None, "lossless JPEG \\(SOF3\\)"),
             "lossless_arith.jpg": (b"\xff\xcb", None, "lossless arithmetic"),
             "hierarchical.jpg": (b"\xff\xc5", None, "hierarchical JPEG \\(SOF5\\)"),
             "twelve.jpg": (b"\xff\xc1", 12, "12-bit JPEG is not supported")}
    for name, (marker, precision, msg) in cases.items():
        data = bytearray(base)
        data[sof:sof + 2] = marker
        if precision:
            data[sof + 4] = precision
        path = tmp_path / name
        path.write_bytes(bytes(data))
        with pytest.raises(ValueError, match=f"{name}: {msg}"):
            codecs.read_image(str(path))
        with pytest.raises(ValueError, match=msg):
            codecs.decode_image(bytes(data))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

PNG_SIG = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def pack_rows(s: np.ndarray, depth: int) -> np.ndarray:
    h = s.shape[0]
    if depth == 16:
        return s.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return s.astype(np.uint8).reshape(h, -1)
    bits = np.unpackbits(s.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:].reshape(h, -1)
    return np.packbits(bits, axis=-1)


def filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Each row under filter type (row index mod 5): every filter occurs."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for i, r in enumerate(rows.astype(np.int32)):
        a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = i % 5
        if f == 0:
            d = r
        elif f == 1:
            d = r - a
        elif f == 2:
            d = r - prev
        elif f == 3:
            d = r - ((a + prev) >> 1)
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            d = r - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([f]) + (d & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def png_bytes(samples: np.ndarray, ctype: int, depth: int, interlace: bool = False, plte: bytes | None = None,
              trns: bytes | None = None, exif: bytes | None = None, exif_after_idat: bool = False) -> bytes:
    """A PNG of (H, W, channels) samples as they lie on disk (RGB order,
    palette indices), Adam7-interlaced when asked."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(filter_rows(pack_rows(samples[y0::dy, x0::dx], depth), bpp)
                       for x0, y0, dx, dy in ADAM7 if samples[y0::dy, x0::dx].size)
    else:
        raw = filter_rows(pack_rows(samples, depth), bpp)
    out = PNG_SIG + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if exif is not None and not exif_after_idat:
        out += png_chunk(b"eXIf", exif)
    if plte is not None:
        out += png_chunk(b"PLTE", plte)
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    out += png_chunk(b"IDAT", zlib.compress(raw, 6))
    if exif is not None and exif_after_idat:
        out += png_chunk(b"eXIf", exif)
    return out + png_chunk(b"IEND", b"")


PNG_LAYOUTS = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)] + [(3, d) for d in (1, 2, 4, 8)] + \
              [(4, 8), (4, 16), (6, 8), (6, 16)]


def png_case(ctype: int, depth: int, interlace: bool, trns: bool, h: int = 13, w: int = 11) -> bytes:
    rng = np.random.default_rng(ctype * 100 + depth * 4 + interlace * 2 + trns)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    s = rng.integers(0, 1 << depth, (h, w, channels)).astype(np.uint16 if depth == 16 else np.uint8)
    plte = tr = None
    if ctype == 3:
        n = min(1 << depth, 7) if depth > 1 else 2
        s = (s % n).astype(np.uint8)
        plte = rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes()
        tr = rng.integers(0, 256, n - 1, dtype=np.uint8).tobytes() if trns else None
    elif trns:
        tr = struct.pack(">" + "H" * channels, *[int(v) for v in s[3, 4]])
    return png_bytes(s, ctype, depth, interlace, plte, tr)


# tRNS only where the spec allows it: gray, RGB and palette
PNG_CASES = [(c, d, i, t) for c, d in PNG_LAYOUTS for i in (False, True) for t in (False, True) if not (t and c >= 4)]


@pytest.mark.parametrize("ctype,depth,interlace,trns", PNG_CASES)
def test_png_layout_matches_cv2(ctype, depth, interlace, trns):
    data = png_case(ctype, depth, interlace, trns)
    assert_same(codecs.decode_png(data), cv2_decode(data, cv2.IMREAD_UNCHANGED))
    assert_same(codecs.decode_unchanged(data), cv2_decode(data, cv2.IMREAD_UNCHANGED))
    assert_same(codecs.decode_image(data), rgb(cv2_decode(data, cv2.IMREAD_COLOR)))


@pytest.mark.parametrize("after_idat", [False, True])
@pytest.mark.parametrize("orientation", [1, 2, 6, 7])
def test_png_exif_orientation_matches_cv2(orientation, after_idat):
    """cv2 5.0 applies a PNG eXIf chunk under IMREAD_COLOR, wherever it
    stands, and not under IMREAD_UNCHANGED."""
    tiff = exif_app1(orientation, "II")[10:]
    s = np.random.default_rng(orientation).integers(0, 256, (13, 11, 3), dtype=np.uint8)
    data = png_bytes(s, 2, 8, exif=tiff, exif_after_idat=after_idat)
    want = rgb(cv2_decode(data, cv2.IMREAD_COLOR))
    assert want.shape[:2] == ((11, 13) if orientation >= 5 else (13, 11))
    assert_same(codecs.decode_image(data), want)
    assert_same(codecs.decode_png(data), cv2_decode(data, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("kind", ["u8_gray", "u8_bgr", "u8_bgra", "u16_gray", "u16_bgr", "u16_bgra"])
def test_write_png_writes_every_decoded_layout(kind, tmp_path):
    """``write_png`` takes each layout ``decode_png`` returns, as
    ``cv2.imwrite`` does: the file decodes under cv2 to the same array."""
    dtype = np.uint16 if kind.startswith("u16") else np.uint8
    channels = {"gray": (), "bgr": (3,), "bgra": (4,)}[kind.split("_")[1]]
    img = np.random.default_rng(len(kind)).integers(0, np.iinfo(dtype).max + 1, (17, 9, *channels)).astype(dtype)
    path = str(tmp_path / "x.png")
    codecs.write_png(path, img)
    assert_same(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    assert_same(codecs.read_png(path), img)
    ref = str(tmp_path / "cv2.png")
    cv2.imwrite(ref, img)
    assert_same(codecs.read_png(ref), img)


def test_digests_match_cv2_and_the_port():
    """``digests.json`` (what ``chip_smoke.py`` holds the port to on the
    card host) is cv2's decode of every fixture, and the port gives it."""
    with open(os.path.join(FIX, "digests.json")) as f:
        digests = json.load(f)
    assert sorted(digests) == sorted(JPEG_FIXTURES + PNG_FIXTURES)
    for name, want in digests.items():
        path = os.path.join(FIX, name)
        if name.endswith(".jpg"):
            assert want == {"color": digest(cv2.imread(path, cv2.IMREAD_COLOR))}
            assert digest(rgb(codecs.read_jpeg(path))) == want["color"], name
        else:
            assert want == {"color": digest(cv2.imread(path, cv2.IMREAD_COLOR)),
                            "unchanged": digest(cv2.imread(path, cv2.IMREAD_UNCHANGED))}
            assert digest(rgb(codecs.read_image(path))) == want["color"], name
            assert digest(codecs.read_png(path)) == want["unchanged"], name


# ---------------------------------------------------------------------------
# Frames told apart by signature
# ---------------------------------------------------------------------------


def test_formats_are_told_apart_by_signature(tmp_path):
    from tpu3dlm.data.dataset import load_depth_image as jax_load_depth
    from tpu3dlm.data.dataset import load_rgb_image as jax_load_rgb

    img = pattern_image(48, 64, seed=5)
    png_as_jpg = tmp_path / "1.jpg"
    png_as_jpg.write_bytes(cv2.imencode(".png", img)[1].tobytes())
    assert_same(load_rgb_image(str(png_as_jpg)), jax_load_rgb(str(png_as_jpg)))
    assert_same(load_rgb_image(str(png_as_jpg), (32, 32)), jax_load_rgb(str(png_as_jpg), (32, 32)))
    jpeg_as_png = tmp_path / "1.png"
    jpeg_as_png.write_bytes(cv2.imencode(".jpg", img)[1].tobytes())
    with pytest.raises(ValueError) as want:
        jax_load_depth(str(jpeg_as_png), 48, 64)
    with pytest.raises(ValueError) as got:
        load_depth_image(str(jpeg_as_png), 48, 64)
    assert str(got.value) == str(want.value) and "neither CV_8UC4 nor 16UC1" in str(got.value)
    for ext in (".bmp", ".tiff", ".ppm", ".webp", ".jp2"):  # containers the port decodes since it reads them all
        path = tmp_path / f"frame{ext}.jpg"
        path.write_bytes(cv2.imencode(ext, img)[1].tobytes())
        assert_same(load_rgb_image(str(path)), jax_load_rgb(str(path)))
    for ext, fmt in ((".avif", "AVIF"),):
        path = tmp_path / f"frame{ext}.jpg"
        path.write_bytes(cv2.imencode(ext, img)[1].tobytes())
        assert cv2.imread(str(path)) is not None
        with pytest.raises(ValueError, match=f"frame{ext}.jpg: {fmt} is not yet ported"):
            load_rgb_image(str(path))
    junk = tmp_path / "junk.jpg"
    junk.write_bytes(b"not an image at all")
    with pytest.raises(ValueError, match="junk.jpg: unknown format"):
        load_rgb_image(str(junk))


def test_c5_exif_orientation_follows_the_reference(tmp_path):
    """ROADMAP §C C5: a JPEG frame with EXIF orientation 6 (PIL, 96 × 128)
    comes out rotated, (128, 96, 3), as the reference's cv2.imread gives
    it; the parent returned it unrotated with no error."""
    from PIL import Image

    from tpu3dlm.data.dataset import load_rgb_image as jax_load_rgb

    exif = Image.Exif()
    exif[0x0112] = 6
    path = tmp_path / "1.jpg"
    Image.fromarray(pattern_image(96, 128, seed=6)).save(str(path), "JPEG", exif=exif.tobytes())
    want = jax_load_rgb(str(path))
    assert want.shape == (128, 96, 3)
    assert_same(load_rgb_image(str(path)), want)
    assert_same(load_rgb_image(str(path), (64, 64)), jax_load_rgb(str(path), (64, 64)))


def replace_image_blobs(db: str, blob_for) -> None:
    conn = sqlite3.connect(db)
    rows = conn.execute("SELECT id, image FROM Data").fetchall()
    conn.executemany("UPDATE Data SET image = ? WHERE id = ?", [(blob_for(i, bytes(b)), i) for i, b in rows])
    conn.commit()
    conn.close()


def test_c6_non_baseline_frames_follow_the_reference(tmp_path):
    """ROADMAP §C C6: a PNG frame file (as ``fetch_data`` names any blob
    ``<n>.jpg``) raised in ``load_rgb_image``, and a progressive blob was
    dropped by ``fetch_arrays``; the reference reads both."""
    from tpu3dlm.data import rtabmap_db as JR

    from tpu3dlm_torch.data import rtabmap_db as PR

    scan = tmp_path / "maintenance"
    shutil.copytree(os.path.join(CAPTURE, "maintenance"), scan)
    db = str(scan / "data.db")
    kinds = {1: "prog", 2: "arith_prog", 3: "png", 4: "arith", 5: "baseline"}

    def blob(i, old):
        if kinds[i] == "baseline":
            return old
        if kinds[i] == "png":
            return cv2.imencode(".png", cv2.imdecode(np.frombuffer(old, np.uint8), cv2.IMREAD_COLOR))[1].tobytes()
        return open(os.path.join(FIX, f"capture_maintenance_{i}_{kinds[i]}.jpg"), "rb").read()

    replace_image_blobs(db, blob)
    outs = {}
    for key, module in (("port", PR), ("jax", JR)):
        ex = module.ImageExtractor(db, str(tmp_path / key / "d"), str(tmp_path / key / "r"))
        ex.fetch_data()
        outs[key] = (ex.fetch_arrays(), list(ex.node_ordinals))
        ex.close()
    (prgb, pdep), pord = outs["port"]
    (jrgb, jdep), jord = outs["jax"]
    assert pord == jord == [1, 2, 3, 4, 5]
    for a, b in zip(prgb + pdep, jrgb + jdep):
        assert_same(a, b)
    for k in range(1, 6):
        path = str(tmp_path / "port" / "r" / f"{k}.jpg")
        assert_same(load_rgb_image(path), rgb(cv2.imread(path, cv2.IMREAD_COLOR)))


# ---------------------------------------------------------------------------
# The two-scan CLI on captures in the new formats
# ---------------------------------------------------------------------------


def capture_project(root: str, variant: str | None) -> str:
    """The committed capture under ``root`` with make_project's config on
    the fused route, f32 and the fixture checkpoints (as
    tests/test_torch_pipeline.py), ICP cut to 2048 points and 10 iterations
    a stage so that compare, which the frames' format does not reach, takes
    seconds; with ``variant``, the maintenance data.db image blobs replaced
    by the progressive-arithmetic transcodes or by PNG bytes of the same
    pixels."""
    import chip_smoke

    data = chip_smoke.copy_project(root)
    cfg = chip_smoke.pipeline_config(root, [
        ("infer_dtype = bf16", "infer_dtype = f32"),
        ("yolo_weights =", f"yolo_weights = {chip_smoke.FIXTURES / 'yolo_synthetic.msgpack'}"),
        ("beit_weights =", f"beit_weights = {chip_smoke.FIXTURES / 'beit_synthetic.msgpack'}"),
        ("icp_max_points = 16384", "icp_max_points = 2048"), ("icp_iterations = 30", "icp_iterations = 10")])
    ext = os.path.join(data, "maintenance", "rtabmap_extract", "data_rgb")
    for name in os.listdir(ext):  # the frames come from data.db, as in a fresh export
        os.remove(os.path.join(ext, name))
    if variant == "arith_prog":
        replace_image_blobs(os.path.join(data, "maintenance", "data.db"), lambda i, old: open(
            os.path.join(FIX, f"capture_maintenance_{i}_arith_prog.jpg"), "rb").read())
    elif variant == "png":
        replace_image_blobs(os.path.join(data, "maintenance", "data.db"), lambda i, old: codecs.encode_png(
            rgb(codecs.decode_jpeg(old))))
    return cfg


def port_cli(root: str, variant: str | None) -> bytes:
    import torch

    from tpu3dlm_torch import cli
    from tpu3dlm_torch.utils.config import ConfigLoader

    torch.set_num_threads(1)  # the JAX package's CPU reductions, as tests/test_torch_pipeline.py
    cfg = capture_project(root, variant)
    cli.main(["--data", "maintenance", "--config", cfg, "--device", "cpu"])
    return open(ConfigLoader(cfg, "maintenance").csv_output, "rb").read()


@pytest.fixture(scope="module")
def baseline_csv(tmp_path_factory):
    return port_cli(str(tmp_path_factory.mktemp("baseline")), None)


@pytest.mark.parametrize("variant", ["arith_prog", "png"])
def test_two_scan_cli_on_new_formats_writes_the_jax_csv(variant, baseline_csv, tmp_path):
    import unittest.mock as mock

    from tpu3dlm import cli as jax_cli
    from tpu3dlm.utils.config import ConfigLoader as JCfg

    got = port_cli(str(tmp_path / "port"), variant)
    jax_cfg = capture_project(str(tmp_path / "jax"), variant)
    with mock.patch("tpu3dlm.native.native_grid_normals", return_value=None):
        jax_cli.main(["--data", "maintenance", "--config", jax_cfg])
    want = open(JCfg(jax_cfg, "maintenance").csv_output, "rb").read()
    assert got == want
    assert got == baseline_csv
    assert got.count(b"missing") == 1
