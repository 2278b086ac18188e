"""The port's TIFF reader on what cv2 5.0 reads through its libtiff 4.7
beyond ``test_torch_codecs_containers.py``'s layouts, against cv2 as the
reference calls it (``cv2.imread`` and ``cv2.imdecode`` under IMREAD_COLOR
and IMREAD_UNCHANGED), byte for byte: shape, dtype and every byte, or the
same refusal (cv2's None, the port's ``ValueError`` naming the file).

- BigTIFF (``II+``, ``MM+``): every layout the classic tests hold.
- CCITT: Modified Huffman (2) and its word-aligned form (32771), T.4 1-D
  and 2-D with and without fill bits (3), T.6 (4); FillOrder 1 and 2,
  MinIsWhite and MinIsBlack, strips and tiles; bit errors.
- JPEG-in-TIFF (7): YCbCr at each chroma subsampling libjpeg writes, RGB,
  gray and CMYK, strips and tiles, JPEGTables.
- YCbCr (6) uncompressed, LZW, Deflate and PackBits at every
  YCbCrSubSampling libtiff's RGBA reader has a routine for (and the ones it
  refuses), YCbCrCoefficients and ReferenceBlackWhite, planes.
- CIELab (8) of 8 and 16 bits, WhitePoint; ICCLab (9) and ITULab (10),
  which cv2 refuses.
- 10-, 12- and 14-bit samples: IMREAD_UNCHANGED's uint16 with each sample
  at the top bits, IMREAD_COLOR's refusal.
- The compressions cv2's libtiff is built without (old JPEG, PixarLog,
  JBIG, LZMA, ZSTD, WebP, LERC): refused in cv2's terms, never as "not yet
  ported".
- The committed fixtures (``tests/fixtures/codecs/tiff``, from
  ``make_tiff.c`` and ``make_containers.tiff_fixtures()``) and their
  digests, which ``chip_smoke.py`` holds the port to on the card host.
- The JAX package's readers against the port's on BigTIFF and
  JPEG-in-TIFF frames and blobs (the two-scan CLI on such a capture is
  ``test_torch_codecs_tiff_cli.py``).

Where cv2's output is not defined the tests hold what is defined: the rows
of a CCITT strip from where its data ends (libtiff leaves its buffer as it
was; the port refuses), and the planes of a planar image of 10 to 16 bits
read through cv2's raw path (held to the planes' own samples)."""

import glob
import json
import os
import shutil
import sqlite3
import struct
import sys

import cv2
import numpy as np
import pytest
from test_torch_codecs_containers import TIFF_LAYOUTS, digest, hold, hold_all, port, reference, rng_of, tiff_kinds

from tpu3dlm_torch.data import codecs
from tpu3dlm_torch.data.dataset import load_depth_image, load_rgb_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "codecs")
TIFF = os.path.join(FIX, "tiff")
CAPTURE = os.path.join(REPO, "tests", "fixtures", "torch_project", "data")
sys.path.insert(0, FIX)

import make_containers as mk  # noqa: E402

FIXTURES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(TIFF, "*.tif")))
LACKED = {6: "old JPEG", 32909: "PixarLog", 34661: "JBIG", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP", 34887: "LERC"}


def with_compression(data: bytes, comp: int) -> bytes:
    """A classic little-endian TIFF with its Compression tag set to comp."""
    out = bytearray(data)
    (at,) = struct.unpack("<I", out[4:8])
    (n,) = struct.unpack("<H", out[at:at + 2])
    for i in range(n):
        e = at + 2 + 12 * i
        if struct.unpack("<H", out[e:e + 2])[0] == 259:
            out[e + 8:e + 10] = struct.pack("<H", comp)
    return bytes(out)


def bilevel(rng, h, w):
    """A bilevel page: bands, blocks, a diagonal and noise (PIL mode "1")."""
    from PIL import Image

    y, x = np.mgrid[:h, :w]
    page = ((x // 9 + y // 5) % 3 == 0) ^ (np.abs(x - 2 * y) < 3) ^ (rng.random((h, w)) < 0.04)
    page[::11] = True
    page[5::13] = False
    return Image.fromarray(page)


# ---------------------------------------------------------------------------
# The committed fixtures
# ---------------------------------------------------------------------------


def test_tiff_fixture_count():
    assert len(FIXTURES) == 71


@pytest.mark.parametrize("name", FIXTURES)
def test_tiff_fixture_matches_cv2(name, tmp_path):
    with open(os.path.join(TIFF, name), "rb") as f:
        hold(f.read(), tmp_path, name)


def test_tiff_digests_match_cv2_and_the_port():
    """``tiff/digests.json`` (what ``chip_smoke.py`` holds the port to on
    the card host) is cv2's ``imread`` of every fixture, ``null`` where it
    returns None, and the port's file form gives it."""
    with open(os.path.join(TIFF, "digests.json")) as f:
        digests = json.load(f)
    assert sorted(digests) == FIXTURES
    assert sum(v[k] is None for v in digests.values() for k in v) >= 25
    for name, want in digests.items():
        path = os.path.join(TIFF, name)
        for kind in ("color", "unchanged"):
            ref = reference(kind, path)
            assert want[kind] == (None if ref is None else digest(ref)), (name, kind)
            got = port(kind, path)
            assert (None if got is None else digest(got)) == want[kind], (name, kind)


def test_tiff_fixtures_are_what_the_generator_writes():
    made = mk.tiff_fixtures()
    assert set(made) <= set(FIXTURES)
    for name, data in made.items():
        if name.startswith("pil_"):
            continue  # PIL's own writer: held to cv2 above, not to its bytes
        with open(os.path.join(TIFF, name), "rb") as f:
            assert f.read() == data, name


# ---------------------------------------------------------------------------
# BigTIFF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(TIFF_LAYOUTS))
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_bigtiff_layouts_match_cv2(compression, layout, tmp_path):
    """Every sample layout of the classic tests, with and without the
    horizontal predictor, written as BigTIFF (8-byte offsets and counts,
    20-byte entries, LONG8 strip and tile offsets); a planar image of 16 or
    32 bits read under IMREAD_UNCHANGED is held to its planes' samples, as
    there."""
    lay = TIFF_LAYOUTS[layout]
    rng = rng_of(compression, len(layout), 43)
    for h, w in ((5, 7), (37, 21)):
        for img, ph, kw in tiff_kinds(rng, h, w):
            if lay.get("planar") and img.ndim == 2:
                continue
            for predictor in (1, 2):
                data = mk.tiff(img, ph, compression=compression, predictor=predictor, big=True, **lay, **kw)
                assert data[2:4] in (b"+\x00", b"\x00+")
                raw_planes = lay.get("planar") and img.dtype.itemsize > 1 and not (img.ndim == 3 and img.shape[2] == 2)
                skip = {("unchanged", "bytes"), ("unchanged", "file")} if raw_planes else ()
                hold(data, tmp_path, (h, w, img.dtype, img.shape, ph, kw, predictor), skip=skip)
                if raw_planes and (predictor == 1 or compression in (5, 8)):
                    want = img[..., [2, 1, 0, 3][:img.shape[2]]] if ph == 2 else img
                    np.testing.assert_array_equal(codecs.decode_unchanged(data), want)


def test_bigtiff_palettes_bilevel_orientation_and_cuts_match_cv2(tmp_path):
    rng = rng_of(44)
    cases = []
    for h, w in ((5, 7), (1, 1), (37, 21)):
        for bits in (1, 4, 8):
            v = rng.integers(0, 1 << bits, (h, w), dtype=np.uint8)
            cases.append((("palette", bits), mk.tiff(v, 3, 5, bits=bits, colormap=rng.integers(0, 65536, (1 << bits, 3)),
                                                     big=True)))
            cases.append((("white", bits), mk.tiff(v, 0, 32773, bits=bits, big=True, order=">")))
        c = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for orientation in (3, 6):
            cases.append((("orientation", orientation), mk.tiff(c, 2, 8, orientation=orientation, big=True)))
    whole = mk.tiff(rng.integers(0, 256, (20, 16, 3), dtype=np.uint8), 2, 8, rows_per_strip=4, big=True)
    cases += [(("cut", n), whole[:n]) for n in (12, 16, len(whole) // 2, len(whole) - 3)]
    hold_all(cases, tmp_path)


# ---------------------------------------------------------------------------
# CCITT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["tiff_ccitt", "group3", "group4"])
def test_ccitt_written_by_pil_matches_cv2(compression, tmp_path):
    """PIL's Modified Huffman, T.4 and T.6 (libtiff's encoders) at sizes
    from one pixel to a row past the 2560-pixel extended make-up codes."""
    import io

    rng = rng_of(len(compression))
    cases = []
    for h, w in ((1, 1), (5, 7), (40, 130), (6, 3001), (33, 64)):
        bio = io.BytesIO()
        bilevel(rng, h, w).save(bio, "TIFF", compression=compression)
        cases.append(((h, w), bio.getvalue()))
    hold_all(cases, tmp_path)


FAX_FIXTURES = [n for n in FIXTURES if any(k in n for k in ("g3", "g4", "mh", "rlew", "ccitt", "group"))]


@pytest.mark.parametrize("name", FAX_FIXTURES)
def test_ccitt_bit_errors_match_cv2(name):
    """Bits flipped in a CCITT strip: bad code words, lost EOLs, runs past
    the row. Where the port decodes the file its arrays equal cv2's; where
    it refuses, the data ends before a row is whole, and cv2's rows from
    there on are its buffer as it was (not defined)."""
    from tpu3dlm_torch.data import containers

    with open(os.path.join(TIFF, name), "rb") as f:
        data = f.read()
    _, tags = containers._tiff_ifd(data, name)
    offsets, counts = tags.get(273) or tags[324], tags.get(279) or tags[325]
    rng = rng_of(len(name), 7)
    decoded = 0
    for _ in range(40):
        flipped = bytearray(data)
        k = int(rng.integers(len(offsets)))
        flipped[offsets[k] + int(rng.integers(counts[k]))] ^= 1 << int(rng.integers(8))
        flipped = bytes(flipped)
        try:
            got = codecs.decode_unchanged(flipped)
        except ValueError as e:
            assert "not defined in cv2" in str(e), e
            continue
        decoded += 1
        want = cv2.imdecode(np.frombuffer(flipped, np.uint8), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(codecs.decode_image(flipped)[..., ::-1],
                                      cv2.imdecode(np.frombuffer(flipped, np.uint8), cv2.IMREAD_COLOR))
    assert decoded >= 20


def test_ccitt_cut_strips_are_refused_and_whole_ones_decode():
    """A CCITT strip cut short: the rows before the cut are cv2's, the rest
    not defined, so the port refuses naming why; the uncut file decodes."""
    for name in ("g3_1d.tif", "g3_2d_fillbits_min_is_black.tif", "g4.tif", "mh.tif"):  # one strip each
        with open(os.path.join(TIFF, name), "rb") as f:
            data = f.read()
        (at,) = struct.unpack("<I", data[4:8])
        cut = bytearray(data)
        (n,) = struct.unpack("<H", data[at:at + 2])
        for i in range(n):
            e = at + 2 + 12 * i
            if struct.unpack("<H", data[e:e + 2])[0] == 279:
                (count,) = struct.unpack("<I", data[e + 8:e + 12])
                cut[e + 8:e + 12] = struct.pack("<I", count // 3)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(codecs.decode_unchanged(data), want)
        with pytest.raises(ValueError, match="not defined in cv2"):
            codecs.decode_unchanged(bytes(cut))


# ---------------------------------------------------------------------------
# JPEG-in-TIFF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["RGB", "YCbCr", "L", "CMYK"])
def test_jpeg_in_tiff_written_by_pil_matches_cv2(mode, tmp_path):
    """PIL's JPEG compression (libtiff's tif_jpeg.c: JPEGTables, one
    abbreviated stream a strip, YCbCr 2x2 for colour) at several qualities
    and sizes, odd ones among them."""
    import io

    from PIL import Image

    rng = rng_of(len(mode), 3)
    cases = []
    for h, w in ((1, 1), (17, 33), (40, 56), (64, 64)):
        y, x = np.mgrid[:h, :w]
        img = ((x * 5 + y * 3)[..., None] + np.array([0, 60, 120]) + rng.integers(0, 40, (h, w, 3))).astype(np.uint8)
        for quality in (50, 95):
            bio = io.BytesIO()
            Image.fromarray(img).convert(mode).save(bio, "TIFF", compression="jpeg", quality=quality)
            cases.append(((h, w, quality), bio.getvalue()))
    hold_all(cases, tmp_path)


def test_jpeg_in_tiff_of_the_chip_writer_matches_cv2(tmp_path):
    """``chip_smoke.write_tiff_jpeg`` (the port's encoder in tiles, tables
    apart) at tile sizes that cut the image or not, on the capture's frame
    and on noise."""
    import chip_smoke

    frame = cv2.imread(os.path.join(CAPTURE, "maintenance", "rtabmap_extract", "data_rgb", "1.jpg"), cv2.IMREAD_COLOR)
    rng = rng_of(9)
    cases = [(("frame", tile), chip_smoke.write_tiff_jpeg(frame, tile)) for tile in (64, 256)]
    cases += [(("noise", h, w), chip_smoke.write_tiff_jpeg(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 16))
              for h, w in ((1, 1), (23, 40))]
    hold_all(cases, tmp_path)


# ---------------------------------------------------------------------------
# YCbCr
# ---------------------------------------------------------------------------

SUBSAMPLINGS = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (2, 4), (1, 4), (3, 1)]


@pytest.mark.parametrize("subsampling", SUBSAMPLINGS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ycbcr_subsamplings_match_cv2(subsampling, tmp_path):
    """YCbCr sampling units at each subsampling, uncompressed, LZW, Deflate
    and PackBits, in strips (of rows that are and are not a multiple of the
    vertical subsampling) and in tiles cut by the image's edges: libtiff's
    putcontig8bitYCbCr* routines where it has one, with its quirks at 4x4
    (tiles skip the columns past the image by units of 10 bytes; a strip is
    read 2 bytes short for an odd count of units, the bytes left zero), and
    cv2's refusal where it has none."""
    rng = rng_of(*subsampling)
    cases = []
    for h, w in ((1, 1), (7, 5), (37, 21), (13, 9)):
        ycc = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for comp in (1, 5, 8, 32773):
            for lay in ({}, dict(rows_per_strip=4), dict(rows_per_strip=5), dict(tile=(16, 16)), dict(tile=(32, 16))):
                cases.append(((h, w, comp, lay), mk.tiff(ycc, 6, comp, subsampling=subsampling, **lay)))
    hold_all(cases, tmp_path)


def test_ycbcr_coefficients_reference_and_planes_match_cv2(tmp_path):
    """YCbCrCoefficients and ReferenceBlackWhite through TIFFYCbCrToRGBInit's
    tables, planes at 1x1 (putseparate8bitYCbCr11tile) and the planes and
    sample counts libtiff refuses."""
    rng = rng_of(529)
    ycc = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    cases = []
    for tags in ({529: (5, [2990, 10000, 5870, 10000, 1140, 10000])}, {529: (5, [2126, 10000, 7152, 10000, 722, 10000])},
                 {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])},
                 {532: (5, [0, 1, 255, 1, 0, 1, 255, 1, 0, 1, 255, 1])}, {529: (5, [1, 2, 0, 1, 1, 2])}):
        for sub in ((1, 1), (2, 2)):
            cases.append(((tags, sub), mk.tiff(ycc, 6, 1, subsampling=sub, extra_tags=tags)))
        cases.append((("planar", tags), mk.tiff(ycc, 6, 8, planar=2, extra_tags={**tags, 530: (3, [1, 1])})))
    cases.append(("planar 2x2", mk.tiff(ycc, 6, 1, planar=2, extra_tags={530: (3, [2, 2])})))
    cases.append(("4 samples", mk.tiff(rng.integers(0, 256, (9, 11, 4), dtype=np.uint8), 6, 1, subsampling=(1, 1))))
    cases.append(("16 bits", mk.tiff(rng.integers(0, 65536, (9, 11, 3), dtype=np.uint16), 6, 1)))
    hold_all(cases, tmp_path)


# ---------------------------------------------------------------------------
# CIELab
# ---------------------------------------------------------------------------


def test_cielab_matches_cv2(tmp_path):
    """Every 8-bit L and a with b in steps of 5 (TIFFCIELab16ToXYZ,
    TIFFXYZToRGB with tif_getimage.c's sRGB display, in libtiff's float
    order), random 16-bit samples, other white points and planes, 4 samples
    and ICCLab / ITULab (refused by cv2)."""
    rng = rng_of(8)
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(0, 256, 5), indexing="ij"), -1)
    lab = grid.reshape(256, -1, 3).astype(np.uint8)
    lab16 = rng.integers(0, 65536, (64, 300, 3), dtype=np.uint16)
    small = lab[:16, :40]
    cases = [("8-bit grid", mk.tiff(lab, 8, 8)), ("16-bit", mk.tiff(lab16, 8, 8)),
             ("16-bit be tiles", mk.tiff(lab16[:20, :40], 8, 5, tile=(16, 16), order=">")),
             ("D65", mk.tiff(small, 8, 1, extra_tags={318: (5, [3127, 10000, 3290, 10000])})),
             ("white point y 0", mk.tiff(small, 8, 1, extra_tags={318: (5, [3127, 10000, 0, 1])})),
             ("planar", mk.tiff(small, 8, 1, planar=2)),
             ("4 samples", mk.tiff(np.concatenate([small, small[..., :1]], -1), 8, 1, extra=[0])),
             ("ICCLab", mk.tiff(small, 9, 1)), ("ITULab", mk.tiff(small, 10, 1))]
    hold_all(cases, tmp_path)


# ---------------------------------------------------------------------------
# 10-, 12- and 14-bit samples
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [10, 12, 14])
def test_deep_samples_match_cv2(bits, tmp_path):
    """Gray, RGB and RGBA of 10, 12 and 14 bits packed MSB first:
    IMREAD_UNCHANGED gives uint16 with each sample moved to the top bits,
    IMREAD_COLOR refuses (libtiff's RGBA reader has no such depth), as do 2
    samples, YCbCr, CIELab and the horizontal predictor (libtiff has it for
    8 to 64 bits only). Planes go through cv2's raw path, not defined: held
    to their own samples."""
    rng = rng_of(bits)
    cases = []
    for spp, ph, extra in ((1, 1, None), (1, 0, None), (3, 2, None), (4, 2, [2]), (2, 1, [2]), (3, 6, None),
                           (3, 8, None)):
        for comp, kw in ((1, {}), (5, {}), (8, {}), (5, dict(predictor=2)), (1, dict(order=">")),
                         (1, dict(rows_per_strip=3)), (8, dict(tile=(16, 16)))):
            s = rng.integers(0, 1 << bits, (7, 19, spp)).astype(np.uint16)
            cases.append(((spp, ph, comp, kw), mk.tiff(s, ph, comp, bits=bits, extra=extra, **kw)))
        if spp in (3, 4) and ph == 2:
            s = rng.integers(0, 1 << bits, (7, 19, spp)).astype(np.uint16)
            data = mk.tiff(s, ph, 5, bits=bits, planar=2, extra=extra)
            np.testing.assert_array_equal(codecs.decode_unchanged(data), (s << (16 - bits))[..., [2, 1, 0, 3][:spp]])
            assert reference("color", data) is None and port("color", data) is None
    hold_all(cases, tmp_path)


# ---------------------------------------------------------------------------
# What cv2 refuses, and why
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", sorted(LACKED))
def test_compressions_cv2_lacks_are_refused_in_its_terms(compression, tmp_path):
    """cv2's libtiff is built without these codecs ("... compression support
    is not configured"): cv2 returns None, and the port refuses naming the
    codec and saying so, never that it is not yet ported."""
    data = with_compression(mk.tiff(rng_of(compression).integers(0, 256, (6, 5, 3), dtype=np.uint8), 2, 1),
                            compression)
    hold(data, tmp_path, compression)
    for decode in (codecs.decode_image, codecs.decode_unchanged):
        with pytest.raises(ValueError) as e:
            decode(data)
        assert f"{LACKED[compression]} compression ({compression}): cv2's libtiff is built without it" in str(e.value)
        assert "not yet ported" not in str(e.value)


def test_refusals_say_why():
    c = rng_of(13).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    for data, why in ((with_compression(mk.tiff(c, 2, 1), 32766), r"NeXT compression \(32766\) is not yet ported"),
                      (with_compression(mk.tiff(c, 2, 1), 34712), "has no decoder in libtiff"),
                      (mk.tiff(c, 9, 1), r"ICCLab \(9\): libtiff's RGBA reader refuses it"),
                      (mk.tiff(c, 6, 1, subsampling=(2, 4)), "has no routine for it"),
                      (mk.tiff(c.astype(np.uint16), 1, 5, bits=12, predictor=2), "predictor with 12-bit")):
        with pytest.raises(ValueError, match=why):
            codecs.decode_unchanged(data)


def test_chip_bigtiff_writer_decodes_to_its_source_in_cv2():
    """``chip_smoke.write_tiff`` with ``big`` (LZW or Deflate strips, predictor 2)
    decodes in cv2 and the port to the array it was written from: RGB,
    RGBA and 16-bit gray."""
    import chip_smoke

    rng = rng_of(16)
    frame = cv2.imread(os.path.join(CAPTURE, "maintenance", "rtabmap_extract", "data_rgb", "1.jpg"), cv2.IMREAD_COLOR)
    sources = [frame, rng.integers(0, 256, (13, 7, 3), dtype=np.uint8), rng.integers(0, 256, (5, 3, 4), dtype=np.uint8),
               rng.integers(0, 65536, (17, 9), dtype=np.uint16)]
    for src in sources:
        for compression in (5, 8):
            data = chip_smoke.write_tiff(src, compression, big=True)
            assert data[:4] == b"II+\x00"
            np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED), src)
            np.testing.assert_array_equal(codecs.decode_unchanged(data), src)


# ---------------------------------------------------------------------------
# The reference's readers and CLI on BigTIFF and JPEG-in-TIFF frames
# ---------------------------------------------------------------------------


def capture_frames():
    """The capture's maintenance frame 2 as JPEG-in-TIFF and LZW BigTIFF
    and its depth as 16-bit BigTIFF and a 4-channel BigTIFF."""
    import chip_smoke

    ext = os.path.join(CAPTURE, "maintenance", "rtabmap_extract")
    bgr = cv2.imread(os.path.join(ext, "data_rgb", "2.jpg"), cv2.IMREAD_COLOR)
    bgra = cv2.imread(os.path.join(ext, "data_depth", "2.png"), cv2.IMREAD_UNCHANGED)
    mm = np.rint(bgra.copy().view(np.float32)[..., 0].astype(np.float64) * 1000).astype(np.uint16)
    rgb = {"tiles.tif": chip_smoke.write_tiff_jpeg(bgr), "big.tif": chip_smoke.write_tiff(bgr, 5, big=True)}
    depth = {"mm16_big.tif": chip_smoke.write_tiff(mm, big=True), "bgra_big.tif": chip_smoke.write_tiff(bgra, big=True)}
    return rgb, depth


def outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return e


def test_load_rgb_and_depth_images_follow_the_reference(tmp_path):
    from tpu3dlm.data.dataset import load_depth_image as jax_depth
    from tpu3dlm.data.dataset import load_rgb_image as jax_rgb

    rgb, depth = capture_frames()
    for name, data in rgb.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        for size in (None, (96, 96)):
            np.testing.assert_array_equal(load_rgb_image(path, size), jax_rgb(path, size), err_msg=name)
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
    """``fetch_data`` and ``fetch_arrays`` on a data.db whose image blobs are
    JPEG-in-TIFF and BigTIFF and whose depth blobs are 16-bit and 4-channel
    BigTIFF: the same rows and arrays as the reference's."""
    from tpu3dlm.data import rtabmap_db as JR

    from tpu3dlm_torch.data import rtabmap_db as PR

    rgb, depth = capture_frames()
    scan = tmp_path / "maintenance"
    shutil.copytree(os.path.join(CAPTURE, "maintenance"), scan)
    db = str(scan / "data.db")
    conn = sqlite3.connect(db)
    rows = [r for r, in conn.execute("SELECT id FROM Data ORDER BY id")]
    plan = {rows[0]: ("tiles.tif", "mm16_big.tif"), rows[1]: ("big.tif", "bgra_big.tif"),
            rows[2]: ("tiles.tif", "bgra_big.tif")}
    for i, (im, dp) in plan.items():
        conn.execute("UPDATE Data SET image = ?, depth = ? WHERE id = ?", (rgb[im], depth[dp], i))
    conn.commit()
    conn.close()
    outs = {}
    for key, module in (("port", PR), ("jax", JR)):
        ex = module.ImageExtractor(db, str(tmp_path / key / "d"), str(tmp_path / key / "r"))
        n = ex.fetch_data()
        arrays = ex.fetch_arrays()
        outs[key] = (n, arrays, list(ex.node_ordinals))
        ex.close()
    (pn, (prgb, pdep), pord), (jn, (jrgb, jdep), jord) = outs["port"], outs["jax"]
    assert (pn, pord) == (jn, jord) and pn == 5
    for a, b in zip(prgb + pdep, jrgb + jdep):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for sub in ("d", "r"):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub))
        for name in names:
            p, j = (str(tmp_path / k / sub / name) for k in ("port", "jax"))
            np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), cv2.imread(j, cv2.IMREAD_UNCHANGED))
