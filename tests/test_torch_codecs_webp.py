"""WebP in the port (``tpu3dlm_torch/data/webp.py`` over
``csrc/host/webp.cpp``) against cv2 5.0 here, byte for byte: the committed
fixtures (``tests/fixtures/codecs/webp``, from ``make_webp.c`` and cv2),
``cv2.imencode(".webp")`` at every quality on odd sizes and 640x480, BGR,
BGRA and gray, PIL at every method with its alpha and exact options, EXIF
orientations, animations, cut files and RIFF sizes, each under IMREAD_COLOR
and IMREAD_UNCHANGED, as bytes (``imdecode``) and as a file (``imread``),
with a ``ValueError`` where cv2 returns None. Then the JAX package's readers
and its two-scan CLI on a WebP capture against the port's."""

import glob
import io
import json
import os
import shutil
import sqlite3
import struct
import sys

import cv2
import numpy as np
import pytest

from tpu3dlm_torch.data import codecs, webp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_codecs_containers import digest, hold, outcome, port, reference  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEBP = os.path.join(REPO, "tests", "fixtures", "codecs", "webp")
CAPTURE = os.path.join(REPO, "tests", "fixtures", "torch_project", "data")
FIXTURES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(WEBP, "*.webp")))


def encode(img: np.ndarray, quality: int) -> bytes:
    return cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()


def picture(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """A smooth image with noise: every intra mode and coefficient band."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(1, h // 6), max(1, w // 6), channels), dtype=np.uint8)
    base = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR).reshape(h, w, channels)
    noise = rng.integers(-12, 13, base.shape)
    return np.clip(base.astype(int) + noise, 0, 255).astype(np.uint8).squeeze()


def chunks(data: bytes) -> list:
    out, pos = [], 12
    while pos + 8 <= len(data):
        n = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\x00" if len(body) & 1 else b"")


def riff(body: bytes, extra: int = 0) -> bytes:
    return b"RIFF" + struct.pack("<I", len(body) + 4 + extra) + b"WEBP" + body


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", struct.pack("<I", flags) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def exif(orientation: int) -> bytes:
    return b"MM\x00\x2a\x00\x00\x00\x08\x00\x01\x01\x12\x00\x03\x00\x00\x00\x01" + bytes([0, orientation]) + bytes(6)


def anmf(x: int, y: int, w: int, h: int, bits: int, frame: bytes) -> bytes:
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 100)) + bytes([bits])
    return chunk(b"ANMF", head + frame)


# ---------------------------------------------------------------------------
# The committed fixtures
# ---------------------------------------------------------------------------


def test_webp_fixture_count():
    assert len(FIXTURES) == 136
    assert sum(name.startswith("refused_") for name in FIXTURES) == 4


@pytest.mark.parametrize("name", FIXTURES)
def test_webp_fixture_matches_cv2(name, tmp_path):
    with open(os.path.join(WEBP, name), "rb") as f:
        hold(f.read(), tmp_path, name)


def test_webp_digests_match_cv2_and_the_port():
    """``webp/digests.json`` (what ``chip_smoke.py`` holds the port to on
    the card host) is cv2's ``imread`` of every fixture, ``null`` where it
    returns None, and the port's file form gives it."""
    with open(os.path.join(WEBP, "digests.json")) as f:
        digests = json.load(f)
    assert sorted(digests) == FIXTURES
    assert sum(v[k] is None for v in digests.values() for k in v) == 8
    for name, want in digests.items():
        path = os.path.join(WEBP, name)
        for kind in ("color", "unchanged"):
            ref = reference(kind, path)
            assert want[kind] == (None if ref is None else digest(ref)), (name, kind)
            got = port(kind, path)
            assert (None if got is None else digest(got)) == want[kind], (name, kind)


def test_capture_fixtures_are_the_frames_cv2_writes():
    """The capture's WebP frames: lossless decodes to the JPEG's pixels,
    q90 within 19 levels of them, the depth to the CV_8UC4 blob's bytes."""
    conn = sqlite3.connect(os.path.join(CAPTURE, "maintenance", "data.db"))
    for i, image, depth in conn.execute("SELECT id, image, depth FROM Data ORDER BY id"):
        bgr = cv2.imdecode(np.frombuffer(image, np.uint8), cv2.IMREAD_COLOR)
        bgra = cv2.imdecode(np.frombuffer(depth, np.uint8), cv2.IMREAD_UNCHANGED)
        path = os.path.join(WEBP, f"capture_maintenance_{i}_webp_lossless.webp")
        assert open(path, "rb").read() == encode(bgr, 101)
        np.testing.assert_array_equal(codecs.read_image(path)[..., ::-1], bgr)
        lossy = codecs.read_image(os.path.join(WEBP, f"capture_maintenance_{i}_webp_q90.webp"))[..., ::-1]
        assert np.abs(lossy.astype(int) - bgr).max() <= 19
        np.testing.assert_array_equal(codecs.read_unchanged(os.path.join(WEBP, f"capture_maintenance_{i}_depth.webp")),
                                      bgra)
    conn.close()


# ---------------------------------------------------------------------------
# What cv2 and PIL write
# ---------------------------------------------------------------------------

SIZES = [(1, 1), (9, 17), (17, 9), (23, 31), (47, 65)]


@pytest.mark.parametrize("kind", ["bgr", "bgra", "gray"])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_cv2_every_quality_matches_cv2(hw, kind, tmp_path):
    h, w = hw
    img = picture(h, w, {"bgr": 3, "bgra": 4, "gray": 1}[kind], h * 100 + w)
    for q in range(1, 102):
        hold(encode(img, q), tmp_path, (kind, hw, q))


@pytest.mark.parametrize("quality", [1, 30, 60, 90, 100, 101])
def test_cv2_full_frame_matches_cv2(quality, tmp_path):
    img = picture(480, 640, 3, quality)
    hold(encode(img, quality), tmp_path, ("640x480", quality))
    bgra = np.dstack([picture(480, 640, 3, quality + 1), picture(480, 640, 1, quality + 2)])
    hold(encode(bgra, quality), tmp_path, ("640x480 bgra", quality))


@pytest.mark.parametrize("method", range(7))
def test_pil_methods_and_options_match_cv2(method, tmp_path):
    from PIL import Image

    rgba = picture(45, 70, 4, method)
    rgba[..., 3] = np.where(rgba[..., 3] > 140, 255, rgba[..., 3])
    rgba[:10, :10, 3] = 0
    for mode, img in (("RGBA", rgba), ("RGB", rgba[..., :3])):
        for kw in ({"quality": 80}, {"quality": 5}, {"lossless": True}, {"lossless": True, "quality": 0},
                   {"quality": 70, "alpha_quality": 30}, {"lossless": True, "exact": True},
                   {"quality": 50, "exact": True}):
            bio = io.BytesIO()
            Image.fromarray(np.ascontiguousarray(img), mode).save(bio, "WEBP", method=method, **kw)
            hold(bio.getvalue(), tmp_path, (mode, method, kw))


# ---------------------------------------------------------------------------
# Containers: VP8X, alpha, EXIF, animation, cut files, RIFF sizes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parts():
    """Bitstreams of one 64x48 picture: VP8, VP8 with its ALPH, VP8L
    opaque and with alpha; and of a 32x24 one for animation frames."""
    img = picture(48, 64, 3, 21)
    alpha = picture(48, 64, 1, 22)
    small, small_alpha = img[:24, :32].copy(), alpha[:24, :32].copy()
    out = {}
    for key, (im, a) in (("", (img, alpha)), ("s_", (small, small_alpha))):
        lossy = chunks(encode(np.dstack([im, a]), 80))
        out[key + "vp8"] = chunks(encode(im, 80))[0][1]
        out[key + "alph"], out[key + "vp8a"] = lossy[1][1], lossy[2][1]
        out[key + "vp8l"] = chunks(encode(im, 101))[0][1]
        out[key + "vp8la"] = chunks(encode(np.dstack([im, a]), 101))[0][1]
    out["alpha_plane"] = alpha
    return out


def test_alpha_channels_follow_the_header_as_in_cv2(parts, tmp_path):
    """4 channels where VP8X's alpha flag or a simple VP8L's alpha hint is
    set, whatever the pixels; an ALPH chunk after the frame is ignored."""
    p = parts
    la, l = p["vp8la"], p["vp8l"]
    cases = {
        "hint off": riff(chunk(b"VP8L", la[:4] + bytes([la[4] & ~0x10]) + la[5:])),
        "hint on": riff(chunk(b"VP8L", l[:4] + bytes([l[4] | 0x10]) + l[5:])),
        "flag off, VP8L alpha": riff(vp8x(0, 64, 48) + chunk(b"VP8L", la)),
        "flag on, VP8L opaque": riff(vp8x(0x10, 64, 48) + chunk(b"VP8L", l)),
        "flag on, no ALPH": riff(vp8x(0x10, 64, 48) + chunk(b"VP8 ", p["vp8"])),
        "flag off, ALPH": riff(vp8x(0, 64, 48) + chunk(b"ALPH", p["alph"]) + chunk(b"VP8 ", p["vp8a"])),
        "ALPH after VP8": riff(vp8x(0x10, 64, 48) + chunk(b"VP8 ", p["vp8a"]) + chunk(b"ALPH", p["alph"])),
        "ALPH before VP8L": riff(vp8x(0x10, 64, 48) + chunk(b"ALPH", p["alph"]) + chunk(b"VP8L", la)),
        "ICCP, XMP, unknown": riff(vp8x(0x24, 64, 48) + chunk(b"ICCP", b"icc") + chunk(b"ABCD", b"xy")
                                   + chunk(b"VP8 ", p["vp8"]) + chunk(b"XMP ", b"<x/>")),
    }
    for what, data in cases.items():
        hold(data, tmp_path, what)
    got = codecs.decode_unchanged(cases["flag on, no ALPH"])
    assert got.shape == (48, 64, 4) and (got[..., 3] == 255).all()


@pytest.mark.parametrize("filt", range(4))
@pytest.mark.parametrize("method", [0, 1])
def test_alpha_headers_and_unfilters_match_cv2(filt, method, parts, tmp_path):
    a = parts["alpha_plane"]
    if method == 0:
        body = a.tobytes()
    else:  # the green channel of a VP8L stream, without its 5-byte header
        body = parts["vp8la"][5:]
    for pre in (0, 1, 2):
        for rsrv in (0, 1):
            head = bytes([method | filt << 2 | pre << 4 | rsrv << 6])
            data = riff(vp8x(0x10, 64, 48) + chunk(b"ALPH", head + body) + chunk(b"VP8 ", parts["vp8a"]))
            hold(data, tmp_path, (method, filt, pre, rsrv))
    short = riff(vp8x(0x10, 64, 48) + chunk(b"ALPH", bytes([filt << 2]) + a.tobytes()[:-1])
                 + chunk(b"VP8 ", parts["vp8a"]))
    hold(short, tmp_path, "raw alpha one byte short")


@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation_matches_cv2(orientation, parts, tmp_path):
    """Applied under IMREAD_COLOR where VP8X's EXIF flag is set and the
    file demuxes; never under IMREAD_UNCHANGED."""
    e = exif(orientation)
    frame = chunk(b"VP8 ", parts["vp8"])
    cases = {
        "after": riff(vp8x(0x08, 64, 48) + frame + chunk(b"EXIF", e)),
        "before": riff(vp8x(0x08, 64, 48) + chunk(b"EXIF", e) + frame),
        "no flag": riff(vp8x(0x00, 64, 48) + frame + chunk(b"EXIF", e)),
        "Exif prefix": riff(vp8x(0x08, 64, 48) + frame + chunk(b"EXIF", b"Exif\x00\x00" + e)),
        "simple file": riff(frame + chunk(b"EXIF", e)),
        "second EXIF": riff(vp8x(0x08, 64, 48) + frame + chunk(b"EXIF", exif(1)) + chunk(b"EXIF", e)),
        "4 stray bytes": riff(vp8x(0x08, 64, 48) + frame + chunk(b"EXIF", e) + b"abcd"),
        "empty chunk after": riff(vp8x(0x08, 64, 48) + frame + chunk(b"EXIF", e) + b"abcd" + bytes(4)),
        "reserved flag": riff(vp8x(0x09, 64, 48) + frame + chunk(b"EXIF", e)),
        "lossless alpha": riff(vp8x(0x18, 64, 48) + chunk(b"VP8L", parts["vp8la"]) + chunk(b"EXIF", e)),
    }
    for what, data in cases.items():
        hold(data, tmp_path, (orientation, what))
    if orientation in (5, 6, 7, 8):
        assert codecs.decode_image(cases["after"]).shape == (64, 48, 3)


@pytest.mark.parametrize("frame", ["vp8", "vp8_alpha", "vp8l", "vp8l_alpha"])
def test_animation_first_frame_matches_cv2(frame, parts, tmp_path):
    """The first frame on a transparent black canvas at its offset, whatever
    the background colour, blend and dispose bits; the alpha flag decides
    the channels; files libwebp's demuxer rejects are refused."""
    p = parts
    body = {"vp8": chunk(b"VP8 ", p["s_vp8"]), "vp8_alpha": chunk(b"ALPH", p["s_alph"]) + chunk(b"VP8 ", p["s_vp8a"]),
            "vp8l": chunk(b"VP8L", p["s_vp8l"]), "vp8l_alpha": chunk(b"VP8L", p["s_vp8la"])}[frame]
    anim = chunk(b"ANIM", struct.pack("<IH", 0x80402010, 0))
    for flags in (0x02, 0x12, 0x1A):
        for bits in range(4):
            for x, y in ((0, 0), (10, 6), (32, 24)):
                data = riff(vp8x(flags, 64, 48) + anim + anmf(x, y, 32, 24, bits, body) + anmf(0, 0, 32, 24, 0, body)
                            + (chunk(b"EXIF", exif(6)) if flags & 0x08 else b""))
                hold(data, tmp_path, (frame, flags, bits, x, y))
    refused = {
        "outside the canvas": riff(vp8x(0x02, 40, 30) + anim + anmf(10, 6, 32, 24, 0, body)),
        "no ANIM": riff(vp8x(0x02, 64, 48) + anmf(10, 6, 32, 24, 0, body)),
        "no animation flag": riff(vp8x(0x00, 64, 48) + anim + anmf(10, 6, 32, 24, 0, body)),
        "a plain frame": riff(vp8x(0x02, 32, 24) + anim + body),
        "no frame": riff(vp8x(0x02, 32, 24) + anim),
        "cut": riff(vp8x(0x02, 64, 48) + anim + anmf(10, 6, 32, 24, 0, body))[:-9],
    }
    for what, data in refused.items():
        hold(data, tmp_path, (frame, what))
        with pytest.raises(ValueError, match="case.bin"):
            codecs.read_image(str(tmp_path / "case.bin"))


def test_pil_animations_match_cv2(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(31)
    for mode, channels in (("RGB", 3), ("RGBA", 4)):
        frames = [Image.fromarray(rng.integers(0, 256, (40, 50, channels), dtype=np.uint8), mode) for _ in range(3)]
        for kw in ({"lossless": True}, {"quality": 80}):
            bio = io.BytesIO()
            frames[0].save(bio, "WEBP", save_all=True, append_images=frames[1:], duration=50, **kw)
            hold(bio.getvalue(), tmp_path, (mode, kw))


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha", "vp8x_exif"])
def test_cut_files_are_refused_in_both_forms(kind, parts, tmp_path):
    img = picture(48, 64, 3, 41)
    data = {"lossy": encode(img, 75), "lossless": encode(img, 101),
            "alpha": encode(np.dstack([img, parts["alpha_plane"]]), 75),
            "vp8x_exif": riff(vp8x(0x08, 64, 48) + chunk(b"VP8 ", parts["vp8"]) + chunk(b"EXIF", exif(6)))}[kind]
    for cut in sorted({1, 12, 20, 31, 32, 40, len(data) // 3, len(data) // 2, len(data) - 2, len(data) - 1}):
        hold(data[:cut], tmp_path, (kind, cut))
    path = tmp_path / "cut.webp"
    path.write_bytes(data[:len(data) // 2])
    for fn in (codecs.read_image, codecs.read_unchanged):
        with pytest.raises(ValueError, match="cut.webp"):
            fn(str(path))


def test_riff_and_chunk_sizes_match_cv2(parts, tmp_path):
    v8 = parts["vp8"]
    body = chunk(b"VP8 ", v8)
    whole = riff(body)
    cases = {
        "riff +1": riff(body, 1), "riff -1": riff(body, -1), "riff -2": riff(body, -2),
        "riff odd": riff(body + b"\x00", -1), "odd chunk": riff(chunk(b"VP8 ", v8 + b"\x01")),
        "trailing bytes": whole + bytes(100), "trailing RIFF": whole + whole,
        "chunk past data": whole[:16] + struct.pack("<I", len(v8) + 2) + whole[20:],
        "chunk short of data": whole[:16] + struct.pack("<I", len(v8) - 10) + whole[20:],
        "riff under 12": whole[:4] + struct.pack("<I", 11) + whole[8:],
        "not WEBP": whole[:8] + b"WEBQ" + whole[12:],
        "VP8X size 9": riff(chunk(b"VP8X", bytes(9)) + body),
        "VP8X wrong canvas": riff(vp8x(0, 65, 48) + body),
        "bare VP8L chunk": chunk(b"VP8L", parts["vp8la"]), "raw VP8L": parts["vp8la"], "bare VP8 chunk": body,
        "bare ALPH": chunk(b"ALPH", parts["alph"]) + chunk(b"VP8 ", parts["vp8a"]),
        "31 bytes": whole[:31],
    }
    for what, data in cases.items():
        hold(data, tmp_path, what)


def test_sniff_is_cv2s_signature_check():
    img = picture(48, 64, 3, 51)
    assert webp.sniff(encode(img, 80)) and webp.sniff(encode(img, 101))
    assert not webp.sniff(encode(img, 80)[:31])
    assert not webp.sniff(cv2.imencode(".png", img)[1].tobytes())
    with pytest.raises(ValueError, match="frame.bin: unknown format"):
        codecs.decode_image(b"RIFF\x10\x00\x00\x00WEBPVP8 " + bytes(30), "frame.bin")


def test_vp8_and_vp8l_bit_errors_are_refused_as_in_cv2(parts, tmp_path):
    """Flipped bits through the bitstreams: the port decodes what cv2
    decodes, identically, and refuses what it refuses."""
    rng = np.random.default_rng(61)
    for key in ("vp8", "vp8l", "vp8la"):
        bits = bytearray(parts[key])
        tag = b"VP8L" if key.startswith("vp8l") else b"VP8 "
        for k in range(40):
            b = bytearray(bits)
            for _ in range(1 + k % 3):
                at = int(rng.integers(10 if tag == b"VP8 " else 5, len(b)))
                b[at] ^= 1 << int(rng.integers(0, 8))
            hold(riff(chunk(tag, bytes(b))), tmp_path, (key, k))
    for quality in (10, 50, 90):  # a token partition opening with 0xff, a value past the coder's range
        frame = bytearray(chunks(encode(picture(48, 64, 3, 21), quality))[0][1])
        first = 10 + ((frame[0] | frame[1] << 8 | frame[2] << 16) >> 5)  # after the first partition
        for value in (0xFE, 0xFF):
            frame[first] = value
            hold(riff(chunk(b"VP8 ", bytes(frame))), tmp_path, ("first token byte", quality, value))


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_vp8_header_bits_match_cv2(quality, tmp_path):
    """Each bit of the first 8 bytes of the first partition flipped: the
    segment, filter and partition headers take values libwebp's encoder
    never writes (relative segment deltas, the simple filter on a normal
    stream, the mode and reference filter deltas) and decode as in cv2."""
    frame = bytearray(chunks(encode(picture(48, 64, 3, 21), quality))[0][1])
    for bit in range(10 * 8, 18 * 8):
        b = bytearray(frame)
        b[bit // 8] ^= 1 << (bit % 8)
        hold(riff(chunk(b"VP8 ", bytes(b))), tmp_path, (quality, bit))


# ---------------------------------------------------------------------------
# The reference's readers and CLI on a WebP capture
# ---------------------------------------------------------------------------


def webp_capture(root: str) -> str:
    """The committed capture with its maintenance frames as WebP: RGB
    frames lossy (quality 90) and depth frames lossless, under the names
    ``fetch_data`` gives (``<n>.jpg``, ``<n>.png``)."""
    scan = os.path.join(root, "maintenance")
    shutil.copytree(os.path.join(CAPTURE, "maintenance"), scan)
    ext = os.path.join(scan, "rtabmap_extract")
    for k in range(1, 6):
        for sub, suffix in (("data_rgb", "webp_q90"), ("data_depth", "depth")):
            name = f"{k}.jpg" if sub == "data_rgb" else f"{k}.png"
            shutil.copyfile(os.path.join(WEBP, f"capture_maintenance_{k}_{suffix}.webp"), os.path.join(ext, sub, name))
    return scan


def test_load_rgb_depth_and_scan_follow_the_reference(tmp_path):
    from tpu3dlm.data import dataset as JD

    from tpu3dlm_torch.data import dataset as PD

    scan = webp_capture(str(tmp_path))
    ext = os.path.join(scan, "rtabmap_extract")
    for k in range(1, 6):
        rgb_path, depth_path = os.path.join(ext, "data_rgb", f"{k}.jpg"), os.path.join(ext, "data_depth", f"{k}.png")
        for size in (None, (96, 96)):
            np.testing.assert_array_equal(PD.load_rgb_image(rgb_path, size), JD.load_rgb_image(rgb_path, size))
        got, want = PD.load_depth_image(depth_path, 256, 192), JD.load_depth_image(depth_path, 256, 192)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        got, want = outcome(PD.load_depth_image, depth_path, 128, 96), outcome(JD.load_depth_image, depth_path, 128, 96)
        assert isinstance(got, ValueError) and isinstance(want, ValueError) and str(got) == str(want)
    args = (os.path.join(ext, "data_rgb"), os.path.join(ext, "data_depth"), os.path.join(ext, "calibration"),
            os.path.join(scan, "poses.txt"))
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


def test_extractor_rows_follow_the_reference(tmp_path):
    """``fetch_data`` and ``fetch_arrays`` on a data.db whose blobs are WebP
    (lossy, lossless and animated images; lossless 4-channel depth, one cut
    short) keep and skip the rows the reference does, with identical arrays
    and files of identical pixels."""
    from tpu3dlm.data import rtabmap_db as JR

    from tpu3dlm_torch.data import rtabmap_db as PR

    scan = tmp_path / "maintenance"
    shutil.copytree(os.path.join(CAPTURE, "maintenance"), scan)
    db = str(scan / "data.db")
    read = lambda name: open(os.path.join(WEBP, name), "rb").read()  # noqa: E731
    conn = sqlite3.connect(db)
    rows = [r for r, in conn.execute("SELECT id FROM Data ORDER BY id")]
    plan = {rows[0]: ("capture_maintenance_1_webp_q90.webp", "capture_maintenance_1_depth.webp"),
            rows[1]: ("capture_maintenance_2_webp_lossless.webp", "capture_maintenance_2_depth.webp"),
            rows[2]: ("anim_lossy_alpha_offset_exif_6.webp", "capture_maintenance_3_depth.webp"),
            rows[3]: ("refused_cut_lossy.webp", "capture_maintenance_4_depth.webp")}
    for i, (im, dp) in plan.items():
        conn.execute("UPDATE Data SET image = ?, depth = ? WHERE id = ?", (read(im), read(dp), i))
    cut_depth = read("capture_maintenance_5_depth.webp")
    conn.execute("UPDATE Data SET depth = ? WHERE id = ?", (cut_depth[:len(cut_depth) // 2], rows[4]))
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
    assert (pn, pfiles, pord) == (jn, jfiles, jord)
    assert (pn, pord) == (4, [1, 2, 3])
    for a, b in zip(prgb + pdep, jrgb + jdep):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for sub in ("d", "r"):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub))
        for name in names:
            p, j = (str(tmp_path / k / sub / name) for k in ("port", "jax"))
            np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), cv2.imread(j, cv2.IMREAD_UNCHANGED))


def test_two_scan_cli_on_a_webp_capture_writes_the_jax_csv(tmp_path):
    """The maintenance data.db of the committed capture with lossy WebP
    image blobs and lossless WebP depth blobs: the port's CLI report equals
    the JAX CLI's byte for byte (one missing sign), at the small ICP of
    ``test_torch_codecs_modes.py``."""
    import unittest.mock as mock

    import torch
    from test_torch_codecs_modes import capture_project

    from tpu3dlm import cli as jax_cli
    from tpu3dlm.utils.config import ConfigLoader as JCfg
    from tpu3dlm_torch import cli
    from tpu3dlm_torch.utils.config import ConfigLoader

    def convert(root):
        cfg = capture_project(root, None)
        conn = sqlite3.connect(os.path.join(root, "configs", "data", "maintenance", "data.db"))
        for k, in conn.execute("SELECT id FROM Data").fetchall():
            image = open(os.path.join(WEBP, f"capture_maintenance_{k}_webp_q90.webp"), "rb").read()
            depth = open(os.path.join(WEBP, f"capture_maintenance_{k}_depth.webp"), "rb").read()
            conn.execute("UPDATE Data SET image = ?, depth = ? WHERE id = ?", (image, depth, k))
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
    assert head == b"RIFF"  # the extracted frames kept their container
