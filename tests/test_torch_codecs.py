"""The port's image codecs (``tpu3dlm_torch/data/codecs.py`` and
``csrc/host/codecs.cpp``) against cv2, which the reference decodes and
resizes with: PNG, JPEG and the resizes byte for byte."""

import os
import zlib

import cv2
import numpy as np
import pytest

from tpu3dlm_torch.data import codecs
from tpu3dlm_torch.data.dataset import load_depth_image, load_rgb_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTURE = os.path.join(REPO, "tests", "fixtures", "torch_project", "data")


def capture_files(sub: str, suffix: str) -> list[str]:
    """generate_scan's files of both scans of the committed capture."""
    out = []
    for folder in ("gold_std", "maintenance"):
        d = os.path.join(CAPTURE, folder, "rtabmap_extract", sub)
        out += [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(suffix)]
    return out


def test_png_matches_cv2_on_generated_depth():
    paths = capture_files("data_depth", ".png")
    assert len(paths) == 10
    for p in paths:
        want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        got = codecs.read_png(p)
        assert got.dtype == want.dtype and got.shape == want.shape == (256, 192, 4)
        np.testing.assert_array_equal(got, want)


def png_filters(data: bytes) -> set[int]:
    """The row filter types a (non-interlaced) PNG uses."""
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = int.from_bytes(ihdr[:4], "big"), int.from_bytes(ihdr[4:8], "big"), ihdr[8], ihdr[9]
    channels = {0: 1, 2: 3, 6: 4}[color]
    row = 1 + w * channels * depth // 8
    raw = zlib.decompress(idat)
    return {raw[r * row] for r in range(h)}


def random_images(rng):
    h, w = 61, 53
    noise8 = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    ramp = (np.add.outer(np.arange(h), np.arange(w)) * 3 % 256).astype(np.uint8)
    smooth = np.stack([ramp, ramp // 2, 255 - ramp, ramp], -1)
    mixed = np.where(rng.uniform(size=(h, w, 1)) < 0.5, noise8, smooth)
    for name, img in (("noise", noise8), ("smooth", smooth), ("mixed", mixed)):
        yield f"{name}-gray", img[..., 0].copy()
        yield f"{name}-bgr", img[..., :3].copy()
        yield f"{name}-bgra", img
        wide = img[..., 0].astype(np.uint16) * 257 + rng.integers(0, 256, (h, w), dtype=np.uint16)
        yield f"{name}-u16", wide


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_png_matches_cv2_on_random_images(level):
    rng = np.random.default_rng(level)
    filters = set()
    for name, img in random_images(rng):
        ok, enc = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        assert ok
        data = enc.tobytes()
        filters |= png_filters(data)
        want = cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)
        got = codecs.decode_png(data, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if level > 0:  # cv2 picks the filter per row; level 0 writes filter None only
        assert filters == {0, 1, 2, 3, 4}, filters


def test_every_png_filter_type_occurs_across_levels():
    rng = np.random.default_rng(7)
    seen = set()
    for level in (0, 1, 6, 9):
        for _, img in random_images(rng):
            seen |= png_filters(cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])[1].tobytes())
    assert seen == {0, 1, 2, 3, 4}


def test_png_refusals(tmp_path):
    """What the port refuses is what cv2 refuses (a CRC mismatch, a cut
    file); 16-bit RGB, once refused, decodes as cv2 decodes it (every PNG
    layout: tests/test_torch_codecs_modes.py)."""
    rgb16 = np.random.default_rng(1).integers(0, 65536, (4, 5, 3), dtype=np.uint16)
    enc = cv2.imencode(".png", rgb16)[1]
    got = codecs.decode_png(enc.tobytes(), "rgb16.png")
    assert got.dtype == np.uint16 and got.shape == (4, 5, 3)
    np.testing.assert_array_equal(got, cv2.imdecode(enc, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(got, rgb16)
    data = bytearray(cv2.imencode(".png", np.zeros((4, 5), np.uint8))[1].tobytes())
    data[30] ^= 0xFF  # inside IHDR: the CRC no longer matches
    with pytest.raises(ValueError, match="CRC"):
        codecs.decode_png(bytes(data), "bad.png")
    good = cv2.imencode(".png", np.zeros((40, 50, 4), np.uint8))[1].tobytes()
    p = tmp_path / "cut.png"
    p.write_bytes(good[: len(good) // 2])
    with pytest.raises(ValueError, match="undecodable PNG .*cut.png"):
        load_depth_image(str(p), 40, 50)
    with pytest.raises(FileNotFoundError):
        load_depth_image(str(tmp_path / "absent.png"), 40, 50)


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "u16"])
def test_write_png_round_trips_through_cv2(tmp_path, kind):
    rng = np.random.default_rng(3)
    img = {
        "gray": rng.integers(0, 256, (17, 9), dtype=np.uint8),
        "bgr": rng.integers(0, 256, (17, 9, 3), dtype=np.uint8),
        "bgra": rng.integers(0, 256, (17, 9, 4), dtype=np.uint8),
        "u16": rng.integers(0, 65536, (17, 9), dtype=np.uint16),
    }[kind]
    p = str(tmp_path / "x.png")
    codecs.write_png(p, img)
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    assert back.dtype == img.dtype and back.shape == img.shape
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(codecs.read_png(p), img)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

SAMPLING = {"420": 0x221111, "422": 0x211111, "444": 0x111111}


def jpeg_sources(h: int, w: int, rng):
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(h + w - 2, 1)], -1).astype(np.uint8)
    return {"noise": noise, "gradient": grad}


def cv2_rgb(enc: np.ndarray) -> np.ndarray:
    return cv2.cvtColor(cv2.imdecode(enc, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def test_jpeg_matches_cv2_on_generated_frames():
    paths = capture_files("data_rgb", ".jpg")
    assert len(paths) == 10
    for p in paths:
        want = cv2.cvtColor(cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(codecs.read_jpeg(p), want)
        np.testing.assert_array_equal(load_rgb_image(p), want)


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("hw", [(480, 640), (481, 643), (17, 9), (1, 1)])
def test_jpeg_matches_cv2(hw, sampling):
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    for kind, img in jpeg_sources(*hw, rng).items():
        for quality in (50, 75, 95, 100):
            for restart in (0, 2):
                params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                          cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
                ok, enc = cv2.imencode(".jpg", img, params)
                assert ok
                if restart:
                    assert b"\xff\xdd" in enc.tobytes()  # a DRI segment was written
                got = codecs.decode_jpeg(enc.tobytes(), kind)
                np.testing.assert_array_equal(got, cv2_rgb(enc), err_msg=f"{kind} q{quality} rst{restart}")


@pytest.mark.parametrize("hw", [(480, 640), (17, 9), (1, 1)])
def test_grayscale_jpeg_matches_cv2(hw):
    rng = np.random.default_rng(5)
    for img in jpeg_sources(*hw, rng).values():
        ok, enc = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2GRAY), [cv2.IMWRITE_JPEG_QUALITY, 90])
        np.testing.assert_array_equal(codecs.decode_jpeg(enc.tobytes()), cv2_rgb(enc))


def test_jpeg_refusals_and_errors(tmp_path):
    """The reference raises ValueError where cv2.imread returns None and
    FileNotFoundError for a missing file; the port does the same. cv2.imread
    decodes a progressive file, and a file cut inside its entropy-coded data
    or just before EOI (libjpeg's stdio source feeds a fake EOI marker, so
    the missing blocks keep zero coefficients: grey where nothing was
    decoded), and the port gives the same bytes. A file cut inside its
    headers, and bytes that are no image, raise (cv2 returns None).
    cv2.imdecode of cut bytes returns None and decode_jpeg raises: that form
    runs out of data instead of meeting a fake marker. Lossless and 12-bit
    JPEG, which the port still refuses: tests/test_torch_codecs_modes.py."""
    img = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    progressive = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    baseline = cv2.imencode(".jpg", img)[1].tobytes()
    cases = {"progressive.jpg": progressive, "cut_scan.jpg": baseline[: len(baseline) // 2],
             "cut_header.jpg": baseline[:200], "cut_eoi.jpg": baseline[:-2], "junk.jpg": b"\xff\xd8junk"}
    for name, data in cases.items():
        p = tmp_path / name
        p.write_bytes(data)
        want = cv2.imread(str(p), cv2.IMREAD_COLOR)
        if name in ("cut_header.jpg", "junk.jpg"):
            assert want is None
            with pytest.raises(ValueError, match=f"undecodable JPEG .*{name}"):
                load_rgb_image(str(p))
        else:
            np.testing.assert_array_equal(load_rgb_image(str(p)), cv2.cvtColor(want, cv2.COLOR_BGR2RGB))
        if name != "progressive.jpg":
            assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
            with pytest.raises(ValueError, match="undecodable JPEG"):
                codecs.decode_jpeg(data, name)
    np.testing.assert_array_equal(codecs.decode_jpeg(progressive), cv2_rgb(np.frombuffer(progressive, np.uint8)))
    with pytest.raises(FileNotFoundError):
        load_rgb_image(str(tmp_path / "absent.jpg"))


# ---------------------------------------------------------------------------
# Resizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "src_hw,dst_wh",
    [((640, 480), (640, 640)), ((640, 480), (128, 128)), ((640, 480), (96, 128)),
     ((480, 640), (128, 96)), ((640, 480), (320, 320)), ((480, 640), (320, 240)),
     ((17, 9), (20, 33)), ((5, 7), (13, 11)), ((100, 101), (53, 37)), ((1, 1), (3, 2)),
     ((640, 480), (480, 640))],
)
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_linear_matches_cv2(src_hw, dst_wh, channels):
    rng = np.random.default_rng(src_hw[0] + dst_wh[0] + channels)
    img = rng.integers(0, 256, src_hw + ((channels,) if channels > 1 else ()), dtype=np.uint8)
    want = cv2.resize(img, dst_wh, interpolation=cv2.INTER_LINEAR)
    got = codecs.resize_linear(img, dst_wh)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_linear_matches_cv2_on_random_shapes():
    rng = np.random.default_rng(11)
    for _ in range(60):
        sh, sw, dh, dw = (int(v) for v in rng.integers(1, 70, 4))
        img = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(codecs.resize_linear(img, (dw, dh)), want)


@pytest.mark.parametrize("src_hw,dst_wh", [((192, 144), (192, 256)), ((512, 384), (192, 256)),
                                           ((256, 192), (192, 256)), ((7, 5), (3, 11))])
def test_resize_nearest_matches_cv2(src_hw, dst_wh):
    depth = np.random.default_rng(1).uniform(0, 5000, src_hw).astype(np.float32)
    want = cv2.resize(depth, dst_wh, interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(codecs.resize_nearest(depth, dst_wh), want)


def test_16bit_depth_png_follows_the_reference(tmp_path):
    from tpu3dlm.data.dataset import load_depth_image as jax_load_depth

    mm = np.random.default_rng(2).integers(0, 8000, (144, 192), dtype=np.uint16)
    p = str(tmp_path / "d.png")
    cv2.imwrite(p, mm)
    np.testing.assert_array_equal(load_depth_image(p, 256, 192), jax_load_depth(p, 256, 192))
    np.testing.assert_array_equal(load_depth_image(p, 144, 192), jax_load_depth(p, 144, 192))


def test_missing_compiler_raises(monkeypatch):
    from tpu3dlm_torch.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        build._cxx()
