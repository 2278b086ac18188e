"""JPEG 2000 in the port (``tpu3dlm_torch/data/jpeg2000.py`` over
``csrc/host/jpeg2000.cpp``) against cv2 5.0 here (OpenJPEG 2.5.3), byte for
byte: the committed fixtures (``tests/fixtures/codecs/jpeg2000``, from
``make_jpeg2000.py``), ``cv2.imencode(".jp2")`` at every compression on odd
sizes as BGR, BGRA, gray and 16-bit gray, PIL's encoder options (wavelets,
colour transforms, progression orders, resolutions, code-blocks, precincts,
tiles, layers, raw codestreams) on sizes from 1x1, every cut point of a small
file and seeded bit errors in packet data, each under IMREAD_COLOR and
IMREAD_UNCHANGED, as bytes (``imdecode``) and as a file (``imread``), with a
``ValueError`` where cv2 returns None. The JAX package's readers, extractor
and two-scan CLI on a JPEG 2000 capture are in
``test_torch_codecs_jpeg2000_cli.py``."""

import glob
import json
import os
import sqlite3
import sys

import cv2
import numpy as np
import pytest

from tpu3dlm_torch.data import codecs, jpeg2000

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_codecs_containers import FLAGS, digest, hold, port, reference  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J2K = os.path.join(REPO, "tests", "fixtures", "codecs", "jpeg2000")
CAPTURE = os.path.join(REPO, "tests", "fixtures", "torch_project", "data")
FIXTURES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(J2K, "*")) if not p.endswith(".json"))
sys.path.insert(0, os.path.dirname(J2K))

import make_jpeg2000 as mk  # noqa: E402


def cv2_or_none(kind: str, data: bytes):
    """cv2's decode, or None where it returns None or raises (its size
    limits raise ``cv2.error`` in ``imdecode``)."""
    try:
        return reference(kind, data)
    except cv2.error:
        return None


def same_bytes_form(data: bytes, what) -> None:
    """``imdecode`` under both flags: the port's array equals cv2's or both
    refuse (the quick form for the many generated cases)."""
    for kind in FLAGS:
        want, got = cv2_or_none(kind, data), port(kind, data)
        if want is None:
            assert got is None, (what, kind, got.shape)
        else:
            assert got is not None, (what, kind, "the port refuses")
            assert got.shape == want.shape and got.dtype == want.dtype, (what, kind, got.shape, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=str((what, kind)))


# ---------------------------------------------------------------------------
# The committed fixtures
# ---------------------------------------------------------------------------


def test_jpeg2000_fixture_count():
    assert len(FIXTURES) == 186
    assert sum(name.startswith("refused_") for name in FIXTURES) == 14
    assert sum(name.startswith("opj_") for name in FIXTURES) == 44


@pytest.mark.parametrize("name", FIXTURES)
def test_jpeg2000_fixture_matches_cv2(name, tmp_path):
    with open(os.path.join(J2K, name), "rb") as f:
        hold(f.read(), tmp_path, name)


def test_jpeg2000_digests_match_cv2_and_the_port():
    """``jpeg2000/digests.json`` (what ``chip_smoke.py`` holds the port to
    on the card host) is cv2's ``imread`` of every fixture, ``null`` where
    it returns None, and the port's file form gives it."""
    with open(os.path.join(J2K, "digests.json")) as f:
        digests = json.load(f)
    assert sorted(digests) == FIXTURES
    assert sum(v[k] is None for v in digests.values() for k in v) == 54
    for name, want in digests.items():
        path = os.path.join(J2K, name)
        for kind in FLAGS:
            ref = reference(kind, path)
            assert want[kind] == (None if ref is None else digest(ref)), (name, kind)
            got = port(kind, path)
            assert (None if got is None else digest(got)) == want[kind], (name, kind)


def test_fixtures_are_what_make_jpeg2000_writes():
    """The generator is deterministic: every committed file but those of the
    system OpenJPEG (``make_jpeg2000_opj.py``, ``opj_*``) is its output."""
    made = {**mk.capture(), **mk.fixtures()}
    assert sorted(made) == [name for name in FIXTURES if "opj_" not in name]
    for name, data in made.items():
        with open(os.path.join(J2K, name), "rb") as f:
            assert f.read() == data, name


def test_capture_fixtures_are_lossless_where_cv2_writes_them():
    """The capture's frames as cv2 writes JP2 decode to the JPEG's pixels
    and the depth blob's bytes; PIL's 9/7 frames stay within 40 levels."""
    conn = sqlite3.connect(os.path.join(CAPTURE, "maintenance", "data.db"))
    for i, image, depth in conn.execute("SELECT id, image, depth FROM Data ORDER BY id"):
        bgr = cv2.imdecode(np.frombuffer(image, np.uint8), cv2.IMREAD_COLOR)
        bgra = cv2.imdecode(np.frombuffer(depth, np.uint8), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(
            codecs.read_image(os.path.join(J2K, f"capture_maintenance_{i}_lossless.jp2"))[..., ::-1], bgr)
        np.testing.assert_array_equal(
            codecs.read_unchanged(os.path.join(J2K, f"capture_maintenance_{i}_depth.jp2")), bgra)
        lossy = codecs.read_image(os.path.join(J2K, f"capture_maintenance_{i}_irreversible_q12.jp2"))[..., ::-1]
        assert np.abs(lossy.astype(int) - bgr).max() <= 40
    conn.close()


def test_sniff_is_cv2s_signature_check():
    assert jpeg2000.sniff(mk.box(b"jP  ", b"\r\n\x87\n"))
    assert jpeg2000.sniff(b"\xffO\xffQ\x00")
    assert not jpeg2000.sniff(b"\x00\x00\x00\x0cjP  \r\n\x87\x0b")
    assert not jpeg2000.sniff(b"\xffO\xffR")
    with pytest.raises(ValueError, match="undecodable JPEG 2000 x.j2k"):
        codecs.decode_image(b"\xffO\xffQ\x00\x29", "x.j2k")


# ---------------------------------------------------------------------------
# What cv2 and PIL write
# ---------------------------------------------------------------------------

CV2_SIZES = [(32, 32), (33, 35), (64, 33), (45, 101), (127, 255)]


@pytest.mark.parametrize("kind", ["bgr", "bgra", "gray", "gray16"])
@pytest.mark.parametrize("hw", CV2_SIZES, ids=[f"{h}x{w}" for h, w in CV2_SIZES])
def test_cv2_every_compression_matches_cv2(hw, kind, tmp_path):
    """cv2's writer (5/3, per-channel, 6 resolutions; its smallest image
    is 32x32) at IMWRITE_JPEG2000_COMPRESSION_X1000 from 10 to 1000: the
    passes cut short below 1000."""
    h, w = hw
    channels = {"bgr": 3, "bgra": 4, "gray": 1, "gray16": 1}[kind]
    img = mk.picture(h, w, channels, h * w + channels, noise=30)
    if kind == "gray16":
        img = img.astype(np.uint16) * 257 + np.random.default_rng(h).integers(0, 257, img.shape).astype(np.uint16)
    for c in (10, 50, 100, 250, 500, 1000):
        data = cv2.imencode(".jp2", img, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, c])[1].tobytes()
        hold(data, tmp_path, (hw, kind, c))


def test_cv2_full_frame_is_lossless_and_matches_cv2(tmp_path):
    img = mk.picture(480, 640, 3, 3, noise=40)
    data = cv2.imencode(".jp2", img, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])[1].tobytes()
    hold(data, tmp_path, "640x480")
    np.testing.assert_array_equal(codecs.decode_image(data)[..., ::-1], img)


ORDERS = ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("order", ORDERS)
def test_pil_progressions_match_cv2(order, irreversible, tmp_path):
    """Each order with several layers, precincts and small code-blocks, on
    tiles of odd size and position, RGB (ICT or RCT) and RGBA."""
    for k, (h, w, ch) in enumerate([(29, 47, 3), (40, 24, 4)]):
        img = mk.picture(h, w, ch, 100 + k)
        for opts in (dict(precinct_size=(32, 32), codeblock_size=(8, 8), num_resolutions=4),
                     dict(tile_size=(13, 17), num_resolutions=3, codeblock_size=(4, 8))):
            data = mk.pil(img, irreversible=irreversible, progression=order, quality_mode="rates",
                          quality_layers=[30, 10, 3], **opts)
            hold(data, tmp_path, (order, irreversible, ch, opts))


@pytest.mark.parametrize("seed", range(12))
def test_pil_options_on_odd_sizes_match_cv2(seed):
    """Seeded draws of PIL's options on sizes from 1x1: wavelet, MCT,
    order, resolutions, code-block and precinct sizes, tiles, layers, raw
    codestreams and PLT; gray, gray + alpha, RGB, RGBA, 16-bit gray."""
    rng = np.random.default_rng(seed)
    made = 0
    while made < 8:
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        mode = ["L", "LA", "RGB", "RGBA", "I;16"][int(rng.integers(0, 5))]
        ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
        img = mk.picture(h, w, ch, int(rng.integers(1 << 30)), noise=int(rng.integers(0, 40)))
        if mode == "I;16":
            img = img.astype(np.uint16) * int(rng.integers(1, 257))
        opts = {"irreversible": bool(rng.random() < 0.5), "progression": ORDERS[int(rng.integers(0, 5))]}
        if rng.random() < 0.5:
            opts["codeblock_size"] = (int(2 ** rng.integers(2, 7)), int(2 ** rng.integers(2, 7)))
        smallest = min(h, w)
        if rng.random() < 0.3:
            tw, th = int(rng.integers(max(1, w // 3), w + 9)), int(rng.integers(max(1, h // 3), h + 9))
            opts["tile_size"] = (tw, th)
            smallest = min(smallest, tw, th, w - tw * ((w - 1) // tw), h - th * ((h - 1) // th))
        levels = 1  # OpenJPEG's encoder needs every tile to span 2^(resolutions - 1) samples
        while (1 << levels) <= smallest and levels < 6:
            levels += 1
        opts["num_resolutions"] = int(rng.integers(1, levels + 1))
        if rng.random() < 0.4:
            opts["quality_mode"] = "rates"
            opts["quality_layers"] = sorted((float(rng.integers(2, 60)) for _ in range(int(rng.integers(1, 4)))),
                                            reverse=True)
        for key, p in (("mct", 0.3), ("no_jp2", 0.25), ("plt", 0.2)):
            if rng.random() < p:
                opts[key] = int(rng.integers(0, 2)) if key == "mct" else True
        try:
            data = mk.pil(img, **opts)
        except (OSError, ValueError):  # options OpenJPEG's encoder refuses
            continue
        same_bytes_form(data, (h, w, mode, opts))
        made += 1


# ---------------------------------------------------------------------------
# Cut files and bit errors
# ---------------------------------------------------------------------------


def small_files() -> dict:
    img = mk.picture(40, 52, 3, 5)
    return {
        "cv2_c250": cv2.imencode(".jp2", img, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 250])[1].tobytes(),
        "cv2_c1000": cv2.imencode(".jp2", img)[1].tobytes(),
        "pil_97_rpcl_layers": mk.pil(img, irreversible=True, quality_mode="rates", quality_layers=[30, 8],
                                     progression="RPCL", precinct_size=(16, 16), codeblock_size=(16, 16),
                                     num_resolutions=3),
        "pil_tiles_raw": mk.pil(img, tile_size=(17, 23), num_resolutions=3, no_jp2=True),
    }


@pytest.mark.parametrize("name,step", [("cv2_c250", 1), ("pil_tiles_raw", 7)])
def test_every_cut_point_matches_cv2(name, step, tmp_path):
    """Every cut of cv2's file (every 7th of the tiled codestream's)."""
    data = small_files()[name]
    for cut in range(1, len(data), step):
        same_bytes_form(data[:cut], (name, cut))
    for cut in range(1, len(data), 97):  # and as files, which cv2 reads alike
        hold(data[:cut], tmp_path, (name, cut))


FLIPPED = ["cv2_c250", "cv2_c1000", "pil_97_rpcl_layers", "pil_tiles_raw", "opj_style_all_97.j2k",
           "opj_style_bypass_termall_53.j2k", "opj_sop_eph_97.j2k", "opj_tile_parts_R.j2k", "opj_ppm_3_segments.j2k",
           "opj_ppt_tiles_tile_parts_97.j2k", "opj_roi_97.j2k"]


@pytest.mark.parametrize("name", FLIPPED)
def test_bit_errors_in_packet_data_match_cv2(name):
    """500 seeded single-bit flips a file past the first SOD (or the first
    PPM or PPT marker's index byte): packet
    headers (inclusion, zero bit-planes, pass counts, lengths; in the data
    or packed in PPM/PPT markers), SOP and EPH markers, tile-part headers
    and MQ or raw segments under every code-block style and ROI, each
    giving cv2's pixels or cv2's refusal."""
    if name.endswith(".j2k"):
        with open(os.path.join(J2K, name), "rb") as f:
            data = f.read()
    else:
        data = small_files()[name]
    start = data.index(b"\xff\x93") + 2
    for marker in (b"\xff\x60", b"\xff\x61"):  # headers packed in PPM or PPT: flip them too
        if marker in data[:start]:
            start = data.index(marker) + 5
    rng = np.random.default_rng(len(data))
    for _ in range(500):
        b = bytearray(data)
        at = int(rng.integers(start, len(b) - 2))
        b[at] ^= 1 << int(rng.integers(0, 8))
        same_bytes_form(bytes(b), (name, at))


@pytest.mark.parametrize("name", ["pil_tiles_17x23_97.jp2", "opj_tlm_plt.j2k", "box_pclr.jp2", "opj_ppm_3_segments.j2k",
                                  "opj_tile_parts_R.j2k"])
def test_bit_errors_in_headers_match_cv2(name):
    """300 seeded single-bit flips a file before the first SOD: JP2 boxes,
    SIZ, COD/QCD, TLM/PLT, PPM and SOT markers, each giving cv2's pixels or
    cv2's refusal."""
    with open(os.path.join(J2K, name), "rb") as f:
        data = f.read()
    end = data.index(b"\xff\x93")
    rng = np.random.default_rng(end)
    for _ in range(300):
        b = bytearray(data)
        at = int(rng.integers(0, end))
        b[at] ^= 1 << int(rng.integers(0, 8))
        same_bytes_form(bytes(b), (name, at))


def test_features_not_ported_raise_naming_them():
    """HT code-blocks (Part 15): OpenJPEG decodes them, the port names the
    feature (COD's code-block style bit 6)."""
    cs = mk.pil(mk.picture(16, 16, 1, 1), no_jp2=True, num_resolutions=2)
    at = cs.index(b"\xff\x52") + 4 + 8
    ht = cs[:at] + bytes([cs[at] | 0x40]) + cs[at + 1:]
    with pytest.raises(ValueError, match="JPEG 2000 HT code-blocks .* is not yet ported"):
        codecs.decode_unchanged(ht, "ht.j2k")
