"""Writes the PNG fixtures beside the JPEG ones (``make_fixtures.c``) and
``digests.json``: for every fixture, the sha256, shape and dtype of what
cv2 decodes (JPEG: ``imread(p, IMREAD_COLOR)``; PNG: ``imread`` with
``IMREAD_UNCHANGED`` and with ``IMREAD_COLOR``), in cv2's BGR order. Then
the other containers (``make_containers.fixtures()``: lossless JPEG, PNM,
PAM, PFM, BMP, TIFF, Sun raster, Radiance HDR, GIF, OpenEXR) into
``containers/`` with ``containers/digests.json``: ``imread`` under both
flags, ``null`` where cv2 returns None. Last the WebP set: the capture's
maintenance frames written by cv2 (``webp_capture``) beside what
``make_webp.c`` wrote into ``webp/``, and ``webp/digests.json`` (``imread``
under both flags, ``null`` for None); then the JPEG 2000 set
(``make_jpeg2000.capture()`` and ``fixtures()``, and
``make_jpeg2000_opj.fixtures()`` from the system OpenJPEG) into
``jpeg2000/`` with ``jpeg2000/digests.json``, the same way; then the TIFF
set: ``make_containers.tiff_fixtures()`` into ``tiff/`` beside what
``make_tiff.c`` wrote there from the system libtiff, and
``tiff/digests.json`` the same way.
``chip_smoke.py`` decodes every fixture with the port on a host without cv2
and holds it to these digests; ``tests/test_torch_codecs_modes.py`` and
``tests/test_torch_codecs_containers.py`` hold the files to cv2. Run from
the repository root:

    python tests/fixtures/codecs/make_digests.py
"""

import hashlib
import json
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [HERE, TESTS, os.path.dirname(TESTS)]

import make_jpeg2000  # noqa: E402
import make_jpeg2000_opj  # noqa: E402
from make_containers import fixtures as container_fixtures  # noqa: E402
from make_containers import tiff_fixtures  # noqa: E402
from test_torch_codecs_modes import png_bytes  # noqa: E402


def digest(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(), "shape": list(a.shape), "dtype": str(a.dtype)}


def png_fixtures() -> dict:
    """A few PNG layouts past 8-bit gray/RGB/RGBA, Adam7 among them."""
    rng = np.random.default_rng(7)
    h, w = 37, 53
    pal = rng.integers(0, 256, 16 * 3, dtype=np.uint8).tobytes()
    return {
        "palette_4bit_adam7_trns.png": png_bytes(rng.integers(0, 16, (h, w, 1), dtype=np.uint8), 3, 4, True,
                                                 plte=pal, trns=bytes(range(0, 240, 20))),
        "gray_1bit.png": png_bytes(rng.integers(0, 2, (h, w, 1), dtype=np.uint8), 0, 1),
        "gray_alpha_16bit_adam7.png": png_bytes(rng.integers(0, 65536, (h, w, 2), dtype=np.uint16), 4, 16, True),
        "rgb_16bit_trns.png": png_bytes(rng.integers(0, 4, (h, w, 3), dtype=np.uint16) * 21845, 2, 16,
                                        trns=b"\x00\x00\x55\x55\xaa\xaa"),
        "rgba_8bit_adam7.png": png_bytes(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), 6, 8, True),
    }


def webp_capture() -> dict:
    """The committed capture's 5 maintenance frames as cv2 writes WebP: the
    images lossless (quality 101) and lossy (quality 90), the depth blobs
    (CV_8UC4) lossless."""
    import sqlite3

    conn = sqlite3.connect(os.path.join(TESTS, "fixtures", "torch_project", "data", "maintenance", "data.db"))
    out = {}
    for i, image, depth in conn.execute("SELECT id, image, depth FROM Data ORDER BY id"):
        bgr = cv2.imdecode(np.frombuffer(image, np.uint8), cv2.IMREAD_COLOR)
        bgra = cv2.imdecode(np.frombuffer(depth, np.uint8), cv2.IMREAD_UNCHANGED)
        for suffix, img, q in (("webp_lossless", bgr, 101), ("webp_q90", bgr, 90), ("depth", bgra, 101)):
            data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])[1].tobytes()
            out[f"capture_maintenance_{i}_{suffix}.webp"] = data
    conn.close()
    return out


def main() -> None:
    for name, data in png_fixtures().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    out = {}
    for name in sorted(os.listdir(HERE)):
        path = os.path.join(HERE, name)
        if name.endswith(".jpg"):
            out[name] = {"color": digest(cv2.imread(path, cv2.IMREAD_COLOR))}
        elif name.endswith(".png"):
            out[name] = {"color": digest(cv2.imread(path, cv2.IMREAD_COLOR)),
                         "unchanged": digest(cv2.imread(path, cv2.IMREAD_UNCHANGED))}
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    sub = os.path.join(HERE, "containers")
    os.makedirs(sub, exist_ok=True)
    out = {}
    for name, data in container_fixtures().items():
        path = os.path.join(sub, name)
        with open(path, "wb") as f:
            f.write(data)
        out[name] = {}
        for key, flag in (("color", cv2.IMREAD_COLOR), ("unchanged", cv2.IMREAD_UNCHANGED)):
            img = cv2.imread(path, flag)
            out[name][key] = None if img is None else digest(img)
    with open(os.path.join(sub, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    sub = os.path.join(HERE, "webp")
    for name, data in webp_capture().items():
        with open(os.path.join(sub, name), "wb") as f:
            f.write(data)
    out = {}
    for name in sorted(os.listdir(sub)):
        if not name.endswith(".webp"):
            continue
        out[name] = {}
        for key, flag in (("color", cv2.IMREAD_COLOR), ("unchanged", cv2.IMREAD_UNCHANGED)):
            img = cv2.imread(os.path.join(sub, name), flag)
            out[name][key] = None if img is None else digest(img)
    with open(os.path.join(sub, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    sub = os.path.join(HERE, "jpeg2000")
    os.makedirs(sub, exist_ok=True)
    out = {}
    made = {**make_jpeg2000.capture(), **make_jpeg2000.fixtures(), **make_jpeg2000_opj.fixtures()}
    for name, data in made.items():
        path = os.path.join(sub, name)
        with open(path, "wb") as f:
            f.write(data)
        out[name] = {}
        for key, flag in (("color", cv2.IMREAD_COLOR), ("unchanged", cv2.IMREAD_UNCHANGED)):
            img = cv2.imread(path, flag)
            out[name][key] = None if img is None else digest(img)
    with open(os.path.join(sub, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    sub = os.path.join(HERE, "tiff")
    os.makedirs(sub, exist_ok=True)
    for name, data in tiff_fixtures().items():
        with open(os.path.join(sub, name), "wb") as f:
            f.write(data)
    out = {}
    for name in sorted(os.listdir(sub)):
        if not name.endswith(".tif"):
            continue
        out[name] = {}
        for key, flag in (("color", cv2.IMREAD_COLOR), ("unchanged", cv2.IMREAD_UNCHANGED)):
            img = cv2.imread(os.path.join(sub, name), flag)
            out[name][key] = None if img is None else digest(img)
    with open(os.path.join(sub, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
