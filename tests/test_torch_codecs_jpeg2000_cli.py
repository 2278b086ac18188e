"""JPEG 2000 frames through the port's readers, extractor and CLI against
the JAX package's (whose cv2 decodes them with OpenJPEG): ``load_rgb_image``,
``load_depth_image`` and ``load_scan`` on the committed capture with its
maintenance frames as JPEG 2000, ``ImageExtractor`` on a data.db of JPEG
2000 blobs (among them a depth blob the parent port skipped as not yet
ported, which the reference keeps), and the two-scan CLI report byte for
byte."""

import os
import shutil
import sqlite3
import sys
import unittest.mock as mock

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_codecs_containers import outcome  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J2K = os.path.join(REPO, "tests", "fixtures", "codecs", "jpeg2000")
CAPTURE = os.path.join(REPO, "tests", "fixtures", "torch_project", "data")


def read(name: str) -> bytes:
    with open(os.path.join(J2K, name), "rb") as f:
        return f.read()


def jpeg2000_capture(root: str) -> str:
    """The committed capture with its maintenance frames as JPEG 2000: RGB
    frames PIL's 9/7 at rate 12 and depth frames cv2's lossless JP2, under
    the names ``fetch_data`` gives (``<n>.jpg``, ``<n>.png``)."""
    scan = os.path.join(root, "maintenance")
    shutil.copytree(os.path.join(CAPTURE, "maintenance"), scan)
    ext = os.path.join(scan, "rtabmap_extract")
    for k in range(1, 6):
        for sub, suffix in (("data_rgb", "irreversible_q12"), ("data_depth", "depth")):
            name = f"{k}.jpg" if sub == "data_rgb" else f"{k}.png"
            shutil.copyfile(os.path.join(J2K, f"capture_maintenance_{k}_{suffix}.jp2"), os.path.join(ext, sub, name))
    return scan


def test_load_rgb_depth_and_scan_follow_the_reference(tmp_path):
    from tpu3dlm.data import dataset as JD

    from tpu3dlm_torch.data import dataset as PD

    scan = jpeg2000_capture(str(tmp_path))
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


def extract(module, db: str, out: str):
    ex = module.ImageExtractor(db, os.path.join(out, "d"), os.path.join(out, "r"))
    n = ex.fetch_data()
    kept = list(ex.node_ordinals)
    arrays = ex.fetch_arrays()
    ords = list(ex.node_ordinals)
    ex.close()
    return n, kept, arrays, ords


def test_extractor_keeps_the_jpeg2000_rows_the_reference_keeps(tmp_path):
    """``fetch_data`` and ``fetch_arrays`` on a data.db whose blobs are JPEG
    2000 (lossless and 9/7 images, a raw codestream, a palette image; JP2
    depth, one cut short) keep and skip the rows the reference does, with
    identical arrays and files of identical pixels. With JPEG 2000 refused
    as not yet ported, as the parent port refused it, the extractor drops
    every row whose depth blob is JPEG 2000: the fault this slice repairs."""
    from tpu3dlm.data import rtabmap_db as JR

    from tpu3dlm_torch.data import jpeg2000
    from tpu3dlm_torch.data import rtabmap_db as PR

    scan = tmp_path / "maintenance"
    shutil.copytree(os.path.join(CAPTURE, "maintenance"), scan)
    db = str(scan / "data.db")
    conn = sqlite3.connect(db)
    rows = [r for r, in conn.execute("SELECT id FROM Data ORDER BY id")]
    plan = {rows[0]: ("capture_maintenance_1_irreversible_q12.jp2", "capture_maintenance_1_depth.jp2"),
            rows[1]: ("capture_maintenance_2_lossless.jp2", "capture_maintenance_2_depth.jp2"),
            rows[2]: ("pil_raw_rgb.j2k", "capture_maintenance_3_depth.jp2"),
            rows[3]: ("box_pclr.jp2", "capture_maintenance_4_depth.jp2")}
    for i, (im, dp) in plan.items():
        conn.execute("UPDATE Data SET image = ?, depth = ? WHERE id = ?", (read(im), read(dp), i))
    cut_depth = read("capture_maintenance_5_depth.jp2")
    conn.execute("UPDATE Data SET depth = ? WHERE id = ?", (cut_depth[:len(cut_depth) // 2], rows[4]))
    conn.commit()
    conn.close()
    port, jax = extract(PR, db, str(tmp_path / "port")), extract(JR, db, str(tmp_path / "jax"))
    (pn, pfiles, (prgb, pdep), pord), (jn, jfiles, (jrgb, jdep), jord) = port, jax
    assert (pn, pfiles, pord) == (jn, jfiles, jord)
    assert (pn, pord) == (4, [1, 2, 3, 4])
    for a, b in zip(prgb + pdep, jrgb + jdep):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for sub in ("d", "r"):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub))
        for name in names:
            p, j = (str(tmp_path / k / sub / name) for k in ("port", "jax"))
            np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), cv2.imread(j, cv2.IMREAD_UNCHANGED))

    def not_ported(data, name, color):
        raise ValueError(f"unsupported image {name}: JPEG 2000 is not yet ported (cv2 decodes it)")

    with mock.patch.object(jpeg2000, "decode", not_ported):
        n, _, _, ords = extract(PR, db, str(tmp_path / "parent"))
    assert (n, ords) == (0, [])  # every depth blob was JPEG 2000: every row skipped


def test_two_scan_cli_on_a_jpeg2000_capture_writes_the_jax_csv(tmp_path):
    """The maintenance data.db of the committed capture with 9/7 JPEG 2000
    image blobs and lossless JP2 depth blobs: the port's CLI report equals
    the JAX CLI's byte for byte (one missing sign), at the small ICP of
    ``test_torch_codecs_modes.py``."""
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
            conn.execute("UPDATE Data SET image = ?, depth = ? WHERE id = ?",
                         (read(f"capture_maintenance_{k}_irreversible_q12.jp2"),
                          read(f"capture_maintenance_{k}_depth.jp2"), k))
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
                             "1.jpg"), "rb").read(12)
    assert head == b"\x00\x00\x00\x0cjP  \r\n\x87\n"  # the extracted frames kept their container
