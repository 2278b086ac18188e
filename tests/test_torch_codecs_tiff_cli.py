"""The two-scan CLI on a capture whose frames are TIFF as cv2 reads it
(JPEG-in-TIFF tiles, LZW BigTIFF, 16-bit BigTIFF depth), the port's against
the JAX package's: the same report. Apart from ``test_torch_codecs_tiff.py``
so that the two run on different test workers."""

import os
import sqlite3

import cv2
import numpy as np


def test_two_scan_cli_on_a_jpeg_in_tiff_capture_writes_the_jax_csv(tmp_path):
    """The maintenance data.db of the committed capture with its image blobs
    as JPEG-in-TIFF tiles (YCbCr 2x2, JPEGTables) and LZW BigTIFF and its
    depth blobs as 16-bit BigTIFF: the port's CLI report equals the JAX
    CLI's (one missing sign), at the small ICP of
    ``test_torch_codecs_modes.py``."""
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
            mm = np.rint(bgra.copy().view(np.float32)[..., 0].astype(np.float64) * 1000).astype(np.uint16)
            image = chip_smoke.write_tiff_jpeg(bgr) if i % 2 else chip_smoke.write_tiff(bgr, 5, big=True)
            conn.execute("UPDATE Data SET image = ?, depth = ? WHERE id = ?", (image, chip_smoke.write_tiff(mm, big=True), i))
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
    assert head == b"II*\x00"  # the extracted frames kept their container
