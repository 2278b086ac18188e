"""The committed two-scan capture ``tests/fixtures/torch_project`` and its
``expected.json``, which ``chip_smoke.py`` reads on the GPU host (which has
no cv2 to generate captures with). This test is also the recipe: it
regenerates both with the JAX package and checks that the committed files
still match —

    python -c "import tests.test_torch_fixture_project as t; t.write_fixture()"

rewrites them. ``data.db`` is compared by its rows, not its bytes (SQLite's
file layout may differ between library versions)."""

import hashlib
import json
import os
import shutil
import sqlite3

import numpy as np
import pytest

from tpu3dlm.data.dataset import load_scan
from tpu3dlm.pipeline.evaluate import make_project

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
PROJECT = os.path.join(FIXTURES, "torch_project")
FOLDERS = ("gold_std", "maintenance")
SIZES = (128, 640)
FIELDS = ("rgb", "depth", "intrinsics", "rgb_size", "poses", "timestamps")


def digest(a) -> dict:
    a = np.ascontiguousarray(a)
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(), "dtype": str(a.dtype),
            "shape": list(a.shape)}


def scan_digests(data_dir: str) -> dict:
    """sha256 of every array the JAX package's load_scan gives on each scan
    of ``data_dir`` at each img_size."""
    out = {}
    for folder in FOLDERS:
        ext = os.path.join(data_dir, folder, "rtabmap_extract")
        for size in SIZES:
            scan = load_scan(os.path.join(ext, "data_rgb"), os.path.join(ext, "data_depth"),
                             os.path.join(ext, "calibration"),
                             os.path.join(data_dir, folder, "poses.txt"), img_size=size)
            out[f"{folder}/{size}"] = {f: digest(getattr(scan, f)) for f in FIELDS}
    return out


def generate(root: str) -> str:
    """make_project's capture (5 frames a scan, 4000 pts/m², sign 2
    dropped) under ``root``; returns its data directory."""
    ckpt = lambda n: os.path.join(FIXTURES, f"{n}_synthetic.msgpack")  # noqa: E731
    _, data_root, _, _ = make_project(root, ckpt("yolo"), ckpt("beit"))
    return data_root


def write_fixture() -> None:
    """Regenerate tests/fixtures/torch_project (the recipe)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        data_root = generate(tmp)
        shutil.rmtree(PROJECT, ignore_errors=True)
        shutil.copytree(data_root, os.path.join(PROJECT, "data"))
    with open(os.path.join(PROJECT, "expected.json"), "w") as f:
        json.dump(scan_digests(os.path.join(PROJECT, "data")), f, indent=1, sort_keys=True)


def db_rows(path: str) -> list:
    conn = sqlite3.connect(path)
    try:
        tables = [r[0] for r in conn.execute("SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        return [(t, conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()) for t in tables]
    finally:
        conn.close()


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    return generate(str(tmp_path_factory.mktemp("project")))


def files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_committed_capture_matches_a_regenerated_one(regenerated):
    committed = os.path.join(PROJECT, "data")
    assert files(committed) == files(regenerated)
    for rel in files(committed):
        a, b = os.path.join(committed, rel), os.path.join(regenerated, rel)
        if rel.endswith(".db"):
            assert db_rows(a) == db_rows(b), rel
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


def test_expected_digests_match_the_jax_load_scan():
    with open(os.path.join(PROJECT, "expected.json")) as f:
        expected = json.load(f)
    assert expected == scan_digests(os.path.join(PROJECT, "data"))
