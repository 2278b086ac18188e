"""The port's ingestion against the JAX package on the CPU: ``load_scan``,
``ImageExtractor``, calibration YAML, the config loader, the pose table and
natural sort. Every array must be identical."""

import os
import shutil
import sqlite3

import numpy as np
import pytest
import yaml

from tpu3dlm.data import dataset as JD
from tpu3dlm.data import poses as JP
from tpu3dlm.data import rtabmap_db as JR
from tpu3dlm.utils import config as JCFG
from tpu3dlm.utils import natsort as JN
from tpu3dlm_torch.data import calibration as PCAL
from tpu3dlm_torch.data import dataset as PD
from tpu3dlm_torch.data import poses as PP
from tpu3dlm_torch.data import rtabmap_db as PR
from tpu3dlm_torch.utils import config as PCFG
from tpu3dlm_torch.utils import natsort as PN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTURE = os.path.join(REPO, "tests", "fixtures", "torch_project", "data")
FIELDS = ("rgb", "depth", "intrinsics", "rgb_size", "poses", "timestamps", "letterbox")


def scan_args(scan_dir: str, rgb_dir: str | None = None, depth_dir: str | None = None):
    ext = os.path.join(scan_dir, "rtabmap_extract")
    return (rgb_dir or os.path.join(ext, "data_rgb"), depth_dir or os.path.join(ext, "data_depth"),
            os.path.join(ext, "calibration"), os.path.join(scan_dir, "poses.txt"))


def assert_scans_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("mode,size", [("square", 128), ("square", 640), ("letterbox", 128),
                                       ("letterbox", 640)])
def test_load_scan_identical_to_jax(mode, size, workers):
    for folder in ("gold_std", "maintenance"):
        args = scan_args(os.path.join(CAPTURE, folder))
        got = PD.load_scan(*args, img_size=size, resize_mode=mode, workers=workers)
        want = JD.load_scan(*args, img_size=size, resize_mode=mode)
        assert_scans_equal(got, want)


def test_scan_dataset_identical_to_jax():
    args = scan_args(os.path.join(CAPTURE, "gold_std"))[:3]
    for processing in (True, False):
        got = PD.ScanDataset(*args, img_size=96, processing=processing)
        want = JD.ScanDataset(*args, img_size=96, processing=processing)
        assert len(got) == len(want) == 5
        for i in (0, 4):
            for a, b in zip(got[i][:2], want[i][:2]):
                np.testing.assert_array_equal(a, b)
            assert got[i][2] == want[i][2]


def test_load_scan_refusals(tmp_path):
    args = scan_args(os.path.join(CAPTURE, "gold_std"))
    with pytest.raises(ValueError, match="resize_mode"):
        PD.load_scan(*args, resize_mode="crop")
    empty = tmp_path / "e"
    empty.mkdir()
    with pytest.raises(ValueError, match="no paired frames"):
        PD.load_scan(str(empty), str(empty), str(empty), args[3])


@pytest.fixture
def capture(tmp_path):
    """A writable copy of the committed gold scan."""
    dst = tmp_path / "gold_std"
    shutil.copytree(os.path.join(CAPTURE, "gold_std"), dst)
    return str(dst)


def extract(module, db: str, out: str):
    ex = module.ImageExtractor(db, os.path.join(out, "d"), os.path.join(out, "r"))
    n = ex.fetch_data()
    rgbs, depths = ex.fetch_arrays()
    ex.close()
    return n, ex.node_ordinals, rgbs, depths


def assert_extractions_equal(db: str, tmp_path):
    import cv2

    pn, pord, prgb, pdep = extract(PR, db, str(tmp_path / "port"))
    jn, jord, jrgb, jdep = extract(JR, db, str(tmp_path / "jax"))
    assert (pn, pord) == (jn, jord)
    assert len(prgb) == len(jrgb) == len(pdep) == len(jdep)
    for a, b in zip(prgb + pdep, jrgb + jdep):
        np.testing.assert_array_equal(a, b)
    for sub in ("d", "r"):
        pf, jf = (sorted(os.listdir(tmp_path / k / sub)) for k in ("port", "jax"))
        assert pf == jf
        for name in pf:
            p, j = (str(tmp_path / k / sub / name) for k in ("port", "jax"))
            if sub == "r":  # RGB blobs are copied as they are
                assert open(p, "rb").read() == open(j, "rb").read()
            else:  # depth PNGs decode to the same array under cv2
                np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED),
                                              cv2.imread(j, cv2.IMREAD_UNCHANGED))
    return pn, pord


def test_extractor_identical_to_jax(capture, tmp_path):
    n, ords = assert_extractions_equal(os.path.join(capture, "data.db"), tmp_path)
    assert n == 5 and ords == [1, 2, 3, 4, 5]


def test_extractor_null_blobs(capture, tmp_path):
    db = os.path.join(capture, "data.db")
    conn = sqlite3.connect(db)
    conn.execute("UPDATE Data SET image = NULL WHERE id = 2")
    conn.execute("UPDATE Data SET depth = NULL WHERE id = 3")
    conn.execute("UPDATE Data SET depth = X'00010203' WHERE id = 5")  # not an image
    conn.commit()
    conn.close()
    n, ords = assert_extractions_equal(db, tmp_path)
    # fetch_data kept nodes 1, 2 and 4; fetch_arrays (run last) only 1 and 4, which have both blobs
    assert n == 3 and ords == [1, 4]


def test_extractor_duplicate_node_id(capture, tmp_path):
    """A broken export without the PRIMARY KEY: node 3's row twice."""
    src = sqlite3.connect(os.path.join(capture, "data.db"))
    rows = src.execute("SELECT id, image, depth FROM Data ORDER BY id").fetchall()
    src.close()
    db = str(tmp_path / "dupes.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE Node (id INTEGER)")
    conn.execute("CREATE TABLE Data (id INTEGER, image BLOB, depth BLOB)")
    conn.executemany("INSERT INTO Data VALUES (?, ?, ?)", rows + [rows[2]])
    conn.executemany("INSERT INTO Node VALUES (?)", [(r[0],) for r in rows])
    conn.commit()
    conn.close()
    n, ords = assert_extractions_equal(db, tmp_path)
    assert n == 5 and ords == [1, 2, 3, 4, 5]


def test_skipped_node_keeps_pose_pairing(capture, tmp_path):
    db = os.path.join(capture, "data.db")
    conn = sqlite3.connect(db)
    conn.execute("UPDATE Data SET depth = NULL WHERE id = 2")
    conn.commit()
    conn.close()
    scans = []
    for name, R, D in (("port", PR, PD), ("jax", JR, JD)):
        out = tmp_path / name
        ex = R.ImageExtractor(db, str(out / "depth"), str(out / "rgb"))
        assert ex.fetch_data() == 4 and ex.node_ordinals == [1, 3, 4, 5]
        ex.close()
        scans.append(D.load_scan(*scan_args(capture, str(out / "rgb"), str(out / "depth")), img_size=64))
    assert_scans_equal(*scans)
    _, all_poses = JP.load_poses(os.path.join(capture, "poses.txt"))
    np.testing.assert_array_equal(scans[0].poses, all_poses[[0, 2, 3, 4]])


def test_depth_round_trip_helpers():
    d = np.random.default_rng(0).uniform(0, 5, (8, 6)).astype(np.float32)
    d[0, 0] = np.nan
    enc = PR.encode_depth(d)
    np.testing.assert_array_equal(enc, JR.encode_depth(d))
    np.testing.assert_array_equal(PR.reinterpret_depth(enc), JR.reinterpret_depth(enc))
    mm = np.arange(12, dtype=np.uint16).reshape(3, 4)
    np.testing.assert_array_equal(PR.reinterpret_depth(mm), JR.reinterpret_depth(mm))


# ---------------------------------------------------------------------------
# calibration, config, poses, natsort
# ---------------------------------------------------------------------------


def test_calibration_identical_to_yaml():
    for folder in ("gold_std", "maintenance"):
        d = os.path.join(CAPTURE, folder, "rtabmap_extract", "calibration")
        for name in os.listdir(d):
            p = os.path.join(d, name)
            text = open(p).read()
            assert PCAL.parse_yaml_subset(text, p) == yaml.safe_load(text)
            from tpu3dlm.data.calibration import load_calibration

            assert PCAL.load_calibration(p) == load_calibration(p)


@pytest.mark.parametrize("text", [
    "image_width: 640\nimage_height: 480\ncamera_matrix:\n  rows: 3\n  cols: 3\n  data: [525.0, 0.0, 319.5, 0.0, 525.0, 239.5, 0.0, 0.0, 1.0]\n",
    "# exported\n---\ncamera_matrix:\n  data:\n    - 5.25e+2\n    - 0\n    - 3_19.5\n    - .0\n    - +525.\n    - -239.5  # note\n  name: pinhole cam\nimage_width: 640\n",
    "a: [.inf, -.inf, 1.5e-3, x y]\nb:\n  c:\n    d: 7\n",
])
def test_yaml_subset_identical_to_safe_load(text):
    assert PCAL.parse_yaml_subset(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "%YAML:1.0\ncamera_matrix: !!opencv-matrix\n  rows: 3\n",  # OpenCV FileStorage
    "a: yes\n", "a: 'quoted'\n", "a:\n", "a: 0x1F\n", "a: [1, [2]]\n", "a: &x 1\n", "a: |\n  text\n",
    "- a: 1\n", "a: 2001-12-14\n",
])
def test_yaml_outside_the_subset_raises(tmp_path, text):
    p = tmp_path / "c.yaml"
    p.write_text(text)
    with pytest.raises(ValueError, match=str(p)):
        PCAL.load_calibration(str(p))


def test_calibration_errors_match_the_reference(tmp_path):
    from tpu3dlm.data.calibration import load_calibration

    for text in ("a: 1\n", "camera_matrix:\n  data: [1, 2]\n"):
        p = tmp_path / "c.yaml"
        p.write_text(text)
        with pytest.raises(ValueError) as port:
            PCAL.load_calibration(str(p))
        with pytest.raises(ValueError) as ref:
            load_calibration(str(p))
        assert str(port.value) == str(ref.value)
    with pytest.raises(FileNotFoundError):
        PCAL.load_calibration(str(tmp_path / "absent.yaml"))


def test_config_identical_to_jax(tmp_path):
    path = str(tmp_path / "configs" / "variables.cfg")
    PCFG.write_default_config(path)
    text = open(path).read().replace("img_size = 640", "img_size = 320.0").replace(
        "use_pallas = true", "use_pallas = off")
    text += "\n[maintenance]\nconf_thresh = 0.3\nimage_dir = /data/{data}/5%_rgb\n"
    open(path, "w").write(text)
    assert set(PCFG._SCHEMA) == set(JCFG._SCHEMA) and PCFG._SCHEMA == JCFG._SCHEMA
    for folder in ("gold_std", "maintenance"):
        got, want = PCFG.ConfigLoader(path, folder), JCFG.ConfigLoader(path, folder)
        for key in JCFG._SCHEMA:
            assert getattr(got, key) == getattr(want, key), key
            assert type(getattr(got, key)) is type(getattr(want, key)), key
        assert vars(got) == vars(want)
    bad = text.replace("view_img = false", "view_img = maybe")
    open(path, "w").write(bad)
    with pytest.raises(ValueError, match="view_img"):
        PCFG.ConfigLoader(path, "gold_std")
    with pytest.raises(FileNotFoundError):
        PCFG.ConfigLoader(str(tmp_path / "absent.cfg"), "gold_std")


def test_default_config_has_the_reference_keys_and_values(tmp_path):
    paths = {}
    for name, mod in (("port", PCFG), ("jax", JCFG)):
        paths[name] = str(tmp_path / name / "variables.cfg")
        mod.write_default_config(paths[name])
    got = PCFG.ConfigLoader(paths["port"], "scan", data_root="/r")
    want = JCFG.ConfigLoader(paths["jax"], "scan", data_root="/r")
    assert vars(got).keys() - {"config_path"} == vars(want).keys() - {"config_path"}
    for key in JCFG._SCHEMA:
        assert getattr(got, key) == getattr(want, key), key


def test_pose_frame_matches_the_dataframe():
    ts, poses = PP.load_poses(os.path.join(CAPTURE, "gold_std", "poses.txt"))
    jts, jposes = JP.load_poses(os.path.join(CAPTURE, "gold_std", "poses.txt"))
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(poses, jposes)
    rng = np.random.default_rng(0)
    ts = np.concatenate([ts, rng.uniform(1.6e9, 1.8e9, 500), [1700000000.123456789, 0.1, 1e-10]])
    poses = rng.normal(size=(len(ts), 7)).astype(np.float32)
    got, want = PP.poses_to_frame(ts, poses), JP.poses_to_dataframe(ts, poses)
    assert got.columns == list(want.columns)
    assert got["timestamp"].dtype == np.dtype("datetime64[ns]")
    np.testing.assert_array_equal(got["timestamp"].astype(np.int64),
                                  want["timestamp"].values.astype(np.int64))
    for col in PP.POSE_COLUMNS:
        np.testing.assert_array_equal(got[col], want[col].to_numpy())
    np.testing.assert_array_equal(got[PP.POSE_COLUMNS].to_numpy(dtype=np.float32),
                                  JP.poses_from_dataframe(want))
    np.testing.assert_array_equal(got[["tx", "qw"]].to_numpy(dtype=np.float64),
                                  want[["tx", "qw"]].to_numpy(dtype=np.float64))


def test_pose_file_errors(tmp_path):
    p = tmp_path / "poses.txt"
    p.write_text("# h\n1 2 3\n")
    with pytest.raises(ValueError, match="8 or 9 columns"):
        PP.load_poses(str(p))


def test_natsort_identical():
    names = ["10.jpg", "2.jpg", "1.jpg", "a10b2", "a2b10", "a2b9", "B1", "b1", "", "007", "7"]
    assert PN.natsorted(names) == JN.natsorted(names)
    assert PN.natsorted(names)[:4] == ["", "1.jpg", "2.jpg", "007"]
