"""The port's flax msgpack reader (``tpu3dlm_torch/models/checkpoint.py``)
against ``flax.serialization`` on the committed fixture checkpoints, and the
port models built from it against the JAX package's loaded tree."""

import os

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dlm.models import weights as JW
from tpu3dlm.models.beit import BeitClassifier, BeitConfig
from tpu3dlm.models.yolov10 import YOLOv10
from tpu3dlm.pipeline.evaluate import BEIT_KW, IMG_SIZE, NC
from tpu3dlm_torch.models import checkpoint as CK
from tpu3dlm_torch.models import weights as PW

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PATHS = {k: os.path.join(FIXTURES, f"{k}_synthetic.msgpack") for k in ("yolo", "beit")}


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("kind", ["yolo", "beit"])
def test_reader_identical_to_msgpack_restore(kind):
    data = open(PATHS[kind], "rb").read()
    got = CK.read_flax_msgpack(PATHS[kind])
    assert_trees_equal(got, fs.msgpack_restore(data))
    assert list(got) == (["batch_stats", "params"] if kind == "yolo" else ["params"])


def test_chunked_tree_and_scalars(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {"params": {"big": rng.normal(size=(37, 29)).astype(np.float32),
                       "ints": np.arange(300, dtype=np.int64).reshape(3, 100)},
            "meta": {"step": 7, "neg": -3, "huge": 2 ** 40, "rate": 0.5, "name": "yolo",
                     "raw": b"\x00\x01", "none": None, "flag": True, "list": [1, 2.5, "x"],
                     "scalar": np.float32(1.25), "complex": 1 + 2j, "empty": np.zeros((0, 3), np.float16)}}
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 256)  # big arrays split into 64-float chunks
    data = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    assert_trees_equal(CK.restore_flax_msgpack(data), fs.msgpack_restore(data))


def test_reader_errors(tmp_path):
    with pytest.raises(NotImplementedError, match="load_torch_state_dict"):
        CK.read_flax_msgpack(str(tmp_path / "best.pt"))
    data = open(PATHS["beit"], "rb").read()
    cut = tmp_path / "cut.msgpack"
    cut.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        CK.read_flax_msgpack(str(cut))
    with pytest.raises(ValueError, match="trailing"):
        CK.restore_flax_msgpack(data + b"\x00")


def jax_tree(kind: str):
    """The tree the JAX Pipeline loads (``load_flax_checkpoint`` into a
    ``model.init`` template), as numpy."""
    if kind == "yolo":
        model, x = YOLOv10(nc=NC, variant="n"), jnp.zeros((1, IMG_SIZE, IMG_SIZE, 3), jnp.float32)
    else:
        cfg = BeitConfig(**BEIT_KW)
        model, x = BeitClassifier(cfg), jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.float32)
    tree = JW.load_flax_checkpoint(PATHS[kind], JW.init_template(model, x))
    return jax.tree.map(np.asarray, tree)


def test_port_models_from_the_reader_match_the_jax_tree():
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 3, IMG_SIZE, IMG_SIZE)).astype(np.float32))
    yolo_a = PW.yolov10_from_flax(CK.read_flax_msgpack(PATHS["yolo"]), nc=NC)
    yolo_b = PW.yolov10_from_flax(jax_tree("yolo"), nc=NC)
    for (ka, a), (kb, b) in zip(yolo_a.state_dict().items(), yolo_b.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    with torch.no_grad():
        out_a, out_b = yolo_a(x.permute(0, 2, 3, 1)), yolo_b(x.permute(0, 2, 3, 1))
    for a, b in zip(torch.utils._pytree.tree_leaves(out_a), torch.utils._pytree.tree_leaves(out_b)):
        assert torch.equal(a, b)

    beit_cfg = PW.beit_config_from_flax(jax_tree("beit")["params"])
    beit_a = PW.beit_from_flax(CK.read_flax_msgpack(PATHS["beit"]), beit_cfg)
    beit_b = PW.beit_from_flax(jax_tree("beit"), beit_cfg)
    crops = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        logits_a, logits_b = beit_a(crops), beit_b(crops)
    assert logits_a.shape == (3, 2)
    assert torch.equal(logits_a, logits_b)
