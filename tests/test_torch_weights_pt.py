"""User checkpoints in torch formats through the port (``models/weights.py``)
against the JAX package's converters on the CPU: an ultralytics-style
``{"model": module}`` ``.pt`` (the module unpickled without ultralytics), a
plain state dict, an HF-named BEiT state dict and ``.safetensors`` files
each load to tensors equal to ``convert_yolov10_state_dict`` /
``convert_beit_state_dict`` carried through ``yolov10_from_flax`` /
``beit_from_flax``; and the Pipeline runs on them."""

import os
import sys
import types

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import save_file as save_torch

from torch_yolov10_ref import TorchYOLOv10, randomize_
from tpu3dlm.models import weights as JW
from tpu3dlm_torch.models import weights as PW
from tpu3dlm_torch.models.beit import BeitConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
BEIT = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            num_labels=3)


def assert_modules_equal(got: torch.nn.Module, want: torch.nn.Module):
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def assert_dicts_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def ultralytics_checkpoint(path: str, nc: int = 4, half: bool = False):
    """Save ``{"model": DetectionModel, "epoch": 3}`` the way ultralytics'
    trainer does, under a fabricated ``ultralytics`` package that is gone
    again before anything loads it."""
    pkg, nnm, tasks = (types.ModuleType(n) for n in ("ultralytics", "ultralytics.nn", "ultralytics.nn.tasks"))

    class DetectionModel(TorchYOLOv10):
        pass

    DetectionModel.__module__ = "ultralytics.nn.tasks"
    DetectionModel.__qualname__ = "DetectionModel"
    tasks.DetectionModel = DetectionModel
    sys.modules.update({"ultralytics": pkg, "ultralytics.nn": nnm, "ultralytics.nn.tasks": tasks})
    try:
        m = DetectionModel(nc=nc, variant="n")
        randomize_(m, seed=2)
        torch.save({"model": m.half() if half else m, "epoch": 3}, path)
    finally:
        for k in ("ultralytics", "ultralytics.nn", "ultralytics.nn.tasks"):
            sys.modules.pop(k, None)


def yolo_via_jax(sd, nc):
    return PW.yolov10_from_flax(JW.convert_yolov10_state_dict(sd), nc=nc)


@pytest.mark.parametrize("half", [False, True])
def test_ultralytics_object_checkpoint(tmp_path, half):
    """Unpickled without the package (the shim leaves no module behind);
    float16 tensors come back as float32, as the reference casts them."""
    path = str(tmp_path / "best.pt")
    ultralytics_checkpoint(path, half=half)
    sd = PW.load_torch_state_dict(path)
    assert "ultralytics" not in sys.modules
    assert_dicts_equal(sd, JW.load_torch_state_dict(path))
    assert all(v.dtype == np.float32 for v in sd.values())
    assert_modules_equal(PW.yolov10_from_ultralytics(sd), yolo_via_jax(sd, 4))


@pytest.mark.parametrize("wrap", ["plain", "state_dict_key"])
def test_plain_yolo_state_dict(tmp_path, wrap):
    m = TorchYOLOv10(nc=3, variant="n")
    randomize_(m, seed=5)
    sd = m.state_dict()
    sd["model.23.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).view(1, 16, 1, 1)
    path = str(tmp_path / "weights.pt")
    torch.save(sd if wrap == "plain" else {"state_dict": sd, "epoch": 1}, path)
    got = PW.load_torch_state_dict(path)
    assert_dicts_equal(got, JW.load_torch_state_dict(path))
    assert_modules_equal(PW.yolov10_from_ultralytics(got, nc=3), yolo_via_jax(got, 3))


def hf_beit_state_dict(seed=0) -> dict:
    """Random weights under the key names of HF ``BeitForImageClassification``
    (relative position bias per layer, layer scale, mean pooling), with its
    index buffers and the pretraining mask token that loaders ignore."""
    rng = np.random.default_rng(seed)
    h, inter, heads, p, labels = BEIT["hidden_size"], BEIT["intermediate_size"], 2, 16, BEIT["num_labels"]
    grid = BEIT["image_size"] // p
    n = grid * grid + 1
    shapes = {"beit.embeddings.cls_token": (1, 1, h), "beit.embeddings.mask_token": (1, 1, h),
              "beit.embeddings.patch_embeddings.projection.weight": (h, 3, p, p),
              "beit.embeddings.patch_embeddings.projection.bias": (h,),
              "beit.pooler.layernorm.weight": (h,), "beit.pooler.layernorm.bias": (h,),
              "classifier.weight": (labels, h), "classifier.bias": (labels,)}
    for i in range(BEIT["num_layers"]):
        pre = f"beit.encoder.layer.{i}."
        shapes.update({pre + k: v for k, v in {
            "lambda_1": (h,), "lambda_2": (h,),
            "layernorm_before.weight": (h,), "layernorm_before.bias": (h,),
            "layernorm_after.weight": (h,), "layernorm_after.bias": (h,),
            "attention.attention.query.weight": (h, h), "attention.attention.query.bias": (h,),
            "attention.attention.key.weight": (h, h),
            "attention.attention.value.weight": (h, h), "attention.attention.value.bias": (h,),
            "attention.attention.relative_position_bias.relative_position_bias_table":
                ((2 * grid - 1) ** 2 + 3, heads),
            "attention.output.dense.weight": (h, h), "attention.output.dense.bias": (h,),
            "intermediate.dense.weight": (inter, h), "intermediate.dense.bias": (inter,),
            "output.dense.weight": (h, inter), "output.dense.bias": (h,)}.items()})
    sd = {k: rng.standard_normal(v).astype(np.float32) * 0.2 for k, v in shapes.items()}
    for i in range(BEIT["num_layers"]):
        sd[f"beit.encoder.layer.{i}.attention.attention.relative_position_bias.relative_position_index"] = (
            rng.integers(0, 10, (n, n)).astype(np.int64))
    return sd


def test_hf_beit_state_dict():
    sd = hf_beit_state_dict()
    cfg = BeitConfig(**BEIT)
    assert_modules_equal(PW.beit_from_hf(sd, cfg), PW.beit_from_flax(JW.convert_beit_state_dict(sd), cfg))


def test_hf_beit_unmapped_weight_raises():
    sd = hf_beit_state_dict()
    sd["beit.embeddings.position_embeddings"] = np.zeros((1, 5, 32), np.float32)
    with pytest.raises(ValueError, match="no mapping"):
        PW.beit_from_hf(sd, BeitConfig(**BEIT))
    with pytest.raises(ValueError, match="no mapping"):
        JW.convert_beit_state_dict(sd)


def test_safetensors_files(tmp_path):
    """The port's own reader against the safetensors package: every dtype a
    checkpoint carries, BF16 widened to float32; both converters on top."""
    sd = hf_beit_state_dict(seed=1)
    path = str(tmp_path / "beit.safetensors")
    save_numpy(sd, path, metadata={"format": "np"})
    got = PW.load_torch_state_dict(path)
    assert_dicts_equal(got, JW.load_torch_state_dict(path))
    cfg = BeitConfig(**BEIT)
    assert_modules_equal(PW.beit_from_hf(got, cfg), PW.beit_from_flax(JW.convert_beit_state_dict(sd), cfg))

    rng = np.random.default_rng(0)
    mixed = {"f16": rng.standard_normal((3, 5)).astype(np.float16), "f64": rng.standard_normal(4),
             "i64": np.arange(6, dtype=np.int64).reshape(2, 3), "u8": np.arange(7, dtype=np.uint8),
             "b": np.array([True, False]), "i32": np.arange(3, dtype=np.int32), "empty": np.zeros((0, 2), np.float32)}
    save_numpy(mixed, str(tmp_path / "mixed.safetensors"))
    assert_dicts_equal(PW.read_safetensors(str(tmp_path / "mixed.safetensors")), mixed)
    bf = torch.randn(4, 6).to(torch.bfloat16)
    save_torch({"w": bf}, str(tmp_path / "bf16.safetensors"))
    np.testing.assert_array_equal(PW.read_safetensors(str(tmp_path / "bf16.safetensors"))["w"], bf.float().numpy())


@pytest.mark.parametrize("damage", ["short", "header_overrun", "offsets_past_end"])
def test_broken_safetensors_raise(tmp_path, damage):
    path = str(tmp_path / "x.safetensors")
    save_numpy({"w": np.ones((4, 4), np.float32)}, path)
    raw = bytearray(open(path, "rb").read())
    if damage == "short":
        raw = raw[:5]
    elif damage == "header_overrun":
        raw[:8] = (len(raw) * 2).to_bytes(8, "little")
    else:
        raw = raw[:-8]
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError):
        PW.read_safetensors(path)


def test_pipeline_runs_on_torch_checkpoints(tmp_path):
    """The fixture checkpoints re-saved as a plain ultralytics-key ``.pt``
    (YOLOv10) and an HF-named ``.safetensors`` (BEiT): the gold Pipeline on
    the committed capture gives the records of the ``.msgpack`` run."""
    import chip_smoke
    from tpu3dlm_torch.models.checkpoint import read_flax_msgpack
    from tpu3dlm_torch.pipeline import task as PT
    from tpu3dlm_torch.utils.config import ConfigLoader

    yolo = PW.yolov10_from_flax(read_flax_msgpack(os.path.join(FIXTURES, "yolo_synthetic.msgpack")), nc=2)
    torch.save(yolo.state_dict(), str(tmp_path / "best.pt"))
    beit = PW.beit_from_flax(read_flax_msgpack(os.path.join(FIXTURES, "beit_synthetic.msgpack")))
    to_hf = {v: k for k, v in PW._HF_BEIT_TOP.items()}
    to_hf.update({f"layers.{i}.{v}": f"beit.encoder.layer.{i}.{k}"
                  for i in range(beit.cfg.num_layers) for k, v in PW._HF_BEIT_LAYER.items()})
    save_numpy({to_hf[k]: v.numpy() for k, v in beit.state_dict().items()}, str(tmp_path / "beit.safetensors"))

    records = {}
    for name, yolo_path, beit_path in (
            ("msgpack", f"{FIXTURES}/yolo_synthetic.msgpack", f"{FIXTURES}/beit_synthetic.msgpack"),
            ("torch", f"{tmp_path}/best.pt", f"{tmp_path}/beit.safetensors")):
        root = str(tmp_path / name)
        chip_smoke.copy_project(root)
        cfg = chip_smoke.pipeline_config(root, [("infer_dtype = bf16", "infer_dtype = f32"),
                                                ("yolo_weights =", f"yolo_weights = {yolo_path}"),
                                                ("beit_weights =", f"beit_weights = {beit_path}")])
        p = PT.setup_pipeline("gold_std", ConfigLoader(cfg, "gold_std"), None, device="cpu")
        records[name] = p.data_to_save
    assert sum(len(v) for v in records["torch"]["predictions"].values()) > 0
    for key in ("predictions", "global_bboxes_data", "optimised_bboxes"):
        np.testing.assert_equal(records["torch"][key], records["msgpack"][key])
