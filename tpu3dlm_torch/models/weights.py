"""Carry Flax variables into the port's modules (the inverse direction of
``tpu3dlm/models/weights.py``).

Both loaders take a Flax variables tree as nested dicts of numpy arrays
(``params``, plus ``batch_stats`` for YOLOv10) — what
``flax.serialization.msgpack_restore`` or ``jax.device_get`` gives — and
return the port module with those weights. Layout changes:
Conv ``(kh, kw, in/g, out)`` → ``(out, in/g, kh, kw)``; Dense ``(in, out)``
→ Linear ``(out, in)``; BatchNorm ``scale/bias/mean/var`` →
``weight/bias/running_mean/running_var``; LayerNorm ``scale`` → ``weight``.
Every port parameter must be covered and every Flax leaf used, or the
loader raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpu3dlm_torch.models.beit import BeitClassifier, BeitConfig
from tpu3dlm_torch.models.yolov10 import YOLOv10

_DETECT_LAYER = 23


def _leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v, np.float32)


def _torch_value(leaf: str, v: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        return np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
    return v


def _load_exact(module: torch.nn.Module, sd: dict[str, np.ndarray]) -> None:
    """Load ``sd`` into ``module``; every parameter and BatchNorm stat must
    be present (only ``num_batches_tracked`` counters may be absent)."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in sd if k not in own]
    if missing or unexpected:
        raise ValueError(f"Flax tree does not fit the port module: missing {missing[:8]}, unexpected {unexpected[:8]}")
    with torch.no_grad():
        for k, v in sd.items():
            if tuple(own[k].shape) != v.shape:
                raise ValueError(f"shape of {k}: port {tuple(own[k].shape)}, Flax {v.shape}")
            own[k].copy_(torch.from_numpy(np.array(v)))  # a writable copy


# ---------------------------------------------------------------------------
# YOLOv10: Flax names → ultralytics keys
# ---------------------------------------------------------------------------


def _yolo_key(path: tuple, collection: str) -> str:
    """('m2', 'm_0', 'cv1', 'conv', 'kernel') → 'model.2.m.0.cv1.conv.weight';
    ('detect_o2o', 'cv3_0_1', 'conv', 'kernel') →
    'model.23.one2one_cv3.0.1.conv.weight'."""
    scope = path[0]
    if scope.startswith("detect_"):
        prefix = "" if scope == "detect_o2m" else "one2one_"
        name, *idx = path[1].split("_")
        toks = ["model", str(_DETECT_LAYER), prefix + name, *idx]
        rest = path[2:]
    else:
        toks = ["model", scope[1:]]
        rest = path[1:]
    for t in rest[:-1]:
        parts = t.split("_")
        toks.extend(parts if len(parts) > 1 and all(p.isdigit() for p in parts[1:]) else [t])
    leaf = rest[-1]
    if collection == "params":
        toks.append({"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf])
    else:
        toks.append({"mean": "running_mean", "var": "running_var"}[leaf])
    return ".".join(toks)


def yolov10_from_flax(variables: Mapping, variant: str = "n", nc: int | None = None) -> YOLOv10:
    """Flax ``{"params", "batch_stats"}`` of ``tpu3dlm.models.yolov10.
    YOLOv10`` → the port's ``YOLOv10`` (float32, CPU). ``nc`` defaults to
    the class count of the one-to-one head."""
    params = variables["params"]
    if nc is None:
        nc = int(np.shape(params["detect_o2o"]["cv3_0_2"]["kernel"])[-1])
    model = YOLOv10(nc=nc, variant=variant)
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, v in _leaves(variables[collection]):
            sd[_yolo_key(path, collection)] = _torch_value(path[-1], v)
    _load_exact(model, sd)
    return model.eval()


# ---------------------------------------------------------------------------
# BEiT: Flax names → port names
# ---------------------------------------------------------------------------


def _beit_key(path: tuple) -> str:
    """('layer3', 'attn', 'query', 'kernel') → 'layers.3.attn.query.weight'."""
    toks = list(path)
    if toks[0].startswith("layer"):
        toks = ["layers", toks[0][len("layer"):]] + toks[1:]
    toks[-1] = {"kernel": "weight", "scale": "weight"}.get(toks[-1], toks[-1])
    return ".".join(toks)


def beit_config_from_flax(params: Mapping) -> BeitConfig:
    """Infer the ``BeitConfig`` a Flax BEiT tree was built with."""
    kh, _, _, hidden = np.shape(params["patch_embed"]["kernel"])
    num_rel, heads = np.shape(params["layer0"]["attn"]["relative_position_bias_table"])
    grid = (int(round(np.sqrt(num_rel - 3))) + 1) // 2
    return BeitConfig(
        image_size=grid * kh,
        patch_size=kh,
        hidden_size=hidden,
        num_layers=sum(k.startswith("layer") for k in params),
        num_heads=heads,
        intermediate_size=int(np.shape(params["layer0"]["fc1"]["kernel"])[-1]),
        num_labels=int(np.shape(params["classifier"]["kernel"])[-1]),
        use_mean_pooling="pool_ln" in params,
    )


def beit_from_flax(variables: Mapping, cfg: BeitConfig | None = None) -> BeitClassifier:
    """Flax ``{"params"}`` of ``tpu3dlm.models.beit.BeitClassifier`` → the
    port's ``BeitClassifier`` (float32, CPU); the config is inferred from
    the tree unless given."""
    params = variables["params"]
    cfg = cfg or beit_config_from_flax(params)
    model = BeitClassifier(cfg)
    sd = {_beit_key(path): _torch_value(path[-1], v) for path, v in _leaves(params)}
    _load_exact(model, sd)
    return model.eval()

