"""Checkpoints into the port's modules (port of
``tpu3dlm/models/weights.py``).

Two sources. User checkpoints in torch formats: ``load_torch_state_dict``
reads a ``.pt``/``.pth``/``.bin`` file (raw state dicts, ``{"state_dict":
...}`` wrappers, and ultralytics' ``{"model": nn.Module}`` objects, which
unpickle without the ultralytics package through ``_StubModules``) or a
``.safetensors`` file (read here: the card host has no safetensors
package); ``yolov10_from_ultralytics`` and ``beit_from_hf`` map ultralytics
YOLOv10 and HF ``BeitForImageClassification`` keys straight onto the
port's modules, which carry those layouts. And Flax variables trees (the
JAX package's msgpack checkpoints), carried by ``yolov10_from_flax`` /
``beit_from_flax``.

The Flax loaders take a Flax variables tree as nested dicts of numpy arrays
(``params``, plus ``batch_stats`` for YOLOv10) — what
``flax.serialization.msgpack_restore`` or ``jax.device_get`` gives — and
return the port module with those weights. Layout changes:
Conv ``(kh, kw, in/g, out)`` → ``(out, in/g, kh, kw)``; Dense ``(in, out)``
→ Linear ``(out, in)``; BatchNorm ``scale/bias/mean/var`` →
``weight/bias/running_mean/running_var``; LayerNorm ``scale`` → ``weight``.
Every port parameter must be covered and every Flax leaf used, or the
loader raises.

The way back, for checkpoints the port trains: ``yolov10_to_flax`` and
``beit_to_flax`` give the Flax trees (keys sorted, as a JAX tree map
leaves them) that ``models/checkpoint.py::write_flax_msgpack`` writes and
the JAX package's ``load_flax_checkpoint`` reads.
"""

from __future__ import annotations

import json
import re
from typing import Mapping

import numpy as np
import torch

from tpu3dlm_torch.models.beit import BeitClassifier, BeitConfig
from tpu3dlm_torch.models.yolov10 import YOLOv10

_DETECT_LAYER = 23


def _leaves(tree: Mapping, path=()):
    """(path, leaf) pairs; float leaves as float32, int8 kernels as is."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            v = np.asarray(v)
            yield path + (k,), v if v.dtype == np.int8 else v.astype(np.float32)


def _torch_value(leaf: str, v: np.ndarray) -> np.ndarray:
    if leaf in ("kernel", "kernel_q"):
        return np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
    return v


def _load_exact(module: torch.nn.Module, sd: dict[str, np.ndarray]) -> None:
    """Load ``sd`` into ``module``; every parameter and BatchNorm stat must
    be present (only ``num_batches_tracked`` counters may be absent)."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in sd if k not in own]
    if missing or unexpected:
        raise ValueError(f"checkpoint does not fit the port module: missing {missing[:8]}, unexpected {unexpected[:8]}")
    with torch.no_grad():
        for k, v in sd.items():
            if tuple(own[k].shape) != v.shape:
                raise ValueError(f"shape of {k}: port {tuple(own[k].shape)}, checkpoint {v.shape}")
            own[k].copy_(torch.from_numpy(np.array(v)))  # a writable copy


# ---------------------------------------------------------------------------
# torch-format checkpoint files
# ---------------------------------------------------------------------------


class _StubModules:
    """A ``sys.meta_path`` shim under which ultralytics ``.pt`` checkpoints
    unpickle without the ultralytics package.

    Ultralytics pickles model objects (``ultralytics.nn.tasks.
    DetectionModel``). Pickle never calls ``__init__``: it looks the class
    up and restores ``__dict__``, so a fabricated ``nn.Module`` subclass of
    the same name is a faithful stand-in whose restored ``_parameters``,
    ``_buffers`` and ``_modules`` make ``state_dict()`` exact. The shim
    fabricates such modules and classes for any missing ``ultralytics*``
    import and removes them on exit."""

    PREFIXES = ("ultralytics",)

    def __init__(self):
        self._installed: list[str] = []

    def __enter__(self):
        import importlib.machinery
        import importlib.util
        import sys
        import types

        installed = self._installed

        def make_module(name: str) -> types.ModuleType:
            mod = types.ModuleType(name)
            mod.__spec__ = importlib.machinery.ModuleSpec(name, None, is_package=True)
            mod.__path__ = []  # a package, so submodules import under it

            def __getattr__(attr, _name=name):
                if attr.startswith("__") and attr.endswith("__"):
                    raise AttributeError(attr)
                sub = f"{_name}.{attr}"
                if sub in sys.modules:
                    return sys.modules[sub]
                return type(attr, (torch.nn.Module,), {"__module__": _name})

            mod.__getattr__ = __getattr__
            return mod

        class MetaLoader:
            def find_spec(self, fullname, path=None, target=None):
                if fullname not in sys.modules and any(
                    fullname == p or fullname.startswith(p + ".") for p in _StubModules.PREFIXES
                ):
                    return importlib.util.spec_from_loader(fullname, self)
                return None

            def create_module(self, spec):
                installed.append(spec.name)
                return make_module(spec.name)

            def exec_module(self, module):
                pass

        self._meta = MetaLoader()
        sys.meta_path.insert(0, self._meta)
        return self

    def __exit__(self, *exc):
        import sys

        sys.meta_path.remove(self._meta)
        for name in self._installed:
            sys.modules.pop(name, None)
        return False


_SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """A ``.safetensors`` file → {name: array}: a little-endian u64 header
    length, a JSON header of ``{name: {"dtype", "shape", "data_offsets"}}``
    (plus an optional ``__metadata__``), then the raw little-endian tensor
    bytes. BF16 tensors come back as float32 (numpy has no bfloat16); the
    other types keep theirs. A header that does not fit the file raises
    ``ValueError``."""
    with open(path, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[:8], "little")
    if len(raw) < 8 or n > len(raw) - 8:
        raise ValueError(f"{path}: not a safetensors file (its header overruns the file)")
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        dt = np.dtype(_SAFETENSORS_DTYPES[info["dtype"]])
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(data) or end - begin != int(np.prod(shape)) * dt.itemsize:
            raise ValueError(f"{path}: tensor {name} does not fit its data offsets {begin}..{end}")
        a = np.frombuffer(data[begin:end], dt).reshape(shape)
        if info["dtype"] == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a.astype(a.dtype.newbyteorder("="))
    return out


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """A torch checkpoint file → {key: ndarray}. ``.safetensors`` through
    ``read_safetensors``; anything else through ``torch.load`` under the
    ``_StubModules`` shim: raw state dicts, ``{"state_dict": ...}``
    wrappers and ultralytics ``{"model": nn.Module}`` objects. Tensors come
    back as float32 (ultralytics stores float16), as the reference casts
    them. ``torch.load`` unpickles code: load only checkpoints you trust."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    with _StubModules():
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj and hasattr(obj["model"], "state_dict"):
        obj = obj["model"].state_dict()
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.detach().float().cpu().numpy() for k, v in obj.items()}


def yolov10_from_ultralytics(sd: Mapping[str, np.ndarray], variant: str = "n",
                             nc: int | None = None) -> YOLOv10:
    """An ultralytics YOLOv10 state dict (``model.{i}.<module path>``) →
    the port's ``YOLOv10`` (float32, CPU), whose keys are ultralytics' own.
    As the reference's converter: keys outside ``model.<layer>``, the fixed
    DFL projection (``model.23.dfl``) and ``num_batches_tracked`` are
    skipped; every other key must fit the module. ``nc`` defaults to the
    class count of the one-to-one head."""
    port_sd = {}
    for key, val in sd.items():
        toks = key.split(".")
        if toks[0] == "model":
            toks = toks[1:]
        if not toks or not toks[0].isdigit():
            continue
        if int(toks[0]) == _DETECT_LAYER and toks[1] == "dfl":
            continue
        if toks[-1] not in ("weight", "bias", "running_mean", "running_var"):
            continue
        port_sd[".".join(["model", *toks])] = np.asarray(val, np.float32)
    if nc is None:
        nc = int(port_sd[f"model.{_DETECT_LAYER}.one2one_cv3.0.2.weight"].shape[0])
    model = YOLOv10(nc=nc, variant=variant)
    _load_exact(model, port_sd)
    return model.eval()


# HF BeitForImageClassification → the port's names
_HF_BEIT_TOP = {
    "beit.embeddings.cls_token": "cls_token",
    "beit.embeddings.patch_embeddings.projection.weight": "patch_embed.weight",
    "beit.embeddings.patch_embeddings.projection.bias": "patch_embed.bias",
    "beit.pooler.layernorm.weight": "pool_ln.weight",
    "beit.pooler.layernorm.bias": "pool_ln.bias",
    "beit.layernorm.weight": "final_ln.weight",
    "beit.layernorm.bias": "final_ln.bias",
    "classifier.weight": "classifier.weight",
    "classifier.bias": "classifier.bias",
}
_HF_BEIT_LAYER = {
    "layernorm_before.weight": "ln1.weight",
    "layernorm_before.bias": "ln1.bias",
    "layernorm_after.weight": "ln2.weight",
    "layernorm_after.bias": "ln2.bias",
    "lambda_1": "lambda_1",
    "lambda_2": "lambda_2",
    "attention.attention.query.weight": "attn.query.weight",
    "attention.attention.query.bias": "attn.query.bias",
    "attention.attention.key.weight": "attn.key.weight",
    "attention.attention.value.weight": "attn.value.weight",
    "attention.attention.value.bias": "attn.value.bias",
    "attention.output.dense.weight": "attn.output.weight",
    "attention.output.dense.bias": "attn.output.bias",
    "attention.attention.relative_position_bias.relative_position_bias_table":
        "attn.relative_position_bias_table",
    "intermediate.dense.weight": "fc1.weight",
    "intermediate.dense.bias": "fc1.bias",
    "output.dense.weight": "fc2.weight",
    "output.dense.bias": "fc2.bias",
}
# buffers and parameters with no inference-time counterpart
_HF_BEIT_IGNORED = (re.compile(r"relative_position_index$"), re.compile(r"beit\.embeddings\.mask_token$"))


def beit_from_hf(sd: Mapping[str, np.ndarray], cfg: BeitConfig) -> BeitClassifier:
    """An HF ``BeitForImageClassification`` state dict → the port's
    ``BeitClassifier(cfg)`` (float32, CPU). A weight the mapping does not
    cover raises (other than the relative-position index buffers and the
    pretraining mask token): dropping it would load a structurally other
    model with weights missing."""
    port_sd, unconverted = {}, []
    for key, val in sd.items():
        name = _HF_BEIT_TOP.get(key)
        m = re.match(r"beit\.encoder\.layer\.(\d+)\.(.+)", key)
        if name is None and m and m.group(2) in _HF_BEIT_LAYER:
            name = f"layers.{m.group(1)}.{_HF_BEIT_LAYER[m.group(2)]}"
        if name is not None:
            port_sd[name] = np.asarray(val, np.float32)
        elif not any(rx.search(key) for rx in _HF_BEIT_IGNORED):
            unconverted.append(key)
    if unconverted:
        raise ValueError(
            "BEiT checkpoint carries weights this converter has no mapping for "
            f"(structurally incompatible config?): {unconverted[:8]}"
            + (" ..." if len(unconverted) > 8 else ""))
    model = BeitClassifier(cfg)
    _load_exact(model, port_sd)
    return model.eval()


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
    stem = "s2d" if np.shape(params["m0"]["conv"]["kernel"])[2] == 12 else "conv"
    model = YOLOv10(nc=nc, variant=variant, stem=stem)
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, v in _leaves(variables[collection]):
            sd[_yolo_key(path, collection)] = _torch_value(path[-1], v)
    _load_exact(model, sd)
    return model.eval()


def _flax_scope(name: str) -> list[str]:
    """A port module path's tokens → Flax names: each name takes the
    indices that follow it ('m.0' → 'm_0', 'cv3.0.1.0' → 'cv3_0_1_0')."""
    out: list[str] = []
    for t in name.split("."):
        if t.isdigit() and out:
            out[-1] += f"_{t}"
        else:
            out.append(t)
    return out


def _flax_value(module: torch.nn.Module, leaf: str, t: torch.Tensor) -> tuple[str, np.ndarray]:
    """A port parameter → (Flax leaf name, Flax layout) by module type."""
    v = t.detach().float().cpu().numpy()
    if leaf == "weight" and isinstance(module, torch.nn.Conv2d):
        return "kernel", np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0)))
    if leaf == "weight" and isinstance(module, torch.nn.Linear):
        return "kernel", np.ascontiguousarray(v.T)
    if leaf == "weight" and isinstance(module, (torch.nn.BatchNorm2d, torch.nn.LayerNorm)):
        return "scale", v
    return leaf, v


def _set_path(tree: dict, path: list[str], v) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    if path[-1] in tree:
        raise ValueError(f"two port tensors map to the Flax leaf {'/'.join(path)}")
    tree[path[-1]] = v


def _sorted_tree(tree: dict) -> dict:
    return {k: _sorted_tree(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def yolov10_to_flax(model: YOLOv10) -> dict:
    """The port's ``YOLOv10`` → Flax ``{"params", "batch_stats"}`` of
    ``tpu3dlm.models.yolov10.YOLOv10`` (numpy f32): the inverse of
    ``yolov10_from_flax``. Layer i is scope ``m{i}``, the head's one-to-many
    and one-to-one branches ``detect_o2m`` / ``detect_o2o``."""
    params: dict = {}
    stats: dict = {}
    for name, module in model.named_modules():
        toks = name.split(".")
        if len(toks) < 3 or toks[0] != "model":
            continue
        if int(toks[1]) == _DETECT_LAYER:
            head = toks[2]
            branch, head = ("detect_o2o", head[len("one2one_"):]) if head.startswith("one2one_") else ("detect_o2m", head)
            scope = [branch] + _flax_scope(".".join([head] + toks[3:]))
        else:
            scope = [f"m{toks[1]}"] + _flax_scope(".".join(toks[2:]))
        for leaf, t in module.named_parameters(recurse=False):
            key, v = _flax_value(module, leaf, t)
            _set_path(params, scope + [key], v)
        if isinstance(module, torch.nn.BatchNorm2d):
            _set_path(stats, scope + ["mean"], module.running_mean.detach().float().cpu().numpy())
            _set_path(stats, scope + ["var"], module.running_var.detach().float().cpu().numpy())
    return {"params": _sorted_tree(params), "batch_stats": _sorted_tree(stats)}


def beit_to_flax(model: BeitClassifier) -> dict:
    """The port's float ``BeitClassifier`` → Flax ``{"params": ...}`` of
    ``tpu3dlm.models.beit.BeitClassifier`` (numpy f32), the tree the
    reference's ``finetune_beit`` checkpoints: the inverse of
    ``beit_from_flax``. An int8 model raises (train and save the float one;
    ``quantize_beit_variables`` quantises a tree)."""
    if model.cfg.quant != "none":
        raise ValueError("beit_to_flax: only a float BEiT converts (quantise the Flax tree after)")
    params: dict = {}
    for name, module in model.named_modules():
        toks = name.split(".") if name else []
        if toks[:1] == ["layers"] and len(toks) > 1:
            toks = [f"layer{toks[1]}"] + toks[2:]
        for leaf, t in module.named_parameters(recurse=False):
            key, v = _flax_value(module, leaf, t)
            _set_path(params, toks + [key], v)
    return {"params": _sorted_tree(params)}


# ---------------------------------------------------------------------------
# BEiT: Flax names → port names
# ---------------------------------------------------------------------------


def _beit_key(path: tuple, int8_dense: bool = False) -> str:
    """('layer3', 'attn', 'query', 'kernel') → 'layers.3.attn.query.weight';
    the leaves of an ``Int8Dense`` (``int8_dense``): ``kernel_q`` →
    ``weight_q``, ``scale`` and ``bias`` as they are."""
    toks = list(path)
    if toks[0].startswith("layer"):
        toks = ["layers", toks[0][len("layer"):]] + toks[1:]
    names = {"kernel_q": "weight_q"} if int8_dense else {"kernel": "weight", "scale": "weight"}
    toks[-1] = names.get(toks[-1], toks[-1])
    return ".".join(toks)


def _is_int8_dense(params: Mapping, path: tuple) -> bool:
    node = params
    for k in path[:-1]:
        node = node[k]
    return "kernel_q" in node


def beit_config_from_flax(params: Mapping) -> BeitConfig:
    """Infer the ``BeitConfig`` a Flax BEiT tree was built with (int8 when
    its encoder projections carry ``kernel_q``)."""
    fc1 = params["layer0"]["fc1"]
    int8 = "kernel_q" in fc1
    kh, _, _, hidden = np.shape(params["patch_embed"]["kernel"])
    num_rel, heads = np.shape(params["layer0"]["attn"]["relative_position_bias_table"])
    grid = (int(round(np.sqrt(num_rel - 3))) + 1) // 2
    return BeitConfig(
        image_size=grid * kh,
        patch_size=kh,
        hidden_size=hidden,
        num_layers=sum(k.startswith("layer") for k in params),
        num_heads=heads,
        intermediate_size=int(np.shape(fc1["kernel_q" if int8 else "kernel"])[-1]),
        num_labels=int(np.shape(params["classifier"]["kernel"])[-1]),
        use_mean_pooling="pool_ln" in params,
        quant="int8" if int8 else "none",
    )


def beit_from_flax(variables: Mapping, cfg: BeitConfig | None = None) -> BeitClassifier:
    """Flax ``{"params"}`` of ``tpu3dlm.models.beit.BeitClassifier`` → the
    port's ``BeitClassifier`` (float32, CPU); the config is inferred from
    the tree unless given. A quantised tree (``quantize_beit_variables``
    here or in the JAX package: ``kernel_q`` int8, ``scale`` f32) goes into
    the ``Int8Dense`` modules of a ``quant="int8"`` model."""
    params = variables["params"]
    cfg = cfg or beit_config_from_flax(params)
    model = BeitClassifier(cfg)
    sd = {_beit_key(path, _is_int8_dense(params, path)): _torch_value(path[-1], v)
          for path, v in _leaves(params)}
    _load_exact(model, sd)
    return model.eval()


def quantize_beit_variables(variables: Mapping) -> dict:
    """Float BEiT variables (a Flax tree of numpy arrays) → int8 variables
    for ``BeitConfig(quant="int8")`` (port of
    ``tpu3dlm/models/weights.py::quantize_beit_variables``).

    Every encoder Dense kernel (attention q/k/v/output, fc1, fc2) becomes
    ``kernel_q`` int8 + per-output-channel ``scale`` f32
    (``ops/quant.py::quantize_weight``), its bias f32; everything else
    passes through. Refuses a tree that is already quantised."""
    from tpu3dlm_torch.ops.quant import quantize_weight

    def walk(tree: Mapping, path: tuple) -> dict:
        out: dict = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                if "kernel_q" in v:
                    raise ValueError(
                        f"quantize_beit_variables: {'/'.join(path + (k,))} is already int8-quantized")
                is_enc_dense = (k in ("fc1", "fc2") and path and path[-1].startswith("layer")) or (
                    k in ("query", "key", "value", "output") and len(path) >= 2
                    and path[-1] == "attn" and path[-2].startswith("layer"))
                if is_enc_dense and "kernel" in v:
                    wq, scale = quantize_weight(torch.from_numpy(np.array(v["kernel"], np.float32)))
                    q = {"kernel_q": wq.numpy(), "scale": scale.numpy()}
                    if "bias" in v:
                        q["bias"] = np.asarray(v["bias"], np.float32)
                    out[k] = q
                else:
                    out[k] = walk(v, path + (k,))
            else:
                out[k] = v
        return out

    return walk(dict(variables), ())

