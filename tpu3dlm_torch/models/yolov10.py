"""YOLOv10 in PyTorch — NMS-free detection (port of
``tpu3dlm/models/yolov10.py``).

The layer graph is the reference's spec table (ultralytics yolov10 yaml
layout) with its per-variant CIB overrides; the module list reproduces the
ultralytics ``DetectionModel`` state-dict prefix ("model.{i}...").

Public layouts follow the JAX package: ``YOLOv10.forward`` takes NHWC
(B, S, S, 3) floats in [0, 1] and returns the raw head maps NHWC. Inside,
the convs run NCHW-indexed on channels_last memory, so the NHWC↔NCHW
permutes at the boundary are free views.

Train mode (``module.train()``) is the reference's ``train=True``: the
BatchNorms use batch statistics (``layers.FlaxBatchNorm2d``), both heads
run, and the one-to-one head reads detached features, so only the
one-to-many loss shapes the backbone (``tpu3dlm/models/yolov10.py:228-231``).
``make_anchors`` and ``decode_raw`` are the training loss's decode
(``models/yolo_loss.py``).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn as nn

from tpu3dlm_torch.models import layers as L

REG_MAX = 16
STRIDES = (8, 16, 32)

# (from, repeats, module, args) — ultralytics yolov10 yaml layout; concat
# is implicit via a tuple "from", upsample is "up".
_SPEC_V10 = [
    (-1, 1, "Conv", (64, 3, 2)),  # 0  P1/2
    (-1, 1, "Conv", (128, 3, 2)),  # 1  P2/4
    (-1, 3, "C2f", (128, True)),  # 2
    (-1, 1, "Conv", (256, 3, 2)),  # 3  P3/8
    (-1, 6, "C2f", (256, True)),  # 4
    (-1, 1, "SCDown", (512, 3, 2)),  # 5  P4/16
    (-1, 6, "C2f", (512, True)),  # 6
    (-1, 1, "SCDown", (1024, 3, 2)),  # 7  P5/32
    (-1, 3, "C2f", (1024, True)),  # 8
    (-1, 1, "SPPF", (1024, 5)),  # 9
    (-1, 1, "PSA", (1024,)),  # 10
    (-1, 1, "up", ()),  # 11
    ((-1, 6), 1, "concat", ()),  # 12
    (-1, 3, "C2f", (512,)),  # 13
    (-1, 1, "up", ()),  # 14
    ((-1, 4), 1, "concat", ()),  # 15
    (-1, 3, "C2f", (256,)),  # 16  P3 out
    (-1, 1, "Conv", (256, 3, 2)),  # 17
    ((-1, 13), 1, "concat", ()),  # 18
    (-1, 3, "C2f", (512,)),  # 19  P4 out
    (-1, 1, "SCDown", (512, 3, 2)),  # 20
    ((-1, 10), 1, "concat", ()),  # 21
    (-1, 3, "C2fCIB", (1024, True, True)),  # 22  P5 out
]
_DETECT_FROM = (16, 19, 22)

# scale: (depth_multiple, width_multiple, max_channels)
_VARIANTS = {
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "b": (2 / 3, 1.0, 512),
    "l": (1.0, 1.0, 512),
    "x": (1.0, 1.25, 512),
}

_M_OVERRIDES = {
    8: ("C2fCIB", (1024, True)),
    19: ("C2fCIB", (512, True)),
    22: ("C2fCIB", (1024, True)),
}
_CIB_OVERRIDES: dict[str, dict[int, tuple[str, tuple]]] = {
    "n": {},
    "s": {8: ("C2fCIB", (1024, True, True))},
    "m": dict(_M_OVERRIDES),
    "b": dict(_M_OVERRIDES),
    "l": dict(_M_OVERRIDES),
    "x": {
        **_M_OVERRIDES,
        6: ("C2fCIB", (512, True)),
        13: ("C2fCIB", (512, True)),
    },
}


@dataclasses.dataclass(frozen=True)
class YoloVariant:
    depth: float
    width: float
    max_channels: int


def yolov10_variant(name: str) -> YoloVariant:
    return YoloVariant(*_VARIANTS[name])


def spec_for_variant(name: str) -> list:
    """The layer spec with the variant's CIB overrides applied."""
    spec = list(_SPEC_V10)
    for idx, (mod, args) in _CIB_OVERRIDES[name].items():
        frm, n, _, _ = spec[idx]
        spec[idx] = (frm, n, mod, args)
    return spec


class V10Detect(nn.Module):
    """Dual-assignment head: ``cv2``/``cv3`` one-to-many and their
    ``one2one_*`` copies. Serving reads only the one-to-one branch."""

    def __init__(self, nc: int, ch: tuple[int, ...]):
        super().__init__()
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(L.ConvBN(x, c2, 3), L.ConvBN(c2, c2, 3), nn.Conv2d(c2, 4 * REG_MAX, 1))
            for x in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(L.ConvBN(x, x, 3, g=x), L.ConvBN(x, c3, 1)),
                nn.Sequential(L.ConvBN(c3, c3, 3, g=c3), L.ConvBN(c3, c3, 1)),
                nn.Conv2d(c3, nc, 1),
            )
            for x in ch
        )
        self.one2one_cv2 = copy.deepcopy(self.cv2)
        self.one2one_cv3 = copy.deepcopy(self.cv3)

    def forward(self, feats, one2many: bool = False):
        """Both heads in train mode, where the one-to-one head reads the
        features detached; in eval mode the one-to-one head, and the
        one-to-many head when ``one2many``."""
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        o2o_feats = [x.detach() for x in feats] if self.training else feats
        out = {
            "one2one_split": [
                (nhwc(self.one2one_cv2[i](x)), nhwc(self.one2one_cv3[i](x)))
                for i, x in enumerate(o2o_feats)
            ]
        }
        if one2many or self.training:
            out["one2many_split"] = [
                (nhwc(self.cv2[i](x)), nhwc(self.cv3[i](x))) for i, x in enumerate(feats)
            ]
        return out


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, H, W, C) → (B, H/b, W/b, C·b²): fold spatial blocks into
    channels, ordered (row in block, column in block, channel) as the
    reference's ``space_to_depth``."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // block, block, W // block, block, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // block, W // block, C * block * block)


class YOLOv10(nn.Module):
    """YOLOv10 detector returning raw per-level head maps.

    ``forward(x)`` takes (B, S, S, 3) NHWC floats in [0, 1] (cast to the
    module's dtype) and returns ``{"one2one_split": [(box, cls), ...]}``
    with NHWC maps per level (and ``one2many_split`` when asked, and always
    in train mode).

    ``stem="s2d"`` replaces the stride-2 stem conv with space-to-depth and
    a stride-1 conv over 12 channels (the reference's ``stem="s2d"``);
    ultralytics checkpoints need the default ``"conv"``.
    """

    def __init__(self, nc: int = 80, variant: str = "n", stem: str = "conv"):
        super().__init__()
        if stem not in ("conv", "s2d"):
            raise ValueError(f"stem must be 'conv' or 's2d', got {stem!r}")
        self.nc = nc
        self.variant = variant
        self.stem = stem
        self._spec = spec_for_variant(variant)
        v = yolov10_variant(variant)
        ch = lambda c: L.scale_channels(c, v.width, v.max_channels)  # noqa: E731
        dp = lambda n: L.scale_depth(n, v.depth)  # noqa: E731

        mods: list[nn.Module] = []
        out_ch: list[int] = []
        for frm, n, mod, args in self._spec:
            if mod == "concat":
                mods.append(nn.Identity())
                out_ch.append(sum(out_ch[j] for j in frm))
                continue
            cin = out_ch[frm] if out_ch else 3
            if mod == "up":
                mods.append(nn.Identity())
                out_ch.append(cin)
                continue
            c2 = ch(args[0])
            if mod == "Conv" and not mods and stem == "s2d":
                mods.append(L.ConvBN(cin * args[2] ** 2, c2, args[1], 1))
            elif mod == "Conv":
                mods.append(L.ConvBN(cin, c2, args[1], args[2]))
            elif mod == "C2f":
                mods.append(L.C2f(cin, c2, dp(n), shortcut=bool(args[1]) if len(args) > 1 else False))
            elif mod == "SCDown":
                mods.append(L.SCDown(cin, c2, args[1], args[2]))
            elif mod == "SPPF":
                mods.append(L.SPPF(cin, c2, args[1]))
            elif mod == "PSA":
                mods.append(L.PSA(cin, c2))
            elif mod == "C2fCIB":
                mods.append(
                    L.C2fCIB(cin, c2, dp(n), shortcut=bool(args[1]),
                             lk=bool(args[2]) if len(args) > 2 else False)
                )
            else:
                raise ValueError(f"unknown module {mod}")
            out_ch.append(c2)
        mods.append(V10Detect(nc, tuple(out_ch[j] for j in _DETECT_FROM)))
        self.model = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, one2many: bool = False) -> dict:
        dtype = self.model[0].conv.weight.dtype
        if self.stem == "s2d":
            x = space_to_depth(x, self._spec[0][3][2])
        x = x.to(dtype).permute(0, 3, 1, 2)  # NHWC memory → channels_last NCHW
        outputs: list[torch.Tensor] = []
        for i, (frm, _n, mod, _args) in enumerate(self._spec):
            if mod == "concat":
                outputs.append(torch.cat([outputs[j] for j in frm], dim=1))
                continue
            inp = outputs[frm] if outputs else x
            outputs.append(L.upsample2x(inp) if mod == "up" else self.model[i](inp))
        return self.model[len(self._spec)]([outputs[j] for j in _DETECT_FROM], one2many)


# ---------------------------------------------------------------------------
# Decode and NMS-free postprocess
# ---------------------------------------------------------------------------


def make_anchors(img_size: int, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor centres (A, 2) in feature-cell units (x, y; cell + 0.5) and
    each anchor's stride (A,), level by level, row-major."""
    if img_size % 32:
        raise ValueError(f"img_size must be a multiple of 32, got {img_size}")
    pts, strs = [], []
    for s in STRIDES:
        h = w = img_size // s
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device) + 0.5,
            torch.arange(w, dtype=torch.float32, device=device) + 0.5,
            indexing="ij",
        )
        pts.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
        strs.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(pts), torch.cat(strs)


def flatten_raw(raw) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-level head maps → (box logits (B, A, 4, REG_MAX), class logits
    (B, A, nc)). ``raw`` is the split form ``[(box, cls), ...]`` or the
    reference's concatenated maps ``[(B, H, W, 4·REG_MAX + nc), ...]``."""
    if isinstance(raw[0], (tuple, list)):
        B = raw[0][0].shape[0]
        box = torch.cat([b.reshape(B, -1, 4 * REG_MAX) for b, _ in raw], 1)
        cls = torch.cat([c.reshape(B, -1, c.shape[-1]) for _, c in raw], 1)
    else:
        B = raw[0].shape[0]
        flat = torch.cat([r.reshape(B, -1, r.shape[-1]) for r in raw], 1)
        box, cls = flat[..., : 4 * REG_MAX], flat[..., 4 * REG_MAX:]
    return box.reshape(B, box.shape[1], 4, REG_MAX), cls


def decode_raw(raw, img_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-level head maps → (boxes xyxy (B, A, 4) px, class logits
    (B, A, nc)), differentiable. DFL: softmax over REG_MAX bins in f32 →
    the expected distance of each side (l, t, r, b) in strides."""
    box_logits, cls_logits = flatten_raw(raw)
    dev = box_logits.device
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
    dist = torch.softmax(box_logits.float(), dim=-1) @ bins  # (B, A, 4)
    anchors, strides = make_anchors(img_size, dev)
    x1y1 = (anchors[None] - dist[..., :2]) * strides[None, :, None]
    x2y2 = (anchors[None] + dist[..., 2:]) * strides[None, :, None]
    return torch.cat([x1y1, x2y2], -1), cls_logits


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis with ``jax.lax.top_k``'s tie order (lower
    index first). ``torch.topk`` promises no tie order, so this sorts
    stably and slices."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def postprocess(raw, img_size: int, max_det: int = 300, per_level: bool = True) -> dict[str, torch.Tensor]:
    """One-to-one head maps → top-``max_det`` boxes per image.

    ``raw`` is the split form ``[(box, cls), ...]`` (``one2one_split``) or
    the reference's concatenated maps ``[(B, H, W, 4·REG_MAX + nc), ...]``;
    both give the same result. Per level (``per_level=True``, reductions
    before any concatenation, as the reference's per-level path): max class
    logit → one sigmoid → conf, argmax → label, DFL softmax expectation →
    box in pixels. ``per_level=False`` is the reference's A/B baseline, bit
    for bit the same result: the maps concatenated, ``decode_raw``, then
    sigmoid over every class logit and the max and argmax of those. Returns
    boxes (B, D, 4), conf (B, D), label (B, D) int32, in descending conf
    order.
    """
    if img_size % 32:
        raise ValueError(f"img_size must be a multiple of 32, got {img_size}")
    split_in = isinstance(raw[0], (tuple, list))
    if not per_level:
        boxes, cls_logits = decode_raw(raw, img_size)
        # contiguous: the CPU's sigmoid over a strided slice of the
        # concatenated maps takes a scalar loop that rounds otherwise than
        # the vector one the per-level path gets, by an ulp
        conf, label = torch.sigmoid(cls_logits.float().contiguous()).max(dim=-1)
        label = label.to(torch.int32)
    else:
        dev = raw[0][0].device if split_in else raw[0].device
        bins = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
        conf_l, label_l, boxes_l = [], [], []
        for r, s in zip(raw, STRIDES):
            if split_in:
                box_map, cls_map = r
                B = box_map.shape[0]
                box_logits = box_map.reshape(B, -1, 4, REG_MAX)
                cls_logits = cls_map.reshape(B, box_logits.shape[1], -1)
            else:
                B = r.shape[0]
                flat = r.reshape(B, -1, r.shape[-1])
                box_logits = flat[..., : 4 * REG_MAX].reshape(B, flat.shape[1], 4, REG_MAX)
                cls_logits = flat[..., 4 * REG_MAX:]
            mx, arg = cls_logits.float().max(dim=-1)
            conf_l.append(torch.sigmoid(mx))
            label_l.append(arg.to(torch.int32))
            dist = torch.softmax(box_logits.float(), dim=-1) @ bins  # (B, n, 4)
            h = w = img_size // s
            ys, xs = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
                indexing="ij",
            )
            a = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
            x1y1 = (a[None] - dist[..., :2]) * float(s)
            x2y2 = (a[None] + dist[..., 2:]) * float(s)
            boxes_l.append(torch.cat([x1y1, x2y2], -1))
        conf = torch.cat(conf_l, 1)
        label = torch.cat(label_l, 1)
        boxes = torch.cat(boxes_l, 1)
    k = min(max_det, boxes.shape[1])
    top_conf, idx = topk_stable(conf, k)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_label = torch.gather(label, 1, idx)
    return {"boxes": top_boxes, "conf": top_conf, "label": top_label}
