"""YOLOv10 building blocks in PyTorch (port of ``tpu3dlm/models/layers.py``).

NCHW modules with ultralytics' module layout and attribute names, so the
state-dict keys are the ultralytics ones ("model.2.m.0.cv1.conv.weight")
and Flax variables map onto them mechanically (models/weights.py).
BatchNorm uses eps 1e-3 as in the reference; convs pad k//2.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm (eps 1e-3) + optional SiLU — the
    ultralytics ``Conv``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 3)
        self.cv2 = ConvBN(c_, c2, 3)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with 2 convolutions, fast variant."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1)
        self.cv2 = ConvBN((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, e=1.0) for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SCDown(nn.Module):
    """Spatial-channel decoupled downsampling: 1×1 projection + k×k
    depthwise strided conv."""

    def __init__(self, c1: int, c2: int, k: int, s: int):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1, 1)
        self.cv2 = ConvBN(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast (3 chained max-pools)."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    """PSA attention: conv-QKV multi-head attention with a depthwise
    positional conv. Plain matmul attention (not a ported kernel): scores
    and softmax in f32, probabilities cast to the activation dtype, as in
    the reference."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim**-0.5
        h = dim + self.key_dim * num_heads * 2
        self.qkv = ConvBN(dim, h, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        qkv = self.qkv(x).reshape(B, self.num_heads, self.key_dim * 2 + self.head_dim, N)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = (q.float().transpose(-2, -1) @ k.float()) * self.scale
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = (v @ attn.transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(out + self.pe(v.reshape(B, C, H, W)))


class PSA(nn.Module):
    """Partial self-attention block."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        self.c = int(c1 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1)
        self.cv2 = ConvBN(2 * self.c, c2, 1)
        self.attn = Attention(self.c, num_heads=max(1, self.c // 64), attn_ratio=0.5)
        self.ffn = nn.Sequential(
            ConvBN(self.c, self.c * 2, 1), ConvBN(self.c * 2, self.c, 1, act=False)
        )

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat((a, b), 1))


class RepVGGDW(nn.Module):
    """7×7 DW + 3×3 DW, summed, SiLU."""

    def __init__(self, ed: int):
        super().__init__()
        self.conv = ConvBN(ed, ed, 7, 1, g=ed, act=False)
        self.conv1 = ConvBN(ed, ed, 3, 1, g=ed, act=False)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """Compact inverted block."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(
            ConvBN(c1, c1, 3, g=c1),
            ConvBN(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else ConvBN(2 * c_, 2 * c_, 3, g=2 * c_),
            ConvBN(2 * c_, c2, 1),
            ConvBN(c2, c2, 3, g=c2),
        )
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f with CIB bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, e)
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, e=1.0, lk=lk) for _ in range(n))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample (NCHW)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def make_divisible(v: float, divisor: int = 8) -> int:
    return max(divisor, int(v + divisor / 2) // divisor * divisor)


def scale_channels(c: int, width: float, max_channels: int) -> int:
    return make_divisible(min(c, max_channels) * width)


def scale_depth(n: int, depth: float) -> int:
    return max(round(n * depth), 1) if n > 1 else n


@torch.no_grad()
def init_seeded_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init, drawn on the CPU from ``generator`` so a seed
    gives the same weights on every device: weights N(0, 1/fan_in), biases
    and LayerNorm/BatchNorm affine terms small normal perturbations of
    their neutral values, BatchNorm running stats mean 0 ± 0.1 and var in
    [0.5, 1.5]. Every parameter is non-trivial, so no path is inert."""

    def draw(shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=generator) * std + mean

    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if name == "weight" and isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                new = draw(p.shape, 0.05, 1.0)
            elif name.startswith("lambda_"):  # BEiT layer scale
                new = draw(p.shape, 0.02, 0.1)
            elif name == "weight" and p.dim() >= 2:
                fan_in = math.prod(p.shape[1:])
                new = draw(p.shape, 1.0 / math.sqrt(fan_in))
            else:
                new = draw(p.shape, 0.02)
            p.copy_(new.to(p.dtype))
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(draw(m.running_mean.shape, 0.1))
            m.running_var.copy_(
                torch.rand(m.running_var.shape, generator=generator) + 0.5
            )
    return module


@torch.no_grad()
def calibrate_batchnorm_(model: nn.Module, *inputs) -> nn.Module:
    """Set every BatchNorm's running statistics to those of one forward
    pass over ``inputs``, then return the model in eval mode. Random
    weights alone let activations fade through YOLOv10's ~60 conv layers
    until every anchor scores the same; calibrated, they keep the spread a
    trained network has, so smoke runs and parity checks see distinct
    confidences."""
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    saved = [bn.momentum for bn in bns]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # cumulative average: one batch → its statistics
    model.train()
    model(*inputs)
    for bn, m in zip(bns, saved):
        bn.momentum = m
    return model.eval()
