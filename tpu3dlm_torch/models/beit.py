"""BEiT image classifier in PyTorch (port of ``tpu3dlm/models/beit.py``).

Matches HF ``BeitForImageClassification`` parameter for parameter, with the
module names of the Flax model (``layers.{i}.attn.query`` ...) so Flax
variables load mechanically (models/weights.py): patch embed, per-layer
relative position bias, k-bias-free QKV, layer-scale residuals, mean
pooling + ``pool_ln``. LayerNorm eps 1e-12, exact GELU.

Attention runs through kernel B1 (``ops/kernels/attention.py``): the CUDA
kernel for CUDA tensors, its plain twin for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu3dlm_torch.device import as_device_tensor
from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed


@dataclasses.dataclass(frozen=True)
class BeitConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_labels: int = 2
    layer_norm_eps: float = 1e-12
    layer_scale_init_value: float = 0.1
    use_mean_pooling: bool = True
    # kept for config parity with the JAX package; the port has one
    # attention path (kernel B1 on the card, its twin on the CPU)
    attn_impl: str = "auto"
    quant: str = "none"  # "int8" is not ported yet

    def __post_init__(self):
        if self.quant not in ("none", "int8"):
            raise ValueError(f"BeitConfig.quant must be 'none' or 'int8', got {self.quant!r}")

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid


def relative_position_index(grid: int) -> np.ndarray:
    """(N+1, N+1) int32 index into the relative-position-bias table: 2D
    window-relative offsets for patch↔patch plus three special entries for
    cls↔patch, patch↔cls and cls↔cls."""
    h = w = grid
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    num_rel = (2 * h - 1) * (2 * w - 1) + 3
    n = h * w
    index = np.zeros((n + 1, n + 1), np.int32)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_rel - 3
    index[0:, 0] = num_rel - 2
    index[0, 0] = num_rel - 1
    return index


class BeitAttention(nn.Module):
    def __init__(self, cfg: BeitConfig):
        super().__init__()
        c = cfg
        self.num_heads = c.num_heads
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size, bias=False)  # BEiT: no k bias
        self.value = nn.Linear(c.hidden_size, c.hidden_size)
        self.output = nn.Linear(c.hidden_size, c.hidden_size)
        num_rel = (2 * c.grid - 1) ** 2 + 3
        self.relative_position_bias_table = nn.Parameter(torch.zeros(num_rel, c.num_heads))
        index = torch.from_numpy(relative_position_index(c.grid).reshape(-1).astype(np.int64))
        self.register_buffer("rel_index", index, persistent=False)

    def forward(self, x):
        B, N, _ = x.shape
        bias = self.relative_position_bias_table[self.rel_index]  # (N·N, h)
        bias = bias.reshape(N, N, self.num_heads).permute(2, 0, 1).float().contiguous()
        out = beit_attention_packed(self.query(x), self.key(x), self.value(x), bias, self.num_heads)
        return self.output(out)


class BeitLayer(nn.Module):
    def __init__(self, cfg: BeitConfig):
        super().__init__()
        c = cfg
        self.lambda_1 = nn.Parameter(torch.full((c.hidden_size,), c.layer_scale_init_value))
        self.lambda_2 = nn.Parameter(torch.full((c.hidden_size,), c.layer_scale_init_value))
        self.ln1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.attn = BeitAttention(c)
        self.ln2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        x = x + self.lambda_1 * self.attn(self.ln1(x))
        h = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="none"))
        return x + self.lambda_2 * h


class BeitClassifier(nn.Module):
    """BEiT encoder + mean-pool classification head.

    ``forward(pixels)``: (B, S, S, 3) NHWC normalised floats → (B, labels)
    logits in the module's dtype.
    """

    def __init__(self, cfg: BeitConfig | None = None):
        super().__init__()
        c = cfg or BeitConfig()
        if c.quant == "int8":
            raise NotImplementedError("int8 BEiT is not ported yet (ROADMAP A21)")
        self.cfg = c
        self.patch_embed = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.layers = nn.ModuleList(BeitLayer(c) for _ in range(c.num_layers))
        if c.use_mean_pooling:
            self.pool_ln = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        else:
            self.final_ln = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.classifier = nn.Linear(c.hidden_size, c.num_labels)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        B = pixels.shape[0]
        x = self.patch_embed(pixels.to(self.cls_token.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, N-1, hidden), patches row-major
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1).contiguous()
        for layer in self.layers:
            x = layer(x)
        if self.cfg.use_mean_pooling:
            pooled = self.pool_ln(x[:, 1:, :].mean(dim=1))
        else:
            pooled = self.final_ln(x)[:, 0]
        return self.classifier(pooled)


IMAGENET_MEAN = (0.5, 0.5, 0.5)
IMAGENET_STD = (0.5, 0.5, 0.5)


def preprocess_crops(crops: torch.Tensor) -> torch.Tensor:
    """uint8 (B, S, S, 3) → normalised float32: rescale 1/255, then
    mean/std 0.5 (BeitImageProcessor parity)."""
    x = crops.float() / 255.0
    mean = as_device_tensor(IMAGENET_MEAN, crops.device, torch.float32)
    std = as_device_tensor(IMAGENET_STD, crops.device, torch.float32)
    return (x - mean) / std
