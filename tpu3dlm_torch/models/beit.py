"""BEiT image classifier in PyTorch (port of ``tpu3dlm/models/beit.py``).

Matches HF ``BeitForImageClassification`` parameter for parameter, with the
module names of the Flax model (``layers.{i}.attn.query`` ...) so Flax
variables load mechanically (models/weights.py): patch embed, per-layer
relative position bias, k-bias-free QKV, layer-scale residuals, mean
pooling + ``pool_ln``. LayerNorm eps 1e-12, exact GELU.

Attention takes the route ``BeitConfig.attn_impl`` names. ``"auto"`` (the
default) and ``"pallas"`` run kernel B1 (``ops/kernels/attention.py``): the
CUDA kernel for CUDA tensors, its plain twin for CPU tensors; scores stay
f32. ``"einsum"`` runs the reference's einsum attention in plain PyTorch on
any device, with its numerics: scores, the 1/√d scale and the bias add in
the compute dtype, the softmax in f32 cast back to v's dtype, the product
with v in the compute dtype. The Pipeline picks ``"einsum"`` under
``use_pallas = false``, as the reference's does.

``BeitConfig(quant="int8")`` makes every encoder projection (attention
q/k/v/output, fc1, fc2) an ``Int8Dense`` (``ops/quant.py``: per-row int8
activations, an int8 product, f32 dequantisation), as the JAX package's
``_encoder_dense`` does; patch embed, LayerNorms, the pooling and the head
stay float, and attention takes its route in the module's dtype. Int8 weights
come from a float model or checkpoint: ``quantize_beit`` here, or
``models/weights.py::quantize_beit_variables`` on a Flax tree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu3dlm_torch.device import as_device_tensor
from tpu3dlm_torch.models.layers import init_seeded_
from tpu3dlm_torch.ops.kernels.attention import beit_attention_packed
from tpu3dlm_torch.ops.quant import dense_int8, quantize_weight


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
    # "auto" or "pallas": kernel B1 (its twin on the CPU); "einsum": the
    # reference's einsum attention in plain PyTorch (module docstring)
    attn_impl: str = "auto"
    quant: str = "none"  # "int8": int8 encoder projections (Int8Dense)

    def __post_init__(self):
        if self.quant not in ("none", "int8"):
            raise ValueError(f"BeitConfig.quant must be 'none' or 'int8', got {self.quant!r}")
        if self.attn_impl not in ("auto", "pallas", "einsum"):
            raise ValueError(f"BeitConfig.attn_impl must be 'auto', 'pallas' or 'einsum', got {self.attn_impl!r}")

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


class Int8Dense(nn.Module):
    """Dense with an int8 kernel and a per-output-channel f32 scale (port of
    ``tpu3dlm/models/beit.py::Int8Dense``).

    Buffers: ``weight_q`` int8 (out, in), the transpose of the Flax
    ``kernel_q`` (in, out), so the card's int8 GEMM reads it column-major;
    ``scale`` f32 (out,); ``bias`` f32 (out,) or none. ``.to(dtype)`` moves
    them between devices but never changes their dtypes: the
    dequantisation and the bias stay f32, and the output takes the input's
    dtype, as ``dense_int8(out_dtype=None)`` gives it. Inference only."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "Int8Dense":
        """Quantise a float ``nn.Linear`` (``ops/quant.py::quantize_weight``
        on its (in, out) kernel)."""
        q = cls(linear.in_features, linear.out_features, linear.bias is not None)
        wq, scale = quantize_weight(linear.weight.detach().float().t())
        q.weight_q.copy_(wq.t())
        q.scale.copy_(scale)
        if linear.bias is not None:
            q.bias.copy_(linear.bias.detach().float())
        return q

    def _apply(self, fn, recurse=True):
        def keep_dtype(t):
            out = fn(t)
            return out if out.dtype == t.dtype else t.to(out.device)

        return super()._apply(keep_dtype, recurse)

    def forward(self, x):
        return dense_int8(x, self.weight_q.t(), self.scale, self.bias)


def _encoder_dense(cfg: BeitConfig, in_features: int, out_features: int, bias: bool = True) -> nn.Module:
    """``nn.Linear`` or ``Int8Dense`` for an encoder projection, per
    ``cfg.quant``."""
    if cfg.quant == "int8":
        return Int8Dense(in_features, out_features, bias)
    return nn.Linear(in_features, out_features, bias=bias)


def einsum_attention(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """The reference's einsum attention (``tpu3dlm/models/beit.py``, the
    ``attn_impl="einsum"`` branch) on packed (B, N, h·d) q, k, v and the
    (h, N, N) bias: scores, ``/ sqrt(d)`` and the bias add in q's dtype,
    softmax in f32 cast to v's dtype, then the product with v."""
    B, N, H = q.shape
    hd = H // num_heads

    def split(t):
        return t.reshape(B, N, num_heads, hd).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    attn = q @ k.transpose(-1, -2)
    attn = attn / torch.tensor(float(hd), dtype=torch.float32).sqrt().to(attn.dtype)
    attn = attn + bias[None].to(attn.dtype)
    attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
    return (attn @ v).transpose(1, 2).reshape(B, N, H)


class BeitAttention(nn.Module):
    def __init__(self, cfg: BeitConfig):
        super().__init__()
        c = cfg
        self.num_heads = c.num_heads
        self.einsum = c.attn_impl == "einsum"
        self.query = _encoder_dense(c, c.hidden_size, c.hidden_size)
        self.key = _encoder_dense(c, c.hidden_size, c.hidden_size, bias=False)  # BEiT: no k bias
        self.value = _encoder_dense(c, c.hidden_size, c.hidden_size)
        self.output = _encoder_dense(c, c.hidden_size, c.hidden_size)
        num_rel = (2 * c.grid - 1) ** 2 + 3
        self.relative_position_bias_table = nn.Parameter(torch.zeros(num_rel, c.num_heads))
        index = torch.from_numpy(relative_position_index(c.grid).reshape(-1).astype(np.int64))
        self.register_buffer("rel_index", index, persistent=False)

    def forward(self, x):
        B, N, _ = x.shape
        bias = self.relative_position_bias_table[self.rel_index]  # (N·N, h)
        bias = bias.reshape(N, N, self.num_heads).permute(2, 0, 1)
        attend = einsum_attention if self.einsum else beit_attention_packed
        out = attend(self.query(x), self.key(x), self.value(x), bias.float().contiguous(), self.num_heads)
        return self.output(out)


class BeitLayer(nn.Module):
    def __init__(self, cfg: BeitConfig):
        super().__init__()
        c = cfg
        self.layer_scale_init_value = c.layer_scale_init_value  # for models.layers.init_like_flax_
        self.lambda_1 = nn.Parameter(torch.full((c.hidden_size,), c.layer_scale_init_value))
        self.lambda_2 = nn.Parameter(torch.full((c.hidden_size,), c.layer_scale_init_value))
        self.ln1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.attn = BeitAttention(c)
        self.ln2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.fc1 = _encoder_dense(c, c.hidden_size, c.intermediate_size)
        self.fc2 = _encoder_dense(c, c.intermediate_size, c.hidden_size)

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


def quantize_beit(model: BeitClassifier) -> BeitClassifier:
    """A float ``BeitClassifier`` → its int8 twin (``quant="int8"``), on the
    CPU in f32: every encoder projection quantised by ``Int8Dense.
    from_linear``, every other parameter copied. Refuses an int8 model."""
    if model.cfg.quant == "int8":
        raise ValueError("quantize_beit: the model is already int8-quantized")
    src = model.float().cpu()
    q = BeitClassifier(dataclasses.replace(model.cfg, quant="int8"))
    with torch.no_grad():
        for name, module in q.named_modules():
            if isinstance(module, Int8Dense):
                fresh = Int8Dense.from_linear(src.get_submodule(name))
                for key, buf in fresh.named_buffers():
                    module.get_buffer(key).copy_(buf)
        own = {k for k, _ in q.named_parameters()}
        for k, v in src.state_dict().items():
            if k in own:
                q.get_parameter(k).copy_(v)
    return q.eval()


def seeded_beit(cfg: BeitConfig, generator: torch.Generator) -> BeitClassifier:
    """Seeded random BEiT (``models.layers.init_seeded_``); for
    ``quant="int8"`` the same float draw, quantised."""
    model = init_seeded_(BeitClassifier(dataclasses.replace(cfg, quant="none")), generator)
    return quantize_beit(model) if cfg.quant == "int8" else model


IMAGENET_MEAN = (0.5, 0.5, 0.5)
IMAGENET_STD = (0.5, 0.5, 0.5)


def preprocess_crops(crops: torch.Tensor) -> torch.Tensor:
    """uint8 (B, S, S, 3) → normalised float32: rescale 1/255, then
    mean/std 0.5 (BeitImageProcessor parity)."""
    x = crops.float() / 255.0
    mean = as_device_tensor(IMAGENET_MEAN, crops.device, torch.float32)
    std = as_device_tensor(IMAGENET_STD, crops.device, torch.float32)
    return (x - mean) / std
