"""BEiT classifier finetuning on one device (port of
``tpu3dlm/parallel/finetune.py::init_finetune`` and
``make_beit_train_step``).

The step is the reference's: ``loss = mean(cross_entropy(model(
preprocess_crops(crops_u8)), labels))`` (optax's
``softmax_cross_entropy_with_integer_labels`` then ``.mean()``), its
gradient through the whole BEiT — attention included: kernel B1 is a
``torch.autograd.Function`` whose backward recomputes the reference's VJP —
and one AdamW update with optax ``adamw``'s settings. On one device the
reference's ``pmean`` of loss and gradients is the identity.

The port keeps PyTorch's stateful form instead of the functional
``(params, opt_state, crops, labels) → (params, opt_state, loss)``: the
module holds the parameters, the optimizer its moments, and
``train_step(crops_u8, labels)`` updates both in place and returns the
loss. After a step every parameter's ``.grad`` holds that step's gradient.

Not ported: ``augment`` (in-step crop augmentation draws from JAX PRNG
streams, ROADMAP A19) and data parallelism over a mesh (A22); both raise
``NotImplementedError``. The YOLO step (``make_yolo_train_step``) waits for
the TAL loss (A19).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu3dlm_torch.device import as_device_tensor, resolve_device
from tpu3dlm_torch.models.beit import BeitClassifier, preprocess_crops

# optax.adamw's defaults besides the learning rate; its weight decay (1e-4)
# is not torch's (1e-2), and optax decays every parameter (mask=None)
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def adamw(params, lr: float) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` set as optax ``adamw(lr)``. The two rules are
    one: torch scales p by (1 − lr·wd) before the Adam step, optax adds
    wd·p to the Adam direction before scaling by −lr; both give
    p − lr·(m̂/(√v̂ + eps) + wd·p)."""
    return torch.optim.AdamW(
        params, lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY
    )


def init_finetune(
    beit: BeitClassifier, lr: float = 1e-4, device: str | torch.device = "cuda"
) -> torch.optim.AdamW:
    """Move ``beit`` (its weights as they are: seeded, or carried from Flax
    by ``models.weights.beit_from_flax``) to ``device`` in place and return
    its optimizer. The reference's ``init_finetune`` also initialises the
    parameters; a port module is initialised when it is built."""
    beit.to(resolve_device(device))
    return adamw(beit.parameters(), lr)


def beit_loss(beit: BeitClassifier, crops_u8: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's ``loss_fn``: mean softmax cross-entropy of the
    logits of the preprocessed uint8 crops against integer labels."""
    logits = beit(preprocess_crops(crops_u8))
    return F.cross_entropy(logits.float(), labels.long())


def make_beit_train_step(
    beit: BeitClassifier,
    optimizer: torch.optim.Optimizer,
    mesh=None,
    augment: dict | None = None,
    device: str | torch.device = "cuda",
):
    """Returns ``train_step(crops_u8, labels) → loss``: one forward,
    backward and optimizer update of ``beit`` on ``device`` (where the
    module must already be, see ``init_finetune``). ``crops_u8`` is
    (B, S, S, 3) uint8 and ``labels`` (B,) integer, numpy or tensors on
    ``device``; the loss comes back as a 0-d f32 tensor on ``device``."""
    if augment is not None:
        raise NotImplementedError("crop augmentation in the step is not ported yet (ROADMAP A19)")
    if mesh is not None:
        raise NotImplementedError("data-parallel finetuning over a mesh is not ported yet (ROADMAP A22)")
    dev = resolve_device(device)
    devices = {p.device for p in beit.parameters()}
    if len(devices) > 1:
        raise NotImplementedError(f"parameters on {len(devices)} devices: one device only (ROADMAP A22)")
    if devices != {dev}:
        raise ValueError(f"the module is on {devices.pop()}, the step on {dev}; call init_finetune")

    def train_step(crops_u8, labels) -> torch.Tensor:
        crops = as_device_tensor(crops_u8, dev)
        if crops.dtype != torch.uint8:
            raise ValueError(f"crops must be uint8, got {crops.dtype}")
        optimizer.zero_grad(set_to_none=True)
        loss = beit_loss(beit, crops, as_device_tensor(labels, dev))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
