"""Device resolution and the numerics policy (the role of
``tpu3dlm/utils/backend.py``).

The port never picks a device on its own: entry points take an explicit
``device`` (default ``"cuda"``) and raise when CUDA is asked for but absent.
Nothing falls back to the CPU silently; the CPU runs only when the caller
passes ``device="cpu"``, as the tests do.

TF32 is switched off here, once, for matmuls AND cuDNN convolutions (cuDNN
defaults to TF32). TF32 keeps ~3 decimal digits: inside the depth median it
would round millimetre depths by 8–16 mm, and the reference's history shows
reduced-precision cross terms flipping nearest-neighbour picks. The bf16
serving path is unaffected — it asks for bf16 explicitly.
"""

from __future__ import annotations

import torch


def set_numerics_policy() -> None:
    """Full-precision float32 on the card: no TF32 in matmuls or convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` → ``torch.device``; raises if CUDA
    is requested on a host without it. Applies the numerics policy."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpu3dlm_torch: device='cuda' requested but torch.cuda is not "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"tpu3dlm_torch: unsupported device {device!r}")
    set_numerics_policy()
    return dev


def as_device_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy/sequence → tensor on ``device``. A tensor already on another
    device raises: moving data between devices is the caller's decision.

    Host data bound for a card is staged in page-locked memory and copied
    with ``non_blocking=True``, so the host goes on while the stream's
    queued work runs (a pageable copy would first wait for it). PyTorch's
    pinned host allocator keeps the staging block until the event recorded
    behind its copy has completed, so a block is never reused early."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(
                f"tensor on {x.device} passed to a call on {device}; move it "
                "explicitly"
            )
        return x if dtype is None else x.to(dtype)
    if device.type != "cuda":
        return torch.as_tensor(x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype).pin_memory().to(device, non_blocking=True)


def module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device
