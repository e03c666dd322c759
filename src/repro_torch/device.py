"""Device resolution shared by the port's entry points, and the two checks every
kernel dispatch makes: which path a tensor takes, and that a kernel wrapper is
never handed an input whose gradient it would drop."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``torch.device`` for ``device``; raises when it names CUDA and there is no
    card, so an entry point never quietly carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel path), False for a CPU tensor (the plain
    path); raises for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {x.device}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd is recording and an input requires grad: a kernel's output
    has no ``grad_fn``, so the gradient through it would be dropped without a
    word. Inside an autograd Function's forward and backward, recording is off."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} was called on an input that requires grad with autograd "
            "recording: its output would carry no gradient. Call it through "
            "repro_torch.kernels.ops, which routes such inputs through the "
            "kernel's autograd Function")
