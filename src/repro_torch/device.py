"""Device resolution shared by the port's entry points."""
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
