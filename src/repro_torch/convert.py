"""Convert a JAX-package parameter tree into the port's tree.

The caller hands over the tree as nested dicts of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``); this module imports neither
jax nor the JAX package. Names and shapes map 1:1 (``models.params``). bf16
arrives as numpy's ml_dtypes ``bfloat16`` and goes through its uint16 bits, so
no value is rounded on the way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.tree import tree_map


def _to_tensor(x, dev: torch.device) -> torch.Tensor:
    a = np.array(x)          # an owned, writable copy for torch.from_numpy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def to_torch(tree, device="cuda"):
    """Nested dicts/tuples of numpy arrays -> the same tree of tensors on ``device``."""
    dev = devices.resolve(device)
    return tree_map(lambda x: _to_tensor(x, dev), tree)
