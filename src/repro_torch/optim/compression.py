"""int8 compression with error feedback for the pod boundary, twin of
``repro.optim.compression``.

Symmetric per-tensor int8 with one f32 scale a leaf; the quantization residual
is carried to the next exchange (error feedback), so the compressed local-SGD
round stays unbiased over time. The arithmetic is the JAX package's, op by op,
so the bits are the same: the scale is formed before the division, ``x /
scale`` is a division (not a product with the reciprocal), and ``torch.round``
rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import tree_flatten_sorted, tree_leaves, tree_map, tree_unflatten_sorted


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q int8, scale f32 0-d tensor)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = (xf / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(tree: dict, ef: dict):
    """Quantize every leaf of ``tree`` plus its error feedback, leaf by leaf in the
    sorted flatten order. Returns ((q, scales), new_ef), trees of ``tree``'s
    structure."""
    qs, scales, new_ef = [], [], []
    for (_, x), (_, e) in zip(tree_flatten_sorted(tree), tree_flatten_sorted(ef)):
        v = x.float() + e
        q, s = quantize_int8(v)
        qs.append(q)
        scales.append(s)
        new_ef.append(v - dequantize_int8(q, s))
    unflat = lambda leaves: tree_unflatten_sorted(tree, leaves)  # noqa: E731
    return (unflat(qs), unflat(scales)), unflat(new_ef)


def decompress_tree(qs: dict, scales: dict) -> dict:
    return tree_map(dequantize_int8, qs, scales)


def init_error_feedback(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compressed_bytes(tree: dict) -> int:
    """Bytes on the wire for the int8-compressed tree (payload + scales)."""
    leaves = tree_leaves(tree)
    return sum(leaf.numel() for leaf in leaves) + 4 * len(leaves)
