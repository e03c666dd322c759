"""int8 compression with error feedback for the pod boundary, twin of
``repro.optim.compression``.

Symmetric per-tensor int8 with one f32 scale a leaf; the quantization residual
is carried to the next exchange (error feedback), so the compressed local-SGD
round stays unbiased over time. The arithmetic is the JAX package's, op by op,
so the bits are the same: the scale is formed before the division, ``x /
scale`` is a division (not a product with the reciprocal), and ``torch.round``
rounds half to even as ``jnp.round`` does.

A leaf sharded over ranks (a DTensor's local shard, in the local-SGD round on a
mesh) is scaled by the whole leaf's absmax: ``quantize_int8``'s ``axes``, the
mesh axes of ``plan`` that split the leaf, take the MAX of the shards' absmaxes
before the divide, so each shard's int8 values and error feedback are the whole
leaf's, element for element.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.parallel.sharding import max_over
from repro_torch.tree import tree_flatten_sorted, tree_leaves, tree_map, tree_unflatten_sorted


def quantize_int8(x: torch.Tensor, plan=None,
                  axes: Sequence[str] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q int8, scale f32 0-d tensor). ``x`` is
    a shard of a leaf split over ``plan``'s mesh ``axes`` (none: the whole leaf),
    whose absmax is the MAX over them."""
    xf = x.float()
    top = xf.abs().max()
    for axis in axes:
        top = max_over(top, plan, axis)
    scale = torch.clamp(top, min=1e-12) / 127.0
    q = (xf / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_leaf(x: torch.Tensor, ef: torch.Tensor, plan=None, axes: Sequence[str] = ()):
    """Quantize ``x`` plus its error feedback ``ef`` (``quantize_int8``'s
    ``plan`` and ``axes``). Returns (q, scale, new_ef)."""
    v = x.float() + ef
    q, s = quantize_int8(v, plan, axes)
    return q, s, v - dequantize_int8(q, s)


def compress_tree(tree: dict, ef: dict):
    """``compress_leaf`` on every leaf of ``tree``, in the sorted flatten order.
    Returns ((q, scales), new_ef), trees of ``tree``'s structure."""
    qs, scales, new_ef = [], [], []
    for (_, x), (_, e) in zip(tree_flatten_sorted(tree), tree_flatten_sorted(ef)):
        q, s, e = compress_leaf(x, e)
        qs.append(q)
        scales.append(s)
        new_ef.append(e)
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
