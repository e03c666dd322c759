"""Shared layer primitives, twins of ``repro.models.layers``: RMSNorm, RoPE, SwiGLU
MLP, GQA q/k/v projection and output projection, and the KV-cache write.

Parameters arrive as the dicts of ``models.params``. On one card every sharding
constraint of the JAX package is the identity, so none appears here, and the
dots keep their natural output dtype (the serving path's ``reduce_dtype`` is
None).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import apply_rope, rope_freqs  # noqa: F401  (RoPE lives with the kernels)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps=eps)


# ------------------------------------------------------------------------------- MLP
def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(h.float()).to(x.dtype) * u.to(x.dtype)
    return (h @ p["w_down"]).to(x.dtype)


# -------------------------------------------------------------------------- attention
def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one contiguous matmul."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).unflatten(-1, (H, hd))


def qkv_project(p: dict, x: torch.Tensor, *, positions: Optional[torch.Tensor],
                theta: float, eps: float, kv_from: Optional[torch.Tensor] = None):
    """q [B,S,H,hd] from x and k, v [B,M,K,hd] from ``kv_from`` (cross-attention)
    or x (self-attention), with qk-norm and RoPE (one fused launch on the card
    where the layer has qk-norm); ``positions`` None: neither (a cross-attention
    layer has no qk-norm, ``params.attn_defs(cross=True)``).

    ``kv_from`` in another dtype than the weights (the Trainer's bf16 patches
    under f32 params) is promoted to theirs, exactly, as the JAX package's
    einsum promotes it: one of the model's two casts of mixed dtypes (the other
    is ``model.Model._encode``'s)."""
    src = x if kv_from is None else kv_from.to(p["wk"].dtype)
    q = _project(x, p["wq"])
    k = _project(src, p["wk"])
    v = _project(src, p["wv"])
    if positions is None:
        return q, k, v
    if "q_norm" in p:
        q, k = ops.qk_norm_rope(q, k, p["q_norm"], p["k_norm"], positions, theta, eps=eps)
    else:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def attn_out(p: dict, o: torch.Tensor) -> torch.Tensor:
    H, hd, D = p["wo"].shape
    return (o.flatten(-2) @ p["wo"].reshape(H * hd, D)).to(o.dtype)


def _cache_update(cache: torch.Tensor, new: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Write new [B, 1, K, D] into cache [B, Smax, K, D] at per-row position pos.

    The JAX package blends a one-hot row mask over the whole cache, a functional
    update that rewrites every position. Here it is an in-place index write into
    the preallocated cache: one row per batch entry. As with the one-hot blend, a
    row whose pos is past the end (an idle serving slot) writes nothing."""
    B, Smax = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    idx = pos.long().clamp(max=Smax - 1)
    keep = (pos < Smax).reshape(B, 1, 1)
    cache[rows, idx] = torch.where(keep, new[:, 0].to(cache.dtype), cache[rows, idx])
    return cache
