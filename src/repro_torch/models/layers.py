"""Shared layer primitives, twins of ``repro.models.layers``: RMSNorm, RoPE, SwiGLU
MLP, GQA q/k/v projection and output projection, and the KV-cache write.

Parameters arrive as the dicts of ``models.params``. On one card every sharding
constraint of the JAX package is the identity, so none appears here, and the
dots keep their natural output dtype (the serving path's ``reduce_dtype`` is
None).
"""
from __future__ import annotations

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


def qkv_project(p: dict, x: torch.Tensor, *, positions: torch.Tensor,
                theta: float, eps: float):
    """Self-attention q [B,S,H,hd] and k, v [B,S,K,hd], with qk-norm and RoPE
    (one fused launch on the card where the layer has qk-norm)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
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
