"""Shared layer primitives, twins of ``repro.models.layers``: RMSNorm, RoPE, SwiGLU
MLP, GQA q/k/v projection and output projection, and the KV-cache write.

Parameters arrive as the dicts of ``models.params``. On one card every sharding
constraint of the JAX package is the identity, and the dots keep their natural
output dtype (the serving path's ``reduce_dtype`` is None).

Tensor parallelism over "model" (the attention and MLP layers of every family
on a multi-rank mesh, the cross-attention's and the moe layers' shared experts'
included; the mamba2 block's is in ``models/ssm.py``, the experts' in
``models/moe.py``): a layer
given ``tp`` (``parallel.sharding.TensorParallel``) takes each rank's local shards
of the weights and runs at the JAX package's ``constrain`` sites the collectives
of ``parallel/sharding.py``, Megatron-LM's way. ``swiglu`` is column-parallel in
``w_gate`` and ``w_up`` and row-parallel in ``w_down``; ``qkv_project`` gives the
local q heads and the k/v heads the rank holds: its 1/M of them where the axis
divides the kv heads, else all of them (``local_kv`` then slices the kv heads of
the local q heads' groups before K1); ``attn_out`` is row-parallel. K2's
``qk_norm_rope`` and K1 run on the local heads unchanged. A replicated tensor that
enters a split region (x, the qk-norm scales, the undivided ``wk``/``wv``, a
cross-attention's memory) goes through ``copy_to``, so its gradient is summed
over the ranks. Without ``tp``
(one card, a one-rank mesh, or a split the axis does not divide: every rank then
holds and computes the whole) the code is the one-card code.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import apply_rope, rope_freqs  # noqa: F401  (RoPE lives with the kernels)
from repro_torch.parallel.sharding import TensorParallel, copy_to, reduce_partial


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps=eps)


# ------------------------------------------------------------------------------- MLP
def swiglu(p: dict, x: torch.Tensor, tp: Optional[TensorParallel] = None) -> torch.Tensor:
    split = tp is not None and tp.ffn
    if split:
        x = copy_to(x, tp.plan)
    h = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(h.float()).to(x.dtype) * u.to(x.dtype)
    out = h @ p["w_down"]
    if split:       # w_down contracts over the split ffn dim
        out = reduce_partial(out, tp.plan)
    return out.to(x.dtype)


# -------------------------------------------------------------------------- attention
def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one contiguous matmul."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).unflatten(-1, (H, hd))


def qkv_project(p: dict, x: torch.Tensor, *, positions: Optional[torch.Tensor],
                theta: float, eps: float, kv_from: Optional[torch.Tensor] = None,
                tp: Optional[TensorParallel] = None):
    """q [B,S,H,hd] from x and k, v [B,M,K,hd] from ``kv_from`` (cross-attention)
    or x (self-attention), with qk-norm and RoPE (one fused launch on the card
    where the layer has qk-norm); ``positions`` None: neither (a cross-attention
    layer has no qk-norm, ``params.attn_defs(cross=True)``).

    ``kv_from`` in another dtype than the weights (the Trainer's bf16 patches
    under f32 params) is promoted to theirs, exactly, as the JAX package's
    einsum promotes it: one of the model's two casts of mixed dtypes (the other
    is ``model.Model._encode``'s).

    With ``tp`` splitting the heads: q of the local heads, k/v of the kv heads the
    rank holds (see the module docstring); ``kv_from`` must have entered the split
    region already (``copy_to``: the model enters the memory once, before its
    decoder stack, rather than once a layer)."""
    if tp is not None and tp.heads:
        return _qkv_split(p, x, positions, theta, eps, tp, kv_from)
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


def _qkv_split(p: dict, x: torch.Tensor, positions, theta: float, eps: float,
               tp: TensorParallel, kv_from: Optional[torch.Tensor] = None):
    """``qkv_project`` on the local heads: x, the qk-norm scales and undivided
    k/v weights enter the split region through ``copy_to``; ``kv_from`` (the
    cross-attention's memory) has entered it before."""
    plan = tp.plan
    x = copy_to(x, plan)
    src = x if kv_from is None else kv_from.to(p["wk"].dtype)
    wk, wv = p["wk"], p["wv"]
    if not tp.kv_heads:
        wk, wv = copy_to(wk, plan), copy_to(wv, plan)
    q, k, v = _project(x, p["wq"]), _project(src, wk), _project(src, wv)
    if positions is None:
        return q, k, v
    if "q_norm" in p:
        q, k = ops.qk_norm_rope(q, k, copy_to(p["q_norm"], plan), copy_to(p["k_norm"], plan),
                                positions, theta, eps=eps)
    else:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def local_kv(q: torch.Tensor, kv: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """The kv heads (dim 2) of ``kv`` that the local q heads of ``q`` attend: all
    of them but where ``tp`` splits the q heads and not the kv heads; there the
    kv heads of the local q heads' groups, a contiguous run (K1 maps q head i to
    kv head i // (Hq / Hk))."""
    if tp is None or not tp.heads or tp.kv_heads:
        return kv
    Hl, K = q.shape[2], kv.shape[2]
    group = Hl * tp.size // K
    if Hl % group == 0:
        n = Hl // group
    elif group % Hl == 0:
        n = 1
    else:
        raise NotImplementedError(
            f"{Hl} local q heads in groups of {group}: neither divides the other")
    return kv.narrow(2, tp.rank * Hl // group, n)


def attn_out(p: dict, o: torch.Tensor, tp: Optional[TensorParallel] = None) -> torch.Tensor:
    H, hd, D = p["wo"].shape
    out = o.flatten(-2) @ p["wo"].reshape(H * hd, D)
    if tp is not None and tp.heads:     # wo contracts over the split heads
        out = reduce_partial(out, tp.plan)
    return out.to(o.dtype)


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


def _cache_write_slice(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> None:
    """Write new [B, 1, K, D] into this rank's slice [B, Sl, K, D] of a
    sequence-split cache at per-row index idx into the slice; a row whose idx
    falls outside the slice (its position lies on another rank) writes nothing."""
    B, Sl = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    at = idx.long().clamp(0, Sl - 1)
    keep = ((idx >= 0) & (idx < Sl)).reshape(B, 1, 1)
    cache[rows, at] = torch.where(keep, new[:, 0].to(cache.dtype), cache[rows, at])
