"""Public kernel ops, dispatched by the device of the tensors they are given.

A CUDA tensor goes to the hand-written Hopper kernel (which launches or raises);
a CPU tensor goes to the kernel's plain PyTorch version. There is no switch and
no fallback from one to the other. ``attend_cache``, ``attend_cache_part``,
``attend_cache_ring`` and ``ssd_decode_step`` have no kernel in the JAX package either and are plain
PyTorch on both devices.

Training: when autograd is recording and an input requires grad,
``flash_attention``, ``rmsnorm``, ``add_rmsnorm``, ``gated_rmsnorm``,
``gated_rmsnorm_split``, ``qk_norm_rope`` and ``ssd_scan`` go through their autograd Function
(``kernels/autograd.py``: the kernels both ways on the card, the plain forward and
explicit backward on the CPU); otherwise, as on every serving call, they call the
kernel directly, without ``Function.apply``'s host cost.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import on_card as _on_card
from repro_torch.kernels import autograd as AG
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd_scan as SS

NEG_INF = -1e30


def _recording(*tensors) -> bool:
    """Autograd is recording and an input requires grad: take the Function."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,Sq,H,D], k/v [B,Skv,K,D] -> [B,Sq,H,D]. GQA via H % K == 0."""
    if _recording(q, k, v):
        if _on_card(q):
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return AG.FlashAttention.apply(q, k, v, causal, window)
    if _on_card(q):
        return FA.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                       causal=causal, window=window)
    return FA.flash_attention_plain(q, k, v, causal=causal, window=window)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    if _recording(x, scale):
        if _on_card(x):
            x, scale = x.contiguous(), scale.contiguous()
        return AG.RMSNorm.apply(x, scale, eps)
    if _on_card(x):
        return RN.rmsnorm_cuda(x.contiguous(), scale.contiguous(), eps=eps)
    return RN.rmsnorm_plain(x, scale, eps=eps)


def add_rmsnorm(x, r, scale, *, eps: float = 1e-6):
    """Residual add, then the next norm: returns (s, rmsnorm(s)) with s = x + r."""
    if _recording(x, r, scale):
        if _on_card(x):
            x, r, scale = x.contiguous(), r.contiguous(), scale.contiguous()
        return AG.AddRMSNorm.apply(x, r, scale, eps)
    if _on_card(x):
        return RN.add_rmsnorm_cuda(x.contiguous(), r.contiguous(), scale.contiguous(),
                                   eps=eps)
    return RN.add_rmsnorm_plain(x, r, scale, eps=eps)


def gated_rmsnorm(y, z, scale, *, eps: float = 1e-6):
    """mamba2's gated norm: rmsnorm(y * silu(z)), silu in f32."""
    if _recording(y, z, scale):
        if _on_card(y):
            y, z, scale = y.contiguous(), z.contiguous(), scale.contiguous()
        return AG.GatedRMSNorm.apply(y, z, scale, eps)
    if _on_card(y):
        return RN.gated_rmsnorm_cuda(y.contiguous(), z.contiguous(), scale.contiguous(),
                                     eps=eps)
    return RN.gated_rmsnorm_plain(y, z, scale, eps=eps)


def gated_rmsnorm_split(y, z, scale, width: int, group, *, eps: float = 1e-6):
    """mamba2's gated norm over rows of ``width`` columns split over the ranks of
    ``group`` (a process group; None: y holds the whole row): y, z [..., D_local]
    and scale [D_local] are this rank's columns. Each row's f32 sum of squares is
    summed over the group between the two launches."""
    if _recording(y, z, scale):
        if _on_card(y):
            y, z, scale = y.contiguous(), z.contiguous(), scale.contiguous()
        return AG.GatedRMSNormSplit.apply(y, z, scale, eps, width, group)
    card = _on_card(y)
    if card:
        y, z, scale = y.contiguous(), z.contiguous(), scale.contiguous()
    ss = RN.gated_rmsnorm_stats_cuda(y, z) if card else RN.gated_rmsnorm_stats_plain(y, z)
    if group is not None:
        dist.all_reduce(ss, group=group)
    norm = RN.gated_rmsnorm_split_cuda if card else RN.gated_rmsnorm_split_plain
    return norm(y, z, scale, ss, width, eps=eps)


def qk_norm_rope(q, k, q_scale, k_scale, positions, theta: float, *, eps: float = 1e-6):
    """qk-norm then split-half RoPE: q [B,S,H,hd], k [B,S,K,hd], positions [B,S]."""
    if _recording(q, k, q_scale, k_scale):
        if _on_card(q):
            q, k = q.contiguous(), k.contiguous()
            q_scale, k_scale = q_scale.contiguous(), k_scale.contiguous()
        return AG.QkNormRope.apply(q, k, q_scale, k_scale, positions, float(theta), eps)
    if _on_card(q):
        return RN.qk_norm_rope_cuda(q.contiguous(), k.contiguous(), q_scale.contiguous(),
                                    k_scale.contiguous(), positions, theta, eps=eps)
    return RN.qk_norm_rope_plain(q, k, q_scale, k_scale, positions, theta, eps=eps)


def attend_cache(q, k_cache, v_cache, pos, *, window: int = 0,
                 packed: bool = False):
    """Decode-step attention: q [B,1,H,D] against a [B,Smax,K,D] cache where
    positions >= ``pos``+1 are not yet written; ``pos`` broadcasts as [B,1,1,1].

    ``packed=True``: GQA grouped product straight against the cache, with no
    repeat of the kv heads; the probabilities are cast to q's dtype before the
    value product, as in the JAX package. Both forms accumulate in f32."""
    B, _, H, D = q.shape
    _, Smax, K, _ = k_cache.shape
    group = H // K
    k_pos = torch.arange(Smax, device=q.device)[None, None, None, :]
    if packed:
        qg = q.reshape(B, K, group, D).float()
        s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) / math.sqrt(D)
        mask = k_pos <= pos.reshape(B, 1, 1, 1)
        if window > 0:
            mask = mask & (pos.reshape(B, 1, 1, 1) - k_pos < window)
        p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype).float(), v_cache.float())
        return out.reshape(B, 1, H, D).to(q.dtype)
    kk = k_cache.float().repeat_interleave(group, dim=2)
    vv = v_cache.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(D)
    mask = k_pos <= pos
    if window > 0:
        mask = mask & (pos - k_pos < window)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)


def attend_cache_part(q, k_cache, v_cache, live):
    """One rank's share of a decode step's attention over its slice of a cache
    split along the sequence: q [B,1,H,D] (every head) against k/v [B,Sl,K,D],
    ``live`` [B,Sl] the slice's positions that hold a token. Returns the
    softmax's partial row max m [B,H], the sum l [B,H] of exp(s - m) over the live
    positions and o [B,H,D] = sum of exp(s - m) v, all f32 (the terms of
    ``attend_cache``'s f32 softmax, which the caller combines across the slices);
    a row with no live position gives l = 0 and o = 0."""
    B, _, H, D = q.shape
    group = H // k_cache.shape[2]
    kk = k_cache.float().repeat_interleave(group, dim=2)
    vv = v_cache.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), kk) / math.sqrt(D)
    s = torch.where(live[:, None, :], s, NEG_INF)
    m = s.max(dim=-1).values
    e = torch.exp(s - m[..., None]) * live[:, None, :]
    return m, e.sum(dim=-1), torch.einsum("bhk,bkhd->bhd", e, vv)


def attend_cache_ring(q, k_cache, v_cache, pos):
    """Decode attention against a ring-buffer window cache of size W.

    Slot s holds absolute position p_s = pos - ((pos - s) mod W); every live slot
    is inside the window by construction, so the only mask is p_s >= 0 (cold
    start). q [B,1,H,D]; k/v [B,W,K,D]; pos [B] (the position just written).
    Accumulates in f32, as the JAX package's."""
    B, _, H, D = q.shape
    _, W, K, _ = k_cache.shape
    group = H // K
    kk = k_cache.float().repeat_interleave(group, dim=2)
    vv = v_cache.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(D)
    slots = torch.arange(W, device=q.device)[None, :]
    p_slot = pos[:, None] - torch.remainder(pos[:, None] - slots, W)    # [B, W]
    mask = (p_slot >= 0)[:, None, None, :]
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)


def ssd_scan(x, dt, a, bm, cm, *, chunk: int = 256, init_state=None,
             return_state: bool = False):
    """Mamba-2 SSD chunked scan. x [B,S,H,P], dt [B,S,H], a [H], bm/cm [B,S,N],
    init_state [B,H,N,P] f32 or None -> y [B,S,H,P] (and the final state)."""
    if _recording(x, dt, a, bm, cm, init_state):
        if _on_card(x):   # x, bm, cm are read in place, as below
            dt, a = dt.contiguous(), a.contiguous()
            init_state = None if init_state is None else init_state.contiguous()
        y, h = AG.SSDScan.apply(x, dt, a, bm, cm, init_state, chunk)
    elif _on_card(x):   # x, bm, cm are read in place: the model passes conv-output slices
        y, h = SS.ssd_scan_cuda(
            x, dt.contiguous(), a.contiguous(), bm, cm, chunk=chunk,
            init_state=None if init_state is None else init_state.contiguous())
    else:
        y, h = SS.ssd_scan_plain(x, dt, a, bm, cm, chunk=chunk, init_state=init_state)
    return (y, h) if return_state else y


def ssd_decode_step(x, dt, a, bm, cm, state):
    """One-token SSD recurrence. x [B,1,H,P], dt [B,1,H], bm/cm [B,1,N],
    state [B,H,N,P] -> (y [B,1,H,P], new_state)."""
    xf, dtf = x[:, 0].float(), dt[:, 0].float()
    bf, cf = bm[:, 0].float(), cm[:, 0].float()
    decay = torch.exp(dtf * a.float()[None, :])                  # [B,H]
    inject = torch.einsum("bn,bhp->bhnp", bf, xf * dtf[..., None])
    new_state = state.float() * decay[..., None, None] + inject
    y = torch.einsum("bn,bhnp->bhp", cf, new_state)
    return y[:, None].to(x.dtype), new_state.to(state.dtype)
