"""Naive PyTorch oracles, twins of ``repro.kernels.ref``: O(S^2)-memory, small
shapes only. The kernels' plain versions and the tests are held against these."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,Sq,H,D], k/v [B,Skv,K,D] -> [B,Sq,H,D]. Naive masked softmax attention.

    Masks are end-aligned: q token i sits at absolute position i + (Skv - Sq)."""
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    group = H // K
    kk = k.repeat_interleave(group, dim=2).float()
    vv = v.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)


def rmsnorm_ref(x, scale, *, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
