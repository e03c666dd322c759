"""Naive PyTorch oracles, twins of ``repro.kernels.ref``: O(S^2)-memory, small
shapes only. The kernels' plain versions and the tests are held against these.
RoPE (twin of ``repro.models.layers``) lives here too, so that the fused
qk-norm + RoPE kernel's plain version can use it without importing ``models``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def widen(x: torch.Tensor) -> torch.Tensor:
    """x in f32, the kernels' accumulation type; float64 stays float64 (the
    gradient checks of the autograd Functions run in it)."""
    return x if x.dtype == torch.float64 else x.float()


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


def ssd_ref(x, dt, a, bm, cm):
    """Naive per-timestep SSD recurrence (the oracle for the SSD scan).

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * B_t x_t^T ;  y_t = C_t . h_t
    x [B,S,H,P], dt [B,S,H], a [H], bm/cm [B,S,N] -> y [B,S,H,P], final h [B,H,N,P]
    """
    B, S, H, P = x.shape
    N = bm.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), bm.float(), cm.float()
    af = a.float()
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * af[None, :])                         # [B,H]
        inject = torch.einsum("bn,bhp->bhnp", bf[:, t], xf[:, t] * dtf[:, t, :, None])
        h = h * decay[..., None, None] + inject
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def rmsnorm_ref(x, scale, *, eps: float = 1e-6):
    xf = widen(x)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * widen(scale)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half RoPE in f32. x: [B, S, H, D] (D even), positions: [B, S]."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                        # [D/2]
    angles = positions[..., None].float() * freqs                 # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = widen(x).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
