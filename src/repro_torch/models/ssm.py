"""Mamba-2 (SSD) block, twin of ``repro.models.ssm``: in-proj -> causal depthwise
conv -> selective state-space scan (``kernels.ops.ssd_scan``) -> gated RMSNorm
(``kernels.ops.gated_rmsnorm``) -> out-proj.

Single B/C group (G=1) as in the mamba2/zamba2 configs. The scan runs chunked
(SSD dual form) for prefill and forward; decode carries a [B, H, N, P] f32 state
and a (W-1)-token conv tail in ``cfg.dtype``. The five projections are plain
matmuls, as XLA does them in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv in f32. x: [B, S, C], kernel: [W, C], tail:
    [B, W-1, C] (previous tokens, for decode). Returns (y [B,S,C] in x's dtype,
    new_tail [B,W-1,C])."""
    W = kernel.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)                             # [B, S+W-1, C]
    S = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for w in range(W):
        y = y + xp[:, w:w + S].float() * kernel[w].float()
    return y.to(x.dtype), xp[:, S:]                              # last W-1 inputs


def ssm_block(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
              state: Optional[dict] = None):
    """x: [B, S, D]. state (decode): {"conv": [B,W-1,DI+2N], "ssd": [B,H,N,P]}.
    Returns (y [B,S,D], the new state {"conv", "ssd"})."""
    B, S, D = x.shape
    DI, N, Hs, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    z = x @ p["w_z"]                                             # gate branch
    xs = x @ p["w_x"]
    bm = x @ p["w_b"]
    cm = x @ p["w_c"]
    dt = x @ p["w_dt"]

    conv_in = torch.cat([xs, bm.to(xs.dtype), cm.to(xs.dtype)], dim=-1)
    conv_k = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1)
    conv_out, new_tail = _causal_conv(conv_in, conv_k,
                                      None if state is None else state["conv"])
    conv_out = F.silu(conv_out.float()).to(xs.dtype)
    xs, bm, cm = conv_out[..., :DI], conv_out[..., DI:DI + N], conv_out[..., DI + N:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())           # [B,S,Hs] > 0
    a = -torch.exp(p["a_log"].float())                           # [Hs] < 0

    xh = xs.reshape(B, S, Hs, P)
    if state is None:
        y, new_ssd = ops.ssd_scan(xh, dt, a, bm, cm, chunk=cfg.ssm_chunk,
                                  return_state=True)
    else:
        y, new_ssd = ops.ssd_decode_step(xh, dt, a, bm, cm, state["ssd"])
    y = y + xh * p["d_skip"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(B, S, DI)

    y = ops.gated_rmsnorm(y, z, p["gate_norm"], eps=cfg.norm_eps)
    out = (y.reshape(B * S, DI) @ p["out_proj"]).reshape(B, S, D)
    return out, {"conv": new_tail, "ssd": new_ssd}


def ssm_state_defs(cfg: ArchConfig, batch: int, *lead: int) -> dict:
    """(shape, dtype) of the decode state, with ``lead`` dims (layers) first."""
    DI, N, W = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv_width
    return {"conv": (lead + (batch, W - 1, DI + 2 * N), getattr(torch, cfg.dtype)),
            "ssd": (lead + (batch, cfg.ssm_heads, N, cfg.ssm_head_dim), torch.float32)}
