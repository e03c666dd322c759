"""Mamba-2 (SSD) block, twin of ``repro.models.ssm``: in-proj -> causal depthwise
conv -> selective state-space scan (``kernels.ops.ssd_scan``) -> gated RMSNorm
(``kernels.ops.gated_rmsnorm``) -> out-proj.

Single B/C group (G=1) as in the mamba2/zamba2 configs. The scan runs chunked
(SSD dual form) for prefill and forward; decode carries a [B, H, N, P] f32 state
and a (W-1)-token conv tail in ``cfg.dtype``. The five projections are plain
matmuls, as XLA does them in the JAX package.

Tensor parallelism over "model" (``tp`` with ``tp.ssm``: the JAX package's
``constrain`` sites split z, xs and the normed y over "ffn" = d_inner and xh over
"ssm_heads"): each rank holds its 1/M of w_z, w_x, conv_x, gate_norm and the rows
of out_proj (d_inner) and of w_dt, a_log, dt_bias and d_skip (the heads), in
step, so its d_inner columns are its heads'. The block's input enters the split
region through ``copy_to``, and so do the replicated w_b, w_c, conv_b and conv_c
(the one B/C group serves every head: each rank's gradient of them covers its own
heads only, and the sum over the ranks is theirs). The depthwise conv runs on the
rank's xs channels and the whole B and C channels, K3 on its heads, the gated
norm over the split row (``ops.gated_rmsnorm_split``: each row's sum of squares
summed over "model" in f32, as GSPMD sums it), and out_proj is row-parallel: its
partial sums are reduced in f32 and rounded to the dtype once
(``reduce_partial``; bf16 under ``plan.bf16_reduce``), where the JAX package's
einsum names no ``preferred_element_type``. The decode state in the compute
layout: the rank's heads of ``ssd`` and a conv tail of its xs channels and all of
B and C (``models/model.py`` lays it out as the JAX package's cache).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.parallel.sharding import TensorParallel, axis_group, copy_to, reduce_partial


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
              state: Optional[dict] = None, tp: Optional[TensorParallel] = None):
    """x: [B, S, D]. state (decode): {"conv": [B,W-1,DI+2N], "ssd": [B,H,N,P]}, in
    the compute layout under ``tp`` (see the module docstring).
    Returns (y [B,S,D], the new state {"conv", "ssd"})."""
    B, S, D = x.shape
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    split = tp is not None and tp.ssm
    w_b, w_c, conv_b, conv_c = p["w_b"], p["w_c"], p["conv_b"], p["conv_c"]
    if split:        # the split region: d_inner and the heads over "model"
        plan = tp.plan
        x = copy_to(x, plan)
        w_b, w_c, conv_b, conv_c = (copy_to(t, plan) for t in (w_b, w_c, conv_b, conv_c))
    DI, Hs = p["w_x"].shape[-1], p["a_log"].shape[-1]           # this rank's

    z = x @ p["w_z"]                                             # gate branch
    xs = x @ p["w_x"]
    bm = x @ w_b
    cm = x @ w_c
    dt = x @ p["w_dt"]

    conv_in = torch.cat([xs, bm.to(xs.dtype), cm.to(xs.dtype)], dim=-1)
    conv_k = torch.cat([p["conv_x"], conv_b, conv_c], dim=-1)
    conv_out, new_tail = _causal_conv(conv_in, conv_k,
                                      None if state is None else state["conv"])
    conv_out = F.silu(conv_out.float()).to(xs.dtype)
    # K3 reads these views in place: a rank's row of Hs * P + 2N channels (P a
    # multiple of 32, N of 16, as K3 takes them) keeps them 16-byte aligned
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

    if split:
        y = ops.gated_rmsnorm_split(y, z, p["gate_norm"], cfg.d_inner,
                                    axis_group(tp.plan, "model"), eps=cfg.norm_eps)
        out = reduce_partial((y.reshape(B * S, DI) @ p["out_proj"]).reshape(B, S, D), tp.plan)
    else:
        y = ops.gated_rmsnorm(y, z, p["gate_norm"], eps=cfg.norm_eps)
        out = (y.reshape(B * S, DI) @ p["out_proj"]).reshape(B, S, D)
    return out, {"conv": new_tail, "ssd": new_ssd}


def ssm_state_defs(cfg: ArchConfig, batch: int, *lead: int) -> dict:
    """(shape, dtype) of the decode state, with ``lead`` dims (layers) first."""
    DI, N, W = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv_width
    return {"conv": (lead + (batch, W - 1, DI + 2 * N), getattr(torch, cfg.dtype)),
            "ssd": (lead + (batch, cfg.ssm_heads, N, cfg.ssm_head_dim), torch.float32)}
