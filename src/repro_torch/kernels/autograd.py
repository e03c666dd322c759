"""Autograd Functions of the kernel ops the models train through.

The port's twin of the JAX package's custom VJP around flash attention
(``_flash_blocked``, ``src/repro/kernels/ops.py:134-145``) and of autodiff through
``ref.rmsnorm_ref``, mamba2's gate and the jnp SSD scan ``_ssd_blocked``. Each
Function runs both directions on one path, picked by the
device of its first input as ``ops`` picks it: a CUDA tensor goes to the
hand-written kernels, forward and backward; a CPU tensor to the plain forward and
the plain *explicit* backward (the ``*_bwd_plain`` twins), never to autodiff of the
plain forward. So the CPU tests run the same Function the card runs.

What each saves: q, k, v, o and the forward's LSE for flash attention (O(S), as
the JAX VJP); the input of the norm for the norms (x; s = x + r for add_rmsnorm;
y and z for gated_rmsnorm, and over a split row also its rows' summed sum of
squares; the pre-norm q and k for qk_norm_rope); the scan's
inputs for the SSD scan, whose backward recomputes the states it needs.

``ops`` enters these only when autograd is recording and an input requires grad;
serving never does. Inside ``forward`` and ``backward`` recording is off, which is
what lets the ``*_cuda`` wrappers refuse to be called with it on.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import on_card
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd_scan as SS


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        if on_card(q):
            o, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                             return_lse=True)
        else:
            o, lse = FA.flash_attention_plain(q, k, v, causal=causal, window=window,
                                              return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if on_card(q):
            dq, dk, dv = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do.contiguous(),
                                                     causal=ctx.causal, window=ctx.window)
        else:
            dq, dk, dv = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


class RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps: float):
        y = RN.rmsnorm_cuda(x, scale, eps=eps) if on_card(x) else \
            RN.rmsnorm_plain(x, scale, eps=eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        if on_card(x):
            dx, dscale = RN.rmsnorm_bwd_cuda(x, scale, dy.contiguous(), eps=ctx.eps)
        else:
            dx, dscale = RN.rmsnorm_bwd_plain(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


class AddRMSNorm(torch.autograd.Function):
    """(s, rmsnorm(s)) with s = x + r. The cotangent of s is None where the caller
    drops s (the final norm), so the backward then reads no zeros."""

    @staticmethod
    def forward(ctx, x, r, scale, eps: float):
        ctx.set_materialize_grads(False)
        if on_card(x):
            s, y = RN.add_rmsnorm_cuda(x, r, scale, eps=eps)
        else:
            s, y = RN.add_rmsnorm_plain(x, r, scale, eps=eps)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        return s, y

    @staticmethod
    def backward(ctx, ds, dn):
        s, scale = ctx.saved_tensors
        if dn is None:       # rmsnorm(s) unused: only the stream's own cotangent
            return ds, ds, None, None
        if on_card(s):
            dx, dscale = RN.add_rmsnorm_bwd_cuda(
                s, scale, None if ds is None else ds.contiguous(), dn.contiguous(),
                eps=ctx.eps)
        else:
            dx, dscale = RN.add_rmsnorm_bwd_plain(s, scale, ds, dn, eps=ctx.eps)
        return dx, dx, dscale, None


class GatedRMSNorm(torch.autograd.Function):
    """rmsnorm(y * silu(z)), mamba2's gated norm."""

    @staticmethod
    def forward(ctx, y, z, scale, eps: float):
        out = RN.gated_rmsnorm_cuda(y, z, scale, eps=eps) if on_card(y) else \
            RN.gated_rmsnorm_plain(y, z, scale, eps=eps)
        ctx.save_for_backward(y, z, scale)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dout):
        y, z, scale = ctx.saved_tensors
        bwd = RN.gated_rmsnorm_bwd_cuda if on_card(y) else RN.gated_rmsnorm_bwd_plain
        dy, dz, dscale = bwd(y, z, scale, dout.contiguous(), eps=ctx.eps)
        return dy, dz, dscale, None


class GatedRMSNormSplit(torch.autograd.Function):
    """rmsnorm(y * silu(z)) of a row whose ``width`` columns are split over the
    ranks of ``group``, this rank holding y, z [..., D_local] and scale [D_local]:
    each direction sums a row statistic (f32, one float a row) over the group
    between its two passes: the sum of t^2 forward, that of dout * scale * t
    backward. dscale is this rank's columns'. ``group`` None: no sum (the local
    columns are the whole row)."""

    @staticmethod
    def forward(ctx, y, z, scale, eps: float, width: int, group):
        card = on_card(y)
        ss = RN.gated_rmsnorm_stats_cuda(y, z) if card else RN.gated_rmsnorm_stats_plain(y, z)
        if group is not None:
            dist.all_reduce(ss, group=group)
        norm = RN.gated_rmsnorm_split_cuda if card else RN.gated_rmsnorm_split_plain
        out = norm(y, z, scale, ss, width, eps=eps)
        ctx.save_for_backward(y, z, scale, ss)
        ctx.eps, ctx.width, ctx.group = eps, width, group
        return out

    @staticmethod
    def backward(ctx, dout):
        y, z, scale, ss = ctx.saved_tensors
        dout = dout.contiguous()
        card = on_card(y)
        dot = (RN.gated_rmsnorm_split_dot_cuda if card else RN.gated_rmsnorm_split_dot_plain)(
            y, z, scale, dout)
        if ctx.group is not None:
            dist.all_reduce(dot, group=ctx.group)
        bwd = RN.gated_rmsnorm_split_bwd_cuda if card else RN.gated_rmsnorm_split_bwd_plain
        dy, dz, dscale = bwd(y, z, scale, dout, ss, dot, ctx.width, eps=ctx.eps)
        return dy, dz, dscale, None, None, None


class SSDScan(torch.autograd.Function):
    """(y, final_state) of the chunked SSD scan. The cotangent of the final state
    is None where the caller drops it (the training path), and the backward then
    reads no zeros; that of y is None where only the state is used."""

    @staticmethod
    def forward(ctx, x, dt, a, bm, cm, init_state, chunk: int):
        ctx.set_materialize_grads(False)
        scan = SS.ssd_scan_cuda if on_card(x) else SS.ssd_scan_plain
        y, h = scan(x, dt, a, bm, cm, chunk=chunk, init_state=init_state)
        ctx.save_for_backward(x, dt, a, bm, cm, init_state)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, a, bm, cm, init_state = ctx.saved_tensors
        dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device) if dy is None else \
            dy.contiguous()
        bwd = SS.ssd_scan_bwd_cuda if on_card(x) else SS.ssd_scan_bwd_plain
        grads = bwd(x, dt, a, bm, cm, init_state, dy,
                    None if dh is None else dh.contiguous(), chunk=ctx.chunk)
        return (*grads, None)


class QkNormRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, q_scale, k_scale, positions, theta: float, eps: float):
        if on_card(q):
            qo, ko = RN.qk_norm_rope_cuda(q, k, q_scale, k_scale, positions, theta, eps=eps)
        else:
            qo, ko = RN.qk_norm_rope_plain(q, k, q_scale, k_scale, positions, theta, eps=eps)
        ctx.save_for_backward(q, k, q_scale, k_scale, positions)
        ctx.theta, ctx.eps = theta, eps
        return qo, ko

    @staticmethod
    def backward(ctx, dq_out, dk_out):
        q, k, q_scale, k_scale, positions = ctx.saved_tensors
        bwd = RN.qk_norm_rope_bwd_cuda if on_card(q) else RN.qk_norm_rope_bwd_plain
        dq, dk, dq_scale, dk_scale = bwd(q, k, q_scale, k_scale, positions, ctx.theta,
                                         dq_out.contiguous(), dk_out.contiguous(),
                                         eps=ctx.eps)
        return dq, dk, dq_scale, dk_scale, None, None, None
