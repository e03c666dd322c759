"""Flash attention forward: the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel ``_attn_kernel`` /
``flash_attention_pallas`` of ``src/repro/kernels/flash_attention.py``; its source
comment gives the design and what bounds it on the H100: bf16 inputs run a
tensor-core design (mma.sync, cp.async double buffering), f32 inputs the exact
CUDA-core design that the f32 checks hold at 2e-5. Both versions follow the
JAX package's reference semantics: end-aligned causal / sliding-window masks
(q row i at absolute position i + Skv - Sq), GQA by kv head ``h // (H/K)``,
softmax scale ``1/sqrt(D)``, f32 accumulation, output in q's dtype.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 128)   # head dims the kernel is instantiated for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          blk_kv: int = 512):
    """Blocked online-softmax forward over kv blocks of ``blk_kv``, mirroring
    ``_flash_fwd_blocked`` of the JAX package. q [B,Sq,H,D], k/v [B,Skv,K,D]."""
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    group = H // K
    scale = 1.0 / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    qf = q.float() * scale
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for k0 in range(0, Skv, min(blk_kv, Skv)):
        kj = k[:, k0:k0 + blk_kv].float().repeat_interleave(group, dim=2)
        vj = v[:, k0:k0 + blk_kv].float().repeat_interleave(group, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kj)
        k_pos = torch.arange(k0, k0 + kj.shape[1], device=q.device)[None, :]
        mask = torch.ones((Sq, kj.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window > 0:
            mask = mask & (q_pos - k_pos < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vj)
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.transpose(1, 2).to(q.dtype)


@functools.cache
def _kernel_fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous CUDA tensors on PyTorch's current
    stream. Raises on anything the kernel does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes f32 or bf16 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, K, Dk = k.shape
    if Bk != B or Dk != D or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernel (have {HEAD_DIMS})")
    if min(B, Sq, Skv) == 0:
        raise ValueError("flash_attention_cuda needs non-empty q and k/v")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs 16-byte aligned q, k, v: the "
                         "kernel copies 16-byte pieces")
    out = torch.empty_like(q)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, H, K, D, int(causal), int(window),
                 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
