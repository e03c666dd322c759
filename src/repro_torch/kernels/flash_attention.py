"""Flash attention forward and backward: the CUDA kernels' wrappers and their plain
PyTorch versions.

The forward kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``_attn_kernel`` / ``flash_attention_pallas`` of ``src/repro/kernels/flash_attention.py``;
its source comment gives the design and what bounds it on the H100: bf16 inputs
run a tensor-core design (mma.sync, cp.async double buffering), f32 inputs the
exact CUDA-core design that the f32 checks hold at 2e-5. With ``return_lse`` it
also writes each row's log-sum-exp, the residual of the backward. It is built for
the head dims of ``HEAD_DIMS``; at 256 (gemma3-12b) the bf16 design takes 32-row
kv tiles and reads Q's fragments from shared memory (the source says why).

The backward kernel computes what the JAX package's custom VJP
``_flash_bwd_blocked`` (``src/repro/kernels/ops.py:90``) computes, from the
forward's (q, k, v, o, lse) and dO; the JAX package has no Pallas backward. Both
of its designs are deterministic (no atomics: a dK/dV pass over kv tiles that sums
the GQA group inside one block, and a dQ pass over q tiles), and the source gives
their bound and counts. bf16 inputs, the training path, run a tensor-core design:
all seven tile products on mma.sync, bf16 tiles loaded by cp.async two stages
deep, P and dS rounded once to bf16 as operands. f32 inputs run the exact
CUDA-core design that the f32 checks hold at 1e-3. It is built for the head dims
of ``BWD_HEAD_DIMS``; at 256 (gemma3-12b's training) the bf16 dK/dV pass gives dK
and dV to separate warps and the dQ pass takes 32-row kv tiles, and the f32
design stages 32-row tiles (the source says why). At 112 (zamba2-7b's shared
attention block) both directions run the D <= 128 plans as they are, with 7
k-steps of 16: the head dim is not padded to 128 as the TPU route pads it.

Both directions follow the JAX package's reference semantics: end-aligned causal /
sliding-window masks (q row i at absolute position i + Skv - Sq), GQA by kv head
``h // (H/K)``, softmax scale ``1/sqrt(D)``, f32 accumulation, outputs in the
inputs' dtype.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.device import refuse_grad
from repro_torch.kernels import _build
from repro_torch.kernels.ref import widen
from repro_torch.kernels.region import plain_kernel

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 112, 128, 256)   # head dims the forward kernel is instantiated for
BWD_HEAD_DIMS = (32, 64, 80, 112, 128, 256)   # and the backward kernel
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _mask(Sq: int, Skv: int, k0: int, blk: int, causal: bool, window: int, device):
    """[Sq, blk] mask of kv positions k0 .. k0+blk-1 (end-aligned; none past Skv)."""
    q_pos = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    k_pos = torch.arange(k0, k0 + blk, device=device)[None, :]
    mask = (k_pos < Skv).expand(Sq, blk)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (q_pos - k_pos < window)
    return mask


@functools.lru_cache(maxsize=None)
def attention_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the end-aligned mask keeps (``_mask``): the pairs the
    kernel computes, where the plain version forms every block."""
    total = 0
    for i in range(Sq):
        pos = i + Skv - Sq
        hi = min(Skv, pos + 1) if causal else Skv
        lo = max(0, pos - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def _fwd_flops(q, k, v, *, causal: bool = True, window: int = 0, **_) -> int:
    """The forward's dot products over the kept pairs: S = Q K^T and P V."""
    B, Sq, H, D = q.shape
    return 4 * B * H * D * attention_pairs(Sq, k.shape[1], causal, window)


def _bwd_flops(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0, **_) -> int:
    """The backward's five products over the kept pairs (S again, dP, dV, dQ, dK):
    2.5 forwards."""
    return 5 * _fwd_flops(q, k, v, causal=causal, window=window) // 2


@plain_kernel(flops=_fwd_flops)
def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          blk_kv: int = 512, return_lse: bool = False):
    """Blocked online-softmax forward over kv blocks of ``blk_kv``, mirroring
    ``_flash_fwd_blocked`` of the JAX package. q [B,Sq,H,D], k/v [B,Skv,K,D].
    ``return_lse``: also the f32 log-sum-exp [B,H,Sq] of the scaled scores."""
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    group = H // K
    scale = 1.0 / math.sqrt(D)
    qf = widen(q) * scale
    acc_t = qf.dtype
    acc = torch.zeros((B, H, Sq, D), dtype=acc_t, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=acc_t, device=q.device)
    for k0 in range(0, Skv, min(blk_kv, Skv)):
        kj = widen(k[:, k0:k0 + blk_kv]).repeat_interleave(group, dim=2)
        vj = widen(v[:, k0:k0 + blk_kv]).repeat_interleave(group, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kj)
        mask = _mask(Sq, Skv, k0, kj.shape[1], causal, window, q.device)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vj)
        m = m_new
    l = l.clamp_min(1e-30)
    o = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    return (o, m + torch.log(l)) if return_lse else o


@plain_kernel(flops=_bwd_flops)
def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, blk_kv: int = 512):
    """(dq, dk, dv) from the forward's residuals and dO, mirroring the JAX
    package's ``_flash_bwd_blocked`` line for line: P recomputed per kv block of
    ``blk_kv`` from the LSE, dS = P (dP - delta) scale, GQA folded back onto the
    kv heads. Gradients in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    group = H // K
    scale = 1.0 / math.sqrt(D)
    blk = min(blk_kv, Skv)
    nkv = -(-Skv // blk)
    pad = nkv * blk - Skv
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)) if pad else k
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) if pad else v

    qf = widen(q)
    dof = widen(do)
    delta = torch.einsum("bqhd,bqhd->bhq", widen(o), dof)             # [B,H,Sq]
    dq = torch.zeros((B, Sq, H, D), dtype=qf.dtype, device=q.device)
    dks, dvs = [], []
    for j in range(nkv):
        kj = kp[:, j * blk:(j + 1) * blk]
        vj = vp[:, j * blk:(j + 1) * blk]
        kjr = widen(kj).repeat_interleave(group, dim=2)
        vjr = widen(vj).repeat_interleave(group, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kjr) * scale
        mask = _mask(Sq, Skv, j * blk, blk, causal, window, q.device)
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dv_j = torch.einsum("bhqk,bqhd->bkhd", p, dof)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vjr)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kjr)
        dk_j = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        # fold GQA groups back onto kv heads
        dks.append(dk_j.reshape(B, blk, K, group, D).sum(dim=3))
        dvs.append(dv_j.reshape(B, blk, K, group, D).sum(dim=3))
    dk = torch.cat(dks, dim=1)[:, :Skv]
    dv = torch.cat(dvs, dim=1)[:, :Skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _kernel_fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = _build.load("flash_attention").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, head_dims, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *rest) -> None:
    """Raise on anything the kernels do not take. ``head_dims``: those the kernel
    is built for. ``rest``: tensors of q's shape and dtype (o and dO of the
    backward)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes f32 or bf16 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, K, Dk = k.shape
    if Bk != B or Dk != D or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match")
    if D not in head_dims:
        raise ValueError(f"{name}: head dim {D} not supported by the kernel (have "
                         f"{head_dims})")
    if min(B, Sq, Skv) == 0:
        raise ValueError(f"{name} needs non-empty q and k/v")
    for t in rest:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: o and dO must match q {tuple(q.shape)} {q.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not all(t.is_contiguous() for t in (q, k, v, *rest)):
        raise ValueError(f"{name} needs contiguous q, k, v (and o, dO)")
    if any(t.data_ptr() % 16 for t in (q, k, v, *rest)):
        raise ValueError(f"{name} needs 16-byte aligned q, k, v: the kernel copies "
                         "16-byte pieces")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0, return_lse: bool = False):
    """Launch the forward kernel on contiguous CUDA tensors on PyTorch's current
    stream. Raises on anything the kernel does not take. ``return_lse``: returns
    (o, lse) with the f32 log-sum-exp [B,H,Sq] that the backward takes."""
    refuse_grad("flash_attention_cuda", q, k, v)
    _check("flash_attention_cuda", HEAD_DIMS, q, k, v)
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, H, K, D, int(causal), int(window),
                 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], stream,
                 None if lse is None else lse.data_ptr())
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0):
    """Launch the backward kernel: (dq, dk, dv) in the inputs' dtype from the
    forward's contiguous q, k, v, o, its f32 lse [B,H,Sq] and dO of o's shape."""
    refuse_grad("flash_attention_bwd_cuda", q, k, v, o, lse, do)
    _check("flash_attention_bwd_cuda", BWD_HEAD_DIMS, q, k, v, o, do)
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd_cuda needs a contiguous f32 lse "
                         f"[{B}, {H}, {Sq}] on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = _bwd_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, Sq, Skv, H, K, D, int(causal), int(window),
                 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError {err}")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_cuda.launches = 0
flash_attention_bwd_cuda.launches = 0
