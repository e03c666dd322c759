"""RMSNorm forward, alone and fused with its neighbours: the CUDA kernel's four
wrappers and their plain PyTorch versions.

The kernel (``csrc/rmsnorm.cu``) replaces the TPU kernel ``_rmsnorm_kernel`` /
``rmsnorm_pallas`` of ``src/repro/kernels/rmsnorm.py``: per row of ``x [..., D]``
the f32 mean of x², then ``x * rsqrt(var + eps) * scale``, cast back to x's
dtype. Its source gives the design and what bounds it (bytes). Besides the
plain norm it takes in the elementwise work that the serving paths run right
before or after it, each fusion rounding where the unfused sequence rounds:

- ``add_rmsnorm``: the residual add ``s = x + r`` before a norm; returns (s, y).
- ``gated_rmsnorm``: mamba2's gate ``y * silu(z)`` before ``gate_norm``.
- ``qk_norm_rope``: q-norm and k-norm, then RoPE on q and k, in one launch.

Each ``*_plain`` is exactly the sequence of PyTorch ops the model ran before the
fusion, so the CPU path computes bit for bit what it computed then.

The backward of every entry point (``rmsnorm_bwd``, ``add_rmsnorm_bwd``,
``gated_rmsnorm_bwd``, ``qk_norm_rope_bwd``) runs on the same kernel's row core,
one launch each; each ``*_bwd_plain`` is its explicit formula, the gradient of
``rmsnorm_ref``'s exact casts (and of the gate's or RoPE's) that autodiff of the
JAX reference gives. The kernel sums
``dscale`` over every row in f64 and deterministically inside the same launch
(per-block partial rows folded by the blocks that finish last, in a fixed order;
no atomics on values), through a scratch buffer kept for each stream.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.device import refuse_grad
from repro_torch.kernels import _build
from repro_torch.kernels.ref import apply_rope, rmsnorm_ref, rope_freqs, widen
from repro_torch.kernels.region import plain_kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROW_BYTES = 256 * 8 * 16   # the widest row: 256 threads x 8 vectors of 16 bytes


# ----------------------------------------------------------------- plain versions
rmsnorm_plain = plain_kernel(rmsnorm_ref)   # the f32 formula of the oracle


@plain_kernel
def add_rmsnorm_plain(x, r, scale, *, eps: float = 1e-6):
    s = x + r
    return s, rmsnorm_ref(s, scale, eps=eps)


@plain_kernel
def gated_rmsnorm_plain(y, z, scale, *, eps: float = 1e-6):
    return rmsnorm_ref(y * F.silu(widen(z)).to(y.dtype), scale, eps=eps)


@plain_kernel
def qk_norm_rope_plain(q, k, q_scale, k_scale, positions, theta: float, *,
                       eps: float = 1e-6):
    q = rmsnorm_ref(q, q_scale, eps=eps)
    k = rmsnorm_ref(k, k_scale, eps=eps)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)


def _rope_bwd(dout, positions, theta: float):
    """RoPE's transpose: the cotangent rotated back by -theta in f32, rounded to
    dout's dtype (the grad of ``apply_rope``'s cast to f32)."""
    D = dout.shape[-1]
    angles = positions[..., None].float() * rope_freqs(D, theta, dout.device)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    d1, d2 = widen(dout).chunk(2, dim=-1)
    return torch.cat([d1 * cos + d2 * sin, d2 * cos - d1 * sin], dim=-1).to(dout.dtype)


@plain_kernel
def rmsnorm_bwd_plain(x, scale, dy, *, eps: float = 1e-6):
    """(dx, dscale) of ``rmsnorm_ref(x, scale)`` for the cotangent dy:
    g = dy w, dx = rstd g - x rstd^3 mean(g x) in f32, rounded to x's dtype;
    dscale = the f32 sum over rows of dy x rstd, rounded to scale's dtype."""
    xf, w, dyf = widen(x), widen(scale), widen(dy)
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    g = dyf * w
    dx = rstd * g - xf * (rstd ** 3) * (g * xf).mean(dim=-1, keepdim=True)
    dscale = (dyf * xf * rstd).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


@plain_kernel
def add_rmsnorm_bwd_plain(s, scale, ds, dn, *, eps: float = 1e-6):
    """(dx, dscale) of ``add_rmsnorm``: s = x + r is the forward's first output,
    ds and dn the cotangents of (s, rmsnorm(s)); dx (= dr) = ds + the norm's dx.
    ds is None where s is not used further (the final norm's stream)."""
    dx, dscale = rmsnorm_bwd_plain(s, scale, dn, eps=eps)
    return (dx if ds is None else ds + dx), dscale


@plain_kernel
def gated_rmsnorm_bwd_plain(y, z, scale, dout, *, eps: float = 1e-6):
    """(dy, dz, dscale) of ``gated_rmsnorm`` for the cotangent dout, with the
    JAX sequence's casts: t = y * T(silu(z)) rounded to T = y's dtype; dt = the
    norm's dx on t, in T; dy = dt * T(silu(z)) in T; dz = silu'(z) * T(dt * y)
    in f32 (silu' = sig (1 + z (1 - sig))), rounded to z's dtype."""
    zf = widen(z)
    silu = F.silu(zf).to(y.dtype)
    dt, dscale = rmsnorm_bwd_plain(y * silu, scale, dout, eps=eps)
    sig = torch.sigmoid(zf)
    dz = widen(dt * y) * (sig * (1 + zf * (1 - sig)))
    return dt * silu, dz.to(z.dtype), dscale


@plain_kernel
def qk_norm_rope_bwd_plain(q, k, q_scale, k_scale, positions, theta: float, dq_out,
                           dk_out, *, eps: float = 1e-6):
    """(dq, dk, dq_scale, dk_scale) of ``qk_norm_rope`` for the cotangents of its
    two outputs: RoPE's transpose, then the norm's backward over head_dim;
    dq_scale is summed over B*S*H rows, dk_scale over B*S*K."""
    dq, dq_scale = rmsnorm_bwd_plain(q, q_scale, _rope_bwd(dq_out, positions, theta), eps=eps)
    dk, dk_scale = rmsnorm_bwd_plain(k, k_scale, _rope_bwd(dk_out, positions, theta), eps=eps)
    return dq, dk, dq_scale, dk_scale


# ------------------------------------------------------------------------- kernel
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    P, I, L, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    tail = [Fl, I, I, P]                 # eps, dtype, device, stream
    signatures = {
        "rmsnorm_fwd": [P] * 3 + [L, I] + tail,
        "add_rmsnorm_fwd": [P] * 5 + [L, I] + tail,
        "gated_rmsnorm_fwd": [P] * 4 + [L, I] + tail,
        "qk_norm_rope_fwd": [P] * 7 + [L, L, P] + [I] * 5 + tail,
        "rmsnorm_bwd": [P] * 6 + [I, L, I] + tail,
        "add_rmsnorm_bwd": [P] * 7 + [I, L, I] + tail,
        "gated_rmsnorm_bwd": [P] * 8 + [I, L, I] + tail,
        "qk_norm_rope_bwd": [P] * 7 + [L, L] + [P] * 6 + [I] * 6 + tail,
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = I
    return lib


def _check(name: str, D: int, *tensors: torch.Tensor) -> None:
    """Raise on anything the kernel does not take, in one pass over the tensors:
    the launch sits on a host-bound serving path."""
    x = tensors[0]
    dev, dt = x.device, x.dtype
    row_bytes = D * x.element_size()
    ok = (dev.type == "cuda" and dt in _DTYPE_CODE and 0 < row_bytes <= MAX_ROW_BYTES
          and row_bytes % 16 == 0)
    for t in tensors:
        ok = ok and t.device == dev and t.dtype == dt and t.is_contiguous() \
            and t.data_ptr() % 16 == 0
    if not ok:
        raise ValueError(
            f"{name} takes contiguous, 16-byte aligned f32 or bf16 tensors of one dtype "
            f"on one CUDA device, rows a multiple of 16 bytes up to {MAX_ROW_BYTES}; got "
            f"{[(str(t.dtype), str(t.device), tuple(t.shape)) for t in tensors]}")


def _norm_args(name: str, x: torch.Tensor, scale: torch.Tensor) -> int:
    D = x.shape[-1] if x.dim() else 0
    if scale.shape != (D,):
        raise ValueError(f"{name}: scale shape {tuple(scale.shape)} != ({D},)")
    return D


def _launched(name: str, wrapper, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1


def _stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on x's card, as the raw handle the C entry
    takes (``torch.cuda.current_stream`` builds a Stream object each call)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm(x) on the card: x [..., D], scale [D], contiguous."""
    refuse_grad("rmsnorm_cuda", x, scale)
    D = _norm_args("rmsnorm_cuda", x, scale)
    _check("rmsnorm_cuda", D, x, scale)
    y = torch.empty_like(x)
    if x.numel():
        err = _lib().rmsnorm_fwd(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                 x.numel() // D, D, eps, _DTYPE_CODE[x.dtype],
                                 x.device.index, _stream(x))
        _launched("rmsnorm_fwd", rmsnorm_cuda, err)
    return y


def add_rmsnorm_cuda(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor, *,
                     eps: float = 1e-6):
    """(s, rmsnorm(s)) with s = x + r, on the card: x, r [..., D] of one shape."""
    refuse_grad("add_rmsnorm_cuda", x, r, scale)
    D = _norm_args("add_rmsnorm_cuda", x, scale)
    if r.shape != x.shape:
        raise ValueError(f"add_rmsnorm_cuda: x {tuple(x.shape)} and r {tuple(r.shape)} differ")
    _check("add_rmsnorm_cuda", D, x, r, scale)
    s, y = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        err = _lib().add_rmsnorm_fwd(x.data_ptr(), r.data_ptr(), scale.data_ptr(),
                                     s.data_ptr(), y.data_ptr(), x.numel() // D, D, eps,
                                     _DTYPE_CODE[x.dtype], x.device.index, _stream(x))
        _launched("add_rmsnorm_fwd", add_rmsnorm_cuda, err)
    return s, y


def gated_rmsnorm_cuda(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, *,
                       eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm(y * silu(z)) on the card: y, z [..., D] of one shape."""
    refuse_grad("gated_rmsnorm_cuda", y, z, scale)
    D = _norm_args("gated_rmsnorm_cuda", y, scale)
    if z.shape != y.shape:
        raise ValueError(f"gated_rmsnorm_cuda: y {tuple(y.shape)} and z {tuple(z.shape)} differ")
    _check("gated_rmsnorm_cuda", D, y, z, scale)
    out = torch.empty_like(y)
    if y.numel():
        err = _lib().gated_rmsnorm_fwd(y.data_ptr(), z.data_ptr(), scale.data_ptr(),
                                       out.data_ptr(), y.numel() // D, D, eps,
                                       _DTYPE_CODE[y.dtype], y.device.index, _stream(y))
        _launched("gated_rmsnorm_fwd", gated_rmsnorm_cuda, err)
    return out


def _qk_args(name: str, q, k, q_scale, k_scale, positions, *grads):
    """Check qk_norm_rope's inputs (and the backward's cotangents, of q's and k's
    shapes); returns (B, S, H, K, hd)."""
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "are not [B,S,H,hd] and [B,S,K,hd]")
    B, S, H, hd = q.shape
    K = k.shape[2]
    if q_scale.shape != (hd,) or k_scale.shape != (hd,):
        raise ValueError(f"{name}: scales {tuple(q_scale.shape)}, "
                         f"{tuple(k_scale.shape)} != ({hd},)")
    if any(g.shape != t.shape for g, t in zip(grads, (q, k))):
        raise ValueError(f"{name}: cotangents {[tuple(g.shape) for g in grads]} do not "
                         f"match q {tuple(q.shape)} and k {tuple(k.shape)}")
    _check(name, hd, q, k, q_scale, k_scale, *grads)
    vecs = hd * q.element_size() // 16
    if vecs < 2 or vecs > 64 or vecs & (vecs - 1):
        raise ValueError(f"{name}: head dim {hd} in {q.dtype} is not a power "
                         "of two of 16-byte vectors from 2 to 64")
    if positions.shape != (B, S) or positions.dtype != torch.int32 \
            or positions.device != q.device:
        raise ValueError(f"{name}: positions must be int32 [{B}, {S}] on "
                         f"{q.device}, got {positions.dtype} {tuple(positions.shape)} "
                         f"on {positions.device}")
    return B, S, H, K, hd


@functools.cache
def _inv_freq(device: torch.device, hd: int, theta: float) -> torch.Tensor:
    """RoPE's inverse frequencies by the plain version's own ops, so the kernel's
    angle is the same f32 product."""
    return rope_freqs(hd, theta, device)


def qk_norm_rope_cuda(q: torch.Tensor, k: torch.Tensor, q_scale: torch.Tensor,
                      k_scale: torch.Tensor, positions: torch.Tensor, theta: float, *,
                      eps: float = 1e-6):
    """RoPE(rmsnorm(q)), RoPE(rmsnorm(k)) in one launch on the card. q [B,S,H,hd],
    k [B,S,K,hd] contiguous; positions [B,S] int32, any strides (an expanded
    arange is read in place); hd * itemsize / 16 a power of two up to 64."""
    refuse_grad("qk_norm_rope_cuda", q, k, q_scale, k_scale)
    B, S, H, K, hd = _qk_args("qk_norm_rope_cuda", q, k, q_scale, k_scale, positions)
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    if min(B, S, H, K) == 0:
        return q_out, k_out
    freqs = _inv_freq(q.device, hd, float(theta))
    err = _lib().qk_norm_rope_fwd(
        q.data_ptr(), k.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(),
        q_out.data_ptr(), k_out.data_ptr(), positions.data_ptr(), positions.stride(0),
        positions.stride(1), freqs.data_ptr(), B, S, H, K, hd, eps,
        _DTYPE_CODE[q.dtype], q.device.index, _stream(q))
    _launched("qk_norm_rope_fwd", qk_norm_rope_cuda, err)
    return q_out, k_out


# ----------------------------------------------------------------------- backward
_TICKETS = 128   # f64 words at the head of a backward scratch: csrc FOLD_COUNTERS tickets
_SCRATCH: dict = {}        # (device index, stream) -> that stream's f64 scratch


@functools.cache
def _max_blocks(device: torch.device) -> int:
    """Blocks a backward launch may use (so rows its scratch must hold): eight
    an SM, as many 256-thread blocks as an SM can hold. The kernel takes fewer
    where the compiled kernel's registers and shared memory allow fewer."""
    return 8 * torch.cuda.get_device_properties(device).multi_processor_count


def _scratch(x: torch.Tensor, W: int) -> tuple:
    """(max blocks, f64 scratch) of the current stream for a backward launch whose
    blocks fold rows of W doubles into dscale: the tickets, then one row a block
    and one a group of blocks (ceil(sqrt(blocks)) a group). One buffer a stream:
    each launch leaves the tickets at 0 for the next launch on its stream, and
    two streams' launches may run at once. It grows, zeroed, when a launch needs
    more rows; the old buffer goes back to the allocator in stream order."""
    blocks = _max_blocks(x.device)
    need = _TICKETS + (blocks + math.isqrt(blocks - 1) + 2) * W
    key = (x.device.index, _stream(x))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.float64, device=x.device)
        _SCRATCH[key] = buf
    return blocks, buf


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                     eps: float = 1e-6):
    """(dx, dscale) of rmsnorm(x) on the card for the cotangent dy of x's shape."""
    refuse_grad("rmsnorm_bwd_cuda", x, scale, dy)
    D = _norm_args("rmsnorm_bwd_cuda", x, scale)
    if dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd_cuda: dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    _check("rmsnorm_bwd_cuda", D, x, scale, dy)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    if not x.numel():
        return dx, dscale.zero_()
    blocks, scratch = _scratch(x, D)
    err = _lib().rmsnorm_bwd(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                             dscale.data_ptr(), scratch.data_ptr(), blocks, x.numel() // D, D,
                             eps, _DTYPE_CODE[x.dtype], x.device.index, _stream(x))
    _launched("rmsnorm_bwd", rmsnorm_bwd_cuda, err)
    return dx, dscale


def add_rmsnorm_bwd_cuda(s: torch.Tensor, scale: torch.Tensor, ds, dn: torch.Tensor, *,
                         eps: float = 1e-6):
    """(dx, dscale) of add_rmsnorm on the card: s = x + r (the forward's first
    output), ds and dn the cotangents of (s, rmsnorm(s)); dx = dr = ds + the
    norm's dx, with ds added in the same pass. ds None: the norm's dx alone."""
    refuse_grad("add_rmsnorm_bwd_cuda", s, scale, ds, dn)
    D = _norm_args("add_rmsnorm_bwd_cuda", s, scale)
    if dn.shape != s.shape or (ds is not None and ds.shape != s.shape):
        raise ValueError(f"add_rmsnorm_bwd_cuda: cotangents "
                         f"{None if ds is None else tuple(ds.shape)}, {tuple(dn.shape)} "
                         f"do not match s {tuple(s.shape)}")
    _check("add_rmsnorm_bwd_cuda", D, s, scale, dn, *(() if ds is None else (ds,)))
    dx, dscale = torch.empty_like(s), torch.empty_like(scale)
    if not s.numel():
        return dx, dscale.zero_()
    blocks, scratch = _scratch(s, D)
    rows, code, lib = s.numel() // D, _DTYPE_CODE[s.dtype], _lib()
    if ds is None:
        err = lib.rmsnorm_bwd(s.data_ptr(), scale.data_ptr(), dn.data_ptr(), dx.data_ptr(),
                              dscale.data_ptr(), scratch.data_ptr(), blocks, rows, D, eps,
                              code, s.device.index, _stream(s))
    else:
        err = lib.add_rmsnorm_bwd(s.data_ptr(), scale.data_ptr(), ds.data_ptr(),
                                  dn.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                                  scratch.data_ptr(), blocks, rows, D, eps, code,
                                  s.device.index, _stream(s))
    _launched("add_rmsnorm_bwd", add_rmsnorm_bwd_cuda, err)
    return dx, dscale


def gated_rmsnorm_bwd_cuda(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                           dout: torch.Tensor, *, eps: float = 1e-6):
    """(dy, dz, dscale) of gated_rmsnorm on the card for the cotangent dout of its
    output; y, z are the forward's inputs. One launch, dscale folded in."""
    refuse_grad("gated_rmsnorm_bwd_cuda", y, z, scale, dout)
    D = _norm_args("gated_rmsnorm_bwd_cuda", y, scale)
    if z.shape != y.shape or dout.shape != y.shape:
        raise ValueError(f"gated_rmsnorm_bwd_cuda: y {tuple(y.shape)}, z {tuple(z.shape)} "
                         f"and dout {tuple(dout.shape)} differ")
    _check("gated_rmsnorm_bwd_cuda", D, y, z, scale, dout)
    dy, dz, dscale = torch.empty_like(y), torch.empty_like(z), torch.empty_like(scale)
    if not y.numel():
        return dy, dz, dscale.zero_()
    blocks, scratch = _scratch(y, D)
    err = _lib().gated_rmsnorm_bwd(y.data_ptr(), z.data_ptr(), scale.data_ptr(),
                                   dout.data_ptr(), dy.data_ptr(), dz.data_ptr(),
                                   dscale.data_ptr(), scratch.data_ptr(), blocks,
                                   y.numel() // D, D, eps, _DTYPE_CODE[y.dtype], y.device.index,
                                   _stream(y))
    _launched("gated_rmsnorm_bwd", gated_rmsnorm_bwd_cuda, err)
    return dy, dz, dscale


def qk_norm_rope_bwd_cuda(q: torch.Tensor, k: torch.Tensor, q_scale: torch.Tensor,
                          k_scale: torch.Tensor, positions: torch.Tensor, theta: float,
                          dq_out: torch.Tensor, dk_out: torch.Tensor, *, eps: float = 1e-6):
    """(dq, dk, dq_scale, dk_scale) of qk_norm_rope on the card, q and k and
    both scales in one launch. q, k are the forward's inputs; dq_out, dk_out the
    cotangents of its outputs."""
    refuse_grad("qk_norm_rope_bwd_cuda", q, k, q_scale, k_scale, dq_out, dk_out)
    B, S, H, K, hd = _qk_args("qk_norm_rope_bwd_cuda", q, k, q_scale, k_scale, positions,
                              dq_out, dk_out)
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    dq_scale, dk_scale = torch.empty_like(q_scale), torch.empty_like(k_scale)
    if min(B, S, H, K) == 0:
        return dq, dk, dq_scale.zero_(), dk_scale.zero_()
    blocks, scratch = _scratch(q, 2 * hd)
    freqs = _inv_freq(q.device, hd, float(theta))
    err = _lib().qk_norm_rope_bwd(
        q.data_ptr(), k.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(),
        dq_out.data_ptr(), dk_out.data_ptr(), positions.data_ptr(), positions.stride(0),
        positions.stride(1), freqs.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dq_scale.data_ptr(), dk_scale.data_ptr(), scratch.data_ptr(), blocks, B, S, H, K,
        hd, eps, _DTYPE_CODE[q.dtype], q.device.index, _stream(q))
    _launched("qk_norm_rope_bwd", qk_norm_rope_bwd_cuda, err)
    return dq, dk, dq_scale, dk_scale


for _wrapper in (rmsnorm_cuda, add_rmsnorm_cuda, gated_rmsnorm_cuda, qk_norm_rope_cuda,
                 rmsnorm_bwd_cuda, add_rmsnorm_bwd_cuda, gated_rmsnorm_bwd_cuda,
                 qk_norm_rope_bwd_cuda):
    _wrapper.launches = 0
