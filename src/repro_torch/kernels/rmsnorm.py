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
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import apply_rope, rmsnorm_ref, rope_freqs

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROW_BYTES = 256 * 8 * 16   # the widest row: 256 threads x 8 vectors of 16 bytes


# ----------------------------------------------------------------- plain versions
rmsnorm_plain = rmsnorm_ref   # the f32 formula of the oracle


def add_rmsnorm_plain(x, r, scale, *, eps: float = 1e-6):
    s = x + r
    return s, rmsnorm_ref(s, scale, eps=eps)


def gated_rmsnorm_plain(y, z, scale, *, eps: float = 1e-6):
    return rmsnorm_ref(y * F.silu(z.float()).to(y.dtype), scale, eps=eps)


def qk_norm_rope_plain(q, k, q_scale, k_scale, positions, theta: float, *,
                       eps: float = 1e-6):
    q = rmsnorm_ref(q, q_scale, eps=eps)
    k = rmsnorm_ref(k, k_scale, eps=eps)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)


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
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"qk_norm_rope_cuda: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "are not [B,S,H,hd] and [B,S,K,hd]")
    B, S, H, hd = q.shape
    K = k.shape[2]
    if q_scale.shape != (hd,) or k_scale.shape != (hd,):
        raise ValueError(f"qk_norm_rope_cuda: scales {tuple(q_scale.shape)}, "
                         f"{tuple(k_scale.shape)} != ({hd},)")
    _check("qk_norm_rope_cuda", hd, q, k, q_scale, k_scale)
    vecs = hd * q.element_size() // 16
    if vecs < 2 or vecs > 64 or vecs & (vecs - 1):
        raise ValueError(f"qk_norm_rope_cuda: head dim {hd} in {q.dtype} is not a power "
                         "of two of 16-byte vectors from 2 to 64")
    if positions.shape != (B, S) or positions.dtype != torch.int32 \
            or positions.device != q.device:
        raise ValueError(f"qk_norm_rope_cuda: positions must be int32 [{B}, {S}] on "
                         f"{q.device}, got {positions.dtype} {tuple(positions.shape)} "
                         f"on {positions.device}")
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


for _wrapper in (rmsnorm_cuda, add_rmsnorm_cuda, gated_rmsnorm_cuda, qk_norm_rope_cuda):
    _wrapper.launches = 0
