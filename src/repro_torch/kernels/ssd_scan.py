"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/ssd_scan.cu``) replaces the TPU kernel ``_ssd_kernel`` /
``ssd_scan_pallas`` of ``src/repro/kernels/ssd_scan.py``. It computes what the
model path of the JAX package computes, which is the jnp ``_ssd_blocked`` of
``src/repro/kernels/ops.py`` and not the Pallas kernel: y *and* the final
state, from an optional initial state, for any S (the Pallas kernel takes
neither state and needs S % chunk == 0, so ``ssm_block`` never reaches it).

  x [B,S,H,P], dt [B,S,H] f32 (> 0), a [H] f32 (< 0), bm/cm [B,S,N] (G=1),
  init_state [B,H,N,P] f32 or None  ->  y [B,S,H,P] in x's dtype,
  final state [B,H,N,P] f32. Accumulation in f32.

x, bm and cm are read in place through their batch and row strides (the model
passes slices of its conv output), with the last dim contiguous and x's heads P
apart. What bounds the kernel on the H100, and the design: see its source
comment. In short: one block per (32-column tile of P, head, batch) walks the
chunks in order with the [N, 32] state slice on chip; bf16 inputs run a
tensor-core design (mma.sync, cp.async double buffering), f32 inputs the exact
CUDA-core design that the f32 checks hold at 2e-4.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import refuse_grad
from repro_torch.kernels import _build

STATE_DIMS = (16, 32, 64, 128)   # N the kernel is instantiated for
P_TILE = 32                      # P must be a multiple of this
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_plain(x, dt, a, bm, cm, *, chunk: int, init_state=None):
    """Chunked SSD mirroring ``_ssd_blocked``: zero-pads the ragged tail,
    vectorises the intra-chunk dual form over chunks, and loops over chunks
    for the inter-chunk recurrence. Returns (y, final_state)."""
    B, S, H, P = x.shape
    N = bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        bm = torch.nn.functional.pad(bm, (0, 0, 0, pad))
        cm = torch.nn.functional.pad(cm, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xf = x.reshape(B, nc, Q, H, P).float()
    dtf = dt.reshape(B, nc, Q, H).float()
    bf = bm.reshape(B, nc, Q, N).float()
    cf = cm.reshape(B, nc, Q, N).float()

    cum = torch.cumsum(dtf * a.float(), dim=2)                   # [B,nc,Q,H]
    seg = cum[:, :, -1, :]                                       # [B,nc,H]

    # intra-chunk (dual quadratic form); the causal mask is applied before the
    # exp, so the positive upper triangle never overflows to inf
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # [B,nc,Q,Q,H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None], li, -torch.inf))
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)                 # [B,nc,Q,Q]
    xdt = xf * dtf[..., None]                                    # [B,nc,Q,H,P]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay, xdt)

    # chunk states: S_c = sum_j exp(seg - cum_j) dt_j B_j (x_j)^T
    w = torch.exp(seg[:, :, None, :] - cum) * dtf                # [B,nc,Q,H]
    states = torch.einsum("bcjn,bcjhp->bchnp", bf, xf * w[..., None])

    # inter-chunk recurrence over c
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(seg[:, c])[..., None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                              # [B,nc,H,N,P]

    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", cf, torch.exp(cum), h_in)
    y = (y_intra + y_inter).reshape(B, nc * Q, H, P)[:, :S].to(x.dtype)
    return y, h


@functools.cache
def _kernel_fn():
    fn = _build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _strides_16b(name: str, t: torch.Tensor, dims) -> list:
    """``t``'s strides over ``dims``, after checking that they and its data
    pointer are multiples of 16 bytes: the kernel copies 16-byte pieces."""
    strides = [t.stride(d) for d in dims]
    if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in strides):
        raise ValueError(f"ssd_scan_cuda needs {name}'s data pointer and batch/row "
                         f"strides 16-byte aligned, got pointer {t.data_ptr()} and "
                         f"strides {t.stride()} of {t.element_size()}-byte elements")
    return strides


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  bm: torch.Tensor, cm: torch.Tensor, *, chunk: int,
                  init_state=None):
    """Launch the CUDA kernel on CUDA tensors on PyTorch's current stream;
    returns (y, final_state). x, bm and cm may be strided views (last dim
    contiguous, x's heads P apart, pointers and batch/row strides 16-byte
    aligned); dt, a and init_state are contiguous. Raises on anything the
    kernel does not take. ``chunk`` is checked and kept for the signature: the
    kernel walks its own 64-row tiles, which changes only the rounding. It has
    no backward yet (the ssm training slice)."""
    refuse_grad("ssd_scan_cuda", x, dt, a, bm, cm, init_state)
    tensors = [x, dt, a, bm, cm] + ([] if init_state is None else [init_state])
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("ssd_scan_cuda needs every input on one CUDA device")
    if x.dtype not in _DTYPE_CODE or bm.dtype != x.dtype or cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan_cuda takes f32 or bf16 x/bm/cm of one dtype, "
                         f"got {x.dtype}, {bm.dtype}, {cm.dtype}")
    if any(t.dtype != torch.float32 for t in tensors[1:3] + tensors[5:]):
        raise ValueError("ssd_scan_cuda takes dt, a and init_state in f32")
    if x.dim() != 4:
        raise ValueError(f"x must be [B,S,H,P], got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = bm.shape[-1]
    want = {"dt": (B, S, H), "a": (H,), "bm": (B, S, N), "cm": (B, S, N),
            "init_state": (B, H, N, P)}
    for name, t in zip(want, tensors[1:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want[name]}")
    if N not in STATE_DIMS or P % P_TILE or min(B, S, H) == 0 or chunk <= 0:
        raise ValueError(f"ssd_scan_cuda takes N in {STATE_DIMS}, P % {P_TILE} == 0 "
                         f"and non-empty B, S, H; got x {tuple(x.shape)}, N={N}, "
                         f"chunk={chunk}")
    if x.stride(3) != 1 or x.stride(2) != P or bm.stride(2) != 1 or cm.stride(2) != 1:
        raise ValueError(f"ssd_scan_cuda needs x's last dim contiguous with heads P "
                         f"apart and bm/cm's last dim contiguous; strides x {x.stride()}, "
                         f"bm {bm.stride()}, cm {cm.stride()}")
    if not all(t.is_contiguous() for t in tensors[1:3] + tensors[5:]):
        raise ValueError("ssd_scan_cuda needs contiguous dt, a and init_state")
    strides = (_strides_16b("x", x, (0, 1)) + _strides_16b("bm", bm, (0, 1))
               + _strides_16b("cm", cm, (0, 1)))
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                 cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
                 y.data_ptr(), state.data_ptr(), B, S, H, P, N, *strides,
                 _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan_fwd launch failed: cudaError {err}")
    ssd_scan_cuda.launches += 1
    return y, state


ssd_scan_cuda.launches = 0
