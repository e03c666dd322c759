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

The backward (``ssd_scan_bwd_cuda``, the ssm training path; reference: the
gradient ``jax.vjp`` takes of ``_ssd_blocked``, which ``ssd_scan_bwd_plain``
writes out explicitly) is parallel over chunks for bf16, on the tensor cores in
three launches: the states entering each 64-row chunk and their cotangents
walked forward and back over [N, P] and kept as bf16 hi + lo planes, then every
chunk's gradients for groups of 10 heads from them, then a fixed-order sum of
what crosses blocks (dB, dC over the groups, dA over the chunks). f32 inputs run
the exact CUDA-core design in two launches. Deterministic.
"""
from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from repro_torch.device import refuse_grad
from repro_torch.kernels import _build
from repro_torch.kernels.ref import widen
from repro_torch.kernels.region import plain_kernel

STATE_DIMS = (16, 32, 64, 128)   # N the kernel is instantiated for
P_TILE = 32                      # P must be a multiple of this
BWD_BF16_P = (32, 64)            # P the bf16 backward is instantiated for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _chunked(chunk: int, x, dt, a, bm, cm, init_state, *more):
    """What the scan and its backward share, as ``_ssd_blocked`` forms it: the
    ragged tail zero-padded, every input widened and cut into chunks of Q rows
    ([B,nc,Q,...]); per chunk cum (the cumsum of dt a), seg (its last row), the
    score (C_i . B_j) exp(cum_i - cum_j) for j <= i (the causal mask applied
    before the exp, so the positive upper triangle never overflows to inf),
    w_j = exp(seg - cum_j) dt_j, the states entering each chunk (h_in, a list)
    and the final state. ``more``: [B,S,H,P] tensors (dy) cut as x is."""
    B, S, H, P = x.shape
    N = bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x, *more = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, *more))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        bm = torch.nn.functional.pad(bm, (0, 0, 0, pad))
        cm = torch.nn.functional.pad(cm, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xf, *more = (widen(t.reshape(B, nc, Q, H, P)) for t in (x, *more))
    dtf = widen(dt.reshape(B, nc, Q, H))
    bf = widen(bm.reshape(B, nc, Q, N))
    cf = widen(cm.reshape(B, nc, Q, N))
    af = widen(a)

    cum = torch.cumsum(dtf * af, dim=2)                          # [B,nc,Q,H]
    seg = cum[:, :, -1, :]                                       # [B,nc,H]
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # [B,nc,Q,Q,H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None], li, -torch.inf))
    score = torch.einsum("bcin,bcjn->bcij", cf, bf)[..., None] * decay
    w = torch.exp(seg[:, :, None, :] - cum) * dtf                # [B,nc,Q,H]
    # chunk states S_c = sum_j w_j B_j x_j^T, then the inter-chunk recurrence
    states = torch.einsum("bcjn,bcjhp->bchnp", bf, xf * w[..., None])
    h = (torch.zeros((B, H, N, P), dtype=xf.dtype, device=x.device)
         if init_state is None else widen(init_state))
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(seg[:, c])[..., None, None] + states[:, c]
    return SimpleNamespace(S=S, Q=Q, nc=nc, xf=xf, dtf=dtf, bf=bf, cf=cf, af=af, cum=cum,
                           seg=seg, decay=decay, score=score, w=w, h_in=h_in, h=h,
                           more=more)


@plain_kernel
def ssd_scan_plain(x, dt, a, bm, cm, *, chunk: int, init_state=None):
    """Chunked SSD mirroring ``_ssd_blocked``: zero-pads the ragged tail,
    vectorises the intra-chunk dual form over chunks, and loops over chunks
    for the inter-chunk recurrence. Returns (y, final_state)."""
    B, S, H, P = x.shape
    t = _chunked(chunk, x, dt, a, bm, cm, init_state)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", t.score, t.xf * t.dtf[..., None])
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", t.cf, torch.exp(t.cum),
                           torch.stack(t.h_in, dim=1))
    y = (y_intra + y_inter).reshape(B, t.nc * t.Q, H, P)[:, :S].to(x.dtype)
    return y, t.h


@plain_kernel
def ssd_scan_bwd_plain(x, dt, a, bm, cm, init_state, dy, d_final, *, chunk: int):
    """The explicit backward of ``ssd_scan_plain`` (the gradient that ``jax.vjp``
    of ``_ssd_blocked`` gives), for the cotangents dy of y and ``d_final`` of the
    final state (None: zero). Returns (dx, ddt, da, dbm, dcm, d_init_state), the
    last None when ``init_state`` is None. Per chunk, with h_c the state entering
    it and dh_c the cotangent of the state leaving it:

      dh_{c-1}  = exp(seg_c) dh_c + sum_i exp(cum_i) C_i dy_i^T     (reverse walk)
      dxs_j     = sum_{i>=j} G_ij exp(cum_i - cum_j) dy_i + exp(seg - cum_j) dh_c^T B_j
      dx_j      = dt_j dxs_j,   ddt_j = x_j . dxs_j + a rc_j
      dC_i      = sum_{j<=i} W_ij B_j + exp(cum_i) h_c dy_i
      dB_j      = sum_{i>=j} W_ij C_i + w_j dh_c x_j
      dcum_i    = dy_i . y_i - dt_i x_i . dxs_i  (+ <h_{c+1}, dh_c> at the last row)

    with G = C B^T, W_ij = exp(cum_i - cum_j) dt_j (dy_i . x_j) for j <= i,
    w_j = exp(seg - cum_j) dt_j, y the forward's f32 output, rc the reverse
    cumsum of dcum within the chunk, and da = sum over rows of dt rc. The ragged
    tail is zero-padded as the forward pads it."""
    B, S, H, P = x.shape
    t = _chunked(chunk, x, dt, a, bm, cm, init_state, dy)
    xf, dtf, bf, cf, cum, seg, w = t.xf, t.dtf, t.bf, t.cf, t.cum, t.seg, t.w
    dyf = t.more[0]
    h_in = torch.stack(t.h_in, dim=1)                            # [B,nc,H,N,P]
    h_out = torch.stack(t.h_in[1:] + [t.h], dim=1)
    # the cotangents of the states leaving each chunk (reverse walk)
    inject = torch.einsum("bcin,bcih,bcihp->bchnp", cf, torch.exp(cum), dyf)
    dh = torch.zeros_like(t.h) if d_final is None else widen(d_final)
    dh_out = [None] * t.nc
    for c in reversed(range(t.nc)):
        dh_out[c] = dh
        dh = dh * torch.exp(seg[:, c])[..., None, None] + inject[:, c]
    dh_out = torch.stack(dh_out, dim=1)                          # [B,nc,H,N,P]

    dxs = (torch.einsum("bcijh,bcihp->bcjhp", t.score, dyf)
           + torch.exp(seg[:, :, None, :] - cum)[..., None]
           * torch.einsum("bcjn,bchnp->bcjhp", bf, dh_out))
    wgt = t.decay * dtf[:, :, None, :, :] * torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    dcm = (torch.einsum("bcijh,bcjn->bcin", wgt, bf)
           + torch.einsum("bcih,bchnp,bcihp->bcin", torch.exp(cum), h_in, dyf))
    dbm = (torch.einsum("bcijh,bcin->bcjn", wgt, cf)
           + torch.einsum("bcjh,bchnp,bcjhp->bcjn", w, dh_out, xf))
    y = (torch.einsum("bcijh,bcjhp->bcihp", t.score, xf * dtf[..., None])
         + torch.einsum("bcin,bcih,bchnp->bcihp", cf, torch.exp(cum), h_in))
    ddt_direct = (xf * dxs).sum(-1)                              # [B,nc,Q,H]
    dcum = (dyf * y).sum(-1) - dtf * ddt_direct
    dcum[:, :, -1] += (h_out * dh_out).sum((-2, -1))             # d seg
    rc = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = ddt_direct + t.af * rc
    da = (dtf * rc).sum((0, 1, 2))

    def rows(v):
        return v.reshape((B, t.nc * t.Q) + v.shape[3:])[:, :S]

    return (rows(dxs * dtf[..., None]).to(x.dtype), rows(ddt).to(dt.dtype), da.to(a.dtype),
            rows(dbm).to(bm.dtype), rows(dcm).to(cm.dtype),
            None if init_state is None else dh.to(init_state.dtype))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in {"ssd_scan_fwd": [P] * 8 + [I] * 5 + [L] * 6 + [I, P],
                       "ssd_scan_bwd": [P] * 15 + [I] * 5 + [L] * 6 + [I, P]}.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = I
    lib.ssd_scan_bwd_scratch.argtypes = [I] * 6
    lib.ssd_scan_bwd_scratch.restype = L
    return lib


def _strides_16b(name: str, t: torch.Tensor, dims) -> list:
    """``t``'s strides over ``dims``, after checking that they and its data
    pointer are multiples of 16 bytes: the forward copies 16-byte pieces."""
    strides = [t.stride(d) for d in dims]
    if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in strides):
        raise ValueError(f"the SSD scan kernels need {name}'s data pointer and batch/row "
                         f"strides 16-byte aligned, got pointer {t.data_ptr()} and "
                         f"strides {t.stride()} of {t.element_size()}-byte elements")
    return strides


def _check(name: str, x, dt, a, bm, cm, init_state, chunk: int):
    """Raise on anything the kernels do not take; returns (B, S, H, P, N, the
    batch and row strides of x, bm and cm)."""
    tensors = [x, dt, a, bm, cm] + ([] if init_state is None else [init_state])
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{name} needs every input on one CUDA device")
    if x.dtype not in _DTYPE_CODE or bm.dtype != x.dtype or cm.dtype != x.dtype:
        raise ValueError(f"{name} takes f32 or bf16 x/bm/cm of one dtype, "
                         f"got {x.dtype}, {bm.dtype}, {cm.dtype}")
    if any(t.dtype != torch.float32 for t in tensors[1:3] + tensors[5:]):
        raise ValueError(f"{name} takes dt, a and init_state in f32")
    if x.dim() != 4:
        raise ValueError(f"x must be [B,S,H,P], got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = bm.shape[-1]
    want = {"dt": (B, S, H), "a": (H,), "bm": (B, S, N), "cm": (B, S, N),
            "init_state": (B, H, N, P)}
    for what, t in zip(want, tensors[1:]):
        if tuple(t.shape) != want[what]:
            raise ValueError(f"{what} shape {tuple(t.shape)} != {want[what]}")
    if N not in STATE_DIMS or P % P_TILE or min(B, S, H) == 0 or chunk <= 0:
        raise ValueError(f"{name} takes N in {STATE_DIMS}, P % {P_TILE} == 0 "
                         f"and non-empty B, S, H; got x {tuple(x.shape)}, N={N}, "
                         f"chunk={chunk}")
    if x.stride(3) != 1 or x.stride(2) != P or bm.stride(2) != 1 or cm.stride(2) != 1:
        raise ValueError(f"{name} needs x's last dim contiguous with heads P "
                         f"apart and bm/cm's last dim contiguous; strides x {x.stride()}, "
                         f"bm {bm.stride()}, cm {cm.stride()}")
    if not all(t.is_contiguous() for t in tensors[1:3] + tensors[5:]):
        raise ValueError(f"{name} needs contiguous dt, a and init_state")
    strides = (_strides_16b("x", x, (0, 1)) + _strides_16b("bm", bm, (0, 1))
               + _strides_16b("cm", cm, (0, 1)))
    return B, S, H, P, N, strides


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  bm: torch.Tensor, cm: torch.Tensor, *, chunk: int,
                  init_state=None):
    """Launch the CUDA kernel on CUDA tensors on PyTorch's current stream;
    returns (y, final_state). x, bm and cm may be strided views (last dim
    contiguous, x's heads P apart, pointers and batch/row strides 16-byte
    aligned); dt, a and init_state are contiguous. Raises on anything the
    kernel does not take. ``chunk`` is checked and kept for the signature: the
    kernel walks its own 64-row tiles, which changes only the rounding. Its
    gradient is ``ssd_scan_bwd_cuda``, reached through ``ops.ssd_scan``."""
    refuse_grad("ssd_scan_cuda", x, dt, a, bm, cm, init_state)
    B, S, H, P, N, strides = _check("ssd_scan_cuda", x, dt, a, bm, cm, init_state, chunk)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            None if init_state is None else init_state.data_ptr(), y.data_ptr(),
            state.data_ptr(), B, S, H, P, N, *strides, _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan_fwd launch failed: cudaError {err}")
    ssd_scan_cuda.launches += 1
    return y, state


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      bm: torch.Tensor, cm: torch.Tensor, init_state, dy: torch.Tensor,
                      d_final, *, chunk: int):
    """The gradient of ``ssd_scan_cuda`` on the card, as ``ssd_scan_bwd_plain``
    returns it: (dx, ddt, da, dbm, dcm, d_init_state or None). The inputs as the
    forward takes them (bf16: P of 32 or 64); dy contiguous in x's dtype, d_final
    f32 contiguous or None (zero). bf16 takes three launches, f32 two (the source
    note says why); the scratch they use (bf16: the states at every 64-row chunk
    boundary and their cotangents, 84 MB each at mamba2-2.7b's 2,048 tokens, and
    f32 rows of dB and dC for each group of 10 heads; the C side sizes it) is
    allocated here and freed with the call."""
    refuse_grad("ssd_scan_bwd_cuda", x, dt, a, bm, cm, init_state, dy, d_final)
    B, S, H, P, N, strides = _check("ssd_scan_bwd_cuda", x, dt, a, bm, cm, init_state, chunk)
    if x.dtype == torch.bfloat16 and P not in BWD_BF16_P:
        raise ValueError(f"ssd_scan_bwd_cuda takes bf16 inputs with P in {BWD_BF16_P}, "
                         f"got x {tuple(x.shape)}")
    if not (dy.is_cuda and dy.device == x.device and dy.dtype == x.dtype
            and dy.shape == x.shape and dy.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd_cuda needs dy contiguous {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}, got {tuple(dy.shape)} {dy.dtype} "
                         f"on {dy.device}")
    if d_final is not None and not (
            d_final.is_cuda and d_final.device == x.device and d_final.dtype == torch.float32
            and d_final.shape == (B, H, N, P) and d_final.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd_cuda needs d_final contiguous f32 {(B, H, N, P)} "
                         f"on {x.device}, got {tuple(d_final.shape)} {d_final.dtype}")
    dev, f32, code = x.device, torch.float32, _DTYPE_CODE[x.dtype]
    dx = torch.empty_like(dy)
    ddt = torch.empty((B, S, H), dtype=f32, device=dev)
    da = torch.empty((H,), dtype=f32, device=dev)
    dbm = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    dcm = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    d_init = None if init_state is None else torch.empty((B, H, N, P), dtype=f32, device=dev)
    lib = _lib()
    scratch = torch.empty((lib.ssd_scan_bwd_scratch(B, S, H, P, N, code),), dtype=torch.uint8,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            None if init_state is None else init_state.data_ptr(), dy.data_ptr(),
            None if d_final is None else d_final.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            da.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
            None if d_init is None else d_init.data_ptr(), scratch.data_ptr(), B, S, H, P, N,
            *strides, code, stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd launch failed: cudaError {err}")
    ssd_scan_bwd_cuda.launches += 1
    return dx, ddt, da, dbm, dcm, d_init


ssd_scan_cuda.launches = 0
ssd_scan_bwd_cuda.launches = 0
