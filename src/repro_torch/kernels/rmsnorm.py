"""RMSNorm forward: a Triton kernel for Hopper and its plain PyTorch version.

Replaces the TPU kernel ``_rmsnorm_kernel`` / ``rmsnorm_pallas`` of
``src/repro/kernels/rmsnorm.py``. Per row of ``x [..., D]``: the f32 mean of x²,
then ``x * rsqrt(var + eps) * scale``, cast back to x's dtype.

What bounds it on the H100: bytes. It does ~4 flops per element against one
read and one write of the row, far below the card's ~20 flops/byte f32 ridge,
so the least time is ``2 * rows * D * itemsize`` over the memory rate. The
design reads each row once into registers, reduces it there in f32 and writes
it once: no second pass over device memory and no intermediate in memory.
Several short rows share one program (qk-norm rows have D=128), so each
program still moves a few KB.

Triton rather than CUDA C++: this is one row-wise reduction fused with an
elementwise scale; it needs no tensor cores, shared-memory staging or
asynchronous copies, and Triton's masked block loads express the ragged tail
as well as CUDA would.

``triton`` is imported only when the kernel is first launched: the module
must import on machines without it.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.ref import rmsnorm_ref

# The plain version is the f32 formula of the oracle; the CPU path runs it.
rmsnorm_plain = rmsnorm_ref

_ELEMS_PER_PROGRAM = 4096


def _rmsnorm_fwd_kernel(x_ptr, w_ptr, y_ptr, n_rows, D, eps,
                        ROWS: "tl.constexpr", BLOCK_D: "tl.constexpr"):
    # Compiled by ``triton.jit`` in ``_compiled``; ``tl`` is bound there.
    pid = tl.program_id(0)
    rows = pid * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_D)
    col_ok = cols < D
    mask = (rows < n_rows)[:, None] & col_ok[None, :]
    offs = rows.to(tl.int64)[:, None] * D + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=1) / D
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=col_ok, other=0.0).to(tl.float32)
    y = x * rstd[:, None] * w[None, :]
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _compiled():
    import triton
    import triton.language

    globals()["tl"] = triton.language
    return triton, triton.jit(_rmsnorm_fwd_kernel)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch the Triton kernel on CUDA tensors: x [..., D], scale [D]."""
    if not (x.is_cuda and scale.is_cuda and x.device == scale.device):
        raise ValueError("rmsnorm_cuda needs x and scale on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm_cuda takes f32/bf16 x with a matching scale, "
                         f"got {x.dtype} and {scale.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous inputs")
    y = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    triton, kernel = _compiled()
    block_d = triton.next_power_of_2(D)
    n_rows_per = max(1, _ELEMS_PER_PROGRAM // block_d)
    grid = (triton.cdiv(rows, n_rows_per),)
    with torch.cuda.device(x.device):
        kernel[grid](x, scale, y, rows, D, eps, ROWS=n_rows_per, BLOCK_D=block_d,
                     num_warps=4)
    rmsnorm_cuda.launches += 1
    return y


rmsnorm_cuda.launches = 0
