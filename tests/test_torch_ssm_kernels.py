"""PyTorch port, SSM slice kernels: the SSD scan (K3), its decode step and the
causal conv, on the CPU (plain versions) against the JAX package on the same
numpy inputs, at the JAX suite's tolerances (tests/test_kernels.py: SSD f32
2e-4 / bf16 5e-2; the decode recurrence 1e-4). Tests marked ``cuda`` hold the
hand-written kernel against the plain version on the card and skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as SS  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401


# twins of tests/test_kernels.py:SSD_SWEEP
SSD_SWEEP = [
    # B, S, H, P, N, chunk
    (1, 128, 2, 32, 16, 32),
    (2, 256, 4, 64, 32, 64),
    (1, 100, 2, 32, 16, 32),            # ragged S % chunk
]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _inputs(B, S, H, P, N, seed=0):
    """x, dt = softplus(normal), a = -exp(0.2 normal), bm, cm, init_state; f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0.0).astype(np.float32)
    a = -np.exp(0.2 * rng.standard_normal(H)).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return x, dt, a, bm, cm, h0


def _torch(a, dtype="float32", device="cpu"):
    return torch.from_numpy(a).to(getattr(torch, dtype)).to(device)


def _scan_args(arrs, dtype, device="cpu"):
    """x/bm/cm in ``dtype``, dt/a in f32, as the model path passes them."""
    x, dt, a, bm, cm = arrs[:5]
    return (_torch(x, dtype, device), _torch(dt, "float32", device),
            _torch(a, "float32", device), _torch(bm, dtype, device),
            _torch(cm, dtype, device))


def _f32(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().cpu().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ------------------------------------------------------------------- scan, CPU
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SWEEP)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_plain_vs_pallas_interpret(B, S, H, P, N, chunk, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    arrs = _inputs(B, S, H, P, N)
    x, dt, a, bm, cm = (jnp.asarray(v) for v in arrs[:5])
    want = jops.ssd_scan(x.astype(dtype), dt, a, bm.astype(dtype), cm.astype(dtype),
                         chunk=chunk, impl="pallas", interpret=True)
    got = tops.ssd_scan(*_scan_args(arrs, dtype), chunk=chunk)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, P)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SWEEP)
def test_ssd_scan_with_init_state_vs_blocked(B, S, H, P, N, chunk):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    arrs = _inputs(B, S, H, P, N, seed=1)
    y_want, h_want = jops.ssd_scan(*(jnp.asarray(v) for v in arrs[:5]), chunk=chunk,
                                   impl="blocked", init_state=jnp.asarray(arrs[5]),
                                   return_state=True)
    y, h = tops.ssd_scan(*_scan_args(arrs, "float32"), chunk=chunk,
                         init_state=_torch(arrs[5]), return_state=True)
    assert h.dtype == torch.float32 and h.shape == (B, H, N, P)
    _close(y, y_want, 2e-4)
    _close(h, h_want, 2e-4)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SWEEP)
def test_ssd_scan_vs_ssd_ref(B, S, H, P, N, chunk):
    """The plain scan against the port's per-timestep oracle, and that oracle
    against the JAX package's, y and final state."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    arrs = _inputs(B, S, H, P, N, seed=2)
    y_j, h_j = jref.ssd_ref(*(jnp.asarray(v) for v in arrs[:5]))
    y_r, h_r = tref.ssd_ref(*_scan_args(arrs, "float32"))
    _close(y_r, y_j, 2e-4)
    _close(h_r, h_j, 2e-4)
    y, h = tops.ssd_scan(*_scan_args(arrs, "float32"), chunk=chunk, return_state=True)
    _close(y, y_r, 2e-4)
    _close(h, h_r, 2e-4)


@pytest.mark.parametrize("s1,chunk", [(100, 32), (64, 64), (1, 32)])
def test_ssd_split_scan_identity(s1, chunk):
    """Scanning S1 tokens, then the rest from the first final state, equals one
    scan of the whole sequence: the state carries everything."""
    arrs = _inputs(2, 128, 4, 32, 16, seed=3)
    args = _scan_args(arrs, "float32")
    y, h = tops.ssd_scan(*args, chunk=chunk, return_state=True)
    first = [t[:, :s1] if t.dim() > 1 else t for t in args]
    rest = [t[:, s1:] if t.dim() > 1 else t for t in args]
    y1, h1 = tops.ssd_scan(*first, chunk=chunk, return_state=True)
    y2, h2 = tops.ssd_scan(*rest, chunk=chunk, init_state=h1, return_state=True)
    _close(torch.cat([y1, y2], dim=1), y, 2e-4)
    _close(h2, h, 2e-4)


def _conv_views(B, S, H, P, N, dtype, device="cpu", seed=9):
    """x, bm, cm as the model passes them: strided slices of one [B, S, H*P + 2N]
    conv output (``ssm_block``), x reshaped to [B, S, H, P]."""
    arrs = _inputs(B, S, H, P, N, seed=seed)
    conv = torch.cat([_torch(arrs[0], dtype, device).reshape(B, S, H * P),
                      _torch(arrs[3], dtype, device), _torch(arrs[4], dtype, device)], dim=-1)
    DI = H * P
    x, bm, cm = conv[..., :DI].reshape(B, S, H, P), conv[..., DI:DI + N], conv[..., DI + N:]
    assert not (x.is_contiguous() or bm.is_contiguous() or cm.is_contiguous())
    return x, _torch(arrs[1], "float32", device), _torch(arrs[2], "float32", device), bm, cm


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_reads_conv_output_views(dtype):
    """ops.ssd_scan on the strided conv-output slices == on contiguous copies."""
    x, dt, a, bm, cm = _conv_views(2, 100, 4, 32, 16, dtype)
    y, h = tops.ssd_scan(x, dt, a, bm, cm, chunk=32, return_state=True)
    y_c, h_c = tops.ssd_scan(x.contiguous(), dt, a, bm.contiguous(), cm.contiguous(),
                             chunk=32, return_state=True)
    assert y.shape == x.shape
    np.testing.assert_array_equal(_f32(y), _f32(y_c))
    np.testing.assert_array_equal(_f32(h), _f32(h_c))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_stride_check(dtype):
    """The wrapper's 16-byte check, which the kernel's copies need: the model's
    conv-output slices pass, a view one element off does not."""
    x, _, _, bm, cm = _conv_views(2, 100, 4, 32, 16, dtype)
    assert SS._strides_16b("x", x, (0, 1)) == [x.stride(0), x.stride(1)]
    assert SS._strides_16b("cm", cm, (0, 1)) == [cm.stride(0), cm.stride(1)]
    base = torch.zeros(2 * 100 * 17 + 8, dtype=getattr(torch, dtype))
    with pytest.raises(ValueError, match="16-byte"):
        SS._strides_16b("bm", base[1:1 + 2 * 100 * 16].view(2, 100, 16), (0, 1))
    with pytest.raises(ValueError, match="16-byte"):
        SS._strides_16b("bm", base[:2 * 100 * 17].view(2, 100, 17)[..., :16], (0, 1))


# ------------------------------------------------------------------ decode step
def test_ssd_decode_step_vs_jax():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    x, dt, a, bm, cm, h0 = _inputs(3, 1, 4, 16, 8, seed=4)
    y_want, h_want = jops.ssd_decode_step(*(jnp.asarray(v) for v in (x, dt, a, bm, cm, h0)))
    y, h = tops.ssd_decode_step(*(_torch(v) for v in (x, dt, a, bm, cm, h0)))
    assert y.shape == (3, 1, 4, 16) and h.dtype == torch.float32
    _close(y, y_want, 1e-5)
    _close(h, h_want, 1e-5)


def test_ssd_decode_step_matches_scan_tail():
    """Twin of tests/test_kernels.py's: S steps of the decode recurrence == the
    scan's outputs and final state."""
    B, S, H, P, N = 1, 32, 2, 16, 8
    x, dt, a, bm, cm = (_torch(v) for v in _inputs(B, S, H, P, N, seed=5)[:5])
    y_scan, h_scan = tref.ssd_ref(x, dt, a, bm, cm)
    h = torch.zeros((B, H, N, P))
    outs = []
    for t in range(S):
        y, h = tops.ssd_decode_step(x[:, t:t + 1], dt[:, t:t + 1], a,
                                    bm[:, t:t + 1], cm[:, t:t + 1], h)
        outs.append(y)
    _close(torch.cat(outs, dim=1), y_scan, 1e-4)
    _close(h, h_scan, 1e-4)


# ------------------------------------------------------------------ causal conv
@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("S", [1, 9])
def test_causal_conv_vs_jax(with_tail, S):
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import ssm as JSSM
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, S, 24)).astype(np.float32)
    k = rng.standard_normal((4, 24)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 24)).astype(np.float32) if with_tail else None
    y_want, t_want = JSSM._causal_conv(jnp.asarray(x), jnp.asarray(k),
                                       None if tail is None else jnp.asarray(tail))
    y, t = TSSM._causal_conv(_torch(x), _torch(k), None if tail is None else _torch(tail))
    assert t.shape == (2, 3, 24)
    _close(y, y_want, 1e-6)
    np.testing.assert_array_equal(_f32(t), _f32(t_want))


# ------------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SWEEP)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_kernel_vs_plain_on_card(cuda, B, S, H, P, N, chunk, dtype, with_state):
    arrs = _inputs(B, S, H, P, N, seed=7)
    args = _scan_args(arrs, dtype, cuda)
    h0 = _torch(arrs[5], "float32", cuda) if with_state else None
    y, h = SS.ssd_scan_cuda(*args, chunk=chunk, init_state=h0)
    y_want, h_want = SS.ssd_scan_plain(*args, chunk=chunk, init_state=h0)
    torch.cuda.synchronize()
    assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32
    _close(y, y_want, TOL[dtype])
    _close(h, h_want, TOL[dtype])


@pytest.mark.cuda
def test_ssd_kernel_split_scan_on_card(cuda):
    args = _scan_args(_inputs(2, 256, 4, 64, 32, seed=8), "float32", cuda)
    y, h = SS.ssd_scan_cuda(*args, chunk=64)
    first = [t[:, :100].contiguous() if t.dim() > 1 else t for t in args]
    rest = [t[:, 100:].contiguous() if t.dim() > 1 else t for t in args]
    y1, h1 = SS.ssd_scan_cuda(*first, chunk=64)
    y2, h2 = SS.ssd_scan_cuda(*rest, chunk=64, init_state=h1)
    torch.cuda.synchronize()
    _close(torch.cat([y1, y2], dim=1), y, 2e-4)
    _close(h2, h, 2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_reads_conv_output_views_on_card(cuda, dtype):
    """The kernel on the strided conv-output slices, in place, against the
    plain version on contiguous copies."""
    x, dt, a, bm, cm = _conv_views(2, 100, 4, 32, 16, dtype, cuda)
    y, h = SS.ssd_scan_cuda(x, dt, a, bm, cm, chunk=32)
    y_want, h_want = SS.ssd_scan_plain(x.contiguous(), dt, a, bm.contiguous(),
                                       cm.contiguous(), chunk=32)
    torch.cuda.synchronize()
    _close(y, y_want, TOL[dtype])
    _close(h, h_want, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("H,N", [(80, 128), (112, 64)], ids=["mamba2-2.7b", "zamba2-7b"])
def test_ssd_kernel_serving_shape_bf16_on_card(cuda, H, N):
    """The prefill of 512 tokens: B=1, P=64, chunk 256; mamba2-2.7b's H=80, N=128
    and zamba2-7b's H=112, N=64."""
    args = _scan_args(_inputs(1, 512, H, 64, N, seed=10), "bfloat16", cuda)
    y, h = SS.ssd_scan_cuda(*args, chunk=256)
    y_want, h_want = SS.ssd_scan_plain(*args, chunk=256)
    torch.cuda.synchronize()
    _close(y, y_want, TOL["bfloat16"])
    _close(h, h_want, TOL["bfloat16"])
