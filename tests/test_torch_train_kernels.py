"""PyTorch port, training slice, kernel level: the backward of K1 (flash attention)
and of K2's three entry points on the dense path (the ssm slice's, K3's and the
gated norm's, are held against JAX in tests/test_torch_ssm_train.py; their
gradchecks are here), through the autograd Functions
as the CPU runs them (the plain forward and the plain explicit backward), against
the JAX package's gradients on the same numpy inputs: ``jax.vjp`` of
``repro.kernels.ops.flash_attention(..., impl="blocked")`` (its custom VJP
``_flash_bwd_blocked``) and of ``ref.rmsnorm_ref`` and the unfused JAX sequences
(add then norm; norm then ``apply_rope``). Tolerances are named where they are
used. A float64 ``gradcheck`` holds each Function's explicit backward against
finite differences of its own forward. Tests marked ``cuda`` hold the backward
kernels against these plain versions on the card and skip without one."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autograd as AG  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401


# tests/test_kernels.py's FLASH_SWEEP (GQA, MQA, bidirectional, window, ragged
# D=80), q shorter than k/v (end-aligned masks), both at qwen3's head dim, and
# gemma3-12b's head dim 256 (causal with a window; Sq < Skv, ragged)
FLASH_CASES = [
    # B, Sq, Skv, H, K, D, causal, window
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 1, 32, True, 0),
    (1, 128, 128, 4, 4, 64, False, 0),
    (1, 256, 256, 4, 2, 64, True, 64),
    (1, 96, 96, 2, 2, 80, True, 0),
    (1, 32, 96, 4, 2, 64, True, 0),
    (2, 17, 80, 4, 1, 32, True, 24),
    (1, 40, 72, 2, 2, 80, False, 0),
    (1, 200, 328, 16, 8, 128, True, 128),    # qwen3's D=128: Sq < Skv, ragged, window
    (1, 128, 128, 4, 2, 256, True, 32),      # gemma3's D=256: causal, window
    (1, 40, 100, 4, 2, 256, True, 0),        # D=256: Sq < Skv, ragged
]
# cross-attention, not causal over Sq != Skv: q longer than k/v (whisper-medium's
# training decoder, 2,048 tokens over 1,500 frames, at small size; ragged for
# 64-row tiles), q shorter, and GQA at head dim 128 (llama-3.2-vision's layout)
CROSS_CASES = [
    (2, 96, 40, 4, 2, 64, False, 0),
    (1, 130, 70, 4, 4, 64, False, 0),
    (1, 40, 75, 8, 1, 128, False, 0),
]
# tests/test_kernels.py:test_flash_custom_vjp_matches_autodiff_oracle's gradient
# tolerance, for f32; bf16 gradients are rounded to bf16 (2^-8 relative), held at
# the forward's bf16 tolerance
FLASH_GRAD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
# K2's gradients: the explicit formula against autodiff, in f32 (a few ulps of a
# sum over D, and dscale summed over every row); bf16 at K2's forward tolerance
NORM_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
NORM_SHAPES = [(2, 7, 128), (3, 5, 80), (4, 1, 1024)]
QK_SHAPES = [(2, 12, 4, 2, 64), (1, 9, 16, 8, 128)]       # B, S, H, K, hd
DTYPES = ["float32", "bfloat16"]
THETA = 1e6   # qwen3's rope_theta


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jnp(a, dtype):
    jnp = pytest.importorskip("jax.numpy")
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ------------------------------------------------------------------ flash attention
def _flash_inputs(B, Sq, Skv, H, K, D, seed=0):
    return (_np((B, Sq, H, D), seed), _np((B, Skv, K, D), seed + 1),
            _np((B, Skv, K, D), seed + 2), _np((B, Sq, H, D), seed + 3))


@pytest.mark.parametrize("B,Sq,Skv,H,K,D,causal,window", FLASH_CASES + CROSS_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_function_grads_match_jax_vjp(B, Sq, Skv, H, K, D, causal, window, dtype):
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as jops
    q, k, v, do = _flash_inputs(B, Sq, Skv, H, K, D)
    out, vjp = jax.vjp(lambda q_, k_, v_: jops.flash_attention(
        q_, k_, v_, causal=causal, window=window, impl="blocked", blk_kv=64),
        *(_jnp(a, dtype) for a in (q, k, v)))
    want = vjp(_jnp(do, dtype))
    tq, tk, tv = (_torch(a, dtype).requires_grad_(True) for a in (q, k, v))
    o = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
    got = torch.autograd.grad(o, (tq, tk, tv), _torch(do, dtype))
    _close(o.detach(), out, 2e-5 if dtype == "float32" else 2e-2)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, FLASH_GRAD_TOL[dtype])


@pytest.mark.parametrize("B,Sq,Skv,H,K,D,causal,window", FLASH_CASES[1::2])
def test_flash_plain_lse_matches_jax(B, Sq, Skv, H, K, D, causal, window):
    """The forward's LSE (the backward's residual) is _flash_fwd_blocked's."""
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    q, k, v, _ = _flash_inputs(B, Sq, Skv, H, K, D, seed=4)
    _, want = jops._flash_fwd_blocked(*(_jnp(a, "float32") for a in (q, k, v)),
                                      causal, window, 64)
    _, got = FA.flash_attention_plain(*(_torch(a, "float32") for a in (q, k, v)),
                                      causal=causal, window=window, return_lse=True)
    assert got.shape == (B, H, Sq) and got.dtype == torch.float32
    _close(got, want, 2e-5)


@pytest.mark.parametrize("B,Sq,Skv,H,K,D,causal,window",
                         FLASH_CASES[:3] + FLASH_CASES[-2:] + CROSS_CASES)
def test_flash_bwd_plain_matches_jax_bwd(B, Sq, Skv, H, K, D, causal, window):
    """flash_attention_bwd_plain against _flash_bwd_blocked on the same residuals."""
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    q, k, v, do = _flash_inputs(B, Sq, Skv, H, K, D, seed=7)
    jq, jk, jv, jdo = (_jnp(a, "float32") for a in (q, k, v, do))
    jo, jlse = jops._flash_fwd_blocked(jq, jk, jv, causal, window, 64)
    want = jops._flash_bwd_blocked(causal, window, 64, (jq, jk, jv, jo, jlse), jdo)
    got = FA.flash_attention_bwd_plain(
        *(_torch(a, "float32") for a in (q, k, v)), torch.from_numpy(np.array(jo)),
        torch.from_numpy(np.array(jlse)), _torch(do, "float32"), causal=causal,
        window=window, blk_kv=64)
    for g, w in zip(got, want):
        _close(g, w, FLASH_GRAD_TOL["float32"])


# ------------------------------------------------------------------ K2 backward
def _norm_vjp(fn, primals, cotangents, dtype):
    jax = pytest.importorskip("jax")
    _, vjp = jax.vjp(fn, *(_jnp(a, dtype) for a in primals))
    return vjp(tuple(_jnp(c, dtype) for c in cotangents) if isinstance(cotangents, list)
               else _jnp(cotangents, dtype))


@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_bwd_matches_jax_grad(shape, dtype):
    pytest.importorskip("jax")
    from repro.kernels import ref as jref
    x, sc, dy = _np(shape, 1), _np(shape[-1:], 2), _np(shape, 3)
    want = _norm_vjp(lambda x_, s_: jref.rmsnorm_ref(x_, s_), (x, sc), dy, dtype)
    got = RN.rmsnorm_bwd_plain(_torch(x, dtype), _torch(sc, dtype), _torch(dy, dtype))
    tx, ts = _torch(x, dtype).requires_grad_(True), _torch(sc, dtype).requires_grad_(True)
    via_fn = torch.autograd.grad(tops.rmsnorm(tx, ts), (tx, ts), _torch(dy, dtype))
    for g, f, w in zip(got, via_fn, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, NORM_GRAD_TOL[dtype])
        assert torch.equal(f, g)


@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_ds", [True, False])
def test_add_rmsnorm_bwd_matches_jax_grad(shape, dtype, with_ds):
    """add then norm, unfused in JAX; ds None is the final norm (s unused)."""
    pytest.importorskip("jax")
    from repro.kernels import ref as jref
    x, r, sc = _np(shape, 4), _np(shape, 5), _np(shape[-1:], 6)
    ds, dn = _np(shape, 7), _np(shape, 8)

    def seq(x_, r_, s_):
        t = x_ + r_
        return t, jref.rmsnorm_ref(t, s_)

    want = _norm_vjp(seq, (x, r, sc), [ds if with_ds else np.zeros_like(ds), dn], dtype)
    tx, tr, ts = (_torch(a, dtype).requires_grad_(True) for a in (x, r, sc))
    s, y = tops.add_rmsnorm(tx, tr, ts)
    outs, cots = ((s, y), (_torch(ds, dtype), _torch(dn, dtype))) if with_ds else \
        ((y,), (_torch(dn, dtype),))
    got = torch.autograd.grad(outs, (tx, tr, ts), cots)
    direct = RN.add_rmsnorm_bwd_plain(s.detach(), ts.detach(),
                                      _torch(ds, dtype) if with_ds else None,
                                      _torch(dn, dtype))
    for g, w in zip(got, want):
        _close(g, w, NORM_GRAD_TOL[dtype])
    assert torch.equal(got[0], direct[0]) and torch.equal(got[2], direct[1])


@pytest.mark.parametrize("B,S,H,K,hd", QK_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_qk_norm_rope_bwd_matches_jax_grad(B, S, H, K, hd, dtype):
    """qk-norm then apply_rope, unfused in JAX (its layers' ops)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    from repro.models import layers as jlayers
    q, k = _np((B, S, H, hd), 9), _np((B, S, K, hd), 10)
    qs, ks = _np((hd,), 11), _np((hd,), 12)
    dq, dk = _np((B, S, H, hd), 13), _np((B, S, K, hd), 14)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None] * 7 + 3, (B, S)).copy()
    jpos = jax.numpy.asarray(pos)

    def seq(q_, k_, qs_, ks_):
        return (jlayers.apply_rope(jref.rmsnorm_ref(q_, qs_), jpos, THETA),
                jlayers.apply_rope(jref.rmsnorm_ref(k_, ks_), jpos, THETA))

    want = _norm_vjp(seq, (q, k, qs, ks), [dq, dk], dtype)
    tq, tk, tqs, tks = (_torch(a, dtype).requires_grad_(True) for a in (q, k, qs, ks))
    qo, ko = tops.qk_norm_rope(tq, tk, tqs, tks, torch.from_numpy(pos), THETA)
    got = torch.autograd.grad((qo, ko), (tq, tk, tqs, tks),
                              (_torch(dq, dtype), _torch(dk, dtype)))
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, NORM_GRAD_TOL[dtype])


# ------------------------------------------------------------------ gradcheck (f64)
def _f64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).requires_grad_(True)


GRADCHECKS = {
    "flash_causal_gqa": lambda: (
        lambda q, k, v: AG.FlashAttention.apply(q, k, v, True, 0),
        (_f64(1, 6, 4, 8), _f64(1, 6, 2, 8, seed=1), _f64(1, 6, 2, 8, seed=2))),
    "flash_window_short_q": lambda: (
        lambda q, k, v: AG.FlashAttention.apply(q, k, v, True, 3),
        (_f64(2, 5, 2, 8), _f64(2, 9, 1, 8, seed=1), _f64(2, 9, 1, 8, seed=2))),
    "flash_bidirectional": lambda: (
        lambda q, k, v: AG.FlashAttention.apply(q, k, v, False, 0),
        (_f64(1, 4, 2, 8), _f64(1, 7, 2, 8, seed=1), _f64(1, 7, 2, 8, seed=2))),
    "rmsnorm": lambda: (lambda x, s: AG.RMSNorm.apply(x, s, 1e-6),
                        (_f64(3, 5, 8), _f64(8, seed=1))),
    "add_rmsnorm": lambda: (lambda x, r, s: AG.AddRMSNorm.apply(x, r, s, 1e-6),
                            (_f64(3, 8), _f64(3, 8, seed=1), _f64(8, seed=2))),
    "add_rmsnorm_norm_only": lambda: (
        lambda x, r, s: AG.AddRMSNorm.apply(x, r, s, 1e-6)[1],
        (_f64(3, 8), _f64(3, 8, seed=1), _f64(8, seed=2))),
    "gated_rmsnorm": lambda: (lambda y, z, s: AG.GatedRMSNorm.apply(y, z, s, 1e-6),
                              (_f64(3, 8), _f64(3, 8, seed=1), _f64(8, seed=2))),
    # S=5 in chunks of 2: a ragged tail; both outputs, so d(final state) too
    "ssd_scan_init_state": lambda: (
        lambda x, dt, a, bm, cm, h0: AG.SSDScan.apply(x, dt, a, bm, cm, h0, 2),
        (_f64(1, 5, 2, 3), _f64(1, 5, 2, seed=1).detach().abs().add(0.1).requires_grad_(True),
         _f64(2, seed=2).detach().abs().neg().requires_grad_(True), _f64(1, 5, 2, seed=3),
         _f64(1, 5, 2, seed=4), _f64(1, 2, 2, 3, seed=5))),
    # no initial state, y alone: the final state's cotangent is None
    "ssd_scan_y_only": lambda: (
        lambda x, dt, a, bm, cm: AG.SSDScan.apply(x, dt, a, bm, cm, None, 3)[0],
        (_f64(2, 4, 1, 2), _f64(2, 4, 1, seed=1).detach().abs().add(0.1).requires_grad_(True),
         _f64(1, seed=2).detach().abs().neg().requires_grad_(True), _f64(2, 4, 3, seed=3),
         _f64(2, 4, 3, seed=4))),
    "qk_norm_rope": lambda: (
        lambda q, k, a, b: AG.QkNormRope.apply(
            q, k, a, b, torch.tensor([[0, 5, 9]], dtype=torch.int32).expand(2, 3),
            1e4, 1e-6),
        (_f64(2, 3, 4, 8), _f64(2, 3, 2, 8, seed=1), _f64(8, seed=2), _f64(8, seed=3))),
}


@pytest.mark.parametrize("name", sorted(GRADCHECKS))
def test_function_gradcheck_float64(name):
    fn, inputs = GRADCHECKS[name]()
    assert torch.autograd.gradcheck(fn, inputs)


# ------------------------------------------------------------------ on the card
# Besides FLASH_CASES, gemma3-12b's heads at head dim 256 past its window of 1,024
# and ragged for the 64-row tiles, with and without the window, Sq < Skv with a
# window, and a bidirectional one (too large for the CPU's jax.vjp tests); and
# zamba2-7b's head dim 112: causal MHA, GQA 2:1, a ragged S, Sq < Skv, not causal,
# and its training attention (B=1, S=2,048, H=K=32); whisper-medium's cross-attention
# in training (4 x 2,048 queries over 1,500 frames), its encoder (1,500 both ways, at
# B=1 and at its training B=4) and its causal decoder in training (4 x 2,048)
FLASH_CARD_CASES = FLASH_CASES + CROSS_CASES + [
    (1, 1100, 1100, 16, 8, 256, True, 0), (1, 1100, 1100, 16, 8, 256, True, 1024),
    (2, 200, 328, 4, 2, 256, True, 128), (1, 130, 130, 4, 2, 256, False, 0),
    (1, 256, 256, 4, 4, 112, True, 0), (2, 256, 256, 4, 2, 112, True, 0),
    (1, 1000, 1000, 4, 2, 112, True, 0), (1, 96, 200, 4, 2, 112, True, 0),
    (1, 130, 130, 4, 4, 112, False, 0), (1, 2048, 2048, 32, 32, 112, True, 0),
    (4, 2048, 1500, 16, 16, 64, False, 0), (1, 1500, 1500, 16, 16, 64, False, 0),
    (4, 1500, 1500, 16, 16, 64, False, 0), (4, 2048, 2048, 16, 16, 64, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,K,D,causal,window", FLASH_CARD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_bwd_kernel_matches_plain_on_card(cuda, B, Sq, Skv, H, K, D, causal, window,
                                               dtype):
    """At D=256 f32 runs the CUDA-core design with 32-row tiles, bf16 the
    tensor-core one (dK and dV on separate warps, 32-row kv tiles in the dQ pass);
    at D=112 the D <= 128 designs with 7 k-steps; the forward's LSE, which serving
    never reads, is the plain version's there too."""
    q, k, v, do = (_torch(a, dtype).to(cuda) for a in _flash_inputs(B, Sq, Skv, H, K, D))
    o, lse = FA.flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
    _, plse = FA.flash_attention_plain(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    _close(lse.cpu(), plse.cpu(), 2e-5)
    got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, window=window)
    for g, w, again in zip(got, want, FA.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal=causal, window=window)):
        _close(g.cpu(), w.cpu(), FLASH_GRAD_TOL[dtype])
        assert torch.equal(g, again)          # deterministic: no atomics


def _exact(t):
    """f32 widened to f64, where the plain twin gives the exact value: dscale sums
    thousands of rows, and two f32 sums of them in different orders differ by more
    than 1e-5 near zero."""
    return t.double() if t.dtype == torch.float32 else t


# Besides the CPU shapes and the training shapes (qwen3-0.6b's, gemma3-12b's and
# zamba2-7b's), the
# edges of the kernels' one-launch dscale fold: one row, rows fewer than the blocks,
# rows not a multiple of a block's (600), and wide rows that take a block each
# (mamba2's 2560 and 5120).
NORM_CARD_SHAPES = NORM_SHAPES + [(4, 2048, 1024), (1, 2048, 3840), (1, 1, 1024), (600, 1024),
                                  (2, 3, 2560), (1, 5, 5120), (1, 2048, 3584)]
QK_CARD_SHAPES = QK_SHAPES + [(4, 2048, 16, 8, 128), (1, 2048, 16, 8, 256), (1, 1, 16, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", NORM_CARD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_bwd_kernels_match_plain_on_card(cuda, shape, dtype):
    """Each entry point twice in a row on one stream: the second launch finds the
    fold's tickets back at 0 and gives the same bits."""
    x, dy, ds = (_torch(_np(shape, s), dtype).to(cuda) for s in (1, 2, 3))
    sc = _torch(_np(shape[-1:], 4), dtype).to(cuda)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]     # K2's forward tolerances
    ex = [_exact(t) for t in (x, sc, dy, ds)]
    for run, want in [(lambda: RN.rmsnorm_bwd_cuda(x, sc, dy), RN.rmsnorm_bwd_plain(*ex[:3])),
                      (lambda: RN.add_rmsnorm_bwd_cuda(x, sc, ds, dy),
                       RN.add_rmsnorm_bwd_plain(ex[0], ex[1], ex[3], ex[2]))]:
        got, again = run(), run()
        for g, w, a in zip(got, want, again):
            _close(g.cpu(), w.cpu(), tol)
            assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,hd", QK_CARD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_qk_norm_rope_bwd_kernel_matches_plain_on_card(cuda, B, S, H, K, hd, dtype):
    q, dq = (_torch(_np((B, S, H, hd), s), dtype).to(cuda) for s in (1, 2))
    k, dk = (_torch(_np((B, S, K, hd), s), dtype).to(cuda) for s in (3, 4))
    qs, ks = (_torch(_np((hd,), s), dtype).to(cuda) for s in (5, 6))
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None].expand(B, S)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    got = RN.qk_norm_rope_bwd_cuda(q, k, qs, ks, pos, THETA, dq, dk)
    again = RN.qk_norm_rope_bwd_cuda(q, k, qs, ks, pos, THETA, dq, dk)
    want = RN.qk_norm_rope_bwd_plain(*(_exact(t) for t in (q, k, qs, ks)), pos, THETA,
                                     _exact(dq), _exact(dk))
    for g, w, a in zip(got, want, again):
        _close(g.cpu(), w.cpu(), tol)
        assert torch.equal(g, a)                 # deterministic: no atomics on values
