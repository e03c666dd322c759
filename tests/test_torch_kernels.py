"""PyTorch port, kernel slice: each kernel's plain PyTorch version (the CPU path)
against the JAX package's Pallas kernel in interpret mode, or its oracle, on the
same numpy inputs, at the JAX suite's own tolerances (tests/test_kernels.py:
flash f32 2e-5 / bf16 2e-2, rmsnorm f32 1e-5 / bf16 2e-2). Tests marked ``cuda``
hold the hand-written kernels against the plain versions on the card and skip
without one."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401


# twins of tests/test_kernels.py:FLASH_SWEEP
FLASH_SWEEP = [
    # B, S, H, K, D, causal, window
    (1, 128, 4, 4, 64, True, 0),
    (2, 256, 4, 2, 64, True, 0),        # GQA
    (1, 256, 8, 1, 32, True, 0),        # MQA, small head
    (1, 128, 4, 4, 64, False, 0),       # bidirectional (encoder)
    (1, 256, 4, 2, 64, True, 64),       # sliding window
    (1, 96, 2, 2, 80, True, 0),         # ragged: S % block, D % 128 != 0
]
# q shorter than k/v (chunked prefill): end-aligned masks; and cross-attention,
# not causal, with q longer than k/v (whisper-medium's training decoder over its
# frames, at small size) or shorter at GQA 8:1 of 128 (llama-3.2-vision's layout)
SHORT_Q = [
    # B, Sq, Skv, H, K, D, causal, window
    (1, 32, 96, 4, 2, 64, True, 0),
    (2, 17, 80, 4, 1, 32, True, 24),
    (1, 40, 72, 2, 2, 80, False, 0),
    (2, 96, 40, 4, 2, 64, False, 0),
    (1, 130, 70, 4, 4, 64, False, 0),
    (1, 40, 75, 8, 1, 128, False, 0),
]
# zamba2-7b's head dim 112 (the card only: the Pallas path pads it to 128 and rounds
# q once more in bf16): causal MHA, GQA 2:1, a ragged S, not causal; Sq < Skv
FLASH_112 = [(1, 256, 4, 4, 112, True, 0), (2, 256, 4, 2, 112, True, 0),
             (1, 1000, 4, 2, 112, True, 0), (1, 130, 4, 4, 112, False, 0)]
SHORT_Q_112 = [(1, 96, 200, 4, 2, 112, True, 0), (2, 40, 130, 4, 4, 112, True, 48)]
RMS_SHAPES = [(2, 64, 128), (1, 7, 256), (4, 1, 512)]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(getattr(torch, dtype)).to(device)


def _f32(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ------------------------------------------------------------------ flash attention
@pytest.mark.parametrize("B,S,H,K,D,causal,window", FLASH_SWEEP)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_vs_pallas_interpret(B, S, H, K, D, causal, window, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    q, k, v = _np((B, S, H, D), 0), _np((B, S, K, D), 1), _np((B, S, K, D), 2)
    want = jops.flash_attention(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                                causal=causal, window=window, impl="pallas",
                                interpret=True)
    got = tops.flash_attention(*(_torch(a, dtype) for a in (q, k, v)),
                               causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, D)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,Sq,Skv,H,K,D,causal,window", SHORT_Q)
def test_flash_plain_short_q_vs_attention_ref(B, Sq, Skv, H, K, D, causal, window):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    q, k, v = _np((B, Sq, H, D), 3), _np((B, Skv, K, D), 4), _np((B, Skv, K, D), 5)
    want = jref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal, window=window)
    got = FA.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, window=window, blk_kv=32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)
    oracle = tref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal, window=window)
    np.testing.assert_allclose(_f32(oracle), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,D,causal,window", FLASH_SWEEP + FLASH_112)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_vs_plain_on_card(cuda, B, S, H, K, D, causal, window, dtype):
    q, k, v = (_torch(_np(s, i), dtype, cuda) for i, s in
               enumerate([(B, S, H, D), (B, S, K, D), (B, S, K, D)]))
    got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,K,D,causal,window", SHORT_Q + SHORT_Q_112)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_short_q_on_card(cuda, B, Sq, Skv, H, K, D, causal, window, dtype):
    """f32 runs the CUDA-core design, bf16 the tensor-core one: both against
    the oracle with end-aligned masks."""
    q, k, v = (_torch(_np(s, i), dtype, cuda) for i, s in
               enumerate([(B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)]))
    got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = tref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,K,D", [(512, 16, 8, 128), (512, 32, 32, 112),
                                     (2048, 32, 32, 112)],
                         ids=["qwen3-0.6b", "zamba2-7b", "zamba2-7b-2048"])
def test_flash_kernel_serving_shape_bf16_on_card(cuda, S, H, K, D):
    """A prefill of S tokens, B=1, causal: qwen3-0.6b's (H=16, K=8, D=128) and
    zamba2-7b's shared block (H=K=32, D=112)."""
    q, k, v = (_torch(_np(s, 20 + i), "bfloat16", cuda) for i, s in
               enumerate([(1, S, H, D), (1, S, K, D), (1, S, K, D)]))
    got = FA.flash_attention_cuda(q, k, v)
    want = FA.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_bwd_kernel_training_shape_bf16_on_card(cuda):
    """K1's backward at qwen3-0.6b's training shape: B=4, S=2048, H=16, K=8, D=128,
    causal, bf16 (the tensor-core design), against the plain backward on the same
    residuals at the bf16 gradient tolerance; two runs bit-equal."""
    q, k, v, do = (_torch(_np(s, 30 + i), "bfloat16", cuda) for i, s in
                   enumerate([(4, 2048, 16, 128), (4, 2048, 8, 128), (4, 2048, 8, 128),
                              (4, 2048, 16, 128)]))
    o, lse = FA.flash_attention_cuda(q, k, v, return_lse=True)
    got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for g, w, a in zip(got, want, again):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=2e-2, atol=2e-2)
        assert torch.equal(g, a)


# -------------------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plain_vs_pallas_interpret(shape, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    x = _np(shape, 6)
    sc = np.full((shape[-1],), 1.5, np.float32)
    want = jops.rmsnorm(jnp.asarray(x).astype(dtype), jnp.asarray(sc).astype(dtype),
                        impl="pallas", interpret=True)
    got = tops.rmsnorm(_torch(x, dtype), _torch(sc, dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMS_SHAPES + [(3, 5, 80), (2, 16, 1024)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_vs_plain_on_card(cuda, shape, dtype):
    x = _torch(_np(shape, 7), dtype, cuda)
    sc = _torch(_np(shape[-1:], 8), dtype, cuda)
    got = RN.rmsnorm_cuda(x, sc)
    want = RN.rmsnorm_plain(x, sc)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------- attend_cache
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("window", [0, 24])
def test_attend_cache_vs_jax(packed, window):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    B, Smax, H, K, D = 3, 48, 4, 2, 32
    q, kc, vc = _np((B, 1, H, D), 9), _np((B, Smax, K, D), 10), _np((B, Smax, K, D), 11)
    pos = np.array([5, 30, 47], np.int32).reshape(B, 1, 1, 1)
    want = jops.attend_cache(*(jnp.asarray(a) for a in (q, kc, vc, pos)),
                             window=window, packed=packed)
    got = tops.attend_cache(*(torch.from_numpy(a) for a in (q, kc, vc, pos)),
                            window=window, packed=packed)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_attend_cache_matches_full_attention():
    """Decode attention against a cache == last row of full causal attention."""
    B, S, H, K, D = 2, 64, 4, 2, 32
    q, k, v = (torch.from_numpy(_np(s, i)) for i, s in
               enumerate([(B, S, H, D), (B, S, K, D), (B, S, K, D)]))
    full = tref.attention_ref(q, k, v, causal=True)
    pos = torch.full((B, 1, 1, 1), S - 1, dtype=torch.int32)
    out = tops.attend_cache(q[:, -1:], k, v, pos)
    np.testing.assert_allclose(_f32(out[:, 0]), _f32(full[:, -1]), rtol=1e-5, atol=1e-5)
