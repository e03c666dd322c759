"""PyTorch port, K2's fused entry points (``add_rmsnorm``, ``gated_rmsnorm``,
``qk_norm_rope``): each plain version against the JAX package's composition of
the same ops on the same numpy inputs (f32 1e-5, bf16 2e-2, the JAX suite's
rmsnorm tolerances); each ``ops.*`` call on the CPU against the unfused PyTorch
sequence the model ran before the fusion, bit for bit; the split-row entries of
the gated norm (a row split over ranks), their plain versions put back together
against the whole-row plain version both ways; and, marked ``cuda``, each of K2's
kernel entry points against its plain version at the serving shapes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401


DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
THETA = 1e6                                   # qwen3's rope_theta
# (B, S, H, K, hd): a prefill and a 4-slot decode step of qwen3's attention heads
QK_SHAPES = [(2, 12, 4, 2, 128), (4, 1, 16, 8, 128)]
NORM_SHAPES = [(2, 7, 128), (4, 1, 1024), (1, 9, 2560)]


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype)).to(device)


def _f32(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().cpu().numpy()


def _positions(B, S, decode: bool) -> np.ndarray:
    """Decode: one position per slot; prefill: the model's expanded arange."""
    if decode:
        return (np.arange(B, dtype=np.int32) * 37 + 500)[:, None]
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))


def _torch_positions(pos: np.ndarray, decode: bool):
    if decode:
        return torch.from_numpy(pos[:, 0].copy())[:, None]       # pos[:, None]
    B, S = pos.shape
    return torch.arange(S, dtype=torch.int32)[None].expand(B, S)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# --------------------------------------------------- plain versions vs the JAX package
@pytest.mark.parametrize("B,S,H,K,hd", QK_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_qk_norm_rope_plain_vs_jax(B, S, H, K, hd, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.models import layers as jlayers
    decode = S == 1
    q, k = _np((B, S, H, hd), 30), _np((B, S, K, hd), 31)
    qs, ks = 1.0 + 0.1 * _np((hd,), 32), 1.0 + 0.1 * _np((hd,), 33)
    pos = _positions(B, S, decode)
    jq, jk, jqs, jks = (jnp.asarray(a).astype(dtype) for a in (q, k, qs, ks))
    want_q = jlayers.apply_rope(jops.rmsnorm(jq, jqs), jnp.asarray(pos), THETA)
    want_k = jlayers.apply_rope(jops.rmsnorm(jk, jks), jnp.asarray(pos), THETA)
    got_q, got_k = RN.qk_norm_rope_plain(_torch(q, dtype), _torch(k, dtype), _torch(qs, dtype),
                                         _torch(ks, dtype), _torch_positions(pos, decode), THETA)
    for got, want in ((got_q, want_q), (got_k, want_k)):
        assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rmsnorm_plain_vs_jax(shape, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    x, r, sc = _np(shape, 40), _np(shape, 41), 1.0 + 0.1 * _np(shape[-1:], 42)
    jx, jr, jsc = (jnp.asarray(a).astype(dtype) for a in (x, r, sc))
    want_s = jx + jr
    want_y = jops.rmsnorm(want_s, jsc)
    got_s, got_y = RN.add_rmsnorm_plain(_torch(x, dtype), _torch(r, dtype), _torch(sc, dtype))
    for got, want in ((got_s, want_s), (got_y, want_y)):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("shape", [(2, 7, 128), (4, 1, 5120), (1, 9, 5120)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_rmsnorm_plain_vs_jax(shape, dtype):
    """``repro.models.ssm``'s gate and ``gate_norm``, as ``ssm_block`` composes them."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ops as jops
    y, z, sc = _np(shape, 50), _np(shape, 51), 1.0 + 0.1 * _np(shape[-1:], 52)
    jy, jz, jsc = (jnp.asarray(a).astype(dtype) for a in (y, z, sc))
    want = jops.rmsnorm(jy * jax.nn.silu(jz.astype(jnp.float32)).astype(jy.dtype), jsc)
    got = RN.gated_rmsnorm_plain(_torch(y, dtype), _torch(z, dtype), _torch(sc, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


# ------------------------------------- CPU dispatch == the unfused sequence, bit for bit
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("decode", [False, True])
def test_qk_norm_rope_cpu_equals_unfused(dtype, decode):
    B, S, H, K, hd = (4, 1, 16, 8, 128) if decode else (2, 12, 4, 2, 128)
    q, k = _torch(_np((B, S, H, hd), 60), dtype), _torch(_np((B, S, K, hd), 61), dtype)
    qs, ks = _torch(_np((hd,), 62), dtype), _torch(_np((hd,), 63), dtype)
    pos = _torch_positions(_positions(B, S, decode), decode)
    got_q, got_k = tops.qk_norm_rope(q, k, qs, ks, pos, THETA, eps=1e-6)
    want_q = TLY.apply_rope(tops.rmsnorm(q, qs, eps=1e-6), pos, THETA)
    want_k = TLY.apply_rope(tops.rmsnorm(k, ks, eps=1e-6), pos, THETA)
    assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rmsnorm_cpu_equals_unfused(dtype):
    x, r = _torch(_np((2, 9, 1024), 70), dtype), _torch(_np((2, 9, 1024), 71), dtype)
    sc = _torch(_np((1024,), 72), dtype)
    s, y = tops.add_rmsnorm(x, r, sc, eps=1e-6)
    want_s = x + r
    assert torch.equal(s, want_s) and torch.equal(y, tops.rmsnorm(want_s, sc, eps=1e-6))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_rmsnorm_cpu_equals_unfused(dtype):
    y, z = _torch(_np((1, 9, 5120), 80), dtype), _torch(_np((1, 9, 5120), 81), dtype)
    sc = _torch(_np((5120,), 82), dtype)
    got = tops.gated_rmsnorm(y, z, sc, eps=1e-5)
    want = tops.rmsnorm(y * F.silu(z.float()).to(y.dtype), sc, eps=1e-5)
    assert torch.equal(got, want)


# ------------------------------------------------- the gated norm over a split row
SPLIT_SHAPES = [(2, 7, 256), (4, 1, 5120), (1, 9, 7168)]


def _gated_case(shape, dtype, seed):
    return tuple(_torch(_np(s, seed + i), dtype) for i, s in
                 enumerate((shape, shape, shape[-1:], shape)))


def _split_forward(y, z, sc, ways):
    """The split-row plain versions on ``ways`` column slices, the row sums added
    here in place of the all-reduce; the slices' outputs put back together."""
    parts = [t.chunk(ways, dim=-1) for t in (y, z, sc)]
    ss = sum(RN.gated_rmsnorm_stats_plain(a, b) for a, b, _ in zip(*parts))
    return torch.cat([RN.gated_rmsnorm_split_plain(a, b, c, ss, y.shape[-1], eps=1e-5)
                      for a, b, c in zip(*parts)], dim=-1)


def _split_backward(y, z, sc, dout, ways):
    parts = [t.chunk(ways, dim=-1) for t in (y, z, sc, dout)]
    ss = sum(RN.gated_rmsnorm_stats_plain(a, b) for a, b, _, _ in zip(*parts))
    dot = sum(RN.gated_rmsnorm_split_dot_plain(*p) for p in zip(*parts))
    outs = [RN.gated_rmsnorm_split_bwd_plain(*p, ss, dot, y.shape[-1], eps=1e-5)
            for p in zip(*parts)]
    return tuple(torch.cat([o[i] for o in outs], dim=-1) for i in range(3))


@pytest.mark.parametrize("ways", [2, 4, 8])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_row_plain_equals_whole_row(shape, ways, dtype):
    """The split-row plain versions, the rows split ``ways`` ways and their sums
    added, equal the whole-row plain ``gated_rmsnorm`` and its backward."""
    y, z, sc, dout = _gated_case(shape, dtype, 110)
    got = _split_forward(y, z, sc, ways)
    want = RN.gated_rmsnorm_plain(y, z, sc, eps=1e-5)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])
    for g, w in zip(_split_backward(y, z, sc, dout, ways),
                    RN.gated_rmsnorm_bwd_plain(y, z, sc, dout, eps=1e-5)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_row_function_without_a_group_is_the_gated_norm(dtype):
    """``ops.gated_rmsnorm_split`` with no group (the local columns are the whole
    row), recording and not, against ``ops.gated_rmsnorm``: the forward and every
    gradient within K2's gates."""
    y, z, sc, dout = _gated_case((3, 5, 256), dtype, 120)
    np.testing.assert_allclose(_f32(tops.gated_rmsnorm_split(y, z, sc, 256, None, eps=1e-5)),
                               _f32(tops.gated_rmsnorm(y, z, sc, eps=1e-5)),
                               rtol=TOL[dtype], atol=TOL[dtype])
    grads = []
    for fn in (lambda a, b, c: tops.gated_rmsnorm_split(a, b, c, 256, None, eps=1e-5),
               lambda a, b, c: tops.gated_rmsnorm(a, b, c, eps=1e-5)):
        leaves = [t.clone().requires_grad_(True) for t in (y, z, sc)]
        fn(*leaves).backward(dout)
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=TOL[dtype], atol=TOL[dtype])


def test_split_row_backward_gradcheck_f64():
    """The split-row Function's explicit backward against finite differences, in
    f64, on one rank's whole row."""
    gen = torch.Generator().manual_seed(5)
    y, z, sc = (torch.randn(s, generator=gen, dtype=torch.float64, requires_grad=True)
                for s in ((3, 16), (3, 16), (16,)))
    from repro_torch.kernels.autograd import GatedRMSNormSplit
    assert torch.autograd.gradcheck(lambda a, b, c: GatedRMSNormSplit.apply(a, b, c, 1e-5, 16,
                                                                            None),
                                    (y, z, sc))


def test_rope_is_reexported_by_layers():
    assert TLY.apply_rope is tref.apply_rope and TLY.rope_freqs is tref.rope_freqs


# ---------------------------------------------------- kernel vs plain version on card
def _close(got, want, dtype):
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 512, 1024), (4, 1, 1024), (1, 512, 2560),
                                   (4, 1, 2560), (3, 5, 80), (1, 2048, 3584)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rmsnorm_kernel_vs_plain_on_card(cuda, shape, dtype):
    x, r = _torch(_np(shape, 90), dtype, cuda), _torch(_np(shape, 91), dtype, cuda)
    sc = _torch(_np(shape[-1:], 92), dtype, cuda)
    s, y = RN.add_rmsnorm_cuda(x, r, sc)
    want_s, want_y = RN.add_rmsnorm_plain(x, r, sc)
    torch.cuda.synchronize()
    assert torch.equal(s, want_s)
    _close(y, want_y, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 512, 5120), (4, 1, 5120), (3, 5, 80),
                                   (1, 2048, 7168)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_rmsnorm_kernel_vs_plain_on_card(cuda, shape, dtype):
    y, z = _torch(_np(shape, 93), dtype, cuda), _torch(_np(shape, 94), dtype, cuda)
    sc = _torch(_np(shape[-1:], 95), dtype, cuda)
    _close(RN.gated_rmsnorm_cuda(y, z, sc, eps=1e-5),
           RN.gated_rmsnorm_plain(y, z, sc, eps=1e-5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,hd", [(1, 512, 16, 8, 128), (4, 1, 16, 8, 128),
                                        (2, 12, 4, 2, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_qk_norm_rope_kernel_vs_plain_on_card(cuda, B, S, H, K, hd, dtype):
    decode = S == 1
    q, k = _torch(_np((B, S, H, hd), 96), dtype, cuda), _torch(_np((B, S, K, hd), 97), dtype, cuda)
    qs, ks = _torch(_np((hd,), 98), dtype, cuda), _torch(_np((hd,), 99), dtype, cuda)
    pos = _torch_positions(_positions(B, S, decode), decode).to(cuda)
    got = RN.qk_norm_rope_cuda(q, k, qs, ks, pos, THETA)
    want = RN.qk_norm_rope_plain(q, k, qs, ks, pos, THETA)
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 512, 1024), (4, 1, 1024), (1, 512, 5120),
                                   (1, 512, 3584), (4, 1, 3584)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_serving_shapes_on_card(cuda, shape, dtype):
    x, sc = _torch(_np(shape, 100), dtype, cuda), _torch(_np(shape[-1:], 101), dtype, cuda)
    _close(RN.rmsnorm_cuda(x, sc), RN.rmsnorm_plain(x, sc), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("ways", [2, 4, 8])
@pytest.mark.parametrize("shape", [(1, 512, 5120), (4, 1, 5120), (3, 5, 7168),
                                   (1, 2048, 7168), (1, 2048, 5120), (3, 5, 5120)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_row_kernels_vs_plain_on_card(cuda, shape, ways, dtype):
    """Each split-row entry against its plain version on the same column slices,
    the row sums added here in place of the all-reduce, and two runs of each
    bit-equal. 8 ways give local rows of up to 128 16-byte vectors (a lane group a
    row in the row passes), 2 and 4 ways wider ones (a block a row); (3, 5) is a
    ragged row count."""
    y, z, sc, dout = (t.to(cuda) for t in _gated_case(shape, dtype, 130))
    parts = [[c.contiguous() for c in t.chunk(ways, dim=-1)] for t in (y, z, sc, dout)]
    f32 = dtype == "float32"
    ss = sum(RN.gated_rmsnorm_stats_cuda(a, b) for a, b, _, _ in zip(*parts))
    ss_p = sum(_sums_f64(*p)[0] if f32 else RN.gated_rmsnorm_stats_plain(p[0], p[1])
               for p in zip(*parts))
    dot = sum(RN.gated_rmsnorm_split_dot_cuda(*p) for p in zip(*parts))
    dot_p = sum(_sums_f64(*p)[1] if f32 else RN.gated_rmsnorm_split_dot_plain(*p)
                for p in zip(*parts))
    _close(ss, ss_p, dtype)
    _close(dot, dot_p, dtype)
    D = shape[-1]
    for p in zip(*parts):
        runs = [(RN.gated_rmsnorm_stats_cuda(p[0], p[1]),
                 RN.gated_rmsnorm_split_dot_cuda(*p),
                 RN.gated_rmsnorm_split_cuda(p[0], p[1], p[2], ss, D, eps=1e-5),
                 *RN.gated_rmsnorm_split_bwd_cuda(*p, ss, dot, D, eps=1e-5))
                for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        _close(runs[0][2], RN.gated_rmsnorm_split_plain(p[0], p[1], p[2], ss, D, eps=1e-5),
               dtype)
        want = list(RN.gated_rmsnorm_split_bwd_plain(*p, ss, dot, D, eps=1e-5))
        if f32:
            want[2] = _dscale_f64(p[0], p[1], p[3], ss, D, 1e-5)
        for g, w in zip(runs[0][3:], want):
            _close(g, w, dtype)


def _sums_f64(y, z, sc, dout):
    """The split-row row sums (of t^2; of dout * scale * t) in f64 from the gate t
    in y's dtype, as the kernels form and, for f32 inputs, sum them. The plain
    versions sum in f32, whose error passes 1e-5 where dout * scale * t cancels,
    so the f32 kernels are held against these."""
    t = RN._gate(y, z).double()
    return (t * t).sum(dim=-1), (dout.double() * sc.double() * t).sum(dim=-1)


def _dscale_f64(y, z, dout, ss, width, eps):
    """The split-row backward's dscale in f64 from the f32 gate and the given ss,
    as the kernel sums it over the rows (the plain version's f32 sum over 2,048
    rows is off by more than 1e-5)."""
    t = RN._gate(y, z).double()
    rstd = torch.rsqrt(ss.double()[..., None] / width + eps)
    return (dout.double() * t * rstd).reshape(-1, y.shape[-1]).sum(dim=0)


@pytest.mark.parametrize("sms", [1, 7, 8, 9, 114, 132, 144])
def test_split_bwd_scratch_holds_the_grid(sms):
    """The split-row backward's scratch sizing (``split_rows``) against
    csrc/rmsnorm.cu: its finish launches one_block_an_sm's grid (the SM count, cut
    to the rows and to the scratch's rows) and writes one f64 row a block after
    the tickets, so split_rows(sms) holds every block of a card of ``sms`` SMs."""
    src = (RN._build.CSRC / "rmsnorm.cu").read_text()

    def body(head):
        rest = src[src.index(head):]
        return rest[:rest.index("\n}\n")]

    run = body("cudaError_t run_split_bwd(")
    assert "const unsigned blocks = one_block_an_sm(a.rows, max_rows);" in run
    assert "double* rows = scratch + FOLD_COUNTERS / 2;" in run
    assert "long long blocks = sm_count();" in body("unsigned one_block_an_sm(")
    assert RN.split_rows(sms) >= sms
