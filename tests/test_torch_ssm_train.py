"""PyTorch port, ssm training slice: the backward of K3 (the SSD chunked scan) and
of K2's gated_rmsnorm, through their autograd Functions as the CPU runs them (the
plain forward and the plain explicit backward), against the JAX package's
gradients on the same numpy inputs: ``jax.vjp`` of the jnp scan the model runs
(``repro.kernels.ops._ssd_blocked``; the JAX package has no Pallas backward) and
of the JAX sequence ``rmsnorm_ref(y * silu(z.astype(f32)).astype(y.dtype))``
(``src/repro/models/ssm.py``). Then the mamba2 train and eval tasks, with the
checkpoint restored by the JAX trainer. Tolerances are named where they are used.
Tests marked ``cuda`` hold the backward kernels against these plain versions on
the card and skip without one."""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import ssd_scan as SS  # noqa: E402
from repro_torch.runtime.step_cache import run_eval_task, run_train_task  # noqa: E402
from repro_torch.runtime.train_loop import Trainer, TrainJobConfig  # noqa: E402
from repro_torch.tree import tree_flatten_sorted  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401


# twins of tests/test_kernels.py:SSD_SWEEP (B, S, H, P, N, chunk), ragged S included
SSD_SWEEP = [(1, 128, 2, 32, 16, 32), (2, 256, 4, 64, 32, 64), (1, 100, 2, 32, 16, 32)]
# The suite's leaf-gradient tolerance, 1e-4 relative and 1e-6 absolute, with the
# absolute part in units of the gradient's largest element: unit-normal inputs and
# cotangents give scan gradients up to ~800, each element a sum of terms of that
# size, and the two f32 evaluations (this and JAX's) each sit up to ~5e-7 of the
# largest element from the f64 value (measured on these cases).
SSD_GRAD_RTOL, SSD_GRAD_ATOL = 1e-4, 1e-6
# K2's backward tolerances (tests/test_torch_train_kernels.py:NORM_GRAD_TOL)
NORM_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the K2 backward shapes of the dense slice, and mamba2-2.7b's gate width
GATED_SHAPES = [(2, 7, 128), (3, 5, 80), (4, 1, 1024), (2, 3, 5120)]
# the edges of the gated backward kernel's grid at mamba2-2.7b's and zamba2-7b's
# widths (chip_smoke.py:GATED_BWD_EDGES): a single row, rows fewer than the SMs,
# row counts that no team count divides, and the widest f32 row the wrapper takes
GATED_EDGES = [(1, 1, 5120), (1, 1, 7168), (1, 100, 5120), (1, 100, 7168), (1, 2047, 5120),
               (1, 1031, 7168), (1, 3, 8192)]
DTYPES = ["float32", "bfloat16"]


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _scan_inputs(B, S, H, P, N, seed=0):
    """x, dt = softplus(normal), a = -exp(0.2 normal), bm, cm, init_state, and
    the cotangents dy and d(final state); f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0.0).astype(np.float32)
    a = -np.exp(0.2 * rng.standard_normal(H)).astype(np.float32)
    bm, cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dh = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return x, dt, a, bm, cm, h0, dy, dh


def _f32(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close_scaled(got, want, rtol, atol, name=""):
    """|got - want| <= rtol |want| + atol max|want|, element by element."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, name
    assert np.isfinite(g).all(), name
    bound = rtol * np.abs(w) + atol * np.abs(w).max()
    assert (np.abs(g - w) <= bound).all(), \
        f"{name}: worst {np.max(np.abs(g - w) / np.maximum(bound, 1e-30)):.3g} x the tolerance"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ------------------------------------------------------------------ K3 backward
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SWEEP)
@pytest.mark.parametrize("init", [False, True], ids=["zero-init", "init-state"])
@pytest.mark.parametrize("final", [False, True], ids=["y-only", "d-final"])
def test_ssd_scan_bwd_matches_jax_vjp(B, S, H, P, N, chunk, init, final):
    """ssd_scan_bwd_plain against jax.vjp of _ssd_blocked in f32, d(init_state)
    included; and the SSDScan Function (through ops.ssd_scan) gives the same
    bits as the plain backward called directly."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ops as jops
    x, dt, a, bm, cm, h0, dy, dh = _scan_inputs(B, S, H, P, N)
    prim = (x, dt, a, bm, cm) + ((h0,) if init else ())
    out, vjp = jax.vjp(lambda *p: jops._ssd_blocked(*p[:5], chunk, *p[5:]),
                       *(jnp.asarray(v) for v in prim))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh) if final else jnp.zeros_like(out[1])))
    T = torch.from_numpy
    got = SS.ssd_scan_bwd_plain(T(x), T(dt), T(a), T(bm), T(cm), T(h0) if init else None,
                                T(dy), T(dh) if final else None, chunk=chunk)
    assert (got[5] is None) == (not init)
    for name, g, w in zip(("dx", "ddt", "da", "dbm", "dcm", "d_init"), got, want):
        _close_scaled(g, w, SSD_GRAD_RTOL, SSD_GRAD_ATOL, name)

    leaves = [T(v).requires_grad_(True) for v in prim]
    y, h = tops.ssd_scan(*leaves[:5], chunk=chunk, init_state=leaves[5] if init else None,
                         return_state=True)
    assert "SSDScan" in type(y.grad_fn).__name__
    outs, cots = ((y, h), (T(dy), T(dh))) if final else ((y,), (T(dy),))
    via_fn = torch.autograd.grad(outs, leaves, cots)
    for g, f in zip(got, via_fn):
        assert torch.equal(g, f)


def test_ssd_scan_bwd_state_only_cotangent():
    """Only the final state used (the cotangent of y is None): the Function hands
    the backward zeros for dy, as jax.vjp with a zero dy gives."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ops as jops
    x, dt, a, bm, cm, h0, dy, dh = _scan_inputs(1, 100, 2, 32, 16, seed=3)
    out, vjp = jax.vjp(lambda *p: jops._ssd_blocked(*p, 32),
                       *(jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    want = vjp((jnp.zeros_like(out[0]), jnp.asarray(dh)))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x, dt, a, bm, cm)]
    _, h = tops.ssd_scan(*leaves, chunk=32, return_state=True)
    got = torch.autograd.grad(h, leaves, torch.from_numpy(dh))
    for name, g, w in zip(("dx", "ddt", "da", "dbm", "dcm"), got, want):
        _close_scaled(g, w, SSD_GRAD_RTOL, SSD_GRAD_ATOL, name)


def _bwd_by_chunks(x, dt, a, bm, cm, h0, dy, dfin, *, rows: int, heads: int,
                   emulate: bool = False):
    """The bf16 backward kernels' algebra (csrc/ssd_scan.cu) in f64 plain PyTorch,
    at their chunk of ``rows`` rows and ``heads`` heads a gradient block:
    (a) each chunk's local state S_c = B^T diag(w) X and injection
    I_c = C^T diag(exp(cum)) dY; (b) the recurrences h_{c+1} = exp(seg) h_c + S_c
    and dh_{c-1} = exp(seg) dh_c + I_c; (c) per chunk and head, from h_c and dh_c,
    the gradients, with dB and dC summed over each group of ``heads`` heads and
    then over the groups, and dcum, its reverse cumsum and d(seg) formed inside the
    chunk (dy.y and x.dxs from the row and column sums of G o W', and the state
    terms C.(dY h^T), B.(X dh^T)). Returns what ssd_scan_bwd_plain returns.
    With ``emulate``, the kernels' roundings: each product's and walk's result
    rounded to f32, and each f32 operand of a product (w x, exp(cum) dy, h_c,
    dh_c, S', W) entering as a bf16 hi + lo pair."""
    f64, F = torch.float64, torch.nn.functional

    def f32(v):
        return v.float().double() if emulate else v

    def pair(v):
        if not emulate:
            return v
        hi = v.to(torch.bfloat16).double()
        return hi + (v - hi).to(torch.bfloat16).double()

    B, S, H, P = x.shape
    N = bm.shape[-1]
    Q, pad = rows, (-S) % rows
    x, dy = (F.pad(t.to(f64), (0, 0, 0, 0, 0, pad)) for t in (x, dy))
    dt = F.pad(dt.to(f64), (0, 0, 0, pad))
    bm, cm = (F.pad(t.to(f64), (0, 0, 0, pad)) for t in (bm, cm))
    nc = (S + pad) // Q
    x, dy = (t.reshape(B, nc, Q, H, P) for t in (x, dy))
    dt = dt.reshape(B, nc, Q, H)
    bm, cm = (t.reshape(B, nc, Q, N) for t in (bm, cm))
    a = a.to(f64)
    cum = f32(torch.cumsum(dt * a, 2))                              # [B,nc,Q,H]
    seg = cum[:, :, -1]
    ecum, eout = torch.exp(cum), torch.exp(seg[:, :, None] - cum)
    w = eout * dt
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    L = torch.exp(torch.where(tri[None, None, :, :, None],
                              cum[:, :, :, None] - cum[:, :, None], -torch.inf))
    # (a) the chunk-local terms, (b) the two recurrences over [N, P]
    local = torch.einsum("bcjn,bcjhp->bchnp", bm, pair(w[..., None] * x))
    inject = torch.einsum("bcin,bcihp->bchnp", cm, pair(ecum[..., None] * dy))
    h = torch.zeros(B, H, N, P, dtype=f64) if h0 is None else h0.to(f64)
    dh = torch.zeros(B, H, N, P, dtype=f64) if dfin is None else dfin.to(f64)
    hs, dhs = [], [None] * nc
    for c in range(nc):
        hs.append(h)
        h = f32(torch.exp(seg[:, c])[..., None, None] * h + local[:, c])
    for c in reversed(range(nc)):
        dhs[c] = dh
        dh = f32(torch.exp(seg[:, c])[..., None, None] * dh + inject[:, c])
    hs, dhs = pair(torch.stack(hs, 1)), pair(torch.stack(dhs, 1))   # [B,nc,H,N,P]
    # (c) the gradients of each chunk and head
    G = f32(torch.einsum("bcin,bcjn->bcij", cm, bm))
    Wp = L * f32(torch.einsum("bcihp,bcjhp->bcijh", dy, x))         # W' = L o (dY X^T)
    W = Wp * dt[:, :, None]                                         # W_ij = W'_ij dt_j
    dxs = (torch.einsum("bcijh,bcihp->bcjhp", pair(G[..., None] * L), dy)
           + eout[..., None] * torch.einsum("bcjn,bchnp->bcjhp", bm, dhs))
    dyh = f32(torch.einsum("bcihp,bchnp->bcihn", dy, hs))           # dY h^T
    xdh = f32(torch.einsum("bcjhp,bchnp->bcjhn", x, dhs))           # X dh^T
    dc_h = torch.einsum("bcijh,bcjn->bcihn", pair(W), bm) + ecum[..., None] * dyh
    db_h = torch.einsum("bcijh,bcin->bcjhn", pair(W), cm) + w[..., None] * xdh
    groups = range(0, H, heads)
    dcm = sum(dc_h[:, :, :, g:g + heads].sum(3) for g in groups)
    dbm = sum(db_h[:, :, :, g:g + heads].sum(3) for g in groups)
    r3 = f32(torch.einsum("bcjn,bcjhn->bcjh", bm, xdh))
    dyy = (f32((G[..., None] * W).sum(3))
           + ecum * f32(torch.einsum("bcin,bcihn->bcih", cm, dyh)))
    xdxs = f32((G[..., None] * Wp).sum(2)) + eout * r3
    dcum = dyy - dt * xdxs
    dcum[:, :, -1] += torch.exp(seg) * (hs * dhs).sum((-2, -1)) + (w * r3).sum(2)
    rc = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])

    def cut(v):
        return v.reshape((B, nc * Q) + v.shape[3:])[:, :S]

    return (cut(dt[..., None] * dxs), cut(xdxs + a * rc), (dt * rc).sum((0, 1, 2)), cut(dbm),
            cut(dcm), None if h0 is None else dh)


# the shapes the bf16 backward kernels add to the sweep: a ragged S, H not a
# multiple of their 10 heads a block, and zamba2's N = 64
SSD_BWD_SHAPES = [(1, 200, 14, 64, 128, 256), (2, 130, 6, 64, 64, 256)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SWEEP + SSD_BWD_SHAPES)
@pytest.mark.parametrize("init", [False, True], ids=["zero-init", "init-state"])
def test_ssd_scan_bwd_chunk_parallel_algebra(B, S, H, P, N, chunk, init):
    """The bf16 backward kernels' decomposition (64-row chunks, 10 heads a block),
    written out in f64, against ssd_scan_bwd_plain at the model's chunk in f64:
    the same gradient up to f64 rounding (1e-12 of each output's largest element;
    the two differ by ~1e-14 on these shapes)."""
    x, dt, a, bm, cm, h0, dy, dh = (torch.from_numpy(v).double()
                                    for v in _scan_inputs(B, S, H, P, N, seed=7))
    args = (x, dt, a, bm, cm, h0 if init else None, dy, dh if init else None)
    got = _bwd_by_chunks(*args, rows=64, heads=10)
    want = SS.ssd_scan_bwd_plain(*args, chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "da", "dbm", "dcm", "d_init"), got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            _close_scaled(g, w, 0.0, 1e-12, name)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SWEEP + SSD_BWD_SHAPES)
@pytest.mark.parametrize("init", [False, True], ids=["zero-init", "init-state"])
def test_ssd_scan_bwd_bf16_roundings_hold_the_gates(B, S, H, P, N, chunk, init):
    """The bf16 kernels' roundings, emulated in their algebra on bf16 inputs (and
    dx, dB, dC rounded to bf16 as the kernels write them), within the gates the
    card holds them to (SSD_CARD_TOL below) against the plain version in f64; dA
    within 4 times the plain version's own f32 distance plus the share."""
    x, dt, a, bm, cm, h0, dy, dh = (torch.from_numpy(v).double()
                                    for v in _scan_inputs(B, S, H, P, N, seed=9))
    x, bm, cm, dy = (t.to(torch.bfloat16).double() for t in (x, bm, cm, dy))
    args = (x, dt, a, bm, cm, h0 if init else None, dy, dh if init else None)
    got = list(_bwd_by_chunks(*args, rows=64, heads=10, emulate=True))
    for i in (0, 3, 4):
        got[i] = got[i].to(torch.bfloat16)
    want = SS.ssd_scan_bwd_plain(*args, chunk=chunk)
    plain_da = SS.ssd_scan_bwd_plain(*(None if t is None else t.float() for t in args),
                                     chunk=chunk)[2]
    rtol, share = SSD_CARD_TOL["bfloat16"]
    for name, g, w in zip(("dx", "ddt", "da", "dbm", "dcm", "d_init"), got, want):
        if w is None:
            continue
        if name == "da":
            err, plain_err = (float((t.double() - w).abs().max()) for t in (g, plain_da))
            assert err <= 4 * plain_err + share * float(w.abs().max())
        else:
            _close_scaled(g, w, rtol, share, name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_bwd_keeps_dtypes(dtype):
    """dx, dbm and dcm in x's dtype; ddt, da and d(init_state) in f32, as the
    inputs' dtypes are (the model passes bf16 conv outputs and f32 dt, a)."""
    x, dt, a, bm, cm, h0, dy, dh = _scan_inputs(1, 40, 2, 32, 16, seed=4)
    dt_ = getattr(torch, dtype)
    got = SS.ssd_scan_bwd_plain(
        torch.from_numpy(x).to(dt_), torch.from_numpy(dt), torch.from_numpy(a),
        torch.from_numpy(bm).to(dt_), torch.from_numpy(cm).to(dt_), torch.from_numpy(h0),
        torch.from_numpy(dy).to(dt_), torch.from_numpy(dh), chunk=32)
    assert [g.dtype for g in got] == [dt_, torch.float32, torch.float32, dt_, dt_,
                                      torch.float32]
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)


# ------------------------------------------------------------- gated norm backward
@pytest.mark.parametrize("shape", GATED_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_rmsnorm_bwd_matches_jax_grad(shape, dtype):
    """The JAX sequence of models/ssm.py: y * silu(z.astype(f32)).astype(y.dtype),
    then ref.rmsnorm_ref; through the GatedRMSNorm Function and the plain
    backward called directly."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ref as jref
    y, z, dout = (2 * _np(shape, s) for s in (1, 2, 3))
    sc = _np(shape[-1:], 4)

    def seq(y_, z_, s_):
        return jref.rmsnorm_ref(y_ * jax.nn.silu(z_.astype(jnp.float32)).astype(y_.dtype), s_)

    _, vjp = jax.vjp(seq, *(jnp.asarray(v).astype(dtype) for v in (y, z, sc)))
    want = vjp(jnp.asarray(dout).astype(dtype))
    tt = [torch.from_numpy(v).to(getattr(torch, dtype)) for v in (y, z, sc, dout)]
    direct = RN.gated_rmsnorm_bwd_plain(*tt)
    leaves = [t.clone().requires_grad_(True) for t in tt[:3]]
    out = tops.gated_rmsnorm(*leaves)
    assert "GatedRMSNorm" in type(out.grad_fn).__name__
    via_fn = torch.autograd.grad(out, leaves, tt[3])
    tol = NORM_GRAD_TOL[dtype]
    for g, f, w in zip(direct, via_fn, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_f32(g), np.asarray(w, np.float32), rtol=tol, atol=tol)
        assert torch.equal(g, f)


@pytest.mark.parametrize("sms", [1, 7, 8, 9, 114, 132, 144])
def test_gated_bwd_scratch_holds_the_grid(sms):
    """The backward scratch's sizing (kernels/rmsnorm.py) against csrc/rmsnorm.cu.
    The gated backward's row pass runs at most one block an SM (its grid is the
    SM count, cut to the rows and to the scratch's rows) and writes one f64 row a
    block after the tickets: gated_rows(sms) holds every block of a card of
    ``sms`` SMs. The other backward kernels fold through one row a block of at
    most blocks and one a group of ceil(sqrt(blocks)) blocks: fold_rows holds
    them."""
    src = (RN._build.CSRC / "rmsnorm.cu").read_text()
    assert "long long blocks = sm_count();" in src
    assert "double* rows = scratch + FOLD_COUNTERS / 2;" in src
    counters = int(re.search(r"constexpr int FOLD_COUNTERS = (\d+);", src).group(1))
    assert RN._TICKETS == counters // 2
    assert RN.gated_rows(sms) >= sms
    for blocks in (sms, 8 * sms):
        group = math.ceil(math.sqrt(blocks))
        assert RN.fold_rows(blocks) >= blocks + -(-blocks // group)


# ------------------------------------------------------ train task -> eval task
def test_mamba2_train_eval_tasks_and_jax_trainer_restore(tmp_path):
    """The ssm family through run_train_task (checkpoints every 2 of 4 steps) and
    a strict run_eval_task restore on the CPU; the JAX trainer of the same job
    restores that checkpoint bit for bit and scores the eval batch within the
    bf16 loss tolerance (0.02, tests/test_torch_train.py:BF16_LOSS_TOL)."""
    jax = pytest.importorskip("jax")
    from repro.runtime.train_loop import Trainer as JTrainer
    from repro.runtime.train_loop import TrainJobConfig as JCfg
    job = {"arch": "mamba2-2.7b", "seq_len": 40, "global_batch": 2}
    payload = dict(job, steps=4, checkpoint_every=2, checkpoint_dir=str(tmp_path),
                   device="cpu")
    res = run_train_task(None, payload)
    assert res["steps"] == 4 and res["ran_steps"] == 4 and np.isfinite(res["loss"])
    assert res["checkpoint"] == {"step": 4, "path": str(tmp_path)}
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000002",
                                                                "step_00000004"]
    ev = run_eval_task(None, dict(job, device="cpu", restore_from=res["checkpoint"]))
    assert ev["restored_step"] == 4 and np.isfinite(ev["eval_loss"])

    port = Trainer(TrainJobConfig(device="cpu", **job))
    assert port.restore(res["checkpoint"], strict=True) == 4
    with torch.no_grad():
        own, _ = port.model.loss_fn(port.params_for_eval(), port._sync_batch(10_000))
    assert float(own) == ev["eval_loss"]
    from jax.sharding import AxisType, Mesh
    mesh = Mesh(np.array(jax.devices()).reshape(1, -1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)     # as tests/test_torch_train.py builds it
    jt = JTrainer(JCfg(**job), mesh=mesh)
    assert jt.restore(res["checkpoint"], strict=True) == 4
    mine = dict(tree_flatten_sorted(port.state))
    theirs = jax.tree_util.tree_flatten_with_path(jt.state)[0]
    assert len(theirs) == len(mine)
    for path, leaf in theirs:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        t = mine[key]
        a = np.asarray(leaf)
        b = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        assert np.array_equal(a.view(np.int16) if t.dtype == torch.bfloat16 else a, b), key
    batch = {k: jax.numpy.asarray(v.float().numpy() if k == "loss_mask" else v.numpy())
             for k, v in port.data.global_batch_at(10_000).items()}
    batch["loss_mask"] = batch["loss_mask"].astype(jax.numpy.bfloat16)
    jloss, _ = jt.model.loss_fn(jt.params_for_eval(), batch)
    np.testing.assert_allclose(float(jloss), ev["eval_loss"], rtol=0.02, atol=0.02)


# ------------------------------------------------------------------ on the card
# gates of the kernel against the plain version evaluated in f64 (the exact value
# at these inputs; bf16 values are exact in f64), as chip_smoke.py holds it: 1e-4
# relative and 1e-5 of the largest element in f32 (sums of up to S terms of that
# size, in another order and chunking); one bf16 rounding of the output (2^-8
# relative, with margin) and the same summation term in bf16. dA sums B*S terms
# that cancel, so the plain version's own f32 evaluation of it misses the f64 value
# by up to 1.5x the f32 gate: dA is held at 4 times the plain version's distance
# from the f64 value, plus the share.
SSD_CARD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-5)}


def _f64(t):
    return t.double() if t is not None and t.is_floating_point() else t


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SWEEP + SSD_BWD_SHAPES
                         + [(1, 2048, 112, 64, 64, 256)])   # zamba2-7b's training scan
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_bwd_kernel_matches_plain_on_card(cuda, B, S, H, P, N, chunk, dtype):
    """With and without init_state and d(final state); twice in a row, bit-equal."""
    x, dt, a, bm, cm, h0, dy, dh = (torch.from_numpy(v).to(cuda)
                                    for v in _scan_inputs(B, S, H, P, N, seed=5))
    x, bm, cm, dy = (t.to(getattr(torch, dtype)) for t in (x, bm, cm, dy))
    for init, final in ((None, None), (h0, dh)):
        args = (x, dt, a, bm, cm, init, dy, final)
        got = SS.ssd_scan_bwd_cuda(*args, chunk=chunk)
        again = SS.ssd_scan_bwd_cuda(*args, chunk=chunk)
        want = SS.ssd_scan_bwd_plain(*(_f64(t) for t in args), chunk=chunk)
        plain_da = SS.ssd_scan_bwd_plain(*args, chunk=chunk)[2]
        for name, g, w, r in zip(("dx", "ddt", "da", "dbm", "dcm", "d_init"), got, want,
                                 again):
            assert torch.equal(g, r) if w is not None else g is None, name
            if name == "da":
                err, plain_err = (float((t.double() - w).abs().max()) for t in (g, plain_da))
                assert err <= 4 * plain_err + SSD_CARD_TOL[dtype][1] * float(w.abs().max())
            elif w is not None:
                _close_scaled(g, w, *SSD_CARD_TOL[dtype], name)


@pytest.mark.cuda
def test_ssd_scan_bwd_bf16_kernel_is_deterministic_on_card(cuda):
    """Two bf16 runs give the same bits, at a size with many chunks, two head
    groups (one partial) and a ragged last chunk: every cross-block sum (dB, dC
    over head groups, dA over chunks) is taken in a fixed order."""
    x, dt, a, bm, cm, h0, dy, dh = (torch.from_numpy(v).to(cuda)
                                    for v in _scan_inputs(2, 1000, 14, 64, 128, seed=8))
    x, bm, cm, dy = (t.to(torch.bfloat16) for t in (x, bm, cm, dy))
    args = (x, dt, a, bm, cm, h0, dy, dh)
    first = SS.ssd_scan_bwd_cuda(*args, chunk=256)
    for _ in range(2):
        for name, g, r in zip(("dx", "ddt", "da", "dbm", "dcm", "d_init"), first,
                              SS.ssd_scan_bwd_cuda(*args, chunk=256)):
            assert torch.equal(g, r), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_bwd_kernel_reads_conv_views_on_card(cuda, dtype):
    """x, B and C as the model passes them, slices of one conv output: the same
    bits as on contiguous copies."""
    B, S, H, P, N = 2, 100, 4, 32, 16
    x, dt, a, bm, cm, _, dy, _ = (torch.from_numpy(v).to(cuda)
                                  for v in _scan_inputs(B, S, H, P, N, seed=6))
    dtp = getattr(torch, dtype)
    conv = torch.cat([x.reshape(B, S, H * P), bm, cm], dim=-1).to(dtp)
    views = (conv[..., :H * P].reshape(B, S, H, P), conv[..., H * P:H * P + N],
             conv[..., H * P + N:])
    copies = tuple(v.contiguous() for v in views)
    on_views = SS.ssd_scan_bwd_cuda(views[0], dt, a, views[1], views[2], None, dy.to(dtp),
                                    None, chunk=32)
    on_copies = SS.ssd_scan_bwd_cuda(copies[0], dt, a, copies[1], copies[2], None, dy.to(dtp),
                                     None, chunk=32)
    for g, w in zip(on_views[:5], on_copies[:5]):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GATED_SHAPES + [(1, 2048, 5120), (1, 2048, 7168)]
                         + GATED_EDGES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_rmsnorm_bwd_kernel_matches_plain_on_card(cuda, shape, dtype):
    """f32 against the gradient in f64 from the forward's f32 gate (the kernel sums
    dscale in f64 over that gate; one formed in f64 differs by an f32 rounding in
    every element); bf16 against the plain version. Two launches bit-equal."""
    y, z, dout = (torch.from_numpy(2 * _np(shape, s)).to(cuda).to(getattr(torch, dtype))
                  for s in (1, 2, 3))
    sc = torch.from_numpy(_np(shape[-1:], 4)).to(cuda).to(getattr(torch, dtype))
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]     # K2's forward tolerances
    got = RN.gated_rmsnorm_bwd_cuda(y, z, sc, dout)
    again = RN.gated_rmsnorm_bwd_cuda(y, z, sc, dout)
    if dtype == "float32":   # in f64 from the forward's own f32 gate, as the kernel sums
        silu = torch.nn.functional.silu(z)
        dt, dscale = RN.rmsnorm_bwd_plain((y * silu).double(), sc.double(), dout.double())
        sig = torch.sigmoid(z.double())
        want = (dt * silu.double(), dt * y.double() * sig * (1 + z.double() * (1 - sig)),
                dscale)
    else:
        want = RN.gated_rmsnorm_bwd_plain(y, z, sc, dout)
    for g, w, r in zip(got, want, again):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=tol, atol=tol)
        assert torch.equal(g, r)
