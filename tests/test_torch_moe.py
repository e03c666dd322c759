"""PyTorch port, MoE slice: reduced deepseek-moe-16b (64 -> 8 experts, top-2, 2
shared experts, MHA) and qwen3-moe-235b-a22b (128 -> 8 experts, top-2, no shared
expert, GQA, qk-norm) on ``device="cpu"`` (the kernels' plain versions) against the
JAX package on the same converted params and numpy inputs: the router, the
load-balance loss, the capacity dispatch (``moe_block``, with drops at capacity
1.25 and none at 8.0), the dense all-experts decode (``moe_block_decode``), the
model's forward, prefill cache and decode steps, ``cache_defs``, ``loss_fn`` with
every leaf's gradient, one train step, and the serve and train tasks; plus twins
of ``tests/test_moe_routing.py`` on the port.

Tolerances: f32 1e-4 (tests/test_torch_model.py's F32_TOL: the same ops in another
summation order), bf16 0.08 + 0.08|x| (tests/test_models_smoke.py's). The router's
top-k indices are compared exactly before any output, so that a near-tie that
flips an expert is reported as a flip (with the smallest gap between the k-th and
(k+1)-th probability over the batch, which is printed). The model-level cases run
at capacity 8.0, as tests/test_models_smoke.py does for prefill and decode
against forward: prefill's dispatch drops tokens past capacity and decode's dense
path drops none, so they agree only where nothing is dropped. ``loss_fn`` and the
train step run at the configs' own capacity 1.25, so the drop path is
differentiated. The JAX reference is built on an Auto-axis mesh, as in
tests/test_torch_model.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import train_state_to_torch  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.params import param_defs as t_param_defs  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime.serve_loop import Server, ServeJobConfig  # noqa: E402
from repro_torch.runtime.step_cache import (ServerCache, run_serve_task,  # noqa: E402
                                            run_train_task)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_model import (BF16_TOL, F32_TOL, _converted, _f32, _jax,  # noqa: E402
                              _jax_model, _tokens)
from test_torch_train import (BF16_LOSS_TOL, LOSS_TOL, MASTER_TOL, MOMENT_TOL,  # noqa: E402
                              OPT, _batch, _jbatch, _named, _np_tree, _tbatch)
from test_torch_model import _one_torch_thread  # noqa: E402,F401


ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
DTYPES = ["float32", "bfloat16"]
CASES = [(a, d) for a in ARCHS for d in DTYPES]
CASE_IDS = [f"{a}-{d}" for a, d in CASES]
HIGH_CAP = 8.0          # tests/test_models_smoke.py's capacity for prefill/decode
B, PROMPT, STEPS = 2, 24, 8
BLOCK_S = 32            # moe_block's sequence: 64 assignments a row over 8 experts
# full-width parameter counts (from param_defs): deepseek-moe-16b at its 28 layers
# and cut to 4 (the card's training depth); qwen3-moe-235b-a22b cut to 2 layers
FULL_PARAMS = {("deepseek-moe-16b", None): 16_879_568_896,
               ("deepseek-moe-16b", 4): 2_770_880_512,
               ("qwen3-moe-235b-a22b", 2): 6_220_173_824}


def _cfg(arch, **overrides):
    return dataclasses.replace(tconfigs.get(arch).reduced(), remat="none", **overrides)


def _tmodel(arch, **overrides):
    return TM.Model(_cfg(arch, **overrides), "cpu")


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol, err_msg=msg)


def _pair(arch, seed=0, **overrides):
    """(JAX model, port model, JAX params, the same params converted)."""
    jax = _jax()
    jm, tm = _jax_model(arch, **overrides), _tmodel(arch, **overrides)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jm, tm, jp, _converted(jp)


def _layer0(jp, tp):
    """Layer 0's MoE params in each package."""
    jax = _jax()
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"]),
            tree_map(lambda t: t[0], tp["layers"]["moe"]))


def _x(shape, dtype, seed):
    """The same activations in both packages (f32 numpy, rounded to bf16 alike)."""
    jnp = _jax().numpy
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(getattr(jnp, dtype)), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _drops(idx, E, C):
    """Assignments past capacity C, over the batch rows of idx [B, S, K]."""
    idx = np.asarray(idx).reshape(idx.shape[0], -1)
    return int(sum(np.maximum(np.bincount(row, minlength=E) - C, 0).sum() for row in idx))


def _same_experts(got_idx, want_idx, probs, k, msg=""):
    """The top-k indices, exactly; on a flip, the smallest k-th/(k+1)-th gap."""
    got, want = np.asarray(got_idx), np.asarray(want_idx)
    srt = np.sort(_f32(probs), axis=-1)[..., ::-1]
    gap = float((srt[..., k - 1] - srt[..., k]).min())
    print(f"\n{msg}: smallest gap between the {k}-th and {k + 1}-th probability {gap:.3g}")
    flips = np.argwhere((got != want).any(-1))
    assert not len(flips), f"{msg}: router flips at {flips.tolist()} (smallest gap {gap:.3g})"


# ------------------------------------------------------- twins of test_moe_routing.py
@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_and_normalization(arch):
    cfg = _cfg(arch)
    p0 = tree_map(lambda t: t[0], TM.Model(cfg, "cpu").init_params(0)["layers"]["moe"])
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1)).bfloat16()
    w, idx, probs = TMOE.router_probs(cfg, p0, x)
    assert idx.shape == w.shape == (2, 8, cfg.top_k)
    assert probs.shape == (2, 8, cfg.num_experts)
    np.testing.assert_allclose(w.sum(-1).numpy(), np.ones((2, 8)), rtol=1e-2, atol=1e-2)
    assert all(len(set(row)) == cfg.top_k for row in idx.reshape(-1, cfg.top_k).tolist())


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_penalizes_imbalance(arch):
    """Balanced probabilities with each token's K experts the same give K; all
    mass on expert 0 gives E*K. The JAX package's values, to f32 rounding."""
    jnp = _jax().numpy
    from repro.models import moe as JMOE
    cfg = _cfg(arch)
    E, K = cfg.num_experts, cfg.top_k
    bal = np.full((2, 8, E), 1.0 / E, np.float32)
    idx_bal = np.tile(np.arange(K)[None, None], (2, 8, 1))
    col = np.zeros((2, 8, E), np.float32)
    col[..., 0] = 1.0
    idx_col = np.zeros((2, 8, K), np.int64)
    got = [float(TMOE.aux_load_balance_loss(cfg, torch.from_numpy(p), torch.from_numpy(i)))
           for p, i in ((bal, idx_bal), (col, idx_col))]
    want = [float(JMOE.aux_load_balance_loss(cfg, jnp.asarray(p), jnp.asarray(i)))
            for p, i in ((bal, idx_bal), (col, idx_col))]
    assert got[1] > got[0] * 2
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, [K, E * K], rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_tokens_gracefully(arch):
    """A tiny capacity drops tokens (output != high capacity) but stays finite."""
    hi = _tmodel(arch, capacity_factor=HIGH_CAP)
    lo = _tmodel(arch, capacity_factor=0.05)
    params = hi.init_params(0)
    toks = {"tokens": torch.from_numpy(_tokens(hi.cfg.vocab_size, 2, 16, 2))}
    y_hi, _ = hi.forward(params, toks)
    y_lo, _ = lo.forward(params, toks)
    assert torch.isfinite(y_lo.float()).all()
    assert not np.allclose(_f32(y_hi), _f32(y_lo), atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_matches_block_at_high_capacity(arch):
    cfg = _cfg(arch, capacity_factor=HIGH_CAP)
    p0 = tree_map(lambda t: t[0], TM.Model(cfg, "cpu").init_params(0)["layers"]["moe"])
    x = torch.randn((4, 1, cfg.d_model), generator=torch.Generator().manual_seed(3)).bfloat16()
    y_block, _ = TMOE.moe_block(cfg, p0, x)
    y_dec = TMOE.moe_block_decode(cfg, p0, x)
    np.testing.assert_allclose(_f32(y_block), _f32(y_dec), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_combine_reshard_is_numerically_identical(arch):
    """The JAX package's ``moe_combine_reshard`` is a layout hint: its outputs are
    bit-equal with it on and off, and the port, which has no such layout on one
    card, matches both."""
    from repro.models import moe as JMOE
    jm, _, jp, tp = _pair(arch, capacity_factor=2.0)
    jp0, tp0 = _layer0(jp, tp)
    jx, tx = _x((2, 8, jm.cfg.d_model), "bfloat16", 5)
    y1, aux1 = JMOE.moe_block(jm.cfg, jp0, jx, jm.plan)
    y2, aux2 = JMOE.moe_block(jm.cfg, jp0, jx,
                              dataclasses.replace(jm.plan, moe_combine_reshard=True))
    np.testing.assert_array_equal(_f32(y1), _f32(y2))
    assert float(aux1) == float(aux2)
    got, aux = TMOE.moe_block(jm.cfg, tp0, tx)
    _close(got, y2, BF16_TOL)
    _close(aux, aux2, F32_TOL)


# ---------------------------------------------------------- the module, on one layer
@pytest.mark.parametrize("arch,dtype", CASES, ids=CASE_IDS)
def test_router_probs_matches_jax(arch, dtype):
    """Indices exactly, then weights and probabilities."""
    from repro.models import moe as JMOE
    jm, _, jp, tp = _pair(arch, dtype=dtype)
    jp0, tp0 = _layer0(jp, tp)
    jx, tx = _x((B, BLOCK_S, jm.cfg.d_model), dtype, 7)
    jw, ji, jpr = JMOE.router_probs(jm.cfg, jp0, jx)
    tw, ti, tpr = TMOE.router_probs(jm.cfg, tp0, tx)
    _same_experts(ti, ji, jpr, jm.cfg.top_k, f"{arch} {dtype} router")
    assert tw.dtype == tpr.dtype == torch.float32
    _close(tw, jw, F32_TOL, "weights")
    _close(tpr, jpr, F32_TOL, "probs")


@pytest.mark.parametrize("arch,dtype", CASES, ids=CASE_IDS)
def test_aux_load_balance_loss_matches_jax(arch, dtype):
    """On the same router outputs (the JAX package's), and on each package's own."""
    jnp = _jax().numpy
    from repro.models import moe as JMOE
    jm, _, jp, tp = _pair(arch, dtype=dtype)
    jp0, tp0 = _layer0(jp, tp)
    jx, tx = _x((B, BLOCK_S, jm.cfg.d_model), dtype, 8)
    _, ji, jpr = JMOE.router_probs(jm.cfg, jp0, jx)
    want = JMOE.aux_load_balance_loss(jm.cfg, jpr, ji)
    same = TMOE.aux_load_balance_loss(jm.cfg, torch.from_numpy(np.array(jpr)),
                                      torch.from_numpy(np.array(ji, np.int64)))
    _, ti, tpr = TMOE.router_probs(jm.cfg, tp0, tx)
    own = TMOE.aux_load_balance_loss(jm.cfg, tpr, ti)
    assert jnp.isfinite(want) and float(want) > 1.0
    _close(same, want, F32_TOL)
    _close(own, want, F32_TOL)


@pytest.mark.parametrize("capacity", [1.25, HIGH_CAP])
@pytest.mark.parametrize("arch,dtype", CASES, ids=CASE_IDS)
def test_moe_block_matches_jax(arch, dtype, capacity):
    """The capacity dispatch on [2, 32] tokens: at 1.25 (capacity 10 a row for 64
    assignments over 8 experts) some assignments are dropped, at 8.0 none; the
    outputs and aux match either way."""
    from repro.models import moe as JMOE
    jm, _, jp, tp = _pair(arch, dtype=dtype, capacity_factor=capacity)
    jp0, tp0 = _layer0(jp, tp)
    cfg = jm.cfg
    jx, tx = _x((B, BLOCK_S, cfg.d_model), dtype, 9)
    want, jaux = JMOE.moe_block(cfg, jp0, jx, jm.plan)
    got, taux = TMOE.moe_block(cfg, tp0, tx)
    _, ji, jpr = JMOE.router_probs(cfg, jp0, jx)
    _, ti, _ = TMOE.router_probs(cfg, tp0, tx)
    _same_experts(ti, ji, jpr, cfg.top_k, f"{arch} {dtype} moe_block")
    C = max(int(BLOCK_S * cfg.top_k * capacity / cfg.num_experts), cfg.top_k)
    drops = _drops(ti, cfg.num_experts, C)
    assert (drops > 0) == (capacity < 2), f"{drops} assignments dropped at capacity {C}"
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == tuple(want.shape)
    _close(got, want, _tol(dtype), "y")
    _close(taux, jaux, F32_TOL, "aux")


@pytest.mark.parametrize("arch,dtype", CASES, ids=CASE_IDS)
def test_moe_block_decode_matches_jax(arch, dtype):
    """The dense all-experts decode on 4 single-token rows."""
    from repro.models import moe as JMOE
    jm, _, jp, tp = _pair(arch, dtype=dtype)
    jp0, tp0 = _layer0(jp, tp)
    jx, tx = _x((4, 1, jm.cfg.d_model), dtype, 10)
    want = JMOE.moe_block_decode(jm.cfg, jp0, jx, jm.plan)
    got = TMOE.moe_block_decode(jm.cfg, tp0, tx)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (4, 1, jm.cfg.d_model)
    _close(got, want, _tol(dtype))


# --------------------------------------------------------------------- the model
@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def moe_run(request):
    """(dtype, model, {stage: (jax, port)}) at capacity 8.0: forward logits and aux,
    the prefill's last logits and cache, and teacher-forced decode steps' logits
    and caches (each step's leaves copied, since the port writes in place)."""
    jax = _jax()
    jnp = jax.numpy
    arch, dtype = request.param
    jm, tm, jp, tp = _pair(arch, dtype=dtype, capacity_factor=HIGH_CAP)
    toks = _tokens(jm.cfg.vocab_size, B, PROMPT + STEPS, 1)
    max_len = PROMPT + STEPS + 2
    out = {}
    out["forward"] = (jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)}),
                      tm.forward(tp, {"tokens": torch.from_numpy(toks)}))
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))(
        jp, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :PROMPT])}, max_len=max_len)
    out["prefill"] = (jl, tl)
    out["prefill cache"] = (jc, tree_map(lambda t: t.clone(), tc))
    decode = jax.jit(jm.decode_step)
    steps = []
    for i in range(STEPS):
        step = toks[:, PROMPT + i:PROMPT + i + 1]
        jl, jc = decode(jp, jnp.asarray(step), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(step), tc)
        steps.append((jl, tl, jc, tree_map(lambda t: t.clone(), tc)))
    out["decode"] = steps
    return dtype, tm, out


def test_forward_matches_jax(moe_run):
    """Logits, and aux: the sum of the layers' load-balance losses, finite and
    above 1 (a layer's is about K when balanced)."""
    dtype, tm, out = moe_run
    (jl, jaux), (tl, taux) = out["forward"]
    assert tl.dtype == getattr(torch, dtype) and tuple(tl.shape) == tuple(jl.shape)
    _close(tl, jl, _tol(dtype), "logits")
    assert taux.dtype == torch.float32 and torch.isfinite(taux) and float(taux) > 1.0
    # bf16: aux is an f32 function of bf16 hidden states, held as a bf16 loss is
    # (tests/test_torch_train.py's BF16_LOSS_TOL)
    _close(taux, jaux, F32_TOL if dtype == "float32" else BF16_LOSS_TOL, "aux")


def test_prefill_matches_jax(moe_run):
    """The last logits, and the cache {"pos", "layers": ({"k", "v": [L, B, max_len,
    K, hd]},)} leaf by leaf, zero past the prompt."""
    dtype, tm, out = moe_run
    jl, tl = out["prefill"]
    _close(tl, jl, _tol(dtype), "prefill logits")
    jc, tc = out["prefill cache"]
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [PROMPT] * B
    for n in ("k", "v"):
        got, want = tc["layers"][0][n], jc["layers"][0][n]
        assert tuple(got.shape) == tuple(want.shape) == (tm.cfg.num_layers, B,
                                                         PROMPT + STEPS + 2,
                                                         tm.cfg.num_kv_heads,
                                                         tm.cfg.head_dim)
        _close(got, want, _tol(dtype), n)
        assert not got[:, :, PROMPT:].any()


def test_decode_steps_match_jax(moe_run):
    """Teacher-forced decode steps through the dense all-experts path: each step's
    logits and the cache."""
    dtype, _, out = moe_run
    for i, (jl, tl, jc, tc) in enumerate(out["decode"]):
        _close(tl, jl, _tol(dtype), f"decode step {i} logits")
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [PROMPT + i + 1] * B
        for n in ("k", "v"):
            _close(tc["layers"][0][n], jc["layers"][0][n], _tol(dtype), f"step {i} {n}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Twin of tests/test_models_smoke.py's, inside the port, at capacity 8.0:
    decode(prefill(t[:k]), t[k]) logits == forward(t[:k+1]) last logits."""
    model = _tmodel(arch, capacity_factor=HIGH_CAP)
    params = model.init_params(0)
    S = 16
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, 2, S, 3))
    k = S - 1
    logits_full, _ = model.forward(params, {"tokens": toks})
    last, cache = model.prefill(params, {"tokens": toks[:, :k]}, max_len=S + 4)
    _close(last, logits_full[:, k - 1], BF16_TOL, "prefill")
    step, cache = model.decode_step(params, toks[:, k:k + 1], cache)
    _close(step, logits_full[:, k], BF16_TOL, "decode")
    assert cache["pos"].tolist() == [S] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_defs_match_jax(arch):
    """The dense stack's cache declaration; the Server finds the batch axis."""
    _jax()
    jm, tm = _jax_model(arch), _tmodel(arch)
    got, want = tm.cache_defs(3, 17), jm.cache_defs(3, 17)
    assert got["pos"].shape == want["pos"].shape == (3,)
    assert len(got["layers"]) == len(want["layers"]) == 1
    for n in ("k", "v"):
        d, w = got["layers"][0][n], want["layers"][0][n]
        assert d.shape == w.shape == (tm.cfg.num_layers, 3, 17, tm.cfg.num_kv_heads,
                                      tm.cfg.head_dim)
        assert str(d.dtype).split(".")[-1] == np.dtype(w.dtype).name
    sv = Server(ServeJobConfig(arch=arch, slots=2, max_len=16, device="cpu"))
    assert sv._batch_axis["layers"][0]["k"] == 1


@pytest.mark.parametrize("arch,layers", sorted(FULL_PARAMS, key=str))
def test_full_width_configs_build(arch, layers):
    """``Model`` takes both archs at full width; the parameter counts of the card's
    paths, from the definitions (nothing materialised)."""
    cfg = tconfigs.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = TM.Model(cfg, "cpu")
    n = sum(int(np.prod(d.shape)) for d in tree_leaves(t_param_defs(model.cfg)))
    assert n == FULL_PARAMS[arch, layers] == cfg.param_count()


# ---------------------------------------------------------------------- training
@pytest.mark.parametrize("arch,dtype", CASES, ids=CASE_IDS)
def test_loss_fn_matches_jax(arch, dtype):
    """Loss (CE + 0.01 aux) and metrics at the configs' capacity 1.25 on 48
    tokens a row (drops occur); in f32 the gradient of every leaf (rtol 1e-4,
    atol 1e-6), the router's and the shared expert's included, each nonzero."""
    jax = _jax()
    jm, tm, jp, tp = _pair(arch, seed=2, dtype=dtype)
    b = _batch(2, 48, jm.cfg.vocab_size, seed=1)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, _jbatch(b))
    leaves = {k: v.requires_grad_(True) for k, v in _named(tp).items()}
    tl, tmet = tm.loss_fn(tp, _tbatch(b))
    tol = LOSS_TOL if dtype == "float32" else BF16_LOSS_TOL
    _close(tl.detach(), jl, tol)
    for key in ("loss", "aux_loss", "tokens"):
        _close(tmet[key], jmet[key], tol, key)
    assert float(tmet["aux_loss"]) > 1.0
    if dtype != "float32":
        return
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    want = _named(jg)
    assert sorted(grads) == sorted(want)
    assert "layers/moe/router" in grads
    assert any(k.startswith("layers/moe/shared/") for k in grads) == (arch == ARCHS[0])
    for k, g in grads.items():
        np.testing.assert_allclose(_f32(g), np.asarray(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        assert g.abs().max() > 0, k


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One f32 train step from a converted JAX train state: metrics (aux_loss
    included) and every leaf of params, m, v and master, at tests/test_torch_train.py's
    gates."""
    jax = _jax()
    from repro.launch.steps import init_train_state as j_init, make_train_step as j_step
    from repro.optim.adamw import AdamWConfig as JOpt
    jm, tm = _jax_model(arch, dtype="float32"), _tmodel(arch, dtype="float32")
    jstate = j_init(jm, jax.random.PRNGKey(0))
    tstate = train_state_to_torch(_np_tree(jstate), "cpu")
    b = _batch(2, 40, jm.cfg.vocab_size, seed=3)
    jnew, jmet = jax.jit(j_step(jm, JOpt(**OPT), 1))(jstate, _jbatch(b))
    tnew, tmet = tsteps.make_train_step(tm, tadamw.AdamWConfig(**OPT), 1)(tstate, _tbatch(b))
    for key in ("loss", "grad_norm", "lr", "tokens", "aux_loss"):
        _close(tmet[key], jmet[key], LOSS_TOL, key)
    want, got = _named(_np_tree(jnew)), _named(tnew)
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        tol = MOMENT_TOL if name.startswith(("opt/m/", "opt/v/")) else MASTER_TOL
        _close(got[name], np.asarray(w, np.float32), tol, name)


# ---------------------------------------------------------------------- the tasks
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_task_runs_reduced_moe_on_cpu(arch):
    """``run_serve_task`` (bf16, capacity 1.25 in prefill): a ServerCache hit gives
    the same result from the rebound server."""
    cache = ServerCache(2)
    payload = {"arch": arch, "device": "cpu", "slots": 2, "max_len": 48, "n_requests": 3,
               "prompt_len": 9, "max_new": 4}
    first = run_serve_task(cache, payload)
    assert first == {"requests": 3, "generated_tokens": 12, "decode_steps": 6}
    assert run_serve_task(cache, payload) == first
    assert cache.stats() == {"hits": 1, "misses": 1, "evictions": 0, "size": 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_task_runs_reduced_moe_on_cpu(arch):
    """``run_train_task`` (bf16): finite losses and aux, every step run."""
    res = run_train_task(None, {"arch": arch, "seq_len": 32, "global_batch": 2,
                                "steps": 2, "device": "cpu"})
    assert res["steps"] == 2 and res["ran_steps"] == 2 and res["resumed_from"] == 0
    assert np.isfinite(res["loss"])
