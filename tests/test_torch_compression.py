"""PyTorch port, local SGD's exchange: the int8 error-feedback compression
(``repro_torch.optim.compression``), the local-SGD state's layout and its
conversion, the byte accounting and the outer step of the round, on the CPU
against the JAX package on the same numpy inputs.

The compression is held bit for bit: q, the scale, the new error feedback and the
dequantized values. The JAX functions are called as the JAX package's own tests
call them, op by op; under ``jax.jit`` XLA's CPU backend contracts ``a * b + c``
into one fused multiply-add (on ``mu * m + d``, 29% of f32 results differ in the
last bit from the two rounded ops), so the outer step, which the JAX package only
runs jitted, is held at OUTER_TOL below. The JAX reference is built on an
Auto-axis mesh, as in tests/test_torch_model.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import local_sgd_state_to_torch  # noqa: E402
from repro_torch.models.params import param_defs  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402
from repro_torch.optim import local_sgd as TL  # noqa: E402
from repro_torch.tree import tree_flatten_sorted, tree_map  # noqa: E402
from test_torch_model import _auto_mesh, _jax  # noqa: E402
from test_torch_train import _named, _np_tree  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401


# the outer step from the same pod masters, in f32: the last bits of one fused
# multiply-add (ef ~1e-5 and momentum ~1e-3 move by ~1e-10; master ~1 by an ulp,
# 1.2e-7). Measured within 0.28 of this gate.
OUTER_RTOL, OUTER_ATOL = 2e-6, 2e-9
# qwen3-0.6b at full width and depth (param_defs; untied embedding)
QWEN3_PARAMS = 751_632_384


def _bits(t):
    """The raw bits of a tensor or numpy array (bf16 through int16) as numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_bits(got, want, msg=""):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (msg, g.dtype, w.dtype, g.shape, w.shape)
    assert np.array_equal(g, w), f"{msg}: {int((g != w).sum())} of {g.size} differ"


def _tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _leaf(case):
    """A numpy leaf of one quantizer case."""
    jnp = _jax().numpy
    rng = np.random.default_rng(4)
    if case == "normal":
        return (rng.standard_normal((33, 17)) * 0.3).astype(np.float32)
    if case == "ties":
        # max |x| = 127 gives scale 1, so x / scale is x: every half lands on a tie
        return np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 125.5, -126.5, 3.0],
                        np.float32)
    if case == "zeros":                 # the 1e-12 floor of the scale
        return np.zeros((4, 8), np.float32)
    if case == "tiny":                  # a scale far below 1e-12 / 127 is floored
        return (rng.standard_normal((64,)) * 1e-15).astype(np.float32)
    if case == "bf16":
        return np.asarray(jnp.asarray(rng.standard_normal((16, 24)) * 2.0, jnp.bfloat16))
    raise ValueError(case)


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "tiny", "bf16"])
def test_quantize_int8_matches_jax_bitwise(case):
    jax = _jax()
    from repro.optim.compression import dequantize_int8, quantize_int8
    x = _leaf(case)
    jq, js = quantize_int8(jax.numpy.asarray(x))
    tq, ts = TC.quantize_int8(_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.dim() == 0
    _same_bits(tq, jq, "q")
    _same_bits(ts, js, "scale")
    _same_bits(TC.dequantize_int8(tq, ts), dequantize_int8(jq, js), "dequantized")
    if case == "ties":                  # round half to even, as jnp.round
        assert tq.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 3]
    if case in ("zeros", "tiny"):
        assert float(ts) == np.float32(np.float32(1e-12) / np.float32(127.0))


def _tree(rng, bf16):
    """A nested tree, keys out of sorted order, an f32 and a bf16 (or f32) leaf."""
    jnp = _jax().numpy
    w = rng.standard_normal((8, 5)).astype(np.float32)
    return {"z": {"w": w, "b": np.zeros((5,), np.float32)},
            "a": np.asarray(jnp.asarray(rng.standard_normal((7,)), jnp.bfloat16)) if bf16
            else rng.standard_normal((7,)).astype(np.float32)}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_compress_tree_matches_jax_bitwise(bf16):
    """q, scales and the new error feedback of every leaf, from a nonzero error
    feedback; then decompress_tree."""
    jax = _jax()
    from repro.optim.compression import compress_tree, decompress_tree
    rng = np.random.default_rng(7)
    tree = _tree(rng, bf16)
    ef = tree_map(lambda a: (rng.standard_normal(np.shape(a)) * 1e-2).astype(np.float32), tree)
    jtree = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    (jq, js), jef = compress_tree(jtree, jax.tree_util.tree_map(jax.numpy.asarray, ef))
    (tq, ts), tef = TC.compress_tree(tree_map(_tensor, tree), tree_map(_tensor, ef))
    assert list(tq) == list(tree) and list(tq["z"]) == ["w", "b"]   # the input's structure
    for name, got, want in (("q", tq, jq), ("scale", ts, js), ("ef", tef, jef)):
        got, want = _named(got), _named(_np_tree(want))
        assert sorted(got) == sorted(want)
        for k in want:
            _same_bits(got[k], want[k], f"{name} {k}")
    jd, td = _named(_np_tree(decompress_tree(jq, js))), _named(TC.decompress_tree(tq, ts))
    for k in jd:
        _same_bits(td[k], jd[k], f"decompressed {k}")


@pytest.mark.parametrize("seed", range(6))
def test_int8_error_feedback_reduces_bias(seed):
    """Twin of tests/test_data_optim.py::test_int8_error_feedback_reduces_bias:
    quantize(x + ef) averaged over repeats converges on x, where one-shot
    quantization keeps its error."""
    gen = torch.Generator().manual_seed(seed)
    x = {"g": torch.randn(256, generator=gen) * 0.3}
    ef = TC.init_error_feedback(x)
    acc = torch.zeros(256)
    n = 16
    for _ in range(n):
        (q, s), ef = TC.compress_tree(x, ef)
        acc = acc + q["g"].float() * s["g"]
    mean_err = float((acc / n - x["g"]).abs().mean())
    (q1, s1), _ = TC.compress_tree(x, TC.init_error_feedback(x))
    oneshot_err = float((q1["g"].float() * s1["g"] - x["g"]).abs().mean())
    assert mean_err <= oneshot_err * 0.55 + 1e-6


def test_error_feedback_and_byte_counts_match_jax():
    jax = _jax()
    from repro.optim.compression import compressed_bytes, init_error_feedback
    tree = _tree(np.random.default_rng(1), True)
    jef = _named(_np_tree(init_error_feedback(jax.tree_util.tree_map(jax.numpy.asarray, tree))))
    tef = _named(TC.init_error_feedback(tree_map(_tensor, tree)))
    assert sorted(jef) == sorted(tef)
    for k in jef:
        _same_bits(tef[k], jef[k], k)
    assert TC.compressed_bytes(tree_map(_tensor, tree)) == compressed_bytes(tree) == 40 + 5 + 7 + 12


# ------------------------------------------------------------------ byte accounting
def _jax_params(arch="qwen3-0.6b", **overrides):
    jax = _jax()
    from repro.configs import base as jconfigs
    from repro.models.model import Model as JModel
    from repro.optim.local_sgd import pod_free_plan
    from repro.parallel.sharding import MeshPlan
    cfg = dataclasses.replace(jconfigs.get(arch).reduced(), remat="none", **overrides)
    jm = JModel(cfg, pod_free_plan(MeshPlan(mesh=_auto_mesh(), fsdp=False)))
    return jm, jm.init_params(jax.random.PRNGKey(0))


def test_dcn_byte_accounting_matches_jax():
    """Twin of tests/test_local_sgd.py::test_dcn_byte_accounting, and equal to the
    JAX package's count on the same params."""
    from repro.optim.local_sgd import LocalSGDConfig as JLocal, dcn_bytes_per_round
    _, jp = _jax_params()
    tp = tree_map(_tensor, _np_tree(jp))
    n_params = sum(t.numel() for _, t in tree_flatten_sorted(tp))
    compressed = TL.LocalSGDConfig(inner_steps=4, compress=True)
    plain = TL.LocalSGDConfig(inner_steps=4, compress=False)
    c_bytes, sync_bytes = TL.dcn_bytes_per_round(tp, compressed)
    p_bytes, _ = TL.dcn_bytes_per_round(tp, plain)
    assert p_bytes == 8 * n_params                 # f32 delta, ring 2x
    assert c_bytes < p_bytes / 3.5                 # int8 ~ 4x smaller
    assert sync_bytes / c_bytes > 7                # H(4) x bf16->int8(2x) = 8x
    for cfg in (compressed, plain):
        assert TL.dcn_bytes_per_round(tp, cfg) == dcn_bytes_per_round(
            jp, JLocal(**dataclasses.asdict(cfg)))


def test_dcn_bytes_of_qwen3_at_full_width():
    """qwen3-0.6b at full width and depth, 2 pods, H = 4: the card's local-SGD
    configuration (shapes only, on the meta device)."""
    defs = param_defs(tconfigs.get("qwen3-0.6b"))
    params = tree_map(lambda d: torch.empty(d.shape, device="meta"), defs)
    leaves = [t for _, t in tree_flatten_sorted(params)]
    assert sum(t.numel() for t in leaves) == QWEN3_PARAMS
    c_bytes, sync_bytes = TL.dcn_bytes_per_round(params, TL.LocalSGDConfig(inner_steps=4))
    assert c_bytes == 2 * (QWEN3_PARAMS + 4 * len(leaves))
    assert sync_bytes == 16 * QWEN3_PARAMS                  # 12.03 GB of bf16 gradients
    assert 1.50e9 < c_bytes < 1.51e9


# ------------------------------------------------------------------ state and layout
@pytest.mark.parametrize("n_pods", [1, 2, 3])
def test_init_local_sgd_state_matches_jax(n_pods):
    """Names, shapes, dtypes and bits of every leaf, from the same bf16 params."""
    from repro.optim.local_sgd import init_local_sgd_state
    _, jp = _jax_params()
    want = _named(_np_tree(init_local_sgd_state(jp, n_pods)))
    got = _named(TL.init_local_sgd_state(tree_map(_tensor, _np_tree(jp)), n_pods))
    assert sorted(got) == sorted(want)
    assert got["pod_opt/step"].dtype == torch.int32 and got["round"].dtype == torch.int32
    assert got["pod_params/embed"].dtype == torch.bfloat16
    for k in want:
        _same_bits(got[k], want[k], k)


def _jax_state(n_pods=2):
    from repro.optim.local_sgd import init_local_sgd_state
    _, jp = _jax_params()
    return _np_tree(init_local_sgd_state(jp, n_pods))


def _drop(s):
    del s["ef"]


def _m_bf16(s):
    s["pod_opt"]["m"]["embed"] = s["pod_opt"]["m"]["embed"].astype(s["pod_params"]["embed"].dtype)


def _step_scalar(s):
    s["pod_opt"]["step"] = np.zeros((), np.int32)


def _round_vector(s):
    s["round"] = np.zeros((2,), np.int32)


def _master_stacked(s):
    s["master"]["embed"] = s["pod_opt"]["master"]["embed"]


def _pods_disagree(s):
    s["pod_params"]["embed"] = s["pod_params"]["embed"][:1]


def _ef_unstacked(s):
    s["ef"]["embed"] = s["momentum"]["embed"]


@pytest.mark.parametrize("breaks", [_drop, _m_bf16, _step_scalar, _round_vector,
                                    _master_stacked, _pods_disagree, _ef_unstacked],
                         ids=lambda f: f.__name__[1:])
def test_local_sgd_state_to_torch_refuses_a_wrong_layout(breaks):
    state = _jax_state()
    out = local_sgd_state_to_torch(state, "cpu")          # the real layout converts
    for k, t in _named(out).items():
        _same_bits(t, _named(state)[k], k)
    breaks(state)
    with pytest.raises(ValueError):
        local_sgd_state_to_torch(state, "cpu")


# ------------------------------------------------------------------------ outer step
@pytest.mark.parametrize("n_pods", [2, 3])
@pytest.mark.parametrize("compress", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("nesterov", [True, False], ids=["nesterov", "heavy_ball"])
def test_outer_step_matches_jax(n_pods, compress, nesterov):
    """The outer step from the same state, with pods' masters apart from the global
    one, a nonzero momentum and error feedback: the JAX reference is its jitted
    round with an inner learning rate of 0, whose inner steps leave every pod's
    master as it was. master, momentum, ef, the pods' params and masters at
    OUTER_TOL, delta_norm likewise; every pod equal to the new master, bit for bit."""
    jax = _jax()
    jnp = jax.numpy
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.optim.local_sgd import LocalSGDConfig as JLocal, make_round_fn
    lcfg = TL.LocalSGDConfig(inner_steps=1, compress=compress, nesterov=nesterov)
    from repro.optim.local_sgd import init_local_sgd_state
    jm, _ = _jax_params(dtype="float32", num_layers=1)
    state = _np_tree(init_local_sgd_state(jm.init_params(jax.random.PRNGKey(0)), n_pods))
    rng = np.random.default_rng(3)
    moved = lambda a, s: (a + rng.standard_normal(a.shape) * s).astype(np.float32)  # noqa: E731
    state["pod_opt"]["master"] = tree_map(lambda a: moved(a, 1e-3), state["pod_opt"]["master"])
    state["momentum"] = tree_map(lambda a: moved(a, 1e-3), state["momentum"])
    state["ef"] = tree_map(lambda a: moved(a, 1e-5), state["ef"])
    toks = rng.integers(0, jm.cfg.vocab_size, (1, n_pods, 1, 9)).astype(np.int32)
    batches = {"tokens": jnp.asarray(toks[..., :-1]), "targets": jnp.asarray(toks[..., 1:]),
               "loss_mask": jnp.ones((1, n_pods, 1, 8), jnp.bfloat16)}
    round_fn = jax.jit(make_round_fn(jm.loss_fn, JOpt(peak_lr=0.0), JLocal(
        **dataclasses.asdict(lcfg)), spmd_axis=None))
    jnew, jmet = round_fn(jax.tree_util.tree_map(jnp.asarray, state), batches)

    tstate = local_sgd_state_to_torch(state, "cpu")
    delta_norm = TL.outer_step(tstate, lcfg)
    want, got = _named(_np_tree(jnew)), _named(tstate)
    for k, w in want.items():
        if k.startswith(("pod_opt/m/", "pod_opt/v/", "pod_opt/step", "round")):
            continue                          # the inner steps' and the round's
        np.testing.assert_allclose(got[k].numpy(), w, rtol=OUTER_RTOL, atol=OUTER_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(delta_norm), float(jmet["delta_norm"]), rtol=OUTER_RTOL)
    if not compress:                          # the error feedback stays as it was
        for k, e in _named(state["ef"]).items():
            _same_bits(got["ef/" + k], e, k)
    for (path, master), (_, pods), (_, pod_master) in zip(*(tree_flatten_sorted(t) for t in (
            tstate["master"], tstate["pod_params"], tstate["pod_opt"]["master"]))):
        for p in range(n_pods):
            assert torch.equal(pods[p], master) and torch.equal(pod_master[p], master), path
    for k in want:                            # outer_step leaves the pods' m and v
        if k.startswith(("pod_opt/m/", "pod_opt/v/")):
            assert not got[k].any(), k
