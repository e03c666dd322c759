"""PyTorch port, serving slice: configs, params, the dense model and the Server,
run on ``device="cpu"`` (the kernels' plain versions) against the JAX package on
the same converted params and numpy inputs.

The JAX reference is built on an Auto-axis mesh: ``make_test_mesh`` gives
Explicit axes on current jax, under which its sharding constraints raise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import init_params as t_init_params  # noqa: E402
from repro_torch.models.params import param_defs as t_param_defs  # noqa: E402
from repro_torch.runtime.serve_loop import Server, ServeJobConfig  # noqa: E402
from repro_torch.runtime.step_cache import ServerCache, run_serve_task  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread runs them as fast, and keeps them fast
    beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHS = tconfigs.names()
DENSE_FULL_CACHE = ["phi4-mini-3.8b", "qwen3-0.6b", "qwen3-32b"]
# tokens of the prefill + decode vs forward check: 16, or for gemma3 129, a prefill
# of 128 (2W of the reduced window 64: the ring full) and a decode step past it
DECODE_LEN = {"gemma3-12b": 129}
PROMPTS = [[1, 2, 3, 4], [9, 8, 7], [5, 5], [2, 4, 6, 8, 10]]   # tests/test_serve.py
# f32 logits of the reduced model agree to ~5e-6 (same blocked attention, same
# op order up to matmul summation order); 1e-4 leaves 20x headroom for BLAS
# summation-order changes across machines
F32_TOL = 1e-4
BF16_TOL = 0.08          # tests/test_models_smoke.py's bf16 tolerance


def _jax():
    return pytest.importorskip("jax")


def _auto_mesh():
    jax = _jax()
    from jax.sharding import AxisType, Mesh
    return Mesh(np.array(jax.devices()).reshape(1, -1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


def _jax_model(arch, **overrides):
    from repro.configs import base as jconfigs
    from repro.models.model import Model as JModel
    from repro.parallel.sharding import MeshPlan
    cfg = dataclasses.replace(jconfigs.get(arch).reduced(), remat="none", **overrides)
    return JModel(cfg, MeshPlan(mesh=_auto_mesh(), fsdp=False))


def _converted(jax_params):
    jax = _jax()
    return to_torch(jax.tree_util.tree_map(np.asarray, jax_params), "cpu")


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# --------------------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_field_by_field(arch):
    _jax()
    from repro.configs import base as jconfigs
    assert tconfigs.names() == jconfigs.names()
    for t, j in [(tconfigs.get(arch), jconfigs.get(arch)),
                 (tconfigs.get(arch).reduced(), jconfigs.get(arch).reduced())]:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_jax(arch):
    _jax()
    from repro.models.params import is_def, param_defs as j_param_defs
    import jax
    cfg = tconfigs.get(arch).reduced()
    jdefs = jax.tree_util.tree_flatten_with_path(
        j_param_defs(cfg), is_leaf=is_def)[0]
    want = {jax.tree_util.keystr(p): (d.shape, d.logical, d.init, d.scale)
            for p, d in jdefs}
    got = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + f"['{k}']")
        else:
            got[path] = (tree.shape, tree.logical, tree.init, tree.scale)
    walk(t_param_defs(cfg), "")
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_model_builds_every_arch(arch):
    """``Model`` takes every arch of the registry, all six families, on the CPU,
    and its parameter tree has the config's count."""
    cfg = tconfigs.get(arch).reduced()
    params = TModel(cfg, "cpu").init_params(0)
    assert sum(t.numel() for t in tree_leaves(params)) == cfg.param_count()


def test_init_params_rules_and_param_count():
    cfg = tconfigs.get("qwen3-0.6b").reduced()
    params = TModel(cfg, "cpu").init_params(3)
    assert sum(t.numel() for t in tree_leaves(params)) == cfg.param_count()
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(params))
    assert torch.equal(params["layers"]["ln1"], torch.ones(cfg.num_layers, cfg.d_model,
                                                           dtype=torch.bfloat16))
    # wq [L, D, H, hd]: fan_in spans every leading dim but "layers", i.e. D*H
    std = (cfg.d_model * cfg.num_heads) ** -0.5
    assert abs(params["layers"]["attn"]["wq"].float().std().item() - std) < 0.05 * std
    again = TModel(cfg, "cpu").init_params(3)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))


def test_init_params_ssm_rules():
    """The SSM leaves keep the JAX rules: f32 a_log = log U[0.5, 1], dt_bias =
    softplus^-1 of U[1e-3, 1e-1]."""
    cfg = tconfigs.get("mamba2-2.7b").reduced()
    ssm = t_init_params(cfg, 0, "cpu")["layers"]["ssm"]
    a, dt = ssm["a_log"].exp(), torch.nn.functional.softplus(ssm["dt_bias"])
    assert ssm["a_log"].dtype == ssm["dt_bias"].dtype == torch.float32
    assert 0.5 <= a.min() and a.max() <= 1.0
    assert 1e-3 - 1e-6 <= dt.min() and dt.max() <= 1e-1 + 1e-6
    assert ssm["w_x"].dtype == torch.bfloat16


def test_convert_bf16_is_bit_exact():
    jnp = _jax().numpy
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)), jnp.bfloat16)
    t = to_torch({"a": [np.asarray(x)]}, "cpu")["a"][0]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(x).view(np.int16))


# ------------------------------------------------------------------- model parity
@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def qwen_pair(request):
    """(dtype, {stage: (jax logits, port logits)}) for reduced qwen3-0.6b."""
    jax = _jax()
    jnp = jax.numpy
    dtype = request.param
    jm = _jax_model("qwen3-0.6b", dtype=dtype)
    tm = TModel(dataclasses.replace(tconfigs.get("qwen3-0.6b").reduced(),
                                    remat="none", dtype=dtype), "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = _converted(jp)
    toks = _tokens(jm.cfg.vocab_size, 2, 16, 1)
    out = {}
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    out["forward"] = (jl, tl)
    jll, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=24))(
        jp, {"tokens": jnp.asarray(toks[:, :15])})
    tll, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :15])}, max_len=24)
    out["prefill"] = (jll, tll)
    jdl, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, 15:]), jc)
    tdl, _ = tm.decode_step(tp, torch.from_numpy(toks[:, 15:]), tc)
    out["decode"] = (jdl, tdl)
    return dtype, out


@pytest.mark.parametrize("stage", ["forward", "prefill", "decode"])
def test_qwen3_reduced_matches_jax(qwen_pair, stage):
    dtype, out = qwen_pair
    want, got = out[stage]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["gemma3-12b", "phi4-mini-3.8b", "qwen3-32b"])
def test_dense_forward_matches_jax_f32(arch):
    """Other dense archs (gemma3: the local:global sliding-window period)."""
    jax = _jax()
    jm = _jax_model(arch, dtype="float32")
    tm = TModel(dataclasses.replace(tconfigs.get(arch).reduced(), remat="none",
                                    dtype="float32"), "cpu")
    jp = jm.init_params(jax.random.PRNGKey(1))
    toks = _tokens(jm.cfg.vocab_size, 2, 80, 2)      # longer than gemma3's window 64
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jax.numpy.asarray(toks)})
    tl, _ = tm.forward(_converted(jp), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("arch", DENSE_FULL_CACHE + ["gemma3-12b"])
def test_prefill_decode_matches_forward(arch):
    """Twin of tests/test_models_smoke.py's: decode(prefill(t[:k]), t[k]) logits
    == forward(t[:k+1]) last logits, inside the port (gemma3: its local layers'
    ring cache)."""
    cfg = dataclasses.replace(tconfigs.get(arch).reduced(), remat="none")
    model = TModel(cfg, "cpu")
    params = model.init_params(0)
    B, S = 2, DECODE_LEN.get(arch, 16)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, B, S, 3))
    k = S - 1
    logits_full, _ = model.forward(params, {"tokens": toks})
    last_logits, cache = model.prefill(params, {"tokens": toks[:, :k]}, max_len=S + 4)
    np.testing.assert_allclose(_f32(last_logits), _f32(logits_full[:, k - 1]),
                               rtol=BF16_TOL, atol=BF16_TOL)
    step_logits, cache = model.decode_step(params, toks[:, k:k + 1], cache)
    np.testing.assert_allclose(_f32(step_logits), _f32(logits_full[:, k]),
                               rtol=BF16_TOL, atol=BF16_TOL)
    assert cache["pos"].tolist() == [S] * B


def test_cache_update_matches_jax_one_hot_blend():
    """The in-place index write equals the JAX one-hot blend, including a row
    whose pos is past the end (an idle slot), which writes nothing."""
    jnp = _jax().numpy
    from repro.models import layers as JLY
    cache = np.random.default_rng(4).standard_normal((3, 6, 2, 4)).astype(np.float32)
    new = np.random.default_rng(5).standard_normal((3, 1, 2, 4)).astype(np.float32)
    pos = np.array([0, 5, 9], np.int32)
    want = JLY._cache_update(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos))
    got = TLY._cache_update(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                            torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------- serving
def generate(slots, prompts, max_new=6, params=None, **kw):
    sv = Server(ServeJobConfig(arch="qwen3-0.6b", slots=slots, max_len=64, seed=11,
                               device="cpu", **kw), params=params)
    ids = [sv.submit(p, max_new=max_new) for p in prompts]
    sv.run()
    return {i: sv.requests[i].generated for i in ids}, sv


def test_batching_invariance():
    solo, _ = generate(1, PROMPTS)
    batched, _ = generate(4, PROMPTS)
    assert list(solo.values()) == list(batched.values())


def test_slot_reuse_more_requests_than_slots():
    out, sv = generate(2, PROMPTS, max_new=4)
    assert all(len(g) == 4 for g in out.values())
    assert all(r.done for r in sv.requests.values())


def test_eos_frees_slot_early():
    probe, _ = generate(1, [PROMPTS[0]], max_new=4)
    eos = list(probe.values())[0][0]
    out, sv = generate(2, [PROMPTS[0]], max_new=8, eos_id=int(eos))
    gen = list(out.values())[0]
    assert gen[-1] == eos and len(gen) < 8


def test_mixed_lengths_no_head_of_line_blocking():
    out, sv = generate(2, [[1, 2, 3]] * 2 + [[4, 5, 6]], max_new=3)
    assert len(out) == 3
    assert all(len(g) == 3 for g in out.values())


def test_sampled_decoding_is_seeded():
    a, _ = generate(2, PROMPTS, greedy=False)
    b, _ = generate(2, PROMPTS, greedy=False)
    assert a == b
    assert all(0 <= t < 512 for g in a.values() for t in g)


def test_greedy_tokens_match_jax_server():
    """The port's Server emits the JAX Server's greedy tokens on the same
    converted params. Where a bf16 near-tie flips a token, the JAX top-2 logit
    gap there must be under the bf16 tolerance, and the tokens before it equal."""
    jax = _jax()
    from repro.runtime.serve_loop import Server as JServer
    from repro.runtime.serve_loop import ServeJobConfig as JCfg
    jsv = JServer(JCfg(arch="qwen3-0.6b", slots=2, max_len=64, seed=11),
                  mesh=_auto_mesh())
    ids = [jsv.submit(p, max_new=6) for p in PROMPTS]
    jsv.run()
    want = [jsv.requests[i].generated for i in ids]
    got, _ = generate(2, PROMPTS, params=_converted(jsv.params))
    for prompt, w, g in zip(PROMPTS, want, got.values()):
        if w == g:
            continue
        i = next(n for n, (a, b) in enumerate(zip(w, g)) if a != b)
        toks = jax.numpy.asarray([prompt + w[:i]], jax.numpy.int32)
        logits, _ = jax.jit(jsv.model.forward)(jsv.params, {"tokens": toks})
        top2 = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
        assert top2[1] - top2[0] < BF16_TOL, (prompt, w, g)


def test_serve_task_and_server_cache():
    cache = ServerCache(2)
    payload = {"device": "cpu", "slots": 2, "max_len": 64, "n_requests": 3,
               "prompt_len": 5, "max_new": 4}
    first = run_serve_task(cache, payload)
    assert first == {"requests": 3, "generated_tokens": 12, "decode_steps": 6}
    assert run_serve_task(cache, payload) == first
    assert cache.stats() == {"hits": 1, "misses": 1, "evictions": 0, "size": 1}
    run_serve_task(cache, dict(payload, max_len=32))
    run_serve_task(cache, dict(payload, slots=1))
    assert cache.stats()["evictions"] == 1
    assert run_serve_task(None, dict(payload, n_requests=1))["requests"] == 1


def test_rebind_reinitializes_only_for_a_new_seed():
    _, sv = generate(2, PROMPTS[:1])
    before = sv.params
    sv.rebind(dataclasses.replace(sv.cfg))
    assert sv.params is before and not sv.requests and sv.steps == 0
    sv.rebind(dataclasses.replace(sv.cfg, seed=12))
    assert not torch.equal(sv.params["embed"], before["embed"])
    assert tree_map(lambda t: t.abs().sum().item(), sv.cache)["layers"][0]["k"] == 0
