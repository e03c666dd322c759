"""PyTorch port, SSM slice: reduced mamba2 (4 layers, d_model 128, 8 heads of
P=32, N=16, chunk 32) and its serving, on ``device="cpu"`` (the kernels' plain
versions) against the JAX package on the same converted params and numpy
tokens. The prompt is 80 tokens: three chunks of the scan, the last one ragged,
so the state carried across chunks is on the path."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.runtime.serve_loop import Server, ServeJobConfig  # noqa: E402
from repro_torch.runtime.step_cache import ServerCache, run_serve_task  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_model import (BF16_TOL, F32_TOL, PROMPTS, _auto_mesh,  # noqa: E402
                              _converted, _f32, _jax, _jax_model, _tokens)
from test_torch_model import _one_torch_thread  # noqa: E402,F401


ARCH = "mamba2-2.7b"
PROMPT = 80


def _tmodel(dtype="bfloat16"):
    cfg = dataclasses.replace(tconfigs.get(ARCH).reduced(), remat="none", dtype=dtype)
    return TModel(cfg, "cpu")


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def mamba_pair(request):
    """(dtype, {stage: (jax out, port out)}) for reduced mamba2: logits of
    forward / prefill / decode and the prefill cache's conv tail and SSD state."""
    jax = _jax()
    jnp = jax.numpy
    dtype = request.param
    jm = _jax_model(ARCH, dtype=dtype)
    tm = _tmodel(dtype)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = _converted(jp)
    toks = _tokens(jm.cfg.vocab_size, 2, PROMPT + 1, 1)
    out = {}
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    out["forward"] = (jl, tl)
    jll, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=96))(
        jp, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    tll, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :PROMPT])}, max_len=96)
    out["prefill"] = (jll, tll)
    for n in ("conv", "ssd"):
        out[n] = (jc["layers"][n], tc["layers"][n].clone())
    jdl, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, PROMPT:]), jc)
    tdl, _ = tm.decode_step(tp, torch.from_numpy(toks[:, PROMPT:]), tc)
    out["decode"] = (jdl, tdl)
    return dtype, out


@pytest.mark.parametrize("stage", ["forward", "prefill", "decode"])
def test_mamba2_reduced_matches_jax(mamba_pair, stage):
    dtype, out = mamba_pair
    want, got = out[stage]
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("leaf", ["conv", "ssd"])
def test_mamba2_prefill_cache_matches_jax(mamba_pair, leaf):
    """The cache leaves: conv tail [L,B,W-1,DI+2N] in cfg.dtype, SSD state
    [L,B,H,N,P] in f32, as the JAX package lays them out."""
    dtype, out = mamba_pair
    want, got = out[leaf]
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == (torch.float32 if leaf == "ssd" else getattr(torch, dtype))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=_tol(dtype), atol=_tol(dtype))


def test_cache_defs_and_batch_axes():
    """The Server's generic batch-axis search finds axis 1 of the stacked state."""
    sv = Server(ServeJobConfig(arch=ARCH, slots=3, max_len=64, device="cpu"))
    cfg = sv.arch_cfg
    defs = sv.model.cache_defs(3, 64)
    assert defs["layers"]["conv"].shape == (cfg.num_layers, 3, cfg.ssm_conv_width - 1,
                                            cfg.d_inner + 2 * cfg.ssm_state)
    assert defs["layers"]["ssd"].shape == (cfg.num_layers, 3, cfg.ssm_heads,
                                           cfg.ssm_state, cfg.ssm_head_dim)
    assert defs["layers"]["ssd"].dtype == torch.float32
    assert sv._batch_axis == {"pos": 0, "layers": {"conv": 1, "ssd": 1}}


def test_convert_keeps_the_mamba2_tree():
    """convert.to_torch carries every leaf across, the f32 ones included."""
    jax = _jax()
    jp = _jax_model(ARCH).init_params(jax.random.PRNGKey(2))
    tp = _converted(jp)
    jleaves = jax.tree_util.tree_leaves(jp)
    assert len(tree_leaves(tp)) == len(jleaves)
    ssm = tp["layers"]["ssm"]
    assert ssm["a_log"].dtype == ssm["dt_bias"].dtype == torch.float32
    assert ssm["w_x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ssm["a_log"].numpy(),
                                  np.asarray(jp["layers"]["ssm"]["a_log"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_matches_forward(dtype):
    """Twin of tests/test_models_smoke.py's, inside the port:
    decode(prefill(t[:k]), t[k]) logits == forward(t[:k+1]) logits."""
    model = _tmodel(dtype)
    params = model.init_params(0)
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, 2, PROMPT + 1, 3))
    full, _ = model.forward(params, {"tokens": toks})
    last, cache = model.prefill(params, {"tokens": toks[:, :PROMPT]}, max_len=96)
    np.testing.assert_allclose(_f32(last), _f32(full[:, PROMPT - 1]),
                               rtol=_tol(dtype), atol=_tol(dtype))
    step, cache = model.decode_step(params, toks[:, PROMPT:], cache)
    np.testing.assert_allclose(_f32(step), _f32(full[:, PROMPT]),
                               rtol=_tol(dtype), atol=_tol(dtype))
    assert cache["pos"].tolist() == [PROMPT + 1] * 2


# ----------------------------------------------------------------------- serving
def generate(slots, prompts, max_new=6, params=None, **kw):
    sv = Server(ServeJobConfig(arch=ARCH, slots=slots, max_len=64, seed=11,
                               device="cpu", **kw), params=params)
    ids = [sv.submit(p, max_new=max_new) for p in prompts]
    sv.run()
    return {i: sv.requests[i].generated for i in ids}, sv


def test_greedy_tokens_match_jax_server_f32(monkeypatch):
    """In f32 the port's Server emits the JAX Server's greedy tokens on the
    same converted params."""
    _jax()
    import repro.runtime.serve_loop as jserve
    import repro_torch.runtime.serve_loop as tserve

    for mod in (jserve, tserve):
        get = mod.configs.get
        monkeypatch.setattr(mod.configs, "get", lambda name, get=get: dataclasses.replace(
            get(name), dtype="float32"))
    jsv = jserve.Server(jserve.ServeJobConfig(arch=ARCH, slots=2, max_len=64, seed=11),
                        mesh=_auto_mesh())
    ids = [jsv.submit(p, max_new=6) for p in PROMPTS]
    jsv.run()
    got, sv = generate(2, PROMPTS, params=_converted(jsv.params))
    assert sv.arch_cfg.dtype == "float32"
    assert list(got.values()) == [jsv.requests[i].generated for i in ids]


def test_batching_invariance():
    solo, _ = generate(1, PROMPTS)
    batched, _ = generate(4, PROMPTS)
    assert list(solo.values()) == list(batched.values())


def test_slot_reuse_more_requests_than_slots():
    out, sv = generate(2, PROMPTS + [[7, 7, 7]], max_new=4)
    assert len(out) == 5 and all(len(g) == 4 for g in out.values())
    assert all(r.done for r in sv.requests.values())
    assert all(s is None for s in sv.slots)


def test_serve_task_mamba2():
    cache = ServerCache(2)
    payload = {"arch": ARCH, "device": "cpu", "slots": 2, "max_len": 64,
               "n_requests": 3, "prompt_len": 40, "max_new": 4}
    first = run_serve_task(cache, payload)
    assert first == {"requests": 3, "generated_tokens": 12, "decode_steps": 6}
    assert run_serve_task(cache, payload) == first
    assert cache.stats()["hits"] == 1
