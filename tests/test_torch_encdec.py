"""PyTorch port, encoder-decoder slice: reduced whisper-medium (2 encoder and 4
decoder layers, 24 frames, 4 heads of 32) on ``device="cpu"`` (the kernels' plain
versions) against the JAX package on the same converted params and numpy inputs:
``_encode``, the model's forward, prefill cache and decode steps, ``cache_defs``,
``loss_fn`` with every leaf's gradient (the encoder's included), one train step at
1 and 2 microbatches, the Server against the JAX Server, the serve, train and eval
tasks, the Trainer's fixed frames, checkpoints across the two packages, and the
cast of bf16 frames under f32 params.

The helpers here serve ``tests/test_torch_vlm.py`` too (reduced
llama-3.2-vision-90b): every check is written once for both cross-attending
families. The frames or patches are random, never the zeros the servers feed
(zero frames give an encoder output and cross K/V of exactly 0), and every vlm
cross layer's gate is set to ``GATE`` in both packages (its init is 0, where a
cross layer adds nothing), so a missing cross path cannot pass.

Tolerances: f32 1e-4 (tests/test_torch_model.py's F32_TOL), bf16 0.08 + 0.08|x|
(tests/test_models_smoke.py's); training at tests/test_torch_train.py's gates.
The JAX reference is built on an Auto-axis mesh, as in tests/test_torch_model.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager as TCkpt  # noqa: E402
from repro_torch.convert import train_state_to_torch  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import param_defs as t_param_defs  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim.local_sgd import LocalSGDConfig  # noqa: E402
from repro_torch.runtime.serve_loop import Server, ServeJobConfig  # noqa: E402
from repro_torch.runtime.step_cache import (ServerCache, TrainerCache,  # noqa: E402
                                            run_eval_task, run_serve_task, run_train_task)
from repro_torch.runtime.train_loop import Trainer, TrainJobConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_model import (BF16_TOL, F32_TOL, _auto_mesh, _converted, _f32,  # noqa: E402
                              _jax, _jax_model, _tokens)
from test_torch_train import (LOSS_TOL, MASTER_TOL, MOMENT_TOL, OPT, _batch,  # noqa: E402
                              _bits, _jbatch, _named, _np_tree, _tbatch)
from test_torch_model import _one_torch_thread  # noqa: E402,F401


ARCH = "whisper-medium"
DTYPES = ["float32", "bfloat16"]
B, PROMPT, STEPS = 2, 12, 8
GATE = 0.5               # every vlm cross layer's gate (tanh 0.46), in both packages
CPU = {"device": "cpu"}
# full-width parameter counts (from param_defs): whisper-medium at its 24 + 24 layers
FULL_PARAMS = {(ARCH, None): 1_012_314_112}


# --------------------------------------------------------------------- helpers
def tcfg(arch, **overrides):
    return dataclasses.replace(tconfigs.get(arch).reduced(), remat="none", **overrides)


def aux_key(cfg) -> str:
    return "frames" if cfg.family == "encdec" else "patches"


def aux_len(cfg) -> int:
    return cfg.encoder_frames if cfg.family == "encdec" else cfg.num_patches


def tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def close(got, want, tol_, msg=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol_, atol=tol_, err_msg=msg)


def with_gate(jp, gate=GATE):
    """JAX params with every vlm cross layer's gate at ``gate`` (others as they are)."""
    if "cross_layers" not in jp:
        return jp
    jnp = _jax().numpy
    cross = dict(jp["cross_layers"], gate=jnp.full_like(jp["cross_layers"]["gate"], gate))
    return dict(jp, cross_layers=cross)


def pair(arch, seed=0, **overrides):
    """(JAX model, port model, JAX params with the gates at GATE, the same converted)."""
    jax = _jax()
    jm = _jax_model(arch, **overrides)
    jp = with_gate(jm.init_params(jax.random.PRNGKey(seed)))
    return jm, TM.Model(tcfg(arch, **overrides), "cpu"), jp, _converted(jp)


def aux(cfg, b, seed, dtype=None):
    """The same random frames or patches [b, M, D] in both packages (f32 numpy,
    rounded to ``dtype``, default the config's, alike)."""
    jnp = _jax().numpy
    dtype = dtype or cfg.dtype
    a = np.random.default_rng(seed).standard_normal((b, aux_len(cfg), cfg.d_model))
    a = a.astype(np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def stage_run(arch, dtype):
    """{stage: (jax, port)} of reduced ``arch``: forward logits and aux, the
    prefill's last logits and cache, and teacher-forced decode steps' logits and
    caches (each step's leaves copied, since the port writes in place)."""
    jax = _jax()
    jnp = jax.numpy
    jm, tm, jp, tp = pair(arch, dtype=dtype)
    key = aux_key(jm.cfg)
    toks = _tokens(jm.cfg.vocab_size, B, PROMPT + STEPS, 1)
    ja, ta = aux(jm.cfg, B, 2)
    max_len = PROMPT + STEPS + 2
    out = {}
    out["forward"] = (jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks), key: ja}),
                      tm.forward(tp, {"tokens": torch.from_numpy(toks), key: ta}))
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))(
        jp, {"tokens": jnp.asarray(toks[:, :PROMPT]), key: ja})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :PROMPT]), key: ta},
                        max_len=max_len)
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


def check_forward(run):
    dtype, _, out = run
    (jl, jaux), (tl, taux) = out["forward"]
    assert tl.dtype == getattr(torch, dtype) and tuple(tl.shape) == tuple(jl.shape)
    close(tl, jl, tol(dtype), "logits")
    assert float(taux) == float(jaux) == 0.0


def check_prefill(run):
    """The last logits; the cache {"pos", "self", "cross"} leaf by leaf: self
    padded to max_len with zeros past the prompt, cross at the memory's length."""
    dtype, tm, out = run
    jl, tl = out["prefill"]
    close(tl, jl, tol(dtype), "prefill logits")
    jc, tc = out["prefill cache"]
    cfg = tm.cfg
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [PROMPT] * B
    assert sorted(tc) == sorted(jc) == ["cross", "pos", "self"]
    K, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.family == "encdec":
        self_shape = (cfg.num_layers, B, PROMPT + STEPS + 2, K, hd)
        cross_shape = (cfg.num_layers, B, cfg.encoder_frames, K, hd)
    else:
        nc = cfg.num_layers // cfg.cross_attn_every
        self_shape = (nc, cfg.cross_attn_every - 1, B, PROMPT + STEPS + 2, K, hd)
        cross_shape = (nc, B, cfg.num_patches, K, hd)
    for n in ("k", "v"):
        got, want = tc["self"][n], jc["self"][n]
        assert tuple(got.shape) == tuple(want.shape) == self_shape, n
        close(got, want, tol(dtype), f"self {n}")
        assert not got[..., PROMPT:, :, :].any()
        got, want = tc["cross"][n], jc["cross"][n]
        assert tuple(got.shape) == tuple(want.shape) == cross_shape, n
        close(got, want, tol(dtype), f"cross {n}")
        assert got.abs().amax() > 0.1, f"cross {n} is (near) zero"


def check_decode(run):
    """Teacher-forced decode steps: logits and the self cache each step; the
    cross K/V stay as prefill wrote them."""
    dtype, _, out = run
    _, tc0 = out["prefill cache"]
    for i, (jl, tl, jc, tc) in enumerate(out["decode"]):
        close(tl, jl, tol(dtype), f"decode step {i} logits")
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [PROMPT + i + 1] * B
        for n in ("k", "v"):
            close(tc["self"][n], jc["self"][n], tol(dtype), f"step {i} self {n}")
            assert torch.equal(tc["cross"][n], tc0["cross"][n])


def check_cache_defs(arch, self_axis):
    """The cache declaration as the JAX package declares it, leaf by leaf; the
    Server finds the batch axis of each leaf from it."""
    _jax()
    jm, tm = _jax_model(arch), TM.Model(tcfg(arch), "cpu")
    got, want = tm.cache_defs(3, 17), jm.cache_defs(3, 17)
    assert got["pos"].shape == want["pos"].shape == (3,)
    for g in ("self", "cross"):
        for n in ("k", "v"):
            d, w = got[g][n], want[g][n]
            assert d.shape == w.shape, (g, n)
            assert str(d.dtype).split(".")[-1] == np.dtype(w.dtype).name, (g, n)
    sv = Server(ServeJobConfig(arch=arch, slots=2, max_len=16, **CPU))
    assert sv._batch_axis["self"]["k"] == self_axis and sv._batch_axis["cross"]["v"] == 1


def check_prefill_decode_matches_forward(arch):
    """Twin of tests/test_models_smoke.py's, inside the port, bf16, with random
    frames or patches and the gates at GATE: decode(prefill(t[:k]), t[k]) logits ==
    forward(t[:k+1]) last logits."""
    _, tm, _, tp = pair(arch)
    S = 16
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, 2, S, 3))
    _, ta = aux(tm.cfg, 2, 4)
    key = aux_key(tm.cfg)
    k = S - 1
    full, _ = tm.forward(tp, {"tokens": toks, key: ta})
    last, cache = tm.prefill(tp, {"tokens": toks[:, :k], key: ta}, max_len=S + 4)
    close(last, full[:, k - 1], BF16_TOL, "prefill")
    step, cache = tm.decode_step(tp, toks[:, k:k + 1], cache)
    close(step, full[:, k], BF16_TOL, "decode")
    assert cache["pos"].tolist() == [S] * 2


def check_loss_fn(arch, dtype):
    """Loss and metrics on 2 x 24 tokens with random frames or patches; in f32 the
    gradient of every leaf (rtol 1e-4, atol 1e-6), each nonzero: the encoder's,
    the cross-attention's and the gates' included."""
    jax = _jax()
    jm, tm, jp, tp = pair(arch, seed=2, dtype=dtype)
    key = aux_key(jm.cfg)
    b = _batch(2, 24, jm.cfg.vocab_size, seed=1)
    ja, ta = aux(jm.cfg, 2, 5)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, dict(_jbatch(b), **{key: ja}))
    leaves = {k: v.requires_grad_(True) for k, v in _named(tp).items()}
    tl, tmet = tm.loss_fn(tp, dict(_tbatch(b), **{key: ta}))
    tol_ = LOSS_TOL if dtype == "float32" else 0.02
    close(tl.detach(), jl, tol_)
    for k in ("loss", "aux_loss", "tokens"):
        close(tmet[k], jmet[k], tol_, k)
    if dtype != "float32":
        return
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    want = _named(jg)
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        np.testing.assert_allclose(_f32(g), np.asarray(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        assert g.abs().max() > 0, k
    return grads


def check_train_step(arch, microbatches):
    """One f32 step from a converted JAX train state (gates at GATE), a batch of
    4 x 16 tokens with random frames or patches, split into ``microbatches`` along
    with the tokens: metrics, and params, m, v, master leaf by leaf."""
    jax = _jax()
    from repro.launch.steps import init_train_state as j_init, make_train_step as j_step
    from repro.optim.adamw import AdamWConfig as JOpt
    jm, tm, _, _ = pair(arch, dtype="float32")
    jstate = j_init(jm, jax.random.PRNGKey(0))
    jstate["params"] = with_gate(jstate["params"])
    jstate["opt"]["master"] = with_gate(jstate["opt"]["master"])
    tstate = train_state_to_torch(_np_tree(jstate), "cpu")
    key = aux_key(jm.cfg)
    b = _batch(4, 16, jm.cfg.vocab_size, seed=3)
    ja, ta = aux(jm.cfg, 4, 6)
    jnew, jmet = jax.jit(j_step(jm, JOpt(**OPT), microbatches))(
        jstate, dict(_jbatch(b), **{key: ja}))
    tnew, tmet = tsteps.make_train_step(tm, tadamw.AdamWConfig(**OPT), microbatches)(
        tstate, dict(_tbatch(b), **{key: ta}))
    for k in ("loss", "grad_norm", "lr", "tokens", "aux_loss"):
        close(tmet[k], jmet[k], LOSS_TOL, k)
    want, got = _named(_np_tree(jnew)), _named(tnew)
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        tol_ = MOMENT_TOL if name.startswith(("opt/m/", "opt/v/")) else MASTER_TOL
        close(got[name], np.asarray(w, np.float32), tol_, name)
    return float(tmet["loss"])


def check_server_matches_jax(monkeypatch, arch, dtype):
    """The port's Server against the JAX Server on reduced ``arch`` in ``dtype``, on
    the same converted params, both feeding zero frames or patches: 2 slots, 3
    requests, the same greedy tokens. Where a token differs, the JAX top-2 logit
    gap there must be under the dtype's tolerance, and the tokens before it equal."""
    jax = _jax()
    from repro.configs import base as jconfigs
    from repro.runtime.serve_loop import Server as JServer
    from repro.runtime.serve_loop import ServeJobConfig as JCfg
    for reg in (jconfigs, tconfigs):      # the servers take the config as it is
        real = reg.get
        monkeypatch.setattr(reg, "get", lambda name, real=real: dataclasses.replace(
            real(name).reduced(), dtype=dtype))
    prompts = [list(range(1, 21)), [9, 8, 7] * 5, [5] * 7]
    jsv = JServer(JCfg(arch=arch, reduced=False, slots=2, max_len=48, seed=11),
                  mesh=_auto_mesh())
    jsv.params = with_gate(jsv.params)
    ids = [jsv.submit(p, max_new=8) for p in prompts]
    jsv.run()
    want = [jsv.requests[i].generated for i in ids]
    sv = Server(ServeJobConfig(arch=arch, reduced=False, slots=2, max_len=48, seed=11,
                               **CPU), params=_converted(jsv.params))
    aux_in = sv._aux_inputs(1)[aux_key(sv.arch_cfg)]
    assert aux_in.dtype == torch.bfloat16 and not aux_in.any()
    assert tuple(aux_in.shape) == (1, aux_len(sv.arch_cfg), sv.arch_cfg.d_model)
    got_ids = [sv.submit(p, max_new=8) for p in prompts]
    sv.run()
    got = [sv.requests[i].generated for i in got_ids]
    assert all(len(g) == 8 for g in got)
    for prompt, w, g in zip(prompts, want, got):
        if w == g:
            continue
        i = next(n for n, (a, b_) in enumerate(zip(w, g)) if a != b_)
        zeros = jsv._aux_inputs(1)
        toks = jax.numpy.asarray([prompt + w[:i]], jax.numpy.int32)
        logits, _ = jax.jit(jsv.model.forward)(jsv.params, {"tokens": toks, **zeros})
        top2 = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
        assert top2[1] - top2[0] < tol(dtype), (prompt, w, g)


def check_serve_task(arch):
    """``run_serve_task`` (bf16): a ServerCache hit gives the same result."""
    cache = ServerCache(2)
    payload = {"arch": arch, "slots": 2, "max_len": 48, "n_requests": 3, "prompt_len": 9,
               "max_new": 4, **CPU}
    first = run_serve_task(cache, payload)
    assert first == {"requests": 3, "generated_tokens": 12, "decode_steps": 6}
    assert run_serve_task(cache, payload) == first
    assert cache.stats() == {"hits": 1, "misses": 1, "evictions": 0, "size": 1}


def check_train_and_eval_tasks(tmp_path, arch):
    """``run_train_task`` (bf16, 2 steps, a checkpoint) and a strict
    ``run_eval_task`` restore of it: the restored loss on the eval batch is the
    trained state's own."""
    base = {"arch": arch, "seq_len": 16, "global_batch": 2, **CPU}
    cache = TrainerCache(1)
    res = run_train_task(cache, dict(base, steps=2, checkpoint_every=2,
                                     checkpoint_dir=str(tmp_path)))
    assert res["steps"] == 2 and res["ran_steps"] == 2 and np.isfinite(res["loss"])
    assert res["checkpoint"] == {"step": 2, "path": str(tmp_path)}
    tr = cache.get(TrainJobConfig.from_job({"payload": dict(base, steps=2,
                                                            checkpoint_dir=str(tmp_path))}))
    tr.restore(res["checkpoint"], strict=True)
    with torch.no_grad():
        own = float(tr.model.loss_fn(tr.params_for_eval(), tr._sync_batch(10_000))[0])
    ev = run_eval_task(None, dict(base, restore_from=res["checkpoint"]))
    assert ev["restored_step"] == 2 and ev["eval_loss"] == pytest.approx(own, rel=1e-6)


def check_trainer_aux_inputs(arch, offset):
    """The Trainer's frames or patches: one bf16 draw of [B, M, D] from a
    generator seeded seed + ``offset``, the same at every step and, in local_sgd
    mode, for every pod and inner step; another seed draws another."""
    tr = Trainer(TrainJobConfig(arch=arch, seq_len=8, global_batch=4, seed=3, **CPU))
    cfg, key = tr.arch_cfg, aux_key(tr.arch_cfg)
    a, b = tr._sync_batch(0)[key], tr._sync_batch(5)[key]
    want = torch.randn((4, aux_len(cfg), cfg.d_model),
                       generator=torch.Generator().manual_seed(3 + offset)).bfloat16()
    assert a.dtype == torch.bfloat16 and torch.equal(a, want) and torch.equal(a, b)
    other = Trainer(TrainJobConfig(arch=arch, seq_len=8, global_batch=4, seed=4, **CPU))
    assert not torch.equal(other._sync_batch(0)[key], a)
    ls = Trainer(TrainJobConfig(arch=arch, seq_len=8, global_batch=4, seed=3, mode="local_sgd",
                                local_sgd=LocalSGDConfig(inner_steps=2), **CPU))
    stack = ls._round_batches(0)[key]
    assert tuple(stack.shape) == (2, 2, 2, aux_len(cfg), cfg.d_model)
    assert all(torch.equal(stack[h, p], stack[0, 0]) for h in range(2) for p in range(2))


def check_checkpoints_across_packages(tmp_path, arch):
    """A JAX train state (bf16 params, gates at GATE) saved by either package
    restores in the other bit for bit, every leaf (the 0-d gates included)."""
    jax = _jax()
    from repro.checkpoint.manager import CheckpointManager as JCkpt
    from repro.launch.steps import init_train_state as j_init
    jm = _jax_model(arch)
    jstate = j_init(jm, jax.random.PRNGKey(1))
    jstate["params"] = with_gate(jstate["params"])
    tstate = train_state_to_torch(_np_tree(jstate), "cpu")
    TCkpt(str(tmp_path / "port")).save(3, tstate, extra={"arch": arch}, blocking=True)
    restored, step, _ = JCkpt(str(tmp_path / "port")).restore(jstate)
    got = _named(_np_tree(restored))
    for name, t in _named(tstate).items():
        g = np.asarray(got[name])
        assert np.array_equal(g.view(np.int16) if t.dtype == torch.bfloat16 else g,
                              _bits(t)), name
    JCkpt(str(tmp_path / "jax")).save(3, jstate, extra={"arch": arch}, blocking=True)
    like = train_state_to_torch(_np_tree(j_init(jm, jax.random.PRNGKey(2))), "cpu")
    back, step, extra = TCkpt(str(tmp_path / "jax")).restore(like)
    assert step == 3 and extra == {"arch": arch}
    for name, t in _named(tstate).items():
        r = _named(back)[name]
        assert r.dtype == t.dtype and r.shape == t.shape and np.array_equal(
            _bits(r), _bits(t)), name
    return _named(tstate)


def check_entry_points_default_to_cuda(monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TM.Model(tcfg(arch)), lambda: Server(ServeJobConfig(arch=arch)),
                 lambda: Trainer(TrainJobConfig(arch=arch)),
                 lambda: run_serve_task(None, {"arch": arch, "n_requests": 1})):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def full_params(arch, layers):
    """The parameter count of ``arch`` at full width (cut to ``layers``) from its
    definitions (nothing materialised), through a ``Model`` that takes it."""
    cfg = tconfigs.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = TM.Model(cfg, "cpu")
    n = sum(int(np.prod(d.shape)) for d in tree_leaves(t_param_defs(model.cfg)))
    assert n == cfg.param_count()
    return n


# ------------------------------------------------------------------- whisper
@pytest.fixture(scope="module", params=DTYPES)
def whisper_run(request):
    return stage_run(ARCH, request.param)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_jax(dtype):
    """The encoder alone (2 layers, not causal, over 24 frames), then enc_norm."""
    jax = _jax()
    jm, tm, jp, tp = pair(ARCH, dtype=dtype)
    ja, ta = aux(jm.cfg, B, 7)
    want = jax.jit(jm._encode)(jp, ja)
    got = tm._encode(tp, ta)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, jm.cfg.encoder_frames, jm.cfg.d_model)
    close(got, want, tol(dtype))


def test_forward_matches_jax(whisper_run):
    check_forward(whisper_run)


def test_prefill_matches_jax(whisper_run):
    check_prefill(whisper_run)


def test_decode_steps_match_jax(whisper_run):
    check_decode(whisper_run)


def test_cache_defs_match_jax():
    check_cache_defs(ARCH, self_axis=1)


def test_prefill_decode_matches_forward():
    check_prefill_decode_matches_forward(ARCH)


def test_frames_reach_the_logits_through_cross_attention():
    """The cross path runs: other frames give other logits, in forward and in
    prefill + decode, while the decoder's self path is the same; zero frames give
    a zero memory and zero cross K/V (what the servers feed)."""
    _, tm, _, tp = pair(ARCH, dtype="float32")
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, B, 10, 8))
    _, fa = aux(tm.cfg, B, 9)
    _, fb = aux(tm.cfg, B, 10)
    la, _ = tm.forward(tp, {"tokens": toks, "frames": fa})
    lb, _ = tm.forward(tp, {"tokens": toks, "frames": fb})
    assert (la - lb).abs().max() > 1e-2
    zeros = torch.zeros_like(fa)
    assert not tm._encode(tp, zeros).any()
    _, cache = tm.prefill(tp, {"tokens": toks, "frames": zeros}, max_len=12)
    assert not cache["cross"]["k"].any() and not cache["cross"]["v"].any()
    assert cache["self"]["k"].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_fn_matches_jax(dtype):
    grads = check_loss_fn(ARCH, dtype)
    if grads is not None:
        assert any(k.startswith("enc_layers/") for k in grads) and "enc_norm" in grads
        assert "layers/xattn/wk" in grads and "layers/ln3" in grads


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    check_train_step(ARCH, microbatches)


def test_two_microbatches_match_one():
    """The frames are split with the tokens: 2 microbatches give 1's loss and
    update within f32 summation order."""
    jm, tm, _, _ = pair(ARCH, dtype="float32")
    b = _batch(4, 16, jm.cfg.vocab_size, seed=3)
    _, frames = aux(jm.cfg, 4, 6)
    out = []
    for M in (1, 2):
        state = tsteps.init_train_state(tm, 0)
        out.append(tsteps.make_train_step(tm, tadamw.AdamWConfig(**OPT), M)(
            state, dict(_tbatch(b), frames=frames)))
    (s1, m1), (s2, m2) = out
    close(m2["loss"], m1["loss"], LOSS_TOL)
    for (name, a), (_, c) in zip(_named(s1).items(), _named(s2).items()):
        close(c, a, MASTER_TOL, name)


def test_f32_params_take_bf16_frames_as_the_jax_layers_do():
    """The Trainer's frames are bf16 whatever the params' dtype. The JAX package's
    layers normalise them in bf16 (its rmsnorm keeps its input's dtype) and
    promote at the products and the first add; its ``_encode`` cannot carry the
    promoted stream through ``lax.scan`` (TypeError). The port casts once
    (``Model._encode``): its forward matches the JAX package's layers applied
    one by one (the encoder's ``_block``s and ``rmsnorm``, then its own decoder
    stack and unembedding) at 1e-4."""
    jax = _jax()
    jnp = jax.numpy
    from repro.models import layers as JLY
    from repro.models import model as JM
    jm, tm, jp, tp = pair(ARCH, dtype="float32")
    cfg = jm.cfg
    toks = _tokens(cfg.vocab_size, B, 12, 11)
    ja, ta = aux(cfg, B, 12, dtype="bfloat16")
    with pytest.raises(TypeError, match="carry"):
        jm.forward(jp, {"tokens": jnp.asarray(toks), "frames": ja})

    @jax.jit
    def reference(params, tokens, frames):
        pos = jnp.broadcast_to(jnp.arange(frames.shape[1], dtype=jnp.int32)[None],
                               frames.shape[:2])
        x = frames
        for i in range(cfg.encoder_layers):
            lp = jax.tree_util.tree_map(lambda t: t[i], params["enc_layers"])
            x, _, _, _ = JM._block(cfg, jm.plan, lp, x, pos, 0, False, causal=False)
        memory = JLY.rmsnorm(x, params["enc_norm"], cfg.norm_eps)
        S = tokens.shape[1]
        positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], tokens.shape)
        h, _, _, _ = JM._stack_fwd(cfg, jm.plan, params, jm._embed(params, tokens),
                                   positions, memory=memory)
        return memory, jm._unembed(params, h)

    memory, want = reference(jp, jnp.asarray(toks), ja)
    assert memory.dtype == jnp.float32
    got_memory = tm._encode(tp, ta)
    assert got_memory.dtype == torch.float32
    close(got_memory, memory, F32_TOL, "memory")
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks), "frames": ta})
    close(got, want, F32_TOL, "logits")
    # the cast keeps the JAX package's rounding: ln1's output rounded to bf16
    unrounded, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks), "frames": ta.float()})
    assert (unrounded - got).abs().max() > F32_TOL


def test_server_matches_jax_server(monkeypatch):
    """In bf16: the JAX Server feeds bf16 zero frames, which its ``_encode`` takes
    only under bf16 params (see the test above)."""
    check_server_matches_jax(monkeypatch, ARCH, "bfloat16")


def test_serve_task_runs_reduced_whisper_on_cpu():
    check_serve_task(ARCH)


def test_train_and_eval_tasks(tmp_path):
    check_train_and_eval_tasks(tmp_path, ARCH)


def test_trainer_frames_are_one_fixed_bf16_draw():
    check_trainer_aux_inputs(ARCH, offset=1)


def test_checkpoints_restore_across_packages(tmp_path):
    names = check_checkpoints_across_packages(tmp_path, ARCH)
    assert {"params/enc_norm", "params/layers/ln3", "params/layers/xattn/wq"} <= set(names)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    check_entry_points_default_to_cuda(monkeypatch, ARCH)


def test_full_width_config_builds():
    """whisper-medium at full width and depth (the card's serving and training
    path): 1,012,314,112 params."""
    assert full_params(ARCH, None) == FULL_PARAMS[ARCH, None]
