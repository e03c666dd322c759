"""PyTorch port, gemma3 slices: the ring-buffer KV cache of the sliding-window
layers (``_ring_slice``, ``attend_cache_ring``, the window branch of the decode
step), K1's plain version at head dim 256, and reduced gemma3-12b's prefill, decode
steps across the ring's wrap and Server, run on ``device="cpu"`` against the JAX
package on the same converted params and numpy inputs; the refusal of a depth that
is not a multiple of the local:global period by the dense, moe and encdec stacks, as
the JAX package's;
and a train task of reduced gemma3 on the CPU. Tests marked ``cuda`` hold K1's D=256
forward kernel against its plain version on the card (the backward's D=256 cases are
in tests/test_torch_train_kernels.py) and check that both directions refuse a head dim
that is not built; they skip without a card.

Tolerances: f32 1e-5 for one decode attention (the JAX and PyTorch einsums sum in
another order), 1e-4 for model logits and caches (tests/test_torch_model.py's
F32_TOL), 2e-5 for flash attention and bf16 2e-2 (tests/test_kernels.py), bf16
0.08 for one decode attention (tests/test_models_smoke.py's bf16 tolerance).
The JAX reference is built on an Auto-axis mesh, as in tests/test_torch_model.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.serve_loop import Server, ServeJobConfig  # noqa: E402
from repro_torch.runtime.step_cache import run_train_task  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401


ARCH = "gemma3-12b"
F32_TOL = 1e-4
RING_TOL = {"float32": 1e-5, "bfloat16": 0.08}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# K1 at head dim 256: B, S, H, K, causal, window (Sq == Skv): causal with and
# without a window, GQA 2:1, a ragged S
FLASH_256 = [(1, 128, 4, 2, True, 0), (1, 128, 4, 2, True, 32), (2, 96, 2, 2, True, 0)]
# rows of one decode batch: all inside the first window, all past it, and rows at
# different positions across the wrap (W = 16)
RING_POS = {"before_wrap": [0, 7, 15], "after_wrap": [16, 40, 63],
            "across_wrap": [3, 15, 16, 17, 47]}
# greedy serving: prompts shorter than the reduced window 64 whose generations
# cross it, one of exactly 2W, more requests than slots
PROMPTS = [list(range(1, 41)), [9, 8, 7] * 10, [5] * 50, list(range(128))]


def _jax():
    return pytest.importorskip("jax")


def _auto_mesh():
    jax = _jax()
    from jax.sharding import AxisType, Mesh
    return Mesh(np.array(jax.devices()).reshape(1, -1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _models(**overrides):
    """(JAX Model, port Model) of reduced gemma3-12b in f32 with ``overrides``."""
    from repro.configs import base as jconfigs
    from repro.models.model import Model as JModel
    from repro.parallel.sharding import MeshPlan
    fields = dict(remat="none", dtype="float32", **overrides)
    jm = JModel(dataclasses.replace(jconfigs.get(ARCH).reduced(), **fields),
                MeshPlan(mesh=_auto_mesh(), fsdp=False))
    tm = TM.Model(dataclasses.replace(tconfigs.get(ARCH).reduced(), **fields), "cpu")
    return jm, tm


def _converted(jax_params):
    jax = _jax()
    return to_torch(jax.tree_util.tree_map(np.asarray, jax_params), "cpu")


# ---------------------------------------------------------------------- ring cache
@pytest.mark.parametrize("rows", list(RING_POS), ids=list(RING_POS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_cache_ring_matches_jax(rows, dtype):
    jnp = _jax().numpy
    from repro.kernels import ops as jops
    pos = np.array(RING_POS[rows], np.int32)
    B, W, H, K, D = len(pos), 16, 4, 2, 32
    q, kc, vc = _np((B, 1, H, D), 1), _np((B, W, K, D), 2), _np((B, W, K, D), 3)
    want = jops.attend_cache_ring(*(jnp.asarray(a).astype(dtype) for a in (q, kc, vc)),
                                  jnp.asarray(pos))
    got = tops.attend_cache_ring(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                   for a in (q, kc, vc)), torch.from_numpy(pos))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, 1, H, D)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RING_TOL[dtype],
                               atol=RING_TOL[dtype])


def test_attend_cache_ring_equals_windowed_attention():
    """A ring written position by position gives the last row of full attention
    under the sliding window, before and after it wraps."""
    B, S, W, H, K, D = 2, 40, 16, 4, 2, 32
    q, k, v = (torch.from_numpy(_np(s, 10 + i)) for i, s in
               enumerate([(B, S, H, D), (B, S, K, D), (B, S, K, D)]))
    ring_k, ring_v = torch.zeros((B, W, K, D)), torch.zeros((B, W, K, D))
    for p in range(S):
        ring_k[:, p % W], ring_v[:, p % W] = k[:, p], v[:, p]
        pos = torch.full((B,), p, dtype=torch.int32)
        got = tops.attend_cache_ring(q[:, p:p + 1], ring_k, ring_v, pos)
        want = FA.flash_attention_plain(q[:, :p + 1], k[:, :p + 1], v[:, :p + 1],
                                        window=W)[:, -1:]
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [10, 16, 32], ids=["S<W", "S=W", "S=2W"])
def test_ring_slice_matches_jax_bit_for_bit(S):
    jnp = _jax().numpy
    from repro.models import model as JM
    k = _np((2, S, 2, 8), 4)
    want = np.asarray(JM._ring_slice(jnp.asarray(k), 16))
    got = TM._ring_slice(torch.from_numpy(k), 16)
    assert got.shape == (2, 16, 2, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ring_slice_refuses_a_length_past_the_window_not_a_multiple_of_it():
    with pytest.raises(ValueError, match="multiple of it"):
        TM._ring_slice(torch.zeros((1, 20, 2, 8)), 16)


# --------------------------------------------------------------- K1 at head dim 256
@pytest.mark.parametrize("impl", ["pallas", "blocked"])
@pytest.mark.parametrize("B,S,H,K,causal,window", FLASH_256)
def test_flash_plain_head_dim_256_matches_jax(B, S, H, K, causal, window, impl):
    jnp = _jax().numpy
    from repro.kernels import ops as jops
    D = 256
    q, k, v = _np((B, S, H, D), 5), _np((B, S, K, D), 6), _np((B, S, K, D), 7)
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                window=window, impl=impl, interpret=True)
    got = FA.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,K,causal,window", [
    (1, 128, 128, 4, 2, True, 0), (2, 256, 256, 4, 2, True, 64),
    (1, 1000, 1000, 4, 2, True, 300), (1, 96, 200, 4, 2, True, 0),
    (1, 130, 130, 4, 2, False, 0), (1, 2048, 2048, 16, 8, True, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_head_dim_256_vs_plain_on_card(cuda, B, Sq, Skv, H, K, causal, window,
                                                    dtype):
    """f32 runs the CUDA-core design, bf16 the tensor-core one with 32-row kv
    tiles; the last case is a gemma3-12b local layer's prefill of 2W."""
    q, k, v = (torch.from_numpy(_np(s, 20 + i)).to(getattr(torch, dtype)).to(cuda)
               for i, s in enumerate([(B, Sq, H, 256), (B, Skv, K, 256), (B, Skv, K, 256)]))
    got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()), rtol=FLASH_TOL[dtype],
                               atol=FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_kernels_refuse_an_unbuilt_head_dim_on_card(cuda):
    """A head dim that no config uses (96) is built in neither direction: both
    wrappers raise, naming the head dims they have."""
    q = torch.zeros((1, 64, 4, 96), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 64, 2, 96), dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros((1, 4, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="head dim 96 not supported"):
        FA.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="head dim 96 not supported"):
        FA.flash_attention_bwd_cuda(q, k, k, q, lse, q)


# --------------------------------------------------------------------- the model
@pytest.mark.parametrize("prompt", [40, 128], ids=["S<W", "S=2W"])
@pytest.mark.parametrize("head_dim", [32, 256])
def test_prefill_and_30_decode_steps_match_jax(head_dim, prompt):
    """Reduced gemma3 (6 layers: 5 local with window 64, 1 global), f32: the
    prefill's logits and cache, then 30 teacher-forced decode steps (from 128
    tokens every one wraps the ring; from 40 the ring wraps at step 24), each
    step's logits and every cache leaf, ring and full, against the JAX Model."""
    jax = _jax()
    jnp = jax.numpy
    jm, tm = _models(head_dim=head_dim)
    jp = jm.init_params(jax.random.PRNGKey(2))
    tp = _converted(jp)
    steps, B = 30, 2
    max_len = prompt + steps + 2
    toks = _tokens(jm.cfg.vocab_size, B, prompt + steps, 3)
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))(
        jp, {"tokens": jnp.asarray(toks[:, :prompt])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :prompt])},
                        max_len=max_len)
    decode = jax.jit(jm.decode_step)

    def held(stage, t_logits, j_logits):
        np.testing.assert_allclose(_f32(t_logits), _f32(j_logits), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"{stage} logits")
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist(), stage
        for j, layer in enumerate(tc["layers"]):
            W = TM._window_for(tm.cfg, j)
            for n, t in layer.items():
                assert t.shape[2] == (W or max_len), (stage, j, n, t.shape)
                np.testing.assert_allclose(_f32(t), _f32(jc["layers"][j][n]), rtol=F32_TOL,
                                           atol=F32_TOL, err_msg=f"{stage} cache {j} {n}")

    held("prefill", tl, jl)
    for i in range(steps):
        step = toks[:, prompt + i:prompt + i + 1]
        jl, jc = decode(jp, jnp.asarray(step), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(step), tc)
        held(f"decode step {i}", tl, jl)


def test_greedy_tokens_match_jax_server(monkeypatch):
    """The port's Server emits the JAX Server's greedy tokens on reduced gemma3 in
    f32 (both packages' registries give the f32 config), on the same converted
    params: 2 slots, 4 requests, generations that cross the window 64 while
    decoding. Where a token differs, the JAX top-2 logit gap there must be under
    F32_TOL, and the tokens before it equal."""
    jax = _jax()
    from repro.configs import base as jconfigs
    from repro.runtime.serve_loop import Server as JServer
    from repro.runtime.serve_loop import ServeJobConfig as JCfg
    for reg in (jconfigs, tconfigs):
        real = reg.get
        monkeypatch.setattr(reg, "get", lambda name, real=real: dataclasses.replace(
            real(name), dtype="float32"))
    jsv = JServer(JCfg(arch=ARCH, slots=2, max_len=192, seed=11), mesh=_auto_mesh())
    ids = [jsv.submit(p, max_new=40) for p in PROMPTS]
    jsv.run()
    want = [jsv.requests[i].generated for i in ids]
    sv = Server(ServeJobConfig(arch=ARCH, slots=2, max_len=192, seed=11, device="cpu"),
                params=_converted(jsv.params))
    assert sv.arch_cfg.dtype == "float32" and sv.arch_cfg.sliding_window == 64
    got_ids = [sv.submit(p, max_new=40) for p in PROMPTS]
    sv.run()
    got = [sv.requests[i].generated for i in got_ids]
    assert all(len(g) == 40 for g in got)
    for prompt, w, g in zip(PROMPTS, want, got):
        if w == g:
            continue
        i = next(n for n, (a, b) in enumerate(zip(w, g)) if a != b)
        toks = jax.numpy.asarray([prompt + w[:i]], jax.numpy.int32)
        logits, _ = jax.jit(jsv.model.forward)(jsv.params, {"tokens": toks})
        top2 = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
        assert top2[1] - top2[0] < F32_TOL, (prompt, w, g)


# ----------------------------------------------------- depth and the local:global period
@pytest.mark.parametrize("layers", [7, 12])
def test_model_takes_only_whole_local_global_groups(layers):
    """Reduced gemma3 (period 6): 7 layers are refused, naming the period, where the
    stack would drop the seventh; 12 (two groups) build and run ``forward``."""
    cfg = dataclasses.replace(tconfigs.get(ARCH).reduced(), num_layers=layers,
                              dtype="float32")
    if layers % 6:
        with pytest.raises(ValueError, match="period 6"):
            TM.Model(cfg, "cpu")
        return
    tm = TM.Model(cfg, "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 1, 16, 0))
    logits, _ = tm.forward(tm.init_params(0), {"tokens": toks})
    assert logits.shape == (1, 16, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert tm.cache_defs(1, 16)["layers"][0]["k"].shape[0] == 2


def test_jax_model_refuses_the_same_depth():
    """The JAX package's dense stack refuses 7 layers of reduced gemma3 as well: its
    ``_grouped`` asserts whole groups."""
    jax = _jax()
    from repro.configs import base as jconfigs
    from repro.models.model import Model as JModel
    from repro.parallel.sharding import MeshPlan
    jm = JModel(dataclasses.replace(jconfigs.get(ARCH).reduced(), num_layers=7,
                                    dtype="float32", remat="none"),
                MeshPlan(mesh=_auto_mesh(), fsdp=False))
    params = jm.init_params(jax.random.PRNGKey(0))
    toks = jax.numpy.asarray(_tokens(jm.cfg.vocab_size, 1, 16, 0))
    with pytest.raises(AssertionError):
        jm.forward(params, {"tokens": toks})


# ------------------------------------------------------------------------ training
def test_train_task_runs_reduced_gemma3_on_cpu():
    """``run_train_task`` of reduced gemma3 (bf16, 6 layers) on the CPU, over
    sequences past its window of 64: finite losses, every step run."""
    res = run_train_task(None, {"arch": ARCH, "seq_len": 80, "global_batch": 2,
                                "steps": 2, "device": "cpu"})
    assert res["steps"] == 2 and res["ran_steps"] == 2 and res["resumed_from"] == 0
    assert np.isfinite(res["loss"])


# the other families whose stack runs whole local:global groups: an MoE and an
# encoder-decoder arch given gemma3's pattern at period 2
PERIOD_2 = dict(local_global_pattern=1, sliding_window=8, dtype="float32")


def _period_batch(cfg, tokens):
    batch = {"tokens": torch.from_numpy(tokens)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(_np((1, cfg.encoder_frames, cfg.d_model), 1))
    return batch


@pytest.mark.parametrize("layers", [3, 4])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "whisper-medium"])
def test_moe_and_encdec_take_only_whole_local_global_groups(arch, layers):
    """Reduced deepseek-moe-16b and whisper-medium at period 2: 3 layers are
    refused, naming the period, where the stack would drop the third; 4 (two
    groups) build and run ``forward``, and the fourth layer moves the logits."""
    cfg = dataclasses.replace(tconfigs.get(arch).reduced(), num_layers=layers, **PERIOD_2)
    if layers % 2:
        with pytest.raises(ValueError, match="period 2"):
            TM.Model(cfg, "cpu")
        return
    tm = TM.Model(cfg, "cpu")
    batch = _period_batch(cfg, _tokens(cfg.vocab_size, 1, 16, 0))
    params = tm.init_params(0)
    logits, _ = tm.forward(params, batch)
    assert logits.shape == (1, 16, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    moved = dict(params, layers=tree_map(lambda t: torch.cat([t[:-1], t[-1:] + 1.0]),
                                         params["layers"]))
    assert not torch.equal(tm.forward(moved, batch)[0], logits)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "whisper-medium"])
def test_jax_moe_and_encdec_refuse_the_same_depth(arch):
    """The JAX package's moe and encdec stacks refuse 3 layers at period 2 as well:
    ``_grouped`` asserts whole groups."""
    jax = _jax()
    from repro.configs import base as jconfigs
    from repro.models.model import Model as JModel
    from repro.parallel.sharding import MeshPlan
    cfg = dataclasses.replace(jconfigs.get(arch).reduced(), num_layers=3, remat="none",
                              **PERIOD_2)
    jm = JModel(cfg, MeshPlan(mesh=_auto_mesh(), fsdp=False))
    params = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))   # shapes only
    batch = {k: jax.numpy.asarray(v.numpy())
             for k, v in _period_batch(cfg, _tokens(cfg.vocab_size, 1, 16, 0)).items()}
    with pytest.raises(AssertionError):
        jax.eval_shape(jm.forward, params, batch)
