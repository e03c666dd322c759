"""PyTorch port, VLM slice: reduced llama-3.2-vision-90b (4 layers in 2 groups of
one self layer and one tanh-gated cross layer, 16 patches, GQA 4:2 of 32) on
``device="cpu"`` against the JAX package on the same converted params and numpy
inputs, through the checks of ``tests/test_torch_encdec.py`` (written once for
both cross-attending families): forward, prefill cache and decode steps,
``cache_defs``, ``loss_fn`` with every leaf's gradient (the gates' included), one
train step at 1 and 2 microbatches, the Server against the JAX Server, the tasks,
the Trainer's fixed patches, checkpoints across the packages, the cast of bf16
patches under f32 params; plus the gate's effect and the depth refusal.

Every cross layer's gate is set to ``GATE`` in both packages (its init is 0, where
a cross layer adds nothing) and the patches are random. Tolerances as in
``tests/test_torch_encdec.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from test_torch_encdec import (DTYPES, F32_TOL, GATE, aux, check_cache_defs,  # noqa: E402
                               check_checkpoints_across_packages, check_decode,
                               check_entry_points_default_to_cuda, check_forward,
                               check_loss_fn, check_prefill,
                               check_prefill_decode_matches_forward,
                               check_serve_task, check_server_matches_jax,
                               check_train_and_eval_tasks, check_train_step,
                               check_trainer_aux_inputs, close, full_params, pair,
                               stage_run, _tokens)
from test_torch_model import _one_torch_thread  # noqa: E402,F401


ARCH = "llama-3.2-vision-90b"
# full-width parameter counts (from param_defs): the card's serving path at 10
# layers (two groups), one group (the f32 checks' depth), and all 100 layers
FULL_PARAMS = {10: 10_657_898_498, 5: 6_379_626_497, None: 87_666_794_516}


@pytest.fixture(scope="module", params=DTYPES)
def vlm_run(request):
    return stage_run(ARCH, request.param)


def test_forward_matches_jax(vlm_run):
    check_forward(vlm_run)


def test_prefill_matches_jax(vlm_run):
    check_prefill(vlm_run)


def test_decode_steps_match_jax(vlm_run):
    check_decode(vlm_run)


def test_cache_defs_match_jax():
    """The self cache [nc, k-1, B, max_len, K, hd] (batch axis 2), the cross cache
    [nc, B, P, K, hd]."""
    check_cache_defs(ARCH, self_axis=2)


def test_prefill_decode_matches_forward():
    check_prefill_decode_matches_forward(ARCH)


def test_gate_opens_the_cross_path():
    """A zero gate (the init) gives other logits than GATE, and with it the patches
    do not reach the logits at all; with GATE they do."""
    _, tm, _, tp = pair(ARCH, dtype="float32")
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, 2, 10, 8))
    _, pa = aux(tm.cfg, 2, 9)
    _, pb = aux(tm.cfg, 2, 10)
    shut = dict(tp, cross_layers=dict(tp["cross_layers"],
                                      gate=torch.zeros_like(tp["cross_layers"]["gate"])))
    assert torch.equal(tp["cross_layers"]["gate"], torch.full((2,), GATE))
    logits = {}
    for name, params in (("open", tp), ("shut", shut)):
        for pname, patches in (("a", pa), ("b", pb)):
            logits[name, pname] = tm.forward(params, {"tokens": toks, "patches": patches})[0]
    assert (logits["open", "a"] - logits["shut", "a"]).abs().max() > 1e-2
    assert (logits["open", "a"] - logits["open", "b"]).abs().max() > 1e-2
    assert torch.equal(logits["shut", "a"], logits["shut", "b"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_fn_matches_jax(dtype):
    grads = check_loss_fn(ARCH, dtype)
    if grads is not None:
        assert {"cross_layers/gate", "cross_layers/xattn/wk",
                "self_layers/attn/wq"} <= set(grads)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    check_train_step(ARCH, microbatches)


def test_f32_params_take_bf16_patches_as_jax_does():
    """The Trainer's patches are bf16 whatever the params' dtype; only the cross
    K/V projection reads them, and the JAX package's einsum promotes them to f32
    exactly. The port casts there (``layers.qkv_project``): the f32 forward with
    bf16 patches matches the JAX package's at 1e-4, and equals the port's own on
    the same patches widened to f32."""
    jax = _jax_mod()
    jnp = jax.numpy
    jm, tm, jp, tp = pair(ARCH, dtype="float32")
    toks = _tokens(jm.cfg.vocab_size, 2, 12, 11)
    ja, ta = aux(jm.cfg, 2, 12, dtype="bfloat16")
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks), "patches": ja})
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks), "patches": ta})
    assert got.dtype == torch.float32
    close(got, want, F32_TOL)
    widened, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks), "patches": ta.float()})
    assert torch.equal(widened, got)          # the cast is exact


def test_server_matches_jax_server(monkeypatch):
    check_server_matches_jax(monkeypatch, ARCH, "float32")


def test_serve_task_runs_reduced_llama_vision_on_cpu():
    check_serve_task(ARCH)


def test_train_and_eval_tasks(tmp_path):
    check_train_and_eval_tasks(tmp_path, ARCH)


def test_trainer_patches_are_one_fixed_bf16_draw():
    check_trainer_aux_inputs(ARCH, offset=2)


def test_checkpoints_restore_across_packages(tmp_path):
    names = check_checkpoints_across_packages(tmp_path, ARCH)
    assert names["params/cross_layers/gate"].shape == (2,)
    assert {"params/self_layers/ln1", "opt/master/cross_layers/gate"} <= set(names)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    check_entry_points_default_to_cuda(monkeypatch, ARCH)


def test_depth_off_the_cross_period_is_refused():
    """7 layers do not tile into groups of cross_attn_every = 5 at full width (2 in
    the reduced config): the port refuses with ValueError in ``Model``, the JAX
    package asserts in ``param_defs``; 10 layers build in both."""
    _jax_mod()
    from repro.configs import base as jconfigs
    from repro.models.params import param_defs as j_param_defs
    for every, bad in ((5, 7), (2, 5)):
        cfg = dataclasses.replace(tconfigs.get(ARCH), num_layers=bad, cross_attn_every=every)
        with pytest.raises(ValueError, match="multiple of cross_attn_every"):
            TM.Model(cfg, "cpu")
        with pytest.raises(AssertionError, match="tile"):
            j_param_defs(dataclasses.replace(jconfigs.get(ARCH), num_layers=bad,
                                             cross_attn_every=every))
    TM.Model(dataclasses.replace(tconfigs.get(ARCH), num_layers=10), "cpu")
    j_param_defs(dataclasses.replace(jconfigs.get(ARCH), num_layers=10))


@pytest.mark.parametrize("layers", sorted(FULL_PARAMS, key=str))
def test_full_width_configs_build(layers):
    """llama-3.2-vision-90b at full width: 10 layers (the card's serving path, 19.85
    GiB of bf16), 5 (one group), 100 (163.3 GiB: not on one card)."""
    assert full_params(ARCH, layers) == FULL_PARAMS[layers]


def test_cache_is_written_in_place_across_groups():
    """A decode step writes the token's k/v into every self layer of every group
    of the cache it is given, at pos, and nowhere else; the cross K/V stay."""
    _, tm, _, tp = pair(ARCH, dtype="float32")
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, 2, 9, 13))
    _, pa = aux(tm.cfg, 2, 14)
    _, cache = tm.prefill(tp, {"tokens": toks[:, :8], "patches": pa}, max_len=12)
    before = tree_map(lambda t: t.clone(), cache)
    _, after = tm.decode_step(tp, toks[:, 8:], cache)
    for n in ("k", "v"):
        assert after["self"][n] is cache["self"][n]
        changed = (after["self"][n] != before["self"][n]).any(-1).any(-1)   # [nc,k-1,B,S]
        assert changed[..., 8].all() and not changed[..., :8].any() \
            and not changed[..., 9:].any()
        assert torch.equal(after["cross"][n], before["cross"][n])


def _jax_mod():
    return pytest.importorskip("jax")
