"""PyTorch port, ``cfg.remat`` (``none``, ``dots``, ``full``): on ``device="cpu"``
the three modes give the same loss and gradients bit for bit in every family,
``full`` and ``dots`` run each kernel forward of a unit twice and ``dots`` keeps
the weight products' outputs (no ``aten.mm`` runs again), remat applies only
while autograd records, and each mode matches the JAX package's same mode on the
same converted params and numpy batch."""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.launch.steps import _loss_and_grads  # noqa: E402
from repro_torch.models.model import REMAT_MODES, Model  # noqa: E402
from test_torch_train import (LOSS_TOL, _batch, _f32, _jax, _jax_model,  # noqa: E402
                              _jbatch, _named, _np_tree, _tbatch)

# one arch of each family, and gemma3-12b: a dense group of 6 layers (5 local, 1
# global) is one remat unit
FAMILY_ARCHS = ["qwen3-0.6b", "gemma3-12b", "mamba2-2.7b", "zamba2-7b", "deepseek-moe-16b",
                "whisper-medium", "llama-3.2-vision-90b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread runs them as fast, and keeps them fast
    beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch, remat, **overrides):
    return dataclasses.replace(tconfigs.get(arch).reduced(), remat=remat, **overrides)


def _inputs(cfg, B=2, S=16, seed=0):
    """A numpy-drawn batch as torch tensors; random frames or patches where the
    family reads them."""
    b = _tbatch(_batch(B, S, cfg.vocab_size, seed=seed))
    rng = np.random.default_rng(seed + 1)
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        b["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)).to(dtype)
    if cfg.family == "vlm":
        b["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)).to(dtype)
    return b


def _params(cfg):
    params = Model(cfg, "cpu").init_params(0)
    if "cross_layers" in params:      # open the vlm gates (0 at init) so the
        params["cross_layers"]["gate"].fill_(0.5)   # cross layers move the loss
    return params


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_modes_give_the_same_loss_and_grads(arch):
    """In the config's bf16: loss, aux loss and every leaf's gradient torch.equal
    across the three modes."""
    got = {}
    for mode in REMAT_MODES:
        cfg = _cfg(arch, mode)
        got[mode] = _loss_and_grads(Model(cfg, "cpu"), _params(cfg), _inputs(cfg))
    (met, grads) = got["none"]
    assert any(bool(g.abs().sum() > 0) for g in grads)
    for mode in ("dots", "full"):
        m, g = got[mode]
        for key in ("loss", "aux_loss", "tokens"):
            assert torch.equal(m[key], met[key]), (mode, key)
        assert len(g) == len(grads)
        assert all(torch.equal(a, b) for a, b in zip(g, grads)), mode


def _counting(monkeypatch):
    """Counts of the plain kernels' calls and of the aten ops that run."""
    counts = collections.Counter()
    for mod, name in [(FA, "flash_attention_plain"), (FA, "flash_attention_bwd_plain"),
                      (RN, "rmsnorm_plain"), (RN, "add_rmsnorm_plain"),
                      (RN, "qk_norm_rope_plain")]:
        real = getattr(mod, name)

        def call(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, call)
    return counts


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def test_full_and_dots_recompute_the_kernels_and_dots_keeps_the_matmuls(monkeypatch):
    """qwen3, L = 4 layers, one loss: ``none`` runs each kernel forward once a
    layer; ``full`` and ``dots`` again in the backward (K1 and qk_norm_rope 2L,
    rmsnorm 2, add_rmsnorm 2L + 2L - 1: the final norm is outside the units);
    the backward kernels once. ``full`` runs the forward's weight products again,
    ``dots`` does not."""
    counts = _counting(monkeypatch)
    ops = {}
    for mode in REMAT_MODES:
        cfg = _cfg("qwen3-0.6b", mode)
        model, params, batch = Model(cfg, "cpu"), _params(cfg), _inputs(cfg)
        counts.clear()
        with _OpCount() as oc:
            _loss_and_grads(model, params, batch)
        L = cfg.num_layers
        again = 0 if mode == "none" else 1
        assert counts["flash_attention_plain"] == L * (1 + again), mode
        assert counts["qk_norm_rope_plain"] == L * (1 + again), mode
        assert counts["rmsnorm_plain"] == 1 + again, mode
        assert counts["add_rmsnorm_plain"] == 2 * L + again * (2 * L - 1), mode
        assert counts["flash_attention_bwd_plain"] == L, mode
        ops[mode] = oc.counts[torch.ops.aten.mm.default]
    # the weight products a layer that the backward needs again: q, k, v, o, gate
    # and up (the recompute stops before the down product, whose output the
    # backward does not read)
    assert ops["full"] == ops["none"] + 6 * cfg.num_layers
    assert ops["dots"] == ops["none"]


def test_remat_applies_only_while_autograd_records(monkeypatch):
    """Under no_grad, and on params that require no grad, a remat model runs each
    kernel once and gives none's logits bit for bit; prefill too. An unknown mode
    is refused."""
    counts = _counting(monkeypatch)
    base = _cfg("qwen3-0.6b", "none")
    params, batch = _params(base), _inputs(base)
    want, _ = Model(base, "cpu").forward(params, batch)
    for mode in ("full", "dots"):
        model = Model(_cfg("qwen3-0.6b", mode), "cpu")
        counts.clear()
        got, _ = model.forward(params, batch)             # nothing requires grad
        with torch.no_grad():
            last, _ = model.prefill(params, {"tokens": batch["tokens"]})
        assert torch.equal(got, want) and torch.equal(last, want[:, -1])
        assert counts["flash_attention_plain"] == 2 * base.num_layers
    with pytest.raises(ValueError, match="remat"):
        Model(_cfg("qwen3-0.6b", "everything"), "cpu")


@pytest.mark.parametrize("mode", REMAT_MODES)
def test_remat_mode_matches_jax_same_mode(mode):
    """f32 reduced qwen3: loss (LOSS_TOL) and every leaf's gradient (rtol 1e-4,
    atol 1e-6, as test_torch_train's loss_fn parity) of each mode against the JAX
    package's ``_remat`` in the same mode, from the same converted params."""
    jax = _jax()
    jm = _jax_model("qwen3-0.6b", dtype="float32")
    jm = type(jm)(dataclasses.replace(jm.cfg, remat=mode), jm.plan)
    tm = Model(_cfg("qwen3-0.6b", mode, dtype="float32"), "cpu")
    jp = jm.init_params(jax.random.PRNGKey(2))
    tp = to_torch(_np_tree(jp), "cpu")
    b = _batch(2, 16, jm.cfg.vocab_size, seed=1)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, _jbatch(b))
    leaves = {k: v.requires_grad_(True) for k, v in _named(tp).items()}
    tl, _ = tm.loss_fn(tp, _tbatch(b))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_TOL, atol=LOSS_TOL)
    grads = torch.autograd.grad(tl, list(leaves.values()))
    for (name, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(_f32(g), np.asarray(_named(jg)[name]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
