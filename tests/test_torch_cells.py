"""PyTorch port, the cells (``repro_torch.launch.steps.build_cell``): for every
(arch x shape) cell at full width, the port's cell against the JAX package's
(its spec, microbatches, donated arguments and every abstract argument's shape
and dtype; the same skip set); at reduced size, each cell's step on
``device="cpu"`` against the JAX cell's step, built on an Auto-axis mesh, from
the same converted state and numpy inputs: the train step (in each remat mode),
prefill, decode and the Titchener round."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, cell_is_runnable  # noqa: E402
from repro_torch.convert import (local_sgd_state_to_torch, to_torch,  # noqa: E402
                                 train_state_to_torch)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.model import REMAT_MODES  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.local_sgd import init_local_sgd_state  # noqa: E402
from repro_torch.tree import tree_flatten_sorted  # noqa: E402
from test_torch_local_sgd import (DELTA_NORM_RTOL, EF_FLIP_SHARE, EF_TOL,  # noqa: E402
                                  ROUND_TOL, _jb, _round_batches, _tb)
from test_torch_model import BF16_TOL, _auto_mesh, _jax  # noqa: E402
from test_torch_train import (LOSS_TOL, MASTER_TOL, MOMENT_TOL, OPT, _batch,  # noqa: E402
                              _f32, _jbatch, _named, _np_tree, _tbatch)
from test_torch_model import _one_torch_thread  # noqa: E402,F401

CELLS = [(a, s) for a in tconfigs.names() for s in SHAPES
         if not cell_is_runnable(tconfigs.get(a), s)]
SKIPS = [(a, s) for a in tconfigs.names() for s in SHAPES
         if cell_is_runnable(tconfigs.get(a), s)]


def test_skip_set_matches_the_jax_suite():
    """tests/test_dryrun_cells.py's skip set: exactly the 7 pure-full-attention
    archs skip long_500k, 33 + 7 = 40 cells."""
    assert sorted(a for a, s in SKIPS) == sorted([
        "qwen3-32b", "phi4-mini-3.8b", "qwen3-0.6b", "deepseek-moe-16b",
        "qwen3-moe-235b-a22b", "whisper-medium", "llama-3.2-vision-90b"])
    assert {s for _, s in SKIPS} == {"long_500k"}
    assert len(CELLS) == 33 and len(CELLS) + len(SKIPS) == 40
    for arch, shape in SKIPS:
        with pytest.raises(ValueError, match="not runnable"):
            tsteps.build_cell(arch, shape, device="cpu")


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _leaves(tree):
    """[(shape, dtype name)] of a tree of TensorDefs or ShapeDtypeStructs, in the
    sorted flatten order both packages use."""
    return [(tuple(d.shape), str(d.dtype).removeprefix("torch."))
            for _, d in tree_flatten_sorted(tree)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_matches_the_jax_cell(arch, shape):
    """Full width: spec, microbatches (the train step's M), donated arguments, and
    the abstract arguments' tree and leaves, shape and dtype."""
    _jax()
    from repro.launch.steps import build_cell as j_build
    jcell = j_build(arch, shape, _auto_mesh())
    tcell = tsteps.build_cell(arch, shape, device="cpu")
    assert dataclasses.asdict(tcell.spec) == dataclasses.asdict(jcell.spec)
    assert tcell.name == jcell.name and tcell.cfg == tconfigs.get(arch)
    assert tcell.donate_argnums == jcell.donate_argnums
    if tcell.spec.step == "train":
        assert tcell.fn.num_microbatches == _closure(jcell.fn)["M"] == (
            8 if tcell.spec.global_batch >= 64 else 1)
    assert len(tcell.abstract_args) == len(jcell.abstract_args)
    for t, j in zip(tcell.abstract_args, jcell.abstract_args):
        assert _leaves({"a": t}) == _leaves({"a": j})
    assert _leaves(tcell.model.abstract_params()) == _leaves(jcell.model.abstract_params())


# ----------------------------------------------------------- reduced, against JAX
def _cfgs(arch="qwen3-0.6b", **overrides):
    """The reduced config in both packages, f32 (the parity dtype)."""
    from repro.configs import base as jconfigs
    kw = {"dtype": "float32", **overrides}
    return (dataclasses.replace(jconfigs.get(arch).reduced(), **kw),
            dataclasses.replace(tconfigs.get(arch).reduced(), **kw))


@pytest.fixture(scope="module")
def jax_train():
    """The JAX train_4k cell's step (M = 8) on reduced f32 qwen3 from its init
    state, on 8 x 16 tokens: (state before, state after, metrics, batch)."""
    jax = _jax()
    from repro.launch.steps import build_cell as j_build, init_train_state as j_init
    from repro.optim.adamw import AdamWConfig as JOpt
    jcfg, _ = _cfgs()
    jcell = j_build(jcfg, "train_4k", _auto_mesh(), opt_cfg=JOpt(**OPT))
    state = j_init(jcell.model, jax.random.PRNGKey(0))
    before = _np_tree(state)
    b = _batch(8, 16, jcfg.vocab_size, seed=3)
    new, met = jax.jit(jcell.fn)(state, _jbatch(b))
    return before, _np_tree(new), met, b


@pytest.mark.parametrize("remat", REMAT_MODES)
def test_train_cell_matches_jax(remat, jax_train):
    """The port's train_4k cell (M = 8, as the JAX cell) in each remat mode against
    the JAX cell's step (remat "full", the config's): loss, grad_norm, lr, tokens
    (LOSS_TOL); params and master (MASTER_TOL); m and v (MOMENT_TOL)."""
    before, want, jmet, b = jax_train
    _, tcfg = _cfgs()
    tcell = tsteps.build_cell(tcfg, "train_4k", tsteps.CellOptions(remat=remat),
                              AdamWConfig(**OPT), device="cpu")
    assert tcell.cfg.remat == remat and tcell.fn.num_microbatches == 8
    new, met = tcell.fn(train_state_to_torch(before, "cpu"), _tbatch(b))
    for key in ("loss", "grad_norm", "lr", "tokens"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=key)
    want, got = _named(want), _named(new)
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        tol = MOMENT_TOL if name.startswith(("opt/m/", "opt/v/")) else MASTER_TOL
        np.testing.assert_allclose(_f32(got[name]), np.asarray(w, np.float32), rtol=tol,
                                   atol=tol, err_msg=name)


def test_accum_dtype_sums_the_microbatches_in_that_dtype():
    """accum_dtype=bfloat16: the gradients summed in bf16, then f32 / M, as the
    JAX step: against the same step's f32 sum, the same loss and a grad_norm
    within bf16's rounding; a batch off the microbatches is refused."""
    _, tcfg = _cfgs()
    b = _tbatch(_batch(4, 16, tcfg.vocab_size, seed=4))
    out = {}
    for dt in ("float32", "bfloat16"):
        cell = tsteps.build_cell(tcfg, "train_4k", tsteps.CellOptions(
            num_microbatches=4, accum_dtype=dt), AdamWConfig(**OPT), device="cpu")
        out[dt] = cell.fn(tsteps.init_train_state(cell.model, 0), b)[1]
    assert torch.equal(out["float32"]["loss"], out["bfloat16"]["loss"])
    gf, gb = float(out["float32"]["grad_norm"]), float(out["bfloat16"]["grad_norm"])
    assert gf != gb and abs(gf - gb) <= 2 ** -7 * gf
    with pytest.raises(ValueError, match="multiple of 4 microbatches"):
        cell.fn(tsteps.init_train_state(cell.model, 0),
                _tbatch(_batch(6, 16, tcfg.vocab_size)))


def test_prefill_and_decode_cells_match_jax():
    """prefill_32k's step (a 32,768-slot cache) on 2 x 16 tokens, then decode_32k's
    step for one token on that cache, each package on its own prefill's cache, in
    the configs' bf16: last logits and the decode logits within the JAX suite's
    bf16 tolerance, 0.08; the filled cache rows too. The decode cell writes its
    cache in place (its donated argument)."""
    jax = _jax()
    jnp = jax.numpy
    from repro.launch.steps import build_cell as j_build
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    mesh = _auto_mesh()
    jpre, jdec = j_build(jcfg, "prefill_32k", mesh), j_build(jcfg, "decode_32k", mesh)
    tpre = tsteps.build_cell(tcfg, "prefill_32k", device="cpu")
    tdec = tsteps.build_cell(tcfg, "decode_32k", device="cpu")
    assert tdec.donate_argnums == (2,)
    jp = jpre.model.init_params(jax.random.PRNGKey(1))
    tp = to_torch(_np_tree(jp), "cpu")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    jlast, jcache = jax.jit(jpre.fn)(jp, {"tokens": jnp.asarray(toks[:, :16])})
    tlast, tcache = tpre.fn(tp, {"tokens": torch.from_numpy(toks[:, :16].copy())})
    np.testing.assert_allclose(_f32(tlast), np.asarray(jlast, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)
    for (path, got), want in zip(tree_flatten_sorted(tcache),
                                 jax.tree_util.tree_leaves(jcache)):
        assert tuple(got.shape) == want.shape, path
        if got.dim() == 5:          # [L, B, S, K, hd]: the 16 filled rows
            np.testing.assert_allclose(_f32(got[:, :, :16]), np.asarray(
                want[:, :, :16], np.float32), rtol=BF16_TOL, atol=BF16_TOL, err_msg=str(path))
    assert tcache["layers"][0]["k"].shape[2] == SHAPES["prefill_32k"].seq_len
    jlog, jnew = jax.jit(jdec.fn)(jp, jnp.asarray(toks[:, 16:]), jcache)
    k_before = tcache["layers"][0]["k"]
    tlog, tnew = tdec.fn(tp, torch.from_numpy(toks[:, 16:].copy()), tcache)
    np.testing.assert_allclose(_f32(tlog), np.asarray(jlog, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert tnew["layers"][0]["k"] is k_before and int(tnew["pos"][0]) == 17
    assert int(jnew["pos"][0]) == 17


def test_titchener_cell_matches_jax():
    """The train_4k cell with titchener=True: one local-SGD round (H = 2 by
    ``extra``, one pod; the JAX cell on an Auto-axis (pod, data, model) mesh of
    one device) from the same converted state, on [2, 1, 2, 16] batches:
    the new state leaf by leaf and delta_norm, with the tolerances and the int8
    flip rule by which tests/test_torch_local_sgd.py holds the round."""
    jax = _jax()
    from repro.launch.steps import CellOptions as JOpts, build_cell as j_build
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.optim.local_sgd import init_local_sgd_state as j_init
    from jax.sharding import AxisType, Mesh
    jcfg, tcfg = _cfgs(num_layers=2)
    extra = (("inner_steps", 2),)
    # the JAX round's state specs name a "pod" axis: a mesh of one pod
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1), ("pod", "data", "model"),
                axis_types=(AxisType.Auto,) * 3)
    jcell = j_build(jcfg, "train_4k", mesh, JOpts(titchener=True, extra=extra), JOpt(**OPT))
    tcell = tsteps.build_cell(tcfg, "train_4k", tsteps.CellOptions(titchener=True, extra=extra),
                              AdamWConfig(**OPT), device="cpu")
    state_abs, batches_abs = tcell.abstract_args
    assert batches_abs["tokens"].shape == (2, 1, 128, 4096)
    assert state_abs["pod_opt"]["step"].shape == (1,) and tcell.donate_argnums == (0,)
    jstate = j_init(jcell.model.init_params(jax.random.PRNGKey(0)), 1)
    tstate = local_sgd_state_to_torch(_np_tree(jstate), "cpu")
    assert _leaves(tstate) == _leaves(state_abs)
    b = _round_batches(np.random.default_rng(2), jcfg.vocab_size, 2, 1)
    jnew, jmet = jax.jit(jcell.fn)(jstate, _jb(b))
    tnew, tmet = tcell.fn(tstate, _tb(b))
    np.testing.assert_allclose(float(tmet["delta_norm"]), float(jmet["delta_norm"]),
                               rtol=DELTA_NORM_RTOL)
    want, got = _named(_np_tree(jnew)), _named(tnew)
    assert sorted(want) == sorted(got)
    flips = size = 0
    for name, w in want.items():
        g = got[name].numpy()
        if name in ("round", "pod_opt/step"):
            assert np.array_equal(g, w), name
        elif name.startswith(("pod_opt/m/", "pod_opt/v/")):
            np.testing.assert_allclose(g, w, rtol=MOMENT_TOL, atol=MOMENT_TOL, err_msg=name)
        elif name.startswith("ef/"):
            diff = np.abs(g[0] - w[0])
            off = diff > EF_TOL
            assert (diff[off] <= 1.01 * 2 * np.abs(w[0]).max() + EF_TOL).all(), name
            flips, size = flips + int(off.sum()), size + diff.size
        else:
            np.testing.assert_allclose(g, w, rtol=ROUND_TOL, atol=ROUND_TOL, err_msg=name)
    assert flips <= EF_FLIP_SHARE * size
    assert int(tnew["round"]) == 1 and tnew["pod_opt"]["step"].tolist() == [2]
