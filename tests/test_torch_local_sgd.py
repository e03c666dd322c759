"""PyTorch port, local SGD (the Titchener trainer mode): the round
(``repro_torch.optim.local_sgd.make_round_fn``), ``Trainer(mode="local_sgd")``,
its tasks and its checkpoints, on ``device="cpu"`` against the JAX package on
the same converted state and numpy batches; plus twins of
tests/test_local_sgd.py on the port.

The JAX round is ``make_round_fn(..., spmd_axis=None)`` (the pods a plain vmap)
on a model built on an Auto-axis mesh through ``pod_free_plan``, jitted as the
JAX Trainer runs it; the JAX Trainer gets that mesh too. Parity runs in f32.
Tolerances are named where they are used; test_torch_compression.py holds the
quantizer bit for bit and the outer step from the same pod masters."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import local_sgd_state_to_torch  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import local_sgd as TL  # noqa: E402
from repro_torch.runtime.step_cache import (TrainerCache, run_eval_task,  # noqa: E402
                                            run_train_task)
from repro_torch.runtime.train_loop import Trainer, TrainJobConfig  # noqa: E402
from repro_torch.tree import tree_flatten_sorted, tree_map  # noqa: E402
from test_torch_model import _auto_mesh, _jax  # noqa: E402
from test_torch_train import (BF16_LOSS_TOL, MOMENT_TOL, OPT, _bits, _named,  # noqa: E402
                              _np_tree)
from test_torch_model import _one_torch_thread  # noqa: E402,F401

# master, momentum and the pods' params and masters after a round from the same
# state. The pods' masters after the inner steps differ where Adam's eps term
# amplifies a gradient's summation-order difference (as the sync step's master
# does, tests/test_torch_train.py), and an element of the int8 delta that lies on
# a rounding boundary may round the other way, which moves the mean delta by one
# int8 step over P and the master by outer_lr (1 + mu) times that (~2e-5 here).
# Measured at most 5.64e-5 (deepseek-moe-16b uncompressed: its rarely routed
# experts' near-zero gradients).
ROUND_TOL = 1e-4
# the new error feedback: within EF_TOL (measured at most 7.7e-7), except the
# elements whose int8 value rounded the other way (measured 40-184 of 1.1-3.9M,
# at most 0.0052%), which differ by one int8 step, s = max|v| / 127: at most
# EF_FLIP_SHARE of the elements, each by at most 1.01 x 2 max|ef| (|ef| <= s / 2
# elsewhere; measured 1.00006 x)
EF_TOL, EF_FLIP_SHARE = 1e-6, 5e-4
DELTA_NORM_RTOL = 1e-5   # measured 1.9e-6
CPU = {"device": "cpu"}
SMALL = {"seq_len": 8, "global_batch": 4, "n_pods": 2, **CPU}


def _jax_model(arch, **overrides):
    from repro.configs import base as jconfigs
    from repro.models.model import Model as JModel
    from repro.optim.local_sgd import pod_free_plan
    from repro.parallel.sharding import MeshPlan
    cfg = dataclasses.replace(jconfigs.get(arch).reduced(), remat="none", **overrides)
    return JModel(cfg, pod_free_plan(MeshPlan(mesh=_auto_mesh(), fsdp=False)))


def _round_batches(rng, vocab, H, P, B=2, S=16):
    """numpy [H, P, B, S] tokens/targets and a loss mask with a few zeros."""
    toks = rng.integers(0, vocab, (H, P, B, S + 1)).astype(np.int32)
    mask = np.ones((H, P, B, S), np.float32)
    mask[..., :2] = 0.0
    return {"tokens": toks[..., :-1], "targets": toks[..., 1:], "loss_mask": mask}


def _jb(b):
    jnp = _jax().numpy
    return {"tokens": jnp.asarray(b["tokens"]), "targets": jnp.asarray(b["targets"]),
            "loss_mask": jnp.asarray(b["loss_mask"]).astype(jnp.bfloat16)}


def _tb(b):
    return {"tokens": torch.from_numpy(b["tokens"].copy()),
            "targets": torch.from_numpy(b["targets"].copy()),
            "loss_mask": torch.from_numpy(b["loss_mask"].copy()).to(torch.bfloat16)}


# (arch, P, compress, nesterov, overrides): compression and Nesterov on and off,
# P = 2 and 3, the dense, ssm and moe families (deepseek-moe-16b at capacity 4.0 =
# E / K of its reduced 8 experts, top-2, where nothing can drop)
NO_DROP = {"capacity_factor": 4.0}
ROUND_CASES = [
    pytest.param("qwen3-0.6b", 2, True, True, {}, id="qwen3-0.6b-2-int8-nesterov"),
    pytest.param("qwen3-0.6b", 2, False, True, {}, id="qwen3-0.6b-2-f32-nesterov"),
    pytest.param("qwen3-0.6b", 2, True, False, {}, id="qwen3-0.6b-2-int8-heavy_ball"),
    pytest.param("qwen3-0.6b", 3, True, True, {}, id="qwen3-0.6b-3-int8-nesterov"),
    pytest.param("mamba2-2.7b", 2, True, True, {}, id="mamba2-2.7b-2-int8-nesterov"),
    pytest.param("mamba2-2.7b", 3, False, False, {}, id="mamba2-2.7b-3-f32-heavy_ball"),
    pytest.param("deepseek-moe-16b", 2, True, True, NO_DROP, id="deepseek-moe-16b-2-int8-nesterov"),
    pytest.param("deepseek-moe-16b", 3, False, True, NO_DROP, id="deepseek-moe-16b-3-f32-nesterov"),
]


def _jax_round(arch, n_pods, compress, nesterov, overrides):
    """The JAX side of one ROUND_CASES case, built: a function that returns (the
    state after its own first round, the second round's batches, the state and
    delta_norm after that round)."""
    jax = _jax()
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.optim.local_sgd import LocalSGDConfig as JLocal, init_local_sgd_state, make_round_fn
    lcfg = JLocal(inner_steps=2, compress=compress, nesterov=nesterov)
    jm = _jax_model(arch, dtype="float32", **overrides)
    jround = jax.jit(make_round_fn(jm.loss_fn, JOpt(**OPT), lcfg, spmd_axis=None))
    rng = np.random.default_rng(1)
    start = init_local_sgd_state(jm.init_params(jax.random.PRNGKey(0)), n_pods)
    first, b = (_round_batches(rng, jm.cfg.vocab_size, 2, n_pods) for _ in range(2))

    def run():
        jstate, _ = jround(start, _jb(first))
        jnew, jmet = jround(jstate, _jb(b))
        return _np_tree(jstate), b, _np_tree(jnew), float(jmet["delta_norm"])
    return run


@pytest.fixture(scope="module")
def jax_rounds():
    """Every ROUND_CASES case's JAX rounds, built in turn, then compiled and run
    once for the module on four threads (XLA compiles and runs with the GIL
    released)."""
    from concurrent.futures import ThreadPoolExecutor
    cases = [tuple(p.values) for p in ROUND_CASES]
    runs = [_jax_round(*c) for c in cases]
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(map(_key, cases), pool.map(lambda run: run(), runs)))


def _key(case) -> tuple:
    *head, overrides = case
    return (*head, tuple(sorted(overrides.items())))


@pytest.mark.parametrize("arch,n_pods,compress,nesterov,overrides", ROUND_CASES)
def test_round_matches_jax(jax_rounds, arch, n_pods, compress, nesterov, overrides):
    """One round (H = 2) from the same state: the JAX state after one round of its
    own (a nonzero momentum and error feedback, pod steps at 2) converted, then
    the same batches through both. Every leaf of the new state; delta_norm."""
    H = 2
    lcfg = TL.LocalSGDConfig(inner_steps=H, compress=compress, nesterov=nesterov)
    tm = TModel(dataclasses.replace(tconfigs.get(arch).reduced(), remat="none", dtype="float32",
                                    **overrides), "cpu")
    jstate, b, jnew, jnorm = jax_rounds[_key((arch, n_pods, compress, nesterov, overrides))]
    tstate = local_sgd_state_to_torch(jstate, "cpu")
    tnew, tmet = TL.make_round_fn(tm, tadamw.AdamWConfig(**OPT), lcfg)(tstate, _tb(b))

    want, got = _named(jnew), _named(tnew)
    assert sorted(got) == sorted(want)
    flips = size = 0
    for name, w in want.items():
        g = got[name].numpy()
        if name in ("round", "pod_opt/step"):
            assert np.array_equal(g, w) and g.dtype == np.int32, name
        elif name.startswith(("pod_opt/m/", "pod_opt/v/")):
            np.testing.assert_allclose(g, w, rtol=MOMENT_TOL, atol=MOMENT_TOL, err_msg=name)
        elif name.startswith("ef/"):
            for p in range(n_pods):
                diff = np.abs(g[p] - w[p])
                off = diff > EF_TOL
                step = 2 * np.abs(w[p]).max()
                assert (diff[off] <= 1.01 * step + EF_TOL).all(), (name, p, diff.max(), step)
                flips, size = flips + int(off.sum()), size + diff.size
        else:
            np.testing.assert_allclose(g, w, rtol=ROUND_TOL, atol=ROUND_TOL, err_msg=name)
    assert flips <= EF_FLIP_SHARE * size, f"{flips} of {size} int8 elements rounded otherwise"
    if not compress:
        assert flips == 0
    assert int(tnew["round"]) == 2 and tnew["pod_opt"]["step"].tolist() == [2 * H] * n_pods
    np.testing.assert_allclose(float(tmet["delta_norm"]), jnorm, rtol=DELTA_NORM_RTOL)


def test_round_refuses_batches_of_another_layout():
    tm = TModel(dataclasses.replace(tconfigs.get("qwen3-0.6b").reduced(), remat="none"), "cpu")
    state = TL.init_local_sgd_state(tm.init_params(0), 2)
    round_fn = TL.make_round_fn(tm, tadamw.AdamWConfig(), TL.LocalSGDConfig(inner_steps=2))
    b = _tb(_round_batches(np.random.default_rng(0), 512, 3, 2, S=4))
    with pytest.raises(ValueError, match="H, n_pods"):
        round_fn(state, b)


# --------------------------------------------------- twins of tests/test_local_sgd.py
def _tiny(dtype="bfloat16"):
    """tests/test_local_sgd.py's tiny_model on the port."""
    cfg = dataclasses.replace(tconfigs.get("qwen3-0.6b").reduced(), remat="none",
                              num_layers=2, d_model=64, d_ff=128, vocab_size=128,
                              num_heads=2, num_kv_heads=1, head_dim=32, dtype=dtype)
    model = TModel(cfg, "cpu")
    return cfg, model, model.init_params(0)


def test_single_pod_h1_equals_sync_adamw():
    """Twin of tests/test_local_sgd.py's: with H = 1, no compression, outer_lr 1 and
    no momentum, one pod's round is one synchronous AdamW step."""
    cfg, model, params = _tiny()
    opt_cfg = tadamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=100,
                                 weight_decay=0.0)
    lcfg = TL.LocalSGDConfig(inner_steps=1, outer_lr=1.0, outer_momentum=0.0,
                             nesterov=False, compress=False)
    state = TL.init_local_sgd_state(params, n_pods=1)
    b = _tb(_round_batches(np.random.default_rng(1), cfg.vocab_size, 1, 1, S=8))
    state, _ = TL.make_round_fn(model, opt_cfg, lcfg)(state, b)
    ref = tsteps.make_train_step(model, opt_cfg, 1)(
        {"params": params, "opt": tadamw.init_opt_state(params)},
        {k: v[0, 0] for k, v in b.items()})[0]
    for (path, a), (_, r) in zip(tree_flatten_sorted(state["master"]),
                                 tree_flatten_sorted(ref["opt"]["master"])):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=2e-5, atol=2e-5, err_msg=str(path))


def test_round_reduces_loss_and_pods_stay_synced():
    """Twin of tests/test_local_sgd.py's: six rounds of 2 pods, H = 4, int8 with
    error feedback, on random tokens; every pod's params equal the master cast to
    bf16, bit for bit."""
    cfg, model, params = _tiny()
    opt_cfg = tadamw.AdamWConfig(peak_lr=5e-3, warmup_steps=1, total_steps=1000,
                                 weight_decay=0.0)
    lcfg = TL.LocalSGDConfig(inner_steps=4, compress=True)
    state = TL.init_local_sgd_state(params, n_pods=2)
    round_fn = TL.make_round_fn(model, opt_cfg, lcfg)
    rng = np.random.default_rng(7)
    eval_b = {k: v[0, 0] for k, v in _tb(_round_batches(rng, cfg.vocab_size, 1, 1, S=8)).items()}

    def eval_loss():
        with torch.no_grad():
            return float(model.loss_fn(tree_map(lambda m: m.to(torch.bfloat16),
                                                state["master"]), eval_b)[0])

    loss0 = eval_loss()
    losses = []
    for _ in range(6):
        state, metrics = round_fn(state, _tb(_round_batches(rng, cfg.vocab_size, 4, 2, S=8)))
        assert np.isfinite(float(metrics["delta_norm"]))
        losses.append(eval_loss())
    # the outer Nesterov step overshoots on this toy problem (tests/test_local_sgd.py)
    assert min(losses) < loss0 - 0.1, (loss0, losses)
    for (_, wp), (_, gm) in zip(tree_flatten_sorted(state["pod_params"]),
                                tree_flatten_sorted(state["master"])):
        assert torch.equal(wp[0], wp[1]) and torch.equal(wp[0], gm.to(wp.dtype))


# ------------------------------------------------------------------ trainer and tasks
def _local(**kw):
    return TrainJobConfig(mode="local_sgd", **{**SMALL, **kw})


def test_trainer_counts_inner_steps_and_evaluates_the_master():
    tr = Trainer(_local(local_sgd=TL.LocalSGDConfig(inner_steps=2)))
    m = tr.step_once()
    assert tr.step == 2 and int(tr.state["round"]) == 1 and set(m) == {"delta_norm"}
    tr.run(3)                                 # overshoots to a multiple of H, as in JAX
    assert tr.step == 6 and int(tr.state["round"]) == 3
    assert tr.state["pod_opt"]["step"].tolist() == [6, 6]
    assert tr.loss() is None and len(tr.metrics.series("delta_norm")) == 3
    ev = tr.params_for_eval()
    for (_, e), (_, m), (_, pods) in zip(*(tree_flatten_sorted(t) for t in (
            ev, tr.state["master"], tr.state["pod_params"]))):
        assert e.dtype == torch.bfloat16 and torch.equal(e, m.to(torch.bfloat16))
        assert all(torch.equal(pods[p], e) for p in range(2))
    batches = tr._round_batches(6)
    assert batches["tokens"].shape == (2, 2, 2, 8)       # [H, P, B/P, S]
    assert torch.equal(batches["tokens"][1, 1], tr.data.batch_at(7, shard_id=1, batch=2)["tokens"])


def test_rebind_draws_the_local_sgd_state_again():
    cache = TrainerCache(2)
    payload = {"mode": "local_sgd", "steps": 4, **SMALL}
    a = run_train_task(cache, dict(payload))
    tr = cache.get(TrainJobConfig.from_job({"payload": payload}))    # a hit: rebound
    fresh = Trainer(_local())
    for (path, x), (_, y) in zip(tree_flatten_sorted(tr.state), tree_flatten_sorted(fresh.state)):
        assert torch.equal(x, y), path
    assert tr.step == 0 and cache.stats()["hits"] == 1
    b = run_train_task(cache, dict(payload))
    assert a == dict(b, step_ema_s=a["step_ema_s"])
    tr.rebind(_local(seed=1))
    assert not torch.equal(tr.state["master"]["embed"], fresh.state["master"]["embed"])


def test_restore_matches_uninterrupted_run(tmp_path):
    """Twin of tests/test_fault_tolerance.py's test of the same name in local_sgd
    mode: restored at step 4, the next rounds are the uninterrupted run's, exactly."""
    kw = dict(local_sgd=TL.LocalSGDConfig(inner_steps=2), seed=3)
    ref = Trainer(_local(steps=8, **kw))
    ref.run()
    a = Trainer(_local(steps=4, checkpoint_every=100, checkpoint_dir=str(tmp_path), **kw))
    a.run()
    a.save_checkpoint()
    b = Trainer(_local(steps=8, checkpoint_every=100, checkpoint_dir=str(tmp_path), **kw))
    assert b.restore(strict=True) == 4 and b.data.step == 0
    b.run(4)
    assert b.metrics.series("delta_norm") == ref.metrics.series("delta_norm")[2:]
    for (path, x), (_, y) in zip(tree_flatten_sorted(b.state), tree_flatten_sorted(ref.state)):
        assert torch.equal(x, y), path


@pytest.fixture
def jax_trainers(monkeypatch):
    """The JAX package's trainer module, its trainers built on the Auto-axis mesh."""
    _jax()
    import repro.runtime.train_loop as jtl
    monkeypatch.setattr(jtl, "make_test_mesh", _auto_mesh)
    return jtl


def test_tasks_match_jax(jax_trainers, tmp_path):
    """run_train_task and run_eval_task in local_sgd mode: the same keys and values
    as the JAX package's (``loss`` None: the round's only metric is delta_norm),
    each eval a strict restore of its own package's checkpoint."""
    from repro.runtime import step_cache as jsc
    base = {"mode": "local_sgd", "seq_len": 8, "global_batch": 4, "steps": 4,
            "checkpoint_every": 4, "local_sgd": {"inner_steps": 2}}
    out = {}
    for name, train, evaluate, extra in (("jax", jsc.run_train_task, jsc.run_eval_task, {}),
                                         ("port", run_train_task, run_eval_task, CPU)):
        payload = {**base, **extra, "checkpoint_dir": str(tmp_path / name)}
        res = train(None, dict(payload))
        ev = evaluate(None, {**base, **extra, "restore_from": res["checkpoint"]})
        out[name] = (res, ev)
    (jres, jev), (tres, tev) = out["jax"], out["port"]
    assert sorted(tres) == sorted(jres) and sorted(tev) == sorted(jev)
    for key in ("steps", "ran_steps", "resumed_from", "loss"):
        assert tres[key] == jres[key], key
    assert tres["loss"] is None and tres["steps"] == 4
    assert tres["checkpoint"] == {"step": 4, "path": str(tmp_path / "port")}
    assert jres["checkpoint"] == {"step": 4, "path": str(tmp_path / "jax")}
    assert tev["restored_step"] == jev["restored_step"] == 4
    assert np.isfinite(tev["eval_loss"]) and np.isfinite(jev["eval_loss"])


def _leaf_bits(tree):
    return {k: (_bits(v) if isinstance(v, torch.Tensor) else
                (np.asarray(v).view(np.int16) if np.asarray(v).dtype.name == "bfloat16"
                 else np.asarray(v)))
            for k, v in _named(tree).items()}


def test_jax_local_sgd_checkpoint_restores_in_port(jax_trainers, tmp_path):
    """The JAX Trainer trains two rounds and saves; the port's Trainer restores it
    strictly, bit for bit, saves the same leaf files, and its eval task on that
    checkpoint gives the JAX model's loss on the port's eval batch."""
    jax = _jax()
    kw = {"mode": "local_sgd", "seq_len": 8, "global_batch": 4, "steps": 4,
          "checkpoint_dir": str(tmp_path / "jax"), "local_sgd": TL.LocalSGDConfig(inner_steps=2)}
    from repro.optim.local_sgd import LocalSGDConfig as JLocal
    jt = jax_trainers.Trainer(jax_trainers.TrainJobConfig(
        **dict(kw, local_sgd=JLocal(inner_steps=2))), mesh=_auto_mesh())
    jt.run()
    jt.save_checkpoint()
    tt = Trainer(TrainJobConfig(**kw, **CPU))
    assert tt.restore(strict=True) == 4
    want, got = _leaf_bits(_np_tree(jt.state)), _leaf_bits(tt.state)
    assert sorted(got) == sorted(want) and "pod_opt/step" in got and "round" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    tt.ckpt = type(tt.ckpt)(str(tmp_path / "port"))
    tt.save_checkpoint()
    jdir, tdir = tmp_path / "jax" / "step_00000004", tmp_path / "port" / "step_00000004"
    jman, tman = (json.loads((d / "manifest.json").read_text()) for d in (jdir, tdir))
    assert jman["leaves"] == tman["leaves"] and jman["extra"] == tman["extra"]
    assert tman["extra"]["mode"] == "local_sgd"
    for ent in jman["leaves"].values():
        assert (jdir / ent["file"]).read_bytes() == (tdir / ent["file"]).read_bytes()

    ev = run_eval_task(None, {**{k: v for k, v in kw.items() if k != "local_sgd"}, **CPU,
                              "local_sgd": {"inner_steps": 2},
                              "restore_from": {"path": str(tmp_path / "jax")}})
    batch = tt._sync_batch(10_000)
    jb = {"tokens": jax.numpy.asarray(batch["tokens"].numpy()),
          "targets": jax.numpy.asarray(batch["targets"].numpy()),
          "loss_mask": jax.numpy.ones(batch["loss_mask"].shape, jax.numpy.bfloat16)}
    want_loss = float(jt.model.loss_fn(jt.params_for_eval(), jb)[0])
    assert ev["restored_step"] == 4
    np.testing.assert_allclose(ev["eval_loss"], want_loss, rtol=BF16_LOSS_TOL, atol=BF16_LOSS_TOL)


def test_port_local_sgd_checkpoint_restores_in_jax(jax_trainers, tmp_path):
    """The port's Trainer trains two rounds and saves; the JAX Trainer restores it
    strictly, bit for bit."""
    from repro.optim.local_sgd import LocalSGDConfig as JLocal
    kw = {"mode": "local_sgd", "seq_len": 8, "global_batch": 4, "steps": 4,
          "checkpoint_dir": str(tmp_path)}
    tt = Trainer(TrainJobConfig(**kw, local_sgd=TL.LocalSGDConfig(inner_steps=2), **CPU))
    tt.run()
    tt.save_checkpoint()
    jt = jax_trainers.Trainer(jax_trainers.TrainJobConfig(**kw, local_sgd=JLocal(inner_steps=2)),
                              mesh=_auto_mesh())
    assert jt.restore(strict=True) == 4
    want, got = _leaf_bits(tt.state), _leaf_bits(_np_tree(jt.state))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert jt.data.state_dict() == tt.data.state_dict()
