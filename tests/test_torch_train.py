"""PyTorch port, training slice: ``Model.loss_fn``, the train step, AdamW and its
schedule, the data pipeline, the checkpoint format and the trainer's task
semantics, run on ``device="cpu"`` (the kernels' plain versions, through their
autograd Functions) against the JAX package on the same converted state and
numpy batches. The JAX reference is built on an Auto-axis mesh, as
``tests/test_torch_model.py`` builds it. Parity runs in f32, where the two
packages differ only in summation order; tolerances are named where used."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager as TCkpt  # noqa: E402
from repro_torch.convert import to_torch, train_state_to_torch  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim.schedules import warmup_cosine  # noqa: E402
from repro_torch.runtime.step_cache import (TrainerCache, run_eval_task,  # noqa: E402
                                            run_train_task)
from repro_torch.runtime.train_loop import Trainer, TrainJobConfig  # noqa: E402
from repro_torch.tree import tree_flatten_sorted  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401


OPT = dict(peak_lr=1e-2, warmup_steps=20, total_steps=2000, weight_decay=0.1)
# f32 loss and grad_norm: the same ops in another summation order (~1e-6 relative)
LOSS_TOL = 1e-5
# f32 state after one step. m = 0.1 g and v = 0.05 g^2 are linear and quadratic in
# the gradient: they hold the gradients themselves (measured ~1e-8 apart).
MOMENT_TOL = 1e-7
# master and params move by lr * g / (|g| + eps) at step 1: where |g| is near eps
# (1e-8) a summation-order difference of ~1e-9 in g moves that element by up to
# lr * dg / eps (measured 0.21 lr), and a wrong sign of any gradient by 2 lr. They
# are held at half a learning-rate step (lr = peak_lr / warmup_steps at step 1).
MASTER_TOL = 0.5 * OPT["peak_lr"] / OPT["warmup_steps"]
BF16_LOSS_TOL = 0.02     # bf16 CE: rounding of the bf16 logits in two frameworks
CPU = {"device": "cpu"}


def _jax():
    return pytest.importorskip("jax")


def _auto_mesh():
    jax = _jax()
    from jax.sharding import AxisType, Mesh
    return Mesh(np.array(jax.devices()).reshape(1, -1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


def _cfg(arch="qwen3-0.6b", **overrides):
    return dataclasses.replace(tconfigs.get(arch).reduced(), remat="none", **overrides)


def _jax_model(arch="qwen3-0.6b", **overrides):
    from repro.configs import base as jconfigs
    from repro.models.model import Model as JModel
    from repro.parallel.sharding import MeshPlan
    cfg = dataclasses.replace(jconfigs.get(arch).reduced(), remat="none", **overrides)
    return JModel(cfg, MeshPlan(mesh=_auto_mesh(), fsdp=False))


def _np_tree(tree):
    jax = _jax()
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(B, S, vocab, seed=0):
    """tokens/targets int32 and a loss mask with a few zeros, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, :3] = 0.0
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "loss_mask": mask}


def _jbatch(b):
    jnp = _jax().numpy
    return {"tokens": jnp.asarray(b["tokens"]), "targets": jnp.asarray(b["targets"]),
            "loss_mask": jnp.asarray(b["loss_mask"]).astype(jnp.bfloat16)}


def _tbatch(b):
    return {"tokens": torch.from_numpy(b["tokens"].copy()),
            "targets": torch.from_numpy(b["targets"].copy()),
            "loss_mask": torch.from_numpy(b["loss_mask"].copy()).to(torch.bfloat16)}


def _named(tree):
    return {"/".join(map(str, p)): leaf for p, leaf in tree_flatten_sorted(tree)}


def _f32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ------------------------------------------------------------------------- loss_fn
# (arch, sequence length, dtype, loss_chunk, config overrides): qwen3-0.6b, the
# trained arch, in both dtypes and with the chunked CE; in f32 three more reduced
# dense archs: gemma3-12b at S=80 past its reduced window of 64, so its five local
# layers mask what its global layer sees (K1's windowed backward), also at its
# real head dim 256, phi4-mini-3.8b (no qk-norm) and qwen3-32b; mamba2-2.7b, the
# trained ssm arch, in both dtypes at S=48, past one reduced chunk of 32, so the
# scan's ragged tail is differentiated
LOSS_CASES = [
    pytest.param("qwen3-0.6b", 32, "float32", 0, {}, id="float32-0"),
    pytest.param("qwen3-0.6b", 32, "float32", 8, {}, id="float32-8"),
    pytest.param("qwen3-0.6b", 32, "bfloat16", 0, {}, id="bfloat16-0"),
    pytest.param("gemma3-12b", 80, "float32", 0, {}, id="gemma3-12b-float32-0"),
    pytest.param("gemma3-12b", 80, "float32", 0, {"head_dim": 256},
                 id="gemma3-12b-head_dim_256-float32-0"),
    pytest.param("phi4-mini-3.8b", 32, "float32", 0, {}, id="phi4-mini-3.8b-float32-0"),
    pytest.param("qwen3-32b", 32, "float32", 0, {}, id="qwen3-32b-float32-0"),
    pytest.param("mamba2-2.7b", 48, "float32", 0, {}, id="mamba2-2.7b-float32-0"),
    pytest.param("mamba2-2.7b", 48, "bfloat16", 0, {}, id="mamba2-2.7b-bfloat16-0"),
]


@pytest.mark.parametrize("arch,S,dtype,loss_chunk,overrides", LOSS_CASES)
def test_loss_fn_matches_jax(arch, S, dtype, loss_chunk, overrides):
    """Loss and metrics, and (f32) the gradient of every leaf."""
    jax = _jax()
    jm = _jax_model(arch, dtype=dtype, loss_chunk=loss_chunk, **overrides)
    tm = TModel(_cfg(arch, dtype=dtype, loss_chunk=loss_chunk, **overrides), "cpu")
    jp = jm.init_params(jax.random.PRNGKey(2))
    tp = to_torch(_np_tree(jp), "cpu")
    b = _batch(2, S, jm.cfg.vocab_size, seed=1)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, _jbatch(b))
    leaves = {k: v.requires_grad_(True) for k, v in _named(tp).items()}
    tl, tmet = tm.loss_fn(tp, _tbatch(b))
    tol = LOSS_TOL if dtype == "float32" else BF16_LOSS_TOL
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=tol, atol=tol)
    for key in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=tol, atol=tol)
    assert float(tmet["tokens"]) == 2 * (S - 3)
    if dtype == "float32":
        grads = torch.autograd.grad(tl, list(leaves.values()))
        for (name, _), g in zip(leaves.items(), grads):
            np.testing.assert_allclose(_f32(g), np.asarray(_named(jg)[name]),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def test_chunked_ce_needs_a_dividing_chunk():
    tm = TModel(_cfg(dtype="float32", loss_chunk=5), "cpu")
    with pytest.raises(ValueError, match="must divide"):
        tm.loss_fn(tm.init_params(0), _tbatch(_batch(1, 12, 512)))


# ----------------------------------------------------------------------- train step
@pytest.mark.parametrize("arch,microbatches,S", [
    pytest.param("qwen3-0.6b", 1, 16, id="1"), pytest.param("qwen3-0.6b", 2, 16, id="2"),
    pytest.param("mamba2-2.7b", 1, 16, id="mamba2-2.7b-1"),
    pytest.param("mamba2-2.7b", 2, 16, id="mamba2-2.7b-2"),
    pytest.param("gemma3-12b", 1, 80, id="gemma3-12b-1")])
def test_train_step_matches_jax(arch, microbatches, S):
    """One step from a converted JAX train state: loss, grad_norm, lr, tokens, and
    params, m, v, master leaf by leaf. gemma3 at S=80, past its reduced window."""
    jax = _jax()
    from repro.launch.steps import init_train_state as j_init, make_train_step as j_step
    from repro.optim.adamw import AdamWConfig as JOpt
    jm = _jax_model(arch, dtype="float32")
    tm = TModel(_cfg(arch, dtype="float32"), "cpu")
    jstate = j_init(jm, jax.random.PRNGKey(0))
    tstate = train_state_to_torch(_np_tree(jstate), "cpu")
    b = _batch(4, S, jm.cfg.vocab_size, seed=3)
    jnew, jmet = jax.jit(j_step(jm, JOpt(**OPT), microbatches))(jstate, _jbatch(b))
    tnew, tmet = tsteps.make_train_step(tm, tadamw.AdamWConfig(**OPT), microbatches)(
        tstate, _tbatch(b))
    for key in ("loss", "grad_norm", "lr", "tokens", "aux_loss"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=key)
    assert int(tnew["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    want, got = _named(_np_tree(jnew)), _named(tnew)
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        tol = MOMENT_TOL if name.startswith(("opt/m/", "opt/v/")) else MASTER_TOL
        np.testing.assert_allclose(_f32(got[name]), np.asarray(w, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)


def test_adamw_update_and_schedule_match_jax():
    jax = _jax()
    jnp = jax.numpy
    from repro.optim.adamw import AdamWConfig as JOpt, adamw_update as j_update
    from repro.optim.schedules import warmup_cosine as j_wc
    rng = np.random.default_rng(5)
    params = {"b": rng.standard_normal((3, 4)).astype(np.float32),
              "a": {"w": rng.standard_normal((5,)).astype(np.float32)}}
    grads = {k: (np.random.default_rng(6).standard_normal(np.shape(v)) * 3).astype(np.float32)
             if k == "b" else {"w": rng.standard_normal((5,)).astype(np.float32)}
             for k, v in params.items()}
    state = {"m": {"b": rng.standard_normal((3, 4)).astype(np.float32) * .1,
                   "a": {"w": rng.standard_normal((5,)).astype(np.float32) * .1}},
             "v": {"b": rng.random((3, 4)).astype(np.float32),
                   "a": {"w": rng.random((5,)).astype(np.float32)}},
             "master": params, "step": np.array(6, np.int32)}
    cfg = dict(OPT, grad_clip=0.5, warmup_steps=4, total_steps=30)
    jp, js, jmet = j_update(jax.tree_util.tree_map(jnp.asarray, params),
                            jax.tree_util.tree_map(jnp.asarray, grads),
                            jax.tree_util.tree_map(jnp.asarray, state), JOpt(**cfg))
    tp, ts, tmet = tadamw.adamw_update(
        train_state_to_torch({"params": params, "opt": state}, "cpu")["params"],
        {k: (torch.from_numpy(v) if k == "b" else {"w": torch.from_numpy(v["w"])})
         for k, v in grads.items()},
        train_state_to_torch({"params": params, "opt": state}, "cpu")["opt"],
        tadamw.AdamWConfig(**cfg))
    for name, w in {**_named({"params": _np_tree(jp)}), **_named(_np_tree(js))}.items():
        got = _named({"params": tp, **ts})[name]
        np.testing.assert_allclose(_f32(got), np.asarray(w, np.float32), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-6)
    for step in (0, 1, 3, 4, 5, 17, 30, 45):
        np.testing.assert_allclose(
            float(warmup_cosine(step, peak_lr=1e-2, warmup_steps=4, total_steps=30)),
            float(j_wc(step, peak_lr=1e-2, warmup_steps=4, total_steps=30)), rtol=1e-6)


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("task", ["ramp", "random"])
def test_pipeline_is_a_pure_function_of_seed_step_shard(task):
    d = SyntheticTokens(vocab_size=300, seq_len=12, global_batch=4, seed=7, task=task,
                        num_shards=2)
    a = d.batch_at(5, shard_id=1)
    again = SyntheticTokens(vocab_size=300, seq_len=12, global_batch=4, seed=7, task=task,
                            num_shards=2).batch_at(5, shard_id=1)
    assert all(torch.equal(a[k], again[k]) for k in a)
    assert not torch.equal(a["tokens"], d.batch_at(6, shard_id=1)["tokens"])
    assert not torch.equal(a["tokens"], d.batch_at(5, shard_id=0)["tokens"])
    assert a["tokens"].shape == (2, 12) and a["tokens"].dtype == torch.int32
    assert a["loss_mask"].dtype == torch.bfloat16 and bool((a["loss_mask"] == 1).all())
    assert torch.equal(a["targets"][:, :-1], a["tokens"][:, 1:])   # shifted tokens
    assert int(a["tokens"].max()) < 300 and int(a["tokens"].min()) >= 0
    if task == "ramp":
        assert torch.equal(a["targets"], (a["tokens"] + 1) % 300)
    g = d.global_batch_at(3)
    assert all(torch.equal(g[k], d.batch_at(3, shard_id=0, batch=4)[k]) for k in g)


def test_pipeline_iterates_and_state_dict_round_trips():
    d = SyntheticTokens(vocab_size=64, seq_len=8, global_batch=2, seed=1)
    first = next(d)
    next(d)
    assert d.step == 2
    e = SyntheticTokens(vocab_size=64, seq_len=8, global_batch=2, seed=1)
    e.load_state_dict(json.loads(json.dumps(d.state_dict())))
    assert e.step == 2 and torch.equal(next(e)["tokens"], d.batch_at(2)["tokens"])
    assert torch.equal(first["tokens"], d.batch_at(0)["tokens"])
    with pytest.raises(ValueError, match="mismatch"):
        SyntheticTokens(vocab_size=64, seq_len=8, global_batch=2, seed=2).load_state_dict(
            d.state_dict())


# ----------------------------------------------------------------- checkpoints
def _jax_train_state(seed=0):
    """A bf16-param JAX train state after init (f32 opt, int32 step)."""
    jax = _jax()
    from repro.launch.steps import init_train_state as j_init
    state = j_init(_jax_model(), jax.random.PRNGKey(seed))
    state["opt"]["step"] = jax.numpy.asarray(3, jax.numpy.int32)
    return state


def _bits(t):
    a = t.detach().cpu()
    return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()


def test_port_checkpoint_restores_in_jax(tmp_path):
    from repro.checkpoint.manager import CheckpointManager as JCkpt
    jstate = _jax_train_state(1)
    tstate = train_state_to_torch(_np_tree(jstate), "cpu")
    TCkpt(str(tmp_path)).save(3, tstate, extra={"data": {"step": 3}}, blocking=True)
    restored, step, extra = JCkpt(str(tmp_path)).restore(jstate)
    assert step == 3 and extra == {"data": {"step": 3}}
    got, want = _named(_np_tree(restored)), _named(tstate)
    assert any(t.dtype == torch.bfloat16 for t in want.values())
    for name, t in want.items():
        g = np.asarray(got[name])
        assert str(g.dtype) == {torch.bfloat16: "bfloat16", torch.float32: "float32",
                                torch.int32: "int32"}[t.dtype]
        assert np.array_equal(g.view(np.int16) if t.dtype == torch.bfloat16 else g,
                              _bits(t)), name


def test_jax_checkpoint_restores_in_port_and_files_are_identical(tmp_path):
    from repro.checkpoint.manager import CheckpointManager as JCkpt
    jstate = _jax_train_state(2)
    tstate = train_state_to_torch(_np_tree(jstate), "cpu")
    JCkpt(str(tmp_path / "jax")).save(3, jstate, extra={"k": 1}, blocking=True)
    like = train_state_to_torch(_np_tree(_jax_train_state(4)), "cpu")
    restored, step, extra = TCkpt(str(tmp_path / "jax")).restore(like)
    assert step == 3 and extra == {"k": 1}
    for name, t in _named(tstate).items():
        r = _named(restored)[name]
        assert r.dtype == t.dtype and np.array_equal(_bits(r), _bits(t)), name
    # the same state saved by the port: the same bytes in every file
    TCkpt(str(tmp_path / "port")).save(3, tstate, extra={"k": 1}, blocking=True)
    jdir, tdir = tmp_path / "jax" / "step_00000003", tmp_path / "port" / "step_00000003"
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir()) and "manifest.json" in names
    for n in names:
        assert (jdir / n).read_bytes() == (tdir / n).read_bytes(), n


def test_restore_is_strict_about_torn_and_missing_leaves(tmp_path):
    state = {"a": torch.ones(4), "b": {"c": torch.zeros(2, dtype=torch.bfloat16)}}
    mgr = TCkpt(str(tmp_path))
    mgr.save(1, state, blocking=True)
    with pytest.raises(KeyError, match="no leaf"):
        mgr.restore(dict(state, z=torch.ones(1)))
    leaf = sorted((tmp_path / "step_00000001").glob("leaf_*.bin"))[0]
    leaf.write_bytes(leaf.read_bytes()[:-2])
    with pytest.raises(ValueError, match="bytes"):
        mgr.restore(state)
    with pytest.raises(FileNotFoundError):
        TCkpt(str(tmp_path / "empty")).restore(state)


# -------------------------------------------------------- trainer and tasks
def test_restore_matches_uninterrupted_run(tmp_path):
    """Twin of tests/test_fault_tolerance.py::test_restore_matches_uninterrupted_run."""
    kw = dict(arch="qwen3-0.6b", seq_len=16, global_batch=2, seed=3, **CPU)
    t_ref = Trainer(TrainJobConfig(steps=8, **kw))
    t_ref.run()
    ref_loss = t_ref.metrics.series("loss")

    t_a = Trainer(TrainJobConfig(steps=4, checkpoint_every=4,
                                 checkpoint_dir=str(tmp_path / "ck"), **kw))
    t_a.run()
    t_a.save_checkpoint()
    t_b = Trainer(TrainJobConfig(steps=8, checkpoint_every=100,
                                 checkpoint_dir=str(tmp_path / "ck"), **kw))
    assert t_b.restore() == 4
    t_b.run(4)
    assert ref_loss[4:] == pytest.approx(t_b.metrics.series("loss"), rel=1e-5)


def test_redelivered_train_task_resumes_not_reruns(tmp_path):
    """Twin of tests/test_fault_tolerance.py's test of the same name, on the task
    semantics (a plane's job moved across a cluster loss is
    tests/test_torch_local_plane.py's): the redelivered task restores the
    committed step and runs ZERO steps."""
    payload = {"arch": "qwen3-0.6b", "seq_len": 8, "global_batch": 2, "steps": 4,
               "checkpoint_every": 2, "checkpoint_dir": str(tmp_path / "ck"), **CPU}
    first = run_train_task(None, dict(payload))        # the worker dies after this
    assert first["steps"] == 4 and first["ran_steps"] == 4 and first["resumed_from"] == 0
    again = run_train_task(TrainerCache(), dict(payload))
    assert again["steps"] == 4 and again["ran_steps"] == 0
    assert again["resumed_from"] == 4
    assert again["checkpoint"] == {"step": 4, "path": str(tmp_path / "ck")}


def test_eval_fails_on_half_written_checkpoint(tmp_path):
    """Twin of tests/test_fault_tolerance.py's test of the same name: an eval task
    pointed at a torn or absent checkpoint raises (strict restore)."""
    ck = tmp_path / "ck"
    base = {"arch": "qwen3-0.6b", "seq_len": 8, "global_batch": 2, **CPU}
    tr = Trainer(TrainJobConfig(steps=2, checkpoint_dir=str(ck), **base))
    tr.run()
    tr.save_checkpoint()
    good = run_eval_task(None, {**base, "restore_from": {"path": str(ck)}})
    assert good["restored_step"] == 2 and np.isfinite(good["eval_loss"])
    leaf = sorted((ck / "step_00000002").glob("leaf_*.bin"))[0]
    leaf.write_bytes(leaf.read_bytes()[:-4])
    with pytest.raises(ValueError, match="bytes"):
        run_eval_task(None, {**base, "restore_from": {"path": str(ck)}})
    with pytest.raises(FileNotFoundError):
        run_eval_task(None, {**base, "restore_from": {"path": str(tmp_path / "nowhere")}})


def test_trainer_cache_rebind_hands_back_the_initial_state():
    cache = TrainerCache(2)
    payload = {"arch": "qwen3-0.6b", "seq_len": 8, "global_batch": 2, "steps": 3, **CPU}
    a = run_train_task(cache, dict(payload))
    b = run_train_task(cache, dict(payload))            # hit: rebound, same seed
    assert cache.stats()["hits"] == 1 and a["loss"] == b["loss"] and b["ran_steps"] == 3
    tr = cache.get(TrainJobConfig.from_job({"payload": payload}))
    fresh = Trainer(TrainJobConfig(**{k: v for k, v in payload.items() if k != "steps"}))
    for (_, x), (_, y) in zip(tree_flatten_sorted(tr.state), tree_flatten_sorted(fresh.state)):
        assert torch.equal(x, y)


def test_train_task_checkpoint_restores_in_jax_trainer_layout(tmp_path):
    """The port's trainer checkpoint carries the JAX Trainer's extra (data state,
    arch, mode) and leaf names."""
    payload = {"arch": "qwen3-0.6b", "seq_len": 8, "global_batch": 2, "steps": 2,
               "checkpoint_every": 100, "checkpoint_dir": str(tmp_path), **CPU}
    run_train_task(None, payload)
    manifest = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    assert manifest["extra"] == {"data": {"step": 0, "seed": 0, "task": "ramp"},
                                 "arch": "qwen3-0.6b", "mode": "sync"}
    names = list(manifest["leaves"])
    assert names[0].startswith("opt/m/") and "opt/step" in names
    assert manifest["leaves"]["params/embed"]["dtype"] == "bfloat16"
