"""PyTorch port, multi-rank training of the moe family: the ``Trainer`` on a
("data", "model") ``DeviceMesh`` of 8 gloo CPU ranks against the JAX ``Trainer``
on 8 forced host devices, from the same numpy params and batches.

One JAX subprocess and one spawn of 8 gloo ranks run side by side in a module
fixture (``tests/test_torch_tp.py``'s helpers).

* Two f32 steps of reduced deepseek-moe-16b and qwen3-moe-235b-a22b (8 experts,
  top-2, capacity 1.25) on (2, 4) and (4, 2), one microbatch (the step reports
  the load-balance loss), tests/test_torch_train.py's ``OPT``: losses, aux and
  grad norms within ``LOSS_TOL`` of JAX's at every step; after the first step and
  the last, m and v (so every leaf's gradient: the experts', the router's and the
  shared experts' among them) within ``MOMENT_TOL``, master and params within
  ``MASTER_TOL``: tests/test_torch_moe.py's ``test_train_step_matches_jax``
  gates. Each rank's master, m and v are its ``opt_state_specs`` slice, its
  params its ``partition_specs`` slice.
* Elastic: a deepseek-moe step on (4, 2), ``Trainer.remesh`` onto (2, 2) over
  ranks 0-3, two more steps there, against the JAX Trainer doing the same.
* Checkpoints: a deepseek-moe (2, 4) save restores bit-equal on one device.
* ``chip_smoke.py``'s one-rank phase of the family, reduced, on a one-rank gloo
  mesh in bf16: a deepseek-moe Trainer's steps and state, and teacher-forced
  prefill and decode steps of both archs, bit-equal to one device's.
"""
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from test_torch_sharding import init_gloo, spawn_ranks  # noqa: E402
from test_torch_tp import JAX_PRELUDE, MESHES, finish_jax, np_params, start_jax  # noqa: E402
from test_torch_tp import cfg_of as _cfg_of  # noqa: E402
from test_torch_tp_moe import ARCHS  # noqa: E402
from test_torch_tp_train import _np_named  # noqa: E402
from test_torch_train import LOSS_TOL, MASTER_TOL, MOMENT_TOL, OPT  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

SEQ, BATCH, STEPS = 16, 8, 2
TRAIN_CASES = {f"{a}-{m}": (a, m) for a in ARCHS for m in ("2x4", "4x2")}
ELASTIC_SPLIT = 1
ELASTIC_FROM = "deepseek-moe-16b-4x2"  # the run whose state at ELASTIC_SPLIT is re-meshed
ELASTIC_STEPS = 2                      # steps on (2, 2) after the re-mesh
CKPT_FROM = "deepseek-moe-16b-2x4"     # the run saved at its end
ONE_RANK_DECODE = 3                    # teacher-forced decode steps of the one-rank phase
SERIES = ("loss", "aux_loss", "grad_norm")


def cfg_of(arch: str, dtype: str = "float32"):
    return _cfg_of(arch, dtype)


def _state_close(got: dict, want: dict) -> None:
    """tests/test_torch_moe.py's ``test_train_step_matches_jax`` gates, leaf by
    leaf of the f32 state: m and v at ``MOMENT_TOL``, every other leaf at
    ``MASTER_TOL``."""
    want = {tuple(p): w for p, w in _np_named(want)}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        tol = MOMENT_TOL if path[:2] in (("opt", "m"), ("opt", "v")) else MASTER_TOL
        np.testing.assert_allclose(got[path], w, rtol=tol, atol=tol, err_msg=str(path))


JAX_TRAIN = JAX_PRELUDE + """
from repro.launch.steps import train_state_specs
from repro.optim.adamw import AdamWConfig, init_opt_state
from repro.runtime.elastic import remesh_state
from repro.runtime.train_loop import Trainer, TrainJobConfig
in_dtype("float32")


def trainer(arch, mesh, step=0, state=None):
    tr = Trainer(TrainJobConfig(arch=arch, steps=args["steps"], seq_len=args["seq"],
                                global_batch=args["batch"], opt=AdamWConfig(**args["opt"])),
                 mesh=mesh)
    if state is None:
        params = tmap(jnp.asarray, args["params"][arch])
        state = {"params": params, "opt": init_opt_state(params)}
    tr.state, tr.step = state, step
    tr._sync_batch = lambda s: {k: jnp.asarray(v) for k, v in args["batches"][s].items()}
    return tr


def record(trs, with_state=True):
    out = {k: sum((tr.metrics.series(k) for tr in trs), []) for k in args["series"]}
    if with_state:
        out["state"] = tmap(lambda x: np.asarray(x, np.float32), trs[-1].state)
    return out


out = {}
for name, (arch, mesh_name) in args["cases"].items():
    tr = trainer(arch, mesh_of(mesh_name))
    tr.run(1)
    first = tmap(lambda x: np.asarray(x, np.float32), tr.state)
    if name == args["elastic"]:       # the elastic run: this one's state after step 1
        split, split_series = tr.state, record([tr], False)
        plan, cfg = tr.plan, tr.arch_cfg
    tr.run(args["steps"] - 1)
    out[name] = record([tr])
    out[name]["first"] = first
mesh4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
             axis_types=(AxisType.Auto,) * 2)
state4 = remesh_state(split, plan, MeshPlan(mesh=mesh4, fsdp=False),
                      lambda p: train_state_specs(cfg, p))
tr4 = trainer(args["cases"][args["elastic"]][0], mesh4, step=args["split"], state=state4)
tr4.run(args["elastic_steps"])
out["elastic"] = record([tr4])
out["elastic"].update({k: split_series[k] + out["elastic"][k] for k in split_series})
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def _job(arch: str, **kw):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainJobConfig
    return TrainJobConfig(arch=arch, steps=STEPS, seq_len=SEQ, global_batch=BATCH,
                          opt=AdamWConfig(**OPT), device="cpu", **kw)


def _rank_train(rank, world, store, tmp, args):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as cfgs
    from repro_torch.convert import to_torch
    from repro_torch.launch.steps import train_state_specs
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.parallel.sharding import (OneDeviceMesh, as_dtensor, distribute,
                                               full_value, local_range, placements)
    from repro_torch.runtime.train_loop import Trainer
    from repro_torch.tree import tree_flatten_sorted, tree_map
    init_gloo(rank, world, store)
    axes = ("data", "model")
    meshes = {n: init_device_mesh("cpu", s, mesh_dim_names=axes) for n, s in MESHES.items()}
    mesh4 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=axes)
    mesh1 = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64), mesh_dim_names=axes)
    one = OneDeviceMesh(torch.device("cpu"))
    real_get = cfgs.get
    cfgs.get = lambda name: dataclasses.replace(real_get(name), dtype="float32")
    tmp = Path(tmp)

    def start(arch, mesh, **kw):
        tr = Trainer(_job(arch, **kw), mesh=mesh)
        params = to_torch(args["params"][arch], "cpu")
        state = {"params": params, "opt": init_opt_state(params)}
        if isinstance(mesh, OneDeviceMesh):
            tr.state = state
        else:
            tr.state = tree_map(lambda x, s: distribute(x, mesh, s), state,
                                train_state_specs(tr.arch_cfg, tr.plan))
        return tr

    def whole(state) -> dict:
        return {p: np.array(full_value(t).float().numpy()) for p, t in tree_flatten_sorted(state)}

    def series(*trs) -> dict:
        return {k: sum((tr.metrics.series(k) for tr in trs), []) for k in SERIES}

    report = {"train": {}, "layout": {}}
    for name, (arch, mesh_name) in TRAIN_CASES.items():
        kw = ({"checkpoint_dir": str(tmp / "ckpt"), "checkpoint_every": 100}
              if name == CKPT_FROM else {})
        tr = start(arch, meshes[mesh_name], **kw)
        tr.run(1)
        first = whole(tr.state)
        if name == ELASTIC_FROM:        # the elastic run: a copy of this one after step 1
            split = (series(tr), tree_map(lambda t: as_dtensor(
                t.to_local().clone(), t.device_mesh, tuple(t.placements), t.shape), tr.state))
        tr.run(STEPS - 1)
        full = whole(tr.state)
        rep = series(tr)
        rep["experts"] = tr.model.tp.experts
        if rank == 0:
            rep["state"], rep["first"] = full, first
        report["train"][name] = rep
        # each leaf's local shard is its spec's slice of the whole, placed by it
        specs = dict(tree_flatten_sorted(train_state_specs(tr.arch_cfg, tr.plan)))
        bad = []
        for path, t in tree_flatten_sorted(tr.state):
            spec = specs[path]
            sl = tuple(slice(*local_range(tr.plan, spec, d, n)) for d, n in enumerate(t.shape))
            if not (isinstance(t, DTensor) and tuple(t.placements) == placements(tr.plan.mesh, spec)
                    and np.array_equal(t.to_local().float().numpy(), full[path][sl])):
                bad.append(path)
        report["layout"][name] = bad
        if name == CKPT_FROM:
            ckpt = (tr, full)

    # -- elastic: the (4, 2) run's state after step 1 onto (2, 2) over ranks 0-3
    before, state = split
    tr = start(TRAIN_CASES[ELASTIC_FROM][0], meshes["4x2"])
    tr.state, tr.step, tr.data.step = state, ELASTIC_SPLIT, ELASTIC_SPLIT
    tr.remesh(mesh4)
    if rank < 4:
        tr.run(ELASTIC_STEPS)
        state = whole(tr.state)
        if rank == 0:
            after = series(tr)
            report["elastic"] = dict({k: before[k] + after[k] for k in after}, state=state)
    # -- checkpoints: the (2, 4) save, restored on one device
    tr24, full24 = ckpt
    manifest = tr24.save_checkpoint()
    dist.barrier()
    if rank == 0:
        solo = start(TRAIN_CASES[CKPT_FROM][0], one)
        step = solo.restore(manifest, strict=True)
        got = whole(solo.state)
        report["ckpt"] = {"step": step, "on_one": [p for p in full24
                                                   if not np.array_equal(got[p], full24[p])],
                          "plain": not any(isinstance(t, DTensor)
                                           for _, t in tree_flatten_sorted(solo.state))}
        cfgs.get = real_get
        report["one_rank"] = _one_rank(mesh1)
    cfgs.get = real_get
    with open(tmp / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def _forced(model, params, tokens) -> list:
    """Teacher-forced logits: a prefill of all but the last ONE_RANK_DECODE + 1
    tokens, then decode steps of the next ONE_RANK_DECODE, each logits whole."""
    from repro_torch.parallel.sharding import full_value
    k = tokens.shape[1] - ONE_RANK_DECODE - 1
    with torch.no_grad():
        last, cache = model.prefill(params, {"tokens": tokens[:, :k]}, max_len=tokens.shape[1])
        out = [full_value(last)]
        for i in range(k, k + ONE_RANK_DECODE):
            step, cache = model.decode_step(params, tokens[:, i:i + 1], cache)
            out.append(full_value(step))
    return out


def _one_rank(mesh1) -> dict:
    """``chip_smoke.py``'s one-rank phase of the moe family at reduced size in
    bf16 (the card's dtype) on a one-rank gloo mesh: a deepseek-moe Trainer's
    steps and state, and teacher-forced prefill and decode steps of both archs,
    bit-equal to one device's."""
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as cfgs
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import MeshPlan, OneDeviceMesh, distribute, full_value
    from repro_torch.runtime.train_loop import Trainer
    from repro_torch.tree import tree_flatten_sorted, tree_map
    real_get = cfgs.get
    cfgs.get = lambda name: dataclasses.replace(real_get(name), dtype="bfloat16")
    one = OneDeviceMesh(torch.device("cpu"))
    out = {}
    try:
        ref, tr = Trainer(_job(ARCHS[0]), mesh=one), Trainer(_job(ARCHS[0]), mesh=mesh1)
        ref.run(2)
        tr.run(2)
        a = [(p, full_value(t)) for p, t in tree_flatten_sorted(tr.state)]
        b = list(tree_flatten_sorted(ref.state))
        out["train"] = {
            "dtensors": all(isinstance(t, DTensor) for _, t in tree_flatten_sorted(tr.state)),
            "series": [(tr.metrics.series(k), ref.metrics.series(k)) for k in SERIES],
            "state": len(a) == len(b) and all(p == q and x.dtype == y.dtype and torch.equal(x, y)
                                              for (p, x), (q, y) in zip(a, b))}
        gen = torch.Generator().manual_seed(4)
        for arch in ARCHS:
            cfg = _cfg_of(arch, "bfloat16")
            model = Model(cfg, "cpu")
            params = model.init_params(0)
            tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
            meshed = Model(cfg, "cpu", MeshPlan(mesh=mesh1, fsdp=False))
            dparams = tree_map(lambda x, s: distribute(x, mesh1, s), params,
                               meshed.param_specs())
            want = _forced(model, params, tokens)
            got = _forced(meshed, dparams, tokens)
            out[arch] = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want))
    finally:
        cfgs.get = real_get
    return out


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """(the JAX Trainers' records, each rank's report)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("tp_moe_train")
    data = SyntheticTokens(vocab_size=512, seq_len=SEQ, global_batch=BATCH, seed=0)
    batches = [{k: v.float().numpy() if k == "loss_mask" else v.numpy()
                for k, v in data.global_batch_at(s).items()}
               for s in range(ELASTIC_SPLIT + ELASTIC_STEPS)]
    params = {a: np_params(cfg_of(a), 0) for a in ARCHS}
    args = {"params": params, "batches": batches, "meshes": MESHES, "steps": STEPS,
            "seq": SEQ, "batch": BATCH, "opt": OPT, "split": ELASTIC_SPLIT,
            "elastic": ELASTIC_FROM, "elastic_steps": ELASTIC_STEPS, "series": SERIES}
    proc = start_jax(JAX_TRAIN, dict(args, cases=TRAIN_CASES), tmp, "jax_tp_moe_train")
    try:
        reports = spawn_ranks(_rank_train, (args,), tmp)
    finally:
        jax_out = finish_jax(*proc)
    return jax_out, reports


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_steps_match_jax(train_runs, case):
    jax_out, reports = train_runs
    want = jax_out[case]
    got = reports[0]["train"][case]
    for rank, r in enumerate(reports):     # the metrics are the same on every rank
        assert all(r["train"][case][k] == got[k] for k in SERIES), rank
        assert r["train"][case]["experts"], rank
    assert len(got["loss"]) == STEPS
    assert min(got["aux_loss"]) > 0
    for key in SERIES:
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=key)
    _state_close(got["first"], want["first"])
    _state_close(got["state"], want["state"])


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_each_rank_holds_its_specs_slice(train_runs, case):
    """Params by ``partition_specs`` (fsdp off: the experts over "model"), master,
    m and v by ``opt_state_specs`` (ZeRO: their embed dim over "data" too)."""
    for rank, r in enumerate(train_runs[1]):
        assert r["layout"][case] == [], (rank, r["layout"][case][:5])


def test_training_goes_on_after_a_remesh_to_fewer_ranks(train_runs):
    jax_out, reports = train_runs
    got, want = reports[0]["elastic"], jax_out["elastic"]
    assert len(got["loss"]) == ELASTIC_SPLIT + ELASTIC_STEPS
    for key in SERIES:
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=key)
    _state_close(got["state"], want["state"])
    assert all("elastic" not in r for r in reports[1:])


def test_a_mesh_save_restores_bit_equal_on_one_device(train_runs):
    ck = train_runs[1][0]["ckpt"]
    assert ck["step"] == STEPS and ck["on_one"] == [] and ck["plain"], ck


def test_one_rank_mesh_trains_as_one_device(train_runs):
    """chip_smoke.py's one-rank phase of the family, reduced: the deepseek-moe
    Trainer."""
    one = train_runs[1][0]["one_rank"]["train"]
    assert one["dtensors"] and one["state"]
    for got, want in one["series"]:
        assert len(got) == 2 and got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_prefill_and_decode_as_one_device(train_runs, arch):
    """chip_smoke.py's one-rank phase, reduced: teacher-forced prefill and decode
    steps, bit-equal to one device's."""
    assert train_runs[1][0]["one_rank"][arch] is True
