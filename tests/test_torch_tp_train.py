"""PyTorch port, multi-rank training of the dense family: the ``Trainer`` on a
("data", "model") ``DeviceMesh`` of 8 gloo CPU ranks against the JAX ``Trainer``
on 8 forced host devices, from the same numpy params and batches.

One JAX subprocess and one spawn of 8 gloo ranks run side by side in a module
fixture (``tests/test_torch_tp.py``'s helpers).

* Three steps of reduced qwen3-0.6b on (1, 8), (2, 4) and (4, 2) with
  tests/test_torch_train.py's ``OPT`` in f32, and on (2, 4) in bf16 and with 2
  microbatches: f32 losses and grad norms within ``LOSS_TOL`` of JAX's at every
  step; m and v within ``MOMENT_TOL`` after the first step, where that gate was
  measured (over three steps the one-device port and JAX drift apart by ~1.2e-7 in
  a few elements of m, on one device as on ranks); master and params within
  ``MASTER_TOL`` after the first step and the last, but for the elements whose
  gradients are at AdamW's eps (second moment above 0 and under ``EPS_V``: the step there is
  lr * g / (|g| + eps), its sign and size set by summation order), which are held
  within the bound of any update's difference, 2 x the sum of the steps' learning
  rates: JAX's own Trainer on (4, 2) and on one device differ by 4.0e-4 there
  after three steps (an element of v 1.0e-17); bf16 losses within
  ``BF16_LOSS_TOL``. Each rank's master, m and v are its
  ``opt_state_specs`` slice (ZeRO over "data"), its params its
  ``partition_specs`` slice.
* ``zero2_accum``: the 2-microbatch step on (2, 4) with its accumulator in the
  optimizer's layout, against the same JAX run.
* The dry-run's count: one 2-microbatch step of ``make_train_step`` on (2, 4)
  under ``roofline/op_stats.py``'s counter on every rank; its collectives equal
  the dry-run's count of the train cell's step on a fake world of 8 ranks.
* Elastic: two steps on (4, 2), ``Trainer.remesh`` onto (2, 2) over ranks 0-3,
  two more steps there, against the JAX Trainer doing the same.
* Checkpoints: a (2, 4) save restores bit-equal on one device and on (4, 2), and
  training goes on; a one-device save restores bit-equal on (2, 4).
* ``chip_smoke.py``'s tensor-parallel phase, reduced, on a one-rank gloo mesh:
  the Trainer, a save from it and the Server bit-equal to one device's.
"""
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from test_torch_sharding import init_gloo, spawn_ranks  # noqa: E402
from test_torch_tp import (JAX_PRELUDE, MESHES, cfg_of, finish_jax, np_params,  # noqa: E402
                           start_jax)
from test_torch_train import (BF16_LOSS_TOL, LOSS_TOL, MASTER_TOL, MOMENT_TOL,  # noqa: E402
                              OPT)
from test_torch_model import _one_torch_thread  # noqa: E402,F401

ARCH = "qwen3-0.6b"
SEQ, BATCH, STEPS = 32, 8, 3
# name -> (mesh, dtype, microbatches)
TRAIN_CASES = {f"{m}-float32": (m, "float32", 1) for m in MESHES}
TRAIN_CASES["2x4-bfloat16"] = ("2x4", "bfloat16", 1)
TRAIN_CASES["2x4-float32-M2"] = ("2x4", "float32", 2)
ELASTIC_SPLIT = 2
ELASTIC_FROM = "4x2-float32"     # the run whose state at ELASTIC_SPLIT is re-meshed
EPS_V = 1e-14       # v below (10 x AdamW's eps)^2: |g| within 10 eps of 0


JAX_TRAIN = JAX_PRELUDE + """
from repro.launch.steps import train_state_specs
from repro.optim.adamw import AdamWConfig, init_opt_state
from repro.runtime.elastic import remesh_state
from repro.runtime.train_loop import Trainer, TrainJobConfig


def trainer(mesh, dtype, microbatches, step=0, state=None):
    in_dtype(dtype)
    tr = Trainer(TrainJobConfig(arch=args["arch"], steps=args["steps"], seq_len=args["seq"],
                                global_batch=args["batch"], microbatches=microbatches,
                                opt=AdamWConfig(**args["opt"])), mesh=mesh)
    if state is None:
        params = tmap(jnp.asarray, args["params"][dtype])
        state = {"params": params, "opt": init_opt_state(params)}
    tr.state, tr.step = state, step
    tr._sync_batch = lambda s: {k: jnp.asarray(v) for k, v in args["batches"][s].items()}
    return tr


def record(trs, with_state=True):
    out = {k: sum((tr.metrics.series(k) for tr in trs), []) for k in ("loss", "grad_norm")}
    if with_state:
        out["state"] = tmap(lambda x: np.asarray(x, np.float32), trs[-1].state)
    return out


out = {}
for name, (mesh_name, dtype, microbatches) in args["cases"].items():
    tr = trainer(mesh_of(mesh_name), dtype, microbatches)
    tr.run(1)
    first = tmap(lambda x: np.asarray(x, np.float32), tr.state)
    tr.run(args["split"] - 1)
    if name == args["elastic"]:       # the elastic run: this one's state at the split
        split, split_series = tr.state, record([tr], False)
    tr.run(args["steps"] - args["split"])
    out[name] = record([tr], dtype == "float32")
    if dtype == "float32":
        out[name]["first"] = first
    if name == args["elastic"]:
        plan = tr.plan
mesh4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
             axis_types=(AxisType.Auto,) * 2)
state4 = remesh_state(split, plan, MeshPlan(mesh=mesh4, fsdp=False),
                      lambda p: train_state_specs(tr.arch_cfg, p))
tr4 = trainer(mesh4, "float32", 1, step=args["split"], state=state4)
tr4.run(args["split"])
out["elastic"] = record([tr4])
out["elastic"].update({k: split_series[k] + out["elastic"][k] for k in split_series})
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def _job(dtype: str, microbatches: int = 1, **kw):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainJobConfig
    return TrainJobConfig(arch=ARCH, steps=STEPS, seq_len=SEQ, global_batch=BATCH,
                          microbatches=microbatches, opt=AdamWConfig(**OPT), device="cpu", **kw)


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
    tmp = Path(tmp)

    def in_dtype(dtype):
        cfgs.get = lambda name: dataclasses.replace(real_get(name), dtype=dtype)

    def start(mesh, dtype, microbatches=1, **kw):
        in_dtype(dtype)
        tr = Trainer(_job(dtype, microbatches, **kw), mesh=mesh)
        params = to_torch(args["params"][dtype], "cpu")
        state = {"params": params, "opt": init_opt_state(params)}
        if isinstance(mesh, OneDeviceMesh):
            tr.state = state
        else:
            tr.state = tree_map(lambda x, s: distribute(x, mesh, s), state,
                                train_state_specs(tr.arch_cfg, tr.plan))
        return tr

    def whole(state) -> dict:
        """Copies of the whole values (a replicated leaf's is its local tensor)."""
        return {p: np.array(full_value(t).float().numpy()) for p, t in tree_flatten_sorted(state)}

    def series(*trs) -> dict:
        return {k: sum((tr.metrics.series(k) for tr in trs), []) for k in ("loss", "grad_norm")}

    report = {"train": {}, "layout": {}}
    trainers = {}
    for name, (mesh_name, dtype, microbatches) in TRAIN_CASES.items():
        kw = ({"checkpoint_dir": str(tmp / "ckpt_2x4"), "checkpoint_every": 100}
              if name == "2x4-float32" else {})
        tr = start(meshes[mesh_name], dtype, microbatches, **kw)
        tr.run(1)
        first = whole(tr.state)
        tr.run(ELASTIC_SPLIT - 1)
        if name == ELASTIC_FROM:        # the elastic run: a copy of this one at the split
            split = (series(tr), tree_map(lambda t: as_dtensor(
                t.to_local().clone(), t.device_mesh, tuple(t.placements), t.shape), tr.state))
        tr.run(STEPS - ELASTIC_SPLIT)
        full = whole(tr.state)
        rep = series(tr)
        if rank == 0 and dtype == "float32":
            rep["state"], rep["first"] = full, first
        report["train"][name] = rep
        if microbatches == 1 and dtype == "float32":
            # each leaf's local shard is its spec's slice of the whole, placed by it
            specs = dict(tree_flatten_sorted(train_state_specs(tr.arch_cfg, tr.plan)))
            bad = []
            for path, t in tree_flatten_sorted(tr.state):
                spec = specs[path]
                sl = tuple(slice(*local_range(tr.plan, spec, d, n)) for d, n in enumerate(t.shape))
                if not (isinstance(t, DTensor)
                        and tuple(t.placements) == placements(tr.plan.mesh, spec)
                        and np.array_equal(t.to_local().float().numpy(), full[path][sl])):
                    bad.append(path)
            wq = specs[("opt", "master", "layers", "attn", "wq")]
            report["layout"][mesh_name] = (bad, tuple(wq), tuple(specs[("params", "layers",
                                                                        "attn", "wq")]))
            trainers[mesh_name] = (tr, full)
    in_dtype("float32")

    # -- zero2_accum: the 2-microbatch run, its accumulator in the optimizer's layout
    from repro_torch.launch.steps import make_train_step
    tr = start(meshes["2x4"], "float32", 2)
    tr.step_fn = make_train_step(tr.model, tr.cfg.opt, 2, zero2_accum=True)
    tr.run(STEPS)
    state = whole(tr.state)
    report["zero2"] = dict(series(tr), state=state if rank == 0 else None)

    # -- one 2-microbatch step of make_train_step (the train cell's step) on (2, 4)
    # under the dry-run's counter, on the real tensors: its collectives
    from repro_torch.roofline.op_stats import measure, pod_size
    tr = start(meshes["2x4"], "float32", 2)
    step_fn = make_train_step(tr.model, tr.cfg.opt, 2)
    batch = {k: distribute(v, tr.plan.mesh, tr.plan.spec(("batch", "seq"), tuple(v.shape)))
             for k, v in tr._sync_batch(0).items()}
    _, st = measure(step_fn, (tr.state, batch), pod_size=pod_size(tr.plan.mesh))
    report["counts"] = st.collective_counts()
    report["batch"] = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}

    # -- elastic: the (4, 2) run's state at step 2 onto (2, 2) over ranks 0-3, 2 steps
    before, state = split
    tr = start(meshes["4x2"], "float32")
    tr.state, tr.step, tr.data.step = state, ELASTIC_SPLIT, ELASTIC_SPLIT
    tr.remesh(mesh4)
    if rank < 4:
        tr.run(ELASTIC_SPLIT)
        state = whole(tr.state)
        if rank == 0:
            after = series(tr)
            report["elastic"] = dict({k: before[k] + after[k] for k in after}, state=state)
    # -- checkpoints: the (2, 4) save on one device and on (4, 2), and back
    tr24, full24 = trainers["2x4"]
    manifest = tr24.save_checkpoint()
    tr42 = start(meshes["4x2"], "float32")
    step = tr42.restore(manifest, strict=True)
    back = whole(tr42.state)
    report["ckpt"] = {"step": step, "on_4x2": [p for p in full24
                                               if not np.array_equal(back[p], full24[p])]}
    tr24.run(1)
    tr42.run(1)
    report["ckpt"]["losses"] = (tr24.metrics.series("loss")[-1], tr42.metrics.series("loss")[-1])
    if rank == 0:
        solo = start(one, "float32", checkpoint_dir=str(tmp / "ckpt_one"), checkpoint_every=100)
        solo.restore(manifest, strict=True)
        got = whole(solo.state)
        report["ckpt"]["on_one"] = [p for p in full24 if not np.array_equal(got[p], full24[p])]
        report["ckpt"]["plain"] = not any(isinstance(t, DTensor) for t in solo.state["params"].values())
        solo.run(1)
        solo.save_checkpoint()
        report["ckpt"]["solo"] = whole(solo.state)
    dist.barrier()
    tr24b = start(meshes["2x4"], "float32")
    tr24b.restore({"step": STEPS + 1, "path": str(tmp / "ckpt_one")}, strict=True)
    again = whole(tr24b.state)
    if rank == 0:
        report["ckpt"]["on_2x4"] = [p for p in again
                                    if not np.array_equal(again[p], report["ckpt"]["solo"][p])]
        del report["ckpt"]["solo"]
        report["one_rank"] = _one_rank(mesh1, start, in_dtype, tmp)
    cfgs.get = real_get
    with open(tmp / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def _one_rank(mesh1, start, in_dtype, tmp: Path) -> dict:
    """``chip_smoke.py``'s ``phase_tensor_parallel`` at reduced size in bf16 (the
    card's dtype) on a one-rank gloo mesh: the Trainer's steps, a save from the
    mesh restored on one device, and a Server, each bit-equal to one device's."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.parallel.sharding import OneDeviceMesh, full_value
    from repro_torch.runtime.serve_loop import Server, ServeJobConfig
    from repro_torch.tree import tree_flatten_sorted
    one = OneDeviceMesh(torch.device("cpu"))
    in_dtype("bfloat16")
    ref, tr = start(one, "bfloat16"), start(mesh1, "bfloat16")
    ref.run(STEPS)
    tr.run(STEPS)
    a = [(p, full_value(t)) for p, t in tree_flatten_sorted(tr.state)]
    b = list(tree_flatten_sorted(ref.state))
    out = {"dtensors": all(isinstance(t, DTensor) for _, t in tree_flatten_sorted(tr.state)),
           "series": [(tr.metrics.series(k), ref.metrics.series(k)) for k in ("loss", "grad_norm")],
           "state": len(a) == len(b) and all(p == q and x.dtype == y.dtype and torch.equal(x, y)
                                             for (p, x), (q, y) in zip(a, b))}
    mgr = CheckpointManager(str(tmp / "ckpt_one_rank"))
    mgr.save(tr.step, tr.state, blocking=True)
    restored, _, _ = mgr.restore(ref.state)
    c = list(tree_flatten_sorted(restored))
    out["ckpt"] = all(not isinstance(y, DTensor) and torch.equal(x, y)
                      for (_, x), (_, y) in zip(a, c))
    cfg = ServeJobConfig(arch=ARCH, slots=2, max_len=64, device="cpu")
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 5]]
    toks = []
    for mesh in (one, mesh1):
        sv = Server(cfg, params=ref.state["params"], mesh=mesh)
        ids = [sv.submit(p, max_new=5) for p in prompts]
        sv.run()
        toks.append([sv.requests[i].generated for i in ids])
    out["serve"] = toks
    return out


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """(the JAX Trainers' records, each rank's report)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("tp_train")
    data = SyntheticTokens(vocab_size=512, seq_len=SEQ, global_batch=BATCH, seed=0)
    batches = [{k: v.float().numpy() if k == "loss_mask" else v.numpy()
                for k, v in data.global_batch_at(s).items()} for s in range(2 * STEPS)]
    params = {dt: np_params(cfg_of(ARCH, dt), 0) for dt in ("float32", "bfloat16")}
    args = {"params": params, "batches": batches, "meshes": MESHES, "arch": ARCH,
            "steps": STEPS, "seq": SEQ, "batch": BATCH, "opt": OPT, "cases": TRAIN_CASES,
            "split": ELASTIC_SPLIT, "elastic": ELASTIC_FROM}
    proc, out = start_jax(JAX_TRAIN, args, tmp, "jax_train")
    try:
        reports = spawn_ranks(_rank_train, (args,), tmp)
    finally:
        jax_out = finish_jax(proc, out)
    return jax_out, reports


def _state_close(got: dict, want: dict, moments: bool) -> None:
    """f32 state leaf by leaf at tests/test_torch_train.py's gates: master, params
    and step at ``MASTER_TOL`` (their elements at eps within 2 x the sum of the
    learning rates, see the module docstring); m and v at ``MOMENT_TOL`` where
    ``moments``."""
    want = {tuple(p): w for p, w in _np_named(want)}
    assert sorted(got) == sorted(want)
    n = int(want[("opt", "step")])
    any_step = 2 * OPT["peak_lr"] * n * (n + 1) / (2 * OPT["warmup_steps"])
    for path, w in want.items():
        if path[:2] in (("opt", "m"), ("opt", "v")):
            if moments:
                np.testing.assert_allclose(got[path], w, rtol=MOMENT_TOL, atol=MOMENT_TOL,
                                           err_msg=str(path))
            continue
        if path == ("opt", "step"):
            assert got[path] == w
            continue
        v = want[("opt", "v") + path[(2 if path[0] == "opt" else 1):]]
        at_eps = (v > 0) & (v < EPS_V)      # v = 0: no gradient, weight decay alone
        assert at_eps.mean() < 0.01, (path, int(at_eps.sum()))
        np.testing.assert_allclose(got[path][~at_eps], w[~at_eps], rtol=MASTER_TOL,
                                   atol=MASTER_TOL, err_msg=str(path))
        np.testing.assert_allclose(got[path][at_eps], w[at_eps], rtol=0, atol=any_step,
                                   err_msg=str(path))


def _np_named(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _np_named(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_steps_match_jax(train_runs, case):
    jax_out, reports = train_runs
    want = jax_out[case]
    dtype = TRAIN_CASES[case][1]
    got = reports[0]["train"][case]
    for rank, r in enumerate(reports):     # the metrics are the same on every rank
        assert all(r["train"][case][k] == got[k] for k in ("loss", "grad_norm")), rank
    assert len(got["loss"]) == STEPS
    if dtype == "bfloat16":
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=BF16_LOSS_TOL,
                                   atol=BF16_LOSS_TOL)
        return
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=key)
    _state_close(got["first"], want["first"], moments=True)
    _state_close(got["state"], want["state"], moments=False)


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_specs_slice(train_runs, mesh):
    """Params by ``partition_specs`` (fsdp off: heads over "model" only), master, m
    and v by ``opt_state_specs`` (ZeRO: their embed dim over "data" too)."""
    for rank, r in enumerate(train_runs[1]):
        bad, master_wq, param_wq = r["layout"][mesh]
        assert bad == [], (rank, bad[:5])
        heads = "model" if mesh != "1x8" else None
        assert param_wq == ((None, None, heads) if heads else ())
        assert master_wq == ((None, "data", heads) if heads else (None, "data"))


def test_the_dry_run_counts_a_train_step_as_every_rank_ran_it(train_runs):
    """One 2-microbatch f32 step of ``make_train_step`` on (2, 4) on each of the 8
    ranks under the dry-run's counter (real tensors, gloo), against the dry-run's
    count of the train cell's step (the same function, plan, state and batch
    shapes) on a fake world of 8 ranks, rank 0: the same collectives, each
    (opcode, link, operand bytes) with its count; none crosses a pod (the mesh
    has no "pod" axis)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    from repro_torch.launch.steps import CellOptions, build_cell
    from repro_torch.models.params import TensorDef
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline.op_stats import call_stats
    reports = train_runs[1]
    batch = {k: TensorDef(shape, dtype) for k, (shape, dtype) in reports[0]["batch"].items()}
    with fake_world(8):
        mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
        cell = build_cell(cfg_of(ARCH, "float32"), "train_4k",
                          CellOptions(fsdp=False, num_microbatches=2), AdamWConfig(**OPT),
                          device="cpu", mesh=mesh)
        want = call_stats(cell.fn, (cell.abstract_args[0], batch), mesh, cell.in_shardings,
                          pod_size=8).collective_counts()
    assert not dist.is_initialized()
    assert want and all(link == "ici" for _, link, _ in want)
    for rank, r in enumerate(reports):
        assert r["counts"] == want, rank


def test_zero2_accumulator_matches_jax(train_runs):
    """``zero2_accum`` on (2, 4): each microbatch's gradients summed over "data"
    into the ZeRO layout; the run is the JAX 2-microbatch Trainer's."""
    jax_out, reports = train_runs
    got, want = reports[0]["zero2"], jax_out["2x4-float32-M2"]
    for key in ("loss", "grad_norm"):
        assert all(r["zero2"][key] == got[key] for r in reports)
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=key)
    _state_close(got["state"], want["state"], moments=False)


def test_training_goes_on_after_a_remesh_to_fewer_ranks(train_runs):
    jax_out, reports = train_runs
    got, want = reports[0]["elastic"], jax_out["elastic"]
    assert len(got["loss"]) == 2 * ELASTIC_SPLIT
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=key)
    _state_close(got["state"], want["state"], moments=False)
    assert all("elastic" not in r for r in reports[1:])


def test_checkpoints_restore_across_meshes(train_runs):
    """A (2, 4) save restores bit-equal on (4, 2) and on one device; the next
    step on (4, 2) is the (2, 4) Trainer's; a one-device save restores
    bit-equal on (2, 4)."""
    reports = train_runs[1]
    ck = reports[0]["ckpt"]
    assert ck["on_one"] == [] and ck["on_2x4"] == [] and ck["plain"], ck
    for rank, r in enumerate(reports):
        assert r["ckpt"]["step"] == STEPS and r["ckpt"]["on_4x2"] == [], rank
        a, b = r["ckpt"]["losses"]
        np.testing.assert_allclose(a, b, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_one_rank_mesh_runs_the_one_device_code(train_runs):
    """chip_smoke.py's tensor-parallel phase, reduced, on a one-rank gloo mesh."""
    one = train_runs[1][0]["one_rank"]
    assert one["dtensors"] and one["state"] and one["ckpt"]
    for got, want in one["series"]:
        assert len(got) == STEPS and got == want
    assert one["serve"][0] == one["serve"][1] and all(len(g) == 5 for g in one["serve"][0])
