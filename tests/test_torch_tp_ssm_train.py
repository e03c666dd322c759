"""PyTorch port, multi-rank training of the ssm and hybrid families: the
``Trainer`` on a ("data", "model") ``DeviceMesh`` of 8 gloo CPU ranks against the
JAX ``Trainer`` on 8 forced host devices, from the same numpy params and batches.

Three JAX subprocesses (side by side) and one spawn of 8 gloo ranks run
side by side in a module fixture (``tests/test_torch_tp.py``'s helpers; the params
those of ``tests/test_torch_tp_ssm.py``).

* Three f32 steps of reduced mamba2-2.7b on (1, 8), (2, 4) and (4, 2), and of
  reduced zamba2-7b on (4, 2), with tests/test_torch_train.py's ``OPT``: losses
  and grad norms within
  ``LOSS_TOL`` of JAX's at every step; m and v within ``MOMENT_TOL`` after the
  first step; master and params within ``MASTER_TOL`` after the first step and the
  last, but for the elements whose gradients are at AdamW's eps, held within the
  bound of any update's difference (``tests/test_torch_tp_train.py``'s
  ``_state_close``). Each rank's master, m and v are its ``opt_state_specs``
  slice, its params its ``partition_specs`` slice.
* Elastic: two mamba2 steps on (4, 2), ``Trainer.remesh`` onto (2, 2) over ranks
  0-3, two more steps there, against the JAX Trainer doing the same.
* Checkpoints: a mamba2 (2, 4) save restores bit-equal on one device.
* ``chip_smoke.py``'s one-rank phase of the ssm and hybrid families, reduced, on a
  one-rank gloo mesh: the Trainers and a Server bit-equal to one device's.
"""
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from test_torch_sharding import init_gloo, spawn_ranks  # noqa: E402
from test_torch_tp import JAX_PRELUDE, MESHES, finish_jax, start_jax  # noqa: E402
from test_torch_tp_ssm import cfg_of, np_params  # noqa: E402
from test_torch_tp_train import EPS_V, _np_named  # noqa: E402
from test_torch_train import LOSS_TOL, MASTER_TOL, MOMENT_TOL, OPT  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

ARCHS = ("mamba2-2.7b", "zamba2-7b")
SEQ, BATCH, STEPS = 40, 8, 3
# mamba2 on every mesh; zamba2, whose shared block runs the dense family's
# tensor-parallel code, on (4, 2), where it splits the q and the kv heads (its JAX
# Trainer takes ~40 s a mesh to compile here)
TRAIN_CASES = {**{f"mamba2-2.7b-{m}": ("mamba2-2.7b", m) for m in MESHES},
               "zamba2-7b-4x2": ("zamba2-7b", "4x2")}
# the JAX processes, side by side, and the cases each runs
JAX_GROUPS = (("mamba2-2.7b-1x8", "mamba2-2.7b-2x4"), ("mamba2-2.7b-4x2",), ("zamba2-7b-4x2",))
ELASTIC_SPLIT = 2
ELASTIC_FROM = "mamba2-2.7b-4x2"     # the run whose state at ELASTIC_SPLIT is re-meshed
CKPT_FROM = "mamba2-2.7b-2x4"        # the run saved at its end


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
    out = {k: sum((tr.metrics.series(k) for tr in trs), []) for k in ("loss", "grad_norm")}
    if with_state:
        out["state"] = tmap(lambda x: np.asarray(x, np.float32), trs[-1].state)
    return out


out = {}
for name, (arch, mesh_name) in args["cases"].items():
    tr = trainer(arch, mesh_of(mesh_name))
    tr.run(1)
    first = tmap(lambda x: np.asarray(x, np.float32), tr.state)
    tr.run(args["split"] - 1)
    if name == args["elastic"]:       # the elastic run: this one's state at the split
        split, split_series = tr.state, record([tr], False)
        plan, cfg = tr.plan, tr.arch_cfg
    tr.run(args["steps"] - args["split"])
    out[name] = record([tr])
    out[name]["first"] = first
if args["elastic"] in args["cases"]:
    mesh4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
                 axis_types=(AxisType.Auto,) * 2)
    state4 = remesh_state(split, plan, MeshPlan(mesh=mesh4, fsdp=False),
                          lambda p: train_state_specs(cfg, p))
    tr4 = trainer(args["cases"][args["elastic"]][0], mesh4, step=args["split"], state=state4)
    tr4.run(args["split"])
    out["elastic"] = record([tr4])
    out["elastic"].update({k: split_series[k] + out["elastic"][k] for k in split_series})
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def _state_close(got: dict, want: dict, moments: bool) -> None:
    """``tests/test_torch_tp_train.py``'s ``_state_close``: f32 state leaf by leaf,
    master, params and step at ``MASTER_TOL``, m and v at ``MOMENT_TOL`` where
    ``moments``; the elements whose gradients are at AdamW's eps (second moment
    above 0 and under ``EPS_V``) within 2 x the sum of the steps' learning rates.
    Those may be 1% of a leaf or 2 elements, whichever is more: the ssm leaves
    over the heads are small (zamba2's a_log holds 48 elements, and two of them are
    at eps after three steps, in the JAX Trainer's run and the port's alike)."""
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
        assert at_eps.sum() <= max(0.01 * at_eps.size, 2), (path, int(at_eps.sum()))
        np.testing.assert_allclose(got[path][~at_eps], w[~at_eps], rtol=MASTER_TOL,
                                   atol=MASTER_TOL, err_msg=str(path))
        np.testing.assert_allclose(got[path][at_eps], w[at_eps], rtol=0, atol=any_step,
                                   err_msg=str(path))


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
        return {k: sum((tr.metrics.series(k) for tr in trs), []) for k in ("loss", "grad_norm")}

    report = {"train": {}, "layout": {}}
    for name, (arch, mesh_name) in TRAIN_CASES.items():
        kw = ({"checkpoint_dir": str(tmp / "ckpt"), "checkpoint_every": 100}
              if name == CKPT_FROM else {})
        tr = start(arch, meshes[mesh_name], **kw)
        tr.run(1)
        first = whole(tr.state)
        tr.run(ELASTIC_SPLIT - 1)
        if name == ELASTIC_FROM:        # the elastic run: a copy of this one at the split
            split = (series(tr), tree_map(lambda t: as_dtensor(
                t.to_local().clone(), t.device_mesh, tuple(t.placements), t.shape), tr.state))
        tr.run(STEPS - ELASTIC_SPLIT)
        full = whole(tr.state)
        rep = series(tr)
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
        w_x = specs[("opt", "master", "layers", "ssm", "w_x")]
        report["layout"][name] = (bad, tuple(w_x),
                                  tuple(specs[("params", "layers", "ssm", "w_x")]))
        if name == CKPT_FROM:
            ckpt = (tr, full)

    # -- elastic: the (4, 2) run's state at step 2 onto (2, 2) over ranks 0-3, 2 steps
    before, state = split
    tr = start(TRAIN_CASES[ELASTIC_FROM][0], meshes["4x2"])
    tr.state, tr.step, tr.data.step = state, ELASTIC_SPLIT, ELASTIC_SPLIT
    tr.remesh(mesh4)
    if rank < 4:
        tr.run(ELASTIC_SPLIT)
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


def _one_rank(mesh1) -> dict:
    """``chip_smoke.py``'s one-rank phase of the ssm and hybrid families at reduced
    size in bf16 (the card's dtype) on a one-rank gloo mesh: each arch's Trainer's
    steps and state, and a Server's tokens, bit-equal to one device's."""
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as cfgs
    from repro_torch.parallel.sharding import OneDeviceMesh, full_value
    from repro_torch.runtime.serve_loop import Server, ServeJobConfig
    from repro_torch.runtime.train_loop import Trainer
    from repro_torch.tree import tree_flatten_sorted
    real_get = cfgs.get
    cfgs.get = lambda name: dataclasses.replace(real_get(name), dtype="bfloat16")
    one = OneDeviceMesh(torch.device("cpu"))
    out = {}
    try:
        for arch in ARCHS:
            ref, tr = Trainer(_job(arch), mesh=one), Trainer(_job(arch), mesh=mesh1)
            ref.run(2)
            tr.run(2)
            a = [(p, full_value(t)) for p, t in tree_flatten_sorted(tr.state)]
            b = list(tree_flatten_sorted(ref.state))
            rep = {"dtensors": all(isinstance(t, DTensor)
                                   for _, t in tree_flatten_sorted(tr.state)),
                   "series": [(tr.metrics.series(k), ref.metrics.series(k))
                              for k in ("loss", "grad_norm")],
                   "state": len(a) == len(b) and all(
                       p == q and x.dtype == y.dtype and torch.equal(x, y)
                       for (p, x), (q, y) in zip(a, b))}
            cfg = ServeJobConfig(arch=arch, slots=2, max_len=64, device="cpu")
            toks = []
            for mesh in (one, mesh1):
                sv = Server(cfg, params=ref.state["params"], mesh=mesh)
                ids = [sv.submit(p, max_new=5) for p in ([1, 2, 3, 4], [9, 8, 7], [5, 5])]
                sv.run()
                toks.append([sv.requests[i].generated for i in ids])
            rep["serve"] = toks
            out[arch] = rep
    finally:
        cfgs.get = real_get
    return out


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """(the JAX Trainers' records, each rank's report)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("tp_ssm_train")
    data = SyntheticTokens(vocab_size=512, seq_len=SEQ, global_batch=BATCH, seed=0)
    batches = [{k: v.float().numpy() if k == "loss_mask" else v.numpy()
                for k, v in data.global_batch_at(s).items()} for s in range(2 * STEPS)]
    params = {a: np_params(cfg_of(a, "float32"), 0) for a in ARCHS}
    args = {"params": params, "batches": batches, "meshes": MESHES, "steps": STEPS,
            "seq": SEQ, "batch": BATCH, "opt": OPT, "split": ELASTIC_SPLIT,
            "elastic": ELASTIC_FROM}
    procs = [start_jax(JAX_TRAIN, dict(args, cases={n: TRAIN_CASES[n] for n in group}), tmp,
                       f"jax_{i}") for i, group in enumerate(JAX_GROUPS)]
    try:
        reports = spawn_ranks(_rank_train, (args,), tmp)
    finally:
        jax_out = {}
        for p in procs:
            jax_out.update(finish_jax(*p))
    return jax_out, reports


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_steps_match_jax(train_runs, case):
    jax_out, reports = train_runs
    want = jax_out[case]
    got = reports[0]["train"][case]
    for rank, r in enumerate(reports):     # the metrics are the same on every rank
        assert all(r["train"][case][k] == got[k] for k in ("loss", "grad_norm")), rank
    assert len(got["loss"]) == STEPS
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=key)
    _state_close(got["first"], want["first"], moments=True)
    _state_close(got["state"], want["state"], moments=False)


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_each_rank_holds_its_specs_slice(train_runs, case):
    """Params by ``partition_specs`` (fsdp off: d_inner over "model"), master, m and
    v by ``opt_state_specs`` (ZeRO: their embed dim over "data" too)."""
    for rank, r in enumerate(train_runs[1]):
        bad, master_w_x, param_w_x = r["layout"][case]
        assert bad == [], (rank, bad[:5])
        assert param_w_x == (None, None, "model")
        assert master_w_x == (None, "data", "model")


def test_training_goes_on_after_a_remesh_to_fewer_ranks(train_runs):
    jax_out, reports = train_runs
    got, want = reports[0]["elastic"], jax_out["elastic"]
    assert len(got["loss"]) == 2 * ELASTIC_SPLIT
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=key)
    _state_close(got["state"], want["state"], moments=False)
    assert all("elastic" not in r for r in reports[1:])


def test_a_mesh_save_restores_bit_equal_on_one_device(train_runs):
    ck = train_runs[1][0]["ckpt"]
    assert ck["step"] == STEPS and ck["on_one"] == [] and ck["plain"], ck


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_runs_the_one_device_code(train_runs, arch):
    """chip_smoke.py's one-rank phase of the ssm and hybrid families, reduced."""
    one = train_runs[1][0]["one_rank"][arch]
    assert one["dtensors"] and one["state"]
    for got, want in one["series"]:
        assert len(got) == 2 and got == want
    assert one["serve"][0] == one["serve"][1] and all(len(g) == 5 for g in one["serve"][0])
