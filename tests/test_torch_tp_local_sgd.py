"""PyTorch port, local SGD with its pods on ranks of their own: the local-SGD
``Trainer`` with its pods split over a "pod" mesh axis (and on a ("data",
"model") mesh, every pod on every rank) on 8 gloo CPU ranks against the JAX
``Trainer`` on 8 forced host devices on the same mesh, from the same numpy
params and batches.

One JAX subprocess (its programs compiled on four threads and run in turn) and one spawn of 8 gloo
ranks run side by side in a module fixture (``tests/test_torch_tp.py``'s
helpers). Reduced models in f32, seq_len 16, global batch 8, H = 2, two rounds:

* qwen3-0.6b on (2, 2, 2) ("pod", "data", "model") with int8 and Nesterov, with
  the f32 exchange and heavy ball, and with 4 pods (two local pods a rank); on a
  ("data", "model") (2, 4) mesh with 2 pods (the JAX package's
  ``spmd_axis=None``); deepseek-moe-16b on (2, 1, 4) at capacity 4.0 (nothing
  drops, the load-balance loss pod-local): each round's state and delta_norm by
  tests/test_torch_local_sgd.py's gates; every rank's leaves their
  ``local_sgd_state_specs`` slices.
* The "pod" group's collectives in a round, counted by wrapping
  ``torch.distributed``: compressed, exactly the all-gathers of each leaf's int8
  values and f32 scales, in the outer step; uncompressed, one f32 all-reduce a
  leaf; none in the inner steps; no DTensor redistribute.
* The Titchener cell on (2, 2, 2) (fsdp on: embed dims split over "data" too)
  against the JAX cell's jitted round, two rounds from the same state; every
  master leaf's int8 scale formed from its shards equal to the whole leaf's. A
  third round under the dry-run's counter (``roofline/op_stats.py``) on every
  rank: its collectives equal the dry-run's count of the round on a fake (2, 2,
  2) world, whose cross-pod bytes equal ``module_stats``' on the JAX cell.
* Checkpoints: a (2, 2, 2) save restores bit-equal on one device and on (2, 4,
  1); a one-device save restores bit-equal on (2, 2, 2); ``Trainer.remesh``
  from (2, 2, 2) onto (2, 4, 1) after a round, then a round there, against the
  uninterrupted JAX run.
* A ``TorchLocalPlane`` on (2, 2, 2) runs a local-SGD train job; its checkpoint
  evaluated by ``run_eval_task`` through a ``TrainerCache`` on the mesh, against
  the one-device eval task.
* ``chip_smoke.py``'s ``phase_local_sgd_pods``, reduced, in bf16 on a one-rank
  gloo (1, 1, 1) mesh: bit-equal to one device.
"""
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from test_torch_local_sgd import (DELTA_NORM_RTOL, EF_FLIP_SHARE, EF_TOL,  # noqa: E402
                                  ROUND_TOL, _round_batches)
from test_torch_sharding import init_gloo, spawn_ranks  # noqa: E402
from test_torch_tp import JAX_PRELUDE, cfg_of, finish_jax, np_params, start_jax  # noqa: E402
from test_torch_train import BF16_LOSS_TOL, MOMENT_TOL, OPT  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

SEQ, BATCH, H, ROUNDS = 16, 8, 2, 2
POD_AXES = ("pod", "data", "model")
MESHES = {"2x2x2": ((2, 2, 2), POD_AXES), "2x4": ((2, 4), ("data", "model")),
          "2x1x4": ((2, 1, 4), POD_AXES), "2x4x1": ((2, 4, 1), POD_AXES)}
# name -> (arch, mesh, n_pods, compress, nesterov)
CASES = {
    "qwen3-2x2x2-int8-nesterov": ("qwen3-0.6b", "2x2x2", 2, True, True),
    "qwen3-2x2x2-f32-heavy_ball": ("qwen3-0.6b", "2x2x2", 2, False, False),
    "qwen3-2x4-int8-nesterov": ("qwen3-0.6b", "2x4", 2, True, True),
    "qwen3-2x2x2-4pods": ("qwen3-0.6b", "2x2x2", 4, True, True),
    "deepseek-2x1x4-int8-nesterov": ("deepseek-moe-16b", "2x1x4", 2, True, True),
}
OVERRIDES = {"qwen3-0.6b": {}, "deepseek-moe-16b": {"capacity_factor": 4.0}}
BASE = "qwen3-2x2x2-int8-nesterov"     # the run that checkpoints and re-meshes
CELL_LAYERS = 2
WARM_STEP, WARM_ROUND = 4, 2     # the pods' steps and the round of the runs' first state
OUTER_MOMENTUM = 0.9      # LocalSGDConfig's, every case's
# the pods' m, absolute, a round after one whose int8 flips moved the masters
# (measured at the second round against JAX: at most 8.9e-7 with 4 pods, 4.3e-7
# with 2, 2.3e-7 in the cell, 3.5e-7 after the re-mesh, 9.5e-9 with the f32
# exchange; v stays within MOMENT_TOL)
M_DRIFT_TOL = 2e-6


JAX_LOCAL = JAX_PRELUDE + """
from concurrent.futures import ThreadPoolExecutor
from repro.launch.steps import CellOptions, build_cell
from repro.optim.adamw import AdamWConfig
from repro.optim.local_sgd import LocalSGDConfig
from repro.runtime.train_loop import Trainer, TrainJobConfig
H = args["H"]


def local_mesh(name):
    shape, axes = args["meshes"][name]
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes,
                axis_types=(AxisType.Auto,) * len(axes))


def batches(b):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "loss_mask" else None) for k, v in b.items()}


def trainer(name):
    arch, mesh_name, n_pods, compress, nesterov = args["cases"][name]
    configs.get = lambda n: dataclasses.replace(_get(n), dtype="float32",
                                                **args["overrides"][arch])
    tr = Trainer(TrainJobConfig(arch=arch, steps=H * args["rounds"], seq_len=args["seq"],
                                global_batch=args["batch"], mode="local_sgd", n_pods=n_pods,
                                opt=AdamWConfig(**args["opt"]),
                                local_sgd=LocalSGDConfig(inner_steps=H, compress=compress,
                                                         nesterov=nesterov)),
                 mesh=local_mesh(mesh_name))
    tr.state = tmap(jnp.asarray, args["states"][(arch, n_pods)])
    tr._round_batches = lambda s: batches(args["data"][n_pods][s // H])
    return tr


def run_trainer(tr):
    states = []
    for _ in range(args["rounds"]):
        tr.run(H)
        states.append(tmap(np.asarray, tr.state))
        # uncommitted again: the next round reuses the first round's program
        tr.state = tmap(jnp.asarray, states[-1])
    return {"states": states, "delta_norm": tr.metrics.series("delta_norm")}


def cell():
    cfg = dataclasses.replace(cfg_of("qwen3-0.6b", "float32"), num_layers=args["cell_layers"])
    c = build_cell(cfg, "train_4k", local_mesh("2x2x2"),
                   CellOptions(titchener=True, extra=(("inner_steps", H),)),
                   AdamWConfig(**args["opt"]))
    return jax.jit(c.fn, in_shardings=c.in_shardings, out_shardings=c.out_shardings)


def run_cell(fn):
    state = tmap(jnp.asarray, args["cell_state"])
    states, norms = [], []
    for b in args["cell_data"]:
        state, m = fn(state, batches(b))
        states.append(tmap(np.asarray, state))
        norms.append(float(m["delta_norm"]))
    return {"states": states, "delta_norm": norms}


def compiled(fn, *example):
    return fn.lower(*example).compile()


# each program compiled on a thread of 4 as soon as it is built (XLA's compiler
# releases the GIL), then the programs run in turn: programs of 8 devices run at
# once can deadlock in XLA:CPU's in-process collectives
trainers, programs = {}, {}
with ThreadPoolExecutor(4) as pool:
    for name in args["cases"]:
        tr = trainers[name] = trainer(name)
        programs[name] = pool.submit(compiled, tr.round_fn, tr.state, tr._round_batches(0))
    programs["cell"] = pool.submit(compiled, cell(), tmap(jnp.asarray, args["cell_state"]),
                                   batches(args["cell_data"][0]))
    programs = {name: f.result() for name, f in programs.items()}
out = {}
for name, tr in trainers.items():
    tr.round_fn = programs[name]
    out[name] = run_trainer(tr)
out["cell"] = run_cell(programs["cell"])
from repro.roofline.hlo_stats import module_stats
st = module_stats(programs["cell"].as_text(), pod_size=4, n_devices=8)
out["cell_stats"] = {"by_opcode": st.by_opcode(), "cross_pod_bytes": st.cross_pod_bytes}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def _job(arch: str, n_pods: int, compress: bool, nesterov: bool, **kw):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.local_sgd import LocalSGDConfig
    from repro_torch.runtime.train_loop import TrainJobConfig
    return TrainJobConfig(arch=arch, steps=H * ROUNDS, seq_len=SEQ, global_batch=BATCH,
                          mode="local_sgd", n_pods=n_pods, opt=AdamWConfig(**OPT),
                          local_sgd=LocalSGDConfig(inner_steps=H, compress=compress,
                                                   nesterov=nesterov), device="cpu", **kw)


COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
               "broadcast", "all_to_all_single", "reduce", "gather", "scatter", "barrier")


class _Watch:
    """Counts the ``torch.distributed`` collectives on one process group, by the
    phase of the round (``local_sgd.inner_steps`` / ``outer_step``) and the dtype
    of their input, and the DTensor redistributions, while open."""

    def __init__(self, group):
        self.group, self.phase, self.calls, self.redistribute = group, None, {}, 0

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor
        from repro_torch.optim import local_sgd as LS
        self.saved = [(dist, n, getattr(dist, n)) for n in COLLECTIVES] + [
            (LS, n, getattr(LS, n)) for n in ("inner_steps", "outer_step")] + [
            (DTensor, "redistribute", DTensor.redistribute)]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._wrap(mod, name, fn))
        return self

    def _wrap(self, mod, name, fn):
        if name in ("inner_steps", "outer_step"):
            def phased(*a, **kw):
                self.phase = name
                try:
                    return fn(*a, **kw)
                finally:
                    self.phase = None
            return phased
        if name == "redistribute":
            def counted(*a, **kw):
                self.redistribute += 1
                return fn(*a, **kw)
            return counted

        def watched(*a, **kw):
            if self.group is not None and kw.get("group") is self.group:
                t = a[1] if name in ("all_gather", "all_gather_into_tensor") else a[0] if a \
                    else None
                key = (self.phase, name, str(getattr(t, "dtype", None)))
                self.calls[key] = self.calls.get(key, 0) + 1
            return fn(*a, **kw)
        return watched

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _rank_local(rank, world, store, tmp, args):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as cfgs
    from repro_torch.convert import to_torch
    from repro_torch.launch.mesh import make_test_mesh, n_pods
    from repro_torch.launch.steps import CellOptions, build_cell, local_sgd_state_specs
    from repro_torch.optim import local_sgd as LS
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import quantize_int8
    from repro_torch.parallel.sharding import (OneDeviceMesh, P, distribute, full_value,
                                               local_range, placements)
    from repro_torch.roofline.op_stats import measure, pod_size
    from repro_torch.runtime.train_loop import Trainer
    from repro_torch.tree import tree_flatten_sorted, tree_map
    init_gloo(rank, world, store)
    meshes = {n: make_test_mesh(s, a, device="cpu") for n, (s, a) in MESHES.items()}
    mesh1 = DeviceMesh("cpu", torch.zeros((1, 1, 1), dtype=torch.int64), mesh_dim_names=POD_AXES)
    one = OneDeviceMesh(torch.device("cpu"))
    real_get = cfgs.get
    tmp = Path(tmp)

    def start(case, mesh, **kw):
        arch, _, n_pods, compress, nesterov = CASES[case]
        cfgs.get = lambda n: dataclasses.replace(real_get(n), dtype="float32", **OVERRIDES[arch])
        tr = Trainer(_job(arch, n_pods, compress, nesterov, **kw), mesh=mesh)
        tr.state = tree_map(lambda x, sp: distribute(x, mesh, sp),
                            to_torch(args["states"][(arch, n_pods)], "cpu"), tr._specs(tr.plan))
        return tr

    def whole(state) -> dict:
        return {p: np.array(full_value(t).float().numpy()) for p, t in tree_flatten_sorted(state)}

    def misplaced(state, plan, specs, full) -> list:
        """Leaves whose local shard is not their spec's slice of the whole, placed
        by it."""
        specs = dict(tree_flatten_sorted(specs))
        bad = []
        for path, t in tree_flatten_sorted(state):
            spec = specs[path]
            sl = tuple(slice(*local_range(plan, spec, d, n)) for d, n in enumerate(t.shape))
            if not (isinstance(t, DTensor) and tuple(t.placements) == placements(plan.mesh, spec)
                    and np.array_equal(t.to_local().float().numpy(), full[path][sl])):
                bad.append(path)
        return bad

    report = {"cases": {}, "n_pods": {n: n_pods(m) for n, m in meshes.items()}}
    for case, (_, mesh_name, _, _, _) in CASES.items():
        mesh = meshes[mesh_name]
        kw = ({"checkpoint_dir": str(tmp / "ckpt_222"), "checkpoint_every": 100}
              if case == BASE else {})
        tr = start(case, mesh, **kw)
        group = mesh.get_group("pod") if "pod" in mesh.mesh_dim_names else None
        with _Watch(group) as watch:
            tr.run(H)
        states = [whole(tr.state)]
        tr.run(H)
        states.append(whole(tr.state))
        rep = {"delta_norm": tr.metrics.series("delta_norm"), "calls": watch.calls,
               "redistribute": watch.redistribute,
               "leaves": len(tree_flatten_sorted(tr.state["master"])),
               "bad": misplaced(tr.state, tr.plan, tr._specs(tr.plan), states[-1]),
               "local_pods": tr.state["pod_opt"]["step"].to_local().shape[0]}
        if rank == 0:
            rep["states"] = states
        report["cases"][case] = rep
        if case == BASE:
            base, base_state = tr, states[-1]

    # -- a fresh Trainer's own initial state: its specs' slices of one device's
    cfgs.get = lambda n: dataclasses.replace(real_get(n), dtype="float32")
    job = _job("qwen3-0.6b", 4, True, True)
    fresh = Trainer(job, mesh=meshes["2x2x2"])
    full = whole(fresh.state)
    report["init"] = {"bad": misplaced(fresh.state, fresh.plan, fresh._specs(fresh.plan), full)}
    if rank == 0:
        ref = Trainer(job, mesh=one)
        report["init"]["same"] = [p for p, t in tree_flatten_sorted(ref.state)
                                  if not np.array_equal(t.float().numpy(), full[p])]
    del fresh, full

    # -- checkpoints: the (2, 2, 2) save on (2, 4, 1) and on one device, and back
    manifest = base.save_checkpoint()
    tr = start(BASE, meshes["2x4x1"])
    step = tr.restore(manifest, strict=True)
    back = whole(tr.state)
    report["ckpt"] = {"step": step, "on_241": [p for p in base_state
                                               if not np.array_equal(back[p], base_state[p])]}
    if rank == 0:
        solo = start(BASE, one, checkpoint_dir=str(tmp / "ckpt_one"), checkpoint_every=100)
        solo.restore(manifest, strict=True)
        got = whole(solo.state)
        report["ckpt"]["on_one"] = [p for p in base_state
                                    if not np.array_equal(got[p], base_state[p])]
        report["ckpt"]["plain"] = not any(isinstance(t, DTensor) for _, t in
                                          tree_flatten_sorted(solo.state))
        solo.run(H)
        solo.save_checkpoint()
        solo_state = whole(solo.state)
    dist.barrier()
    tr = start(BASE, meshes["2x2x2"])
    report["ckpt"]["step_back"] = tr.restore({"step": H * (ROUNDS + 1),
                                              "path": str(tmp / "ckpt_one")}, strict=True)
    again = whole(tr.state)
    if rank == 0:
        report["ckpt"]["on_222"] = [p for p in again if not np.array_equal(again[p], solo_state[p])]

    # -- elastic: a round on (2, 2, 2), re-meshed onto (2, 4, 1), a round there
    tr = start(BASE, meshes["2x2x2"])
    tr.run(H)
    states = [whole(tr.state)]
    tr.remesh(meshes["2x4x1"])
    tr.run(H)
    states.append(whole(tr.state))
    report["elastic"] = {"delta_norm": tr.metrics.series("delta_norm"),
                         "bad": misplaced(tr.state, tr.plan, tr._specs(tr.plan), states[-1])}
    if rank == 0:
        report["elastic"]["states"] = states

    # -- a local-SGD train job through a TorchLocalPlane on (2, 2, 2), then its
    # checkpoint evaluated by run_eval_task on the mesh (a TrainerCache's)
    from repro_torch.runtime.local_plane import TorchLocalPlane
    from repro_torch.runtime.step_cache import TrainerCache, run_eval_task
    cfgs.get = real_get
    plane = TorchLocalPlane(device="cpu", checkpoint_root=str(tmp / "plane"),
                            mesh=meshes["2x2x2"])
    payload = {"mode": "local_sgd", "seq_len": SEQ, "global_batch": BATCH, "n_pods": 2,
               "local_sgd": {"inner_steps": H}}
    plane.submit({"job_id": "ls", "kind": "train", "steps": H * ROUNDS, "payload": payload})
    polls = [plane.poll("ls") for _ in range(ROUNDS)]
    restore = {"path": str(tmp / "plane" / "ls")}
    ev = run_eval_task(TrainerCache(0, mesh=meshes["2x2x2"]),
                       {**payload, "device": "cpu", "restore_from": restore})
    report["plane"] = {"polls": [(p["status"], p["progress"]) for p in polls], "eval": ev,
                       "dtensors": isinstance(plane.jobs["ls"].trainer.state["master"]["embed"],
                                              DTensor)}
    if rank == 0:
        report["plane"]["one"] = run_eval_task(TrainerCache(0, mesh=one),
                                               {**payload, "device": "cpu",
                                                "restore_from": restore})

    # -- the Titchener cell on (2, 2, 2), fsdp on; every master leaf's int8 scale
    cfgs.get = lambda n: dataclasses.replace(real_get(n), dtype="float32")
    mesh = meshes["2x2x2"]
    cfg = dataclasses.replace(cfgs.get("qwen3-0.6b").reduced(), remat="none",
                              num_layers=CELL_LAYERS)
    cell = build_cell(cfg, "train_4k", CellOptions(titchener=True, extra=(("inner_steps", H),)),
                      AdamWConfig(**OPT), device="cpu", mesh=mesh)
    specs = local_sgd_state_specs(cfg, cell.plan)
    state = tree_map(lambda x, sp: distribute(x, mesh, sp), to_torch(args["cell_state"], "cpu"),
                     specs)
    cell_rep = {"states": [], "delta_norm": []}
    for b in args["cell_data"]:
        b = {k: distribute(torch.from_numpy(v).to(torch.bfloat16 if k == "loss_mask" else None),
                           mesh, P(None, "pod", "data")) for k, v in b.items()}
        state, m = cell.fn(state, b)
        cell_rep["delta_norm"].append(float(m["delta_norm"]))
        full = whole(state)
        if rank == 0:
            cell_rep["states"].append(full)
    cell_rep["bad"] = misplaced(state, cell.plan, specs, full)
    scales, split = [], set()
    for path, t in tree_flatten_sorted(state["master"]):
        q, s = quantize_int8(t.to_local(), cell.plan, LS.split_axes(t))
        qw, sw = quantize_int8(full_value(t))
        spec = dict(tree_flatten_sorted(specs["master"]))[path]
        sl = tuple(slice(*local_range(cell.plan, spec, d, n)) for d, n in enumerate(t.shape))
        scales.append((path, bool(torch.equal(s, sw)), bool(torch.equal(q, qw[sl]))))
        split.update(a for e in spec if e for a in (e if isinstance(e, tuple) else (e,)))
    cell_rep["scales"], cell_rep["split"] = scales, sorted(split)
    # one more round under the dry-run's counter, on the real tensors
    _, st = measure(cell.fn, (state, b), pod_size=pod_size(mesh))
    cell_rep["counts"] = st.collective_counts()
    report["cell"] = cell_rep
    if rank == 0:
        cfgs.get = real_get
        report["one_rank"] = _one_rank(mesh1, one)
    cfgs.get = real_get
    with open(tmp / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def _one_rank(mesh1, one) -> dict:
    """``chip_smoke.py``'s ``phase_local_sgd_pods`` (a), reduced, in bf16 (the
    card's dtype) on a one-rank gloo (1, 1, 1) mesh: the local-SGD Trainer's
    rounds bit-equal to one device's."""
    from torch.distributed.tensor import DTensor
    from repro_torch.optim.local_sgd import LocalSGDConfig
    from repro_torch.parallel.sharding import full_value
    from repro_torch.runtime.train_loop import Trainer, TrainJobConfig
    from repro_torch.tree import tree_flatten_sorted
    job = TrainJobConfig(arch="qwen3-0.6b", steps=H * ROUNDS, seq_len=SEQ, global_batch=BATCH,
                         mode="local_sgd", n_pods=2, local_sgd=LocalSGDConfig(inner_steps=H),
                         device="cpu")
    ref, tr = Trainer(job, mesh=one), Trainer(job, mesh=mesh1)
    ref.run()
    tr.run()
    a = [(p, full_value(t)) for p, t in tree_flatten_sorted(tr.state)]
    b = list(tree_flatten_sorted(ref.state))
    return {"dtensors": all(isinstance(t, DTensor) for _, t in tree_flatten_sorted(tr.state)),
            "series": (tr.metrics.series("delta_norm"), ref.metrics.series("delta_norm")),
            "state": len(a) == len(b) and all(p == q and x.dtype == y.dtype and torch.equal(x, y)
                                              for (p, x), (q, y) in zip(a, b))}


def _warm_state(params: dict, n_pods: int, seed: int) -> dict:
    """A local-SGD state of numpy arrays as a run has it some rounds in: the pods
    synced to the master at pod step 4, m, v, momentum and the error feedback
    drawn from ``seed`` (m and momentum ~1e-4, v in [1e-8, 1e-6], so no element's
    Adam step sits at eps, ef within half an int8 step), round 2."""
    from repro_torch.convert import to_torch
    from repro_torch.optim.local_sgd import init_local_sgd_state
    state = tree_map(lambda t: t.numpy().copy(),
                     init_local_sgd_state(to_torch(params, "cpu"), n_pods))
    rng = np.random.default_rng(seed)
    draw = lambda scale: (lambda x: (rng.standard_normal(x.shape) * scale)  # noqa: E731
                          .astype(np.float32))
    state["pod_opt"]["m"] = tree_map(draw(1e-4), state["pod_opt"]["m"])
    state["pod_opt"]["v"] = tree_map(lambda x: rng.uniform(1e-8, 1e-6, x.shape)
                                     .astype(np.float32), state["pod_opt"]["v"])
    state["momentum"] = tree_map(draw(1e-4), state["momentum"])
    state["ef"] = tree_map(draw(1e-7), state["ef"])
    state["pod_opt"]["step"] = np.full((n_pods,), WARM_STEP, np.int32)
    state["round"] = np.array(WARM_ROUND, np.int32)
    return state


@pytest.fixture(scope="module")
def local_runs(tmp_path_factory):
    """(the JAX runs, each rank's report)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("tp_local_sgd")
    params = {arch: np_params(dataclasses.replace(cfg_of(arch, "float32"), **OVERRIDES[arch]), 0)
              for arch in OVERRIDES}
    data = {}
    for n_pods in sorted({c[2] for c in CASES.values()}):
        src = SyntheticTokens(vocab_size=512, seq_len=SEQ, global_batch=BATCH, seed=0)
        Bp = BATCH // n_pods
        data[n_pods] = [{k: np.stack([np.stack([
            src.batch_at(r * H + h, shard_id=p, batch=Bp)[k].float().numpy()
            if k == "loss_mask" else src.batch_at(r * H + h, shard_id=p, batch=Bp)[k].numpy()
            for p in range(n_pods)]) for h in range(H)])
            for k in ("tokens", "targets", "loss_mask")} for r in range(ROUNDS)]
    states = {(arch, n_pods): _warm_state(params[arch], n_pods, 3)
              for arch, _, n_pods, _, _ in CASES.values()}
    cell_params = np_params(dataclasses.replace(cfg_of("qwen3-0.6b", "float32"),
                                                num_layers=CELL_LAYERS), 1)
    rng = np.random.default_rng(2)
    args = {"states": states, "data": data, "meshes": MESHES, "cases": CASES,
            "overrides": OVERRIDES, "opt": OPT, "seq": SEQ, "batch": BATCH, "H": H,
            "rounds": ROUNDS, "cell_layers": CELL_LAYERS,
            "cell_state": _warm_state(cell_params, 2, 4),
            "cell_data": [_round_batches(rng, 512, H, 2) for _ in range(ROUNDS)]}
    proc, out = start_jax(JAX_LOCAL, args, tmp, "jax_local_sgd")
    try:
        reports = spawn_ranks(_rank_local, (args,), tmp)
    finally:
        jax_out = finish_jax(proc, out)
    return jax_out, reports


def _rounds_close(got: list, want: list, n_pods: int) -> None:
    """Each round's state, leaf by leaf, by tests/test_torch_local_sgd.py's round
    gates: the pods' m and v at MOMENT_TOL, the error feedback within EF_TOL but
    for at most EF_FLIP_SHARE of its elements (those whose int8 value rounded to
    the next one), each within one int8 step of the other side's, round and the
    pods' steps exact, every other leaf at ROUND_TOL. The first round starts from
    the same state on both sides, as that test's round does. A later round
    starts from the masters that the earlier rounds' flipped elements moved by
    one int8 step over P through the outer step; so from the second round on,
    where the error feedback differs (in this round or an earlier one) master,
    momentum and the pods' params and masters take (1 + outer_momentum) int8
    steps over P more for each round so far (the most a flip moves momentum and,
    times outer_lr < 1, the master); v stays at MOMENT_TOL and m, whose
    gradients those masters move everywhere, takes M_DRIFT_TOL more for each
    round so far; and the flip share EF_FLIP_SHARE for each round so far."""
    flipped = None
    for r, (g, w) in enumerate(zip(got, want), start=1):
        flipped = _state_close(g, w, n_pods, r, flipped)


def _state_close(got: dict, want: dict, n_pods: int, r: int, flipped):
    want = {"/".join(map(str, p)): w for p, w in _np_named(want)}
    got = {"/".join(map(str, p)): g for p, g in got.items()}
    assert sorted(got) == sorted(want)
    steps, flips, size, out = {}, 0, 0, {}
    for name, w in want.items():            # the error feedback first: the flips
        if not name.startswith("ef/"):
            continue
        g, leaf = got[name], name[3:]
        steps[leaf] = max(2 * np.abs(w[p]).max() for p in range(n_pods))
        diff = np.abs(g - w)
        off = diff > EF_TOL
        for p in range(n_pods):
            step = 2 * np.abs(w[p]).max()
            assert (diff[p][off[p]] <= 1.01 * step + EF_TOL).all(), (name, p, diff.max(), step)
        flips, size = flips + int(off.sum()), size + diff.size
        out[leaf] = off.any(axis=0) | (flipped[leaf] if flipped else False)
    assert flips <= r * EF_FLIP_SHARE * size, f"{flips} of {size} int8 elements rounded otherwise"
    for name, w in want.items():
        g = got[name]
        if name in ("round", "pod_opt/step"):
            assert np.array_equal(g, w), name
            continue
        if name.startswith("ef/"):
            continue
        moment = name.startswith(("pod_opt/m/", "pod_opt/v/"))
        if r == 1 or moment:
            tol = MOMENT_TOL if moment else ROUND_TOL
            drift = (r - 1) * M_DRIFT_TOL if name.startswith("pod_opt/m/") else 0
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol + drift, err_msg=name)
            continue
        leaf = name.split("/", 2 if name.startswith("pod_opt/") else 1)[-1]
        extra = out[leaf] * ((r - 1) * (1 + OUTER_MOMENTUM) * steps[leaf] / n_pods)
        diff = np.abs(g - w)
        assert (diff <= ROUND_TOL * (1 + np.abs(w)) + extra).all(), (name, float(diff.max()))
    return out


def _np_named(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _np_named(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree, np.float32)


@pytest.mark.parametrize("case", CASES)
def test_rounds_match_jax(local_runs, case):
    """Each round's state, every leaf, and the delta norms against the JAX
    Trainer's on the same mesh; the norms the same on every rank."""
    jax_out, reports = local_runs
    want, got = jax_out[case], reports[0]["cases"][case]
    n_pods = CASES[case][2]
    for rank, r in enumerate(reports):
        assert r["cases"][case]["delta_norm"] == got["delta_norm"], rank
    np.testing.assert_allclose(got["delta_norm"], want["delta_norm"], rtol=DELTA_NORM_RTOL)
    _rounds_close(got["states"], want["states"], n_pods)
    assert got["states"][-1][("round",)] == WARM_ROUND + ROUNDS
    assert np.array_equal(got["states"][-1][("pod_opt", "step")],
                          [WARM_STEP + H * ROUNDS] * n_pods)


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_specs_slice(local_runs, case):
    """Every leaf of every rank is its ``local_sgd_state_specs`` slice; a rank
    holds n_pods / mesh["pod"] pods (all of them without a "pod" axis)."""
    _, mesh_name, n_pods, _, _ = CASES[case]
    pods = MESHES[mesh_name][0][0] if MESHES[mesh_name][1] == POD_AXES else 1
    for rank, r in enumerate(local_runs[1]):
        rep = r["cases"][case]
        assert rep["bad"] == [], (rank, rep["bad"][:5])
        assert rep["local_pods"] == n_pods // pods, rank


@pytest.mark.parametrize("case", CASES)
def test_the_pod_group_carries_only_the_exchange(local_runs, case):
    """In a round, the "pod" group runs nothing in the inner steps; in the outer
    step compressed, one all-gather of each leaf's int8 values and one of its f32
    scales; uncompressed, one f32 all-reduce a leaf. No DTensor redistribute in
    the round. A mesh without "pod" has no such group."""
    _, mesh_name, _, compress, _ = CASES[case]
    for rank, r in enumerate(local_runs[1]):
        rep = r["cases"][case]
        n = rep["leaves"]
        if MESHES[mesh_name][1] != POD_AXES:
            want = {}
        elif compress:
            want = {("outer_step", "all_gather", "torch.int8"): n,
                    ("outer_step", "all_gather", "torch.float32"): n}
        else:
            want = {("outer_step", "all_reduce", "torch.float32"): n}
        assert rep["calls"] == want, (rank, rep["calls"])
        assert rep["redistribute"] == 0, rank


def test_titchener_cell_matches_jax(local_runs):
    """The train_4k cell's round (fsdp on, H = 2) on (2, 2, 2), twice from the
    same state: every leaf and the delta norms against the JAX cell's jitted
    round; each rank's leaves their specs' slices."""
    jax_out, reports = local_runs
    got, want = reports[0]["cell"], jax_out["cell"]
    np.testing.assert_allclose(got["delta_norm"], want["delta_norm"], rtol=DELTA_NORM_RTOL)
    _rounds_close(got["states"], want["states"], 2)
    for rank, r in enumerate(reports):
        assert r["cell"]["bad"] == [] and r["cell"]["delta_norm"] == got["delta_norm"], rank


@pytest.fixture(scope="module")
def cell_count():
    """The dry-run's per-device count (``roofline/op_stats.py``) of the cell's
    round on a fake (2, 2, 2) world, rank 0: the ranks' config, state and batch
    shapes and dtypes, fake tensors, nothing computed."""
    import torch.distributed as dist
    from repro_torch import configs as tcfgs
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    from repro_torch.launch.steps import CellOptions, build_cell
    from repro_torch.models.params import TensorDef
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline.op_stats import call_stats
    cfg = dataclasses.replace(dataclasses.replace(tcfgs.get("qwen3-0.6b"), dtype="float32")
                              .reduced(), remat="none", num_layers=CELL_LAYERS)
    lead = (H, 2, 2, SEQ)           # _round_batches(rng, 512, H, 2)'s [H, P, B, S]
    batch = {"tokens": TensorDef(lead, torch.int32), "targets": TensorDef(lead, torch.int32),
             "loss_mask": TensorDef(lead, torch.bfloat16)}
    with fake_world(8):
        mesh = make_test_mesh((2, 2, 2), POD_AXES, device="cpu")
        cell = build_cell(cfg, "train_4k", CellOptions(titchener=True,
                                                       extra=(("inner_steps", H),)),
                          AdamWConfig(**OPT), device="cpu", mesh=mesh)
        st = call_stats(cell.fn, (cell.abstract_args[0], batch), mesh, cell.in_shardings,
                        pod_size=4)
    assert not dist.is_initialized()
    return st


def test_the_dry_run_counts_the_round_as_every_rank_ran_it(local_runs, cell_count):
    """One more round of the cell on each of the 8 ranks under the dry-run's
    counter (real tensors, gloo): its collectives, each (opcode, link, operand
    bytes) with its count, equal the fake world's count of the same round."""
    want = cell_count.collective_counts()
    assert want
    for rank, r in enumerate(local_runs[1]):
        assert r["cell"]["counts"] == want, rank


def test_the_round_crosses_the_pod_as_the_jax_cell_does(local_runs, cell_count):
    """The round's cross-pod bytes a device, the port's dry-run against
    ``module_stats`` of the JAX cell's compiled round (a pod of 4 devices):
    equal, all-gathers only on both sides (printed side by side)."""
    jax_stats = local_runs[0]["cell_stats"]
    mine, theirs = cell_count.by_opcode(), jax_stats["by_opcode"]
    for key in sorted(set(mine) | set(theirs)):
        print(f"  {key:24s} port {mine.get(key, 0):>10d}  JAX {theirs.get(key, 0):>10d}")
    assert cell_count.cross_pod_bytes == jax_stats["cross_pod_bytes"] > 0
    assert {k for k in mine if k.endswith(":dcn")} == {"all-gather:dcn"}
    assert {k for k in theirs if k.endswith(":dcn")} == {"all-gather:dcn"}


def test_a_sharded_leaf_is_scaled_by_the_whole_leafs_absmax(local_runs):
    """Every master leaf of the cell's state, split over "data" (fsdp), "model"
    or neither: its int8 scale from the shards (MAX over the splitting groups)
    equals the whole leaf's, and its int8 values are the whole leaf's slice."""
    for rank, r in enumerate(local_runs[1]):
        assert r["cell"]["split"] == ["data", "model"]
        bad = [path for path, scale, q in r["cell"]["scales"] if not (scale and q)]
        assert bad == [], (rank, bad)


def test_a_fresh_trainer_lays_its_state_out_by_the_specs(local_runs):
    """A Trainer built on (2, 2, 2) with 4 pods draws its initial state as one
    device's and keeps its specs' slices."""
    reports = local_runs[1]
    assert reports[0]["init"]["same"] == []
    assert all(r["init"]["bad"] == [] for r in reports)


def test_a_plane_job_and_an_eval_task_on_the_pod_mesh(local_runs):
    """A TorchLocalPlane on (2, 2, 2) runs a local-SGD train job to done, its
    Trainer's state DTensors; run_eval_task through a TrainerCache on that mesh
    restores its checkpoint strictly and scores the one-device eval task's loss
    (bf16 params: within BF16_LOSS_TOL)."""
    reports = local_runs[1]
    one = reports[0]["plane"]["one"]
    for rank, r in enumerate(reports):
        rep = r["plane"]
        assert rep["polls"] == [("running", float(H)), ("done", float(H * ROUNDS))], rank
        assert rep["dtensors"] and rep["eval"]["restored_step"] == H * ROUNDS, rank
        np.testing.assert_allclose(rep["eval"]["eval_loss"], one["eval_loss"],
                                   rtol=BF16_LOSS_TOL, atol=BF16_LOSS_TOL)
    assert one["restored_step"] == H * ROUNDS


def test_checkpoints_restore_across_meshes(local_runs):
    """A (2, 2, 2) save restores bit-equal on (2, 4, 1) and on one device (plain
    tensors); a one-device save restores bit-equal on (2, 2, 2)."""
    reports = local_runs[1]
    ck = reports[0]["ckpt"]
    assert ck["on_one"] == [] and ck["on_222"] == [] and ck["plain"], ck
    for rank, r in enumerate(reports):
        assert r["ckpt"]["step"] == H * ROUNDS and r["ckpt"]["on_241"] == [], rank
        assert r["ckpt"]["step_back"] == H * (ROUNDS + 1), rank


def test_remesh_then_a_round_matches_the_uninterrupted_jax_run(local_runs):
    jax_out, reports = local_runs
    got, want = reports[0]["elastic"], jax_out[BASE]
    np.testing.assert_allclose(got["delta_norm"], want["delta_norm"], rtol=DELTA_NORM_RTOL)
    _rounds_close(got["states"], want["states"], 2)
    assert all(r["elastic"]["bad"] == [] for r in reports)


def test_one_rank_mesh_runs_the_one_device_code(local_runs):
    """chip_smoke.py's phase_local_sgd_pods (a), reduced, on a one-rank gloo mesh."""
    one = local_runs[1][0]["one_rank"]
    assert one["dtensors"] and one["state"]
    got, want = one["series"]
    assert len(got) == ROUNDS and got == want


def test_meshes_over_the_ranks(local_runs):
    """``make_test_mesh`` builds each mesh over the 8 ranks, and ``n_pods`` reads
    its "pod" axis (1 without one)."""
    for r in local_runs[1]:
        assert r["n_pods"] == {"2x2x2": 2, "2x4": 1, "2x1x4": 2, "2x4x1": 2}


def test_pods_must_divide_over_the_pod_axis():
    from repro_torch.optim.local_sgd import local_pods

    class FakeMesh:
        shape = {"pod": 2, "data": 1, "model": 1}
    assert local_pods(FakeMesh(), 4) == (0, 2)
    with pytest.raises(ValueError, match="divide"):
        local_pods(FakeMesh(), 3)
