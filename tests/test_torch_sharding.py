"""PyTorch port, sharding (``repro_torch.parallel.sharding``, the spec functions of
``models/params.py``, ``models/model.py``, ``optim/adamw.py`` and
``launch/steps.py``) against the JAX package's.

* Spec parity with no devices: for every registered arch's full config,
  ``partition_specs``, ``opt_state_specs``, ``Model.cache_specs`` (batch 4,
  max_len 2,048) and ``batch_pspecs`` entry for entry on four mesh shapes, under
  fsdp on and off, sp on and off, and the default and dp-only rules. The
  spec math needs only the mesh's axis sizes (``FakeMesh``, as
  tests/test_sharding.py's); the JAX package's tests twinned here too.
* Every cell's shardings (the placements of its arguments and results) against
  the JAX cell's specs on a one-device mesh.
* Placements: a dim over two mesh axes, an out-of-order spec refused, and
  ``constrain`` on a plain tensor.
* Shard for shard on 8 CPU ranks: a JAX subprocess on 8 forced host devices
  writes ``NamedSharding(mesh, spec).devices_indices_map(shape)`` of every leaf
  of reduced qwen3-0.6b's train state, cache and batch on (4, 2), (2, 2, 2) and
  (2, 2, 2) under the dp-only rules; 8 gloo ranks of the port put the same numpy
  values (from a seed, through ``convert.py``) on the same meshes, and each
  rank's local shard must equal the JAX slice at its mesh coordinate, bit for
  bit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="hypothesis not installed")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, cell_is_runnable, token_inputs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import partition_specs  # noqa: E402
from repro_torch.optim.adamw import opt_state_specs  # noqa: E402
from repro_torch.parallel.sharding import (DEFAULT_RULES, DP_ONLY_RULES, MeshPlan,  # noqa: E402
                                           OneDeviceMesh, P, constrain, placements)
from repro_torch.tree import tree_flatten_sorted  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tconfigs.names()
LOGICALS = [name for name in DEFAULT_RULES if name is not None]
MESHES = {
    "pod2-data16-model16": {"pod": 2, "data": 16, "model": 16},
    "data16-model16": {"data": 16, "model": 16},
    "data4-model2": {"data": 4, "model": 2},
    "data1-model1": {"data": 1, "model": 1},
}
RULES = {"default": None, "dp_only": "dp_only"}
# the 8-rank check: (mesh shape, axis names, rules) by name
RANK_MESHES = {"4x2": ((4, 2), ("data", "model"), None),
               "2x2x2": ((2, 2, 2), ("pod", "data", "model"), None),
               "2x2x2-dp_only": ((2, 2, 2), ("pod", "data", "model"), "dp_only")}
RANK_BATCH, RANK_SEQ, RANK_CACHE_LEN = 8, 16, 16
RANKS = 8
TIMEOUT_S = 420             # tests/test_elastic.py's for its 8-device subprocess


def _fake_mesh(shape: dict):
    class FakeMesh:
        pass
    m = FakeMesh()
    m.shape = dict(shape)
    m.axis_names = tuple(shape)
    return m


def _jax():
    return pytest.importorskip("jax")


def _jflat(tree) -> dict:
    """{path: spec entries} of a JAX spec tree, the path in the port's terms."""
    jax = _jax()
    from jax.sharding import PartitionSpec as JP
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[key] = tuple(spec)
    return out


def _tflat(tree) -> dict:
    return {path: tuple(spec) for path, spec in tree_flatten_sorted(tree)}


def _plans(mesh_shape: dict, fsdp: bool, sp: bool, rules):
    from repro.parallel.sharding import DP_ONLY_RULES as J_DP_ONLY, MeshPlan as JPlan
    mesh = _fake_mesh(mesh_shape)
    return (MeshPlan(mesh=mesh, fsdp=fsdp, sp=sp, rules=DP_ONLY_RULES if rules else None),
            JPlan(mesh=mesh, fsdp=fsdp, sp=sp, rules=J_DP_ONLY if rules else None))


# ------------------------------------------------------------------ spec parity
def test_rule_sets_are_the_jax_packages():
    _jax()
    from repro.parallel import sharding as J
    from repro_torch.parallel import sharding as T
    for name in ("DEFAULT_RULES", "OPT_RULES", "DP_ONLY_RULES"):
        assert getattr(T, name) == getattr(J, name), name
    for base in (T.DEFAULT_RULES, T.DP_ONLY_RULES):
        assert T.opt_rules_for(base) == J.opt_rules_for(base)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_entry_for_entry(arch, mesh_name):
    """Full config: params, optimizer state, cache and the train and decode
    batches, under fsdp x sp x {default, dp_only} rules."""
    _jax()
    from repro.configs import base as jconfigs
    from repro.configs.shapes import token_inputs as j_token_inputs
    from repro.launch.steps import batch_pspecs as j_batch_pspecs
    from repro.models.model import Model as JModel
    from repro.models.params import partition_specs as j_partition_specs
    from repro.optim.adamw import opt_state_specs as j_opt_state_specs
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    checked = 0
    for fsdp in (True, False):
        for sp in (False, True):
            for rules in RULES.values():
                tp, jp = _plans(MESHES[mesh_name], fsdp, sp, rules)
                pairs = [(partition_specs(tcfg, tp), j_partition_specs(jcfg, jp)),
                         (opt_state_specs(tcfg, tp), j_opt_state_specs(jcfg, jp)),
                         (TModel(tcfg, "cpu", tp).cache_specs(4, 2048),
                          JModel(jcfg, jp).cache_specs(4, 2048))]
                for shape in ("train_4k", "decode_32k"):
                    pairs.append((tsteps.batch_pspecs(tp, tcfg, token_inputs(tcfg, SHAPES[shape])),
                                  j_batch_pspecs(jp, jcfg, j_token_inputs(jcfg, SHAPES[shape]))))
                for t, j in pairs:
                    assert _tflat(t) == _jflat(j), (fsdp, sp, rules)
                    checked += len(_tflat(t))
    assert checked > 0


def _entries(spec):
    out = []
    for e in spec:
        if e is None:
            continue
        out.extend(e if isinstance(e, tuple) else (e,))
    return out


@settings(max_examples=80, deadline=None)
@given(st.lists(st.sampled_from(LOGICALS + [None]), min_size=1, max_size=5),
       st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 16, 64, 128, 151936]),
                min_size=1, max_size=5),
       st.sampled_from(sorted(MESHES)))
def test_spec_never_reuses_axis_and_divides(axes, dims, mesh_name):
    """tests/test_sharding.py's property, on the one-device test mesh and on the
    fake production meshes, and the JAX package's spec for the same inputs."""
    _jax()
    from repro.parallel.sharding import MeshPlan as JPlan
    n = min(len(axes), len(dims))
    axes, dims = axes[:n], dims[:n]
    for plan in (MeshPlan(mesh=make_test_mesh(device="cpu"), fsdp=True),
                 MeshPlan(mesh=_fake_mesh(MESHES[mesh_name]), fsdp=True)):
        spec = plan.spec(axes, dims)
        used = _entries(spec)
        assert len(used) == len(set(used))
        for d, entry in zip(dims, list(spec) + [None] * (n - len(spec))):
            if entry is None:
                continue
            group = entry if isinstance(entry, tuple) else (entry,)
            assert d % int(np.prod([plan.axis_size(a) for a in group])) == 0
    jspec = JPlan(mesh=_fake_mesh(MESHES[mesh_name]), fsdp=True).spec(axes, dims)
    assert tuple(spec) == tuple(jspec)


def test_batch_pod_data_on_production_shapes():
    plan = MeshPlan(mesh=_fake_mesh(MESHES["pod2-data16-model16"]), fsdp=True)
    assert plan.spec(("batch", "seq"), (256, 4096)) == P(("pod", "data"))
    assert plan.spec(("vocab", "embed"), (151936, 5120)) == P("model", "data")
    # opt state: embed dim spreads over pod too (ZeRO)
    assert plan.opt_spec(("vocab", "embed"), (151936, 5120)) == P("model", ("pod", "data"))
    # non-divisible dims drop axes (24 heads on model=16)
    assert plan.spec(("embed", "heads", None), (3072, 24, 128)) == P("data")


def test_sp_switch_shards_sequence():
    mesh = _fake_mesh(MESHES["pod2-data16-model16"])
    base = MeshPlan(mesh=mesh, fsdp=True, sp=False)
    sp = MeshPlan(mesh=mesh, fsdp=True, sp=True)
    assert base.spec(("batch", "seq", None), (256, 4096, 5120)) == P(("pod", "data"))
    assert sp.spec(("batch", "seq", None), (256, 4096, 5120)) == P(("pod", "data"), "model")


# ------------------------------------------------------------------- placements
def test_sharding_gives_placements_of_a_two_axis_dim():
    from torch.distributed.tensor import Replicate, Shard
    plan = MeshPlan(mesh=_fake_mesh(MESHES["pod2-data16-model16"]), fsdp=True)
    assert plan.sharding(("batch", "seq"), (256, 4096)) == (Shard(0), Shard(0), Replicate())
    assert plan.sharding(("vocab", "embed"), (151936, 5120)) == (Replicate(), Shard(1), Shard(0))
    dp = MeshPlan(mesh=_fake_mesh(MESHES["pod2-data16-model16"]), rules=DP_ONLY_RULES)
    assert dp.sharding(("batch", "seq"), (512, 4096)) == (Shard(0),) * 3
    assert plan.sharding((None, None), (4, 4)) == (Replicate(),) * 3


def test_out_of_order_spec_and_unknown_axis_are_refused():
    mesh = _fake_mesh(MESHES["pod2-data16-model16"])
    plan = MeshPlan(mesh=mesh, rules=dict(DEFAULT_RULES, batch=("data", "pod")))
    assert plan.spec(("batch",), (256,)) == P(("data", "pod"))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        plan.sharding(("batch",), (256,))
    with pytest.raises(ValueError, match="not in the mesh"):
        placements(_fake_mesh(MESHES["data4-model2"]), P("pod"))


def test_constrain_returns_a_plain_tensor_as_it_is():
    plan = MeshPlan(mesh=make_test_mesh(device="cpu"), fsdp=True)
    x = torch.ones(4, 8)
    assert constrain(x, plan, ("batch", "embed")) is x
    assert isinstance(plan.mesh, OneDeviceMesh) and plan.mesh.device.type == "cpu"


def test_meshes_without_ranks():
    """No process group: the production meshes raise, naming the ranks they need;
    the test mesh is the one-device mesh; the mesh functions read a mesh's axes as
    the JAX package's do."""
    _jax()
    from repro.launch import mesh as J
    from repro_torch.launch import mesh as T
    with pytest.raises(RuntimeError, match="needs a default process group of 256 ranks"):
        T.make_production_mesh()
    with pytest.raises(RuntimeError, match="of 512 ranks; none is initialised"):
        T.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        T.make_test_mesh((2, 2), ("data", "model"), device="cpu")
    one = T.make_test_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    assert isinstance(one, OneDeviceMesh) and T.mesh_axes(one) == ("pod", "data", "model")
    for shape in MESHES.values():
        mesh = _fake_mesh(shape)
        assert (T.mesh_axes(mesh), T.n_pods(mesh), T.chips(mesh)) == (
            J.mesh_axes(mesh), J.n_pods(mesh), J.chips(mesh))


def test_partition_spec_is_a_tree_leaf_and_pickles():
    spec = P(("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(spec)) == spec and type(spec) is P
    assert tree_flatten_sorted({"a": spec}) == [(("a",), spec)]


# ---------------------------------------------------------------- the cells
CELLS = [(a, s) for a in ARCHS for s in SHAPES if not cell_is_runnable(tconfigs.get(a), s)]
# every cell, and every train cell again as the Titchener round
CELL_CASES = ([(a, s, False) for a, s in CELLS]
              + [(a, s, True) for a, s in CELLS if SHAPES[s].step == "train"])


def _jspecs_to_placements(mesh, tree):
    """The JAX cell's NamedSharding tree as placements on the port's mesh."""
    jax = _jax()
    return jax.tree_util.tree_map(lambda s: placements(mesh, P(*s.spec)), tree,
                                  is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))


@pytest.mark.parametrize("arch,shape,titchener", CELL_CASES,
                         ids=[f"{a}-{s}-{'titchener' if t else 'sync'}" for a, s, t in CELL_CASES])
def test_cell_shardings_match_the_jax_cell(arch, shape, titchener):
    """Full width on one device (the Titchener round on a (pod, data, model) mesh
    of one): the cell's placements are the JAX cell's specs', argument for
    argument and result for result, under dp_only rules as well."""
    jax = _jax()
    from jax.sharding import AxisType, Mesh
    from repro.launch.steps import CellOptions as JOpts, build_cell as j_build
    axes = ("pod", "data", "model") if titchener else ("data", "model")
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(axes)), axes,
                 axis_types=(AxisType.Auto,) * len(axes))
    for dp_only in (False, True):
        jcell = j_build(arch, shape, jmesh, JOpts(titchener=titchener, dp_only=dp_only))
        tcell = tsteps.build_cell(arch, shape, tsteps.CellOptions(titchener=titchener,
                                                                  dp_only=dp_only),
                                  device="cpu")
        assert tuple(tcell.mesh.shape) == axes and tcell.plan.rules == (
            DP_ONLY_RULES if dp_only else None)
        assert tcell.in_shardings == _jspecs_to_placements(tcell.mesh, jcell.in_shardings)
        assert tcell.out_shardings == _jspecs_to_placements(tcell.mesh, jcell.out_shardings)


@pytest.mark.parametrize("zero2", [False, True], ids=["param_specs", "zero2"])
def test_cell_on_a_production_mesh_and_its_accumulator(zero2):
    """deepseek-moe-16b's train cell on the fake (2, 16, 16) mesh: its state and
    batch placements are those of the JAX package's specs there, and the gradient
    accumulator is laid out as the JAX train step lays it: by the optimizer's
    (pod-spread) rules under zero2_accum, else by the params'."""
    _jax()
    from repro.configs import base as jconfigs
    from repro.launch.steps import batch_pspecs as j_batch_pspecs, train_state_specs as j_specs
    from repro.configs.shapes import token_inputs as j_token_inputs
    from repro.models.params import is_def, param_defs as j_param_defs
    jax = _jax()
    arch, mesh = "deepseek-moe-16b", _fake_mesh(MESHES["pod2-data16-model16"])
    cell = tsteps.build_cell(arch, "train_4k", tsteps.CellOptions(zero2_accum=zero2),
                             device="cpu", mesh=mesh)
    _, jp = _plans(MESHES["pod2-data16-model16"], True, False, None)
    jcfg = jconfigs.get(arch)

    def as_placements(jtree):
        from jax.sharding import PartitionSpec as JP
        return tsteps.named(mesh, jax.tree_util.tree_map(
            lambda s: P(*s), jtree, is_leaf=lambda x: isinstance(x, JP)))

    assert cell.in_shardings == (
        as_placements(j_specs(jcfg, jp)),
        as_placements(j_batch_pspecs(jp, jcfg, j_token_inputs(jcfg, SHAPES["train_4k"]))))
    accum = jax.tree_util.tree_map(
        lambda d: (jp.opt_spec if zero2 else jp.spec)(d.logical, d.shape),
        j_param_defs(jcfg), is_leaf=is_def)
    assert _tflat(cell.fn.accum_specs) == _jflat(accum)
    assert (_tflat(cell.fn.accum_specs) == _tflat(opt_state_specs(cell.cfg, cell.plan)["m"])) \
        == zero2


# ------------------------------------------------------- shard for shard, 8 ranks
JAX_INDEX_MAPS = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import dataclasses
    import jax, numpy as np
    from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import base as configs
    from repro.launch.steps import abstract_train_state, batch_pspecs, train_state_specs
    from repro.models.model import Model
    from repro.parallel.sharding import DP_ONLY_RULES, MeshPlan

    meshes, B, S, L, out_path = pickle.loads(bytes.fromhex(sys.argv[1]))
    cfg = dataclasses.replace(configs.get("qwen3-0.6b").reduced(), remat="none")
    inputs = {k: jax.ShapeDtypeStruct((B, S), dt) for k, dt in
              (("tokens", np.int32), ("targets", np.int32), ("loss_mask", jax.numpy.bfloat16))}

    def flat(tree, is_leaf=None):
        out = []
        for path, x in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]:
            out.append((tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path), x))
        return out

    result = {}
    for name, (shape, axes, rules) in meshes.items():
        mesh = Mesh(np.array(jax.devices()).reshape(shape), axes,
                    axis_types=(AxisType.Auto,) * len(axes))
        coord = {d.id: tuple(int(i) for i in idx) for idx, d in np.ndenumerate(mesh.devices)}
        plan = MeshPlan(mesh=mesh, rules=DP_ONLY_RULES if rules else None)
        model = Model(cfg, plan)
        trees = {"state": (train_state_specs(cfg, plan), abstract_train_state(cfg)),
                 "cache": (model.cache_specs(B, L), model.abstract_cache(B, L)),
                 "batch": (batch_pspecs(plan, cfg, inputs), inputs)}
        leaves = []
        for part, (specs, shapes) in trees.items():
            specs = flat(specs, is_leaf=lambda x: isinstance(x, P))
            shapes = flat(shapes)
            assert [p for p, _ in specs] == [p for p, _ in shapes]
            for (path, spec), (_, sd) in zip(specs, shapes):
                idx = NamedSharding(mesh, spec).devices_indices_map(sd.shape)
                by_coord = {coord[d.id]: tuple((sl.start or 0, n if sl.stop is None else sl.stop)
                                               for sl, n in zip(sls, sd.shape))
                            for d, sls in idx.items()}
                leaves.append((part, path, tuple(spec), tuple(sd.shape), str(sd.dtype), by_coord))
        result[name] = leaves
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    print("INDEX_MAPS_OK")
""")


def run_jax_subprocess(script: str, args: tuple, tmp: Path, out_name: str):
    """Run ``script`` in a JAX process of 8 forced host devices; returns the
    pickle it writes to ``tmp / out_name``."""
    out = tmp / out_name
    path = tmp / "jax_script.py"
    path.write_text(script)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(path), pickle.dumps(args + (str(out),)).hex()],
                          cwd=str(ROOT), env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0 and out.exists(), proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def spawn_ranks(fn, args: tuple, tmp: Path, n: int = RANKS) -> list:
    """Run ``fn(rank, n, store, tmp, *args)`` on ``n`` spawned CPU processes; each
    writes its result to ``tmp / f"rank{rank}.pkl"``. Returns the results by rank.
    The ranks meet through a file store in ``tmp`` (no port). ``args`` reach them
    through a file: a spawned process takes its arguments through a pipe only as
    fast as it imports this module, so large ones would start the ranks one at a
    time."""
    import torch.multiprocessing as mp
    with open(tmp / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    ctx = mp.start_processes(_rank_main, args=(n, str(tmp / "store"), str(tmp), fn), nprocs=n,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for rank in range(n):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, store: str, tmp: str, fn) -> None:
    with open(Path(tmp) / "args.pkl", "rb") as f:
        args = pickle.load(f)
    fn(rank, world, store, tmp, *args)


def init_gloo(rank: int, world: int, store: str) -> None:
    import datetime
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _rank_shards(rank, world, store, tmp, meshes, maps, values):
    """One gloo rank: every leaf of every mesh laid out by the port, its local
    shard against the JAX slice at this rank's mesh coordinate."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.convert import to_torch
    from repro_torch.models.params import TensorDef
    from repro_torch.parallel.sharding import distribute
    init_gloo(rank, world, store)
    cfg = dataclasses.replace(tconfigs.get("qwen3-0.6b").reduced(), remat="none")
    full = to_torch(values, "cpu")
    report = {"checked": 0, "bad": [], "specs": {}}
    for name, (shape, axes, rules) in meshes.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        plan = MeshPlan(mesh=mesh, rules=DP_ONLY_RULES if rules else None)
        inputs = {k: TensorDef((RANK_BATCH, RANK_SEQ), dt) for k, dt in
                  (("tokens", torch.int32), ("targets", torch.int32),
                   ("loss_mask", torch.bfloat16))}
        trees = {"state": tsteps.train_state_specs(cfg, plan),
                 "cache": TModel(cfg, "cpu", plan).cache_specs(RANK_BATCH, RANK_CACHE_LEN),
                 "batch": tsteps.batch_pspecs(plan, cfg, inputs)}
        specs = {(part, path): spec for part, tree in trees.items()
                 for path, spec in tree_flatten_sorted(tree)}
        report["specs"][name] = {k: tuple(v) for k, v in specs.items()}
        coord = tuple(mesh.get_coordinate())
        for part, path, _, _, _, by_coord in maps[name]:
            x = full[part]["/".join(map(str, path))]
            local = distribute(x, mesh, specs[(part, path)]).to_local()
            want = x[tuple(slice(a, b) for a, b in by_coord[coord])]
            report["checked"] += 1
            if local.dtype != want.dtype or not torch.equal(local, want):
                report["bad"].append((name, part, path, tuple(local.shape), tuple(want.shape)))
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)
    dist.destroy_process_group()


def _np_value(rng, shape, dtype: str):
    if dtype == "int32":
        return rng.integers(0, 1 << 20, shape, dtype=np.int32)
    x = rng.standard_normal(shape, dtype=np.float32)
    if dtype == "bfloat16":
        import ml_dtypes
        return x.astype(ml_dtypes.bfloat16)
    assert dtype == "float32", dtype
    return x


@pytest.fixture(scope="module")
def shard_runs(tmp_path_factory):
    """(the JAX index maps, each rank's report) of the 8-rank check."""
    _jax()
    tmp = tmp_path_factory.mktemp("shards")
    maps = run_jax_subprocess(JAX_INDEX_MAPS, (RANK_MESHES, RANK_BATCH, RANK_SEQ,
                                              RANK_CACHE_LEN), tmp, "maps.pkl")
    rng = np.random.default_rng(0)
    values = {"state": {}, "cache": {}, "batch": {}}
    for part, path, _, shape, dtype, _ in maps["4x2"]:
        values[part]["/".join(map(str, path))] = _np_value(rng, shape, dtype)
    return maps, spawn_ranks(_rank_shards, (RANK_MESHES, maps, values), tmp)


def test_every_local_shard_is_the_jax_slice_at_its_mesh_coordinate(shard_runs):
    maps, reports = shard_runs
    n_leaves = sum(len(leaves) for leaves in maps.values())
    assert {len(leaves) for leaves in maps.values()} == {len(maps["4x2"])} and n_leaves > 100
    for rank, rep in enumerate(reports):
        assert rep["bad"] == [], (rank, rep["bad"][:5])
        assert rep["checked"] == n_leaves, rank


def test_rank_specs_are_the_jax_specs(shard_runs):
    """The specs each rank laid out by, leaf for leaf, against the JAX package's
    on the same meshes (real devices this time, not a FakeMesh)."""
    maps, reports = shard_runs
    for name, leaves in maps.items():
        want = {(part, path): spec for part, path, spec, _, _, _ in leaves}
        for rep in reports:
            assert rep["specs"][name] == want, name
    # the meshes lay out two- and three-axis dims: batch over (pod, data) and
    # (pod, data, model)
    batch = {name: dict(((p, path), s) for p, path, s, *_ in leaves)[("batch", ("tokens",))]
             for name, leaves in maps.items()}
    assert batch == {"4x2": ("data",), "2x2x2": (("pod", "data"),),
                     "2x2x2-dp_only": (("pod", "data", "model"),)}

