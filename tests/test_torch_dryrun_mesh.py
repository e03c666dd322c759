"""PyTorch port, the dry-run on meshes of ranks: ``roofline/op_stats.py``'s
per-device count on a fake process group (``launch/mesh.py``'s ``fake_world``)
of the collectives a step issues, each marked in-pod or cross-pod by its group's
ranks (the twin of tests/test_hlo_stats.py's classification), the flops of the
reduced qwen3 cells on a fake (2, 2, 2) ("pod", "data", "model") world against
``repro.roofline.hlo_stats`` on the JAX cell compiled for the same mesh of 8
forced host devices, the sync step's cross-pod bytes worked out from the state's
specs, and ``python -m repro_torch.launch.dryrun --mesh both`` at full width on
the production meshes of 256 and 512 fake ranks, with the report's collective
term. The counts on real gloo ranks are held against the fake group's in
tests/test_torch_tp_local_sgd.py and tests/test_torch_tp_train.py. Every test
that starts a fake world checks that none is left behind."""
import json
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import (CHIPS_PER_POD, CROSS_POD_BW, IN_POD_BW,  # noqa: E402
                                     fake_world, make_production_mesh, make_test_mesh)
from repro_torch.models.params import abstract_params, param_defs  # noqa: E402
from repro_torch.optim.local_sgd import LocalSGDConfig, dcn_bytes_per_round  # noqa: E402
from repro_torch.parallel.sharding import MeshPlan, compute_spec, mesh_shape  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.op_stats import cell_stats, groups_cross_pod, measure  # noqa: E402
from repro_torch.tree import tree_flatten_sorted  # noqa: E402
from test_torch_dryrun import FLOPS_RTOL, _cut_shapes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
POD_AXES = ("pod", "data", "model")
ARCH = "qwen3-0.6b"
TIMEOUT_S = 300

JAX_SYNC = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import base as configs
from repro.configs import shapes
from repro.launch.steps import CellOptions, build_cell
from repro.roofline.hlo_stats import module_stats
shapes.SHAPES["train_4k"] = shapes.ShapeSpec("train_4k", 256, 8, "train")
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"),
            axis_types=(AxisType.Auto,) * 3)
cell = build_cell(configs.get(sys.argv[2]).reduced(), "train_4k", mesh,
                  CellOptions(num_microbatches=2))
st = module_stats(cell.lower().compile().as_text(), pod_size=4, n_devices=8)
with open(sys.argv[1], "wb") as f:
    pickle.dump({"flops": st.flops, "by_opcode": st.by_opcode(),
                 "cross_pod_bytes": st.cross_pod_bytes}, f)
"""


class _SpecMesh:
    """The spec math's mesh: axis sizes, no ranks."""

    def __init__(self, shape: dict):
        self.shape = shape


def _axes(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def _local(shape, spec, sizes: dict) -> list:
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            out[d] //= sizes[a]
    return out


# ------------------------------------------------------------------ the fake world
def test_only_fake_world_imports_torch_testing():
    """``torch.testing._internal`` (the fake group's store) is imported by the port
    only inside ``launch/mesh.py``'s ``fake_world``, never at a module's load."""
    import ast
    where = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.startswith("torch.testing") for n in names):
                where.append((path.relative_to(ROOT).as_posix(), node.lineno,
                              node in tree.body))
    assert [(w[0], w[2]) for w in where] == [("src/repro_torch/launch/mesh.py", False)]
    fn = next(n for n in ast.walk(ast.parse((ROOT / "src/repro_torch/launch/mesh.py")
                                            .read_text()))
              if isinstance(n, ast.FunctionDef) and n.name == "fake_world")
    assert fn.lineno < where[0][1] <= fn.end_lineno


def test_fake_world_refuses_a_second_world_and_always_tears_down():
    with fake_world(8):
        assert dist.get_world_size() == 8 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="initialised already"):
            with fake_world(8):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="inside"):
        with fake_world(4, rank=3):
            assert dist.get_rank() == 3
            raise ValueError("inside")
    assert not dist.is_initialized()


@pytest.mark.parametrize("multi", [False, True])
def test_the_production_meshes_build_on_a_fake_world(multi):
    """(16, 16) on 256 fake ranks, (2, 16, 16) on 512: the mesh's shape, its "pod"
    line ranks 0 and 256 (a pod is CHIPS_PER_POD ranks); without the world, or on
    one of the wrong size, it raises."""
    n = 512 if multi else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        assert mesh.size() == n and mesh_shape(mesh) == (
            {"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16})
        if multi:
            assert dist.get_process_group_ranks(mesh.get_group("pod")) == [0, CHIPS_PER_POD]
        with pytest.raises(RuntimeError, match="needs a default process group"):
            make_production_mesh(multi_pod=not multi, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="none is initialised"):
        make_production_mesh(multi_pod=multi, device="cpu")


# ---------------------------------------------------------------- classification
GROUPS = {"pod": True, "data": False, "model": False, ("data", "model"): False}


@pytest.mark.parametrize("axes", list(GROUPS), ids=str)
def test_cross_pod_classification(axes):
    """On a fake (2, 2, 2) world (a pod is 4 ranks): an all-reduce and an
    all-gather on the "pod" group cross the boundary; on "data", "model" and the
    flattened ("data", "model") group they stay in the pod. Each records the
    bytes this device sends."""
    with fake_world(8):
        mesh = make_test_mesh((2, 2, 2), POD_AXES, device="cpu")
        group = mesh[axes]._flatten().get_group() if isinstance(axes, tuple) else \
            mesh.get_group(axes)
        x = torch.zeros(6, 5)

        def step(x):
            dist.all_reduce(x, group=group)
            parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x, group=group)

        _, st = measure(step, (x,), pod_size=4)
    assert not dist.is_initialized()
    cross = GROUPS[axes]
    link = "dcn" if cross else "ici"
    assert st.collective_counts() == {("all-reduce", link, 120): 1, ("all-gather", link, 120): 1}
    assert (st.cross_pod_bytes, st.in_pod_bytes) == ((240, 0) if cross else (0, 240))
    assert st.by_opcode() == {f"all-reduce:{link}": 120, f"all-gather:{link}": 120}


def test_groups_cross_pod_by_ranks():
    """The rule itself, as hlo_stats' ``groups_cross_pod`` on replica groups."""
    assert groups_cross_pod([0, 4], 4) and groups_cross_pod([3, 4], 4)
    assert not groups_cross_pod([0, 1, 2, 3], 4) and not groups_cross_pod([4, 6], 4)
    assert not groups_cross_pod([0, 4], None) and not groups_cross_pod([0, 255], 256)
    assert groups_cross_pod([0, 256], 256)


def test_a_dtensor_redistribute_over_pod_is_a_cross_pod_all_gather():
    """DTensor's own collectives (a redistribute from a "pod" split to whole, the
    functional all-gather) are counted, on the local shard; on a mesh without a
    "pod" axis (one pod of 8 ranks) nothing crosses."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with fake_world(8):
        for shape, axes, size, link in (((2, 2, 2), POD_AXES, 4, "dcn"),
                                        ((2, 4), ("data", "model"), 8, "ici")):
            mesh = make_test_mesh(shape, axes, device="cpu")
            x = distribute_tensor(torch.zeros(8, 4), mesh,
                                  (Shard(0),) + (Replicate(),) * (len(shape) - 1),
                                  src_data_rank=None)
            out, st = measure(lambda t: t.redistribute(mesh, (Replicate(),) * len(shape)), (x,),
                              pod_size=size)
            assert out.to_local().shape == (8, 4)
            assert st.collective_counts() == {("all-gather", link, 4 * 4 * 4): 1}
    assert not dist.is_initialized()


def test_one_card_records_no_collective():
    from repro_torch.models.params import TensorDef
    from repro_torch.roofline.op_stats import call_stats
    st = call_stats(lambda x: (x @ x).sum(), (TensorDef((4, 4), torch.float32),))
    assert st.collectives == [] and st.collective_bytes == 0 and st.top_collectives() == []


# ----------------------------------------------------- the reduced cells on (2, 2, 2)
@pytest.fixture(scope="module")
def jax_sync(tmp_path_factory):
    """The JAX sync train cell of reduced qwen3 at 256 x 8 tokens, M = 2, compiled
    for a (2, 2, 2) Auto-axis mesh of 8 forced host devices: hlo_stats' flops and
    collectives, a pod of 4 devices."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("dryrun_mesh")
    (tmp / "sync.py").write_text(JAX_SYNC)
    out = tmp / "sync.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(tmp / "sync.py"), str(out), ARCH], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _cell_on(shape_name, opts, mesh_shape_=(2, 2, 2), axes=POD_AXES):
    """(cell, its per-device OpStats) of reduced qwen3 on a fake world of the mesh's
    size; the world is gone after."""
    with fake_world(math.prod(mesh_shape_)):
        mesh = make_test_mesh(mesh_shape_, axes, device="cpu")
        cell = tsteps.build_cell(tconfigs.get(ARCH).reduced(), shape_name, opts, device="cpu",
                                 mesh=mesh)
        st = cell_stats(cell)
    assert not dist.is_initialized()
    return cell, st


def test_sync_train_cell_matches_jax_on_2x2x2(jax_sync, monkeypatch):
    """The sync train cell (256 x 8 tokens, M = 2) on a fake (2, 2, 2) world: its
    per-device dot flops within FLOPS_RTOL of hlo_stats' on the JAX program for
    the same mesh (printed with the collectives side by side by opcode and link).
    Its cross-pod bytes are not held against JAX's, part of which is XLA's
    partitioner's own resharding; they equal what the step must send over the
    "pod" group, worked out from the specs: each param's f32 gradient, of its
    compute shard, all-reduced over "pod"; each master split over "pod" by the
    optimizer's (ZeRO) rules gathered back over "pod" in the param's dtype,
    DTensor gathering its "data" split first (so its operand is the master shard
    times the "data" size); and the loss's two f32 sums a microbatch."""
    _cut_shapes(monkeypatch, tshapes)
    cell, st = _cell_on("train_4k", tsteps.CellOptions(num_microbatches=2))
    got, want = st.dot_flops, jax_sync["flops"]
    mine = st.by_opcode()
    print(f"sync train cell on (2, 2, 2), per device: dot flops port {got:.0f}, JAX {want:.0f} "
          f"({got / want:.4f}x); cross-pod bytes port {st.cross_pod_bytes}, JAX "
          f"{jax_sync['cross_pod_bytes']}")
    for key in sorted(set(mine) | set(jax_sync["by_opcode"])):
        print(f"  {key:24s} port {mine.get(key, 0):>12d}  JAX {jax_sync['by_opcode'].get(key, 0):>12d}")
    assert abs(got - want) <= FLOPS_RTOL * want

    cfg, plan = cell.cfg, cell.plan
    sizes = mesh_shape(cell.mesh)
    specs = tsteps.train_state_specs(cfg, plan)
    opt_specs = dict(tree_flatten_sorted(specs["opt"]["master"]))
    dtypes = dict(tree_flatten_sorted(abstract_params(cfg)))
    grads = gathers = 0
    for path, d in tree_flatten_sorted(param_defs(cfg)):
        grads += 4 * math.prod(_local(d.shape, compute_spec(plan, d.logical, d.shape), sizes))
        spec = opt_specs[path]
        if any("pod" in _axes(e) for e in spec):
            gathers += (dtypes[path].dtype.itemsize * sizes["data"]
                        * math.prod(_local(d.shape, spec, sizes)))
    loss_sums = 2 * 2 * 4
    assert st.cross_pod_bytes == grads + gathers + loss_sums
    assert st.by_opcode()["all-reduce:dcn"] == grads + loss_sums
    assert st.by_opcode()["all-gather:dcn"] == gathers


def test_prefill_splits_its_flops_as_far_as_its_batch_allows(monkeypatch):
    """Prefill of 1,024 x 2 tokens: a batch of 2 cannot split over ("pod",
    "data") of 4, so a device's flops lie between the one-device step's / 8 and
    the one-device step's; nothing crosses the pod."""
    _cut_shapes(monkeypatch, tshapes)
    one = cell_stats(tsteps.build_cell(tconfigs.get(ARCH).reduced(), "prefill_32k",
                                       device="cpu"))
    _, st = _cell_on("prefill_32k", tsteps.CellOptions())
    print(f"prefill per device {st.dot_flops:.0f}, one device {one.dot_flops:.0f} "
          f"({st.dot_flops / one.dot_flops * 8:.3f} x 1/8)")
    assert one.dot_flops / 8 < st.dot_flops < one.dot_flops
    assert st.cross_pod_bytes == 0 and st.in_pod_bytes > 0


# ------------------------------------------------------------- the CLI at full width
def test_cli_both_meshes_at_full_width(tmp_path, capsys):
    """qwen3-0.6b/decode_32k on one card and on both production meshes: the
    records' mesh, chips and per-device peak (below one card's), nothing across
    the pod on either mesh (the reduced JAX decode crosses with one 1,024-byte
    all-gather, a resharding of XLA's partitioner), the verbose line's coll= and
    dcn=, and the report's rows with the collective term from the two rates."""
    argv = ["--arch", ARCH, "--shape", "decode_32k", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    assert dryrun.main(argv + ["--mesh", "both"]) == 0
    out = capsys.readouterr().out
    assert not dist.is_initialized()
    assert "dry-run summary: ok=2 skip=0 fail=0" in out
    assert "per device of 512" in out and "coll=" in out and "(dcn=0.000e+00)" in out
    one = json.loads((tmp_path / f"{ARCH}__decode_32k.json").read_text())
    for mesh, chips in (("single", 256), ("multi", 512)):
        rec = json.loads((tmp_path / mesh / f"{ARCH}__decode_32k.json").read_text())
        hs = rec["hlo_stats"]
        assert rec["mesh"] == mesh and rec["chips"] == chips
        assert hs["peak_bytes"] < one["hlo_stats"]["peak_bytes"]
        assert hs["cross_pod_bytes"] == 0 < hs["in_pod_bytes"] == hs["collective_bytes"]
        assert all(k.endswith(":ici") for k in hs["by_opcode"]) and hs["top_collectives"]
        assert sum(hs["by_opcode"].values()) == hs["collective_bytes"]
        rows = report.load_rows(root=tmp_path, mesh=mesh)
        assert [r.cell for r in rows] == [f"{ARCH}/decode_32k"]
        r = rows[0]
        assert r.chips == chips and r.mem_gb == hs["peak_bytes"] / 1e9 and r.fits
        assert r.collective_s == hs["in_pod_bytes"] / IN_POD_BW + hs["cross_pod_bytes"] / CROSS_POD_BW
        assert r.collective_s > 0
    assert [r.mesh for r in report.load_rows(root=tmp_path)] == ["h100"]


def test_titchener_round_at_full_width_sends_its_int8_shards_across(tmp_path, capsys):
    """``--mesh multi --set titchener=true`` on qwen3-0.6b/train_4k (one inner
    step: the exchange does not depend on H): the round's cross-pod bytes are the
    int8 values of this device's fsdp-split master shards plus one f32 scale a
    leaf, all-gathered over "pod"; printed beside ``dcn_bytes_per_round``'s
    figure (a ring all-reduce's 2x payload of the whole tree)."""
    argv = ["--arch", ARCH, "--shape", "train_4k", "--mesh", "multi", "--set", "titchener=true",
            "--set", "inner_steps=1", "--tag", "titchener", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    assert not dist.is_initialized()
    rec = json.loads((tmp_path / "multi" / f"{ARCH}__train_4k__titchener.json").read_text())
    hs = rec["hlo_stats"]
    cfg = tconfigs.get(ARCH)
    sizes = {"pod": 2, "data": 16, "model": 16}
    specs = tsteps.local_sgd_state_specs(cfg, MeshPlan(mesh=_SpecMesh(sizes)))["master"]
    payload = leaves = 0
    for (path, d), (_, spec) in zip(tree_flatten_sorted(param_defs(cfg)),
                                    tree_flatten_sorted(specs)):
        payload += math.prod(_local(d.shape, spec, sizes))
        leaves += 1
    want = payload + 4 * leaves
    ring, _ = dcn_bytes_per_round([torch.empty(d.shape, device="meta")
                                   for _, d in tree_flatten_sorted(param_defs(cfg))],
                                  LocalSGDConfig(inner_steps=1))
    print(f"titchener round on (2, 16, 16), per device: cross-pod {hs['cross_pod_bytes']} bytes "
          f"(int8 {payload} + scales {4 * leaves}); dcn_bytes_per_round {ring}")
    assert hs["cross_pod_bytes"] == want
    assert set(k for k in hs["by_opcode"] if k.endswith(":dcn")) == {"all-gather:dcn"}
