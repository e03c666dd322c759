"""PyTorch port, elastic re-meshing (``repro_torch.runtime.elastic``) against the
JAX package's ``repro.runtime.elastic``.

* ``divisors_mesh``; the ``ElasticController`` seeing a join and a leave on the
  port's own plane (tests/test_elastic.py's twins); the Trainer going on after a
  same-device re-mesh, its losses and state bit-equal to an uninterrupted run's;
  ``examples/torch_elastic_training.py --device cpu``.
* 8 CPU ranks (gloo), as tests/test_elastic.py's 8-device subprocess: reduced
  qwen3-0.6b's train state laid out on a (4, 2) mesh and re-meshed onto (2, 2)
  over ranks 0-3, every value bit-equal and only ranks 0-3 holding shards; the
  sharded forward's logits on both meshes within bf16 2e-2 of each other
  (tests/test_elastic.py's gate), and within the port's model-parity gates
  (tests/test_torch_model.py: f32 1e-4, bf16 0.08) of the JAX package's forward
  on 8 forced host devices from the same params (a JAX subprocess, its
  ``init_params`` from ``PRNGKey(0)``, carried across by ``convert.py``; qwen3
  and gemma3, the dense family, take the tensor-parallel route); the other
  families' sharded forward on (4, 2) against their one-device forward (every
  family tensor-parallel, moe's experts split over "model").
  Rank 0
  also runs the card's elastic phase of ``chip_smoke.py`` at reduced size: a
  Trainer's state re-meshed onto a one-rank ``DeviceMesh`` and back between its
  steps, and the sharded forward there bit-equal to the one-device forward.
"""
import dataclasses
import importlib.util
import pickle
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.plane import ManagementPlane, SimLocalPlane  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.steps import batch_pspecs, train_state_specs  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import TensorDef  # noqa: E402
from repro_torch.parallel.sharding import MeshPlan, OneDeviceMesh  # noqa: E402
from repro_torch.runtime.elastic import (ElasticController, divisors_mesh,  # noqa: E402
                                         remesh_state)
from repro_torch.runtime.train_loop import Trainer, TrainJobConfig  # noqa: E402
from repro_torch.tree import tree_flatten_sorted, tree_map  # noqa: E402
from test_torch_model import BF16_TOL, F32_TOL  # noqa: E402
from test_torch_sharding import init_gloo, run_jax_subprocess, spawn_ranks  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-0.6b"
DTYPES = ("bfloat16", "float32")
REMESH_TOL = 2e-2            # tests/test_elastic.py:89-91
BATCH, SEQ = 4, 16           # tests/test_elastic.py's tokens
TRAIN = {"arch": ARCH, "steps": 4, "seq_len": 8, "global_batch": 2, "device": "cpu"}


# ------------------------------------------------------------------- on the CPU
@pytest.mark.parametrize("n,grid", [(256, (16, 16)), (12, (4, 3)), (7, (7, 1))])
def test_divisors_mesh(n, grid):
    assert divisors_mesh(n) == grid


def test_controller_sees_join_and_leave():
    plane = ManagementPlane()
    plane.add_cluster("master", is_master=True, local_plane=SimLocalPlane(caps=("control",)))
    plane.add_cluster("onprem-0", local_plane=SimLocalPlane(("cpu",), 1.0))
    changes = []
    ElasticController(plane.overwatch, lambda m: changes.append(tuple(m)))
    plane.add_cluster("onprem-9")                      # join
    assert changes and "onprem-9" in changes[-1]
    plane.fabric.partition_cluster("onprem-9")         # leave (lease expiry)
    plane.tick(n=8)
    assert "onprem-9" not in changes[-1]
    assert "master" in changes[-1]


def _state_bits(state) -> dict:
    return {path: t.clone() for path, t in tree_flatten_sorted(state)}


def test_trainer_continues_after_remesh_same_device():
    """A one-device re-mesh between steps 2 and 3: losses and every state tensor
    bit-equal to an uninterrupted run's."""
    tr = Trainer(TrainJobConfig(**TRAIN))
    assert isinstance(tr.plan.mesh, OneDeviceMesh) and not tr.plan.fsdp
    tr.run(2)
    new_plan = MeshPlan(mesh=make_test_mesh(device="cpu"), fsdp=False)
    before = _state_bits(tr.state)
    tr.state = remesh_state(tr.state, tr.plan, new_plan,
                            lambda p: train_state_specs(tr.arch_cfg, p))
    after = _state_bits(tr.state)
    assert sorted(before) == sorted(after)
    assert all(torch.equal(before[k], after[k]) and before[k].dtype == after[k].dtype
               for k in before)
    tr.run(2)
    ref = Trainer(TrainJobConfig(**TRAIN))
    ref.run(4)
    assert tr.step == ref.step == 4
    assert tr.metrics.series("loss") == ref.metrics.series("loss")
    got, want = _state_bits(tr.state), _state_bits(ref.state)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_trainer_refuses_a_mesh_of_several_devices():
    """Multi-rank training covers every family in both modes: a local_sgd Trainer
    on a mesh whose "pod" axis does not divide its pods (2 over 4) is refused, a
    deepseek-moe one among them."""
    class FakeMesh:
        shape = {"pod": 4, "data": 1, "model": 2}
    for job in (dict(TRAIN, mode="local_sgd"),
                dict(TRAIN, arch="deepseek-moe-16b", mode="local_sgd")):
        with pytest.raises(ValueError, match="axis must divide the pods"):
            Trainer(TrainJobConfig(**job), mesh=FakeMesh())


def test_elastic_example_on_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "torch_elastic_training", ROOT / "examples" / "torch_elastic_training.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(device="cpu", checkpoint_root=str(tmp_path))
    assert out["status"]["status"] == "done" and out["status"]["progress"] == 12.0
    assert out["status"]["cluster"] != out["killed"]
    last = out["memberships"][-1]
    assert "zone-c" in last and out["killed"] not in last and "master" in last


# ------------------------------------------------------------------- 8 CPU ranks
JAX_FORWARD = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import dataclasses
    import jax, numpy as np
    from jax.sharding import AxisType, Mesh, NamedSharding
    from repro.configs import base as configs
    from repro.models.model import Model
    from repro.models.params import partition_specs
    from repro.parallel.sharding import MeshPlan

    dtypes, B, S, out_path = pickle.loads(bytes.fromhex(sys.argv[1]))
    mesh8 = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"),
                 axis_types=(AxisType.Auto,) * 2)
    plan8 = MeshPlan(mesh=mesh8)
    result = {}
    for dtype in dtypes:
        cfg = dataclasses.replace(configs.get("qwen3-0.6b").reduced(), remat="none",
                                  dtype=dtype)
        model = Model(cfg, plan8)
        params = model.init_params(jax.random.PRNGKey(0))
        sharded = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh8, s)),
            params, partition_specs(cfg, plan8))
        toks = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size)
        logits8, _ = jax.jit(model.forward)(sharded, {"tokens": toks})
        result[dtype] = {"params": jax.tree_util.tree_map(np.asarray, params),
                         "tokens": np.asarray(toks, np.int32),
                         "logits": np.asarray(logits8, np.float32)}
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    print("FORWARD_OK")
""")


def _one_rank_phase(mesh1) -> dict:
    """``chip_smoke.py``'s elastic phase at reduced size on the CPU: 2 steps, the
    state onto the one-rank ``mesh1`` and back, 2 steps, against 4 uninterrupted
    steps; the sharded forward on ``mesh1`` against the one-device forward."""
    one = OneDeviceMesh(torch.device("cpu"))
    ref = Trainer(TrainJobConfig(**TRAIN), mesh=one)
    ref.run(4)
    tr = Trainer(TrainJobConfig(**TRAIN), mesh=one)
    tr.run(2)
    plan1 = MeshPlan(mesh=mesh1, fsdp=False)
    specs = lambda p: train_state_specs(tr.arch_cfg, p)  # noqa: E731
    on1 = remesh_state(tr.state, tr.plan, plan1, specs)
    dtensors = all(type(t).__name__ == "DTensor" for _, t in tree_flatten_sorted(on1))
    tr.state = remesh_state(on1, plan1, tr.plan, specs)
    tr.run(2)
    got, want = _state_bits(tr.state), _state_bits(ref.state)
    out = {"dtensors": dtensors,
           "losses": (tr.metrics.series("loss"), ref.metrics.series("loss")),
           "state_equal": sorted(got) == sorted(want)
           and all(torch.equal(got[k], want[k]) for k in want)}
    cfg = tr.arch_cfg
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=torch.Generator()
                           .manual_seed(5), dtype=torch.int32)
    params1 = remesh_state(tr.state["params"], tr.plan, plan1,
                           lambda p: Model(cfg, "cpu", p).param_specs())
    spec = batch_pspecs(plan1, cfg, {"tokens": TensorDef((BATCH, SEQ), torch.int32)})
    batch1 = remesh_state({"tokens": tokens}, tr.plan, plan1, lambda p: spec)
    with torch.no_grad():
        sharded = Model(cfg, "cpu", plan1).forward(params1, batch1)[0]
        plain = tr.model.forward(tr.state["params"], {"tokens": tokens})[0]
    out["forward_equal"] = (type(sharded).__name__ == "DTensor"
                            and torch.equal(sharded.full_tensor(), plain))
    return out


# the other families' sharded forward on the (4, 2) mesh, tensor-parallel: frames
# and patches ride the batch's rows; moe's experts split over "model"
FAMILY_ARCHS = ("gemma3-12b", "mamba2-2.7b", "zamba2-7b", "whisper-medium",
                "llama-3.2-vision-90b", "deepseek-moe-16b")


def _families_sharded(plan8) -> dict:
    """{arch: max |sharded - one-device| of the f32 logits} on (4, 2), and
    ``constrain`` of a replicated DTensor."""
    from repro_torch.configs.shapes import SHAPES, token_inputs
    from repro_torch.parallel.sharding import constrain, distribute
    mesh = plan8.mesh
    gen = torch.Generator().manual_seed(3)
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = dataclasses.replace(tconfigs.get(arch).reduced(), remat="none",
                                  dtype="float32")
        one, sharded = Model(cfg, "cpu"), Model(cfg, "cpu", plan8)
        params = one.init_params(0)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen,
                                         dtype=torch.int32)}
        aux = {k: v for k, v in token_inputs(cfg, SHAPES["train_4k"]).items()
               if k in ("frames", "patches")}
        for k, d in aux.items():
            batch[k] = torch.randn((BATCH,) + tuple(d.shape[1:]), generator=gen)
        specs = batch_pspecs(plan8, cfg, {k: TensorDef(tuple(v.shape), v.dtype)
                                          for k, v in batch.items()})
        dparams = remesh_state(params, one.plan, plan8, lambda p: sharded.param_specs())
        dbatch = {k: distribute(v, mesh, specs[k]) for k, v in batch.items()}
        with torch.no_grad():
            want = one.forward(params, batch)[0]
            got = sharded.forward(dparams, dbatch)[0].full_tensor()
        out[arch] = float((got - want).abs().max())
    x = distribute(torch.arange(32.0).reshape(8, 4), mesh, plan8.spec((None, None)))
    y = constrain(x, plan8, ("batch", "vocab"))
    out["constrain"] = (tuple(y.placements) == plan8.sharding(("batch", "vocab"), (8, 4))
                        and torch.equal(y.full_tensor(), torch.arange(32.0).reshape(8, 4)))
    return out


def _rank_remesh(rank, world, store, tmp, jax_out):
    """One gloo rank of the 8 -> 4 re-mesh, each dtype; rank 0 also runs
    ``_one_rank_phase`` on a mesh of itself alone."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from repro_torch.convert import to_torch
    from repro_torch.launch.mesh import chips
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.parallel.sharding import distribute
    init_gloo(rank, world, store)
    axes = ("data", "model")
    mesh8 = init_device_mesh("cpu", (4, 2), mesh_dim_names=axes)
    mesh4 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=axes)
    mesh1 = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64), mesh_dim_names=axes)
    plan8, plan4 = MeshPlan(mesh=mesh8), MeshPlan(mesh=mesh4)
    one = MeshPlan(mesh=OneDeviceMesh(torch.device("cpu")))
    from repro_torch.launch.mesh import make_production_mesh
    test_mesh = make_test_mesh(device="cpu")       # (1, world) over the default group
    report = {"chips": (chips(mesh8), chips(mesh4)),
              "test_mesh": (tuple(test_mesh.shape), test_mesh.mesh_dim_names)}
    try:
        make_production_mesh(device="cpu")
    except RuntimeError as e:
        report["production"] = str(e)
    for dtype in DTYPES:
        cfg = dataclasses.replace(tconfigs.get(ARCH).reduced(), remat="none", dtype=dtype)
        ref = jax_out[dtype]
        params = to_torch(ref["params"], "cpu")
        opt = init_opt_state(params)
        gen = torch.Generator().manual_seed(1)
        for name in ("m", "v"):       # moments of every leaf, not zeros
            opt[name] = tree_map(lambda t: torch.randn(t.shape, generator=gen), opt[name])
        opt["step"] = torch.tensor(7, dtype=torch.int32)
        state = {"params": params, "opt": opt}
        specs = lambda p: train_state_specs(cfg, p)  # noqa: E731
        state8 = remesh_state(state, one, plan8, specs)
        flat, flat8 = tree_flatten_sorted(state), tree_flatten_sorted(state8)
        rep = {"state8_equal": all(torch.equal(x.full_tensor(), y) and x.dtype == y.dtype
                                   for (_, x), (_, y) in zip(flat8, flat))}
        tokens = torch.from_numpy(ref["tokens"])
        bdef = {"tokens": TensorDef(tuple(tokens.shape), torch.int32)}
        tok8 = distribute(tokens, mesh8, batch_pspecs(plan8, cfg, bdef)["tokens"])
        with torch.no_grad():
            logits8 = Model(cfg, "cpu", plan8).forward(state8["params"], {"tokens": tok8})[0]
        vshape = (BATCH, SEQ, cfg.vocab_size)
        rep["logits8_placements"] = (tuple(logits8.placements)
                                     == plan8.sharding(("batch", "seq", "vocab"), vshape))
        full8 = logits8.full_tensor()
        moved = remesh_state(state8, plan8, plan4, specs)          # 8 -> 4 ranks
        rep["local_numel"] = [x.to_local().numel() for _, x in tree_flatten_sorted(moved)]
        tok4 = distribute(tokens, mesh4, batch_pspecs(plan4, cfg, bdef)["tokens"])
        if rank < 4:
            rep["moved_equal"] = all(
                torch.equal(x.full_tensor(), y) and x.dtype == y.dtype
                for (_, x), (_, y) in zip(tree_flatten_sorted(moved), flat))
            with torch.no_grad():
                full4 = Model(cfg, "cpu", plan4).forward(moved["params"],
                                                         {"tokens": tok4})[0].full_tensor()
            if rank == 0:
                rep["logits8"], rep["logits4"] = full8.float().numpy(), full4.float().numpy()
        report[dtype] = rep
    report["families"] = _families_sharded(plan8)
    if rank == 0:
        report["one_rank"] = _one_rank_phase(mesh1)
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def remesh_runs(tmp_path_factory):
    """(the JAX 8-device forward by dtype, each rank's report)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("remesh")
    jax_out = run_jax_subprocess(JAX_FORWARD, (DTYPES, BATCH, SEQ), tmp, "forward.pkl")
    return jax_out, spawn_ranks(_rank_remesh, (jax_out,), tmp)


def test_remesh_8_to_4_keeps_every_value_and_leaves_ranks_4_7_empty(remesh_runs):
    _, reports = remesh_runs
    for rank, rep in enumerate(reports):
        assert rep["chips"] == (8, 4)
        assert rep["test_mesh"] == ((1, 8), ("data", "model"))
        assert "needs a default process group of 256 ranks; it has 8" in rep["production"]
        for dtype in DTYPES:
            r = rep[dtype]
            assert r["state8_equal"], (rank, dtype)
            if rank < 4:
                assert r["moved_equal"] and all(n > 0 for n in r["local_numel"]), (rank, dtype)
            else:
                assert "moved_equal" not in r and set(r["local_numel"]) == {0}, (rank, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_forward_agrees_across_meshes_and_with_jax(remesh_runs, dtype):
    jax_out, reports = remesh_runs
    r = reports[0][dtype]
    assert all(rep[dtype]["logits8_placements"] for rep in reports)
    l8, l4, want = r["logits8"], r["logits4"], jax_out[dtype]["logits"]
    np.testing.assert_allclose(l8, l4, rtol=REMESH_TOL, atol=REMESH_TOL)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for got in (l8, l4):
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_sharded_forward_of_the_other_families(remesh_runs):
    """Reduced f32 dense (gemma3's local:global), ssm, hybrid, encdec, vlm and moe
    on the (4, 2) mesh, each tensor-parallel (moe's experts split over "model"),
    frames and patches sharded with the tokens: the logits within
    F32_TOL of the one-device forward on every rank; ``constrain``
    moves a replicated DTensor to its spec's placements, values kept."""
    for rank, rep in enumerate(remesh_runs[1]):
        fam = rep["families"]
        assert fam["constrain"] is True, rank
        for arch in FAMILY_ARCHS:
            assert fam[arch] <= F32_TOL, (rank, arch, fam[arch])


def test_one_rank_mesh_phase_is_bit_equal(remesh_runs):
    """chip_smoke.py's elastic phase, reduced, on a one-rank gloo mesh."""
    one = remesh_runs[1][0]["one_rank"]
    assert one["dtensors"], "the state on the one-rank DeviceMesh is not DTensors"
    losses, ref = one["losses"]
    assert len(losses) == 4 and losses == ref
    assert one["state_equal"] and one["forward_equal"]
