"""PyTorch port, tensor parallelism over "model" and data parallelism for the dense
family: the forward and the Server on 8 CPU ranks against the JAX package on 8
forced host devices.

One JAX subprocess (``XLA_FLAGS`` forces 8 host devices; an Auto-axis mesh) and one
spawn of 8 gloo ranks (``tests/test_torch_sharding.py``'s ``spawn_ranks`` and
``init_gloo``, arguments through a file) run side by side in a module fixture, on
the same params: a numpy draw from a seed, carried into both packages
(``convert.py`` for the port).

* Forward: reduced qwen3-0.6b on (1, 8), (2, 4) and (4, 2), in f32 and bf16, and
  reduced gemma3-12b (local:global windows) on (2, 4): the logits (a DTensor on
  ``plan.spec(("batch", "seq", "vocab"))``'s placements) within
  tests/test_torch_model.py's gates (f32 1e-4, bf16 0.08) of the JAX forward on
  the same mesh and of the port's one-device forward; every rank's compute shard
  of every weight its spec splits over "model" is 1/M of it and holds the values
  of its slice; the forward calls no ``full_tensor`` and no ``redistribute``.
* Serve: reduced qwen3-0.6b and gemma3-12b ``Server``s in f32 (4 slots, max_len
  256) on (2, 4) and (1, 8): greedy tokens equal to the JAX ``Server``'s on the
  same mesh and to the port's one-device ``Server``'s; each rank's cache shard is
  its ``cache_specs`` slice; on (2, 4) ranks hold cache slices with no live
  position, and a qwen3 prompt crosses a slice boundary; gemma3's ring wraps.
* The collectives without ranks: the identity, on one device.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.params import param_defs  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from test_torch_model import BF16_TOL, F32_TOL  # noqa: E402
from test_torch_sharding import init_gloo, spawn_ranks  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1x8": (1, 8), "2x4": (2, 4), "4x2": (4, 2)}
DTYPES = ("float32", "bfloat16")
FORWARD_CASES = ([("qwen3-0.6b", m, dt) for m in MESHES for dt in DTYPES]
                 + [("gemma3-12b", "2x4", dt) for dt in DTYPES])
SERVE_CASES = [(a, m) for a in ("qwen3-0.6b", "gemma3-12b") for m in ("2x4", "1x8")]
BATCH, SEQ = 4, 16
SLOTS, MAX_LEN = 4, 256
# (prompt, max_new): qwen3's 70-token prompt crosses the (2, 4) cache's 64-position
# slices; gemma3's 64-token one (a whole window) wraps its 64-slot ring. Two prompt
# lengths an arch: the JAX Server compiles a prefill for each
PROMPTS = {
    "qwen3-0.6b": [([1, 2, 3, 4], 8), ([9, 8, 7, 6], 6), ([(7 * i) % 500 for i in range(70)], 8),
                   ([5, 5, 2, 4], 5), ([2, 4, 6, 8], 7)],
    "gemma3-12b": [([(3 * i) % 500 for i in range(64)], 8), ([9, 8, 7], 6), ([5, 5, 1], 5),
                   ([2, 4, 6], 7)],
}
TIMEOUT_S = 420


def cfg_of(arch: str, dtype: str):
    return dataclasses.replace(tconfigs.get(arch).reduced(), remat="none", dtype=dtype)


def np_params(cfg, seed: int) -> dict:
    """A parameter tree of numpy arrays by ``models.params``' init rules (normal
    leaves at 1/sqrt(fan_in), norms at 1), in the config's dtype."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        if d.init in ("ones", "zeros"):
            x = np.full(d.shape, 1.0 if d.init == "ones" else 0.0, np.float32)
        else:
            fan_in = int(np.prod([n for n, log in zip(d.shape[:-1], d.logical[:-1])
                                  if log != "layers"])) if len(d.shape) >= 2 else d.shape[0]
            x = rng.standard_normal(d.shape, dtype=np.float32) * (d.scale / max(fan_in, 1) ** .5)
        if cfg.dtype == "bfloat16":
            import ml_dtypes
            return x.astype(ml_dtypes.bfloat16)
        return x
    return tree_map(leaf, param_defs(cfg))


def start_jax(script: str, args: dict, tmp: Path, name: str):
    """Start ``script`` in a JAX process of 8 forced host devices, its arguments in
    a file; returns (the process, the path of the pickle it writes)."""
    (tmp / f"{name}.py").write_text(script)
    with open(tmp / f"{name}_args.pkl", "wb") as f:
        pickle.dump(args, f)
    out = tmp / f"{name}_out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, str(tmp / f"{name}.py"),
                             str(tmp / f"{name}_args.pkl"), str(out)], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out


def finish_jax(proc, out: Path):
    try:
        _, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and out.exists(), err[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


JAX_PRELUDE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh, NamedSharding
from repro.configs import base as configs
from repro.parallel.sharding import MeshPlan

args_path, out_path = sys.argv[1:3]
with open(args_path, "rb") as f:
    args = pickle.load(f)
_get = configs.get
tmap = jax.tree_util.tree_map


def cfg_of(arch, dtype):
    return dataclasses.replace(_get(arch).reduced(), remat="none", dtype=dtype)


def mesh_of(name):
    shape = args["meshes"][name]
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def in_dtype(dtype):
    # the JAX Trainer's and Server's configs: reduced, in ``dtype``
    configs.get = lambda name: dataclasses.replace(_get(name), dtype=dtype)
"""

JAX_FORWARD_SERVE = JAX_PRELUDE + """
from repro.models.model import Model
from repro.models.params import partition_specs
from repro.runtime.serve_loop import Server, ServeJobConfig
out = {"forward": {}, "serve": {}}
toks = jnp.asarray(args["tokens"])
for arch, mesh_name, dtype in args["forward_cases"]:
    cfg = cfg_of(arch, dtype)
    mesh = mesh_of(mesh_name)
    plan = MeshPlan(mesh=mesh, fsdp=False)
    params = tmap(lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
                  args["params"][(arch, dtype)], partition_specs(cfg, plan))
    logits, _ = jax.jit(Model(cfg, plan).forward)(params, {"tokens": toks})
    out["forward"][(arch, mesh_name, dtype)] = np.asarray(logits, np.float32)
in_dtype("float32")
for arch, mesh_name in args["serve_cases"]:
    sv = Server(ServeJobConfig(arch=arch, slots=args["slots"], max_len=args["max_len"]),
                params=tmap(jnp.asarray, args["params"][(arch, "float32")]),
                mesh=mesh_of(mesh_name))
    ids = [sv.submit(p, max_new=n) for p, n in args["prompts"][arch]]
    sv.run()
    out["serve"][(arch, mesh_name)] = [sv.requests[i].generated for i in ids]
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def _counting(cls, name: str, counts: dict):
    fn = getattr(cls, name)

    def counted(self, *a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(self, *a, **kw)
    return fn, counted


def _rank_tp(rank, world, store, tmp, args):
    """One gloo rank: the forward cases, the shards, then the Servers."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as cfgs
    from repro_torch.convert import to_torch
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import (MeshPlan, OneDeviceMesh, distribute, full_value,
                                               local_range, placements)
    from repro_torch.runtime.serve_loop import Server, ServeJobConfig
    from repro_torch.tree import tree_flatten_sorted
    init_gloo(rank, world, store)
    meshes = {n: init_device_mesh("cpu", s, mesh_dim_names=("data", "model"))
              for n, s in MESHES.items()}
    one = OneDeviceMesh(torch.device("cpu"))
    tokens = torch.from_numpy(args["tokens"])
    report = {"forward": {}, "shards": {}, "serve": {}, "cache": {}, "live": {}}
    for case in FORWARD_CASES:
        arch, mesh_name, dtype = case
        cfg = cfg_of(arch, dtype)
        params = to_torch(args["params"][(arch, dtype)], "cpu")
        plan = MeshPlan(mesh=meshes[mesh_name], fsdp=False)
        model = Model(cfg, "cpu", plan)
        dparams = tree_map(lambda x, s: distribute(x, plan.mesh, s), params, model.param_specs())
        counts = {}
        saved = [(name, *_counting(DTensor, name, counts))
                 for name in ("full_tensor", "redistribute")]
        for name, _, counted in saved:
            setattr(DTensor, name, counted)
        try:
            with torch.no_grad():
                logits = model.forward(dparams, {"tokens": tokens})[0]
        finally:
            for name, fn, _ in saved:
                setattr(DTensor, name, fn)
        want_pl = plan.sharding(("batch", "seq", "vocab"), tuple(logits.shape))
        full = logits.full_tensor()
        rep = {"calls": counts, "placements": tuple(logits.placements) == want_pl}
        if rank == 0:
            with torch.no_grad():
                plain = Model(cfg, "cpu").forward(params, {"tokens": tokens})[0]
            rep["logits"], rep["plain"] = full.float().numpy(), plain.float().numpy()
        report["forward"][case] = rep
        local = dict(tree_flatten_sorted(model.shard_params(dparams)))
        specs = dict(tree_flatten_sorted(model.param_specs()))
        shards = {}
        for path, x in tree_flatten_sorted(params):
            spec, t = specs[path], local[path]
            split = [d for d, e in enumerate(spec) if e == "model"]
            sl = [slice(None)] * x.dim()
            for d in split:
                lo, hi = local_range(plan, spec, d, x.shape[d])
                sl[d] = slice(lo, hi)
            shards[path] = (split, t.numel(), x.numel(), torch.equal(t, x[tuple(sl)]))
        report["shards"][case] = shards
    real_get = cfgs.get
    cfgs.get = lambda name: dataclasses.replace(real_get(name), dtype="float32")
    try:
        for arch, mesh_name in SERVE_CASES:
            params = to_torch(args["params"][(arch, "float32")], "cpu")
            scfg = ServeJobConfig(arch=arch, slots=SLOTS, max_len=MAX_LEN, device="cpu")
            runs = [(mesh_name, meshes[mesh_name])] + ([("one", one)] if rank == 0 else [])
            servers = {}
            for name, mesh in runs:
                servers[name] = Server(scfg, params=params, mesh=mesh)
                ids = [servers[name].submit(p, max_new=n) for p, n in PROMPTS[arch]]
                servers[name].run()
                report["serve"][(arch, mesh_name, name)] = [
                    servers[name].requests[i].generated for i in ids]
            sv = servers[mesh_name]
            # each cache leaf's local shard against its cache_specs slice of the whole
            specs = dict(tree_flatten_sorted(sv.model.cache_specs(SLOTS, MAX_LEN)))
            plan = sv.model.plan
            bad = []
            for path, t in tree_flatten_sorted(sv.cache):
                spec, whole = specs[path], full_value(t)
                sl = tuple(slice(*local_range(plan, spec, d, n)) for d, n in enumerate(t.shape))
                if not (isinstance(t, DTensor) and torch.equal(t.to_local(), whole[sl])
                        and tuple(t.placements) == placements(plan.mesh, spec)):
                    bad.append(path)
            report["cache"][(arch, mesh_name)] = (bad, tuple(specs[("layers", 0, "k")]))
            # the positions of this rank's slice of the first layer's cache, and the
            # highest position any slot has written
            k = sv.cache["layers"][0]["k"]
            lo, hi = local_range(plan, specs[("layers", 0, "k")], 2, k.shape[2])
            report["live"][(arch, mesh_name)] = (lo, hi, int(full_value(sv.cache["pos"]).max()) - 1)
    finally:
        cfgs.get = real_get
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """(the JAX forward logits and Server tokens, each rank's report)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("tp")
    params = {(arch, dt): np_params(cfg_of(arch, dt), 0)
              for arch in ("qwen3-0.6b", "gemma3-12b") for dt in DTYPES}
    tokens = np.random.default_rng(1).integers(0, 512, (BATCH, SEQ)).astype(np.int32)
    args = {"params": params, "tokens": tokens, "meshes": MESHES, "slots": SLOTS,
            "max_len": MAX_LEN, "forward_cases": FORWARD_CASES, "serve_cases": SERVE_CASES,
            "prompts": PROMPTS}
    proc, out = start_jax(JAX_FORWARD_SERVE, args, tmp, "jax_tp")
    try:
        reports = spawn_ranks(_rank_tp, (args,), tmp)
    finally:
        jax_out = finish_jax(proc, out)
    return jax_out, reports


@pytest.mark.parametrize("case", FORWARD_CASES, ids=["-".join(c) for c in FORWARD_CASES])
def test_forward_matches_jax_and_one_device(tp_runs, case):
    jax_out, reports = tp_runs
    rep = reports[0]["forward"][case]
    tol = F32_TOL if case[2] == "float32" else BF16_TOL
    want = jax_out["forward"][case]
    assert rep["logits"].shape == want.shape == (BATCH, SEQ, 512)
    assert np.isfinite(rep["logits"]).all()
    np.testing.assert_allclose(rep["logits"], want, rtol=tol, atol=tol)
    np.testing.assert_allclose(rep["logits"], rep["plain"], rtol=tol, atol=tol)
    for rank, r in enumerate(reports):
        assert r["forward"][case]["placements"], rank
        assert r["forward"][case]["calls"] == {}, (rank, r["forward"][case]["calls"])


@pytest.mark.parametrize("case", FORWARD_CASES, ids=["-".join(c) for c in FORWARD_CASES])
def test_no_rank_holds_a_whole_split_weight(tp_runs, case):
    """Each rank's compute shard of a weight split over "model" is 1/M of it, the
    values of its slice; (1, 8) splits ffn and vocab only (reduced H = 4, K = 2),
    (2, 4) the q heads too, (4, 2) the kv heads as well."""
    M = MESHES[case[1]][1]
    split_leaves = set()
    for rank, r in enumerate(tp_runs[1]):
        for path, (split, n, whole, equal) in r["shards"][case].items():
            assert equal, (rank, path)
            if split:
                split_leaves.add(path)
                assert n * M == whole, (rank, path, n, whole)
    heads = ("layers", "attn", "wq") in split_leaves
    kv = ("layers", "attn", "wk") in split_leaves
    assert {("embed",), ("layers", "mlp", "w_down")} <= split_leaves
    assert (heads, kv) == {"1x8": (False, False), "2x4": (True, False),
                           "4x2": (True, True)}[case[1]]


@pytest.mark.parametrize("arch,mesh", SERVE_CASES, ids=[f"{a}-{m}" for a, m in SERVE_CASES])
def test_server_tokens_match_jax_and_one_device(tp_runs, arch, mesh):
    jax_out, reports = tp_runs
    want = jax_out["serve"][(arch, mesh)]
    assert [len(g) for g in want] == [n for _, n in PROMPTS[arch]]
    assert reports[0]["serve"][(arch, mesh, "one")] == want
    for rank, r in enumerate(reports):
        assert r["serve"][(arch, mesh, mesh)] == want, rank


@pytest.mark.parametrize("arch,mesh", SERVE_CASES, ids=[f"{a}-{m}" for a, m in SERVE_CASES])
def test_cache_shards_are_their_cache_specs_slices(tp_runs, arch, mesh):
    """The cache splits its slots over "data" and its sequence (the ring's slots)
    over "model"; each rank holds exactly its slice."""
    for rank, r in enumerate(tp_runs[1]):
        bad, spec = r["cache"][(arch, mesh)]
        assert bad == [], (rank, bad[:5])
        assert spec == (None, "data", "model")


def test_ranks_with_no_live_position_add_nothing(tp_runs):
    """On (2, 4) the 256-position cache is split into slices of 64: qwen3's
    70-token prompt lives on two of them, the others on the first only, so ranks
    whose slice held no live position took part in every decode step (the
    tokens above are the JAX Server's)."""
    live = {r: rep["live"][("qwen3-0.6b", "2x4")] for r, rep in enumerate(tp_runs[1])}
    empty = [r for r, (lo, hi, top) in live.items() if lo > top]
    crossed = [r for r, (lo, hi, top) in live.items() if lo > 0 and lo <= top]
    assert empty and crossed, live
    assert {hi - lo for lo, hi, _ in live.values()} == {MAX_LEN // 4}


def test_collectives_are_the_identity_on_one_device():
    """Off a DeviceMesh every collective returns its input, launching nothing,
    and a model there has no tensor-parallel split."""
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import (MeshPlan, OneDeviceMesh, P, copy_to,
                                               gather_along, local_range, max_over,
                                               reduce_from, reduce_partial, sum_over)
    plan = MeshPlan(mesh=OneDeviceMesh(torch.device("cpu")))
    x = torch.randn(3, 4)
    for out in (copy_to(x, plan), reduce_from(x, plan), reduce_partial(x, plan),
                gather_along(x, 1, plan), max_over(x, plan), sum_over(x, plan, ("data",))):
        assert out is x
    assert local_range(plan, P(None, "model"), 1, 8) == (0, 8)
    assert Model(cfg_of("qwen3-0.6b", "float32"), "cpu").tp is None
