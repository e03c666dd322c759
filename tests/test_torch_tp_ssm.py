"""PyTorch port, tensor parallelism over "model" and data parallelism for the ssm
and hybrid families: the forward and the Server on 8 CPU ranks against the JAX
package on 8 forced host devices.

One JAX subprocess (``XLA_FLAGS`` forces 8 host devices; an Auto-axis mesh) and one
spawn of 8 gloo ranks run side by side in a module fixture, on the same params: a
numpy draw from a seed (``tests/test_torch_tp.py``'s helpers; a_log and dt_bias
by their init rules).

* Forward: reduced mamba2-2.7b (d_inner 256, 8 heads) and zamba2-7b (the same
  mamba2 layers, two groups of 3 and the shared attention + MLP block; in bf16 one
  group and a tail layer, as tests/test_torch_hybrid.py cuts it) on (1, 8), (2, 4)
  and (4, 2), in f32 and bf16: the logits within tests/test_torch_model.py's gates
  (f32 1e-4, bf16 0.08) of the JAX forward on the same mesh and of the port's
  one-device forward; each rank's compute shard of every weight its spec splits
  over "model" is 1/M of it and holds the values of its slice (w_x, conv_x,
  gate_norm, out_proj, a_log among them); the forward calls no ``full_tensor``
  and no ``redistribute``.
* Serve: the two archs' ``Server``s in f32 (4 slots, max_len 128) on (2, 4) and
  (1, 8): greedy tokens equal to the JAX ``Server``'s on the same mesh and to the
  port's one-device ``Server``'s; each rank's cache shard is its ``cache_specs``
  slice, the conv tails (split over the channels [xs | B | C]) and the SSD states
  (split by heads) included.
"""
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_model import BF16_TOL, F32_TOL  # noqa: E402
from test_torch_sharding import init_gloo, spawn_ranks  # noqa: E402
from test_torch_tp import JAX_PRELUDE, MESHES, _counting, finish_jax  # noqa: E402
from test_torch_tp import cfg_of as _cfg_of  # noqa: E402
from test_torch_tp import np_params as _np_params  # noqa: E402
from test_torch_tp import start_jax  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

ARCHS = ("mamba2-2.7b", "zamba2-7b")
DTYPES = ("float32", "bfloat16")
FORWARD_CASES = [(a, m, dt) for a in ARCHS for m in MESHES for dt in DTYPES]
SERVE_CASES = [(a, m) for a in ARCHS for m in ("2x4", "1x8")]
BATCH, SEQ = 4, 40      # two of the reduced configs' 32-token SSD chunks, the last ragged
SLOTS, MAX_LEN = 4, 128
# two prompt lengths (the JAX Server compiles a prefill for each); zamba2's shared
# block's 128-position cache is split into slices of 32 on (2, 4), which the
# 40-token prompt crosses
PROMPTS = [([(5 * i) % 500 for i in range(40)], 8), ([9, 8, 7, 6], 6), ([1, 2, 3, 4], 7),
           ([5, 5, 2, 4], 5)]
# zamba2's bf16 cases at 4 layers (one group of 3 and a tail layer), as
# tests/test_torch_hybrid.py runs them: the two packages' bf16 logits drift apart
# with depth, past the 0.08 gate at 6 layers on one device as on a mesh
CUT = {("zamba2-7b", "bfloat16"): 4}
# the leaves of a mamba2 layer that tensor parallelism splits
SPLIT_SSM = ("w_z", "w_x", "w_dt", "conv_x", "a_log", "dt_bias", "d_skip", "gate_norm",
             "out_proj")


def cfg_of(arch: str, dtype: str):
    cfg = _cfg_of(arch, dtype)
    layers = CUT.get((arch, dtype))
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def np_params(cfg, seed: int) -> dict:
    """``tests/test_torch_tp.py``'s numpy params, with a_log and dt_bias drawn by
    their own init rules (``models.params``: A in [-1, -0.5], dt in [1e-3, 1e-1]
    through softplus^-1), as both packages' ``init_params`` draw them."""
    params = _np_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    for name, (lo, hi) in (("a_log", (0.5, 1.0)), ("dt_bias", (1e-3, 1e-1))):
        leaf = params["layers"]["ssm"][name]
        u = rng.uniform(lo, hi, leaf.shape).astype(np.float32)
        x = np.log(u) if name == "a_log" else u + np.log(-np.expm1(-u))
        params["layers"]["ssm"][name] = x.astype(leaf.dtype)
    return params


# two JAX processes side by side (compiling is the most of each, on one core)
JAX_FORWARD = JAX_PRELUDE + """
from repro.models.model import Model
from repro.models.params import partition_specs
out = {}
toks = jnp.asarray(args["tokens"])
for arch, mesh_name, dtype in args["forward_cases"]:
    cfg = cfg_of(arch, dtype)
    if (arch, dtype) in args["cut"]:
        cfg = dataclasses.replace(cfg, num_layers=args["cut"][(arch, dtype)])
    mesh = mesh_of(mesh_name)
    plan = MeshPlan(mesh=mesh, fsdp=False)
    params = tmap(lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
                  args["params"][(arch, dtype)], partition_specs(cfg, plan))
    logits, _ = jax.jit(Model(cfg, plan).forward)(params, {"tokens": toks})
    out[(arch, mesh_name, dtype)] = np.asarray(logits, np.float32)
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""

JAX_SERVE = JAX_PRELUDE + """
from repro.runtime.serve_loop import Server, ServeJobConfig
out = {}
in_dtype("float32")
for arch, mesh_name in args["serve_cases"]:
    sv = Server(ServeJobConfig(arch=arch, slots=args["slots"], max_len=args["max_len"]),
                params=tmap(jnp.asarray, args["params"][(arch, "float32")]),
                mesh=mesh_of(mesh_name))
    ids = [sv.submit(p, max_new=n) for p, n in args["prompts"]]
    sv.run()
    out[(arch, mesh_name)] = [sv.requests[i].generated for i in ids]
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def _rank_tp_ssm(rank, world, store, tmp, args):
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
    from repro_torch.tree import tree_flatten_sorted, tree_map
    init_gloo(rank, world, store)
    meshes = {n: init_device_mesh("cpu", s, mesh_dim_names=("data", "model"))
              for n, s in MESHES.items()}
    one = OneDeviceMesh(torch.device("cpu"))
    tokens = torch.from_numpy(args["tokens"])
    report = {"forward": {}, "shards": {}, "serve": {}, "cache": {}}
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
        rep = {"calls": counts, "placements": tuple(logits.placements) == want_pl,
               "ssm_split": model.tp is not None and model.tp.ssm}
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
                sl[d] = slice(*local_range(plan, spec, d, x.shape[d]))
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
                ids = [servers[name].submit(p, max_new=n) for p, n in PROMPTS]
                servers[name].run()
                report["serve"][(arch, mesh_name, name)] = [
                    servers[name].requests[i].generated for i in ids]
            sv = servers[mesh_name]
            specs = dict(tree_flatten_sorted(sv.model.cache_specs(SLOTS, MAX_LEN)))
            plan = sv.model.plan
            bad, held = [], {}
            for path, t in tree_flatten_sorted(sv.cache):
                spec, whole = specs[path], full_value(t)
                sl = tuple(slice(*local_range(plan, spec, d, n)) for d, n in enumerate(t.shape))
                if not (isinstance(t, DTensor) and torch.equal(t.to_local(), whole[sl])
                        and tuple(t.placements) == placements(plan.mesh, spec)):
                    bad.append(path)
                if path[-1] in ("conv", "ssd") and whole.numel():
                    held[path] = (tuple(spec), tuple(t.to_local().shape), tuple(whole.shape),
                                  bool(t.to_local().abs().sum() > 0))
            report["cache"][(arch, mesh_name)] = (bad, held)
    finally:
        cfgs.get = real_get
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_ssm_runs(tmp_path_factory):
    """(the JAX forward logits and Server tokens, each rank's report)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("tp_ssm")
    params = {(arch, dt): np_params(cfg_of(arch, dt), 0) for arch in ARCHS for dt in DTYPES}
    tokens = np.random.default_rng(1).integers(0, 512, (BATCH, SEQ)).astype(np.int32)
    args = {"params": params, "tokens": tokens, "meshes": MESHES, "slots": SLOTS,
            "max_len": MAX_LEN, "forward_cases": FORWARD_CASES, "serve_cases": SERVE_CASES,
            "prompts": PROMPTS, "cut": CUT}
    procs = {n: start_jax(script, args, tmp, f"jax_tp_ssm_{n}")
             for n, script in (("forward", JAX_FORWARD), ("serve", JAX_SERVE))}
    try:
        reports = spawn_ranks(_rank_tp_ssm, (args,), tmp)
    finally:
        jax_out = {n: finish_jax(*p) for n, p in procs.items()}
    return jax_out, reports


@pytest.mark.parametrize("case", FORWARD_CASES, ids=["-".join(c) for c in FORWARD_CASES])
def test_forward_matches_jax_and_one_device(tp_ssm_runs, case):
    jax_out, reports = tp_ssm_runs
    rep = reports[0]["forward"][case]
    tol = F32_TOL if case[2] == "float32" else BF16_TOL
    want = jax_out["forward"][case]
    assert rep["logits"].shape == want.shape == (BATCH, SEQ, 512)
    assert np.isfinite(rep["logits"]).all()
    np.testing.assert_allclose(rep["logits"], want, rtol=tol, atol=tol)
    np.testing.assert_allclose(rep["logits"], rep["plain"], rtol=tol, atol=tol)
    for rank, r in enumerate(reports):
        assert r["forward"][case]["placements"] and r["forward"][case]["ssm_split"], rank
        assert r["forward"][case]["calls"] == {}, (rank, r["forward"][case]["calls"])


@pytest.mark.parametrize("case", FORWARD_CASES, ids=["-".join(c) for c in FORWARD_CASES])
def test_no_rank_holds_a_whole_split_weight(tp_ssm_runs, case):
    """Each rank's compute shard of a weight split over "model" is 1/M of it, the
    values of its slice: every mamba2 leaf over d_inner or the heads (8 heads
    split 8, 4 and 2 ways), the vocab; zamba2's shared block's MLP on every
    mesh, its 4 q heads on (2, 4) and (4, 2), its 2 kv heads on (4, 2)."""
    M = MESHES[case[1]][1]
    split_leaves = set()
    for rank, r in enumerate(tp_ssm_runs[1]):
        for path, (split, n, whole, equal) in r["shards"][case].items():
            assert equal, (rank, path)
            if split:
                split_leaves.add(path)
                assert n * M == whole, (rank, path, n, whole)
    assert {("layers", "ssm", k) for k in SPLIT_SSM} | {("embed",)} <= split_leaves
    assert not {("layers", "ssm", k) for k in ("w_b", "w_c", "conv_b", "conv_c")} & split_leaves
    if case[0] == "zamba2-7b":
        heads = ("shared_block", "attn", "wq") in split_leaves
        kv = ("shared_block", "attn", "wk") in split_leaves
        assert ("shared_block", "mlp", "w_down") in split_leaves
        assert (heads, kv) == {"1x8": (False, False), "2x4": (True, False),
                               "4x2": (True, True)}[case[1]]


@pytest.mark.parametrize("arch,mesh", SERVE_CASES, ids=[f"{a}-{m}" for a, m in SERVE_CASES])
def test_server_tokens_match_jax_and_one_device(tp_ssm_runs, arch, mesh):
    jax_out, reports = tp_ssm_runs
    want = jax_out["serve"][(arch, mesh)]
    assert [len(g) for g in want] == [n for _, n in PROMPTS]
    assert reports[0]["serve"][(arch, mesh, "one")] == want
    for rank, r in enumerate(reports):
        assert r["serve"][(arch, mesh, mesh)] == want, rank


@pytest.mark.parametrize("arch,mesh", SERVE_CASES, ids=[f"{a}-{m}" for a, m in SERVE_CASES])
def test_cache_shards_are_their_cache_specs_slices(tp_ssm_runs, arch, mesh):
    """Every cache leaf's local shard is its ``cache_specs`` slice: the slots over
    "data", the conv tail's 288 channels [xs | B | C] over "model" in contiguous
    slices (on (2, 4) rank 0's 72 are xs only, rank 3's hold B and C), the SSD
    state's 8 heads over "model", and they hold the served state."""
    M = MESHES[mesh][1]

    def entry(spec, d):
        return spec[d] if d < len(spec) else None

    for rank, r in enumerate(tp_ssm_runs[1]):
        bad, held = r["cache"][(arch, mesh)]
        assert bad == [], (rank, bad[:5])
        assert held, rank
        for path, (spec, local, whole, nonzero) in held.items():
            n = len(whole)
            if path[-1] == "conv":       # [.., B, W-1, DI + 2N]
                assert entry(spec, n - 1) == "model" and local[-1] * M == whole[-1] == 288
                batch = n - 3
            else:                        # [.., B, H, N, P]
                assert entry(spec, n - 3) == "model" and local[-3] * M == whole[-3] == 8
                batch = n - 4
            assert entry(spec, batch) == "data", (rank, path)
            assert nonzero, (rank, path)
