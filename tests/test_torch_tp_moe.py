"""PyTorch port, expert and data parallelism for the moe family: the forward,
prefill, decode and the Server on 8 CPU ranks against the JAX package on 8 forced
host devices.

One JAX subprocess (``XLA_FLAGS`` forces 8 host devices; an Auto-axis mesh; a
case's forward, prefill and decode steps one program, the cases' compiled on four
threads) and one spawn of 8 gloo ranks run side by side in a module fixture, on
the same params: a numpy draw from a seed (``tests/test_torch_tp.py``'s
helpers).

* Forward, prefill and decode: reduced deepseek-moe-16b (shared experts) and
  qwen3-moe-235b-a22b (qk-norm), 8 experts, top-2, capacity 1.25 (the forward
  drops assignments), on (1, 8), (2, 4) and (4, 2), in f32 and bf16; and in f32
  on (2, 4) with 6 experts, which "model" does not divide (every rank holds and
  computes them all), and with ``moe_combine_reshard`` (the slot buffer gathered
  before the combine). The logits of the forward, of a prefill of the first
  ``PREFILL`` tokens and of teacher-forced decode steps of the rest, and the
  forward's load-balance loss (global on every rank), within
  tests/test_torch_model.py's gates (f32 1e-4, bf16 0.08) of the JAX package on
  the same mesh and of the port's one-device path. Each rank's compute shard of
  every weight is its ``compute_specs`` slice: 1/M of the experts (their three
  weights and the router's columns) where "model" divides them; the calls run
  no ``full_tensor`` and no ``redistribute``.
* Serve: the two archs' ``Server``s in f32 (4 slots) on (2, 4): greedy tokens
  equal to the JAX ``Server``'s on the same mesh and to the port's one-device
  ``Server``'s.
"""
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_model import BF16_TOL, F32_TOL  # noqa: E402
from test_torch_moe import _drops  # noqa: E402
from test_torch_sharding import init_gloo, spawn_ranks  # noqa: E402
from test_torch_tp import JAX_PRELUDE, MESHES, _counting, finish_jax, np_params  # noqa: E402
from test_torch_tp import cfg_of as _cfg_of  # noqa: E402
from test_torch_tp import start_jax  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

ARCHS = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")
DTYPES = ("float32", "bfloat16")
# a case's variant: "" the reduced config; "e6" 6 experts, which no "model" axis of
# more than 2 ranks divides; "reshard" the plan's moe_combine_reshard
VARIANTS = {"": {}, "e6": {"num_experts": 6}, "reshard": {}}
# (arch, mesh, dtype, variant)
FORWARD_CASES = ([(a, m, dt, "") for a in ARCHS for m in MESHES for dt in DTYPES]
                 + [(a, "2x4", "float32", v) for a in ARCHS for v in ("e6", "reshard")])
SERVE_CASES = [(a, "2x4") for a in ARCHS]
BATCH, SEQ, PREFILL, MAX_LEN = 4, 12, 8, 16     # 3 teacher-forced decode steps
SLOTS, SERVE_LEN = 4, 64
# two prompt lengths (the JAX Server compiles a prefill for each); the 20-token one
# crosses the (2, 4) cache's 16-position slices
PROMPTS = [([(5 * i) % 500 for i in range(20)], 6), ([9, 8, 7, 6], 5), ([1, 2, 3, 4], 7),
           ([5, 5, 2, 4], 4)]
EXPERT_LEAVES = ("router", "we_gate", "we_up", "we_down")


def cfg_of(arch: str, dtype: str, variant: str = ""):
    return dataclasses.replace(_cfg_of(arch, dtype), **VARIANTS[variant])


def case_inputs(case) -> dict:
    arch, _, dtype, variant = case
    return {"params": np_params(cfg_of(arch, dtype, variant), 0)}


JAX_MOE = JAX_PRELUDE + """
from concurrent.futures import ThreadPoolExecutor
from repro.models.model import Model
from repro.models.params import partition_specs
from repro.runtime.serve_loop import Server, ServeJobConfig
out = {"forward": {}, "serve": {}}
toks = jnp.asarray(args["tokens"])
P = args["prefill"]


def program(case):
    # the forward, the prefill and the teacher-forced decode steps (a scan): one
    # program a case, with its params laid out on the case's mesh
    arch, mesh_name, dtype, variant = case
    cfg = dataclasses.replace(cfg_of(arch, dtype), **args["variants"][variant])
    mesh = mesh_of(mesh_name)
    plan = MeshPlan(mesh=mesh, fsdp=False, moe_combine_reshard=variant == "reshard")
    params = tmap(lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
                  args["inputs"][case]["params"], partition_specs(cfg, plan))
    model = Model(cfg, plan)

    def run(params, toks):
        logits, aux = model.forward(params, {"tokens": toks})
        last, cache = model.prefill(params, {"tokens": toks[:, :P]}, max_len=args["max_len"])

        def step(cache, tok):
            logits, cache = model.decode_step(params, tok[:, None], cache)
            return cache, logits
        _, steps = jax.lax.scan(step, cache, toks[:, P:-1].T)
        return logits, last, steps, aux
    return jax.jit(run), params


# the programs built in turn, compiled on 4 threads (XLA's compiler releases the GIL)
programs = [program(case) for case in args["forward_cases"]]
with ThreadPoolExecutor(4) as pool:
    compiled = list(pool.map(lambda fp: fp[0].lower(fp[1], toks).compile(), programs))
for case, fn, (_, params) in zip(args["forward_cases"], compiled, programs):
    out["forward"][case] = tuple(np.asarray(t, np.float32) for t in fn(params, toks))
in_dtype("float32")
for arch, mesh_name in args["serve_cases"]:
    sv = Server(ServeJobConfig(arch=arch, slots=args["slots"], max_len=args["serve_len"]),
                params=tmap(jnp.asarray, args["inputs"][(arch, mesh_name, "float32", "")]["params"]),
                mesh=mesh_of(mesh_name))
    ids = [sv.submit(p, max_new=n) for p, n in args["prompts"]]
    sv.run()
    out["serve"][(arch, mesh_name)] = [sv.requests[i].generated for i in ids]
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def _run_case(model, params, tokens):
    """(forward logits, prefill's last logits, [steps, B, V] teacher-forced decode
    logits, the forward's aux), each whole."""
    from repro_torch.parallel.sharding import full_value
    with torch.no_grad():
        logits, aux = model.forward(params, {"tokens": tokens})
        logits, aux = full_value(logits), full_value(aux)
        last, cache = model.prefill(params, {"tokens": tokens[:, :PREFILL]}, max_len=MAX_LEN)
        steps = []
        for i in range(PREFILL, tokens.shape[1] - 1):
            step, cache = model.decode_step(params, tokens[:, i:i + 1], cache)
            steps.append(full_value(step))
    return logits, full_value(last), torch.stack(steps), aux


def _routed_drops(model, params, tokens) -> int:
    """The assignments past capacity in the one-device forward's routers."""
    from repro_torch.models import moe as MOE
    real, seen = MOE.router_probs, []

    def logged(*a):
        out = real(*a)
        seen.append(out[1])
        return out
    MOE.router_probs = logged
    try:
        with torch.no_grad():
            model.forward(params, {"tokens": tokens})
    finally:
        MOE.router_probs = real
    cfg = model.cfg
    C = MOE.capacity(cfg, tokens.shape[1])
    return sum(_drops(idx.numpy(), cfg.num_experts, C) for idx in seen)


def _rank_tp_moe(rank, world, store, tmp, args):
    """One gloo rank: the forward / prefill / decode cases and the shards, then
    the Servers."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as cfgs
    from repro_torch.convert import to_torch
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import MeshPlan, OneDeviceMesh, distribute, local_range
    from repro_torch.runtime.serve_loop import Server, ServeJobConfig
    from repro_torch.tree import tree_flatten_sorted, tree_map
    init_gloo(rank, world, store)
    meshes = {n: init_device_mesh("cpu", s, mesh_dim_names=("data", "model"))
              for n, s in MESHES.items()}
    one = OneDeviceMesh(torch.device("cpu"))
    tokens = torch.from_numpy(args["tokens"])
    report = {"forward": {}, "shards": {}, "serve": {}}
    for case in FORWARD_CASES:
        arch, mesh_name, dtype, variant = case
        cfg = cfg_of(arch, dtype, variant)
        params = to_torch(args["inputs"][case]["params"], "cpu")
        plan = MeshPlan(mesh=meshes[mesh_name], fsdp=False,
                        moe_combine_reshard=variant == "reshard")
        model = Model(cfg, "cpu", plan)
        dparams = tree_map(lambda x, s: distribute(x, plan.mesh, s), params, model.param_specs())
        counts = {}
        saved = [(name, *_counting(DTensor, name, counts))
                 for name in ("full_tensor", "redistribute")]
        for name, _, counted in saved:
            setattr(DTensor, name, counted)
        try:
            got = _run_case(model, dparams, tokens)
        finally:
            for name, fn, _ in saved:
                setattr(DTensor, name, fn)
        tp = model.tp
        rep = {"calls": counts, "aux": float(got[3]),
               "tp": (tp.heads, tp.kv_heads, tp.ffn, tp.vocab, tp.experts)}
        if rank == 0:
            plain = Model(cfg, "cpu")
            want = _run_case(plain, params, tokens)
            rep["got"] = [t.float().numpy() for t in got[:3]]
            rep["plain"] = [t.float().numpy() for t in want[:3]]
            rep["plain_aux"] = float(want[3])
            rep["drops"] = _routed_drops(plain, params, tokens)
        report["forward"][case] = rep
        local = dict(tree_flatten_sorted(model.shard_params(dparams)))
        specs = dict(tree_flatten_sorted(model.compute_specs()))
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
            params = to_torch(args["inputs"][(arch, mesh_name, "float32", "")]["params"], "cpu")
            scfg = ServeJobConfig(arch=arch, slots=SLOTS, max_len=SERVE_LEN, device="cpu")
            runs = [(mesh_name, meshes[mesh_name])] + ([("one", one)] if rank == 0 else [])
            for name, mesh in runs:
                sv = Server(scfg, params=params, mesh=mesh)
                ids = [sv.submit(p, max_new=n) for p, n in PROMPTS]
                sv.run()
                report["serve"][(arch, mesh_name, name)] = [sv.requests[i].generated
                                                            for i in ids]
    finally:
        cfgs.get = real_get
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_moe_runs(tmp_path_factory):
    """(the JAX logits, aux and Server tokens, each rank's report)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("tp_moe")
    tokens = np.random.default_rng(1).integers(0, 512, (BATCH, SEQ)).astype(np.int32)
    args = {"inputs": {case: case_inputs(case) for case in FORWARD_CASES}, "tokens": tokens,
            "meshes": MESHES, "slots": SLOTS, "serve_len": SERVE_LEN, "max_len": MAX_LEN,
            "prefill": PREFILL, "forward_cases": FORWARD_CASES, "serve_cases": SERVE_CASES,
            "prompts": PROMPTS, "variants": VARIANTS}
    proc = start_jax(JAX_MOE, args, tmp, "jax_tp_moe")
    try:
        reports = spawn_ranks(_rank_tp_moe, (args,), tmp)
    finally:
        jax_out = finish_jax(*proc)
    return jax_out, reports


def _ids(cases):
    return ["-".join(c for c in case if c) for case in cases]


@pytest.mark.parametrize("case", FORWARD_CASES, ids=_ids(FORWARD_CASES))
def test_forward_prefill_decode_match_jax_and_one_device(tp_moe_runs, case):
    """The logits of each stage and the forward's aux, against JAX on the same
    mesh and the port's one device; the forward at capacity 1.25 drops
    assignments; every rank reports the same (global) aux."""
    jax_out, reports = tp_moe_runs
    rep = reports[0]["forward"][case]
    tol = F32_TOL if case[2] == "float32" else BF16_TOL
    assert rep["drops"] > 0
    shapes = [(BATCH, SEQ, 512), (BATCH, 512), (SEQ - PREFILL - 1, BATCH, 512)]
    want_stages = jax_out["forward"][case]
    for stage, got, plain, want, shape in zip(("forward", "prefill", "decode"), rep["got"],
                                              rep["plain"], want_stages[:3], shapes):
        assert got.shape == want.shape == shape, stage
        assert np.isfinite(got).all(), stage
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=stage)
        np.testing.assert_allclose(got, plain, rtol=tol, atol=tol, err_msg=stage)
    np.testing.assert_allclose(rep["aux"], float(want_stages[3]), rtol=tol, atol=tol)
    np.testing.assert_allclose(rep["aux"], rep["plain_aux"], rtol=tol, atol=tol)
    for rank, r in enumerate(reports):
        assert r["forward"][case]["calls"] == {}, (rank, r["forward"][case]["calls"])
        assert r["forward"][case]["aux"] == rep["aux"], rank


@pytest.mark.parametrize("case", FORWARD_CASES, ids=_ids(FORWARD_CASES))
def test_each_rank_holds_its_experts(tp_moe_runs, case):
    """Each rank's compute shard of every weight is its ``compute_specs`` slice.
    The experts split over "model" where it divides them: 1, 2 or 4 of 8 a rank
    on (1, 8), (2, 4), (4, 2); 6 experts stay whole on (2, 4). The attention and
    the shared experts split as the dense family's (reduced H = 4, K = 2)."""
    arch, mesh, _, variant = case
    M = MESHES[mesh][1]
    experts = variant != "e6"
    shared = arch == "deepseek-moe-16b"
    want_tp = {"1x8": (False, False, shared, True, experts),
               "2x4": (True, False, shared, True, experts),
               "4x2": (True, True, shared, True, experts)}[mesh]
    for rank, r in enumerate(tp_moe_runs[1]):
        assert r["forward"][case]["tp"] == want_tp, rank
        split_leaves = set()
        for path, (split, n, whole, equal) in r["shards"][case].items():
            assert equal, (rank, path)
            if split:
                split_leaves.add(path)
                assert n * M == whole, (rank, path, n, whole)
        moe = {("layers", "moe", w) for w in EXPERT_LEAVES}
        if experts:
            assert moe <= split_leaves, rank
        else:
            assert not moe & split_leaves, rank
        if shared:
            assert ("layers", "moe", "shared", "w_gate") in split_leaves, rank


@pytest.mark.parametrize("arch,mesh", SERVE_CASES, ids=[f"{a}-{m}" for a, m in SERVE_CASES])
def test_server_tokens_match_jax_and_one_device(tp_moe_runs, arch, mesh):
    jax_out, reports = tp_moe_runs
    want = jax_out["serve"][(arch, mesh)]
    assert [len(g) for g in want] == [n for _, n in PROMPTS]
    assert reports[0]["serve"][(arch, mesh, "one")] == want
    for rank, r in enumerate(reports):
        assert r["serve"][(arch, mesh, mesh)] == want, rank
