"""PyTorch port, tensor parallelism over "model" and data parallelism for the
cross-attending families (encdec and vlm): the forward, prefill, decode and the
Server on 8 CPU ranks against the JAX package on 8 forced host devices.

One JAX subprocess (``XLA_FLAGS`` forces 8 host devices; an Auto-axis mesh; a
case's forward, prefill and decode steps one compiled program) and one spawn of
8 gloo ranks run side by side in a module fixture, on the same params: a
numpy draw from a seed (``tests/test_torch_tp.py``'s helpers), every vlm cross
layer's gate at ``GATE``, as ``tests/test_torch_encdec.py`` sets them, and random
frames and patches (the servers' zero frames make every cross output exactly 0).

* Forward, prefill and decode: reduced whisper-medium (2 + 4 layers over 24
  frames) and llama-3.2-vision-90b (two groups of a self and a gated cross layer
  over 16 patches) on (1, 8), (2, 4) and (4, 2), in f32 and bf16, and in f32 on
  (2, 4) and (4, 2) with a memory that "model" does not divide (25 frames, 17
  patches): the logits of the forward, of a prefill of the first ``PREFILL`` tokens
  and of teacher-forced decode steps of the rest within tests/test_torch_model.py's
  gates (f32 1e-4, bf16 0.08) of the JAX package on the same mesh and of the port's
  one-device path. Each rank's compute shard of every weight its spec splits over
  "model" is 1/M of it and holds the values of its slice (the decoder's, the
  encoder's and the cross-attention's wq, wk, wv, wo among them); the calls run
  no ``full_tensor`` and no ``redistribute``. Each cache leaf's local shard is its
  ``cache_specs`` slice: the cross K/V split along the memory where "model"
  divides it, by kv heads on (4, 2) where it does not, whole on (2, 4) there.
* Serve: the two archs' ``Server``s in f32 (4 slots) on (2, 4): greedy tokens
  equal to the JAX ``Server``'s on the same mesh and to the port's one-device
  ``Server``'s. The JAX whisper Server is fed its zero frames in f32: its
  encoder's scan refuses bf16 frames under f32 params. Zero frames give an
  encoder output and cross K/V of exactly 0 in either dtype, as the port's
  Server computes from its bf16 zeros.
"""
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_model import BF16_TOL, F32_TOL  # noqa: E402
from test_torch_sharding import init_gloo, spawn_ranks  # noqa: E402
from test_torch_tp import JAX_PRELUDE, MESHES, _counting, finish_jax, np_params  # noqa: E402
from test_torch_tp import cfg_of as _cfg_of  # noqa: E402
from test_torch_tp import start_jax  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

ARCHS = ("whisper-medium", "llama-3.2-vision-90b")
DTYPES = ("float32", "bfloat16")
GATE = 0.5
# a memory length that no "model" axis of more than one rank divides
ODD = {"whisper-medium": {"encoder_frames": 25}, "llama-3.2-vision-90b": {"num_patches": 17}}
# (arch, mesh, dtype, memory): memory "odd" takes ODD's length
FORWARD_CASES = ([(a, m, dt, "") for a in ARCHS for m in MESHES for dt in DTYPES]
                 + [(a, m, "float32", "odd") for a in ARCHS for m in ("2x4", "4x2")])
SERVE_CASES = [(a, "2x4") for a in ARCHS]
BATCH, SEQ, PREFILL, MAX_LEN = 4, 12, 8, 16     # 3 teacher-forced decode steps
SLOTS, SERVE_LEN = 4, 64
# two prompt lengths (the JAX Server compiles a prefill for each); the 20-token one
# crosses the (2, 4) self cache's 16-position slices
PROMPTS = [([(5 * i) % 500 for i in range(20)], 6), ([9, 8, 7, 6], 5), ([1, 2, 3, 4], 7),
           ([5, 5, 2, 4], 4)]
# the leaves tensor parallelism splits over "model" on (2, 4) and (4, 2)
SPLIT = {"whisper-medium": [("layers", "attn", "wq"), ("layers", "attn", "wo"),
                            ("layers", "xattn", "wq"), ("layers", "xattn", "wo"),
                            ("layers", "mlp", "w_down"), ("enc_layers", "attn", "wq"),
                            ("enc_layers", "attn", "wo"), ("enc_layers", "mlp", "w_gate")],
         "llama-3.2-vision-90b": [("self_layers", "attn", "wq"), ("self_layers", "attn", "wo"),
                                  ("self_layers", "mlp", "w_up"), ("cross_layers", "xattn", "wq"),
                                  ("cross_layers", "xattn", "wo"),
                                  ("cross_layers", "mlp", "w_down")]}
KV = {"whisper-medium": ["layers", "enc_layers"], "llama-3.2-vision-90b": ["self_layers"]}
CROSS_KV = {"whisper-medium": ("layers", "xattn"), "llama-3.2-vision-90b": ("cross_layers", "xattn")}


def cfg_of(arch: str, dtype: str, memory: str = ""):
    cfg = _cfg_of(arch, dtype)
    return dataclasses.replace(cfg, **ODD[arch]) if memory else cfg


def aux_name(cfg) -> str:
    return "frames" if cfg.family == "encdec" else "patches"


def with_gates(params: dict) -> dict:
    """numpy params with every vlm cross layer's gate at GATE."""
    if "cross_layers" in params:
        gate = params["cross_layers"]["gate"]
        params["cross_layers"]["gate"] = np.full(gate.shape, GATE, np.float32).astype(gate.dtype)
    return params


def case_inputs(case) -> dict:
    """The case's params (gates at GATE), tokens and frames or patches, from seeds."""
    arch, _, dtype, memory = case
    cfg = cfg_of(arch, dtype, memory)
    rng = np.random.default_rng(2)
    M = cfg.encoder_frames if cfg.family == "encdec" else cfg.num_patches
    aux = rng.standard_normal((BATCH, M, cfg.d_model), dtype=np.float32)
    if dtype == "bfloat16":
        import ml_dtypes
        aux = aux.astype(ml_dtypes.bfloat16)
    return {"params": with_gates(np_params(cfg, 0)), aux_name(cfg): aux}


JAX_XATTN = JAX_PRELUDE + """
from repro.models.model import Model
from repro.models.params import partition_specs
from repro.runtime.serve_loop import Server, ServeJobConfig
out = {"forward": {}, "serve": {}}
toks = jnp.asarray(args["tokens"])
P = args["prefill"]
for case in args["forward_cases"]:
    arch, mesh_name, dtype, memory = case
    cfg = cfg_of(arch, dtype)
    if memory:
        cfg = dataclasses.replace(cfg, **args["odd"][arch])
    mesh = mesh_of(mesh_name)
    plan = MeshPlan(mesh=mesh, fsdp=False)
    inputs = args["inputs"][case]
    params = tmap(lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
                  inputs["params"], partition_specs(cfg, plan))
    name = "frames" if cfg.family == "encdec" else "patches"
    aux = {name: jnp.asarray(inputs[name])}
    model = Model(cfg, plan)

    def run(params, toks, aux):
        # the forward, the prefill and the teacher-forced decode steps: one program
        logits, _ = model.forward(params, {"tokens": toks, **aux})
        last, cache = model.prefill(params, {"tokens": toks[:, :P], **aux},
                                    max_len=args["max_len"])
        steps = []
        for i in range(P, toks.shape[1] - 1):
            step, cache = model.decode_step(params, toks[:, i:i + 1], cache)
            steps.append(step)
        return logits, last, jnp.stack(steps)
    out["forward"][case] = tuple(np.asarray(t, np.float32)
                                 for t in jax.jit(run)(params, toks, aux))
in_dtype("float32")
for arch, mesh_name in args["serve_cases"]:
    sv = Server(ServeJobConfig(arch=arch, slots=args["slots"], max_len=args["serve_len"]),
                params=tmap(jnp.asarray, args["inputs"][(arch, mesh_name, "float32", "")]["params"]),
                mesh=mesh_of(mesh_name))
    if arch == "whisper-medium":      # its zero frames in f32, where its f32 encoder takes them
        zeros = sv._aux_inputs
        sv._aux_inputs = lambda B: tmap(lambda z: z.astype(jnp.float32), zeros(B))
    ids = [sv.submit(p, max_new=n) for p, n in args["prompts"]]
    sv.run()
    out["serve"][(arch, mesh_name)] = [sv.requests[i].generated for i in ids]
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def _run_case(model, params, tokens, aux: dict):
    """(forward logits, prefill's last logits, [steps, B, V] teacher-forced decode
    logits, the cache after them), each logits tensor whole."""
    from repro_torch.parallel.sharding import full_value
    with torch.no_grad():
        logits = full_value(model.forward(params, {"tokens": tokens, **aux})[0])
        last, cache = model.prefill(params, {"tokens": tokens[:, :PREFILL], **aux},
                                    max_len=MAX_LEN)
        steps = []
        for i in range(PREFILL, tokens.shape[1] - 1):
            step, cache = model.decode_step(params, tokens[:, i:i + 1], cache)
            steps.append(full_value(step))
    return logits, full_value(last), torch.stack(steps), cache


def _rank_tp_xattn(rank, world, store, tmp, args):
    """One gloo rank: the forward / prefill / decode cases, the shards and the
    cache slices, then the Servers."""
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
    report = {"forward": {}, "shards": {}, "cache": {}, "serve": {}}
    for case in FORWARD_CASES:
        arch, mesh_name, dtype, memory = case
        cfg = cfg_of(arch, dtype, memory)
        inputs = to_torch(args["inputs"][case], "cpu")
        params, aux = inputs.pop("params"), inputs
        plan = MeshPlan(mesh=meshes[mesh_name], fsdp=False)
        model = Model(cfg, "cpu", plan)
        dparams = tree_map(lambda x, s: distribute(x, plan.mesh, s), params, model.param_specs())
        counts = {}
        saved = [(name, *_counting(DTensor, name, counts))
                 for name in ("full_tensor", "redistribute")]
        for name, _, counted in saved:
            setattr(DTensor, name, counted)
        try:
            got = _run_case(model, dparams, tokens, aux)
        finally:
            for name, fn, _ in saved:
                setattr(DTensor, name, fn)
        tp = model.tp
        rep = {"calls": counts, "tp": (tp.heads, tp.kv_heads, tp.ffn, tp.vocab)}
        if rank == 0:
            want = _run_case(Model(cfg, "cpu"), params, tokens, aux)
            rep["got"] = [t.float().numpy() for t in got[:3]]
            rep["plain"] = [t.float().numpy() for t in want[:3]]
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
        # each cache leaf's local shard against its cache_specs slice of the whole
        cache = got[3]
        cspecs = dict(tree_flatten_sorted(model.cache_specs(BATCH, MAX_LEN)))
        bad = []
        for path, t in tree_flatten_sorted(cache):
            spec, whole = cspecs[path], full_value(t)
            sl = tuple(slice(*local_range(plan, spec, d, n)) for d, n in enumerate(t.shape))
            if not (isinstance(t, DTensor) and torch.equal(t.to_local(), whole[sl])
                    and tuple(t.placements) == placements(plan.mesh, spec)):
                bad.append(path)
        report["cache"][case] = (bad, tuple(cspecs[("cross", "k")]),
                                 tuple(cspecs[("self", "k")]),
                                 bool(cache["cross"]["k"].to_local().abs().sum() > 0))
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
def tp_xattn_runs(tmp_path_factory):
    """(the JAX logits and Server tokens, each rank's report)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("tp_xattn")
    tokens = np.random.default_rng(1).integers(0, 512, (BATCH, SEQ)).astype(np.int32)
    args = {"inputs": {case: case_inputs(case) for case in FORWARD_CASES}, "tokens": tokens,
            "meshes": MESHES, "slots": SLOTS, "serve_len": SERVE_LEN, "max_len": MAX_LEN,
            "prefill": PREFILL, "forward_cases": FORWARD_CASES, "serve_cases": SERVE_CASES,
            "prompts": PROMPTS, "odd": ODD}
    proc = start_jax(JAX_XATTN, args, tmp, "jax_tp_xattn")
    try:
        reports = spawn_ranks(_rank_tp_xattn, (args,), tmp)
    finally:
        jax_out = finish_jax(*proc)
    return jax_out, reports


def _ids(cases):
    return ["-".join(c for c in case if c) for case in cases]


@pytest.mark.parametrize("case", FORWARD_CASES, ids=_ids(FORWARD_CASES))
def test_forward_prefill_decode_match_jax_and_one_device(tp_xattn_runs, case):
    jax_out, reports = tp_xattn_runs
    rep = reports[0]["forward"][case]
    tol = F32_TOL if case[2] == "float32" else BF16_TOL
    shapes = [(BATCH, SEQ, 512), (BATCH, 512), (SEQ - PREFILL - 1, BATCH, 512)]
    for stage, got, plain, want, shape in zip(("forward", "prefill", "decode"), rep["got"],
                                              rep["plain"], jax_out["forward"][case], shapes):
        assert got.shape == want.shape == shape, stage
        assert np.isfinite(got).all(), stage
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=stage)
        np.testing.assert_allclose(got, plain, rtol=tol, atol=tol, err_msg=stage)
    for rank, r in enumerate(reports):
        assert r["forward"][case]["calls"] == {}, (rank, r["forward"][case]["calls"])


@pytest.mark.parametrize("case", FORWARD_CASES, ids=_ids(FORWARD_CASES))
def test_no_rank_holds_a_whole_split_weight(tp_xattn_runs, case):
    """Each rank's compute shard of a weight split over "model" is 1/M of it, the
    values of its slice. (1, 8) splits the ffn and the vocab only (reduced H = 4,
    K = 2); (2, 4) the q heads of the self, the cross and the encoder's attention
    too; (4, 2) their kv heads as well."""
    arch, mesh = case[0], case[1]
    M = MESHES[mesh][1]
    split_leaves = set()
    for rank, r in enumerate(tp_xattn_runs[1]):
        assert r["forward"][case]["tp"] == {
            "1x8": (False, False, True, True), "2x4": (True, False, True, True),
            "4x2": (True, True, True, True)}[mesh], rank
        for path, (split, n, whole, equal) in r["shards"][case].items():
            assert equal, (rank, path)
            if split:
                split_leaves.add(path)
                assert n * M == whole, (rank, path, n, whole)
    ffn = {p for p in SPLIT[arch] if p[1] == "mlp"}
    assert {("embed",)} | ffn <= split_leaves
    if mesh != "1x8":
        assert set(SPLIT[arch]) <= split_leaves
    kv = {(stack, "attn", w) for stack in KV[arch] for w in ("wk", "wv")}
    kv |= {CROSS_KV[arch] + (w,) for w in ("wk", "wv")}
    if mesh == "4x2":
        assert kv <= split_leaves
    else:
        assert not kv & split_leaves


@pytest.mark.parametrize("case", FORWARD_CASES, ids=_ids(FORWARD_CASES))
def test_cache_shards_are_their_cache_specs_slices(tp_xattn_runs, case):
    """After the prefill and the decode steps each cache leaf's local shard is its
    ``cache_specs`` slice. The self cache splits its 16 positions over "model";
    the cross K/V split their 24 frames or 16 patches over "model", or, where
    "model" does not divide 25 or 17, their 2 kv heads on (4, 2) and nothing on
    (2, 4); they hold the cross K/V of the random memory."""
    for rank, r in enumerate(tp_xattn_runs[1]):
        bad, cross, self_, nonzero = r["cache"][case]
        assert bad == [], (rank, bad[:5])
        assert nonzero, rank
        lead = (None,) * (2 if case[0] == "llama-3.2-vision-90b" else 1)
        assert self_ == lead + ("data", "model"), (rank, self_)
        if not case[3]:
            assert cross == (None, "data", "model"), (rank, cross)
        else:
            assert cross == {"2x4": (None, "data"),
                             "4x2": (None, "data", None, "model")}[case[1]], (rank, cross)


@pytest.mark.parametrize("arch,mesh", SERVE_CASES, ids=[f"{a}-{m}" for a, m in SERVE_CASES])
def test_server_tokens_match_jax_and_one_device(tp_xattn_runs, arch, mesh):
    jax_out, reports = tp_xattn_runs
    want = jax_out["serve"][(arch, mesh)]
    assert [len(g) for g in want] == [n for _, n in PROMPTS]
    assert reports[0]["serve"][(arch, mesh, "one")] == want
    for rank, r in enumerate(reports):
        assert r["serve"][(arch, mesh, mesh)] == want, rank
