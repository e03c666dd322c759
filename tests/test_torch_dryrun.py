"""PyTorch port, the one-card dry-run: ``roofline/op_stats.py`` against ground
truths computable by hand (the twins of tests/test_hlo_stats.py's: chained
matmuls' flops, and a known allocation sequence's peak), a kernel's plain
version counted as one kernel (its inputs and outputs framework bytes, its
intermediates kernel-internal and out of the peak), its flops on reduced qwen3
and mamba2 cells against ``repro.roofline.hlo_stats`` on the same JAX cells'
compiled HLO, and ``python -m repro_torch.launch.dryrun`` writing artifacts that
``roofline/report.py`` reads back. Nothing here allocates a tensor of the
counted sizes: the steps run on fake tensors."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16  # noqa: E402
from repro_torch.models.params import TensorDef  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.op_stats import call_stats, cell_stats, stats_to_json  # noqa: E402
from test_torch_model import _auto_mesh, _jax  # noqa: E402

F32 = torch.float32
# the dry-run's flops against the JAX package's HLO accounting of the same cell
FLOPS_RTOL = 0.05


def test_chained_matmuls_count_exactly():
    """L chained [B, D] x [D, D] products: L * 2 * B * D^2 flops, and per product
    its result plus its two operands in bytes (w[i] is a view: it moves nothing)."""
    L, B, D = 4, 8, 32

    def f(w, x):
        for i in range(L):
            x = x @ w[i]
        return x

    st = call_stats(f, (TensorDef((L, D, D), F32), TensorDef((B, D), F32)))
    assert st.flops == L * 2 * B * D * D
    assert st.framework_bytes == L * 4 * (2 * B * D + D * D) and st.kernel_bytes == 0
    assert st.collective_bytes == st.cross_pod_bytes == st.in_pod_bytes == 0


def test_known_allocation_sequence_gives_its_exact_peak():
    """The input (1 KiB) stays live; a (1 KiB), b (2 KiB), a freed, c (2 KiB): the
    peak is input + b + c + a's last moment = 5 KiB; the output is a view of c."""
    def f(x):
        a = x + 1
        b = torch.cat([a, a])
        del a
        c = b * 2
        del b
        return c[:10]

    st = call_stats(f, (TensorDef((256,), F32),))
    assert st.peak_bytes == 1024 + 2048 + 2048
    assert st.flops == 0


def test_a_plain_kernel_counts_as_one_kernel():
    """K1's plain version in the dry-run: framework bytes are exactly q, k, v in
    and o out; what it forms between them (the blocks' scores and probabilities:
    shared memory and registers on the card) is kernel-internal, and the peak is
    the inputs and the output alone. Its flops are the kernel's, over the causal
    pairs: 4 B H D S (S + 1) / 2; ``dot_flops`` counts every block the plain
    version forms, the masked ones too: 4 B H Sq Skv D."""
    B, S, H, K, D = 1, 1024, 4, 2, 32
    q, kv = TensorDef((B, S, H, D), F32), TensorDef((B, S, K, D), F32)
    st = call_stats(lambda q, k, v: ops.flash_attention(q, k, v), (q, kv, kv))
    io = 4 * (2 * B * S * H * D + 2 * B * S * K * D)
    assert st.framework_bytes == io and st.peak_bytes == io
    assert st.kernel_bytes > 10 * io
    assert st.flops == 4 * B * H * D * S * (S + 1) // 2
    assert st.dot_flops == 4 * B * H * S * S * D


def _pairs_by_mask(Sq, Skv, causal, window):
    from repro_torch.kernels.flash_attention import _mask
    return int(_mask(Sq, Skv, 0, Skv, causal, window, "cpu").sum())


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (64, 64, True, 0), (64, 64, False, 0), (64, 64, True, 16), (16, 80, True, 0),
    (80, 16, True, 0), (48, 96, True, 24), (33, 70, False, 0), (70, 33, False, 0)])
def test_attention_pairs_are_the_masks_kept_pairs(Sq, Skv, causal, window):
    """K1's stated flops rest on ``attention_pairs``: the (query, key) pairs that
    the plain version's end-aligned mask keeps, counted from the mask itself."""
    from repro_torch.kernels.flash_attention import attention_pairs
    assert attention_pairs(Sq, Skv, causal, window) == _pairs_by_mask(Sq, Skv, causal, window)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 200), (False, 0)])
def test_k1_counts_its_kept_pairs_both_ways(causal, window):
    """K1 under autograd: the forward's 4 B H D pairs and the backward's 2.5 times
    as much (S again, dP, dV, dQ, dK) in ``flops``; ``dot_flops`` the plain
    versions' every block, Sq != Skv and a window included: the forward's 2
    products of 2 B H Sq Skv D, the backward's 5 over kv padded to its 512-key
    blocks and its delta = rowsum(dO * O), 2 B H Sq D."""
    B, Sq, Skv, H, K, D = 1, 300, 700, 4, 2, 16

    def step(q, k, v):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        ops.flash_attention(q, k, v, causal=causal, window=window).sum().backward()
        return q.grad, k.grad, v.grad

    st = call_stats(step, (TensorDef((B, Sq, H, D), F32), TensorDef((B, Skv, K, D), F32),
                           TensorDef((B, Skv, K, D), F32)))
    pairs = _pairs_by_mask(Sq, Skv, causal, window)
    assert 0 < pairs <= Sq * Skv
    assert st.flops == (4 + 10) * B * H * D * pairs
    padded = -(-Skv // 512) * 512
    assert st.dot_flops == 2 * B * H * D * (2 * Sq * Skv + 5 * Sq * padded + Sq)


def _cut_shapes(monkeypatch, *shape_modules):
    """train_4k and prefill_32k cut to 256 x 8 tokens and 1,024 x 2 in each
    package's SHAPES (2 kv blocks of K1's 512, 32 of mamba2's reduced 32-row
    chunks), so that the JAX package compiles them in seconds."""
    for mod in shape_modules:
        monkeypatch.setitem(mod.SHAPES, "train_4k", mod.ShapeSpec("train_4k", 256, 8, "train"))
        monkeypatch.setitem(mod.SHAPES, "prefill_32k",
                            mod.ShapeSpec("prefill_32k", 1024, 2, "prefill"))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_flops_match_jax_hlo_stats(arch, shape, monkeypatch):
    """The reduced config (its remat, "full"), 2 microbatches in training: the
    dry-run's ``dot_flops`` (every dot product the plain path runs, hlo_stats'
    convention) within FLOPS_RTOL of ``module_stats`` on the JAX cell's
    ``compiled.as_text()``, both printed, and its ``flops`` (K1 by its kept pairs)
    below them."""
    _jax()
    from repro.configs import base as jconfigs
    from repro.configs import shapes as jshapes
    from repro.launch.steps import CellOptions as JOpts, build_cell as j_build
    from repro.roofline.hlo_stats import module_stats
    _cut_shapes(monkeypatch, jshapes, tshapes)
    jcell = j_build(jconfigs.get(arch).reduced(), shape, _auto_mesh(),
                    JOpts(num_microbatches=2))
    want = module_stats(jcell.lower().compile().as_text()).flops
    tcell = tsteps.build_cell(tconfigs.get(arch).reduced(), shape,
                              tsteps.CellOptions(num_microbatches=2), device="cpu")
    st = cell_stats(tcell)
    got = st.dot_flops
    print(f"{arch}/{shape} reduced: dry-run {got:.6e} dot flops ({st.flops:.6e} with K1 by "
          f"its kept pairs), JAX hlo_stats {want:.6e} ({got / want:.4f}x)")
    assert abs(got - want) <= FLOPS_RTOL * want
    assert st.flops < st.dot_flops if arch == "qwen3-0.6b" else st.flops == st.dot_flops


def test_dryrun_cli_writes_artifacts_that_the_report_reads(tmp_path, capsys):
    """Two decode cells at full width, then the same with --skip-existing, then a
    variant whose option the model refuses: the summary lines and exit codes, the
    records' fields, and the report's rows from them."""
    argv = ["--arch", "mamba2-2.7b", "--shape", "decode_32k", "--shape", "long_500k",
            "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    assert "dry-run summary: ok=2 skip=0 fail=0" in capsys.readouterr().out
    paths = sorted(p.name for p in tmp_path.glob("*.json"))
    assert paths == ["mamba2-2.7b__decode_32k.json", "mamba2-2.7b__long_500k.json"]
    rec = json.loads((tmp_path / paths[1]).read_text())
    assert rec["mesh"] == "h100" and rec["chips"] == 1 and rec["step"] == "decode"
    assert rec["tokens_per_step"] == 1 and rec["options"]["remat"] is None
    hs = rec["hlo_stats"]
    assert 0 < hs["flops"] == hs["dot_flops"] and hs["peak_bytes"] > 2 * rec["params"]
    assert hs["hbm_bytes"] == hs["framework_bytes"] + hs["kernel_bytes"]
    assert hs["collective_bytes"] == hs["cross_pod_bytes"] == 0

    assert dryrun.main(argv + ["--skip-existing"]) == 0
    assert "dry-run summary: ok=2 skip=0 fail=0" in capsys.readouterr().out
    bad = ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--shape", "long_500k",
           "--set", "remat=everything", "--set", "note=1", "--tag", "bad",
           "--out", str(tmp_path)]
    assert dryrun.main(bad) == 1
    assert "dry-run summary: ok=0 skip=1 fail=1" in capsys.readouterr().out
    assert dryrun.parse_set(["remat=dots", "num_microbatches=4", "note=x"]) == \
        tsteps.CellOptions(remat="dots", num_microbatches=4, extra=(("note", "x"),))

    rows = report.load_rows(root=tmp_path)
    assert [r.cell for r in rows] == ["mamba2-2.7b/decode_32k", "mamba2-2.7b/long_500k"]
    r = rows[1]
    assert r.mesh == "h100" and r.chips == 1 and r.collective_s == 0 and r.fits
    assert r.model_flops == 2 * rec["active_params"]
    assert r.compute_s == hs["flops"] / PEAK_FLOPS_BF16
    assert r.memory_s == hs["framework_bytes"] / HBM_BW
    assert r.mem_gb == hs["peak_bytes"] / 1e9 < HBM_BYTES / 1e9
    table = report.markdown_table(rows)
    assert table.count("\n") == 4 and "| mamba2-2.7b/long_500k | decode |" in table
    assert report.to_json(rows)[0]["dominant"] == "memory"
    assert report.load_rows(tag="bad", root=tmp_path) == []


def test_record_fields_keep_the_jax_names():
    """Every field of the JAX package's ``hlo_stats`` record that exists on one
    card keeps its name."""
    st = call_stats(lambda x: x @ x, (TensorDef((4, 4), F32),))
    rec = stats_to_json(st)
    for name in ("flops", "dot_flops", "hbm_bytes", "collective_bytes", "cross_pod_bytes",
                 "in_pod_bytes", "by_opcode", "top_collectives"):
        assert name in rec
    assert dataclasses.asdict(st)["flops"] == 2 * 4 * 4 * 4
