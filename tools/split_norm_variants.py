#!/usr/bin/env python3
"""K2's gated norm over a split row against its variants, in turns on one NVIDIA GPU.

    python3 tools/split_norm_variants.py --parent DIR   # from the root of a checkout

Builds this checkout's ``csrc/rmsnorm.cu`` and copies of it changed by the
textual patches in VARIANTS (each a design choice of the split-row kernels
undone), each into a library of its own with the port's nvcc flags, and DIR's
``rmsnorm.cu`` (an older checkout, e.g. the parent commit unpacked by ``git
archive``), called through DIR's own ``kernels/rmsnorm.py``. Every build's four
split-row entries are held against their plain versions at CHECKED in both dtypes
(the f32 sums and backward against chip_smoke's f64 evaluations), two runs
bit-equal. Then each entry of each build is timed in bf16 with the L2 flushed
before every call (chip_smoke's time_cold_ms, the median of 20) in turns (the
builds in order, reversed, in order, reversed) at the training rows of mamba2-2.7b
and zamba2-7b split 2, 4 and 8 ways, beside ``torch.add(y, z)`` on the same local
rows, flushed too (the card's streaming rate for a yardstick). Prints the card's
name and power limit; exits nonzero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

# (rows, d_inner, ways) held both ways in f32 and bf16: ragged rows, both row plans
CHECKED = [((3, 5), 5120, 2), ((3, 5), 7168, 8), ((1, 300), 5120, 4), ((1, 2048), 7168, 2)]
WIDTHS, WAYS = (5120, 7168), (2, 4, 8)
ENTRIES = ("gated_rmsnorm_stats", "gated_rmsnorm_split", "gated_rmsnorm_split_dot",
           "gated_rmsnorm_split_bwd")

_ROUND_PAIR = """    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(&h);
    a = bf_lo(w);
    b = bf_hi(w);
"""
_PACK_PAIRS = """  if constexpr (sizeof(T) == 4) {
    return pack<T>(f);
  } else {"""
_FINISH_LOOP = """#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float e = expf(-zf[j]);
          const float sf = silu_of<T>(zf[j], e);
          const float sig = __fdividef(1.0f, 1.0f + e);
          const float t = round_to<T>(__fmul_rn(yf[j], sf));
          acc[v][j] += (Acc)gf[j] * t * (Acc)rstd;
          const float dt = round_to<T>(rstd * gf[j] * w[j] - t * coef);
          dz[j] = __fmul_rn(round_to<T>(__fmul_rn(dt, yf[j])),
                            __fmul_rn(sig, 1.0f + zf[j] * (1.0f - sig)));
          dy[j] = __fmul_rn(dt, sf);
        }
        put16(a.dz, row * nvec + i, pack<T>(dz));
        put16(a.out, row * nvec + i, pack<T>(dy));"""
_FINISH_PAIRS = """#pragma unroll
        for (int j = 0; j < VEC; j += 2) {
          const float e0 = expf(-zf[j]), e1 = expf(-zf[j + 1]);
          float s0 = silu_raw<T>(zf[j], e0), s1 = silu_raw<T>(zf[j + 1], e1);
          round_pair<T>(s0, s1);
          float t0 = __fmul_rn(yf[j], s0), t1 = __fmul_rn(yf[j + 1], s1);
          round_pair<T>(t0, t1);
          acc[v][j] += (Acc)gf[j] * t0 * (Acc)rstd;
          acc[v][j + 1] += (Acc)gf[j + 1] * t1 * (Acc)rstd;
          float d0 = rstd * gf[j] * w[j] - t0 * coef, d1 = rstd * gf[j + 1] * w[j + 1] - t1 * coef;
          round_pair<T>(d0, d1);
          float q0 = __fmul_rn(d0, yf[j]), q1 = __fmul_rn(d1, yf[j + 1]);
          round_pair<T>(q0, q1);
          const float g0 = __fdividef(1.0f, 1.0f + e0), g1 = __fdividef(1.0f, 1.0f + e1);
          dz[j] = __fmul_rn(q0, __fmul_rn(g0, 1.0f + zf[j] * (1.0f - g0)));
          dz[j + 1] = __fmul_rn(q1, __fmul_rn(g1, 1.0f + zf[j + 1] * (1.0f - g1)));
          dy[j] = __fmul_rn(d0, s0);
          dy[j + 1] = __fmul_rn(d1, s1);
        }
        put16(a.dz, row * nvec + i, pack_pairs<T>(dz));
        put16(a.out, row * nvec + i, pack_pairs<T>(dy));"""
# name -> (what the variant undoes, [(old, new, times), ...] on this checkout's source)
VARIANTS = {
    "rows: NV x2": (
        "the row passes' rows past 128 vectors at twice row_shape's vectors a thread "
        "(half the threads a block)",
        [("""  a.nvec = r.nvec;
  a.tpr = r.tpr;
  const unsigned blocks = grid_for(r.groups, r.threads);""", """  if (r.tpr > 32 && r.nv < 8) {
    r.nv *= 2;
    r.tpr = ((r.nvec + r.nv - 1) / r.nv + 31) / 32 * 32;
    r.threads = r.tpr;
  }
  a.nvec = r.nvec;
  a.tpr = r.tpr;
  const unsigned blocks = grid_for(r.groups, r.threads);""", 1)]),
    "rows: scale from L1": (
        "the row passes' scale read from L1 at every row, not held in registers",
        [("          widen<T>(sc[v], w);\n", "          widen<T>(ld16(a.scale, i), w);\n", 2)]),
    "rows: one rounding a value": (
        "the row passes' every rounding to bf16 one conversion a value (round_to, pack), "
        "not a pair",
        [(_ROUND_PAIR, "    a = round_to<T>(a);\n    b = round_to<T>(b);\n", 1),
         (_PACK_PAIRS, "  if constexpr (true) {\n    return pack<T>(f);\n  } else {", 1)]),
    "rows: 6 blocks an SM": (
        "the row passes compiled for 6 blocks of 256 threads an SM (at most 40 registers), "
        "not for 1",
        [("__global__ void __launch_bounds__(MAX_THREADS)\nsplit_rows_kernel(",
          "__global__ void __launch_bounds__(MAX_THREADS, 6)\nsplit_rows_kernel(", 1)]),
    "rows: 8 blocks an SM": (
        "the row passes compiled for 8 blocks of 256 threads an SM (at most 32 registers), "
        "not for 1",
        [("__global__ void __launch_bounds__(MAX_THREADS)\nsplit_rows_kernel(",
          "__global__ void __launch_bounds__(MAX_THREADS, 8)\nsplit_rows_kernel(", 1)]),
    "finish: pairs": (
        "the finish rounding two values a conversion (round_pair, pack_pairs), as the row "
        "passes do, not one",
        [(_FINISH_LOOP, _FINISH_PAIRS, 1)]),
    "finish: 768 threads": ("the finish's block bound 768 threads at NV <= 2 (80 registers), "
                            "not 640 (96)",
                            [("constexpr int SPLIT_THREADS = 640;",
                              "constexpr int SPLIT_THREADS = 768;", 1)]),
    "finish: 1 stage": ("the finish with no row in flight ahead (a ring of one stage)",
                        [("constexpr int GATED_STAGES = 2;", "constexpr int GATED_STAGES = 1;",
                          1)]),
    "finish: 3 stages": ("the finish with two rows in flight ahead, not one",
                         [("constexpr int GATED_STAGES = 2;", "constexpr int GATED_STAGES = 3;",
                           1)]),
    "finish: wide NV=4": ("the finish's rows past 128 vectors at 4 vectors a thread, not 2",
                          [("constexpr int GATED_WIDE_NV = 2;",
                            "constexpr int GATED_WIDE_NV = 4;", 1)]),
}


def patched(src: str, edits) -> str:
    for old, new, times in edits:
        if src.count(old) != times:
            raise SystemExit(f"patch target found {src.count(old)} times, not {times}: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(sources: dict) -> dict:
    """{name: source text} -> {name: (loaded library, nvcc's log)}, one nvcc each, all at
    once."""
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "split_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(so)), log
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True, metavar="CHECKOUT")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("split_norm_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as RN
    card = C.phase_card()
    this = (_build.CSRC / "rmsnorm.cu").read_text()
    older = (args.parent.resolve() / "src/repro_torch/kernels/csrc/rmsnorm.cu").read_text()
    libs = build({"this": this, **{n: patched(this, e) for n, (_, e) in VARIANTS.items()},
                  "older": older})
    for name, (what, _) in VARIANTS.items():
        print(f"variant {name!r}: {what}")
    mine = RN._lib()
    modules = {}
    for name, (lib, log) in libs.items():
        regs = {}   # (kernel, dtype) -> (registers, spill bytes), the most of its instances
        for k, st, r in C.ptxas_kernels(log):
            m = re.search(r"(split_\w+?_kernel)I(f|13__nv_bfloat16)", k)
            if m and r:
                key = f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}>"
                old = regs.get(key, (0, 0))
                regs[key] = (max(old[0], r), max(old[1], st))
        print(f"{name}: registers at most " + ", ".join(
            f"{k} {r}" + (f" (spills {st} B)" if st else "") for k, (r, st) in regs.items()))
        for entry in ("gated_rmsnorm_split_stats", "gated_rmsnorm_split_fwd",
                      "gated_rmsnorm_split_dot", "gated_rmsnorm_split_bwd"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = getattr(mine, entry).argtypes, ctypes.c_int
        if name == "older":
            modules[name] = C.other_rmsnorm(args.parent, lib)
        else:
            mod = C.other_rmsnorm(ROOT, lib)   # this checkout's wrappers on the variant
            modules[name] = mod

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for rows, D, ways in CHECKED:
        for dtype in (f32, bf16):
            y, z, sc, dout = C.gated_bwd_case(gen, rows + (D,), dtype)
            a, b, c, g = (C.split_parts(t, ways)[0] for t in (y, z, sc, dout))
            tol = C.RMS_TOL[dtype]
            ss_x, dot_x = C.split_sums_exact(a, b, c, g)
            ss, dot = ss_x.float() * ways, dot_x.float()
            want = (C.split_bwd_exact(a, b, c, g, ss, dot, D) if dtype == f32 else
                    RN.gated_rmsnorm_split_bwd_plain(a, b, c, g, ss, dot, D))
            want_norm = RN.gated_rmsnorm_split_plain(a, b, c, ss, D)
            for name, mod in modules.items():
                calls = C.split_entries(mod, a, b, c, g, ss, dot, D)
                first = [calls[e]() for e in ENTRIES]
                again = [calls[e]() for e in ENTRIES]
                for e, x, r in zip(ENTRIES, first, again):
                    for i, (p, q) in enumerate(zip(x if isinstance(x, tuple) else (x,),
                                                   r if isinstance(r, tuple) else (r,))):
                        C.check(torch.equal(p, q), f"{name} {e} {rows} {D}/{ways} {dtype} "
                                f"output {i}: two runs differ")
                for e, got, w in (("stats", first[0], ss_x), ("dot", first[2], dot_x),
                                  ("norm", first[1], want_norm)):
                    C.check(C.close(got, w, tol), f"{name} {e} {rows} {D}/{ways} {dtype}: "
                            f"max err {C.max_err(got, w)}")
                for i, (got, w) in enumerate(zip(first[3], want)):
                    C.check(C.close(got, w, tol), f"{name} bwd {rows} {D}/{ways} {dtype} "
                            f"output {i}: max err {C.max_err(got, w)}")
    print(f"every build within K2's gates at {CHECKED}, f32 and bf16, two runs bit-equal")

    names = list(modules) + ["torch.add(y, z)"]
    for D in WIDTHS:
        for ways in WAYS:
            y, z, sc, dout = C.gated_bwd_case(gen, (1, 2048, D), bf16)
            a, b, c, g = (C.split_parts(t, ways)[0] for t in (y, z, sc, dout))
            ss = RN.gated_rmsnorm_stats_cuda(a, b) * ways
            dot = RN.gated_rmsnorm_split_dot_cuda(a, b, c, g)
            out = torch.empty_like(a)
            n, e, Dl = a.numel(), a.element_size(), a.shape[-1]
            print(f"== [2048, {D}] / {ways} = [2048, {Dl}] bf16, L2 flushed, ms: the builds in "
                  f"turns (order, reversed, order, reversed), their median [{card}]")
            bounds = {"gated_rmsnorm_stats": 2 * n * e + 4 * 2048,
                      "gated_rmsnorm_split": 3 * n * e + Dl * e + 4 * 2048,
                      "gated_rmsnorm_split_dot": 3 * n * e + Dl * e + 4 * 2048,
                      "gated_rmsnorm_split_bwd": 5 * n * e + 2 * Dl * e + 8 * 2048}
            for entry in ENTRIES:
                calls = {nm: C.split_entries(mod, a, b, c, g, ss, dot, D)[entry]
                         for nm, mod in modules.items()}
                calls["torch.add(y, z)"] = lambda: torch.add(a, b, out=out)
                times = {nm: [] for nm in names}
                for order in (names, names[::-1], names, names[::-1]):
                    for nm in order:
                        times[nm].append(C.time_cold_ms(calls[nm]))
                print(f"  {entry} (bound {bounds[entry] / C.PEAK_BYTES_S * 1e3:.5f} ms):")
                for nm in names:
                    print(f"    {nm:22s} " + " ".join(f"{t:.4f}" for t in times[nm])
                          + f"  median {statistics.median(times[nm]):.4f}")
            del y, z, sc, dout, a, b, c, g, out
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
