#!/usr/bin/env python3
"""K2's gated backward against its variants, in turns on one NVIDIA GPU.

    python3 tools/gated_bwd_variants.py --parent DIR   # from the root of a checkout

Builds this checkout's ``csrc/rmsnorm.cu`` and copies of it changed by the
textual patches in VARIANTS (each a design choice undone), and DIR's
``rmsnorm.cu`` (an older checkout, e.g. the parent commit unpacked by ``git
archive``) as it is and with its fold removed, each into a library of its own
with the port's nvcc flags. Every variant that computes dscale is held against
the plain version at GATED_SHAPES in both dtypes (f32 against chip_smoke's
gated_bwd_exact), two runs bit-equal. Then each is timed (CUDA events, median
of 20 calls) in turns, forwards then backwards, twice, at mamba2-2.7b's and
zamba2-7b's training rows in bf16 beside ``torch.add(y, z)`` on the same
tensors (the card's streaming rate for a yardstick), and the older checkout's
rmsnorm_bwd and add_rmsnorm_bwd with and without their fold at wide rows. Prints
the card's name and power limit; exits nonzero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

# the timed shapes: mamba2-2.7b's and zamba2-7b's gated rows in training
TIMED = [(1, 2048, 5120), (1, 2048, 7168)]
GATED_SHAPES = [(3, 5, 80), (2, 16, 1024), (1, 1, 5120), (1, 100, 7168), (1, 2047, 5120),
                (1, 3, 8192)] + TIMED
# the older checkout's plain and add backward at wide rows (and qwen3's, narrow)
FOLD_SHAPES = [(4, 2048, 1024), (1, 2048, 2560), (1, 2048, 3584), (1, 2048, 4096),
               (1, 2048, 8192)]

_FOLD_LOOP = """    double s = 0.0;
    for (int j = 0; j < teams; ++j) s += stage[(size_t)j * D + e];
    out[e] = s;
  }
}
"""
_FOLD_LAUNCH = """  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gated_fold_kernel<T><<<(D + 31) / 32, 32 * GATED_SLICES, 0, s>>>(rows, (int)blocks, D,
                                                                   a.dscale);
  return cudaGetLastError();
"""
# name -> (what the variant undoes, [(old, new), ...] on this checkout's source)
VARIANTS = {
    "one launch, ticket fold": (
        "dscale folded in the same launch by rows_bwd_kernel's wait-free ticket tree "
        "over the blocks' rows, not by a second launch",
        [(_FOLD_LOOP, """    double s = 0.0;
    for (int j = 0; j < teams; ++j) s += stage[(size_t)j * D + e];
    out[(e % VEC) * nvec + e / VEC] = s;   // fold's [k][i] layout
  }
  Fold f;
  f.count = reinterpret_cast<unsigned*>(rows - FOLD_COUNTERS / 2);
  f.partial = rows;
  f.group = rows + (long long)gridDim.x * D;
  fold<T, VEC>(f, D, D, nvec, a.dscale, a.dscale);
}
"""), (_FOLD_LAUNCH, "  return cudaGetLastError();\n")]),
    "wide rows at NV=4": (
        "rows past 128 vectors at 4 vectors a thread (rows_bwd_kernel's, so each row's "
        "sums in its order), not 2",
        [("constexpr int GATED_WIDE_NV = 2;", "constexpr int GATED_WIDE_NV = 4;")]),
    "e not kept": (
        "the second pass's expf(-z) again, not e kept in shared memory",
        [("""          reinterpret_cast<float*>(ekeep + (v * VEC / 4 + k / 4) * tpr)[k % 4] = e;
""", ""), ("""#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const float4 f = ekeep[(v * VEC / 4 + q) * tpr];
          ef[4 * q] = f.x;
          ef[4 * q + 1] = f.y;
          ef[4 * q + 2] = f.z;
          ef[4 * q + 3] = f.w;
        }
""", ""), ("const float sig = __fdividef(1.0f, 1.0f + ef[k]);",
           "const float sig = __fdividef(1.0f, 1.0f + expf(-zf[k]));"),
         ("+ NV * Vec<T>::N * sizeof(float));", "+ 0);")]),
    "1,024 threads": (
        "a bound of 1,024 threads a block at NV <= 2 (64 registers), not 896 (72)",
        [("return nv <= 2 ? 896 : 512;", "return nv <= 2 ? 1024 : 512;")]),
    "1 stage": ("no row in flight ahead (a ring of one stage), not one",
                [("constexpr int GATED_STAGES = 2;", "constexpr int GATED_STAGES = 1;")]),
    "3 stages": ("two rows in flight ahead, not one",
                 [("constexpr int GATED_STAGES = 2;", "constexpr int GATED_STAGES = 3;")]),
}
PARENT_FOLD = "  fold<T, VEC>(fold_, D, D, nvec, a.dscale, a.dscale);\n}"


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"patch target found {src.count(old)} times: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(sources: dict) -> dict:
    """{name: source text} -> {name: loaded library}, one nvcc each, all at once."""
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "variants"
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
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True, metavar="CHECKOUT")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gated_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as RN
    card = C.phase_card()
    this = (_build.CSRC / "rmsnorm.cu").read_text()
    older = (args.parent.resolve() / "src/repro_torch/kernels/csrc/rmsnorm.cu").read_text()
    sources = {"this": this, **{n: patched(this, e) for n, (_, e) in VARIANTS.items()},
               "older": older, "older, no fold": patched(older, [(PARENT_FOLD, "}")])}
    libs = build(sources)
    for name, (what, _) in VARIANTS.items():
        print(f"variant {name!r}: {what}")
    fns = {}
    for name, lib in libs.items():
        for entry in ("gated_rmsnorm_bwd", "rmsnorm_bwd", "add_rmsnorm_bwd"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = getattr(RN._lib(), entry).argtypes, ctypes.c_int
            fns[name, entry] = fn
    blocks = RN._max_blocks(torch.device("cuda"))
    scratch = C.fold_scratch(blocks)
    gated = {name: C.other_gated_bwd(fns[name, "gated_rmsnorm_bwd"], scratch, blocks)
             for name in libs}

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    for shape in GATED_SHAPES:
        for dtype in (f32, bf16):
            y, z, sc, dout = C.gated_bwd_case(gen, shape, dtype)
            want = (C.gated_bwd_exact(y, z, sc, dout) if dtype == f32
                    else RN.gated_rmsnorm_bwd_plain(y, z, sc, dout))
            for name, call in gated.items():
                if name == "older, no fold":
                    continue
                try:
                    got, again = call(y, z, sc, dout), call(y, z, sc, dout)
                except RuntimeError as err:   # a variant's teams that do not fit
                    C.check(name in VARIANTS, str(err))
                    print(f"variant {name!r} does not launch at {shape} {dtype}: {err}")
                    continue
                for i, (g, w, r) in enumerate(zip(got, want, again)):
                    C.check(C.close(g, w, C.RMS_TOL[dtype]), f"{name} {shape} {dtype} output "
                            f"{i}: max err {C.max_err(g, w)}")
                    C.check(torch.equal(g, r), f"{name} {shape} {dtype} output {i}: two runs "
                            "differ")
    print(f"every variant within K2's gates at {len(GATED_SHAPES)} shapes, f32 and bf16, "
          "two runs bit-equal")

    for shape in TIMED:
        y, z, sc, dout = C.gated_bwd_case(gen, shape, bf16)
        out = torch.empty_like(y)
        nbytes = (5 * y.numel() + 2 * sc.numel()) * y.element_size()
        names = list(gated) + ["torch.add(y, z)"]
        calls = {**{n: (lambda c=c: c(y, z, sc, dout)) for n, c in gated.items()},
                 "torch.add(y, z)": lambda: torch.add(y, z, out=out)}
        times = {n: [] for n in names}
        for order in (names, names[::-1], names, names[::-1]):
            for n in order:
                times[n].append(C.time_ms(calls[n]))
        print(f"== {shape} bf16: bound {nbytes / C.PEAK_BYTES_S * 1e3:.4f} ms "
              f"({nbytes / 1e6:.1f} MB; torch.add moves {3 * y.numel() * 2 / 1e6:.1f} MB) "
              f"[{card}]")
        for n in names:
            print(f"  {n:26s} " + " ".join(f"{t:.4f}" for t in times[n])
                  + f"  min {min(times[n]):.4f} ms")
        for n in ("older", "this"):
            C.profile_breakdown(f"gated_rmsnorm_bwd {shape} bf16, {n}", calls[n], top=3)
        del y, z, dout, out

    print("== the older checkout's rmsnorm_bwd and add_rmsnorm_bwd, bf16, with and without "
          "its fold, in turns")
    stream = torch.cuda.current_stream().cuda_stream
    for shape in FOLD_SHAPES:
        x, sc, dy, ds = C.norm_bwd_case(gen, shape, bf16)
        D = shape[-1]
        dx, dsc = torch.empty_like(x), torch.empty_like(sc)
        head = (x.data_ptr(), sc.data_ptr())
        tail = (dx.data_ptr(), dsc.data_ptr(), scratch(D), blocks, x.numel() // D, D, 1e-6,
                1, 0, stream)
        row = []
        for entry, mid in (("rmsnorm_bwd", (dy.data_ptr(),)),
                           ("add_rmsnorm_bwd", (ds.data_ptr(), dy.data_ptr()))):
            t = {n: [] for n in ("older", "older, no fold")}
            for n in ("older", "older, no fold", "older, no fold", "older"):
                t[n].append(C.time_ms(lambda f=fns[n, entry]: f(*head, *mid, *tail)))
            row.append(f"{entry} {min(t['older']):.4f}, without the fold "
                       f"{min(t['older, no fold']):.4f}")
        nb = (3 * x.numel() + 2 * D) * 2
        print(f"  {shape}: " + "; ".join(row) + f" ms (rmsnorm_bwd's bound "
              f"{nb / C.PEAK_BYTES_S * 1e3:.4f})")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
