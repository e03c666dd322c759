"""One-card dry-run: count what every (arch x shape) cell's step does on the H100,
twin of ``repro.launch.dryrun``.

For each cell this builds the step (``launch/steps.py`` ``build_cell``) on the
CPU and runs it once on fake tensors (``roofline/op_stats.py``): no memory is
allocated, nothing is computed and no card is used, so it runs on any machine.
It records the step's flops, its memory traffic (framework and kernel-internal
bytes) and its predicted peak memory, and writes one JSON artifact per cell
under ``artifacts/dryrun_h100/`` (``roofline/report.py`` turns them into the
roofline table). The mesh kind is ``"h100"``: one card, no collectives.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --skip-existing
  ... --set remat=dots --set num_microbatches=4 --tag dots   # hillclimb variants
  PYTHONPATH=src python -m repro_torch.roofline.report       # the table
"""
import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, cell_is_runnable
from repro_torch.launch.mesh import CHIPS
from repro_torch.launch.steps import CellOptions, build_cell
from repro_torch.roofline.op_stats import cell_stats, stats_to_json
from repro_torch.roofline.report import ARTIFACTS

MESH = "h100"


def run_cell(arch, shape: str, opts: CellOptions, tag: str = "baseline",
             verbose: bool = True) -> dict:
    """The record of one cell; ``arch`` an arch id or an ``ArchConfig``."""
    t0 = time.time()
    cell = build_cell(arch, shape, opts, device="cpu")
    t_build = time.time() - t0
    t0 = time.time()
    st = cell_stats(cell)
    t_trace = time.time() - t0
    arch = cell.cfg.name
    rec = {
        "cell": f"{arch}/{shape}",
        "arch": arch,
        "shape": shape,
        "mesh": MESH,
        "tag": tag,
        "step": cell.spec.step,
        "chips": CHIPS,
        "options": {**dataclasses.asdict(opts), "extra": dict(opts.extra)},
        "timings_s": {"build": round(t_build, 2), "trace": round(t_trace, 2)},
        "hlo_stats": stats_to_json(st),
        "params": cell.cfg.param_count(),
        "active_params": cell.cfg.active_param_count(),
        "tokens_per_step": (cell.spec.global_batch *
                            (cell.spec.seq_len if cell.spec.step != "decode" else 1)),
    }
    if verbose:
        hs = rec["hlo_stats"]
        print(f"  op_stats (one card, whole step): flops={hs['flops']:.3e} "
              f"(every dot {hs['dot_flops']:.3e}) hbm={hs['hbm_bytes']:.3e} (framework {hs['framework_bytes']:.3e}, "
              f"kernel-internal {hs['kernel_bytes']:.3e}) peak={hs['peak_bytes'] / 1e9:.2f} GB "
              f"ops={hs['ops']}")
    return rec


def artifact_path(arch: str, shape: str, tag: str = "baseline",
                  root: Path = ARTIFACTS) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    suffix = "" if tag == "baseline" else f"__{tag}"
    return root / f"{arch}__{shape}{suffix}.json"


def parse_set(kvs) -> CellOptions:
    opts = {}
    for kv in kvs or ():
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        elif v.lstrip("-").isdigit():
            v = int(v)
        else:
            try:
                v = float(v)
            except ValueError:
                pass
        opts[k] = v
    known = {f.name for f in dataclasses.fields(CellOptions)}
    extra = tuple((k, v) for k, v in opts.items() if k not in known)
    kwargs = {k: v for k, v in opts.items() if k in known}
    if extra:
        kwargs["extra"] = extra
    return CellOptions(**kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", action="append", help="arch id (repeatable)")
    ap.add_argument("--shape", action="append", choices=sorted(SHAPES))
    ap.add_argument("--set", action="append", dest="sets", metavar="K=V",
                    help="CellOptions override, e.g. --set remat=dots")
    ap.add_argument("--tag", default="baseline",
                    help="artifact tag (hillclimb variants)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--fail-fast", action="store_true")
    ap.add_argument("--out", type=Path, default=ARTIFACTS,
                    help=f"artifact directory (default {ARTIFACTS})")
    args = ap.parse_args(argv)

    opts = parse_set(args.sets)
    archs = args.arch or configs.names()
    shapes = args.shape or list(SHAPES)

    n_ok = n_skip = n_fail = 0
    failures = []
    for arch in archs:
        cfg = configs.get(arch)
        for shape in shapes:
            reason = cell_is_runnable(cfg, shape)
            if reason:
                print(f"SKIP {arch}/{shape}: {reason}")
                n_skip += 1
                continue
            path = artifact_path(arch, shape, args.tag, args.out)
            if args.skip_existing and path.exists():
                n_ok += 1
                continue
            print(f"=== {arch}/{shape} [{MESH}] tag={args.tag}", flush=True)
            try:
                rec = run_cell(arch, shape, opts, args.tag)
                path.write_text(json.dumps(rec, indent=1))
                print(f"  wrote {path} (build {rec['timings_s']['build']}s, "
                      f"trace {rec['timings_s']['trace']}s)", flush=True)
                n_ok += 1
            except Exception as e:        # noqa: BLE001
                n_fail += 1
                failures.append((arch, shape, MESH, repr(e)))
                traceback.print_exc()
                if args.fail_fast:
                    raise
    print(f"\ndry-run summary: ok={n_ok} skip={n_skip} fail={n_fail}")
    for f in failures:
        print("  FAIL", *f)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
