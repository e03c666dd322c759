"""Roofline report: three terms per (arch x shape x mesh) cell from the
dry-run's artifacts, twin of ``repro.roofline.report``, on the H100's constants
(``launch/mesh.py``).

Conventions:
  * Every quantity is per device for the whole step (``launch/dryrun.py``
    counts it with ``roofline/op_stats.py`` on fake tensors: on one card, or as
    one rank of the 256- or 512-device production mesh).
  * compute term    = flops / PEAK_FLOPS_BF16 (dense bf16 tensor cores); K1's
    flops are its kept (query, key) pairs' (the record's ``dot_flops`` also
    counts the masked blocks that the plain path forms).
  * memory term     = framework_bytes / HBM_BW. Framework bytes exclude what a
    kernel's plain version forms between its inputs and its outputs: on the card
    those live in shared memory and registers.
  * collective term = in_pod_bytes / IN_POD_BW + cross_pod_bytes / CROSS_POD_BW
    (a device's InfiniBand port in the pod; its share of the hybrid-cloud link
    across it); 0 on one card, which has no collectives.
  * MODEL_FLOPS     = the useful flops of a step per device:
      train   6*N*D    prefill  2*N*D    decode  2*N*B     (N = active params)
  * roofline_fraction = (MODEL_FLOPS/peak) / max(terms): the share of the step's
    bound time that does useful model math. Also reported: compute_fraction =
    compute_s / max(terms) (how compute-bound the cell is), MODEL/HLO (the
    remat recompute and attention, which 6*N*D leaves out), and
    the predicted peak memory a device against the card's (``fits``).

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.report               # every mesh's table
  PYTHONPATH=src python -m repro_torch.roofline.report --mesh multi
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

from repro_torch.launch.mesh import (CROSS_POD_BW, HBM_BW, HBM_BYTES, IN_POD_BW,
                                     PEAK_FLOPS_BF16)

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_h100"


@dataclasses.dataclass
class RooflineRow:
    cell: str
    mesh: str
    tag: str
    step: str
    chips: int
    hlo_flops: float
    model_flops: float
    framework_bytes: float
    kernel_bytes: float
    ici_bytes: float
    dcn_bytes: float
    mem_gb: float

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def model_compute_s(self) -> float:
        return self.model_flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.framework_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.ici_bytes / IN_POD_BW + self.dcn_bytes / CROSS_POD_BW

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s, 1e-12)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        return self.model_compute_s / self.bound_s

    @property
    def compute_fraction(self) -> float:
        return self.compute_s / self.bound_s

    @property
    def model_over_hlo(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1e-12)

    @property
    def fits(self) -> bool:
        return self.mem_gb * 1e9 <= HBM_BYTES

    def advice(self) -> str:
        if not self.fits:
            return ("does not fit a card: cut the microbatch (num_microbatches), "
                    "remat=full, or shard across more cards")
        if self.dominant == "memory":
            return ("memory-bound: fuse the elementwise passes around the kernels, "
                    "keep intermediates in bf16, raise arithmetic intensity (larger "
                    "matmuls per launch)")
        if self.dominant == "collective":
            if self.dcn_bytes / CROSS_POD_BW > self.ici_bytes / IN_POD_BW:
                return ("cross-pod-bound: amortize the pod boundary - Titchener "
                        "local-sync (H local steps + int8 delta) instead of a "
                        "gradient all-reduce every step")
            return ("in-pod-bound: replace tensor-parallel all-reduces with "
                    "reduce-scatter + all-gather (sp=true), bf16 collectives, overlap "
                    "with compute")
        return ("compute-bound: reduce remat recompute (remat=dots), larger "
                "microbatches; near roofline otherwise")


def model_flops_per_device(rec: dict) -> float:
    n = rec["active_params"]
    toks = rec["tokens_per_step"]
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[rec["step"]]
    return mult * n * toks / rec["chips"]


def row_from_artifact(rec: dict) -> RooflineRow:
    hs = rec["hlo_stats"]
    return RooflineRow(
        cell=rec["cell"], mesh=rec["mesh"], tag=rec.get("tag", "baseline"),
        step=rec["step"], chips=rec["chips"], hlo_flops=hs["flops"],
        model_flops=model_flops_per_device(rec),
        framework_bytes=hs["framework_bytes"], kernel_bytes=hs["kernel_bytes"],
        ici_bytes=hs["in_pod_bytes"], dcn_bytes=hs["cross_pod_bytes"],
        mem_gb=hs["peak_bytes"] / 1e9)


def load_rows(tag: str = "baseline", root: Path = ARTIFACTS,
              mesh: str = "h100") -> List[RooflineRow]:
    """The rows of the artifacts of ``tag`` on ``mesh``: ``root`` itself for one
    card ("h100"), ``root/<mesh>`` for "single" and "multi"."""
    rows = []
    d = root if mesh == "h100" else root / mesh
    if not d.exists():
        return rows
    for p in sorted(d.glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("tag", "baseline") != tag:
            continue
        rows.append(row_from_artifact(rec))
    return rows


def markdown_table(rows: List[RooflineRow]) -> str:
    """One mesh's table (``main`` prints one a mesh)."""
    hdr = ("| cell | step | compute s | memory s | collective s | bound s | "
           "dominant | RF | CF | MODEL/HLO | mem GB/dev | fits | TFLOP/dev | in-pod GB/dev | "
           "cross-pod GB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in sorted(rows, key=lambda r: r.cell):
        out.append(
            f"| {r.cell} | {r.step} | {r.compute_s:.3f} | {r.memory_s:.3f} | "
            f"{r.collective_s:.3f} | {r.bound_s:.3f} | {r.dominant} | "
            f"{r.roofline_fraction:.2f} | {r.compute_fraction:.2f} | "
            f"{r.model_over_hlo:.2f} | {r.mem_gb:.1f} | {'yes' if r.fits else 'no'} | "
            f"{r.hlo_flops / 1e12:.2f} | {r.ici_bytes / 1e9:.3f} | {r.dcn_bytes / 1e9:.4f} |\n")
    return "".join(out)


def to_json(rows: List[RooflineRow]) -> list:
    return [{**dataclasses.asdict(r),
             "compute_s": r.compute_s, "memory_s": r.memory_s,
             "collective_s": r.collective_s, "bound_s": r.bound_s,
             "dominant": r.dominant,
             "roofline_fraction": r.roofline_fraction,
             "compute_fraction": r.compute_fraction,
             "model_over_hlo": r.model_over_hlo,
             "fits": r.fits,
             "advice": r.advice()} for r in rows]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", choices=("h100", "single", "multi", "all"), default="all")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--root", type=Path, default=ARTIFACTS)
    args = ap.parse_args(argv)
    meshes = ("h100", "single", "multi") if args.mesh == "all" else (args.mesh,)
    for mesh in meshes:
        rows = load_rows(args.tag, args.root, mesh)
        if rows or args.mesh != "all":
            print(f"## {mesh}\n\n{markdown_table(rows)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
