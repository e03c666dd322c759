"""Copy of ``repro.roofline.cost`` under ``repro_torch``.

Roofline cost vectors: the placement signal for workload-aware routing.

Every pipeline ``Task`` can be priced as a :class:`CostVector` — (flops,
hbm_bytes, collective_bytes, io_bytes) for one execution of the task. The
vector comes from, in order of preference:

  1. ``Task.cost`` — an explicit dict, e.g. loaded from a dry-run artifact
     (the JAX package's ``roofline.hlo_stats.stats_to_json`` output)
     committed next to the DAG;
  2. ``payload["hlo_stats"]`` — the same artifact inlined in the payload
     (``flops`` / ``hbm_bytes`` / ``collective_bytes`` keys are lifted);
  3. an analytic estimate from the arch registry + payload shapes — the
     ``6·N·D`` / ``2·N·D`` MFU conventions the roofline report uses, with N
     from ``ArchConfig.param_count()`` and D (tokens) from the payload's
     (steps, global_batch, seq_len), optionally resolved through a named
     ``configs.shapes`` entry (``payload["shape"]``);
  4. nothing — tasks with no recognizable shape (custom ``python`` kinds)
     price as ``None`` and are never steered, which keeps cost-aware routing
     a strict no-op for them.

Classification is the standard roofline split: a task with no flops is
IO-bound; otherwise arithmetic intensity (flops / hbm_byte) above
``MACHINE_BALANCE`` is compute-bound, below is memory-bound. Both compute-
and memory-bound classes want the accelerator tier (HBM bandwidth lives
there too); IO-bound stages want the cheap tier. The class maps to a
*steering capability tag* (``ACCEL_CAP`` / ``CHEAP_IO_CAP``): clusters
advertise the tags in their capability profiles, and because queue names ARE
capability sets (``scheduler.queue_for``), appending the steering tag to a
task's requires routes it — through the existing broker queues, dispatcher
depth-aware placement, and autoscaler families — with no new wire protocol.

This module is import-light on purpose (no torch): the scheduler, dispatcher
and autoscaler price tasks on the control-plane hot path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# Steering capability tags clusters advertise in their profiles.
ACCEL_CAP = "accel"          # accelerator tier: high flops + HBM bandwidth
CHEAP_IO_CAP = "cheap-io"    # cheap tier: storage/network heavy, few flops

#: cost class -> capability tag of the tier that should host it
CLASS_CAPS = {"compute": ACCEL_CAP, "memory": ACCEL_CAP, "io": CHEAP_IO_CAP}

# Arithmetic-intensity split (flops per HBM byte) between the tiers: the
# machine balance of the CHEAP tier — work denser than this gains from the
# accelerator tier, sparser work is bandwidth/IO and gains nothing there.
MACHINE_BALANCE = 8.0

# Analytic-estimate conventions (documented in benchmarks/README.md):
# per optimizer step each parameter moves ~20 bytes of HBM traffic
# (bf16 weights+grads read/write + f32 m/v read/write), and a sync-mode
# data-parallel step all-reduces one bf16 gradient copy both ways.
HBM_BYTES_PER_PARAM_STEP = 20.0
COLLECTIVE_BYTES_PER_PARAM_STEP = 4.0


@dataclasses.dataclass(frozen=True)
class CostVector:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    io_bytes: float = 0.0

    @property
    def intensity(self) -> float:
        """Arithmetic intensity in flops per HBM byte."""
        return self.flops / max(self.hbm_bytes, 1.0)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def classify(cv: CostVector) -> str:
    """Roofline class of one task execution: compute | memory | io."""
    if cv.flops <= 0.0:
        return "io"
    return "compute" if cv.intensity >= MACHINE_BALANCE else "memory"


def steering_cap(cost_class: str) -> Optional[str]:
    """Capability tag of the tier that should host ``cost_class`` work."""
    return CLASS_CAPS.get(cost_class)


def _vector_from_artifact(artifact: dict) -> CostVector:
    """Lift a dry-run artifact (``stats_to_json`` payload or an explicit
    ``Task.cost`` dict) into a CostVector; unknown keys are ignored."""
    return CostVector(
        flops=float(artifact.get("flops", 0.0)),
        hbm_bytes=float(artifact.get("hbm_bytes", 0.0)),
        collective_bytes=float(artifact.get("collective_bytes", 0.0)),
        io_bytes=float(artifact.get("io_bytes", 0.0)))


def _shape_of(payload: dict) -> tuple:
    """(seq_len, global_batch) from the payload, resolving a named
    ``configs.shapes`` entry when given (the dry-run shape registry)."""
    seq_len = payload.get("seq_len")
    batch = payload.get("global_batch")
    name = payload.get("shape")
    if name and (seq_len is None or batch is None):
        from repro_torch.configs.shapes import SHAPES   # lazy: off the control path
        spec = SHAPES.get(name)
        if spec is not None:
            seq_len = seq_len if seq_len is not None else spec.seq_len
            batch = batch if batch is not None else spec.global_batch
    return int(seq_len or 64), int(batch or 8)


def _param_count(payload: dict) -> float:
    from repro_torch.configs import base as configs
    cfg = configs.get(payload.get("arch", "qwen3-0.6b"))
    if payload.get("reduced", True):
        cfg = cfg.reduced()
    return float(cfg.param_count())


def _estimate(kind: str, payload: dict) -> Optional[CostVector]:
    """Analytic cost estimate for the built-in task kinds (None: unpriced)."""
    if kind in ("train", "eval"):
        n = _param_count(payload)
        seq_len, batch = _shape_of(payload)
        if kind == "train":
            steps = int(payload.get("steps", 50))
            tokens = float(steps) * batch * seq_len
            sync = payload.get("mode", "sync") == "sync"
            return CostVector(
                flops=6.0 * n * tokens,
                hbm_bytes=steps * n * HBM_BYTES_PER_PARAM_STEP,
                collective_bytes=(steps * n * COLLECTIVE_BYTES_PER_PARAM_STEP
                                  if sync else n))
        tokens = float(batch) * seq_len          # eval: one forward batch
        return CostVector(flops=2.0 * n * tokens,
                          hbm_bytes=n * HBM_BYTES_PER_PARAM_STEP)
    if kind == "serve":
        n = _param_count(payload)
        slots = int(payload.get("slots", 4))
        new = int(payload.get("max_new", 16)) * max(
            int(payload.get("n_requests", slots)), 1)
        # decode reads the full weight set per generated token position:
        # intensity ≈ batch slots, the canonical memory-bound regime
        return CostVector(flops=2.0 * n * new * slots,
                          hbm_bytes=2.0 * n * new)
    if kind == "etl":
        seq_len, batch = _shape_of(payload)
        rows = int(payload.get("batches", 2)) * batch * seq_len
        return CostVector(io_bytes=4.0 * rows)
    if kind == "export":
        return CostVector(io_bytes=2.0 * _param_count(payload))
    return None


def task_cost(task) -> Optional[CostVector]:
    """Price a pipeline ``Task`` (duck-typed: needs .kind/.payload and an
    optional .cost). None means "no cost signal" — never steered."""
    explicit = getattr(task, "cost", None)
    if explicit:
        return _vector_from_artifact(explicit)
    payload = task.payload or {}
    if isinstance(payload.get("hlo_stats"), dict):
        return _vector_from_artifact(payload["hlo_stats"])
    try:
        return _estimate(task.kind, payload)
    except KeyError:                      # unknown arch: unpriced, unsteered
        return None


def steering_tag(task) -> Optional[str]:
    """The steering capability tag for a task, or None when it has no cost
    signal (cost-aware routing must be a no-op for unpriced tasks)."""
    cv = task_cost(task)
    if cv is None:
        return None
    return steering_cap(classify(cv))
