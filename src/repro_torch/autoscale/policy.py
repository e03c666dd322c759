"""Copy of ``repro.autoscale.policy`` under ``repro_torch``.

Per queue-family scaling policy: backlog -> desired replica count.

A *family* is one class of worker pod: the queues its workers consume, the
capability tags the pod itself carries, and the sizing envelope. The policy
is a pure function of (published ready backlog, current replicas) — all the
flap protection lives here, so the reconciler stays a mechanical diff loop:

  * ``target_depth_per_worker`` — the ready backlog one worker is sized to
    absorb; the raw desired count is ``ceil(backlog / target)``.
  * ``min_replicas`` / ``max_replicas`` — hard clamp (``min_replicas=0``
    enables scale-to-zero).
  * ``scale_up_step`` / ``scale_down_step`` — at most this many replicas
    added/retired per reconcile pass, so one burst never slews the fleet
    instantaneously.
  * ``up_threshold`` / ``down_threshold`` — the hysteresis band, expressed
    as multiples of the per-worker target: the fleet grows only once the
    per-worker backlog exceeds ``target * up_threshold`` and shrinks only
    once it falls below ``target * down_threshold``. Between the two bands
    the current size is sticky, so a backlog hovering near the target never
    flaps the fleet.
  * ``up_cooldown`` / ``down_cooldown`` — minimum fabric-clock spacing
    between consecutive scaling actions in each direction (enforced by the
    reconciler; a cold start from zero replicas bypasses the up-cooldown so
    a queue that just appeared is not left stranded).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ScalingPolicy:
    family: str
    queues: Tuple[str, ...] = ("default",)
    requires: Tuple[str, ...] = ()       # capability tags of the worker pod
    # roofline cost class this family serves (compute | memory | io): folds
    # the class's steering capability (repro_torch.roofline.cost.CLASS_CAPS) into
    # ``requires``, so the family's pods only land on — and its spawn jobs
    # carry the cost_class tag for — the matching cluster tier. None keeps
    # the family tier-agnostic (byte-identical to the pre-cost plane).
    cost_class: "str | None" = None
    target_depth_per_worker: float = 8.0
    min_replicas: int = 0
    max_replicas: int = 8
    scale_up_step: int = 4
    scale_down_step: int = 1
    up_threshold: float = 1.25
    down_threshold: float = 0.5
    up_cooldown: float = 1.0
    down_cooldown: float = 3.0

    def __post_init__(self):
        if self.cost_class is not None:
            from repro_torch.roofline.cost import steering_cap
            cap = steering_cap(self.cost_class)
            if cap is None:
                raise ValueError(f"family {self.family}: unknown cost class "
                                 f"{self.cost_class!r}")
            if cap not in self.requires:
                # frozen dataclass: fold the steering capability in here
                object.__setattr__(self, "requires", self.requires + (cap,))
        if not self.queues:
            raise ValueError(f"family {self.family}: needs at least one queue")
        if self.target_depth_per_worker <= 0:
            raise ValueError(f"family {self.family}: target depth must be > 0")
        if not (0 <= self.min_replicas <= self.max_replicas):
            raise ValueError(f"family {self.family}: need "
                             "0 <= min_replicas <= max_replicas")
        if self.scale_up_step < 1 or self.scale_down_step < 1:
            raise ValueError(f"family {self.family}: steps must be >= 1")
        if self.up_threshold < 1.0:
            raise ValueError(f"family {self.family}: up_threshold < 1 would "
                             "scale up below the per-worker target (flaps "
                             "against down_threshold)")
        if not 0.0 <= self.down_threshold <= 1.0:
            raise ValueError(f"family {self.family}: down_threshold must be "
                             "in [0, 1]")

    def desired_replicas(self, backlog: float, current: int) -> int:
        """The next fleet size for ``backlog`` ready tasks and ``current``
        live replicas — clamped, hysteresis-gated, and step-limited. The
        reconciler applies cooldowns on top."""
        target = self.target_depth_per_worker
        raw = math.ceil(backlog / target) if backlog > 0 else 0
        want = min(max(raw, self.min_replicas), self.max_replicas)
        if want > current:
            # up-hysteresis: an existing fleet only grows once the per-worker
            # backlog clears the upper band. It never gates the clamp edges:
            # a cold start (current == 0) has no per-worker backlog to
            # measure, and a fleet knocked below its min_replicas floor
            # (pods lost to a dead cluster) must recover regardless of how
            # quiet the backlog is — the floor is availability, not sizing.
            if (self.min_replicas <= current
                    and current > 0
                    and backlog <= current * target * self.up_threshold):
                return current
            return min(current + self.scale_up_step, want)
        if want < current:
            # an EMPTY backlog always permits shrinking (otherwise
            # down_threshold=0.0 — "only shrink when fully drained" — would
            # pin the fleet at its peak forever: 0 >= 0 holds)
            if backlog and backlog >= current * target * self.down_threshold:
                return current
            return max(current - self.scale_down_step, want)
        return current
