"""Step-level telemetry: rates, EMAs, and the straggler-detector feed (a copy of
``repro.runtime.telemetry``, which is pure Python; the port keeps its own).

The control agent heartbeats these numbers to the overwatch (`/telemetry/...`,
`/jobs/.../status.rate`); the dispatcher's straggler check compares job rates
against the fleet median — so everything here must be cheap and monotone.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass
class StepTimer:
    """EMA of step wall time + derived tokens/s. Pure-python, checkpoint-free."""
    tokens_per_step: int = 0
    alpha: float = 0.1
    ema_s: Optional[float] = None
    last_t: Optional[float] = None
    steps: int = 0

    def tick(self, now: Optional[float] = None) -> Optional[float]:
        now = time.monotonic() if now is None else now
        dt = None
        if self.last_t is not None:
            dt = now - self.last_t
            self.ema_s = dt if self.ema_s is None else (
                (1 - self.alpha) * self.ema_s + self.alpha * dt)
        self.last_t = now
        self.steps += 1
        return dt

    @property
    def steps_per_s(self) -> float:
        return 1.0 / self.ema_s if self.ema_s else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_per_step * self.steps_per_s

    def snapshot(self) -> dict:
        return {"steps": self.steps, "ema_step_s": self.ema_s,
                "steps_per_s": self.steps_per_s,
                "tokens_per_s": self.tokens_per_s}


@dataclasses.dataclass
class MetricsLog:
    """Bounded in-memory metrics ring (examples/tests read loss curves off it).

    The ring is a ``deque(maxlen=capacity)``: append past capacity evicts the
    oldest row in O(1) instead of the old list's O(n) front-slice on every
    overflowing append."""
    capacity: int = 4096
    rows: Deque = None

    def __post_init__(self):
        # maxlen depends on the capacity field, so it can't be a field default
        self.rows = deque(self.rows or (), maxlen=self.capacity)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                pass
        self.rows.append(row)

    def latest(self) -> Optional[dict]:
        return self.rows[-1] if self.rows else None

    def series(self, key: str) -> List[float]:
        return [r[key] for r in self.rows if key in r]
