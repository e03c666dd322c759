"""Copy of ``repro.observability.metrics`` under ``repro_torch``.

Unified metrics for the hybrid plane (the flight recorder's second half).

Every component in the repo grew its own ad-hoc ``stats`` Counter/dict —
fabric byte ledgers, broker op counts, overwatch shard ops, replica watch
counters, autoscaler events, step-cache hit rates. They stay (cheap, and
tests read them), but management questions need one namespace and one
export path. ``MetricsRegistry`` provides both:

  * **Push primitives** — ``inc`` (counter), ``set_gauge``, ``observe``
    (bounded-bucket histogram with p50/p99 summaries, the per-queue-family
    service-time instrument the predictive autoscaler needs).
  * **Pull sources** — ``register_source(prefix, fn)`` adopts an existing
    legacy stats dict at zero hot-path cost: ``fn`` is only called at
    snapshot time, so components keep mutating their own Counters exactly
    as before and the registry reads them when someone asks.
  * **Stable dotted names** — ``snapshot()`` flattens everything to
    ``"broker.compute.ops.pushN"``-style keys; ``sections()`` groups by the
    first segment, which is the unit of export: each agent publishes one
    overwatch key ``/metrics/<cluster>/<section>`` per *changed* section
    per heartbeat, and those keys ride the PR 7 one-envelope-per-sweep
    replica delta feed — fleet-wide scrape via ``range_stale("/metrics/")``
    costs zero cross-boundary bytes (the paper's management plane monitors
    every cluster without a per-scrape RPC storm).

Histogram buckets are log-spaced over [1e-6 s, 1e3 s] (fixed count, so a
histogram's memory is bounded regardless of sample count); quantiles are
bucket-upper-edge estimates clamped to the observed [min, max].
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional

# log-spaced bucket upper bounds: 1e-6 .. 1e3 seconds, 4 buckets per decade
_BOUNDS: List[float] = []
for _exp in range(-6, 3):
    for _frac in (1.0, 1.8, 3.2, 5.6):
        _BOUNDS.append(_frac * (10.0 ** _exp))
_BOUNDS.append(10.0 ** 3)


class Histogram:
    """Bounded-bucket histogram: O(len(_BOUNDS)) memory forever, O(log n)
    per observe, p50/p99 from bucket edges (exact min/max kept)."""

    __slots__ = ("counts", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.counts = [0] * (len(_BOUNDS) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, value: float) -> None:
        lo, hi = 0, len(_BOUNDS)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= _BOUNDS[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.total += value
        if self.vmin is None or value < self.vmin:
            self.vmin = value
        if self.vmax is None or value > self.vmax:
            self.vmax = value

    def quantile(self, q: float) -> Optional[float]:
        if not self.count:
            return None
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                edge = _BOUNDS[i] if i < len(_BOUNDS) else self.vmax
                return min(max(edge, self.vmin), self.vmax)
        return self.vmax

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count,
                "min": self.vmin, "max": self.vmax,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99)}


class MetricsRegistry:
    """One cluster-local namespace over counters, gauges, histograms, and
    adopted legacy stats dicts. See the module docstring for the naming and
    export contract."""

    def __init__(self, cluster: str = ""):
        self.cluster = cluster
        self.counters: Counter = Counter()
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self._sources: Dict[str, Callable[[], dict]] = {}
        self.source_errors: Counter = Counter()

    # ----------------------------------------------------------- push side
    def inc(self, name: str, value: float = 1) -> None:
        self.counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.observe(value)

    # ----------------------------------------------------------- pull side
    def register_source(self, prefix: str, fn: Callable[[], dict]) -> None:
        """Adopt a legacy stats dict: ``fn()`` is called at snapshot time
        and its flat numeric dict lands under ``<prefix>.<key>``. Re-using a
        prefix replaces the source (recovery re-registers freely)."""
        self._sources[prefix] = fn

    # --------------------------------------------------------------- export
    def snapshot(self) -> Dict[str, float]:
        """Flat ``dotted.name -> number`` view of everything, pulled fresh.
        A failing source is skipped and counted (a half-constructed
        component during recovery must not take the whole scrape down)."""
        out: Dict[str, float] = {}
        out.update(self.counters)
        out.update(self.gauges)
        for name, h in self.histograms.items():
            for k, v in h.summary().items():
                out[f"{name}.{k}"] = v
        for prefix, fn in self._sources.items():
            try:
                vals = fn()
            except Exception:
                self.source_errors[prefix] += 1
                continue
            for k, v in vals.items():
                out[f"{prefix}.{k}"] = v
        return out

    def sections(self) -> Dict[str, Dict[str, float]]:
        """``snapshot()`` grouped by first dotted segment — the unit an
        agent publishes (one overwatch key per changed section). Fresh
        dicts every call, so callers may keep them for ==-comparison."""
        out: Dict[str, Dict[str, float]] = {}
        for name, v in self.snapshot().items():
            section, _, rest = name.partition(".")
            out.setdefault(section, {})[rest or section] = v
        return out
