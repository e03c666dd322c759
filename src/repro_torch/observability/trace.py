"""Copy of ``repro.observability.trace`` under ``repro_torch``.

Distributed tracing for the hybrid plane (the flight recorder's first half).

The paper's global management plane exists to answer management questions
about pipelines running across clusters; the most basic one — *where did this
task's latency go?* — needs a causally-linked record of every lifecycle stage
a task instance passes through. This module provides it:

  * ``TraceContext`` — the compact ``"trace_id|span_id"`` string that rides
    inside message payloads (broker task messages, dispatch envelopes) under
    the ``TRACE_KEY`` field. The fabric propagates it across gateway relays
    and channel hops (``Fabric.current_trace``), so a handler many hops from
    the sender can still parent its spans correctly. One flat string — not a
    nested pair — so the fabric's byte accounting prices it with a single
    memoized lookup instead of a container walk, and child spans store the
    parent context verbatim (no parsing on the record path). Trace ids must
    not contain ``"|"``.
  * ``Span`` — one timed segment on the simulated fabric clock, with a
    component label, a status, and free-form attrs (wall-clock facts like a
    train step's EMA ride in as attrs, so reports mix both).
  * ``Tracer`` — the shared span recorder plus the keyed-open map that lets a
    span OPEN in one component and CLOSE in another (a queue span opens at
    broker push and closes at pull; a task's root span opens at scheduling
    and closes when the scheduler observes the terminal taskdb row).

Hot-path design: a recorded span is ONE tuple in a flat event log, and the
API is shaped so batch sites never pay a Python call per span:

  * ``rec`` — the log's raw bound ``append``. The two hottest loops (the
    scheduler's flush of staged schedule spans, the worker's post-ack sweep
    recording execute/commit pairs) build event tuples in place and append
    them directly; ``bound()`` afterwards enforces the log cap. Leaf events
    carry ``sid None`` — nothing ever parents under them, so span ids are
    assigned lazily at read time instead of costing a counter bump each.
  * ``open_keyed_many`` / ``close_keyed_many`` — the broker opens one batch
    of queue-wait spans per ``push_many`` and closes one batch per
    ``pull_many``, one clock read and one call for the whole batch.
  * every record call takes optional ``t0``/``t1`` so remaining loops read
    the simulated clock ONCE (within one tick the readings are identical
    anyway); parent contexts are stored verbatim and parsed only when
    ``Span`` objects are materialized for a reader.

The first cut kept live per-span objects, per-span clock reads, and a
nested-list wire context, and cost 1.7x on a pure control-plane workload;
this layout is gated at <= 1.05x by ``benchmarks/observability.py``, cheap
enough to leave sampling on.

Honesty note: trace *context* genuinely crosses the fabric inside
byte-accounted envelopes — sampling on/off changes the wire bytes and the
benchmarks price it. The event log is a shared in-process object (the
simulated stand-in for each component reporting spans to a collector);
nothing reads another component's spans on any hot path.

Crash semantics (the part production tracers get wrong): spans owned by
master-hosted components (scheduler/broker) are TRUNCATED at recovery —
recorded with ``status="truncated"`` at the recovery clock — never leaked
open and never double-closed; a task's root span survives the crash and
still closes when the task eventually commits. The accounting identity

    stats["opened"] == stats["closed"] + stats["truncated"] + open_count

holds at every instant and is gated (with ``stats["double_close"] == 0``)
by ``benchmarks/observability.py`` across an injected crash-restart.

Sampling is deterministic, so two runs of the same workload sample the same
task sets: the scheduler (the head-of-trace decision point) traces every
``round(1/sample)``-th staged task — one int op on the unsampled hot path —
while id-keyed call sites (dispatcher jobs) use ``Tracer.sampled`` (crc32 of
the trace id). ``sample=0`` records nothing and — because instrumented
sites only attach ``TRACE_KEY`` to sampled messages — leaves every fabric
payload byte-identical to an uninstrumented plane.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Sequence

# the payload field a trace context rides under; absent => untraced message
# (repro_torch.core.transport reads the same literal on its delivery fast path)
TRACE_KEY = "trace"

TraceContext = str  # "trace_id|span_id" — one flat string on the wire

#: The recommended production sampling rate: the overhead-control knob every
#: production tracer ships (Dapper samples 1/1024; we can afford far more
#: because recording is a tuple append). Deterministic sampling (stride at
#: the scheduler, crc32 for id-keyed sites) means the same tenth of the
#: task population is fully traced on every run.
#: ``benchmarks/observability.py`` gates the plane at this rate at <= 1.05x
#: an untraced plane on an instant-handler DAG — the harshest denominator,
#: pure control-plane work — and reports the full-sampling (``sample=1.0``,
#: what the tests pin for exact span accounting) ratio alongside it.
DEFAULT_SAMPLE = 0.1


class Span:
    """One timed segment of a trace, materialized from the event log on
    read. ``start``/``end`` are simulated fabric clock (deterministic, what
    the benchmarks gate); host-time facts arrive as attrs (``wall_s``,
    ``step_ema_s``)."""

    __slots__ = ("span_id", "trace_id", "parent_id", "name", "component",
                 "start", "end", "status", "attrs")

    def __init__(self, span_id, trace_id, parent_id, name, component,
                 start, end, status, attrs):
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.name = name
        self.component = component
        self.start = start
        self.end = end
        self.status = status
        self.attrs = attrs

    def ctx(self) -> TraceContext:
        """The wire form children parent under: ``"trace_id|span_id"``."""
        return f"{self.trace_id}|{self.span_id}"

    @property
    def open(self) -> bool:
        return self.end is None

    def duration(self) -> float:
        return 0.0 if self.end is None else self.end - self.start

    def __repr__(self) -> str:                              # pragma: no cover
        return (f"Span({self.span_id}, {self.trace_id!r}, {self.name!r}, "
                f"{self.status!r})")


class Tracer:
    """Flat-event-log span recorder + keyed-open map + deterministic sampler.

    One ``Tracer`` serves a whole plane (master components, agents, workers
    share it — see the module docstring's honesty note). Recorded (closed)
    spans are tuples ``(sid, origin, name, component, start, end, status,
    attrs)`` in ``_log``, where ``origin`` is the PARENT's wire context
    string stored verbatim (or the bare trace id for roots) and ``sid`` is
    ``None`` for leaf events appended via ``rec`` (span ids for those are
    assigned lazily at read time — nothing parents under a leaf). Spans
    still open live in ``_pending`` (opened by context, e.g. dispatch legs)
    or ``_keyed`` (opened under a cross-component key, e.g. task roots and
    queue waits). The log is bounded: past ``max_events`` the oldest
    fully-closed traces are compacted away (events dropped, the accounting
    counters kept), so a long-running plane never grows without bound while
    open spans are never lost.
    """

    def __init__(self, clock_fn=None, sample: float = 1.0,
                 max_events: int = 200_000):
        self.clock = clock_fn or (lambda: 0.0)
        self.sample = float(sample)
        self.max_events = max_events
        # (sid_or_None, origin, name, component, t0, t1, status, attrs)
        self._log: List[tuple] = []
        #: raw event append — THE fast path. Batch sites build event tuples
        #: in place (sid ``None``), append through this bound method, then
        #: call ``bound()`` once per batch. Layout is the ``_log`` tuple.
        self.rec = self._log.append
        self._n = 0                  # sids allocated (ctx-opened + keyed)
        # sid -> (origin, name, component, t0, attrs)         [ctx-opened]
        self._pending: Dict[int, tuple] = {}
        # key -> (origin, name, component, t0, attrs, sid, ctx) [key-opened]
        self._keyed: Dict[tuple, tuple] = {}
        self._truncated = 0
        self._double = 0
        self._evicted = 0
        # compacted-away event counts, by event class
        self._dropped_leaf = 0
        self._dropped_closed = 0
        self._dropped_trunc = 0

    # ------------------------------------------------------------- sampling
    def sampled(self, trace_id: str) -> bool:
        """Deterministic per-trace sampling decision (crc32 of the id):
        identical across runs, processes, and components — every site that
        asks about the same task gets the same answer."""
        s = self.sample
        if s >= 1.0:
            return True
        if s <= 0.0:
            return False
        return (zlib.crc32(trace_id.encode()) % 100_000) < int(s * 100_000)

    # ------------------------------------------------------------- hot path
    def bound(self) -> None:
        """Enforce the log cap — batch sites call this once after a loop of
        raw ``rec`` appends (keyed/complete methods call it themselves)."""
        if len(self._log) >= self.max_events:
            self._compact()

    def span_complete(self, parent: str, name: str, component: str,
                      t0: float, status: str = "ok",
                      attrs: Optional[dict] = None,
                      t1: Optional[float] = None) -> None:
        """Record one finished leaf span — the caller captured ``t0``
        (``tracer.clock()``) before the work and knows the outcome after.
        The parent context string is stored verbatim, never parsed here.
        Loops hotter than one call per span use ``rec`` directly."""
        self.rec((None, parent, name, component, t0,
                  self.clock() if t1 is None else t1, status, attrs))
        if len(self._log) >= self.max_events:
            self._compact()

    def open_span(self, name: str, component: str,
                  parent: Optional[str] = None,
                  trace_id: Optional[str] = None,
                  attrs: Optional[dict] = None,
                  t0: Optional[float] = None) -> TraceContext:
        """Open a span whose close happens elsewhere (possibly in another
        component); returns the wire context children parent under."""
        if parent is not None:
            origin = parent
            tid = parent[:parent.rindex("|")]
        else:
            if trace_id is None:
                raise ValueError("root span needs an explicit trace_id")
            tid = origin = trace_id
        n = self._n + 1
        self._n = n
        self._pending[n] = (origin, name, component,
                            self.clock() if t0 is None else t0, attrs)
        return f"{tid}|{n}"

    def end_span(self, ctx: str, status: str = "ok",
                 attrs: Optional[dict] = None,
                 t1: Optional[float] = None) -> Optional[int]:
        """Close a span by its context (first close wins; a second close is
        counted in ``stats["double_close"]`` and records nothing)."""
        sid = int(ctx[ctx.rindex("|") + 1:])
        p = self._pending.pop(sid, None)
        if p is None:
            self._double += 1
            return None
        a = p[4]
        if attrs:
            a = {**(a or {}), **attrs}
        self.rec((sid, p[0], p[1], p[2], p[3],
                  self.clock() if t1 is None else t1, status, a))
        if len(self._log) >= self.max_events:
            self._compact()
        return sid

    # ------------------------------------------------- cross-component opens
    def open_keyed(self, key: tuple, name: str, component: str,
                   parent: Optional[str] = None,
                   trace_id: Optional[str] = None,
                   attrs: Optional[dict] = None,
                   t0: Optional[float] = None) -> TraceContext:
        """Open a span another component will close by ``key``. If an open
        span already holds the key its context is returned unchanged (a
        retry re-stage reuses the task's root instead of forking a
        duplicate)."""
        rec = self._keyed.get(key)
        if rec is not None:
            return rec[6]
        if parent is not None:
            origin = parent
            tid = parent[:parent.rindex("|")]
        else:
            if trace_id is None:
                raise ValueError("root span needs an explicit trace_id")
            tid = origin = trace_id
        n = self._n + 1
        self._n = n
        ctx = f"{tid}|{n}"
        self._keyed[key] = (origin, name, component,
                            self.clock() if t0 is None else t0,
                            attrs, n, ctx)
        return ctx

    def open_keyed_many(self, items: Sequence[tuple], name: str,
                        component: str, t0: float) -> None:
        """Batch ``open_keyed`` — one call and one clock reading for a whole
        broker push batch. ``items`` are ``(key, parent_ctx, attrs)``; keys
        already open are left untouched (requeue reuses the open span). No
        contexts are returned: queue-wait spans never go on the wire."""
        kd = self._keyed
        n = self._n
        for key, parent, attrs in items:
            if key in kd:
                continue
            n += 1
            kd[key] = (parent, name, component, t0, attrs, n, None)
        self._n = n

    def close_keyed(self, key: tuple, status: str = "ok",
                    attrs: Optional[dict] = None,
                    t1: Optional[float] = None) -> Optional[int]:
        """Close the span registered under ``key``; ``None`` (and no effect)
        when no open span holds it — a crash-truncated key, an unsampled
        task, or a stage that already closed it: all silently fine, which is
        what makes close sites safe to call unconditionally."""
        p = self._keyed.pop(key, None)
        if p is None:
            return None
        a = p[4]
        if attrs:
            a = {**(a or {}), **attrs}
        sid = p[5]
        self.rec((sid, p[0], p[1], p[2], p[3],
                  self.clock() if t1 is None else t1, status, a))
        if len(self._log) >= self.max_events:
            self._compact()
        return sid

    def close_keyed_many(self, keys: Sequence[tuple], t1: float,
                         status: str = "ok") -> None:
        """Batch ``close_keyed`` — one call for a whole broker pull batch;
        unknown keys are skipped (same contract as ``close_keyed``)."""
        kd = self._keyed
        rec = self.rec
        for key in keys:
            p = kd.pop(key, None)
            if p is not None:
                rec((p[5], p[0], p[1], p[2], p[3], t1, status, p[4]))
        if len(self._log) >= self.max_events:
            self._compact()

    def ctx_for(self, key: tuple) -> Optional[TraceContext]:
        """Wire context of the open span under ``key`` (crash recovery uses
        this to re-attach reseeded messages to their surviving root);
        ``None`` for unknown keys and for batch-opened spans, which carry no
        context by design."""
        p = self._keyed.get(key)
        return p[6] if p is not None else None

    # ------------------------------------------------------ crash truncation
    def truncate_open(self, components: Optional[Sequence[str]] = None
                      ) -> int:
        """Record every open span owned by ``components`` (all when
        ``None``) with ``status="truncated"`` at the current clock — the
        crash-recovery contract: a master-hosted component's open spans died
        with it, so they are cut cleanly at the recovery epoch instead of
        leaking open (or being double-closed by a post-recovery pull that
        re-walks the same message). Truncated keys are dropped so recovery
        re-opens fresh spans under the same keys."""
        comp = None if components is None else set(components)
        now = self.clock()
        n = 0
        for sid in sorted(self._pending):
            p = self._pending[sid]
            if comp is not None and p[2] not in comp:
                continue
            del self._pending[sid]
            self.rec((sid, p[0], p[1], p[2], p[3], now, "truncated", p[4]))
            self._truncated += 1
            n += 1
        for key in sorted(self._keyed, key=repr):
            p = self._keyed[key]
            if comp is not None and p[2] not in comp:
                continue
            del self._keyed[key]
            self.rec((p[5], p[0], p[1], p[2], p[3], now, "truncated", p[4]))
            self._truncated += 1
            n += 1
        if len(self._log) >= self.max_events:
            self._compact()
        return n

    # ----------------------------------------------------------- observation
    @property
    def open_count(self) -> int:
        return len(self._pending) + len(self._keyed)

    @property
    def stats(self) -> Dict[str, int]:
        """Accounting counters (also a metrics-registry source): every
        span — counter-allocated or leaf-recorded — is exactly one of
        closed, truncated, or open."""
        leaf_in_log = sum(1 for ev in self._log if ev[0] is None)
        trunc_in_log = self._truncated - self._dropped_trunc
        leaf = leaf_in_log + self._dropped_leaf
        sid_closed = (len(self._log) - leaf_in_log - trunc_in_log
                      + self._dropped_closed)
        return {"opened": self._n + leaf, "closed": leaf + sid_closed,
                "truncated": self._truncated, "double_close": self._double,
                "evicted_traces": self._evicted}

    def accounting_ok(self) -> bool:
        """The gated invariant: every opened span is exactly one of closed,
        truncated, or still open — nothing lost, nothing counted twice.
        (Leaf events are closed by construction, so the identity reduces to
        the counter-allocated spans.)"""
        s = self.stats
        return (s["opened"] == s["closed"] + s["truncated"] + self.open_count
                and self._double == 0)

    @staticmethod
    def _parse_origin(origin: str):
        """``origin`` -> ``(trace_id, parent_sid_or_None)`` — the only place
        wire contexts are ever parsed."""
        tid, sep, ps = origin.rpartition("|")
        if not sep:
            return origin, None            # bare trace id: a root
        return tid, int(ps)

    def _materialize(self) -> Dict[int, Span]:
        out: Dict[int, Span] = {}
        leaf_id = self._n               # read-time ids for sid-less leaves
        for ev in self._log:
            sid = ev[0]
            if sid is None:
                leaf_id += 1
                sid = leaf_id
            tid, psid = self._parse_origin(ev[1])
            out[sid] = Span(sid, tid, psid, ev[2], ev[3], ev[4],
                            ev[5], ev[6], dict(ev[7] or {}))
        for sid in sorted(self._pending):
            p = self._pending[sid]
            tid, psid = self._parse_origin(p[0])
            out[sid] = Span(sid, tid, psid, p[1], p[2], p[3], None,
                            "open", dict(p[4] or {}))
        for p in self._keyed.values():
            tid, psid = self._parse_origin(p[0])
            out[p[5]] = Span(p[5], tid, psid, p[1], p[2], p[3], None,
                             "open", dict(p[4] or {}))
        return out

    @property
    def spans(self) -> Dict[int, Span]:
        """Materialized ``{span_id: Span}`` view (closed + still-open)."""
        return self._materialize()

    def trace(self, trace_id: str) -> List[Span]:
        return [s for s in self._materialize().values()
                if s.trace_id == trace_id]

    def trace_ids(self) -> List[str]:
        seen = dict.fromkeys(
            ev[1].rpartition("|")[0] or ev[1] for ev in self._log)
        for p in self._pending.values():
            seen.setdefault(p[0].rpartition("|")[0] or p[0], None)
        for p in self._keyed.values():
            seen.setdefault(p[0].rpartition("|")[0] or p[0], None)
        return list(seen)

    # ------------------------------------------------------------ compaction
    def _compact(self) -> None:
        """Bound the log: drop events of traces that are fully closed and
        not among the newest half, keeping the accounting counters exact."""
        def tid_of(origin: str) -> str:
            return origin.rpartition("|")[0] or origin

        keep_tids = {tid_of(p[0]) for p in self._pending.values()}
        keep_tids.update(tid_of(p[0]) for p in self._keyed.values())
        keep_tids.update(tid_of(ev[1])
                         for ev in self._log[len(self._log) // 2:])
        kept: List[tuple] = []
        dropped_tids = set()
        for ev in self._log:
            tid = tid_of(ev[1])
            if tid in keep_tids:
                kept.append(ev)
            else:
                if ev[0] is None:
                    self._dropped_leaf += 1
                elif ev[6] == "truncated":
                    self._dropped_trunc += 1
                else:
                    self._dropped_closed += 1
                dropped_tids.add(tid)
        self._evicted += len(dropped_tids)
        self._log = kept
        self.rec = self._log.append


# ----------------------------------------------------- critical-path analysis
def critical_path(tracer: Tracer, trace_id: str) -> Optional[dict]:
    """Reconstruct one trace's tree and account its latency by segment.

    Returns ``{"trace_id", "total", "status", "segments", "dominant",
    "path", "spans"}`` where ``segments`` sums duration per span NAME across
    the tree (for a task trace: schedule / queue / execute / commit — the
    placement, queue-wait, execution, and commit segments), ``dominant`` is
    the largest, and ``path`` is the greedy longest-child walk from the
    root. Durations are simulated-clock; host-time facts (``wall_s``,
    ``step_ema_s``) live in each span's attrs.
    """
    spans = tracer.trace(trace_id)
    if not spans:
        return None
    by_id = {s.span_id: s for s in spans}
    children: Dict[Optional[int], List[Span]] = {}
    roots: List[Span] = []
    for s in spans:
        if s.parent_id in by_id:
            children.setdefault(s.parent_id, []).append(s)
        else:
            roots.append(s)
    root = min(roots, key=lambda s: (s.start, s.span_id))
    segments: Dict[str, float] = {}
    for s in spans:
        if s is root:
            continue
        segments[s.name] = segments.get(s.name, 0.0) + s.duration()
    dominant = max(segments, key=segments.get) if segments else root.name
    path, node = [root.name], root
    while True:
        kids = children.get(node.span_id)
        if not kids:
            break
        node = max(kids, key=lambda s: (s.duration(), s.span_id))
        path.append(node.name)
    return {"trace_id": trace_id, "total": root.duration(),
            "status": root.status, "segments": segments,
            "dominant": dominant, "path": path, "spans": len(spans)}


def trace_report(tracer: Tracer, top_n: int = 10) -> List[dict]:
    """The top-N slowest completed traces (by simulated root duration), each
    with its critical-path breakdown — what ``make trace-report`` renders."""
    roots = [s for s in tracer.spans.values()
             if s.parent_id is None and s.end is not None]
    roots.sort(key=lambda s: (-s.duration(), s.trace_id))
    seen: set = set()
    out = []
    for s in roots:
        if s.trace_id in seen:
            continue
        seen.add(s.trace_id)
        cp = critical_path(tracer, s.trace_id)
        if cp is not None:
            out.append(cp)
        if len(out) >= top_n:
            break
    return out


def format_trace_report(tracer: Tracer, top_n: int = 10) -> str:
    rows = trace_report(tracer, top_n=top_n)
    if not rows:
        return "no completed traces"
    width = max(len(r["trace_id"]) for r in rows)
    lines = [f"{'trace':<{width}}  {'clock':>8}  {'dominant':<10}  segments",
             "-" * (width + 60)]
    for r in rows:
        segs = "  ".join(f"{n}={d:g}" for n, d in sorted(
            r["segments"].items(), key=lambda kv: -kv[1]))
        lines.append(f"{r['trace_id']:<{width}}  {r['total']:>8g}  "
                     f"{r['dominant']:<10}  {segs}")
    return "\n".join(lines)
