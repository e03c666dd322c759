"""Copy of ``repro.observability`` under ``repro_torch``.

Observability layer for the hybrid management plane.

The paper's global management plane "radically simplifies managing big data
applications" only if it can *see* them: this package is the plane-wide
flight recorder. ``trace`` carries a ``TraceContext`` across fabric hops and
gateway relays so a task's lifecycle (submit → dispatch → schedule → queue →
execute → commit) reconstructs as one tree with a critical-path breakdown;
``metrics`` unifies every component's ad-hoc stats behind stable dotted
names and per-queue-family service-time histograms, exported over the PR 7
replica delta feed at zero cross-boundary read cost.
"""
from .metrics import Histogram, MetricsRegistry
from .trace import (TRACE_KEY, Span, TraceContext, Tracer, critical_path,
                    format_trace_report, trace_report)

__all__ = ["TRACE_KEY", "Span", "TraceContext", "Tracer", "critical_path",
           "trace_report", "format_trace_report", "Histogram",
           "MetricsRegistry"]
