"""repro_torch.obs — unified telemetry: metrics registry + cross-tier tracing.

Stdlib-only (no torch, no other repro_torch imports), so every tier can depend
on it without layering cycles. Two halves behind one kill-switch:

    client ──POST /batch──────────────▶ StatsRouter        (root span)
                                          │  traceparent: header + wire
                                          │                 frame section
                  ┌───────────────────────┴──────────────┐
                  ▼                                      ▼
            replica A  (replica.sub_batch)         replica B
                  │                                      │
            StatsService.batch (service.superpack)       │
                  │                                      │
            EstimationEngine  (engine.pack → engine.dispatch → engine.d2h)
                  │
          spans close bottom-up → each lands in the bounded finished-span
          ring → grouped per trace at GET /debug/traces?limit=N (JSON trees)

    Counters / gauges / histograms land in the process-global
    `MetricsRegistry`; pre-existing stats objects (`ServiceStats`,
    `IngestStats`, `CatalogStats`, `PoolStats`) are registered as
    weakref VIEWS read at scrape time — single source of truth, no
    double counting → GET /metrics (Prometheus text exposition).
    The router re-emits each remote replica's scrape under a
    `replica="<name>"` label next to its own series.

Telemetry is NEUTRAL by contract: nothing here enters `cache_key`,
`cache_token`, or ETag derivation — estimate bytes and ETags are
byte-identical with telemetry on or off (`set_enabled(False)` turns
every increment and span into a no-op; `benchmarks/obs_overhead.py`
holds the warm-path overhead under 5%).

Estimation-quality observability rides the same registry. Every batch
the estimator runs also emits per-lane PROVENANCE (core/ndv: route
chosen + margin, detector margin, Newton iteration counts/residual,
clamps hit) — extra output lanes of the one shared program, so fused
and unfused twins produce identical diagnostics and nothing enters
cache identity:

    estimate_batch ──▶ BatchEstimates(+route, margins, iters, clamps)
         │ provenance_from_batch (estimator.py)
         ▼
    catalog.provenance_cache_store   ← the ONE funnel that records
         │                             ndv_route_total{route=},
         │                             ndv_newton_iters{solver=},
         │                             ndv_detector_margin
         ├─▶ ?explain=1 on /estimate and per-tuple in /batch
         │     (same ETag — explain never enters identity; wire frames
         │      carry it in a tagged section old peers skip)
         ├─▶ GET /debug/explain      (per-dataset cache dump; the
         │                            router aggregates per replica)
         └─▶ audit loop (service.py, opt-in): samples K columns per
               refresh generation, reference NDV from an HLL sketch
               over one row group (kernels/hll.py), q-error lands in
               ndv_audit_qerror{route=} and rides explain payloads

Metric naming conventions: every series is `ndv_<subsystem>_<noun>`
with unit suffixes per Prometheus style (`_total` counters, `_seconds`/
`_bytes` in the name, `_bucket`/`_sum`/`_count` for histograms). Labels
are low-cardinality enums only (route, solver, tier, status — never
column or dataset names on estimator series; the router adds
`replica="<name>"` when re-emitting remote scrapes).
"""
from repro_torch.obs import _state
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    WIDTH_BUCKETS,
    registry,
)
from repro_torch.obs.trace import (
    Span,
    TRACEPARENT_HEADER,
    TraceCollector,
    collector,
    current_span,
    current_traceparent,
    format_traceparent,
    parse_traceparent,
    root_span,
    span,
    trace_tree,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "Span",
    "TRACEPARENT_HEADER",
    "TraceCollector",
    "WIDTH_BUCKETS",
    "collector",
    "current_span",
    "current_traceparent",
    "enabled",
    "format_traceparent",
    "parse_traceparent",
    "registry",
    "root_span",
    "set_enabled",
    "span",
    "trace_tree",
]


def set_enabled(value: bool) -> None:
    """Flip the process-global telemetry switch (metrics AND spans)."""
    _state.enabled = bool(value)


def enabled() -> bool:
    return _state.enabled
