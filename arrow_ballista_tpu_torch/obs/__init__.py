"""Observability subsystem: distributed tracing, unified metrics, exports.

The staged shuffle architecture (scheduler → executor tasks → Flight fetch
→ TPU kernel) is a multi-process pipeline; this package makes it visible
end to end:

* :mod:`.trace` — span API (context manager + decorator, monotonic
  clocks, thread-local current span) with a trace/span id that propagates
  scheduler → executor → shuffle fetch over TaskDefinition fields and
  Flight metadata, so one job yields a single stitched trace;
* :mod:`.recorder` — bounded per-process ring buffer of finished spans
  plus the scheduler-side per-job trace store (executor spans ship
  piggybacked on task-status and heartbeat updates);
* :mod:`.registry` — unified counter/gauge/histogram registry backing
  ``/api/metrics`` and the Prometheus text-exposition endpoint;
* :mod:`.export` — Chrome-trace/Perfetto JSON and the EXPLAIN-ANALYZE
  style per-stage profile behind ``GET /api/jobs/{id}/trace`` and
  ``GET /api/jobs/{id}/profile``;
* :mod:`.telemetry` — per-executor resource sampler whose snapshots ride
  ``HeartBeatParams.telemetry_json`` to the scheduler;
* :mod:`.timeseries` — scheduler-side bounded downsampling series
  (per-executor + cluster aggregates) behind ``GET /api/cluster/health``
  and ``GET /api/cluster/timeseries``, plus per-session SLO tracking;
* :mod:`.events` — append-only size-rotated structured event journal
  (job/stage/task lifecycle, retries, speculation, quarantine, drain)
  behind ``GET /api/jobs/{id}/events`` and ``GET /api/events/tail``.

Tracing is gated by ``ballista.obs.enabled``; with it off the span API
is a near-zero-cost no-op (one module attribute read per call).  The
telemetry heartbeat piggyback is the one always-on piece; the journal
and SLO tracking are off until configured.
"""

from . import trace  # noqa: F401
from .recorder import get_recorder, trace_store  # noqa: F401
from .registry import MetricsRegistry, process_registry  # noqa: F401

__all__ = [
    "trace",
    "get_recorder",
    "trace_store",
    "MetricsRegistry",
    "process_registry",
]
