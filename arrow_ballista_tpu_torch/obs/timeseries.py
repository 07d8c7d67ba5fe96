"""Scheduler-side cluster telemetry: bounded time series + SLO tracking.

:class:`SeriesRing` — a bounded ring of ``(ts, value)`` points that
**downsamples instead of truncating**: when the ring fills, every second
point is dropped and the minimum spacing between kept points doubles, so
a fixed-size buffer covers an ever-longer window at decaying resolution
(the classic RRD trade, without the fixed archive schedule).

:class:`ClusterTelemetry` — routes executor heartbeat snapshots
(``HeartBeatParams.telemetry_json``, produced by ``obs/telemetry.py``)
into per-executor rings + a latest-snapshot map, records the scheduler's
own cluster aggregates (queue depth, running tasks, slots free), and
mirrors the latest per-executor values into the scheduler's
MetricsRegistry as labeled gauges so one Prometheus scrape carries both
planes.  Parsing is TOLERANT: old executors ship no payload, broken ones
may ship garbage — both must never take the heartbeat path down.

:class:`SloTracker` — per-session job-latency SLO
(``ballista.obs.slo.job_latency_seconds``): completed jobs feed a
``slo_breaches_total`` counter and a burn-rate gauge (breach fraction
over a sliding window).

Everything here is read by ``GET /api/cluster/health`` and
``GET /api/cluster/timeseries?metric=…`` (scheduler/api.py).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

DEFAULT_RING_POINTS = 360
# per-executor numeric keys mirrored into the registry as labeled gauges;
# anything else still rides the rings/latest map but not Prometheus
MIRRORED_GAUGES = {
    "cpu_percent": "executor process CPU percent (can exceed 100 on multicore)",
    "rss_bytes": "executor resident set size",
    "shuffle_disk_bytes": "bytes of shuffle data under the executor work dir",
    "fetch_queue_bytes": "fetched-but-unconsumed shuffle bytes staged in memory",
    "write_queue_bytes": "coalesced-but-unwritten shuffle write bytes queued",
    "replicator_backlog": "async replica uploads submitted but unfinished",
    "active_tasks": "tasks currently executing on the executor",
    "slots_total": "executor task-slot capacity",
}
MAX_SERIES_PER_EXECUTOR = 32


class SeriesRing:
    """Bounded, downsampling ``(ts, value)`` ring (thread-safe)."""

    def __init__(
        self, capacity: int = DEFAULT_RING_POINTS, min_interval_s: float = 0.0
    ):
        self.capacity = max(4, capacity)
        self.min_interval_s = min_interval_s
        self._points: List[List[float]] = []
        self._lock = threading.Lock()

    def add(self, ts: float, value: float) -> None:
        with self._lock:
            if (
                self._points
                and ts - self._points[-1][0] < self.min_interval_s
            ):
                # inside the current resolution: the newest value wins the
                # slot (the ring records state, not a sum)
                self._points[-1] = [ts, value]
                return
            self._points.append([ts, value])
            if len(self._points) >= self.capacity:
                # full: halve resolution, double the window headroom.
                # Keep the NEWEST point exactly (operators read the tail).
                self._points = self._points[(len(self._points) - 1) % 2 :: 2]
                self.min_interval_s = max(self.min_interval_s, 0.5) * 2

    def points(self) -> List[List[float]]:
        with self._lock:
            return [list(p) for p in self._points]

    def __len__(self) -> int:
        with self._lock:
            return len(self._points)


class ClusterTelemetry:
    def __init__(
        self,
        registry=None,
        ring_points: int = DEFAULT_RING_POINTS,
    ):
        self.registry = registry
        self.ring_points = ring_points
        self._lock = threading.Lock()
        self._per_executor: Dict[str, Dict[str, SeriesRing]] = {}
        self._latest: Dict[str, dict] = {}
        self._latest_mono: Dict[str, float] = {}
        self._cluster: Dict[str, SeriesRing] = {}
        self._parse_errors = None
        if registry is not None:
            self._parse_errors = registry.counter(
                "telemetry_parse_errors_total",
                "heartbeat telemetry payloads that failed to parse",
            )

    # ---------------------------------------------------------- executors
    def record_executor(self, executor_id: str, payload) -> bool:
        """Absorb one heartbeat snapshot.  ``payload`` is the raw
        ``telemetry_json`` bytes (or an already-parsed dict).  Returns
        True when something was recorded; malformed payloads from old or
        broken executors count a parse error and change nothing."""
        if not executor_id or not payload:
            return False
        snap = payload
        if isinstance(payload, (bytes, str)):
            try:
                snap = json.loads(payload)
            except Exception:  # noqa: BLE001 - garbage from the wire
                if self._parse_errors is not None:
                    self._parse_errors.inc()
                return False
        if not isinstance(snap, dict):
            if self._parse_errors is not None:
                self._parse_errors.inc()
            return False
        ts = snap.get("ts")
        if not isinstance(ts, (int, float)):
            ts = time.time()
        numeric = {
            k: v
            for k, v in snap.items()
            if k != "ts" and isinstance(v, (int, float))
            and not isinstance(v, bool)
        }
        with self._lock:
            # keep only the numeric view: downstream aggregation sums
            # latest-snapshot fields, so a string value smuggled in by a
            # broken executor must not survive past this point
            self._latest[executor_id] = {"ts": ts, **numeric}
            self._latest_mono[executor_id] = time.monotonic()
            rings = self._per_executor.setdefault(executor_id, {})
            for k, v in numeric.items():
                ring = rings.get(k)
                if ring is None:
                    if len(rings) >= MAX_SERIES_PER_EXECUTOR:
                        continue  # bounded: a hostile payload can't grow us
                    ring = rings[k] = SeriesRing(self.ring_points)
                ring.add(float(ts), float(v))
            # mirror under the same lock that forget_executor takes, so
            # an in-flight heartbeat can't re-register a removed
            # executor's labeled gauges after remove_by_label ran
            if self.registry is not None:
                for k, v in numeric.items():
                    help_ = MIRRORED_GAUGES.get(k)
                    if help_ is None:
                        continue
                    self.registry.gauge(
                        f"executor_{k}", help_, labels={"executor": executor_id}
                    ).set(v)
        return True

    def forget_executor(self, executor_id: str) -> None:
        """Drop a removed executor's series and labeled gauges (its
        latest snapshot would otherwise read as live forever)."""
        with self._lock:
            self._per_executor.pop(executor_id, None)
            self._latest.pop(executor_id, None)
            self._latest_mono.pop(executor_id, None)
            if self.registry is not None:
                self.registry.remove_by_label("executor", executor_id)

    # ------------------------------------------------------------ cluster
    def record_cluster(self, metrics: Dict[str, float], ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        with self._lock:
            for k, v in metrics.items():
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    continue
                ring = self._cluster.get(k)
                if ring is None:
                    ring = self._cluster[k] = SeriesRing(self.ring_points)
                ring.add(float(ts), float(v))

    # -------------------------------------------------------------- reads
    def latest(self) -> Dict[str, dict]:
        """{executor_id: {**snapshot, "age_s": seconds since receipt}}."""
        now = time.monotonic()
        with self._lock:
            return {
                eid: {**snap, "age_s": round(now - self._latest_mono[eid], 3)}
                for eid, snap in self._latest.items()
            }

    def series(
        self, metric: str, executor_id: Optional[str] = None
    ) -> Optional[List[List[float]]]:
        with self._lock:
            if executor_id:
                ring = self._per_executor.get(executor_id, {}).get(metric)
            else:
                ring = self._cluster.get(metric)
        return ring.points() if ring is not None else None

    def metric_names(self) -> dict:
        with self._lock:
            return {
                "cluster": sorted(self._cluster),
                "executor": sorted(
                    {k for r in self._per_executor.values() for k in r}
                ),
                "executors": sorted(self._per_executor),
            }


class SloTracker:
    """Per-session job-latency SLO.  ``observe`` is called once per
    COMPLETED job with the session's target
    (``ballista.obs.slo.job_latency_seconds``; 0/absent = untracked).
    Burn rate is the breach fraction over the trailing ``window_s`` of
    tracked completions — 0.0 is a healthy budget, 1.0 means every
    recent job breached."""

    def __init__(self, registry, window_s: float = 3600.0):
        self.window_s = window_s
        self._lock = threading.Lock()
        self._ring: deque = deque()  # (mono_ts, breached)
        self._jobs = registry.counter(
            "slo_jobs_total", "completed jobs with a latency SLO configured"
        )
        self._breaches = registry.counter(
            "slo_breaches_total",
            "completed jobs whose latency exceeded the session SLO",
        )
        registry.gauge(
            "slo_burn_rate",
            "fraction of SLO-tracked jobs breaching over the trailing window",
            fn=self.burn_rate,
        )

    def observe(self, latency_s: float, target_s: float) -> bool:
        """Record one completed job; returns True when it breached."""
        if target_s <= 0:
            return False
        breached = latency_s > target_s
        self._jobs.inc()
        if breached:
            self._breaches.inc()
        now = time.monotonic()
        with self._lock:
            self._ring.append((now, breached))
            cutoff = now - self.window_s
            while self._ring and self._ring[0][0] < cutoff:
                self._ring.popleft()
        return breached

    def burn_rate(self) -> float:
        cutoff = time.monotonic() - self.window_s
        with self._lock:
            while self._ring and self._ring[0][0] < cutoff:
                self._ring.popleft()
            if not self._ring:
                return 0.0
            return round(
                sum(1 for _, b in self._ring if b) / len(self._ring), 4
            )

    def snapshot(self) -> dict:
        return {
            "jobs": int(self._jobs.value),
            "breaches": int(self._breaches.value),
            "burn_rate": self.burn_rate(),
            "window_s": self.window_s,
        }
