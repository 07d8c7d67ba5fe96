"""Per-executor resource sampler.

One :class:`TelemetrySampler` per executor process; the push-mode
``Heartbeater`` calls :meth:`sample` right before each beat and ships the
snapshot as ``HeartBeatParams.telemetry_json``.  The scheduler's
``ClusterTelemetry`` (obs/timeseries.py) keeps the per-executor series
and the cluster aggregates both ROADMAP consumers need: admission
control / KEDA-style autoscaling reads queue depth and slot saturation;
adaptive re-planning reads the same executor pressure signals the skew
analytics complement.

Design rules:

* **Sampling must never hurt the data plane.**  Every probe is wrapped:
  a failed read degrades that field to absence, never the beat.  The
  work-dir disk walk — the only probe that is not O(1) — is throttled to
  once per ``disk_interval_s`` and reuses the previous value between
  walks.
* **Point-in-time, latest-wins.**  Unlike spans (which requeue on a
  failed heartbeat so the trace has no gaps), a telemetry snapshot is
  superseded by the next sample — a lost beat just means the scheduler
  sees the NEXT snapshot, so there is nothing to requeue.
* **Disabled is free.**  ``enabled=False`` turns :meth:`sample` into a
  single attribute check returning None.

Snapshot fields (all optional for the reader — old executors ship none,
newer ones may add more; the scheduler parses tolerantly):
``cpu_percent``, ``rss_bytes``, ``shuffle_disk_bytes``,
``fetch_queue_bytes``, ``write_queue_bytes``, ``replicator_backlog``,
``slots_total``, ``active_tasks``, ``span_drops``, ``ts``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

_PAGE_SIZE = 4096
try:
    _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, ValueError, OSError):
    pass


def _rss_bytes() -> Optional[int]:
    """Resident set size via /proc (Linux); getrusage peak-RSS fallback."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except Exception:  # noqa: BLE001 - non-Linux or hardened /proc
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # noqa: BLE001
        return None


def dir_bytes(path: str) -> int:
    """Total file bytes under ``path`` (0 when absent/unreadable)."""
    total = 0
    try:
        for root, _dirs, files in os.walk(path):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(root, name))
                except OSError:
                    pass
    except OSError:
        pass
    return total


class TelemetrySampler:
    """Snapshot this process's resource pressure for the heartbeat
    piggyback.  ``active_tasks_fn`` is the executor's live task count
    (``Executor.active_task_count``); ``slots_total`` its concurrency."""

    def __init__(
        self,
        work_dir: str = "",
        slots_total: int = 0,
        active_tasks_fn: Optional[Callable[[], int]] = None,
        disk_interval_s: float = 10.0,
        enabled: bool = True,
    ):
        self.enabled = enabled
        self.work_dir = work_dir
        self.slots_total = slots_total
        self.active_tasks_fn = active_tasks_fn
        self.disk_interval_s = disk_interval_s
        self._lock = threading.Lock()
        # CPU%: process CPU time (all threads) over wall time between
        # samples — can exceed 100 on multi-core, exactly like top's view
        self._last_cpu: Optional[float] = None
        self._last_mono: Optional[float] = None
        self._disk_bytes = 0
        self._disk_sampled_mono = float("-inf")

    # ------------------------------------------------------------- probes
    def _cpu_percent(self, now_mono: float) -> Optional[float]:
        cpu = time.process_time()
        with self._lock:
            last_cpu, last_mono = self._last_cpu, self._last_mono
            self._last_cpu, self._last_mono = cpu, now_mono
        if last_cpu is None or last_mono is None or now_mono <= last_mono:
            return None  # first sample has no baseline
        return round(100.0 * (cpu - last_cpu) / (now_mono - last_mono), 2)

    def _shuffle_disk_bytes(self, now_mono: float) -> int:
        with self._lock:
            fresh = now_mono - self._disk_sampled_mono < self.disk_interval_s
            if fresh or not self.work_dir:
                return self._disk_bytes
            self._disk_sampled_mono = now_mono  # claim before the walk
        n = dir_bytes(self.work_dir)
        with self._lock:
            self._disk_bytes = n
        return n

    # ------------------------------------------------------------- sample
    def sample(self) -> Optional[dict]:
        """One snapshot dict, or None (disabled / sampler broke).  Never
        raises — telemetry must never fail a heartbeat."""
        if not self.enabled:
            return None
        try:
            now_mono = time.monotonic()
            out: dict = {"ts": round(time.time(), 3)}
            cpu = self._cpu_percent(now_mono)
            if cpu is not None:
                out["cpu_percent"] = cpu
            rss = _rss_bytes()
            if rss is not None:
                out["rss_bytes"] = rss
            if self.work_dir:
                out["shuffle_disk_bytes"] = self._shuffle_disk_bytes(now_mono)
            # queue occupancy: fetch-side staging bytes + write-pool
            # queued bytes are process-wide counters maintained by the
            # shuffle data plane (jax-free modules; cheap reads)
            from ..shuffle import fetcher, writer

            out["fetch_queue_bytes"] = fetcher.staging_bytes()
            out["write_queue_bytes"] = writer.queued_bytes()
            from ..shuffle import store as shuffle_store

            out["replicator_backlog"] = shuffle_store.replicator_backlog()
            if self.slots_total:
                out["slots_total"] = self.slots_total
            if self.active_tasks_fn is not None:
                out["active_tasks"] = int(self.active_tasks_fn())
            from .recorder import get_recorder

            out["span_drops"] = get_recorder().dropped
            return out
        except Exception:  # noqa: BLE001 - degrade to no payload
            return None
