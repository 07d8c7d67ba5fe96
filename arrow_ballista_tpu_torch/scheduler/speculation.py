"""Scheduler-driven speculative execution + task deadline reaper.

Ballista's staged shuffle execution runs a whole query at the speed of
its slowest task: one wedged worker or one degraded node holds a
partition — and the job — hostage until the executor heartbeat times out
(minutes).  This module closes that tail-latency gap with the two
mitigations a production fleet expects:

* **speculation** — once enough of a stage has finished
  (``ballista.speculation.min_completed_fraction``), a task running
  longer than ``multiplier × median(completed runtimes)`` (floored at
  ``min_runtime_seconds``) gets a duplicate attempt on a *different*
  executor; the first completion wins, commits its output locations, and
  the loser is cancelled — its late status is dropped as stale and never
  consumes failure budget (``ExecutionGraph._commit_winner``).
* **deadline reaping** — a "running" task older than
  ``ballista.task.timeout_seconds`` on a live-but-wedged executor is
  cancelled and re-queued through the normal transient path with a FREE
  attempt (staleness bump without budget burn), so a hung worker process
  can no longer hold a partition forever.

The :class:`SpeculationManager` owns the registry counters and the scan
body; the scan itself is triggered as a ``SpeculationScan`` event on the
scheduler's single event-loop thread (``query_stage_scheduler.py``) by a
timer in ``SchedulerServer`` — all graph mutations stay on that thread's
locking discipline.  Per-job policy comes from the session config at
submit (``ExecutionGraph._init_speculation_policy``); the scheduler
binary's ``--speculation-enabled`` / ``--task-timeout-seconds`` flags
force the machinery on for every session.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Tuple

log = logging.getLogger(__name__)


class SpeculationManager:
    """Periodic straggler/deadline scan over the active jobs.

    Constructed by :class:`~..scheduler.state.SchedulerState`; ``scan()``
    must run on the query-stage event-loop thread (it takes the same
    per-job entry locks as every other graph mutation).
    """

    def __init__(
        self,
        state,
        force_enabled: bool = False,
        force_task_timeout_s: float = 0.0,
    ):
        self.state = state
        self.force_enabled = force_enabled
        self.force_task_timeout_s = force_task_timeout_s
        # per-job monotonic last-scan anchor honoring the session's
        # ballista.speculation.interval_seconds (the scan thread ticks at
        # the scheduler-level period; slower sessions skip ticks)
        self._last_scan: Dict[str, float] = {}
        # speculative_launched/wins/wasted live on the TaskManager (the
        # dispatch/commit paths that actually observe them); the scan
        # only owns the reap counter
        self._timeouts = state.metrics.counter(
            "task_timeouts_total",
            "running tasks reaped past ballista.task.timeout_seconds",
        )

    # ------------------------------------------------------------- scan
    def scan(self) -> Tuple[List[Tuple[str, str]], int]:
        """Visit every active job's running stages: flag stragglers for
        duplicate dispatch, reap deadline-expired tasks, fan the queued
        CancelTasks out (pooled channels, best-effort).  Returns
        ``(job events, slots_wanted)`` — the push-mode caller mints one
        reservation per wanted slot (new speculation requests + reaped
        re-queues)."""
        tm = self.state.task_manager
        now = time.monotonic()
        events: List[Tuple[str, str]] = []
        slots_wanted = 0
        cancels: List[Tuple[str, object]] = []
        for job_id in tm.active_job_ids():
            entry = tm._entry(job_id)
            with entry.lock:
                graph = tm._load(job_id, entry)
                if graph is None:
                    continue
                interval = getattr(graph, "spec_interval_s", 1.0)
                last = self._last_scan.get(job_id, float("-inf"))
                if now - last < interval:
                    continue
                self._last_scan[job_id] = now
                out = graph.scan_speculation(
                    now,
                    force_enabled=self.force_enabled,
                    force_timeout_s=self.force_task_timeout_s,
                )
                cancels.extend(graph.take_pending_cancels())
                if not (
                    out["new_requests"] or out["timeouts"] or out["events"]
                ):
                    continue
                if out["timeouts"]:
                    self._timeouts.inc(out["timeouts"])
                slots_wanted += out["new_requests"]
                for ev in out["events"]:
                    if ev == "task_requeued":
                        tm._retries.inc()
                        slots_wanted += 1
                    events.append((job_id, ev))
                if out["new_requests"]:
                    log.info(
                        "job %s: flagged %d straggler(s) for speculation",
                        job_id,
                        out["new_requests"],
                    )
                tm._persist(graph)
        # forget jobs that left the cache (completed/failed/evicted)
        active = set(tm.active_job_ids())
        for job_id in list(self._last_scan):
            if job_id not in active:
                self._last_scan.pop(job_id, None)
        if cancels:
            tm.cancel_task_attempts(cancels)
        return events, slots_wanted
