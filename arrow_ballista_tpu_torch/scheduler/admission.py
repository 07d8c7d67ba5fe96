"""Multi-tenant admission control + weighted fair job release.

The scheduler's front door.  Everything downstream of here — the
ExecutionGraph cache, slot reservations, the event loop — was built for
one job at a time; under "millions of users" traffic N concurrent
submissions all raced FIFO into the same slot pool with no queue
discipline, no backpressure and no way to shed load.  This module adds:

* **Tenant pools** — every admission-enabled job belongs to a pool
  (``ballista.tenant.id``, default pool otherwise) with a weight
  (``ballista.tenant.weight``) and an optional per-pool concurrency cap
  (``ballista.tenant.max_running_jobs``).
* **A bounded admission queue** — jobs past the cluster's running-job
  capacity wait here *pre-planning*: no ExecutionGraph is built, no plan
  memory pinned, nothing persisted.  The per-job logical plan is the
  only thing held.
* **Deficit-weighted round-robin release** — as capacity frees, queued
  jobs release pool-by-pool: each eligible pool banks credit
  proportional to its weight and the richest pool admits next, so two
  pools with weights 2:1 see a 2:1 admission rate whenever both have
  work queued.  Idle pools bank nothing (deficits reset when a pool's
  queue drains), so a long-quiet tenant cannot burst past its share.
* **Priority lanes** — ``ballista.tenant.priority=interactive`` jobs
  release ahead of batch work across every pool, but only
  ``max_interactive_bypass`` times in a row past a waiting batch job:
  batch can be delayed, never starved.  A bounded express lane
  (``interactive_headroom``) additionally lets a few interactive jobs
  run ABOVE the cluster cap — a short interactive query must never
  wait a whole long batch job's completion for its admission slot —
  and their tasks dispatch first among running jobs.
* **Graceful shedding** — past ``ballista.admission.max_queued_jobs``
  the controller sheds the newest (``shed_policy=reject``) or oldest
  (``shed_policy=oldest``) queued job with a structured, retryable
  :class:`~arrow_ballista_tpu_torch.errors.ClusterSaturated` error.  A job
  queued longer than ``max_queue_wait_seconds`` sheds the same way.
  The running set is never touched — overload degrades the queue, not
  the work already admitted.

Threading: every method is safe under the controller's own lock.  The
release/plan path runs on the query-stage event loop; cancellation and
status reads arrive from gRPC/REST threads.  The controller never calls
back into the task manager or graphs, so there is no lock ordering to
violate.

With ``ballista.admission.enabled=false`` (the default) nothing here is
ever invoked on the submit path and dispatch behavior is byte-identical
to a scheduler without this module.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from ..errors import ClusterSaturated
from ..obs.registry import MetricsRegistry

# hard floor for pool weights: a zero/absurd weight must not stall the
# deficit top-up loop or divide-by-zero the dispatch share
MIN_POOL_WEIGHT = 1e-3
DEFAULT_POOL = "default"
INTERACTIVE = "interactive"
BATCH = "batch"
# cancel intents are a tiny race-closing buffer (cancel arrived while
# the job was between queue release and graph creation); bound it so
# cancels of bogus job ids cannot accumulate forever
MAX_CANCEL_INTENTS = 256

QUEUE_WAIT_BUCKETS = (0.005, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0, 600.0)


@dataclass
class QueuedJob:
    """One held-back submission: everything needed to plan it later."""

    job_id: str
    session_id: str
    plan: object  # the LOGICAL plan — nothing heavier exists yet
    pool: str
    priority: str
    enqueued_mono: float
    enqueued_unix: float
    max_wait_s: float  # 0 = wait forever


@dataclass
class AdmissionDecision:
    """Outcome of :meth:`AdmissionController.offer`."""

    queued: bool = False
    position: int = 0
    # jobs displaced by shed_policy=oldest: the caller fails each with
    # its paired error message (they belong to other sessions)
    displaced: List[Tuple[QueuedJob, str]] = field(default_factory=list)
    # set when THIS submission was shed (shed_policy=reject): the caller
    # raises it so the job fails with the structured backpressure error
    error: Optional[ClusterSaturated] = None


class _Pool:
    __slots__ = (
        "name",
        "weight",
        "max_running",
        "lanes",
        "running",
        "deficit",
        "admitted_total",
        "shed_total",
    )

    def __init__(self, name: str):
        self.name = name
        self.weight = 1.0
        self.max_running = 0  # 0 = unlimited
        self.lanes: Dict[str, Deque[QueuedJob]] = {
            INTERACTIVE: deque(),
            BATCH: deque(),
        }
        self.running: set = set()
        self.deficit = 0.0
        self.admitted_total = 0
        self.shed_total = 0

    def queued(self) -> int:
        return len(self.lanes[INTERACTIVE]) + len(self.lanes[BATCH])

    def jobs(self) -> List[QueuedJob]:
        """Release order within the pool: interactive lane first."""
        return list(self.lanes[INTERACTIVE]) + list(self.lanes[BATCH])


class AdmissionController:
    def __init__(
        self,
        executor_manager,
        registry: Optional[MetricsRegistry] = None,
        events=None,
        max_interactive_bypass: int = 4,
        pinned_settings: Optional[Dict[str, str]] = None,
    ):
        from ..obs.events import EventJournal

        self.executor_manager = executor_manager
        # operator-pinned CLUSTER limits (scheduler flags / overrides):
        # a ballista.admission.* key present here wins over whatever the
        # submitting session says — one tenant must not rewrite the
        # cluster-wide gates (queue bound, shed policy, concurrency cap)
        # every other tenant depends on.  Per-POOL knobs (ballista.
        # tenant.*) stay session-driven by design: a tenant can only
        # shape its own pool.
        self._pinned = {
            k: v
            for k, v in (pinned_settings or {}).items()
            if k.startswith("ballista.admission.")
        }
        self.events = events if events is not None else EventJournal()
        self.registry = registry or MetricsRegistry()
        self._lock = threading.Lock()
        # durable queue journal: attached by SchedulerState
        # when --admission-wal-enabled; None keeps every hook a no-op
        # and the submit path byte-identical to pre-WAL behavior
        self.wal = None
        self._pools: Dict[str, _Pool] = {}
        # job_id -> (pool, priority) for every admitted-and-not-yet-
        # terminal job; priority matters for capacity accounting —
        # running interactive jobs charge the headroom FIRST, so an
        # express-lane job never occupies base capacity a batch release
        # is waiting for (otherwise steady interactive traffic would
        # hold base_ok false forever and batch would starve structurally)
        self._running: Dict[str, Tuple[str, str]] = {}
        # job_id -> QueuedJob for queue membership / position queries
        self._queued: Dict[str, QueuedJob] = {}
        # cancel arrived while the job was mid-release (no queue entry,
        # no graph yet): the submit path checks-and-consumes these
        self._cancel_intents: OrderedDict = OrderedDict()
        # cluster-level limits, refreshed from the submitting job's
        # merged config at each offer (scheduler flags seed defaults,
        # explicit session settings win — same contract as AQE)
        self._max_running_jobs = 0  # 0 = one admitted job per task slot
        self._max_queued = 100
        self._shed_policy = "reject"
        self._max_bypass = max_interactive_bypass
        # bounded express lane: interactive jobs may run up to this many
        # ABOVE the cap — a short interactive query must never wait a
        # whole long batch job's completion for its admission slot
        # (job-granular admission would otherwise make it slower than
        # task-granular FIFO, the opposite of a priority lane)
        self._interactive_headroom = 2
        # consecutive interactive releases past waiting batch work —
        # ONE counter across pools, so interactive jumps every batch
        # queue but can never starve any of them
        self._interactive_bypass = 0
        self._queued_counter = self.registry.counter(
            "jobs_queued_total",
            "jobs held in the admission queue at submit",
        )
        self._admitted_counter = self.registry.counter(
            "jobs_admitted_total",
            "jobs released from the admission queue into planning",
        )
        self._shed_counter = self.registry.counter(
            "jobs_shed_total",
            "jobs shed with ClusterSaturated backpressure",
        )
        self._wait_hist = self.registry.histogram(
            "admission_queue_wait_seconds",
            "queue wait of admitted jobs (enqueue to release)",
            buckets=QUEUE_WAIT_BUCKETS,
        )
        self.registry.gauge(
            "admission_queued_jobs",
            "jobs currently waiting in the admission queue",
            fn=self.queued_count,
        )

    # ------------------------------------------------------------ capacity
    def _derived_max_running(self) -> int:
        """Default concurrency gate: one admitted job per task slot
        across alive executors (an empty cluster still admits one job so
        the first registration has something to run)."""
        try:
            em = self.executor_manager
            alive = em.get_alive_executors()
            total = sum(
                meta.specification.task_slots
                for meta in em.executors()
                if meta.id in alive
            )
            return max(1, total)
        except Exception:  # noqa: BLE001 - capacity probe must not fail submit
            return 1

    def _effective_max_running(self) -> int:
        return (
            self._max_running_jobs
            if self._max_running_jobs > 0
            else self._derived_max_running()
        )

    @staticmethod
    def _pool_capacity_ok(pool: _Pool) -> bool:
        return pool.max_running <= 0 or len(pool.running) < pool.max_running

    # -------------------------------------------------------------- pools
    def _pool_for(self, cfg) -> _Pool:
        name = (cfg.tenant_id or "").strip() or DEFAULT_POOL
        pool = self._pools.get(name)
        if pool is None:
            pool = self._pools[name] = _Pool(name)
        # pool parameters follow the latest submission (tenants ship
        # their own weight/cap; a scheduler-flag override wins the merge
        # upstream exactly like every other knob)
        pool.weight = max(MIN_POOL_WEIGHT, cfg.tenant_weight)
        pool.max_running = cfg.tenant_max_running_jobs
        return pool

    def _effective_cfg(self, cfg):
        """Operator-pinned admission keys over the session's values."""
        if not self._pinned:
            return cfg
        from ..config import BallistaConfig

        return BallistaConfig({**cfg.to_dict(), **self._pinned})

    def _refresh_limits(self, cfg) -> None:
        self._max_running_jobs = cfg.admission_max_running_jobs
        self._max_queued = cfg.admission_max_queued_jobs
        self._shed_policy = cfg.admission_shed_policy
        self._max_bypass = cfg.admission_max_interactive_bypass
        self._interactive_headroom = max(0, cfg.admission_interactive_headroom)

    def pool_weights(self) -> Dict[str, float]:
        """{pool: weight} snapshot — the dispatch-side fair-share input
        (``TaskManager.fill_reservations`` ordering)."""
        with self._lock:
            return {name: p.weight for name, p in self._pools.items()}

    # -------------------------------------------------------------- offer
    def offer(self, job_id: str, session_id: str, plan, cfg) -> AdmissionDecision:
        """Enqueue one admission-enabled submission (or shed per policy).

        Pure queue discipline: the caller runs :meth:`release`
        immediately after, so an uncontended job passes straight through
        with ~0 queue wait.  Returns the decision; on
        ``shed_policy=reject`` saturation the decision carries the
        :class:`ClusterSaturated` error for the caller to raise."""
        now_mono = time.monotonic()
        with self._lock:
            pool = self._pool_for(cfg)
            cfg = self._effective_cfg(cfg)
            self._refresh_limits(cfg)
            priority = cfg.tenant_priority
            qj = QueuedJob(
                job_id=job_id,
                session_id=session_id,
                plan=plan,
                pool=pool.name,
                priority=priority,
                enqueued_mono=now_mono,
                enqueued_unix=time.time(),
                max_wait_s=cfg.admission_max_queue_wait_seconds,
            )
            decision = AdmissionDecision()
            # every admission transits the queue (release() is the only
            # admit path), so the bound must never be able to reject an
            # idle cluster outright: 0 means unbounded, like the other
            # capacity knobs
            if 0 < self._max_queued <= len(self._queued):
                if self._shed_policy == "oldest":
                    oldest = min(
                        self._queued.values(), key=lambda q: q.enqueued_mono
                    )
                    err = self._shed_locked(
                        oldest, "displaced by a newer submission", now_mono
                    )
                    decision.displaced.append((oldest, str(err)))
                else:
                    pool.shed_total += 1
                    self._shed_counter.inc()
                    decision.error = ClusterSaturated(
                        "admission queue full",
                        pool=pool.name,
                        queued=len(self._queued),
                        policy=self._shed_policy,
                    )
                    self.events.emit(
                        "job_shed",
                        job=job_id,
                        pool=pool.name,
                        priority=priority,
                        queue_wait_s=0.0,
                        policy=self._shed_policy,
                        reason="queue full",
                    )
                    self._refresh_gauges_locked()
                    return decision
            pool.lanes[priority if priority in pool.lanes else BATCH].append(qj)
            self._queued[job_id] = qj
            if self.wal is not None:
                self.wal.append(qj, pool.weight, pool.max_running)
            self._queued_counter.inc()
            decision.queued = True
            decision.position = self._position_locked(qj)
            self.events.emit(
                "job_queued",
                job=job_id,
                pool=pool.name,
                priority=priority,
                position=decision.position,
                queued_jobs=len(self._queued),
            )
            self._refresh_gauges_locked()
            return decision

    # ------------------------------------------------------------- release
    def release(self) -> List[QueuedJob]:
        """Admit as many queued jobs as current capacity allows, by
        deficit-weighted round robin across pools.  The caller plans and
        submits each returned job (they are already counted running so a
        racing release cannot over-admit)."""
        out: List[QueuedJob] = []
        with self._lock:
            guard = 0
            while guard < 100_000:
                guard += 1
                if not self._queued:
                    break
                max_running = self._effective_max_running()
                inter_running = sum(
                    1
                    for _pool, prio in self._running.values()
                    if prio == INTERACTIVE
                )
                # running interactive jobs fill the headroom before they
                # count against base capacity: batch's share of the
                # cluster is never consumed by express-lane traffic
                base_used = len(self._running) - min(
                    inter_running, self._interactive_headroom
                )
                base_ok = base_used < max_running
                # the express lane: interactive jobs may still admit
                # when the base capacity is full, up to the headroom
                inter_ok = (
                    len(self._running)
                    < max_running + self._interactive_headroom
                )
                if not inter_ok:  # implies base_ok is false too
                    break
                interactive_only = not base_ok

                def lanes_queued(p: _Pool) -> bool:
                    if interactive_only:
                        return bool(p.lanes[INTERACTIVE])
                    return p.queued() > 0

                eligible = [
                    p
                    for p in self._pools.values()
                    if lanes_queued(p) and self._pool_capacity_ok(p)
                ]
                if not eligible:
                    break
                affordable = [p for p in eligible if p.deficit >= 1.0]
                if not affordable:
                    # top up: each pool banks credit proportional to its
                    # weight until someone can afford one admission
                    for p in eligible:
                        p.deficit += p.weight
                    continue
                qj, best = self._pick_locked(
                    affordable, interactive_only=interactive_only
                )
                if qj is None:  # defensive; lanes_queued said non-empty
                    continue
                best.deficit -= 1.0
                self._queued.pop(qj.job_id, None)
                best.running.add(qj.job_id)
                self._running[qj.job_id] = (best.name, qj.priority)
                best.admitted_total += 1
                self._admitted_counter.inc()
                wait = time.monotonic() - qj.enqueued_mono
                self._wait_hist.observe(wait)
                self.events.emit(
                    "job_admitted",
                    job=qj.job_id,
                    pool=best.name,
                    priority=qj.priority,
                    queue_wait_s=round(wait, 4),
                )
                out.append(qj)
            # standard DRR: an idle pool banks nothing — its burst
            # budget restarts when work arrives
            for p in self._pools.values():
                if not p.queued():
                    p.deficit = 0.0
            self._refresh_gauges_locked()
        return out

    def _pick_locked(self, affordable: List[_Pool], interactive_only=False):
        """One admission among the affordable pools: the interactive
        lane goes first ACROSS pools — but only ``max_interactive_
        bypass`` times in a row past waiting batch work, then the
        best batch head must go (bounded bypass: batch is delayed,
        never starved).  Within a lane, the pool with the largest
        deficit wins, oldest head job as the tie-break (deficit-
        weighted round robin).  ``interactive_only`` (headroom-funded
        admissions past the base cap) never counts as a bypass —
        batch could not have taken that slot anyway."""
        inter_pools = [p for p in affordable if p.lanes[INTERACTIVE]]
        batch_pools = (
            [] if interactive_only
            else [p for p in affordable if p.lanes[BATCH]]
        )

        def best_of(pools: List[_Pool], lane: str) -> _Pool:
            return max(
                pools,
                key=lambda p: (p.deficit, -p.lanes[lane][0].enqueued_mono),
            )

        if inter_pools and (
            not batch_pools
            or self._interactive_bypass < max(0, self._max_bypass)
        ):
            best = best_of(inter_pools, INTERACTIVE)
            if interactive_only:
                # headroom-funded slot: it was never batch's to take, so
                # it neither counts as a bypass nor forgives past ones —
                # unless no batch is waiting anywhere, which genuinely
                # ends the streak
                if not any(p.lanes[BATCH] for p in self._pools.values()):
                    self._interactive_bypass = 0
            elif batch_pools:
                self._interactive_bypass += 1
            else:
                self._interactive_bypass = 0
            return best.lanes[INTERACTIVE].popleft(), best
        if batch_pools:
            self._interactive_bypass = 0
            best = best_of(batch_pools, BATCH)
            return best.lanes[BATCH].popleft(), best
        return None, None

    # ------------------------------------------------------------ lifecycle
    def job_finished(self, job_id: str) -> bool:
        """A tracked job reached a terminal state: free its concurrency
        slot.  No-op (False) for jobs admission never saw."""
        with self._lock:
            entry = self._running.pop(job_id, None)
            if entry is None:
                return False
            pool = self._pools.get(entry[0])
            if pool is not None:
                pool.running.discard(job_id)
            self._refresh_gauges_locked()
            return True

    def adopt_running(self, job_id: str, pool_name: str, priority: str = BATCH) -> None:
        """Restart/HA adoption: re-register an already-admitted job so
        pool accounting (and the concurrency gate) survives failover."""
        with self._lock:
            pool = self._pools.get(pool_name)
            if pool is None:
                pool = self._pools[pool_name] = _Pool(pool_name)
            pool.running.add(job_id)
            self._running[job_id] = (pool_name, priority)
            self._refresh_gauges_locked()

    # ---------------------------------------------------- durability (WAL)
    def attach_wal(self, wal) -> None:
        """Arm the durable queue journal (:class:`~.queue_wal.
        AdmissionWal`).  Every queue mutation from here on writes
        through; ``None`` (the default) keeps behavior byte-identical
        to a WAL-less scheduler."""
        self.wal = wal

    def wal_discard(self, job_id: str) -> None:
        """The job reached a durable downstream state (its graph was
        persisted, or it went terminal): its WAL entry is now redundant.
        Deliberately NOT called at :meth:`release` — a crash between
        release and graph persistence must still replay the job."""
        if self.wal is not None:
            self.wal.discard(job_id)

    def restore(
        self,
        job_id: str,
        session_id: str,
        plan,
        pool_name: str,
        priority: str,
        pool_weight: float,
        pool_max_running: int,
        enqueued_unix: float,
        max_wait_s: float,
    ) -> bool:
        """WAL replay: re-enqueue one journaled job in arrival order
        (the caller iterates entries sorted by sequence).  Queue-wait
        age survives the restart — ``enqueued_mono`` is back-dated by
        the wall-clock elapsed so ``max_queue_wait_seconds`` expiry
        still fires on schedule.  DRR deficits deliberately restart at
        zero: they are burst credit, not queue position.  Returns False
        for jobs admission already tracks (idempotent replay)."""
        now_mono = time.monotonic()
        with self._lock:
            if job_id in self._queued or job_id in self._running:
                return False
            pool = self._pools.get(pool_name)
            if pool is None:
                pool = self._pools[pool_name] = _Pool(pool_name)
                # journaled pool parameters seed a pool the restarted
                # scheduler hasn't seen yet; a live pool keeps whatever
                # the latest real submission configured
                pool.weight = max(MIN_POOL_WEIGHT, pool_weight)
                pool.max_running = pool_max_running
            qj = QueuedJob(
                job_id=job_id,
                session_id=session_id,
                plan=plan,
                pool=pool.name,
                priority=priority,
                enqueued_mono=now_mono - max(0.0, time.time() - enqueued_unix),
                enqueued_unix=enqueued_unix,
                max_wait_s=max_wait_s,
            )
            pool.lanes[priority if priority in pool.lanes else BATCH].append(qj)
            self._queued[job_id] = qj
            self.events.emit(
                "job_requeued",
                job=job_id,
                pool=pool.name,
                priority=qj.priority,
                position=self._position_locked(qj),
            )
            self._refresh_gauges_locked()
            return True

    def restore_cancel_intent(self, job_id: str) -> None:
        """WAL replay: re-arm a cancel intent that raced the crash."""
        with self._lock:
            self._cancel_intents[job_id] = time.monotonic()
            while len(self._cancel_intents) > MAX_CANCEL_INTENTS:
                evicted, _ = self._cancel_intents.popitem(last=False)
                if self.wal is not None:
                    self.wal.discard_intent(evicted)

    # ----------------------------------------------------------- shedding
    def _shed_locked(
        self, qj: QueuedJob, reason: str, now_mono: float
    ) -> ClusterSaturated:
        """Remove one queued job and account the shed; returns the
        structured error the caller fails it with."""
        self._queued.pop(qj.job_id, None)
        if self.wal is not None:
            self.wal.discard(qj.job_id)
        pool = self._pools.get(qj.pool)
        wait = now_mono - qj.enqueued_mono
        if pool is not None:
            for lane in pool.lanes.values():
                try:
                    lane.remove(qj)
                except ValueError:
                    pass
            pool.shed_total += 1
        self._shed_counter.inc()
        err = ClusterSaturated(
            reason,
            pool=qj.pool,
            queued=len(self._queued),
            policy=self._shed_policy,
            queue_wait_s=wait,
        )
        self.events.emit(
            "job_shed",
            job=qj.job_id,
            pool=qj.pool,
            priority=qj.priority,
            queue_wait_s=round(wait, 4),
            policy=self._shed_policy,
            reason=reason,
        )
        return err

    def expire_overdue(self) -> List[Tuple[QueuedJob, str]]:
        """Shed every queued job past its ``max_queue_wait_seconds``
        (0 = never).  Returns [(job, error message)] for the caller to
        fail — the periodic admission pulse drives this."""
        now = time.monotonic()
        out: List[Tuple[QueuedJob, str]] = []
        with self._lock:
            overdue = [
                qj
                for qj in self._queued.values()
                if qj.max_wait_s > 0 and now - qj.enqueued_mono > qj.max_wait_s
            ]
            for qj in overdue:
                err = self._shed_locked(
                    qj,
                    f"queued longer than max_queue_wait_seconds="
                    f"{qj.max_wait_s:g}",
                    now,
                )
                out.append((qj, str(err)))
            if overdue:
                self._refresh_gauges_locked()
        return out

    # --------------------------------------------------------- cancellation
    def cancel(self, job_id: str) -> Optional[QueuedJob]:
        """Dequeue a still-queued job (cancel-before-admit).  Returns
        the entry when it was waiting, None when admission doesn't hold
        it (already released, or never admission-managed)."""
        with self._lock:
            qj = self._queued.pop(job_id, None)
            if qj is None:
                return None
            if self.wal is not None:
                self.wal.discard(job_id)
            pool = self._pools.get(qj.pool)
            if pool is not None:
                for lane in pool.lanes.values():
                    try:
                        lane.remove(qj)
                    except ValueError:
                        pass
            self._refresh_gauges_locked()
            return qj

    def mark_cancel_intent(self, job_id: str) -> None:
        """Cancel raced the admit window (not queued, no graph yet): the
        release/plan path consumes the intent and fails the job instead
        of running it.  Bounded — stale intents for bogus ids age out."""
        with self._lock:
            self._cancel_intents[job_id] = time.monotonic()
            if self.wal is not None:
                self.wal.put_intent(job_id)
            while len(self._cancel_intents) > MAX_CANCEL_INTENTS:
                evicted, _ = self._cancel_intents.popitem(last=False)
                if self.wal is not None:
                    self.wal.discard_intent(evicted)

    def take_cancel_intent(self, job_id: str) -> bool:
        with self._lock:
            taken = self._cancel_intents.pop(job_id, None) is not None
            if taken and self.wal is not None:
                self.wal.discard_intent(job_id)
            return taken

    # ------------------------------------------------------------- queries
    def queued_count(self) -> int:
        with self._lock:
            return len(self._queued)

    def _position_locked(self, qj: QueuedJob) -> int:
        pool = self._pools.get(qj.pool)
        if pool is None:
            return 0
        try:
            return pool.jobs().index(qj) + 1
        except ValueError:
            return 0

    def queued_status(self, job_id: str) -> Optional[dict]:
        """Job-status surface for a held-back job: queue position within
        its pool (1-based, interactive lane first) + wait so far."""
        with self._lock:
            qj = self._queued.get(job_id)
            if qj is None:
                return None
            return {
                "state": "queued",
                "job_id": job_id,
                "pool": qj.pool,
                "priority": qj.priority,
                "queue_position": self._position_locked(qj),
                "queued_seconds": round(
                    time.monotonic() - qj.enqueued_mono, 3
                ),
            }

    def queued_jobs_brief(self) -> List[dict]:
        """[{job_id, pool, priority}] for the /api/jobs table."""
        with self._lock:
            return [
                {"job_id": q.job_id, "pool": q.pool, "priority": q.priority}
                for q in self._queued.values()
            ]

    def snapshot(self) -> dict:
        """The /api/tenants payload: per-pool weights, lanes, queue
        depth, running share and lifetime counters."""
        with self._lock:
            total_weight = sum(
                p.weight for p in self._pools.values()
            ) or 1.0
            pools = {}
            for name, p in sorted(self._pools.items()):
                pools[name] = {
                    "weight": p.weight,
                    "share_target": round(p.weight / total_weight, 4),
                    "max_running_jobs": p.max_running,
                    "queued": p.queued(),
                    "queued_interactive": len(p.lanes[INTERACTIVE]),
                    "queued_batch": len(p.lanes[BATCH]),
                    "running": len(p.running),
                    "admitted_total": p.admitted_total,
                    "shed_total": p.shed_total,
                }
            return {
                "pools": pools,
                "queued_jobs": len(self._queued),
                "running_jobs": len(self._running),
                "max_running_jobs": self._effective_max_running(),
                "max_queued_jobs": self._max_queued,
                "shed_policy": self._shed_policy,
                "max_interactive_bypass": self._max_bypass,
                "interactive_headroom": self._interactive_headroom,
            }

    def health_summary(self) -> dict:
        """Compact admission block for /api/cluster/health."""
        with self._lock:
            return {
                "queued_jobs": len(self._queued),
                "running_jobs": len(self._running),
                "pools": {
                    name: {"queued": p.queued(), "running": len(p.running)}
                    for name, p in sorted(self._pools.items())
                    if p.queued() or p.running or p.admitted_total
                },
            }

    # -------------------------------------------------------------- gauges
    def _refresh_gauges_locked(self) -> None:
        total_weight = sum(p.weight for p in self._pools.values()) or 1.0
        for name, p in self._pools.items():
            labels = {"pool": name}
            self.registry.gauge(
                "tenant_queued_jobs",
                "jobs waiting in this pool's admission queue",
                labels=labels,
            ).set(p.queued())
            self.registry.gauge(
                "tenant_running_jobs",
                "admitted (running) jobs of this pool",
                labels=labels,
            ).set(len(p.running))
            self.registry.gauge(
                "tenant_share",
                "configured fair-share fraction of this pool",
                labels=labels,
            ).set(round(p.weight / total_weight, 4))
