"""SchedulerServer: top-level scheduler object.

Counterpart of the reference's ``scheduler/src/scheduler_server/mod.rs``:
owns the :class:`SchedulerState`, the scheduling policy, and the
query-stage event loop (buffer 10,000, `:55-61`); ``init()`` starts the
loop and the dead-executor reaper (`:131-137`, `:192-253`); ``submit_job``
posts ``JobQueued`` (`:139-153`); ``update_task_status`` posts
``TaskUpdating`` after rejecting dead executors (`:157-178`).

The pull-mode fill path (``poll_work``) mutates state directly from the
RPC thread exactly like the reference's handler
(``scheduler_server/grpc.rs:56-175``): graphs are behind per-job locks, so
this is safe, and job-level consequences are still posted as events.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from ..config import TaskSchedulingPolicy
from ..plan import logical as lp
from ..proto import pb
from ..serde.scheduler_types import ExecutorMetadata
from .backend import Keyspace, StateBackend
from .event_loop import EventLoop
from .execution_stage import TaskInfo
from .executor_manager import (
    DEFAULT_EXECUTOR_TIMEOUT_S,
    ExecutorReservation,
)
from .query_stage_scheduler import (
    ExecutorLost,
    JobQueued,
    QueryStageScheduler,
    ReservationOffering,
    TaskUpdating,
    post_job_events,
)
from .session_manager import SessionBuilder, default_session_builder
from .state import SchedulerState
from .task_manager import TaskLauncher, TaskManager

log = logging.getLogger(__name__)

EVENT_LOOP_BUFFER = 10_000


class SchedulerServer:
    def __init__(
        self,
        scheduler_id: str,
        backend: StateBackend,
        policy: TaskSchedulingPolicy = TaskSchedulingPolicy.PULL_STAGED,
        session_builder: SessionBuilder = default_session_builder,
        launcher: Optional[TaskLauncher] = None,
        work_dir: str = "/tmp/ballista-tpu",
        liveness_window_s: float = 60.0,
        executor_timeout_s: float = DEFAULT_EXECUTOR_TIMEOUT_S,
        reaper_interval_s: Optional[float] = None,
        quarantine_threshold: Optional[int] = None,
        quarantine_window_s: Optional[float] = None,
        quarantine_backoff_s: Optional[float] = None,
        speculation_interval_s: float = 1.0,
        speculation_force_enabled: bool = False,
        task_timeout_force_s: float = 0.0,
        aqe_force_enabled: bool = False,
        admission_force_enabled: bool = False,
        admission_defaults: Optional[Dict[str, str]] = None,
        admission_wal_enabled: bool = False,
        cache_force_enabled: bool = False,
        cache_policy_force_enabled: bool = False,
        cache_settings: Optional[Dict[str, str]] = None,
        drain_timeout_s: float = 30.0,
        telemetry_sample_s: float = 5.0,
        event_journal_dir: str = "",
        event_journal_rotate_bytes: Optional[int] = None,
        event_journal_segments: Optional[int] = None,
        autoscaler_settings: Optional[Dict[str, str]] = None,
        executor_provider=None,
    ):
        self.scheduler_id = scheduler_id
        self.policy = policy
        self.state = SchedulerState(
            backend,
            scheduler_id,
            policy,
            session_builder,
            launcher,
            work_dir,
            liveness_window_s,
            quarantine_threshold=quarantine_threshold,
            quarantine_window_s=quarantine_window_s,
            quarantine_backoff_s=quarantine_backoff_s,
            speculation_force_enabled=speculation_force_enabled,
            task_timeout_force_s=task_timeout_force_s,
            aqe_force_enabled=aqe_force_enabled,
            admission_force_enabled=admission_force_enabled,
            admission_defaults=admission_defaults,
            admission_wal_enabled=admission_wal_enabled,
            cache_force_enabled=cache_force_enabled,
            cache_policy_force_enabled=cache_policy_force_enabled,
            cache_settings=cache_settings,
            event_journal_dir=event_journal_dir,
            event_journal_rotate_bytes=event_journal_rotate_bytes,
            event_journal_segments=event_journal_segments,
        )
        self.event_loop = EventLoop(
            "query_stage", EVENT_LOOP_BUFFER, QueryStageScheduler(self.state)
        )
        self.executor_timeout_s = executor_timeout_s
        self.reaper_interval_s = (
            reaper_interval_s if reaper_interval_s is not None else executor_timeout_s
        )
        # straggler/deadline scan period (tests shrink the attr live; the
        # timer re-reads it each tick)
        self.speculation_interval_s = speculation_interval_s
        # graceful-decommission drain budget handed to executors
        # (ballista.executor.drain_timeout_seconds is the session-side
        # spelling; the scheduler flag wins for operator-driven drains)
        self.drain_timeout_s = drain_timeout_s
        # cluster-aggregate sampling period (queue depth, running tasks,
        # slots free → obs/timeseries.py rings); tests shrink the attr
        self.telemetry_sample_s = telemetry_sample_s
        self._reaper: Optional[threading.Thread] = None
        self._spec_timer: Optional[threading.Thread] = None
        self._telemetry_timer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # elastic lifecycle: None unless explicitly enabled AND
        # a provider is supplied — the knob-off scheduler carries no
        # autoscaler object at all, so the default path is unchanged
        self.autoscaler = None
        from .autoscaler import AutoscalerPolicy

        if (
            executor_provider is not None
            and AutoscalerPolicy.enabled_in(autoscaler_settings)
        ):
            self.attach_autoscaler(executor_provider, autoscaler_settings)

    # ------------------------------------------------------------ lifecycle
    def init(self) -> "SchedulerServer":
        self.event_loop.start()
        # restart-resume: re-arm every persisted active job before serving
        # (Running stages were stored Resolved, so their tasks re-dispatch
        # through the normal offer/poll path)
        recovered = self.state.task_manager.recover_active_jobs()
        if recovered:
            log.info("recovered %d active job(s): %s", len(recovered), recovered)
        # queued (pre-planning) jobs + buffered cancel intents come back
        # from the admission WAL in submit order (no-op when the WAL
        # knob is off)
        # slot counts are durable: reservations held by the process that
        # died leaked with it (its re-armed tasks are pending again), so
        # rebuild every executor's count from the persisted graphs —
        # without this a small fleet restarts into a dispatch deadlock.
        # Runs before the WAL replay so a replayed admission cannot race
        # its fresh reservations against the rebuild.
        reclaimed = self.state.executor_manager.reconcile_slots(
            self.state.task_manager.running_tasks_by_executor()
        )
        if reclaimed:
            log.info("reconciled leaked executor slots: %s", reclaimed)
        requeued = self.replay_admission_wal()
        if requeued:
            log.info(
                "replayed %d queued job(s) from the admission WAL: %s",
                len(requeued), requeued,
            )
        if recovered and self.policy == TaskSchedulingPolicy.PUSH_STAGED:
            # revive is not an offer: nothing else re-offers a recovered
            # job's re-armed tasks until some unrelated event happens by
            from .query_stage_scheduler import JobSubmitted

            for job_id in recovered:
                self.event_loop.get_sender().post(JobSubmitted(job_id))
        self._reaper = threading.Thread(
            target=self._reaper_loop, name="executor-reaper", daemon=True
        )
        self._reaper.start()
        self._spec_timer = threading.Thread(
            target=self._speculation_loop, name="speculation-timer", daemon=True
        )
        self._spec_timer.start()
        self._telemetry_timer = threading.Thread(
            target=self._telemetry_loop, name="cluster-telemetry", daemon=True
        )
        self._telemetry_timer.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.autoscaler is not None:
            self.autoscaler.close()
        self.event_loop.stop()
        self.state.executor_manager.close()
        self.state.events.close()

    def attach_autoscaler(
        self, provider, settings: Optional[Dict[str, str]] = None
    ):
        """Wire the elastic lifecycle loop onto this scheduler.  Callable
        before OR after ``init()`` (the timer re-checks each tick), which
        lets standalone mode attach once its port is actually bound."""
        from .autoscaler import Autoscaler, AutoscalerPolicy

        self.autoscaler = Autoscaler(
            self, provider, AutoscalerPolicy.from_settings(settings or {})
        )
        return self.autoscaler

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until the event loop has processed everything queued (test
        aid, mirrors the reference's await_condition polling)."""
        return self.event_loop.drain(timeout)

    # ------------------------------------------------------------ job entry
    def submit_job(self, job_id: str, session_id: str, plan: lp.LogicalPlan) -> None:
        self.event_loop.get_sender().post(JobQueued(job_id, session_id, plan))

    def update_task_status(
        self, executor_id: str, statuses: List[TaskInfo]
    ) -> None:
        """Reject updates from executors already declared dead
        (reference: scheduler_server/mod.rs:157-178)."""
        if self.state.executor_manager.is_dead_executor(executor_id):
            log.warning(
                "dropping %d task status(es) from dead executor %s",
                len(statuses),
                executor_id,
            )
            return
        try:
            meta = self.state.executor_manager.get_executor_metadata(executor_id)
        except Exception:
            # unknown executor (e.g. scheduler restarted and lost state):
            # drop rather than erroring the RPC, which would make the
            # executor's status reporter retry the same batch forever
            log.warning(
                "dropping %d task status(es) from unknown executor %s",
                len(statuses),
                executor_id,
            )
            return
        self.event_loop.get_sender().post(TaskUpdating(meta, statuses))

    def offer_reservation(self, reservations: List[ExecutorReservation]) -> None:
        self.event_loop.get_sender().post(ReservationOffering(reservations))

    def executor_lost(self, executor_id: str, reason: str = "") -> None:
        self.event_loop.get_sender().post(ExecutorLost(executor_id, reason))

    # ------------------------------------------------------- decommission
    def decommission_executor(
        self,
        executor_id: str,
        reason: str = "decommissioned by operator",
        timeout_s: Optional[float] = None,
    ) -> bool:
        """Graceful decommission: mark the executor DRAINING —
        it takes no new work from this moment — and ask it to drain:
        finish (or, past the timeout, cancel-and-hand-off) its running
        tasks, upload un-replicated shuffle partitions to the external
        store, report ExecutorStopped and exit.  The ExecutorStopped (or,
        for a wedged drain, the reaper's deadline) then rides the normal
        event-loop ExecutorLost path, which re-points shuffle locations
        at replicas and only recomputes what truly has no surviving copy.

        Pull-mode executors (no gRPC port) can't receive the drain RPC:
        they are marked draining (starving them of work) and the deadline
        concludes the drain.  Returns False for unknown executors."""
        em = self.state.executor_manager
        timeout = self.drain_timeout_s if timeout_s is None else timeout_s
        try:
            meta = em.get_executor_metadata(executor_id)
        except Exception:  # noqa: BLE001
            log.warning("cannot decommission unknown executor %s", executor_id)
            return False
        em.mark_draining(executor_id, timeout)
        log.info(
            "decommissioning executor %s (drain timeout %.0fs): %s",
            executor_id, timeout, reason,
        )
        if meta.grpc_port:
            # the drain RPC returns immediately; the executor drains in
            # the background and reports ExecutorStopped when done.  Off
            # the caller's thread: a dead host costs a 5s RPC timeout.
            def _ask() -> None:
                try:
                    from ..proto.rpc import executor_stub

                    executor_stub(meta.host, meta.grpc_port).StopExecutor(
                        pb.StopExecutorParams(
                            executor_id=executor_id,
                            reason=reason,
                            force=False,
                            drain=True,
                            drain_timeout_seconds=timeout,
                        ),
                        timeout=5,
                    )
                except Exception as e:  # noqa: BLE001
                    log.warning(
                        "drain RPC to %s failed (the deadline watchdog "
                        "will conclude the drain): %s", executor_id, e,
                    )

            threading.Thread(
                target=_ask, name="drain-executor", daemon=True
            ).start()
        return True

    # ------------------------------------------------------------ pull mode
    def poll_work(
        self,
        metadata: ExecutorMetadata,
        can_accept_task: bool,
        statuses: List[TaskInfo],
    ) -> Optional[pb.TaskDefinition]:
        """Pull-mode heart of the scheduler (reference: grpc.rs:56-175):
        save metadata + heartbeat, apply piggybacked statuses, then fill at
        most one task into the polling executor's free slot."""
        em = self.state.executor_manager
        if em.is_dead_executor(metadata.id):
            log.warning("rejecting poll from dead executor %s", metadata.id)
            return None
        self._save_poll_registration(metadata)

        if statuses:
            events, _ = self.state.update_task_statuses(metadata, statuses)
            post_job_events(self.state, self.event_loop.get_sender(), events)

        if not can_accept_task:
            return None
        reservation = ExecutorReservation(metadata.id)
        tm: TaskManager = self.state.task_manager
        assignments, _free, _pending = tm.fill_reservations([reservation])
        if not assignments:
            return None
        _executor_id, task = assignments[0]
        return tm.prepare_task_definition(task)

    def _save_poll_registration(self, metadata: ExecutorMetadata) -> None:
        from .executor_manager import ExecutorHeartbeat

        em = self.state.executor_manager
        try:
            em.get_executor_metadata(metadata.id)
        except Exception:
            em.register_executor(metadata)
            return
        em.save_heartbeat(ExecutorHeartbeat(metadata.id, time.time(), "active"))

    # -------------------------------------------------------------- reaper
    def _reaper_loop(self) -> None:
        """Periodically expire executors whose heartbeats timed out
        (reference: scheduler_server/mod.rs:192-253 expire_dead_executors),
        publish this scheduler's own liveness, and adopt jobs curated by
        dead peer schedulers (HA failover over a shared backend)."""
        while not self._stop.wait(self.reaper_interval_s):
            try:
                self._expire_dead_executors()
                self._expire_overdue_drains()
            except Exception:  # noqa: BLE001 - reaper must never die
                log.exception("dead-executor reaper iteration failed")
            try:
                self.heartbeat_self()
                self.take_over_dead_schedulers()
            except Exception:  # noqa: BLE001
                log.exception("scheduler-liveness sweep failed")

    def _speculation_loop(self) -> None:
        """Periodically post a SpeculationScan onto the event loop — the
        straggler/deadline scan itself runs on the event-loop thread, so
        every graph mutation keeps the single-thread discipline.  Idle
        schedulers (no active jobs) skip the post entirely.  The same
        timer drives the AdmissionPulse while the admission queue is
        non-empty (queue-wait expiry + the release catch-up for
        capacity freed outside job events, e.g. a new executor)."""
        from .query_stage_scheduler import AdmissionPulse, SpeculationScan

        while not self._stop.wait(max(0.05, self.speculation_interval_s)):
            try:
                if self.state.task_manager.active_job_ids():
                    self.event_loop.get_sender().post(SpeculationScan())
                if self.state.admission.queued_count():
                    self.event_loop.get_sender().post(AdmissionPulse())
            except Exception:  # noqa: BLE001 - timer must never die
                log.exception("speculation timer iteration failed")
            if self.autoscaler is not None:
                # the autoscaler rides the same cadence; its own tick()
                # contains provider failures, but belt-and-braces here —
                # this thread also drives speculation and admission
                try:
                    self.autoscaler.tick()
                except Exception:  # noqa: BLE001
                    log.exception("autoscaler tick failed")

    def _telemetry_loop(self) -> None:
        """Record the cluster-aggregate series (queue depth, running
        tasks, slots free, shuffle backlog) into the bounded timeseries
        rings — the history behind /api/cluster/timeseries; the same
        values are scrape-time gauges on /api/metrics."""
        while not self._stop.wait(max(0.1, self.telemetry_sample_s)):
            try:
                self.sample_cluster_telemetry()
            except Exception:  # noqa: BLE001 - timer must never die
                log.exception("cluster telemetry sample failed")

    def sample_cluster_telemetry(self) -> Dict[str, float]:
        """One cluster-aggregate sample (also callable from tests)."""
        state = self.state
        pending, running = state.task_manager.task_counts()
        em = state.executor_manager
        latest = state.telemetry.latest()
        metrics: Dict[str, float] = {
            "pending_tasks": pending,
            "running_tasks": running,
            "available_slots": em.available_slots(),
            "alive_executors": len(em.get_alive_executors()),
            "active_jobs": len(state.task_manager.active_job_ids()),
            "executors_quarantined": len(em.quarantined_executors()),
            "executors_draining": len(em.draining_executors()),
            "admission_queued_jobs": state.admission.queued_count(),
            # shuffle backlog: queued-but-unmoved bytes + pending replica
            # uploads summed over the latest executor snapshots
            "shuffle_queue_bytes": sum(
                (s.get("fetch_queue_bytes") or 0)
                + (s.get("write_queue_bytes") or 0)
                for s in latest.values()
                if isinstance(s, dict)
            ),
            "replicator_backlog": sum(
                s.get("replicator_backlog") or 0
                for s in latest.values()
                if isinstance(s, dict)
            ),
        }
        state.telemetry.record_cluster(metrics)
        return metrics

    def doctor_cluster_context(self) -> Dict[str, object]:
        """Live capacity context for the query doctor's cluster rules
        (underprovisioned_cluster, the scale-out-in-flight note on
        admission_queued_job) — shared by the REST and gRPC report
        handlers so both surfaces diagnose from identical numbers."""
        em = self.state.executor_manager
        ctx: Dict[str, object] = {
            "alive_executors": len(em.get_alive_executors()),
            "admission_queued_jobs": self.state.admission.queued_count(),
            "autoscaler_enabled": self.autoscaler is not None,
            "max_executors": 0,
        }
        if self.autoscaler is not None:
            launching = self.autoscaler.scale_out_in_flight()
            ctx["max_executors"] = self.autoscaler.policy.max_executors
            ctx["scale_out_in_flight"] = launching
            ctx["autoscaler_launching"] = self.autoscaler._count_phase(
                "launching"
            )
        else:
            # knob off: diagnose against the default ceiling so the
            # doctor can still say "this cluster could have scaled"
            from ..config import AUTOSCALER_MAX_EXECUTORS, BallistaConfig

            ctx["max_executors"] = BallistaConfig({})._get(
                AUTOSCALER_MAX_EXECUTORS
            )
        return ctx

    # --------------------------------------------------------- HA failover
    SCHEDULER_HB_PREFIX = "scheduler:"
    # a peer is dead only after missing several sweeps: the publish period
    # IS the sweep period, so the threshold must be a clear multiple of it
    # (executors use the same shape: 60s beats, 180s expiry)
    SCHEDULER_DEAD_SWEEPS = 3.0

    def heartbeat_self(self) -> None:
        """Publish this scheduler's liveness into the shared backend (the
        peer-visible analogue of executor heartbeats; its own keyspace so
        the executor-heartbeat watch never sees it)."""
        self.state.backend.put(
            Keyspace.Schedulers,
            f"{self.SCHEDULER_HB_PREFIX}{self.scheduler_id}",
            str(time.time()).encode(),
        )

    def take_over_dead_schedulers(
        self, timeout_s: Optional[float] = None
    ) -> List[str]:
        """Adopt active jobs curated by peers whose heartbeat expired.
        With a shared etcd-style backend this is the multi-scheduler HA
        story: any survivor resumes a dead curator's jobs (reference:
        curator ids in ``execution_graph.rs:99-101`` +
        ``backend/etcd.rs`` shared state)."""
        timeout = (
            timeout_s
            if timeout_s is not None
            else self.SCHEDULER_DEAD_SWEEPS * self.reaper_interval_s
        )
        now = time.time()
        adopted: List[str] = []
        for key, raw in self.state.backend.get_from_prefix(
            Keyspace.Schedulers, self.SCHEDULER_HB_PREFIX
        ):
            peer = key[len(self.SCHEDULER_HB_PREFIX):]
            if peer == self.scheduler_id:
                continue
            try:
                ts = float(raw.decode())
            except ValueError:
                continue
            if now - ts <= timeout:
                continue
            jobs = self.state.task_manager.take_over_jobs(peer)
            # the dead peer's QUEUED jobs (never planned, graph-less)
            # come over too: replay its admission-WAL entries under this
            # scheduler's curatorship, in the peer's submit order
            requeued = self.replay_admission_wal(curator=peer)
            # one survivor wins the takeover lock; clearing the heartbeat
            # makes the adoption idempotent across sweeps
            self.state.backend.delete(Keyspace.Schedulers, key)
            if jobs or requeued:
                log.warning(
                    "adopted %d job(s) + %d queued job(s) from dead "
                    "scheduler %s: %s",
                    len(jobs), len(requeued), peer, jobs + requeued,
                )
                adopted.extend(jobs)
                adopted.extend(requeued)
            if jobs:
                # the dead peer's reservations leaked with it; its
                # adopted jobs' tasks are pending again, so rebuild the
                # slot counts and re-offer (revive alone never offers)
                reclaimed = self.state.executor_manager.reconcile_slots(
                    self.state.task_manager.running_tasks_by_executor()
                )
                if reclaimed:
                    log.info(
                        "reconciled leaked executor slots on takeover: %s",
                        reclaimed,
                    )
                if self.policy == TaskSchedulingPolicy.PUSH_STAGED:
                    from .query_stage_scheduler import JobSubmitted

                    for job_id in jobs:
                        self.event_loop.get_sender().post(JobSubmitted(job_id))
        return adopted

    def replay_admission_wal(self, curator: Optional[str] = None) -> List[str]:
        """Re-enqueue every WAL-journaled queued job owned by ``curator``
        (default: this scheduler — the restart path; the reaper passes a
        dead peer's id on takeover).  Entries replay in submit order;
        jobs that already reached a durable downstream state (graph
        persisted or terminal) are stale and dropped instead.  Buffered
        cancel intents re-arm the same way, so a cancel raced with the
        crash still wins.  No-op unless ``--admission-wal-enabled``."""
        wal = self.state.admission_wal
        if wal is None:
            return []
        me = self.state.task_manager.scheduler_id
        target = me if curator is None else curator
        admission = self.state.admission
        restored: List[str] = []
        for key, rec in wal.load(target):
            job_id = rec.get("job_id") or ""
            if not job_id:
                continue
            if any(
                self.state.backend.get(ks, job_id) is not None
                for ks in (
                    Keyspace.ActiveJobs,
                    Keyspace.CompletedJobs,
                    Keyspace.FailedJobs,
                )
            ):
                # the job made it past the queue before the crash (its
                # graph persisted / went terminal): the entry is stale
                wal.register(job_id, key)
                wal.discard(job_id)
                continue
            if target != me:
                # takeover: re-stamp so a second failover replays again
                rec = wal.rewrite_curator(key, rec, me)
            try:
                plan = wal.decode_plan(rec)
            except Exception:  # noqa: BLE001 - poison entry must not wedge boot
                log.exception("dropping undecodable admission WAL entry %s", key)
                wal.register(job_id, key)
                wal.discard(job_id)
                continue
            if admission.restore(
                job_id,
                rec.get("session_id") or "",
                plan,
                rec.get("pool") or "default",
                rec.get("priority") or "batch",
                float(rec.get("pool_weight") or 1.0),
                int(rec.get("pool_max_running") or 0),
                float(rec.get("enqueued_unix") or time.time()),
                float(rec.get("max_wait_s") or 0.0),
            ):
                wal.register(job_id, key)
                restored.append(job_id)
        for job_id in wal.load_intents(target):
            admission.restore_cancel_intent(job_id)
            if target != me:
                wal.put_intent(job_id)  # re-stamp to the adopting curator
        if restored:
            from .query_stage_scheduler import AdmissionPulse

            self.event_loop.get_sender().post(AdmissionPulse())
        return restored

    def _expire_dead_executors(self) -> None:
        """Heartbeat-timeout expiry ONLY posts ExecutorLost: the loss
        itself (state removal, StopExecutor, rollback/repoint, drain
        bookkeeping) is handled on the event-loop thread exactly like
        gRPC-reported loss, so the two paths can never interleave a
        rollback with drain handling (previously the
        StopExecutor RPC ran here on the reaper thread)."""
        expired = self.state.executor_manager.get_expired_executors(
            self.executor_timeout_s
        )
        for hb in expired:
            age = time.time() - hb.timestamp
            log.warning(
                "executor %s heartbeat is %.0fs old (timeout %.0fs); removing",
                hb.executor_id,
                age,
                self.executor_timeout_s,
            )
            self.executor_lost(hb.executor_id, "heartbeat timed out")

    def _expire_overdue_drains(self) -> None:
        """A draining executor that never reported stopped inside its
        deadline (+grace) is declared lost — same event-loop path, so its
        tasks hand off and its locations re-point exactly once.  One
        still heartbeating (mid drain-upload) is deferred up to the
        hard cap rather than interrupted mid-copy — but only push-mode
        executors, which actually received the drain RPC; a pull-mode
        drain has nothing to wait on, the deadline concludes it."""
        em = self.state.executor_manager
        draining = set()
        for eid in em.get_alive_executors():
            try:
                if em.get_executor_metadata(eid).grpc_port:
                    draining.add(eid)
            except Exception:  # noqa: BLE001 - racing a removal
                pass
        for eid in em.overdue_drains(alive=draining):
            log.warning(
                "draining executor %s missed its drain deadline; "
                "declaring it lost", eid,
            )
            self.executor_lost(eid, "drain deadline exceeded")

    # --------------------------------------------------------------- misc
    def cancel_job(self, job_id: str) -> None:
        """Fail the job and tell executors to abort its running tasks over
        the pooled channel cache — one cached channel per executor instead
        of a fresh handshake per fan-out (reference: grpc.rs CancelJob →
        task_manager.rs:225-303)."""
        running = self.state.task_manager.cancel_job(job_id)
        if self.state.admission.queued_count():
            # a cancelled running job freed an admission slot from this
            # gRPC thread; queued-job release must run on the event loop
            from .query_stage_scheduler import AdmissionPulse

            self.event_loop.get_sender().post(AdmissionPulse())
        from ..proto.rpc import executor_stub

        for meta, pids in running:
            if not meta.grpc_port:
                continue
            try:
                executor_stub(meta.host, meta.grpc_port).CancelTasks(
                    pb.CancelTasksParams(
                        partition_ids=[p.to_proto() for p in pids]
                    ),
                    timeout=5,
                )
            except Exception as e:  # noqa: BLE001
                log.warning("CancelTasks on %s failed: %s", meta.id, e)
