"""The scheduler's brain: an event-driven job/stage state machine.

Counterpart of the reference's
``scheduler/src/scheduler_server/query_stage_scheduler.rs:65-202`` with the
same event vocabulary (``event.rs:27-43``): JobQueued → planning →
JobSubmitted → reservations → ReservationOffering → tasks launch;
TaskUpdating drives stage transitions and re-offers freed slots;
ExecutorLost rolls affected jobs back.  All mutations run on the single
event-loop thread.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional

from ..config import TaskSchedulingPolicy
from ..errors import BallistaError
from ..plan import logical as lp
from ..serde.scheduler_types import ExecutorMetadata
from .event_loop import EventAction, EventSender
from .execution_stage import TaskInfo
from .executor_manager import ExecutorReservation
from .state import SchedulerState

log = logging.getLogger(__name__)


# ------------------------------------------------------------------ events
@dataclass
class JobQueued:
    job_id: str
    session_id: str
    plan: lp.LogicalPlan


@dataclass
class JobSubmitted:
    job_id: str


@dataclass
class JobPlanningFailed:
    job_id: str
    error: str


@dataclass
class JobFinished:
    job_id: str


@dataclass
class JobRunningFailed:
    job_id: str
    error: str


@dataclass
class JobUpdated:
    job_id: str


@dataclass
class TaskUpdating:
    executor: ExecutorMetadata
    statuses: List[TaskInfo]


@dataclass
class ReservationOffering:
    reservations: List[ExecutorReservation] = field(default_factory=list)


@dataclass
class ExecutorLost:
    executor_id: str
    reason: str = ""


@dataclass
class SpeculationScan:
    """Periodic tick from the SchedulerServer's speculation timer: run
    one straggler/deadline scan on the event-loop thread (all graph
    mutations stay on the single-thread discipline)."""


@dataclass
class AdmissionPulse:
    """Periodic tick (same 1s timer) while the admission queue is
    non-empty: shed jobs queued past max_queue_wait_seconds and retry
    the release scan — the catch-up path for capacity that freed
    without a job event (an executor registering, a cancel from a gRPC
    thread)."""


def post_job_events(state: SchedulerState, sender, events) -> None:
    """Map task-manager job events onto scheduler events; shared by the
    event-loop TaskUpdating handler and the pull-mode poll_work path."""
    for job_id, ev in events:
        if ev == "job_completed":
            sender.post(JobFinished(job_id))
        elif ev == "job_failed":
            status = state.task_manager.get_job_status(job_id) or {}
            sender.post(JobRunningFailed(job_id, status.get("error", "task failed")))
        else:
            sender.post(JobUpdated(job_id))


class QueryStageScheduler(EventAction):
    def __init__(self, state: SchedulerState):
        self.state = state
        # event-loop observability: every mutation runs on this single
        # thread, so handling latency IS scheduler responsiveness
        self._event_latency = state.metrics.histogram(
            "scheduler_event_handle_seconds",
            "query-stage event handling latency (event-loop thread)",
            buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0),
        )
        self._events = state.metrics.counter(
            "scheduler_events_total", "query-stage events processed"
        )

    # ---------------------------------------------------------- dispatch
    def on_receive(self, event, sender: EventSender) -> None:
        import time as _t

        t0 = _t.monotonic()
        try:
            self._dispatch(event, sender)
        finally:
            self._events.inc()
            self._event_latency.observe(_t.monotonic() - t0)

    def _dispatch(self, event, sender: EventSender) -> None:
        if isinstance(event, JobQueued):
            self._on_job_queued(event, sender)
        elif isinstance(event, JobSubmitted):
            self._on_job_submitted(event, sender)
        elif isinstance(event, JobPlanningFailed):
            log.error("job %s planning failed: %s", event.job_id, event.error)
            self.state.task_manager.fail_job(event.job_id, event.error)
            self._admit_released(sender)
        elif isinstance(event, JobFinished):
            self.state.task_manager.complete_job(event.job_id)
            # the finished job freed an admission slot: queued jobs with
            # capacity now release by deficit-weighted round robin
            self._admit_released(sender)
        elif isinstance(event, JobRunningFailed):
            log.error("job %s failed: %s", event.job_id, event.error)
            self.state.task_manager.fail_job(event.job_id, event.error)
            self._admit_released(sender)
        elif isinstance(event, AdmissionPulse):
            self._on_admission_pulse(sender)
        elif isinstance(event, JobUpdated):
            self.state.task_manager.update_job(event.job_id)
        elif isinstance(event, TaskUpdating):
            self._on_task_updating(event, sender)
        elif isinstance(event, ReservationOffering):
            self._on_reservation_offering(event, sender)
        elif isinstance(event, ExecutorLost):
            self._on_executor_lost(event, sender)
        elif isinstance(event, SpeculationScan):
            self._on_speculation_scan(sender)
        else:
            log.warning("unknown scheduler event %r", event)

    # ----------------------------------------------------------- handlers
    def _on_job_queued(self, event: JobQueued, sender: EventSender) -> None:
        session_ctx = self.state.session_manager.get_session(event.session_id)
        if session_ctx is None:
            sender.post(
                JobPlanningFailed(event.job_id, f"unknown session {event.session_id}")
            )
            return
        try:
            outcome = self.state.submit_job(event.job_id, session_ctx, event.plan)
        except BallistaError as e:
            sender.post(JobPlanningFailed(event.job_id, str(e)))
            return
        except Exception as e:  # noqa: BLE001 - planning bugs must fail the job
            sender.post(JobPlanningFailed(event.job_id, f"internal error: {e}"))
            return
        if outcome == "queued":
            # admission-managed: the job sits in the queue pre-planning;
            # the release scan (run now, and again as capacity frees)
            # plans whichever jobs fair share admits — possibly this one
            self._admit_released(sender)
            return
        sender.post(JobSubmitted(event.job_id))

    def _admit_released(self, sender: EventSender) -> None:
        """Plan + submit every job the admission controller releases at
        current capacity (deficit-weighted round robin across pools).
        Runs on the event-loop thread, so queued-job planning keeps the
        same single-thread discipline as direct submits."""
        state = self.state
        for qj in state.admission.release():
            if state.admission.take_cancel_intent(qj.job_id):
                # cancel arrived while the job was queued/mid-release:
                # fail instead of planning (the slot frees immediately)
                state.admission.job_finished(qj.job_id)
                state.task_manager.fail_job(
                    qj.job_id, "job cancelled by user"
                )
                continue
            session_ctx = state.session_manager.get_session(qj.session_id)
            if session_ctx is None:
                sender.post(
                    JobPlanningFailed(
                        qj.job_id, f"unknown session {qj.session_id}"
                    )
                )
                continue
            try:
                state.submit_admitted_job(qj.job_id, session_ctx, qj.plan)
            except BallistaError as e:
                sender.post(JobPlanningFailed(qj.job_id, str(e)))
                continue
            except Exception as e:  # noqa: BLE001 - planning bugs fail the job
                sender.post(
                    JobPlanningFailed(qj.job_id, f"internal error: {e}")
                )
                continue
            sender.post(JobSubmitted(qj.job_id))

    def _on_admission_pulse(self, sender: EventSender) -> None:
        """Shed overdue queued jobs, then retry the release scan (the
        1s catch-up for capacity freed outside job events)."""
        for qj, error in self.state.admission.expire_overdue():
            self.state.task_manager.fail_job(qj.job_id, error)
        self._admit_released(sender)

    def _on_job_submitted(self, event: JobSubmitted, sender: EventSender) -> None:
        if self.state.policy != TaskSchedulingPolicy.PUSH_STAGED:
            return
        status = self.state.task_manager.get_job_status(event.job_id)
        if status is None:
            return
        # reserve as many slots as the job has runnable tasks right now
        entry = self.state.task_manager._entry(event.job_id)
        with entry.lock:
            graph = self.state.task_manager._load(event.job_id, entry)
            n = graph.available_tasks() if graph is not None else 0
        if n <= 0:
            return
        reservations = self.state.executor_manager.reserve_slots(n, event.job_id)
        if reservations:
            sender.post(ReservationOffering(reservations))

    def _on_task_updating(self, event: TaskUpdating, sender: EventSender) -> None:
        events, reservations = self.state.update_task_statuses(
            event.executor, event.statuses
        )
        post_job_events(self.state, sender, events)
        if self.state.policy == TaskSchedulingPolicy.PUSH_STAGED:
            # a retried/requeued task must land on a DIFFERENT executor
            # than the slot freed by its failure — reserve across the
            # cluster (quarantine-reset tasks mint nothing otherwise)
            retried = sum(
                1 for _, ev in events if ev in ("task_retried", "task_requeued")
            )
            if retried:
                reservations = list(reservations)
                _pending, hosts = self.state.task_manager.locality_pending()
                reservations.extend(
                    self.state.executor_manager.reserve_slots(
                        retried, preferred_hosts=hosts or None
                    )
                )
        if reservations:
            sender.post(ReservationOffering(reservations))
        self._drain_expulsions(sender)

    def _on_reservation_offering(
        self, event: ReservationOffering, sender: EventSender
    ) -> None:
        launched, leftover = self.state.offer_reservation(event.reservations)
        if leftover:
            # nothing runnable right now (tasks in flight gate the rest):
            # give the slots back — the next TaskUpdating re-mints them.
            # Re-posting here would spin the loop.
            self.state.executor_manager.cancel_reservations(leftover)
        self._drain_expulsions(sender)

    def _on_speculation_scan(self, sender: EventSender) -> None:
        events, slots_wanted = self.state.speculation.scan()
        post_job_events(self.state, sender, events)
        if slots_wanted and self.state.policy == TaskSchedulingPolicy.PUSH_STAGED:
            # duplicates must land on a DIFFERENT executor than the
            # straggler's; reserve cluster-wide and let pop_next_task's
            # same-host guard sort the placement
            reservations = self.state.executor_manager.reserve_slots(
                slots_wanted
            )
            if reservations:
                sender.post(ReservationOffering(reservations))
        if self.state.policy == TaskSchedulingPolicy.PUSH_STAGED:
            # locality liveness: a task deferred for its preferred host
            # gave its slot back; this periodic tick (the same 1s timer
            # driving the scan) re-mints reservations — host-ordered —
            # so the task dispatches the moment a preferred slot frees
            # or its locality wait expires.  locality_pending() is empty
            # unless some job opted into ballista.shuffle.locality_*.
            pending, hosts = self.state.task_manager.locality_pending()
            if pending > 0:
                reservations = self.state.executor_manager.reserve_slots(
                    pending, preferred_hosts=hosts or None
                )
                if reservations:
                    sender.post(ReservationOffering(reservations))

    def _drain_expulsions(self, sender: EventSender) -> None:
        """Executors whose repeated launch failures crossed the threshold
        become ExecutorLost — the standard rollback path — instead of the
        scheduler silently re-dispatching into a black hole."""
        for eid in self.state.executor_manager.take_pending_expulsions():
            sender.post(ExecutorLost(eid, "repeated launch failures"))

    def _on_executor_lost(self, event: ExecutorLost, sender: EventSender) -> None:
        """ALL executor-loss paths land here on the event-loop thread —
        gRPC ExecutorStopped, repeated launch failures, heartbeat expiry
        and drain deadlines — so rollback/repoint and drain bookkeeping
        serialize instead of racing across threads."""
        log.warning("executor %s lost: %s", event.executor_id, event.reason)
        em = self.state.executor_manager
        self.state.events.emit(
            "executor_lost",
            executor=event.executor_id,
            reason=(event.reason or "")[:200],
        )
        # the lost executor's telemetry series and labeled gauges go too
        # (its last snapshot must not read as a live executor forever)
        self.state.telemetry.forget_executor(event.executor_id)
        if not em.is_draining(event.executor_id):
            # a non-draining loss (crash/expiry) gets a best-effort
            # force-stop so a half-dead process stops serving; a DRAINED
            # executor is already exiting on its own terms
            self.state.try_stop_executor(event.executor_id, event.reason)
        em.remove_executor(event.executor_id)  # concludes any drain cycle
        affected = self.state.task_manager.executor_lost(event.executor_id)
        for job_id in affected:
            # bounded rollback: a stage reset past ballista.stage.max_attempts
            # failed the graph instead of resetting again
            status = self.state.task_manager.get_job_status(job_id) or {}
            if status.get("state") == "failed":
                sender.post(
                    JobRunningFailed(
                        job_id, status.get("error", "stage reset limit")
                    )
                )
            else:
                sender.post(JobUpdated(job_id))
        if affected and self.state.policy == TaskSchedulingPolicy.PUSH_STAGED:
            total = 0
            for job_id in affected:
                entry = self.state.task_manager._entry(job_id)
                with entry.lock:
                    graph = self.state.task_manager._load(job_id, entry)
                    if graph is not None:
                        total += graph.available_tasks()
            if total > 0:
                reservations = self.state.executor_manager.reserve_slots(total)
                if reservations:
                    sender.post(ReservationOffering(reservations))
