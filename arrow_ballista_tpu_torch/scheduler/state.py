"""Scheduler state facade bundling the managers.

Counterpart of the reference's ``scheduler/src/state/mod.rs``: owns the
backend + executor/task/session managers, performs job planning on submit,
and implements ``offer_reservation`` — the fill-and-launch cycle shared by
push scheduling and the pull-mode poll handler.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..config import BallistaConfig, TaskSchedulingPolicy
from ..context import SessionContext
from ..errors import BallistaError
from ..exec.operators import ExecutionPlan
from ..exec.planner import PhysicalPlanner
from ..obs import trace
from ..obs.recorder import get_recorder, trace_store
from ..obs.registry import MetricsRegistry
from ..plan import logical as lp
from ..plan.optimizer import optimize
from ..serde.scheduler_types import ExecutorMetadata
from .backend import StateBackend
from .execution_graph import Task
from .execution_stage import TaskInfo
from .executor_manager import ExecutorManager, ExecutorReservation
from .session_manager import SessionBuilder, SessionManager, default_session_builder
from .task_manager import TaskLauncher, TaskManager

log = logging.getLogger(__name__)


class SchedulerState:
    def __init__(
        self,
        backend: StateBackend,
        scheduler_id: str,
        policy: TaskSchedulingPolicy = TaskSchedulingPolicy.PULL_STAGED,
        session_builder: SessionBuilder = default_session_builder,
        launcher: Optional[TaskLauncher] = None,
        work_dir: str = "/tmp/ballista-tpu",
        liveness_window_s: float = 60.0,
        quarantine_threshold: Optional[int] = None,
        quarantine_window_s: Optional[float] = None,
        quarantine_backoff_s: Optional[float] = None,
        speculation_force_enabled: bool = False,
        task_timeout_force_s: float = 0.0,
        aqe_force_enabled: bool = False,
        admission_force_enabled: bool = False,
        admission_defaults: Optional[Dict[str, str]] = None,
        admission_wal_enabled: bool = False,
        cache_force_enabled: bool = False,
        cache_policy_force_enabled: bool = False,
        cache_settings: Optional[Dict[str, str]] = None,
        event_journal_dir: str = "",
        event_journal_rotate_bytes: Optional[int] = None,
        event_journal_segments: Optional[int] = None,
    ):
        from ..obs.events import (
            DEFAULT_KEEP_SEGMENTS,
            DEFAULT_ROTATE_BYTES,
            EventJournal,
        )
        from ..obs.timeseries import ClusterTelemetry, SloTracker
        from .executor_manager import (
            DEFAULT_QUARANTINE_BACKOFF_S,
            DEFAULT_QUARANTINE_THRESHOLD,
            DEFAULT_QUARANTINE_WINDOW_S,
        )

        self.backend = backend
        self.scheduler_id = scheduler_id
        self.policy = policy
        # unified metrics: one registry per scheduler instance (a test
        # process may run several side by side) backing /api/metrics and
        # the Prometheus endpoint; managers register their counters here
        self.metrics = MetricsRegistry()
        # continuous cluster telemetry: heartbeat snapshots and
        # the scheduler's own aggregates land in bounded downsampling
        # rings behind /api/cluster/health + /api/cluster/timeseries
        self.telemetry = ClusterTelemetry(registry=self.metrics)
        # structured event journal (off unless a directory is configured;
        # emit() is then one attribute check) — managers below share it
        self.events = EventJournal(
            event_journal_dir,
            rotate_bytes=(
                DEFAULT_ROTATE_BYTES
                if event_journal_rotate_bytes is None
                else event_journal_rotate_bytes
            ),
            keep_segments=(
                DEFAULT_KEEP_SEGMENTS
                if event_journal_segments is None
                else event_journal_segments
            ),
        )
        # per-session job-latency SLO (ballista.obs.slo.job_latency_seconds)
        self.slo = SloTracker(self.metrics)
        self.executor_manager = ExecutorManager(
            backend,
            liveness_window_s,
            quarantine_threshold=(
                DEFAULT_QUARANTINE_THRESHOLD
                if quarantine_threshold is None
                else quarantine_threshold
            ),
            quarantine_window_s=(
                DEFAULT_QUARANTINE_WINDOW_S
                if quarantine_window_s is None
                else quarantine_window_s
            ),
            quarantine_backoff_s=(
                DEFAULT_QUARANTINE_BACKOFF_S
                if quarantine_backoff_s is None
                else quarantine_backoff_s
            ),
            registry=self.metrics,
            events=self.events,
        )
        # scheduler flags seed cluster-wide defaults that an EXPLICIT
        # session setting still wins over (session settings ship sparse)
        overrides: Dict[str, str] = dict(admission_defaults or {})
        overrides.update(cache_settings or {})
        if overrides:
            BallistaConfig(overrides)  # fail fast on a bad operator knob
        if aqe_force_enabled:
            overrides["ballista.aqe.enabled"] = "true"
        if admission_force_enabled:
            overrides["ballista.admission.enabled"] = "true"
        if cache_force_enabled:
            overrides["ballista.cache.enabled"] = "true"
        if cache_policy_force_enabled:
            overrides["ballista.cache.policy.enabled"] = "true"
        # multi-tenant front door: the admission queue +
        # weighted fair release.  Always constructed; it only ever acts
        # on jobs whose merged config has ballista.admission.enabled, so
        # the default-off path is byte-identical to a scheduler without
        # it.  Release/planning of queued jobs runs on the query-stage
        # event loop (query_stage_scheduler._admit_released).  Any
        # ballista.admission.* key the operator set is PINNED: cluster
        # limits then ignore whatever the submitting session says.
        from .admission import AdmissionController

        self.admission = AdmissionController(
            self.executor_manager,
            registry=self.metrics,
            events=self.events,
            pinned_settings=overrides,
        )
        # plan-fingerprint result/shuffle cache + learned per-plan policy.  Always constructed — both layers are gated per-job
        # by ballista.cache.enabled / ballista.cache.policy.enabled, so a
        # default-off scheduler plans and dispatches byte-identically to
        # one without them.  Cached partitions live beside the external
        # shuffle store under the scheduler work dir.
        import os as _os

        from .plan_cache import PlanCache
        from .policy_store import PolicyStore

        self.plan_cache = PlanCache(_os.path.join(work_dir, "plan_cache"))
        self.policy_store = PolicyStore(
            _os.path.join(work_dir, "policy_store.json")
        )
        self.task_manager = TaskManager(
            backend, self.executor_manager, scheduler_id, launcher, work_dir,
            registry=self.metrics,
            events=self.events,
            slo=self.slo,
            config_overrides=overrides or None,
            admission=self.admission,
            plan_cache=self.plan_cache,
            policy_store=self.policy_store,
        )
        # durable admission queue: journal queued jobs +
        # cancel intents through the state backend so a restarted or
        # adopting scheduler replays them in submit order.  Off by
        # default — admission.wal stays None and every hook is a no-op.
        # The curator resolves lazily off the task manager because
        # __main__ finalizes the stable scheduler id after construction.
        self.admission_wal = None
        if admission_wal_enabled:
            from .queue_wal import AdmissionWal

            self.admission_wal = AdmissionWal(
                backend, lambda: self.task_manager.scheduler_id
            )
            self.admission.attach_wal(self.admission_wal)
        self.session_manager = SessionManager(backend, session_builder)
        # straggler mitigation: the periodic scan body (invoked on the
        # event-loop thread via the SpeculationScan event); the force
        # flags come from the scheduler binary and apply to every session
        from .speculation import SpeculationManager

        self.speculation = SpeculationManager(
            self,
            force_enabled=speculation_force_enabled,
            force_task_timeout_s=task_timeout_force_s,
        )
        # scrape-time gauges (computed on read, not pushed on change)
        self.metrics.gauge(
            "available_slots", "task slots free across alive executors",
            fn=self.executor_manager.available_slots,
        )
        self.metrics.gauge(
            "alive_executors", "executors inside the liveness window",
            fn=lambda: len(self.executor_manager.get_alive_executors()),
        )
        self.metrics.gauge(
            "active_jobs", "jobs currently cached as active",
            fn=lambda: len(self.task_manager.active_job_ids()),
        )
        self.metrics.gauge(
            "executors_quarantined", "executors currently in quarantine backoff",
            fn=lambda: len(self.executor_manager.quarantined_executors()),
        )
        self.metrics.gauge(
            "trace_store_spans", "spans held for /api/jobs/{id}/trace",
            fn=lambda: trace_store().span_count(),
        )
        # autoscaling/admission signals (ROADMAP item 3): queue depth and
        # slot saturation computed at scrape, recorded as history by the
        # SchedulerServer's cluster sampling loop
        # one task_counts() walk (it takes every cached job's entry lock)
        # feeds both gauges: the providers are read back-to-back in a
        # scrape, so a short memo halves the lock traffic without going
        # stale between scrapes
        counts_lock = threading.Lock()
        counts_state = {"mono": -1.0, "value": (0, 0)}

        def _task_counts_memo() -> Tuple[int, int]:
            with counts_lock:
                now = time.monotonic()
                if now - counts_state["mono"] > 0.1:
                    counts_state["value"] = self.task_manager.task_counts()
                    counts_state["mono"] = now
                return counts_state["value"]

        self.metrics.gauge(
            "pending_tasks", "dispatchable tasks waiting for a slot",
            fn=lambda: _task_counts_memo()[0],
        )
        self.metrics.gauge(
            "running_tasks", "tasks currently dispatched to executors",
            fn=lambda: _task_counts_memo()[1],
        )

    # ------------------------------------------------------------ planning
    def plan_job(
        self, session_ctx: SessionContext, plan: lp.LogicalPlan
    ) -> ExecutionPlan:
        """Logical → optimized → physical.  The TPU acceleration pass is NOT
        applied here: stage plans travel unaccelerated and each executor
        re-accelerates under its own session config."""
        optimized = optimize(plan)
        return PhysicalPlanner(session_ctx.config).create_physical_plan(optimized)

    def submit_job(
        self,
        job_id: str,
        session_ctx: SessionContext,
        plan: lp.LogicalPlan,
    ) -> str:
        """The scheduler's front door.  With admission enabled for this
        job (``ballista.admission.enabled`` — session setting or the
        ``--admission-enabled`` cluster default) the LOGICAL plan is
        offered to the admission controller FIRST: a saturated cluster
        holds the job queued pre-planning (no ExecutionGraph built, no
        memory pinned — returns ``"queued"``) or sheds it with a
        structured :class:`ClusterSaturated` raise.  The caller runs the
        release scan right after, so an uncontended job passes straight
        through.  Returns ``"submitted"`` once planned + submitted."""
        cfg = self._admission_config(session_ctx)
        if cfg.admission_enabled:
            decision = self.admission.offer(
                job_id, session_ctx.session_id, plan, cfg
            )
            for displaced, error in decision.displaced:
                # shed_policy=oldest displaced another session's queued
                # job to make room: fail it with the structured error
                self.task_manager.fail_job(displaced.job_id, error)
            if decision.error is not None:
                raise decision.error
            return "queued"
        self.submit_admitted_job(job_id, session_ctx, plan)
        return "submitted"

    def _admission_config(self, session_ctx: SessionContext) -> BallistaConfig:
        """Session settings over scheduler-flag defaults — the same
        merge TaskManager.submit_job applies at planning time."""
        settings = dict(self.task_manager.config_overrides)
        config = getattr(session_ctx, "config", None)
        if config is not None:
            settings.update(config.to_dict())
        return BallistaConfig(settings)

    def submit_admitted_job(
        self,
        job_id: str,
        session_ctx: SessionContext,
        plan: lp.LogicalPlan,
    ) -> None:
        """Plan + submit one job PAST the admission gate (direct path
        for admission-off jobs; the event loop's release handler for
        jobs coming off the queue)."""
        trace_id = self._maybe_start_trace(job_id, session_ctx)
        if trace_id:
            with trace.activate(trace_id), trace.span("job.plan", job=job_id):
                physical = self.plan_job(session_ctx, plan)
        else:
            physical = self.plan_job(session_ctx, plan)
        self.task_manager.submit_job(
            job_id, session_ctx.session_id, physical, trace_id=trace_id
        )
        # graph persisted (or terminal): the queue WAL entry is now
        # redundant — dropping it here (not at release) closes the
        # release→persist crash window
        self.admission.wal_discard(job_id)

    def _maybe_start_trace(self, job_id: str, session_ctx: SessionContext) -> str:
        """Mint the job's trace id when the session asks for observability
        (ratchets process tracing on; spans recorded in this process
        forward straight into the TraceStore — no transport needed).
        Returns "" for untraced/unsampled jobs."""
        config = getattr(session_ctx, "config", None)
        if config is None or not trace.enable_from_config(
            config, process="scheduler"
        ):
            return ""
        get_recorder().set_forward(trace_store().add)
        if not trace.sampled():
            return ""
        trace_id = trace.new_id()
        trace_store().bind(trace_id, job_id)
        return trace_id

    # ------------------------------------------------------------- updates
    def update_task_statuses(
        self, executor: ExecutorMetadata, statuses: List[TaskInfo]
    ) -> Tuple[List[Tuple[str, str]], List[ExecutorReservation]]:
        """Apply statuses; mint one reservation per finished task in push
        mode so freed slots immediately re-offer
        (reference: state/mod.rs:128-150)."""
        events = self.task_manager.update_task_statuses(executor, statuses)
        reservations = []
        if (
            self.policy == TaskSchedulingPolicy.PUSH_STAGED
            and not self.executor_manager.is_quarantined(executor.id)
            and not self.executor_manager.is_draining(executor.id)
        ):
            finished = sum(1 for s in statuses if s.state in ("completed", "failed"))
            reservations = [
                ExecutorReservation(executor.id) for _ in range(finished)
            ]
        return events, reservations

    # ------------------------------------------------------------ lifecycle
    def try_stop_executor(
        self, executor_id: str, reason: str, force: bool = True
    ) -> None:
        """Best-effort StopExecutor RPC on a detached thread (reference:
        scheduler_server/mod.rs:227-244).  Runs off-thread so the 5s RPC
        timeout against a dead host never stalls the caller — in
        particular the event-loop thread handling ExecutorLost."""
        try:
            meta = self.executor_manager.get_executor_metadata(executor_id)
        except Exception:  # noqa: BLE001 - already forgotten
            return
        if not meta.grpc_port:
            return

        def _stop() -> None:
            try:
                from ..proto import pb
                from ..proto.rpc import executor_stub

                executor_stub(meta.host, meta.grpc_port).StopExecutor(
                    pb.StopExecutorParams(
                        executor_id=executor_id, reason=reason, force=force
                    ),
                    timeout=5,
                )
            except Exception as e:  # noqa: BLE001 - executor may be gone
                log.debug("StopExecutor(%s) failed: %s", executor_id, e)

        threading.Thread(
            target=_stop, name="stop-executor", daemon=True
        ).start()

    # ------------------------------------------------------------ offering
    def offer_reservation(
        self, reservations: List[ExecutorReservation]
    ) -> Tuple[int, List[ExecutorReservation]]:
        """Fill reservations with tasks and launch them; returns
        (n_launched, leftover reservations to cancel or re-offer)
        (reference: state/mod.rs:188-248)."""
        assignments, free, pending = self.task_manager.fill_reservations(reservations)

        per_executor: Dict[str, List[Task]] = {}
        for executor_id, task in assignments:
            per_executor.setdefault(executor_id, []).append(task)

        launched = 0
        for executor_id, tasks in per_executor.items():
            try:
                meta = self.executor_manager.get_executor_metadata(executor_id)
                self.task_manager.launch_tasks(meta, tasks)
                launched += len(tasks)
            except BallistaError as e:
                log.warning("failed to launch tasks on %s: %s", executor_id, e)
                # tasks were reset by launch_tasks; slots go back too
                free.extend(ExecutorReservation(executor_id) for _ in tasks)

        if free and pending <= 0:
            self.executor_manager.cancel_reservations(free)
            free = []
        return launched, free
