"""Job lifecycle + task dispatch.

Counterpart of the reference's ``scheduler/src/state/task_manager.rs``:
graphs are built on submit, persisted to the ActiveJobs keyspace and cached
behind per-job locks; ``fill_reservations`` walks cached jobs popping tasks
into reserved slots; completed/failed jobs move keyspaces; ``launch_task``
pushes TaskDefinitions to executors through a pluggable launcher (a no-op
launcher stands in for gRPC in tests, mirroring the reference's
``#[cfg(test)]`` no-op, `task_manager.rs:440-449`).
"""

from __future__ import annotations

import random
import string
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..errors import SchedulerError
from ..exec.operators import ExecutionPlan
from ..obs import trace
from ..obs.export import AQE_OP, CACHE_OP, LOCALITY_OP
from ..obs.recorder import trace_store
from ..obs.registry import MetricsRegistry
from ..proto import pb
from ..serde import BallistaCodec, partitioning_to_proto
from ..serde.scheduler_types import ExecutorMetadata, PartitionId
from .backend import Keyspace, StateBackend
from .execution_graph import COMPLETED, FAILED, RUNNING, ExecutionGraph, Task
from .execution_stage import TaskInfo
from .executor_manager import ExecutorManager, ExecutorReservation


class TaskLauncher:
    """Transport for pushing tasks to executors (push scheduling)."""

    def launch(
        self,
        executor: ExecutorMetadata,
        tasks: List[pb.TaskDefinition],
        scheduler_id: str,
    ) -> None:
        raise NotImplementedError


class NoopLauncher(TaskLauncher):
    """Test stand-in; records what would have been sent."""

    def __init__(self) -> None:
        self.launched: List[Tuple[str, List[pb.TaskDefinition]]] = []

    def launch(self, executor, tasks, scheduler_id):
        self.launched.append((executor.id, tasks))


class GrpcLauncher(TaskLauncher):
    """Real transport: LaunchTask RPC on the executor's grpc port, over
    the process-wide pooled channel cache shared with every other
    scheduler→executor control-plane call (``proto/rpc.executor_stub``;
    reference: task_manager.rs:416-438)."""

    def launch(self, executor, tasks, scheduler_id):
        from ..proto.rpc import executor_stub

        stub = executor_stub(executor.host, executor.grpc_port)
        stub.LaunchTask(
            pb.LaunchTaskParams(tasks=tasks, scheduler_id=scheduler_id),
            timeout=20,
        )


def _plan_tree_text(plan: ExecutionPlan, depth: int = 0, limit: int = 40) -> str:
    """Indented one-line-per-operator tree for the dashboard plan view
    (the reference UI's query-plan panel; rendered as <pre> client-side)."""
    lines = ["  " * depth + str(plan)]
    if depth < limit:
        for child in plan.children():
            lines.append(_plan_tree_text(child, depth + 1, limit))
    return "\n".join(lines)


@dataclass
class JobEntry:
    lock: threading.RLock = field(default_factory=threading.RLock)
    graph: Optional[ExecutionGraph] = None


class TaskManager:
    def __init__(
        self,
        backend: StateBackend,
        executor_manager: ExecutorManager,
        scheduler_id: str,
        launcher: Optional[TaskLauncher] = None,
        work_dir: str = "/tmp/ballista-tpu",
        registry: Optional[MetricsRegistry] = None,
        events=None,
        slo=None,
        config_overrides: Optional[Dict[str, str]] = None,
        admission=None,
        plan_cache=None,
        policy_store=None,
    ):
        from ..obs.events import EventJournal

        self.backend = backend
        # multi-tenant admission controller (scheduler/admission.py);
        # None for bare TaskManagers in tests — every admission touch
        # point below is a no-op then
        self.admission = admission
        self.executor_manager = executor_manager
        self.scheduler_id = scheduler_id
        self.launcher = launcher or GrpcLauncher()
        self.work_dir = work_dir
        # scheduler-flag session-setting overrides (e.g. --aqe-enabled
        # forces ballista.aqe.enabled for every submitted job); applied
        # on top of the session settings at submit-time planning
        self.config_overrides = dict(config_overrides or {})
        # structured event journal + SLO tracker (obs/events.py,
        # obs/timeseries.py): shared with the owning SchedulerState; a
        # bare TaskManager (tests) gets a disabled journal
        self.events = events if events is not None else EventJournal()
        self.slo = slo
        # plan-fingerprint result/shuffle cache + learned per-plan policy
        # (scheduler/plan_cache.py, scheduler/policy_store.py); None for
        # bare TaskManagers and when the owning state never enables them.
        # Both are gated per-job by the session config knobs, so a wired
        # store with ballista.cache.enabled=false is still a no-op.
        self.plan_cache = plan_cache
        self.policy_store = policy_store
        # job_id -> learned props to stamp onto TaskDefinitions for keys
        # the session didn't set (mirrors the SHUFFLE_PIPELINED stamp)
        self._policy_props: Dict[str, Dict[str, str]] = {}
        self._cache: Dict[str, JobEntry] = {}
        self._cache_lock = threading.Lock()
        # scheduler-lifetime counters live in the unified registry
        # (obs/registry.py) backing /api/metrics + Prometheus exposition
        self.registry = registry or MetricsRegistry()
        self._retries = self.registry.counter(
            "task_retries_total",
            "transient-failure task re-queues over scheduler lifetime",
        )
        self._jobs_completed = self.registry.counter(
            "jobs_completed_total", "jobs that reached COMPLETED"
        )
        self._jobs_failed = self.registry.counter(
            "jobs_failed_total", "jobs that reached FAILED"
        )
        # speculative execution (scheduler/speculation.py drives the scan;
        # dispatch/commit paths here own the counters)
        self._spec_launched = self.registry.counter(
            "speculative_launched",
            "duplicate straggler attempts dispatched",
        )
        self._spec_wins = self.registry.counter(
            "speculative_wins",
            "partitions committed by a speculative duplicate",
        )
        self._spec_wasted = self.registry.counter(
            "speculative_wasted",
            "speculative duplicates that lost the race or died",
        )
        # replicated shuffle storage: scheduler-side rollup of
        # the data-plane counters so /api/metrics shows them even when
        # executors run in other processes
        self._replicas_written = self.registry.counter(
            "shuffle_replicas_written",
            "shuffle partitions committed with an external-store replica",
        )
        self._replica_fetches = self.registry.counter(
            "replica_fetches_total",
            "shuffle reads served by a replica after primary failover",
        )
        self._drain_handoffs = self.registry.counter(
            "drain_handoffs_total",
            "tasks handed off a draining executor without burning budget",
        )

    @property
    def task_retries_total(self) -> int:
        """Back-compat read surface for the old ad-hoc counter."""
        return int(self._retries.value)

    # ------------------------------------------------------------ helpers
    def _entry(self, job_id: str) -> JobEntry:
        with self._cache_lock:
            e = self._cache.get(job_id)
            if e is None:
                e = JobEntry()
                self._cache[job_id] = e
            return e

    def _load(self, job_id: str, entry: JobEntry) -> Optional[ExecutionGraph]:
        if entry.graph is not None:
            return entry.graph
        raw = self.backend.get(Keyspace.ActiveJobs, job_id)
        if raw is None:
            return None
        entry.graph = ExecutionGraph.decode(raw, self.work_dir)
        return entry.graph

    def _persist(self, graph: ExecutionGraph) -> None:
        # single choke point every graph mutation passes through: flush
        # wasted-duplicate counts into the registry so /api/metrics stays
        # reconciled with the per-stage spec_stats rollup whichever path
        # (commit, failure, reset, reap, executor loss) dropped the copy
        wasted = graph.take_spec_wasted()
        if wasted:
            self._spec_wasted.inc(wasted)
        # ...and drain the graph's queued journal events (stage
        # completion/skew, retries, speculation outcomes, reaps,
        # lost-shuffle recovery, drain handoffs) into the event journal —
        # drained unconditionally so a disabled journal never accumulates
        self.events.emit_many(
            graph.take_pending_events(),
            job=graph.job_id,
            trace=graph.trace_id,
        )
        try:
            self.backend.put(Keyspace.ActiveJobs, graph.job_id, graph.encode())
        except Exception:
            # store unreachable (outage) or write refused: the in-memory
            # graph now holds UNPERSISTED mutations — e.g. a task popped
            # by fill_reservations that its caller will never deliver
            # once this raises.  Drop the cached copy so the next load
            # re-reads the last persisted state; otherwise the mutation
            # strands (a "running" task no executor ever received).
            with self._cache_lock:
                e = self._cache.get(graph.job_id)
            if e is not None:
                e.graph = None
            raise

    def _cache_sync(self, graph: ExecutionGraph) -> None:
        """Plan-cache upkeep after task-status updates commit (caller
        holds the job entry lock): pin newly-completed eligible stages
        under their fingerprints, and evict entries the lost-shuffle
        recovery path proved hollow.  Best-effort — a cache failure must
        never fail the status update."""
        if self.plan_cache is None:
            return
        cfg = getattr(graph, "cache_config", None)
        if cfg is not None:
            from .plan_cache import store_completed

            try:
                store_completed(graph, self.plan_cache, cfg)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "plan-cache store failed for %s", graph.job_id
                )
        take = getattr(graph, "take_pending_cache_invalidations", None)
        if take is not None:
            for fp in take():
                try:
                    self.plan_cache.invalidate(fp)
                except Exception:
                    pass

    # ------------------------------------------------------------ recovery
    def recover_active_jobs(self) -> List[str]:
        """Resume every ActiveJobs graph from the backend (scheduler
        restart).  Graphs persist Running stages as Resolved
        (execution_graph.py module rule, mirroring the reference's
        ``execution_graph.rs:867-920``), so revive() re-marks their tasks
        dispatchable and the normal offer/poll path re-executes exactly
        the in-flight work — completed stages keep their locations.
        Returns the recovered job ids."""
        out: List[str] = []
        for job_id in self.backend.scan_keys(Keyspace.ActiveJobs):
            entry = self._entry(job_id)
            with entry.lock:
                graph = self._load(job_id, entry)
                if graph is None or graph.status in (COMPLETED, FAILED):
                    continue
                graph.revive()
                self._persist(graph)
                self._admission_adopt(graph)
                out.append(job_id)
        return out

    def _admission_adopt(self, graph: ExecutionGraph) -> None:
        """Restart/HA adoption: re-register a recovered admission-managed
        job with the controller so pool concurrency accounting survives.
        Queued (pre-planning) jobs are recovered separately: with
        ``--admission-wal-enabled`` the queue WAL replays them in submit
        order (``SchedulerServer.replay_admission_wal``); without it
        they are lost and their clients' retries re-enter the front
        door."""
        if self.admission is not None and graph.admission_enabled:
            self.admission.adopt_running(
                graph.job_id, graph.tenant_pool, graph.tenant_priority
            )

    def take_over_jobs(self, dead_scheduler_id: str) -> List[str]:
        """HA failover: adopt every active job CURATED by a dead peer
        scheduler (reference: jobs carry a curator scheduler id,
        ``execution_graph.rs:99-101``; with a shared etcd-style backend any
        surviving scheduler can resume them).  Returns adopted job ids."""
        out: List[str] = []
        lk = self.backend.lock(
            Keyspace.ActiveJobs, f"takeover:{dead_scheduler_id}"
        )
        with lk:
            for job_id in self.backend.scan_keys(Keyspace.ActiveJobs):
                entry = self._entry(job_id)
                with entry.lock:
                    entry.graph = None  # peer may have persisted newer state
                    graph = self._load(job_id, entry)
                    if graph is None or graph.status in (COMPLETED, FAILED):
                        continue
                    if graph.scheduler_id != dead_scheduler_id:
                        continue
                    graph.scheduler_id = self.scheduler_id
                    graph.revive()
                    # the adoption write carries the grant's fencing
                    # token (remote lease) — if this sweeper's lease
                    # lapsed (TTL outlived without a refresh), the store
                    # rejects the write and a live sweeper wins; local
                    # backends ignore the fence
                    try:
                        self.backend.put_txn(
                            [(Keyspace.ActiveJobs, job_id, graph.encode())],
                            fence=lk,
                        )
                    except Exception:
                        entry.graph = None  # store refused: reload
                        raise
                    self._admission_adopt(graph)
                    out.append(job_id)
        return out

    # -------------------------------------------------------------- submit
    def _policy_consult(
        self, job_id: str, plan: ExecutionPlan, config
    ) -> Tuple[str, str, Dict[str, str]]:
        """Shape-fingerprint the raw submitted plan (no source-snapshot
        identity — knob choices don't depend on the data) and ask the
        policy store which arm this run lands on.  Any failure degrades
        to baseline: the policy layer must never fail a submit."""
        from .plan_cache import plan_fingerprint

        try:
            fp = plan_fingerprint(plan, with_snapshot=False)
        except Exception:
            return "", "baseline", {}
        try:
            overrides, arm = self.policy_store.overrides_for(
                job_id, fp, config.cache_policy_shadow_fraction
            )
        except Exception:
            return fp, "baseline", {}
        return fp, arm, dict(overrides)

    def submit_job(
        self,
        job_id: str,
        session_id: str,
        plan: ExecutionPlan,
        trace_id: str = "",
    ) -> ExecutionGraph:
        from ..config import BallistaConfig

        # the session's config steers distributed planning (mesh gang
        # stages, shuffle data plane) exactly as it steers acceleration;
        # scheduler-flag overrides seed cluster-wide defaults that an
        # EXPLICIT session setting still wins over (session settings are
        # sparse — only user-set keys ship), so per-session A/B toggles
        # like ballista.aqe.enabled=false keep working under the flag
        session_settings = self._session_settings(session_id)
        settings = session_settings
        if self.config_overrides:
            settings = {**self.config_overrides, **settings}
        config = BallistaConfig(settings)
        # learned per-plan policy: overrides sit ABOVE
        # cluster-flag defaults but BENEATH explicit session settings, so
        # a user's deliberate knob always wins over what the store learned
        policy_fp, policy_arm, policy_overrides = "", "baseline", {}
        if self.policy_store is not None and config.cache_policy_enabled:
            policy_fp, policy_arm, policy_overrides = self._policy_consult(
                job_id, plan, config
            )
            if policy_overrides:
                settings = {
                    **self.config_overrides,
                    **policy_overrides,
                    **session_settings,
                }
                config = BallistaConfig(settings)
        if self.admission is not None and self.admission.take_cancel_intent(
            job_id
        ):
            # cancel raced the admission release: the user gave up while
            # the job sat queued — fail it instead of building a graph
            self.admission.job_finished(job_id)
            raise SchedulerError("job cancelled by user while queued")
        graph = ExecutionGraph(
            self.scheduler_id, job_id, session_id, plan, self.work_dir, config
        )
        # set BEFORE the graph becomes poppable: a concurrent pull-mode
        # PollWork may dispatch first-stage tasks the moment the entry is
        # cached, and those TaskDefinitions must already carry the trace
        graph.trace_id = trace_id
        # policy bookkeeping rides the in-memory graph only (decoded
        # graphs degrade to baseline — getattr defaults downstream)
        graph.policy_fp = policy_fp
        graph.policy_arm = policy_arm
        graph.policy_overrides = dict(policy_overrides)
        if policy_overrides:
            self._policy_props[job_id] = dict(policy_overrides)
            self.events.emit(
                "policy_applied",
                job=job_id,
                trace=trace_id,
                fingerprint=policy_fp,
                overrides=dict(policy_overrides),
            )
        # result/shuffle cache: serve matching stage
        # subtrees straight from the external store BEFORE revive() can
        # resolve/dispatch them; a serve failure must never fail a submit
        if self.plan_cache is not None and config.cache_enabled:
            graph.cache_config = config
            try:
                from .plan_cache import try_serve

                try_serve(graph, self.plan_cache, config)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "plan-cache serve failed for %s", job_id
                )
        graph.revive()
        self.events.emit(
            "job_submitted",
            job=job_id,
            trace=trace_id,
            session=session_id,
            stages=len(graph.stages),
            partitions=graph.output_partitions,
        )
        entry = self._entry(job_id)
        with entry.lock:
            entry.graph = graph
            try:
                self._persist(graph)
            except Exception:
                # nothing durable exists for this job: evict the cache
                # entry too, or active_job_ids() would report a phantom
                # job forever (KEDA's inflight metric never draining)
                with self._cache_lock:
                    self._cache.pop(job_id, None)
                raise
        if graph.status == COMPLETED:
            # full-plan cache hit: every stage was served, no task will
            # ever run, so no task-status update will drive completion —
            # close the job out right here (moves it to CompletedJobs,
            # records SLO/policy observations, emits the job span)
            self.complete_job(job_id)
        return graph

    def get_job_status(self, job_id: str) -> Optional[dict]:
        """Status snapshot: {state, error?, locations?}.

        Read-only: must NOT create a cache entry — a finished job's status
        is polled long after complete_job() evicted it, and a stray entry
        would make active_job_ids() (and the KEDA scaler's inflight metric)
        report the job forever."""
        if self.admission is not None:
            # a job held in the admission queue has no graph anywhere:
            # report QUEUED with its pool + position so clients can tell
            # a waiting job from a wedged one
            qs = self.admission.queued_status(job_id)
            if qs is not None:
                return qs
        return self._with_graph(job_id, self._status_of)

    @staticmethod
    def _status_of(graph: ExecutionGraph) -> dict:
        out = {"state": graph.status, "job_id": graph.job_id}
        if graph.status == FAILED:
            out["error"] = graph.error
        if graph.status == COMPLETED:
            out["locations"] = list(graph.output_locations)
        return out

    def _with_graph(self, job_id: str, fn):
        """Apply ``fn(graph)`` to the job's graph and return the result.

        For a cached (live) job, ``fn`` runs UNDER the entry lock — the
        scheduler mutates graph/stage state under that same lock from gRPC
        threads, so unlocked reads from the REST thread would race dict
        resizes mid-iteration.  Decoded (persisted) graphs are private
        copies and need no lock.  Read-only like get_job_status: never
        creates a cache entry."""
        with self._cache_lock:
            entry = self._cache.get(job_id)
        if entry is not None:
            with entry.lock:
                graph = self._load(job_id, entry)
                if graph is not None:
                    return fn(graph)
        for ks in (Keyspace.CompletedJobs, Keyspace.FailedJobs, Keyspace.ActiveJobs):
            raw = self.backend.get(ks, job_id)
            if raw is not None:
                return fn(ExecutionGraph.decode(raw, self.work_dir))
        return None

    def get_job_detail(self, job_id: str) -> Optional[dict]:
        """Per-stage drill-down for the scheduler UI (the reference UI's
        QueriesList row expansion, ``ballista/ui/scheduler/src/components/
        QueriesList.tsx``): stage state machine position, task progress
        and merged operator metrics per stage."""
        if self.admission is not None:
            qs = self.admission.queued_status(job_id)
            if qs is not None:
                return qs
        return self._with_graph(job_id, self._detail_of)

    def _detail_of(self, graph: ExecutionGraph) -> dict:
        from ..obs.critical_path import stage_timing_of

        detail = self._status_of(graph)
        detail["task_retries"] = graph.task_retries
        detail["stage_resets"] = dict(graph.stage_reset_counts)
        # job-level timeline anchors for critical-path attribution
        # (persisted with the graph, so a decoded copy keeps the
        # ORIGINAL submit anchor)
        detail["submitted_us"] = graph.submitted_unix_ns // 1000
        detail["planning_us"] = getattr(graph, "planning_ns", 0) // 1000
        # per-job attempt histogram: {attempts_consumed: n_tasks}; tasks
        # that never failed land in bucket 0
        histogram: Dict[int, int] = {}
        stages = []
        for sid in sorted(graph.stages):
            stage = graph.stages[sid]
            state = type(stage).__name__.replace("Stage", "")
            row = {
                "stage_id": sid,
                "state": state,
                "partitions": stage.partitions,
            }
            count = getattr(stage, "completed_tasks", None)
            if count is not None:
                row["completed_tasks"] = count()
            attempts = getattr(stage, "task_attempts", None)
            if attempts is not None:
                for p in range(stage.partitions):
                    a = attempts.get(p, 0)
                    histogram[a] = histogram.get(a, 0) + 1
                if attempts:
                    row["task_attempts"] = dict(attempts)
                row["task_retries"] = sum(attempts.values())
            fetch_retries = getattr(stage, "task_fetch_retries", None)
            if fetch_retries:
                row["fetch_retries"] = sum(fetch_retries.values())
            spec_stats = getattr(stage, "spec_stats", None)
            if spec_stats:
                row["speculation"] = dict(spec_stats)
            aqe = getattr(stage, "aqe", None) or (
                getattr(stage, "stage_metrics", None) or {}
            ).get(AQE_OP)
            if aqe:
                # adaptive re-plan outcome (tasks before/after, rewrite
                # counts) — also persisted inside stage_metrics[__aqe__]
                row["aqe"] = dict(aqe)
            served = (getattr(stage, "stage_metrics", None) or {}).get(
                CACHE_OP
            )
            if served:
                # plan-cache serve outcome: the stage (and its elided
                # upstream subtree) never dispatched a task
                row["cache"] = dict(served)
            placement = getattr(stage, "locality_stats", None) or (
                getattr(stage, "stage_metrics", None) or {}
            ).get(LOCALITY_OP)
            if placement:
                # locality placement outcome: tasks dispatched on their
                # preferred (most-input-bytes) host vs anywhere else
                row["locality_placement"] = dict(placement)
            pipeline = self._pipeline_of(stage)
            if pipeline:
                # pipelined-execution classification (streamable vs
                # pipeline-breaker inputs) + whether the stage actually
                # started on partial input — the doctor's evidence for
                # whether barrier_wait upside is reachable
                row["pipeline"] = pipeline
            failures = getattr(stage, "task_failures", None)
            if failures:
                row["failures"] = {p: list(h) for p, h in failures.items()}
            metrics = getattr(stage, "stage_metrics", None)
            if metrics:
                row["metrics"] = {
                    op: dict(vals) for op, vals in metrics.items()
                }
            err = getattr(stage, "error", "")
            if err:
                row["error"] = err
            # critical-path timeline anchors (live attrs on
            # Resolved/Running stages, persisted synthetic metrics on
            # Completed ones) — obs/critical_path.py's input
            timing = stage_timing_of(stage)
            if timing:
                row["timing"] = timing
            # DAG edges + operator tree for the dashboard's SVG plan view
            # (the reference UI renders the stage graph; QueriesList.tsx)
            row["output_links"] = list(getattr(stage, "output_links", []))
            row["plan"] = _plan_tree_text(stage.plan)
            stages.append(row)
        detail["stages"] = stages
        detail["attempt_histogram"] = histogram
        # decoded (persisted) graphs lose the live counter but keep the
        # per-task attempts; derive so completed jobs still report retries
        attempts_total = sum(a * n for a, n in histogram.items())
        detail["task_retries"] = max(detail["task_retries"], attempts_total)
        return detail

    @staticmethod
    def _pipeline_of(stage) -> dict:
        """Per-stage pipelined-execution block for the job detail:
        streamable/breaker input classification (planner walk — works on
        unresolved placeholders and resolved readers alike) plus the
        partial-start marker (live flag on Running stages, persisted
        ``__pipelined__`` metric on Completed ones)."""
        from ..obs.export import PIPELINED_OP
        from .planner import classify_shuffle_inputs

        out: dict = {}
        if getattr(stage, "inputs", None):
            try:
                streamable, breakers = classify_shuffle_inputs(stage.plan)
            except Exception:  # noqa: BLE001 - classification is advisory
                streamable, breakers = set(), set()
            if streamable or breakers:
                out["streamable_inputs"] = sorted(streamable)
                out["breaker_inputs"] = sorted(breakers)
        partial = getattr(stage, "started_on_partial", False) or bool(
            (getattr(stage, "stage_metrics", None) or {}).get(PIPELINED_OP)
        )
        if partial:
            out["partial_start"] = True
        return out

    def get_job_dot(self, job_id: str) -> Optional[str]:
        """GraphViz text of the job's stage DAG (reference: the UI's plan
        view via ``core/src/utils.rs produce_diagram``)."""
        from ..utils.diagram import produce_diagram

        return self._with_graph(job_id, produce_diagram)

    def get_job_progress(self, job_id: str) -> Optional[dict]:
        """Live progress snapshot (``GET /api/jobs/{id}/progress`` and
        the gRPC ``include_progress`` poll): per-stage
        done/running/pending task counts and written bytes, plus a job
        ETA extrapolated from the observed median task runtime and the
        current dispatch width.  Cheap by design — the client poll loop
        may request it every interval."""
        if self.admission is not None:
            qs = self.admission.queued_status(job_id)
            if qs is not None:
                # still in the admission queue: no graph, no stages —
                # progress is the queue coordinates
                return {
                    **qs,
                    "stages": [],
                    "tasks_total": 0,
                    "tasks_done": 0,
                    "tasks_running": 0,
                    "eta_s": None,
                }
        return self._with_graph(job_id, self._progress_of)

    @staticmethod
    def _progress_of(graph: ExecutionGraph) -> dict:
        import statistics

        from .execution_stage import CompletedStage, RunningStage

        out = {
            "job_id": graph.job_id,
            "state": graph.status,
            "stages": [],
        }
        if graph.status == FAILED:
            out["error"] = graph.error
        total = done = running_now = 0
        runtimes: List[float] = []
        cache_elided = getattr(graph, "cache_elided", None) or set()
        cache_served = getattr(graph, "cache_served", None) or {}
        for sid in sorted(graph.stages):
            stage = graph.stages[sid]
            n = stage.partitions
            row = {
                "stage_id": sid,
                "state": type(stage).__name__.replace("Stage", ""),
                "partitions": n,
                "completed": 0,
                "running": 0,
                "pending": n,
            }
            if sid in cache_elided:
                # upstream of a cache-served stage: will never dispatch a
                # task — excluded from the task totals so a (partially)
                # served job's done/total fraction still reaches 1.0
                row["pending"] = 0
                row["cache_elided"] = True
                out["stages"].append(row)
                continue
            total += n
            if sid in cache_served:
                row["cache_served"] = True
            if isinstance(stage, (RunningStage, CompletedStage)):
                completed = stage.completed_tasks()
                row["completed"] = completed
                done += completed
                if isinstance(stage, RunningStage):
                    active = sum(
                        1
                        for t in stage.task_statuses
                        if t is not None and t.state == "running"
                    )
                    row["running"] = active
                    running_now += active
                    if stage.started_on_partial:
                        # pipelined: these runtimes include stall-on-
                        # producer, so they must not inflate the
                        # observed-median ETA; the flag also tells
                        # clients the "running" tasks are streaming a
                        # producer that is NOT done yet
                        row["partial_input"] = True
                    else:
                        runtimes.extend(stage.completed_runtime_s)
                    bytes_wire = sum(
                        b.get("wire", 0) for b in stage.task_bytes.values()
                    )
                else:
                    from ..obs.export import PIPELINED_OP, TASK_RUNTIME_OP

                    if not stage.stage_metrics.get(PIPELINED_OP):
                        ms = stage.stage_metrics.get(TASK_RUNTIME_OP, {})
                        runtimes.extend(v / 1e3 for v in ms.values())
                    bytes_wire = sum(
                        stage.output_partition_bytes().values()
                    )
                row["pending"] = max(0, n - row["completed"] - row["running"])
                if bytes_wire:
                    row["bytes_wire"] = bytes_wire
            out["stages"].append(row)
        out["tasks_total"] = total
        out["tasks_done"] = done
        out["tasks_running"] = running_now
        if graph.status in (COMPLETED, FAILED):
            # a decoded (evicted) graph re-stamps its monotonic anchor,
            # so terminal elapsed comes from the persisted wall anchors:
            # submit (graph proto) → the last task commit anywhere (a
            # FAILED job has no final-stage completion, but its finished
            # stages persist __stage_timing__ too)
            from ..obs.export import STAGE_TIMING_OP

            submitted = graph.submitted_unix_ns // 1000
            end = 0
            for stage in graph.stages.values():
                metrics = getattr(stage, "stage_metrics", None) or {}
                end = max(
                    end,
                    metrics.get(STAGE_TIMING_OP, {}).get("completed_us", 0),
                )
                fin = getattr(stage, "task_finish_unix_ns", None)
                if fin:
                    end = max(end, max(fin.values()) // 1000)
            out["elapsed_s"] = (
                round((end - submitted) / 1e6, 3) if end > submitted else None
            )
        else:
            out["elapsed_s"] = round(
                (time.monotonic_ns() - graph.submitted_mono_ns) / 1e9, 3
            )
        remaining = total - done
        if graph.status == RUNNING and remaining > 0 and runtimes:
            # optimistic-but-useful ETA: remaining waves at the observed
            # median task runtime over the current dispatch width
            import math

            width = max(1, running_now)
            out["eta_s"] = round(
                statistics.median(runtimes) * math.ceil(remaining / width), 3
            )
        else:
            out["eta_s"] = None if graph.status == RUNNING else 0.0
        return out

    # ------------------------------------------------------------- updates
    def update_task_statuses(
        self,
        executor: ExecutorMetadata,
        statuses: List[TaskInfo],
    ) -> List[Tuple[str, str]]:
        """Group statuses per job, apply to graphs; returns
        [(job_id, event)] with event in
        job_updated/job_completed/job_failed/task_retried
        (reference: task_manager.rs:132-170).

        Failed statuses feed the executor quarantine window; an executor
        quarantined by this batch gets its in-flight tasks reset so they
        re-dispatch elsewhere immediately instead of timing out."""
        per_job: Dict[str, List[TaskInfo]] = {}
        for s in statuses:
            # FailedTask carries no executor id on the wire; the reporting
            # executor ran it — stamp it for exclusion/quarantine tracking
            if s.state == "failed" and not s.executor_id:
                s.executor_id = executor.id
            per_job.setdefault(s.partition_id.job_id, []).append(s)

        events: List[Tuple[str, str]] = []
        newly_quarantined: List[str] = []
        cancels: List[Tuple[str, PartitionId]] = []
        feed_pushes: List[tuple] = []
        draining = self.executor_manager.is_draining(executor.id)
        for job_id, infos in per_job.items():
            entry = self._entry(job_id)
            with entry.lock:
                graph = self._load(job_id, entry)
                if graph is None:
                    continue
                for info in infos:
                    if info.spans:
                        # piggybacked executor spans → per-job trace store
                        # (dedup by span id there; stale-attempt statuses
                        # still surrender their spans before being dropped)
                        trace_store().add(info.spans)
                        info.spans = []
                    if draining and info.state == "failed" and (
                        self._is_drain_handoff(info.error)
                    ):
                        # graceful decommission: a draining executor's
                        # cancellations/transient failures are HANDOFFS —
                        # re-queue elsewhere without burning the failure
                        # budget or feeding quarantine.  Structured
                        # lost-shuffle failures and genuine fatal errors
                        # still take the normal classification path (a
                        # handoff would re-burn a full fetch cycle on
                        # vanished data, or delay a poison-pill verdict).
                        if graph.handoff_task(info.partition_id, executor.id):
                            self._drain_handoffs.inc()
                            events.append((job_id, "task_requeued"))
                        continue
                    evs = graph.update_task_status(info, executor)
                    if info.state == "completed" and evs:
                        # committed (not a stale duplicate): roll the
                        # data-plane replica counters up scheduler-side
                        self._replicas_written.inc(
                            sum(1 for p in info.partitions if p.replica_path)
                        )
                        fetched_from_replica = sum(
                            int(vals.get("replica_fetches", 0))
                            for _, vals in info.metrics
                        )
                        if fetched_from_replica:
                            self._replica_fetches.inc(fetched_from_replica)
                    for ev in evs:
                        # speculation outcomes feed counters, not the
                        # job-event stream (the accompanying completion
                        # already carries job_updated/job_completed)
                        if ev == "speculative_win":
                            self._spec_wins.inc()
                            continue
                        if ev == "speculative_wasted":
                            continue  # counted via _persist's drain
                        if ev == "task_retried":
                            self._retries.inc()
                        events.append((job_id, ev))
                    if info.state == "failed" and evs:
                        from .failure import indicts_reporter

                        # only infrastructure (transient) failures that the
                        # graph actually PROCESSED indict the host: a fatal
                        # plan/serde error is the job's fault, a stale
                        # duplicate of a superseded attempt (evs == [])
                        # must not re-count one real failure into the
                        # quarantine window, and a lost-shuffle fetch
                        # failure blames the vanished producer data, not
                        # the healthy consumer host
                        if indicts_reporter(info.error) and (
                            self.executor_manager.record_task_failure(
                                info.executor_id
                            )
                        ):
                            newly_quarantined.append(info.executor_id)
                cancels.extend(graph.take_pending_cancels())
                feed_pushes.extend(self._collect_feed_pushes(graph))
                self._cache_sync(graph)
                self._persist(graph)
        if cancels:
            # after the locks drop: losing duplicate attempts / reaped
            # stragglers get a best-effort CancelTasks fan-out
            self.cancel_task_attempts(cancels)
        self._push_shuffle_deltas(feed_pushes)
        for eid in newly_quarantined:
            for job_id, n in self.reset_executor_running_tasks(eid).items():
                # one task_requeued per reset task: the event loop mints a
                # replacement reservation for each in push mode (the
                # quarantined executor's own slots are sidelined)
                self._retries.inc(n)
                events.extend([(job_id, "task_requeued")] * n)
        return events

    @staticmethod
    def _is_drain_handoff(error: str) -> bool:
        """Which failures from a DRAINING executor are absorbed as
        budget-free handoffs: its drain-timeout cancellations (fatal by
        classification, but deliberate here) and transient infra noise.
        ShuffleFetchFailed must reach ``_recover_lost_shuffle`` and other
        fatal errors must fail fast as usual."""
        from .failure import FATAL, classify_failure, parse_shuffle_fetch_failure

        err = (error or "").strip()
        if err.startswith("Cancelled"):
            return True
        if parse_shuffle_fetch_failure(err) is not None:
            return False
        return classify_failure(err) != FATAL

    # -------------------------------------------- pipelined feed plane
    def get_shuffle_location_delta(
        self, job_id: str, stage_id: int, from_index: int
    ) -> dict:
        """``GetShuffleLocationDelta`` body: one producer feed's delta
        from ``from_index``.  Feeds live only on CACHED graphs (they are
        in-memory scheduler state) — an evicted/restarted job reports
        the feed invalid, which aborts the tail; the task's late status
        is then dropped by the rolled-back-stage guards."""
        invalid = {
            "stage": stage_id,
            "from_index": 0,
            "locations": [],
            "complete": False,
            "epoch": 0,
            "valid": False,
        }
        with self._cache_lock:
            entry = self._cache.get(job_id)
        if entry is None:
            return invalid
        with entry.lock:
            graph = entry.graph
            if graph is None:
                return invalid
            return graph.shuffle_feed_delta(stage_id, from_index)

    def _collect_feed_pushes(self, graph: ExecutionGraph) -> List[tuple]:
        """Under the job entry lock: drain the graph's queued feed
        deltas and resolve push targets (executors currently running
        tailing consumer tasks).  Deltas with no live target are simply
        dropped — the executor-side poll fallback reads the same feed."""
        deltas = graph.take_pending_feed_deltas()
        out: List[tuple] = []
        for d in deltas:
            targets = graph.tailing_executors(d["stage"])
            if targets:
                out.append((graph.job_id, d, sorted(targets)))
        return out

    def _executor_fanout(
        self,
        items: List[Tuple[str, object]],
        send,
        thread_name: str,
        log_label: str,
        log_level: int = 30,  # logging.WARNING
    ) -> None:
        """Best-effort per-executor RPC fan-out shared by CancelTasks and
        UpdateShuffleLocations: group ``(executor_id, payload)`` items,
        resolve each executor's metadata once (unknown executors are
        skipped — they may be gone — and pull-mode executors, which
        expose no gRPC port, never receive pushes), then run
        ``send(stub, payloads)`` per executor on ONE detached daemon
        thread over the pooled channel cache.  Detached because every
        payload here is advisory (guards/polls cover a lost RPC) and a
        dead executor's RPC timeout must never stall the event-loop
        thread issuing it; failures log at ``log_level`` and move on."""
        per: Dict[str, List[object]] = {}
        metas: Dict[str, ExecutorMetadata] = {}
        for executor_id, payload in items:
            if not executor_id:
                continue
            if executor_id not in metas:
                try:
                    metas[executor_id] = (
                        self.executor_manager.get_executor_metadata(executor_id)
                    )
                except Exception:  # noqa: BLE001 - executor may be gone
                    continue
            if not metas[executor_id].grpc_port:
                continue
            per.setdefault(executor_id, []).append(payload)
        if not per:
            return

        def run() -> None:
            import logging

            from ..proto.rpc import executor_stub

            for executor_id, payloads in per.items():
                meta = metas[executor_id]
                try:
                    send(
                        executor_stub(meta.host, meta.grpc_port), payloads
                    )
                except Exception as e:  # noqa: BLE001 - advisory RPC
                    logging.getLogger(__name__).log(
                        log_level, "%s to %s failed: %s",
                        log_label, executor_id, e,
                    )

        threading.Thread(target=run, name=thread_name, daemon=True).start()

    def _push_shuffle_deltas(self, pushes: List[tuple]) -> None:
        """Best-effort UpdateShuffleLocations fan-out (push mode) to the
        executors running tailing consumer tasks; failures only log at
        debug — the executor-side poll fallback reads the same feed."""
        items = [
            (eid, (job_id, delta))
            for job_id, delta, targets in pushes
            for eid in targets
        ]

        def send(stub, payloads) -> None:
            params = pb.UpdateShuffleLocationsParams()
            for job_id, delta in payloads:
                m = params.deltas.add()
                m.job_id = job_id
                m.stage_id = delta["stage"]
                m.from_index = delta["from_index"]
                m.complete = delta["complete"]
                m.valid = delta["valid"]
                m.epoch = delta["epoch"]
                for loc in delta["locations"]:
                    m.locations.add().CopyFrom(loc.to_proto())
            stub.UpdateShuffleLocations(params, timeout=5)

        self._executor_fanout(
            items, send, "shuffle-delta-fanout", "UpdateShuffleLocations",
            log_level=10,  # logging.DEBUG
        )

    def cancel_task_attempts(
        self, cancels: List[Tuple[str, PartitionId]]
    ) -> None:
        """Best-effort CancelTasks fan-out for losing duplicate attempts
        and reaped stragglers: a cancel is advisory (the
        committed-partition guard drops the loser's results either way)."""

        def send(stub, pids) -> None:
            stub.CancelTasks(
                pb.CancelTasksParams(
                    partition_ids=[p.to_proto() for p in pids]
                ),
                timeout=5,
            )

        self._executor_fanout(
            cancels, send, "cancel-tasks-fanout", "CancelTasks"
        )

    def reset_executor_running_tasks(self, executor_id: str) -> Dict[str, int]:
        """Re-queue (with exclusion) every in-flight task on a quarantined
        executor across cached jobs; returns {job_id: tasks reset}.  Unlike
        ``executor_lost`` this does NOT roll back completed shuffle output
        — the host is sick, not gone, and its files are still servable."""
        with self._cache_lock:
            job_ids = list(self._cache.keys())
        affected: Dict[str, int] = {}
        for job_id in job_ids:
            entry = self._entry(job_id)
            with entry.lock:
                graph = self._load(job_id, entry)
                if graph is None or graph.status in (COMPLETED, FAILED):
                    continue
                n = graph.reset_running_tasks(executor_id)
                if n:
                    affected[job_id] = n
                    self._persist(graph)
        return affected

    def running_tasks_by_executor(self) -> Dict[str, int]:
        """Dispatched tasks per executor across every ActiveJobs graph in
        the backend (all curators — with a shared backend a peer's
        in-flight work counts too).  Input for the restart-time slot
        reconcile."""
        per: Dict[str, int] = {}
        for job_id in self.backend.scan_keys(Keyspace.ActiveJobs):
            entry = self._entry(job_id)
            with entry.lock:
                graph = self._load(job_id, entry)
                if graph is None or graph.status in (COMPLETED, FAILED):
                    continue
                for eid, n in graph.running_tasks_by_executor().items():
                    per[eid] = per.get(eid, 0) + n
        return per

    # ------------------------------------------------------------ dispatch
    def fill_reservations(
        self, reservations: List[ExecutorReservation]
    ) -> Tuple[List[Tuple[str, Task]], List[ExecutorReservation], int]:
        """Assign tasks to reserved slots.  Returns (assignments as
        (executor_id, task), unassigned reservations, pending tasks count)
        (reference: task_manager.rs:184-221)."""
        em = self.executor_manager
        quarantined = set(em.quarantined_executors())
        # quarantined AND draining executors' slots sit out this cycle
        # entirely — returned unfilled so the caller cancels them back to
        # the pool (a draining executor must never take NEW work)
        sitting_out = quarantined | set(em.draining_executors())
        free = [r for r in reservations if r.executor_id not in sitting_out]
        sidelined = [r for r in reservations if r.executor_id in sitting_out]
        assignments: List[Tuple[str, Task]] = []
        pending = 0

        # exclusion escape hatch: a task is never retried on the executor
        # that just failed it UNLESS that executor is the only live
        # candidate (otherwise a 1-executor cluster could never retry)
        alive = em.get_alive_executors() - sitting_out

        def _allow_excluded(executor_id: str) -> bool:
            return not (alive - {executor_id})

        # executor host per reservation (memoized): locality-aware
        # pop_next_task prefers tasks whose input bytes live on the
        # popping executor's host
        hosts: Dict[str, str] = {}

        def _host_of(executor_id: str) -> str:
            h = hosts.get(executor_id)
            if h is None:
                try:
                    h = em.get_executor_metadata(executor_id).host
                except Exception:  # noqa: BLE001 - host unknown: no pref
                    h = ""
                hosts[executor_id] = h
            return h

        with self._cache_lock:
            job_ids = list(self._cache.keys())
        # weighted fair dispatch (scheduler/admission.py): when any
        # cached job is admission-managed, walk jobs in fair-share order
        # instead of submit FIFO — interactive lane first, then by the
        # pool's weighted running-task share.  With no admission-managed
        # job this returns the list untouched (byte-identical A/B).
        job_ids = self._admission_order(job_ids)

        feed_pushes: List[tuple] = []
        for job_id in job_ids:
            if not free:
                break
            entry = self._entry(job_id)
            with entry.lock:
                graph = self._load(job_id, entry)
                if graph is None or graph.status in (COMPLETED, FAILED):
                    continue
                graph.revive()
                # partial resolution inside revive may have seeded a
                # shuffle feed: drain its deltas (and push-notify any
                # already-running tailing consumers) whether or not a
                # task pops below
                feed_pushes.extend(self._collect_feed_pushes(graph))
                changed = False
                start = len(assignments)
                free_before = list(free)
                still_free = []
                for r in free:
                    task = graph.pop_next_task(
                        r.executor_id,
                        allow_excluded=_allow_excluded(r.executor_id),
                        executor_host=_host_of(r.executor_id),
                    )
                    if task is None:
                        still_free.append(r)
                        continue
                    if task.speculative:
                        self._spec_launched.inc()
                    assignments.append((r.executor_id, task))
                    changed = True
                free = still_free
                pending += graph.available_tasks()
                if changed:
                    try:
                        self._persist(graph)
                    except Exception:
                        # this job's pops never became durable (_persist
                        # dropped its cached graph, so it reloads the
                        # last persisted state): withdraw ITS assignments
                        # and give the reservations back, but keep and
                        # deliver every assignment persisted for earlier
                        # jobs — otherwise their tasks strand as Running
                        # with no executor ever receiving them
                        import logging

                        logging.getLogger(__name__).warning(
                            "persist failed filling reservations for %s; "
                            "withdrawing its assignments", job_id,
                        )
                        del assignments[start:]
                        free = free_before
        self._push_shuffle_deltas(feed_pushes)
        return assignments, free + sidelined, pending

    def _admission_order(self, job_ids: List[str]) -> List[str]:
        """Fair-share walk order for ``fill_reservations``: interactive
        jobs before batch, then pools with the smallest weighted
        running-task share first (a freed slot goes to whoever is
        furthest under their share), submit order as the tie-break.
        Jobs without admission (or not yet cached) keep their relative
        submit order, interleaved as weight-1 batch work with zero
        share.  Returns the input list unchanged when no cached job is
        admission-managed, so the default-off path stays byte-identical."""
        if self.admission is None or len(job_ids) < 2:
            return job_ids
        rows = []
        managed = False
        for i, jid in enumerate(job_ids):
            with self._cache_lock:
                entry = self._cache.get(jid)
            if entry is None:
                rows.append((jid, i, None, 0))
                continue
            # one read of everything under the entry lock: the graph can
            # be evicted (entry.graph = None) by a concurrent failover
            # or persist failure between unlocked reads
            with entry.lock:
                graph = entry.graph
                if (
                    graph is None
                    or not getattr(graph, "admission_enabled", False)
                    or graph.status in (COMPLETED, FAILED)
                ):
                    rows.append((jid, i, None, 0))
                    continue
                managed = True
                rows.append(
                    (
                        jid,
                        i,
                        (graph.tenant_pool, graph.tenant_priority),
                        graph.running_tasks(),
                    )
                )
        if not managed:
            return job_ids
        pool_running: Dict[str, int] = {}
        for _jid, _i, info, running in rows:
            if info is not None:
                pool_running[info[0]] = pool_running.get(info[0], 0) + running
        weights = self.admission.pool_weights()

        def key(row):
            _jid, i, info, _running = row
            if info is None:
                return (1, 0.0, i)
            pool, priority = info
            share = pool_running.get(pool, 0) / max(
                weights.get(pool, 1.0), 1e-3
            )
            return (0 if priority == "interactive" else 1, share, i)

        rows.sort(key=key)
        return [row[0] for row in rows]

    def prepare_task_definition(self, task: Task) -> pb.TaskDefinition:
        td = pb.TaskDefinition()
        td.task_id.CopyFrom(task.partition.to_proto())
        td.plan = BallistaCodec.encode_physical(task.plan)
        if task.output_partitioning is not None:
            td.output_partitioning.CopyFrom(
                partitioning_to_proto(task.output_partitioning)
            )
            td.has_output_partitioning = True
        td.session_id = task.session_id
        td.curator_scheduler_id = self.scheduler_id
        td.attempt = task.attempt
        td.speculative = task.speculative
        td.timeout_seconds = task.timeout_seconds
        # trace propagation: executor task spans parent under the job's
        # root span (root span id == trace id by convention).  A traced
        # task also carries the obs prop so executors ratchet tracing on
        # even when it was forced scheduler-side (--obs-enabled) rather
        # than set on the session.
        td.trace_id = task.trace_id
        td.parent_span_id = task.trace_id
        if task.trace_id and "ballista.obs.enabled" not in td.props:
            td.props["ballista.obs.enabled"] = "true"
        # ship the session settings so the executor's TaskContext + TPU
        # acceleration pass see the client's config (reference: grpc.rs
        # poll_work/launch builds TaskDefinition.props from session props)
        for k, v in self._session_settings(task.session_id).items():
            td.props[k] = v
        # pipelined execution enabled by a SCHEDULER override (not the
        # session): stamp the knob so the executor's worker-eligibility
        # gate still recognizes tailing plans; sessions that set it ship
        # it above, and default-off tasks carry nothing extra
        from ..config import SHUFFLE_PIPELINED

        if SHUFFLE_PIPELINED not in td.props and self.config_overrides.get(
            SHUFFLE_PIPELINED
        ):
            td.props[SHUFFLE_PIPELINED] = self.config_overrides[
                SHUFFLE_PIPELINED
            ]
        # learned policy overrides (plan-cache layer 2) merged beneath
        # the session at submit: sessions don't ship them, so stamp any
        # key the session (or obs forcing above) didn't already set
        for k, v in self._policy_props.get(task.partition.job_id, {}).items():
            if k not in td.props:
                td.props[k] = v
        return td

    def _session_settings(self, session_id: str) -> Dict[str, str]:
        raw = self.backend.get(Keyspace.Sessions, session_id)
        if raw is None:
            return {}
        msg = pb.SessionSettings.FromString(raw)
        return {kv.key: kv.value for kv in msg.configs}

    def launch_tasks(
        self, executor: ExecutorMetadata, tasks: List[Task]
    ) -> None:
        from ..testing.faults import fault_point

        defs = [self.prepare_task_definition(t) for t in tasks]
        if tasks and tasks[0].trace_id:
            trace.record_raw(
                "scheduler.launch",
                tasks[0].trace_id,
                trace.new_id(),
                tasks[0].trace_id,
                time.time_ns(),
                0,
                job=tasks[0].partition.job_id,
                executor=executor.id,
                tasks=len(tasks),
                stages=sorted({t.partition.stage_id for t in tasks}),
            )
        try:
            fault_point("scheduler.launch_task", executor_id=executor.id)
            self.launcher.launch(executor, defs, self.scheduler_id)
        except Exception as e:
            # hand the tasks back — excluded from this executor so the
            # re-dispatch goes elsewhere — and feed the quarantine window;
            # repeated launch failures queue the executor for expulsion
            # (drained into ExecutorLost by the query-stage scheduler).
            # A failed SPECULATIVE launch only forgets the duplicate; the
            # primary attempt keeps the partition.
            for t in tasks:
                self.reset_task(
                    t.partition,
                    exclude_executor=executor.id,
                    speculative=t.speculative,
                )
            self.executor_manager.record_launch_failure(executor.id)
            raise SchedulerError(
                f"launching {len(tasks)} task(s) on {executor.id} failed: {e}"
            ) from e
        self.executor_manager.record_launch_success(executor.id)

    def reset_task(
        self, partition: PartitionId, exclude_executor: str = "",
        speculative: bool = False,
    ) -> None:
        entry = self._entry(partition.job_id)
        with entry.lock:
            graph = self._load(partition.job_id, entry)
            if graph is not None:
                graph.reset_task_status(
                    partition, exclude_executor, speculative=speculative
                )
                self._persist(graph)

    # --------------------------------------------------------- transitions
    def _emit_job_span(self, graph, status: str) -> None:
        """The trace's root span, timed submit → terminal state (its id IS
        the trace id; every shipped child parented under it)."""
        if graph is None or not getattr(graph, "trace_id", ""):
            return
        trace.record_raw(
            "job",
            graph.trace_id,
            graph.trace_id,
            "",
            graph.submitted_unix_ns,
            time.monotonic_ns() - graph.submitted_mono_ns,
            job=graph.job_id,
            status=status,
            task_retries=graph.task_retries,
            stages=len(graph.stages),
        )

    def _admission_finished(self, job_id: str) -> None:
        """Free the job's admission concurrency slot on any terminal
        transition (no-op for jobs admission never tracked).  The
        event-loop handler that drove the transition runs the release
        scan right after, so freed capacity admits queued jobs."""
        if self.admission is not None:
            self.admission.job_finished(job_id)

    def complete_job(self, job_id: str) -> None:
        self._admission_finished(job_id)
        entry = self._entry(job_id)
        with entry.lock:
            graph = self._load(job_id, entry)
            if graph is not None:
                self._persist(graph)
            self._emit_job_span(graph, "completed")
            self._jobs_completed.inc()
            self._observe_completion(graph)
            self.backend.mv(Keyspace.ActiveJobs, Keyspace.CompletedJobs, job_id)
            with self._cache_lock:
                self._cache.pop(job_id, None)

    def _observe_completion(self, graph: Optional[ExecutionGraph]) -> None:
        """Journal the completion and feed the session's latency SLO
        (``ballista.obs.slo.job_latency_seconds``; 0/absent = untracked).
        The journal line is the job's post-mortem anchor — it survives
        the cache eviction this very call performs."""
        if graph is None:
            return
        latency_s = (time.monotonic_ns() - graph.submitted_mono_ns) / 1e9
        breached = None
        if self.slo is not None:
            from ..config import OBS_SLO_JOB_LATENCY_S

            try:
                target = float(
                    self._session_settings(graph.session_id).get(
                        OBS_SLO_JOB_LATENCY_S, 0.0
                    )
                )
            except (TypeError, ValueError):
                target = 0.0
            if target > 0:
                breached = self.slo.observe(latency_s, target)
        fields = {
            "latency_s": round(latency_s, 4),
            "task_retries": graph.task_retries,
        }
        if breached is not None:
            fields["slo_breached"] = breached
        self.events.emit(
            "job_completed", job=graph.job_id, trace=graph.trace_id, **fields
        )
        self._policy_record(graph, latency_s)

    def _policy_record(
        self, graph: ExecutionGraph, latency_s: float
    ) -> None:
        """Feed the completed job's measured latency + doctor findings
        into the per-plan policy store and journal any rollbacks it
        triggers.  Best-effort: diagnosis runs the same report bundle
        the REST profile serves, and any failure inside it degrades to
        recording the latency with no findings."""
        if self.policy_store is None:
            return
        fp = getattr(graph, "policy_fp", "") or ""
        if not fp:
            return
        arm = getattr(graph, "policy_arm", "baseline") or "baseline"
        self._policy_props.pop(graph.job_id, None)
        findings: List[str] = []
        if arm != "applied":
            # findings steer what gets LEARNED; applied runs only need
            # the latency sample, so skip the diagnosis cost for them
            try:
                from ..obs.doctor import job_report
                from ..obs.recorder import spans_for_job

                detail = self._detail_of(graph)
                ev = (
                    self.events.for_job(graph.job_id)
                    if getattr(self.events, "enabled", False)
                    else []
                )
                report = job_report(detail, spans_for_job(graph.job_id), ev)
                findings = [
                    f.get("code")
                    for f in report.get("doctor") or []
                    if f.get("code")
                ]
            except Exception:
                findings = []
        try:
            rollbacks = self.policy_store.record_job(
                fp, arm, latency_s, findings
            )
        except Exception:
            return
        for rb in rollbacks:
            self.events.emit(
                "policy_rollback",
                job=graph.job_id,
                trace=graph.trace_id,
                **rb,
            )

    def fail_job(self, job_id: str, error: str) -> None:
        self._admission_finished(job_id)
        if self.admission is not None:
            # a job failed out of the queue/admit window reached its
            # terminal state: its queue-WAL entry must not replay it
            self.admission.wal_discard(job_id)
        self._policy_props.pop(job_id, None)
        entry = self._entry(job_id)
        with entry.lock:
            graph = self._load(job_id, entry)
            # two fatal tasks of one job each post JobRunningFailed; only
            # the FIRST fail_job (which moves the job into FailedJobs)
            # emits the root span + counter.  The graph's own status is
            # no signal — it's already FAILED before the event arrives.
            already_failed = (
                self.backend.get(Keyspace.FailedJobs, job_id) is not None
            )
            if not already_failed:
                self._emit_job_span(graph, "failed")
                self._jobs_failed.inc()
                self.events.emit(
                    "job_failed",
                    job=job_id,
                    trace=getattr(graph, "trace_id", "") or "",
                    error=(error or "")[:500],
                )
            tombstone = graph is None
            if graph is not None:
                if graph.status != FAILED:
                    graph.fail_job(error)
                try:
                    self._persist(graph)
                except Exception:
                    # the plan itself may be unserializable (that can be WHY
                    # the job failed); fall back to a status-only tombstone
                    tombstone = True
            if tombstone:
                msg = pb.ExecutionGraphProto(job_id=job_id)
                msg.status.failed.error = error
                self.backend.put(
                    Keyspace.ActiveJobs, job_id, msg.SerializeToString()
                )
            self.backend.mv(Keyspace.ActiveJobs, Keyspace.FailedJobs, job_id)
            with self._cache_lock:
                self._cache.pop(job_id, None)

    def update_job(self, job_id: str) -> None:
        entry = self._entry(job_id)
        with entry.lock:
            graph = self._load(job_id, entry)
            if graph is not None:
                self._persist(graph)

    def cancel_job(self, job_id: str) -> List[Tuple[ExecutorMetadata, List[PartitionId]]]:
        """Fail the job; return the running tasks per executor so the caller
        can issue CancelTasks RPCs (reference: task_manager.rs:225-303).

        A job still sitting in the ADMISSION queue has no graph and no
        running tasks: cancelling it dequeues it (it will never plan)
        and journals ``job_cancelled``.  A cancel racing the admit
        window (released from the queue but no graph cached yet) leaves
        a bounded cancel intent the submit path consumes — the job fails
        instead of running either way."""
        if self.admission is not None:
            qj = self.admission.cancel(job_id)
            if qj is not None:
                self.events.emit(
                    "job_cancelled",
                    job=job_id,
                    pool=qj.pool,
                    queued=True,
                    queue_wait_s=round(
                        time.monotonic() - qj.enqueued_mono, 4
                    ),
                )
                self.fail_job(job_id, "job cancelled by user")
                return []
        entry = self._entry(job_id)
        running: Dict[str, List[PartitionId]] = {}
        with entry.lock:
            graph = self._load(job_id, entry)
            if graph is None:
                if self.admission is not None and not any(
                    self.backend.get(ks, job_id) is not None
                    for ks in (
                        Keyspace.ActiveJobs,
                        Keyspace.CompletedJobs,
                        Keyspace.FailedJobs,
                    )
                ):
                    # nothing queued, nothing persisted: the job is in
                    # the release→plan window (or the id is bogus) —
                    # the intent makes the submit path fail it
                    self.admission.mark_cancel_intent(job_id)
                return []
            from .execution_stage import RunningStage

            for sid, stage in graph.stages.items():
                if isinstance(stage, RunningStage):
                    for t in stage.task_statuses:
                        if t is not None and t.state == "running":
                            running.setdefault(t.executor_id, []).append(
                                t.partition_id
                            )
                    # duplicate attempts racing stragglers abort too
                    for si in stage.speculative_statuses.values():
                        running.setdefault(si.executor_id, []).append(
                            si.partition_id
                        )
        self.events.emit("job_cancelled", job=job_id, queued=False)
        self.fail_job(job_id, "job cancelled by user")
        out = []
        for eid, pids in running.items():
            try:
                meta = self.executor_manager.get_executor_metadata(eid)
            except SchedulerError:
                continue
            out.append((meta, pids))
        return out

    def executor_lost(self, executor_id: str) -> List[str]:
        """Roll back every cached graph; returns affected job ids
        (reference: task_manager.rs:384-412)."""
        with self._cache_lock:
            job_ids = list(self._cache.keys())
        affected = []
        for job_id in job_ids:
            entry = self._entry(job_id)
            with entry.lock:
                graph = self._load(job_id, entry)
                if graph is None or graph.status in (COMPLETED, FAILED):
                    continue
                if graph.reset_stages(executor_id):
                    affected.append(job_id)
                    self._persist(graph)
        return affected

    # -------------------------------------------------------------- misc
    def active_job_ids(self) -> List[str]:
        with self._cache_lock:
            return list(self._cache.keys())

    def locality_pending(self) -> Tuple[int, Dict[str, int]]:
        """(deferred-pending tasks, per-host demand) across cached jobs
        with LOCALITY PLACEMENT ON — the periodic re-offer input keeping
        locality-deferred tasks live in push mode (a deferred task's
        slot was cancelled; somebody must mint new reservations once the
        wait expires).  Counts ONLY stages whose last pop actually
        turned a slot away (``stage.locality_deferred``): pending tasks
        the event-driven flow already covers must not be double-booked
        every tick.  Jobs without the knob contribute nothing, so
        knob-off scheduling is untouched."""
        from .execution_stage import RunningStage

        pending = 0
        hosts: Dict[str, int] = {}
        with self._cache_lock:
            entries = list(self._cache.values())
        for entry in entries:
            with entry.lock:
                graph = entry.graph
                if graph is None or graph.status in (COMPLETED, FAILED):
                    continue
                if not getattr(graph, "locality_enabled", False):
                    continue
                deferred = 0
                for stage in graph.stages.values():
                    if (
                        isinstance(stage, RunningStage)
                        and stage.locality_deferred
                    ):
                        deferred += sum(
                            1 for t in stage.task_statuses if t is None
                        )
                if not deferred:
                    continue
                pending += deferred
                for h, n in graph.preferred_hosts().items():
                    hosts[h] = hosts.get(h, 0) + n
        return pending, hosts

    def task_counts(self) -> Tuple[int, int]:
        """(pending, running) task totals across cached active jobs —
        the queue-depth and slot-saturation inputs for the cluster
        telemetry rings and the autoscaling gauges.  Reads only cached
        graphs (scrape-time: must never hit the backend)."""
        pending = running = 0
        with self._cache_lock:
            entries = list(self._cache.values())
        for entry in entries:
            with entry.lock:
                graph = entry.graph
                if graph is None or graph.status in (COMPLETED, FAILED):
                    continue
                pending += graph.available_tasks()
                running += graph.running_tasks()
        return pending, running

    def unreplicated_shuffle_bytes(self) -> Dict[str, int]:
        """Per-executor bytes of completed shuffle output that has NO
        external-store replica and is still referenced by an active job —
        exactly what a graceful drain must upload before the executor can
        retire.  The autoscaler's scale-in victim selection minimizes
        this (cheapest executor to move).  Cached graphs only
        (scrape-time: must never hit the backend)."""
        out: Dict[str, int] = {}
        with self._cache_lock:
            entries = list(self._cache.values())
        for entry in entries:
            with entry.lock:
                graph = entry.graph
                if graph is None or graph.status in (COMPLETED, FAILED):
                    continue
                for stage in graph.stages.values():
                    for info in getattr(stage, "task_statuses", None) or []:
                        if info is None or info.state != "completed":
                            continue
                        if not info.executor_id:
                            continue
                        pending = sum(
                            p.num_bytes
                            for p in info.partitions
                            if not p.replica_path and p.num_bytes > 0
                        )
                        if pending:
                            out[info.executor_id] = (
                                out.get(info.executor_id, 0) + pending
                            )
        return out

    def list_jobs(self) -> List[dict]:
        """Job table for the REST API: active, completed and failed jobs
        with their states (reference exposes this via /api/state +
        the scheduler UI's job dashboard)."""
        out: List[dict] = []
        seen: set = set()
        if self.admission is not None:
            for row in self.admission.queued_jobs_brief():
                out.append({**row, "state": "queued"})
                seen.add(row["job_id"])
        for job_id in self.active_job_ids():
            st = self.get_job_status(job_id)
            if st is not None:
                retries = self._with_graph(job_id, lambda g: g.task_retries)
                out.append(
                    {
                        "job_id": job_id,
                        "state": st["state"],
                        "task_retries": retries or 0,
                    }
                )
                seen.add(job_id)
        for ks, state in (
            (Keyspace.CompletedJobs, "completed"),
            (Keyspace.FailedJobs, "failed"),
        ):
            for key in self.backend.scan_keys(ks):
                if key not in seen:
                    out.append({"job_id": key, "state": state})
                    seen.add(key)
        return out

    @staticmethod
    def generate_job_id() -> str:
        """7-char alphanumeric (reference: task_manager.rs:544-551)."""
        return "".join(
            random.choices(string.ascii_lowercase + string.digits, k=7)
        )
