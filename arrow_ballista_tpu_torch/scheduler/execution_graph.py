"""Per-job DAG of stages.

Counterpart of the reference's ``scheduler/src/state/execution_graph.rs``:
tracks job status, drives stage transitions as task statuses arrive, hands
out tasks (`pop_next_task`), pushes completed map-output locations into
consumer stages (`update_stage_output_links`), and supports executor-loss
rollback (`reset_stages`).  Protobuf persistence follows the reference's
rule that Running stages are stored as Resolved so a restarted scheduler
re-dispatches in-flight work (`execution_graph.rs:867-920`).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from ..errors import SchedulerError
from ..exec.operators import ExecutionPlan
from ..proto import pb
from ..serde.scheduler_types import (
    ExecutorMetadata,
    PartitionId,
    PartitionLocation,
    PartitionStats,
    ShuffleWritePartition,
)
from ..shuffle import ShuffleWriterExec, UnresolvedShuffleExec
from .execution_stage import (
    CompletedStage,
    FailedStage,
    ResolvedStage,
    RunningStage,
    StageInput,
    TaskInfo,
    UnresolvedStage,
)
from .planner import DistributedPlanner, find_unresolved_shuffles

Stage = Union[UnresolvedStage, ResolvedStage, RunningStage, CompletedStage, FailedStage]


@dataclass
class Task:
    """A runnable task handed to an executor (reference:
    execution_graph.rs:1052-1058)."""

    session_id: str
    partition: PartitionId
    plan: ShuffleWriterExec
    output_partitioning: Optional[object]  # Partitioning of the shuffle write
    attempt: int = 0  # 0-based attempt counter, shipped in TaskDefinition
    # the job's trace id ("" = untraced/unsampled); shipped in
    # TaskDefinition so executor task spans stitch under the job trace
    trace_id: str = ""
    # scheduler-launched duplicate of a straggling partition (same
    # attempt number as the primary; first completion wins)
    speculative: bool = False
    # ballista.task.timeout_seconds at dispatch (0 = none); informational
    # for the executor — the scheduler's scan enforces it
    timeout_seconds: float = 0.0


DEFAULT_TASK_MAX_ATTEMPTS = 4
DEFAULT_STAGE_MAX_ATTEMPTS = 4


# Job status values
QUEUED = "queued"
RUNNING = "running"
COMPLETED = "completed"
FAILED = "failed"


class ExecutionGraph:
    def __init__(
        self,
        scheduler_id: str,
        job_id: str,
        session_id: str,
        plan: ExecutionPlan,
        work_dir: str = "/tmp/ballista-tpu",
        config=None,
    ):
        self.scheduler_id = scheduler_id
        self.job_id = job_id
        self.session_id = session_id
        self.status: str = QUEUED
        self.error: str = ""
        self.stages: Dict[int, Stage] = {}
        self.output_locations: List[PartitionLocation] = []
        self.task_max_attempts = (
            config.task_max_attempts if config is not None
            else DEFAULT_TASK_MAX_ATTEMPTS
        )
        self.stage_max_attempts = (
            config.stage_max_attempts if config is not None
            else DEFAULT_STAGE_MAX_ATTEMPTS
        )
        self.task_retries = 0  # transient-failure re-queues over job lifetime
        self.stage_reset_counts: Dict[int, int] = {}  # executor-loss resets
        # ballista.shuffle.external_path: lets executor-loss handling
        # re-point lost locations at external replicas (probe-derived for
        # drain-time uploads) instead of recomputing
        self.external_shuffle_path = (
            config.shuffle_external_path if config is not None else ""
        )
        # speculative execution + deadline policy from the session config
        # (scheduler flags can force-enable; see scheduler/speculation.py).
        # In-memory only — a restarted scheduler re-derives nothing here
        # (Running stages persist as Resolved, so timing state is gone).
        self._init_speculation_policy(config)
        # locality-aware placement (ballista.shuffle.locality_*): prefer
        # putting reduce tasks on the hosts holding the most bytes of
        # their input partitions, waiting up to locality_wait_s before
        # any host may take them.  In-memory only, like speculation — a
        # recovered graph re-dispatches location-blind until its stages
        # re-resolve.
        self._init_locality_policy(config)
        # multi-tenant admission (scheduler/admission.py): the pool and
        # lane this job belongs to.  Persisted (tenant_json) so restart
        # and HA adoption re-register the job with the admission
        # controller's per-pool concurrency accounting, and so
        # fill_reservations can keep ordering dispatch by fair share.
        self._init_tenant(config)
        # streaming pipelined execution (ballista.shuffle.pipelined):
        # streamable consumer stages start on partial map output, tailing
        # the scheduler's per-producer shuffle-location feed.  In-memory
        # only — partially-resolved stages persist as Unresolved, so a
        # restarted scheduler re-resolves against real state.
        self._init_pipelining(config)
        # adaptive query execution (scheduler/adaptive.py): persisted in
        # the graph proto so restart/HA adoption replays decisions for
        # stages that resolve after the failover
        from .adaptive import AqePolicy

        self.aqe_policy = AqePolicy.from_config(config)
        # CancelTasks fan-out queue: (executor_id, PartitionId) of losing
        # duplicate attempts / reaped deadline-timeouts, drained by the
        # TaskManager after graph mutations commit
        self.pending_cancels: List[tuple] = []
        # structured journal queue: lifecycle events recorded while
        # mutating the graph ({"kind": ..., **fields}); TaskManager's
        # _persist drains them into the EventJournal with job/trace ids
        # attached (drained even when the journal is disabled, so the
        # list never grows unbounded)
        self.pending_events: List[dict] = []
        # wasted-duplicate count not yet flushed into the scheduler's
        # registry counter (TaskManager._persist drains it, so every
        # drop site — commit, failure, reset, reap — reconciles with the
        # per-stage spec_stats rollup)
        self.spec_wasted_pending = 0
        # plan-fingerprint cache (scheduler/plan_cache.py): stages served
        # straight from cached shuffle output (sid -> fingerprint) and
        # stages elided because every consumer is served/elided (revive
        # skips them — they never dispatch).  Persisted (cache_json) so
        # restart/HA adoption keeps skipping the elided subtree instead
        # of waiting forever on inputs nobody will produce.
        self.cache_served: Dict[int, str] = {}
        self.cache_elided: set = set()
        # fingerprints whose cached files turned out to be lost; drained
        # by the TaskManager (like pending_cancels) to evict the entries
        self.pending_cache_invalidations: List[str] = []
        # tracing: set by the scheduler at submit when the session has
        # ballista.obs.enabled (and the job is sampled); in-memory only —
        # a trace does not survive scheduler restart
        self.trace_id = ""
        self.submitted_unix_ns = time.time_ns()
        self.submitted_mono_ns = time.monotonic_ns()

        planner = DistributedPlanner(work_dir, config)
        stage_plans = planner.plan_query_stages(job_id, plan)
        self._final_stage_id = stage_plans[-1].stage_id
        self.output_partitions = stage_plans[-1].output_partitioning().n
        self.stages = _build_stages(stage_plans)
        # query-doctor anchors: distributed-planning duration,
        # and leaf stages are dispatchable the moment the graph exists
        self.planning_ns = time.monotonic_ns() - self.submitted_mono_ns
        now_ns = time.time_ns()
        for stage in self.stages.values():
            if isinstance(stage, ResolvedStage):
                stage.ready_unix_ns = now_ns

    def _init_speculation_policy(self, config) -> None:
        if config is not None:
            self.spec_enabled = config.speculation_enabled
            self.spec_interval_s = config.speculation_interval_seconds
            self.spec_multiplier = config.speculation_multiplier
            self.spec_min_completed_fraction = (
                config.speculation_min_completed_fraction
            )
            self.spec_min_runtime_s = config.speculation_min_runtime_seconds
            self.spec_max_copies_per_stage = (
                config.speculation_max_copies_per_stage
            )
            self.task_timeout_s = config.task_timeout_seconds
        else:
            self.spec_enabled = False
            self.spec_interval_s = 1.0
            self.spec_multiplier = 1.5
            self.spec_min_completed_fraction = 0.75
            self.spec_min_runtime_s = 1.0
            self.spec_max_copies_per_stage = 2
            self.task_timeout_s = 0.0

    def _init_locality_policy(self, config) -> None:
        if config is not None:
            self.locality_enabled = config.shuffle_locality_enabled
            self.locality_wait_s = config.shuffle_locality_wait_seconds
        else:
            self.locality_enabled = False
            self.locality_wait_s = 0.0

    def _init_tenant(self, config) -> None:
        if config is not None:
            self.admission_enabled = config.admission_enabled
            self.tenant_pool = (config.tenant_id or "").strip() or "default"
            self.tenant_priority = config.tenant_priority
        else:
            self.admission_enabled = False
            self.tenant_pool = "default"
            self.tenant_priority = "batch"

    def _init_pipelining(self, config) -> None:
        if config is not None:
            self.pipelined_enabled = config.shuffle_pipelined
            self.pipelined_min_fraction = config.shuffle_pipelined_min_fraction
        else:
            self.pipelined_enabled = False
            self.pipelined_min_fraction = 0.25
        # producer stage id -> {"locations": [PartitionLocation] (append-
        # only, committed winners only), "complete": bool, "epoch": int}.
        # The executor-side delta store mirrors it (push notifications in
        # push mode, GetShuffleLocationDelta polls in pull mode).
        self.shuffle_feeds: Dict[int, dict] = {}
        # epoch survives feed invalidation (executor-loss rollback): a
        # recreated feed starts at epoch+1 so executors' stale mirrors
        # reset instead of merging two generations of locations
        self.feed_epochs: Dict[int, int] = {}
        # queued feed updates for the push fan-out; drained by the
        # TaskManager after graph mutations commit (like pending_cancels)
        self.pending_feed_deltas: List[dict] = []

    def take_pending_feed_deltas(self) -> List[dict]:
        out, self.pending_feed_deltas = self.pending_feed_deltas, []
        return out

    def take_pending_cancels(self) -> List[tuple]:
        out, self.pending_cancels = self.pending_cancels, []
        return out

    def take_pending_cache_invalidations(self) -> List[str]:
        out, self.pending_cache_invalidations = (
            self.pending_cache_invalidations, [],
        )
        return out

    def take_pending_events(self) -> List[dict]:
        out, self.pending_events = self.pending_events, []
        return out

    def _journal(self, kind: str, **fields) -> None:
        self.pending_events.append({"kind": kind, **fields})

    def take_spec_wasted(self) -> int:
        n, self.spec_wasted_pending = self.spec_wasted_pending, 0
        return n

    # ------------------------------------------------------------- intro
    @property
    def final_stage_id(self) -> int:
        return self._final_stage_id

    def stage_count(self) -> int:
        return len(self.stages)

    def is_successful(self) -> bool:
        return self.status == COMPLETED

    def is_complete(self) -> bool:
        return all(
            isinstance(s, CompletedStage)
            for sid, s in self.stages.items()
            if sid not in self.cache_elided
        )

    def available_tasks(self) -> int:
        return sum(
            s.available_tasks()
            for s in self.stages.values()
            if isinstance(s, RunningStage)
        )

    def running_tasks(self) -> int:
        """Tasks currently dispatched (primary + speculative copies) —
        the slot-saturation input for cluster telemetry."""
        n = 0
        for s in self.stages.values():
            if isinstance(s, RunningStage):
                n += sum(
                    1
                    for t in s.task_statuses
                    if t is not None and t.state == "running"
                )
                n += sum(
                    1
                    for t in s.speculative_statuses.values()
                    if t.state == "running"
                )
        return n

    def running_tasks_by_executor(self) -> Dict[str, int]:
        """Dispatched tasks grouped by the executor running them — the
        ground truth the restart-time slot reconcile rebuilds the durable
        slot counts from."""
        per: Dict[str, int] = {}
        for s in self.stages.values():
            if not isinstance(s, RunningStage):
                continue
            for t in s.task_statuses:
                if t is not None and t.state == "running" and t.executor_id:
                    per[t.executor_id] = per.get(t.executor_id, 0) + 1
            for t in s.speculative_statuses.values():
                if t.state == "running" and t.executor_id:
                    per[t.executor_id] = per.get(t.executor_id, 0) + 1
        return per

    # ------------------------------------------------------------ revive
    def revive(self) -> bool:
        """Resolve every resolvable stage and start every resolved stage
        (reference: execution_graph.rs:169-193).  Returns True if anything
        changed.

        The moment a stage becomes resolvable every producer has
        reported exact per-partition output sizes — the one window where
        re-planning is free (nothing dispatched yet), so the AQE hook
        runs here, just before ``to_resolved()``."""
        changed = False
        for sid, stage in list(self.stages.items()):
            if sid in self.cache_elided:
                continue  # every consumer is cache-served: never dispatch
            if isinstance(stage, UnresolvedStage) and stage.resolvable():
                self._maybe_replan(stage)
                resolved = stage.to_resolved()
                # scheduling-delay anchor: resolvable (every input
                # committed) → first dispatch is the scheduler's own
                # latency, measured from here
                resolved.ready_unix_ns = time.time_ns()
                self.stages[sid] = resolved
                changed = True
        if self.pipelined_enabled and self._revive_partial():
            changed = True
        for sid, stage in list(self.stages.items()):
            if sid in self.cache_elided:
                continue
            if isinstance(stage, ResolvedStage):
                running = stage.to_running()
                if self.locality_enabled:
                    # per-task preferred hosts from the resolved readers'
                    # exact input-partition sizes; computed only under
                    # the knob so knob-off dispatch stays the untouched
                    # baseline
                    running.task_preferred_host = preferred_hosts_of(
                        running.plan, running.partitions
                    )
                self.stages[sid] = running
                changed = True
        if changed and self.status == QUEUED:
            self.status = RUNNING
        return changed

    # ------------------------------------------- pipelined execution
    def _revive_partial(self) -> bool:
        """Partial resolution (ballista.shuffle.pipelined): start a
        consumer stage once ``pipelined_min_fraction`` of each STREAMABLE
        input's map tasks have committed, resolving those inputs to
        tailing readers over the producer's shuffle-location feed.
        Pipeline-breaking inputs (sort, hash-join build) must still be
        complete; AQE-rewritten stages keep the barrier (replans are
        gated off for partially-started stages — exact-bytes stats don't
        exist yet).  Committed-task granularity: the feed only ever
        carries first-completion-wins winners, so a consumer can never
        stream from a speculative loser."""
        import math

        from .planner import classify_shuffle_inputs

        changed = False
        for sid, stage in list(self.stages.items()):
            if not isinstance(stage, UnresolvedStage) or stage.resolvable():
                continue
            if stage.aqe:
                continue  # AQE-rewritten layout: barrier (gate, not break)
            if any(
                sh.selections is not None
                for sh in find_unresolved_shuffles(stage.plan)
            ):
                continue
            streamable, _breakers = classify_shuffle_inputs(stage.plan)
            tail: set = set()
            eligible = True
            for in_sid, inp in stage.inputs.items():
                if inp.complete:
                    continue
                if in_sid not in streamable:
                    eligible = False  # a breaker input still running
                    break
                producer = self.stages.get(in_sid)
                if not isinstance(producer, RunningStage):
                    eligible = False  # not started / mid-rollback
                    break
                need = max(
                    1,
                    math.ceil(
                        self.pipelined_min_fraction * producer.partitions
                    ),
                )
                if producer.completed_tasks() < need:
                    eligible = False
                    break
                tail.add(in_sid)
            if not eligible or not tail:
                continue
            try:
                resolved = stage.to_resolved(frozenset(tail))
            except Exception:  # noqa: BLE001 - degrade to the barrier path
                import logging

                logging.getLogger(__name__).exception(
                    "job %s: partial resolution of stage %s failed; "
                    "keeping the stage barrier", self.job_id, sid,
                )
                continue
            resolved.ready_unix_ns = time.time_ns()
            self.stages[sid] = resolved
            for in_sid in sorted(tail):
                self._ensure_feed(in_sid, stage.inputs.get(in_sid))
            self._journal(
                "stage_partial_start",
                stage=sid,
                tail_inputs=sorted(tail),
                min_fraction=self.pipelined_min_fraction,
            )
            changed = True
        return changed

    def _ensure_feed(self, sid: int, inp: Optional[StageInput]) -> None:
        """Create the producer's shuffle-location feed, seeded with every
        location committed so far (the consumer's accumulated StageInput
        carries full executor metadata; repointed external-sentinel
        locations ride through unchanged)."""
        if sid in self.shuffle_feeds:
            return
        locations: List[PartitionLocation] = []
        if inp is not None:
            for q in sorted(inp.partition_locations):
                locations.extend(
                    sorted(inp.partition_locations[q], key=lambda l: l.path)
                )
        epoch = self.feed_epochs.get(sid, 0) + 1
        self.feed_epochs[sid] = epoch
        producer = self.stages.get(sid)
        self.shuffle_feeds[sid] = {
            "locations": locations,
            "complete": isinstance(producer, CompletedStage),
            "epoch": epoch,
        }
        self._queue_feed_delta(sid, 0, locations)

    def _queue_feed_delta(
        self, sid: int, from_index: int, locations: List[PartitionLocation]
    ) -> None:
        feed = self.shuffle_feeds.get(sid)
        if feed is None:
            return
        self.pending_feed_deltas.append(
            {
                "stage": sid,
                "from_index": from_index,
                "locations": list(locations),
                "complete": feed["complete"],
                "epoch": feed["epoch"],
                "valid": True,
            }
        )

    def _append_feed(self, sid: int, locations: List[PartitionLocation]) -> None:
        feed = self.shuffle_feeds.get(sid)
        if feed is None:
            return
        start = len(feed["locations"])
        feed["locations"].extend(locations)
        self._queue_feed_delta(sid, start, locations)

    def _complete_feed(self, sid: int) -> None:
        feed = self.shuffle_feeds.get(sid)
        if feed is None or feed["complete"]:
            return
        feed["complete"] = True
        self._queue_feed_delta(sid, len(feed["locations"]), [])

    def _invalidate_feed(self, sid: int) -> None:
        """Tear a feed down (producer re-run / consumer rollback): stale
        executor mirrors must abort their tails instead of merging two
        generations of locations.  The epoch counter survives, so a
        recreated feed supersedes every mirror of this one."""
        if self.shuffle_feeds.pop(sid, None) is not None:
            self.pending_feed_deltas.append(
                {
                    "stage": sid,
                    "from_index": 0,
                    "locations": [],
                    "complete": False,
                    "epoch": self.feed_epochs.get(sid, 0),
                    "valid": False,
                }
            )

    def _feed_serves_executor(self, sid: int, executor_id: str) -> bool:
        feed = self.shuffle_feeds.get(sid)
        return feed is not None and any(
            l.executor_meta.id == executor_id for l in feed["locations"]
        )

    def shuffle_feed_delta(self, sid: int, from_index: int) -> dict:
        """The ``GetShuffleLocationDelta`` payload for one producer feed
        (pull-mode executors poll this; dict-shaped so the gRPC layer and
        tests share it)."""
        feed = self.shuffle_feeds.get(sid)
        if feed is None:
            return {
                "stage": sid,
                "from_index": 0,
                "locations": [],
                "complete": False,
                "epoch": self.feed_epochs.get(sid, 0),
                "valid": False,
            }
        locs = feed["locations"]
        start = max(0, min(int(from_index), len(locs)))
        return {
            "stage": sid,
            "from_index": start,
            "locations": list(locs[start:]),
            "complete": feed["complete"],
            "epoch": feed["epoch"],
            "valid": True,
        }

    def tailing_executors(self, sid: int) -> set:
        """Executor ids currently running tasks of a consumer stage that
        tails producer ``sid`` — the push-notification fan-out targets."""
        out: set = set()
        for stage in self.stages.values():
            if (
                isinstance(stage, RunningStage)
                and sid in stage.tail_inputs
            ):
                for t in stage.task_statuses:
                    if t is not None and t.state == "running" and t.executor_id:
                        out.add(t.executor_id)
                for si in stage.speculative_statuses.values():
                    if si.executor_id:
                        out.add(si.executor_id)
        return out

    def _maybe_replan(self, stage: UnresolvedStage) -> None:
        """AQE coalesce/skew-split hook; an AQE bug must degrade to the
        static plan, never fail the job."""
        if not self.aqe_policy.enabled:
            return
        try:
            from .adaptive import replan_stage

            replan_stage(self, stage)
        except Exception:  # noqa: BLE001 - fall back to the static plan
            import logging

            logging.getLogger(__name__).exception(
                "job %s: AQE replan of stage %s failed; keeping the "
                "static plan", self.job_id, stage.stage_id,
            )

    def _maybe_broadcast(self, completed_sid: int) -> None:
        """AQE shuffle→broadcast hook, same degrade-to-static contract."""
        if not self.aqe_policy.enabled:
            return
        try:
            from .adaptive import try_broadcast

            try_broadcast(self, completed_sid)
        except Exception:  # noqa: BLE001 - fall back to the static plan
            import logging

            logging.getLogger(__name__).exception(
                "job %s: AQE broadcast conversion after stage %s failed; "
                "keeping the static plan", self.job_id, completed_sid,
            )

    # ----------------------------------------------------------- dispatch
    def pop_next_task(
        self,
        executor_id: str,
        allow_excluded: bool = False,
        executor_host: Optional[str] = None,
    ) -> Optional[Task]:
        """Find a Running stage with an unclaimed partition, mark it
        running on ``executor_id`` and return it
        (reference: execution_graph.rs:418-471).

        A partition whose last transient failure happened on
        ``executor_id`` is skipped (the retry must land elsewhere) unless
        ``allow_excluded`` — the liveness escape hatch when no other
        executor exists (``task_manager.fill_reservations``).

        With locality placement on (``ballista.shuffle.locality_*``) and
        ``executor_host`` known, the scan walks partitions in order but
        DEFERS any task preferring a different host — leaving it for a
        preferred executor — until the stage has been running for
        ``locality_wait_s``, after which any host may take it (soft
        preference: data locality is worth waiting for, never starving
        for).  Preference-less tasks are taken whenever reached — they
        are not reordered behind this host's preferred ones (in practice
        a reduce stage's partitions either all carry preferences or none
        do, so a second prioritizing scan would buy nothing).  Callers
        that do not pass a host — or pass an empty one (metadata lookup
        failed) — keep baseline behavior: an UNKNOWN host must degrade
        to location-blind dispatch, never defer every preferred task
        against it.

        Unclaimed partitions are served first; pending speculation
        requests (straggler duplicates flagged by the scan) come second
        and only ever land on an executor OTHER than the primary's."""
        from ..shuffle.transport import normalize_host

        locality = self.locality_enabled and bool(executor_host)
        host_n = normalize_host(executor_host) if locality else ""
        now = time.monotonic() if locality else 0.0
        for sid in sorted(self.stages):
            stage = self.stages[sid]
            if not isinstance(stage, RunningStage):
                continue
            for p, t in enumerate(stage.task_statuses):
                if t is not None:
                    continue
                if (
                    not allow_excluded
                    and stage.task_exclusions.get(p) == executor_id
                ):
                    continue
                pref = (
                    stage.task_preferred_host.get(p) if locality else None
                )
                if (
                    pref
                    and pref != host_n
                    and now
                    < stage.running_since_mono + self.locality_wait_s
                ):
                    # hold out for the host that already has the bytes;
                    # the flag keeps the push-mode safety tick re-minting
                    # a reservation for the turned-away slot
                    stage.locality_deferred = True
                    continue
                if locality:
                    stage.locality_deferred = False
                if pref:
                    stage.locality_stats["local" if pref == host_n else "any"] = (
                        stage.locality_stats.get(
                            "local" if pref == host_n else "any", 0
                        )
                        + 1
                    )
                attempt = stage.task_attempts.get(p, 0)
                pid = PartitionId(self.job_id, sid, p)
                stage.task_statuses[p] = TaskInfo(
                    pid, "running", executor_id, attempt=attempt
                )
                stage.task_started_mono[p] = time.monotonic()
                # critical-path anchor: re-dispatches overwrite, so the
                # breakdown reflects the attempt that ends up committing
                stage.task_dispatch_unix_ns[p] = time.time_ns()
                return Task(
                    self.session_id,
                    pid,
                    stage.plan,
                    stage.plan.shuffle_output_partitioning,
                    attempt,
                    trace_id=self.trace_id,
                    timeout_seconds=self.task_timeout_s,
                )
            task = self._pop_speculative(sid, stage, executor_id)
            if task is not None:
                return task
        return None

    def preferred_hosts(self) -> Dict[str, int]:
        """Pending-task demand per preferred host (normalized) across
        Running stages — the ordering hint for
        ``ExecutorManager.reserve_slots`` so cluster-wide reservations
        land where the shuffle bytes already are.  Empty when locality
        placement is off."""
        out: Dict[str, int] = {}
        if not self.locality_enabled:
            return out
        for stage in self.stages.values():
            if not isinstance(stage, RunningStage):
                continue
            for p, t in enumerate(stage.task_statuses):
                if t is None:
                    h = stage.task_preferred_host.get(p)
                    if h:
                        out[h] = out.get(h, 0) + 1
        return out

    def _pop_speculative(
        self, sid: int, stage: RunningStage, executor_id: str
    ) -> Optional[Task]:
        """Hand out one pending straggler duplicate to ``executor_id``.
        The duplicate shares the primary's attempt number — whichever copy
        completes first commits; the other's late status fails the
        "partition already completed" guard."""
        for p, primary_eid in sorted(stage.speculation_requests.items()):
            t = stage.task_statuses[p]
            if t is None or t.state != "running":
                # the primary failed/was reset/completed since the scan
                # flagged it: the request is stale
                stage.speculation_requests.pop(p, None)
                continue
            if executor_id == t.executor_id or executor_id == primary_eid:
                continue  # the duplicate must race on a DIFFERENT host
            if stage.task_exclusions.get(p) == executor_id:
                continue  # ...and never on a host that already failed p
            if p in stage.speculative_statuses:
                stage.speculation_requests.pop(p, None)
                continue
            attempt = stage.task_attempts.get(p, 0)
            pid = PartitionId(self.job_id, sid, p)
            stage.speculative_statuses[p] = TaskInfo(
                pid, "running", executor_id, attempt=attempt, speculative=True
            )
            stage.spec_started_mono[p] = time.monotonic()
            stage.spec_dispatch_unix_ns[p] = time.time_ns()
            stage.bump_spec_stat("launched")
            stage.speculation_requests.pop(p, None)
            self._journal(
                "speculation_launched",
                stage=sid,
                partition=p,
                executor=executor_id,
                straggler=t.executor_id,
            )
            return Task(
                self.session_id,
                pid,
                stage.plan,
                stage.plan.shuffle_output_partitioning,
                attempt,
                trace_id=self.trace_id,
                speculative=True,
                timeout_seconds=self.task_timeout_s,
            )
        return None

    def reset_task_status(
        self, partition: PartitionId, exclude_executor: str = "",
        speculative: bool = False,
    ) -> None:
        """Return a handed-out task to the pool (launch failed / reservation
        cancelled).  ``exclude_executor`` keeps the re-dispatch off the
        executor the launch just failed against.  A failed SPECULATIVE
        launch only forgets the duplicate — the primary attempt keeps the
        partition."""
        stage = self.stages.get(partition.stage_id)
        if not isinstance(stage, RunningStage):
            return
        p = partition.partition_id
        if speculative:
            if stage.drop_speculative(p) is not None:
                stage.bump_spec_stat("wasted")
                self.spec_wasted_pending += 1
            return
        t = stage.task_statuses[p]
        if t is not None and t.state == "running":
            stage.task_statuses[p] = None
            stage.task_started_mono.pop(p, None)
            if exclude_executor:
                stage.task_exclusions[p] = exclude_executor

    def reset_running_tasks(self, executor_id: str) -> int:
        """Re-queue every task currently running on ``executor_id`` with
        the executor excluded (quarantine: the host is sick but its past
        shuffle output is still servable, so no stage rollback).  Returns
        the number of tasks reset.

        The attempt counter is bumped: the quarantined executor was never
        told to stop, so its late status for the superseded attempt must
        fail the stale-attempt guards instead of double-completing or
        double-failing the partition.  A primary whose healthy duplicate
        is still racing elsewhere is not re-queued — the duplicate is
        promoted in place (same attempt, partition stays covered)."""
        n = 0
        for stage in self.stages.values():
            if not isinstance(stage, RunningStage):
                continue
            for p, si in list(stage.speculative_statuses.items()):
                if si.executor_id == executor_id:
                    stage.drop_speculative(p)
                    stage.bump_spec_stat("wasted")
                    self.spec_wasted_pending += 1
            for p, t in enumerate(stage.task_statuses):
                if t is not None and t.state == "running" and t.executor_id == executor_id:
                    spec_started = stage.spec_started_mono.get(p)
                    spec_dispatch = stage.spec_dispatch_unix_ns.get(p)
                    shadow = stage.drop_speculative(p)
                    if shadow is not None:
                        stage.task_statuses[p] = shadow
                        if spec_started is not None:
                            stage.task_started_mono[p] = spec_started
                        else:
                            stage.task_started_mono.pop(p, None)
                        if spec_dispatch is not None:
                            stage.task_dispatch_unix_ns[p] = spec_dispatch
                        # the quarantined host's copy is superseded: abort
                        # it (best-effort) — its late reports are dropped
                        # by the superseded-copy guard either way
                        self.pending_cancels.append(
                            (executor_id, t.partition_id)
                        )
                        continue
                    stage.task_statuses[p] = None
                    stage.task_started_mono.pop(p, None)
                    stage.task_exclusions[p] = executor_id
                    stage.task_attempts[p] = stage.task_attempts.get(p, 0) + 1
                    self.task_retries += 1
                    n += 1
        return n

    # ------------------------------------------------------ status updates
    def update_task_status(
        self,
        info: TaskInfo,
        executor: Optional[ExecutorMetadata] = None,
    ) -> List[str]:
        """Apply one task status; returns job-level events out of
        ("job_updated", "job_completed", "job_failed")
        (reference: execution_graph.rs:197-318)."""
        stage = self.stages.get(info.partition_id.stage_id)
        if stage is None:
            raise SchedulerError(
                f"job {self.job_id}: unknown stage {info.partition_id.stage_id}"
            )
        if not isinstance(stage, RunningStage):
            # late status for a stage already rolled back or completed
            return []

        events: List[str] = []
        p = info.partition_id.partition_id
        committed = (
            0 <= p < stage.partitions
            and stage.task_statuses[p] is not None
            and stage.task_statuses[p].state == "completed"
        )
        if committed:
            # first-completion-wins: the partition already committed, so
            # ANY later report — the cancelled loser's success as much as
            # its failure, or a duplicate delivery — is stale.  Dropping
            # it here keeps the committed output locations stable (no
            # double propagation to consumers) and burns no failure
            # budget.
            return []

        if info.state == "failed":
            return self._on_task_failed(stage, info)

        if info.attempt < stage.task_attempts.get(p, 0):
            # late status from a superseded attempt (the task was reset by
            # quarantine and re-dispatched): accepting it would overwrite
            # the live attempt's status — and a stale completion would
            # propagate the same partition's output twice
            return []
        if info.state == "running" and info.speculative:
            # progress report from a duplicate attempt: it must never
            # shadow the primary's slot
            if p in stage.speculative_statuses:
                stage.speculative_statuses[p] = info
            return []
        if info.state == "completed":
            events.extend(self._commit_winner(stage, info))
        stage.update_task_status(info)
        if info.state == "completed":
            if info.fetch_retries:
                stage.task_fetch_retries[p] = info.fetch_retries
            stage.update_task_metrics(info)
            # per-partition written-bytes distribution (skew input): wire
            # bytes from the writer metrics when present, else the sum of
            # the partition files' sizes; raw falls back to wire
            wire_m = sum(
                int(vals.get("bytes_written_wire", 0)) for _, vals in info.metrics
            )
            raw_m = sum(
                int(vals.get("bytes_written_raw", 0)) for _, vals in info.metrics
            )
            wire = wire_m or sum(pt.num_bytes for pt in info.partitions)
            stage.task_bytes[p] = {"raw": raw_m or wire, "wire": wire}
            if executor is not None:
                self._propagate_output(stage, info, executor)
            if stage.is_completed():
                sid = info.partition_id.stage_id
                completed = stage.to_completed()
                self.stages[sid] = completed
                from ..obs.export import STAGE_SKEW_OP

                skew = completed.stage_metrics.get(STAGE_SKEW_OP, {})
                self._journal(
                    "stage_completed",
                    stage=sid,
                    partitions=completed.partitions,
                    task_retries=sum(completed.task_attempts.values()),
                    runtime_skew=skew.get("runtime_ms_skew_x1000", 0) / 1000.0,
                    bytes_skew=skew.get("bytes_wire_skew_x1000", 0) / 1000.0,
                )
                from .display import print_stage_metrics

                print_stage_metrics(
                    self.job_id, sid, completed.plan, completed.stage_metrics
                )
                for link in completed.output_links:
                    consumer = self.stages.get(link)
                    if isinstance(consumer, UnresolvedStage):
                        consumer.complete_input(sid)
                    elif sid in getattr(consumer, "tail_inputs", ()):
                        # partially-started consumer: the producer is done
                        # — flip its input complete so rollback/recovery
                        # bookkeeping sees a finished input from here on
                        inp = consumer.inputs.get(sid)
                        if inp is not None:
                            inp.complete = True
                # the tailing feed (if any consumer streams this stage)
                # ends here: executors finish their tails and the stage's
                # last fragment becomes fetchable like any other
                self._complete_feed(sid)
                if sid == self._final_stage_id:
                    self._collect_job_output(completed, executor)
                    self.status = COMPLETED
                    events.append("job_completed")
                else:
                    # AQE: a freshly-measured small build side may convert
                    # a consumer's join to broadcast (stripping the
                    # not-yet-started probe shuffle) BEFORE revive can
                    # resolve anything against the static plan
                    self._maybe_broadcast(sid)
                    self.revive()
                    events.append("job_updated")
            else:
                events.append("job_updated")
        return events

    def _commit_winner(self, stage: RunningStage, info: TaskInfo) -> List[str]:
        """First-completion-wins bookkeeping for one completed report:
        identify the losing copy (if the partition was racing two), queue
        its CancelTasks, and record the winner's runtime for the stage's
        speculation median.  The caller then commits ``info`` as the
        partition's status."""
        p = info.partition_id.partition_id
        events: List[str] = []
        cur = stage.task_statuses[p]
        started = stage.task_started_mono.get(p)
        shadow_started = stage.spec_started_mono.get(p)
        shadow_dispatch = stage.spec_dispatch_unix_ns.get(p)
        shadow = stage.drop_speculative(p)
        if info.speculative:
            # the committed attempt is the DUPLICATE: its dispatch anchor
            # replaces the straggler's, so the breakdown window excludes
            # the straggler's dead time
            if shadow_dispatch is not None:
                stage.task_dispatch_unix_ns[p] = shadow_dispatch
            # the duplicate beat the straggler: the still-running primary
            # is the loser — cancel it; its late status will hit the
            # committed-partition guard
            if (
                cur is not None
                and cur.state == "running"
                and cur.executor_id != info.executor_id
            ):
                self.pending_cancels.append(
                    (cur.executor_id, info.partition_id)
                )
            stage.bump_spec_stat("wins")
            events.append("speculative_win")
            self._journal(
                "speculation_win",
                stage=info.partition_id.stage_id,
                partition=p,
                executor=info.executor_id,
                loser=cur.executor_id if cur is not None else "",
            )
            started = shadow_started if shadow_started is not None else started
        elif shadow is not None:
            # the primary won the race after all: the duplicate is wasted
            self.pending_cancels.append(
                (shadow.executor_id, info.partition_id)
            )
            stage.bump_spec_stat("wasted")
            self.spec_wasted_pending += 1
            events.append("speculative_wasted")
            self._journal(
                "speculation_wasted",
                stage=info.partition_id.stage_id,
                partition=p,
                executor=shadow.executor_id,
            )
        stage.task_started_mono.pop(p, None)
        stage.task_finish_unix_ns[p] = time.time_ns()
        if started is not None:
            runtime = max(0.0, time.monotonic() - started)
            stage.completed_runtime_s.append(runtime)
            # per-partition runtime distribution (skew input)
            stage.task_runtime_s[p] = runtime
        return events

    def _on_task_failed(self, stage: RunningStage, info: TaskInfo) -> List[str]:
        """Bounded retry with failure classification (the reference fails
        the whole job on the first failed task; production cannot):
        transient failures re-queue the partition — excluded from the
        executor that just failed it — until ``ballista.task.max_attempts``
        is spent, then the job fails with the accumulated error history.
        Fatal (plan/serde/SQL) errors fail fast on attempt 1.

        Speculation interplay: while a partition races two copies, one
        copy's failure only drops THAT copy (the other keeps the
        partition; no re-queue, no attempt burned).  A consumer failing
        with a structured ShuffleFetchFailed triggers producer-partition
        recovery instead of burning its own attempts on data that no
        longer exists."""
        from .failure import (
            FATAL,
            classify_failure,
            parse_shuffle_fetch_failure,
        )

        sid = info.partition_id.stage_id
        p = info.partition_id.partition_id
        current = stage.task_attempts.get(p, 0)
        if info.attempt < current:
            # late report from an attempt already superseded (e.g. the
            # task was reset by quarantine and re-ran elsewhere)
            return []
        if info.fetch_retries:
            stage.task_fetch_retries[p] = info.fetch_retries
        error = info.error or "task failed"

        shadow = stage.speculative_statuses.get(p)
        cur = stage.task_statuses[p]
        if info.speculative:
            # the duplicate died; the primary still owns the partition
            if shadow is not None and info.executor_id == shadow.executor_id:
                stage.drop_speculative(p)
                stage.bump_spec_stat("wasted")
                self.spec_wasted_pending += 1
                return ["speculative_wasted"]
            if not (
                cur is not None
                and cur.state == "running"
                and cur.executor_id == info.executor_id
            ):
                return []  # duplicate already dropped/superseded: stale
            # the duplicate was PROMOTED to primary (its reports still
            # carry speculative=true from the TaskDefinition): this is
            # now the partition's only live attempt — fall through to the
            # normal failure path so it re-queues instead of stranding
            # the partition in "running" forever
        elif cur is None or cur.state != "running":
            # no live attempt owns this partition: it was reset (launch
            # failure, stage rollback, lost-shuffle recovery) and will
            # re-dispatch through the normal path.  The report is from a
            # superseded copy — e.g. a recovery-cancelled consumer task's
            # late "Cancelled:" — and must neither burn budget nor
            # fail-fast a job mid-recovery.
            return []
        elif (
            cur.executor_id
            and info.executor_id
            and cur.executor_id != info.executor_id
        ):
            # same-attempt failure from an executor that no longer owns
            # the partition (e.g. a quarantine reset promoted the
            # duplicate in place and the old primary limped on): the
            # live attempt on cur.executor_id keeps the partition — do
            # not wipe it or burn budget for a superseded copy
            return []
        if (
            shadow is not None
            and cur is not None
            and cur.state == "running"
            and info.executor_id == cur.executor_id
        ):
            # the primary died but its duplicate races on: promote it in
            # place (same attempt number) instead of re-queueing
            spec_started = stage.spec_started_mono.get(p)
            spec_dispatch = stage.spec_dispatch_unix_ns.get(p)
            promoted = stage.drop_speculative(p)
            stage.task_statuses[p] = promoted
            if spec_started is not None:
                stage.task_started_mono[p] = spec_started
            else:
                stage.task_started_mono.pop(p, None)
            if spec_dispatch is not None:
                stage.task_dispatch_unix_ns[p] = spec_dispatch
            stage.task_failures.setdefault(p, []).append(
                f"attempt {current} on {info.executor_id or '<unknown>'}: "
                f"{error} (duplicate attempt promoted)"
            )
            return ["job_updated"]

        lost = parse_shuffle_fetch_failure(error)
        if lost is not None:
            recovered = self._recover_lost_shuffle(stage, *lost)
            if recovered is not None:
                return recovered

        history = stage.task_failures.setdefault(p, [])
        history.append(
            f"attempt {current} on {info.executor_id or '<unknown>'}: {error}"
        )
        kind = classify_failure(error)
        # deadline reaps bump the attempt counter for staleness but grant
        # a free attempt — they never consume the failure budget
        budget = self.task_max_attempts + stage.task_free_attempts.get(p, 0)
        if kind != FATAL and current + 1 < budget:
            stage.task_attempts[p] = current + 1
            if info.executor_id:
                stage.task_exclusions[p] = info.executor_id
            stage.task_statuses[p] = None
            stage.task_started_mono.pop(p, None)
            self.task_retries += 1
            self._journal(
                "task_retry",
                stage=sid,
                partition=p,
                attempt=current,
                executor=info.executor_id,
                error=error[:200],
            )
            return ["task_retried"]

        detail = "; ".join(history)
        reason = (
            "fatal error"
            if kind == FATAL
            else f"exhausted {self.task_max_attempts} attempts"
        )
        self.stages[sid] = stage.to_failed(detail)
        self.status = FAILED
        self.error = (
            f"stage {sid} task {p} failed ({reason}): {detail}"
        )
        return ["job_failed"]

    def _propagate_output(
        self, stage: RunningStage, info: TaskInfo, executor: ExecutorMetadata
    ) -> None:
        """Push one completed map task's shuffle partitions into consumer
        stages' inputs (reference: execution_graph.rs:320-369).  Only
        COMMITTED winners reach here (the first-completion-wins guard
        drops losers before publication), so partially-started consumers
        and the tailing feed can never stream from a losing attempt."""
        locations = [
            PartitionLocation(
                PartitionId(self.job_id, stage.stage_id, p.partition_id),
                executor,
                PartitionStats(p.num_rows, p.num_batches, p.num_bytes),
                p.path,
                replica_path=p.replica_path,
            )
            for p in info.partitions
        ]
        for link in stage.output_links:
            consumer = self.stages.get(link)
            if isinstance(consumer, UnresolvedStage):
                consumer.add_input_partitions(stage.stage_id, locations)
            elif stage.stage_id in getattr(consumer, "tail_inputs", ()):
                # partially-started consumer: keep its StageInput current
                # (rollback/recovery reads it) while the live stream rides
                # the feed below
                inp = consumer.inputs.get(stage.stage_id)
                if inp is not None:
                    for loc in locations:
                        inp.add_partition(loc)
        self._append_feed(stage.stage_id, locations)

    def _collect_job_output(
        self, stage: CompletedStage, executor: Optional[ExecutorMetadata]
    ) -> None:
        self.output_locations = []
        for t in stage.task_statuses:
            if t is None:
                continue
            meta = executor
            for p in t.partitions:
                self.output_locations.append(
                    PartitionLocation(
                        PartitionId(self.job_id, stage.stage_id, p.partition_id),
                        meta if meta is not None else ExecutorMetadata("", "", 0),
                        PartitionStats(p.num_rows, p.num_batches, p.num_bytes),
                        p.path,
                        replica_path=p.replica_path,
                    )
                )

    # ------------------------------------------ lost-shuffle recovery
    def _recover_lost_shuffle(
        self,
        consumer: RunningStage,
        prod_sid: int,
        map_partition: int,
        executor_id: str,
    ) -> Optional[List[str]]:
        """A consumer task exhausted its fetch retries against map output
        that no longer exists (``ShuffleFetchFailed``): re-run only the
        PRODUCER partitions that lived on ``executor_id`` and roll the
        consumer back to Unresolved, instead of burning the consumer's
        attempt budget on data nobody can serve.  Returns the job events,
        or None when recovery does not apply (the normal transient retry
        path then takes over).  Bounded by the same
        ``ballista.stage.max_attempts`` ledger as executor-loss resets."""
        from ..shuffle.store import EXTERNAL_EXECUTOR_ID

        producer = self.stages.get(prod_sid)
        if producer is None or prod_sid == consumer.stage_id:
            return None
        csid = consumer.stage_id
        inp = consumer.inputs.get(prod_sid)
        lost_in_consumer = inp is not None and any(
            l.executor_meta.id == executor_id
            for locs in inp.partition_locations.values()
            for l in locs
        )
        # an EXTERNAL-STORE loss (a repointed location's copy vanished):
        # record which paths the strip below will remove, so the re-run
        # covers exactly the map tasks backing them — resetting healthy
        # executors' tasks too would re-propagate (duplicate) locations
        # the consumer still holds
        sentinel_paths: set = set()
        if executor_id == EXTERNAL_EXECUTOR_ID and inp is not None:
            sentinel_paths = {
                l.path
                for locs in inp.partition_locations.values()
                for l in locs
                if l.executor_meta.id == EXTERNAL_EXECUTOR_ID
            }
        producer_has_lost_tasks = isinstance(producer, CompletedStage) and any(
            t is not None and t.executor_id == executor_id
            for t in producer.task_statuses
        )
        producer_rerunning = isinstance(producer, (RunningStage, ResolvedStage, UnresolvedStage))
        if not (lost_in_consumer or producer_has_lost_tasks or producer_rerunning):
            return None

        # bounded: repeated data loss on the same stages must fail the
        # job with the ledger, not loop forever
        for sid in (prod_sid, csid):
            count = self.stage_reset_counts.get(sid, 0) + 1
            self.stage_reset_counts[sid] = count
            if count >= self.stage_max_attempts:
                self.status = FAILED
                self.error = (
                    f"stage {sid} reset {count} times recovering lost "
                    f"shuffle output of stage {prod_sid} on {executor_id}; "
                    f"exceeded ballista.stage.max_attempts="
                    f"{self.stage_max_attempts}"
                )
                return ["job_failed"]

        # 1) abandon the consumer's other in-flight tasks (their input
        #    set is about to change) and roll it back to Unresolved,
        #    stripping ONLY the lost executor's locations for prod_sid.
        #    A half-streamed consumer's tail feeds are invalidated so
        #    executor mirrors abort instead of merging the re-run's
        #    locations into the dead generation.
        for t in consumer.task_statuses:
            if t is not None and t.state == "running":
                self.pending_cancels.append((t.executor_id, t.partition_id))
        for si in consumer.speculative_statuses.values():
            self.pending_cancels.append((si.executor_id, si.partition_id))
        for f_sid in sorted(consumer.tail_inputs):
            self._invalidate_feed(f_sid)
        self._invalidate_feed(prod_sid)
        unresolved = consumer.to_resolved().to_unresolved()
        uinp = unresolved.inputs.get(prod_sid)
        if uinp is not None:
            stripped = False
            for q, locs in uinp.partition_locations.items():
                kept = [
                    l for l in locs if l.executor_meta.id != executor_id
                ]
                if len(kept) != len(locs):
                    stripped = True
                uinp.partition_locations[q] = kept
            if stripped or producer_has_lost_tasks or producer_rerunning:
                uinp.complete = False
        self.stages[csid] = unresolved

        # 2) re-run just the producer tasks whose output lived there
        n_rerun = 0
        if prod_sid in self.cache_served:
            # the "producer" never ran — it was served from the plan
            # cache and its files vanished: forget the serve, rebirth
            # the elided subtree, recompute through normal dispatch
            n_rerun = self._revert_cache_served(prod_sid)
        elif isinstance(producer, CompletedStage):
            running = producer.to_running()
            if executor_id == EXTERNAL_EXECUTOR_ID:
                # the external store lost data: re-run the map tasks
                # backing the stripped sentinel locations (matched by
                # replica/primary path; every task when the paths are
                # unknown) — the sentinel must never leave the consumer
                # stranded on an input nobody will complete
                for i, t in enumerate(running.task_statuses):
                    if t is None:
                        continue
                    backs_sentinel = not sentinel_paths or any(
                        p.replica_path in sentinel_paths
                        or p.path in sentinel_paths
                        for p in t.partitions
                    )
                    if backs_sentinel:
                        running.task_statuses[i] = None
                        n_rerun += 1
            else:
                n_rerun = running.reset_tasks(executor_id)
            if n_rerun:
                self.stages[prod_sid] = running
        self.revive()
        self._journal(
            "shuffle_lost_recovery",
            producer_stage=prod_sid,
            consumer_stage=csid,
            executor=executor_id,
            map_tasks_rerun=n_rerun,
        )
        return ["job_updated"] + ["task_requeued"] * n_rerun

    def _revert_cache_served(self, sid: int) -> int:
        """A cache-served stage's cached partitions vanished: forget the
        serve — the stage and its elided upstream subtree revert to
        their born state and recompute through the normal dispatch path.
        The subtree is self-contained by construction (serving requires
        every interior stage's consumers to stay inside it), so rebirth
        cannot strand or double-feed any outside consumer.  Returns the
        number of stages reborn."""
        stage = self.stages.get(sid)
        if not isinstance(stage, CompletedStage):
            self.cache_served.pop(sid, None)
            return 0
        fp = self.cache_served.pop(sid, "")
        if fp:
            self.pending_cache_invalidations.append(fp)
        reborn = {sid}
        frontier = [sid]
        while frontier:
            cur = self.stages.get(frontier.pop())
            if cur is None:
                continue
            for sh in find_unresolved_shuffles(cur.plan):
                if sh.stage_id in self.cache_elided:
                    self.cache_elided.discard(sh.stage_id)
                    reborn.add(sh.stage_id)
                    frontier.append(sh.stage_id)
        for s in sorted(reborn):
            cur = self.stages[s]
            deps = [sh.stage_id for sh in find_unresolved_shuffles(cur.plan)]
            if deps:
                self.stages[s] = UnresolvedStage(
                    s,
                    cur.plan,
                    list(cur.output_links),
                    {d: StageInput() for d in deps},
                )
            else:
                born = ResolvedStage(s, cur.plan, list(cur.output_links), {})
                born.ready_unix_ns = time.time_ns()
                self.stages[s] = born
        self._journal(
            "cache_lost",
            stage=sid,
            fingerprint=fp,
            stages_reborn=sorted(reborn),
        )
        return len(reborn)

    # --------------------------------------- speculation/deadline scan
    def scan_speculation(
        self,
        now: Optional[float] = None,
        force_enabled: bool = False,
        force_timeout_s: float = 0.0,
    ) -> dict:
        """One pass of the scheduler's periodic straggler/deadline scan
        (runs on the event-loop thread via ``scheduler/speculation.py``).
        Flags stragglers for duplicate dispatch, reaps running tasks past
        ``ballista.task.timeout_seconds``, and returns
        ``{"new_requests", "timeouts", "events"}``.  Cancellations queue
        on ``pending_cancels``."""
        now = time.monotonic() if now is None else now
        out = {"new_requests": 0, "timeouts": 0, "events": []}
        if self.status != RUNNING:
            return out
        enabled = self.spec_enabled or force_enabled
        timeout_s = self.task_timeout_s or force_timeout_s
        for sid, stage in list(self.stages.items()):
            if not isinstance(stage, RunningStage):
                continue
            if timeout_s > 0:
                self._reap_deadlines(sid, stage, now, timeout_s, out)
                if self.status == FAILED:
                    return out
            if enabled:
                self._request_speculation(stage, now, out)
        return out

    def _reap_deadlines(
        self, sid: int, stage: RunningStage, now: float, timeout_s: float,
        out: dict,
    ) -> None:
        # wedged duplicates just disappear (wasted); the primary keeps
        # the partition
        for p, si in list(stage.speculative_statuses.items()):
            started = stage.spec_started_mono.get(p)
            if started is not None and now - started >= timeout_s:
                stage.drop_speculative(p)
                stage.bump_spec_stat("wasted")
                self.spec_wasted_pending += 1
                self.pending_cancels.append(
                    (si.executor_id, si.partition_id)
                )
                out["timeouts"] += 1
        for p, t in enumerate(stage.task_statuses):
            if t is None or t.state != "running":
                continue
            started = stage.task_started_mono.get(p)
            if started is None or now - started < timeout_s:
                continue
            pid = PartitionId(self.job_id, sid, p)
            self.pending_cancels.append((t.executor_id, pid))
            out["timeouts"] += 1
            spec_started = stage.spec_started_mono.get(p)
            spec_dispatch = stage.spec_dispatch_unix_ns.get(p)
            shadow = stage.drop_speculative(p)
            if shadow is not None:
                # a healthy duplicate takes over in place (same attempt)
                stage.task_statuses[p] = shadow
                if spec_started is not None:
                    stage.task_started_mono[p] = spec_started
                else:
                    stage.task_started_mono.pop(p, None)
                if spec_dispatch is not None:
                    stage.task_dispatch_unix_ns[p] = spec_dispatch
                out["events"].append("job_updated")
                continue
            cur = stage.task_attempts.get(p, 0)
            stage.task_failures.setdefault(p, []).append(
                f"attempt {cur} on {t.executor_id or '<unknown>'}: task "
                f"deadline exceeded after {now - started:.1f}s (reaped)"
            )
            # reaps are budget-free but NOT unbounded: a partition whose
            # every attempt outlives the deadline (the timeout is simply
            # below its genuine runtime) must fail the job with a clear
            # error, not loop dispatch→reap forever
            reaps = stage.task_free_attempts.get(p, 0) + 1
            if reaps >= max(2, self.task_max_attempts):
                detail = "; ".join(stage.task_failures.get(p, []))
                self.stages[sid] = stage.to_failed(detail)
                self.status = FAILED
                self.error = (
                    f"stage {sid} task {p} reaped {reaps} times at "
                    f"ballista.task.timeout_seconds={timeout_s:g} — the "
                    f"deadline is below the task's real runtime: {detail}"
                )
                out["events"].append("job_failed")
                return
            stage.task_statuses[p] = None
            stage.task_started_mono.pop(p, None)
            if t.executor_id:
                stage.task_exclusions[p] = t.executor_id
            # the bump keeps the wedged executor's late report stale; the
            # free attempt keeps the reap out of the failure budget
            stage.task_attempts[p] = cur + 1
            stage.task_free_attempts[p] = reaps
            self.task_retries += 1
            self._journal(
                "task_reaped",
                stage=sid,
                partition=p,
                executor=t.executor_id,
                elapsed_s=round(now - started, 3),
                timeout_s=timeout_s,
            )
            out["events"].append("task_requeued")

    def _request_speculation(
        self, stage: RunningStage, now: float, out: dict
    ) -> None:
        import math
        import statistics

        launched = stage.spec_stats.get("launched", 0)
        budget = (
            self.spec_max_copies_per_stage
            - launched
            - len(stage.speculation_requests)
        )
        if budget <= 0:
            return
        runtimes = stage.completed_runtime_s
        need = max(
            1,
            math.ceil(self.spec_min_completed_fraction * stage.partitions),
        )
        if not runtimes or stage.completed_tasks() < need:
            return
        threshold = max(
            self.spec_multiplier * statistics.median(runtimes),
            self.spec_min_runtime_s,
        )
        for p, t in enumerate(stage.task_statuses):
            if budget <= 0:
                break
            if t is None or t.state != "running":
                continue
            if (
                p in stage.speculative_statuses
                or p in stage.speculation_requests
            ):
                continue
            started = stage.task_started_mono.get(p)
            if started is None or now - started <= threshold:
                continue
            stage.speculation_requests[p] = t.executor_id
            out["new_requests"] += 1
            budget -= 1

    # ------------------------------------------------------------- failure
    def fail_job(self, error: str) -> None:
        self.status = FAILED
        self.error = error

    # ------------------------------------------- replica repoint helpers
    def _external_location(self, loc: PartitionLocation, path: str) -> PartitionLocation:
        from ..shuffle.store import EXTERNAL_EXECUTOR

        return PartitionLocation(
            loc.partition_id, EXTERNAL_EXECUTOR, loc.partition_stats, path
        )

    @staticmethod
    def _exists_memo():
        """Memoized ``os.path.exists``: one reset_stages pass probes the
        same replica paths from several angles (annotate, victim split,
        keep_task, repoint) and runs on the single event-loop thread —
        with the external root on a network mount each stat is a round
        trip, so pay it once per path per loss, not four times."""
        import os

        cache: Dict[str, bool] = {}

        def probe(path: str) -> bool:
            v = cache.get(path)
            if v is None:
                v = os.path.exists(path)
                cache[path] = v
            return v

        return probe

    def _derived_replica(self, path: str, probe=None) -> str:
        """External-store copy of ``path`` that actually exists, or "".
        Covers drain-time uploads, which register no replica_path — the
        mapping is deterministic, so the scheduler probes the shared
        store instead of needing a new wire protocol."""
        import os

        from ..shuffle.store import external_replica_path, is_under_root

        probe = os.path.exists if probe is None else probe
        root = getattr(self, "external_shuffle_path", "")
        if not root or not path:
            return ""
        if is_under_root(root, path):
            # external-primary store: the partition IS the surviving copy
            return path
        cand = external_replica_path(root, path)
        return cand if cand is not None and probe(cand) else ""

    def _replica_of(
        self, loc: PartitionLocation, probe=None
    ) -> Optional[PartitionLocation]:
        """A location for a surviving copy of ``loc``'s partition, or
        None when no copy is KNOWN TO EXIST.  A registered replica_path
        is probed too: replication=async stamps it optimistically, so a
        failed background upload must not repoint consumers at a dangling
        path (they would fetch-fail against the sentinel and the
        producer would never recompute)."""
        import os

        probe = os.path.exists if probe is None else probe
        if loc.replica_path and probe(loc.replica_path):
            return self._external_location(loc, loc.replica_path)
        derived = self._derived_replica(loc.path, probe)
        return self._external_location(loc, derived) if derived else None

    def _repoint_inputs(
        self, executor_id: str, skip_paths=frozenset(), probe=None
    ) -> int:
        """Re-point every stage-input location served by ``executor_id``
        at its surviving replica (external sentinel executor, so nothing
        downstream ever strips it again).  Locations WITHOUT a surviving
        copy — and locations in ``skip_paths`` (output of map tasks that
        are about to RE-RUN: repointing half a task while the whole task
        re-propagates would feed consumers the same data twice) — are
        left for the strip/rollback passes.  Returns how many locations
        were re-pointed."""
        n = 0
        for stage in self.stages.values():
            inputs = getattr(stage, "inputs", None)
            if not inputs:
                continue
            for inp in inputs.values():
                for q, locs in inp.partition_locations.items():
                    out = []
                    for l in locs:
                        if (
                            l.executor_meta.id == executor_id
                            and l.path not in skip_paths
                        ):
                            r = self._replica_of(l, probe)
                            if r is not None:
                                out.append(r)
                                n += 1
                                continue
                        out.append(l)
                    inp.partition_locations[q] = out
        return n

    def _annotate_completed_replicas(
        self, executor_id: str, probe=None
    ) -> int:
        """Stamp probe-derived replica paths onto completed task stats of
        ``executor_id`` (drain-time uploads registered none), so the
        survivor/victim split can tell replicated partitions from truly
        lost ones.  Running stages' COMPLETED tasks are annotated too —
        a partially-finished stage's done work is just as protectable.
        Returns the number of partitions annotated."""
        from dataclasses import replace as _replace

        n = 0
        for stage in self.stages.values():
            statuses = getattr(stage, "task_statuses", None)
            if statuses is None:
                continue
            for t in statuses:
                if (
                    t is None
                    or t.executor_id != executor_id
                    or t.state != "completed"
                ):
                    continue
                parts = []
                changed = False
                for p in t.partitions:
                    if not p.replica_path:
                        derived = self._derived_replica(p.path, probe)
                        if derived:
                            p = _replace(p, replica_path=derived)
                            changed = True
                            n += 1
                    parts.append(p)
                if changed:
                    t.partitions = parts
        return n

    @staticmethod
    def _fully_replicated(t: TaskInfo, probe=None) -> bool:
        """Does every output partition of this completed task have a copy
        that EXISTS on the shared store right now?  (An optimistic async
        replica_path whose upload failed does not count.)"""
        import os as _os

        probe = _os.path.exists if probe is None else probe
        return (
            t.state == "completed"
            and bool(t.partitions)
            and all(
                p.replica_path and probe(p.replica_path)
                for p in t.partitions
            )
        )

    def _victim_task_paths(self, executor_id: str, probe=None) -> set:
        """Output paths of the lost executor's completed map tasks that
        will have to RE-RUN (some partition has no surviving copy).
        Their locations must be stripped — never repointed — so the
        re-run's propagation is the single source of their data."""
        out: set = set()
        for stage in self.stages.values():
            statuses = getattr(stage, "task_statuses", None)
            if statuses is None:
                continue
            for t in statuses:
                if (
                    t is not None
                    and t.executor_id == executor_id
                    and t.state == "completed"
                    and not self._fully_replicated(t, probe)
                ):
                    out.update(p.path for p in t.partitions)
        return out

    def handoff_task(self, partition: PartitionId, executor_id: str) -> bool:
        """Graceful-decommission handoff: a DRAINING executor cancelled
        (or otherwise failed) this task — re-queue it excluded from the
        drainer WITHOUT consuming the failure budget (the attempt bump
        keeps the drainer's late reports stale; the free attempt keeps
        the budget whole).  A duplicate copy on the drainer just drops.
        Returns True when the report was absorbed as a handoff."""
        stage = self.stages.get(partition.stage_id)
        if not isinstance(stage, RunningStage):
            return False
        p = partition.partition_id
        if not (0 <= p < stage.partitions):
            return False
        si = stage.speculative_statuses.get(p)
        if si is not None and si.executor_id == executor_id:
            stage.drop_speculative(p)
            stage.bump_spec_stat("wasted")
            self.spec_wasted_pending += 1
            return True
        t = stage.task_statuses[p]
        if t is None or t.state != "running" or t.executor_id != executor_id:
            return False
        cur = stage.task_attempts.get(p, 0)
        stage.task_statuses[p] = None
        stage.task_started_mono.pop(p, None)
        stage.task_exclusions[p] = executor_id
        stage.task_attempts[p] = cur + 1
        stage.task_free_attempts[p] = stage.task_free_attempts.get(p, 0) + 1
        self._journal(
            "drain_handoff",
            stage=partition.stage_id,
            partition=p,
            executor=executor_id,
        )
        return True

    def reset_stages(self, executor_id: str) -> int:
        """Executor-loss rollback (reference: execution_graph.rs:499-622),
        replica-aware:

        * re-point locations with a surviving external-store copy at the
          replica FIRST — those partitions are not lost, consumers keep
          (or re-resolve to) working locations and nothing recomputes;
        * clear running tasks assigned to the executor;
        * strip its un-replicated partition locations from unresolved
          stages' inputs;
        * roll Running/Resolved stages whose inputs truly lost data back
          to UnResolved;
        * re-run Completed stages' map tasks only where some output
          partition has NO surviving copy.

        Returns the number of affected/re-pointed stages; only genuine
        rollbacks (not repoints) consume the stage_max_attempts ledger."""
        affected = set()

        # 0) surviving copies first: annotate drain-uploaded partitions,
        #    split the lost executor's completed tasks into survivors
        #    (every partition has an existing copy) and victims (must
        #    re-run), then re-point the SURVIVORS' input locations — the
        #    strip/rollback passes below only ever see genuine losses,
        #    and a victim's locations are never half-repointed (the
        #    re-run re-propagates the whole task; a lingering sentinel
        #    copy would duplicate its rows at the consumer)
        probe = self._exists_memo()  # one stat per replica path per loss
        repointed = self._annotate_completed_replicas(executor_id, probe)
        victim_paths = self._victim_task_paths(executor_id, probe)
        repointed += self._repoint_inputs(
            executor_id, skip_paths=victim_paths, probe=probe
        )

        # 1) running stages: reset that executor's tasks (duplicates the
        #    stage drops count toward the wasted registry counter).  A
        #    COMPLETED task whose every partition has a surviving copy
        #    is kept — its propagated locations were just repointed, so
        #    a 90%-done stage on a drained executor re-runs nothing.
        for sid, stage in list(self.stages.items()):
            if isinstance(stage, RunningStage):
                wasted_before = stage.spec_stats.get("wasted", 0)
                if stage.reset_tasks(
                    executor_id,
                    keep_task=lambda t: self._fully_replicated(t, probe),
                ):
                    affected.add(sid)
                self.spec_wasted_pending += (
                    stage.spec_stats.get("wasted", 0) - wasted_before
                )

        # 2) strip lost input locations everywhere; find consumers that lost
        #    data and must re-resolve
        rollback_consumers = set()
        rerun_producers = set()
        for sid, stage in list(self.stages.items()):
            if isinstance(stage, UnresolvedStage):
                before = _locations_of(stage, executor_id)
                if before:
                    stage.remove_input_partitions(executor_id)
                    affected.add(sid)
                    # a producer that already COMPLETED on the lost
                    # executor has no rolled-back consumer to nominate it
                    # below — without this the consumer waits forever on
                    # an input nobody re-runs (step 4 ignores producers
                    # that are merely mid-flight)
                    for in_sid, inp in stage.inputs.items():
                        if not inp.complete:
                            rerun_producers.add(in_sid)
            elif isinstance(stage, (ResolvedStage, RunningStage)):
                lost = any(
                    any(
                        l.executor_meta.id == executor_id
                        for locs in inp.partition_locations.values()
                        for l in locs
                    )
                    for inp in stage.inputs.values()
                )
                # a tailing consumer whose FEED served the lost executor
                # rolls back even when replica repoint cleaned its inputs:
                # the stream already shipped dead locations executor-side,
                # and a stream in flight cannot be patched (pipelined
                # failure semantics ride the existing reset path)
                if not lost and stage.tail_inputs:
                    lost = any(
                        self._feed_serves_executor(f_sid, executor_id)
                        for f_sid in stage.tail_inputs
                    )
                if lost:
                    rollback_consumers.add(sid)

        # 3) roll back consumers to unresolved
        for sid in rollback_consumers:
            stage = self.stages[sid]
            if isinstance(stage, RunningStage):
                if stage.tail_inputs:
                    # half-streamed consumer: abort its in-flight tasks
                    # (their tailing fetch plans reference the dead feed)
                    # and tear the feeds down — the re-resolve recreates
                    # them at the next epoch.  Barrier-path consumers keep
                    # the pre-existing semantics (late statuses are
                    # dropped by the rolled-back-stage guard).
                    for t in stage.task_statuses:
                        if t is not None and t.state == "running":
                            self.pending_cancels.append(
                                (t.executor_id, t.partition_id)
                            )
                    for si in stage.speculative_statuses.values():
                        self.pending_cancels.append(
                            (si.executor_id, si.partition_id)
                        )
                    for f_sid in sorted(stage.tail_inputs):
                        self._invalidate_feed(f_sid)
                stage = stage.to_resolved()
            assert isinstance(stage, ResolvedStage)
            if stage.tail_inputs:
                for f_sid in sorted(stage.tail_inputs):
                    self._invalidate_feed(f_sid)
            unresolved = stage.to_unresolved()
            unresolved.remove_input_partitions(executor_id)
            # any input stage whose data was lost must re-run
            for in_sid, inp in unresolved.inputs.items():
                if not inp.complete:
                    rerun_producers.add(in_sid)
            self.stages[sid] = unresolved
            affected.add(sid)

        # 4) completed producers re-run ONLY the victim map tasks (some
        #    partition without an EXISTING copy — same split as step 0);
        #    fully-replicated tasks keep their re-pointed locations
        for sid in sorted(rerun_producers):
            stage = self.stages.get(sid)
            if isinstance(stage, CompletedStage):
                victims = [
                    i
                    for i, t in enumerate(stage.task_statuses)
                    if t is not None
                    and t.executor_id == executor_id
                    and not self._fully_replicated(t, probe)
                ]
                if not victims:
                    continue
                running = stage.to_running()
                for i in victims:
                    running.task_statuses[i] = None
                self.stages[sid] = running
                self._invalidate_feed(sid)  # re-run supersedes the feed
                affected.add(sid)

        # 5) bound the rollback: a stage reset more than
        #    ballista.stage.max_attempts times means the cluster is
        #    flapping faster than the job can make progress — fail it
        #    with the reset ledger instead of looping forever
        for sid in affected:
            count = self.stage_reset_counts.get(sid, 0) + 1
            self.stage_reset_counts[sid] = count
            if count >= self.stage_max_attempts and self.status != FAILED:
                self.status = FAILED
                self.error = (
                    f"stage {sid} reset {count} times after executor loss "
                    f"(last: {executor_id}); exceeded "
                    f"ballista.stage.max_attempts={self.stage_max_attempts}"
                )
        if self.status == FAILED:
            return len(affected)

        if affected and self.status == COMPLETED:
            self.status = RUNNING
        self.revive()
        if affected or repointed:
            # replica repoint / executor-loss rollback: the post-mortem
            # distinguishes "consumers re-pointed at replicas, nothing
            # recomputed" from a genuine rollback storm
            self._journal(
                "executor_rollback",
                executor=executor_id,
                stages_affected=sorted(affected),
                locations_repointed=repointed,
            )
        # repoint-only changes (no rollback) still mutated locations and
        # must persist — report them without burning the reset ledger
        return len(affected) if affected else (1 if repointed else 0)

    # -------------------------------------------------------- persistence
    def encode(self) -> bytes:
        from ..serde import BallistaCodec

        g = pb.ExecutionGraphProto()
        g.job_id = self.job_id
        g.session_id = self.session_id
        g.scheduler_id = self.scheduler_id
        g.output_partitions = self.output_partitions
        g.task_max_attempts = self.task_max_attempts
        g.stage_max_attempts = self.stage_max_attempts
        g.task_retries = self.task_retries
        g.external_shuffle_path = self.external_shuffle_path
        # job-level timeline anchors: the original submit wall-clock and
        # planning duration must survive eviction/restart or every
        # relative timestamp in the breakdown shifts to decode time
        g.submitted_unix_us = self.submitted_unix_ns // 1000
        g.planning_us = getattr(self, "planning_ns", 0) // 1000
        if self.aqe_policy.enabled:
            g.aqe_settings_json = self.aqe_policy.to_json()
        if self.admission_enabled:
            g.tenant_json = json.dumps(
                {"pool": self.tenant_pool, "priority": self.tenant_priority}
            )
        for sid in sorted(self.stage_reset_counts):
            g.stage_reset_ids.append(sid)
            g.stage_reset_counts.append(self.stage_reset_counts[sid])
        if self.cache_served or self.cache_elided:
            g.cache_json = json.dumps(
                {
                    "served": {
                        str(s): fp for s, fp in self.cache_served.items()
                    },
                    "elided": sorted(self.cache_elided),
                }
            )
        if self.status == QUEUED:
            g.status.queued.SetInParent()
        elif self.status == RUNNING:
            g.status.running.SetInParent()
        elif self.status == FAILED:
            g.status.failed.error = self.error
        else:
            for loc in self.output_locations:
                g.status.completed.partition_location.add().CopyFrom(loc.to_proto())
        for sid in sorted(self.stages):
            stage = self.stages[sid]
            sp = g.stages.add()
            if isinstance(stage, RunningStage):
                stage = stage.to_resolved()  # re-dispatch on restart
            if isinstance(stage, ResolvedStage) and stage.tail_inputs:
                # partially-resolved (pipelined): the location feed is
                # in-memory only, so persist as Unresolved — a restarted
                # scheduler re-resolves from the producers' real state
                stage = stage.to_unresolved()
            if isinstance(stage, UnresolvedStage):
                sp.unresolved.stage_id = sid
                sp.unresolved.plan = BallistaCodec.encode_physical(stage.plan)
                sp.unresolved.output_links.extend(stage.output_links)
                _encode_inputs(sp.unresolved.inputs, stage.inputs)
                if stage.aqe:
                    sp.unresolved.aqe_summary_json = json.dumps(stage.aqe)
            elif isinstance(stage, ResolvedStage):
                sp.resolved.stage_id = sid
                sp.resolved.partitions = stage.partitions
                sp.resolved.plan = BallistaCodec.encode_physical(stage.plan)
                sp.resolved.output_links.extend(stage.output_links)
                _encode_inputs(sp.resolved.inputs, stage.inputs)
                if stage.aqe:
                    sp.resolved.aqe_summary_json = json.dumps(stage.aqe)
            elif isinstance(stage, CompletedStage):
                sp.completed.stage_id = sid
                sp.completed.partitions = stage.partitions
                sp.completed.plan = BallistaCodec.encode_physical(stage.plan)
                sp.completed.output_links.extend(stage.output_links)
                _encode_inputs(sp.completed.inputs, stage.inputs)
                # merged operator metrics survive completion: the REST
                # detail and /api/jobs/{id}/profile read them from the
                # persisted graph once the cache entry is evicted
                for op, vals in stage.stage_metrics.items():
                    m = sp.completed.stage_metrics.add()
                    m.operator_name = op
                    for k, v in vals.items():
                        m.values[k] = int(v)
                sp.completed.speculative_launched = stage.spec_stats.get(
                    "launched", 0
                )
                sp.completed.speculative_wins = stage.spec_stats.get("wins", 0)
                sp.completed.speculative_wasted = stage.spec_stats.get(
                    "wasted", 0
                )
                for t in stage.task_statuses:
                    if t is None:
                        continue
                    ts = sp.completed.task_statuses.add()
                    ts.task_id.CopyFrom(t.partition_id.to_proto())
                    ts.attempt = stage.task_attempts.get(
                        t.partition_id.partition_id, t.attempt
                    )
                    ts.fetch_retries = stage.task_fetch_retries.get(
                        t.partition_id.partition_id, t.fetch_retries
                    )
                    ts.completed.executor_id = t.executor_id
                    for p in t.partitions:
                        ts.completed.partitions.add().CopyFrom(p.to_proto())
            elif isinstance(stage, FailedStage):
                sp.failed.stage_id = sid
                sp.failed.partitions = stage.partitions
                sp.failed.plan = BallistaCodec.encode_physical(stage.plan)
                sp.failed.output_links.extend(stage.output_links)
                sp.failed.error = stage.error
        return g.SerializeToString()

    @classmethod
    def decode(cls, data: bytes, work_dir: str = "/tmp/ballista-tpu") -> "ExecutionGraph":
        from ..serde import BallistaCodec

        g = pb.ExecutionGraphProto.FromString(data)
        self = cls.__new__(cls)
        self.scheduler_id = g.scheduler_id
        self.job_id = g.job_id
        self.session_id = g.session_id
        self.trace_id = ""  # traces don't survive restart/adoption
        # the WALL submit anchor is persisted (timeline attribution must
        # not shift to decode time); the monotonic one cannot be — live
        # elapsed/SLO math restarts from adoption
        self.submitted_unix_ns = (
            g.submitted_unix_us * 1000 if g.submitted_unix_us else time.time_ns()
        )
        self.submitted_mono_ns = time.monotonic_ns()
        self.planning_ns = g.planning_us * 1000
        self.output_partitions = g.output_partitions
        self.output_locations = []
        self.error = ""
        # restart/HA adoption must keep the session's bounds and the spent
        # budgets — a fresh budget per failover would unbound the loops
        self.task_max_attempts = g.task_max_attempts or DEFAULT_TASK_MAX_ATTEMPTS
        self.stage_max_attempts = g.stage_max_attempts or DEFAULT_STAGE_MAX_ATTEMPTS
        self.task_retries = g.task_retries
        self.external_shuffle_path = g.external_shuffle_path
        self.stage_reset_counts = dict(
            zip(g.stage_reset_ids, g.stage_reset_counts)
        )
        self.cache_served = {}
        self.cache_elided = set()
        self.pending_cache_invalidations = []
        if g.cache_json:
            try:
                c = json.loads(g.cache_json)
                self.cache_served = {
                    int(k): v for k, v in (c.get("served") or {}).items()
                }
                self.cache_elided = set(c.get("elided") or [])
            except (ValueError, TypeError, AttributeError):
                pass
        # speculation/deadline policy is session-config derived and not
        # persisted: a recovered/adopted graph runs without it until its
        # stages complete (timing anchors are gone anyway); locality
        # placement likewise (preferred hosts re-derive on re-resolve)
        self._init_speculation_policy(None)
        self._init_locality_policy(None)
        # tenant identity IS persisted: pool concurrency accounting and
        # fair dispatch ordering must survive restart / HA adoption
        self._init_tenant(None)
        # pipelined execution is session-config derived and not persisted:
        # a recovered/adopted graph runs the barrier scheduler (partial
        # stages were stored as Unresolved, so nothing dangles)
        self._init_pipelining(None)
        if g.tenant_json:
            try:
                tenant = json.loads(g.tenant_json)
                self.admission_enabled = True
                self.tenant_pool = tenant.get("pool") or "default"
                self.tenant_priority = tenant.get("priority") or "batch"
            except (ValueError, TypeError, AttributeError):
                pass
        # AQE policy IS persisted: stats and already-made decisions live
        # in the stage protos, so a restarted scheduler replays the same
        # rewrites for stages that resolve after the failover
        from .adaptive import AqePolicy

        self.aqe_policy = AqePolicy.from_json(g.aqe_settings_json)
        self.pending_cancels = []
        self.pending_events = []
        self.spec_wasted_pending = 0
        which = g.status.WhichOneof("status")
        if which == "queued":
            self.status = QUEUED
        elif which == "running":
            self.status = RUNNING
        elif which == "failed":
            self.status = FAILED
            self.error = g.status.failed.error
        else:
            self.status = COMPLETED
            self.output_locations = [
                PartitionLocation.from_proto(l)
                for l in g.status.completed.partition_location
            ]
        self.stages = {}
        max_sid = 0
        for sp in g.stages:
            which = sp.WhichOneof("stage")
            if which == "unresolved":
                s = sp.unresolved
                stage: Stage = UnresolvedStage(
                    s.stage_id,
                    BallistaCodec.decode_physical(s.plan, work_dir),
                    list(s.output_links),
                    _decode_inputs(s.inputs),
                    aqe=_decode_aqe(s.aqe_summary_json),
                )
            elif which == "resolved":
                s = sp.resolved
                stage = ResolvedStage(
                    s.stage_id,
                    BallistaCodec.decode_physical(s.plan, work_dir),
                    list(s.output_links),
                    _decode_inputs(s.inputs),
                    aqe=_decode_aqe(s.aqe_summary_json),
                )
            elif which == "completed":
                s = sp.completed
                statuses: List[Optional[TaskInfo]] = [None] * s.partitions
                attempts: Dict[int, int] = {}
                fetch_retries: Dict[int, int] = {}
                for ts in s.task_statuses:
                    pid = PartitionId.from_proto(ts.task_id)
                    statuses[pid.partition_id] = TaskInfo(
                        pid,
                        "completed",
                        ts.completed.executor_id,
                        partitions=[
                            ShuffleWritePartition.from_proto(p)
                            for p in ts.completed.partitions
                        ],
                        attempt=ts.attempt,
                        fetch_retries=ts.fetch_retries,
                    )
                    if ts.attempt:
                        attempts[pid.partition_id] = ts.attempt
                    if ts.fetch_retries:
                        fetch_retries[pid.partition_id] = ts.fetch_retries
                spec_stats = {
                    k: v
                    for k, v in (
                        ("launched", s.speculative_launched),
                        ("wins", s.speculative_wins),
                        ("wasted", s.speculative_wasted),
                    )
                    if v
                }
                stage = CompletedStage(
                    s.stage_id,
                    BallistaCodec.decode_physical(s.plan, work_dir),
                    list(s.output_links),
                    _decode_inputs(s.inputs),
                    statuses,
                    stage_metrics={
                        m.operator_name: dict(m.values)
                        for m in s.stage_metrics
                    },
                    task_attempts=attempts,
                    task_fetch_retries=fetch_retries,
                    spec_stats=spec_stats,
                )
            else:
                s = sp.failed
                stage = FailedStage(
                    s.stage_id,
                    BallistaCodec.decode_physical(s.plan, work_dir),
                    list(s.output_links),
                    s.error,
                )
            self.stages[stage.stage_id] = stage
            max_sid = max(max_sid, stage.stage_id)
        self._final_stage_id = max_sid
        # a broadcast decision PENDING at failover (build side completed
        # small, consumer still unresolved) replays now: completion events
        # never re-fire for already-Completed stages on the adopting
        # scheduler, and the conversion is idempotent (a converted
        # consumer carries its aqe marker, persisted above)
        for sid in sorted(self.stages):
            if isinstance(self.stages.get(sid), CompletedStage):
                self._maybe_broadcast(sid)
        return self


def _encode_inputs(out, inputs: Dict[int, StageInput]) -> None:
    for sid, inp in inputs.items():
        m = out.add()
        m.stage_id = sid
        m.complete = inp.complete
        for locs in inp.partition_locations.values():
            for l in locs:
                m.partition_locations.add().CopyFrom(l.to_proto())


def _decode_aqe(raw: str) -> Dict[str, int]:
    if not raw:
        return {}
    try:
        return dict(json.loads(raw))
    except Exception:  # noqa: BLE001 - tolerate future/garbage payloads
        return {}


def _decode_inputs(msgs) -> Dict[int, StageInput]:
    out: Dict[int, StageInput] = {}
    for m in msgs:
        inp = StageInput(complete=m.complete)
        for l in m.partition_locations:
            inp.add_partition(PartitionLocation.from_proto(l))
        out[m.stage_id] = inp
    return out


def preferred_hosts_of(plan, n_tasks: int) -> Dict[int, str]:
    """task index -> normalized host holding the most input bytes, from
    the resolved plan's ShuffleReaderExec location lists (exact
    per-partition wire sizes recorded at shuffle-write time).  Tasks
    whose inputs carry no sized, host-addressed location (external-store
    sentinel, empty partitions) get no preference."""
    from ..shuffle.execution_plans import ShuffleReaderExec
    from ..shuffle.transport import normalize_host

    by_task: Dict[int, Dict[str, int]] = {}
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, ShuffleReaderExec):
            for p, locs in enumerate(node.partition):
                if p >= n_tasks:
                    break
                for l in locs:
                    host = normalize_host(
                        getattr(l.executor_meta, "host", "") or ""
                    )
                    if not host:
                        continue
                    nb = int(
                        getattr(l.partition_stats, "num_bytes", 0) or 0
                    )
                    if nb <= 0:
                        continue
                    hosts = by_task.setdefault(p, {})
                    hosts[host] = hosts.get(host, 0) + nb
        stack.extend(node.children())
    return {
        # deterministic argmax: bytes desc, then host name
        p: max(sorted(hosts), key=lambda h: hosts[h])
        for p, hosts in by_task.items()
    }


def _locations_of(stage: UnresolvedStage, executor_id: str) -> int:
    return sum(
        1
        for inp in stage.inputs.values()
        for locs in inp.partition_locations.values()
        for l in locs
        if l.executor_meta.id == executor_id
    )


def _build_stages(stage_plans: List[ShuffleWriterExec]) -> Dict[int, Stage]:
    """Infer the DAG from UnresolvedShuffleExec leaves
    (reference: ExecutionStageBuilder, execution_graph.rs:941-1038)."""
    dependencies: Dict[int, List[int]] = {}  # stage -> stages it reads
    for sp in stage_plans:
        dependencies[sp.stage_id] = [
            sh.stage_id for sh in find_unresolved_shuffles(sp)
        ]

    output_links: Dict[int, List[int]] = {sp.stage_id: [] for sp in stage_plans}
    for consumer, producers in dependencies.items():
        for p in producers:
            output_links[p].append(consumer)

    stages: Dict[int, Stage] = {}
    for sp in stage_plans:
        inputs = {p: StageInput() for p in dependencies[sp.stage_id]}
        if inputs:
            stages[sp.stage_id] = UnresolvedStage(
                sp.stage_id, sp, output_links[sp.stage_id], inputs
            )
        else:
            # leaf stage: immediately resolvable
            stages[sp.stage_id] = ResolvedStage(
                sp.stage_id, sp, output_links[sp.stage_id], {}
            )
    return stages
