"""Stage state machine.

Counterpart of the reference's
``scheduler/src/state/execution_graph/execution_stage.rs:44-58``:

              to_resolved()          start
  UnResolved ────────────▶ Resolved ──────▶ Running ──▶ Completed
      ▲                        ▲               │  ▲          │
      │ rollback (lost input)  │ reset_tasks   │  │          │ re-run
      └────────────────────────┴───────────────┘  └──────────┘
                              Failed ◀── task failure

A stage's *plan* is a ``ShuffleWriterExec`` subtree; its *tasks* are the
plan's input partitions.  ``inputs`` tracks, per producing stage, the
map-side partition locations accumulated so far.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..errors import SchedulerError
from ..exec.operators import ExecutionPlan
from ..serde.scheduler_types import (
    PartitionId,
    PartitionLocation,
    ShuffleWritePartition,
)
from ..shuffle import ShuffleWriterExec
from .planner import (
    find_unresolved_shuffles,
    remove_unresolved_shuffles,
    rollback_resolved_shuffles,
)


# --------------------------------------------------------------- task status
@dataclass
class TaskInfo:
    """Scheduler-side view of one task attempt (reference: proto TaskStatus)."""

    partition_id: PartitionId
    state: str  # "running" | "completed" | "failed"
    executor_id: str = ""
    error: str = ""
    partitions: List[ShuffleWritePartition] = field(default_factory=list)
    metrics: List[tuple] = field(default_factory=list)  # (operator, {k: v})
    attempt: int = 0  # which attempt this status describes (0-based)
    fetch_retries: int = 0  # shuffle-fetch retries this attempt paid
    # finished spans piggybacked from the executor (obs/recorder.py span
    # dicts); absorbed into the scheduler's TraceStore, never persisted
    spans: List[dict] = field(default_factory=list)
    # True for the scheduler-launched duplicate copy racing a straggler
    # (TaskDefinition.speculative, echoed back in TaskStatus.speculative)
    speculative: bool = False


@dataclass
class StageInput:
    """Accumulated output of one producing stage, as seen by a consumer
    (reference: execution_stage.rs StageOutput)."""

    complete: bool = False
    # output partition index -> locations from each completed map task
    partition_locations: Dict[int, List[PartitionLocation]] = field(
        default_factory=dict
    )

    def add_partition(self, loc: PartitionLocation) -> None:
        self.partition_locations.setdefault(loc.partition_id.partition_id, []).append(
            loc
        )


# ------------------------------------------------------------------- stages
@dataclass
class UnresolvedStage:
    stage_id: int
    plan: ShuffleWriterExec
    output_links: List[int] = field(default_factory=list)
    inputs: Dict[int, StageInput] = field(default_factory=dict)
    # AQE decision summary (scheduler/adaptive.py): {tasks_before,
    # tasks_after, coalesced_groups, skew_splits, broadcast}.  Non-empty
    # means the plan was already rewritten — replanning is idempotent
    # across rollback/re-resolve.  Carried through every transition and
    # merged into stage_metrics as __aqe__ at to_completed so it
    # persists with the graph and surfaces in the job profile.
    aqe: Dict[str, int] = field(default_factory=dict)

    @property
    def partitions(self) -> int:
        return self.plan.output_partitioning().n

    def add_input_partitions(
        self, stage_id: int, locations: List[PartitionLocation]
    ) -> None:
        if stage_id not in self.inputs:
            raise SchedulerError(
                f"stage {self.stage_id} has no input from stage {stage_id}"
            )
        for loc in locations:
            self.inputs[stage_id].add_partition(loc)

    def remove_input_partitions(self, executor_id: str) -> None:
        """Strip locations served by a lost executor and mark those inputs
        incomplete (reference: execution_stage.rs remove_input_partitions)."""
        for inp in self.inputs.values():
            changed = False
            for p, locs in inp.partition_locations.items():
                kept = [l for l in locs if l.executor_meta.id != executor_id]
                if len(kept) != len(locs):
                    changed = True
                inp.partition_locations[p] = kept
            if changed:
                inp.complete = False

    def complete_input(self, stage_id: int) -> None:
        if stage_id in self.inputs:
            self.inputs[stage_id].complete = True

    def resolvable(self) -> bool:
        return all(i.complete for i in self.inputs.values())

    def to_resolved(
        self, tail_stage_ids: frozenset = frozenset()
    ) -> "ResolvedStage":
        """Resolve against the accumulated input locations.  With
        ``tail_stage_ids`` (pipelined execution) those producers resolve
        to TAILING readers instead — no static locations; the executor
        streams the scheduler's shuffle-location feed — and the stage
        starts while they are still running."""
        tail = frozenset(tail_stage_ids)
        locations: Dict[int, List[List[PartitionLocation]]] = {}
        for shuffle in find_unresolved_shuffles(self.plan):
            if shuffle.stage_id in tail:
                continue
            inp = self.inputs.get(shuffle.stage_id)
            if inp is None or not inp.complete:
                raise SchedulerError(
                    f"stage {self.stage_id}: input stage {shuffle.stage_id} "
                    "is not complete"
                )
            locations[shuffle.stage_id] = [
                sorted(
                    inp.partition_locations.get(p, []),
                    key=lambda l: l.path,
                )
                for p in range(shuffle.output_partition_count)
            ]
        resolved_plan = (
            remove_unresolved_shuffles(self.plan, locations, tail)
            if locations or tail
            else self.plan
        )
        return ResolvedStage(
            self.stage_id,
            resolved_plan,
            list(self.output_links),
            dict(self.inputs),
            aqe=dict(self.aqe),
            tail_inputs=set(tail),
        )


@dataclass
class ResolvedStage:
    stage_id: int
    plan: ShuffleWriterExec
    output_links: List[int] = field(default_factory=list)
    inputs: Dict[int, StageInput] = field(default_factory=dict)
    aqe: Dict[str, int] = field(default_factory=dict)
    # query-doctor anchor: wall-clock ns when this stage became
    # dispatchable (every producer committed; graph build for leaves).
    # 0 = unknown (decoded graphs) — attribution degrades, never fails.
    ready_unix_ns: int = 0
    # pipelined execution: producer stage ids this stage reads
    # through TAILING readers (resolved before the producer completed).
    # Empty on the barrier path.  In-memory only — a partially-resolved
    # stage persists as Unresolved (see ExecutionGraph.encode) so a
    # restarted scheduler re-resolves against real state.
    tail_inputs: set = field(default_factory=set)

    @property
    def partitions(self) -> int:
        return self.plan.output_partitioning().n

    def to_running(self) -> "RunningStage":
        return RunningStage(
            self.stage_id,
            self.plan,
            list(self.output_links),
            dict(self.inputs),
            [None] * self.partitions,
            aqe=dict(self.aqe),
            ready_unix_ns=self.ready_unix_ns,
            tail_inputs=set(self.tail_inputs),
            started_on_partial=bool(self.tail_inputs),
        )

    def to_unresolved(self) -> UnresolvedStage:
        """Roll back for executor-loss recovery.  The rolled-back plan
        keeps its AQE selections (rollback_resolved_shuffles) and the
        ``aqe`` marker, so re-resolution reuses the rewritten layout."""
        return UnresolvedStage(
            self.stage_id,
            rollback_resolved_shuffles(self.plan),
            list(self.output_links),
            dict(self.inputs),
            aqe=dict(self.aqe),
        )


@dataclass
class RunningStage:
    stage_id: int
    plan: ShuffleWriterExec
    output_links: List[int]
    inputs: Dict[int, StageInput]
    task_statuses: List[Optional[TaskInfo]]
    stage_metrics: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # fault tolerance (partition -> value); sparse so stage transitions
    # constructed positionally keep working
    task_attempts: Dict[int, int] = field(default_factory=dict)
    task_failures: Dict[int, List[str]] = field(default_factory=dict)
    # the executor that last failed the partition: its retry never goes
    # back there while another live executor exists
    task_exclusions: Dict[int, str] = field(default_factory=dict)
    task_fetch_retries: Dict[int, int] = field(default_factory=dict)
    # ---- speculative execution + deadlines (all transient: Running
    # stages persist as Resolved, so none of this survives restart) ----
    # partition -> the PRIMARY attempt's executor id: the speculation
    # scan flagged it a straggler; the normal dispatch path hands the
    # duplicate to any OTHER executor
    speculation_requests: Dict[int, str] = field(default_factory=dict)
    # partition -> the duplicate attempt currently running (at most one
    # shadow per partition; same attempt number as the primary)
    speculative_statuses: Dict[int, "TaskInfo"] = field(default_factory=dict)
    # monotonic dispatch anchors (primary / shadow) for runtime stats,
    # the straggler threshold and the deadline reaper
    task_started_mono: Dict[int, float] = field(default_factory=dict)
    spec_started_mono: Dict[int, float] = field(default_factory=dict)
    # runtimes (seconds) of this stage's committed completions: the
    # median feeds the speculation threshold
    completed_runtime_s: List[float] = field(default_factory=list)
    # attempts granted beyond ballista.task.max_attempts (deadline reaps
    # bump the attempt counter for staleness but must not consume the
    # task's failure budget)
    task_free_attempts: Dict[int, int] = field(default_factory=dict)
    # cumulative launched/wins/wasted rollup (carried to CompletedStage
    # for the /api/jobs/{id}/profile speculation column)
    spec_stats: Dict[str, int] = field(default_factory=dict)
    # ---- stage skew analytics: per-partition inputs for the
    # completion-time reduction.  partition -> committed runtime seconds
    # (the winner's, when a race ran) and -> written bytes {raw, wire};
    # to_completed() reduces them to p50/p99/max-over-median coefficients
    # inside stage_metrics, which already persist past cache eviction
    task_runtime_s: Dict[int, float] = field(default_factory=dict)
    task_bytes: Dict[int, Dict[str, int]] = field(default_factory=dict)
    # AQE decision summary (see UnresolvedStage.aqe)
    aqe: Dict[str, int] = field(default_factory=dict)
    # ---- locality-aware placement (populated by
    # ExecutionGraph.revive only when ballista.shuffle.locality_enabled,
    # so knob-off placement is byte-identical to the baseline) ----
    # partition -> normalized host holding the most bytes of its input
    # shuffle partitions (exact sizes from the map-side write stats)
    task_preferred_host: Dict[int, str] = field(default_factory=dict)
    # dispatch rollup: {"local": popped on the preferred host, "any":
    # popped elsewhere after/without the locality wait}
    locality_stats: Dict[str, int] = field(default_factory=dict)
    # wait anchor: tasks may hold out for their preferred host until
    # running_since_mono + locality_wait_s
    running_since_mono: float = field(default_factory=time.monotonic)
    # set when a pop DEFERRED a task for its preferred host (cleared on
    # the next successful pop): the push-mode 1s tick re-mints
    # reservations ONLY for stages that actually turned a slot away —
    # otherwise the timer would double-book slots the event-driven flow
    # already covers, every second
    locality_deferred: bool = False
    # ---- query-doctor timeline anchors: everything below is
    # wall-clock (epoch ns) because critical-path attribution subtracts
    # anchors recorded at different points in the job's life and must
    # align with the journal's timestamps; all recorded on the scheduler
    # so one clock serves the whole job.  Reduced to the __stage_timing__
    # / __task_*_us__ synthetic metrics at to_completed (persist past
    # eviction/restart like the skew analytics).
    ready_unix_ns: int = 0
    # partition -> dispatch anchor of the CURRENT attempt (reset with the
    # attempt, so a retry's breakdown reflects the attempt that committed)
    task_dispatch_unix_ns: Dict[int, int] = field(default_factory=dict)
    # ...and of the partition's racing speculative duplicate: when the
    # duplicate wins (or is promoted in place), ITS dispatch anchor
    # replaces the straggler's, so the committed attempt's window never
    # includes the straggler's dead time
    spec_dispatch_unix_ns: Dict[int, int] = field(default_factory=dict)
    # partition -> commit anchor (the winner's completion report)
    task_finish_unix_ns: Dict[int, int] = field(default_factory=dict)
    # ---- pipelined execution ----
    # producer stage ids this stage reads through TAILING readers; fixed
    # for the stage's lifetime (producer completion flips the matching
    # StageInput.complete and the feed's complete flag instead)
    tail_inputs: set = field(default_factory=set)
    # True when the stage was dispatched on partial map output: its task
    # runtimes include stall-on-producer, so the progress ETA median
    # excludes them, and to_completed persists the __pipelined__ marker
    started_on_partial: bool = False

    @property
    def partitions(self) -> int:
        return len(self.task_statuses)

    def available_tasks(self) -> int:
        # pending speculation requests count as dispatchable work so push
        # mode mints slots for them
        return (
            sum(1 for t in self.task_statuses if t is None)
            + len(self.speculation_requests)
        )

    def bump_spec_stat(self, key: str, n: int = 1) -> None:
        self.spec_stats[key] = self.spec_stats.get(key, 0) + n

    def drop_speculative(self, p: int) -> Optional["TaskInfo"]:
        """Forget partition ``p``'s duplicate attempt (loser/failed/reset);
        returns the dropped TaskInfo so the caller can cancel it.
        Promotion sites that need the duplicate's timing anchors read
        ``spec_started_mono`` / ``spec_dispatch_unix_ns`` BEFORE calling
        this."""
        self.spec_started_mono.pop(p, None)
        self.spec_dispatch_unix_ns.pop(p, None)
        self.speculation_requests.pop(p, None)
        return self.speculative_statuses.pop(p, None)

    def update_task_status(self, info: TaskInfo) -> None:
        p = info.partition_id.partition_id
        if not (0 <= p < self.partitions):
            raise SchedulerError(
                f"stage {self.stage_id}: task partition {p} out of range"
            )
        self.task_statuses[p] = info

    def update_task_metrics(self, info: TaskInfo) -> None:
        """Merge one task's per-operator metrics into the combined stage
        metrics (reference: execution_stage.rs RunningStage::update_task_metrics)."""
        for op_name, values in info.metrics:
            agg = self.stage_metrics.setdefault(op_name, {})
            for k, v in values.items():
                agg[k] = agg.get(k, 0) + v

    def is_completed(self) -> bool:
        return all(t is not None and t.state == "completed" for t in self.task_statuses)

    def completed_tasks(self) -> int:
        return sum(
            1 for t in self.task_statuses if t is not None and t.state == "completed"
        )

    def reset_tasks(self, executor_id: str, keep_task=None) -> int:
        """Clear every task that ran on a lost executor; returns count.

        ``keep_task(t)`` (optional) exempts a status from the reset —
        the replica-aware executor-loss path keeps COMPLETED tasks whose
        every output partition has a surviving external copy, so a
        partially-finished stage on a drained executor re-runs nothing.

        Speculation interplay: a duplicate attempt ON the lost executor
        simply disappears (wasted); a duplicate running ELSEWHERE is
        promoted to primary when its primary was on the lost host — the
        partition stays covered without a re-dispatch."""
        for p, si in list(self.speculative_statuses.items()):
            if si.executor_id == executor_id:
                self.drop_speculative(p)
                self.bump_spec_stat("wasted")
        n = 0
        for i, t in enumerate(self.task_statuses):
            if t is not None and t.executor_id == executor_id:
                if keep_task is not None and keep_task(t):
                    continue
                shadow = None
                if t.state == "running":
                    spec_started = self.spec_started_mono.get(i)
                    spec_dispatch = self.spec_dispatch_unix_ns.get(i)
                    shadow = self.drop_speculative(i)
                if shadow is not None:
                    self.task_statuses[i] = shadow
                    if spec_started is not None:
                        self.task_started_mono[i] = spec_started
                    else:
                        self.task_started_mono.pop(i, None)
                    if spec_dispatch is not None:
                        self.task_dispatch_unix_ns[i] = spec_dispatch
                else:
                    self.task_statuses[i] = None
                    self.task_started_mono.pop(i, None)
                    n += 1
        return n

    def to_completed(self) -> "CompletedStage":
        from ..obs.export import (
            AQE_OP,
            stage_skew_metrics,
            stage_timing_metrics,
        )

        # reduce the per-partition runtime/bytes distributions to skew
        # coefficients NOW — stage_metrics persist in the graph proto, so
        # the profile keeps its skew column after cache eviction/restart
        metrics = dict(self.stage_metrics)
        metrics.update(stage_skew_metrics(self.task_runtime_s, self.task_bytes))
        # ...and the critical-path timeline anchors (ready/dispatch/commit
        # per partition) ride the same persistence path
        metrics.update(
            stage_timing_metrics(
                self.ready_unix_ns,
                self.task_dispatch_unix_ns,
                self.task_finish_unix_ns,
            )
        )
        if self.aqe:
            # the replan decision rides the same persistence path as the
            # skew analytics: visible in the profile after eviction/restart
            metrics[AQE_OP] = dict(self.aqe)
        if self.locality_stats:
            # placement hit-rate persists alongside the data-plane
            # local/remote fetch counters (which live in the reader
            # operator's own metrics)
            from ..obs.export import LOCALITY_OP

            metrics[LOCALITY_OP] = dict(self.locality_stats)
        if self.started_on_partial:
            # the stage ran pipelined: persist the marker so progress/ETA
            # and the doctor can tell stall-inflated runtimes apart after
            # eviction/restart
            from ..obs.export import PIPELINED_OP

            metrics[PIPELINED_OP] = {
                "partial_start": 1,
                "tail_inputs": len(self.tail_inputs),
            }
        return CompletedStage(
            self.stage_id,
            self.plan,
            list(self.output_links),
            dict(self.inputs),
            list(self.task_statuses),
            metrics,
            dict(self.task_attempts),
            dict(self.task_fetch_retries),
            spec_stats=dict(self.spec_stats),
        )

    def to_failed(self, error: str) -> "FailedStage":
        return FailedStage(
            self.stage_id,
            self.plan,
            list(self.output_links),
            error,
        )

    def to_resolved(self) -> ResolvedStage:
        """Drop in-flight work (persistence rule: Running is stored as
        Resolved so a restarted scheduler re-dispatches)."""
        return ResolvedStage(
            self.stage_id, self.plan, list(self.output_links),
            dict(self.inputs), aqe=dict(self.aqe),
            ready_unix_ns=self.ready_unix_ns,
            tail_inputs=set(self.tail_inputs),
        )


@dataclass
class CompletedStage:
    stage_id: int
    plan: ShuffleWriterExec
    output_links: List[int]
    inputs: Dict[int, StageInput]
    task_statuses: List[Optional[TaskInfo]]
    stage_metrics: Dict[str, Dict[str, int]] = field(default_factory=dict)
    task_attempts: Dict[int, int] = field(default_factory=dict)
    task_fetch_retries: Dict[int, int] = field(default_factory=dict)
    # speculation rollup inherited from the RunningStage (profile column)
    spec_stats: Dict[str, int] = field(default_factory=dict)

    @property
    def partitions(self) -> int:
        return len(self.task_statuses)

    def completed_tasks(self) -> int:
        return sum(
            1 for t in self.task_statuses if t is not None and t.state == "completed"
        )

    def output_partition_bytes(self) -> Dict[int, int]:
        """EXACT wire bytes per OUTPUT (reduce) partition this stage
        wrote, summed over the committed winners' per-fragment stats —
        the direct sizing input for adaptive re-planning.  Unlike the
        ``__task_bytes_*__`` skew maps (keyed by MAP task, reduced to
        quantiles), this is the reduce-side distribution, recomputed
        from ``task_statuses`` (which persist in the graph proto), so
        AQE never reconstructs sizes from metric rollups."""
        return self._sum_output_partitions("num_bytes")

    def output_partition_rows(self) -> Dict[int, int]:
        """Row counterpart of :meth:`output_partition_bytes`."""
        return self._sum_output_partitions("num_rows")

    def _sum_output_partitions(self, attr: str) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for t in self.task_statuses:
            if t is None:
                continue
            for p in t.partitions:
                out[p.partition_id] = out.get(p.partition_id, 0) + int(
                    getattr(p, attr) or 0
                )
        return out

    def to_running(self) -> RunningStage:
        """Re-run after its shuffle files were lost with an executor."""
        from ..obs.export import (
            AQE_OP,
            STAGE_TIMING_OP,
            TASK_BYTES_RAW_OP,
            TASK_BYTES_WIRE_OP,
            TASK_DISPATCH_OP,
            TASK_FINISH_OP,
            TASK_RUNTIME_OP,
        )

        # Seed the skew inputs from the persisted per-partition maps so
        # re-completion reduces over the FULL distribution (re-run
        # partitions overwrite their own entries) — otherwise a 1-task
        # lost-shuffle re-run would overwrite a 100-partition stage's
        # skew with partitions=1.  ms + 0.5 survives to_completed's
        # int(v * 1e3) truncation exactly (v/1e3*1e3 can land just
        # below the integer).
        runtime_s = {
            int(p): (v + 0.5) / 1e3
            for p, v in self.stage_metrics.get(TASK_RUNTIME_OP, {}).items()
        }
        wire = self.stage_metrics.get(TASK_BYTES_WIRE_OP, {})
        raw = self.stage_metrics.get(TASK_BYTES_RAW_OP, {})
        task_bytes = {
            int(p): {"wire": int(wire.get(p, 0)), "raw": int(raw.get(p, 0))}
            for p in set(wire) | set(raw)
        }
        return RunningStage(
            self.stage_id,
            self.plan,
            list(self.output_links),
            dict(self.inputs),
            list(self.task_statuses),
            dict(self.stage_metrics),
            dict(self.task_attempts),
            {},
            {},
            dict(self.task_fetch_retries),
            spec_stats=dict(self.spec_stats),
            task_runtime_s=runtime_s,
            task_bytes=task_bytes,
            aqe=dict(self.stage_metrics.get(AQE_OP, {})),
            # seed the timeline anchors back from the persisted maps so a
            # partial re-run re-reduces the FULL timing distribution (the
            # same rule the skew seeds follow); re-run partitions simply
            # overwrite their own entries at re-dispatch/re-commit
            ready_unix_ns=self.stage_metrics.get(STAGE_TIMING_OP, {}).get(
                "ready_us", 0
            )
            * 1000,
            task_dispatch_unix_ns={
                int(p): int(v) * 1000
                for p, v in self.stage_metrics.get(TASK_DISPATCH_OP, {}).items()
            },
            task_finish_unix_ns={
                int(p): int(v) * 1000
                for p, v in self.stage_metrics.get(TASK_FINISH_OP, {}).items()
            },
        )

    def reset_tasks(self, executor_id: str) -> int:
        n = 0
        for i, t in enumerate(self.task_statuses):
            if t is not None and t.executor_id == executor_id:
                self.task_statuses[i] = None
                n += 1
        return n


@dataclass
class FailedStage:
    stage_id: int
    plan: ShuffleWriterExec
    output_links: List[int]
    error: str

    @property
    def partitions(self) -> int:
        return self.plan.output_partitioning().n
