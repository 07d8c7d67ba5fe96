"""Distributed planner: split a physical plan into shuffle-bounded stages.

Counterpart of the reference's ``scheduler/src/planner.rs``:

* recursive walk of the physical plan; at ``RepartitionExec(hash)`` insert a
  ``ShuffleWriterExec`` with that hash partitioning and replace the subtree
  with an ``UnresolvedShuffleExec`` placeholder (`planner.rs:127-156`);
* at ``CoalescePartitionsExec`` insert a ``ShuffleWriterExec`` with no
  repartitioning under the coalesce (`planner.rs:97-125`);
* non-hash repartitions are dropped (`planner.rs:157-164`);
* finally the root is wrapped in a ``ShuffleWriterExec`` with no
  partitioning — its output files are the job's result (`planner.rs:61-76`).

Also ``remove_unresolved_shuffles`` (swap placeholders for readers with real
locations once producing stages complete, `planner.rs:199-247`) and
``rollback_resolved_shuffles`` (the inverse, for executor-loss recovery,
`planner.rs:252-275`).
"""

from __future__ import annotations

from typing import Dict, List

from ..errors import PlanError
from ..exec.operators import (
    CoalescePartitionsExec,
    ExecutionPlan,
    RepartitionExec,
)
from ..serde.scheduler_types import PartitionLocation
from ..shuffle import ShuffleReaderExec, ShuffleWriterExec, UnresolvedShuffleExec


class DistributedPlanner:
    def __init__(self, work_dir: str = "/tmp/ballista-tpu", config=None):
        from ..config import BallistaConfig

        self.work_dir = work_dir
        self.config = config or BallistaConfig()
        self._next_stage_id = 0

    def _maybe_gang(self, plan: ExecutionPlan, part=None) -> ExecutionPlan:
        """TPU-native stage forms (two shapes):

        * the subtree fuses into a partial aggregate → MeshGangExec: the
          cross-partition exchange is a psum over ICI and only
          [capacity]-sized states reach the shuffle;
        * the stage feeds a hash repartition (``part``) → MeshRepartition-
          Exec: rows route to their output partition with one all_to_all
          over ICI and the writer persists pre-partitioned batches —
          replacing the per-partition hash-split + disk+Flight hop the
          reference always takes (shuffle_writer.rs:142-292, :201-285).
        """
        from ..parallel.mesh_stage import (
            MeshGangExec,
            MeshRepartitionExec,
            exchange_supported,
            gang_eligible,
        )

        if not (self.config.mesh_enable and self.config.tpu_enable):
            return plan
        if plan.output_partitioning().n <= 1:
            return plan  # single partition: nothing to gang
        if gang_eligible(plan):
            return MeshGangExec(plan, self.config.mesh_devices)
        if (
            part is not None
            and part.kind == "hash"
            and part.exprs
            and exchange_supported(plan.schema)
        ):
            return MeshRepartitionExec(plan, part, self.config.mesh_devices)
        return plan

    def _new_stage_id(self) -> int:
        self._next_stage_id += 1
        return self._next_stage_id

    def plan_query_stages(
        self, job_id: str, plan: ExecutionPlan
    ) -> List[ShuffleWriterExec]:
        """Return all stages; the last entry is the job's root stage."""
        stages, root = self._plan(job_id, plan)
        stages.append(self._create_shuffle_writer(job_id, root, None))
        return stages

    def _plan(
        self, job_id: str, plan: ExecutionPlan
    ) -> tuple[List[ShuffleWriterExec], ExecutionPlan]:
        stages: List[ShuffleWriterExec] = []
        children = []
        for child in plan.children():
            child_stages, child_plan = self._plan(job_id, child)
            stages.extend(child_stages)
            children.append(child_plan)

        if isinstance(plan, CoalescePartitionsExec):
            writer = self._create_shuffle_writer(
                job_id, self._maybe_gang(children[0]), None
            )
            stages.append(writer)
            placeholder = UnresolvedShuffleExec(
                writer.stage_id,
                writer.input_schema,
                writer.output_partitioning().n,
                # no repartition: one output file per input partition
                writer.output_partitioning().n,
            )
            return stages, plan.with_new_children([placeholder])

        if isinstance(plan, RepartitionExec):
            part = plan.partitioning
            if part.kind == "hash":
                writer = self._create_shuffle_writer(
                    job_id, self._maybe_gang(children[0], part), part
                )
                stages.append(writer)
                placeholder = UnresolvedShuffleExec(
                    writer.stage_id,
                    writer.input_schema,
                    writer.output_partitioning().n,
                    part.n,
                )
                return stages, placeholder
            # round-robin / unknown repartitions add nothing across a
            # process boundary: drop the node (reference planner.rs:157-164)
            return stages, children[0]

        if children:
            return stages, plan.with_new_children(children)
        return stages, plan

    def _create_shuffle_writer(
        self, job_id: str, plan: ExecutionPlan, partitioning
    ) -> ShuffleWriterExec:
        return ShuffleWriterExec(
            job_id, self._new_stage_id(), plan, self.work_dir, partitioning
        )


def classify_shuffle_inputs(plan: ExecutionPlan) -> tuple:
    """Pipelined-execution eligibility walk: split a stage
    plan's shuffle inputs into ``(streamable, breakers)`` — sets of
    producing stage ids.

    A shuffle input is *streamable* when no pipeline-breaking operator
    sits between the shuffle read and the stage root, so the stage can
    start consuming the producer's output before every map task has
    committed: filter, project, union, limit, aggregates (partial OR
    final — they consume a stream; a final agg still cannot EMIT early,
    but it can overlap its reads with the producing stage's tail) and
    the PROBE side of a hash join all pass through.  ``SortExec`` and
    ``WindowExec`` (which sorts internally) are breakers, as is the
    BUILD (left) side of any join — a build-side read gains nothing
    from starting early and would pin a slot against the barrier
    anyway.  Leaves are matched by ``stage_id`` attribute, so the walk
    classifies both unresolved placeholders and already-resolved
    readers (the doctor runs it over completed stages too).  A stage id
    reachable both ways (self-join of one producer) classifies as a
    breaker — partial start must be safe for EVERY read of that input.
    """
    from ..exec.joins import CrossJoinExec, HashJoinExec
    from ..exec.operators import SortExec
    from ..exec.window import WindowExec

    streamable: set = set()
    breakers: set = set()

    def walk(node: ExecutionPlan, under_breaker: bool) -> None:
        if isinstance(node, (UnresolvedShuffleExec, ShuffleReaderExec)):
            (breakers if under_breaker else streamable).add(node.stage_id)
            return
        if isinstance(node, (SortExec, WindowExec)):
            under_breaker = True
        children = node.children()
        if isinstance(node, (HashJoinExec, CrossJoinExec)) and children:
            walk(children[0], True)  # build side barriers
            for c in children[1:]:
                walk(c, under_breaker)
            return
        for c in children:
            walk(c, under_breaker)

    walk(plan, False)
    # an input read through BOTH a streamable and a breaker edge must
    # barrier for the breaker read
    streamable -= breakers
    return streamable, breakers


def find_unresolved_shuffles(plan: ExecutionPlan) -> List[UnresolvedShuffleExec]:
    out: List[UnresolvedShuffleExec] = []
    if isinstance(plan, UnresolvedShuffleExec):
        out.append(plan)
    for c in plan.children():
        out.extend(find_unresolved_shuffles(c))
    return out


def remove_unresolved_shuffles(
    plan: ExecutionPlan,
    partition_locations: Dict[int, List[List[PartitionLocation]]],
    tail_stage_ids: frozenset = frozenset(),
) -> ExecutionPlan:
    """Swap every UnresolvedShuffleExec for a ShuffleReaderExec with the
    producing stage's real output locations.

    ``partition_locations[stage]`` is always keyed by SOURCE reduce
    partition; a placeholder carrying AQE ``selections`` maps those
    source lists onto its coalesced/split task layout here, so two
    leaves reading the same producer stage can do so through different
    layouts (e.g. the split side and the duplicated side of a skew-split
    join).

    ``tail_stage_ids`` (pipelined execution): producers whose
    output is still GROWING — their leaves resolve to TAILING readers
    that carry no static locations and instead stream the scheduler's
    shuffle-location feed at execution time (``shuffle/delta_store``).
    Only valid for selections-free leaves (partial resolution is gated
    off for AQE-rewritten layouts)."""
    if isinstance(plan, UnresolvedShuffleExec):
        from ..shuffle.execution_plans import apply_read_selections

        if plan.stage_id in tail_stage_ids:
            if plan.selections is not None:
                raise PlanError(
                    f"stage {plan.stage_id}: cannot tail an AQE-rewritten "
                    "shuffle read"
                )
            return ShuffleReaderExec(
                plan.stage_id,
                plan.schema,
                [[] for _ in range(plan.output_partition_count)],
                source_partition_count=plan.output_partition_count,
                tail=True,
            )
        locs = partition_locations.get(plan.stage_id)
        if locs is None:
            raise PlanError(
                f"no partition locations for stage {plan.stage_id}"
            )
        if len(locs) != plan.output_partition_count:
            raise PlanError(
                f"stage {plan.stage_id}: expected "
                f"{plan.output_partition_count} output partitions, got {len(locs)}"
            )
        if plan.selections is not None:
            locs = apply_read_selections(plan.selections, locs)
        return ShuffleReaderExec(
            plan.stage_id,
            plan.schema,
            locs,
            selections=plan.selections,
            source_partition_count=plan.output_partition_count,
        )
    children = plan.children()
    if not children:
        return plan
    return plan.with_new_children(
        [
            remove_unresolved_shuffles(c, partition_locations, tail_stage_ids)
            for c in children
        ]
    )


def rollback_resolved_shuffles(plan: ExecutionPlan) -> ExecutionPlan:
    """Inverse of remove_unresolved_shuffles (executor-loss recovery).

    An AQE-rewritten reader rolls back to a placeholder carrying the
    SAME selections, so the re-resolved consumer keeps its adaptive
    task layout instead of silently reverting to the static plan (whose
    partition indexing the reader's task count no longer matches)."""
    if isinstance(plan, ShuffleReaderExec):
        n_src = (
            plan.source_partition_count
            if plan.source_partition_count
            else len(plan.partition)
        )
        # input partition count is not recoverable from the reader alone and
        # is not needed to re-resolve; re-derived when the stage re-completes
        return UnresolvedShuffleExec(
            plan.stage_id, plan.schema, n_src, n_src,
            selections=plan.selections,
        )
    children = plan.children()
    if not children:
        return plan
    return plan.with_new_children(
        [rollback_resolved_shuffles(c) for c in children]
    )
