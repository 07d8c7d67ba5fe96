"""Adaptive query execution (AQE): re-plan stages from observed shuffle
statistics.

The Spark-AQE move applied to the Ballista stage DAG (PAPER.md §1:
``ExecutionGraph``/``UnresolvedShuffleExec`` is the natural re-planning
seam).  The scheduler resolves stages lazily, and by the time a consumer
resolves, every producer has already REPORTED exact per-reduce-partition
output sizes (``CompletedStage.output_partition_bytes``, from the
write path's per-fragment stats).  This module feeds those sizes back
into planning at two hook points:

* :func:`replan_stage` — called by ``ExecutionGraph.revive()`` on an
  ``UnresolvedStage`` the moment it becomes resolvable, BEFORE
  ``to_resolved()``.  Rewrites the not-yet-dispatched reduce-task
  layout in place:

  1. **partition coalescing** — pack adjacent tiny reduce partitions
     into fewer tasks until each reads ~``ballista.aqe.
     target_partition_bytes``, so a 64-way shuffle whose output is 3 MB
     runs 2 reduce tasks instead of 64;
  2. **skew splitting** — a reduce partition whose observed input
     exceeds ``ballista.aqe.skew_factor`` × median is split across K
     tasks, each reading a disjoint chunk of the map-side fragments.
     Joins duplicate the companion side's partition into every chunk
     task (each probe row still sees the full build rows for its hash
     partition, so the union of the chunk outputs IS the partition's
     join output).  A stage whose body is a final hash aggregate is
     rewritten to a merge-partial aggregate (states in → states out)
     and every consumer gets the original final merge injected above
     its reader, so results stay correct for non-decomposable outputs
     like avg.

* :func:`try_broadcast` — called when a stage COMPLETES, before its
  consumers can resolve.  When the completed stage is one side of a
  partitioned inner join and measured under ``ballista.aqe.
  broadcast_threshold_bytes`` — and the probe-side producer has not
  started — the join converts to the existing COLLECT_LEFT build-side
  broadcast path (``exec/joins.py``) and the probe-side shuffle stage
  is deleted outright, its subtree inlined into the consumer: the big
  side's rows never touch disk or the wire.

All rewrites are deterministic functions of persisted state (stats live
in ``CompletedStageProto``, the policy in ``ExecutionGraphProto.
aqe_settings_json``, the chosen layouts inside the stage plans), so HA
adoption and scheduler restart replay the same decisions.  Every rewrite
journals an ``aqe_replan`` event and stamps the stage's ``aqe`` summary
(surfaced as ``__aqe__`` stage metrics → ``/api/jobs/{id}/profile``).

A failure anywhere in here must never fail the job: the graph's hook
wrappers catch and fall back to the static plan.
"""

from __future__ import annotations

import json
import logging
import math
import statistics
from dataclasses import asdict, dataclass, fields
from typing import Dict, List, Optional, Tuple

from ..exec.aggregates import FINAL, PARTIAL, AggSpec, HashAggregateExec
from ..exec.expressions import Col
from ..exec.joins import COLLECT_LEFT, PARTITIONED, HashJoinExec
from ..exec.operators import ExecutionPlan, FilterExec, ProjectionExec
from ..exec.planner import RenameSchemaExec
from ..shuffle import UnresolvedShuffleExec
from .execution_stage import CompletedStage, ResolvedStage, RunningStage, UnresolvedStage
from .planner import find_unresolved_shuffles, rollback_resolved_shuffles

log = logging.getLogger(__name__)

# aggregate functions whose FINAL-stage merge decomposes into a partial
# re-merge over the state columns (sum→sum, count→sum of counts,
# min/max→min/max, avg→sum of its sum+count states).  Everything else
# (distinct/median/stddev/udaf) plans single-stage and never reaches a
# FINAL stage anyway.
_MERGEABLE_FUNCS = frozenset({"sum", "count", "min", "max", "avg"})


@dataclass(frozen=True)
class AqePolicy:
    """ballista.aqe.* knobs snapshot, persisted with the graph so a
    restarted/adopting scheduler replays the same decisions."""

    enabled: bool = False
    coalesce_enabled: bool = True
    broadcast_enabled: bool = False
    skew_enabled: bool = False
    target_partition_bytes: int = 16 << 20
    broadcast_threshold_bytes: int = 10 << 20
    skew_factor: float = 4.0
    max_splits: int = 8
    coalesce_min_partitions: int = 8

    @classmethod
    def from_config(cls, config) -> "AqePolicy":
        if config is None:
            return cls()
        return cls(
            enabled=config.aqe_enabled,
            coalesce_enabled=config.aqe_coalesce_enabled,
            broadcast_enabled=config.aqe_broadcast_enabled,
            skew_enabled=config.aqe_skew_enabled,
            target_partition_bytes=config.aqe_target_partition_bytes,
            broadcast_threshold_bytes=config.aqe_broadcast_threshold_bytes,
            skew_factor=config.aqe_skew_factor,
            max_splits=config.aqe_max_splits,
            coalesce_min_partitions=config.aqe_coalesce_min_partitions,
        )

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "AqePolicy":
        if not raw:
            return cls()
        try:
            data = json.loads(raw)
            known = {f.name for f in fields(cls)}
            return cls(**{k: v for k, v in data.items() if k in known})
        except Exception:  # noqa: BLE001 - tolerate future/garbage payloads
            return cls()


# --------------------------------------------------------------- structure
# single-child wrappers between a stage's shuffle writer and its join
# under which per-row independence holds: the union of the rewritten
# tasks' outputs equals the static plan's output (PARTIAL aggregates
# qualify because every downstream consumer merges partial states from
# an arbitrary number of map tasks anyway)
def _union_safe(node: ExecutionPlan) -> bool:
    if isinstance(node, (FilterExec, ProjectionExec, RenameSchemaExec)):
        return True
    return isinstance(node, HashAggregateExec) and node.mode == PARTIAL


def _body_below_wrappers(node: ExecutionPlan) -> ExecutionPlan:
    while _union_safe(node) and len(node.children()) == 1:
        node = node.children()[0]
    return node


def _split_sides(join: HashJoinExec) -> frozenset:
    """Which join inputs may be chunk-split: the side whose every row's
    output is independent of the other rows ON THAT SIDE.  Splitting the
    other side would recompute its unmatched/padded rows once per chunk."""
    if join.partition_mode == COLLECT_LEFT:
        return frozenset({"right"}) if join.join_type == "inner" else frozenset()
    return {
        "inner": frozenset({"left", "right"}),
        "left": frozenset({"left"}),
        "semi": frozenset({"left"}),
        "anti": frozenset({"left"}),
        "right": frozenset({"right"}),
    }.get(join.join_type, frozenset())


def _replace_node(
    plan: ExecutionPlan, old: ExecutionPlan, new: ExecutionPlan
) -> ExecutionPlan:
    """Rebuild ``plan`` with the (identity-matched) ``old`` subtree
    swapped for ``new``."""
    return _replace_nodes(plan, {id(old): new})


def _replace_nodes(
    plan: ExecutionPlan, mapping: Dict[int, ExecutionPlan]
) -> ExecutionPlan:
    """Swap several identity-matched subtrees (``id(old) -> new``) in
    ONE rebuild.  Sequential single swaps would not compose: the first
    rebuild replaces every interior node, so later identity keys taken
    against the ORIGINAL tree no longer match anything."""
    if id(plan) in mapping:
        return mapping[id(plan)]
    children = plan.children()
    if not children:
        return plan
    new_children = [_replace_nodes(c, mapping) for c in children]
    if all(a is b for a, b in zip(new_children, children)):
        return plan
    return plan.with_new_children(new_children)


# ----------------------------------------------------------- skew targets
def _join_split_candidates(
    plan_root, leaves: List[UnresolvedShuffleExec]
) -> List[UnresolvedShuffleExec]:
    """The leaves whose fragments may be chunk-split when the stage body
    is a join reachable through union-safe wrappers; [] when the shape
    does not qualify."""
    body = _body_below_wrappers(plan_root.input)
    if not isinstance(body, HashJoinExec):
        return []
    sides = _split_sides(body)
    if not sides:
        return []
    # every leaf of the stage must be a direct join input: a leaf hiding
    # elsewhere in the tree would not get the duplicate treatment
    join_leaves = {
        id(c)
        for c in (body.left, body.right)
        if isinstance(c, UnresolvedShuffleExec)
    }
    if any(id(l) not in join_leaves for l in leaves):
        return []
    candidates = []
    if "left" in sides and isinstance(body.left, UnresolvedShuffleExec):
        candidates.append(body.left)
    if "right" in sides and isinstance(body.right, UnresolvedShuffleExec):
        candidates.append(body.right)
    return candidates


def _merge_partial_specs(
    final_agg: HashAggregateExec,
) -> Optional[List[AggSpec]]:
    """Specs for a PARTIAL-mode aggregate that MERGES partial states and
    re-emits the same state schema (sum of sums, sum of counts, min of
    mins...); None when any function has no such decomposition."""
    state_schema = final_agg.input.schema
    specs: List[AggSpec] = []
    idx = len(final_agg.group_exprs)
    for a in final_agg.aggs:
        if a.func not in _MERGEABLE_FUNCS:
            return None
        if a.func == "avg":
            for suffix in ("#sum", "#count"):
                name = f"{a.name}{suffix}"
                specs.append(
                    AggSpec(
                        "sum", Col(idx, name), name, state_schema.field(idx).type
                    )
                )
                idx += 1
            continue
        func = a.func if a.func in ("min", "max") else "sum"
        specs.append(
            AggSpec(func, Col(idx, a.name), a.name, state_schema.field(idx).type)
        )
        idx += 1
    return specs


def _find_agg_split(
    graph, stage, leaves
) -> Optional[Tuple[HashAggregateExec, List[ExecutionPlan], HashAggregateExec]]:
    """(final aggregate, deferred wrapper chain, merge-partial node) when
    skew-splitting the
    stage's final hash aggregate is safe: the aggregate sits under the
    shuffle writer (through row-wise wrappers only — they defer
    downstream with the merge) over the single leaf, every function
    re-merges from partial state, the stage has downstream consumers
    (all still Unresolved) to carry the injected final merge, and the
    rewritten merge reproduces the exact state schema.  A writer with
    its own hash partitioning qualifies only when it hashes pure
    group-key columns (their position is identical in the state schema)
    and no wrapper sits in between (the hash would otherwise evaluate
    over wrapper output that no longer exists in this stage)."""
    if len(leaves) != 1:
        return None
    chain: List[ExecutionPlan] = []
    node = stage.plan.input
    while isinstance(node, (FilterExec, ProjectionExec, RenameSchemaExec)):
        chain.append(node)
        node = node.children()[0]
    if not (isinstance(node, HashAggregateExec) and node.mode == FINAL):
        return None
    if node.input is not leaves[0]:
        return None
    part = stage.plan.shuffle_output_partitioning
    if part is not None:
        if chain or part.kind != "hash":
            return None
        n_groups = len(node.group_exprs)
        for e in part.exprs:
            if not (isinstance(e, Col) and e.index < n_groups):
                return None
    if stage.stage_id == graph.final_stage_id or not stage.output_links:
        return None  # job output has no downstream seat for the merge
    for csid in stage.output_links:
        if not isinstance(graph.stages.get(csid), UnresolvedStage):
            return None
    specs = _merge_partial_specs(node)
    if specs is None:
        return None
    merge = HashAggregateExec(PARTIAL, node.group_exprs, specs, node.input)
    if not merge.schema.equals(node.input.schema):
        return None  # rewrite would change the shuffle's wire schema
    return node, chain, merge


def _leaf_parents(
    plan: ExecutionPlan, sid: int
) -> List[Tuple[ExecutionPlan, UnresolvedShuffleExec]]:
    """Every (parent node, placeholder) pair reading stage ``sid``."""
    out: List[Tuple[ExecutionPlan, UnresolvedShuffleExec]] = []

    def rec(node: ExecutionPlan) -> None:
        for c in node.children():
            if isinstance(c, UnresolvedShuffleExec) and c.stage_id == sid:
                out.append((node, c))
            else:
                rec(c)

    rec(plan)
    return out


def _inject_consumer_merges(graph, stage, final_agg, chain) -> bool:
    """Move the original final merge (plus any deferred row-wise wrapper
    chain) into every consumer, above a state-schema placeholder.

    Group rows of a split stage are NOT disjoint across its output
    partitions any more (two chunk tasks may both emit partial rows for
    one group):

    * a hash-partitioned producer still sends one group to one reduce
      partition, so the merge sits directly above the placeholder;
    * a partitioning=None producer's outputs are task-indexed — the
      merge must see ALL partitions at once, so it sits above the
      consumer's CoalescePartitionsExec (the planner always reads such
      a boundary through one; any other shape disqualifies the split).

    All-or-nothing: every rewrite is schema-verified before any consumer
    plan is touched."""
    from ..exec.operators import CoalescePartitionsExec

    state_schema = final_agg.input.schema
    part_is_none = stage.plan.shuffle_output_partitioning is None
    rewrites = []
    for csid in stage.output_links:
        consumer = graph.stages[csid]
        pairs = _leaf_parents(consumer.plan, stage.stage_id)
        if not pairs:
            return False
        for parent, old in pairs:
            new_leaf = UnresolvedShuffleExec(
                stage.stage_id,
                state_schema,
                old.input_partition_count,
                old.output_partition_count,
                selections=old.selections,
            )
            if part_is_none:
                if not isinstance(parent, CoalescePartitionsExec):
                    return False
                replaced: ExecutionPlan = parent
                subtree: ExecutionPlan = HashAggregateExec(
                    FINAL,
                    final_agg.group_exprs,
                    final_agg.aggs,
                    CoalescePartitionsExec(new_leaf),
                )
            else:
                replaced = old
                subtree = HashAggregateExec(
                    FINAL, final_agg.group_exprs, final_agg.aggs, new_leaf
                )
            for wrapper in reversed(chain):
                subtree = wrapper.with_new_children([subtree])
            if not subtree.schema.equals(replaced.schema):
                return False  # consumer expects a different row shape
            rewrites.append((consumer, replaced, subtree))
    # one rebuild per consumer: a consumer reading the split stage
    # through several parents must swap them all in a single pass
    grouped: Dict[int, Tuple[UnresolvedStage, Dict[int, ExecutionPlan]]] = {}
    for consumer, replaced, subtree in rewrites:
        grouped.setdefault(id(consumer), (consumer, {}))[1][
            id(replaced)
        ] = subtree
    for consumer, mapping in grouped.values():
        consumer.plan = _replace_nodes(consumer.plan, mapping)
    return True


# ------------------------------------------------------------ replan core
def replan_stage(graph, stage: UnresolvedStage) -> None:
    """Coalesce/skew-split rewrite of one about-to-resolve consumer stage
    (see module docstring).  Mutates ``stage`` (and, for an aggregate
    split, its consumers) in place; a no-op when nothing pays."""
    policy: AqePolicy = graph.aqe_policy
    if not policy.enabled or stage.aqe:
        return
    leaves = find_unresolved_shuffles(stage.plan)
    if not leaves or any(l.selections is not None for l in leaves):
        return  # already rewritten (rollback re-resolve) or nothing to do
    producers: Dict[int, CompletedStage] = {}
    for l in leaves:
        prod = graph.stages.get(l.stage_id)
        if not isinstance(prod, CompletedStage):
            return  # stats incomplete (mid-recovery resolve): stay static
        producers[l.stage_id] = prod
    counts = {l.output_partition_count for l in leaves}
    if len(counts) != 1:
        return  # differently-shaped inputs cannot share one task layout
    n = counts.pop()
    if n <= 1 or stage.plan.output_partitioning().n != n:
        return  # task count is not driven by the shuffle (e.g. coalesced)

    # one O(tasks x partitions) scan per producer, reused by every
    # consumer of the maps below (skew targeting included)
    bytes_by_sid = {
        sid: prod.output_partition_bytes() for sid, prod in producers.items()
    }
    leaf_bytes = [bytes_by_sid[l.stage_id] for l in leaves]
    total = {p: sum(b.get(p, 0) for b in leaf_bytes) for p in range(n)}

    # ---- skew candidates + structural target
    split_k: Dict[int, int] = {}
    split_leaf: Optional[UnresolvedShuffleExec] = None
    agg_target: Optional[
        Tuple[HashAggregateExec, List[ExecutionPlan], HashAggregateExec]
    ] = None
    if policy.skew_enabled:
        med = statistics.median([total[p] for p in range(n)])
        threshold = max(
            policy.skew_factor * med, float(policy.target_partition_bytes)
        )
        skewed = [p for p in range(n) if total[p] > threshold]
        if skewed:
            agg_target = _find_agg_split(graph, stage, leaves)
            if agg_target is not None:
                split_leaf = leaves[0]
            else:
                # split the heaviest qualifying join side at the skewed
                # partitions; the companion side duplicates into chunks
                candidates = _join_split_candidates(stage.plan, leaves)
                if candidates:
                    split_leaf = max(
                        candidates,
                        key=lambda l: sum(
                            bytes_by_sid[l.stage_id].get(p, 0) for p in skewed
                        ),
                    )
            if split_leaf is not None:
                side_bytes = bytes_by_sid[split_leaf.stage_id]
                # re-run the skew test against the SPLIT side's own
                # distribution: a partition whose weight sits on a
                # non-splittable companion side must stay whole — each
                # chunk task would re-read the heavy companion in full,
                # k-multiplying exactly the work the split meant to cut
                side_med = statistics.median(
                    [side_bytes.get(p, 0) for p in range(n)]
                )
                side_threshold = max(
                    policy.skew_factor * side_med,
                    float(policy.target_partition_bytes),
                )
                inp = stage.inputs.get(split_leaf.stage_id)
                for p in skewed:
                    if side_bytes.get(p, 0) <= side_threshold:
                        continue
                    frags = (
                        len(inp.partition_locations.get(p, []))
                        if inp is not None
                        else 0
                    )
                    k = min(
                        policy.max_splits,
                        frags,
                        max(
                            2,
                            math.ceil(
                                side_bytes.get(p, 0)
                                / max(1, policy.target_partition_bytes)
                            ),
                        ),
                    )
                    if k >= 2:
                        split_k[p] = k

    # ---- build the unified task layout (coalesce bins around splits)
    coalesce_on = (
        policy.coalesce_enabled and n > policy.coalesce_min_partitions
    )
    if not coalesce_on and not split_k:
        return

    def build_layout() -> Tuple[
        List[List[List[Tuple[int, int, int]]]], int, int, int
    ]:
        selections: List[List[List[Tuple[int, int, int]]]] = [
            [] for _ in leaves
        ]
        tasks_after = 0
        merged_groups = 0
        split_tasks = 0
        group: List[int] = []
        group_bytes = 0

        def flush_group() -> None:
            nonlocal tasks_after, merged_groups, group, group_bytes
            if not group:
                return
            row = [(p, 0, 1) for p in group]
            for sel in selections:
                sel.append(list(row))
            tasks_after += 1
            if len(group) > 1:
                merged_groups += 1
            group, group_bytes = [], 0

        for p in range(n):
            k = split_k.get(p)
            if k:
                flush_group()
                for i in range(k):
                    for sel, l in zip(selections, leaves):
                        sel.append(
                            [(p, i, k)] if l is split_leaf else [(p, 0, 1)]
                        )
                    tasks_after += 1
                    split_tasks += 1
                continue
            if (
                group
                and group_bytes + total[p] > policy.target_partition_bytes
            ):
                flush_group()
            group.append(p)
            group_bytes += total[p]
            if not coalesce_on:
                flush_group()
        flush_group()
        return selections, tasks_after, merged_groups, split_tasks

    selections, tasks_after, merged_groups, split_tasks = build_layout()
    if tasks_after == n and not split_tasks:
        return  # the static layout was already right-sized

    # ---- commit: consumer-merge injection first (all-or-nothing), then
    # the in-place leaf/selection + plan rewrites
    if split_tasks and agg_target is not None:
        final_agg, chain, merge = agg_target
        if _inject_consumer_merges(graph, stage, final_agg, chain):
            stage.plan = stage.plan.with_new_children([merge])
        else:
            # downstream seat unavailable: drop the split but keep the
            # independently valid coalesce-only layout (needs no merge)
            split_k.clear()
            if not coalesce_on:
                return
            selections, tasks_after, merged_groups, split_tasks = (
                build_layout()
            )
            if tasks_after == n and not split_tasks:
                return  # coalescing alone changes nothing: stay static
    for sel, l in zip(selections, leaves):
        l.selections = sel
    if (
        stage.plan.shuffle_output_partitioning is None
        and tasks_after != n
    ):
        # a partitioning=None stage's output-partition ids ARE its task
        # indices: consumers' placeholders must track the new task
        # count, or a split's extra output partitions would silently
        # fall outside their location range
        for csid in stage.output_links:
            consumer = graph.stages.get(csid)
            if isinstance(consumer, UnresolvedStage):
                for l in find_unresolved_shuffles(consumer.plan):
                    if l.stage_id == stage.stage_id:
                        l.output_partition_count = tasks_after
                        l.input_partition_count = tasks_after
    stage.aqe = {
        "tasks_before": n,
        "tasks_after": tasks_after,
        "coalesced_groups": merged_groups,
        "skew_splits": split_tasks,
        "skewed_partitions": len(split_k),
    }
    if stage.stage_id == graph.final_stage_id:
        graph.output_partitions = stage.plan.output_partitioning().n
    kinds = []
    if merged_groups or tasks_after < n:
        kinds.append("coalesce")
    if split_tasks:
        kinds.append("skew_split")
    graph._journal(
        "aqe_replan",
        stage=stage.stage_id,
        rewrite="+".join(kinds) or "coalesce",
        tasks_before=n,
        tasks_after=tasks_after,
        skewed_partitions=sorted(split_k),
        reason=(
            f"observed {sum(total.values())} B over {n} reduce partitions; "
            f"target {policy.target_partition_bytes} B/task"
            + (
                f"; split {len(split_k)} skewed partition(s) "
                f"(> {policy.skew_factor:g}x median)"
                if split_k
                else ""
            )
        ),
    )


# ------------------------------------------------------- broadcast rewrite
def _find_broadcast_join(
    plan_root, build_sid: int
) -> Optional[Tuple[HashJoinExec, UnresolvedShuffleExec]]:
    """(join, probe leaf) when the stage body is a partitioned inner
    join whose LEFT input reads ``build_sid`` and whose RIGHT input is a
    different stage's placeholder.  COLLECT_LEFT collects the left side,
    so only a small LEFT qualifies (swapping sides would permute the
    output schema)."""
    body = _body_below_wrappers(plan_root.input)
    if not isinstance(body, HashJoinExec):
        return None
    if body.partition_mode != PARTITIONED or body.join_type != "inner":
        return None
    left, right = body.left, body.right
    if not (
        isinstance(left, UnresolvedShuffleExec)
        and left.stage_id == build_sid
        and isinstance(right, UnresolvedShuffleExec)
        and right.stage_id != build_sid
    ):
        return None
    return body, right


def _probe_unstarted(stage) -> bool:
    """True while stripping the probe-side shuffle forfeits no work: the
    stage has dispatched nothing (a Running stage counts only before its
    first task is handed out — every graph mutation runs under the job
    entry lock, so this cannot race a pop)."""
    if isinstance(stage, (UnresolvedStage, ResolvedStage)):
        return True
    if isinstance(stage, RunningStage):
        return (
            all(t is None for t in stage.task_statuses)
            and not stage.speculative_statuses
            and not stage.task_attempts
        )
    return False


def try_broadcast(graph, completed_sid: int) -> None:
    """Shuffle→broadcast join conversion on ``completed_sid``'s
    consumers (see module docstring).  The probe-side producer stage is
    DELETED from the DAG: its subtree is inlined into the consumer, its
    inputs (with any already-accumulated locations) move to the
    consumer, and its own producers' output links re-point there."""
    policy: AqePolicy = graph.aqe_policy
    if not (policy.enabled and policy.broadcast_enabled):
        return
    completed = graph.stages.get(completed_sid)
    if not isinstance(completed, CompletedStage):
        return
    build_bytes = sum(completed.output_partition_bytes().values())
    if build_bytes >= policy.broadcast_threshold_bytes:
        return
    for csid in list(completed.output_links):
        consumer = graph.stages.get(csid)
        if not isinstance(consumer, UnresolvedStage) or consumer.aqe:
            continue
        found = _find_broadcast_join(consumer.plan, completed_sid)
        if found is None:
            continue
        join, probe_leaf = found
        rsid = probe_leaf.stage_id
        probe = graph.stages.get(rsid)
        if probe is None or probe.output_links != [csid]:
            continue  # another consumer still needs the probe shuffle
        if not _probe_unstarted(probe):
            continue  # probe work already paid for: nothing to save
        # a Resolved probe already materialized its readers' locations;
        # roll them back to placeholders (selections preserved) so the
        # consumer — which stays Unresolved, outside reset_stages' reach —
        # re-resolves against live locations after any executor loss
        probe_body = rollback_resolved_shuffles(probe.plan.input)
        from ..parallel.mesh_stage import MeshGangExec, MeshRepartitionExec

        if isinstance(probe_body, (MeshGangExec, MeshRepartitionExec)):
            continue  # gang bodies assume the writer's exchange contract
        tasks_before = consumer.partitions
        new_join = join.as_collect_left(right=probe_body)
        consumer.plan = _replace_node(consumer.plan, join, new_join)
        # DAG surgery: the consumer inherits the probe stage's inputs
        # (accumulated locations included) and its producers' links
        consumer.inputs.pop(rsid, None)
        for in_sid, inp in probe.inputs.items():
            consumer.inputs.setdefault(in_sid, inp)
            upstream = graph.stages.get(in_sid)
            if upstream is not None:
                links = [csid if x == rsid else x for x in upstream.output_links]
                seen: set = set()
                upstream.output_links[:] = [
                    x for x in links if not (x in seen or seen.add(x))
                ]
        del graph.stages[rsid]
        consumer.aqe = {
            "tasks_before": tasks_before,
            "tasks_after": consumer.partitions,
            "broadcast": 1,
        }
        if (
            consumer.plan.shuffle_output_partitioning is None
            and consumer.partitions != tasks_before
        ):
            # same fix-up as replan_stage: a partitioning=None stage's
            # output-partition ids ARE its task indices, and inlining the
            # probe subtree changed the task count — downstream
            # placeholders must track it or the extra partitions' rows
            # silently fall outside their location range
            for out_sid in consumer.output_links:
                downstream = graph.stages.get(out_sid)
                if isinstance(downstream, UnresolvedStage):
                    for l in find_unresolved_shuffles(downstream.plan):
                        if l.stage_id == csid:
                            l.output_partition_count = consumer.partitions
                            l.input_partition_count = consumer.partitions
        if csid == graph.final_stage_id:
            graph.output_partitions = consumer.partitions
        graph._journal(
            "aqe_replan",
            stage=csid,
            rewrite="broadcast",
            tasks_before=tasks_before,
            tasks_after=consumer.partitions,
            stripped_stage=rsid,
            reason=(
                f"build side (stage {completed_sid}) measured "
                f"{build_bytes} B < "
                f"{policy.broadcast_threshold_bytes} B; probe shuffle "
                f"stage {rsid} stripped and its subtree inlined"
            ),
        )
