"""Physical plan ⇄ protobuf conversion.

Counterpart of the reference's ``core/src/serde/physical_plan/mod.rs``
(operator encode/decode; roundtrip-tested the same way).  Stage plans
travel scheduler → executor inside ``TaskDefinition.plan``.

``ShuffleWriterExec.work_dir`` deliberately does NOT travel on the wire:
the receiving executor rebuilds the writer against its local work dir,
exactly like the reference (``executor/src/executor.rs:137-161``).
"""

from __future__ import annotations

import json
from typing import Optional

from ..catalog import provider_from_description
from ..errors import PlanError
from ..exec import aggregates as agg
from ..exec import joins as jn
from ..exec.operators import (
    CoalescePartitionsExec,
    EmptyExec,
    ExecutionPlan,
    FilterExec,
    LimitExec,
    Partitioning,
    ProjectionExec,
    RepartitionExec,
    ScanExec,
    SortExec,
    UnionExec,
)
from ..exec.planner import RenameSchemaExec
from ..exec.window import WindowExec, WindowSpec
from ..proto import pb
from ..shuffle import ShuffleReaderExec, ShuffleWriterExec, UnresolvedShuffleExec
from .arrow_utils import (
    dtype_from_bytes,
    dtype_to_bytes,
    schema_from_bytes,
    schema_to_bytes,
)
from .expressions import (
    _frame_from_proto,
    _frame_to_proto,
    physical_expr_from_proto,
    physical_expr_to_proto,
)
from .scheduler_types import PartitionLocation


def _selections_from_json(raw: str):
    """AQE read-selection triples from their JSON wire form ('' = none)."""
    if not raw:
        return None
    return [[tuple(t) for t in task] for task in json.loads(raw)]


def partitioning_to_proto(p: Partitioning) -> pb.PhysicalPartitioning:
    msg = pb.PhysicalPartitioning(kind=p.kind, partition_count=p.n)
    for e in p.exprs:
        msg.exprs.add().CopyFrom(physical_expr_to_proto(e))
    return msg


def partitioning_from_proto(msg: pb.PhysicalPartitioning) -> Partitioning:
    exprs = tuple(physical_expr_from_proto(e) for e in msg.exprs)
    return Partitioning(msg.kind, msg.partition_count, exprs)


def physical_plan_to_proto(plan: ExecutionPlan) -> pb.PhysicalPlanNode:
    from ..ops.stage_compiler import TorchStageExec
    from ..ops.window_compiler import TorchWindowExec

    if isinstance(plan, (TorchStageExec, TorchWindowExec)):
        # accelerated stages travel as their unaccelerated operator
        # subtree; the receiving executor re-applies maybe_accelerate
        # under its own session config (acceleration is a local
        # physical-optimizer rule, mirroring the reference's
        # PhysicalExtensionCodec plugin hook)
        return physical_plan_to_proto(plan.original)

    n = pb.PhysicalPlanNode()
    if isinstance(plan, ScanExec):
        n.scan.table_name = plan.table_name
        n.scan.provider.json = json.dumps(plan.provider.describe())
        if plan.projection is not None:
            n.scan.projection.extend(plan.projection)
            n.scan.has_projection = True
        return n
    if isinstance(plan, FilterExec):
        n.filter.predicate.CopyFrom(physical_expr_to_proto(plan.predicate))
        n.filter.input.CopyFrom(physical_plan_to_proto(plan.input))
        return n
    if isinstance(plan, ProjectionExec):
        for e, name in plan.exprs:
            ne = n.projection.exprs.add()
            ne.expr.CopyFrom(physical_expr_to_proto(e))
            ne.name = name
        n.projection.input.CopyFrom(physical_plan_to_proto(plan.input))
        return n
    if isinstance(plan, agg.HashAggregateExec):
        n.aggregate.mode = plan.mode
        for e, name in plan.group_exprs:
            ne = n.aggregate.group_exprs.add()
            ne.expr.CopyFrom(physical_expr_to_proto(e))
            ne.name = name
        for spec in plan.aggs:
            sp = n.aggregate.aggs.add()
            sp.func = spec.func
            if spec.arg is not None:
                sp.arg.CopyFrom(physical_expr_to_proto(spec.arg))
                sp.has_arg = True
            if spec.arg2 is not None:
                sp.arg2.CopyFrom(physical_expr_to_proto(spec.arg2))
                sp.has_arg2 = True
            sp.name = spec.name
            sp.out_type = dtype_to_bytes(spec.out_type)
        n.aggregate.input.CopyFrom(physical_plan_to_proto(plan.input))
        return n
    if isinstance(plan, jn.HashJoinExec):
        n.join.left.CopyFrom(physical_plan_to_proto(plan.left))
        n.join.right.CopyFrom(physical_plan_to_proto(plan.right))
        for l, r in plan.on:
            pair = n.join.on.add()
            pair.left.CopyFrom(physical_expr_to_proto(l))
            pair.right.CopyFrom(physical_expr_to_proto(r))
        n.join.join_type = plan.join_type
        n.join.partition_mode = plan.partition_mode
        if plan.filter is not None:
            n.join.filter.CopyFrom(physical_expr_to_proto(plan.filter))
            n.join.has_filter = True
        return n
    if isinstance(plan, jn.CrossJoinExec):
        n.cross_join.left.CopyFrom(physical_plan_to_proto(plan.left))
        n.cross_join.right.CopyFrom(physical_plan_to_proto(plan.right))
        return n
    if isinstance(plan, SortExec):
        for e, asc, nf in plan.sort_keys:
            k = n.sort.keys.add()
            k.expr.CopyFrom(physical_expr_to_proto(e))
            k.asc = asc
            k.nulls_first = 0 if nf is None else (1 if nf else 2)
        n.sort.input.CopyFrom(physical_plan_to_proto(plan.input))
        n.sort.fetch = -1 if plan.fetch is None else plan.fetch
        return n
    if isinstance(plan, WindowExec):
        for s in plan.specs:
            sp = n.window.specs.add()
            sp.func = s.func
            if s.arg is not None:
                sp.arg.CopyFrom(physical_expr_to_proto(s.arg))
                sp.has_arg = True
            for p in s.partition_by:
                sp.partition_by.add().CopyFrom(physical_expr_to_proto(p))
            for e, asc, nf in s.order_by:
                k = sp.order_by.add()
                k.expr.CopyFrom(physical_expr_to_proto(e))
                k.asc = asc
                k.nulls_first = 0 if nf is None else (1 if nf else 2)
            sp.name = s.name
            sp.out_type = dtype_to_bytes(s.out_type)
            sp.offset = s.offset
            if s.frame is not None:
                _frame_to_proto(s.frame, sp.frame)
        n.window.input.CopyFrom(physical_plan_to_proto(plan.input))
        return n
    if isinstance(plan, LimitExec):
        n.limit.input.CopyFrom(physical_plan_to_proto(plan.input))
        n.limit.skip = plan.skip
        n.limit.fetch = -1 if plan.fetch is None else plan.fetch
        return n
    if isinstance(plan, UnionExec):
        for i in plan.inputs:
            n.union_all.inputs.add().CopyFrom(physical_plan_to_proto(i))
        return n
    if isinstance(plan, RepartitionExec):
        n.repartition.input.CopyFrom(physical_plan_to_proto(plan.input))
        n.repartition.partitioning.CopyFrom(partitioning_to_proto(plan.partitioning))
        return n
    if isinstance(plan, CoalescePartitionsExec):
        n.coalesce.input.CopyFrom(physical_plan_to_proto(plan.input))
        return n
    if isinstance(plan, RenameSchemaExec):
        n.rename.input.CopyFrom(physical_plan_to_proto(plan.input))
        n.rename.schema = schema_to_bytes(plan.schema)
        return n
    if isinstance(plan, EmptyExec):
        n.empty.produce_one_row = plan.produce_one_row
        n.empty.schema = schema_to_bytes(plan.schema)
        return n
    if isinstance(plan, ShuffleWriterExec):
        n.shuffle_writer.job_id = plan.job_id
        n.shuffle_writer.stage_id = plan.stage_id
        n.shuffle_writer.input.CopyFrom(physical_plan_to_proto(plan.input))
        if plan.shuffle_output_partitioning is not None:
            n.shuffle_writer.output_partitioning.CopyFrom(
                partitioning_to_proto(plan.shuffle_output_partitioning)
            )
            n.shuffle_writer.has_output_partitioning = True
        return n
    if isinstance(plan, ShuffleReaderExec):
        n.shuffle_reader.stage_id = plan.stage_id
        n.shuffle_reader.schema = schema_to_bytes(plan.schema)
        for locs in plan.partition:
            ll = n.shuffle_reader.partition.add()
            for loc in locs:
                ll.locations.add().CopyFrom(loc.to_proto())
        # AQE provenance: lets executor-loss rollback rebuild the
        # REWRITTEN placeholder after a scheduler restart too
        if plan.selections is not None:
            n.shuffle_reader.selections_json = json.dumps(plan.selections)
        if plan.source_partition_count:
            n.shuffle_reader.source_partition_count = plan.source_partition_count
        if plan.tail:
            # pipelined execution: the executor tails the scheduler's
            # shuffle-location feed instead of reading static locations
            n.shuffle_reader.tail = True
        return n
    if isinstance(plan, UnresolvedShuffleExec):
        n.unresolved_shuffle.stage_id = plan.stage_id
        n.unresolved_shuffle.schema = schema_to_bytes(plan.schema)
        n.unresolved_shuffle.input_partition_count = plan.input_partition_count
        n.unresolved_shuffle.output_partition_count = plan.output_partition_count
        if plan.selections is not None:
            n.unresolved_shuffle.selections_json = json.dumps(plan.selections)
        return n
    from ..parallel.mesh_stage import MeshGangExec, MeshRepartitionExec

    if isinstance(plan, MeshRepartitionExec):
        n.mesh_repartition.input.CopyFrom(physical_plan_to_proto(plan.input))
        n.mesh_repartition.partitioning.CopyFrom(
            partitioning_to_proto(plan.partitioning)
        )
        n.mesh_repartition.n_devices = plan.n_devices
        return n

    if isinstance(plan, MeshGangExec):
        n.mesh_gang.input.CopyFrom(physical_plan_to_proto(plan.input))
        n.mesh_gang.n_devices = plan.n_devices
        return n
    raise PlanError(f"cannot serialize physical plan {type(plan).__name__}")


def physical_plan_from_proto(
    n: pb.PhysicalPlanNode, work_dir: str = "/tmp/ballista-tpu"
) -> ExecutionPlan:
    def rec(m: pb.PhysicalPlanNode) -> ExecutionPlan:
        return physical_plan_from_proto(m, work_dir)

    kind = n.WhichOneof("plan")
    if kind == "scan":
        provider = provider_from_description(json.loads(n.scan.provider.json))
        projection = list(n.scan.projection) if n.scan.has_projection else None
        return ScanExec(n.scan.table_name, provider, projection)
    if kind == "filter":
        return FilterExec(
            physical_expr_from_proto(n.filter.predicate), rec(n.filter.input)
        )
    if kind == "projection":
        exprs = [
            (physical_expr_from_proto(e.expr), e.name) for e in n.projection.exprs
        ]
        return ProjectionExec(exprs, rec(n.projection.input))
    if kind == "aggregate":
        groups = [
            (physical_expr_from_proto(e.expr), e.name)
            for e in n.aggregate.group_exprs
        ]
        specs = [
            agg.AggSpec(
                sp.func,
                physical_expr_from_proto(sp.arg) if sp.has_arg else None,
                sp.name,
                dtype_from_bytes(sp.out_type),
                arg2=(
                    physical_expr_from_proto(sp.arg2) if sp.has_arg2 else None
                ),
            )
            for sp in n.aggregate.aggs
        ]
        return agg.HashAggregateExec(
            n.aggregate.mode, groups, specs, rec(n.aggregate.input)
        )
    if kind == "join":
        on = [
            (physical_expr_from_proto(p.left), physical_expr_from_proto(p.right))
            for p in n.join.on
        ]
        jfilter = (
            physical_expr_from_proto(n.join.filter) if n.join.has_filter else None
        )
        return jn.HashJoinExec(
            rec(n.join.left),
            rec(n.join.right),
            on,
            n.join.join_type,
            n.join.partition_mode,
            jfilter,
        )
    if kind == "cross_join":
        return jn.CrossJoinExec(rec(n.cross_join.left), rec(n.cross_join.right))
    if kind == "sort":
        keys = [
            (
                physical_expr_from_proto(k.expr),
                k.asc,
                None if k.nulls_first == 0 else k.nulls_first == 1,
            )
            for k in n.sort.keys
        ]
        return SortExec(
            keys, rec(n.sort.input), None if n.sort.fetch < 0 else n.sort.fetch
        )
    if kind == "window":
        specs = [
            WindowSpec(
                sp.func,
                physical_expr_from_proto(sp.arg) if sp.has_arg else None,
                tuple(
                    physical_expr_from_proto(p) for p in sp.partition_by
                ),
                tuple(
                    (
                        physical_expr_from_proto(k.expr),
                        k.asc,
                        None if k.nulls_first == 0 else k.nulls_first == 1,
                    )
                    for k in sp.order_by
                ),
                sp.name,
                dtype_from_bytes(sp.out_type),
                sp.offset,
                _frame_from_proto(sp.frame)
                if sp.HasField("frame")
                else None,
            )
            for sp in n.window.specs
        ]
        return WindowExec(rec(n.window.input), specs)
    if kind == "limit":
        return LimitExec(
            rec(n.limit.input),
            n.limit.skip,
            None if n.limit.fetch < 0 else n.limit.fetch,
        )
    if kind == "union_all":
        return UnionExec([rec(i) for i in n.union_all.inputs])
    if kind == "repartition":
        return RepartitionExec(
            rec(n.repartition.input),
            partitioning_from_proto(n.repartition.partitioning),
        )
    if kind == "coalesce":
        return CoalescePartitionsExec(rec(n.coalesce.input))
    if kind == "rename":
        return RenameSchemaExec(rec(n.rename.input), schema_from_bytes(n.rename.schema))
    if kind == "empty":
        return EmptyExec(n.empty.produce_one_row, schema_from_bytes(n.empty.schema))
    if kind == "shuffle_writer":
        part: Optional[Partitioning] = None
        if n.shuffle_writer.has_output_partitioning:
            part = partitioning_from_proto(n.shuffle_writer.output_partitioning)
        return ShuffleWriterExec(
            n.shuffle_writer.job_id,
            n.shuffle_writer.stage_id,
            rec(n.shuffle_writer.input),
            work_dir,
            part,
        )
    if kind == "shuffle_reader":
        partition = [
            [PartitionLocation.from_proto(loc) for loc in ll.locations]
            for ll in n.shuffle_reader.partition
        ]
        return ShuffleReaderExec(
            n.shuffle_reader.stage_id,
            schema_from_bytes(n.shuffle_reader.schema),
            partition,
            selections=_selections_from_json(n.shuffle_reader.selections_json),
            source_partition_count=(
                n.shuffle_reader.source_partition_count or None
            ),
            tail=bool(n.shuffle_reader.tail),
        )
    if kind == "unresolved_shuffle":
        return UnresolvedShuffleExec(
            n.unresolved_shuffle.stage_id,
            schema_from_bytes(n.unresolved_shuffle.schema),
            n.unresolved_shuffle.input_partition_count,
            n.unresolved_shuffle.output_partition_count,
            selections=_selections_from_json(
                n.unresolved_shuffle.selections_json
            ),
        )
    if kind == "mesh_gang":
        from ..parallel.mesh_stage import MeshGangExec

        return MeshGangExec(rec(n.mesh_gang.input), n.mesh_gang.n_devices)
    if kind == "mesh_repartition":
        from ..parallel.mesh_stage import MeshRepartitionExec

        return MeshRepartitionExec(
            rec(n.mesh_repartition.input),
            partitioning_from_proto(n.mesh_repartition.partitioning),
            n.mesh_repartition.n_devices,
        )
    raise PlanError(f"cannot deserialize physical plan node {kind!r}")
