"""Logical plan ⇄ protobuf conversion.

Counterpart of the reference's vendored DataFusion logical plan serde
(``core/proto/datafusion.proto`` + its from/to_proto code).  This is what
travels client → scheduler in ``ExecuteQuery``.
"""

from __future__ import annotations

import json

import pyarrow as pa

from ..catalog import provider_from_description
from ..errors import PlanError
from ..plan import logical as lp
from ..proto import pb
from .arrow_utils import (
    schema_from_bytes,
    schema_to_bytes,
    table_from_ipc,
    table_to_ipc,
)
from .expressions import logical_expr_from_proto, logical_expr_to_proto


def logical_plan_to_proto(plan: lp.LogicalPlan) -> pb.LogicalPlanNode:
    n = pb.LogicalPlanNode()
    if isinstance(plan, lp.TableScan):
        n.table_scan.table_name = plan.table_name
        n.table_scan.provider.json = json.dumps(plan.provider.describe())
        if plan.projection is not None:
            n.table_scan.projection.extend(plan.projection)
            n.table_scan.has_projection = True
        for f in plan.filters:
            n.table_scan.filters.add().CopyFrom(logical_expr_to_proto(f))
        return n
    if isinstance(plan, lp.SubqueryAlias):
        n.subquery_alias.input.CopyFrom(logical_plan_to_proto(plan.input))
        n.subquery_alias.alias = plan.alias
        return n
    if isinstance(plan, lp.Projection):
        for e in plan.exprs:
            n.projection.exprs.add().CopyFrom(logical_expr_to_proto(e))
        n.projection.input.CopyFrom(logical_plan_to_proto(plan.input))
        return n
    if isinstance(plan, lp.Filter):
        n.filter.predicate.CopyFrom(logical_expr_to_proto(plan.predicate))
        n.filter.input.CopyFrom(logical_plan_to_proto(plan.input))
        return n
    if isinstance(plan, lp.Aggregate):
        for g in plan.group_exprs:
            n.aggregate.group_exprs.add().CopyFrom(logical_expr_to_proto(g))
        for a in plan.agg_exprs:
            n.aggregate.agg_exprs.add().CopyFrom(logical_expr_to_proto(a))
        n.aggregate.input.CopyFrom(logical_plan_to_proto(plan.input))
        return n
    if isinstance(plan, lp.Sort):
        for s in plan.sort_exprs:
            n.sort.sort_exprs.add().CopyFrom(logical_expr_to_proto(s))
        n.sort.input.CopyFrom(logical_plan_to_proto(plan.input))
        n.sort.fetch = -1 if plan.fetch is None else plan.fetch
        return n
    if isinstance(plan, lp.Limit):
        n.limit.input.CopyFrom(logical_plan_to_proto(plan.input))
        n.limit.skip = plan.skip
        n.limit.fetch = -1 if plan.fetch is None else plan.fetch
        return n
    if isinstance(plan, lp.Join):
        n.join.left.CopyFrom(logical_plan_to_proto(plan.left))
        n.join.right.CopyFrom(logical_plan_to_proto(plan.right))
        for l, r in plan.on:
            pair = n.join.on.add()
            pair.left.CopyFrom(logical_expr_to_proto(l))
            pair.right.CopyFrom(logical_expr_to_proto(r))
        n.join.join_type = plan.join_type
        if plan.filter is not None:
            n.join.filter.CopyFrom(logical_expr_to_proto(plan.filter))
            n.join.has_filter = True
        return n
    if isinstance(plan, lp.CrossJoin):
        n.cross_join.left.CopyFrom(logical_plan_to_proto(plan.left))
        n.cross_join.right.CopyFrom(logical_plan_to_proto(plan.right))
        return n
    if isinstance(plan, lp.Union):
        for i in plan.inputs:
            n.union_all.inputs.add().CopyFrom(logical_plan_to_proto(i))
        return n
    if isinstance(plan, lp.Distinct):
        n.distinct.input.CopyFrom(logical_plan_to_proto(plan.input))
        return n
    if isinstance(plan, lp.Window):
        for w in plan.window_exprs:
            n.window.window_exprs.add().CopyFrom(logical_expr_to_proto(w))
        n.window.input.CopyFrom(logical_plan_to_proto(plan.input))
        return n
    if isinstance(plan, lp.EmptyRelation):
        n.empty.produce_one_row = plan.produce_one_row
        n.empty.schema = schema_to_bytes(plan.schema_)
        return n
    if isinstance(plan, lp.Values):
        arrays = []
        for i, f in enumerate(plan.schema_):
            arrays.append(pa.array([r[i] for r in plan.rows], f.type))
        tbl = pa.Table.from_arrays(arrays, schema=plan.schema_)
        n.values.ipc_data = table_to_ipc(tbl)
        return n
    raise PlanError(f"cannot serialize logical plan {type(plan).__name__}")


def logical_plan_from_proto(n: pb.LogicalPlanNode) -> lp.LogicalPlan:
    kind = n.WhichOneof("plan")
    if kind == "table_scan":
        provider = provider_from_description(json.loads(n.table_scan.provider.json))
        projection = (
            list(n.table_scan.projection) if n.table_scan.has_projection else None
        )
        filters = [logical_expr_from_proto(f) for f in n.table_scan.filters]
        return lp.TableScan(n.table_scan.table_name, provider, projection, filters)
    if kind == "subquery_alias":
        return lp.SubqueryAlias(
            logical_plan_from_proto(n.subquery_alias.input), n.subquery_alias.alias
        )
    if kind == "projection":
        return lp.Projection(
            [logical_expr_from_proto(e) for e in n.projection.exprs],
            logical_plan_from_proto(n.projection.input),
        )
    if kind == "filter":
        return lp.Filter(
            logical_expr_from_proto(n.filter.predicate),
            logical_plan_from_proto(n.filter.input),
        )
    if kind == "aggregate":
        return lp.Aggregate(
            [logical_expr_from_proto(g) for g in n.aggregate.group_exprs],
            [logical_expr_from_proto(a) for a in n.aggregate.agg_exprs],
            logical_plan_from_proto(n.aggregate.input),
        )
    if kind == "sort":
        return lp.Sort(
            [logical_expr_from_proto(s) for s in n.sort.sort_exprs],
            logical_plan_from_proto(n.sort.input),
            None if n.sort.fetch < 0 else n.sort.fetch,
        )
    if kind == "limit":
        return lp.Limit(
            logical_plan_from_proto(n.limit.input),
            n.limit.skip,
            None if n.limit.fetch < 0 else n.limit.fetch,
        )
    if kind == "join":
        on = [
            (logical_expr_from_proto(p.left), logical_expr_from_proto(p.right))
            for p in n.join.on
        ]
        jfilter = logical_expr_from_proto(n.join.filter) if n.join.has_filter else None
        return lp.Join(
            logical_plan_from_proto(n.join.left),
            logical_plan_from_proto(n.join.right),
            on,
            n.join.join_type,
            jfilter,
        )
    if kind == "cross_join":
        return lp.CrossJoin(
            logical_plan_from_proto(n.cross_join.left),
            logical_plan_from_proto(n.cross_join.right),
        )
    if kind == "union_all":
        return lp.Union([logical_plan_from_proto(i) for i in n.union_all.inputs])
    if kind == "distinct":
        return lp.Distinct(logical_plan_from_proto(n.distinct.input))
    if kind == "window":
        return lp.Window(
            [logical_expr_from_proto(w) for w in n.window.window_exprs],
            logical_plan_from_proto(n.window.input),
        )
    if kind == "empty":
        return lp.EmptyRelation(
            n.empty.produce_one_row, schema_from_bytes(n.empty.schema)
        )
    if kind == "values":
        tbl = table_from_ipc(n.values.ipc_data)
        rows = [list(r.values()) for r in tbl.to_pylist()]
        return lp.Values(rows, tbl.schema)
    raise PlanError(f"cannot deserialize logical plan node {kind!r}")
