"""Logical → physical planning.

Counterpart of DataFusion's DefaultPhysicalPlanner as driven by the
reference's session context (``state/session_manager.rs:112-125`` maps
session settings into planner behavior).  Key structural choices mirrored
from the reference so the distributed planner can split stages the same way
(``scheduler/src/planner.rs:81-170``):

* aggregates are planned Partial → RepartitionExec(hash keys) → Final
* joins are planned Partitioned (repartition both sides) or CollectLeft
* sorts/limits sit above an explicit CoalescePartitionsExec

Shuffle boundaries are therefore exactly the RepartitionExec /
CoalescePartitionsExec nodes.
"""

from __future__ import annotations

from typing import Optional

import pyarrow as pa

from ..config import BallistaConfig
from ..errors import NotImplementedYet, PlanError
from ..plan import expressions as lex
from ..plan import logical as lp
from . import aggregates as agg
from . import joins as jn
from .expressions import Col, PhysicalExpr, create_physical_expr
from .operators import (
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
    TaskContext,
    UnionExec,
    collect,
)


class RenameSchemaExec(ExecutionPlan):
    """Pass-through that re-qualifies field names (SubqueryAlias)."""

    def __init__(self, input: ExecutionPlan, schema: pa.Schema):
        super().__init__()
        self.input = input
        self._schema = schema

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return self.input.output_partitioning()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def execute(self, partition: int, ctx: TaskContext):
        for b in self.input.execute(partition, ctx):
            yield pa.RecordBatch.from_arrays(b.columns, schema=self._schema)

    def with_new_children(self, children):
        return RenameSchemaExec(children[0], self._schema)

    def __str__(self) -> str:
        return f"RenameSchemaExec: {self._schema.names}"


class PhysicalPlanner:
    def __init__(self, config: Optional[BallistaConfig] = None):
        self.config = config or BallistaConfig()

    # ------------------------------------------------------------ entry
    def create_physical_plan(self, plan: lp.LogicalPlan) -> ExecutionPlan:
        plan = self._materialize_scalar_subqueries(plan)
        return self._plan(plan)

    def _materialize_scalar_subqueries(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        """Execute uncorrelated scalar subqueries eagerly and inline results.

        DataFusion decorrelates these in its optimizer; TPC-H only needs the
        uncorrelated form at top level (q15-style views are handled by the
        derived-table path).
        """

        def rewrite_expr(e: lex.Expr) -> lex.Expr:
            def fn(node: lex.Expr) -> lex.Expr:
                if isinstance(node, lex.ScalarSubqueryExpr):
                    # the embedded plan never went through the session's
                    # optimizer pass (it lives inside an expression), so
                    # fold/simplify here — date arithmetic etc. must be
                    # constant-folded before physical lowering
                    from ..plan.optimizer import optimize as _optimize

                    sub_phys = PhysicalPlanner(self.config).create_physical_plan(
                        _optimize(node.plan)
                    )
                    tbl = collect(sub_phys, TaskContext(config=self.config))
                    if tbl.num_rows != 1:
                        raise PlanError(
                            f"scalar subquery returned {tbl.num_rows} rows"
                        )
                    return lex.Literal(tbl.column(0)[0].as_py(), tbl.schema.field(0).type)
                return node

            return lex.transform(e, fn)

        def fn_plan(p: lp.LogicalPlan) -> lp.LogicalPlan:
            from ..plan.optimizer import _map_exprs

            return _map_exprs(p, rewrite_expr)

        return lp.transform_up(plan, fn_plan)

    # ------------------------------------------------------------- lowering
    def _plan(self, plan: lp.LogicalPlan) -> ExecutionPlan:
        if isinstance(plan, lp.TableScan):
            return ScanExec(plan.table_name, plan.provider, plan.projection)

        if isinstance(plan, lp.SubqueryAlias):
            child = self._plan(plan.input)
            return RenameSchemaExec(child, plan.schema)

        if isinstance(plan, lp.Filter):
            child = self._plan(plan.input)
            pred = create_physical_expr(plan.predicate, child.schema)
            return FilterExec(pred, child)

        if isinstance(plan, lp.Projection):
            child = self._plan(plan.input)
            exprs = [
                (create_physical_expr(e, child.schema), e.name) for e in plan.exprs
            ]
            return ProjectionExec(exprs, child)

        if isinstance(plan, lp.Aggregate):
            return self._plan_aggregate(plan)

        if isinstance(plan, lp.Window):
            return self._plan_window(plan)

        if isinstance(plan, lp.Sort):
            child = self._plan(plan.input)
            if child.output_partitioning().n != 1:
                child = CoalescePartitionsExec(child)
            keys = [
                (create_physical_expr(s.expr, child.schema), s.asc, s.nulls_first)
                for s in plan.sort_exprs
            ]
            return SortExec(keys, child, plan.fetch)

        if isinstance(plan, lp.Limit):
            child = self._plan(plan.input)
            if child.output_partitioning().n != 1:
                child = CoalescePartitionsExec(child)
            return LimitExec(child, plan.skip, plan.fetch)

        if isinstance(plan, lp.Join):
            return self._plan_join(plan)

        if isinstance(plan, lp.CrossJoin):
            return jn.CrossJoinExec(self._plan(plan.left), self._plan(plan.right))

        if isinstance(plan, lp.Union):
            return UnionExec([self._plan(c) for c in plan.inputs])

        if isinstance(plan, lp.Distinct):
            child = self._plan(plan.input)
            group = [
                (Col(i, f.name), f.name) for i, f in enumerate(child.schema)
            ]
            n = self.config.shuffle_partitions
            if child.output_partitioning().n > 1 or n > 1:
                child = RepartitionExec(
                    child, Partitioning.hash(tuple(g for g, _ in group), n)
                )
            return agg.HashAggregateExec(agg.SINGLE, group, [], child)

        if isinstance(plan, lp.EmptyRelation):
            return EmptyExec(plan.produce_one_row, plan.schema)

        if isinstance(plan, lp.Values):
            from ..catalog import MemoryTable

            arrays = []
            for i, f in enumerate(plan.schema_):
                arrays.append(pa.array([r[i] for r in plan.rows], f.type))
            tbl = pa.Table.from_arrays(arrays, schema=plan.schema_)
            return ScanExec("values", MemoryTable.from_table(tbl), None)

        raise NotImplementedYet(f"physical planning for {type(plan).__name__}")

    # ------------------------------------------------------------- window
    def _plan_window(self, plan: lp.Window) -> ExecutionPlan:
        """Distribute windows with data parallelism: when every window
        shares one non-empty PARTITION BY set, hash-repartition the input
        on it (each hash partition holds whole window partitions); any
        other shape coalesces to a single partition.  The reference's
        planner raises NotImplemented here (planner.rs WindowAggExec) —
        this surpasses it."""
        from .window import WindowExec, WindowSpec

        child = self._plan(plan.input)
        in_schema = child.schema
        out_schema = plan.schema
        base = len(in_schema)

        specs: list[WindowSpec] = []
        part_sets = set()
        for i, w in enumerate(plan.window_exprs):
            part_phys = tuple(
                create_physical_expr(p, in_schema) for p in w.partition_by
            )
            order_phys = tuple(
                (create_physical_expr(s.expr, in_schema), s.asc, s.nulls_first)
                for s in w.order_by
            )
            arg_phys = (
                create_physical_expr(w.arg, in_schema)
                if w.arg is not None
                else None
            )
            f = out_schema.field(base + i)
            specs.append(
                WindowSpec(
                    w.func, arg_phys, part_phys, order_phys, f.name, f.type,
                    w.offset, w.frame,
                )
            )
            part_sets.add(tuple(str(p) for p in w.partition_by))

        n_part = self.config.shuffle_partitions
        # one shared NON-EMPTY partition-by set → hash repartition keeps
        # whole window partitions together; anything else must coalesce
        common_keys = len(part_sets) == 1 and bool(next(iter(part_sets)))
        if common_keys:
            if child.output_partitioning().n > 1:
                child = RepartitionExec(
                    child,
                    Partitioning.hash(specs[0].partition_by, n_part),
                )
        elif child.output_partitioning().n != 1:
            child = CoalescePartitionsExec(child)
        return WindowExec(child, specs)

    # ----------------------------------------------------------- aggregate
    def _plan_aggregate(self, plan: lp.Aggregate) -> ExecutionPlan:
        child = self._plan(plan.input)
        in_schema = child.schema
        agg_schema = plan.schema  # groups then aggs

        group_phys: list[tuple[PhysicalExpr, str]] = []
        for i, g in enumerate(plan.group_exprs):
            group_phys.append(
                (create_physical_expr(g, in_schema), agg_schema.field(i).name)
            )

        specs: list[agg.AggSpec] = []
        has_distinct = False
        for j, a in enumerate(plan.agg_exprs):
            inner = a.expr if isinstance(a, lex.Alias) else a
            assert isinstance(inner, lex.AggregateExpr), f"not an aggregate: {a}"
            if (
                inner.func == "count_distinct"
                or inner.distinct
                or inner.func.startswith("udaf:")
                or inner.func in lex.STAT_AGGREGATES
            ):
                # UDAFs and the statistical aggregates (median/stddev/
                # var/corr) have no partial/merge decomposition — run
                # single stage with each group wholly in one partition,
                # the same strategy as distinct aggregates
                has_distinct = True
            arg = (
                create_physical_expr(inner.arg, in_schema)
                if inner.arg is not None
                else None
            )
            arg2 = (
                create_physical_expr(inner.arg2, in_schema)
                if inner.arg2 is not None
                else None
            )
            name = agg_schema.field(len(plan.group_exprs) + j).name
            specs.append(
                agg.AggSpec(
                    inner.func, arg, name, agg_schema.field(name).type,
                    arg2=arg2,
                )
            )

        n_part = self.config.shuffle_partitions
        repartition = self.config.repartition_aggregations and group_phys

        if has_distinct:
            # distinct aggregates need each group wholly in one partition:
            # hash-repartition input on the group keys, run single-stage
            if group_phys:
                child = RepartitionExec(
                    child,
                    Partitioning.hash(tuple(g for g, _ in group_phys), n_part),
                )
            elif child.output_partitioning().n != 1:
                child = CoalescePartitionsExec(child)
            return agg.HashAggregateExec(agg.SINGLE, group_phys, specs, child)

        partial = agg.HashAggregateExec(agg.PARTIAL, group_phys, specs, child)

        if repartition:
            partial_schema = partial.schema
            key_cols = tuple(
                Col(i, partial_schema.field(i).name) for i in range(len(group_phys))
            )
            shuffled: ExecutionPlan = RepartitionExec(
                partial, Partitioning.hash(key_cols, n_part)
            )
        else:
            shuffled = (
                CoalescePartitionsExec(partial)
                if partial.output_partitioning().n != 1
                else partial
            )

        # FINAL mode re-groups by the key columns of the partial output
        final_groups = [
            (Col(i, partial.schema.field(i).name), name)
            for i, (_, name) in enumerate(group_phys)
        ]
        return agg.HashAggregateExec(agg.FINAL, final_groups, specs, shuffled)

    # ---------------------------------------------------------------- join
    def _plan_join(self, plan: lp.Join) -> ExecutionPlan:
        left = self._plan(plan.left)
        right = self._plan(plan.right)
        lkeys = [create_physical_expr(l, left.schema) for l, _ in plan.on]
        rkeys = [create_physical_expr(r, right.schema) for _, r in plan.on]
        jfilter = (
            create_physical_expr(
                plan.filter, pa.schema(list(left.schema) + list(right.schema))
            )
            if plan.filter is not None
            else None
        )
        n_part = self.config.shuffle_partitions
        if self.config.repartition_joins:
            left = RepartitionExec(left, Partitioning.hash(tuple(lkeys), n_part))
            right = RepartitionExec(right, Partitioning.hash(tuple(rkeys), n_part))
            mode = jn.PARTITIONED
        elif plan.join_type == "inner":
            # broadcasting the build side against each probe partition is
            # only correct for inner joins (other types would emit
            # per-partition unmatched/duplicate rows)
            mode = jn.COLLECT_LEFT
        else:
            if left.output_partitioning().n != 1:
                left = CoalescePartitionsExec(left)
            if right.output_partitioning().n != 1:
                right = CoalescePartitionsExec(right)
            mode = jn.PARTITIONED
        return jn.HashJoinExec(
            left, right, list(zip(lkeys, rkeys)), plan.join_type, mode, jfilter
        )
