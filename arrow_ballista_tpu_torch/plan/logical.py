"""Logical plan nodes.

Counterpart of DataFusion's ``LogicalPlan`` as carried over the wire by the
reference (``core/proto/datafusion.proto`` LogicalPlanNode).  Schemas are
``pyarrow.Schema``; field names carry relation qualifiers as ``"rel.col"``
flat names, mirroring DataFusion's ``DFSchema`` qualified fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import TYPE_CHECKING, Any, Optional

import pyarrow as pa

from ..errors import PlanError
from . import expressions as ex

if TYPE_CHECKING:
    from ..catalog import TableProvider


class LogicalPlan:
    @property
    def schema(self) -> pa.Schema:
        raise NotImplementedError

    def children(self) -> list["LogicalPlan"]:
        return []

    def display(self, indent: int = 0) -> str:
        out = "  " * indent + str(self)
        for c in self.children():
            out += "\n" + c.display(indent + 1)
        return out


def _qualify(schema: pa.Schema, qualifier: str) -> pa.Schema:
    return pa.schema(
        [
            pa.field(f"{qualifier}.{f.name.split('.')[-1]}", f.type, f.nullable)
            for f in schema
        ]
    )


@dataclass
class TableScan(LogicalPlan):
    table_name: str
    provider: "TableProvider"
    projection: Optional[list[str]] = None  # column names (unqualified)
    filters: list[ex.Expr] = dc_field(default_factory=list)  # pushed-down

    @property
    def schema(self) -> pa.Schema:
        base = self.provider.schema
        if self.projection is not None:
            base = pa.schema([base.field(n) for n in self.projection])
        return _qualify(base, self.table_name)

    def __str__(self) -> str:
        proj = f" projection={self.projection}" if self.projection is not None else ""
        filt = f" filters={[str(f) for f in self.filters]}" if self.filters else ""
        return f"TableScan: {self.table_name}{proj}{filt}"


@dataclass
class SubqueryAlias(LogicalPlan):
    input: LogicalPlan
    alias: str

    @property
    def schema(self) -> pa.Schema:
        return _qualify(self.input.schema, self.alias)

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def __str__(self) -> str:
        return f"SubqueryAlias: {self.alias}"


@dataclass
class Projection(LogicalPlan):
    exprs: list[ex.Expr]
    input: LogicalPlan

    @property
    def schema(self) -> pa.Schema:
        in_schema = self.input.schema
        return pa.schema(
            [
                pa.field(e.name, e.data_type(in_schema), e.nullable(in_schema))
                for e in self.exprs
            ]
        )

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def __str__(self) -> str:
        return f"Projection: {', '.join(str(e) for e in self.exprs)}"


@dataclass
class Filter(LogicalPlan):
    predicate: ex.Expr
    input: LogicalPlan

    @property
    def schema(self) -> pa.Schema:
        return self.input.schema

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def __str__(self) -> str:
        return f"Filter: {self.predicate}"


@dataclass
class Aggregate(LogicalPlan):
    group_exprs: list[ex.Expr]
    agg_exprs: list[ex.Expr]  # AggregateExpr possibly wrapped in Alias
    input: LogicalPlan

    @property
    def schema(self) -> pa.Schema:
        in_schema = self.input.schema
        fields = [
            pa.field(e.name, e.data_type(in_schema), True) for e in self.group_exprs
        ]
        fields += [
            pa.field(e.name, e.data_type(in_schema), True) for e in self.agg_exprs
        ]
        return pa.schema(fields)

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def __str__(self) -> str:
        g = ", ".join(str(e) for e in self.group_exprs)
        a = ", ".join(str(e) for e in self.agg_exprs)
        return f"Aggregate: groupBy=[{g}], aggr=[{a}]"


@dataclass
class Window(LogicalPlan):
    """Window evaluation: output = input columns + one column per
    window expression (in original row order — windows do not reorder)."""

    window_exprs: list[ex.WindowExpr]
    input: LogicalPlan

    @property
    def schema(self) -> pa.Schema:
        in_schema = self.input.schema
        fields = list(in_schema)
        fields += [
            pa.field(str(w), w.data_type(in_schema), True)
            for w in self.window_exprs
        ]
        return pa.schema(fields)

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def __str__(self) -> str:
        return (
            "Window: "
            + ", ".join(str(w) for w in self.window_exprs)
        )


@dataclass
class Sort(LogicalPlan):
    sort_exprs: list[ex.SortExpr]
    input: LogicalPlan
    fetch: Optional[int] = None

    @property
    def schema(self) -> pa.Schema:
        return self.input.schema

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def __str__(self) -> str:
        return f"Sort: {', '.join(str(e) for e in self.sort_exprs)}"


@dataclass
class Limit(LogicalPlan):
    input: LogicalPlan
    skip: int = 0
    fetch: Optional[int] = None

    @property
    def schema(self) -> pa.Schema:
        return self.input.schema

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def __str__(self) -> str:
        return f"Limit: skip={self.skip}, fetch={self.fetch}"


JOIN_TYPES = {"inner", "left", "right", "full", "semi", "anti"}


@dataclass
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    on: list[tuple[ex.Column, ex.Column]]  # equijoin keys (left, right)
    join_type: str = "inner"
    filter: Optional[ex.Expr] = None  # extra non-equi condition

    def __post_init__(self) -> None:
        if self.join_type not in JOIN_TYPES:
            raise PlanError(f"unsupported join type {self.join_type}")

    @property
    def schema(self) -> pa.Schema:
        if self.join_type in ("semi", "anti"):
            return self.left.schema
        lf = list(self.left.schema)
        rf = list(self.right.schema)
        if self.join_type in ("left", "full"):
            rf = [f.with_nullable(True) for f in rf]
        if self.join_type in ("right", "full"):
            lf = [f.with_nullable(True) for f in lf]
        return pa.schema(lf + rf)

    def children(self) -> list[LogicalPlan]:
        return [self.left, self.right]

    def __str__(self) -> str:
        on = ", ".join(f"{l} = {r}" for l, r in self.on)
        f = f" filter={self.filter}" if self.filter is not None else ""
        return f"Join({self.join_type}): on=[{on}]{f}"


@dataclass
class CrossJoin(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan

    @property
    def schema(self) -> pa.Schema:
        return pa.schema(list(self.left.schema) + list(self.right.schema))

    def children(self) -> list[LogicalPlan]:
        return [self.left, self.right]

    def __str__(self) -> str:
        return "CrossJoin"


@dataclass
class Union(LogicalPlan):
    inputs: list[LogicalPlan]

    @property
    def schema(self) -> pa.Schema:
        return self.inputs[0].schema

    def children(self) -> list[LogicalPlan]:
        return list(self.inputs)

    def __str__(self) -> str:
        return "Union"


@dataclass
class Distinct(LogicalPlan):
    input: LogicalPlan

    @property
    def schema(self) -> pa.Schema:
        return self.input.schema

    def children(self) -> list[LogicalPlan]:
        return [self.input]

    def __str__(self) -> str:
        return "Distinct"


@dataclass
class EmptyRelation(LogicalPlan):
    produce_one_row: bool = False
    schema_: pa.Schema = dc_field(default_factory=lambda: pa.schema([]))

    @property
    def schema(self) -> pa.Schema:
        return self.schema_

    def __str__(self) -> str:
        return f"EmptyRelation: produce_one_row={self.produce_one_row}"


@dataclass
class Values(LogicalPlan):
    rows: list[list[Any]]
    schema_: pa.Schema = dc_field(default_factory=lambda: pa.schema([]))

    @property
    def schema(self) -> pa.Schema:
        return self.schema_

    def __str__(self) -> str:
        return f"Values: {len(self.rows)} rows"


@dataclass
class ExplainPlan(LogicalPlan):
    plan: LogicalPlan
    verbose: bool = False

    @property
    def schema(self) -> pa.Schema:
        return pa.schema([pa.field("plan_type", pa.string()), pa.field("plan", pa.string())])

    def children(self) -> list[LogicalPlan]:
        return [self.plan]

    def __str__(self) -> str:
        return "Explain"


def transform_up(plan: LogicalPlan, fn) -> LogicalPlan:
    """Bottom-up plan rewrite; fn(node_with_new_children) -> node."""
    kids = plan.children()
    if kids:
        new_kids = [transform_up(c, fn) for c in kids]
        plan = with_new_children(plan, new_kids)
    return fn(plan)


def with_new_children(plan: LogicalPlan, kids: list[LogicalPlan]) -> LogicalPlan:
    import copy

    p = copy.copy(plan)
    if isinstance(
        p,
        (Projection, Filter, Aggregate, Window, Sort, Limit, Distinct, SubqueryAlias),
    ):
        p.input = kids[0]
    elif isinstance(p, (Join, CrossJoin)):
        p.left, p.right = kids
    elif isinstance(p, Union):
        p.inputs = kids
    elif isinstance(p, ExplainPlan):
        p.plan = kids[0]
    elif kids:
        raise PlanError(f"with_new_children: unhandled node {type(plan).__name__}")
    return p
