"""SQL abstract syntax tree.

Produced by :mod:`arrow_ballista_tpu_torch.sql.parser`, consumed by
:mod:`arrow_ballista_tpu_torch.plan.builder` which resolves names against the
catalog and emits a logical plan.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union


# ---------------------------------------------------------------- expressions
class SqlExpr:
    pass


@dataclass
class ColumnRef(SqlExpr):
    """``name`` or ``qualifier.name``."""

    name: str
    qualifier: Optional[str] = None

    def __str__(self) -> str:
        return f"{self.qualifier}.{self.name}" if self.qualifier else self.name


@dataclass
class Star(SqlExpr):
    qualifier: Optional[str] = None


@dataclass
class NumberLit(SqlExpr):
    value: str  # kept textual; builder decides int vs float/decimal


@dataclass
class StringLit(SqlExpr):
    value: str


@dataclass
class BoolLit(SqlExpr):
    value: bool


@dataclass
class NullLit(SqlExpr):
    pass


@dataclass
class DateLit(SqlExpr):
    value: str  # 'YYYY-MM-DD'


@dataclass
class IntervalLit(SqlExpr):
    value: str  # e.g. "3"
    unit: str  # DAY | MONTH | YEAR ...


@dataclass
class Binary(SqlExpr):
    op: str  # + - * / % = <> < <= > >= AND OR LIKE ||
    left: SqlExpr
    right: SqlExpr


@dataclass
class Unary(SqlExpr):
    op: str  # NOT | -
    operand: SqlExpr


@dataclass
class IsNull(SqlExpr):
    operand: SqlExpr
    negated: bool = False


@dataclass
class Between(SqlExpr):
    operand: SqlExpr
    low: SqlExpr
    high: SqlExpr
    negated: bool = False


@dataclass
class InList(SqlExpr):
    operand: SqlExpr
    items: list[SqlExpr]
    negated: bool = False


@dataclass
class InSubquery(SqlExpr):
    operand: SqlExpr
    query: "Query"
    negated: bool = False


@dataclass
class Exists(SqlExpr):
    query: "Query"
    negated: bool = False


@dataclass
class ScalarSubquery(SqlExpr):
    query: "Query"


@dataclass
class Like(SqlExpr):
    operand: SqlExpr
    pattern: SqlExpr
    negated: bool = False


@dataclass
class WindowFrame:
    """ROWS frame bounds as row offsets relative to the current row:
    negative = preceding, 0 = current row, positive = following,
    None = unbounded in that direction."""

    start: Optional[int]
    end: Optional[int]


@dataclass
class WindowSpec:
    partition_by: list[SqlExpr] = field(default_factory=list)
    order_by: list["OrderItem"] = field(default_factory=list)
    frame: Optional[WindowFrame] = None  # None = default RANGE frame


@dataclass
class FunctionCall(SqlExpr):
    name: str
    args: list[SqlExpr]
    distinct: bool = False
    over: Optional[WindowSpec] = None  # OVER (...) makes it a window fn


@dataclass
class Case(SqlExpr):
    operand: Optional[SqlExpr]
    whens: list[tuple[SqlExpr, SqlExpr]]
    else_expr: Optional[SqlExpr]


@dataclass
class CastExpr(SqlExpr):
    operand: SqlExpr
    type_name: str  # textual SQL type


@dataclass
class Extract(SqlExpr):
    field: str  # YEAR | MONTH | DAY ...
    operand: SqlExpr


@dataclass
class Substring(SqlExpr):
    operand: SqlExpr
    start: SqlExpr
    length: Optional[SqlExpr]


# ---------------------------------------------------------------- queries
@dataclass
class SelectItem:
    expr: SqlExpr
    alias: Optional[str] = None


@dataclass
class TableRef:
    pass


@dataclass
class NamedTable(TableRef):
    name: str
    alias: Optional[str] = None


@dataclass
class DerivedTable(TableRef):
    query: "Query"
    alias: str = ""


@dataclass
class JoinClause(TableRef):
    left: TableRef
    right: TableRef
    kind: str  # INNER | LEFT | RIGHT | FULL | CROSS | SEMI | ANTI
    on: Optional[SqlExpr] = None


@dataclass
class OrderItem:
    expr: SqlExpr
    asc: bool = True
    nulls_first: Optional[bool] = None


@dataclass
class Query:
    ctes: list[tuple[str, "Query"]] = field(default_factory=list)  # WITH name AS (...)
    select: list[SelectItem] = field(default_factory=list)
    distinct: bool = False
    from_: list[TableRef] = field(default_factory=list)  # comma-separated refs
    where: Optional[SqlExpr] = None
    group_by: list[SqlExpr] = field(default_factory=list)
    having: Optional[SqlExpr] = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None


# ---------------------------------------------------------------- statements
Statement = Union["Query", "CreateExternalTable", "ShowStmt", "SetVariable", "Explain", "DropTable"]


@dataclass
class CreateExternalTable:
    """Reference: handled client-side at client/src/context.rs:377-425."""

    name: str
    file_type: str  # CSV | PARQUET | AVRO | NDJSON
    location: str
    columns: list[tuple[str, str]] = field(default_factory=list)  # (name, type)
    has_header: bool = False
    delimiter: str = ","
    if_not_exists: bool = False


@dataclass
class ShowStmt:
    variable: list[str]  # e.g. ["TABLES"] or ["COLUMNS","FROM","t"]


@dataclass
class SetVariable:
    name: str
    value: str


@dataclass
class Explain:
    query: Query
    verbose: bool = False
    analyze: bool = False  # EXPLAIN ANALYZE: execute + runtime metrics


@dataclass
class DropTable:
    name: str
    if_exists: bool = False
