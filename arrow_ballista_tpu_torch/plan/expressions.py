"""Logical expression IR.

Counterpart of DataFusion's ``Expr`` as serialized by the reference's
``core/proto/datafusion.proto`` (LogicalExprNode) — redesigned as Python
dataclasses with pyarrow-based type inference.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from typing import Any, Optional

import pyarrow as pa

from ..errors import PlanError

# ------------------------------------------------------------------ operators
COMPARISON_OPS = {"=", "<>", "<", "<=", ">", ">="}
ARITHMETIC_OPS = {"+", "-", "*", "/", "%"}
BOOLEAN_OPS = {"AND", "OR"}

AGGREGATE_FUNCTIONS = {
    "sum", "avg", "min", "max", "count", "count_distinct",
    # single-stage statistical aggregates (each group wholly in one
    # partition, like count_distinct): exact median, sample/population
    # stddev + variance, Pearson correlation (two arguments)
    "median", "stddev", "stddev_pop", "var", "var_pop", "corr",
}

SCALAR_FUNCTIONS = {
    # math
    "abs", "ceil", "floor", "round", "sqrt", "exp", "ln", "log10", "log2",
    "power", "sin", "cos", "tan", "signum",
    # string
    "lower", "upper", "trim", "ltrim", "rtrim", "length", "char_length",
    "substr", "substring", "concat", "replace", "starts_with", "strpos",
    "left", "right", "repeat", "reverse", "ascii", "lpad", "rpad", "btrim",
    "initcap", "split_part", "translate", "to_hex", "md5", "sha256",
    # temporal
    "date_part", "date_trunc", "extract", "to_timestamp", "now",
    # conditional / misc
    "coalesce", "nullif", "random",
}


def _is_numeric(t: pa.DataType) -> bool:
    return (
        pa.types.is_integer(t)
        or pa.types.is_floating(t)
        or pa.types.is_decimal(t)
    )


def coerce_types(lt: pa.DataType, rt: pa.DataType, op: str) -> pa.DataType:
    """Binary-op result/coercion type (simplified DataFusion coercion rules)."""
    if lt.equals(rt):
        return lt
    if pa.types.is_null(lt):
        return rt
    if pa.types.is_null(rt):
        return lt
    # date arithmetic with intervals handled by the caller
    if _is_numeric(lt) and _is_numeric(rt):
        if pa.types.is_decimal(lt) or pa.types.is_decimal(rt):
            return pa.float64()
        if pa.types.is_floating(lt) or pa.types.is_floating(rt):
            return pa.float64() if (lt.bit_width == 64 or rt.bit_width == 64) else pa.float32()
        # both ints
        return pa.int64()
    if (pa.types.is_date(lt) and pa.types.is_string(rt)) or (
        pa.types.is_string(lt) and pa.types.is_date(rt)
    ):
        return pa.date32()
    if pa.types.is_string(lt) and pa.types.is_string(rt):
        return pa.string()
    if pa.types.is_boolean(lt) and pa.types.is_boolean(rt):
        return pa.bool_()
    if pa.types.is_timestamp(lt) or pa.types.is_timestamp(rt):
        return pa.timestamp("us")
    raise PlanError(f"cannot coerce {lt} {op} {rt}")


class Expr:
    """Base logical expression."""

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        raise NotImplementedError

    def nullable(self, schema: pa.Schema) -> bool:
        return True

    @property
    def name(self) -> str:
        """Output column name when this expr lands in a projection."""
        return str(self)

    def children(self) -> list["Expr"]:
        return []

    # Convenience builders (DataFrame API surface)
    def __eq__(self, other: object):  # type: ignore[override]
        if isinstance(other, Expr) or not isinstance(other, (str, bytes)):
            return BinaryExpr(self, "=", _lit_or_expr(other))
        return NotImplemented

    def __hash__(self) -> int:
        return hash(str(self))

    def __lt__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "<", _lit_or_expr(other))

    def __le__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "<=", _lit_or_expr(other))

    def __gt__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, ">", _lit_or_expr(other))

    def __ge__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, ">=", _lit_or_expr(other))

    def __add__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "+", _lit_or_expr(other))

    def __sub__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "-", _lit_or_expr(other))

    def __mul__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "*", _lit_or_expr(other))

    def __truediv__(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "/", _lit_or_expr(other))

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def neq(self, other: Any) -> "BinaryExpr":
        return BinaryExpr(self, "<>", _lit_or_expr(other))

    def and_(self, other: "Expr") -> "BinaryExpr":
        return BinaryExpr(self, "AND", other)

    def or_(self, other: "Expr") -> "BinaryExpr":
        return BinaryExpr(self, "OR", other)

    def is_null(self) -> "IsNullExpr":
        return IsNullExpr(self, False)

    def sort(self, asc: bool = True, nulls_first: Optional[bool] = None) -> "SortExpr":
        return SortExpr(self, asc, nulls_first)


def _lit_or_expr(v: Any) -> Expr:
    return v if isinstance(v, Expr) else lit(v)


@dataclass(frozen=True, eq=False)
class Column(Expr):
    """A resolved column reference, optionally relation-qualified."""

    cname: str
    qualifier: Optional[str] = None

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return schema.field(self.resolve_index(schema)).type

    def nullable(self, schema: pa.Schema) -> bool:
        return schema.field(self.resolve_index(schema)).nullable

    def resolve_index(self, schema: pa.Schema) -> int:
        flat = self.flat_name
        idx = schema.get_field_index(flat)
        if idx >= 0:
            return idx
        if self.qualifier is not None:
            # a qualified ref may bind to an exactly-named unqualified field
            # (e.g. aggregate/projection output), but never suffix-match a
            # field carrying a DIFFERENT qualifier
            idx = schema.get_field_index(self.cname)
            if idx >= 0 and "." not in schema.field(idx).name:
                return idx
            raise PlanError(f"column {flat!r} not found in {schema.names}")
        # unqualified reference: qualified schema fields match on suffix
        matches = [
            i
            for i, f in enumerate(schema)
            if f.name.split(".")[-1] == self.cname
        ]
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            raise PlanError(f"ambiguous column {self.flat_name!r} in {schema.names}")
        raise PlanError(f"column {self.flat_name!r} not found in {schema.names}")

    @property
    def flat_name(self) -> str:
        return f"{self.qualifier}.{self.cname}" if self.qualifier else self.cname

    @property
    def name(self) -> str:
        return self.cname

    def __str__(self) -> str:
        return self.flat_name


@dataclass(frozen=True, eq=False)
class Literal(Expr):
    value: Any
    dtype: pa.DataType = field(default_factory=pa.null)

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.dtype

    def nullable(self, schema: pa.Schema) -> bool:
        return self.value is None

    def __str__(self) -> str:
        if isinstance(self.value, str):
            return f"'{self.value}'"
        return str(self.value)


def lit(v: Any) -> Literal:
    if v is None:
        return Literal(None, pa.null())
    if isinstance(v, bool):
        return Literal(v, pa.bool_())
    if isinstance(v, int):
        return Literal(v, pa.int64())
    if isinstance(v, float):
        return Literal(v, pa.float64())
    if isinstance(v, str):
        return Literal(v, pa.string())
    if isinstance(v, _dt.date):
        return Literal(v, pa.date32())
    if isinstance(v, _dt.datetime):
        return Literal(v, pa.timestamp("us"))
    raise PlanError(f"unsupported literal {v!r}")


@dataclass(frozen=True, eq=False)
class IntervalLiteral(Expr):
    """Calendar interval; kept symbolic so date arithmetic stays exact."""

    months: int = 0
    days: int = 0

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.month_day_nano_interval()

    def __str__(self) -> str:
        return f"INTERVAL {self.months} MONTH {self.days} DAY"


@dataclass(frozen=True, eq=False)
class Alias(Expr):
    expr: Expr
    alias_name: str

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.expr.data_type(schema)

    def nullable(self, schema: pa.Schema) -> bool:
        return self.expr.nullable(schema)

    @property
    def name(self) -> str:
        return self.alias_name

    def children(self) -> list[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"{self.expr} AS {self.alias_name}"


@dataclass(frozen=True, eq=False)
class BinaryExpr(Expr):
    left: Expr
    op: str
    right: Expr

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        if self.op in COMPARISON_OPS or self.op in BOOLEAN_OPS:
            return pa.bool_()
        lt = self.left.data_type(schema)
        rt = self.right.data_type(schema)
        # date ± interval
        if pa.types.is_date(lt) and isinstance(self.right, IntervalLiteral):
            return lt
        if self.op == "||":
            return pa.string()
        return coerce_types(lt, rt, self.op)

    def children(self) -> list[Expr]:
        return [self.left, self.right]

    def __str__(self) -> str:
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True, eq=False)
class NotExpr(Expr):
    expr: Expr

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def children(self) -> list[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"NOT {self.expr}"


@dataclass(frozen=True, eq=False)
class NegativeExpr(Expr):
    expr: Expr

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.expr.data_type(schema)

    def children(self) -> list[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"(- {self.expr})"


@dataclass(frozen=True, eq=False)
class IsNullExpr(Expr):
    expr: Expr
    negated: bool = False

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def nullable(self, schema: pa.Schema) -> bool:
        return False

    def children(self) -> list[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"{self.expr} IS {'NOT ' if self.negated else ''}NULL"


@dataclass(frozen=True, eq=False)
class BetweenExpr(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def children(self) -> list[Expr]:
        return [self.expr, self.low, self.high]

    def __str__(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"{self.expr} {neg}BETWEEN {self.low} AND {self.high}"


@dataclass(frozen=True, eq=False)
class InListExpr(Expr):
    expr: Expr
    items: tuple[Expr, ...] = ()
    negated: bool = False

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def children(self) -> list[Expr]:
        return [self.expr, *self.items]

    def __str__(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"{self.expr} {neg}IN ({', '.join(map(str, self.items))})"


@dataclass(frozen=True, eq=False)
class LikeExpr(Expr):
    expr: Expr
    pattern: Expr
    negated: bool = False

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return pa.bool_()

    def children(self) -> list[Expr]:
        return [self.expr, self.pattern]

    def __str__(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"{self.expr} {neg}LIKE {self.pattern}"


@dataclass(frozen=True, eq=False)
class CaseExpr(Expr):
    operand: Optional[Expr]
    whens: tuple[tuple[Expr, Expr], ...]
    else_expr: Optional[Expr]

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        for _, then in self.whens:
            t = then.data_type(schema)
            if not pa.types.is_null(t):
                return t
        if self.else_expr is not None:
            return self.else_expr.data_type(schema)
        return pa.null()

    def children(self) -> list[Expr]:
        out: list[Expr] = []
        if self.operand:
            out.append(self.operand)
        for w, t in self.whens:
            out.extend([w, t])
        if self.else_expr:
            out.append(self.else_expr)
        return out

    def __str__(self) -> str:
        parts = ["CASE"]
        if self.operand:
            parts.append(str(self.operand))
        for w, t in self.whens:
            parts.append(f"WHEN {w} THEN {t}")
        if self.else_expr:
            parts.append(f"ELSE {self.else_expr}")
        parts.append("END")
        return " ".join(parts)


@dataclass(frozen=True, eq=False)
class CastExpr(Expr):
    expr: Expr
    to_type: pa.DataType = field(default_factory=pa.float64)

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.to_type

    def children(self) -> list[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"CAST({self.expr} AS {self.to_type})"


@dataclass(frozen=True, eq=False)
class ScalarFunction(Expr):
    fname: str
    args: tuple[Expr, ...] = ()

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        f = self.fname
        if f in {"length", "char_length", "strpos", "ascii"}:
            return pa.int64()
        if f in {"lower", "upper", "trim", "ltrim", "rtrim", "substr", "substring",
                 "concat", "replace", "left", "right", "repeat", "reverse",
                 "lpad", "rpad", "btrim", "initcap", "split_part", "translate",
                 "to_hex", "md5", "sha256"}:
            return pa.string()
        if f == "starts_with":
            return pa.bool_()
        if f in {"date_part", "extract"}:
            return pa.int64()
        if f == "date_trunc":
            unit = self.args[0].value if isinstance(self.args[0], Literal) else None
            if unit in ("day", "week", "month", "quarter", "year"):
                return pa.date32()
            return pa.timestamp("us")
        if f in {"to_timestamp", "now"}:
            return pa.timestamp("us")
        if f in {"coalesce", "nullif"}:
            return self.args[0].data_type(schema)
        if f in {"abs", "signum"}:
            return self.args[0].data_type(schema)
        if f in {"ceil", "floor", "round"}:
            return pa.float64()
        return pa.float64()

    def children(self) -> list[Expr]:
        return list(self.args)

    def __str__(self) -> str:
        return f"{self.fname}({', '.join(map(str, self.args))})"


@dataclass(frozen=True, eq=False)
class ScalarUDFExpr(Expr):
    """A user scalar function call, resolved by NAME from the UDF registry
    (reference: ScalarUDF shipped as UdfNode, code loaded via plugin)."""

    fname: str
    args: tuple = ()
    return_type: pa.DataType = field(default_factory=pa.float64)

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.return_type

    def nullable(self, schema: pa.Schema) -> bool:
        return True

    def children(self) -> list["Expr"]:
        return list(self.args)

    @property
    def name(self) -> str:
        return self.fname

    def __str__(self) -> str:
        return f"{self.fname}({', '.join(str(a) for a in self.args)})"


STAT_AGGREGATES = {"median", "stddev", "stddev_pop", "var", "var_pop", "corr"}


@dataclass(frozen=True, eq=False)
class AggregateExpr(Expr):
    func: str  # sum | avg | min | max | count | count_distinct | median
    #            | stddev | stddev_pop | var | var_pop | corr | udaf:<name>
    arg: Optional[Expr]  # None for COUNT(*)
    distinct: bool = False
    # UDAF return type, captured at build time and shipped over the wire so
    # a scheduler that has not registered the UDAF can still plan the job
    udaf_type: Optional[pa.DataType] = None
    arg2: Optional[Expr] = None  # corr's second argument

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        if self.func.startswith("udaf:"):
            if self.udaf_type is not None:
                return self.udaf_type
            from ..udf import global_registry

            u = global_registry().aggregate(self.func[5:])
            if u is None:
                raise PlanError(f"UDAF {self.func[5:]!r} not registered")
            return u.return_type
        if self.func.startswith("count"):
            return pa.int64()
        if self.func == "avg" or self.func in STAT_AGGREGATES:
            return pa.float64()
        assert self.arg is not None
        t = self.arg.data_type(schema)
        if self.func == "sum":
            if pa.types.is_integer(t):
                return pa.int64()
            return pa.float64()
        return t  # min/max keep input type

    def children(self) -> list[Expr]:
        out = [self.arg] if self.arg is not None else []
        if self.arg2 is not None:
            out.append(self.arg2)
        return out

    def __str__(self) -> str:
        inner = "*" if self.arg is None else str(self.arg)
        if self.distinct:
            inner = f"DISTINCT {inner}"
        if self.arg2 is not None:
            inner = f"{inner}, {self.arg2}"
        fname = "count" if self.func == "count_distinct" else self.func
        return f"{fname}({inner})"


# ranking window functions (the aggregate set also works over windows);
# ntile(k) carries its bucket count in WindowExpr.offset
WINDOW_RANKING_FUNCTIONS = {"row_number", "rank", "dense_rank", "ntile"}
# value window functions: argument-typed, ORDER BY required
WINDOW_VALUE_FUNCTIONS = {"lag", "lead", "first_value", "last_value"}


@dataclass(frozen=True, eq=False)
class WindowExpr(Expr):
    """``func(...) OVER (PARTITION BY ... ORDER BY ...)``.

    Reference parity note: DataFusion's single-node engine evaluates
    window functions; Ballista's distributed planner raises
    NotImplemented for WindowAggExec (``planner.rs`` WindowAggExec arm).
    Here the physical planner repartitions on the PARTITION BY keys so
    windows also run distributed — each hash partition holds whole
    window partitions.

    Semantics: ranking functions need ORDER BY; aggregate functions
    without ORDER BY cover the whole partition, with ORDER BY they are
    running aggregates over the default frame (RANGE UNBOUNDED PRECEDING
    — peer rows share the value).
    """

    func: str  # row_number | rank | dense_rank | ntile | lag | lead
    #            | first_value | last_value | sum | avg | min | max | count
    arg: Optional["Expr"]  # None for ranking functions and count(*)
    partition_by: tuple = ()
    order_by: tuple = ()  # of SortExpr
    offset: int = 1  # lag/lead distance; ntile bucket count
    # explicit ROWS frame as (start, end) row offsets relative to the
    # current row (negative = preceding, None = unbounded); None = the
    # default RANGE frame
    frame: Optional[tuple] = None

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        if self.func in WINDOW_RANKING_FUNCTIONS or self.func.startswith(
            "count"
        ):
            return pa.int64()
        if self.func == "avg":
            return pa.float64()
        assert self.arg is not None
        t = self.arg.data_type(schema)
        if self.func == "sum":
            return pa.int64() if pa.types.is_integer(t) else pa.float64()
        return t  # min/max and the value functions keep the input type

    def children(self) -> list["Expr"]:
        out = [self.arg] if self.arg is not None else []
        out.extend(self.partition_by)
        out.extend(s.expr for s in self.order_by)
        return out

    def __str__(self) -> str:
        inner = "*" if self.arg is None else str(self.arg)
        if self.func in WINDOW_RANKING_FUNCTIONS:
            # ntile's bucket count must stay visible: the builder dedups
            # window exprs BY THIS STRING, so ntile(2) and ntile(3) over
            # the same window must not collapse into one column
            inner = str(self.offset) if self.func == "ntile" else ""
        if self.func in ("lag", "lead"):
            inner = f"{inner}, {self.offset}"
        parts = []
        if self.partition_by:
            parts.append(
                "PARTITION BY " + ", ".join(str(p) for p in self.partition_by)
            )
        if self.order_by:
            parts.append(
                "ORDER BY " + ", ".join(str(s) for s in self.order_by)
            )
        if self.frame is not None:
            # part of the dedup identity: same window, different frame
            # must stay a different column

            def b(v, side):
                if v is None:
                    return f"UNBOUNDED {side}"
                if v == 0:
                    return "CURRENT ROW"
                return f"{-v} PRECEDING" if v < 0 else f"{v} FOLLOWING"

            parts.append(
                f"ROWS BETWEEN {b(self.frame[0], 'PRECEDING')} "
                f"AND {b(self.frame[1], 'FOLLOWING')}"
            )
        return f"{self.func}({inner}) OVER ({' '.join(parts)})"


@dataclass(frozen=True, eq=False)
class SortExpr(Expr):
    expr: Expr
    asc: bool = True
    nulls_first: Optional[bool] = None

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.expr.data_type(schema)

    def children(self) -> list[Expr]:
        return [self.expr]

    def __str__(self) -> str:
        s = f"{self.expr} {'ASC' if self.asc else 'DESC'}"
        if self.nulls_first is not None:
            s += " NULLS FIRST" if self.nulls_first else " NULLS LAST"
        return s


@dataclass(frozen=True, eq=False)
class ScalarSubqueryExpr(Expr):
    """Uncorrelated scalar subquery; replaced by a Literal by the optimizer."""

    plan: Any  # LogicalPlan (deferred import)

    def data_type(self, schema: pa.Schema) -> pa.DataType:
        return self.plan.schema.field(0).type

    def __str__(self) -> str:
        return "(<scalar subquery>)"


def col(name: str) -> Column:
    if "." in name:
        q, c = name.rsplit(".", 1)
        return Column(c, q)
    return Column(name)


# ------------------------------------------------------------- tree walking
def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def find_columns(e: Expr) -> list[Column]:
    return [x for x in walk(e) if isinstance(x, Column)]


def find_aggregates(e: Expr) -> list[AggregateExpr]:
    # note: a windowed aggregate (sum(x) OVER (...)) is a WindowExpr with
    # func="sum", never a wrapped AggregateExpr — so any AggregateExpr
    # found inside a window's arg/partition/order refers to the enclosing
    # GROUP BY level and is correctly collected here
    return [x for x in walk(e) if isinstance(x, AggregateExpr)]


def find_windows(e: Expr) -> list[WindowExpr]:
    return [x for x in walk(e) if isinstance(x, WindowExpr)]


def transform(e: Expr, fn) -> Expr:
    """Bottom-up expression rewrite."""
    if isinstance(e, Alias):
        e2: Expr = Alias(transform(e.expr, fn), e.alias_name)
    elif isinstance(e, BinaryExpr):
        e2 = BinaryExpr(transform(e.left, fn), e.op, transform(e.right, fn))
    elif isinstance(e, NotExpr):
        e2 = NotExpr(transform(e.expr, fn))
    elif isinstance(e, NegativeExpr):
        e2 = NegativeExpr(transform(e.expr, fn))
    elif isinstance(e, IsNullExpr):
        e2 = IsNullExpr(transform(e.expr, fn), e.negated)
    elif isinstance(e, BetweenExpr):
        e2 = BetweenExpr(
            transform(e.expr, fn), transform(e.low, fn), transform(e.high, fn), e.negated
        )
    elif isinstance(e, InListExpr):
        e2 = InListExpr(
            transform(e.expr, fn), tuple(transform(i, fn) for i in e.items), e.negated
        )
    elif isinstance(e, LikeExpr):
        e2 = LikeExpr(transform(e.expr, fn), transform(e.pattern, fn), e.negated)
    elif isinstance(e, CaseExpr):
        e2 = CaseExpr(
            transform(e.operand, fn) if e.operand else None,
            tuple((transform(w, fn), transform(t, fn)) for w, t in e.whens),
            transform(e.else_expr, fn) if e.else_expr else None,
        )
    elif isinstance(e, CastExpr):
        e2 = CastExpr(transform(e.expr, fn), e.to_type)
    elif isinstance(e, ScalarFunction):
        e2 = ScalarFunction(e.fname, tuple(transform(a, fn) for a in e.args))
    elif isinstance(e, ScalarUDFExpr):
        e2 = ScalarUDFExpr(
            e.fname, tuple(transform(a, fn) for a in e.args), e.return_type
        )
    elif isinstance(e, AggregateExpr):
        e2 = AggregateExpr(
            e.func,
            transform(e.arg, fn) if e.arg is not None else None,
            e.distinct,
            udaf_type=e.udaf_type,
            arg2=transform(e.arg2, fn) if e.arg2 is not None else None,
        )
    elif isinstance(e, WindowExpr):
        e2 = WindowExpr(
            e.func,
            transform(e.arg, fn) if e.arg is not None else None,
            tuple(transform(p, fn) for p in e.partition_by),
            tuple(
                SortExpr(transform(s.expr, fn), s.asc, s.nulls_first)
                for s in e.order_by
            ),
            e.offset,
            e.frame,
        )
    elif isinstance(e, SortExpr):
        e2 = SortExpr(transform(e.expr, fn), e.asc, e.nulls_first)
    else:
        e2 = e
    return fn(e2)
