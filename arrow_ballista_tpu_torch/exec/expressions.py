"""Physical expressions — columnar evaluation over Arrow batches.

Counterpart of the reference's physical expr tree
(``core/proto/ballista.proto:91-124`` PhysicalExprNode and DataFusion's
``PhysicalExpr``).  Columns are resolved to indices at planning time; eval is
vectorized via ``pyarrow.compute``.  The TPU stage compiler
(:mod:`arrow_ballista_tpu_torch.ops.stage_compiler`) lowers this same tree to jax.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from typing import Any, Optional

import pyarrow as pa
import pyarrow.compute as pc

from ..errors import ExecutionError, NotImplementedYet, PlanError
from ..plan import expressions as lex


class PhysicalExpr:
    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        raise NotImplementedError

    def children(self) -> list["PhysicalExpr"]:
        return []

    @property
    def name(self) -> str:
        return str(self)


@dataclass(frozen=True)
class Col(PhysicalExpr):
    index: int
    colname: str

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        return batch.column(self.index)

    @property
    def name(self) -> str:
        return self.colname

    def __str__(self) -> str:
        return f"{self.colname}@{self.index}"


@dataclass(frozen=True)
class Lit(PhysicalExpr):
    value: Any
    dtype: pa.DataType = field(default_factory=pa.null)

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        return pa.scalar(self.value, self.dtype if not pa.types.is_null(self.dtype) else None)

    def __str__(self) -> str:
        return repr(self.value)


@dataclass(frozen=True)
class IntervalLit(PhysicalExpr):
    months: int
    days: int

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        return pa.scalar((self.months, self.days, 0), pa.month_day_nano_interval())

    def __str__(self) -> str:
        return f"interval({self.months}mo,{self.days}d)"


_CMP = {
    "=": pc.equal,
    "<>": pc.not_equal,
    "<": pc.less,
    "<=": pc.less_equal,
    ">": pc.greater,
    ">=": pc.greater_equal,
}
_ARITH = {
    "+": pc.add_checked,
    "-": pc.subtract_checked,
    "*": pc.multiply_checked,
    "/": pc.divide,
}


def _as_compute_val(v):
    return v


@dataclass(frozen=True)
class Binary(PhysicalExpr):
    left: PhysicalExpr
    op: str
    right: PhysicalExpr

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        op = self.op
        if op == "AND":
            return pc.and_kleene(self.left.evaluate(batch), self.right.evaluate(batch))
        if op == "OR":
            return pc.or_kleene(self.left.evaluate(batch), self.right.evaluate(batch))
        l = self.left.evaluate(batch)
        r = self.right.evaluate(batch)
        if op in _CMP:
            return _CMP[op](l, r)
        if op == "%":
            return pc.subtract(l, pc.multiply(pc.floor(pc.divide(l, r)), r))
        if op == "||":
            return pc.binary_join_element_wise(
                pc.cast(l, pa.string()), pc.cast(r, pa.string()), ""
            )
        if op in _ARITH:
            try:
                return _ARITH[op](l, r)
            except pa.ArrowNotImplementedError:
                # e.g. date32 ± month_day_nano_interval needs timestamp hop
                if pa.types.is_date(_type_of(l)):
                    ts = pc.cast(l, pa.timestamp("s"))
                    out = _ARITH[op](ts, r)
                    return pc.cast(out, pa.date32())
                raise
        raise ExecutionError(f"unsupported binary op {op}")

    def children(self) -> list[PhysicalExpr]:
        return [self.left, self.right]

    def __str__(self) -> str:
        return f"({self.left} {self.op} {self.right})"


def _type_of(v) -> pa.DataType:
    return v.type


@dataclass(frozen=True)
class Not(PhysicalExpr):
    expr: PhysicalExpr

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        return pc.invert(self.expr.evaluate(batch))

    def children(self) -> list[PhysicalExpr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"NOT {self.expr}"


@dataclass(frozen=True)
class Negative(PhysicalExpr):
    expr: PhysicalExpr

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        return pc.negate(self.expr.evaluate(batch))

    def children(self) -> list[PhysicalExpr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"(- {self.expr})"


@dataclass(frozen=True)
class IsNull(PhysicalExpr):
    expr: PhysicalExpr
    negated: bool = False

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        v = self.expr.evaluate(batch)
        return pc.is_valid(v) if self.negated else pc.is_null(v)

    def children(self) -> list[PhysicalExpr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"{self.expr} IS {'NOT ' if self.negated else ''}NULL"


@dataclass(frozen=True)
class InList(PhysicalExpr):
    expr: PhysicalExpr
    items: tuple[Any, ...]
    negated: bool = False

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        v = self.expr.evaluate(batch)
        mask = pc.is_in(v, value_set=pa.array(list(self.items)))
        return pc.invert(mask) if self.negated else mask

    def __str__(self) -> str:
        return f"{self.expr} IN {self.items}"


@dataclass(frozen=True)
class Like(PhysicalExpr):
    expr: PhysicalExpr
    pattern: str
    negated: bool = False

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        v = self.expr.evaluate(batch)
        m = pc.match_like(v, self.pattern)
        return pc.invert(m) if self.negated else m

    def __str__(self) -> str:
        return f"{self.expr} {'NOT ' if self.negated else ''}LIKE '{self.pattern}'"


@dataclass(frozen=True)
class Case(PhysicalExpr):
    whens: tuple[tuple[PhysicalExpr, PhysicalExpr], ...]
    else_expr: Optional[PhysicalExpr]
    out_type: pa.DataType = field(default_factory=pa.float64)

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        n = batch.num_rows
        if self.else_expr is not None:
            result = _broadcast(self.else_expr.evaluate(batch), n, self.out_type)
        else:
            result = pa.nulls(n, self.out_type)
        for cond_e, then_e in reversed(self.whens):
            cond = _broadcast(cond_e.evaluate(batch), n, pa.bool_())
            then = _broadcast(then_e.evaluate(batch), n, self.out_type)
            result = pc.if_else(cond, then, result)
        return result

    def children(self) -> list[PhysicalExpr]:
        out = []
        for w, t in self.whens:
            out += [w, t]
        if self.else_expr:
            out.append(self.else_expr)
        return out

    def __str__(self) -> str:
        return "CASE " + " ".join(f"WHEN {w} THEN {t}" for w, t in self.whens) + (
            f" ELSE {self.else_expr} END" if self.else_expr else " END"
        )


def _broadcast(v, n: int, dtype: pa.DataType):
    if isinstance(v, pa.Scalar):
        return pc.cast(v, dtype) if not v.type.equals(dtype) else v
    if isinstance(v, (pa.Array, pa.ChunkedArray)):
        return pc.cast(v, dtype) if not v.type.equals(dtype) else v
    return pa.scalar(v, dtype)


@dataclass(frozen=True)
class Cast(PhysicalExpr):
    expr: PhysicalExpr
    to_type: pa.DataType

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        return pc.cast(self.expr.evaluate(batch), self.to_type, safe=False)

    def children(self) -> list[PhysicalExpr]:
        return [self.expr]

    def __str__(self) -> str:
        return f"CAST({self.expr} AS {self.to_type})"


@dataclass(frozen=True)
class ScalarUdf(PhysicalExpr):
    """User scalar function resolved BY NAME from the process-global UDF
    registry at evaluation time — executors never receive code, only the
    name (reference: plugin-loaded ScalarUDF referenced from TaskContext).
    """

    fname: str
    args: tuple[PhysicalExpr, ...]
    out_type: pa.DataType = field(default_factory=pa.float64)

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        from ..udf import global_registry

        u = global_registry().scalar(self.fname)
        if u is None:
            raise ExecutionError(
                f"scalar UDF {self.fname!r} is not registered on this "
                f"executor; load it via ballista.plugin_dir"
            )
        args = [_as_array_len(x.evaluate(batch), batch.num_rows) for x in self.args]
        out = u.fn(*args)
        if not isinstance(out, (pa.Array, pa.ChunkedArray)):
            out = pa.array(out, type=self.out_type)
        if isinstance(out, pa.ChunkedArray):
            out = out.combine_chunks()
        if len(out) != batch.num_rows:
            # a UDF that mis-sizes its output would silently corrupt row
            # alignment downstream (round-1 advisor finding)
            raise ExecutionError(
                f"scalar UDF {self.fname!r} returned {len(out)} rows for a "
                f"{batch.num_rows}-row batch"
            )
        if not out.type.equals(self.out_type):
            out = pc.cast(out, self.out_type, safe=False)
        return out

    def __str__(self) -> str:
        return f"{self.fname}({', '.join(str(a) for a in self.args)})"


def _as_array_len(v, n: int) -> pa.Array:
    if isinstance(v, pa.ChunkedArray):
        return v.combine_chunks()
    if isinstance(v, pa.Array):
        return v
    if isinstance(v, pa.Scalar):
        return pa.array([v.as_py()] * n, type=v.type)
    return pa.array([v] * n)


@dataclass(frozen=True)
class ScalarFn(PhysicalExpr):
    fname: str
    args: tuple[PhysicalExpr, ...]
    out_type: pa.DataType = field(default_factory=pa.float64)

    def evaluate(self, batch: pa.RecordBatch) -> pa.Array:
        f = self.fname
        a = [x.evaluate(batch) for x in self.args]
        if f == "abs":
            return pc.abs(a[0])
        if f == "ceil":
            return pc.ceil(a[0])
        if f == "floor":
            return pc.floor(a[0])
        if f == "round":
            ndigits = a[1].as_py() if len(a) > 1 else 0
            return pc.round(a[0], ndigits=ndigits)
        if f == "sqrt":
            return pc.sqrt(a[0])
        if f == "exp":
            return pc.exp(a[0])
        if f == "ln":
            return pc.ln(a[0])
        if f == "log10":
            return pc.log10(a[0])
        if f == "log2":
            return pc.log2(a[0])
        if f == "power":
            return pc.power(a[0], a[1])
        if f in ("sin", "cos", "tan"):
            return getattr(pc, f)(a[0])
        if f == "signum":
            return pc.sign(a[0])
        if f == "lower":
            return pc.utf8_lower(a[0])
        if f == "upper":
            return pc.utf8_upper(a[0])
        if f == "trim" or f == "btrim":
            return pc.utf8_trim_whitespace(a[0])
        if f == "ltrim":
            return pc.utf8_ltrim_whitespace(a[0])
        if f == "rtrim":
            return pc.utf8_rtrim_whitespace(a[0])
        if f in ("length", "char_length"):
            return pc.utf8_length(a[0])
        if f in ("substr", "substring"):
            start = a[1].as_py() - 1  # SQL is 1-based
            if len(a) > 2:
                return pc.utf8_slice_codeunits(a[0], start, start + a[2].as_py())
            return pc.utf8_slice_codeunits(a[0], start)
        if f == "concat":
            return pc.binary_join_element_wise(
                *[pc.cast(x, pa.string()) for x in a], ""
            )
        if f == "replace":
            return pc.replace_substring(a[0], pattern=a[1].as_py(), replacement=a[2].as_py())
        if f == "starts_with":
            return pc.starts_with(a[0], pattern=a[1].as_py())
        if f == "strpos":
            return pc.add(pc.find_substring(a[0], pattern=a[1].as_py()), 1)
        if f == "left":
            return pc.utf8_slice_codeunits(a[0], 0, a[1].as_py())
        if f == "right":
            n = a[1].as_py()
            return pc.utf8_slice_codeunits(a[0], -n)
        if f == "repeat":
            return pc.binary_repeat(a[0], a[1].as_py())
        if f == "reverse":
            return pc.utf8_reverse(a[0])
        if f == "ascii":
            raise NotImplementedYet("ascii()")
        if f in ("lpad", "rpad"):
            pad = a[2].as_py() if len(a) > 2 else " "
            fn = pc.utf8_lpad if f == "lpad" else pc.utf8_rpad
            return fn(a[0], width=a[1].as_py(), padding=pad)
        if f == "initcap":
            return pc.utf8_capitalize(a[0])
        if f == "split_part":
            parts = pc.split_pattern(a[0], pattern=a[1].as_py())
            return pc.list_element(parts, a[2].as_py() - 1)
        if f == "date_part" or f == "extract":
            part = a[0].as_py()
            v = a[1]
            if pa.types.is_date(v.type) or pa.types.is_timestamp(v.type):
                fn = {"year": pc.year, "month": pc.month, "day": pc.day,
                      "hour": pc.hour, "minute": pc.minute, "second": pc.second,
                      "quarter": pc.quarter, "week": pc.iso_week,
                      "dow": pc.day_of_week, "doy": pc.day_of_year}.get(part)
                if fn is None:
                    raise NotImplementedYet(f"date_part({part!r})")
                return pc.cast(fn(v), pa.int64())
            raise ExecutionError(f"date_part on non-temporal {v.type}")
        if f == "date_trunc":
            unit = a[0].as_py()
            ts = pc.floor_temporal(pc.cast(a[1], pa.timestamp("us")), unit=unit)
            if unit in ("day", "week", "month", "quarter", "year"):
                return pc.cast(ts, pa.date32())
            return ts  # sub-day truncation keeps the time component
        if f == "to_timestamp":
            return pc.cast(a[0], pa.timestamp("us"))
        if f == "now":
            return pa.scalar(_dt.datetime.utcnow(), pa.timestamp("us"))
        if f == "coalesce":
            return pc.coalesce(*a)
        if f == "nullif":
            eq = pc.equal(a[0], a[1])
            return pc.if_else(eq, pa.nulls(len(a[0]) if hasattr(a[0], "__len__") else 1, a[0].type), a[0])
        raise NotImplementedYet(f"scalar function {f!r}")

    def children(self) -> list[PhysicalExpr]:
        return list(self.args)

    def __str__(self) -> str:
        return f"{self.fname}({', '.join(map(str, self.args))})"


# --------------------------------------------------------------- lowering
def create_physical_expr(e: lex.Expr, schema: pa.Schema) -> PhysicalExpr:
    """Lower a logical expression to a physical one against ``schema``."""
    if isinstance(e, lex.Alias):
        return create_physical_expr(e.expr, schema)
    if isinstance(e, lex.Column):
        idx = e.resolve_index(schema)
        return Col(idx, schema.field(idx).name)
    if isinstance(e, lex.Literal):
        return Lit(e.value, e.dtype)
    if isinstance(e, lex.IntervalLiteral):
        return IntervalLit(e.months, e.days)
    if isinstance(e, lex.BinaryExpr):
        return Binary(
            create_physical_expr(e.left, schema), e.op, create_physical_expr(e.right, schema)
        )
    if isinstance(e, lex.NotExpr):
        return Not(create_physical_expr(e.expr, schema))
    if isinstance(e, lex.NegativeExpr):
        return Negative(create_physical_expr(e.expr, schema))
    if isinstance(e, lex.IsNullExpr):
        return IsNull(create_physical_expr(e.expr, schema), e.negated)
    if isinstance(e, lex.BetweenExpr):
        operand = create_physical_expr(e.expr, schema)
        low = create_physical_expr(e.low, schema)
        high = create_physical_expr(e.high, schema)
        rng = Binary(Binary(operand, ">=", low), "AND", Binary(operand, "<=", high))
        return Not(rng) if e.negated else rng
    if isinstance(e, lex.InListExpr):
        vals = []
        for item in e.items:
            if not isinstance(item, lex.Literal):
                raise NotImplementedYet("IN list with non-literal items")
            vals.append(item.value)
        return InList(create_physical_expr(e.expr, schema), tuple(vals), e.negated)
    if isinstance(e, lex.LikeExpr):
        if not isinstance(e.pattern, lex.Literal):
            raise NotImplementedYet("LIKE with non-literal pattern")
        return Like(create_physical_expr(e.expr, schema), e.pattern.value, e.negated)
    if isinstance(e, lex.CaseExpr):
        out_type = e.data_type(schema)
        whens = []
        for w, t in e.whens:
            cond = (
                lex.BinaryExpr(e.operand, "=", w) if e.operand is not None else w
            )
            whens.append(
                (create_physical_expr(cond, schema), create_physical_expr(t, schema))
            )
        else_e = (
            create_physical_expr(e.else_expr, schema) if e.else_expr is not None else None
        )
        return Case(tuple(whens), else_e, out_type)
    if isinstance(e, lex.CastExpr):
        return Cast(create_physical_expr(e.expr, schema), e.to_type)
    if isinstance(e, lex.ScalarFunction):
        return ScalarFn(
            e.fname,
            tuple(create_physical_expr(a, schema) for a in e.args),
            e.data_type(schema),
        )
    if isinstance(e, lex.ScalarUDFExpr):
        return ScalarUdf(
            e.fname,
            tuple(create_physical_expr(a, schema) for a in e.args),
            e.return_type,
        )
    if isinstance(e, lex.AggregateExpr):
        raise PlanError(f"aggregate {e} cannot be lowered as a scalar physical expr")
    if isinstance(e, lex.ScalarSubqueryExpr):
        raise PlanError("scalar subquery must be materialized before physical lowering")
    raise PlanError(f"cannot lower expression {e!r}")
