"""Expression tree ⇄ protobuf conversion (logical and physical).

Counterpart of the reference's ``core/src/serde/physical_plan/
{from_proto,to_proto}.rs`` expression sections and the DataFusion logical
expr serde.  One ``ExprNode`` message serves both trees: logical columns
carry names, physical columns carry resolved indices.
"""

from __future__ import annotations

from typing import Optional

import pyarrow as pa

from ..errors import PlanError
from ..exec import expressions as pex
from ..plan import expressions as lex
from ..proto import pb
from .arrow_utils import (
    array_from_ipc,
    array_to_ipc,
    dtype_from_bytes,
    dtype_to_bytes,
    value_from_ipc,
    value_to_ipc,
)

# ---------------------------------------------------------------------------
# physical expressions
# ---------------------------------------------------------------------------


def physical_expr_to_proto(e: pex.PhysicalExpr) -> pb.ExprNode:
    n = pb.ExprNode()
    if isinstance(e, pex.Col):
        n.column.name = e.colname
        n.column.index = e.index
        return n
    if isinstance(e, pex.Lit):
        untyped = pa.types.is_null(e.dtype) and e.value is not None
        n.literal.ipc_value = value_to_ipc(
            e.value, None if untyped else e.dtype
        )
        n.literal.untyped = untyped
        return n
    if isinstance(e, pex.IntervalLit):
        n.interval.months = e.months
        n.interval.days = e.days
        return n
    if isinstance(e, pex.Binary):
        n.binary.left.CopyFrom(physical_expr_to_proto(e.left))
        n.binary.op = e.op
        n.binary.right.CopyFrom(physical_expr_to_proto(e.right))
        return n
    if isinstance(e, pex.Not):
        n.logical_not.expr.CopyFrom(physical_expr_to_proto(e.expr))
        return n
    if isinstance(e, pex.Negative):
        n.negative.expr.CopyFrom(physical_expr_to_proto(e.expr))
        return n
    if isinstance(e, pex.IsNull):
        n.is_null.expr.CopyFrom(physical_expr_to_proto(e.expr))
        n.is_null.negated = e.negated
        return n
    if isinstance(e, pex.InList):
        n.in_list.expr.CopyFrom(physical_expr_to_proto(e.expr))
        n.in_list.ipc_items = array_to_ipc(e.items)
        n.in_list.negated = e.negated
        return n
    if isinstance(e, pex.Like):
        n.like.expr.CopyFrom(physical_expr_to_proto(e.expr))
        n.like.pattern_str = e.pattern
        n.like.negated = e.negated
        return n
    if isinstance(e, pex.Case):
        n.case_expr.SetInParent()
        for w, t in e.whens:
            wt = n.case_expr.whens.add()
            wt.when.CopyFrom(physical_expr_to_proto(w))
            wt.then.CopyFrom(physical_expr_to_proto(t))
        if e.else_expr is not None:
            n.case_expr.else_expr.CopyFrom(physical_expr_to_proto(e.else_expr))
            n.case_expr.has_else = True
        n.case_expr.out_type = dtype_to_bytes(e.out_type)
        return n
    if isinstance(e, pex.Cast):
        n.cast.expr.CopyFrom(physical_expr_to_proto(e.expr))
        n.cast.to_type = dtype_to_bytes(e.to_type)
        return n
    if isinstance(e, pex.ScalarFn):
        n.scalar_fn.fname = e.fname
        for a in e.args:
            n.scalar_fn.args.add().CopyFrom(physical_expr_to_proto(a))
        n.scalar_fn.out_type = dtype_to_bytes(e.out_type)
        return n
    if isinstance(e, pex.ScalarUdf):
        n.udf.name = e.fname
        for a in e.args:
            n.udf.args.add().CopyFrom(physical_expr_to_proto(a))
        n.udf.out_type = dtype_to_bytes(e.out_type)
        return n
    raise PlanError(f"cannot serialize physical expr {type(e).__name__}")


def physical_expr_from_proto(n: pb.ExprNode) -> pex.PhysicalExpr:
    kind = n.WhichOneof("expr")
    if kind == "column":
        return pex.Col(n.column.index, n.column.name)
    if kind == "literal":
        value, dtype = value_from_ipc(n.literal.ipc_value)
        return pex.Lit(value, pa.null() if n.literal.untyped else dtype)
    if kind == "interval":
        return pex.IntervalLit(n.interval.months, n.interval.days)
    if kind == "binary":
        return pex.Binary(
            physical_expr_from_proto(n.binary.left),
            n.binary.op,
            physical_expr_from_proto(n.binary.right),
        )
    if kind == "logical_not":
        return pex.Not(physical_expr_from_proto(n.logical_not.expr))
    if kind == "negative":
        return pex.Negative(physical_expr_from_proto(n.negative.expr))
    if kind == "is_null":
        return pex.IsNull(physical_expr_from_proto(n.is_null.expr), n.is_null.negated)
    if kind == "in_list":
        items = tuple(array_from_ipc(n.in_list.ipc_items).to_pylist())
        return pex.InList(
            physical_expr_from_proto(n.in_list.expr), items, n.in_list.negated
        )
    if kind == "like":
        return pex.Like(
            physical_expr_from_proto(n.like.expr), n.like.pattern_str, n.like.negated
        )
    if kind == "case_expr":
        whens = tuple(
            (physical_expr_from_proto(w.when), physical_expr_from_proto(w.then))
            for w in n.case_expr.whens
        )
        else_e = (
            physical_expr_from_proto(n.case_expr.else_expr)
            if n.case_expr.has_else
            else None
        )
        return pex.Case(whens, else_e, dtype_from_bytes(n.case_expr.out_type))
    if kind == "cast":
        return pex.Cast(
            physical_expr_from_proto(n.cast.expr), dtype_from_bytes(n.cast.to_type)
        )
    if kind == "scalar_fn":
        return pex.ScalarFn(
            n.scalar_fn.fname,
            tuple(physical_expr_from_proto(a) for a in n.scalar_fn.args),
            dtype_from_bytes(n.scalar_fn.out_type),
        )
    if kind == "udf":
        return pex.ScalarUdf(
            n.udf.name,
            tuple(physical_expr_from_proto(a) for a in n.udf.args),
            dtype_from_bytes(n.udf.out_type),
        )
    raise PlanError(f"cannot deserialize physical expr node {kind!r}")


# ---------------------------------------------------------------------------
# logical expressions
# ---------------------------------------------------------------------------


def _frame_to_proto(frame: tuple, node) -> None:
    start, end = frame
    if start is None:
        node.start_unbounded = True
    else:
        node.start = start
    if end is None:
        node.end_unbounded = True
    else:
        node.end = end


def _frame_from_proto(node) -> tuple:
    return (
        None if node.start_unbounded else node.start,
        None if node.end_unbounded else node.end,
    )


def logical_expr_to_proto(e: lex.Expr) -> pb.ExprNode:
    n = pb.ExprNode()
    if isinstance(e, lex.Column):
        n.column.name = e.cname
        n.column.qualifier = e.qualifier or ""
        n.column.index = -1
        return n
    if isinstance(e, lex.Literal):
        untyped = pa.types.is_null(e.dtype) and e.value is not None
        n.literal.ipc_value = value_to_ipc(e.value, None if untyped else e.dtype)
        n.literal.untyped = untyped
        return n
    if isinstance(e, lex.IntervalLiteral):
        n.interval.months = e.months
        n.interval.days = e.days
        return n
    if isinstance(e, lex.Alias):
        n.alias.expr.CopyFrom(logical_expr_to_proto(e.expr))
        n.alias.alias = e.alias_name
        return n
    if isinstance(e, lex.BinaryExpr):
        n.binary.left.CopyFrom(logical_expr_to_proto(e.left))
        n.binary.op = e.op
        n.binary.right.CopyFrom(logical_expr_to_proto(e.right))
        return n
    if isinstance(e, lex.NotExpr):
        n.logical_not.expr.CopyFrom(logical_expr_to_proto(e.expr))
        return n
    if isinstance(e, lex.NegativeExpr):
        n.negative.expr.CopyFrom(logical_expr_to_proto(e.expr))
        return n
    if isinstance(e, lex.IsNullExpr):
        n.is_null.expr.CopyFrom(logical_expr_to_proto(e.expr))
        n.is_null.negated = e.negated
        return n
    if isinstance(e, lex.BetweenExpr):
        n.between.expr.CopyFrom(logical_expr_to_proto(e.expr))
        n.between.low.CopyFrom(logical_expr_to_proto(e.low))
        n.between.high.CopyFrom(logical_expr_to_proto(e.high))
        n.between.negated = e.negated
        return n
    if isinstance(e, lex.InListExpr):
        n.in_list.expr.CopyFrom(logical_expr_to_proto(e.expr))
        for item in e.items:
            n.in_list.items.add().CopyFrom(logical_expr_to_proto(item))
        n.in_list.negated = e.negated
        return n
    if isinstance(e, lex.LikeExpr):
        n.like.expr.CopyFrom(logical_expr_to_proto(e.expr))
        n.like.pattern.CopyFrom(logical_expr_to_proto(e.pattern))
        n.like.negated = e.negated
        return n
    if isinstance(e, lex.CaseExpr):
        n.case_expr.SetInParent()
        if e.operand is not None:
            n.case_expr.operand.CopyFrom(logical_expr_to_proto(e.operand))
            n.case_expr.has_operand = True
        for w, t in e.whens:
            wt = n.case_expr.whens.add()
            wt.when.CopyFrom(logical_expr_to_proto(w))
            wt.then.CopyFrom(logical_expr_to_proto(t))
        if e.else_expr is not None:
            n.case_expr.else_expr.CopyFrom(logical_expr_to_proto(e.else_expr))
            n.case_expr.has_else = True
        return n
    if isinstance(e, lex.CastExpr):
        n.cast.expr.CopyFrom(logical_expr_to_proto(e.expr))
        n.cast.to_type = dtype_to_bytes(e.to_type)
        return n
    if isinstance(e, lex.ScalarFunction):
        n.scalar_fn.fname = e.fname
        for a in e.args:
            n.scalar_fn.args.add().CopyFrom(logical_expr_to_proto(a))
        return n
    if isinstance(e, lex.ScalarUDFExpr):
        n.udf.name = e.fname
        for a in e.args:
            n.udf.args.add().CopyFrom(logical_expr_to_proto(a))
        n.udf.out_type = dtype_to_bytes(e.return_type)
        return n
    if isinstance(e, lex.AggregateExpr):
        n.aggregate.func = e.func
        if e.arg is not None:
            n.aggregate.arg.CopyFrom(logical_expr_to_proto(e.arg))
            n.aggregate.has_arg = True
        if e.arg2 is not None:
            n.aggregate.arg2.CopyFrom(logical_expr_to_proto(e.arg2))
            n.aggregate.has_arg2 = True
        n.aggregate.distinct = e.distinct
        if e.func.startswith("udaf:"):
            # ship the return type: the scheduler may not have the UDAF
            t = e.udaf_type
            if t is None:
                t = e.data_type(pa.schema([]))
            n.aggregate.udaf_out_type = dtype_to_bytes(t)
        return n
    if isinstance(e, lex.WindowExpr):
        n.window.func = e.func
        n.window.offset = e.offset
        if e.frame is not None:
            _frame_to_proto(e.frame, n.window.frame)
        if e.arg is not None:
            n.window.arg.CopyFrom(logical_expr_to_proto(e.arg))
            n.window.has_arg = True
        for p in e.partition_by:
            n.window.partition_by.add().CopyFrom(logical_expr_to_proto(p))
        for s in e.order_by:
            so = n.window.order_by.add()
            so.expr.CopyFrom(logical_expr_to_proto(s.expr))
            so.asc = s.asc
            so.nulls_first = (
                0 if s.nulls_first is None else (1 if s.nulls_first else 2)
            )
        return n
    if isinstance(e, lex.SortExpr):
        n.sort.expr.CopyFrom(logical_expr_to_proto(e.expr))
        n.sort.asc = e.asc
        n.sort.nulls_first = (
            0 if e.nulls_first is None else (1 if e.nulls_first else 2)
        )
        return n
    if isinstance(e, lex.ScalarSubqueryExpr):
        from .logical_plan import logical_plan_to_proto

        n.scalar_subquery.plan.CopyFrom(logical_plan_to_proto(e.plan))
        return n
    raise PlanError(f"cannot serialize logical expr {type(e).__name__}")


def logical_expr_from_proto(n: pb.ExprNode) -> lex.Expr:
    kind = n.WhichOneof("expr")
    if kind == "column":
        return lex.Column(n.column.name, n.column.qualifier or None)
    if kind == "literal":
        value, dtype = value_from_ipc(n.literal.ipc_value)
        return lex.Literal(value, pa.null() if n.literal.untyped else dtype)
    if kind == "interval":
        return lex.IntervalLiteral(n.interval.months, n.interval.days)
    if kind == "alias":
        return lex.Alias(logical_expr_from_proto(n.alias.expr), n.alias.alias)
    if kind == "binary":
        return lex.BinaryExpr(
            logical_expr_from_proto(n.binary.left),
            n.binary.op,
            logical_expr_from_proto(n.binary.right),
        )
    if kind == "logical_not":
        return lex.NotExpr(logical_expr_from_proto(n.logical_not.expr))
    if kind == "negative":
        return lex.NegativeExpr(logical_expr_from_proto(n.negative.expr))
    if kind == "is_null":
        return lex.IsNullExpr(
            logical_expr_from_proto(n.is_null.expr), n.is_null.negated
        )
    if kind == "between":
        return lex.BetweenExpr(
            logical_expr_from_proto(n.between.expr),
            logical_expr_from_proto(n.between.low),
            logical_expr_from_proto(n.between.high),
            n.between.negated,
        )
    if kind == "in_list":
        return lex.InListExpr(
            logical_expr_from_proto(n.in_list.expr),
            tuple(logical_expr_from_proto(i) for i in n.in_list.items),
            n.in_list.negated,
        )
    if kind == "like":
        return lex.LikeExpr(
            logical_expr_from_proto(n.like.expr),
            logical_expr_from_proto(n.like.pattern),
            n.like.negated,
        )
    if kind == "case_expr":
        operand = (
            logical_expr_from_proto(n.case_expr.operand)
            if n.case_expr.has_operand
            else None
        )
        whens = tuple(
            (logical_expr_from_proto(w.when), logical_expr_from_proto(w.then))
            for w in n.case_expr.whens
        )
        else_e = (
            logical_expr_from_proto(n.case_expr.else_expr)
            if n.case_expr.has_else
            else None
        )
        return lex.CaseExpr(operand, whens, else_e)
    if kind == "cast":
        return lex.CastExpr(
            logical_expr_from_proto(n.cast.expr), dtype_from_bytes(n.cast.to_type)
        )
    if kind == "scalar_fn":
        return lex.ScalarFunction(
            n.scalar_fn.fname,
            tuple(logical_expr_from_proto(a) for a in n.scalar_fn.args),
        )
    if kind == "udf":
        return lex.ScalarUDFExpr(
            n.udf.name,
            tuple(logical_expr_from_proto(a) for a in n.udf.args),
            dtype_from_bytes(n.udf.out_type),
        )
    if kind == "aggregate":
        arg = (
            logical_expr_from_proto(n.aggregate.arg) if n.aggregate.has_arg else None
        )
        udaf_type = (
            dtype_from_bytes(n.aggregate.udaf_out_type)
            if n.aggregate.udaf_out_type
            else None
        )
        arg2 = (
            logical_expr_from_proto(n.aggregate.arg2)
            if n.aggregate.has_arg2
            else None
        )
        return lex.AggregateExpr(
            n.aggregate.func, arg, n.aggregate.distinct,
            udaf_type=udaf_type, arg2=arg2,
        )
    if kind == "window":
        warg = (
            logical_expr_from_proto(n.window.arg) if n.window.has_arg else None
        )
        parts = tuple(
            logical_expr_from_proto(p) for p in n.window.partition_by
        )
        orders = tuple(
            lex.SortExpr(
                logical_expr_from_proto(s.expr),
                s.asc,
                None if s.nulls_first == 0 else s.nulls_first == 1,
            )
            for s in n.window.order_by
        )
        return lex.WindowExpr(
            n.window.func, warg, parts, orders, n.window.offset,
            _frame_from_proto(n.window.frame)
            if n.window.HasField("frame")
            else None,
        )
    if kind == "sort":
        nf: Optional[bool] = (
            None if n.sort.nulls_first == 0 else n.sort.nulls_first == 1
        )
        return lex.SortExpr(logical_expr_from_proto(n.sort.expr), n.sort.asc, nf)
    if kind == "scalar_subquery":
        from .logical_plan import logical_plan_from_proto

        return lex.ScalarSubqueryExpr(logical_plan_from_proto(n.scalar_subquery.plan))
    raise PlanError(f"cannot deserialize logical expr node {kind!r}")
