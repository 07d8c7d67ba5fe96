"""PyTorch lowering of physical expressions + the segment-aggregate kernels.

Counterpart of ``arrow_ballista_tpu/ops/kernels.py`` for one CUDA device.
The eligible stage subtree (filter → project → partial aggregate) runs per
batch as one launch of the hand-written expression kernel
(``ops/cuda/expr_eval.cu``: the filter and arguments compiled once into a
register program from the expression closures, which XLA inlined into one
program on the reference) followed by
the hand-written segment aggregate that folds the masks, reduces per group
and merges into the running state: the scatter route
(``ops/cuda/segment_agg.cu``) or, at large capacity on cuda, the sort
route (``ops/cuda/radix_sort.cu`` + ``ops/cuda/seg_scan.cu``, which the
window kernel shares).  A join-fused stage first probes the build side on
the device (``ops/cuda/join_probe.cu``) and folds the misses into the row
mask.  The keyed route assigns group ids on the device instead of the
host: key encode and group ids (``ops/cuda/keyed_gids.cu``) around the
radix sort, the segmented scan into the state and the key gather
(``keyed_finish.cu``), and the median (``keyed_median.cu``) and corr
(``keyed_corr.cu``) passes over the same sort.  A stage that retains its
batches (the column cache, whole-stage fusion) folds them all in one
multi-entry launch of the segment aggregate
(``ops/cuda/segment_agg_entries.cu``), bit-identical to one launch per
batch.

Design rules:
* x64 only — f64/i64 device dtypes (the H100 has both); every tensor the
  port builds names its dtype, so torch's float32 default never leaks in;
* group-by runs over host-assigned dense group ids into a fixed-capacity
  state that grows in 4x steps with identity padding;
* nulls ride as separate validity masks and fold into the row mask; an
  all-valid companion is ``None`` and costs no bytes or loads;
* strings never reach the device — the ``NotLowerable`` boundary is the
  reference's.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import pyarrow as pa
import torch

from ..errors import ExecutionError
from ..exec import expressions as pe
from .bridge import arrow_to_numpy

# The port's one dtype mode is the reference's "x64": f64 values, i64
# integers (x32 is not ported).
F64 = torch.float64
I64 = torch.int64

# env key under which the stage's torch.device travels to the closures
# (literal constants are materialised on it)
DEVICE = "__device__"

# A lowered node evaluates to (value, validity-or-None) in a leaf env.
TorchClosure = Callable[[dict], tuple[torch.Tensor, Optional[torch.Tensor]]]

# reserved NaN payloads standing for NULL in float group-key codes (the
# keyed route's encoders in ops/bridge.py)
FLOAT32_NULL_BITS = 0xFFC00001 - (1 << 32)  # as signed i32
FLOAT64_NULL_BITS = 0xFFF8000000000001 - (1 << 64)  # as signed i64


class NotLowerable(Exception):
    """Subtree cannot run on device (string compute, unsupported fn)."""


@dataclass
class LeafSpec:
    """One host-supplied input array of the stage.

    Kinds: "column" (value + validity), "cpu_expr" (host-evaluated value +
    validity), "column_validity" (validity ONLY — count(col) never needs
    the values), "column_ord_pair" (the value as an order-preserving
    (hi, lo) int32 pair + validity: the keyed median's sort operand),
    "join_col" (a build-side column of a folded device join: gathered on
    the device by :func:`join_probe`, never read from the probe batch).
    """

    name: str
    kind: str  # "column" | "cpu_expr" | "column_validity" | "column_ord_pair" | "join_col"
    col_index: int = -1
    cpu_expr: Optional[pe.PhysicalExpr] = None


@dataclass
class CompiledExpr:
    closure: TorchClosure
    leaves: dict[str, LeafSpec] = field(default_factory=dict)


def _pa_to_torch_dtype(t: pa.DataType) -> torch.dtype:
    if pa.types.is_floating(t) or pa.types.is_decimal(t):
        return F64
    if pa.types.is_boolean(t):
        return torch.bool
    return I64


def _const(value, dtype: torch.dtype) -> Callable[[dict], torch.Tensor]:
    """A constant tensor materialised once per device it is asked for."""
    cache: dict = {}

    def get(env: dict) -> torch.Tensor:
        dev = env[DEVICE]
        t = cache.get(dev)
        if t is None:
            t = cache[dev] = torch.tensor(value, dtype=dtype).to(dev)
        return t

    return get


@dataclass(frozen=True)
class ExprNode:
    """The typed twin of one lowered closure, which :class:`ExprProgram`
    compiles: ``op`` (an :data:`EXPR_OPS` name before linearisation, or
    "div"/"mod" resolved to their int or float form here), the static
    value dtype (bool, int64 or float64; None for a validity-only leaf),
    the argument nodes and a constant: a leaf's (value, validity) env
    names, a literal's int64 bit pattern, an IN list's (dtype, bit
    patterns), whether a CASE has an ELSE, or an "error" node's message
    (an operation torch refuses, raised when the program is built, where
    the closure raises when it runs).  Equal nodes compute equal values."""

    op: str
    dtype: Optional[torch.dtype]
    args: tuple = ()
    const: object = None


def _with_node(closure: TorchClosure, node: ExprNode) -> TorchClosure:
    closure.node = node
    return closure


def _bits(value, dtype: torch.dtype) -> int:
    """The int64 bit pattern of a literal of ``dtype``."""
    if dtype == F64:
        return int(np.array(value, np.float64).view(np.int64))
    return int(value)


_BINARY_OPS = {
    "=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge",
    "+": "add", "-": "sub", "*": "mul",
}
_ARITH = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}
_BOOL_OPS = ("and", "or", "not", "is_null", "is_not_null",
             "eq", "ne", "lt", "le", "gt", "ge")


def _node(op: str, *closures) -> ExprNode:
    """The node of an operation over the closures' nodes, its dtype decided
    as the closure's torch calls decide it."""
    args = tuple(c.node for c in closures)
    err = next((a for a in args if a.op == "error"), None)
    if err is not None:
        return err
    if op in _BOOL_OPS:
        return ExprNode(op, torch.bool, args)
    if op in ("div", "mod"):  # both int64 (bool is not): truncating / floor
        ints = all(a.dtype == I64 for a in args)
        return ExprNode(f"{op}_int" if ints else f"{op}_f", I64 if ints else F64, args)
    if op in ("add", "sub", "mul", "neg"):
        zeros = [torch.zeros((), dtype=a.dtype) for a in args]
        try:
            if op == "neg":
                dtype = (-zeros[0]).dtype
            else:
                dtype = _ARITH[op](*_numeric_align(*zeros)).dtype
        except RuntimeError as exc:  # bool - bool, -bool
            return ExprNode("error", None, args, str(exc))
        return ExprNode(op, dtype, args)
    return ExprNode(op, F64, args)  # the float functions, power, round, square


def _in_node(f: TorchClosure, items, all_int: bool, negated: bool) -> ExprNode:
    """IN / NOT IN: the table in the dtype the closure compares in."""
    child = f.node
    if child.op == "error":
        return child
    try:
        if all_int:
            table = torch.tensor(list(items), dtype=I64)
            if child.dtype != I64:
                table = table.to(F64)
        else:
            table = torch.tensor([_to_num(i) for i in items], dtype=F64)
    except (RuntimeError, OverflowError) as exc:
        return ExprNode("error", None, (child,), str(exc))
    bits = tuple(table.view(I64).tolist())
    return ExprNode("not_in" if negated else "in", torch.bool, (child,),
                    (table.dtype, bits))


def _cast_node(child: ExprNode, dt: torch.dtype) -> ExprNode:
    """CAST as :func:`_cast` does it: float → int64 saturates, a cast to the
    same dtype is the value itself, the rest is ``.to``."""
    if child.op == "error" or dt == child.dtype:
        return child
    if dt == I64 and child.dtype == F64:
        return ExprNode("cast_i64", I64, (child,))
    return ExprNode("convert", dt, (child,))


class TorchExprCompiler:
    """Lower PhysicalExpr trees to torch closures over a shared leaf env.

    Counterpart of the reference's ``JaxExprCompiler``: any subtree that
    cannot lower (LIKE, string functions, …) but whose OUTPUT is
    device-friendly becomes a ``cpu_expr`` leaf evaluated by pyarrow per
    batch and shipped beside the raw columns.  Every closure carries its
    typed :class:`ExprNode` (``closure.node``), which a stage compiles into
    an :class:`ExprProgram`; the closures are the program's specification.
    """

    def __init__(self, schema: pa.Schema):
        self.schema = schema
        self.leaves: dict[str, LeafSpec] = {}

    def compile(self, expr: pe.PhysicalExpr) -> CompiledExpr:
        closure = self._lower_or_leaf(expr)
        return CompiledExpr(closure, self.leaves)

    # ------------------------------------------------------------ helpers
    def _leaf_column(self, e: pe.Col) -> TorchClosure:
        t = self.schema.field(e.index).type
        # keep in sync with bridge._is_device_friendly — anything accepted
        # here must actually cross the bridge at runtime.  uint64 stays on
        # the host: its values past 2^63 have no int64 image
        if pa.types.is_uint64(t) or not (
            pa.types.is_integer(t)
            or pa.types.is_floating(t)
            or pa.types.is_boolean(t)
            or pa.types.is_date(t)
            or pa.types.is_timestamp(t)
        ):
            raise NotLowerable(f"column {e.colname}: type {t}")
        name = f"col_{e.index}"
        self.leaves[name] = LeafSpec(name, "column", col_index=e.index)
        vname = f"{name}__valid"

        def run(env: dict):
            return env[name], env[vname]

        return _with_node(run, ExprNode("leaf", _pa_to_torch_dtype(t), (), (name, vname)))

    def validity_only(self, e: pe.Col) -> TorchClosure:
        """Leaf that ships ONLY the validity mask of a column (count(col))."""
        name = f"col_{e.index}__validonly"
        self.leaves[name] = LeafSpec(name, "column_validity", col_index=e.index)
        vname = f"{name}__valid"

        def run(env: dict):
            return None, env[vname]

        return _with_node(run, ExprNode("leaf", None, (), (None, vname)))

    def ord_pair_column(self, e: pe.Col) -> TorchClosure:
        """Leaf that ships a numeric column as an order-preserving (hi, lo)
        int32 pair (``bridge.to_u64_order`` of its f64 value, split by
        ``bridge.split_u64_i32``): lexicographic integer order is the f64
        order, so the keyed median sorts it and decodes the middle rows
        exactly."""
        name = f"col_{e.index}__ordpair"
        self.leaves[name] = LeafSpec(name, "column_ord_pair", col_index=e.index)
        vname = f"{name}__valid"

        def run(env: dict):
            return (env[f"{name}__ohi"], env[f"{name}__olo"]), env[vname]

        return run

    def _cpu_leaf(self, e: pe.PhysicalExpr) -> TorchClosure:
        out_t = _infer_pa_type(e, self.schema)
        if pa.types.is_uint64(out_t) or not (
            pa.types.is_boolean(out_t)
            or pa.types.is_integer(out_t)
            or pa.types.is_floating(out_t)
            or pa.types.is_date(out_t)
        ):
            raise NotLowerable(f"cpu-leaf output type {out_t} for {e}")
        name = f"cpu_{len(self.leaves)}"
        self.leaves[name] = LeafSpec(name, "cpu_expr", cpu_expr=e)
        vname = f"{name}__valid"

        def run(env: dict):
            return env[name], env[vname]

        return _with_node(
            run, ExprNode("leaf", _pa_to_torch_dtype(out_t), (), (name, vname))
        )

    def _lower_or_leaf(self, e: pe.PhysicalExpr) -> TorchClosure:
        try:
            return self._lower(e)
        except NotLowerable:
            return self._cpu_leaf(e)

    # ------------------------------------------------------------ lowering
    def _lower(self, e: pe.PhysicalExpr) -> TorchClosure:
        if isinstance(e, pe.Col):
            return self._leaf_column(e)

        if isinstance(e, pe.Lit):
            v = e.value
            if v is None:
                raise NotLowerable("null literal")
            if isinstance(v, bool):
                dtype, value = torch.bool, v
            elif isinstance(v, int):
                if not -(2**63) <= v < 2**63:
                    raise NotLowerable(f"int literal {v} exceeds i64")
                dtype, value = I64, v
            elif isinstance(v, float):
                dtype, value = F64, v
            elif _is_date(v):
                dtype, value = I64, _days(v)
            else:
                raise NotLowerable(f"literal {v!r}")
            const = _const(value, dtype)
            return _with_node(
                lambda env: (const(env), None),
                ExprNode("lit", dtype, (), _bits(value, dtype)),
            )

        if isinstance(e, pe.Binary):
            op = e.op
            if op in ("AND", "OR"):
                lf, rf = self._lower_or_leaf(e.left), self._lower_or_leaf(e.right)

                def run_bool(env, lf=lf, rf=rf, op=op):
                    lv, lval = lf(env)
                    rv, rval = rf(env)
                    # Kleene: null treated as False for filter masks, which
                    # matches WHERE semantics (null predicate drops the row)
                    lv = lv if lval is None else torch.logical_and(lv, lval)
                    rv = rv if rval is None else torch.logical_and(rv, rval)
                    if op == "AND":
                        return torch.logical_and(lv, rv), None
                    return torch.logical_or(lv, rv), None

                return _with_node(run_bool, _node(op.lower(), lf, rf))
            lf, rf = self._lower(e.left), self._lower(e.right)
            fns = {
                "=": torch.eq, "<>": torch.ne, "<": torch.lt,
                "<=": torch.le, ">": torch.gt, ">=": torch.ge,
                "+": torch.add, "-": torch.sub, "*": torch.mul,
            }
            if op in fns:
                f = fns[op]

                def run_bin(env, lf=lf, rf=rf, f=f):
                    lv, lval = lf(env)
                    rv, rval = rf(env)
                    lv, rv = _numeric_align(lv, rv)
                    return f(lv, rv), _merge_valid(lval, rval)

                return _with_node(run_bin, _node(_BINARY_OPS[op], lf, rf))
            if op == "/":

                def run_div(env, lf=lf, rf=rf):
                    lv, lval = lf(env)
                    rv, rval = rf(env)
                    if _is_int(lv) and _is_int(rv):
                        return _trunc_div(lv, rv), _merge_valid(lval, rval)
                    return lv.to(F64) / rv.to(F64), _merge_valid(lval, rval)

                return _with_node(run_div, _node("div", lf, rf))
            if op == "%":

                def run_mod(env, lf=lf, rf=rf):
                    lv, lval = lf(env)
                    rv, rval = rf(env)
                    return _floor_mod(lv, rv), _merge_valid(lval, rval)

                return _with_node(run_mod, _node("mod", lf, rf))
            raise NotLowerable(f"binary op {op}")

        if isinstance(e, pe.Not):
            f = self._lower_or_leaf(e.expr)

            def run_not(env, f=f):
                v, val = f(env)
                v = v if val is None else torch.logical_and(v, val)
                return torch.logical_not(v), None

            return _with_node(run_not, _node("not", f))

        if isinstance(e, pe.Negative):
            f = self._lower(e.expr)

            def run_neg(env, f=f):
                v, val = f(env)
                return -v, val

            return _with_node(run_neg, _node("neg", f))

        if isinstance(e, pe.IsNull):
            f = self._lower_or_leaf(e.expr)
            negated = e.negated
            false = _const(False, torch.bool)

            def run_isnull(env, f=f, negated=negated):
                _, val = f(env)
                if val is None:
                    out = false(env)
                    return (torch.logical_not(out) if negated else out), None
                return (val if negated else torch.logical_not(val)), None

            return _with_node(
                run_isnull, _node("is_not_null" if negated else "is_null", f)
            )

        if isinstance(e, pe.InList):
            f = self._lower(e.expr)
            items = e.items
            if not all(isinstance(i, (int, float)) or _is_date(i) for i in items):
                raise NotLowerable("IN list with non-numeric items")
            # integer membership must compare in int64: casting an int64 id
            # to f64 loses precision above 2^53 and admits adjacent values
            all_int = all(
                isinstance(i, int) and not isinstance(i, bool) for i in items
            )
            consts = (
                _const(list(items), I64)
                if all_int
                else _const([_to_num(i) for i in items], F64)
            )
            negated = e.negated

            def run_in(env, f=f, consts=consts, negated=negated, all_int=all_int):
                v, val = f(env)
                rhs = consts(env)
                if all_int and _is_int(v):
                    lhs = v.to(I64)
                else:
                    lhs = v.to(F64)
                    rhs = rhs.to(F64)
                m = torch.eq(lhs[:, None], rhs[None, :]).any(dim=1)
                if negated:
                    m = torch.logical_not(m)
                return m, val

            return _with_node(run_in, _in_node(f, items, all_int, negated))

        if isinstance(e, pe.Case):
            whens = [
                (self._lower_or_leaf(w), self._lower(t)) for w, t in e.whens
            ]
            else_f = self._lower(e.else_expr) if e.else_expr is not None else None
            out_dtype = _pa_to_torch_dtype(e.out_type)
            true, false = _const(True, torch.bool), _const(False, torch.bool)
            zero = _const(0, out_dtype)

            def run_case(env, whens=whens, else_f=else_f, out_dtype=out_dtype):
                # per-row branch selection: both the value AND the validity
                # follow the selected branch (SQL CASE); a no-ELSE CASE is
                # NULL on rows no WHEN matches
                if else_f is not None:
                    acc, ev = else_f(env)
                    acc = acc.to(out_dtype)
                    acc_val = true(env) if ev is None else ev
                else:
                    acc = zero(env)
                    acc_val = false(env)
                for wf, tf in reversed(whens):
                    c, cval = wf(env)
                    c = c.to(torch.bool) if cval is None else torch.logical_and(c, cval)
                    t, tval = tf(env)
                    acc = torch.where(c, t.to(out_dtype), acc)
                    tv = true(env) if tval is None else tval
                    acc_val = torch.where(c, tv, acc_val)
                return acc, acc_val

            args = tuple(g.node for pair in whens for g in pair)
            if else_f is not None:
                args += (else_f.node,)
            return _with_node(
                run_case, ExprNode("case", out_dtype, args, else_f is not None)
            )

        if isinstance(e, pe.Cast):
            f = self._lower(e.expr)
            dt = _pa_to_torch_dtype(e.to_type)

            def run_cast(env, f=f, dt=dt):
                v, val = f(env)
                return _cast(v, dt), val

            return _with_node(run_cast, _cast_node(f.node, dt))

        if isinstance(e, pe.ScalarFn):
            mapping = {
                "abs": torch.abs, "sqrt": torch.sqrt, "exp": torch.exp,
                "ln": torch.log, "log10": torch.log10, "log2": torch.log2,
                "ceil": torch.ceil, "floor": torch.floor, "sin": torch.sin,
                "cos": torch.cos, "tan": torch.tan, "signum": _sign,
            }
            if e.fname in mapping and len(e.args) == 1:
                f = self._lower(e.args[0])
                fn = mapping[e.fname]

                def run_fn(env, f=f, fn=fn):
                    v, val = f(env)
                    return fn(v.to(F64)), val

                return _with_node(run_fn, _node(e.fname, f))
            if e.fname == "power" and len(e.args) == 2:
                a = self._lower(e.args[0])
                b = self._lower(e.args[1])

                def run_pow(env, a=a, b=b):
                    av, aval = a(env)
                    bv, bval = b(env)
                    return torch.pow(av.to(F64), bv.to(F64)), _merge_valid(aval, bval)

                return _with_node(run_pow, _node("power", a, b))
            if e.fname == "round":
                f = self._lower(e.args[0])

                def run_round(env, f=f):
                    v, val = f(env)
                    # half-to-even, as jnp.round
                    return torch.round(v.to(F64)), val

                return _with_node(run_round, _node("round", f))
            raise NotLowerable(f"scalar fn {e.fname}")

        raise NotLowerable(f"node {type(e).__name__}")


def square_closure(closure: TorchClosure) -> TorchClosure:
    """x² in float64 (the variance family's second moment)."""

    def run(env: dict):
        v, valid = closure(env)
        v = v.to(F64)
        return v * v, valid

    return _with_node(run, _node("square", closure))


def _merge_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return torch.logical_and(a, b)


def _is_int(t: torch.Tensor) -> bool:
    return not t.is_floating_point() and t.dtype != torch.bool


def _numeric_align(lv, rv):
    if lv.dtype == torch.bool or rv.dtype == torch.bool:
        return lv, rv
    if lv.is_floating_point() or rv.is_floating_point():
        return lv.to(F64), rv.to(F64)
    return lv.to(I64), rv.to(I64)


def _trunc_div(lv: torch.Tensor, rv: torch.Tensor) -> torch.Tensor:
    """SQL / Arrow integer ``/``: truncates toward zero (``//`` would
    floor) with a zero divisor guarded, as the reference's ``lax.div``;
    ``x / -1`` is the wrapping negation, so ``INT64_MIN / -1`` is
    ``INT64_MIN`` as in XLA (the CPU's division traps there)."""
    lv, rv = lv.to(I64), rv.to(I64)
    neg1 = rv == -1
    rv_safe = torch.where((rv == 0) | neg1, torch.ones_like(rv), rv)
    return torch.where(neg1, -lv, torch.div(lv, rv_safe, rounding_mode="trunc"))


def _floor_mod(lv: torch.Tensor, rv: torch.Tensor) -> torch.Tensor:
    """``jnp.mod``: floor modulo; an integer zero divisor gives 0 (torch
    raises on the CPU and returns garbage on CUDA, so it is guarded), and
    so does -1 (``INT64_MIN % -1`` traps on the CPU)."""
    if _is_int(lv) and _is_int(rv):
        lv, rv = lv.to(I64), rv.to(I64)
        zero = rv == 0
        r = torch.remainder(lv, torch.where(zero | (rv == -1), torch.ones_like(rv), rv))
        return torch.where(zero, torch.zeros_like(r), r)
    return torch.remainder(lv.to(F64), rv.to(F64))


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: NaN stays NaN and ±0.0 keeps its sign (torch.sign
    maps both to +0.0)."""
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


def _cast(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``astype`` with XLA's float → int64 conversion: truncate toward zero,
    saturate at the int64 range, NaN → 0 (torch leaves these undefined)."""
    if dt == I64 and v.is_floating_point():
        v = v.to(F64)
        hi = v >= 2.0**63
        lo = v < -(2.0**63)
        bad = hi | lo | torch.isnan(v)
        out = torch.where(bad, torch.zeros_like(v), v).to(I64)
        out = torch.where(hi, torch.full_like(out, 2**63 - 1), out)
        return torch.where(lo, torch.full_like(out, -(2**63)), out)
    return v.to(dt)


def _is_date(v) -> bool:
    import datetime

    return isinstance(v, datetime.date)


def _days(v) -> int:
    import datetime

    return (v - datetime.date(1970, 1, 1)).days


def _to_num(v):
    if _is_date(v):
        return float(_days(v))
    return float(v)


def _infer_pa_type(e: pe.PhysicalExpr, schema: pa.Schema) -> pa.DataType:
    empty = pa.RecordBatch.from_arrays(
        [pa.nulls(0, f.type) for f in schema], schema=schema
    )
    v = e.evaluate(empty)
    return v.type


# ---------------------------------------------------------------- env build
def build_env(
    batch: pa.RecordBatch, leaves: dict[str, LeafSpec], n_padded: int,
    trivial_valid: Optional[set] = None,
) -> dict[str, np.ndarray]:
    """Evaluate/extract all leaf arrays for one batch, padded to n_padded.

    Every leaf ships a validity companion (all-true when the batch has no
    nulls).  Names of companions that are trivially all-true over the live
    rows are added to ``trivial_valid`` when given: the stage replaces them
    with ``None`` so they never cross the bridge.
    """
    import pyarrow.compute as pc

    env: dict[str, np.ndarray] = {}
    for name, spec in leaves.items():
        if spec.kind == "join_col":
            continue  # gathered on the device by the join probe
        if spec.kind == "cpu_expr":
            arr = spec.cpu_expr.evaluate(batch)
            if isinstance(arr, pa.Scalar):
                arr = pa.array([arr.as_py()] * batch.num_rows, arr.type)
        else:
            arr = batch.column(spec.col_index)
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if spec.kind == "column_validity":
            if arr.null_count:
                validity = np.asarray(pc.is_valid(arr))
            else:
                validity = np.ones(len(arr), dtype=bool)
                if trivial_valid is not None:
                    trivial_valid.add(f"{name}__valid")
            env[f"{name}__valid"] = _pad(validity, n_padded)
            continue
        values, validity = arrow_to_numpy(arr)
        if validity is None:
            validity = np.ones(len(values), dtype=bool)
            if trivial_valid is not None:
                trivial_valid.add(f"{name}__valid")
        env[f"{name}__valid"] = _pad(validity, n_padded)
        if spec.kind == "column_ord_pair":
            from .bridge import split_u64_i32, to_u64_order

            # the f64 VALUE is encoded (integers cast exactly below 2^53);
            # consumers decode through bridge.order_decode_f64
            ohi, olo = split_u64_i32(to_u64_order(values.astype(np.float64)))
            env[f"{name}__ohi"] = _pad(ohi, n_padded)
            env[f"{name}__olo"] = _pad(olo, n_padded)
            continue
        env[name] = _pad(coerce_host_values(values), n_padded)
    return env


def coerce_host_values(values: np.ndarray) -> np.ndarray:
    """Widen host arrays to the x64 device dtypes before transfer.

    Every integer leaf (date32 days included) becomes int64 and every float
    leaf float64, which is what the reference's lowering aligns them to
    before any arithmetic, comparison or aggregate.  The compiler keeps
    uint64 leaves off the device at plan time; uint64 values past the
    int64 range raise ExecutionError here all the same.
    """
    kind = values.dtype.kind
    if kind == "b" or values.dtype in (np.dtype(np.int64), np.dtype(np.float64)):
        return values
    if kind == "f":
        return values.astype(np.float64)
    if kind == "u" and values.dtype.itemsize == 8:
        if len(values) and values.max() > np.iinfo(np.int64).max:
            raise ExecutionError("uint64 column exceeds the int64 range")
    if kind in "iu":
        return values.astype(np.int64)
    raise ExecutionError(f"dtype {values.dtype} cannot cross the device bridge")


def flat_arg_names(leaves: dict[str, LeafSpec]) -> list[str]:
    """Positional arg order of the stage's per-batch arrays, per leaf kind."""
    out = []
    for n, spec in leaves.items():
        if spec.kind == "column_validity":
            out.append(f"{n}__valid")
        elif spec.kind == "column_ord_pair":
            out.extend([f"{n}__ohi", f"{n}__olo", f"{n}__valid"])
        else:
            out.extend([n, f"{n}__valid"])
    return out


def _pad(x: np.ndarray, n: int) -> np.ndarray:
    if len(x) == n:
        return x
    out = np.zeros(n, dtype=x.dtype)
    out[: len(x)] = x
    return out


def bucket_rows(n: int, floor: int = 1024) -> int:
    """Power-of-two row bucket (sizes the bridge's reusable pinned buffers)."""
    return max(floor, 1 << math.ceil(math.log2(max(n, 1))))


# ------------------------------------------------------------- state layout
@dataclass(frozen=True)
class KernelAggSpec:
    func: str  # sum | count | avg | min | max | count_star
    has_arg: bool
    # min/max over integer/date args stay in INTEGER dtype end-to-end
    int_minmax: bool = False
    # sum over an integer arg accumulates in int64: exact at any magnitude
    # (the reference sums in f64, exact only below 2^53)
    int_sum: bool = False


def state_fields(spec: KernelAggSpec) -> tuple[str, ...]:
    """Per-aggregate kernel-state layout: field roles in output order.

    Roles drive merging: "add" → +, "min"/"max" → elementwise extremum.
    """
    if spec.func in ("count", "count_star"):
        return ("add",)
    if spec.func in ("sum", "avg"):
        return ("add", "add")
    if spec.func == "min":
        return ("min", "add")
    if spec.func == "max":
        return ("max", "add")
    raise ExecutionError(f"kernel agg {spec.func}")


def state_is_int(spec: KernelAggSpec) -> tuple[bool, ...]:
    """Which state fields are integer (counts) vs float, in layout order."""
    if spec.func in ("count", "count_star"):
        return (True,)
    if spec.func in ("sum", "avg"):
        return (spec.int_sum, True)
    return (spec.int_minmax, True)  # min/max: (value, n)


def _field_flags(specs: list[KernelAggSpec]) -> list[tuple[str, bool]]:
    """(role, is_int) per state row, presence last."""
    out = []
    for spec in specs:
        out.extend(zip(state_fields(spec), state_is_int(spec)))
    out.append(("add", True))  # presence
    return out


def _pad_ident(role: str, is_int: bool):
    """Growth-padding identity per state field, dtype-aware (integer
    min/max states must not pad with float inf)."""
    if role == "min":
        return torch.iinfo(I64).max if is_int else math.inf
    if role == "max":
        return torch.iinfo(I64).min if is_int else -math.inf
    return 0


def _ident_bits(role: str, is_int: bool) -> int:
    """The identity of a state row as its int64 storage word."""
    v = _pad_ident(role, is_int)
    if is_int:
        return int(v)
    return int(np.array(float(v), np.float64).view(np.int64))


def init_states(
    specs: list[KernelAggSpec], capacity: int, device
) -> torch.Tensor:
    """Fresh [n_fields, capacity] int64 state holding every row's identity
    (float rows hold float64 bit patterns)."""
    words = [_ident_bits(r, i) for r, i in _field_flags(specs)]
    col = torch.tensor(words, dtype=I64).to(device)
    return col[:, None].expand(len(words), capacity).contiguous()


def pad_states(
    specs: list[KernelAggSpec], acc: Optional[torch.Tensor], new_cap: int
) -> Optional[torch.Tensor]:
    """Grow accumulated [n_fields, old_cap] states to new_cap (adaptive
    segment capacity): additive fields pad with 0, extrema with their
    identity.  Existing group ids stay valid — the host encoder assigns
    them monotonically."""
    if acc is None:
        return None
    grow = new_cap - acc.shape[1]
    if grow <= 0:
        return acc
    return torch.cat([acc, init_states(specs, grow, acc.device)], dim=1)


def _fmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.minimum on f64: NaN propagates and -0.0 orders below +0.0."""
    r = torch.minimum(a, b)
    z = (a == 0) & (b == 0)
    neg = torch.signbit(a) | torch.signbit(b)
    return _keep_nan(a, b, torch.where(z, _signed_zero(neg), r))


def _fmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.maximum on f64: NaN propagates and +0.0 orders above -0.0."""
    r = torch.maximum(a, b)
    z = (a == 0) & (b == 0)
    neg = torch.signbit(a) & torch.signbit(b)
    return _keep_nan(a, b, torch.where(z, _signed_zero(neg), r))


def _keep_nan(a: torch.Tensor, b: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The NaN operand itself where there is one (torch's vectorised
    minimum/maximum return an all-ones NaN; XLA and the kernels keep the
    operand's bits)."""
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, r))


def _signed_zero(neg: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros(neg.shape, dtype=F64, device=neg.device)
    return torch.where(neg, -zero, zero)


def _merge_row(role: str, is_int: bool, a: torch.Tensor, b: torch.Tensor):
    """Merge two int64 storage rows of one state field."""
    if is_int:
        if role == "min":
            return torch.minimum(a, b)
        if role == "max":
            return torch.maximum(a, b)
        return a + b
    af, bf = a.view(F64), b.view(F64)
    if role == "min":
        r = _fmin(af, bf)
    elif role == "max":
        r = _fmax(af, bf)
    else:
        r = af + bf
    return r.view(I64)


def combine_states(
    specs: list[KernelAggSpec],
    acc: Optional[torch.Tensor],
    new: torch.Tensor,
) -> torch.Tensor:
    """Merge two [n_fields, capacity] states elementwise (+, min, max).

    The CUDA kernel merges each batch into the running state itself; this
    is the plain form of that epilogue (the twin uses it)."""
    if acc is None:
        return new
    rows = [
        _merge_row(role, is_int, acc[i], new[i])
        for i, (role, is_int) in enumerate(_field_flags(specs))
    ]
    return torch.stack(rows, dim=0)


def fetch_states(state: torch.Tensor, keep: Optional[int] = None) -> np.ndarray:
    """ONE device→host copy of the first ``keep`` state columns.  The state
    already has the reference's packed layout ([n_fields, keep], floats as
    their int64 bits), so there is nothing to pack."""
    cap = state.shape[1]
    if keep is None or keep > cap:
        keep = cap
    return state[:, :keep].cpu().numpy()


def unpack_host(
    specs: list[KernelAggSpec], packed: np.ndarray
) -> list[np.ndarray]:
    """Host-side view of a fetched state (numpy, no device)."""
    flags = [f for spec in specs for f in state_is_int(spec)] + [True]
    out = []
    for row, is_int in zip(packed, flags):
        out.append(row if is_int else row.view(np.float64))
    return out


# ----------------------------------------------------- JAX-package interop
def specs_from_dicts(dicts: list[dict]) -> list[KernelAggSpec]:
    """Port specs from the reference's ``KernelAggSpec`` fields as plain
    dicts (``dataclasses.asdict``).  Only x64 layouts carry over."""
    out = []
    for d in dicts:
        if d.get("pair") or d.get("ord_pair"):
            raise NotLowerable("x32 pair state layouts are not ported")
        out.append(
            KernelAggSpec(
                d["func"], bool(d["has_arg"]),
                int_minmax=bool(d.get("int_minmax", False)),
                int_sum=bool(d.get("int_sum", False)),
            )
        )
    return out


def states_from_numpy(
    spec_dicts: list[dict], arrays, device
) -> torch.Tensor:
    """The reference's state tuple (one [capacity] array per field, then
    presence) as the port's [n_fields, capacity] int64 state on ``device``."""
    flags = _field_flags(specs_from_dicts(spec_dicts))
    arrays = [np.asarray(a) for a in arrays]
    if len(arrays) != len(flags):
        raise ValueError(f"{len(arrays)} state arrays for {len(flags)} fields")
    rows = []
    for a, (_role, is_int) in zip(arrays, flags):
        if is_int != (a.dtype.kind in "iu"):
            raise ValueError(f"state field dtype {a.dtype} vs is_int={is_int}")
        rows.append(
            a.astype(np.int64) if is_int else a.astype(np.float64).view(np.int64)
        )
    return torch.from_numpy(np.stack(rows)).to(device)


# Launches of each hand-written kernel, counted by its wrapper where it
# launches (window_kernel.py's wrappers count here too); a twin never counts.
# An executor runs several task threads against one card, so a count goes
# through count_launch, under a lock.
LAUNCHES = dict.fromkeys(
    ("expr_eval", "segment_agg", "segment_agg_entries", "radix_sort", "seg_scan", "range_extremum", "window_epilogue",
     "partition_ids", "join_build_table", "join_probe", "key_encode", "keyed_gids",
     "keyed_finish", "keyed_median", "keyed_corr", "mesh_reduce", "mesh_route"), 0
)
_LAUNCHES_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


# ------------------------------------------------------ segment aggregate
# Per-field reduction codes, shared with ops/cuda/segment_agg.cu.
OP_COUNT = 0  # + of the field's mask (row mask ∧ column validity)
OP_ADD_F64 = 1
OP_ADD_I64 = 2
OP_MIN_F64 = 3
OP_MAX_F64 = 4
OP_MIN_I64 = 5
OP_MAX_I64 = 6
_OP_ROLE = {
    OP_COUNT: ("add", True), OP_ADD_F64: ("add", False),
    OP_ADD_I64: ("add", True), OP_MIN_F64: ("min", False),
    OP_MAX_F64: ("max", False), OP_MIN_I64: ("min", True),
    OP_MAX_I64: ("max", True),
}
MAX_COLUMNS = 32
MAX_FIELDS = 64


def _segment_extremum(v, m, gid, capacity: int, is_min: bool):
    """Per-group min/max of ``v`` over rows where ``m``, with
    ``jax.ops.segment_min/max`` semantics: NaN propagates, -0.0 orders
    below +0.0 (scatter_reduce alone keeps whichever zero came first)."""
    if v.is_floating_point():
        ident = math.inf if is_min else -math.inf
    else:
        ident = torch.iinfo(I64).max if is_min else torch.iinfo(I64).min
    out = torch.full((capacity,), ident, dtype=v.dtype, device=v.device)
    vm = torch.where(m, v, torch.full_like(v, ident))
    out = out.scatter_reduce(0, gid, vm, "amin" if is_min else "amax")
    if not v.is_floating_point():
        return out

    def any_in_group(flag):
        cnt = torch.zeros(capacity, dtype=I64, device=v.device)
        return cnt.index_add_(0, gid, (m & flag).to(I64)) > 0

    zero_sign = torch.signbit(v) if is_min else ~torch.signbit(v)
    has_zero = any_in_group((v == 0) & zero_sign)
    out = torch.where(
        (out == 0) & has_zero,
        torch.full_like(out, -0.0 if is_min else 0.0),
        out,
    )
    has_nan = any_in_group(torch.isnan(v))
    return torch.where(has_nan, torch.full_like(out, math.nan), out)


def segment_agg_reference(
    gid: torch.Tensor,
    tail: Optional[torch.Tensor],
    pred: Optional[torch.Tensor],
    pvalid: Optional[torch.Tensor],
    values: list,
    valids: list,
    ops: list[int],
    cols: list[int],
    state: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch twin of the CUDA segment-aggregate kernel.

    Same inputs and mask folding: row mask = tail ∧ pred ∧ pvalid (the
    reference kernel's order), per field mask = row mask ∧ validity of
    its column; ``None`` masks are all-true.  Reduces the batch with
    ``index_add_``/``scatter_reduce`` and merges into ``state`` in place.
    """
    n, capacity = gid.shape[0], state.shape[1]
    mask = (
        torch.ones(n, dtype=torch.bool, device=gid.device)
        if tail is None
        else tail
    )
    if pred is not None:
        p = pred if pvalid is None else torch.logical_and(pred, pvalid)
        mask = torch.logical_and(mask, p)
    g = gid.to(I64)
    for f, (op, c) in enumerate(zip(ops, cols)):
        m = mask if c < 0 or valids[c] is None else torch.logical_and(mask, valids[c])
        if op == OP_COUNT:
            part = torch.zeros(capacity, dtype=I64, device=gid.device)
            part.index_add_(0, g, m.to(I64))
        elif op in (OP_ADD_F64, OP_ADD_I64):
            v = values[c]
            part = torch.zeros(capacity, dtype=v.dtype, device=gid.device)
            part.index_add_(0, g, torch.where(m, v, torch.zeros_like(v)))
        else:
            part = _segment_extremum(
                values[c], m, g, capacity, op in (OP_MIN_F64, OP_MIN_I64)
            )
        role, is_int = _OP_ROLE[op]
        state[f] = _merge_row(role, is_int, state[f], part.view(I64))
    return state


def _check_cuda_args(gid, tail, pred, pvalid, values, valids, ops, cols, state):
    """Raise ValueError unless the kernel's inputs have the devices, dtypes,
    shapes and layouts the binding accepts.  The binding checks them too,
    but with some toolchains an exception thrown inside the extension ends
    the process (SIGSEGV) instead of raising, so bad input is turned away
    here, before the binding."""
    dev = state.device

    def bad(x, dtypes, shape) -> bool:
        return (
            x.device != dev or x.dtype not in dtypes
            or tuple(x.shape) != shape or not x.is_contiguous()
        )

    if dev.type != "cuda" or state.dtype != I64 or state.dim() != 2 or (
        not state.is_contiguous()
    ):
        raise ValueError("state must be a contiguous CUDA int64 [n_fields, capacity]")
    if gid.dim() != 1 or bad(gid, (torch.int32,), (gid.shape[0],)):
        raise ValueError(f"gid must be contiguous int32 [n] on {dev}")
    n = gid.shape[0]
    masks = [("tail", tail), ("pred", pred), ("pvalid", pvalid)]
    masks += [(f"validity {c}", v) for c, v in enumerate(valids)]
    for name, m in masks:
        if m is not None and bad(m, (torch.bool,), (n,)):
            raise ValueError(f"{name} must be contiguous bool [{n}] on {dev}")
    if pvalid is not None and pred is None:
        raise ValueError("pvalid without pred")
    for c, v in enumerate(values):
        if v is not None and bad(v, (F64, I64), (n,)):
            raise ValueError(f"column {c} must be contiguous f64/i64 [{n}] on {dev}")
    for f, (op, c) in enumerate(zip(ops, cols)):
        if op not in _OP_ROLE or not -1 <= c < len(values):
            raise ValueError(f"field {f}: op {op}, column {c}")
        if op != OP_COUNT:
            v = values[c] if c >= 0 else None
            if v is None or v.dtype != (I64 if _OP_ROLE[op][1] else F64):
                raise ValueError(f"field {f}: op {op} does not match its column")


def segment_agg_cuda(
    gid: torch.Tensor,
    tail: Optional[torch.Tensor],
    pred: Optional[torch.Tensor],
    pvalid: Optional[torch.Tensor],
    values: list,
    valids: list,
    ops: list[int],
    cols: list[int],
    state: torch.Tensor,
) -> torch.Tensor:
    """Launch the hand-written segment-aggregate kernel (CUDA tensors only).

    Replaces ``arrow_ballista_tpu/ops/kernels.py:make_partial_agg_kernel``'s
    scatter route and ``combine_states``.  Devices, dtypes, shapes and
    contiguity are checked first (ValueError on anything else); a failed
    build or launch raises — there is no fallback to the twin.
    """
    from .cuda.build import load

    _check_cuda_args(gid, tail, pred, pvalid, values, valids, ops, cols, state)
    ext = load()
    empty = torch.empty(0, dtype=torch.bool, device=state.device)
    ext.segment_agg(
        gid,
        empty if tail is None else tail,
        empty if pred is None else pred,
        empty if pvalid is None else pvalid,
        [empty if v is None else v for v in values],
        [empty if v is None else v for v in valids],
        list(ops),
        list(cols),
        state,
    )
    count_launch("segment_agg")
    return state


def segment_agg(gid, tail, pred, pvalid, values, valids, ops, cols, state):
    """Segment aggregate into ``state``: the CUDA kernel for CUDA tensors,
    its plain twin for tensors on the CPU."""
    if len(values) != len(valids) or len(values) > MAX_COLUMNS:
        raise ValueError(f"segment_agg: {len(values)} columns")
    if len(ops) != len(cols) or len(ops) != state.shape[0] or len(ops) > MAX_FIELDS:
        raise ValueError(f"segment_agg: {len(ops)} fields")
    if state.device.type == "cpu":
        return segment_agg_reference(
            gid, tail, pred, pvalid, values, valids, ops, cols, state
        )
    return segment_agg_cuda(
        gid, tail, pred, pvalid, values, valids, ops, cols, state
    )


def segment_agg_entries_reference(
    entries: list, ops: list[int], cols: list[int], state: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch twin of the multi-entry segment aggregate: the
    one-batch twin over ``entries`` in order, each entry a ``(gid, tail,
    pred, pvalid, values, valids)`` tuple as :func:`segment_agg` takes
    them, all folded into ``state`` in place."""
    for gid, tail, pred, pvalid, values, valids in entries:
        segment_agg_reference(gid, tail, pred, pvalid, values, valids, ops, cols, state)
    return state


def segment_agg_entries_cuda(
    entries: list, ops: list[int], cols: list[int], state: torch.Tensor
) -> torch.Tensor:
    """Launch the hand-written multi-entry segment aggregate
    (``ops/cuda/segment_agg_entries.cu``): every entry folded into
    ``state`` in one call, bit-identical to one :func:`segment_agg_cuda`
    launch per entry in entry order.

    Replaces ``arrow_ballista_tpu/ops/stage_compiler.py:_run_fused`` and
    ``_fused_for`` (the per-entry kernel, ``combine_states`` and
    ``pack_states`` in one program).  Every entry's inputs are checked
    first (ValueError); a failed build or launch raises, and nothing
    falls back to the one-batch kernel or the twin."""
    from .cuda.build import load

    if not entries:
        raise ValueError("segment_agg_entries: no entries")
    for gid, tail, pred, pvalid, values, valids in entries:
        _check_cuda_args(gid, tail, pred, pvalid, values, valids, ops, cols, state)
    ext = load()
    empty = torch.empty(0, dtype=torch.bool, device=state.device)

    def opt(x):
        return empty if x is None else x

    ext.segment_agg_entries(
        [e[0] for e in entries],
        [opt(e[1]) for e in entries],
        [opt(e[2]) for e in entries],
        [opt(e[3]) for e in entries],
        [[opt(v) for v in e[4]] for e in entries],
        [[opt(v) for v in e[5]] for e in entries],
        list(ops),
        list(cols),
        state,
    )
    count_launch("segment_agg_entries")
    return state


def segment_agg_entries(entries: list, ops: list[int], cols: list[int], state):
    """Every entry's segment aggregate folded into ``state``: the CUDA
    kernel for CUDA tensors, its plain twin for tensors on the CPU."""
    for _gid, _tail, _pred, _pvalid, values, valids in entries:
        if len(values) != len(valids) or len(values) > MAX_COLUMNS:
            raise ValueError(f"segment_agg_entries: {len(values)} columns")
    if len(ops) != len(cols) or len(ops) != state.shape[0] or len(ops) > MAX_FIELDS:
        raise ValueError(f"segment_agg_entries: {len(ops)} fields")
    if state.device.type == "cpu":
        return segment_agg_entries_reference(entries, ops, cols, state)
    return segment_agg_entries_cuda(entries, ops, cols, state)


# ------------------------------------------------------- algorithm choice
# The segment reduction has two device routes: "scatter" (B1, segment_agg
# above) and "sort" (one stable radix sort of the group ids, then one
# segmented scan over every aggregate column, totals merged at each
# segment's last row).  B1 re-scans a batch once per tile of groups, so it
# stops paying at large capacity; the sort route costs the same at any
# capacity.  The reference's matmul route is x32-only and not ported.
# Bounds: the reference's builtin defaults (its routing table names no
# cuda platform), constants until the cuda routing grid exists.
SORT_MIN_CAPACITY = 8192  # capacity above this sorts
SORT_MIN_ELEMS = 1 << 36  # rows x capacity above this sorts
_AGG_ALGO: dict = {"force": None}


def set_agg_algorithm(algo: Optional[str]) -> None:
    """Force the segment-reduction route (tests) or None = by the bounds."""
    if algo not in (None, "scatter", "sort"):
        raise ValueError(f"agg algorithm {algo!r}")
    _AGG_ALGO["force"] = algo


def segment_algo(capacity: int, n_rows: Optional[int], device) -> str:
    """Route of one batch: "sort" on cuda above the capacity or the
    rows x capacity bound, else "scatter"; the CPU twins always scatter
    unless a route is forced."""
    if _AGG_ALGO["force"] is not None:
        return _AGG_ALGO["force"]
    if torch.device(device).type != "cuda":
        return "scatter"
    if capacity > SORT_MIN_CAPACITY:
        return "sort"
    if n_rows is not None and n_rows * capacity > SORT_MIN_ELEMS:
        return "sort"
    return "scatter"


def algo_cache_token() -> tuple:
    """Part of a kernel cache key: the route inputs that are not in the
    kernel's signature."""
    return (_AGG_ALGO["force"], SORT_MIN_CAPACITY, SORT_MIN_ELEMS)


def _check_cuda_tensor(x, name: str, dtypes, n: int, device) -> None:
    """ValueError unless ``x`` is a contiguous [n] tensor of one of
    ``dtypes`` on ``device`` (checked before a binding is called: an
    exception inside the extension may end the process)."""
    if (
        not isinstance(x, torch.Tensor) or x.device != device
        or x.dtype not in dtypes or x.dim() != 1 or x.shape[0] != n
        or not x.is_contiguous()
    ):
        raise ValueError(f"{name} must be a contiguous [{n}] {dtypes} tensor on {device}")


# ------------------------------------------------------------- radix sort
RADIX_TILE = 4096  # rows per tile of a pass (radix_sort.h: kRadixTile)


def radix_argsort_reference(keys: list) -> torch.Tensor:
    """Plain twin of the radix sort: stable sorts from the last key to the
    first, so ties keep row order (``lax.sort(keys + (iota,))``)."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=I64, device=keys[0].device)
    for k in reversed(keys):
        _, idx = torch.sort(k[perm], stable=True)
        perm = perm[idx]
    return perm.to(torch.int32)


def _radix_plan(keys: list):
    """Check the key columns, then launch the whole-column byte histograms
    and the sort's device plan (ops/cuda/radix_sort.h).  Returns
    (extension, hist, plan); nothing is read back."""
    from .cuda.build import load

    if not keys or len(keys) > 32:
        raise ValueError(f"radix sort: {len(keys)} key columns")
    device = keys[0].device
    n = keys[0].shape[0] if keys[0].dim() == 1 else -1
    if device.type != "cuda" or not 0 <= n < (1 << 31):
        raise ValueError("radix sort keys must be [n] CUDA tensors, n < 2^31")
    for i, k in enumerate(keys):
        _check_cuda_tensor(k, f"key {i}", (torch.int32, I64), n, device)
    ext = load()
    hist = torch.empty((len(keys), 8, 256), dtype=torch.int32, device=device)
    cands = sum(k.element_size() for k in keys)
    plan = torch.empty(1 + cands + len(keys), dtype=torch.int32, device=device)
    ext.radix_sort_plan(list(keys), hist, plan)
    return ext, hist, plan


def radix_argsort_cuda(keys: list) -> torch.Tensor:
    """Launch the hand-written stable LSD radix argsort (ops/cuda/
    radix_sort.cu) over int32/int64 key columns, most significant first.

    Replaces the multi-key ``lax.sort`` of ``arrow_ballista_tpu/ops/
    window_kernel.py:make_window_kernel`` and the ``gid<<31 | row`` sort of
    ``ops/kernels.py:_sorted_segment_agg``.  The whole-column byte
    histograms decide on the device which passes run: a byte that is the
    same on every row costs an empty launch, and the host never waits."""
    ext, hist, plan = _radix_plan(keys)
    n, device = keys[0].shape[0], keys[0].device
    perm = torch.empty(n, dtype=torch.int32, device=device)
    tiles = max(1, -(-n // RADIX_TILE))
    ext.radix_sort_passes(
        list(keys), hist, plan, perm,
        torch.empty(n, dtype=torch.int32, device=device),
        torch.empty(n, dtype=I64, device=device),
        torch.empty(n, dtype=I64, device=device),
        torch.empty(256 * tiles, dtype=torch.int32, device=device),
    )
    count_launch("radix_sort")
    return perm


def radix_sort_pass_count(keys: list) -> int:
    """How many LSD passes the radix sort runs on ``keys``: its device
    plan's count, read back (for reports and tests; not a sort launch)."""
    return int(_radix_plan(keys)[2][0].item())


def radix_argsort(keys: list) -> torch.Tensor:
    """int32 permutation that stably sorts the rows by ``keys`` (signed
    order, most significant first): the CUDA kernel for CUDA tensors, its
    plain twin for tensors on the CPU."""
    if keys[0].device.type == "cpu":
        return radix_argsort_reference(keys)
    return radix_argsort_cuda(keys)


# --------------------------------------------------------- segmented scan
# Element sources of a scan column (ops/cuda/seg_scan.h: ScanSrc).
SS_VALUES = 0  # values[perm[r]]; a null is 0 for a sum, the identity else
SS_COUNT = 1   # valid[perm[r]] as 0/1 (1 without a validity)
SS_IOTA = 2    # the sorted row index r
SS_AUX = 3     # aux[r] as 0/1
SCAN_MAX_COLUMNS = 32
SCAN_TILE = 2048  # rows per block (seg_scan.h: kScanTile)


@dataclass(frozen=True, eq=False)
class ScanColumn:
    """One column of a segmented scan: its element source and fold."""

    src: int
    op: int  # OP_ADD_F64 .. OP_MAX_I64 (OP_ADD_I64 for counts and iota)
    values: Optional[torch.Tensor] = None  # [n] f64/i64, input row order
    valid: Optional[torch.Tensor] = None   # [n] bool, input row order


def _ident_value(op: int, dtype):
    if op in (OP_MIN_F64, OP_MIN_I64):
        return math.inf if dtype == F64 else torch.iinfo(I64).max
    if op in (OP_MAX_F64, OP_MAX_I64):
        return -math.inf if dtype == F64 else torch.iinfo(I64).min
    return 0


def _elements(col: ScanColumn, n: int, perm, aux, device) -> torch.Tensor:
    """The column's elements in sorted order, typed (f64 or i64)."""
    if col.src == SS_IOTA:
        return torch.arange(n, dtype=I64, device=device)
    if col.src == SS_AUX:
        return aux.to(I64)

    def gathered(x):
        return x if perm is None else x[perm.long()]

    ok = None if col.valid is None else gathered(col.valid)
    if col.src == SS_COUNT:
        return torch.ones(n, dtype=I64, device=device) if ok is None else ok.to(I64)
    dtype = F64 if _OP_ROLE[col.op][1] is False else I64
    v = gathered(col.values).to(dtype)
    if ok is None:
        return v
    return torch.where(ok, v, torch.full_like(v, _ident_value(col.op, dtype)))


def _fold(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    role, is_int = _OP_ROLE[op]
    if role == "min":
        return torch.minimum(a, b) if is_int else _fmin(a, b)
    if role == "max":
        return torch.maximum(a, b) if is_int else _fmax(a, b)
    return a + b


def _scan_reference(op: int, x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``x`` resetting where ``start``: log-step
    doubling with the segmented operator ``(fa, a), (fb, b) -> (fa | fb,
    b if fb else a . b)``, as the reference's associative_scan combines."""
    v, f = x, start
    d = 1
    while d < x.shape[0]:
        merged = torch.where(f[d:], v[d:], _fold(op, v[:-d], v[d:]))
        v = torch.cat([v[:d], merged])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return v


def _starts(n: int, perm, flag, key, device) -> torch.Tensor:
    """Segment starts in sorted order (row 0 always starts one)."""
    if flag is not None:
        start = flag.to(torch.bool).clone()
    else:
        s = key if perm is None else key[perm.long()]
        start = torch.ones(n, dtype=torch.bool, device=device)
        start[1:] = s[1:] != s[:-1]
    if n:
        start[0] = True
    return start


def seg_scan_reference(
    cols: list, n: int, perm=None, flag=None, key=None, aux=None,
    reverse: bool = False,
) -> list:
    """Plain twin of the segmented scan: each column's inclusive scan in
    sorted order, as int64 words (floats as their bits)."""
    device = (perm if perm is not None else flag if flag is not None else key).device
    if n == 0:
        return [torch.empty(0, dtype=I64, device=device) for _ in cols]
    start = _starts(n, perm, flag, key, device)
    if reverse:  # a segment's last row starts the reversed scan
        start = torch.cat([start[1:], torch.ones(1, dtype=torch.bool, device=device)])
    out = []
    for col in cols:
        x = _elements(col, n, perm, aux, device)
        if reverse:
            s = _scan_reference(col.op, x.flip(0), start.flip(0)).flip(0)
        else:
            s = _scan_reference(col.op, x, start)
        out.append(s.view(I64) if s.dtype == F64 else s)
    return out


def _check_scan_args(cols, n, perm, flag, key, aux, device) -> None:
    if device.type != "cuda" or not 0 <= n < (1 << 31):
        raise ValueError("seg_scan runs on CUDA tensors, n < 2^31")
    if not 1 <= len(cols) <= SCAN_MAX_COLUMNS:
        raise ValueError(f"seg_scan: {len(cols)} columns")
    if (flag is None) == (key is None):
        raise ValueError("seg_scan needs exactly one of flag and key")
    if perm is not None:
        _check_cuda_tensor(perm, "perm", (torch.int32,), n, device)
    if flag is not None:
        _check_cuda_tensor(flag, "flag", (torch.uint8, torch.bool), n, device)
    if key is not None:
        _check_cuda_tensor(key, "key", (torch.int32,), n, device)
    for i, c in enumerate(cols):
        if c.op not in _OP_ROLE or c.op == OP_COUNT:
            raise ValueError(f"scan column {i}: op {c.op}")
        if c.src == SS_AUX:
            _check_cuda_tensor(aux, "aux", (torch.uint8, torch.bool), n, device)
        if c.src == SS_VALUES:
            want = I64 if _OP_ROLE[c.op][1] else F64
            dtypes = (F64, I64) if want == F64 else (I64,)
            _check_cuda_tensor(c.values, f"column {i} values", dtypes, n, device)
        if c.valid is not None:
            _check_cuda_tensor(c.valid, f"column {i} validity", (torch.bool,), n, device)


def _launch_scan(cols, n, perm, flag, key, aux, reverse, outs, state, field_col,
                 field_op):
    from .cuda.build import load

    device = (perm if perm is not None else flag if flag is not None else key).device
    empty = torch.empty(0, dtype=torch.uint8, device=device)
    blocks = max(1, -(-n // SCAN_TILE))
    load().seg_scan(
        n,
        empty if perm is None else perm,
        empty if flag is None else flag,
        empty if key is None else key,
        empty if aux is None else aux,
        reverse,
        [empty if c.values is None else c.values for c in cols],
        [empty if c.valid is None else c.valid for c in cols],
        [c.src for c in cols],
        [c.op for c in cols],
        [int(c.values is not None and c.values.dtype == I64) for c in cols],
        [empty if o is None else o for o in outs],
        empty if state is None else state,
        list(field_col), list(field_op),
        torch.empty(blocks * len(cols), dtype=I64, device=device),
        torch.empty(blocks * len(cols), dtype=I64, device=device),
        torch.empty(blocks, dtype=torch.uint8, device=device),
    )
    count_launch("seg_scan")


def seg_scan_cuda(
    cols: list, n: int, perm=None, flag=None, key=None, aux=None,
    reverse: bool = False,
) -> list:
    """Launch the hand-written segmented scan (ops/cuda/seg_scan.cu).

    Replaces ``arrow_ballista_tpu/ops/window_kernel.py:_seg_scan``,
    ``_seg_first``/``_seg_last`` and the scan of ``ops/kernels.py:
    _scan_segments``.  Segments start where ``flag`` is set, or where
    ``key[perm[r]]`` changes; returns each column's scan as [n] int64
    words in sorted order."""
    device = (perm if perm is not None else flag if flag is not None else key).device
    _check_scan_args(cols, n, perm, flag, key, aux, device)
    outs = [torch.empty(n, dtype=I64, device=device) for _ in cols]
    _launch_scan(cols, n, perm, flag, key, aux, reverse, outs, None, [], [])
    return outs


def seg_scan(cols, n, perm=None, flag=None, key=None, aux=None, reverse=False):
    """Segmented inclusive scan: the CUDA kernel for CUDA tensors, its
    plain twin for tensors on the CPU."""
    device = (perm if perm is not None else flag if flag is not None else key).device
    if device.type == "cpu":
        return seg_scan_reference(cols, n, perm, flag, key, aux, reverse)
    return seg_scan_cuda(cols, n, perm, flag, key, aux, reverse)


# ------------------------------------------------------------- sort route
def _build_scan_plan(values: list, valids: list, ops: list, cols: list):
    """Scan columns of the sort route and the column each state field reads
    (``field_col``).  A field folds its column's validity into its
    elements; the base mask is the sort key's sentinel.  Count fields over
    the same validity share one column (count(*), an all-valid count and
    presence all count the segment's rows)."""
    columns: list[ScanColumn] = []
    index: dict = {}
    field_col: list[int] = []
    for op, c in zip(ops, cols):
        if op == OP_COUNT:
            valid = valids[c] if c >= 0 else None
            k = ("count", None if valid is None else c)
            col = ScanColumn(SS_COUNT, OP_ADD_I64, valid=valid)
        else:
            k = (op, c)
            col = ScanColumn(SS_VALUES, op, values=values[c], valid=valids[c])
        if k not in index:
            index[k] = len(columns)
            columns.append(col)
        field_col.append(index[k])
    return columns, field_col


def _emit_scan_outs(totals: list, field_col: list, ops: list, state, present):
    """Merge each field's segment totals into ``state`` (twin of the
    kernel's epilogue); groups with no row keep their state."""
    for f, (op, j) in enumerate(zip(ops, field_col)):
        role, is_int = _OP_ROLE[op]
        merged = _merge_row(role, is_int, state[f], totals[j])
        state[f] = torch.where(present, merged, state[f])
    return state


def _sort_key(gid, tail, pred, pvalid, capacity: int) -> torch.Tensor:
    """Group id, or the sentinel ``capacity`` for rows the base mask drops
    (they sort past every group)."""
    mask = None if tail is None else tail
    if pred is not None:
        p = pred if pvalid is None else torch.logical_and(pred, pvalid)
        mask = p if mask is None else torch.logical_and(mask, p)
    if mask is None:
        return gid
    return torch.where(mask, gid, torch.full_like(gid, capacity))


def sorted_segment_agg_reference(
    gid, tail, pred, pvalid, values, valids, ops, cols, state
) -> torch.Tensor:
    """Plain twin of the sort route: the twins of the sort and the scan,
    then ``_scan_segments``' read of each segment's total at its last row
    (boundaries by ``searchsorted``), merged into ``state`` in place."""
    n, capacity = gid.shape[0], state.shape[1]
    key = _sort_key(gid, tail, pred, pvalid, capacity)
    perm = radix_argsort_reference([key])
    columns, field_col = _build_scan_plan(values, valids, ops, cols)
    scanned = seg_scan_reference(columns, n, perm=perm, key=key)
    s2 = key[perm.long()]
    bounds = torch.searchsorted(
        s2, torch.arange(capacity + 1, dtype=s2.dtype, device=s2.device)
    )
    present = (bounds[1:] - bounds[:-1]) > 0
    last = torch.clamp(bounds[1:] - 1, 0, max(n - 1, 0))
    totals = [s[last] if n else s.new_zeros(capacity) for s in scanned]
    return _emit_scan_outs(totals, field_col, ops, state, present)


def sorted_segment_agg_cuda(
    gid, tail, pred, pvalid, values, valids, ops, cols, state
) -> torch.Tensor:
    """The sort route on the card: the radix sort of the group ids, then
    one segmented scan whose epilogue merges every segment's totals into
    ``state`` (ops/cuda/seg_scan.cu).  Replaces ``arrow_ballista_tpu/ops/
    kernels.py:_sorted_segment_agg`` inside ``_fn_sorted``."""
    _check_cuda_args(gid, tail, pred, pvalid, values, valids, ops, cols, state)
    n, capacity = gid.shape[0], state.shape[1]
    if n == 0:
        return state
    key = _sort_key(gid, tail, pred, pvalid, capacity).contiguous()
    perm = radix_argsort_cuda([key])
    columns, field_col = _build_scan_plan(values, valids, ops, cols)
    _check_scan_args(columns, n, perm, None, key, None, state.device)
    _launch_scan(columns, n, perm, None, key, None, False, [None] * len(columns),
                 state, field_col, ops)
    return state


def sorted_segment_agg(gid, tail, pred, pvalid, values, valids, ops, cols, state):
    """The sort route into ``state``: CUDA kernels for CUDA tensors, their
    plain twins for tensors on the CPU.  Same arguments and result as
    :func:`segment_agg`."""
    if len(values) != len(valids) or len(values) > MAX_COLUMNS:
        raise ValueError(f"sorted_segment_agg: {len(values)} columns")
    if len(ops) != len(cols) or len(ops) != state.shape[0] or len(ops) > MAX_FIELDS:
        raise ValueError(f"sorted_segment_agg: {len(ops)} fields")
    if state.device.type == "cpu":
        return sorted_segment_agg_reference(
            gid, tail, pred, pvalid, values, valids, ops, cols, state
        )
    return sorted_segment_agg_cuda(
        gid, tail, pred, pvalid, values, valids, ops, cols, state
    )


def _column(x: Optional[torch.Tensor], n: int, dtype, device):
    """A [n] contiguous tensor of ``dtype`` (scalars broadcast), or None."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=dtype, device=device)
    if x.dim() == 0:
        x = x.expand(n)
    return x.to(dtype).contiguous()


def _agg_layout(specs: list[KernelAggSpec], arg_closures: list):
    """The state-field layout of ``specs``, fixed once per stage function:
    ``(closures, columns, ops, cols)``.  Aggregates whose argument is the
    SAME closure object and dtype share one kernel column (``columns``
    holds (closure index, dtype)); ``ops``/``cols`` give each state field's
    reduction and column, presence last."""
    closures: list[TorchClosure] = []  # distinct argument closures
    columns: list[tuple[int, Optional[torch.dtype]]] = []  # (closure, dtype)
    ops: list[int] = []
    cols: list[int] = []

    def column(closure: TorchClosure, dtype: Optional[torch.dtype]) -> int:
        k = next((i for i, c in enumerate(closures) if c is closure), None)
        if k is None:
            k = len(closures)
            closures.append(closure)
        if (k, dtype) not in columns:
            columns.append((k, dtype))
        return columns.index((k, dtype))

    for spec, closure in zip(specs, arg_closures):
        if spec.func == "count_star":
            ops.append(OP_COUNT)
            cols.append(-1)
            continue
        if spec.func == "count":
            ops.append(OP_COUNT)
            cols.append(column(closure, None))
            continue
        if spec.func in ("sum", "avg"):
            j = column(closure, I64 if spec.int_sum else F64)
            ops.extend([OP_ADD_I64 if spec.int_sum else OP_ADD_F64, OP_COUNT])
        elif spec.func in ("min", "max"):
            j = column(closure, I64 if spec.int_minmax else F64)
            if spec.int_minmax:
                op = OP_MIN_I64 if spec.func == "min" else OP_MAX_I64
            else:
                op = OP_MIN_F64 if spec.func == "min" else OP_MAX_F64
            ops.extend([op, OP_COUNT])
        else:  # the stage rejects every other aggregate at plan time
            raise ValueError(f"kernel agg {spec.func}")
        cols.extend([j, j])
    ops.append(OP_COUNT)  # presence
    cols.append(-1)
    return closures, columns, ops, cols


# ------------------------------------------------ expression program (B3)
# A stage function's filter and distinct aggregate arguments compile, once,
# into one linear register program: register i holds instruction i's value
# (64 bits) and validity bit, equal subtrees share one register, and store
# instructions after the last register write the outputs.  One launch of
# ops/cuda/expr_eval.cu evaluates it for every row of a batch: the
# counterpart of the reference's JaxExprCompiler closures, which XLA inlines
# into its aggregate program.  The closures stay as the lowering's
# specification: expr_program_reference, the plain twin, runs the program
# op by op with the closures' own torch calls.

# Opcodes, in the order of expr_eval.h's ExprOp.
EXPR_OPS = (
    "leaf", "lit", "null", "convert", "cast_i64", "and", "or", "not",
    "eq", "ne", "lt", "le", "gt", "ge", "add", "sub", "mul",
    "div_int", "div_f", "mod_int", "mod_f", "neg", "is_null", "is_not_null",
    "in", "not_in", "select", "abs", "sqrt", "exp", "ln", "log10", "log2",
    "ceil", "floor", "sin", "cos", "tan", "signum", "round", "power", "square",
    "store_value", "store_valid",
)
_EXPR_OP = {name: i for i, name in enumerate(EXPR_OPS)}
DT_BOOL, DT_I64, DT_F64 = 0, 1, 2  # expr_eval.h: ExprDtype
_DT_CODE = {torch.bool: DT_BOOL, I64: DT_I64, F64: DT_F64}
_DT_TORCH = (torch.bool, I64, F64)
EXPR_MAX_INPUTS = 96  # expr_eval.h: kExprMaxInputs
EXPR_MAX_OUTPUTS = 72  # kExprMaxOutputs
EXPR_MAX_INSTR = 1024  # kExprMaxInstr
EXPR_SMEM_LIMIT = 232448  # shared memory one CTA can use on sm_90
_CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge}
_UNARY_F64 = {
    "abs": torch.abs, "sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log,
    "log10": torch.log10, "log2": torch.log2, "ceil": torch.ceil,
    "floor": torch.floor, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "signum": _sign, "round": torch.round,
}
# registers each op reads (a; a, b; a, b, c)
_ARITY = dict.fromkeys(EXPR_OPS, 1)
_ARITY.update(dict.fromkeys(("leaf", "lit", "null"), 0))
_ARITY.update(dict.fromkeys(("and", "or", "add", "sub", "mul", "div_int", "div_f",
                             "mod_int", "mod_f", "power", *_CMP), 2))
_ARITY["select"] = 3
# operand and result dtypes fixed by the op (-1: read from the row)
_FIXED_IN = {"div_int": DT_I64, "mod_int": DT_I64, "div_f": DT_F64, "mod_f": DT_F64,
             "cast_i64": DT_F64, "power": DT_F64, "square": DT_F64,
             **dict.fromkeys(_UNARY_F64, DT_F64)}
_FIXED_OUT = {"div_int": DT_I64, "mod_int": DT_I64, "cast_i64": DT_I64,
              "store_valid": DT_BOOL, "in": DT_BOOL, "not_in": DT_BOOL,
              **dict.fromkeys(_BOOL_OPS, DT_BOOL),
              **dict.fromkeys(("div_f", "mod_f", "power", "square", *_UNARY_F64), DT_F64)}
# ops whose result has no validity (NULL folds into the value)
_NO_VALIDITY = ("lit", "and", "or", "not", "is_null", "is_not_null")


def _validity(rows, leaf_valid) -> list[bool]:
    """Per register of ``rows``: whether it carries a validity, a leaf's
    as ``leaf_valid(its validity slot)`` says; a CASE always does, NULL
    folds into the value of the boolean connectives and IS NULL, and the
    rest carry their operands'."""
    out: list[bool] = []
    for op, _, _, a, b, c, _ in rows:
        name = EXPR_OPS[op]
        if name == "leaf":
            out.append(leaf_valid(b))
        elif name in ("null", "select"):
            out.append(True)
        elif name in _NO_VALIDITY:
            out.append(False)
        else:
            out.append(any(out[r] for r in (a, b, c)[:_ARITY[name]]))
    return out


def _closure_node(closure) -> ExprNode:
    node = getattr(closure, "node", None)
    if not isinstance(node, ExprNode):
        raise ValueError("closure has no expression node")
    return node


class ExprProgram:
    """A stage function's filter and aggregate arguments as one register
    program (kernel B3), built and validated once.

    ``code`` is an int64 [n_instr, 7] table of (op, result dtype, operand
    dtype, a, b, c, imm): rows [0, n_regs) compute register i from
    registers a, b, c (a leaf reads input slots a (value, -1 for none) and
    b (validity); an IN list reads ``consts[b:b + c]``; a literal's value
    is imm), the store rows after them write register a to output slot b.
    Only the registers some store needs are kept.  ``inputs`` names the
    env entry of each input slot; ``stores`` gives each output slot's
    (kind, register, dtype code); ``outputs`` is the map of
    :func:`expr_eval`'s results (pred, pvalid, then values[j] and
    valids[j] per kernel column), each None, ``("value", reg, dtype code,
    slot)``, ``("valid", reg, slot)`` or ``("input", slot, dtype code)``:
    the env tensor itself (a leaf asked for in its own dtype, or its
    validity, as :func:`_column` passes them through).  ``source`` keeps
    the ``(filter closure, closures, columns)`` it was compiled from."""

    def __init__(self, filter_closure, closures: list, columns: list):
        self._rows: list[list[int]] = []
        self._regs: dict = {}
        self._consts: list[int] = []
        self.inputs: list[str] = []
        self.source = (filter_closure, list(closures), list(columns))
        regs = [self._emit(_closure_node(c)) for c in closures]
        pred = None if filter_closure is None else self._emit(_closure_node(filter_closure))
        may_be_valid = _validity(self._rows, lambda slot: True)
        slots: dict = {}

        def value(reg: int, dtype) -> tuple:
            op, dt, _, a = self._rows[reg][:4]
            want = _DT_CODE[dtype]
            if EXPR_OPS[op] == "leaf" and a >= 0 and dt == want:
                return ("input", a, want)
            return ("value", reg, want, slots.setdefault(("value", reg, want), len(slots)))

        def valid(reg: int):
            if not may_be_valid[reg]:
                return None
            row = self._rows[reg]
            if EXPR_OPS[row[0]] == "leaf":
                return ("input", row[4], DT_BOOL)
            return ("valid", reg, slots.setdefault(("valid", reg, DT_BOOL), len(slots)))

        outputs = [None, None] if pred is None else [value(pred, torch.bool), valid(pred)]
        outputs += [None if dt is None else value(regs[k], dt) for k, dt in columns]
        outputs += [valid(regs[k]) for k, _ in columns]
        rows, renum = self._live(self._rows, [reg for _, reg, _ in slots])
        stores = [(kind, renum[reg], dt) for kind, reg, dt in slots]
        outputs = [o if o is None or o[0] == "input" else (o[0], renum[o[1]], *o[2:])
                   for o in outputs]
        n_regs = len(rows)
        for slot, (kind, reg, dt) in enumerate(stores):
            rows.append([_EXPR_OP[f"store_{kind}"], dt, -1, reg, slot, -1, 0])
        self._init(np.asarray(rows, np.int64).reshape(-1, 7),
                   np.asarray(self._consts, np.int64), n_regs, stores, outputs)
        del self._rows, self._regs, self._consts

    @classmethod
    def from_parts(cls, code, consts, inputs, n_regs, stores, outputs) -> "ExprProgram":
        """A program from its tables, validated (ValueError when malformed)."""
        self = cls.__new__(cls)
        self.inputs = list(inputs)
        self.source = None
        self._init(np.asarray(code, np.int64), np.asarray(consts, np.int64),
                   n_regs, list(stores), list(outputs))
        return self

    def _init(self, code, consts, n_regs, stores, outputs) -> None:
        self.code = code
        self.consts = consts
        self.n_regs = int(n_regs)
        self.stores = stores
        self.outputs = outputs
        self._device: dict = {}
        self._lock = threading.Lock()
        self.validate()
        self.code.setflags(write=False)
        self.consts.setflags(write=False)

    # ------------------------------------------------------------ build
    def _row(self, op: str, dt: int, in_dt: int = -1, a: int = -1, b: int = -1,
             c: int = -1, imm: int = 0) -> int:
        self._rows.append([_EXPR_OP[op], dt, in_dt, a, b, c, imm])
        return len(self._rows) - 1

    def _slot(self, name: str) -> int:
        if name not in self.inputs:
            self.inputs.append(name)
        return self.inputs.index(name)

    def _dt(self, reg: int) -> int:
        return self._rows[reg][1]

    def _emit(self, node: ExprNode) -> int:
        reg = self._regs.get(node)
        if reg is not None:
            return reg
        op = node.op
        if op == "error":
            raise RuntimeError(node.const)
        if op == "case":
            reg = self._emit_case(node)
        elif op == "leaf":
            value, valid = node.const
            dt = DT_BOOL if node.dtype is None else _DT_CODE[node.dtype]
            reg = self._row("leaf", dt, -1, -1 if value is None else self._slot(value),
                            self._slot(valid))
        elif op == "lit":
            reg = self._row("lit", _DT_CODE[node.dtype], imm=node.const)
        else:
            a, b, c = ([self._emit(x) for x in node.args] + [-1, -1])[:3]
            dt = _DT_CODE[node.dtype]
            if op in ("in", "not_in"):
                table_dtype, bits = node.const
                b, c = len(self._consts), len(bits)
                self._consts.extend(bits)
                in_dt = _DT_CODE[table_dtype]
            elif op in _CMP:  # torch promotes bool < int64 < float64
                in_dt = max(self._dt(a), self._dt(b))
            elif op in ("add", "sub", "mul", "neg"):
                in_dt = dt
            elif op == "convert":
                in_dt = self._dt(a)
            else:
                in_dt = _FIXED_IN.get(op, -1)
            reg = self._row(op, dt, in_dt, a, b, c)
        self._regs[node] = reg
        return reg

    def _emit_case(self, node: ExprNode) -> int:
        """CASE as the closure folds it: the ELSE (or a NULL) first, then
        one select per WHEN, last to first."""
        dt = _DT_CODE[node.dtype]
        args = list(node.args)
        if node.const:
            acc = self._emit(args.pop())
            if self._dt(acc) != dt:
                acc = self._row("convert", dt, self._dt(acc), acc)
        else:
            acc = self._row("null", dt)
        for w, t in reversed(list(zip(args[0::2], args[1::2]))):
            cond, then = self._emit(w), self._emit(t)
            acc = self._row("select", dt, -1, cond, then, acc)
        return acc

    @staticmethod
    def _live(rows, roots) -> tuple:
        """The rows the ``roots`` registers need, in order, their register
        operands renumbered: ``(rows, old register -> new)``."""
        live = [False] * len(rows)
        for r in roots:
            live[r] = True
        for i in range(len(rows) - 1, -1, -1):
            if live[i]:
                op, _, _, a, b, c, _ = rows[i]
                for r in (a, b, c)[:_ARITY[EXPR_OPS[op]]]:
                    live[r] = True
        renum: dict = {}
        out = []
        for i, row in enumerate(rows):
            if live[i]:
                renum[i] = len(out)
                row = list(row)
                k = _ARITY[EXPR_OPS[row[0]]]
                row[3:3 + k] = [renum[r] for r in row[3:3 + k]]
                out.append(row)
        return out, renum

    # -------------------------------------------------------- validation
    def validate(self) -> None:
        """Raise ValueError unless every row, slot and output is well
        formed; nothing malformed reaches a launch.  A program whose tables
        are the ones last validated (the arrays are read-only) passes at
        once."""
        key = (id(self.code), id(self.consts), id(self.inputs), id(self.stores),
               id(self.outputs), self.n_regs)
        if getattr(self, "_valid_key", None) == key:
            return
        code = self.code
        if code.dtype != np.int64 or code.ndim != 2 or code.shape[1] != 7:
            raise ValueError("expr program: code must be int64 [n_instr, 7]")
        if self.consts.dtype != np.int64 or self.consts.ndim != 1:
            raise ValueError("expr program: consts must be int64 [n]")
        n_regs, n_in = self.n_regs, len(self.inputs)
        if not 0 <= n_regs <= len(code):
            raise ValueError(f"expr program: {n_regs} registers")
        rows = code.tolist()
        seen: set = set()
        for i, (op, dt, in_dt, a, b, c, _imm) in enumerate(rows):
            if not 0 <= op < len(EXPR_OPS):
                raise ValueError(f"expr program: row {i}: opcode {op}")
            name = EXPR_OPS[op]
            where = f"expr program: row {i} ({name})"
            if name.startswith("store_") != (i >= n_regs):
                raise ValueError(f"{where}: out of place")
            if dt not in (DT_BOOL, DT_I64, DT_F64) or dt != _FIXED_OUT.get(name, dt):
                raise ValueError(f"{where}: result dtype {dt}")
            for r in (a, b, c)[:_ARITY[name]]:
                if not 0 <= r < min(i, n_regs):
                    raise ValueError(f"{where}: register {r}")
            fixed = _FIXED_IN.get(name)
            if fixed is not None and in_dt != fixed:
                raise ValueError(f"{where}: operand dtype {in_dt}")
            if name == "leaf" and not (-1 <= a < n_in and 0 <= b < n_in):
                raise ValueError(f"{where}: input slots {a}, {b}")
            if name in ("in", "not_in") and (
                in_dt not in (DT_I64, DT_F64) or b < 0 or c < 0
                or b + c > len(self.consts)
            ):
                raise ValueError(f"{where}: table {b}+{c} of {len(self.consts)}")
            if name in (*_CMP, "convert") and in_dt not in (DT_BOOL, DT_I64, DT_F64):
                raise ValueError(f"{where}: operand dtype {in_dt}")
            if name in ("add", "sub", "mul", "neg") and (
                in_dt != dt or (dt == DT_BOOL and name in ("sub", "neg"))
            ):
                raise ValueError(f"{where}: dtype {dt}")
            if name == "select" and rows[c][1] != dt:
                raise ValueError(f"{where}: ELSE dtype {rows[c][1]}")
            if name.startswith("store_"):
                if not 0 <= b < len(self.stores) or tuple(self.stores[b]) != (name[6:], a, dt):
                    raise ValueError(f"{where}: output slot {b}")
                if b in seen:
                    raise ValueError(f"{where}: output slot {b} stored twice")
                seen.add(b)
        if len(seen) != len(self.stores):
            raise ValueError("expr program: an output slot is never stored")
        for out in self.outputs:
            if out is None:
                continue
            if out[0] == "input":
                if not (0 <= out[1] < n_in and out[2] in (DT_BOOL, DT_I64, DT_F64)):
                    raise ValueError(f"expr program: output {out}")
                continue
            kind, reg, slot = out[0], out[1], out[-1]
            dt = out[2] if kind == "value" else DT_BOOL
            if not (0 <= slot < len(self.stores)
                    and tuple(self.stores[slot]) == (kind, reg, dt)):
                raise ValueError(f"expr program: output {out} is not stored")
        self._regs_rows = rows[:n_regs]
        # (slot, dtype, may be None) of every input a leaf reads or an
        # output passes on: what the kernel's wrapper checks each batch
        leaves = [r for r in self._regs_rows if EXPR_OPS[r[0]] == "leaf"]
        self._reads = [(r[3], r[1], False) for r in leaves if r[3] >= 0]
        self._reads += [(r[4], DT_BOOL, True) for r in leaves]
        self._reads += [(o[1], o[2], self.inputs[o[1]].endswith("__valid"))
                        for o in self.outputs if o is not None and o[0] == "input"]
        self._valid_key = key

    # ---------------------------------------------------------- runtime
    def presence(self, inputs: list) -> list[bool]:
        """Per register: whether its validity is present for this batch's
        inputs (a leaf's env validity None is absent), as the closures'
        ``_merge_valid`` would leave it."""
        return _validity(self._regs_rows, lambda slot: inputs[slot] is not None)

    def constant(self, key, value, dtype, device) -> torch.Tensor:
        """A 0-d (or table) constant on ``device``, made once, as
        :func:`_const` makes the closures' constants."""
        k = (key, torch.device(device))
        t = self._device.get(k)
        if t is None:
            t = self._device.setdefault(k, torch.tensor(value, dtype=dtype).to(device))
        return t

    def device_words(self, device) -> torch.Tensor:
        """The code (as expr_eval.h's 32-byte ExprInstr rows, the operand
        registers' dtypes packed beside the opcode) and the constants in
        one int64 tensor on ``device``, copied once."""
        k = ("words", torch.device(device))
        t = self._device.get(k)
        if t is None:
            with self._lock:
                t = self._device.get(k)
                if t is None:
                    n = len(self.code)
                    rows = np.zeros((n, 8), np.int32)
                    rows[:, :6] = self.code[:, :6]
                    for i, (op, _, _, *regs) in enumerate(self.code[:, :6].tolist()):
                        for j, r in enumerate(regs[:_ARITY[EXPR_OPS[op]]]):
                            rows[i, 0] |= int(self.code[r, 1]) << (8 * (j + 1))
                    rows[:, 6:] = np.ascontiguousarray(self.code[:, 6]).view(np.int32).reshape(n, 2)
                    words = np.concatenate([rows.view(np.int64).reshape(-1), self.consts])
                    t = self._device[k] = torch.from_numpy(words).to(device)
        return t

    def layout(self, get) -> tuple:
        """``(pred, pvalid, values, valids)`` from ``get(output)``."""
        outs = [None if o is None else get(o) for o in self.outputs]
        k = (len(outs) - 2) // 2
        return outs[0], outs[1], outs[2:2 + k], outs[2 + k:]


def _fold_valid(v: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """A boolean operand with NULL as false (the closures' Kleene fold)."""
    return v if valid is None else torch.logical_and(v, valid)


def expr_program_reference(program: ExprProgram, env: dict, n: int, device) -> tuple:
    """Plain PyTorch twin of the expression kernel: the program run row by
    row with the closures' own torch calls (so bit for bit what the
    closures give on the same device), each output laid out by
    :func:`_column` as the stage functions always did.  Returns ``(pred,
    pvalid, values, valids)``."""
    program.validate()
    vals: list = []
    valids: list = []
    for i, (op, dt, in_dt, a, b, c, imm) in enumerate(program.code[: program.n_regs].tolist()):
        name = EXPR_OPS[op]
        dtype = _DT_TORCH[dt]
        val = None
        if name == "leaf":
            v = None if a < 0 else env[program.inputs[a]]
            val = env[program.inputs[b]]
        elif name == "lit":
            value = np.int64(imm).view(np.float64).item() if dt == DT_F64 else imm
            v = program.constant(i, bool(value) if dt == DT_BOOL else value, dtype, device)
        elif name == "null":
            v = program.constant(i, 0, dtype, device)
            val = program.constant("false", False, torch.bool, device)
        elif name in ("and", "or"):
            f = torch.logical_and if name == "and" else torch.logical_or
            v = f(_fold_valid(vals[a], valids[a]), _fold_valid(vals[b], valids[b]))
        elif name == "not":
            v = torch.logical_not(_fold_valid(vals[a], valids[a]))
        elif name in ("is_null", "is_not_null"):
            negated = name == "is_not_null"
            if valids[a] is None:
                v = program.constant("false", False, torch.bool, device)
                v = torch.logical_not(v) if negated else v
            else:
                v = valids[a] if negated else torch.logical_not(valids[a])
        elif name in ("in", "not_in"):
            table = program.constant(("table", i), program.consts[b:b + c].tolist(), I64, device)
            lhs = vals[a].to(_DT_TORCH[in_dt])
            m = torch.eq(lhs.reshape(-1, 1), table.view(lhs.dtype)[None, :]).any(dim=1)
            v, val = (torch.logical_not(m) if name == "not_in" else m), valids[a]
        elif name == "select":
            cond, cval = vals[a], valids[a]
            cond = cond.to(torch.bool) if cval is None else torch.logical_and(cond, cval)
            true = program.constant("true", True, torch.bool, device)
            v = torch.where(cond, vals[b].to(dtype), vals[c])
            val = torch.where(cond, true if valids[b] is None else valids[b],
                              true if valids[c] is None else valids[c])
        else:
            x = vals[a]
            y = vals[b] if _ARITY[name] == 2 else None
            if name in _CMP or name in _ARITH:
                v = (_CMP.get(name) or _ARITH[name])(*_numeric_align(x, y))
            elif name == "div_int":
                v = _trunc_div(x, y)
            elif name == "div_f":
                v = x.to(F64) / y.to(F64)
            elif name in ("mod_int", "mod_f"):
                v = _floor_mod(x, y)
            elif name == "power":
                v = torch.pow(x.to(F64), y.to(F64))
            elif name == "neg":
                v = -x
            elif name == "convert":
                v = x.to(dtype)
            elif name == "cast_i64":
                v = _cast(x, I64)
            elif name == "square":
                x = x.to(F64)
                v = x * x
            else:
                v = _UNARY_F64[name](x.to(F64))
            val = valids[a] if y is None else _merge_valid(valids[a], valids[b])
        vals.append(v)
        valids.append(val)

    def get(out):
        if out[0] == "input":
            return _column(env[program.inputs[out[1]]], n, _DT_TORCH[out[2]], device)
        if out[0] == "value":
            return _column(vals[out[1]], n, _DT_TORCH[out[2]], device)
        return _column(valids[out[1]], n, torch.bool, device)

    return program.layout(get)


def closures_layout(program: ExprProgram, env: dict, n: int, device) -> tuple:
    """The lowering's specification: the closures ``program`` was compiled
    from, run as torch ops over ``env`` and laid out as
    :func:`expr_program_reference` lays its registers out (the tests and
    the smoke hold the twin and the kernel against it)."""
    filter_closure, closures, columns = program.source
    env = dict(env)
    env[DEVICE] = device
    pred = pvalid = None
    if filter_closure is not None:
        p, pv = filter_closure(env)
        pred = _column(p, n, torch.bool, device)
        pvalid = _column(pv, n, torch.bool, device)
    evaluated = [c(env) for c in closures]
    values = [
        None if dtype is None else _column(evaluated[k][0], n, dtype, device)
        for k, dtype in columns
    ]
    valids = [_column(evaluated[k][1], n, torch.bool, device) for k, _ in columns]
    return pred, pvalid, values, valids


def _check_expr_args(program: ExprProgram, inputs: list, n: int, device) -> None:
    """Raise ValueError unless the program fits the kernel (instructions,
    input and output slots, shared memory at 32 threads a CTA) and every
    input slot holds what its leaf reads: a contiguous [n] tensor on
    ``device`` of the leaf's dtype, a validity bool or None.  Checked here,
    before the binding, like every kernel's inputs."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"expr_eval: device {dev} is not CUDA")
    n_instr = len(program.code)
    smem = n_instr * 32 + program.n_regs * 32 * 9
    if (n_instr > EXPR_MAX_INSTR or smem > EXPR_SMEM_LIMIT
            or len(inputs) > EXPR_MAX_INPUTS or len(program.stores) > EXPR_MAX_OUTPUTS):
        raise ValueError(
            f"expr_eval: {n_instr} instructions, {program.n_regs} registers, "
            f"{len(inputs)} inputs, {len(program.stores)} outputs exceed the kernel"
        )

    def bad(x, dtype) -> bool:
        return (not isinstance(x, torch.Tensor) or x.device.type != dev.type
                or (dev.index is not None and x.device.index != dev.index)
                or x.dtype != dtype or tuple(x.shape) != (n,) or not x.is_contiguous())

    for slot, dt, optional in program._reads:
        x = inputs[slot]
        if not (optional and x is None) and bad(x, _DT_TORCH[dt]):
            raise ValueError(f"expr_eval: {program.inputs[slot]} must be contiguous "
                             f"{_DT_TORCH[dt]} [{n}] on {dev}")


def expr_eval_cuda(program: ExprProgram, env: dict, n: int, device) -> tuple:
    """Launch the hand-written expression kernel (``ops/cuda/expr_eval.cu``):
    one launch writes every output the program computes for the batch's
    ``n`` rows; a leaf asked for in its own dtype is the env tensor itself,
    and a validity that no input carries stays None.  Returns ``(pred,
    pvalid, values, valids)``.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:JaxExprCompiler`` (the
    closures XLA inlines into the aggregate program).  The program and the
    inputs are checked first (ValueError); a failed build or launch raises,
    and nothing falls back to the twin or the closures.  A program that
    computes nothing (every output an env tensor) launches nothing."""
    from .cuda.build import load

    program.validate()
    inputs = [env[name] for name in program.inputs]
    _check_expr_args(program, inputs, n, device)
    present = program.presence(inputs)
    outs = [
        torch.empty(n, dtype=_DT_TORCH[dt], device=device)
        if kind == "value" or present[reg] else None
        for kind, reg, dt in program.stores
    ]
    if n and any(t is not None for t in outs):
        empty = torch.empty(0, dtype=torch.bool, device=device)
        load().expr_eval(
            program.device_words(device), len(program.code), program.n_regs,
            [empty if t is None else t for t in inputs],
            [empty if t is None else t for t in outs], n,
        )
        count_launch("expr_eval")
    return program.layout(lambda out: inputs[out[1]] if out[0] == "input" else outs[out[-1]])


def expr_eval(program: ExprProgram, env: dict, n: int, device) -> tuple:
    """The stage's filter and argument columns over one batch's env, as
    ``(pred, pvalid, values, valids)`` (each a [n] tensor or None): the CUDA
    kernel on a CUDA device, its plain twin on the CPU."""
    if torch.device(device).type == "cpu":
        return expr_program_reference(program, env, n, device)
    return expr_eval_cuda(program, env, n, device)


def make_partial_agg_kernel(
    filter_closure: Optional[TorchClosure],
    arg_closures: list[Optional[TorchClosure]],
    specs: list[KernelAggSpec],
    capacity: int,
    flat_names: list[str],
    algo: str = "scatter",
):
    """Build the fused filter → project → segment-aggregate function.

    Returns ``fn(seg_ids, valid, *leaf_arrays, state=None) -> state``: the
    expression program (:func:`expr_eval`, one launch) computes the mask
    and the argument columns on the arrays' device, then one
    :func:`segment_agg` folds the masks, reduces every aggregate per group
    and merges into ``state`` (a fresh identity state when None), which is
    returned.  Per-agg state layout is :func:`state_fields` — sum/avg →
    (sum, n), min/max → (value, n), count/count_star → (n,) — and the last
    row is presence, the count of mask-passing rows per group.

    The field layout is fixed here, once (:func:`_agg_layout`), and each
    distinct argument is one column.  ``algo`` picks the reduction
    route (:func:`segment_algo`): "scatter" (:func:`segment_agg`) or "sort"
    (:func:`sorted_segment_agg`); both merge into the same state.
    """
    if algo not in ("scatter", "sort"):
        raise ValueError(f"agg algorithm {algo!r}")
    reduce = sorted_segment_agg if algo == "sort" else segment_agg
    closures, columns, ops, cols = _agg_layout(specs, arg_closures)
    program = ExprProgram(filter_closure, closures, columns)

    def fn(seg_ids, valid, *arrays, state=None):
        device = seg_ids.device
        n = seg_ids.shape[0]
        env = dict(zip(flat_names, arrays))
        pred, pvalid, values, valids = expr_eval(program, env, n, device)
        if state is None:
            state = init_states(specs, capacity, device)
        return reduce(seg_ids, valid, pred, pvalid, values, valids, ops, cols, state)

    return fn


def make_entries_agg_kernel(
    filter_closure: Optional[TorchClosure],
    arg_closures: list[Optional[TorchClosure]],
    specs: list[KernelAggSpec],
    capacity: int,
    flat_names: list[str],
):
    """The multi-entry counterpart of :func:`make_partial_agg_kernel` (its
    scatter route): ``fn(entries) -> state`` over retained ``(gid, tail,
    leaf arrays)`` entries runs the expression program over every entry,
    then ONE :func:`segment_agg_entries` folds all of them into a fresh
    identity state at ``capacity``.  The program's outputs of every entry
    are alive together until that call returns."""
    closures, columns, ops, cols = _agg_layout(specs, arg_closures)
    program = ExprProgram(filter_closure, closures, columns)

    def fn(entries: list) -> torch.Tensor:
        rows = []
        for gid, tail, arrays in entries:
            env = dict(zip(flat_names, arrays))
            pred, pvalid, values, valids = expr_eval(program, env, gid.shape[0], gid.device)
            rows.append((gid, tail, pred, pvalid, values, valids))
        state = init_states(specs, capacity, entries[0][0].device)
        return segment_agg_entries(rows, ops, cols, state)

    return fn


# ------------------------------------------------ shuffle partition ids (B4)
PID_MAX_PARTITIONS = 1 << 16  # the reference's bound for the device hash
_HASH_MUL = 0x9E3779B97F4A7C15  # the host partitioner's multiplier
_NULL_HASH = 0xA5A5A5A5DEADBEEF  # the host partitioner's null hash
_MASK32 = 0xFFFFFFFF


def _signed64(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def _pid_bits(v: pa.Array) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """``(bits, is_null)`` of one key column: the raw 64-bit pattern each
    value hashes as, viewed as int64, and the null flags — the value prep of
    ``exec/operators.py:hash_partition_indices`` (the reference's
    ``_pid_limbs``, as one word instead of two uint32 limbs), or None when
    the type has no device hash (strings hash FNV over bytes on the host)."""
    import pyarrow.compute as pc

    t = v.type
    if not (
        pa.types.is_integer(t)
        or pa.types.is_floating(t)
        or pa.types.is_boolean(t)
        or pa.types.is_date(t)
        or pa.types.is_timestamp(t)
    ):
        return None
    is_null = (
        np.asarray(pc.is_null(v))
        if v.null_count
        else np.zeros(len(v), dtype=bool)
    )
    if pa.types.is_date32(t):
        v = v.cast(pa.int32())
    elif pa.types.is_date64(t) or pa.types.is_timestamp(t):
        v = v.cast(pa.int64())
    elif pa.types.is_boolean(t):
        v = v.cast(pa.int8())
    if v.null_count:
        v = v.fill_null(0)
    x = np.asarray(v)
    if x.dtype.kind == "f":
        x = x if x.dtype == np.float64 else x.astype(np.float64)
        return x.view(np.int64), is_null
    return x.astype(np.int64), is_null


def partition_ids_twin(bits: torch.Tensor, nulls: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain PyTorch twin of the partition-id kernel: ``bits`` int64
    ``[n_cols, n]``, ``nulls`` bool ``[n_cols, n]`` → int32 ``[n]``.

    torch has no shifts on uint64, so the u64 arithmetic runs in int64:
    multiply and add wrap mod 2^64 alike, a logical shift is an arithmetic
    one masked to its low 32 bits, and the unsigned ``h mod n`` goes through
    the non-negative halves: ``((hi % n) * (2^32 % n) + lo % n) % n``."""
    h = torch.zeros(bits.shape[1], dtype=I64, device=bits.device)
    null_hash = torch.tensor(_signed64(_NULL_HASH), dtype=I64, device=bits.device)
    for c in range(bits.shape[0]):
        hv = bits[c] * _signed64(_HASH_MUL)
        hv = hv ^ ((hv >> 32) & _MASK32)
        hv = torch.where(nulls[c], null_hash, hv)
        h = h * 31 + hv
    hi, lo = (h >> 32) & _MASK32, h & _MASK32
    pid = ((hi % n_out) * ((1 << 32) % n_out) + lo % n_out) % n_out
    return pid.to(torch.int32)


def _check_pid_args(bits, nulls, n_out: int) -> None:
    """ValueError unless the kernel takes these inputs (checked before the
    binding: an exception inside the extension may end the process)."""
    if not (
        isinstance(bits, torch.Tensor) and bits.device.type == "cuda"
        and bits.dtype == I64 and bits.dim() == 2 and bits.is_contiguous()
        and bits.shape[0] >= 1
    ):
        raise ValueError("bits must be a contiguous CUDA int64 [n_cols, n] tensor, n_cols >= 1")
    if not (
        isinstance(nulls, torch.Tensor) and nulls.device == bits.device
        and nulls.dtype == torch.bool and nulls.shape == bits.shape
        and nulls.is_contiguous()
    ):
        raise ValueError(f"nulls must be a contiguous bool {tuple(bits.shape)} tensor on {bits.device}")
    if not 1 <= n_out <= PID_MAX_PARTITIONS:
        raise ValueError(f"n_out {n_out} outside 1..{PID_MAX_PARTITIONS}")


def partition_ids_cuda(bits: torch.Tensor, nulls: torch.Tensor, n_out: int) -> torch.Tensor:
    """Launch the hand-written partition-id kernel (ops/cuda/partition_id.cu).

    Replaces ``arrow_ballista_tpu/ops/kernels.py:partition_id_hash`` and
    ``make_partition_id_kernel``.  Inputs are checked first (ValueError);
    a failed build or launch raises — nothing falls back to the host hash."""
    from .cuda.build import load

    _check_pid_args(bits, nulls, int(n_out))
    ext = load()
    out = torch.empty(bits.shape[1], dtype=torch.int32, device=bits.device)
    ext.partition_ids(bits, nulls, int(n_out), out)
    count_launch("partition_ids")
    return out


def partition_ids(bits: torch.Tensor, nulls: torch.Tensor, n_out: int) -> torch.Tensor:
    """Partition id of each row: the CUDA kernel for CUDA tensors, its
    plain twin for tensors on the CPU."""
    if bits.device.type == "cpu":
        return partition_ids_twin(bits, nulls, n_out)
    return partition_ids_cuda(bits, nulls, n_out)


def device_partition_ids(
    batch: pa.RecordBatch, exprs, n: int, device
) -> Optional[np.ndarray]:
    """int32 partition ids of ``batch``'s rows under hash partitioning by
    ``exprs`` into ``n`` partitions, computed on ``device``; None under the
    reference's gates (a non-column expression, a key without a device
    hash, ``n`` outside 1..2^16, an empty batch), where the writer runs
    the host partitioner.  Bit-identical to ``hash_partition_indices``."""
    if n <= 0 or n > PID_MAX_PARTITIONS or batch.num_rows == 0:
        return None
    cols = []
    for e in exprs:
        if not isinstance(e, pe.Col) or not (0 <= e.index < batch.num_columns):
            return None
        prep = _pid_bits(batch.column(e.index))
        if prep is None:
            return None
        cols.append(prep)
    if not cols:
        return None
    bits = torch.from_numpy(np.stack([b for b, _ in cols])).to(device)
    nulls = torch.from_numpy(np.stack([m for _, m in cols])).to(device)
    return partition_ids(bits, nulls, n).cpu().numpy()


def pid_key_bits(arrays: list, width: int, device) -> Optional[tuple]:
    """``(bits, nulls)`` of the decoded group keys ``arrays`` (one pa.Array
    per hint key, in hint order), each row padded with zeros to ``width``:
    the partition-id kernel's operands on ``device``, or None when a key
    has no device hash."""
    bits = np.zeros((len(arrays), width), dtype=np.int64)
    nulls = np.zeros((len(arrays), width), dtype=bool)
    for k, arr in enumerate(arrays):
        prep = _pid_bits(arr)
        if prep is None:
            return None
        bits[k, :len(arr)], nulls[k, :len(arr)] = prep
    return torch.from_numpy(bits).to(device), torch.from_numpy(nulls).to(device)


def fetch_states_with_pids(
    state: torch.Tensor, keep: int, bits: torch.Tensor, nulls: torch.Tensor, n_out: int
) -> tuple[np.ndarray, np.ndarray]:
    """ONE device→host copy of the first ``keep`` state columns plus one row
    of partition ids (:func:`partition_ids` over ``bits``/``nulls``, whose
    width is that ``keep``, capped at the capacity): ``(states, pids)``."""
    keep = min(keep, state.shape[1])
    buf = torch.empty((state.shape[0] + 1, keep), dtype=I64, device=state.device)
    buf[:-1] = state[:, :keep]
    buf[-1] = partition_ids(bits, nulls, n_out)
    host = buf.cpu().numpy()
    return host[:-1], host[-1]


# ------------------------------------------------------- device join (B5)
JOIN_MAX_COLUMNS = 32  # build columns one probe gathers (join_probe.h)
_JOIN_VALUE_DTYPES = (F64, I64, torch.bool)  # the bridge's device dtypes


def join_build_table_twin(bkeys: torch.Tensor, kmin: int, span: int) -> torch.Tensor:
    """Plain PyTorch twin of the dense slot-table kernel: int32 ``[span]``
    holding ``row + 1`` at slot ``bkeys[row] - kmin`` and 0 (no such key)
    everywhere else (the reference's eager scatter in ``_prepare_build``)."""
    m = bkeys.shape[0]
    tbl = torch.zeros(span, dtype=torch.int32, device=bkeys.device)
    tbl[bkeys - kmin] = torch.arange(1, m + 1, dtype=torch.int32, device=bkeys.device)
    return tbl


def _check_build_args(bkeys, kmin: int, span: int) -> None:
    """ValueError unless the slot-table kernel takes these inputs (checked
    before the binding: an exception inside the extension may end the
    process)."""
    if not (
        isinstance(bkeys, torch.Tensor) and bkeys.device.type == "cuda"
        and bkeys.dtype == I64 and bkeys.dim() == 1 and bkeys.is_contiguous()
        and 1 <= bkeys.shape[0] < (1 << 31)
    ):
        raise ValueError("bkeys must be a contiguous CUDA int64 [m] tensor, 1 <= m < 2^31")
    if not -(1 << 63) <= kmin < (1 << 63):
        raise ValueError(f"kmin {kmin} outside int64")
    if not 1 <= span <= (1 << 31) - 1:
        raise ValueError(f"table of {span} slots")


def join_build_table_cuda(bkeys: torch.Tensor, kmin: int, span: int) -> torch.Tensor:
    """Launch the hand-written slot-table kernel (ops/cuda/join_probe.cu).

    Replaces the eager ``jnp.zeros(span).at[slots].set(rows)`` scatter of
    ``arrow_ballista_tpu/ops/stage_compiler.py:_prepare_build`` (B5a).
    ``bkeys`` are unique, so the scatter has no conflicts; a key outside
    ``[kmin, kmin + span)`` is skipped.  A failed build or launch raises."""
    from .cuda.build import load

    kmin, span = int(kmin), int(span)
    _check_build_args(bkeys, kmin, span)
    ext = load()
    out = torch.empty(span, dtype=torch.int32, device=bkeys.device)
    ext.join_build_table(bkeys, kmin, out)
    count_launch("join_build_table")
    return out


def join_build_table(bkeys: torch.Tensor, kmin: int, span: int) -> torch.Tensor:
    """Dense slot table of the unique build keys: the CUDA kernel for CUDA
    tensors, its plain twin for tensors on the CPU."""
    if bkeys.device.type == "cpu":
        return join_build_table_twin(bkeys, kmin, span)
    return join_build_table_cuda(bkeys, kmin, span)


def join_probe_twin(pkey, pkey_valid, valid, bvals, bvalids, table=None, kmin=0,
                    bkeys=None):
    """Plain PyTorch twin of the probe kernel (the reference's arithmetic in
    ``make_join_kernel``).  Returns ``(values, validities, mask)``: each
    build column gathered at the probe row's build row, its validity ANDed
    with the match, and ``valid`` (None = every row) ANDed with the match.

    Dense form (``table``): ``rel = pkey - kmin`` in int64, a match where
    ``0 <= rel < span``, ``table[rel] > 0`` and the key is valid; the build
    row is ``max(table[clip(rel)] - 1, 0)``.  Sorted form (``bkeys``, sorted
    unique): the row is ``clip(searchsorted(bkeys, pkey, 'left'), 0, m-1)``,
    a match where ``bkeys[row] == pkey`` and the key is valid.  Unmatched
    rows carry the values at that clamped row."""
    if table is not None:
        span = table.shape[0]
        rel = pkey - int(kmin)
        inb = (rel >= 0) & (rel < span)
        slot = table[rel.clamp(0, span - 1)]
        match = inb & (slot > 0)
        idx = (slot.to(I64) - 1).clamp(min=0)
    else:
        m = bkeys.shape[0]
        idx = torch.searchsorted(bkeys, pkey).clamp(0, max(m - 1, 0))
        match = bkeys[idx] == pkey
    if pkey_valid is not None:
        match = match & pkey_valid
    vals = [v[idx] for v in bvals]
    valids = [match if bv is None else bv[idx] & match for bv in bvalids]
    mask = match if valid is None else valid & match
    return vals, valids, mask


def _check_probe_args(pkey, pkey_valid, valid, bvals, bvalids, table, kmin, bkeys):
    """ValueError unless the probe kernel takes these inputs (checked before
    the binding: an exception inside the extension may end the process)."""
    if not (
        isinstance(pkey, torch.Tensor) and pkey.device.type == "cuda"
        and pkey.dtype == I64 and pkey.dim() == 1 and pkey.is_contiguous()
    ):
        raise ValueError("pkey must be a contiguous CUDA int64 [n] tensor")
    device, n = pkey.device, pkey.shape[0]
    for name, m in (("pkey_valid", pkey_valid), ("valid", valid)):
        if m is not None:
            _check_cuda_tensor(m, name, (torch.bool,), n, device)
    if (table is None) == (bkeys is None):
        raise ValueError("give exactly one of table (dense) and bkeys (sorted)")
    if table is not None:
        if not isinstance(table, torch.Tensor) or table.dim() != 1:
            raise ValueError("table must be a 1-D tensor")
        m = table.shape[0]
        _check_cuda_tensor(table, "table", (torch.int32,), m, device)
        if m < 1:
            raise ValueError("empty slot table")
        if not -(1 << 63) <= int(kmin) < (1 << 63):
            raise ValueError(f"kmin {kmin} outside int64")
    else:
        if not isinstance(bkeys, torch.Tensor) or bkeys.dim() != 1:
            raise ValueError("bkeys must be a 1-D tensor")
        m = bkeys.shape[0]
        _check_cuda_tensor(bkeys, "bkeys", (I64,), m, device)
        if m < 1:
            raise ValueError("empty build keys")
    if len(bvals) != len(bvalids) or len(bvals) > JOIN_MAX_COLUMNS:
        raise ValueError(f"{len(bvals)} build columns, {len(bvalids)} validities")
    rows = bvals[0].shape[0] if bvals else 0
    for c, (v, bv) in enumerate(zip(bvals, bvalids)):
        if not isinstance(v, torch.Tensor) or v.dim() != 1:
            raise ValueError(f"build column {c} must be a 1-D tensor")
        _check_cuda_tensor(v, f"build column {c}", _JOIN_VALUE_DTYPES, rows, device)
        if bv is not None:
            _check_cuda_tensor(bv, f"build validity {c}", (torch.bool,), rows, device)
    if bvals and (rows < 1 or (bkeys is not None and rows != bkeys.shape[0])):
        raise ValueError(f"build columns of {rows} rows")


def join_probe_cuda(pkey, pkey_valid, valid, bvals, bvalids, table=None, kmin=0,
                    bkeys=None):
    """Launch the hand-written probe kernel (ops/cuda/join_probe.cu): the
    dense or the sorted form, with the same outputs as
    :func:`join_probe_twin`, bit for bit.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:make_join_kernel`` (B5b
    dense, B5c sorted).  Inputs are checked first (ValueError); a failed
    build or launch raises — nothing falls back to a library search or to
    the CPU.  With a dense table, the build rows it holds must index the
    build columns (the stage builds both from one build side)."""
    from .cuda.build import load

    bvals, bvalids = list(bvals), list(bvalids)
    _check_probe_args(pkey, pkey_valid, valid, bvals, bvalids, table, kmin, bkeys)
    ext = load()
    n, device = pkey.shape[0], pkey.device
    empty = torch.empty(0, dtype=torch.bool, device=device)
    vals = [torch.empty(n, dtype=v.dtype, device=device) for v in bvals]
    valids = [torch.empty(n, dtype=torch.bool, device=device) for _ in bvals]
    mask = torch.empty(n, dtype=torch.bool, device=device)
    ext.join_probe(
        pkey,
        empty if pkey_valid is None else pkey_valid,
        empty if valid is None else valid,
        torch.empty(0, dtype=torch.int32, device=device) if table is None else table,
        int(kmin),
        torch.empty(0, dtype=I64, device=device) if bkeys is None else bkeys,
        bvals,
        [empty if bv is None else bv for bv in bvalids],
        vals, valids, mask,
    )
    count_launch("join_probe")
    return vals, valids, mask


def join_probe(pkey, pkey_valid, valid, bvals, bvalids, table=None, kmin=0, bkeys=None):
    """PK-FK probe of one batch (see :func:`join_probe_twin`): the CUDA
    kernel for CUDA tensors, its plain twin for tensors on the CPU."""
    if pkey.device.type == "cpu":
        return join_probe_twin(pkey, pkey_valid, valid, bvals, bvalids, table, kmin, bkeys)
    return join_probe_cuda(pkey, pkey_valid, valid, bvals, bvalids, table, kmin, bkeys)


def make_join_kernel(inner_fn, flat_names: list[str], join_slots: dict[str, int],
                     n_build: int, dense: bool = False):
    """Wrap a stage function with the on-device PK-FK probe join.

    ``join_slots`` maps flat arg NAMES that come from the build side to
    their index in the build-column lists.  The wrapped signature is::

        fn(seg, valid, *probe_args, pkey, pkey_valid,
           bkeys, *bvals, *bvalids, state=None)        # sorted form
        fn(seg, valid, *probe_args, pkey, pkey_valid,
           table, kmin, *bvals, *bvalids, state=None)  # dense form

    where ``probe_args`` are the batch's tensors for the NON-join flat names
    (in order) and ``pkey`` is its probe join key (int64).  One
    :func:`join_probe` gathers the build columns and folds the misses into
    the row mask, then ``inner_fn`` runs unchanged on the full argument
    list, so the joined relation is never materialised."""
    n_probe = sum(1 for n in flat_names if n not in join_slots)
    head = 4 if dense else 3

    def fn(seg_ids, valid, *args, state=None):
        probe_args = args[:n_probe]
        pkey, pkey_valid = args[n_probe:n_probe + 2]
        if dense:
            form = dict(table=args[n_probe + 2], kmin=args[n_probe + 3])
        else:
            form = dict(bkeys=args[n_probe + 2])
        bvals = list(args[n_probe + head:n_probe + head + n_build])
        bvalids = list(args[n_probe + head + n_build:])
        vals, valids, mask = join_probe(pkey, pkey_valid, valid, bvals, bvalids, **form)
        full = []
        it = iter(probe_args)
        for name in flat_names:
            j = join_slots.get(name)
            if j is None:
                full.append(next(it))
            elif name.endswith("__valid"):
                full.append(valids[j])
            else:
                full.append(vals[j])
        return inner_fn(seg_ids, mask, *full, state=state)

    return fn


# ------------------------------------------------- keyed route (B7-B10)
# The keyed aggregation: the host never assigns group ids.  Per batch the
# prep runs the filter (and the join probe) and the key encode kernel
# (B7a) turns the raw key columns into codes and the inverted row mask
# into the sort's major key; those buffer on the device.  At the end of
# the stream ONE stable radix sort (K1) orders the rows by (not mask,
# *codes), the gid kernel (B7b) numbers the groups from key changes, K2
# reduces every aggregate into the state with its epilogue, and the
# finish kernel (B8) gathers each group's key codes into the fetch.
# Median and count distinct (B9) and corr (B10) run their own passes over
# the same sort.  Counterpart of ``arrow_ballista_tpu/ops/kernels.py``'s
# device_encode_keys, _keyed_sort_fn, keyed_finish_kernel,
# keyed_median_kernel and keyed_corr_kernel.
KEY_KINDS = {"ident": 1, "bool": 2, "f32": 3, "f64": 4}  # keyed_gids.h
KEY_IN_TYPES = {torch.int32: 0, I64: 1, torch.float32: 2, F64: 3, torch.bool: 4}
KEYED_MAX_KEYS = 16
INT32_MAX = (1 << 31) - 1
IDENT_KEY_LIMIT = 1 << 61  # bridge.IdentityKeyEncoder's 62-bit code bound


def key_host_values(kind: str, values: np.ndarray) -> np.ndarray:
    """A raw key column as one of the dtypes the encode kernel reads:
    int32 or int64 for ``ident``, bool, float32 or float64."""
    if kind == "bool":
        return values.astype(bool, copy=False)
    if kind == "f32":
        return values.astype(np.float32, copy=False)
    if kind == "f64":
        return values.astype(np.float64, copy=False)
    if values.dtype.kind in "iu" and values.dtype.itemsize < 4:
        return values.astype(np.int32)
    if values.dtype in (np.dtype(np.int32), np.dtype(np.int64)):
        return values
    if values.dtype.kind == "u" and values.dtype.itemsize == 8 and len(values) and (
        values.max() > np.iinfo(np.int64).max
    ):
        raise ExecutionError("uint64 group key exceeds the int64 range")
    return values.astype(np.int64)


def key_encode_reference(kinds: tuple, keys: tuple, masks: tuple, n: int, device):
    """Plain twin of the key encode kernel.  ``keys[k]`` is ``(codes,)`` for
    kind ``code`` (host-encoded codes pass through) or ``(values,
    validity-or-None)`` for a device kind; ``masks`` are the row masks
    (None = all rows) whose AND keeps a row.  Returns ``(inv, codes)``:
    the int32 sort operand ``not mask`` and one int64 code column per
    device kind, bit-identical to ``encoder.encode`` of the port's host
    encoders (``ident``: the zigzag image, null 0; ``bool``: null 0, False
    1, True 2; ``f32``/``f64``: the raw bit pattern, null the reserved NaN
    of ``FLOAT32_NULL_BITS``/``FLOAT64_NULL_BITS``)."""
    m = None
    for x in masks:
        if x is not None:
            m = x if m is None else m & x
    if m is None:
        inv = torch.zeros(n, dtype=torch.int32, device=device)
    else:
        inv = torch.logical_not(m).to(torch.int32)
    codes = []
    for kind, ops in zip(kinds, keys):
        if kind == "code":
            codes.append(ops[0])
            continue
        v, ok = ops
        if kind == "ident":
            v = v.to(I64)
            c = torch.where(v >= 0, 2 * v + 1, -2 * v)
            null = 0
        elif kind == "bool":
            c = v.to(I64) + 1
            null = 0
        elif kind == "f32":
            c = v.to(torch.float32).view(torch.int32).to(I64)
            null = FLOAT32_NULL_BITS
        elif kind == "f64":
            c = v.to(F64).view(I64)
            null = FLOAT64_NULL_BITS
        else:
            raise ValueError(f"key kind {kind!r}")
        if ok is not None:
            c = torch.where(ok, c, torch.full_like(c, null))
        codes.append(c)
    return inv, codes


def _check_encode_args(kinds, keys, masks, n: int, device) -> None:
    if device.type != "cuda" or not 0 <= n < (1 << 31):
        raise ValueError("key_encode runs on CUDA tensors, n < 2^31")
    if len(kinds) != len(keys) or len(kinds) > KEYED_MAX_KEYS:
        raise ValueError(f"key_encode: {len(kinds)} kinds, {len(keys)} keys")
    for i, m in enumerate(masks):
        if m is not None:
            _check_cuda_tensor(m, f"mask {i}", (torch.bool,), n, device)
    for k, (kind, ops) in enumerate(zip(kinds, keys)):
        if kind == "code":
            _check_cuda_tensor(ops[0], f"key {k} codes", (torch.int32, I64), n, device)
            continue
        if kind not in KEY_KINDS or len(ops) != 2:
            raise ValueError(f"key {k}: kind {kind!r}")
        v, ok = ops
        want = {"ident": (torch.int32, I64), "bool": (torch.bool,),
                "f32": (torch.float32,), "f64": (F64,)}[kind]
        _check_cuda_tensor(v, f"key {k} values", want, n, device)
        if ok is not None:
            _check_cuda_tensor(ok, f"key {k} validity", (torch.bool,), n, device)


def key_encode_cuda(kinds: tuple, keys: tuple, masks: tuple, n: int, device):
    """Launch the hand-written key encode kernel (ops/cuda/keyed_gids.cu),
    the same outputs as :func:`key_encode_reference`, bit for bit.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:device_encode_keys`` (B7)
    inside the keyed prep; the row mask folds into the sort operand in the
    same pass."""
    from .cuda.build import load

    # "cuda" names the current card: compare with the tensors' own device
    device = torch.empty(0, device=device).device
    masks = tuple(masks)
    _check_encode_args(kinds, keys, masks, n, device)
    if len(masks) > 3:
        raise ValueError("key_encode: at most 3 masks")
    ext = load()
    empty = torch.empty(0, dtype=torch.bool, device=device)
    inv = torch.empty(n, dtype=torch.int32, device=device)
    dev_kinds, dev_vals, dev_valids, dev_out, codes = [], [], [], [], []
    for kind, ops in zip(kinds, keys):
        if kind == "code":
            codes.append(ops[0])
            continue
        out = torch.empty(n, dtype=I64, device=device)
        dev_kinds.append(KEY_KINDS[kind])
        dev_vals.append(ops[0])
        dev_valids.append(empty if ops[1] is None else ops[1])
        dev_out.append(out)
        codes.append(out)
    padded = list(masks) + [None] * (3 - len(masks))
    ext.key_encode(
        n, [empty if m is None else m for m in padded], inv, dev_kinds,
        [KEY_IN_TYPES[v.dtype] for v in dev_vals], dev_vals, dev_valids, dev_out,
    )
    count_launch("key_encode")
    return inv, codes


def key_encode(kinds: tuple, keys: tuple, masks: tuple, n: int, device):
    """Sort operands of one batch: the CUDA kernel on a CUDA device, its
    plain twin on the CPU."""
    if torch.device(device).type == "cpu":
        return key_encode_reference(kinds, keys, masks, n, device)
    return key_encode_cuda(kinds, keys, masks, n, device)


def keyed_gids_reference(perm: torch.Tensor, inv: torch.Tensor, keys: list) -> dict:
    """Plain twin of the gid kernel: over rows sorted by ``perm``, a group
    starts at each valid row (``inv`` 0) whose keys differ from the row
    before (row 0 always differs).  Returns ``s2`` (each sorted row's group
    id, ``INT32_MAX`` for masked rows), ``gid_in`` (the same ids in input
    row order), ``sk`` (the keys in sorted order), ``starts`` ([n + 1]:
    each group's first sorted row, then at ``n_groups`` the count of valid
    rows; the rest 0) and ``counts`` ([2] int64: groups, valid rows)."""
    n, device = perm.shape[0], perm.device
    p = perm.long()
    sk = [k[p] for k in keys]
    valid = inv[p] == 0
    first = torch.ones(n, dtype=torch.bool, device=device)
    if n > 1 and sk:
        diff = torch.zeros(n - 1, dtype=torch.bool, device=device)
        for k in sk:
            diff |= k[1:] != k[:-1]
        first[1:] = diff
    flag = first & valid
    gid = torch.cumsum(flag.to(I64), 0) - 1
    s2 = torch.where(valid, gid, torch.full_like(gid, INT32_MAX)).to(torch.int32)
    gid_in = torch.empty(n, dtype=torch.int32, device=device)
    gid_in[p] = s2
    n_groups, n_valid = int(flag.sum()), int(valid.sum())
    starts = torch.zeros(n + 1, dtype=torch.int32, device=device)
    starts[:n_groups] = torch.nonzero(flag).flatten().to(torch.int32)
    starts[n_groups] = n_valid
    counts = torch.tensor([n_groups, n_valid], dtype=I64, device=device)
    return dict(s2=s2, gid_in=gid_in, sk=sk, starts=starts, counts=counts)


GIDS_TILE = 2048  # rows per block (keyed_gids.h: kGidsTile)


def _check_gids_args(perm, inv, keys) -> None:
    device = perm.device
    n = perm.shape[0] if perm.dim() == 1 else -1
    if device.type != "cuda" or not 0 <= n < (1 << 31):
        raise ValueError("keyed_gids runs on CUDA tensors, n < 2^31")
    _check_cuda_tensor(perm, "perm", (torch.int32,), n, device)
    _check_cuda_tensor(inv, "inv", (torch.int32,), n, device)
    if len(keys) > KEYED_MAX_KEYS:
        raise ValueError(f"keyed_gids: {len(keys)} keys")
    for k, key in enumerate(keys):
        _check_cuda_tensor(key, f"key {k}", (torch.int32, I64), n, device)


def keyed_gids_cuda(perm: torch.Tensor, inv: torch.Tensor, keys: list,
                    sorted_outputs: bool = True) -> dict:
    """Launch the hand-written gid kernel (ops/cuda/keyed_gids.cu): key
    changes over the sorted rows, group ids by a block prefix count, the
    same outputs as :func:`keyed_gids_reference` (``starts`` past
    ``n_groups`` is not written).  With ``sorted_outputs`` False only
    ``starts`` and ``counts`` are written (the median's pass).

    Replaces the boundary and cumsum half of ``arrow_ballista_tpu/ops/
    kernels.py:_keyed_sort_fn`` (B7); the sort itself is K1."""
    from .cuda.build import load

    _check_gids_args(perm, inv, keys)
    ext = load()
    n, device = perm.shape[0], perm.device
    empty32 = torch.empty(0, dtype=torch.int32, device=device)
    if sorted_outputs:
        s2 = torch.empty(n, dtype=torch.int32, device=device)
        gid_in = torch.empty(n, dtype=torch.int32, device=device)
        sk = [torch.empty(n, dtype=k.dtype, device=device) for k in keys]
    else:
        s2 = gid_in = None
        sk = []
    starts = torch.empty(n + 1, dtype=torch.int32, device=device)
    counts = torch.empty(2, dtype=I64, device=device)
    blocks = max(1, -(-n // GIDS_TILE))
    ext.keyed_gids(
        perm, inv, list(keys), empty32 if s2 is None else s2,
        empty32 if gid_in is None else gid_in, sk, starts, counts,
        torch.empty(2 * blocks, dtype=I64, device=device),
    )
    count_launch("keyed_gids")
    return dict(s2=s2, gid_in=gid_in, sk=sk, starts=starts, counts=counts)


def keyed_gids(perm: torch.Tensor, inv: torch.Tensor, keys: list) -> dict:
    """Group ids of the sorted rows: the CUDA kernel for CUDA tensors, its
    plain twin for tensors on the CPU."""
    if perm.device.type == "cpu":
        return keyed_gids_reference(perm, inv, keys)
    return keyed_gids_cuda(perm, inv, keys)


def keyed_sort(inv: torch.Tensor, keys: list) -> tuple:
    """The keyed route's sort: K1 orders the rows by ``(inv, *keys)`` (masked
    rows last, ties in row order), then the gid kernel numbers the groups.
    Returns ``(perm, gids, n_groups)``; ``n_groups`` is the one number the
    host reads before it sizes the finish."""
    perm = radix_argsort([inv] + list(keys))
    gids = keyed_gids(perm, inv, keys)
    return perm, gids, int(gids["counts"][0].item())


def keyed_keys_reference(sk: list, starts: torch.Tensor, n_groups: int,
                         out: torch.Tensor) -> torch.Tensor:
    """Plain twin of the finish kernel's key gather: ``out[k][g]`` is group
    g's key code (its first sorted row's ``sk[k]``) for g < ``n_groups``,
    else 0."""
    cap = out.shape[1]
    g = torch.arange(cap, device=out.device)
    live = g < n_groups
    at = starts[torch.clamp(g, max=max(n_groups - 1, 0))].long()
    for k, key in enumerate(sk):
        if key.shape[0] == 0:
            out[k] = 0
            continue
        vals = key[torch.clamp(at, max=key.shape[0] - 1)].to(I64)
        out[k] = torch.where(live, vals, torch.zeros_like(vals))
    return out


def keyed_keys_cuda(sk: list, starts: torch.Tensor, n_groups: int,
                    out: torch.Tensor) -> torch.Tensor:
    """Launch the finish kernel's key gather (ops/cuda/keyed_finish.cu)."""
    from .cuda.build import load

    device = out.device
    n = sk[0].shape[0] if sk else 0
    if device.type != "cuda" or out.dtype != I64 or out.dim() != 2 or (
        not out.is_contiguous() or out.shape[0] != len(sk)
    ):
        raise ValueError("out must be a contiguous CUDA int64 [n_keys, capacity]")
    if not 0 <= n_groups <= min(n, out.shape[1]):
        raise ValueError(f"n_groups {n_groups} for {n} rows, capacity {out.shape[1]}")
    _check_cuda_tensor(starts, "starts", (torch.int32,), n + 1, device)
    for k, key in enumerate(sk):
        _check_cuda_tensor(key, f"sorted key {k}", (torch.int32, I64), n, device)
    load().keyed_keys(list(sk), starts, int(n_groups), out)
    count_launch("keyed_finish")
    return out


def _scan_into_state_reference(columns, field_col, ops, state, n, perm, key):
    """Twin of K2's sorted-aggregate epilogue: every segment's totals (a
    segment is a run of equal ``key[perm[r]]``, non-decreasing) merge into
    ``state`` at the segment's key when it is below the capacity."""
    capacity = state.shape[1]
    if n == 0:
        return state
    scanned = seg_scan_reference(columns, n, perm=perm, key=key)
    s2 = key if perm is None else key[perm.long()]
    bounds = torch.searchsorted(
        s2.to(I64), torch.arange(capacity + 1, dtype=I64, device=s2.device)
    )
    present = (bounds[1:] - bounds[:-1]) > 0
    last = torch.clamp(bounds[1:] - 1, 0, max(n - 1, 0))
    totals = [s[last] for s in scanned]
    return _emit_scan_outs(totals, field_col, ops, state, present)


def _scan_into_state_cuda(columns, field_col, ops, state, n, perm, key):
    """K2 with its sorted-aggregate epilogue into ``state`` (the card's
    form of :func:`_scan_into_state_reference`)."""
    if n == 0:
        return state
    _check_scan_args(columns, n, perm, None, key, None, state.device)
    _launch_scan(columns, n, perm, None, key, None, False, [None] * len(columns),
                 state, field_col, ops)
    return state


def _finish_packed(specs: list, ops: list, gids: dict, capacity: int, device):
    """The finish's output with every state row at its identity."""
    flags = _field_flags(specs)
    if len(ops) != len(flags):
        raise ValueError(f"{len(ops)} ops for {len(flags)} state fields")
    words = torch.tensor([_ident_bits(r, i) for r, i in flags], dtype=I64).to(device)
    packed = torch.empty((len(flags) + len(gids["sk"]), capacity), dtype=I64, device=device)
    packed[:len(flags)] = words[:, None]
    return packed, len(flags)


def keyed_finish_reference(specs, columns, field_col, ops, perm, gids, n_groups: int,
                           capacity: int) -> torch.Tensor:
    """Plain twin of :func:`keyed_finish_cuda`: the segmented scan's twin
    into the state rows, the key gather's twin into the key rows."""
    packed, n_state = _finish_packed(specs, ops, gids, capacity, perm.device)
    _scan_into_state_reference(columns, field_col, ops, packed[:n_state], perm.shape[0],
                               perm, gids["gid_in"])
    keyed_keys_reference(gids["sk"], gids["starts"], n_groups, packed[n_state:])
    return packed


def keyed_finish_cuda(specs, columns, field_col, ops, perm, gids, n_groups: int,
                      capacity: int) -> torch.Tensor:
    """The keyed route's finish on the card: ``[n_fields + n_keys,
    capacity]`` int64, the state rows (presence last, floats as their bits)
    and then each group's key codes, fetched by the host in ONE copy.  K2
    reduces the scan columns through ``perm`` segmented by
    ``gids["gid_in"]`` straight into the state rows; the finish kernel
    (ops/cuda/keyed_finish.cu) gathers the key rows.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:keyed_finish_kernel`` (B8)."""
    packed, n_state = _finish_packed(specs, ops, gids, capacity, perm.device)
    _scan_into_state_cuda(columns, field_col, ops, packed[:n_state], perm.shape[0],
                          perm, gids["gid_in"])
    if gids["sk"]:
        keyed_keys_cuda(gids["sk"], gids["starts"], n_groups, packed[n_state:])
    return packed


def keyed_finish(specs, columns, field_col, ops, perm, gids, n_groups: int,
                 capacity: int) -> torch.Tensor:
    """The keyed finish: the CUDA kernels for CUDA tensors, the twins for
    tensors on the CPU."""
    if perm.device.type == "cpu":
        return keyed_finish_reference(specs, columns, field_col, ops, perm, gids,
                                      n_groups, capacity)
    return keyed_finish_cuda(specs, columns, field_col, ops, perm, gids, n_groups,
                             capacity)


def unpack_keyed_host(specs: list, packed: np.ndarray, n_keys: int) -> tuple:
    """Host inverse of :func:`keyed_finish`'s pack: (state arrays with
    presence last, one int64 key-code array per key)."""
    flags = [f for spec in specs for f in state_is_int(spec)] + [True]
    states = [
        row if is_int else row.view(np.float64)
        for row, is_int in zip(packed[: len(flags)], flags)
    ]
    keys = [packed[len(flags) + k].astype(np.int64) for k in range(n_keys)]
    return states, keys


def merge_keyed_host(specs: list, per_chunk: list) -> tuple:
    """Merge keyed chunk results BY KEY on the host (numpy, vectorised).

    ``per_chunk``: ``(states, key_codes, n_groups)`` of each flushed block,
    as :func:`unpack_keyed_host` returns them.  The merge is [distinct]-
    sized: the per-row work stayed on the device.  Returns (merged states
    with presence last, merged key-code arrays, n_groups)."""
    live = [(s, k, n) for s, k, n in per_chunk if n > 0]
    if not live:
        empty = [np.zeros(0, dtype=np.int64) for _ in per_chunk[0][0]]
        return empty, [np.zeros(0, np.int64) for _ in per_chunk[0][1]], 0
    n_keys = len(live[0][1])
    keys = [np.concatenate([k[j][:n] for _s, k, n in live]) for j in range(n_keys)]
    states = [
        np.concatenate([s[i][:n] for s, _k, n in live])
        for i in range(len(live[0][0]))
    ]
    order = np.lexsort(tuple(reversed(keys)))
    keys = [k[order] for k in keys]
    states = [s[order] for s in states]
    n_rows = len(keys[0])
    newflag = np.zeros(n_rows, dtype=bool)
    newflag[:1] = True
    for k in keys:
        newflag[1:] |= k[1:] != k[:-1]
    starts = np.flatnonzero(newflag)
    out_keys = [k[starts] for k in keys]

    def reduceat(a, role):
        if role == "min":
            if a.dtype.kind == "f":
                return _host_fold(np.minimum, a, starts)
            return np.minimum.reduceat(a, starts)
        if role == "max":
            if a.dtype.kind == "f":
                return _host_fold(np.maximum, a, starts)
            return np.maximum.reduceat(a, starts)
        return np.add.reduceat(a, starts)

    out: list[np.ndarray] = []
    i = 0
    for spec in specs:
        for role in state_fields(spec):
            out.append(reduceat(states[i], role))
            i += 1
    out.append(np.add.reduceat(states[-1], starts))  # presence
    return out, out_keys, len(starts)


def _host_fold(fold, a: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Per-segment f64 min/max with jnp's rules: NaN propagates (numpy's
    reduceat does that), -0.0 orders below +0.0."""
    r = fold.reduceat(a, starts)
    zero = r == 0
    if zero.any():
        is_min = fold is np.minimum
        sign = np.signbit(a) if is_min else ~np.signbit(a)
        hit = np.add.reduceat(((a == 0) & sign).astype(np.int64), starts) > 0
        r = np.where(zero & hit, -0.0 if is_min else 0.0, r)
    return r


# ---------------------------------------------------- keyed median (B9)
def keyed_median_reference(inv, keys, ohi, olo, ovalid, capacity: int) -> torch.Tensor:
    """Plain twin of the median kernel, the arithmetic of the reference's
    ``keyed_median_kernel``: one sort by (inv, *keys, arg-null, ohi, olo),
    group ids from key changes among valid rows, a doubled segment id
    ``gid * 2 + null`` whose bounds give each group's first row and valid
    count; per group the order pairs at the two middle rows, the valid
    count and the count of distinct values (run starts).  Returns
    ``[6, capacity]`` int64: hi@lo, lo@lo, hi@hi, lo@hi, count, distinct."""
    n, device = inv.shape[0], inv.device
    argnull = (
        torch.zeros(n, dtype=torch.int32, device=device) if ovalid is None
        else torch.logical_not(ovalid).to(torch.int32)
    )
    perm = radix_argsort_reference([inv] + list(keys) + [argnull, ohi, olo]).long()
    out = torch.zeros((6, capacity), dtype=I64, device=device)
    if n == 0:
        return out
    sk = [k[perm] for k in keys]
    snull, shi, slo = argnull[perm], ohi[perm].to(I64), olo[perm].to(I64)
    valid = inv[perm] == 0
    diff = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=device)
    for k in sk:
        diff |= k[1:] != k[:-1]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=device), diff])
    gid = torch.cumsum((first & valid).to(I64), 0) - 1
    s2 = torch.where(valid, gid * 2 + snull.to(I64), torch.full_like(gid, INT32_MAX))
    bounds = torch.searchsorted(s2, torch.arange(2 * capacity + 1, dtype=I64, device=device))
    start = bounds[0::2][:capacity]
    end_valid = bounds[1::2]
    cnt = end_valid - start
    lo_idx = torch.clamp(start + torch.div(cnt - 1, 2, rounding_mode="floor"), 0, n - 1)
    hi_idx = torch.clamp(start + torch.div(cnt, 2, rounding_mode="floor"), 0, n - 1)
    vdiff = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
    runfirst = torch.cat([torch.ones(1, dtype=torch.bool, device=device), diff | vdiff])
    dflag = runfirst & valid & (snull == 0)
    cum0 = torch.cat([torch.zeros(1, dtype=I64, device=device),
                      torch.cumsum(dflag.to(I64), 0)])
    distinct = cum0[end_valid] - cum0[start]
    for r, v in enumerate((shi[lo_idx], slo[lo_idx], shi[hi_idx], slo[hi_idx], cnt, distinct)):
        out[r] = v
    return out


def keyed_median_cuda(inv, keys, ohi, olo, ovalid, capacity: int) -> torch.Tensor:
    """The median and count distinct on the card: K1 sorts by (inv, *keys,
    arg-null, ohi, olo), the gid kernel finds each group's first row, and
    the median kernel (ops/cuda/keyed_median.cu, one block per group) reads
    the valid count, the two middle order pairs and the distinct run
    starts.  Same output as :func:`keyed_median_reference`, bit for bit.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:keyed_median_kernel`` (B9)."""
    from .cuda.build import load

    device, n = inv.device, inv.shape[0]
    if device.type != "cuda" or capacity < 1:
        raise ValueError("keyed_median runs on CUDA tensors, capacity >= 1")
    for name, t in (("ohi", ohi), ("olo", olo), ("inv", inv)):
        _check_cuda_tensor(t, name, (torch.int32,), n, device)
    if ovalid is not None:
        _check_cuda_tensor(ovalid, "ovalid", (torch.bool,), n, device)
    argnull = (
        torch.zeros(n, dtype=torch.int32, device=device) if ovalid is None
        else torch.logical_not(ovalid).to(torch.int32)
    )
    perm = radix_argsort_cuda([inv] + list(keys) + [argnull, ohi, olo])
    gids = keyed_gids_cuda(perm, inv, list(keys), sorted_outputs=False)
    out = torch.empty((6, capacity), dtype=I64, device=device)
    if n == 0:
        return out.zero_()
    load().keyed_median(perm, argnull, ohi, olo, gids["starts"], gids["counts"], out)
    count_launch("keyed_median")
    return out


def keyed_median(inv, keys, ohi, olo, ovalid, capacity: int) -> torch.Tensor:
    """Per-group median and distinct count of one argument: the CUDA
    kernels for CUDA tensors, the twin for tensors on the CPU."""
    if inv.device.type == "cpu":
        return keyed_median_reference(inv, keys, ohi, olo, ovalid, capacity)
    return keyed_median_cuda(inv, keys, ohi, olo, ovalid, capacity)


# ------------------------------------------------------- keyed corr (B10)
def _corr_pass1_columns(x, y, m):
    return [
        ScanColumn(SS_COUNT, OP_ADD_I64, valid=m),
        ScanColumn(SS_VALUES, OP_ADD_F64, values=x, valid=m),
        ScanColumn(SS_VALUES, OP_ADD_F64, values=y, valid=m),
    ]


def corr_center_reference(s2, perm, x, y, m, moments):
    """Plain twin of the centring kernel: per sorted row of a live group,
    x and y minus their group means (``moments`` rows n, Σx, Σy), and the
    products x'y', x'², y'² (0 where the pair is not valid)."""
    cap = moments.shape[1]
    n_pair = moments[0]
    nf = torch.clamp(n_pair, min=1).to(F64)
    mx, my = moments[1].view(F64) / nf, moments[2].view(F64) / nf
    g = torch.clamp(s2.long(), 0, cap - 1)
    p = perm.long()
    xs, ys, ms = x[p].to(F64), y[p].to(F64), m[p]
    xc, yc = xs - mx[g], ys - my[g]
    zero = torch.zeros_like(xc)
    return [torch.where(ms, xc * yc, zero), torch.where(ms, xc * xc, zero),
            torch.where(ms, yc * yc, zero)]


def keyed_corr_reference(s2, perm, gid_in, x, xvalid, y, yvalid, capacity: int):
    """Plain twin of the corr kernels, the arithmetic of the reference's
    ``keyed_corr_kernel`` (x64): over pairwise-valid rows (neither argument
    null nor NaN), pass 1 sums n, Σx, Σy per group; the group means centre
    each row; pass 2 sums Σx'y', Σx'², Σy'².  Returns ``[4, capacity]``
    int64: Σx'y', Σx'², Σy'² (f64 bits), n."""
    n, device = perm.shape[0], perm.device
    m = torch.ones(n, dtype=torch.bool, device=device)
    for ok in (xvalid, yvalid):
        if ok is not None:
            m = m & ok
    if x.is_floating_point():
        m = m & ~torch.isnan(x)
    if y.is_floating_point():
        m = m & ~torch.isnan(y)
    buf = torch.zeros((6, capacity), dtype=I64, device=device)
    ops1 = [OP_ADD_I64, OP_ADD_F64, OP_ADD_F64]
    _scan_into_state_reference(_corr_pass1_columns(x, y, m), [0, 1, 2], ops1,
                               buf[3:6], n, perm, gid_in)
    prods = corr_center_reference(s2, perm, x, y, m, buf[3:6])
    cols2 = [ScanColumn(SS_VALUES, OP_ADD_F64, values=v) for v in prods]
    _scan_into_state_reference(cols2, [0, 1, 2], [OP_ADD_F64] * 3, buf[0:3], n,
                               None, s2)
    return buf[:4].clone()


def keyed_corr_cuda(s2, perm, gid_in, x, xvalid, y, yvalid, capacity: int):
    """Corr moments on the card: the pairwise mask and the centring pass are
    hand-written (ops/cuda/keyed_corr.cu), both passes' sums are K2 with
    its state epilogue.  Same layout as :func:`keyed_corr_reference`.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:keyed_corr_kernel`` (B10)."""
    from .cuda.build import load

    device, n = perm.device, perm.shape[0]
    if device.type != "cuda" or capacity < 1:
        raise ValueError("keyed_corr runs on CUDA tensors, capacity >= 1")
    for name, t in (("s2", s2), ("perm", perm), ("gid_in", gid_in)):
        _check_cuda_tensor(t, name, (torch.int32,), n, device)
    for name, t in (("x", x), ("y", y)):
        _check_cuda_tensor(t, name, (F64, I64), n, device)
    for name, t in (("xvalid", xvalid), ("yvalid", yvalid)):
        if t is not None:
            _check_cuda_tensor(t, name, (torch.bool,), n, device)
    buf = torch.zeros((6, capacity), dtype=I64, device=device)
    if n == 0:
        return buf[:4].clone()
    ext = load()
    empty = torch.empty(0, dtype=torch.bool, device=device)
    m = torch.empty(n, dtype=torch.bool, device=device)
    ext.corr_mask(x, empty if xvalid is None else xvalid, y,
                  empty if yvalid is None else yvalid, m)
    count_launch("keyed_corr")
    ops1 = [OP_ADD_I64, OP_ADD_F64, OP_ADD_F64]
    _scan_into_state_cuda(_corr_pass1_columns(x, y, m), [0, 1, 2], ops1, buf[3:6], n,
                          perm, gid_in)
    prods = [torch.empty(n, dtype=F64, device=device) for _ in range(3)]
    ext.corr_center(s2, perm, x, y, m, buf[3:6], prods[0], prods[1], prods[2])
    count_launch("keyed_corr")
    cols2 = [ScanColumn(SS_VALUES, OP_ADD_F64, values=v) for v in prods]
    _scan_into_state_cuda(cols2, [0, 1, 2], [OP_ADD_F64] * 3, buf[0:3], n, None, s2)
    return buf[:4].clone()


def keyed_corr(s2, perm, gid_in, x, xvalid, y, yvalid, capacity: int):
    """Per-group centred corr moments: the CUDA kernels for CUDA tensors,
    the twins for tensors on the CPU."""
    if perm.device.type == "cpu":
        return keyed_corr_reference(s2, perm, gid_in, x, xvalid, y, yvalid, capacity)
    return keyed_corr_cuda(s2, perm, gid_in, x, xvalid, y, yvalid, capacity)


# ------------------------------------------------------- keyed prep (B7)
@dataclass
class KeyedBatch:
    """One batch's buffered operands on the device: the sort operand
    ``inv`` (int32, 1 = the row is dropped), the key codes, the scan
    columns' values and validities (None = absent or all valid) and the
    raw extras of the median and corr passes."""

    inv: torch.Tensor
    codes: list
    values: list
    valids: list
    extras: list

    @property
    def nbytes(self) -> int:
        ts = [self.inv, *self.codes, *self.values, *self.valids, *self.extras]
        return sum(t.numel() * t.element_size() for t in ts if t is not None)


def make_keyed_prep_kernel(
    filter_closure: Optional[TorchClosure],
    arg_closures: list,
    specs: list[KernelAggSpec],
    flat_names: list[str],
    key_kinds: tuple,
    extra_names: tuple = (),
):
    """Per-batch half of the keyed aggregation (the reference's
    ``make_keyed_prep_kernel``).

    ``fn(keys, valid, *leaf_arrays, state=None) -> KeyedBatch``: the filter
    and arguments run through the expression program (B3, as in the basic
    route),
    then :func:`key_encode` derives the key codes and the sort operand
    from ``keys`` (per key ``(codes,)`` for kind ``code``, else ``(values,
    validity)``) and the row masks.  ``keys`` rides the group-id slot, so
    :func:`make_join_kernel` wraps this function unchanged; ``state`` is
    accepted for that signature and ignored.  ``extra_names`` are env
    arrays buffered raw for the median and corr passes.  The keyed route
    always has at least one group key."""
    closures, columns, ops, cols = _agg_layout(specs, arg_closures)
    program = ExprProgram(filter_closure, closures, columns)

    def fn(keys, valid, *arrays, state=None):
        env = dict(zip(flat_names, arrays))
        n, device = keys[0][0].shape[0], keys[0][0].device
        pred, pvalid, values, valids = expr_eval(program, env, n, device)
        inv, codes = key_encode(key_kinds, tuple(keys), (valid, pred, pvalid), n, device)
        extras = [env[nm] for nm in extra_names]
        return KeyedBatch(inv, list(codes), values, valids, extras)

    fn.layout = (columns, ops, cols)
    return fn
