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
radix sort, the segment reduce into the state and the key gather
(``keyed_finish.cu``), and the median (``keyed_median.cu``) and corr
(``keyed_corr.cu``) passes over the same sort.  A stage that retains its
batches (the column cache, whole-stage fusion) folds them all in one
multi-entry launch of the segment aggregate
(``ops/cuda/segment_agg_entries.cu``), bit-identical to one launch per
batch.

Design rules:
* a dtype MODE, as the reference's: "x64" (f64/i64 device dtypes, the
  default on every device: the H100 has both) or "x32" (f32/i32, forced
  with :func:`set_precision`), whose sums are double-float (hi, lo) pairs
  (``ops/cuda/df32_agg.cu``), whose f64 min/max ride order pairs
  (``ops/cuda/ord_extremum.cu``) and whose states merge through
  ``ops/cuda/x32_merge.cu``; every tensor the port builds names its dtype,
  so torch's float32 default never leaks in;
* group-by runs over host-assigned dense group ids into a fixed-capacity
  state that grows in 4x steps with identity padding;
* nulls ride as separate validity masks and fold into the row mask; an
  all-valid companion is ``None`` and costs no bytes or loads;
* strings never reach the device — the ``NotLowerable`` boundary is the
  reference's.
"""

from __future__ import annotations

import functools
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

F64 = torch.float64
I64 = torch.int64
F32 = torch.float32
I32 = torch.int32

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


class X32RangeError(ExecutionError):
    """A value the x32 device dtypes cannot carry exactly (an integer past
    int32, an int64 pair past 2^48, a float past the f32 range): the stage
    re-runs the partition on the CPU operators, as for a capacity overflow
    (``tpu_fallback``)."""


# ------------------------------------------------------------- precision
# The device dtype policy is a MODE, as in the reference:
#   "x64" — f64/i64 device dtypes (the port's default on every device)
#   "x32" — f32/i32 device dtypes; sums are double-float (hi, lo) pairs,
#           f64 min/max ride order-preserving (hi, lo) int32 pairs
# Each TorchStageExec pins the mode it was built under.
_PRECISION: dict = {"mode": None}


def set_precision(mode: Optional[str]) -> None:
    """Force the kernel dtype mode ("x64" | "x32"), or None for the default."""
    if mode not in (None, "x64", "x32"):
        raise ValueError(f"precision mode {mode!r}")
    _PRECISION["mode"] = mode


def precision_mode() -> str:
    """The dtype mode in force: "x64" unless "x32" was set."""
    return _PRECISION["mode"] or "x64"


def value_dtype(mode: Optional[str] = None) -> torch.dtype:
    return F32 if (mode or precision_mode()) == "x32" else F64


def index_dtype(mode: Optional[str] = None) -> torch.dtype:
    return I32 if (mode or precision_mode()) == "x32" else I64


@dataclass
class LeafSpec:
    """One host-supplied input array of the stage.

    Kinds: "column" (value + validity), "cpu_expr" (host-evaluated value +
    validity), "column_validity" (validity ONLY — count(col) never needs
    the values), "column_ord_pair" (the value as an order-preserving
    (hi, lo) int32 pair + validity: the keyed median's sort operand, and
    an f64 min/max in x32), "column_pair" (x32: the value as an exact f32
    (hi, lo) pair + validity, summed by the pair-aware aggregates),
    "join_col" (a build-side column of a folded device join: gathered on
    the device by :func:`join_probe`, never read from the probe batch).
    """

    name: str
    kind: str  # "column" | "cpu_expr" | "column_validity" | "column_ord_pair" | "column_pair" | "join_col"
    col_index: int = -1
    cpu_expr: Optional[pe.PhysicalExpr] = None


@dataclass
class CompiledExpr:
    closure: TorchClosure
    leaves: dict[str, LeafSpec] = field(default_factory=dict)


def _pa_to_torch_dtype(t: pa.DataType, mode: str = "x64") -> torch.dtype:
    if pa.types.is_floating(t) or pa.types.is_decimal(t):
        return value_dtype(mode)
    if pa.types.is_boolean(t):
        return torch.bool
    return index_dtype(mode)


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
    value dtype (bool, int64 or float64 in x64, bool, int32 or float32 in
    x32; None for a validity-only leaf),
    the argument nodes and a constant: a leaf's (value, validity) env
    names, a literal's bit pattern (an int64; a float32's is its int32
    bits), an IN list's (dtype, bit
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
    """The bit pattern of a literal of ``dtype``: an f64's int64 bits, an
    f32's int32 bits, an integer or bool itself."""
    if dtype == F64:
        return int(np.array(value, np.float64).view(np.int64))
    if dtype == F32:
        return int(np.array(value, np.float32).view(np.int32))
    return int(value)


_BINARY_OPS = {
    "=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge",
    "+": "add", "-": "sub", "*": "mul",
}
_ARITH = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}
_BOOL_OPS = ("and", "or", "not", "is_null", "is_not_null",
             "eq", "ne", "lt", "le", "gt", "ge")


def _node(op: str, *closures, mode: str = "x64") -> ExprNode:
    """The node of an operation over the closures' nodes, its dtype decided
    as the closure's torch calls decide it (``mode`` gives the float and
    integer dtypes)."""
    args = tuple(c.node for c in closures)
    err = next((a for a in args if a.op == "error"), None)
    if err is not None:
        return err
    if op in _BOOL_OPS:
        return ExprNode(op, torch.bool, args)
    fdt, idt = value_dtype(mode), index_dtype(mode)
    if op in ("div", "mod"):  # both integer (bool is not): truncating / floor
        ints = all(a.dtype in (I64, I32) for a in args)
        return ExprNode(f"{op}_int" if ints else f"{op}_f", idt if ints else fdt, args)
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
    return ExprNode(op, fdt, args)  # the float functions, power, round, square


def _in_node(f: TorchClosure, items, all_int: bool, negated: bool,
             mode: str = "x64") -> ExprNode:
    """IN / NOT IN: the table in the dtype the closure compares in (its
    bits as int64, int32 in x32)."""
    child = f.node
    if child.op == "error":
        return child
    fdt, idt = value_dtype(mode), index_dtype(mode)
    try:
        if all_int:
            table = torch.tensor(list(items), dtype=idt)
            if child.dtype != idt:
                table = table.to(fdt)
        else:
            table = torch.tensor([_to_num(i) for i in items], dtype=fdt)
    except (RuntimeError, OverflowError) as exc:
        return ExprNode("error", None, (child,), str(exc))
    bits = tuple(table.view(idt).tolist())
    return ExprNode("not_in" if negated else "in", torch.bool, (child,),
                    (table.dtype, bits))


def _cast_node(child: ExprNode, dt: torch.dtype) -> ExprNode:
    """CAST as :func:`_cast` does it: float → integer saturates, a cast to
    the same dtype is the value itself, the rest is ``.to``."""
    if child.op == "error" or dt == child.dtype:
        return child
    if dt in (I64, I32) and child.dtype in (F64, F32):
        return ExprNode("cast_i64", dt, (child,))
    return ExprNode("convert", dt, (child,))


class TorchExprCompiler:
    """Lower PhysicalExpr trees to torch closures over a shared leaf env.

    Counterpart of the reference's ``JaxExprCompiler``: any subtree that
    cannot lower (LIKE, string functions, …) but whose OUTPUT is
    device-friendly becomes a ``cpu_expr`` leaf evaluated by pyarrow per
    batch and shipped beside the raw columns.  Every closure carries its
    typed :class:`ExprNode` (``closure.node``), which a stage compiles into
    an :class:`ExprProgram`; the closures are the program's specification.
    ``mode`` (the precision mode when None) fixes the value dtypes: x32
    computes in float32/int32 as the reference's x32 closures do.
    """

    def __init__(self, schema: pa.Schema, mode: Optional[str] = None):
        self.schema = schema
        self.leaves: dict[str, LeafSpec] = {}
        self.mode = mode or precision_mode()
        self.x32 = self.mode == "x32"
        self.F = value_dtype(self.mode)
        self.I = index_dtype(self.mode)

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
        if self.x32 and (pa.types.is_timestamp(t) or pa.types.is_date64(t)):
            # ns/ms epoch values overflow int32: these stay on the CPU
            raise NotLowerable(f"column {e.colname}: {t} needs int64 (x32 mode)")
        name = f"col_{e.index}"
        self.leaves[name] = LeafSpec(name, "column", col_index=e.index)
        vname = f"{name}__valid"

        def run(env: dict):
            return env[name], env[vname]

        return _with_node(
            run, ExprNode("leaf", _pa_to_torch_dtype(t, self.mode), (), (name, vname))
        )

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

        run.valid_name = vname
        return run

    def pair_column(self, e: pe.Col) -> TorchClosure:
        """x32: leaf that ships an int64 (or f64) column as an exact f32
        (hi, lo) pair, read only by the pair-aware sums
        (``KernelAggSpec.pair``)."""
        name = f"col_{e.index}__pair"
        self.leaves[name] = LeafSpec(name, "column_pair", col_index=e.index)
        vname = f"{name}__valid"

        def run(env: dict):
            return (env[f"{name}__hi"], env[f"{name}__lo"]), env[vname]

        # each half as a float32 leaf of the expression program (the
        # square pair of the variance family reads them there)
        run.halves = tuple(
            _with_node(lambda env, h=h: (env[h], env[vname]),
                       ExprNode("leaf", F32, (), (h, vname)))
            for h in (f"{name}__hi", f"{name}__lo")
        )
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
            run, ExprNode("leaf", _pa_to_torch_dtype(out_t, self.mode), (), (name, vname))
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
                bits = 31 if self.x32 else 63
                if not -(2**bits) <= v < 2**bits:
                    raise NotLowerable(f"int literal {v} exceeds {self.I}")
                dtype, value = self.I, v
            elif isinstance(v, float):
                dtype, value = self.F, v
            elif _is_date(v):
                dtype, value = self.I, _days(v)
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

                return _with_node(run_bool, _node(op.lower(), lf, rf, mode=self.mode))
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

                return _with_node(run_bin, _node(_BINARY_OPS[op], lf, rf, mode=self.mode))
            if op == "/":

                def run_div(env, lf=lf, rf=rf, fdt=self.F):
                    lv, lval = lf(env)
                    rv, rval = rf(env)
                    if _is_int(lv) and _is_int(rv):
                        return _trunc_div(lv, rv), _merge_valid(lval, rval)
                    return lv.to(fdt) / rv.to(fdt), _merge_valid(lval, rval)

                return _with_node(run_div, _node("div", lf, rf, mode=self.mode))
            if op == "%":

                def run_mod(env, lf=lf, rf=rf):
                    lv, lval = lf(env)
                    rv, rval = rf(env)
                    return _floor_mod(lv, rv), _merge_valid(lval, rval)

                return _with_node(run_mod, _node("mod", lf, rf, mode=self.mode))
            raise NotLowerable(f"binary op {op}")

        if isinstance(e, pe.Not):
            f = self._lower_or_leaf(e.expr)

            def run_not(env, f=f):
                v, val = f(env)
                v = v if val is None else torch.logical_and(v, val)
                return torch.logical_not(v), None

            return _with_node(run_not, _node("not", f, mode=self.mode))

        if isinstance(e, pe.Negative):
            f = self._lower(e.expr)

            def run_neg(env, f=f):
                v, val = f(env)
                return -v, val

            return _with_node(run_neg, _node("neg", f, mode=self.mode))

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
                run_isnull, _node("is_not_null" if negated else "is_null", f, mode=self.mode)
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
            if all_int and self.x32 and any(
                not -(2**31) <= i < 2**31 for i in items
            ):
                raise NotLowerable("IN list item exceeds int32")
            consts = (
                _const(list(items), self.I)
                if all_int
                else _const([_to_num(i) for i in items], self.F)
            )
            negated = e.negated

            def run_in(env, f=f, consts=consts, negated=negated, all_int=all_int,
                       fdt=self.F, idt=self.I):
                v, val = f(env)
                rhs = consts(env)
                if all_int and _is_int(v):
                    lhs = v.to(idt)
                else:
                    lhs = v.to(fdt)
                    rhs = rhs.to(fdt)
                m = torch.eq(lhs[:, None], rhs[None, :]).any(dim=1)
                if negated:
                    m = torch.logical_not(m)
                return m, val

            return _with_node(run_in, _in_node(f, items, all_int, negated, self.mode))

        if isinstance(e, pe.Case):
            whens = [
                (self._lower_or_leaf(w), self._lower(t)) for w, t in e.whens
            ]
            else_f = self._lower(e.else_expr) if e.else_expr is not None else None
            out_dtype = _pa_to_torch_dtype(e.out_type, self.mode)
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
            dt = _pa_to_torch_dtype(e.to_type, self.mode)

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

                def run_fn(env, f=f, fn=fn, fdt=self.F):
                    v, val = f(env)
                    return fn(v.to(fdt)), val

                return _with_node(run_fn, _node(e.fname, f, mode=self.mode))
            if e.fname == "power" and len(e.args) == 2:
                a = self._lower(e.args[0])
                b = self._lower(e.args[1])

                def run_pow(env, a=a, b=b, fdt=self.F):
                    av, aval = a(env)
                    bv, bval = b(env)
                    return torch.pow(av.to(fdt), bv.to(fdt)), _merge_valid(aval, bval)

                return _with_node(run_pow, _node("power", a, b, mode=self.mode))
            if e.fname == "round":
                f = self._lower(e.args[0])

                def run_round(env, f=f, fdt=self.F):
                    v, val = f(env)
                    # half-to-even, as jnp.round
                    return torch.round(v.to(fdt)), val

                return _with_node(run_round, _node("round", f, mode=self.mode))
            raise NotLowerable(f"scalar fn {e.fname}")

        raise NotLowerable(f"node {type(e).__name__}")


def square_closure(closure: TorchClosure) -> TorchClosure:
    """x² in float64 (the variance family's second moment)."""

    def run(env: dict):
        v, valid = closure(env)
        v = v.to(F64)
        return v * v, valid

    return _with_node(run, _node("square", closure))


def square_pair_twin(hi: torch.Tensor, lo: torch.Tensor) -> tuple:
    """x² of the exact float32 pair x = hi + lo as a float32 pair (p, e),
    the arithmetic of the reference's ``square_pair_closure`` as XLA
    compiles it (kernel B12f):

    * p = fl(hi·hi);
    * e = hi·hi - p exactly (the Dekker two-product, which XLA contracts
      into one FMA), NaN where the Veltkamp split ``hi·4097`` overflows
      (|hi| past about 8.3e34, infinities included);
    * e = fl(fma(2·hi, lo, e) + fl(lo·lo)), the reference's
      ``e + 2·hi·lo + lo·lo`` with its contraction.

    The FMA is exact here: 2·hi·lo is exact in float64, the 2Sum of it and
    e is exact, and rounding that pair to odd in float64 and then to
    nearest in float32 rounds the exact sum once.  NaN payloads aside, the
    CUDA opcode gives the same bits (``__fmaf_rn``)."""
    with torch.no_grad():
        hi, lo = hi.to(F32), lo.to(F32)
        p = hi * hi
        e = ((hi.to(F64) * hi.to(F64)) - p.to(F64)).to(F32)
        split = hi * 4097.0
        e = torch.where(torch.isinf(split), torch.full_like(e, math.nan), e)
        a = (hi * 2.0).to(F64) * lo.to(F64)
        b = e.to(F64)
        s, t = _two_sum(a, b)
        bits = s.view(I64)
        odd = torch.isfinite(s) & torch.isfinite(t) & (t != 0) & ((bits & 1) == 0)
        bits = torch.where(odd, torch.where((t > 0) == (s > 0), bits + 1, bits - 1), bits)
        e = bits.view(F64).to(F32) + lo * lo
    return p, e


def square_pair_closure(pair_closure: TorchClosure) -> TorchClosure:
    """x² as a float32 pair from a pair leaf (the variance family in x32):
    ``((p, e), valid)`` with p the ``square`` of hi and e the ``sqpair_lo``
    of (hi, lo), both registers of the expression program (B12f, one B3
    launch); ``.halves`` holds the two as closures with their nodes."""
    hi_c, lo_c = pair_closure.halves

    def run(env: dict):
        (hi, lo), valid = pair_closure(env)
        return square_pair_twin(hi, lo), valid

    p_node = ExprNode("square", F32, (hi_c.node,))
    e_node = ExprNode("sqpair_lo", F32, (hi_c.node, lo_c.node))

    def p_run(env: dict):
        (hi, _lo), valid = pair_closure(env)
        return hi * hi, valid

    def e_run(env: dict):
        (hi, lo), valid = pair_closure(env)
        return square_pair_twin(hi, lo)[1], valid

    run.halves = (_with_node(p_run, p_node), _with_node(e_run, e_node))
    run.in_program = True
    return run


def _merge_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return torch.logical_and(a, b)


def _is_int(t: torch.Tensor) -> bool:
    return not t.is_floating_point() and t.dtype != torch.bool


def _wide(*ts: torch.Tensor) -> bool:
    """Whether the operands are x64 values (x32's are int32/float32; the
    two modes never meet in one expression)."""
    return any(t.dtype in (F64, I64) for t in ts)


def _numeric_align(lv, rv):
    if lv.dtype == torch.bool or rv.dtype == torch.bool:
        return lv, rv
    wide = _wide(lv, rv)
    if lv.is_floating_point() or rv.is_floating_point():
        fdt = F64 if wide else F32
        return lv.to(fdt), rv.to(fdt)
    idt = I64 if wide else I32
    return lv.to(idt), rv.to(idt)


def _trunc_div(lv: torch.Tensor, rv: torch.Tensor) -> torch.Tensor:
    """SQL / Arrow integer ``/``: truncates toward zero (``//`` would
    floor) with a zero divisor guarded, as the reference's ``lax.div``;
    ``x / -1`` is the wrapping negation, so ``INT64_MIN / -1`` is
    ``INT64_MIN`` as in XLA (the CPU's division traps there).  In the
    operands' width (int32 in x32)."""
    idt = I64 if _wide(lv, rv) else I32
    lv, rv = lv.to(idt), rv.to(idt)
    neg1 = rv == -1
    rv_safe = torch.where((rv == 0) | neg1, torch.ones_like(rv), rv)
    return torch.where(neg1, -lv, torch.div(lv, rv_safe, rounding_mode="trunc"))


def _floor_mod(lv: torch.Tensor, rv: torch.Tensor) -> torch.Tensor:
    """``jnp.mod``: floor modulo; an integer zero divisor gives 0 (torch
    raises on the CPU and returns garbage on CUDA, so it is guarded), and
    so does -1 (``INT64_MIN % -1`` traps on the CPU)."""
    wide = _wide(lv, rv)
    if _is_int(lv) and _is_int(rv):
        idt = I64 if wide else I32
        lv, rv = lv.to(idt), rv.to(idt)
        zero = rv == 0
        r = torch.remainder(lv, torch.where(zero | (rv == -1), torch.ones_like(rv), rv))
        return torch.where(zero, torch.zeros_like(r), r)
    fdt = F64 if wide else F32
    return torch.remainder(lv.to(fdt), rv.to(fdt))


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: NaN stays NaN and ±0.0 keeps its sign (torch.sign
    maps both to +0.0)."""
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


def _cast(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``astype`` with XLA's float → integer conversion: truncate toward
    zero, saturate at the integer range, NaN → 0 (torch leaves these
    undefined).  float32 → int32 compares in float32, as XLA does."""
    if dt in (I64, I32) and v.is_floating_point():
        bits = 63 if dt == I64 else 31
        if dt == I64:
            v = v.to(F64)
        hi = v >= 2.0**bits
        lo = v < -(2.0**bits)
        bad = hi | lo | torch.isnan(v)
        out = torch.where(bad, torch.zeros_like(v), v).to(dt)
        out = torch.where(hi, torch.full_like(out, 2**bits - 1), out)
        return torch.where(lo, torch.full_like(out, -(2**bits)), out)
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
    trivial_valid: Optional[set] = None, mode: str = "x64",
) -> dict[str, np.ndarray]:
    """Evaluate/extract all leaf arrays for one batch, padded to n_padded.

    Every leaf ships a validity companion (all-true when the batch has no
    nulls).  Names of companions that are trivially all-true over the live
    rows are added to ``trivial_valid`` when given: the stage replaces them
    with ``None`` so they never cross the bridge.  In ``mode`` "x32" the
    values narrow to float32/int32 (:func:`coerce_host_values`) and a pair
    leaf ships its exact f32 (hi, lo) split; a value those cannot carry
    raises :class:`X32RangeError`.
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
        if spec.kind == "column_pair":
            hi, lo = _pair_split(values)
            env[f"{name}__hi"] = _pad(hi, n_padded)
            env[f"{name}__lo"] = _pad(lo, n_padded)
            continue
        env[name] = _pad(coerce_host_values(values, mode), n_padded)
    return env


def _pair_split(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """x32: the exact f32 (hi, lo) split of an int64 or f64 column
    (hi = f32(v), lo = f32(v - hi)).  Integers past 2^48 lose low bits in
    the split and floats past the f32 range have no hi: both raise
    :class:`X32RangeError`."""
    v = values.astype(np.float64)
    if len(v) and values.dtype.kind in "iu" and np.abs(v).max() >= float(1 << 48):
        raise X32RangeError("int64 column exceeds 48-bit pair range in x32 mode")
    if len(v) and values.dtype.kind == "f" and np.abs(v).max() >= 3e38:
        raise X32RangeError("f64 column exceeds f32 range")
    hi = v.astype(np.float32)
    return hi, (v - hi.astype(np.float64)).astype(np.float32)


def coerce_host_values(values: np.ndarray, mode: str = "x64") -> np.ndarray:
    """Convert host arrays to the mode's device dtypes before transfer.

    x64: every integer leaf (date32 days included) becomes int64 and every
    float leaf float64, which is what the reference's lowering aligns them
    to before any arithmetic, comparison or aggregate.  The compiler keeps
    uint64 leaves off the device at plan time; uint64 values past the
    int64 range raise ExecutionError here all the same.  x32: floats
    become float32 and integers int32 (half the bytes); an integer past
    the int32 range raises :class:`X32RangeError` and the stage re-runs
    the partition on the CPU operators.
    """
    kind = values.dtype.kind
    if mode == "x32":
        if kind == "b":
            return values
        if kind == "f":
            return values.astype(np.float32)
        if kind in "iu":
            if values.dtype.itemsize >= 4 and len(values) and (
                values.max() > np.iinfo(np.int32).max
                or (kind == "i" and values.min() < np.iinfo(np.int32).min)
            ):
                raise X32RangeError("int64 column exceeds i32 range in x32 mode")
            return values.astype(np.int32)
        raise ExecutionError(f"dtype {values.dtype} cannot cross the device bridge")
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
        elif spec.kind == "column_pair":
            out.extend([f"{n}__hi", f"{n}__lo", f"{n}__valid"])
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
    # (the reference sums in f64, exact only below 2^53); x64 only
    int_sum: bool = False
    # x32 only: the argument is an exact f32 (hi, lo) pair of an int64
    # column (avg over int64); the sum adds both halves and recombines
    pair: bool = False
    # x32 only: min/max over an f64 column rides an order-preserving
    # (hi, lo) int32 pair, so the extremum is bit-exact
    ord_pair: bool = False


def _state_mode(state) -> str:
    """The mode of a state tensor or packed array: x32 states are int32."""
    return "x32" if state.dtype in (I32, np.int32) else "x64"


def state_fields(spec: KernelAggSpec, mode: str = "x64") -> tuple[str, ...]:
    """Per-aggregate kernel-state layout: field roles in output order.

    Roles drive merging: "add" → +, "min"/"max" → elementwise extremum,
    "omin_hi"/"omin_lo" (and omax) → the lexicographic extremum of an
    order pair.  x32 sums carry a double-float (hi, lo) pair.
    """
    if spec.func in ("count", "count_star"):
        return ("add",)
    if spec.func in ("sum", "avg"):
        return ("add", "add", "add") if mode == "x32" else ("add", "add")
    if spec.func in ("min", "max"):
        if spec.ord_pair:
            return (f"o{spec.func}_hi", f"o{spec.func}_lo", "add")
        return (spec.func, "add")
    raise ExecutionError(f"kernel agg {spec.func}")


def state_is_int(spec: KernelAggSpec, mode: str = "x64") -> tuple[bool, ...]:
    """Which state fields are integer (counts) vs float, in layout order."""
    if spec.func in ("count", "count_star"):
        return (True,)
    if spec.func in ("sum", "avg"):
        return (False, False, True) if mode == "x32" else (spec.int_sum, True)
    if spec.ord_pair:
        return (True, True, True)  # (hi, lo, n): all integer
    return (spec.int_minmax, True)  # min/max: (value, n)


def _field_flags(specs: list[KernelAggSpec], mode: str = "x64") -> list[tuple[str, bool]]:
    """(role, is_int) per state row, presence last."""
    out = []
    for spec in specs:
        out.extend(zip(state_fields(spec, mode), state_is_int(spec, mode)))
    out.append(("add", True))  # presence
    return out


def _pad_ident(role: str, is_int: bool, mode: str = "x64"):
    """Growth-padding identity per state field, dtype-aware (integer
    min/max states must not pad with float inf)."""
    info = torch.iinfo(index_dtype(mode))
    if role in ("min", "omin_hi", "omin_lo"):
        return info.max if is_int else math.inf
    if role in ("max", "omax_hi", "omax_lo"):
        return info.min if is_int else -math.inf
    return 0


def _ident_bits(role: str, is_int: bool, mode: str = "x64") -> int:
    """The identity of a state row as its storage word (int64 in x64,
    int32 in x32; a float row holds its float's bits)."""
    v = _pad_ident(role, is_int, mode)
    if is_int:
        return int(v)
    if mode == "x32":
        return int(np.array(float(v), np.float32).view(np.int32))
    return int(np.array(float(v), np.float64).view(np.int64))


def init_states(
    specs: list[KernelAggSpec], capacity: int, device, mode: str = "x64"
) -> torch.Tensor:
    """Fresh [n_fields, capacity] state holding every row's identity: int64
    words in x64 (float rows hold float64 bit patterns), int32 words in x32
    (float rows hold float32 bit patterns)."""
    words = [_ident_bits(r, i, mode) for r, i in _field_flags(specs, mode)]
    col = torch.tensor(words, dtype=index_dtype(mode)).to(device)
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
    return torch.cat([acc, init_states(specs, grow, acc.device, _state_mode(acc))], dim=1)


def _fmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.minimum on floats: NaN propagates and -0.0 orders below +0.0."""
    r = torch.minimum(a, b)
    z = (a == 0) & (b == 0)
    neg = torch.signbit(a) | torch.signbit(b)
    return _keep_nan(a, b, torch.where(z, _signed_zero(neg, a.dtype), r))


def _fmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.maximum on floats: NaN propagates and +0.0 orders above -0.0."""
    r = torch.maximum(a, b)
    z = (a == 0) & (b == 0)
    neg = torch.signbit(a) & torch.signbit(b)
    return _keep_nan(a, b, torch.where(z, _signed_zero(neg, a.dtype), r))


def _keep_nan(a: torch.Tensor, b: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The NaN operand itself where there is one (torch's vectorised
    minimum/maximum return an all-ones NaN; XLA and the kernels keep the
    operand's bits)."""
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, r))


def _signed_zero(neg: torch.Tensor, dtype: torch.dtype = F64) -> torch.Tensor:
    zero = torch.zeros(neg.shape, dtype=dtype, device=neg.device)
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
    is the plain form of that epilogue (the twin uses it).  An x32 state
    (int32 words) merges as the reference's x32 ``combine_states``: sums
    by 2Sum of the hi words, order pairs lexicographically
    (:func:`x32_merge_reference`)."""
    if acc is None:
        return new
    if _state_mode(new) == "x32":
        return x32_merge_reference(acc.clone(), x32_merge_ops(specs), list(new))
    rows = [
        _merge_row(role, is_int, acc[i], new[i])
        for i, (role, is_int) in enumerate(_field_flags(specs))
    ]
    return torch.stack(rows, dim=0)


def fetch_states(state: torch.Tensor, keep: Optional[int] = None) -> np.ndarray:
    """ONE device→host copy of the first ``keep`` state columns.  The state
    already has the reference's packed layout ([n_fields, keep], floats as
    their int64 bits, or their int32 bits in x32), so there is nothing to
    pack."""
    cap = state.shape[1]
    if keep is None or keep > cap:
        keep = cap
    return state[:, :keep].cpu().numpy()


def unpack_host(
    specs: list[KernelAggSpec], packed: np.ndarray
) -> list[np.ndarray]:
    """Host-side view of a fetched state (numpy, no device); an int32 pack
    is an x32 state, its float rows float32."""
    mode = _state_mode(packed)
    flags = [f for spec in specs for f in state_is_int(spec, mode)] + [True]
    fdt = np.float32 if mode == "x32" else np.float64
    out = []
    for row, is_int in zip(packed, flags):
        out.append(row if is_int else row.view(fdt))
    return out


# ----------------------------------------------------- JAX-package interop
def specs_from_dicts(dicts: list[dict]) -> list[KernelAggSpec]:
    """Port specs from the reference's ``KernelAggSpec`` fields as plain
    dicts (``dataclasses.asdict``), x32 pair layouts included."""
    return [
        KernelAggSpec(
            d["func"], bool(d["has_arg"]),
            int_minmax=bool(d.get("int_minmax", False)),
            int_sum=bool(d.get("int_sum", False)),
            pair=bool(d.get("pair", False)),
            ord_pair=bool(d.get("ord_pair", False)),
        )
        for d in dicts
    ]


def states_from_numpy(
    spec_dicts: list[dict], arrays, device, mode: str = "x64"
) -> torch.Tensor:
    """The reference's state tuple (one [capacity] array per field, then
    presence) as the port's [n_fields, capacity] state on ``device``: int64
    words in x64, int32 words in x32."""
    flags = _field_flags(specs_from_dicts(spec_dicts), mode)
    arrays = [np.asarray(a) for a in arrays]
    if len(arrays) != len(flags):
        raise ValueError(f"{len(arrays)} state arrays for {len(flags)} fields")
    idt, fdt = (np.int32, np.float32) if mode == "x32" else (np.int64, np.float64)
    rows = []
    for a, (_role, is_int) in zip(arrays, flags):
        if is_int != (a.dtype.kind in "iu"):
            raise ValueError(f"state field dtype {a.dtype} vs is_int={is_int}")
        rows.append(a.astype(idt) if is_int else a.astype(fdt).view(idt))
    return torch.from_numpy(np.stack(rows)).to(device)


# Launches of each hand-written kernel, counted by its wrapper where it
# launches (window_kernel.py's wrappers count here too); a twin never counts.
# An executor runs several task threads against one card, so a count goes
# through count_launch, under a lock.
LAUNCHES = dict.fromkeys(
    ("expr_eval", "segment_agg", "segment_agg_entries", "radix_sort", "seg_scan", "range_extremum", "window_epilogue",
     "partition_ids", "join_build_table", "join_probe", "key_encode", "keyed_gids",
     "keyed_finish", "keyed_median", "keyed_corr", "keyed_encode_entries", "keyed_unfold",
     "mesh_reduce", "mesh_route", "df32_agg", "ord_extremum", "x32_merge"), 0
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
# scan-only folds of x32's sort route over 64-bit words (seg_scan.cu)
OP_DF32 = 7      # an f32 (hi, lo) pair, hi in the low word: _scan_segments' df32
OP_UMIN_U64 = 8  # unsigned min of a joined order pair (join_u64)
OP_UMAX_U64 = 9
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


@functools.lru_cache(maxsize=256)
def _fold_map(ops: tuple, cols: tuple, counted: frozenset) -> tuple:
    fold_ops: list = []
    fold_cols: list = []
    field_fold: list = []
    index: dict = {}
    for op, c in zip(ops, cols):
        if op == OP_COUNT and c not in counted:
            c = -1  # a column without a validity counts the row mask
        k = index.setdefault((op, c), len(fold_ops))
        if k == len(fold_ops):
            fold_ops.append(op)
            fold_cols.append(c)
        field_fold.append(k)
    return tuple(fold_ops), tuple(fold_cols), tuple(field_fold)


def segment_fold_map(ops, cols, valids_sets) -> tuple:
    """The state fields' distinct folds: ``(fold_ops, fold_cols,
    field_fold)``.  Two fields fold to the same bits when they apply the
    same op to the same column, or count the same mask: a count's fold
    column is its column when that column has a validity in any of
    ``valids_sets`` (one ``valids`` list per entry), else -1 (the row
    mask).  Field ``f`` takes fold ``field_fold[f]``; folds are numbered
    in order of their first field.  The kernels fold each distinct fold
    once and store it to every field that takes it."""
    counted = frozenset(c for v in valids_sets for c, x in enumerate(v) if x is not None)
    return _fold_map(tuple(ops), tuple(cols), counted)


def _check_fields(ops, cols, n_cols: int) -> list:
    """Raise ValueError unless every field's op is a segment op and its
    column in range; returns the distinct (op, column) pairs whose column
    each entry's dtype must match (:func:`_check_rows`)."""
    for f, (op, c) in enumerate(zip(ops, cols)):
        if op not in _OP_ROLE or not -1 <= c < n_cols:
            raise ValueError(f"field {f}: op {op}, column {c}")
    return sorted({(op, c) for op, c in zip(ops, cols) if op != OP_COUNT})


def _check_rows(gid, tail, pred, pvalid, values, valids, typed, state):
    """Raise ValueError unless one batch's inputs have the devices, dtypes,
    shapes and layouts the binding accepts (``typed``: the
    :func:`_check_fields` pairs).  The binding checks them too, but with
    some toolchains an exception thrown inside the extension ends the
    process (SIGSEGV) instead of raising, so bad input is turned away here,
    before the binding."""
    dev = state.device

    def bad(x, dtypes, shape) -> bool:
        return (
            x.device != dev or x.dtype not in dtypes
            or x.shape != shape or not x.is_contiguous()
        )

    if dev.type != "cuda" or state.dtype != I64 or state.dim() != 2 or (
        not state.is_contiguous()
    ):
        raise ValueError("state must be a contiguous CUDA int64 [n_fields, capacity]")
    if gid.dim() != 1 or bad(gid, (torch.int32,), gid.shape):
        raise ValueError(f"gid must be contiguous int32 [n] on {dev}")
    shape = gid.shape
    for name, m in (("tail", tail), ("pred", pred), ("pvalid", pvalid)):
        if m is not None and bad(m, (torch.bool,), shape):
            raise ValueError(f"{name} must be contiguous bool [{shape[0]}] on {dev}")
    for c, m in enumerate(valids):
        if m is not None and bad(m, (torch.bool,), shape):
            raise ValueError(f"validity {c} must be contiguous bool [{shape[0]}] on {dev}")
    if pvalid is not None and pred is None:
        raise ValueError("pvalid without pred")
    for c, v in enumerate(values):
        if v is not None and bad(v, (F64, I64), shape):
            raise ValueError(f"column {c} must be contiguous f64/i64 [{shape[0]}] on {dev}")
    for op, c in typed:
        v = values[c] if c >= 0 else None
        if v is None or v.dtype != (I64 if _OP_ROLE[op][1] else F64):
            raise ValueError(f"op {op} on column {c} does not match its column")


def _check_cuda_args(gid, tail, pred, pvalid, values, valids, ops, cols, state):
    """:func:`_check_fields` and :func:`_check_rows` for one batch."""
    typed = _check_fields(ops, cols, len(values))
    _check_rows(gid, tail, pred, pvalid, values, valids, typed, state)


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
    scatter route and ``combine_states``.  The fields are checked here,
    the devices, dtypes, shapes and layouts by the binding before it
    launches (ValueError on anything else); a failed build or launch raises
    — there is no fallback to the twin.
    """
    from .cuda.build import load

    _check_fields(ops, cols, len(values))
    fold_ops, fold_cols, field_fold = segment_fold_map(ops, cols, (valids,))
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
        list(field_fold),
        list(fold_ops),
        list(fold_cols),
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
    ``pack_states`` in one program).  The fields are checked here, every
    entry's inputs by the binding before it launches (ValueError); a failed
    build or launch raises, and nothing falls back to the one-batch kernel
    or the twin."""
    from .cuda.build import load

    if not entries:
        raise ValueError("segment_agg_entries: no entries")
    n_cols = len(entries[0][4])
    _check_fields(ops, cols, n_cols)
    empty = torch.empty(0, dtype=torch.bool, device=state.device)

    def opt(x):
        return empty if x is None else x

    args: tuple = ([], [], [], [], [], [])  # gid, tail, pred, pvalid, values, valids
    for gid, tail, pred, pvalid, values, valids in entries:
        if len(values) != n_cols:
            raise ValueError("segment_agg_entries: every entry has the same columns")
        for out, x in zip(args, (gid, opt(tail), opt(pred), opt(pvalid),
                                 [opt(v) for v in values], [opt(v) for v in valids])):
            out.append(x)
    fold_ops, fold_cols, field_fold = segment_fold_map(ops, cols, [e[5] for e in entries])
    load().segment_agg_entries(
        *args, list(ops), list(field_fold), list(fold_ops), list(fold_cols), state
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


# ------------------------------------------------------------ x32 kernels
# Three kernels serve the x32 partial aggregate (ROADMAP B12):
#   D  (ops/cuda/df32_agg.cu)     — double-float segment sums and exact
#                                   counts (the reference's
#                                   _blocked_onehot_agg and
#                                   _segment_sum_df32);
#   E  (ops/cuda/ord_extremum.cu) — the per-group extremum of order pairs
#                                   and of single f32/i32 words
#                                   (_ord_segment_extremum, segment_min/max);
#   M  (ops/cuda/x32_merge.cu)    — the x32 state merge (combine_states'
#                                   x32 branches, _two_sum and _lex_merge).
DF32_BLOCK = 1 << 14  # rows per block of D's matmul form (_MATMUL_BLOCK)
DF32_MAX_COLUMNS = 32  # df32_agg.h: kDfMaxCols

# x32 state-merge codes, one per state row (x32_merge.h: X32Op)
XM_SUM_HI = 0    # a (hi, lo) f32 pair: this row and the next, merged by 2Sum
XM_SUM_LO = 1    # the lo word of the pair above (merged with it)
XM_ADD_I32 = 2   # counts and presence
XM_MIN_F32 = 3
XM_MAX_F32 = 4
XM_MIN_I32 = 5
XM_MAX_I32 = 6
XM_OMIN_HI = 7   # an order pair: this row (hi) and the next (lo)
XM_OMAX_HI = 8
XM_PAIR_LO = 9   # the lo word of the order pair above

# E's operand kinds (ord_extremum.h: OrdKind)
ORD_PAIR, ORD_F32, ORD_I32 = 0, 1, 2


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Knuth 2Sum: s = fl(a + b) and its exact rounding error e (no FMA;
    torch's float32 adds round once each)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _lex_merge(a_hi, a_lo, b_hi, b_lo, is_min: bool) -> tuple:
    """Lexicographic (hi, lo) extremum: with the order-pair encoding of an
    f64 this is the f64 min/max."""
    if is_min:
        better_b = (b_hi < a_hi) | ((b_hi == a_hi) & (b_lo < a_lo))
    else:
        better_b = (b_hi > a_hi) | ((b_hi == a_hi) & (b_lo > a_lo))
    return torch.where(better_b, b_hi, a_hi), torch.where(better_b, b_lo, a_lo)


def x32_merge_ops(specs: list[KernelAggSpec]) -> list[int]:
    """The merge code of every row of an x32 state, presence last."""
    ops: list[int] = []
    for spec in specs:
        if spec.func in ("count", "count_star"):
            ops.append(XM_ADD_I32)
        elif spec.func in ("sum", "avg"):
            ops.extend([XM_SUM_HI, XM_SUM_LO, XM_ADD_I32])
        elif spec.ord_pair:
            ops.extend([XM_OMIN_HI if spec.func == "min" else XM_OMAX_HI,
                        XM_PAIR_LO, XM_ADD_I32])
        elif spec.int_minmax:
            ops.extend([XM_MIN_I32 if spec.func == "min" else XM_MAX_I32, XM_ADD_I32])
        else:
            ops.extend([XM_MIN_F32 if spec.func == "min" else XM_MAX_F32, XM_ADD_I32])
    ops.append(XM_ADD_I32)  # presence
    return ops


def _x32_merge_row(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One single-word x32 state row merged (int32 words)."""
    if op == XM_ADD_I32:
        return a + b
    if op == XM_MIN_I32:
        return torch.minimum(a, b)
    if op == XM_MAX_I32:
        return torch.maximum(a, b)
    fn = _fmin if op == XM_MIN_F32 else _fmax
    return fn(a.view(F32), b.view(F32)).view(I32)


def x32_merge_reference(state: torch.Tensor, ops: list[int], rows: list) -> torch.Tensor:
    """Plain twin of the x32 state merge (kernel M): ``rows`` (one int32
    [capacity] tensor per state row, floats as their bits) merged into the
    int32 ``state`` in place, as the reference's x32 ``combine_states``:
    a sum's (hi, lo) by ``s, e = 2Sum(acc_hi, new_hi)``, ``lo = acc_lo +
    new_lo + e``; an order pair lexicographically; the rest by i32 add or
    f32/i32 min/max (NaN propagates, -0.0 below +0.0)."""
    for f, op in enumerate(ops):
        if op in (XM_SUM_LO, XM_PAIR_LO):
            continue
        if op == XM_SUM_HI:
            s, e = _two_sum(state[f].view(F32), rows[f].view(F32))
            lo = state[f + 1].view(F32) + rows[f + 1].view(F32) + e
            state[f] = s.view(I32)
            state[f + 1] = lo.view(I32)
        elif op in (XM_OMIN_HI, XM_OMAX_HI):
            hi, lo = _lex_merge(state[f], state[f + 1], rows[f], rows[f + 1],
                                op == XM_OMIN_HI)
            state[f] = hi
            state[f + 1] = lo
        else:
            state[f] = _x32_merge_row(op, state[f], rows[f])
    return state


def _check_x32_rows(state, ops, rows) -> None:
    if state.dtype != I32 or state.dim() != 2 or not state.is_contiguous():
        raise ValueError("x32 state must be a contiguous int32 [n_fields, capacity]")
    if len(ops) != state.shape[0] or len(rows) != len(ops) or len(ops) > MAX_FIELDS:
        raise ValueError(f"x32_merge: {len(ops)} ops, {len(rows)} rows, {state.shape[0]} fields")
    for f, (op, r) in enumerate(zip(ops, rows)):
        if not 0 <= op <= XM_PAIR_LO:
            raise ValueError(f"x32_merge: field {f}: op {op}")
        _check_cuda_tensor(r, f"x32_merge row {f}", (I32,), state.shape[1], state.device)


def x32_merge_cuda(state: torch.Tensor, ops: list[int], rows: list) -> torch.Tensor:
    """Launch the hand-written x32 state merge (ops/cuda/x32_merge.cu).

    Replaces the x32 branches of ``arrow_ballista_tpu/ops/kernels.py:
    combine_states`` (with ``_two_sum`` and ``_lex_merge``).  Inputs are
    checked (ValueError); a failed build or launch raises."""
    from .cuda.build import load

    if state.device.type != "cuda":
        raise ValueError("x32_merge_cuda takes CUDA tensors")
    _check_x32_rows(state, ops, rows)
    load().x32_merge(state, list(ops), list(rows))
    count_launch("x32_merge")
    return state


def x32_merge(state: torch.Tensor, ops: list[int], rows: list) -> torch.Tensor:
    """Merge ``rows`` into the x32 ``state`` in place: the CUDA kernel for
    CUDA tensors, its plain twin for tensors on the CPU."""
    if state.device.type == "cpu":
        return x32_merge_reference(state, ops, rows)
    return x32_merge_cuda(state, ops, rows)


def _x32_row_mask(n: int, tail, pred, pvalid, device) -> torch.Tensor:
    """tail ∧ pred ∧ pvalid (all-true where None), the kernels' row mask."""
    mask = torch.ones(n, dtype=torch.bool, device=device) if tail is None else tail
    if pred is not None:
        p = pred if pvalid is None else torch.logical_and(pred, pvalid)
        mask = torch.logical_and(mask, p)
    return mask


def _col_mask(mask: torch.Tensor, valids: list, c: int) -> torch.Tensor:
    return mask if c < 0 or valids[c] is None else torch.logical_and(mask, valids[c])


def df32_scatter_block(n: int, capacity: int, device) -> int:
    """Rows per block of D's scatter form: the reference's
    ``_segment_sum_df32`` rule for its backend — the CPU's
    ``max(256, min(4096, n // 64))``, an accelerator's ``max(8192,
    ⌈n/64⌉)`` up to capacity 2^16, else ``max(2^16, ⌈n/8⌉)``."""
    if torch.device(device).type == "cpu":
        return int(max(256, min(4096, n // 64)))
    if capacity <= (1 << 16):
        return int(max(8192, -(-n // 64)))
    return int(max(1 << 16, -(-n // 8)))


def _df32_blocks(n: int, block: int) -> int:
    """The pow2 block count of the pair tree (at least one block)."""
    nb = max(1, -(-n // block))
    return 1 << (nb - 1).bit_length()


def _df32_tree(part: torch.Tensor) -> tuple:
    """The reference's pairwise double-float tree over [nb, ...] f32 block
    partials (nb a power of two): ``hi[0::2]`` with ``hi[1::2]`` by 2Sum,
    ``lo = lo[0::2] + lo[1::2] + e``.  Returns (hi, lo)."""
    hi = part
    lo = torch.zeros_like(hi)
    while hi.shape[0] > 1:
        s, e = _two_sum(hi[0::2], hi[1::2])
        hi, lo = s, lo[0::2] + lo[1::2] + e
    return hi[0], lo[0]


def df32_agg_reference(gid, tail, pred, pvalid, values, valids, sums, counts,
                       capacity: int, block: int) -> tuple:
    """Plain twin of the double-float segment sum (kernel D).

    Rows split into ``block``-row blocks, padded with zeros to a power-of-
    two block count; each block's per-group sum of every masked f32 column
    (row mask tail ∧ pred ∧ pvalid, then the column's validity; a masked
    row adds 0), rounded once to f32 (accumulated in f64 here; the kernel
    adds in f32 in a fixed tree), then the reference's pairwise 2Sum tree
    over the blocks.  ``sums`` lists each output's columns ``(a, b)``: b >=
    0 sums a second column (an int64 pair's lo half) by its own tree, and
    the two combine as ``s, e = 2Sum(hi_a, hi_b)``, ``lo = lo_a + lo_b +
    e``.  ``counts`` lists each count's validity column (-1: the row mask),
    exact in int32.  Returns (hi [S, cap] f32, lo [S, cap] f32, counts
    [C, cap] int32)."""
    n = gid.shape[0]
    device = gid.device
    mask = _x32_row_mask(n, tail, pred, pvalid, device)
    g = gid.to(I64)
    nb = _df32_blocks(n, block)
    flat = torch.arange(n, dtype=I64, device=device) // block * capacity + g

    def tree(c: int) -> tuple:
        v = torch.where(_col_mask(mask, valids, c), values[c].to(F64),
                        torch.zeros((), dtype=F64, device=device))
        part = torch.zeros(nb * capacity, dtype=F64, device=device).index_add_(0, flat, v)
        return _df32_tree(part.to(F32).view(nb, capacity))

    his, los = [], []
    for a, b in sums:
        hi, lo = tree(a)
        if b >= 0:
            hi_b, lo_b = tree(b)
            hi, e = _two_sum(hi, hi_b)
            lo = lo + lo_b + e
        his.append(hi)
        los.append(lo)
    cnts = []
    for c in counts:
        cnt = torch.zeros(capacity, dtype=I64, device=device)
        cnts.append(cnt.index_add_(0, g, _col_mask(mask, valids, c).to(I64)).to(I32))

    def stack(rows, dtype):
        if not rows:
            return torch.empty((0, capacity), dtype=dtype, device=device)
        return torch.stack(rows)

    return stack(his, F32), stack(los, F32), stack(cnts, I32)


def _check_df32_args(gid, tail, pred, pvalid, values, valids, sums, counts,
                     capacity, block) -> None:
    device = gid.device
    if device.type != "cuda":
        raise ValueError("df32_agg_cuda takes CUDA tensors")
    n = gid.shape[0]
    _check_cuda_tensor(gid, "gid", (torch.int32,), n, device)
    for name, m in (("tail", tail), ("pred", pred), ("pvalid", pvalid)):
        if m is not None:
            _check_cuda_tensor(m, name, (torch.bool,), n, device)
    if pvalid is not None and pred is None:
        raise ValueError("pvalid without pred")
    if len(values) != len(valids) or len(values) > DF32_MAX_COLUMNS:
        raise ValueError(f"df32_agg: {len(values)} columns")
    read = {a for a, _ in sums} | {b for _, b in sums if b >= 0}
    for c, (v, ok) in enumerate(zip(values, valids)):
        if c in read:
            _check_cuda_tensor(v, f"column {c}", (F32,), n, device)
        if ok is not None:
            _check_cuda_tensor(ok, f"validity {c}", (torch.bool,), n, device)
    if len(sums) + len(counts) == 0 or len(sums) > DF32_MAX_COLUMNS or (
        len(counts) > DF32_MAX_COLUMNS
    ):
        raise ValueError(f"df32_agg: {len(sums)} sums, {len(counts)} counts")
    if any(not 0 <= c < len(values) for c in read) or any(
        not -1 <= c < len(values) for c in counts
    ):
        raise ValueError("df32_agg: column index out of range")
    if block < 1 or capacity < 1 or n >= 1 << 31 or _df32_blocks(n, block) > 1 << 20:
        # 2^20 blocks: df32_agg.h's kDfMaxLevels, the depth of pass 2's stack
        raise ValueError(f"df32_agg: block {block}, capacity {capacity}, {n} rows")


def df32_agg_cuda(gid, tail, pred, pvalid, values, valids, sums, counts,
                  capacity: int, block: int) -> tuple:
    """Launch the hand-written double-float segment sum (ops/cuda/
    df32_agg.cu).  Pass 1 reads each input once (up to capacity 8192):
    a CTA sorts a run of rows (a 2^14-row block, or a slice of a larger
    one) by group in shared memory and folds each summed column and count
    of the sorted rows into per-group f32 partials in a fixed order (no
    one-hot, no GEMM); pass 2 runs the pairwise 2Sum tree over the blocks,
    parallel over blocks and groups.  Same results as
    :func:`df32_agg_reference` within rel 1e-6 on hi + lo, counts exact,
    two launches bit-identical.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:_blocked_onehot_agg``
    (block 2^14, every sum and count column) and ``_segment_sum_df32``
    (each column by its own tree at the backend's block).  Inputs are
    checked (ValueError); a failed build or launch raises."""
    from .cuda.build import load

    _check_df32_args(gid, tail, pred, pvalid, values, valids, sums, counts,
                     capacity, block)
    device = gid.device
    n = gid.shape[0]
    nb = _df32_blocks(n, block)
    slots = sorted({a for a, _ in sums} | {b for _, b in sums if b >= 0})
    hi = torch.empty((len(sums), capacity), dtype=F32, device=device)
    lo = torch.empty((len(sums), capacity), dtype=F32, device=device)
    cnt = torch.empty((len(counts), capacity), dtype=I32, device=device)
    run_rows = 1 << 14  # df32_agg.h: kDfRunRows, a block's runs in pass 1
    runs = max(1, -(-n // block)) * -(-block // run_rows)
    partial = torch.empty(runs * (len(slots) + len(counts)) * capacity,
                          dtype=F32, device=device)
    empty = torch.empty(0, dtype=torch.bool, device=device)

    def opt(x):
        return empty if x is None else x

    load().df32_agg(
        gid, opt(tail), opt(pred), opt(pvalid),
        [opt(v) for v in values], [opt(v) for v in valids],
        slots, [slots.index(a) for a, _ in sums],
        [slots.index(b) if b >= 0 else -1 for _, b in sums],
        list(counts), capacity, block, nb, hi, lo, cnt, partial,
    )
    count_launch("df32_agg")
    return hi, lo, cnt


def df32_agg(gid, tail, pred, pvalid, values, valids, sums, counts,
             capacity: int, block: int) -> tuple:
    """Double-float segment sums and exact counts: the CUDA kernel for
    CUDA tensors, its plain twin for tensors on the CPU.  D's matmul form
    is ``block`` = :data:`DF32_BLOCK`, its scatter form
    :func:`df32_scatter_block`; either reduces every column by its own
    tree."""
    if gid.device.type == "cpu":
        return df32_agg_reference(gid, tail, pred, pvalid, values, valids, sums,
                                  counts, capacity, block)
    return df32_agg_cuda(gid, tail, pred, pvalid, values, valids, sums, counts,
                         capacity, block)


_I64_MIN = -(1 << 63)
_F32_CANON_NAN = 0x7FC00000


def _ord_keys(kind: int, hi: torch.Tensor, lo, is_min: bool) -> torch.Tensor:
    """E's sort keys as int64 whose signed order is the operand order:
    an order pair ``hi * 2^32 + (lo + 2^31)`` (the unsigned order of
    ``join_u64``), an f32 its IEEE order key in [0, 2^32) with NaN the
    extreme the reference's scatter min/max keeps (0 for min, 2^32 - 1
    for max), an i32 ``v + 2^31``."""
    if kind == ORD_PAIR:
        return hi.to(I64) * (1 << 32) + (lo.to(I64) + (1 << 31))
    if kind == ORD_I32:
        return hi.to(I64) + (1 << 31)
    bits = hi.view(I32).to(I64) & 0xFFFFFFFF
    key = torch.where(bits >= (1 << 31), bits ^ 0xFFFFFFFF, bits | (1 << 31))
    nan = torch.isnan(hi.view(F32))
    return torch.where(nan, torch.full_like(key, 0 if is_min else 0xFFFFFFFF), key)


def _ord_ident(kind: int, is_min: bool) -> int:
    """The key of an empty group: the reference's identity (INT32_MAX
    pairs, +inf, INT32_MAX for a min; their opposites for a max)."""
    if kind == ORD_PAIR:
        return (1 << 63) - 1 if is_min else _I64_MIN
    if kind == ORD_I32:
        return (1 << 32) - 1 if is_min else 0
    return 0xFF800000 if is_min else 0x007FFFFF  # +inf / -inf


def _ord_decode(kind: int, key: torch.Tensor, is_min: bool) -> torch.Tensor:
    """Keys back to state words: [2, cap] (hi, lo) for a pair, else [1, cap]."""
    if kind == ORD_PAIR:
        hi = torch.div(key, 1 << 32, rounding_mode="floor")
        lo = key - hi * (1 << 32) - (1 << 31)
        return torch.stack([hi.to(I32), lo.to(I32)])
    if kind == ORD_I32:
        return (key - (1 << 31)).to(I32)[None]
    nan = key == (0 if is_min else 0xFFFFFFFF)
    bits = torch.where(key >= (1 << 31), key & 0x7FFFFFFF, key ^ 0xFFFFFFFF)
    bits = torch.where(nan, torch.full_like(bits, _F32_CANON_NAN), bits)
    return torch.where(bits >= (1 << 31), bits - (1 << 32), bits).to(I32)[None]


def ord_extremum_reference(gid, tail, pred, pvalid, valid, hi, lo, capacity: int,
                           is_min: bool) -> torch.Tensor:
    """Plain twin of the exact per-group extremum (kernel E) over rows where
    tail ∧ pred ∧ pvalid ∧ ``valid``.  ``lo`` given: ``(hi, lo)`` is an
    order pair (int32 words of ``split_u64_i32``), whose lexicographic
    extremum — the reference's hi pass then lo pass among the ties — is
    one 64-bit extremum of the joined word.  Else ``hi`` is one float32 or
    int32 column, reduced as ``jax.ops.segment_min/max`` (NaN propagates
    as the canonical NaN, -0.0 below +0.0).  Returns int32 [2, cap] (hi,
    lo) or [1, cap] words; an empty group holds the identity."""
    kind = ORD_PAIR if lo is not None else (ORD_F32 if hi.dtype == F32 else ORD_I32)
    mask = _x32_row_mask(gid.shape[0], tail, pred, pvalid, gid.device)
    if valid is not None:
        mask = torch.logical_and(mask, valid)
    key = _ord_keys(kind, hi, lo, is_min)[mask]
    out = torch.full((capacity,), _ord_ident(kind, is_min), dtype=I64, device=gid.device)
    out = out.scatter_reduce(0, gid.to(I64)[mask], key, "amin" if is_min else "amax")
    return _ord_decode(kind, out, is_min)


def ord_extremum_cuda(gid, tail, pred, pvalid, valid, hi, lo, capacity: int,
                      is_min: bool) -> torch.Tensor:
    """Launch the hand-written exact extremum (ops/cuda/ord_extremum.cu):
    one pass of unsigned 64-bit min/max per group over the operand's order
    keys, split back into state words.  Bit-identical to its twin.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:_ord_segment_extremum``
    and the matmul and scatter routes' ``segment_min``/``segment_max``.
    Inputs are checked (ValueError); a failed build or launch raises."""
    from .cuda.build import load

    device = gid.device
    n = gid.shape[0]
    if device.type != "cuda" or capacity < 1 or n >= 1 << 31:
        raise ValueError("ord_extremum_cuda takes CUDA tensors, capacity >= 1")
    _check_cuda_tensor(gid, "gid", (torch.int32,), n, device)
    for name, m in (("tail", tail), ("pred", pred), ("pvalid", pvalid), ("valid", valid)):
        if m is not None:
            _check_cuda_tensor(m, name, (torch.bool,), n, device)
    if lo is not None:
        kind = ORD_PAIR
        _check_cuda_tensor(hi, "hi", (I32,), n, device)
        _check_cuda_tensor(lo, "lo", (I32,), n, device)
    else:
        _check_cuda_tensor(hi, "values", (F32, I32), n, device)
        kind = ORD_F32 if hi.dtype == F32 else ORD_I32
    out = torch.empty((2 if kind == ORD_PAIR else 1, capacity), dtype=I32, device=device)
    scratch = torch.empty(capacity, dtype=I64, device=device)
    empty = torch.empty(0, dtype=torch.bool, device=device)

    def opt(x):
        return empty if x is None else x

    load().ord_extremum(gid, opt(tail), opt(pred), opt(pvalid), opt(valid),
                        hi.view(I32), empty if lo is None else lo, kind, bool(is_min),
                        scratch, out)
    count_launch("ord_extremum")
    return out


def ord_extremum(gid, tail, pred, pvalid, valid, hi, lo, capacity: int,
                 is_min: bool) -> torch.Tensor:
    """The exact per-group extremum: the CUDA kernel for CUDA tensors, its
    plain twin for tensors on the CPU."""
    if gid.device.type == "cpu":
        return ord_extremum_reference(gid, tail, pred, pvalid, valid, hi, lo,
                                      capacity, is_min)
    return ord_extremum_cuda(gid, tail, pred, pvalid, valid, hi, lo, capacity, is_min)


# ------------------------------------------------------- algorithm choice
# The segment reduction has two device routes: "scatter" (B1, segment_agg
# above) and "sort" (one stable radix sort of the group ids, then one
# segmented scan over every aggregate column, totals merged at each
# segment's last row).  B1 re-scans a batch once per tile of groups, so it
# stops paying at large capacity; the sort route costs the same at any
# capacity.  x32 adds the reference's "matmul" route (kernel D's matmul
# form over every sum and count column, E for extrema, M to merge), the
# accelerator's choice while capacity and rows x capacity stay inside its
# bounds; x32's "scatter" route runs D's scatter form (the backend's block).
# Bounds: the reference's builtin defaults (its routing table names no
# cuda platform), constants until the cuda routing grid exists.
SORT_MIN_CAPACITY = 8192  # capacity above this sorts
SORT_MIN_ELEMS = 1 << 36  # rows x capacity above this sorts
MATMUL_MAX_CAPACITY = 8192  # x32: capacity above this sorts
MATMUL_MAX_ELEMS = 1 << 36  # x32: rows x capacity above this sorts
_AGG_ALGO: dict = {"force": None}


def set_agg_algorithm(algo: Optional[str]) -> None:
    """Force the segment-reduction route (tests) or None = by the bounds."""
    if algo not in (None, "matmul", "scatter", "sort"):
        raise ValueError(f"agg algorithm {algo!r}")
    _AGG_ALGO["force"] = algo


def segment_algo(capacity: int, n_rows: Optional[int], device, mode: str = "x64") -> str:
    """Route of one batch.  x64: "sort" on cuda above the capacity or the
    rows x capacity bound, else "scatter".  x32: "matmul" on cuda inside
    the matmul bounds, else "sort".  The CPU twins always scatter unless a
    route is forced; a forced "matmul" runs scatter in x64, as in the
    reference."""
    force = _AGG_ALGO["force"]
    if force is not None:
        return "scatter" if force == "matmul" and mode != "x32" else force
    if torch.device(device).type != "cuda":
        return "scatter"
    if mode == "x32":
        if capacity > MATMUL_MAX_CAPACITY or (
            n_rows is not None and n_rows * capacity > MATMUL_MAX_ELEMS
        ):
            return "sort"
        return "matmul"
    if capacity > SORT_MIN_CAPACITY:
        return "sort"
    if n_rows is not None and n_rows * capacity > SORT_MIN_ELEMS:
        return "sort"
    return "scatter"


def algo_cache_token() -> tuple:
    """Part of a kernel cache key: the route inputs that are not in the
    kernel's signature."""
    return (_AGG_ALGO["force"], SORT_MIN_CAPACITY, SORT_MIN_ELEMS,
            MATMUL_MAX_CAPACITY, MATMUL_MAX_ELEMS)


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
RADIX_TILE = 6144  # rows per tile of a pass (radix_sort.h: kRadixTile)
# at most this many rows sort in one launch of one CTA (radix_sort.h:
# kRadixSmallMax): on one key, faster than the tiled passes below it,
# level at it (PERF.md §6)
RADIX_SMALL_ROWS = 16384


def radix_argsort_reference(keys: list) -> torch.Tensor:
    """Plain twin of the radix sort: stable sorts from the last key to the
    first, so ties keep row order (``lax.sort(keys + (iota,))``)."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=I64, device=keys[0].device)
    for k in reversed(keys):
        _, idx = torch.sort(k[perm], stable=True)
        perm = perm[idx]
    return perm.to(torch.int32)


def _radix_keys(keys: list) -> tuple:
    """Check the key columns (before any binding is called: an exception
    inside the extension may end the process); returns (n, device)."""
    if not keys or len(keys) > 32:
        raise ValueError(f"radix sort: {len(keys)} key columns")
    device = keys[0].device
    n = keys[0].shape[0] if keys[0].dim() == 1 else -1
    if device.type != "cuda" or not 0 <= n < (1 << 31):
        raise ValueError("radix sort keys must be [n] CUDA tensors, n < 2^31")
    for i, k in enumerate(keys):
        _check_cuda_tensor(k, f"key {i}", (torch.int32, I64), n, device)
    return n, device


def radix_argsort_cuda(keys: list) -> torch.Tensor:
    """Launch the hand-written stable LSD radix argsort (ops/cuda/
    radix_sort.cu) over int32/int64 key columns, most significant first.

    Replaces the multi-key ``lax.sort`` of ``arrow_ballista_tpu/ops/
    window_kernel.py:make_window_kernel`` and the ``gid<<31 | row`` sort of
    ``ops/kernels.py:_sorted_segment_agg``.  Up to ``RADIX_SMALL_ROWS``
    rows one launch of one CTA sorts in shared memory; above, one launch a
    digit over tiles, after one read of the columns (bounds and byte
    histograms) decides on the device whether to pack the columns into one
    key and which passes run (a byte that is the same on every row costs
    an empty launch; the host never waits).  Both give the same
    permutation."""
    from .cuda.build import load

    n, device = _radix_keys(keys)
    small = n <= RADIX_SMALL_ROWS
    ext = load()
    perm = torch.empty(n, dtype=torch.int32, device=device)
    # the one-CTA sort needs no scratch: perm stands in, unread
    scratch = perm if small else _radix_scratch(ext, keys, device)
    ext.radix_sort(list(keys), perm, scratch, small)
    count_launch("radix_sort")
    return perm


def _radix_scratch(ext, keys: list, device) -> torch.Tensor:
    return torch.empty(ext.radix_sort_scratch_bytes(list(keys)), dtype=torch.uint8,
                       device=device)


def radix_sort_pass_count(keys: list) -> int:
    """How many LSD passes the multi-CTA radix sort runs on ``keys``: its
    device plan's count (the scratch's first int32), read back (for
    reports and tests; not a sort launch)."""
    from .cuda.build import load

    _, device = _radix_keys(keys)
    ext = load()
    scratch = _radix_scratch(ext, keys, device)
    ext.radix_sort_plan(list(keys), scratch)
    return int(scratch[:4].view(torch.int32)[0].item())


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
# the tile rule (seg_scan.h: kScan*, scan_smem_bytes, scan_plan)
SCAN_THREADS = 256
SCAN_MAX_ROWS = 8
SCAN_PLAN_SMS = 132
SCAN_SMEM_BUDGET = 65536        # three CTAs an SM, room left for L1
SCAN_SMEM_BUDGET_WIDE = 115712  # two, for R >= 4 over more columns
SCAN_FIXED_BYTES = 5120


@dataclass(frozen=True, eq=False)
class ScanColumn:
    """One column of a segmented scan: its element source and fold.

    x32's sort route reads 32-bit columns: float32 or int32 ``values``
    under an f64/i64 fold widen exactly; under :data:`OP_DF32` a float32
    column is the pair (v, 0) and, with float32 ``values2``, the 2Sum of
    the two halves of an int64 pair; under :data:`OP_UMIN_U64`/
    :data:`OP_UMAX_U64` int32 ``values`` and ``values2`` are an order
    pair's (hi, lo), joined into one unsigned word."""

    src: int
    op: int  # OP_ADD_F64 .. OP_UMAX_U64 (OP_ADD_I64 for counts and iota)
    values: Optional[torch.Tensor] = None  # [n] input row order
    valid: Optional[torch.Tensor] = None   # [n] bool, input row order
    values2: Optional[torch.Tensor] = None  # [n] the pair's second half


_I64_MIN_WORD = -(1 << 63)


def _ident_value(op: int, dtype):
    if op in (OP_MIN_F64, OP_MIN_I64):
        return math.inf if dtype == F64 else torch.iinfo(I64).max
    if op in (OP_MAX_F64, OP_MAX_I64):
        return -math.inf if dtype == F64 else torch.iinfo(I64).min
    if op == OP_UMIN_U64:
        return -1  # all ones: the largest unsigned word
    return 0


def _df32_word(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """An f32 (hi, lo) pair as one int64 word, hi's bits in the low half."""
    return lo.view(I32).to(I64) * (1 << 32) + (hi.view(I32).to(I64) & 0xFFFFFFFF)


def _df32_split(w: torch.Tensor) -> tuple:
    """The (hi, lo) float32 pair of :func:`_df32_word` words."""
    lo = torch.div(w, 1 << 32, rounding_mode="floor")
    hi = w - lo * (1 << 32)
    hi = torch.where(hi >= (1 << 31), hi - (1 << 32), hi)
    return hi.to(I32).view(F32), lo.to(I32).view(F32)


def _ord_word(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """An order pair's ``join_u64`` as int64 bits (its unsigned order is
    the pair's lexicographic order)."""
    return (hi ^ torch.iinfo(I32).min).to(I64) * (1 << 32) + (
        (lo.to(I64) & 0xFFFFFFFF) ^ 0x80000000
    )


def _ord_split(w: torch.Tensor) -> tuple:
    """The int32 (hi, lo) of :func:`_ord_word` words."""
    top = torch.div(w, 1 << 32, rounding_mode="floor")
    lo = w - top * (1 << 32) - (1 << 31)
    return top.to(I32) ^ torch.iinfo(I32).min, lo.to(I32)


def _elements(col: ScanColumn, n: int, perm, aux, device) -> torch.Tensor:
    """The column's elements in sorted order, typed (f64 or i64; the x32
    folds' as int64 words)."""
    if col.src == SS_IOTA:
        return torch.arange(n, dtype=I64, device=device)
    if col.src == SS_AUX:
        return aux.to(I64)

    def gathered(x):
        return x if perm is None else x[perm.long()]

    ok = None if col.valid is None else gathered(col.valid)
    if col.src == SS_COUNT:
        return torch.ones(n, dtype=I64, device=device) if ok is None else ok.to(I64)
    if col.op == OP_DF32:
        h = gathered(col.values)
        if col.values2 is None:
            w = _df32_word(h, torch.zeros_like(h))
        else:
            w = _df32_word(*_two_sum(h, gathered(col.values2)))
    elif col.op in (OP_UMIN_U64, OP_UMAX_U64):
        w = _ord_word(gathered(col.values), gathered(col.values2))
    else:
        dtype = F64 if _OP_ROLE[col.op][1] is False else I64
        w = gathered(col.values).to(dtype)
        if ok is None:
            return w
        return torch.where(ok, w, torch.full_like(w, _ident_value(col.op, dtype)))
    if ok is None:
        return w
    return torch.where(ok, w, torch.full_like(w, _ident_value(col.op, I64)))


def _fold(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == OP_DF32:  # _scan_segments' df32 combine
        ah, al = _df32_split(a)
        bh, bl = _df32_split(b)
        s, e = _two_sum(ah, bh)
        return _df32_word(*_two_sum(s, al + bl + e))
    if op in (OP_UMIN_U64, OP_UMAX_U64):
        a_le_b = (a ^ _I64_MIN_WORD) <= (b ^ _I64_MIN_WORD)
        return torch.where(a_le_b == (op == OP_UMIN_U64), a, b)
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
        x32_op = c.op in (OP_DF32, OP_UMIN_U64, OP_UMAX_U64)
        if (c.op not in _OP_ROLE and not x32_op) or c.op == OP_COUNT:
            raise ValueError(f"scan column {i}: op {c.op}")
        if c.src == SS_AUX:
            _check_cuda_tensor(aux, "aux", (torch.uint8, torch.bool), n, device)
        if c.src == SS_VALUES:
            if x32_op:
                dtypes = (F32,) if c.op == OP_DF32 else (I32,)
            else:
                want = I64 if _OP_ROLE[c.op][1] else F64
                dtypes = (F64, I64, F32, I32) if want == F64 else (I64, I32)
            _check_cuda_tensor(c.values, f"column {i} values", dtypes, n, device)
            if c.values2 is not None or c.op in (OP_UMIN_U64, OP_UMAX_U64):
                if not x32_op:
                    raise ValueError(f"scan column {i}: a pair under op {c.op}")
                _check_cuda_tensor(c.values2, f"column {i} values2", dtypes, n, device)
        if c.valid is not None:
            _check_cuda_tensor(c.valid, f"column {i} validity", (torch.bool,), n, device)


# how seg_scan.cu reads a SS_VALUES column (seg_scan.h: ScanWidth)
SW_WORD, SW_F32, SW_I32, SW_F32_PAIR, SW_ORD_PAIR = 0, 1, 2, 3, 4


def _scan_width(c: ScanColumn) -> int:
    if c.values is None:
        return SW_WORD
    if c.values2 is not None:
        return SW_F32_PAIR if c.values.dtype == F32 else SW_ORD_PAIR
    return {F32: SW_F32, I32: SW_I32}.get(c.values.dtype, SW_WORD)


def scan_smem_bytes(rows: int, n_cols: int) -> int:
    """seg_scan.h:scan_smem_bytes: a CTA's shared bytes at ``rows`` a
    thread over ``n_cols`` columns (each column's 8-byte words padded one
    in 16, perm, the keys with a neighbour each side, the start flags)."""
    t = SCAN_THREADS * rows
    return (SCAN_FIXED_BYTES + n_cols * 8 * (t + t // 16) + 4 * t + 4 * (t + 2)
            + ((t + 15) & ~15))


def scan_launch_plan(n: int, n_cols: int) -> tuple:
    """seg_scan.h:scan_plan, the tile rule: ``(threads, rows, tile, shared
    bytes)`` of a scan of ``n`` rows over ``n_cols`` columns.  R, the rows
    a thread, is the largest of 8, 4, 2, 1 whose tile leaves room for three
    CTAs an SM, or, where that is below 4, for two; a call of fewer tiles
    than two an SM halves R."""
    def widest(budget: int) -> int:
        rows = SCAN_MAX_ROWS
        while rows > 1 and scan_smem_bytes(rows, n_cols) > budget:
            rows //= 2
        return rows

    rows = widest(SCAN_SMEM_BUDGET)
    if rows < 4:
        rows = widest(SCAN_SMEM_BUDGET_WIDE)
    while rows > 1 and -(-n // (SCAN_THREADS * rows)) < 2 * SCAN_PLAN_SMS:
        rows //= 2
    return SCAN_THREADS, rows, SCAN_THREADS * rows, scan_smem_bytes(rows, n_cols)


def scan_launch_describe(n: int, n_cols: int) -> dict:
    """What a scan launch over ``n`` rows of ``n_cols`` columns runs with,
    from the C side (seg_scan.h:scan_plan and the CUDA runtime, on the
    current device): ``threads``, ``rows`` a thread, ``tile``, ``smem``
    (shared bytes), the kernel's ``registers`` and ``local_bytes`` a
    thread, ``ctas_per_sm`` and the ``grid``.  Card only."""
    from .cuda.build import load

    keys = ("threads", "rows", "tile", "smem", "registers", "local_bytes", "ctas_per_sm",
            "grid")
    return dict(zip(keys, load().seg_scan_describe(n, n_cols)))


def _scan_code(c: ScanColumn) -> int:
    """A column's src | op << 8 | in_i64 << 16 | width << 24 (the
    binding's ``codes``)."""
    in_i64 = int(c.values is not None and c.values.dtype == I64)
    return c.src | c.op << 8 | in_i64 << 16 | _scan_width(c) << 24


def _launch_scan(cols, n, perm, flag, key, aux, reverse, outs, state, field_col,
                 field_op):
    """One seg_scan launch.  An int64 ``state`` takes the x64 epilogue
    (``field_op`` the OP_* merges), an int32 one the x32 epilogue
    (``field_op`` the XM_* merges of :func:`x32_merge`).  The look-back's
    words persist in the binding; nothing is allocated here."""
    from .cuda.build import load

    device = (perm if perm is not None else flag if flag is not None else key).device
    empty = _expr_empty(device)
    x32_state = state is not None and state.dtype == I32
    load().seg_scan(
        n,
        empty if perm is None else perm,
        empty if flag is None else flag,
        empty if key is None else key,
        empty if aux is None else aux,
        reverse,
        [empty if c.values is None else c.values for c in cols],
        [empty if c.valid is None else c.valid for c in cols],
        [empty if c.values2 is None else c.values2 for c in cols],
        [_scan_code(c) for c in cols],
        [empty if o is None else o for o in outs],
        empty if state is None or x32_state else state,
        state if x32_state else empty,
        list(field_col), list(field_op),
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
    "store_value", "store_valid", "sqpair_lo",
)
_EXPR_OP = {name: i for i, name in enumerate(EXPR_OPS)}
DT_BOOL, DT_I64, DT_F64, DT_I32, DT_F32 = 0, 1, 2, 3, 4  # expr_eval.h: ExprDtype
_DT_CODE = {torch.bool: DT_BOOL, I64: DT_I64, F64: DT_F64, I32: DT_I32, F32: DT_F32}
_DT_TORCH = (torch.bool, I64, F64, I32, F32)
# the register dtypes of each mode's programs (x64: bool < int64 < float64,
# x32: bool < int32 < float32, each ordered as torch promotes)
_MODE_DTS = {"x64": (DT_BOOL, DT_I64, DT_F64), "x32": (DT_BOOL, DT_I32, DT_F32)}
EXPR_MAX_INPUTS = 96  # expr_eval.h: kExprMaxInputs
EXPR_MAX_OUTPUTS = 72  # kExprMaxOutputs
EXPR_MAX_INSTR = 1024  # kExprMaxInstr
EXPR_SMEM_LIMIT = 232448  # shared memory one CTA can use on sm_90
# where a register lives (expr_eval.h: ExprRegKind, kRegInvariant, kRegWide)
EXPR_REG_TILE, EXPR_REG_UNIFORM, EXPR_REG_LEAF, EXPR_REG_MASK = 0, 1, 2, 3
EXPR_REG_INVARIANT, EXPR_REG_WIDE = 4, 8
EXPR_MAX_ROWS = 8  # kExprMaxRows
EXPR_PLAN_SMS = 132  # kExprPlanSms
EXPR_SMEM_PER_SM, EXPR_SMEM_PER_CTA = 233472, 1024  # kExprSmemPerSm, kExprSmemPerCta
EXPR_REGS_PER_SM, EXPR_MAX_REGS = 65536, 128  # kExprRegsPerSm, kExprMaxRegs
_EXPR_THREADS = (128, 64, 256, 32)  # expr_plan's kThreads
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
                             "mod_int", "mod_f", "power", "sqpair_lo", *_CMP), 2))
_ARITY["select"] = 3
# operand and result dtypes fixed by the op (-1: read from the row), as x64
# codes; an x32 program reads DT_I64/DT_F64 here as DT_I32/DT_F32
_FIXED_IN = {"div_int": DT_I64, "mod_int": DT_I64, "div_f": DT_F64, "mod_f": DT_F64,
             "cast_i64": DT_F64, "power": DT_F64, "square": DT_F64, "sqpair_lo": DT_F64,
             **dict.fromkeys(_UNARY_F64, DT_F64)}
_FIXED_OUT = {"div_int": DT_I64, "mod_int": DT_I64, "cast_i64": DT_I64,
              "store_valid": DT_BOOL, "in": DT_BOOL, "not_in": DT_BOOL,
              **dict.fromkeys(_BOOL_OPS, DT_BOOL),
              **dict.fromkeys(("div_f", "mod_f", "power", "square", "sqpair_lo", *_UNARY_F64),
                              DT_F64)}
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


def _fixed_dt(table: dict, name: str, mode: str):
    dt = table.get(name)
    if dt is None or mode != "x32":
        return dt
    return {DT_I64: DT_I32, DT_F64: DT_F32}.get(dt, dt)


def _expr_operand_targets(name: str, dt: int, in_dt: int) -> tuple:
    """The dtypes the kernel reads operands (a, b) of a register row as,
    through a converted copy when the operand's dtype differs (None: not
    read so); ``select``'s first is its THEN operand (b)."""
    if name in (*_CMP, "add", "sub", "mul"):
        return (None, None) if in_dt == DT_BOOL else (in_dt, in_dt)
    if name in ("div_int", "mod_int", "div_f", "mod_f", "power", "sqpair_lo"):
        return (in_dt, in_dt)
    if name in ("neg", "in", "not_in", *_UNARY_F64, "square"):
        return (in_dt, None)
    if name == "cast_i64":
        return (DT_F32 if dt == DT_I32 else DT_F64, None)
    if name == "select" and dt != DT_BOOL:
        return (dt, None)
    return (None, None)


def _expr_layout(rows, stores=()) -> tuple:
    """Where each register of ``rows`` (a program's register rows) lives
    in the kernel, as expr_eval.h's ``ExprRegKind`` words (int32: kind in
    bits 0-1, ``EXPR_REG_INVARIANT``, ``EXPR_REG_WIDE``, the index from
    bit 4), and ``(uniform slots, mask slots, 8-byte tiles, 4-byte tiles,
    scratch blocks)``.  A bool is a mask; a numeric leaf its staged column
    (a leaf with no value column a uniform 0); a register whose operands
    are all invariant (literals, NULL and what only they feed) is
    invariant, and numeric it is one uniform value; any other numeric
    register takes a tile of its width, one whose last reader (a row, or
    one of the ``stores`` rows' registers, read at the end) has run:
    every row reads its operands whole before it writes its result.  A
    scratch block holds an operand that is not invariant, converted to the
    dtype its op reads."""
    last = list(range(len(rows)))
    for i, (op, _, _, a, b, c, _) in enumerate(rows):
        for r in (a, b, c)[:_ARITY[EXPR_OPS[op]]]:
            last[r] = i
    for r in stores:
        last[r] = len(rows)
    words, invariant = [], []
    n_uni = n_mask = n_scratch = 0
    tiles: dict = {True: [], False: []}  # wide -> each tile's register
    for i, (op, dt, in_dt, a, b, c, _) in enumerate(rows):
        name = EXPR_OPS[op]
        inv = name != "leaf" and all(invariant[r] for r in (a, b, c)[:_ARITY[name]])
        invariant.append(inv)
        flags = EXPR_REG_INVARIANT if inv else 0
        if dt == DT_BOOL:
            kind, idx = EXPR_REG_MASK, n_mask
            n_mask += 1
        elif name == "leaf" and a >= 0:
            kind, idx = EXPR_REG_LEAF, a
        elif inv or name == "leaf":
            kind, idx = EXPR_REG_UNIFORM, n_uni
            n_uni += 1
        else:
            wide = dt in (DT_I64, DT_F64)
            pool = tiles[wide]
            idx = next((j for j, r in enumerate(pool) if last[r] <= i), len(pool))
            pool[idx:idx + 1] = [i]
            kind, flags = EXPR_REG_TILE, flags | (EXPR_REG_WIDE if wide else 0)
        words.append(kind | flags | idx << 4)
        targets = _expr_operand_targets(name, dt, in_dt)
        operands = (b, c) if name == "select" else (a, b)
        for slot, (want, reg) in enumerate(zip(targets, operands)):
            if want is not None and rows[reg][1] != want and not invariant[reg]:
                n_scratch = max(n_scratch, slot + 1)
    counts = (n_uni, n_mask, len(tiles[True]), len(tiles[False]), n_scratch)
    return np.asarray(words, np.int32), counts


def _align16(x: int) -> int:
    return (x + 15) & ~15


def _align128(x: int) -> int:
    return (x + 127) & ~127


def expr_block_bytes(rows: int, width: int) -> int:
    """expr_eval.h:expr_block_bytes: a thread's block of ``rows`` values."""
    return rows * width


def expr_smem_bytes(n_regs: int, counts: tuple, staged_w: tuple, threads: int, rows: int,
                    stages: int) -> int:
    """expr_eval.h:expr_smem_bytes: one CTA's shared memory (``staged_w``:
    the staged slots of 1, 4 and 8 bytes)."""
    n_uni, n_mask, n_wide, n_narrow, n_scratch = counts
    b4, b8 = expr_block_bytes(rows, 4), expr_block_bytes(rows, 8)
    stage = threads * sum(k * expr_block_bytes(rows, w) for k, w in zip(staged_w, (1, 4, 8)))
    return (_align128(_align16(4 * n_regs) + _align16(8 * n_uni) + 16 * threads
                      + _align16(threads * n_regs) + _align16(threads * n_mask))
            + threads * ((n_scratch + n_wide) * b8 + n_narrow * b4) + stages * _align128(stage))


def expr_resident_warps(threads: int, smem: int) -> int:
    """expr_eval.h:expr_resident_warps: warps an SM holds of such CTAs."""
    ctas = min(EXPR_SMEM_PER_SM // (smem + EXPR_SMEM_PER_CTA),
               EXPR_REGS_PER_SM // (EXPR_MAX_REGS * threads))
    return ctas * threads // 32


def expr_launch_plan(n: int, n_regs: int, counts: tuple, staged_w: tuple) -> tuple:
    """expr_eval.h:expr_plan, the tile rule: ``(threads, rows, stages,
    shared bytes)`` for ``n`` rows of a program of ``n_regs`` registers
    laid out as ``counts`` (:func:`_expr_layout`) with ``staged_w`` staged
    slots of 1, 4 and 8 bytes.  Shared bytes past ``EXPR_SMEM_LIMIT``: the
    program does not fit."""
    def size(threads, rows, stages) -> int:
        return expr_smem_bytes(n_regs, counts, staged_w, threads, rows, stages)

    plan, warps, rows = (_EXPR_THREADS[3], 1, 1), -1, EXPR_MAX_ROWS
    while rows >= 1 and warps < 8:
        warps = -1
        for stages in (2, 1):
            for threads in _EXPR_THREADS:
                smem = size(threads, rows, stages)
                if smem > EXPR_SMEM_LIMIT:
                    continue
                w = expr_resident_warps(threads, smem)
                if w > warps:
                    plan, warps = (threads, rows, stages), w
        rows //= 2
    threads, rows, stages = plan

    def tiles() -> int:
        return -(-n // (threads * rows))

    while rows > 1 and tiles() < 2 * EXPR_PLAN_SMS:
        rows //= 2
    while threads > 64 and tiles() < EXPR_PLAN_SMS:
        threads //= 2
    return threads, rows, stages, size(threads, rows, stages)


def _staged_widths(program: "ExprProgram", widths: dict) -> tuple:
    """The staged slots of 1, 4 and 8 bytes, each slot a leaf reads with
    the element size ``widths[slot]`` (0 or absent: not staged, an absent
    validity)."""
    sizes = [widths.get(s, 0) for s in program._staged]
    return tuple(sizes.count(w) for w in (1, 4, 8))


def expr_program_plan(program: "ExprProgram", n: int, widths: dict) -> tuple:
    """:func:`expr_launch_plan` for ``program`` when each staged input
    slot has the element size ``widths[slot]``."""
    return expr_launch_plan(n, program.n_regs, program.reg_counts,
                            _staged_widths(program, widths))


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
    the ``(filter closure, closures, columns)`` it was compiled from.
    ``mode`` "x32" programs compute in bool, int32 and float32 registers
    (the x32 closures' dtypes), x64 ones in bool, int64 and float64."""

    def __init__(self, filter_closure, closures: list, columns: list, mode: str = "x64"):
        self.mode = mode
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
    def from_parts(cls, code, consts, inputs, n_regs, stores, outputs,
                   mode: str = "x64") -> "ExprProgram":
        """A program from its tables, validated (ValueError when malformed)."""
        self = cls.__new__(cls)
        self.mode = mode
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
        self._launch: dict = {}  # which inputs are None -> expr_eval_cuda's per-batch words
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
                in_dt = _fixed_dt(_FIXED_IN, op, self.mode)
                in_dt = -1 if in_dt is None else in_dt
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
               id(self.outputs), self.n_regs, self.mode)
        if getattr(self, "_valid_key", None) == key:
            return
        code = self.code
        if code.dtype != np.int64 or code.ndim != 2 or code.shape[1] != 7:
            raise ValueError("expr program: code must be int64 [n_instr, 7]")
        if self.consts.dtype != np.int64 or self.consts.ndim != 1:
            raise ValueError("expr program: consts must be int64 [n]")
        n_regs, n_in = self.n_regs, len(self.inputs)
        if self.mode not in _MODE_DTS:
            raise ValueError(f"expr program: mode {self.mode!r}")
        dts = _MODE_DTS[self.mode]
        d_int, d_float = dts[1], dts[2]
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
            fixed_out = _fixed_dt(_FIXED_OUT, name, self.mode)
            if dt not in dts or dt != (dt if fixed_out is None else fixed_out):
                raise ValueError(f"{where}: result dtype {dt}")
            for r in (a, b, c)[:_ARITY[name]]:
                if not 0 <= r < min(i, n_regs):
                    raise ValueError(f"{where}: register {r}")
            fixed = _fixed_dt(_FIXED_IN, name, self.mode)
            if fixed is not None and in_dt != fixed:
                raise ValueError(f"{where}: operand dtype {in_dt}")
            if name == "leaf" and not (-1 <= a < n_in and 0 <= b < n_in):
                raise ValueError(f"{where}: input slots {a}, {b}")
            if name in ("in", "not_in") and (
                in_dt not in (d_int, d_float) or b < 0 or c < 0
                or b + c > len(self.consts)
            ):
                raise ValueError(f"{where}: table {b}+{c} of {len(self.consts)}")
            if name in (*_CMP, "convert") and in_dt not in dts:
                raise ValueError(f"{where}: operand dtype {in_dt}")
            if name in ("add", "sub", "mul", "neg") and (
                in_dt != dt or (dt == DT_BOOL and name in ("sub", "neg"))
            ):
                raise ValueError(f"{where}: dtype {dt}")
            if name == "sqpair_lo" and self.mode != "x32":
                raise ValueError(f"{where}: an x32 opcode")
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
                if not (0 <= out[1] < n_in and out[2] in dts):
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
        # the input slots a leaf reads: the kernel stages these
        self._staged = sorted({s for r in leaves for s in (r[3], r[4]) if s >= 0})
        self.reg_layout, self.reg_counts = _expr_layout(
            self._regs_rows, [r[3] for r in rows[n_regs:]])
        # the rows a tile skips whatever the batch (the invariant ones), and
        # the numeric leaves, skipped too when their validity is absent
        self._invariant_rows = [i for i, w in enumerate(self.reg_layout.tolist())
                                if w & EXPR_REG_INVARIANT]
        self._value_leaves = [i for i, r in enumerate(self._regs_rows)
                              if EXPR_OPS[r[0]] == "leaf" and r[1] != DT_BOOL and r[3] >= 0]
        self._store_slots = [r[4] for r in rows[n_regs:]]
        # the tile rule's shared memory with every staged slot at its widest
        widest = {s: _DT_BYTES[dt] for s, dt, _ in self._reads}
        self._widest_smem = expr_program_plan(self, 1 << 40, widest)[3]
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

    def device_tables(self, device) -> tuple:
        """:meth:`device_words` and :attr:`reg_layout` (one ``ExprRegKind``
        word a register, int32) on ``device``, looked up by ``device`` as
        given."""
        t = self._device.get(("tables", device))
        if t is None:
            layout = self._device.get(("layout", torch.device(device)))
            if layout is None:
                with self._lock:
                    layout = self._device.setdefault(
                        ("layout", torch.device(device)),
                        torch.from_numpy(self.reg_layout.copy()).to(device))
            t = self._device[("tables", device)] = (self.device_words(device), layout)
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
            if dt == DT_F64:
                value = np.int64(imm).view(np.float64).item()
            elif dt == DT_F32:
                value = np.int32(imm).view(np.float32).item()
            else:
                value = imm
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
            tdt = I32 if in_dt in (DT_I32, DT_F32) else I64
            table = program.constant(("table", i), program.consts[b:b + c].tolist(), tdt, device)
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
                fdt = _DT_TORCH[in_dt]
                v = x.to(fdt) / y.to(fdt)
            elif name in ("mod_int", "mod_f"):
                v = _floor_mod(x, y)
            elif name == "power":
                fdt = _DT_TORCH[in_dt]
                v = torch.pow(x.to(fdt), y.to(fdt))
            elif name == "neg":
                v = -x
            elif name == "convert":
                v = x.to(dtype)
            elif name == "cast_i64":
                v = _cast(x, dtype)
            elif name == "square":
                x = x.to(_DT_TORCH[in_dt])
                v = x * x
            elif name == "sqpair_lo":
                v = square_pair_twin(x, y)[1]
            else:
                v = _UNARY_F64[name](x.to(_DT_TORCH[in_dt]))
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


_DT_BYTES = {DT_BOOL: 1, DT_I64: 8, DT_F64: 8, DT_I32: 4, DT_F32: 4}


def _bit_words(indices, n: int) -> list:
    """Bit i of word i // 32 set for each index, a word for every 32 of
    ``n`` rows (expr_eval.h's ``valid_bits`` and ``skip_bits``)."""
    words = [0] * ((n + 31) // 32)
    for i in indices:
        words[i >> 5] |= 1 << (i & 31)
    return words


def expr_fits(program: ExprProgram, n_inputs: int) -> bool:
    """Whether the kernel takes ``program`` with ``n_inputs`` input slots:
    instructions, input and output slots within expr_eval.h's limits, the
    admission rule (the code and 9 bytes a register for 32 threads within
    a CTA's shared memory), and the tile rule's shared memory with every
    staged slot at its widest (which every program the admission rule
    takes fits)."""
    n_instr = len(program.code)
    if (n_instr > EXPR_MAX_INSTR or n_instr * 32 + program.n_regs * 32 * 9 > EXPR_SMEM_LIMIT
            or n_inputs > EXPR_MAX_INPUTS or len(program.stores) > EXPR_MAX_OUTPUTS):
        return False
    return program._widest_smem <= EXPR_SMEM_LIMIT


def _check_expr_args(program: ExprProgram, inputs: list, n: int, device) -> None:
    """Raise ValueError unless the program fits the kernel
    (:func:`expr_fits`) and every input slot holds what its leaf reads: a
    contiguous [n] tensor on ``device`` of the leaf's dtype, a validity
    bool or None.  Checked here, before the binding, like every kernel's
    inputs."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"expr_eval: device {dev} is not CUDA")
    if not expr_fits(program, len(inputs)):
        raise ValueError(
            f"expr_eval: {len(program.code)} instructions, {program.n_regs} registers, "
            f"{len(inputs)} inputs, {len(program.stores)} outputs exceed the kernel"
        )

    def bad(x, dtype) -> bool:
        if (not isinstance(x, torch.Tensor) or x.dtype != dtype or x.dim() != 1
                or x.shape[0] != n or not x.is_contiguous()):
            return True
        at = x.device
        return at.type != dev.type or (dev.index is not None and at.index != dev.index)

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
    computes nothing (every output an env tensor) launches nothing.  The
    kernel copies the columns a leaf reads in 16-byte chunks, so such a
    column that starts off a 16-byte boundary (a view at an offset) is
    copied to a fresh tensor first."""
    from .cuda.build import load

    program.validate()
    inputs = [env[name] for name in program.inputs]
    _check_expr_args(program, inputs, n, device)
    written, valid_words, skip_words = _expr_batch_words(program, inputs)
    outs = _expr_outputs(program, written, n, device)
    if n and any(written):
        empty = _expr_empty(device)
        staged = _expr_staged(program, inputs, empty)
        words, layout = program.device_tables(device)
        load().expr_eval(
            words, layout, len(program.code), program.n_regs, program.reg_counts,
            valid_words, skip_words, staged, [empty if t is None else t for t in outs], n,
        )
        count_launch("expr_eval")
    return program.layout(lambda out: inputs[out[1]] if out[0] == "input" else outs[out[-1]])


def _expr_batch_words(program: ExprProgram, inputs: list) -> tuple:
    """``(written, valid_words, skip_words)`` for a batch whose absent
    inputs are those of ``inputs``: which outputs the launch writes, the
    registers whose validity the batch may carry and the rows a tile
    skips (expr_eval.h's ``valid_bits`` and ``skip_bits``); worked out
    once for each pattern of absent inputs."""
    absent = tuple(x is None for x in inputs)
    launch = program._launch.get(absent)
    if launch is None:
        present = program.presence(inputs)
        written = [kind == "value" or present[reg] for kind, reg, _ in program.stores]
        skip = program._invariant_rows + [i for i in program._value_leaves if not present[i]]
        skip += [program.n_regs + j for j, slot in enumerate(program._store_slots)
                 if not written[slot]]
        n_rows = len(program.code)
        launch = program._launch[absent] = (
            written, _bit_words((i for i, v in enumerate(present) if v), n_rows),
            _bit_words(skip, n_rows))
    return launch


def _expr_outputs(program: ExprProgram, written: list, n: int, device) -> list:
    """A fresh [n] tensor for each output the launch writes, else None."""
    return [torch.empty(n, dtype=_DT_TORCH[dt], device=device) if w else None
            for w, (_, _, dt) in zip(written, program.stores)]


_EXPR_EMPTY: dict = {}


def _expr_empty(device) -> torch.Tensor:
    """The empty tensor that stands for an absent slot, one a device."""
    t = _EXPR_EMPTY.get(device)
    if t is None:
        t = _EXPR_EMPTY.setdefault(device, torch.empty(0, dtype=torch.bool, device=device))
    return t


def _expr_staged(program: ExprProgram, inputs: list, empty: torch.Tensor) -> list:
    """The binding's input slots: each input a leaf reads (the kernel
    copies it in 16-byte chunks, so one that starts off a 16-byte boundary
    is copied to a fresh tensor first), ``empty`` for every other slot."""
    staged = [empty] * len(inputs)
    for s in program._staged:
        x = inputs[s]
        if x is not None:
            staged[s] = x if x.data_ptr() % 16 == 0 else x.clone()
    return staged


def expr_launch_describe(program: ExprProgram, n: int, widths: dict) -> dict:
    """What a launch of ``program`` over ``n`` rows runs with when each
    staged input slot has the element size ``widths[slot]`` (as
    :func:`expr_program_plan` takes it), from the C side
    (expr_eval.h:expr_plan and the CUDA runtime, on the current device):
    ``threads``, ``rows`` a thread, ``stages``, ``smem`` (shared bytes),
    and the kernel's ``registers`` and ``local_bytes`` a thread and
    ``ctas_per_sm`` at that shape.  Card only."""
    from .cuda.build import load

    widths = list(_staged_widths(program, widths))
    keys = ("threads", "rows", "stages", "smem", "registers", "local_bytes", "ctas_per_sm")
    return dict(zip(keys, load().expr_eval_describe(n, program.n_regs, list(program.reg_counts),
                                                    widths)))


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
    mode: str = "x64",
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

    ``mode`` "x32" builds the reference's x32 function instead: the
    program computes float32/int32 columns, the state is int32 words in
    :func:`state_fields`' x32 layout, and ``algo`` is "matmul", "scatter"
    or "sort" (:func:`x32_reduce`).
    """
    if mode == "x32":
        if algo not in ("matmul", "scatter", "sort"):
            raise ValueError(f"agg algorithm {algo!r}")
        run = _make_x32_kernels(filter_closure, arg_closures, specs, flat_names)

        def fn32(seg_ids, valid, *arrays, state=None):
            return run(algo, seg_ids, valid, arrays, capacity, state)

        return fn32
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
    mode: str = "x64",
    force_sort: bool = False,
):
    """The multi-entry counterpart of :func:`make_partial_agg_kernel` (its
    scatter route): ``fn(entries) -> state`` over retained ``(gid, tail,
    leaf arrays)`` entries runs the expression program over every entry,
    then ONE :func:`segment_agg_entries` folds all of them into a fresh
    identity state at ``capacity``.  The program's outputs of every entry
    are alive together until that call returns.

    x32 (the reference's x32 ``_fused_for``): each entry runs its own route
    (:func:`segment_algo` for its rows, "sort" under ``force_sort``: the
    x32 variance family) and one merge into the state."""
    if mode == "x32":
        run = _make_x32_kernels(filter_closure, arg_closures, specs, flat_names)

        def fn32(entries: list) -> torch.Tensor:
            device = entries[0][0].device
            state = init_states(specs, capacity, device, "x32")
            for gid, tail, arrays in entries:
                algo = ("sort" if force_sort
                        else segment_algo(capacity, gid.shape[0], device, "x32"))
                state = run(algo, gid, tail, arrays, capacity, state)
            return state

        return fn32
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


# ------------------------------------------------- x32 partial aggregate
@dataclass
class X32Layout:
    """An x32 stage function's reductions, fixed once (:func:`x32_layout`).

    Kernel columns are the expression program's columns, then two per pair
    leaf (hi, lo).  ``sums``: each sum output's columns ``(a, b)`` (b = -1
    but for an int64 pair); ``counts``: each count's validity column (-1:
    the row mask); ``exts``: each extremum's ``(hi column, lo column or
    -1, is_min)``; ``fields``: per state row its source, ``("sum", k,
    0 | 1)`` for hi | lo, ``("cnt", k)`` or ``("ext", k, 0 | 1)``;
    ``ops``: per state row its :func:`x32_merge` code."""

    closures: list
    columns: list
    pairs: list
    sums: list
    counts: list
    exts: list
    fields: list
    ops: list


def x32_layout(specs: list[KernelAggSpec], arg_closures: list) -> X32Layout:
    """The x32 reductions of ``specs`` as the reference's x32 routes lower
    them: a sum or avg sums its argument as float32 (an int64 pair's two
    halves each), a min/max reduces a float32 or int32 operand (an f64
    column's order pair), and every aggregate counts its argument's valid
    rows.  Equal arguments share one column, equal validities one count."""
    closures: list = []
    columns: list = []  # (closure index, dtype) of the expression program
    pairs: list = []    # pair-leaf closures, two kernel columns each
    sums: list = []
    counts: list = []
    exts: list = []
    fields: list = []

    def index(items: list, item) -> int:
        if item not in items:
            items.append(item)
        return items.index(item)

    def column(closure, dtype) -> int:
        k = next((i for i, c in enumerate(closures) if c is closure), None)
        if k is None:
            k = len(closures)
            closures.append(closure)
        return index(columns, (k, dtype))

    arg_cols: list = []  # per spec: its value columns (for the count)
    for spec, closure in zip(specs, arg_closures):
        if spec.func == "count_star":
            arg_cols.append(None)
        elif spec.pair and getattr(closure, "in_program", False):
            # a pair the expression program computes (the square pair)
            arg_cols.append(("cols",) + tuple(column(h, F32) for h in closure.halves))
        elif spec.pair or spec.ord_pair:
            p = next((i for i, c in enumerate(pairs) if c is closure), None)
            if p is None:
                p = len(pairs)
                pairs.append(closure)
            arg_cols.append(("pair", p))
        elif spec.func == "count":
            arg_cols.append(column(closure, None))
        elif spec.func in ("sum", "avg") or not spec.int_minmax:
            arg_cols.append(column(closure, F32))
        else:
            arg_cols.append(column(closure, I32))
    base = len(columns)

    def cols_of(a):
        if isinstance(a, tuple):
            if a[0] == "cols":
                return a[1], a[2]
            return base + 2 * a[1], base + 2 * a[1] + 1
        return a, -1

    for spec, a in zip(specs, arg_cols):
        if spec.func == "count_star":
            fields.append(("cnt", index(counts, -1)))
            continue
        hi, lo = cols_of(a)
        cnt = ("cnt", index(counts, hi))
        if spec.func == "count":
            fields.append(cnt)
        elif spec.func in ("sum", "avg"):
            k = index(sums, (hi, lo))
            fields.extend([("sum", k, 0), ("sum", k, 1), cnt])
        elif spec.func in ("min", "max"):
            k = index(exts, (hi, lo, spec.func == "min"))
            fields.extend([("ext", k, 0)] + ([("ext", k, 1)] if spec.ord_pair else []) + [cnt])
        else:  # the stage rejects every other aggregate at plan time
            raise ValueError(f"kernel agg {spec.func}")
    fields.append(("cnt", index(counts, -1)))  # presence
    return X32Layout(closures, columns, pairs, sums, counts, exts, fields,
                     x32_merge_ops(specs))


def _batch_counts(counts: list, valids: list) -> tuple:
    """The batch's distinct counts: counts over one validity tensor are
    one, and a count over a column with no null (validity None) is the row
    mask's, as the reference dedupes its count columns by validity.
    Returns ``(count columns, the distinct count of each layout count)``."""
    keys: dict = {}
    distinct: list = []
    index: list = []
    for c in counts:
        k = None if c < 0 or valids[c] is None else id(valids[c])
        if k not in keys:
            keys[k] = len(distinct)
            distinct.append(-1 if k is None else c)
        index.append(keys[k])
    return distinct, index


def _x32_rows(layout: X32Layout, hi, lo, cnt: list, ext_out: list) -> list:
    """Each state row's new words (int32 [capacity] views) from D's and
    E's outputs (``cnt``: one row per layout count)."""
    rows = []
    for src in layout.fields:
        if src[0] == "sum":
            rows.append((hi if src[2] == 0 else lo)[src[1]].view(I32))
        elif src[0] == "cnt":
            rows.append(cnt[src[1]])
        else:
            rows.append(ext_out[src[1]][src[2]])
    return rows


def _x32_scan_plan(layout: X32Layout, values: list, valids: list) -> tuple:
    """The sort route's scan columns and the column each state row reads:
    a sum output is one df32 column (an int64 pair's halves 2Summed first),
    a distinct count counts its validity, an extremum folds its f32 / i32
    operand widened exactly or its order pair as one unsigned word."""
    columns: list[ScanColumn] = []
    for a, b in layout.sums:
        columns.append(ScanColumn(SS_VALUES, OP_DF32, values=values[a], valid=valids[a],
                                  values2=values[b] if b >= 0 else None))
    n_sums = len(columns)
    distinct, count_of = _batch_counts(layout.counts, valids)
    for c in distinct:
        columns.append(ScanColumn(SS_COUNT, OP_ADD_I64,
                                  valid=valids[c] if c >= 0 else None))
    n_cnt = len(columns)
    for a, b, is_min in layout.exts:
        if b >= 0:
            op = OP_UMIN_U64 if is_min else OP_UMAX_U64
            columns.append(ScanColumn(SS_VALUES, op, values=values[a], valid=valids[a],
                                      values2=values[b]))
        elif values[a].dtype == F32:
            columns.append(ScanColumn(SS_VALUES, OP_MIN_F64 if is_min else OP_MAX_F64,
                                      values=values[a], valid=valids[a]))
        else:
            columns.append(ScanColumn(SS_VALUES, OP_MIN_I64 if is_min else OP_MAX_I64,
                                      values=values[a], valid=valids[a]))
    field_col = [
        src[1] if src[0] == "sum"
        else n_sums + count_of[src[1]] if src[0] == "cnt"
        else n_cnt + src[1]
        for src in layout.fields
    ]
    return columns, field_col


def _x32_scan_rows(ops: list, totals: list, field_col: list) -> list:
    """Each state row's new int32 words from the scan totals, by its merge
    code (the twin of the x32 scan epilogue's decode): a df32 total's hi
    and lo words, an order pair's, an f64 extremum's f32 bits, else the
    word's low 32 bits."""
    rows = []
    for op, j in zip(ops, field_col):
        w = totals[j]
        if op in (XM_SUM_HI, XM_SUM_LO):
            hi, lo = _df32_split(w)
            rows.append((hi if op == XM_SUM_HI else lo).view(I32))
        elif op in (XM_OMIN_HI, XM_OMAX_HI, XM_PAIR_LO):
            rows.append(_ord_split(w)[0 if op != XM_PAIR_LO else 1])
        elif op in (XM_MIN_F32, XM_MAX_F32):
            rows.append(w.view(F64).to(F32).view(I32))
        else:
            rows.append(w.to(I32))
    return rows


def _scan_into_state_x32_reference(columns, field_col, ops, state, n, perm, key):
    """Twin of K2's x32 epilogue: every segment's totals (a run of equal
    ``key[perm[r]]``, non-decreasing) merged into the int32 ``state`` with
    :func:`x32_merge` where the segment's key is below the capacity."""
    capacity = state.shape[1]
    if n == 0:
        return state
    scanned = seg_scan_reference(columns, n, perm=perm, key=key)
    s2 = key if perm is None else key[perm.long()]
    bounds = torch.searchsorted(s2, torch.arange(capacity + 1, dtype=s2.dtype,
                                                 device=s2.device))
    present = (bounds[1:] - bounds[:-1]) > 0
    last = torch.clamp(bounds[1:] - 1, 0, max(n - 1, 0))
    totals = [sc[last] for sc in scanned]
    merged = x32_merge_reference(state.clone(), ops, _x32_scan_rows(ops, totals, field_col))
    state.copy_(torch.where(present[None, :], merged, state))
    return state


def sorted_segment_agg_x32_reference(gid, tail, pred, pvalid, values, valids,
                                     layout: X32Layout, state) -> torch.Tensor:
    """Plain twin of x32's sort route: the radix sort's and the scan's
    twins over :func:`_x32_scan_plan`'s columns, each segment's total read
    at its last row, merged into the int32 ``state`` (:func:`x32_merge`)
    where the group has rows."""
    n, capacity = gid.shape[0], state.shape[1]
    key = _sort_key(gid, tail, pred, pvalid, capacity)
    perm = radix_argsort_reference([key])
    columns, field_col = _x32_scan_plan(layout, values, valids)
    return _scan_into_state_x32_reference(columns, field_col, layout.ops, state, n,
                                          perm, key)


def sorted_segment_agg_x32_cuda(gid, tail, pred, pvalid, values, valids,
                                layout: X32Layout, state) -> torch.Tensor:
    """x32's sort route on the card: the radix sort of the group ids, then
    one segmented scan whose x32 epilogue merges every segment's totals
    into the int32 ``state`` (ops/cuda/seg_scan.cu's df32 and unsigned
    pair folds).  Replaces ``arrow_ballista_tpu/ops/kernels.py:
    _build_scan_plan``' x32 columns and ``_scan_segments``' df32 / omin /
    omax kinds inside ``_fn_sorted``."""
    n, capacity = gid.shape[0], state.shape[1]
    if n == 0:
        return state
    key = _sort_key(gid, tail, pred, pvalid, capacity).contiguous()
    perm = radix_argsort_cuda([key])
    columns, field_col = _x32_scan_plan(layout, values, valids)
    _check_scan_args(columns, n, perm, None, key, None, state.device)
    if state.dtype != I32 or len(layout.ops) != state.shape[0]:
        raise ValueError("x32 sort route: state must be int32 [n_fields, capacity]")
    _launch_scan(columns, n, perm, None, key, None, False, [None] * len(columns),
                 state, field_col, layout.ops)
    return state


def x32_reduce(algo: str, gid, tail, pred, pvalid, values, valids,
               layout: X32Layout, state) -> torch.Tensor:
    """One batch of an x32 stage function reduced on ``algo``'s route and
    merged into the int32 ``state``: "matmul" (D's matmul form over every
    sum and count, E per extremum, one M), "scatter" (the same at D's
    scatter block) or "sort"."""
    capacity = state.shape[1]
    device = state.device
    if algo == "sort":
        if device.type == "cpu":
            return sorted_segment_agg_x32_reference(gid, tail, pred, pvalid, values,
                                                    valids, layout, state)
        return sorted_segment_agg_x32_cuda(gid, tail, pred, pvalid, values, valids,
                                           layout, state)
    distinct, count_of = _batch_counts(layout.counts, valids)
    block = (DF32_BLOCK if algo == "matmul"
             else df32_scatter_block(gid.shape[0], capacity, device))
    hi, lo, cnt = df32_agg(gid, tail, pred, pvalid, values, valids, layout.sums,
                           distinct, capacity, block)
    ext_out = [
        ord_extremum(gid, tail, pred, pvalid, valids[a], values[a],
                     values[b] if b >= 0 else None, capacity, is_min)
        for a, b, is_min in layout.exts
    ]
    return x32_merge(state, layout.ops,
                     _x32_rows(layout, hi, lo, [cnt[i] for i in count_of], ext_out))


def _x32_batch(layout: X32Layout, program: "ExprProgram", env: dict, n: int, device):
    """The batch's kernel columns: the expression program's outputs, then
    each pair leaf's (hi, lo) with its validity twice."""
    pred, pvalid, values, valids = expr_eval(program, env, n, device)
    values, valids = list(values), list(valids)
    for closure in layout.pairs:
        (hi, lo), ok = closure(env)
        values += [hi, lo]
        valids += [ok, ok]
    return pred, pvalid, values, valids


def _make_x32_kernels(filter_closure, arg_closures, specs, flat_names):
    layout = x32_layout(specs, arg_closures)
    program = ExprProgram(filter_closure, layout.closures, layout.columns, mode="x32")

    def run(algo: str, seg_ids, valid, arrays, capacity: int, state):
        device = seg_ids.device
        n = seg_ids.shape[0]
        env = dict(zip(flat_names, arrays))
        pred, pvalid, values, valids = _x32_batch(layout, program, env, n, device)
        if state is None:
            state = init_states(specs, capacity, device, "x32")
        return x32_reduce(algo, seg_ids, valid, pred, pvalid, values, valids, layout, state)

    return run


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
    buf = torch.empty((state.shape[0] + 1, keep), dtype=state.dtype, device=state.device)
    buf[:-1] = state[:, :keep]
    buf[-1] = partition_ids(bits, nulls, n_out)
    host = buf.cpu().numpy()
    return host[:-1], host[-1]


# ------------------------------------------------------- device join (B5)
JOIN_MAX_COLUMNS = 32  # build columns one probe gathers (join_probe.h)
# the bridge's device dtypes (x32's f32 and int32 too)
_JOIN_VALUE_DTYPES = (F64, I64, F32, I32, torch.bool)


def join_build_table_twin(bkeys: torch.Tensor, kmin: int, span: int) -> torch.Tensor:
    """Plain PyTorch twin of the dense slot-table kernel: int32 ``[span]``
    holding ``row + 1`` at slot ``bkeys[row] - kmin`` and 0 (no such key)
    everywhere else (the reference's eager scatter in ``_prepare_build``)."""
    m = bkeys.shape[0]
    tbl = torch.zeros(span, dtype=torch.int32, device=bkeys.device)
    tbl[bkeys.to(I64) - kmin] = torch.arange(1, m + 1, dtype=torch.int32, device=bkeys.device)
    return tbl


def _check_build_args(bkeys, kmin: int, span: int) -> None:
    """ValueError unless the slot-table kernel takes these inputs (checked
    before the binding: an exception inside the extension may end the
    process)."""
    if not (
        isinstance(bkeys, torch.Tensor) and bkeys.device.type == "cuda"
        and bkeys.dtype in (I64, I32) and bkeys.dim() == 1 and bkeys.is_contiguous()
        and 1 <= bkeys.shape[0] < (1 << 31)
    ):
        raise ValueError("bkeys must be a contiguous CUDA int64 or int32 [m] tensor, "
                         "1 <= m < 2^31")
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
        rel = pkey.to(I64) - int(kmin)
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
        and pkey.dtype in (I64, I32) and pkey.dim() == 1 and pkey.is_contiguous()
    ):
        raise ValueError("pkey must be a contiguous CUDA int64 or int32 [n] tensor")
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
        if bkeys.dtype != pkey.dtype:
            raise ValueError(f"pkey ({pkey.dtype}) and bkeys ({bkeys.dtype}) must share "
                             "one key dtype")
        _check_cuda_tensor(bkeys, "bkeys", (pkey.dtype,), m, device)
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
        torch.empty(0, dtype=pkey.dtype, device=device) if bkeys is None else bkeys,
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
    (in order) and ``pkey`` is its probe join key (int64; int32 in x32,
    with the build keys).  One
    :func:`join_probe` gathers the build columns and folds the misses into
    the row mask, then ``inner_fn`` runs unchanged on the full argument
    list, so the joined relation is never materialised."""
    n_probe = sum(1 for n in flat_names if n not in join_slots)
    head = 4 if dense else 3

    def fn(seg_ids, valid, *args, **kw):
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
        return inner_fn(seg_ids, mask, *full, **kw)

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
KEY_KINDS = {"code": 0, "ident": 1, "bool": 2, "f32": 3, "f64": 4}  # keyed.h
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


def _wrap_i32(c: torch.Tensor) -> torch.Tensor:
    """int64 codes as int32 words: each code's low 32 bits."""
    c = c.to(I64) & 0xFFFFFFFF
    return torch.where(c >= (1 << 31), c - (1 << 32), c).to(I32)


def key_encode_reference(kinds: tuple, keys: tuple, masks: tuple, n: int, device,
                         code_dtype=I64):
    """Plain twin of the key encode kernel.  ``keys[k]`` is ``(codes,)`` for
    kind ``code`` (host-encoded codes pass through) or ``(values,
    validity-or-None)`` for a device kind; ``masks`` are the row masks
    (None = all rows) whose AND keeps a row.  Returns ``(inv, codes)``:
    the int32 sort operand ``not mask`` and one int64 code column per
    device kind, bit-identical to ``encoder.encode`` of the port's host
    encoders (``ident``: the zigzag image, null 0; ``bool``: null 0, False
    1, True 2; ``f32``/``f64``: the raw bit pattern, null the reserved NaN
    of ``FLOAT32_NULL_BITS``/``FLOAT64_NULL_BITS``).  ``code_dtype``
    int32 (x32) keeps each device code's low 32 bits; "code" keys are
    passed through as shipped."""
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
        codes.append(_wrap_i32(c) if code_dtype == I32 else c)
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


def key_encode_cuda(kinds: tuple, keys: tuple, masks: tuple, n: int, device,
                    code_dtype=I64):
    """Launch the hand-written key encode kernel (ops/cuda/keyed_gids.cu),
    the same outputs as :func:`key_encode_reference`, bit for bit.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:device_encode_keys`` (B7)
    inside the keyed prep; the row mask folds into the sort operand in the
    same pass.  ``code_dtype`` int32 is x32's form: each code's low 32
    bits."""
    from .cuda.build import load

    if code_dtype not in (I64, I32):
        raise ValueError(f"key_encode: code dtype {code_dtype}")
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
        out = torch.empty(n, dtype=code_dtype, device=device)
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


def key_encode(kinds: tuple, keys: tuple, masks: tuple, n: int, device,
               code_dtype=I64):
    """Sort operands of one batch: the CUDA kernel on a CUDA device, its
    plain twin on the CPU."""
    if torch.device(device).type == "cpu":
        return key_encode_reference(kinds, keys, masks, n, device, code_dtype)
    return key_encode_cuda(kinds, keys, masks, n, device, code_dtype)


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
    else 0 (int64 words, or x32's int32 words)."""
    cap = out.shape[1]
    g = torch.arange(cap, device=out.device)
    live = g < n_groups
    at = starts[torch.clamp(g, max=max(n_groups - 1, 0))].long()
    for k, key in enumerate(sk):
        if key.shape[0] == 0:
            out[k] = 0
            continue
        vals = key[torch.clamp(at, max=key.shape[0] - 1)].to(out.dtype)
        out[k] = torch.where(live, vals, torch.zeros_like(vals))
    return out


# ------------------------------------------ keyed single dispatch (B7c)
# The keyed route's single-dispatch runner: a keyed stream of at most
# FOLD_MAX_ENTRIES batches within the buffer budget codes every batch's
# keys and row masks in ONE entry-wise launch straight into the
# concatenated sort operands.  When every key's min-rebased code span fits
# and the widths sum to 31 bits at most (the stage compiler's
# ``_radix_combine_bits`` plan, ``fold``: one ``(min, width)`` a key), the
# keys fold into one non-negative int32 word, so K1 sorts one operand; the
# finish unfolds each group's word back into its key codes.  Counterpart
# of ``arrow_ballista_tpu/ops/stage_compiler.py``'s _keyed_reduce_fused,
# _keyed_fused_sort_for and _radix_combine_bits.
FOLD_MAX_ENTRIES = 32  # keyed_fold.h: kFoldMaxEntries
FOLD_MAX_BITS = 31


def fold_shifts(fold) -> list:
    """Each key's shift in the folded word: the widths of the keys after
    it (the first key is the most significant)."""
    shifts, acc = [], 0
    for _lo, width in reversed(fold):
        shifts.append(acc)
        acc += width
    return shifts[::-1]


def _check_fold(kinds: tuple, fold) -> None:
    if len(fold) != len(kinds) or any(k in ("f32", "f64") for k in kinds):
        raise ValueError(f"fold plan {fold} for key kinds {kinds}")
    widths = [w for _lo, w in fold]
    if min(widths) < 1 or sum(widths) > FOLD_MAX_BITS:
        raise ValueError(f"fold widths {widths}: 1 bit or more each, {FOLD_MAX_BITS} in all")


def keyed_encode_entries_reference(kinds: tuple, entries: list, fold=None,
                                   code_dtype=I64) -> tuple:
    """Plain twin of the entry-wise encode.  ``entries`` are the pending
    batches' ``(keys, masks, n)`` as :func:`key_encode_reference` takes
    them; each runs that twin, and the batches' ``inv`` and code columns
    are joined in entry order, each column as ``code_dtype`` (host codes
    may ship as int32).  With a ``fold`` plan the codes fold into
    one int32 word in int64 arithmetic, ``comb = (comb << width) | (code -
    min)`` key by key (x32's codes as their signed int32 words).  Returns
    ``(inv, sort keys)``: ``[comb]`` folded, else one column a key."""
    device = entries[0][0][0][0].device
    invs, cols = [], [[] for _ in kinds]
    for keys, masks, n in entries:
        inv, codes = key_encode_reference(kinds, keys, masks, n, device, code_dtype)
        invs.append(inv)
        for col, c in zip(cols, codes):
            col.append(c)
    inv = torch.cat(invs)
    # host codes may ship as int32 words in x64: every column is code_dtype
    codes = [torch.cat(col).to(code_dtype) for col in cols]
    if fold is None:
        return inv, codes
    comb = torch.zeros(inv.shape[0], dtype=I64, device=device)
    for (lo, width), c in zip(fold, codes):
        comb = (comb << width) | (c.to(I64) - lo)
    return inv, [comb.to(I32)]


def keyed_encode_entries_cuda(kinds: tuple, entries: list, fold=None,
                              code_dtype=I64) -> tuple:
    """Launch the hand-written entry-wise encode (ops/cuda/keyed_fold.cu)
    over every pending batch: the same outputs as
    :func:`keyed_encode_entries_reference`, bit for bit.

    Replaces the encode, concatenate and radix-combine half of
    ``arrow_ballista_tpu/ops/stage_compiler.py:_keyed_fused_sort_for``
    (B7c)."""
    from .cuda.build import load

    if code_dtype not in (I64, I32):
        raise ValueError(f"keyed_encode_entries: code dtype {code_dtype}")
    if not 1 <= len(entries) <= FOLD_MAX_ENTRIES:
        raise ValueError(f"keyed_encode_entries: {len(entries)} entries")
    device = torch.empty(0, device=entries[0][0][0][0].device).device
    masks_l, values_l, valids_l, in_types = [], [], [], []
    empty = torch.empty(0, dtype=torch.bool, device=device)
    total = 0
    for keys, masks, n in entries:
        masks = tuple(masks)
        if len(masks) > 3:
            raise ValueError("keyed_encode_entries: at most 3 masks an entry")
        _check_encode_args(kinds, keys, masks, n, device)
        masks_l.append([empty if m is None else m
                        for m in masks + (None,) * (3 - len(masks))])
        values_l.append([ops[0] for ops in keys])
        valids_l.append([empty if len(ops) < 2 or ops[1] is None else ops[1]
                         for ops in keys])
        in_types += [KEY_IN_TYPES[ops[0].dtype] for ops in keys]
        total += n
    if fold is not None:
        _check_fold(kinds, fold)
    inv = torch.empty(total, dtype=torch.int32, device=device)
    if fold is None:
        comb = torch.empty(0, dtype=torch.int32, device=device)
        outs = [torch.empty(total, dtype=code_dtype, device=device) for _ in kinds]
    else:
        comb = torch.empty(total, dtype=torch.int32, device=device)
        outs = []
    load().keyed_encode_entries(
        inv, comb, outs, torch.empty(0, dtype=code_dtype).element_size(),
        [KEY_KINDS[k] for k in kinds], in_types,
        [lo for lo, _w in fold or ()], fold_shifts(fold) if fold else [],
        masks_l, values_l, valids_l,
    )
    count_launch("keyed_encode_entries")
    return inv, ([comb] if fold is not None else outs)


def keyed_encode_entries(kinds: tuple, entries: list, fold=None, code_dtype=I64) -> tuple:
    """Sort operands of every pending batch: the CUDA kernel for CUDA
    tensors, its plain twin for tensors on the CPU."""
    if entries[0][0][0][0].device.type == "cpu":
        return keyed_encode_entries_reference(kinds, entries, fold, code_dtype)
    return keyed_encode_entries_cuda(kinds, entries, fold, code_dtype)


def keyed_unfold_reference(sk: torch.Tensor, starts: torch.Tensor, n_groups: int, fold,
                           out: torch.Tensor) -> torch.Tensor:
    """Plain twin of the unfold kernel: ``out[k][g]`` is key k's code of
    group g, ``((word >> shift_k) & (2^width_k - 1)) + min_k`` of the
    folded word at the group's first sorted row, for g < ``n_groups``,
    else 0 (int64 words, or x32's int32 words): what
    :func:`keyed_keys_reference` gives from the unfolded sorted keys."""
    cap = out.shape[1]
    g = torch.arange(cap, device=out.device)
    live = g < n_groups
    if sk.shape[0] == 0:
        out.zero_()
        return out
    at = starts[torch.clamp(g, max=max(n_groups - 1, 0))].long()
    w = sk[torch.clamp(at, max=sk.shape[0] - 1)].to(I64)
    for k, ((lo, width), shift) in enumerate(zip(fold, fold_shifts(fold))):
        v = ((w >> shift) & ((1 << width) - 1)) + lo
        out[k] = torch.where(live, v, torch.zeros_like(v)).to(out.dtype)
    return out


def keyed_unfold_cuda(sk: torch.Tensor, starts: torch.Tensor, n_groups: int, fold,
                      out: torch.Tensor) -> torch.Tensor:
    """Launch the unfold kernel (ops/cuda/keyed_fold.cu): the same key rows
    as :func:`keyed_unfold_reference`, bit for bit.

    Replaces the shift unpack after the sort of ``arrow_ballista_tpu/ops/
    stage_compiler.py:_keyed_fused_sort_for`` (B7c)."""
    from .cuda.build import load

    device, n = out.device, sk.shape[0]
    if device.type != "cuda" or out.dtype not in (I64, I32) or out.dim() != 2 or (
        not out.is_contiguous() or out.shape[0] != len(fold)
    ):
        raise ValueError("out must be a contiguous CUDA int64 or int32 [n_keys, capacity]")
    if not 0 <= n_groups <= min(n, out.shape[1]):
        raise ValueError(f"n_groups {n_groups} for {n} rows, capacity {out.shape[1]}")
    _check_fold(("code",) * len(fold), fold)
    _check_cuda_tensor(sk, "sorted words", (torch.int32,), n, device)
    _check_cuda_tensor(starts, "starts", (torch.int32,), n + 1, device)
    load().keyed_unfold(sk, starts, int(n_groups), [lo for lo, _w in fold],
                        fold_shifts(fold), [w for _lo, w in fold], out)
    count_launch("keyed_unfold")
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


def _finish_packed(specs: list, ops: list, n_keys: int, capacity: int, device):
    """The finish's output with every state row at its identity."""
    flags = _field_flags(specs)
    if len(ops) != len(flags):
        raise ValueError(f"{len(ops)} ops for {len(flags)} state fields")
    words = torch.tensor([_ident_bits(r, i) for r, i in flags], dtype=I64).to(device)
    packed = torch.empty((len(flags) + n_keys, capacity), dtype=I64, device=device)
    packed[:len(flags)] = words[:, None]
    return packed, len(flags)


def _key_rows(gids: dict, fold) -> int:
    """Key rows of the finish: one a key; a folded sort has one sorted
    word for all of them."""
    return len(gids["sk"]) if fold is None else len(fold)


def keyed_finish_reference(specs, columns, field_col, ops, perm, gids, n_groups: int,
                           capacity: int, fold=None) -> torch.Tensor:
    """Plain twin of :func:`keyed_finish_cuda`: the segmented scan's twin
    into the state rows, the key gather's (or the unfold's) twin into the
    key rows."""
    packed, n_state = _finish_packed(specs, ops, _key_rows(gids, fold), capacity,
                                     perm.device)
    _scan_into_state_reference(columns, field_col, ops, packed[:n_state], perm.shape[0],
                               perm, gids["gid_in"])
    _key_rows_reference(gids, n_groups, fold, packed[n_state:])
    return packed


def _key_rows_reference(gids: dict, n_groups: int, fold, out: torch.Tensor) -> None:
    if fold is None:
        keyed_keys_reference(gids["sk"], gids["starts"], n_groups, out)
    else:
        keyed_unfold_reference(gids["sk"][0], gids["starts"], n_groups, fold, out)


FINISH_TILE = 1024  # sorted rows a CTA of the finish folds (keyed.h: kFinishTile)
FINISH_MAX_COLUMNS = 4  # columns one pass carries (keyed.h: kFinishMaxCols)
FINISH_MAX_FIELDS = 64


def _check_finish_args(columns, field_col, ops, perm, gids, n_groups: int, keys: list,
                       out: torch.Tensor) -> None:
    """ValueError unless the finish kernel can read its inputs: ``perm``,
    ``gids["s2"]`` and ``gids["starts"]`` of one sort on the card, sum,
    count and extremum columns as K2 takes them, one column a state row,
    the sorted key codes, and ``out`` a contiguous ``[rows, capacity]``
    (checked before the binding: an exception inside the extension may
    end the process)."""
    device = perm.device
    n = perm.shape[0] if perm.dim() == 1 else -1
    if device.type != "cuda" or not 0 <= n < (1 << 31):
        raise ValueError("keyed_finish runs on CUDA tensors, n < 2^31")
    _check_cuda_tensor(gids["s2"], "s2", (torch.int32,), n, device)
    _check_scan_args(columns, n, perm, None, gids["s2"], None, device)
    _check_cuda_tensor(gids["starts"], "starts", (torch.int32,), n + 1, device)
    for i, c in enumerate(columns):
        if c.src not in (SS_VALUES, SS_COUNT):
            raise ValueError(f"finish column {i}: source {c.src}")
    if out.device != device or not out.is_contiguous() or out.dim() != 2:
        raise ValueError("the finish's output must be a contiguous [rows, capacity] on the card")
    if not 0 <= n_groups <= min(n, out.shape[1]):
        raise ValueError(f"n_groups {n_groups} for {n} rows, capacity {out.shape[1]}")
    if len(field_col) != len(ops) or len(ops) > FINISH_MAX_FIELDS or (
        any(not 0 <= c < len(columns) for c in field_col)
    ):
        raise ValueError(f"finish fields: columns {list(field_col)} of {len(columns)}")
    if len(keys) > KEYED_MAX_KEYS or out.shape[0] != len(ops) + len(keys):
        raise ValueError(f"finish output rows {out.shape[0]}: {len(ops)} states, "
                         f"{len(keys)} keys")
    for k, key in enumerate(keys):
        _check_cuda_tensor(key, f"sorted key {k}", (torch.int32, I64), n, device)


def _finish_passes(columns: list) -> list:
    """The finish's passes: runs of at most FINISH_MAX_COLUMNS consecutive
    columns, every column of a row gathered in one pass."""
    return [list(range(i, min(i + FINISH_MAX_COLUMNS, len(columns))))
            for i in range(0, len(columns), FINISH_MAX_COLUMNS)]


def _record_words(cols: list) -> int:
    """Words of a pass's packed row: one for each column that reads memory
    (a count with no validity reads none), rounded up to a power of two
    so a record is one 16- or 32-byte piece of a sector; 0 (the columns
    gathered directly) where one column or none reads memory."""
    reads = sum(1 for c in cols if c.values is not None or c.valid is not None)
    return 0 if reads < 2 else 1 << (reads - 1).bit_length()


def _launch_finish(columns, field_col, ops, idents: list, perm, gids, n_groups: int,
                   keys: list, out: torch.Tensor, x32: bool) -> None:
    """The finish kernel over ``columns`` into ``out``: each pass
    (:func:`_finish_passes`) writes its columns' state rows (``ops`` the
    merges, ``idents`` the identity words), the first the key rows after
    them."""
    from .cuda.build import load

    ext = load()
    device = out.device
    n = perm.shape[0]
    tiles = -(-n // FINISH_TILE)
    empty = torch.empty(0, dtype=torch.uint8, device=device)
    for i, cols in enumerate(_finish_passes(columns)):
        local = {c: k for k, c in enumerate(cols)}
        pc = [columns[c] for c in cols]
        words = _record_words(pc)
        ext.keyed_finish(
            perm, gids["s2"], gids["starts"], int(n_groups),
            [empty if c.values is None else c.values for c in pc],
            [empty if c.valid is None else c.valid for c in pc],
            [empty if c.values2 is None else c.values2 for c in pc],
            [c.src for c in pc], [c.op for c in pc],
            [int(c.values is not None and c.values.dtype == I64) for c in pc],
            [_scan_width(c) for c in pc],
            [local.get(c, -1) for c in field_col], list(ops), list(idents), x32,
            list(keys) if i == 0 else [], len(ops), out,
            torch.empty(tiles * len(cols), dtype=I64, device=device),
            torch.empty(tiles * len(cols), dtype=I64, device=device),
            torch.empty(n * words, dtype=I64, device=device),
        )


def keyed_finish_cuda(specs, columns, field_col, ops, perm, gids, n_groups: int,
                      capacity: int, fold=None) -> torch.Tensor:
    """The keyed route's finish on the card: ``[n_fields + n_keys,
    capacity]`` int64, the state rows (presence last, floats as their bits)
    and then each group's key codes, fetched by the host in ONE copy.  The
    finish kernel (ops/cuda/keyed_finish.cu) reduces the scan columns over
    the valid sorted rows, segmented by ``gids["s2"]``, straight into the
    state slots and gathers the key rows, or, after a folded sort
    (``fold``, the plan of :func:`keyed_encode_entries`), the unfold kernel
    (ops/cuda/keyed_fold.cu) recovers them from each group's word.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:keyed_finish_kernel`` (B8)."""
    return _finish_cuda(columns, field_col, ops, _finish_idents(specs, ops, "x64"), perm,
                        gids, n_groups, capacity, fold, I64)


def _finish_idents(specs, ops, mode: str) -> list:
    """Each state row's identity word (int64 in x64, int32 in x32)."""
    idents = [_ident_bits(r, i, mode) for r, i in _field_flags(specs, mode)]
    if len(ops) != len(idents):
        raise ValueError(f"{len(ops)} ops for {len(idents)} state rows")
    return idents


def _finish_cuda(columns, field_col, ops, idents, perm, gids, n_groups, capacity, fold,
                 dtype) -> torch.Tensor:
    """Both forms of the finish: the kernel into the state rows and the key
    rows, or the unfold kernel into the key rows after a folded sort."""
    n_state = len(ops)
    keys = gids["sk"] if fold is None else []
    packed = torch.empty((n_state + _key_rows(gids, fold), capacity), dtype=dtype,
                         device=perm.device)
    head = packed if fold is None else packed[:n_state]
    _check_finish_args(columns, field_col, ops, perm, gids, n_groups, keys, head)
    _launch_finish(columns, field_col, ops, idents, perm, gids, n_groups, keys, packed,
                   dtype == I32)
    count_launch("keyed_finish")
    if fold is not None:
        keyed_unfold_cuda(gids["sk"][0], gids["starts"], n_groups, fold, packed[n_state:])
    return packed


def keyed_finish(specs, columns, field_col, ops, perm, gids, n_groups: int,
                 capacity: int, fold=None) -> torch.Tensor:
    """The keyed finish: the CUDA kernels for CUDA tensors, the twins for
    tensors on the CPU."""
    if perm.device.type == "cpu":
        return keyed_finish_reference(specs, columns, field_col, ops, perm, gids,
                                      n_groups, capacity, fold)
    return keyed_finish_cuda(specs, columns, field_col, ops, perm, gids, n_groups,
                             capacity, fold)


def keyed_finish_x32_reference(specs, columns, field_col, ops, perm, gids,
                               n_groups: int, capacity: int, fold=None) -> torch.Tensor:
    """Plain twin of :func:`keyed_finish_x32_cuda`."""
    n_state = len(ops)
    packed = torch.empty((n_state + _key_rows(gids, fold), capacity), dtype=I32,
                         device=perm.device)
    packed[:n_state] = init_states(specs, capacity, perm.device, "x32")
    _scan_into_state_x32_reference(columns, field_col, ops, packed[:n_state],
                                   perm.shape[0], perm, gids["gid_in"])
    _key_rows_reference(gids, n_groups, fold, packed[n_state:])
    return packed


def keyed_finish_x32_cuda(specs, columns, field_col, ops, perm, gids, n_groups: int,
                          capacity: int, fold=None) -> torch.Tensor:
    """The keyed finish in x32 (the reference's ``keyed_finish_kernel``
    in x32, int32 words): the finish kernel reduces :func:`_x32_scan_plan`'s
    columns over the valid sorted rows and merges each group's totals into
    its identities with the x32 merge (``ops``), then the key codes in the
    rows after them (the unfold kernel after a folded sort): ``[n_fields +
    n_keys, capacity]`` int32, one fetch."""
    return _finish_cuda(columns, field_col, ops, _finish_idents(specs, ops, "x32"), perm,
                        gids, n_groups, capacity, fold, I32)


def keyed_finish_x32(specs, columns, field_col, ops, perm, gids, n_groups: int,
                     capacity: int, fold=None) -> torch.Tensor:
    """The x32 keyed finish: the CUDA kernels for CUDA tensors, the twins
    for tensors on the CPU."""
    if perm.device.type == "cpu":
        return keyed_finish_x32_reference(specs, columns, field_col, ops, perm, gids,
                                          n_groups, capacity, fold)
    return keyed_finish_x32_cuda(specs, columns, field_col, ops, perm, gids,
                                 n_groups, capacity, fold)


def unpack_keyed_host(specs: list, packed: np.ndarray, n_keys: int,
                      signed_keys: tuple = ()) -> tuple:
    """Host inverse of :func:`keyed_finish`'s pack: (state arrays with
    presence last, one int64 key-code array per key).  An int32 pack is
    x32's: its states as :func:`unpack_host` views them, each key code's
    32-bit word widened unsigned (zigzag, bool and dictionary codes) or,
    for the keys in ``signed_keys`` (f32 bit patterns), signed."""
    if packed.dtype == np.int32:
        n_state = len(packed) - n_keys
        states = unpack_host(specs, packed[:n_state])
        keys = []
        for k in range(n_keys):
            w = packed[n_state + k].astype(np.int64)
            keys.append(w if k in signed_keys else w & 0xFFFFFFFF)
        return states, keys
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


def merge_keyed_host_x32(specs: list, per_chunk: list) -> tuple:
    """:func:`merge_keyed_host` for x32 chunks: each chunk's int32 state
    rows scatter to their merged group (identities elsewhere) and merge
    into one state with the x32 state merge (2Sum pairs, order pairs),
    chunk by chunk, on the host."""
    live = [(st, k, n) for st, k, n in per_chunk if n > 0]
    if not live:
        empty = [np.zeros(0, dtype=np.int32) for _ in per_chunk[0][0]]
        return empty, [np.zeros(0, np.int64) for _ in per_chunk[0][1]], 0
    n_keys = len(live[0][1])
    keys = [np.concatenate([k[j][:n] for _s, k, n in live]) for j in range(n_keys)]
    order = np.lexsort(tuple(reversed(keys)))
    sk = [k[order] for k in keys]
    newflag = np.zeros(len(order), dtype=bool)
    newflag[:1] = True
    for k in sk:
        newflag[1:] |= k[1:] != k[:-1]
    group = np.empty(len(order), dtype=np.int64)
    group[order] = np.cumsum(newflag) - 1
    starts = np.flatnonzero(newflag)
    n_groups = len(starts)
    ops = x32_merge_ops(specs)
    state = init_states(specs, n_groups, "cpu", "x32")
    at = 0
    for st, _k, n in live:
        rows = torch.from_numpy(np.stack([a[:n].view(np.int32) for a in st]))
        full = init_states(specs, n_groups, "cpu", "x32")
        full[:, torch.from_numpy(group[at:at + n])] = rows
        state = x32_merge_reference(state, ops, list(full))
        at += n
    return unpack_host(specs, state.numpy()), [k[starts] for k in sk], n_groups


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
def keyed_median_reference(inv, keys, ohi, olo, ovalid, capacity: int,
                           out_dtype=I64) -> torch.Tensor:
    """Plain twin of the median kernel, the arithmetic of the reference's
    ``keyed_median_kernel``: one sort by (inv, *keys, arg-null, ohi, olo),
    group ids from key changes among valid rows, a doubled segment id
    ``gid * 2 + null`` whose bounds give each group's first row and valid
    count; per group the order pairs at the two middle rows, the valid
    count and the count of distinct values (run starts).  Returns
    ``[6, capacity]`` int64 (``out_dtype`` int32 in x32): hi@lo, lo@lo,
    hi@hi, lo@hi, count, distinct."""
    n, device = inv.shape[0], inv.device
    argnull = (
        torch.zeros(n, dtype=torch.int32, device=device) if ovalid is None
        else torch.logical_not(ovalid).to(torch.int32)
    )
    perm = radix_argsort_reference([inv] + list(keys) + [argnull, ohi, olo]).long()
    out = torch.zeros((6, capacity), dtype=out_dtype, device=device)
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


def keyed_median_cuda(inv, keys, ohi, olo, ovalid, capacity: int,
                      out_dtype=I64) -> torch.Tensor:
    """The median and count distinct on the card: K1 sorts by (inv, *keys,
    arg-null, ohi, olo), the gid kernel finds each group's first row, and
    the median kernel (ops/cuda/keyed_median.cu, one block per group) reads
    the valid count, the two middle order pairs and the distinct run
    starts.  Same output as :func:`keyed_median_reference`, bit for bit.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:keyed_median_kernel`` (B9)."""
    from .cuda.build import load

    device, n = inv.device, inv.shape[0]
    if device.type != "cuda" or capacity < 1 or out_dtype not in (I64, I32):
        raise ValueError("keyed_median runs on CUDA tensors, capacity >= 1, "
                         "int64 or int32 out")
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
    out = torch.empty((6, capacity), dtype=out_dtype, device=device)
    if n == 0:
        return out.zero_()
    load().keyed_median(perm, argnull, ohi, olo, gids["starts"], gids["counts"], out)
    count_launch("keyed_median")
    return out


def keyed_median(inv, keys, ohi, olo, ovalid, capacity: int,
                 out_dtype=I64) -> torch.Tensor:
    """Per-group median and distinct count of one argument: the CUDA
    kernels for CUDA tensors, the twin for tensors on the CPU."""
    if inv.device.type == "cpu":
        return keyed_median_reference(inv, keys, ohi, olo, ovalid, capacity, out_dtype)
    return keyed_median_cuda(inv, keys, ohi, olo, ovalid, capacity, out_dtype)


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


# x32 corr (the reference's x32 corr_fn): the state rows of both passes
_CORR_X32_PASS1 = [XM_ADD_I32, XM_SUM_HI, XM_SUM_LO, XM_SUM_HI, XM_SUM_LO]
_CORR_X32_PASS2 = [XM_SUM_HI, XM_SUM_LO] * 3


def _corr_x32_mask(xhi, xvalid, yhi, yvalid):
    m = torch.ones(xhi.shape[0], dtype=torch.bool, device=xhi.device)
    for ok in (xvalid, yvalid):
        if ok is not None:
            m = m & ok
    return m & ~torch.isnan(xhi) & ~torch.isnan(yhi)


def _corr_x32_pass1_columns(xhi, xlo, yhi, ylo, m):
    return [
        ScanColumn(SS_COUNT, OP_ADD_I64, valid=m),
        ScanColumn(SS_VALUES, OP_DF32, values=xhi, valid=m, values2=xlo),
        ScanColumn(SS_VALUES, OP_DF32, values=yhi, valid=m, values2=ylo),
    ]


def corr_center_x32_reference(s2, perm, xhi, xlo, yhi, ylo, m, moments):
    """Plain twin of the x32 centring kernel: per sorted row the group's
    f32 means ``(Σhi + Σlo) / max(n, 1)`` from ``moments`` (int32 rows n,
    Σx hi, lo, Σy hi, lo), the pair centred as ``(hi - mean) + lo`` and the
    f32 products x'y', x'², y'² (0 where the pair is not valid)."""
    cap = moments.shape[1]
    nf = torch.clamp(moments[0], min=1).to(F32)
    mx = (moments[1].view(F32) + moments[2].view(F32)) / nf
    my = (moments[3].view(F32) + moments[4].view(F32)) / nf
    g = torch.clamp(s2.long(), 0, cap - 1)
    p = perm.long()
    xc = (xhi[p] - mx[g]) + xlo[p]
    yc = (yhi[p] - my[g]) + ylo[p]
    ms = m[p]
    zero = torch.zeros_like(xc)
    return [torch.where(ms, xc * yc, zero), torch.where(ms, xc * xc, zero),
            torch.where(ms, yc * yc, zero)]


def keyed_corr_x32_reference(s2, perm, gid_in, xhi, xlo, xvalid, yhi, ylo, yvalid,
                             capacity: int):
    """Plain twin of :func:`keyed_corr_x32_cuda`, the arithmetic of the
    reference's ``keyed_corr_kernel(capacity, "x32")``: pass 1 double-
    float sums of each argument's exact f32 pair and the pair count over
    pairwise-valid rows, f32 centring, pass 2 double-float sums of the f32
    products.  Returns ``[7, capacity]`` int32: Σx'y', Σx'², Σy'² as (hi,
    lo) f32 bits, then n."""
    n = perm.shape[0]
    buf = torch.zeros((11, capacity), dtype=I32, device=perm.device)
    m = _corr_x32_mask(xhi, xvalid, yhi, yvalid)
    _scan_into_state_x32_reference(_corr_x32_pass1_columns(xhi, xlo, yhi, ylo, m),
                                   [0, 1, 1, 2, 2], _CORR_X32_PASS1, buf[6:11], n,
                                   perm, gid_in)
    prods = corr_center_x32_reference(s2, perm, xhi, xlo, yhi, ylo, m, buf[6:11])
    cols2 = [ScanColumn(SS_VALUES, OP_DF32, values=v) for v in prods]
    _scan_into_state_x32_reference(cols2, [0, 0, 1, 1, 2, 2], _CORR_X32_PASS2, buf[0:6],
                                   n, None, s2)
    return buf[:7].clone()


def keyed_corr_x32_cuda(s2, perm, gid_in, xhi, xlo, xvalid, yhi, ylo, yvalid,
                        capacity: int):
    """x32 corr moments on the card: the pairwise mask (``corr_mask`` on
    the f32 hi words) and the f32 centring (``corr_center_x32``) are
    hand-written (ops/cuda/keyed_corr.cu), both passes' double-float sums
    are K2 with its x32 epilogue.  Same layout as
    :func:`keyed_corr_x32_reference`.

    Replaces ``arrow_ballista_tpu/ops/kernels.py:keyed_corr_kernel`` in
    x32 (B10)."""
    from .cuda.build import load

    device, n = perm.device, perm.shape[0]
    if device.type != "cuda" or capacity < 1:
        raise ValueError("keyed_corr runs on CUDA tensors, capacity >= 1")
    for name, t in (("s2", s2), ("perm", perm), ("gid_in", gid_in)):
        _check_cuda_tensor(t, name, (torch.int32,), n, device)
    for name, t in (("xhi", xhi), ("xlo", xlo), ("yhi", yhi), ("ylo", ylo)):
        _check_cuda_tensor(t, name, (F32,), n, device)
    for name, t in (("xvalid", xvalid), ("yvalid", yvalid)):
        if t is not None:
            _check_cuda_tensor(t, name, (torch.bool,), n, device)
    buf = torch.zeros((11, capacity), dtype=I32, device=device)
    if n == 0:
        return buf[:7].clone()
    ext = load()
    empty = torch.empty(0, dtype=torch.bool, device=device)
    m = torch.empty(n, dtype=torch.bool, device=device)
    ext.corr_mask(xhi, empty if xvalid is None else xvalid, yhi,
                  empty if yvalid is None else yvalid, m)
    count_launch("keyed_corr")
    cols1 = _corr_x32_pass1_columns(xhi, xlo, yhi, ylo, m)
    _check_scan_args(cols1, n, perm, None, gid_in, None, device)
    _launch_scan(cols1, n, perm, None, gid_in, None, False, [None] * 3, buf[6:11],
                 [0, 1, 1, 2, 2], _CORR_X32_PASS1)
    prods = [torch.empty(n, dtype=F32, device=device) for _ in range(3)]
    ext.corr_center_x32(s2, perm, xhi, xlo, yhi, ylo, m, buf[6:11].contiguous(),
                        prods[0], prods[1], prods[2])
    count_launch("keyed_corr")
    cols2 = [ScanColumn(SS_VALUES, OP_DF32, values=v) for v in prods]
    _check_scan_args(cols2, n, None, None, s2, None, device)
    _launch_scan(cols2, n, None, None, s2, None, False, [None] * 3, buf[0:6],
                 [0, 0, 1, 1, 2, 2], _CORR_X32_PASS2)
    return buf[:7].clone()


def keyed_corr_x32(s2, perm, gid_in, xhi, xlo, xvalid, yhi, ylo, yvalid, capacity: int):
    """Per-group centred corr moments in x32: the CUDA kernels for CUDA
    tensors, the twins for tensors on the CPU."""
    if perm.device.type == "cpu":
        return keyed_corr_x32_reference(s2, perm, gid_in, xhi, xlo, xvalid, yhi, ylo,
                                        yvalid, capacity)
    return keyed_corr_x32_cuda(s2, perm, gid_in, xhi, xlo, xvalid, yhi, ylo, yvalid,
                               capacity)


# ------------------------------------------------------- keyed prep (B7)
@dataclass
class KeyedBatch:
    """One batch's buffered operands on the device: the sort operand
    ``inv`` (int32, 1 = the row is dropped), the key codes, the scan
    columns' values and validities (None = absent or all valid) and the
    raw extras of the median and corr passes.  A batch whose encode waits
    for the single-dispatch runner has no ``inv`` or codes yet: ``keys``
    and ``masks`` hold what :func:`keyed_encode_entries` takes."""

    inv: Optional[torch.Tensor]
    codes: list
    values: list
    valids: list
    extras: list
    keys: tuple = ()
    masks: tuple = ()

    @property
    def rows(self) -> int:
        return (self.inv if self.inv is not None else self.keys[0][0]).shape[0]

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
    mode: str = "x64",
):
    """Per-batch half of the keyed aggregation (the reference's
    ``make_keyed_prep_kernel``).

    ``fn(keys, valid, *leaf_arrays, state=None, encode=True) ->
    KeyedBatch``: the filter and arguments run through the expression
    program (B3, as in the basic route), then :func:`key_encode` derives
    the key codes and the sort operand from ``keys`` (per key ``(codes,)``
    for kind ``code``, else ``(values, validity)``) and the row masks;
    with ``encode`` False the batch keeps ``keys`` and the masks for the
    single-dispatch runner's one :func:`keyed_encode_entries` launch over
    every pending batch.  ``keys`` rides the group-id slot, so
    :func:`make_join_kernel` wraps this function unchanged; ``state`` is
    accepted for that signature and ignored.  ``extra_names`` are env
    arrays buffered raw for the median and corr passes.  The keyed route
    always has at least one group key.

    ``mode`` "x32" builds the reference's x32 prep: the x32 program and
    pair leaves (:func:`_x32_batch`), int32 key codes, and ``fn.layout``
    the :class:`X32Layout` the x32 finish reads."""
    if mode == "x32":
        layout = x32_layout(specs, arg_closures)
        program = ExprProgram(filter_closure, layout.closures, layout.columns, mode="x32")
    else:
        closures, columns, ops, cols = _agg_layout(specs, arg_closures)
        program = ExprProgram(filter_closure, closures, columns)
        layout = (columns, ops, cols)
    code_dtype = index_dtype(mode)

    def fn(keys, valid, *arrays, state=None, encode=True):
        env = dict(zip(flat_names, arrays))
        n, device = keys[0][0].shape[0], keys[0][0].device
        if mode == "x32":
            pred, pvalid, values, valids = _x32_batch(layout, program, env, n, device)
        else:
            pred, pvalid, values, valids = expr_eval(program, env, n, device)
        extras = [env[nm] for nm in extra_names]
        masks = (valid, pred, pvalid)
        if not encode:
            return KeyedBatch(None, [], values, valids, extras, tuple(keys), masks)
        inv, codes = key_encode(key_kinds, tuple(keys), masks, n, device, code_dtype)
        return KeyedBatch(inv, list(codes), values, valids, extras)

    fn.layout = layout
    return fn
