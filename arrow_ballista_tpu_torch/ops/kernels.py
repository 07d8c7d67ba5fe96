"""PyTorch lowering of physical expressions + the segment-aggregate kernels.

Counterpart of ``arrow_ballista_tpu/ops/kernels.py`` for one CUDA device.
The eligible stage subtree (filter → project → partial aggregate) runs per
batch as torch elementwise ops on the stage's device (the expression
closures, which XLA inlined into one program on the reference) followed by
the hand-written segment aggregate that folds the masks, reduces per group
and merges into the running state: the scatter route
(``ops/cuda/segment_agg.cu``) or, at large capacity on cuda, the sort
route (``ops/cuda/radix_sort.cu`` + ``ops/cuda/seg_scan.cu``, which the
window kernel shares).

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
    the values).
    """

    name: str
    kind: str  # "column" | "cpu_expr" | "column_validity"
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


class TorchExprCompiler:
    """Lower PhysicalExpr trees to torch closures over a shared leaf env.

    Counterpart of the reference's ``JaxExprCompiler``: any subtree that
    cannot lower (LIKE, string functions, …) but whose OUTPUT is
    device-friendly becomes a ``cpu_expr`` leaf evaluated by pyarrow per
    batch and shipped beside the raw columns.
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

        return run

    def validity_only(self, e: pe.Col) -> TorchClosure:
        """Leaf that ships ONLY the validity mask of a column (count(col))."""
        name = f"col_{e.index}__validonly"
        self.leaves[name] = LeafSpec(name, "column_validity", col_index=e.index)
        vname = f"{name}__valid"

        def run(env: dict):
            return None, env[vname]

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

        return run

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
                const = _const(v, torch.bool)
            elif isinstance(v, int):
                if not -(2**63) <= v < 2**63:
                    raise NotLowerable(f"int literal {v} exceeds i64")
                const = _const(v, I64)
            elif isinstance(v, float):
                const = _const(v, F64)
            elif _is_date(v):
                const = _const(_days(v), I64)
            else:
                raise NotLowerable(f"literal {v!r}")
            return lambda env: (const(env), None)

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

                return run_bool
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

                return run_bin
            if op == "/":

                def run_div(env, lf=lf, rf=rf):
                    lv, lval = lf(env)
                    rv, rval = rf(env)
                    if _is_int(lv) and _is_int(rv):
                        # SQL / Arrow integer division truncates toward
                        # zero with the zero divisor guarded (the
                        # reference's lax.div); `//` would floor
                        lv, rv = lv.to(I64), rv.to(I64)
                        rv_safe = torch.where(rv == 0, torch.ones_like(rv), rv)
                        return (
                            torch.div(lv, rv_safe, rounding_mode="trunc"),
                            _merge_valid(lval, rval),
                        )
                    return lv.to(F64) / rv.to(F64), _merge_valid(lval, rval)

                return run_div
            if op == "%":

                def run_mod(env, lf=lf, rf=rf):
                    lv, lval = lf(env)
                    rv, rval = rf(env)
                    return _floor_mod(lv, rv), _merge_valid(lval, rval)

                return run_mod
            raise NotLowerable(f"binary op {op}")

        if isinstance(e, pe.Not):
            f = self._lower_or_leaf(e.expr)

            def run_not(env, f=f):
                v, val = f(env)
                v = v if val is None else torch.logical_and(v, val)
                return torch.logical_not(v), None

            return run_not

        if isinstance(e, pe.Negative):
            f = self._lower(e.expr)

            def run_neg(env, f=f):
                v, val = f(env)
                return -v, val

            return run_neg

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

            return run_isnull

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

            return run_in

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

            return run_case

        if isinstance(e, pe.Cast):
            f = self._lower(e.expr)
            dt = _pa_to_torch_dtype(e.to_type)

            def run_cast(env, f=f, dt=dt):
                v, val = f(env)
                return _cast(v, dt), val

            return run_cast

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

                return run_fn
            if e.fname == "power" and len(e.args) == 2:
                a = self._lower(e.args[0])
                b = self._lower(e.args[1])

                def run_pow(env, a=a, b=b):
                    av, aval = a(env)
                    bv, bval = b(env)
                    return torch.pow(av.to(F64), bv.to(F64)), _merge_valid(aval, bval)

                return run_pow
            if e.fname == "round":
                f = self._lower(e.args[0])

                def run_round(env, f=f):
                    v, val = f(env)
                    # half-to-even, as jnp.round
                    return torch.round(v.to(F64)), val

                return run_round
            raise NotLowerable(f"scalar fn {e.fname}")

        raise NotLowerable(f"node {type(e).__name__}")


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


def _floor_mod(lv: torch.Tensor, rv: torch.Tensor) -> torch.Tensor:
    """``jnp.mod``: floor modulo; an integer zero divisor gives 0 (torch
    raises on the CPU and returns garbage on CUDA, so it is guarded)."""
    if _is_int(lv) and _is_int(rv):
        lv, rv = lv.to(I64), rv.to(I64)
        zero = rv == 0
        r = torch.remainder(lv, torch.where(zero, torch.ones_like(rv), rv))
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
    ("segment_agg", "radix_sort", "seg_scan", "range_extremum", "window_epilogue",
     "partition_ids"), 0
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
    expression closures run as torch ops on the arrays' device, then one
    :func:`segment_agg` folds the masks, reduces every aggregate per group
    and merges into ``state`` (a fresh identity state when None), which is
    returned.  Per-agg state layout is :func:`state_fields` — sum/avg →
    (sum, n), min/max → (value, n), count/count_star → (n,) — and the last
    row is presence, the count of mask-passing rows per group.

    The field layout is fixed here, once: aggregates whose argument is the
    SAME closure object and dtype share one kernel column, and each distinct
    closure runs once per batch.  ``algo`` picks the reduction route
    (:func:`segment_algo`): "scatter" (:func:`segment_agg`) or "sort"
    (:func:`sorted_segment_agg`); both merge into the same state.
    """
    if algo not in ("scatter", "sort"):
        raise ValueError(f"agg algorithm {algo!r}")
    reduce = sorted_segment_agg if algo == "sort" else segment_agg
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

    def fn(seg_ids, valid, *arrays, state=None):
        device = seg_ids.device
        n = seg_ids.shape[0]
        env = dict(zip(flat_names, arrays))
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
        valids = [
            _column(evaluated[k][1], n, torch.bool, device) for k, _ in columns
        ]
        if state is None:
            state = init_states(specs, capacity, device)
        return reduce(seg_ids, valid, pred, pvalid, values, valids, ops, cols, state)

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
