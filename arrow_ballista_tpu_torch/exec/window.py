"""Window evaluation operator.

Reference parity note: DataFusion's single-node engine evaluates window
functions while the reference's distributed planner raises NotImplemented
for WindowAggExec (``scheduler/src/planner.rs`` WindowAggExec arm).  This
engine goes further: the physical planner hash-repartitions the input on
the PARTITION BY keys (each hash partition then holds whole window
partitions), so windows run distributed with ordinary data parallelism.

Evaluation is fully vectorized: one ``pc.sort_indices`` permutation per
DISTINCT window-key signature (specs sharing PARTITION/ORDER BY — the
common shape — reuse one ``_SortState``), numpy segment boundaries and
segmented cumsums, one type-generic pyarrow hash aggregation for
whole-partition frames — no per-row or per-group Python.

Semantics (SQL defaults):
* ranking functions need ORDER BY (row_number / rank / dense_rank);
* aggregate functions without ORDER BY cover the whole partition;
* with ORDER BY they run over the default frame RANGE BETWEEN UNBOUNDED
  PRECEDING AND CURRENT ROW — peer rows (ties in the order keys) share
  the frame, so each row sees the running value through its LAST peer;
* output rows keep the INPUT order (windows never reorder).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..errors import ExecutionError
from .expressions import PhysicalExpr
from .operators import ExecutionPlan, Partitioning, TaskContext, sort_indices

RANKING = {"row_number", "rank", "dense_rank", "ntile"}
VALUE_FNS = {"lag", "lead", "first_value", "last_value"}


@dataclass(frozen=True)
class WindowSpec:
    func: str  # row_number | rank | dense_rank | lag | lead | first_value
    #            | last_value | sum | avg | min | max | count
    arg: Optional[PhysicalExpr]  # None for ranking and count(*)
    partition_by: tuple  # of PhysicalExpr
    order_by: tuple  # of (PhysicalExpr, asc: bool, nulls_first: Optional[bool])
    name: str
    out_type: pa.DataType
    offset: int = 1  # lag/lead distance; ntile bucket count
    # explicit ROWS frame (start, end) row offsets; None = default RANGE
    frame: Optional[tuple] = None


class WindowExec(ExecutionPlan):
    """Appends one column per window spec to its input."""

    def __init__(self, input: ExecutionPlan, specs: list[WindowSpec]):
        super().__init__()
        self.input = input
        self.specs = specs

    @property
    def schema(self) -> pa.Schema:
        fields = list(self.input.schema)
        fields += [pa.field(s.name, s.out_type, True) for s in self.specs]
        return pa.schema(fields)

    def output_partitioning(self) -> Partitioning:
        return self.input.output_partitioning()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children):
        return WindowExec(children[0], self.specs)

    def __str__(self) -> str:
        return "WindowExec: " + ", ".join(
            f"{s.func}->{s.name}" for s in self.specs
        )

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        batches = list(self.input.execute(partition, ctx))
        if not batches:
            return
        with self.metrics.timer("window_time_ns"):
            table = pa.Table.from_batches(batches, schema=self.input.schema)

            def eval_col(e: PhysicalExpr):
                parts = []
                for b in batches:
                    v = e.evaluate(b)
                    if isinstance(v, pa.Scalar):  # literal argument
                        v = pa.array([v.as_py()] * b.num_rows, type=v.type)
                    parts.append(v)
                return pa.chunked_array(parts) if len(parts) > 1 else parts[0]

            # one _SortState (permutation + segment flags) per distinct
            # window-key signature: specs sharing PARTITION/ORDER BY —
            # the common many-functions-one-window shape — sort once
            states: dict = {}
            win_cols = []
            for spec in self.specs:
                sig = (
                    tuple(str(p) for p in spec.partition_by),
                    tuple(
                        (str(e), asc, nf) for e, asc, nf in spec.order_by
                    ),
                )
                st = states.get(sig)
                if st is None:
                    st = _SortState(table.num_rows, eval_col, spec)
                    states[sig] = st
                win_cols.append(self._evaluate_spec(spec, st, eval_col))
            out = table
            for spec, col in zip(self.specs, win_cols):
                out = out.append_column(pa.field(spec.name, spec.out_type), col)
        self.metrics.add("output_rows", out.num_rows)
        for b in out.to_batches(max_chunksize=ctx.batch_size):
            yield b

    # ------------------------------------------------------------ evaluate
    def _evaluate_spec(
        self, spec: WindowSpec, st: "_SortState", eval_col
    ) -> pa.Array:
        n = st.n
        if spec.func == "ntile":
            sorted_out = _ntile(spec.offset, n, st.seg_id, st.seg_first)
        elif spec.func in RANKING:
            sorted_out = self._ranking(
                spec.func, n, st.seg_flag, st.seg_first, st.peer_flag
            )
        elif spec.func in VALUE_FNS:
            sorted_out = _value_fn(spec, st, eval_col)
        else:
            sorted_out = _aggregate(spec, st, eval_col)

        # scatter back to input row order
        if isinstance(sorted_out, (pa.Array, pa.ChunkedArray)):
            arr = sorted_out.take(pa.array(st.inv)) if n else sorted_out
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.combine_chunks()
        else:
            out = sorted_out[st.inv] if n else sorted_out
            arr = pa.array(out, from_pandas=True)
        if not arr.type.equals(spec.out_type):
            arr = pc.cast(arr, spec.out_type, safe=False)
        return arr

    @staticmethod
    def _ranking(func, n, seg_flag, seg_first, peer_flag) -> np.ndarray:
        return _ranking_impl(func, n, seg_flag, seg_first, peer_flag)


class _SortState:
    """Sort/segment state shared by every spec with the same window keys:
    one key evaluation, one ``pc.sort_indices`` permutation, one set of
    segment/peer flags, one inverse permutation."""

    def __init__(self, n: int, eval_col, spec: WindowSpec):
        self.n = n
        key_arrays: list = []
        keys: list[tuple] = []
        for i, p in enumerate(spec.partition_by):
            key_arrays.append(eval_col(p))
            keys.append((f"__p{i}", "ascending", "at_start"))
        for i, (e, asc, nf) in enumerate(spec.order_by):
            if nf is None:
                nf = not asc  # SQL default: NULLS LAST for ASC, FIRST for DESC
            key_arrays.append(eval_col(e))
            keys.append(
                (
                    f"__o{i}",
                    "ascending" if asc else "descending",
                    "at_start" if nf else "at_end",
                )
            )
        if keys:
            sort_tbl = pa.table({k[0]: a for k, a in zip(keys, key_arrays)})
            self.perm = sort_indices(sort_tbl, keys).to_numpy()
        else:
            self.perm = np.arange(n, dtype=np.int64)
        # key columns in SORTED order, computed once for both flag passes
        self._sorted_keys = [
            a.take(pa.array(self.perm)) if n else a for a in key_arrays
        ]
        self._n_part = len(spec.partition_by)
        self._peer_flag: Optional[np.ndarray] = None
        self._inv: Optional[np.ndarray] = None

        self.seg_flag = self._change_flags(self._sorted_keys[: self._n_part])
        seg_starts = np.flatnonzero(self.seg_flag)
        # per sorted row: index of its segment's first row
        seg_first = np.zeros(n, dtype=np.int64)
        seg_first[seg_starts] = seg_starts
        self.seg_first = np.maximum.accumulate(seg_first)
        self.seg_id = (
            np.cumsum(self.seg_flag) - 1 if n else np.empty(0, np.int64)
        )

    def _change_flags(self, sorted_arrays: list) -> np.ndarray:
        """flag[i] = sorted row i starts a new group (row 0 always does);
        null == null counts as the same group."""
        n = self.n
        flag = np.zeros(n, dtype=bool)
        if n:
            flag[0] = True
        for s in sorted_arrays:
            cur, prev = s.slice(1), s.slice(0, max(n - 1, 0))
            neq = pc.fill_null(pc.not_equal(cur, prev), False)
            null_diff = pc.xor(pc.is_null(cur), pc.is_null(prev))
            diff = pc.or_(neq, null_diff)
            flag[1:] |= np.asarray(diff, dtype=bool)
        return flag

    @property
    def peer_flag(self) -> np.ndarray:
        """Partition-OR-order-key change flags (peer-group starts)."""
        if self._peer_flag is None:
            self._peer_flag = self._change_flags(self._sorted_keys)
        return self._peer_flag

    @property
    def inv(self) -> np.ndarray:
        if self._inv is None:
            self._inv = np.empty(self.n, dtype=np.int64)
            self._inv[self.perm] = np.arange(self.n, dtype=np.int64)
        return self._inv


def _ranking_impl(func, n, seg_flag, seg_first, peer_flag) -> np.ndarray:
    idx = np.arange(n, dtype=np.int64)
    if func == "row_number":
        return idx - seg_first + 1
    # first row of each peer group
    peer_first = np.zeros(n, dtype=np.int64)
    starts = np.flatnonzero(peer_flag)
    peer_first[starts] = starts
    peer_first = np.maximum.accumulate(peer_first)
    if func == "rank":
        return peer_first - seg_first + 1
    # dense_rank: count of peer-group starts within the segment
    peers_cum = np.cumsum(peer_flag)
    return peers_cum - peers_cum[seg_first] + 1


def _ntile(k: int, n: int, seg_id: np.ndarray, seg_first: np.ndarray) -> np.ndarray:
    """SQL ntile(k): rows split into k buckets by order; the first
    (size % k) buckets get one extra row."""
    if not n:
        return np.empty(0, np.int64)
    sizes = np.bincount(seg_id)[seg_id]  # per-row partition size
    pos = np.arange(n, dtype=np.int64) - seg_first
    q, r = sizes // k, sizes % k
    big = r * (q + 1)  # rows covered by the (q+1)-sized buckets
    # when q == 0 every row is in a "big" (1-row) bucket, so the small
    # branch's divisor q only matters where q >= 1
    in_big = pos < big
    bucket_big = pos // (q + 1) + 1
    bucket_small = r + (pos - big) // np.maximum(q, 1) + 1
    return np.where(in_big, bucket_big, bucket_small)


def _sorted_arg(st: "_SortState", eval_col, arg) -> pa.Array:
    v = eval_col(arg)
    vs = v.take(pa.array(st.perm)) if st.n else v
    return vs.combine_chunks() if isinstance(vs, pa.ChunkedArray) else vs


def _value_fn(spec: WindowSpec, st: "_SortState", eval_col) -> pa.Array:
    """lag/lead/first_value/last_value: pure gathers over sorted rows,
    type-preserving.  last_value honors the default RANGE frame (the
    frame ends at the LAST peer — the classic SQL gotcha)."""
    n = st.n
    vs = _sorted_arg(st, eval_col, spec.arg)
    idx = np.arange(n, dtype=np.int64)
    if spec.func == "first_value":
        src, ok = st.seg_first, np.ones(n, dtype=bool)
    elif spec.func == "last_value":
        src, ok = _last_of_group(st.peer_flag, n), np.ones(n, dtype=bool)
    elif spec.func == "lag":
        # clamp BOTH frame sides: a negative offset (unreachable from SQL
        # but possible via serde / programmatic WindowSpec) reads forward,
        # so the partition end must bound it too
        seg_last = _last_of_group(st.seg_flag, n)
        src = idx - spec.offset
        ok = (src >= st.seg_first) & (src <= seg_last)
    else:  # lead
        seg_last = _last_of_group(st.seg_flag, n)
        src = idx + spec.offset
        ok = (src <= seg_last) & (src >= st.seg_first)
    taken = vs.take(pa.array(np.clip(src, 0, max(n - 1, 0))))
    if ok.all():
        return taken
    return pc.if_else(pa.array(ok), taken, pa.scalar(None, vs.type))


_NUMERIC = (pa.types.is_integer, pa.types.is_floating, pa.types.is_decimal)


def _require_numeric(spec: WindowSpec, t: pa.DataType) -> None:
    if not any(check(t) for check in _NUMERIC):
        extra = (
            f" (whole-partition {spec.func} — no ORDER BY in the window — "
            "supports any ordered type)"
            if spec.func in ("min", "max")
            else ""
        )
        raise ExecutionError(
            f"window {spec.func} needs a numeric argument, got {t}{extra}"
        )


def _running_minmax(spec: WindowSpec, vs, seg_id, seg_first):
    """(cum, cnt_mm): row-exact running min/max over sorted rows, shared
    by the ROWS-framed and default-RANGE paths.  Exact-int inputs return
    a pa.Array (int64 stays exact past 2^53) with cnt_mm None; the float
    path returns a numpy array already NaN-gated on the running count of
    non-missing values (null/NaN rows see the prior valid extremum)."""
    _require_numeric(spec, vs.type)
    import pandas as pd

    if pa.types.is_integer(vs.type) and vs.null_count == 0:
        g = pd.Series(
            vs.to_numpy(zero_copy_only=False).astype(np.int64)
        ).groupby(seg_id)
        cum = (g.cummin() if spec.func == "min" else g.cummax()).to_numpy()
        return pa.array(cum, pa.int64()), None
    fvals = pc.cast(vs, pa.float64(), safe=False).to_numpy(
        zero_copy_only=False
    )
    miss = np.isnan(fvals)
    ident = np.inf if spec.func == "min" else -np.inf
    cnt_mm = _segmented_cumsum((~miss).astype(np.int64), seg_first)
    g = pd.Series(np.where(miss, ident, fvals)).groupby(seg_id)
    cum = (g.cummin() if spec.func == "min" else g.cummax()).to_numpy()
    return np.where(cnt_mm > 0, cum, np.nan), cnt_mm


def _np_range_extremum(v, lo, hi, fn, ident, max_len):
    """Per-row extremum over [lo_i, hi_i]: numpy sparse table (doubling)
    — level k holds the extremum of the size-2^k window starting at each
    row; the query is two overlapping-window gathers.  ``max_len``
    bounds the depth (finite frames need ceil(log2(frame_len)) levels).
    Callers clip lo/hi to the row's segment, so both query windows stay
    inside it even though levels span boundaries."""
    n = len(v)
    if n == 0:
        return v
    ext = np.minimum if fn == "min" else np.maximum
    depth = max(1, int(max(max_len - 1, 1)).bit_length())
    levels = [v]
    cur = v
    for k in range(1, depth + 1):
        s = 1 << (k - 1)
        shifted = np.full(n, ident, dtype=cur.dtype)
        if s < n:
            shifted[: n - s] = cur[s:]
        cur = ext(cur, shifted)
        levels.append(cur)
    table = np.stack(levels)
    length = np.maximum(hi - lo + 1, 1)
    kq = np.zeros(n, dtype=np.int64)
    for k in range(1, depth + 1):
        kq += (length >= (1 << k)).astype(np.int64)
    size = np.left_shift(np.ones(n, dtype=np.int64), kq)
    aidx = np.clip(lo, 0, n - 1)
    bidx = np.clip(hi - size + 1, 0, n - 1)
    flat = table.reshape(-1)
    return ext(flat[kq * n + aidx], flat[kq * n + bidx])


def _rows_frame_aggregate(spec: WindowSpec, st: "_SortState", eval_col):
    """Explicit ROWS frames: row-exact sliding windows (no peer sharing).

    sum/avg/count reduce to two gathers on a segment-clamped prefix sum
    — O(n) regardless of frame width; bounded min/max query a sparse
    table (``_np_range_extremum``) — O(n log frame) build, O(n) query,
    with the running cummin/cummax fast path kept for UNBOUNDED
    PRECEDING .. CURRENT ROW."""
    n = st.n
    seg_first = st.seg_first
    start, end = spec.frame
    idx = np.arange(n, dtype=np.int64)
    seg_last = _last_of_group(st.seg_flag, n)
    lo = seg_first if start is None else np.maximum(seg_first, idx + start)
    hi = seg_last if end is None else np.minimum(seg_last, idx + end)
    empty = hi < lo

    if spec.func in ("min", "max"):
        vs = _sorted_arg(st, eval_col, spec.arg)
        if start is None and end == 0:
            # running fast path: grouped cummin/cummax
            cum, _ = _running_minmax(spec, vs, st.seg_id, seg_first)
            if isinstance(cum, pa.Array):  # exact-int path
                return pc.if_else(
                    pa.array(~empty), cum, pa.scalar(None, cum.type)
                )
            return np.where(~empty, cum, np.nan)  # cum already NaN-gated
        # general ROWS frame: sparse-table range extremum (two gathers
        # over log-depth doubled windows — the same decomposition the
        # device kernel uses, ops/window_kernel._range_extremum)
        _require_numeric(spec, vs.type)
        if start is not None and end is not None:
            max_len = end - start + 1
        else:
            # half-unbounded frames never exceed the largest segment:
            # bound the table depth by it, not n (the device kernel has
            # to use its static padded n — this host path need not)
            max_len = (
                int((seg_last - seg_first + 1).max()) if n else 1
            )
        if pa.types.is_integer(vs.type) and vs.null_count == 0:
            v = vs.to_numpy(zero_copy_only=False).astype(np.int64)
            ident = (
                np.iinfo(np.int64).max
                if spec.func == "min"
                else np.iinfo(np.int64).min
            )
            res = _np_range_extremum(
                v, lo, hi, spec.func, ident, max_len
            )
            return pa.array(res, pa.int64(), mask=empty)
        fvals = pc.cast(vs, pa.float64(), safe=False).to_numpy(
            zero_copy_only=False
        )
        miss = np.isnan(fvals)
        ident = np.inf if spec.func == "min" else -np.inf
        res = _np_range_extremum(
            np.where(miss, ident, fvals), lo, hi, spec.func, ident, max_len
        )
        # frames holding only nulls (or clipped empty) are NULL: count
        # the frame's valid rows via a segment-local prefix difference
        vcum = _segmented_cumsum((~miss).astype(np.int64), seg_first)
        hi_c = np.clip(hi, 0, max(n - 1, 0))
        lom1_c = np.clip(lo - 1, 0, max(n - 1, 0))
        base = np.where(lo > seg_first, vcum[lom1_c], 0)
        vcnt = np.where(empty, 0, vcum[hi_c] - base)
        return np.where(vcnt > 0, res, np.nan)

    if spec.arg is None:  # count(*)
        out = hi - lo + 1
        return np.where(empty, 0, out)

    vs = _sorted_arg(st, eval_col, spec.arg)
    if spec.func in ("sum", "avg"):
        _require_numeric(spec, vs.type)
    valid = ~np.asarray(pc.is_null(vs), dtype=bool)

    # bounds can point past the partition (e.g. 2 FOLLOWING at the last
    # row): clamp the prefix indexes; the empty-frame mask nulls those.
    # Prefixes are SEGMENT-LOCAL (pandas grouped cumsum): a global prefix
    # makes the P[hi]-P[lo-1] cancellation scale with the whole-table
    # magnitude — measured 4e-4 relative error on a small-valued
    # partition following a 1e6-valued one.
    hi_g = np.clip(hi, 0, max(n - 1, 0))
    lom1_g = np.clip(lo - 1, 0, max(n - 1, 0))
    lo_open = lo > seg_first  # P[lo-1] lies inside the segment

    def range_sum(vals):
        import pandas as pd

        ps = (
            pd.Series(vals).groupby(st.seg_id).cumsum().to_numpy()
        )  # inclusive, resets per segment
        base = np.where(lo_open, ps[lom1_g], 0)
        return np.where(empty, 0, ps[hi_g] - base)

    cnt = range_sum(valid.astype(np.int64))
    cnt = np.where(empty, 0, cnt)
    if spec.func == "count":
        return cnt
    if pa.types.is_integer(vs.type) and vs.null_count == 0 and (
        spec.func == "sum"
    ):
        vals = vs.to_numpy(zero_copy_only=False).astype(np.int64)
        total = range_sum(vals)
        # int64 exactness survives: null out empty frames via an Arrow
        # mask instead of routing the values through float64
        return pa.array(total, pa.int64(), mask=cnt == 0)
    fvals = np.nan_to_num(
        pc.cast(vs, pa.float64(), safe=False).to_numpy(zero_copy_only=False),
        nan=0.0,
    )
    total = range_sum(fvals)
    if spec.func == "sum":
        return np.where(cnt > 0, total, np.nan)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(cnt > 0, total / cnt, np.nan)


def _aggregate(spec: WindowSpec, st: "_SortState", eval_col):
    if spec.frame is not None:
        return _rows_frame_aggregate(spec, st, eval_col)
    n = st.n
    seg_id, seg_first = st.seg_id, st.seg_first
    running = bool(spec.order_by)
    if spec.arg is None:  # count(*)
        if not running:
            sizes = np.bincount(seg_id, minlength=seg_id[-1] + 1 if n else 0)
            return sizes[seg_id].astype(np.int64)
        idx = np.arange(n, dtype=np.int64)
        # rows count through the LAST peer (RANGE frame)
        peer_last = _last_of_group(st.peer_flag, n)
        return idx[peer_last] - seg_first + 1

    vs = _sorted_arg(st, eval_col, spec.arg)

    if not running:
        # whole-partition frame: one TYPE-GENERIC pyarrow hash
        # aggregation over the dense segment ids — min/max keep the
        # input type (strings, dates, wide ints stay exact) and an
        # all-null group's sum is null as SQL requires
        fn = {
            "sum": "sum", "avg": "mean", "min": "min", "max": "max",
            "count": "count",
        }[spec.func]
        if spec.func in ("sum", "avg"):
            _require_numeric(spec, vs.type)  # else raw pyarrow kernel error
        seg_tbl = pa.table({"s": pa.array(seg_id), "v": vs})
        res = pa.TableGroupBy(seg_tbl, "s").aggregate([("v", fn)])
        res = res.sort_by([("s", "ascending")])
        return res.column(f"v_{fn}").take(pa.array(seg_id))

    # running frame: cumulative within segment, then peers share the
    # value through their last row
    is_exact_int = pa.types.is_integer(vs.type) and vs.null_count == 0
    valid = ~np.asarray(pc.is_null(vs), dtype=bool)
    cnt = _segmented_cumsum(valid.astype(np.int64), seg_first)
    if spec.func == "count":
        cum = cnt
    elif spec.func in ("sum", "avg"):
        if is_exact_int and spec.func == "sum":
            # exact integer running sum (float64 loses ULPs past 2^53)
            vals = vs.to_numpy(zero_copy_only=False).astype(np.int64)
            cum = _segmented_cumsum(vals, seg_first)
        else:
            _require_numeric(spec, vs.type)
            vals = np.nan_to_num(
                pc.cast(vs, pa.float64(), safe=False).to_numpy(
                    zero_copy_only=False
                ),
                nan=0.0,
            )
            total = _segmented_cumsum(vals, seg_first)
            if spec.func == "sum":
                cum = np.where(cnt > 0, total, np.nan)
            else:
                with np.errstate(invalid="ignore", divide="ignore"):
                    cum = np.where(cnt > 0, total / cnt, np.nan)
    elif spec.func in ("min", "max"):
        cum, _ = _running_minmax(spec, vs, seg_id, seg_first)
    else:
        raise ExecutionError(f"window aggregate {spec.func}")
    peer_last = _last_of_group(st.peer_flag, n)
    if isinstance(cum, pa.Array):  # exact-int running min/max
        return cum.take(pa.array(peer_last))
    return np.asarray(cum)[peer_last]


def _segmented_cumsum(vals: np.ndarray, seg_first: np.ndarray) -> np.ndarray:
    """Within-segment inclusive cumsum over sorted rows: the global cumsum
    minus the global cumsum just BEFORE each row's segment start (exact
    for int64 inputs)."""
    if not len(vals):
        return vals
    cs = np.cumsum(vals)
    before_seg = cs[seg_first] - vals[seg_first]
    return cs - before_seg


def _last_of_group(start_flag: np.ndarray, n: int) -> np.ndarray:
    """Per row: index of the LAST row of its group, given group-start
    flags over sorted rows (vectorized reverse cummax trick)."""
    if not n:
        return np.empty(0, np.int64)
    # last row of group g = (next group's start) - 1; final group ends at n-1
    starts = np.flatnonzero(start_flag)
    nexts = np.append(starts[1:], n)
    group_of_row = np.cumsum(start_flag) - 1
    return nexts[group_of_row] - 1
