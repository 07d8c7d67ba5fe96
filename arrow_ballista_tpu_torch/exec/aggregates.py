"""Hash aggregation with Partial/Final split.

Counterpart of DataFusion's ``AggregateExec`` with ``AggregateMode`` as
serialized by the reference (``core/proto/ballista.proto:316-320``): the
Partial stage computes per-partition accumulator states, a shuffle hashes
rows by group key, and the Final stage merges states.  This split is exactly
what lets the TPU path reduce partials with ``psum`` across chips
(SURVEY.md §2.5) before the shuffle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import pyarrow as pa
import pyarrow.compute as pc

from ..errors import ExecutionError
from .expressions import PhysicalExpr, _as_array_len
from .operators import ExecutionPlan, Partitioning, TaskContext

PARTIAL = "partial"
FINAL = "final"
SINGLE = "single"


@dataclass(frozen=True)
class AggSpec:
    func: str  # sum | avg | min | max | count | count_distinct | median
    #            | stddev | stddev_pop | var | var_pop | corr | udaf:<name>
    arg: Optional[PhysicalExpr]  # None for count(*)
    name: str  # output column name
    out_type: pa.DataType
    arg2: Optional[PhysicalExpr] = None  # corr's second argument

    def state_fields(self) -> list[pa.Field]:
        """Partial-state columns this aggregate contributes."""
        if self.func == "avg":
            return [
                pa.field(f"{self.name}#sum", pa.float64()),
                pa.field(f"{self.name}#count", pa.int64()),
            ]
        if self.func in ("count", "count_distinct"):
            return [pa.field(self.name, pa.int64())]
        if self.func == "sum":
            t = self.out_type
            return [pa.field(self.name, t)]
        return [pa.field(self.name, self.out_type)]  # min / max


class HashAggregateExec(ExecutionPlan):
    def __init__(
        self,
        mode: str,
        group_exprs: list[tuple[PhysicalExpr, str]],
        aggs: list[AggSpec],
        input: ExecutionPlan,
    ):
        super().__init__()
        assert mode in (PARTIAL, FINAL, SINGLE)
        self.mode = mode
        self.group_exprs = group_exprs
        self.aggs = aggs
        self.input = input
        in_schema = input.schema
        gfields = []
        for e, name in group_exprs:
            from .operators import _infer_type

            gfields.append(pa.field(name, _infer_type(e, in_schema), True))
        if mode == PARTIAL:
            afields = [f for a in aggs for f in a.state_fields()]
        else:
            afields = [pa.field(a.name, a.out_type, True) for a in aggs]
        self._schema = pa.schema(gfields + afields)

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return self.input.output_partitioning()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children):
        return HashAggregateExec(self.mode, self.group_exprs, self.aggs, children[0])

    def __str__(self) -> str:
        return (
            f"HashAggregateExec: mode={self.mode}, "
            f"gby=[{', '.join(n for _, n in self.group_exprs)}], "
            f"aggr=[{', '.join(a.name for a in self.aggs)}]"
        )

    # ------------------------------------------------------------ execution
    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        batches = list(self.input.execute(partition, ctx))
        with self.metrics.timer("agg_time_ns"):
            if self.mode == FINAL:
                out = self._execute_final(batches)
            else:
                out = self._execute_partial_or_single(batches)
        self.metrics.add("output_rows", out.num_rows)
        for b in out.to_batches(max_chunksize=ctx.batch_size):
            yield b

    def _prepared_table(self, batches: list[pa.RecordBatch]) -> Optional[pa.Table]:
        """Evaluate group + arg exprs into a flat table g0..gk, a0..am
        (plus b{j} second-argument columns for corr)."""
        if not batches:
            return None
        cols: dict[str, pa.ChunkedArray] = {}
        for i, (e, name) in enumerate(self.group_exprs):
            cols[f"__g{i}"] = pa.chunked_array(
                [_as_array_len(e.evaluate(b), b.num_rows) for b in batches]
            )
        for j, a in enumerate(self.aggs):
            if a.arg is not None:
                cols[f"__a{j}"] = pa.chunked_array(
                    [_as_array_len(a.arg.evaluate(b), b.num_rows) for b in batches]
                )
            if a.arg2 is not None:
                cols[f"__b{j}"] = pa.chunked_array(
                    [_as_array_len(a.arg2.evaluate(b), b.num_rows) for b in batches]
                )
        if not cols:  # count(*) with no groups
            return pa.table({"__dummy": pa.array([0] * sum(b.num_rows for b in batches))})
        return pa.table(cols)

    def _execute_partial_or_single(self, batches: list[pa.RecordBatch]) -> pa.Table:
        tbl = self._prepared_table(batches)
        n_groups = len(self.group_exprs)
        partial = self.mode == PARTIAL

        if tbl is None or tbl.num_rows == 0:
            if n_groups == 0:
                return self._empty_global_result(partial)
            return pa.Table.from_batches([], schema=self._schema)

        if n_groups == 0:
            return self._global_agg(tbl, partial)

        gkeys = [f"__g{i}" for i in range(n_groups)]
        requests: list[tuple] = []
        # per OUTPUT field (schema order, after the keys): how to build it
        #   ("col", result_name)           — direct group_by result column
        #   ("udaf", result_name, spec)    — fold collected lists
        #   ("median", src)                — pandas groupby merge pass
        #   ("corr", j)                    — finalize the six sum requests
        emit: list[tuple] = []
        derived: dict[str, object] = {}  # extra columns for corr sums

        def _single_only(what: str) -> None:
            if partial:
                raise ExecutionError(
                    f"{what} must run single-stage after key repartition"
                )

        for j, a in enumerate(self.aggs):
            src = f"__a{j}"
            if a.func == "sum":
                requests.append((src, "sum"))
                emit.append(("col", f"{src}_sum"))
            elif a.func == "avg":
                if partial:
                    requests.append((src, "sum"))
                    emit.append(("col", f"{src}_sum"))
                    requests.append((src, "count"))
                    emit.append(("col", f"{src}_count"))
                else:
                    requests.append((src, "mean"))
                    emit.append(("col", f"{src}_mean"))
            elif a.func == "min":
                requests.append((src, "min"))
                emit.append(("col", f"{src}_min"))
            elif a.func == "max":
                requests.append((src, "max"))
                emit.append(("col", f"{src}_max"))
            elif a.func == "count":
                if a.arg is None:
                    # count(*) counts rows including nulls in the key column
                    requests.append(
                        (gkeys[0], "count", pc.CountOptions(mode="all"))
                    )
                    emit.append(("col", f"{gkeys[0]}_count"))
                else:
                    requests.append((src, "count"))
                    emit.append(("col", f"{src}_count"))
            elif a.func == "count_distinct":
                _single_only("count_distinct")
                requests.append((src, "count_distinct"))
                emit.append(("col", f"{src}_count_distinct"))
            elif a.func in ("stddev", "stddev_pop", "var", "var_pop"):
                _single_only(a.func)
                fn = "stddev" if a.func.startswith("stddev") else "variance"
                ddof = 0 if a.func.endswith("_pop") else 1
                requests.append((src, fn, pc.VarianceOptions(ddof=ddof)))
                emit.append(("col", f"{src}_{fn}"))
            elif a.func == "median":
                _single_only("median")
                emit.append(("median", src))
            elif a.func == "corr":
                _single_only("corr")
                # pairwise-valid sums: rows where either argument is null
                # OR NaN drop out of every sum (pandas treats NaN values
                # as missing in corr; the global path does the same)
                x = pc.cast(tbl.column(src), pa.float64(), safe=False)
                y = pc.cast(tbl.column(f"__b{j}"), pa.float64(), safe=False)
                both = pc.and_(
                    pc.and_(pc.is_valid(x), pc.is_valid(y)),
                    pc.and_(
                        pc.invert(pc.is_nan(x)), pc.invert(pc.is_nan(y))
                    ),
                )
                null = pa.scalar(None, pa.float64())
                xv = pc.if_else(both, x, null)
                yv = pc.if_else(both, y, null)
                # center by the GLOBAL mean (corr-invariant): the n·Σxy −
                # Σx·Σy form cancels catastrophically on raw magnitudes
                xm, ym = pc.mean(xv), pc.mean(yv)
                if xm.is_valid:
                    xv = pc.subtract(xv, xm)
                if ym.is_valid:
                    yv = pc.subtract(yv, ym)
                derived[f"__c{j}x"] = xv
                derived[f"__c{j}y"] = yv
                derived[f"__c{j}xy"] = pc.multiply(xv, yv)
                derived[f"__c{j}xx"] = pc.multiply(xv, xv)
                derived[f"__c{j}yy"] = pc.multiply(yv, yv)
                for nm in (f"__c{j}x", f"__c{j}y", f"__c{j}xy",
                           f"__c{j}xx", f"__c{j}yy"):
                    requests.append((nm, "sum"))
                requests.append((f"__c{j}x", "count"))
                emit.append(("corr", j))
            elif a.func.startswith("udaf:"):
                _single_only("UDAFs")
                # collect each group's values; the UDF folds them below
                requests.append((src, "list"))
                emit.append(("udaf", f"{src}_list", a))
            else:
                raise ExecutionError(f"unsupported aggregate {a.func}")

        grouped_tbl = tbl
        for nm, col in derived.items():
            grouped_tbl = grouped_tbl.append_column(nm, col)
        result = pa.TableGroupBy(grouped_tbl, gkeys).aggregate(requests)

        medians = self._group_medians(
            tbl, result, gkeys, sorted({e[1] for e in emit if e[0] == "median"})
        )

        # group_by output columns are named "<src>_<func>", keys keep names
        out_cols: list = []
        fields = list(self._schema)
        for i in range(len(self.group_exprs)):
            out_cols.append(result.column(f"__g{i}"))
        for entry, f in zip(emit, fields[len(self.group_exprs):]):
            if entry[0] == "col":
                col = result.column(entry[1])
            elif entry[0] == "udaf":
                col = _apply_udaf(entry[2], result.column(entry[1]), f.type)
            elif entry[0] == "median":
                col = medians[entry[1]]
            else:  # corr
                col = _finalize_corr(result, entry[1])
            if not col.type.equals(f.type):
                col = pc.cast(col, f.type, safe=False)
            out_cols.append(col)
        return pa.Table.from_arrays(out_cols, schema=self._schema)

    @staticmethod
    def _group_medians(
        tbl: pa.Table, result: pa.Table, gkeys: list[str], srcs: list[str]
    ) -> dict:
        """EXACT per-group medians (pyarrow only has approximate_median):
        one vectorized pandas groupby, merged back onto the group_by
        result's key rows (pandas merge matches null keys to null keys,
        and how='left' preserves the result row order)."""
        if not srcs:
            return {}
        import pandas as pd  # noqa: F401

        pdf = tbl.select(gkeys + srcs).to_pandas()
        med = (
            # observed=True: dictionary keys become pandas Categoricals,
            # and the default would materialize every UNOBSERVED category
            # combination (cartesian in the key cardinalities)
            pdf.groupby(gkeys, dropna=False, sort=False, observed=True)[srcs]
            .median()
            .reset_index()
        )
        keys_pdf = result.select(gkeys).to_pandas()
        merged = keys_pdf.merge(med, on=gkeys, how="left")
        return {
            src: pa.array(merged[src].to_numpy(), pa.float64(), from_pandas=True)
            for src in srcs
        }

    def _global_agg(self, tbl: pa.Table, partial: bool) -> pa.Table:
        import numpy as np
        cols: list[pa.Array] = []
        for j, a in enumerate(self.aggs):
            src = tbl.column(f"__a{j}") if a.arg is not None else None
            if a.func == "sum":
                v = pc.sum(src)
                cols.append(_scalar_col(v, self._field_for(a.name).type))
            elif a.func == "avg":
                if partial:
                    cols.append(_scalar_col(pc.sum(src), pa.float64()))
                    cols.append(_scalar_col(pc.count(src), pa.int64()))
                else:
                    cols.append(_scalar_col(pc.mean(src), pa.float64()))
            elif a.func == "min":
                cols.append(_scalar_col(pc.min(src), self._field_for(a.name).type))
            elif a.func == "max":
                cols.append(_scalar_col(pc.max(src), self._field_for(a.name).type))
            elif a.func == "count":
                n = tbl.num_rows if a.arg is None else pc.count(src).as_py()
                cols.append(pa.array([n], pa.int64()))
            elif a.func == "count_distinct":
                cols.append(
                    pa.array([pc.count_distinct(src).as_py()], pa.int64())
                )
            elif a.func in ("stddev", "stddev_pop", "var", "var_pop"):
                ddof = 0 if a.func.endswith("_pop") else 1
                fn = pc.stddev if a.func.startswith("stddev") else pc.variance
                cols.append(_scalar_col(fn(src, ddof=ddof), pa.float64()))
            elif a.func == "median":
                v = src.drop_null().to_numpy(zero_copy_only=False)
                out = float(np.median(v)) if len(v) else None
                cols.append(pa.array([out], pa.float64()))
            elif a.func == "corr":
                x = pc.cast(src, pa.float64(), safe=False).to_numpy(
                    zero_copy_only=False
                )
                y = pc.cast(
                    tbl.column(f"__b{j}"), pa.float64(), safe=False
                ).to_numpy(zero_copy_only=False)
                both = ~(np.isnan(x) | np.isnan(y))
                xv, yv = x[both], y[both]
                out = None
                if len(xv) >= 2 and xv.std() > 0 and yv.std() > 0:
                    out = float(np.corrcoef(xv, yv)[0, 1])
                cols.append(pa.array([out], pa.float64()))
            elif a.func.startswith("udaf:"):
                t = self._field_for(a.name).type
                v = _resolve_udaf(a.func).fn(src.combine_chunks())
                cols.append(pa.array([v], type=t))
            else:
                raise ExecutionError(f"unsupported aggregate {a.func}")
        return pa.Table.from_arrays(cols, schema=self._schema)

    def _field_for(self, name: str) -> pa.Field:
        return self._schema.field(name)

    def _empty_global_result(self, partial: bool) -> pa.Table:
        """Zero-row input, no GROUP BY → one row: counts 0, everything else
        NULL (SQL semantics for global aggregates over empty input)."""
        count_fields = set()
        for a in self.aggs:
            if a.func in ("count", "count_distinct"):
                count_fields.add(a.name)
            if a.func == "avg" and partial:
                count_fields.add(f"{a.name}#count")
        cols = []
        for f in self._schema:
            if f.name in count_fields:
                cols.append(pa.array([0], f.type))
            else:
                cols.append(pa.nulls(1, f.type))
        return pa.Table.from_arrays(cols, schema=self._schema)

    def _execute_final(self, batches: list[pa.RecordBatch]) -> pa.Table:
        """Merge partial states (input schema = partial output schema)."""
        n_groups = len(self.group_exprs)
        in_schema = self.input.schema
        if not batches:
            if n_groups == 0:
                return self._empty_global_result(False)
            return pa.Table.from_batches([], schema=self._schema)
        tbl = pa.Table.from_batches(batches, schema=in_schema)
        gkeys = [in_schema.field(i).name for i in range(n_groups)]

        if n_groups == 0:
            cols = []
            for a in self.aggs:
                if a.func == "avg":
                    s = pc.sum(tbl.column(f"{a.name}#sum")).as_py() or 0.0
                    c = pc.sum(tbl.column(f"{a.name}#count")).as_py() or 0
                    cols.append(pa.array([s / c if c else None], pa.float64()))
                elif a.func in ("count", "count_distinct"):
                    cols.append(_scalar_col(pc.sum(tbl.column(a.name)), pa.int64()))
                elif a.func == "sum":
                    cols.append(
                        _scalar_col(pc.sum(tbl.column(a.name)), self._field_for(a.name).type)
                    )
                elif a.func == "min":
                    cols.append(
                        _scalar_col(pc.min(tbl.column(a.name)), self._field_for(a.name).type)
                    )
                elif a.func == "max":
                    cols.append(
                        _scalar_col(pc.max(tbl.column(a.name)), self._field_for(a.name).type)
                    )
                else:
                    raise ExecutionError(f"unsupported aggregate {a.func}")
            return pa.Table.from_arrays(cols, schema=self._schema)

        agg_requests: list[tuple[str, str]] = []
        for a in self.aggs:
            if a.func == "avg":
                agg_requests.append((f"{a.name}#sum", "sum"))
                agg_requests.append((f"{a.name}#count", "sum"))
            elif a.func in ("count", "count_distinct"):
                agg_requests.append((a.name, "sum"))
            elif a.func == "sum":
                agg_requests.append((a.name, "sum"))
            elif a.func == "min":
                agg_requests.append((a.name, "min"))
            elif a.func == "max":
                agg_requests.append((a.name, "max"))
            else:
                raise ExecutionError(f"unsupported aggregate {a.func}")
        result = pa.TableGroupBy(tbl, gkeys).aggregate(agg_requests)

        out_cols: list = []
        for g in gkeys:
            out_cols.append(result.column(g))
        # merged columns are named "<src>_<func>"
        for a in self.aggs:
            f = self._field_for(a.name)
            if a.func == "avg":
                s = result.column(f"{a.name}#sum_sum")
                c = result.column(f"{a.name}#count_sum")
                col = pc.divide(pc.cast(s, pa.float64()), pc.cast(c, pa.float64()))
            elif a.func in ("count", "count_distinct"):
                col = result.column(f"{a.name}_sum")
            elif a.func == "sum":
                col = result.column(f"{a.name}_sum")
            elif a.func == "min":
                col = result.column(f"{a.name}_min")
            else:
                col = result.column(f"{a.name}_max")
            if not col.type.equals(f.type):
                col = pc.cast(col, f.type, safe=False)
            out_cols.append(col)
        return pa.Table.from_arrays(out_cols, schema=self._schema)


def _resolve_udaf(func: str):
    from ..udf import global_registry

    name = func[5:]  # strip "udaf:"
    u = global_registry().aggregate(name)
    if u is None:
        raise ExecutionError(
            f"aggregate UDF {name!r} is not registered on this executor; "
            f"load it via ballista.plugin_dir"
        )
    return u


def _finalize_corr(result: pa.Table, j: int) -> pa.Array:
    """Pearson r from the six per-group sums (pairwise-valid rows):
    r = (n·Σxy − Σx·Σy) / sqrt((n·Σxx − Σx²)(n·Σyy − Σy²));
    groups with n < 2 or zero variance yield null (pandas semantics)."""
    import numpy as np

    def col(name):
        return result.column(name).to_numpy(zero_copy_only=False).astype(
            np.float64
        )

    sx = col(f"__c{j}x_sum")
    sy = col(f"__c{j}y_sum")
    sxy = col(f"__c{j}xy_sum")
    sxx = col(f"__c{j}xx_sum")
    syy = col(f"__c{j}yy_sum")
    n = col(f"__c{j}x_count")
    with np.errstate(invalid="ignore", divide="ignore"):
        cov = n * sxy - sx * sy
        varx = n * sxx - sx * sx
        vary = n * syy - sy * sy
        r = cov / np.sqrt(varx * vary)
    bad = (n < 2) | ~np.isfinite(r)
    return pa.array(np.where(bad, np.nan, r), pa.float64(), from_pandas=True)


def _apply_udaf(spec: AggSpec, lists_col, out_type: pa.DataType) -> pa.ChunkedArray:
    """Fold each group's collected value-list through the UDAF callable."""
    u = _resolve_udaf(spec.func)
    values = [
        u.fn(lst.values if lst.is_valid else pa.array([], type=u.input_type))
        for lst in lists_col.combine_chunks()
    ]
    return pa.chunked_array([pa.array(values, type=out_type)])


def _scalar_col(s: pa.Scalar, t: pa.DataType) -> pa.Array:
    v = s.as_py()
    return pa.array([v], t)
