"""Hash join operator.

Counterpart of DataFusion's HashJoinExec as serialized by the reference
(``core/proto/ballista.proto:265-278``), with both partition modes:
``Partitioned`` (both sides hash-repartitioned on keys) and ``CollectLeft``
(build side broadcast — reference PartitionMode::COLLECT_LEFT).

The CPU implementation computes matching (left_index, right_index) pairs via
acero on index-augmented key tables, then gathers both sides; this keeps
exact control of output schema/order and maps 1:1 onto the TPU join kernel's
gather-based design.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..errors import NotImplementedYet
from .expressions import PhysicalExpr
from .operators import ExecutionPlan, Partitioning, TaskContext

PARTITIONED = "partitioned"
COLLECT_LEFT = "collect_left"

_ACERO_TYPE = {
    "inner": "inner",
    "left": "left outer",
    "right": "right outer",
    "full": "full outer",
    "semi": "left semi",
    "anti": "left anti",
}


class HashJoinExec(ExecutionPlan):
    def __init__(
        self,
        left: ExecutionPlan,
        right: ExecutionPlan,
        on: list[tuple[PhysicalExpr, PhysicalExpr]],
        join_type: str = "inner",
        partition_mode: str = PARTITIONED,
        filter: Optional[PhysicalExpr] = None,
    ):
        super().__init__()
        self.left = left
        self.right = right
        self.on = on
        self.join_type = join_type
        self.partition_mode = partition_mode
        self.filter = filter
        self._collect_left_cache: Optional[pa.Table] = None
        self._lock = threading.Lock()

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

    def output_partitioning(self) -> Partitioning:
        if self.partition_mode == COLLECT_LEFT:
            return self.right.output_partitioning()
        return self.left.output_partitioning()

    def children(self) -> list[ExecutionPlan]:
        return [self.left, self.right]

    def with_new_children(self, children):
        return HashJoinExec(
            children[0], children[1], self.on, self.join_type,
            self.partition_mode, self.filter,
        )

    def as_collect_left(
        self, left: Optional[ExecutionPlan] = None,
        right: Optional[ExecutionPlan] = None,
    ) -> "HashJoinExec":
        """This join rebuilt in COLLECT_LEFT (build-side broadcast) mode,
        optionally with replacement inputs — the AQE shuffle→broadcast
        conversion (scheduler/adaptive.py) swaps the probe-side shuffle
        read for the producer's inlined subtree.  Only valid for inner
        joins: broadcasting the build side against each probe partition
        would emit per-partition unmatched/duplicate rows for any other
        type (see the physical planner's mode selection)."""
        assert self.join_type == "inner", "COLLECT_LEFT requires an inner join"
        return HashJoinExec(
            left if left is not None else self.left,
            right if right is not None else self.right,
            self.on, self.join_type, COLLECT_LEFT, self.filter,
        )

    def __str__(self) -> str:
        on = ", ".join(f"{l}={r}" for l, r in self.on)
        return (
            f"HashJoinExec: type={self.join_type}, mode={self.partition_mode}, on=[{on}]"
        )

    # ------------------------------------------------------------ execution
    def _collect_side(
        self, side: ExecutionPlan, partition: Optional[int], ctx: TaskContext
    ) -> pa.Table:
        batches: list[pa.RecordBatch] = []
        if partition is None:
            for p in range(side.output_partitioning().n):
                batches.extend(side.execute(p, ctx))
        else:
            batches.extend(side.execute(partition, ctx))
        return pa.Table.from_batches(batches, schema=side.schema)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        if self.partition_mode == COLLECT_LEFT:
            with self._lock:
                if self._collect_left_cache is None:
                    with self.metrics.timer("build_time_ns"):
                        self._collect_left_cache = self._collect_side(
                            self.left, None, ctx
                        )
            left_tbl = self._collect_left_cache
            right_tbl = self._collect_side(self.right, partition, ctx)
        else:
            with self.metrics.timer("build_time_ns"):
                left_tbl = self._collect_side(self.left, partition, ctx)
            right_tbl = self._collect_side(self.right, partition, ctx)

        with self.metrics.timer("join_time_ns"):
            out = self._join_tables(left_tbl, right_tbl)
        self.metrics.add("output_rows", out.num_rows)
        for b in out.to_batches(max_chunksize=ctx.batch_size):
            yield b

    def _key_table(
        self, tbl: pa.Table, exprs: list[PhysicalExpr], idx_name: str
    ) -> pa.Table:
        cols: dict[str, pa.ChunkedArray] = {}
        batches = tbl.to_batches() if tbl.num_rows else [
            pa.RecordBatch.from_arrays([pa.nulls(0, f.type) for f in tbl.schema], schema=tbl.schema)
        ]
        for i, e in enumerate(exprs):
            vals = [e.evaluate(b) for b in batches]
            cols[f"__k{i}"] = pa.chunked_array(
                [v.combine_chunks() if isinstance(v, pa.ChunkedArray) else v for v in vals]
            )
        cols[idx_name] = pa.chunked_array([pa.array(np.arange(tbl.num_rows, dtype=np.int64))])
        return pa.table(cols)

    def _join_tables(self, left: pa.Table, right: pa.Table) -> pa.Table:
        lkeys = self._key_table(left, [l for l, _ in self.on], "__li")
        rkeys = self._key_table(right, [r for _, r in self.on], "__ri")
        keys = [f"__k{i}" for i in range(len(self.on))]
        schema = self.schema

        jt = self.join_type
        if jt in ("semi", "anti") and self.filter is None:
            idx = lkeys.join(rkeys, keys=keys, join_type=_ACERO_TYPE[jt])
            li = idx.column("__li")
            out = left.take(li)
            return out.combine_chunks().cast(schema)

        if jt in ("semi", "anti") and self.filter is not None:
            pairs = lkeys.join(rkeys, keys=keys, join_type="inner")
            joined = _gather_pair(left, right, pairs, pa.schema(list(left.schema) + list(right.schema)))
            mask = self.filter.evaluate(_as_batch(joined))
            matched_li = pairs.column("__li").filter(mask)
            matched = np.unique(np.asarray(matched_li))
            if jt == "semi":
                take = matched
            else:
                all_idx = np.arange(left.num_rows, dtype=np.int64)
                take = np.setdiff1d(all_idx, matched, assume_unique=False)
            return left.take(pa.array(take)).combine_chunks().cast(schema)

        if jt in ("left", "right", "full") and self.filter is not None:
            # Residual filter on an outer join (e.g. TPC-H q13's ON-clause
            # `not like` predicate): the filter applies to *matched* pairs
            # only — rows of the preserved side whose every match fails the
            # filter still appear once, null-padded.  Reference semantics:
            # DataFusion JoinFilter on HashJoinExec (ballista.proto:265-278).
            pairs = lkeys.join(rkeys, keys=keys, join_type="inner")
            inner_schema = pa.schema(list(self.left.schema) + list(self.right.schema))
            joined = _gather_pair(left, right, pairs, inner_schema)
            mask = pc.fill_null(self.filter.evaluate(_as_batch(joined)), False)
            pairs = pairs.filter(mask)
            li = np.asarray(pairs.column("__li"), dtype=np.int64)
            ri = np.asarray(pairs.column("__ri"), dtype=np.int64)
            li_parts, ri_parts = [li], [ri]
            li_mask_parts = [np.zeros(len(li), dtype=bool)]
            ri_mask_parts = [np.zeros(len(ri), dtype=bool)]
            if jt in ("left", "full"):
                lonely = np.setdiff1d(np.arange(left.num_rows, dtype=np.int64), li)
                li_parts.append(lonely)
                ri_parts.append(np.zeros(len(lonely), dtype=np.int64))
                li_mask_parts.append(np.zeros(len(lonely), dtype=bool))
                ri_mask_parts.append(np.ones(len(lonely), dtype=bool))
            if jt in ("right", "full"):
                lonely = np.setdiff1d(np.arange(right.num_rows, dtype=np.int64), ri)
                li_parts.append(np.zeros(len(lonely), dtype=np.int64))
                ri_parts.append(lonely)
                li_mask_parts.append(np.ones(len(lonely), dtype=bool))
                ri_mask_parts.append(np.zeros(len(lonely), dtype=bool))
            padded = pa.table(
                {
                    "__li": pa.array(
                        np.concatenate(li_parts), mask=np.concatenate(li_mask_parts)
                    ),
                    "__ri": pa.array(
                        np.concatenate(ri_parts), mask=np.concatenate(ri_mask_parts)
                    ),
                }
            )
            return _gather_pair(left, right, padded, schema)

        pairs = lkeys.join(rkeys, keys=keys, join_type=_ACERO_TYPE[jt])
        out = _gather_pair(left, right, pairs, schema)
        if self.filter is not None:
            mask = self.filter.evaluate(_as_batch(out))
            out = out.filter(mask)
        return out

    # TPU note: the device-side join kernel replaces acero's hash table with
    # a sorted-merge over hashed keys (ops/kernels.py) — same (li, ri) pair
    # contract, so this operator is the single source of join semantics.


def _gather_pair(
    left: pa.Table, right: pa.Table, pairs: pa.Table, schema: pa.Schema
) -> pa.Table:
    li = pairs.column("__li")
    ri = pairs.column("__ri")
    lcols = [left.column(i).take(li) for i in range(left.num_columns)]
    rcols = [right.column(i).take(ri) for i in range(right.num_columns)]
    cols = lcols + rcols
    cols = [
        c if c.type.equals(f.type) else pc.cast(c, f.type, safe=False)
        for c, f in zip(cols, schema)
    ]
    return pa.Table.from_arrays(cols, schema=schema)


def _as_batch(tbl: pa.Table) -> pa.RecordBatch:
    tbl = tbl.combine_chunks()
    if tbl.num_rows == 0:
        return pa.RecordBatch.from_arrays(
            [pa.nulls(0, f.type) for f in tbl.schema], schema=tbl.schema
        )
    return tbl.to_batches()[0]


class CrossJoinExec(ExecutionPlan):
    """Cartesian product; left side collected, right side streamed."""

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan):
        super().__init__()
        self.left = left
        self.right = right
        self._left_cache: Optional[pa.Table] = None
        self._lock = threading.Lock()

    @property
    def schema(self) -> pa.Schema:
        return pa.schema(list(self.left.schema) + list(self.right.schema))

    def output_partitioning(self) -> Partitioning:
        return self.right.output_partitioning()

    def children(self) -> list[ExecutionPlan]:
        return [self.left, self.right]

    def with_new_children(self, children):
        return CrossJoinExec(children[0], children[1])

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        with self._lock:
            if self._left_cache is None:
                batches: list[pa.RecordBatch] = []
                for p in range(self.left.output_partitioning().n):
                    batches.extend(self.left.execute(p, ctx))
                self._left_cache = pa.Table.from_batches(
                    batches, schema=self.left.schema
                )
        left = self._left_cache
        nl = left.num_rows
        schema = self.schema
        for rb in self.right.execute(partition, ctx):
            nr = rb.num_rows
            if nr == 0 or nl == 0:
                continue
            li = pa.array(np.repeat(np.arange(nl, dtype=np.int64), nr))
            ri = pa.array(np.tile(np.arange(nr, dtype=np.int64), nl))
            lcols = [left.column(i).take(li) for i in range(left.num_columns)]
            rcols = [rb.column(i).take(ri) for i in range(rb.num_columns)]
            out = pa.Table.from_arrays(lcols + rcols, schema=schema)
            self.metrics.add("output_rows", out.num_rows)
            for b in out.to_batches(max_chunksize=ctx.batch_size):
                yield b
