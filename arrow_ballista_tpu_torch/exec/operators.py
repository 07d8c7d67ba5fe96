"""Physical operators (CPU path).

Counterpart of DataFusion's ``ExecutionPlan`` operators as used by the
reference.  Operators are pull-based: ``execute(partition, ctx)`` yields
Arrow RecordBatches.  Per-operator metrics mirror the reference's
``MetricsSet`` (e.g. ``shuffle_writer.rs:89-106`` timers/counters).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..config import BallistaConfig
from ..errors import ExecutionError
from .expressions import PhysicalExpr


# ------------------------------------------------------------------- metrics
class Metrics:
    """Per-operator metric set (counters in ns / rows / bytes)."""

    def __init__(self) -> None:
        self.values: dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, v: int) -> None:
        with self._lock:
            self.values[name] = self.values.get(name, 0) + int(v)

    def timer(self, name: str) -> "_Timer":
        return _Timer(self, name)

    def to_dict(self) -> dict[str, int]:
        return dict(self.values)


class _Timer:
    def __init__(self, m: Metrics, name: str) -> None:
        self.m, self.name = m, name

    def __enter__(self) -> "_Timer":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.m.add(self.name, time.perf_counter_ns() - self.t0)


# -------------------------------------------------------------- partitioning
@dataclass(frozen=True)
class Partitioning:
    kind: str  # "unknown" | "hash" | "round_robin"
    n: int
    exprs: tuple[PhysicalExpr, ...] = ()

    @staticmethod
    def unknown(n: int) -> "Partitioning":
        return Partitioning("unknown", n)

    @staticmethod
    def hash(exprs: tuple[PhysicalExpr, ...], n: int) -> "Partitioning":
        return Partitioning("hash", n, exprs)


@dataclass
class TaskContext:
    """Session/runtime info handed to every operator execution.

    Reference: DataFusion TaskContext built in
    ``executor/src/executor_server.rs:321-328``.
    """

    session_id: str = "default"
    config: BallistaConfig = field(default_factory=BallistaConfig)
    work_dir: str = "/tmp/ballista-tpu"
    job_id: str = ""
    stage_id: int = 0
    # Cooperative cancellation: set by Executor.cancel_task, checked at batch
    # granularity by the stage driver (the Python analogue of the reference's
    # ``futures::abortable`` wrapper, executor/src/executor.rs:97-134).
    cancel_event: Optional[threading.Event] = None

    @property
    def batch_size(self) -> int:
        return self.config.batch_size

    def check_cancelled(self) -> None:
        if self.cancel_event is not None and self.cancel_event.is_set():
            from ..errors import Cancelled

            raise Cancelled("task cancelled")


class ExecutionPlan:
    """Base physical operator."""

    def __init__(self) -> None:
        self.metrics = Metrics()

    @property
    def schema(self) -> pa.Schema:
        raise NotImplementedError

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> list["ExecutionPlan"]:
        return []

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        raise NotImplementedError

    def with_new_children(self, children: list["ExecutionPlan"]) -> "ExecutionPlan":
        raise NotImplementedError

    def display(self, indent: int = 0, with_metrics: bool = False) -> str:
        line = "  " * indent + str(self)
        if with_metrics and self.metrics.values:
            line += f"  metrics={self.metrics.to_dict()}"
        for c in self.children():
            line += "\n" + c.display(indent + 1, with_metrics)
        return line

    def __str__(self) -> str:
        return type(self).__name__


def collect(plan: ExecutionPlan, ctx: Optional[TaskContext] = None) -> pa.Table:
    """Execute every partition and concatenate (reference: utils.rs:99-107)."""
    ctx = ctx or TaskContext()
    batches: list[pa.RecordBatch] = []
    for p in range(plan.output_partitioning().n):
        batches.extend(plan.execute(p, ctx))
    return pa.Table.from_batches(batches, schema=plan.schema)


# ------------------------------------------------------------------- scan
class ScanExec(ExecutionPlan):
    """Leaf scan over a TableProvider partition (csv/parquet/memory)."""

    def __init__(self, table_name: str, provider, projection: Optional[list[str]] = None):
        super().__init__()
        self.table_name = table_name
        self.provider = provider
        self.projection = projection

    @property
    def schema(self) -> pa.Schema:
        base = self.provider.schema
        if self.projection is not None:
            base = pa.schema([base.field(n) for n in self.projection])
        return pa.schema(
            [pa.field(f"{self.table_name}.{f.name}", f.type, f.nullable) for f in base]
        )

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(self.provider.num_partitions())

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        schema = self.schema
        with self.metrics.timer("scan_time_ns"):
            for b in self.provider.scan_partition(
                partition, self.projection, ctx.batch_size
            ):
                self.metrics.add("output_rows", b.num_rows)
                yield pa.RecordBatch.from_arrays(b.columns, schema=schema)

    def with_new_children(self, children):
        assert not children
        return self

    def __str__(self) -> str:
        proj = f" projection={self.projection}" if self.projection is not None else ""
        return f"ScanExec: {self.table_name}{proj}"


class EmptyExec(ExecutionPlan):
    def __init__(self, produce_one_row: bool, schema: pa.Schema):
        super().__init__()
        self._schema = schema
        self.produce_one_row = produce_one_row

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        if self.produce_one_row:
            if len(self._schema) == 0:
                # zero columns can't carry num_rows=1 in Arrow; emit a
                # placeholder column so `SELECT <literals>` (no FROM)
                # projects exactly one row
                yield pa.RecordBatch.from_arrays(
                    [pa.nulls(1, pa.null())],
                    schema=pa.schema([pa.field("__row", pa.null())]),
                )
                return
            arrays = [pa.nulls(1, f.type) for f in self._schema]
            yield pa.RecordBatch.from_arrays(arrays, schema=self._schema)

    def with_new_children(self, children):
        return self


# ------------------------------------------------------------------ filter
class FilterExec(ExecutionPlan):
    def __init__(self, predicate: PhysicalExpr, input: ExecutionPlan):
        super().__init__()
        self.predicate = predicate
        self.input = input

    @property
    def schema(self) -> pa.Schema:
        return self.input.schema

    def output_partitioning(self) -> Partitioning:
        return self.input.output_partitioning()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        for batch in self.input.execute(partition, ctx):
            with self.metrics.timer("filter_time_ns"):
                mask = self.predicate.evaluate(batch)
                out = batch.filter(mask)
            self.metrics.add("output_rows", out.num_rows)
            if out.num_rows:
                yield out

    def with_new_children(self, children):
        return FilterExec(self.predicate, children[0])

    def __str__(self) -> str:
        return f"FilterExec: {self.predicate}"


class ProjectionExec(ExecutionPlan):
    def __init__(self, exprs: list[tuple[PhysicalExpr, str]], input: ExecutionPlan):
        super().__init__()
        self.exprs = exprs
        self.input = input
        in_schema = input.schema
        self._schema = pa.schema(
            [pa.field(name, _infer_type(e, in_schema), True) for e, name in exprs]
        )

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return self.input.output_partitioning()

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        for batch in self.input.execute(partition, ctx):
            with self.metrics.timer("proj_time_ns"):
                cols = []
                for (e, name), f in zip(self.exprs, self._schema):
                    v = e.evaluate(batch)
                    if isinstance(v, pa.Scalar):
                        v = pa.nulls(batch.num_rows, f.type) if v.as_py() is None else pa.array([v.as_py()] * batch.num_rows, f.type)
                    if isinstance(v, pa.ChunkedArray):
                        v = v.combine_chunks()
                    if not v.type.equals(f.type):
                        v = pc.cast(v, f.type, safe=False)
                    cols.append(v)
            out = pa.RecordBatch.from_arrays(cols, schema=self._schema)
            self.metrics.add("output_rows", out.num_rows)
            yield out

    def with_new_children(self, children):
        return ProjectionExec(self.exprs, children[0])

    def __str__(self) -> str:
        return f"ProjectionExec: {[n for _, n in self.exprs]}"


def _infer_type(e: PhysicalExpr, schema: pa.Schema) -> pa.DataType:
    """Infer an expr's output type by evaluating it on an empty batch."""
    empty = pa.RecordBatch.from_arrays(
        [pa.nulls(0, f.type) for f in schema], schema=schema
    )
    v = e.evaluate(empty)
    if isinstance(v, pa.Scalar):
        return v.type
    return v.type


# Transient column name a device stage appends to its output batches when
# a downstream ShuffleWriterExec installed a shuffle hint: int32 partition
# ids computed by the jitted device hash (ops/kernels.py
# device_partition_ids).  The writer pops it before anything is persisted;
# it never appears in a written partition or a reader schema.
SHUFFLE_PID_COLUMN = "__shuffle_pid__"


# ----------------------------------------------------------- partition moves
class CoalescePartitionsExec(ExecutionPlan):
    """Merge all input partitions into one (reference: DataFusion's
    CoalescePartitionsExec — the stage-split trigger in planner.rs:97-125)."""

    def __init__(self, input: ExecutionPlan):
        super().__init__()
        self.input = input

    @property
    def schema(self) -> pa.Schema:
        return self.input.schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        assert partition == 0
        for p in range(self.input.output_partitioning().n):
            yield from self.input.execute(p, ctx)

    def with_new_children(self, children):
        return CoalescePartitionsExec(children[0])


def hash_partition_indices(
    batch: pa.RecordBatch, exprs: list[PhysicalExpr], n: int
) -> np.ndarray:
    """Deterministic hash of key columns → partition id per row.

    This is the Python counterpart of the native partitioner
    (native/partitioner.cc); both must produce identical assignments since
    map and reduce sides may run on different executors.
    """
    _NULL_HASH = np.uint64(0xA5A5A5A5DEADBEEF)
    h = np.zeros(batch.num_rows, dtype=np.uint64)
    for e in exprs:
        v = e.evaluate(batch)
        if isinstance(v, pa.ChunkedArray):
            v = v.combine_chunks()
        null_mask = np.asarray(pc.is_null(v)) if v.null_count else None
        if pa.types.is_string(v.type) or pa.types.is_large_string(v.type):
            enc = v.dictionary_encode()
            # hash dictionary values once, map through indices; value hashes
            # are content-based so identical keys in different batches (with
            # different dictionaries) still agree
            dvals = np.asarray(
                [hash_bytes(s.as_py().encode()) if s.is_valid else 0 for s in enc.dictionary],
                dtype=np.uint64,
            )
            codes = np.asarray(enc.indices.fill_null(0))
            hv = dvals[codes] if len(dvals) else np.zeros(batch.num_rows, np.uint64)
        else:
            if pa.types.is_date32(v.type):
                v = v.cast(pa.int32())
            elif pa.types.is_date64(v.type) or pa.types.is_timestamp(v.type):
                v = v.cast(pa.int64())
            elif pa.types.is_boolean(v.type):
                v = v.cast(pa.int8())
            if v.null_count:
                v = v.fill_null(0)
            x = np.asarray(v)
            if x.dtype.kind == "f":
                x = x.view(np.uint64) if x.dtype == np.float64 else x.astype(np.float64).view(np.uint64)
            else:
                x = x.astype(np.int64).view(np.uint64)
            hv = x * np.uint64(0x9E3779B97F4A7C15)
            hv ^= hv >> np.uint64(32)
        if null_mask is not None:
            # nulls form one group: constant hash regardless of batch/dict
            hv = np.where(null_mask, _NULL_HASH, hv)
        h = h * np.uint64(31) + hv
    return (h % np.uint64(n)).astype(np.int64)


def hash_bytes(b: bytes) -> int:
    h = 1469598103934665603  # FNV-1a 64
    for c in b:
        h = ((h ^ c) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def partition_permutation(
    idx: np.ndarray, n: int
) -> tuple[np.ndarray, np.ndarray]:
    """Stable partition permutation of ``idx`` (row -> partition id in
    [0, n)) as ``(order, bounds)``: ``idx[order]`` is sorted and rows
    ``order[bounds[p]:bounds[p+1]]`` belong to partition ``p``, in their
    original relative order.

    Counting-sort shape: ``bincount`` + ``cumsum`` produce the partition
    bounds in one O(n) pass (no searchsorted), and the permutation runs
    through numpy's radix path by narrowing the key to the smallest
    unsigned dtype that holds ``n`` — one or two counting passes over
    byte keys instead of the O(n log n) comparison argsort on int64
    (measured 4-7x faster at 1M rows).  Shared by every hash-split site
    (shuffle write, in-process repartition) so the map side has exactly
    one permutation code path.
    """
    counts = np.bincount(idx, minlength=n)
    bounds = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    if n <= 1 << 8:
        key = idx.astype(np.uint8)
    elif n <= 1 << 16:
        key = idx.astype(np.uint16)
    else:  # pragma: no cover - >65536 output partitions
        key = idx
    return np.argsort(key, kind="stable"), bounds


class RepartitionExec(ExecutionPlan):
    """In-process hash repartition (single-process mode only; distributed
    repartition happens at shuffle boundaries via ShuffleWriter/Reader)."""

    def __init__(self, input: ExecutionPlan, partitioning: Partitioning):
        super().__init__()
        self.input = input
        self.partitioning = partitioning
        self._cache: Optional[list[list[pa.RecordBatch]]] = None
        self._lock = threading.Lock()

    @property
    def schema(self) -> pa.Schema:
        return self.input.schema

    def output_partitioning(self) -> Partitioning:
        return self.partitioning

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def _materialize(self, ctx: TaskContext) -> list[list[pa.RecordBatch]]:
        with self._lock:
            if self._cache is not None:
                return self._cache
            n = self.partitioning.n
            buckets: list[list[pa.RecordBatch]] = [[] for _ in range(n)]
            for p in range(self.input.output_partitioning().n):
                for batch in self.input.execute(p, ctx):
                    if self.partitioning.kind == "hash":
                        idx = hash_partition_indices(
                            batch, list(self.partitioning.exprs), n
                        )
                        order, bounds = partition_permutation(idx, n)
                        tbl = batch.take(pa.array(order))
                        for b in range(n):
                            lo, hi = bounds[b], bounds[b + 1]
                            if hi > lo:
                                buckets[b].append(tbl.slice(lo, hi - lo))
                    else:  # round robin by batch
                        buckets[hash(batch.num_rows) % n].append(batch)
            self._cache = buckets
            return buckets

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        with self.metrics.timer("repart_time_ns"):
            buckets = self._materialize(ctx)
        for b in buckets[partition]:
            yield b

    def with_new_children(self, children):
        return RepartitionExec(children[0], self.partitioning)

    def __str__(self) -> str:
        return f"RepartitionExec: {self.partitioning.kind}({self.partitioning.n})"


# -------------------------------------------------------------- sort / limit
def sort_indices(table: pa.Table, keys: list[tuple[str, str, str]]) -> pa.Array:
    """Stable sort permutation of ``table`` by ``(column, order,
    null_placement)`` keys.  Each key's placement of nulls and NaNs (nulls
    outermost, then NaNs, as pyarrow places them) rides as a rank column
    sorted just before the key, so pyarrow releases without per-key null
    placement (24 and older take only ``(column, order)`` pairs) give the
    same order as those with it."""
    cols: dict = {}
    pairs: list[tuple[str, str]] = []
    for i, (name, order, nulls) in enumerate(keys):
        v = table.column(name)
        null = ~np.asarray(pc.is_valid(v))
        nan = np.zeros(len(null), dtype=bool)
        if pa.types.is_floating(v.type):
            nan = np.asarray(pc.fill_null(pc.is_nan(v), False))
        first, last = (0, 2) if nulls == "at_start" else (2, 0)
        rank = np.where(null, first, np.where(nan, 1, last)).astype(np.int8)
        cols[f"__nulls_{i}"] = pa.array(rank)
        cols[name] = v
        pairs += [(f"__nulls_{i}", "ascending"), (name, order)]
    return pc.sort_indices(pa.table(cols), sort_keys=pairs)


class SortExec(ExecutionPlan):
    def __init__(
        self,
        sort_keys: list[tuple[PhysicalExpr, bool, Optional[bool]]],  # expr, asc, nulls_first
        input: ExecutionPlan,
        fetch: Optional[int] = None,
    ):
        super().__init__()
        self.sort_keys = sort_keys
        self.input = input
        self.fetch = fetch

    @property
    def schema(self) -> pa.Schema:
        return self.input.schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        assert partition == 0
        # single-partition input is the planner's contract (a
        # CoalescePartitionsExec is inserted upstream when needed) so the
        # distributed planner can split the plan at that boundary
        batches = list(self.input.execute(0, ctx))
        if not batches:
            return
        with self.metrics.timer("sort_time_ns"):
            table = pa.Table.from_batches(batches, schema=self.schema)
            key_arrays = []
            names = []
            for i, (e, asc, nf) in enumerate(self.sort_keys):
                v = pa.chunked_array([e.evaluate(b) for b in batches]) if len(batches) > 1 else e.evaluate(batches[0])
                if isinstance(v, pa.Scalar):
                    v = pa.array([v.as_py()] * table.num_rows)
                names.append(f"__sort_{i}")
                key_arrays.append(v)
            sort_tbl = pa.table(dict(zip(names, key_arrays)))
            keys = []
            for n, (_, asc, nf) in zip(names, self.sort_keys):
                if nf is None:
                    nf = not asc  # SQL default: NULLS LAST for ASC, FIRST for DESC
                keys.append(
                    (n, "ascending" if asc else "descending",
                     "at_start" if nf else "at_end")
                )
            indices = sort_indices(sort_tbl, keys)
            if self.fetch is not None:
                indices = indices.slice(0, self.fetch)
            out = table.take(indices).combine_chunks()
        self.metrics.add("output_rows", out.num_rows)
        for b in out.to_batches(max_chunksize=ctx.batch_size):
            yield b

    def with_new_children(self, children):
        return SortExec(self.sort_keys, children[0], self.fetch)

    def __str__(self) -> str:
        return f"SortExec: fetch={self.fetch}"


class LimitExec(ExecutionPlan):
    """Global limit; requires single input partition."""

    def __init__(self, input: ExecutionPlan, skip: int = 0, fetch: Optional[int] = None):
        super().__init__()
        self.input = input
        self.skip = skip
        self.fetch = fetch

    @property
    def schema(self) -> pa.Schema:
        return self.input.schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        assert partition == 0
        remaining_skip = self.skip
        remaining = self.fetch if self.fetch is not None else None
        for batch in self.input.execute(0, ctx):
            if remaining_skip:
                if batch.num_rows <= remaining_skip:
                    remaining_skip -= batch.num_rows
                    continue
                batch = batch.slice(remaining_skip)
                remaining_skip = 0
            if remaining is not None:
                if remaining <= 0:
                    return
                if batch.num_rows > remaining:
                    batch = batch.slice(0, remaining)
                remaining -= batch.num_rows
            self.metrics.add("output_rows", batch.num_rows)
            yield batch

    def with_new_children(self, children):
        return LimitExec(children[0], self.skip, self.fetch)

    def __str__(self) -> str:
        return f"LimitExec: skip={self.skip} fetch={self.fetch}"


class UnionExec(ExecutionPlan):
    def __init__(self, inputs: list[ExecutionPlan]):
        super().__init__()
        self.inputs = inputs

    @property
    def schema(self) -> pa.Schema:
        return self.inputs[0].schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(
            sum(i.output_partitioning().n for i in self.inputs)
        )

    def children(self) -> list[ExecutionPlan]:
        return list(self.inputs)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        off = 0
        schema = self.schema
        for inp in self.inputs:
            n = inp.output_partitioning().n
            if partition < off + n:
                for b in inp.execute(partition - off, ctx):
                    # align column names positionally
                    yield pa.RecordBatch.from_arrays(b.columns, schema=schema)
                return
            off += n
        raise ExecutionError(f"union partition {partition} out of range")

    def with_new_children(self, children):
        return UnionExec(children)
