"""Distributed shuffle operators.

Counterparts of the reference's ``core/src/execution_plans/{shuffle_writer,
shuffle_reader,unresolved_shuffle}.rs``:

* :class:`ShuffleWriterExec` — stage-root operator; executes the stage
  subplan for one input partition, hash-repartitions batches, persists each
  output partition as an Arrow IPC file under
  ``work_dir/<job>/<stage>/<out_part>/data-<in_part>.arrow`` and returns
  per-partition :class:`ShuffleWritePartition` stats.
* :class:`ShuffleReaderExec` — leaf operator of downstream stages; fetches
  the map-side partitions (local file fast path, Arrow Flight otherwise).
* :class:`UnresolvedShuffleExec` — placeholder leaf marking a dependency on
  a not-yet-completed stage; refuses to execute.

Hash partitioning runs through the native C++ kernel when available
(:mod:`arrow_ballista_tpu_torch.native`), falling back to the vectorized numpy
implementation; both produce identical assignments by construction.
"""

from __future__ import annotations

import logging
import os
from typing import TYPE_CHECKING, Iterator, Optional

import pyarrow as pa

from ..errors import ExecutionError
from ..exec.expressions import PhysicalExpr
from ..exec.operators import (
    ExecutionPlan,
    Partitioning,
    TaskContext,
    hash_partition_indices,
)

if TYPE_CHECKING:  # runtime import is lazy: serde.physical_plan imports
    # THIS module back, and an eager import here made the package cycle
    # unenterable from the shuffle side (ImportError when
    # arrow_ballista_tpu_torch.shuffle was the first package imported)
    from ..serde.scheduler_types import PartitionLocation, ShuffleWritePartition

try:  # native partitioner (C++); optional
    from ..native import native_hash_partition_indices
except Exception:  # pragma: no cover - toolchain-less environments
    native_hash_partition_indices = None

log = logging.getLogger(__name__)


def partition_indices(batch: pa.RecordBatch, exprs: list[PhysicalExpr], n: int):
    """Partition id per row; native kernel with Python fallback."""
    if native_hash_partition_indices is not None:
        out = native_hash_partition_indices(batch, exprs, n)
        if out is not None:
            return out
    return hash_partition_indices(batch, exprs, n)


# The stats schema ShuffleWriterExec yields from execute() — one row per
# written output partition (reference: shuffle_writer.rs:295+ returns an
# equivalent stats batch).
WRITE_STATS_SCHEMA = pa.schema(
    [
        pa.field("partition_id", pa.int64()),
        pa.field("path", pa.string()),
        pa.field("num_batches", pa.int64()),
        pa.field("num_rows", pa.int64()),
        pa.field("num_bytes", pa.int64()),
    ]
)


class _IpcFileSink:
    """Arrow IPC file writer with write stats (reference:
    core/src/utils.rs:60-97 write_stream_to_disk).

    ``options`` enables IPC body compression; ``ensure_dir`` is the write
    task's memoized mkdir (one syscall per output-partition dir instead
    of one per sink).  ``wire_bytes`` is set by :meth:`close` — None
    means the OS handle may still be open (the writer pool's abort path
    keys off it)."""

    def __init__(
        self,
        path: str,
        schema: pa.Schema,
        options=None,
        ensure_dir=None,
    ):
        d = os.path.dirname(path)
        if ensure_dir is not None:
            ensure_dir(d)
        else:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self.num_rows = 0
        self.num_batches = 0
        self.wire_bytes: Optional[int] = None
        self.replica_path = ""  # set post-close by the replication hook
        self._sink = pa.OSFile(path, "wb")
        try:
            self._writer = pa.ipc.new_file(self._sink, schema, options=options)
        except BaseException:
            self._sink.close()
            raise

    def write(self, batch: pa.RecordBatch) -> None:
        self._writer.write_batch(batch)
        self.num_rows += batch.num_rows
        self.num_batches += 1

    def close(self) -> int:
        # try/finally: a failed footer write (disk full, injected fault)
        # must still release the OS file handle — a leaked fd per retry
        # starves the executor of descriptors long before it fails tasks
        try:
            self._writer.close()
        finally:
            self._sink.close()
        self.wire_bytes = os.path.getsize(self.path)
        return self.wire_bytes

    def abandon(self) -> None:
        """Failed-task teardown: release the OS handle and delete the
        partial file.  Closing the IPC writer leaves a READABLE file
        (valid footer over the batches written so far) at the canonical
        partition path — if it survived, a drain-time upload would
        publish it as a complete replica and a consumer would silently
        read fewer rows."""
        try:
            self._writer.close()
        except Exception:  # noqa: BLE001 - handle release is what matters
            pass
        finally:
            self._sink.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass


class _MemSink:
    """Memory-store sink with the same stats interface as _IpcFileSink.

    TPU-first data plane: gang-stage outputs (and, with
    ``ballista.shuffle.to_memory``, every shuffle partition) stay in
    executor RAM and stream out of the Flight service without disk I/O.
    Batches serialize into the IPC stream buffer AS THEY ARRIVE — the
    partition is never held twice (batch list + serialized bytes), so
    peak memory is the partition's wire size, not 2x its raw size.
    """

    def __init__(
        self, job_id: str, stage_id: int, out_part: int, in_part: int,
        schema: pa.Schema, options=None,
    ):
        from . import memory_store

        self.path = memory_store.make_path(job_id, stage_id, out_part, in_part)
        self._key = (job_id, stage_id, out_part, in_part)
        self.num_rows = 0
        self.num_batches = 0
        self.wire_bytes: Optional[int] = None
        self.replica_path = ""  # set post-close by the replication hook
        self.serialized: Optional[pa.Buffer] = None  # the closed IPC bytes
        self._buf = pa.BufferOutputStream()
        self._writer = pa.ipc.new_stream(self._buf, schema, options=options)

    def write(self, batch: pa.RecordBatch) -> None:
        self._writer.write_batch(batch)
        self.num_rows += batch.num_rows
        self.num_batches += 1

    def close(self) -> int:
        from . import memory_store

        self._writer.close()
        buf = self._buf.getvalue()
        # keep the reference for the replication hook: the store holds the
        # same buffer, so this pins no extra memory
        self.serialized = buf
        memory_store.put_buffer(*self._key, buf)
        self.wire_bytes = memory_store.put_size(self.path)
        return self.wire_bytes

    def abandon(self) -> None:
        """Failed-task teardown: drop the buffer WITHOUT publishing — a
        partial partition stored under the canonical mem:// key would
        shadow the retry's real output."""
        try:
            self._writer.close()
        except Exception:  # noqa: BLE001
            pass


class ShuffleWriterExec(ExecutionPlan):
    def __init__(
        self,
        job_id: str,
        stage_id: int,
        input: ExecutionPlan,
        work_dir: str,
        shuffle_output_partitioning: Optional[Partitioning] = None,
    ):
        super().__init__()
        self.job_id = job_id
        self.stage_id = stage_id
        self.input = input
        self.work_dir = work_dir
        self.shuffle_output_partitioning = shuffle_output_partitioning
        # True only after THIS writer asked its input stage for device
        # partition ids — the pid-column pop is gated on it so a user
        # column that happens to be named __shuffle_pid__ is never eaten
        self._hint_installed = False

    @property
    def schema(self) -> pa.Schema:
        return WRITE_STATS_SCHEMA

    @property
    def input_schema(self) -> pa.Schema:
        return self.input.schema

    def output_partitioning(self) -> Partitioning:
        # one write task per *input* partition
        return Partitioning.unknown(self.input.output_partitioning().n)

    def children(self) -> list[ExecutionPlan]:
        return [self.input]

    def with_new_children(self, children):
        return ShuffleWriterExec(
            self.job_id,
            self.stage_id,
            children[0],
            self.work_dir,
            self.shuffle_output_partitioning,
        )

    def _store_kind(self, policy) -> str:
        """Resolve the shuffle store for this write:
        ``ballista.shuffle.store`` (with the legacy ``shuffle.to_memory``
        folded in by WritePolicy.from_config).  The mesh stages, which
        the reference keeps in memory, are not ported."""
        return policy.store

    def _stage_base_dir(self, kind: str, policy) -> str:
        """Root under which this stage's partition files land: the shared
        external store when it IS the primary, the executor work_dir
        otherwise."""
        return policy.external_path if kind == "external" else self.work_dir

    def _replicate_hook(self):
        """Post-close replication hook for sinks (None when replication
        is off).  Runs on writer-pool threads (pipelined path) or inline
        (legacy path); NEVER raises — a failed upload degrades to a
        single copy and the task still completes (the recompute path
        covers a later loss)."""
        policy = self._policy(None)
        if not policy.replicate:
            return None
        from . import store as shuffle_store

        sync = policy.replication == "sync"

        def replicate(sink) -> None:
            try:
                if sink is None or getattr(sink, "wire_bytes", None) is None:
                    return  # never closed: nothing durable to copy
                dest = shuffle_store.external_replica_path(
                    policy.external_path, sink.path
                )
                if dest is None:
                    return
                buf = getattr(sink, "serialized", None)
                if sync:
                    if buf is not None:
                        shuffle_store.upload_buffer(buf, dest)
                    else:
                        shuffle_store.upload_file(sink.path, dest)
                elif buf is not None:
                    shuffle_store.replicator().submit_buffer(buf, dest)
                else:
                    shuffle_store.replicator().submit_file(sink.path, dest)
                # async reports the destination optimistically: a failed
                # background upload leaves a dangling replica_path, which
                # the fetch failover treats as one more miss before the
                # recompute path fires
                sink.replica_path = dest
                self.metrics.add("replicas_written", 1)
            except Exception as e:  # noqa: BLE001 - degrade to single copy
                shuffle_store.count_upload_failure()
                self.metrics.add("replica_upload_failures", 1)
                log.warning(
                    "replica upload of %s failed (single copy only): %s",
                    getattr(sink, "path", sink),
                    e,
                )

        return replicate

    def _dir_memo(self):
        """Memoized mkdir for this write task: one ``os.makedirs`` per
        output-partition directory instead of one per sink.  Workers of
        the writer pool shard partitions, so a duplicate check-then-add
        race costs at most one extra (idempotent) makedirs."""
        made: set = set()

        def ensure(d: str) -> None:
            if d not in made:
                os.makedirs(d, exist_ok=True)
                made.add(d)

        return ensure

    def _sink(
        self, to_mem: bool, stage_dir: str, out_part: int, in_part: int,
        schema: pa.Schema, single_file: bool, options=None, ensure_dir=None,
    ):
        if to_mem:
            return _MemSink(
                self.job_id, self.stage_id, out_part, in_part, schema,
                options=options,
            )
        name = "data.arrow" if single_file else f"data-{in_part}.arrow"
        return _IpcFileSink(
            os.path.join(stage_dir, str(out_part), name), schema,
            options=options, ensure_dir=ensure_dir,
        )

    def _sink_factory(
        self, to_mem: bool, stage_dir: str, in_part: int, schema: pa.Schema,
        single_file: bool = False, fixed_out: Optional[int] = None,
    ):
        """Per-output-partition sink factory for the async writer pool —
        invoked on the pool's threads, so opens/mkdirs stay off the
        compute thread."""
        from .writer import ipc_write_options

        options = ipc_write_options(self._policy(None).compression)
        ensure_dir = self._dir_memo()

        def factory(out_part: int):
            p = fixed_out if fixed_out is not None else out_part
            return self._sink(
                to_mem, stage_dir, p, in_part, schema, single_file,
                options=options, ensure_dir=ensure_dir,
            )

        return factory

    def _policy(self, ctx: Optional[TaskContext]):
        from .writer import WritePolicy

        if ctx is not None:
            self._write_policy = WritePolicy.from_config(ctx.config)
        return getattr(self, "_write_policy", None) or WritePolicy()

    # ------------------------------------------------------------- core
    def execute_shuffle_write(
        self, input_partition: int, ctx: TaskContext
    ) -> list[ShuffleWritePartition]:
        """Run the stage subplan for ``input_partition`` and persist its
        output (reference: shuffle_writer.rs:142-292) through the
        slab-buffered async writer pool (``shuffle/writer.py``); the
        pre-pipelining synchronous path stays callable via
        ``ballista.shuffle.write_pipelined=false`` (A/B baseline)."""
        part = self.shuffle_output_partitioning
        policy = self._policy(ctx)
        kind = self._store_kind(policy)
        to_mem = kind == "mem"
        stage_dir = os.path.join(
            self._stage_base_dir(kind, policy), self.job_id, str(self.stage_id)
        )

        if part is None:
            return self._single_sink_write(
                input_partition, ctx, stage_dir, to_mem, policy.pipelined
            )

        if part.kind != "hash":
            raise ExecutionError(f"unsupported shuffle partitioning {part.kind}")

        if not policy.pipelined:
            sinks: list = [None] * part.n
            for batch in self.input.execute(input_partition, ctx):
                ctx.check_cancelled()
                self._hash_split_into_sinks(
                    batch, part, sinks, to_mem, stage_dir, input_partition
                )
            return self._close_sinks(
                sinks, to_mem, stage_dir, input_partition, self.input.schema
            )

        # device stages compute the hash on device and attach the pid
        # column; every other input hashes on host inside the split
        if hasattr(self.input, "install_shuffle_hint"):
            self.input.install_shuffle_hint(list(part.exprs), part.n)
            self._hint_installed = True

        def batches():
            for batch in self.input.execute(input_partition, ctx):
                ctx.check_cancelled()
                yield batch

        return self._pipelined_hash_write(
            batches(), part, ctx, stage_dir, to_mem, input_partition
        )

    def _single_sink_write(
        self, input_partition: int, ctx: TaskContext, stage_dir: str,
        to_mem: bool, pipelined: bool,
    ) -> list[ShuffleWritePartition]:
        """No repartition: one output sink for this input partition."""
        from ..serde.scheduler_types import ShuffleWritePartition

        if pipelined:
            from .writer import AsyncShuffleWriter

            writer = AsyncShuffleWriter(
                1,
                self._sink_factory(
                    to_mem, stage_dir, input_partition, self.input.schema,
                    single_file=True, fixed_out=input_partition,
                ),
                self._policy(None),
                self.metrics,
                cancel_event=ctx.cancel_event,
                replicate_fn=self._replicate_hook(),
            )
            try:
                for batch in self.input.execute(input_partition, ctx):
                    ctx.check_cancelled()
                    writer.append(0, batch)
                (sink,) = writer.finish()
            except BaseException:
                writer.abort()
                raise
            self.metrics.add("output_rows", sink.num_rows)
            return [
                ShuffleWritePartition(
                    input_partition, sink.path, sink.num_batches,
                    sink.num_rows, sink.wire_bytes,
                    replica_path=sink.replica_path,
                )
            ]
        sink = None
        replicate = self._replicate_hook()
        with self.metrics.timer("write_time_ns"):
            for batch in self.input.execute(input_partition, ctx):
                ctx.check_cancelled()
                if sink is None:
                    sink = self._sink(
                        to_mem, stage_dir, input_partition,
                        input_partition, batch.schema, True,
                    )
                sink.write(batch)
            if sink is None:
                sink = self._sink(
                    to_mem, stage_dir, input_partition, input_partition,
                    self.input.schema, True,
                )
            nbytes = sink.close()
        if replicate is not None:
            replicate(sink)
        self.metrics.add("output_rows", sink.num_rows)
        return [
            ShuffleWritePartition(
                input_partition, sink.path, sink.num_batches, sink.num_rows,
                nbytes, replica_path=sink.replica_path,
            )
        ]

    def _pipelined_hash_write(
        self, batch_iter, part: Partitioning, ctx: TaskContext,
        stage_dir: str, to_mem: bool, in_part: int,
        schema: Optional[pa.Schema] = None,
    ) -> list[ShuffleWritePartition]:
        """Hash-split a batch stream into the async writer pool: the
        compute thread pays only the O(n) counting-sort permutation and
        one ``take`` per batch; slab coalescing, IPC serialization
        (+compression) and sink I/O run on the pool."""
        from .writer import AsyncShuffleWriter

        writer = AsyncShuffleWriter(
            part.n,
            self._sink_factory(
                to_mem, stage_dir, in_part,
                schema if schema is not None else self.input.schema,
            ),
            self._policy(None),
            self.metrics,
            cancel_event=ctx.cancel_event,
            replicate_fn=self._replicate_hook(),
        )
        try:
            for batch in batch_iter:
                self._split_into_writer(batch, part, writer)
            sinks = writer.finish()
        except BaseException:
            writer.abort()
            raise
        return self._stats_from_sinks(sinks)

    def _split_into_writer(
        self, batch: pa.RecordBatch, part: Partitioning, writer
    ) -> None:
        from ..exec.operators import partition_permutation

        n_out = part.n
        with self.metrics.timer("repart_time_ns"):
            batch, idx = self._partition_ids(batch, part)
            if batch.num_rows == 0:
                return
            order, bounds = partition_permutation(idx, n_out)
        # no `take` here: the per-partition row gathers run on the pool
        # threads at slab-flush time (writer.append_rows), so the compute
        # thread never pays a row copy
        for p in range(n_out):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            if hi > lo:
                writer.append_rows(p, batch, order[lo:hi])

    def _partition_ids(self, batch: pa.RecordBatch, part: Partitioning):
        """(payload batch, partition id per row): pop the device-computed
        pid column when the input stage attached one (install_shuffle_hint),
        else run the host/native partitioner."""
        import numpy as np

        from ..exec.operators import SHUFFLE_PID_COLUMN

        ncols = batch.num_columns
        if (
            self._hint_installed
            and ncols
            and batch.schema.field(ncols - 1).name == SHUFFLE_PID_COLUMN
        ):
            idx = np.asarray(batch.column(ncols - 1)).astype(np.int64)
            self.metrics.add("device_pid_batches", 1)
            return batch.select(range(ncols - 1)), idx
        return batch, partition_indices(batch, list(part.exprs), part.n)

    def _stats_from_sinks(self, sinks: list) -> list[ShuffleWritePartition]:
        from ..serde.scheduler_types import ShuffleWritePartition

        out = []
        for p, s in enumerate(sinks):
            self.metrics.add("output_rows", s.num_rows)
            out.append(
                ShuffleWritePartition(
                    p, s.path, s.num_batches, s.num_rows, s.wire_bytes,
                    replica_path=s.replica_path,
                )
            )
        return out

    def _hash_split_into_sinks(
        self, batch, part: Partitioning, sinks: list, to_mem: bool,
        stage_dir: str, in_part: int,
    ) -> None:
        """Pre-pipelining hash split (the reference hot loop,
        shuffle_writer.rs:201-285): argsort permutation + one synchronous
        uncoalesced sink write per split run.  Kept as the measured A/B
        baseline behind ``ballista.shuffle.write_pipelined=false``."""
        import numpy as np

        n_out = part.n
        with self.metrics.timer("repart_time_ns"):
            idx = partition_indices(batch, list(part.exprs), n_out)
            order = np.argsort(idx, kind="stable")
            sorted_idx = idx[order]
            shuffled = batch.take(pa.array(order))
            bounds = np.searchsorted(sorted_idx, np.arange(n_out + 1))
        with self.metrics.timer("write_time_ns"):
            for p in range(n_out):
                lo, hi = int(bounds[p]), int(bounds[p + 1])
                if hi <= lo:
                    continue
                if sinks[p] is None:
                    sinks[p] = self._sink(
                        to_mem, stage_dir, p, in_part, batch.schema, False
                    )
                sinks[p].write(shuffled.slice(lo, hi - lo))

    def _close_sinks(
        self, sinks: list, to_mem: bool, stage_dir: str, in_part: int,
        in_schema: pa.Schema,
    ) -> list[ShuffleWritePartition]:
        """Close every partition sink (creating empty ones so readers need
        no existence probe) and assemble the write stats."""
        from ..serde.scheduler_types import ShuffleWritePartition

        out = []
        replicate = self._replicate_hook()
        with self.metrics.timer("write_time_ns"):
            for p in range(len(sinks)):
                s = sinks[p]
                if s is None:
                    s = self._sink(
                        to_mem, stage_dir, p, in_part, in_schema, False
                    )
                nbytes = s.close()
                if replicate is not None:
                    replicate(s)
                self.metrics.add("output_rows", s.num_rows)
                out.append(
                    ShuffleWritePartition(
                        p, s.path, s.num_batches, s.num_rows, nbytes,
                        replica_path=s.replica_path,
                    )
                )
        return out

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        stats = self.execute_shuffle_write(partition, ctx)
        yield pa.RecordBatch.from_arrays(
            [
                pa.array([s.partition_id for s in stats], pa.int64()),
                pa.array([s.path for s in stats], pa.string()),
                pa.array([s.num_batches for s in stats], pa.int64()),
                pa.array([s.num_rows for s in stats], pa.int64()),
                pa.array([s.num_bytes for s in stats], pa.int64()),
            ],
            schema=WRITE_STATS_SCHEMA,
        )

    def __str__(self) -> str:
        p = self.shuffle_output_partitioning
        desc = f"hash({p.n})" if p is not None else "none"
        return f"ShuffleWriterExec: job={self.job_id} stage={self.stage_id} partitioning={desc}"


def apply_read_selections(
    selections: list[list[tuple[int, int, int]]],
    source_lists: list[list],
) -> list[list]:
    """Materialize AQE read selections against per-source-partition
    fragment lists.

    Each reduce TASK is a list of ``(source_partition, chunk_i, chunk_k)``
    triples: the task reads chunk ``i`` of ``k`` index-contiguous slices
    of that source partition's fragment list.  ``(p, 0, 1)`` reads the
    whole partition; a coalesced task lists several whole partitions; a
    skew-split task reads one chunk of one partition.  Chunks are derived
    from the CURRENT fragment count, so any k chunks are always an exact
    disjoint cover — a producer re-run (same map-task count, possibly
    different paths) re-resolves to the same coverage without the
    scheduler persisting fragment indices."""
    out: list[list] = []
    for sel in selections:
        frags: list = []
        for p, i, k in sel:
            src = source_lists[p]
            n = len(src)
            lo, hi = (i * n) // k, ((i + 1) * n) // k
            frags.extend(src[lo:hi])
        out.append(frags)
    return out


class ShuffleReaderExec(ExecutionPlan):
    """Reads shuffle partitions written by upstream ShuffleWriter tasks.

    ``partition[p]`` lists every map-side location contributing to output
    partition ``p`` (reference: shuffle_reader.rs:44-130).

    ``selections``/``source_partition_count`` record the AQE rewrite
    (partition coalescing / skew splitting) this reader was resolved
    with, so an executor-loss rollback reconstructs the REWRITTEN
    placeholder — a rolled-back consumer re-resolves with the same
    adaptive plan, not the original static one.

    ``tail=True`` (streaming pipelined execution): the reader
    was resolved BEFORE its producer stage completed — ``partition``
    carries no static locations; execution tails the scheduler's
    shuffle-location feed for this stage (``shuffle/delta_store.py``)
    until the feed reports complete, streaming each committed map
    fragment the moment it lands.
    """

    def __init__(
        self,
        stage_id: int,
        schema: pa.Schema,
        partition: list[list[PartitionLocation]],
        selections: Optional[list[list[tuple[int, int, int]]]] = None,
        source_partition_count: Optional[int] = None,
        tail: bool = False,
    ):
        super().__init__()
        self.stage_id = stage_id
        self._schema = schema
        self.partition = partition
        self.selections = selections
        self.source_partition_count = source_partition_count
        self.tail = tail

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(len(self.partition))

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        """Stream the merged batches of every map-side location.

        EVERY read routes through :class:`ShuffleFetcher` — with
        ``fetch_concurrency=1`` (or a single location) it runs one worker
        that walks locations in order, so "sequential" keeps the same
        retry/backoff, streaming memory profile, cancel wake-up and
        shutdown-abort registration as the pipelined path instead of
        being a second, less robust code path."""
        from ..obs import trace
        from .fetcher import FetchPolicy, ShuffleFetcher

        if self.tail:
            yield from self._execute_tail(partition, ctx)
            return
        locations = self.partition[partition]
        if not locations:
            return
        policy = FetchPolicy.from_config(ctx.config)
        # manual (stack-free) span: this is a generator — a context-pushing
        # span would stay "current" on the consuming thread between yields
        sp = trace.manual_span(
            "shuffle.fetch",
            stage=self.stage_id,
            partition=partition,
            locations=len(locations),
        )
        try:
            fetcher = ShuffleFetcher(
                locations,
                policy,
                self.metrics,
                cancel_event=ctx.cancel_event,
                owner=ctx.work_dir,
                trace_parent=sp.ctx,
            )
            rows = 0
            for b in fetcher:
                ctx.check_cancelled()
                rows += b.num_rows
                self.metrics.add("output_rows", b.num_rows)
                yield b
            sp.set_attr("rows", rows)
        finally:
            sp.finish()

    def _execute_tail(
        self, partition: int, ctx: TaskContext
    ) -> Iterator[pa.RecordBatch]:
        """Pipelined read: stream the producer's growing location set
        from the delta feed (committed winners only) until it completes.
        The feed is keyed by the TASK's job id — a tailing reader never
        travels outside a distributed task."""
        from ..obs import trace
        from .fetcher import FetchPolicy, TailingShuffleFetcher

        policy = FetchPolicy.from_config(ctx.config)
        sp = trace.manual_span(
            "shuffle.fetch",
            stage=self.stage_id,
            partition=partition,
            tail=True,
        )
        try:
            fetcher = TailingShuffleFetcher(
                ctx.job_id,
                self.stage_id,
                partition,
                policy,
                self.metrics,
                cancel_event=ctx.cancel_event,
                owner=ctx.work_dir,
                trace_parent=sp.ctx,
            )
            rows = 0
            for b in fetcher:
                ctx.check_cancelled()
                rows += b.num_rows
                self.metrics.add("output_rows", b.num_rows)
                yield b
            sp.set_attr("rows", rows)
        finally:
            sp.finish()

    def with_new_children(self, children):
        assert not children
        return self

    def __str__(self) -> str:
        if self.tail:
            return (
                f"ShuffleReaderExec: stage={self.stage_id} "
                f"partitions={len(self.partition)} tail=true"
            )
        n_loc = sum(len(p) for p in self.partition)
        aqe = (
            f" aqe_source_partitions={self.source_partition_count}"
            if self.selections is not None
            else ""
        )
        return (
            f"ShuffleReaderExec: stage={self.stage_id} "
            f"partitions={len(self.partition)} locations={n_loc}{aqe}"
        )


class UnresolvedShuffleExec(ExecutionPlan):
    """Placeholder for a dependency on stage ``stage_id`` that has not been
    computed yet (reference: unresolved_shuffle.rs:33-110).

    ``output_partition_count`` is always the SOURCE reduce-partition
    count the producer stage writes.  ``selections`` (optional, set by
    the AQE policy engine in ``scheduler/adaptive.py``) remaps those
    source partitions onto a different reduce-task layout — coalesced
    groups of tiny partitions and/or fragment-chunk splits of skewed
    ones; when set, this node resolves to ``len(selections)`` tasks
    instead of one per source partition."""

    def __init__(
        self,
        stage_id: int,
        schema: pa.Schema,
        input_partition_count: int,
        output_partition_count: int,
        selections: Optional[list[list[tuple[int, int, int]]]] = None,
    ):
        super().__init__()
        self.stage_id = stage_id
        self._schema = schema
        self.input_partition_count = input_partition_count
        self.output_partition_count = output_partition_count
        self.selections = selections

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    @property
    def reduce_task_count(self) -> int:
        """Reduce tasks this placeholder resolves to (selections-aware)."""
        if self.selections is not None:
            return len(self.selections)
        return self.output_partition_count

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(self.reduce_task_count)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[pa.RecordBatch]:
        raise ExecutionError(
            "UnresolvedShuffleExec cannot execute; it must be replaced with a "
            "ShuffleReaderExec once the producing stage completes"
        )

    def with_new_children(self, children):
        assert not children
        return self

    def __str__(self) -> str:
        if self.selections is not None:
            return (
                f"UnresolvedShuffleExec: stage={self.stage_id} "
                f"aqe_tasks={len(self.selections)}/{self.output_partition_count}"
            )
        return f"UnresolvedShuffleExec: stage={self.stage_id}"
