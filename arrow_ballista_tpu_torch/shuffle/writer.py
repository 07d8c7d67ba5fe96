"""Pipelined, slab-buffered, compressed shuffle write.

The map side of every multi-stage query splits its stage output across
N output partitions.  The original ``ShuffleWriterExec`` did everything
on the compute thread: an O(n log n) argsort per batch, then one tiny
synchronous uncompressed IPC write per (input batch, output partition)
run — so a 64-in x 16-out shuffle produced 1024 file fragments and the
stage subplan sat idle during every write syscall.  This module is the
write-side twin of :mod:`shuffle.fetcher` (PAPERS.md Zerrow / Arrow
Flight benchmarking: producer-side layout and copy/compression decisions
dominate end-to-end shuffle throughput):

* the compute thread only hash-splits (O(n) counting-sort permutation,
  :func:`exec.operators.partition_permutation`) and appends zero-copy
  row slices to per-output-partition **slab buffers**;
* a slab reaching ``ballista.shuffle.write_coalesce_rows`` is handed to
  a bounded **writer pool**: concatenation, IPC serialization (optional
  lz4/zstd body compression) and sink I/O all run off the compute
  thread.  Output partitions are sharded across the pool's threads
  (partition ``p`` -> worker ``p % W``), so each sink is touched by
  exactly one thread and per-sink batch order stays deterministic;
* the pool's queues are bounded by BYTES — a stage subplan that produces
  faster than the disk (or memory store) absorbs blocks in ``append``
  instead of buffering the whole stage output;
* the first worker error tears the pipeline down and re-raises on the
  compute thread; cancellation via :meth:`AsyncShuffleWriter.abort`
  closes every queue and sink without leaking file handles.

Metrics (into the owning operator's registry, mirrored to the process
registry): ``bytes_written_raw`` (batch bytes handed to sinks),
``bytes_written_wire`` (bytes that actually hit the sink — the
raw/wire ratio is the compression ratio), ``slab_flushes``,
``write_queue_full_ns`` (compute-thread backpressure time) and
``write_time_ns`` (serialization + sink I/O time on the pool threads).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import pyarrow as pa

from ..errors import ExecutionError
from .fetcher import _TeeMetrics

_WRITE_REGISTRY_NAMES = {
    "bytes_written_raw": "shuffle_bytes_written_raw_total",
    "bytes_written_wire": "shuffle_bytes_written_wire_total",
    "write_queue_full_ns": "shuffle_write_queue_full_ns_total",
    "slab_flushes": "shuffle_slab_flushes_total",
    "write_time_ns": "shuffle_write_ns_total",
}

# Process-wide write-queue occupancy: bytes coalesced but not yet written
# across every live AsyncShuffleWriter.  The telemetry heartbeat
# piggyback (obs/telemetry.py) reports it next to the fetch side's
# staging bytes — two plain ints, no jax/pyarrow on the read path.
_queued_lock = threading.Lock()
_queued_bytes = 0


def _queued_add(n: int) -> None:
    global _queued_bytes
    with _queued_lock:
        _queued_bytes += n


def _queued_sub(n: int) -> None:
    global _queued_bytes
    with _queued_lock:
        _queued_bytes -= n
        if _queued_bytes < 0:  # defensive: never report negative pressure
            _queued_bytes = 0


def queued_bytes() -> int:
    """Bytes sitting in shuffle write-pool queues right now."""
    with _queued_lock:
        return _queued_bytes


@dataclass(frozen=True)
class WritePolicy:
    """Map-side write knobs (see ``ballista.shuffle.write_*`` and the
    storage/replication knobs ``ballista.shuffle.{store,replication,
    external_path}``)."""

    coalesce_rows: int = 32768
    queue_bytes: int = 32 << 20
    concurrency: int = 2
    compression: str = "none"
    pipelined: bool = True
    store: str = "local"  # local | mem | external
    replication: str = "none"  # none | async | sync
    external_path: str = ""

    @property
    def replicate(self) -> bool:
        """Upload a replica of each finished partition?  Only meaningful
        for local/mem primaries — an external-store primary already
        survives its producer."""
        return (
            self.replication != "none"
            and bool(self.external_path)
            and self.store != "external"
        )

    @staticmethod
    def from_config(config) -> "WritePolicy":
        rows = config.shuffle_write_coalesce_rows
        if rows == 0:
            # several source batches per slab: IPC serialization and the
            # worker-side gather amortize much better on 4x-batch slabs
            # than on batch-sized ones (measured 1.7x -> 2.4x+ at the
            # default batch size), and downstream readers see 4x fewer
            # fragments
            rows = 4 * config.batch_size
        store = config.shuffle_store
        if store == "local" and config.shuffle_to_memory:
            store = "mem"  # back-compat spelling of the mem store
        return WritePolicy(
            coalesce_rows=rows,
            queue_bytes=config.shuffle_write_queue_bytes,
            concurrency=config.shuffle_write_concurrency,
            compression=config.shuffle_compression,
            pipelined=config.shuffle_write_pipelined,
            store=store,
            replication=config.shuffle_replication,
            external_path=config.shuffle_external_path,
        )


_CODEC_PROBE = {"lz4": "lz4_frame", "zstd": "zstd"}


def ipc_write_options(compression: str) -> Optional[pa.ipc.IpcWriteOptions]:
    """IpcWriteOptions for the configured codec (None for 'none').

    The codec NAME is validated at config parse; availability is a
    build-time property of the pyarrow wheel, checked here so the error
    names the missing codec instead of failing inside the IPC writer."""
    if not compression or compression == "none":
        return None
    if not pa.Codec.is_available(_CODEC_PROBE[compression]):
        raise ExecutionError(
            f"ballista.shuffle.compression={compression!r} but this "
            "pyarrow build lacks the codec"
        )
    return pa.ipc.IpcWriteOptions(compression=compression)


class _Closed(Exception):
    """Internal: the pipeline was torn down (error or abort)."""


class _ByteQueue:
    """Bounded-by-bytes handoff from the compute thread to one writer.

    ``put`` blocks while the byte budget is exhausted — but always admits
    an item when the queue is EMPTY, so a single slab larger than the
    budget cannot deadlock the pipeline (same rule as the fetch side's
    ``_PrefetchQueue``)."""

    def __init__(self, max_bytes: int, metrics, cancel_event=None) -> None:
        self._max = max(1, max_bytes)
        self._metrics = metrics
        self._cancel = cancel_event
        self._items: list = []
        self._bytes = 0
        self._cv = threading.Condition()
        self._closed = False
        self._done = False  # sentinel received: no more puts expected

    def put(self, item, nbytes: int) -> None:
        with self._cv:
            t0 = None
            while self._bytes >= self._max and self._items and not self._closed:
                if self._cancel is not None and self._cancel.is_set():
                    # a cancelled task's compute thread must not stay
                    # parked on backpressure behind a hung sink
                    raise _Closed()
                if t0 is None:
                    t0 = time.monotonic_ns()
                self._cv.wait(0.25 if self._cancel is not None else None)
            if t0 is not None:
                self._metrics.add(
                    "write_queue_full_ns", time.monotonic_ns() - t0
                )
            if self._closed:
                raise _Closed()
            self._items.append((item, nbytes))
            self._bytes += nbytes
            _queued_add(nbytes)
            self._cv.notify_all()

    def finish(self) -> None:
        """No more items: the worker drains what is queued, then exits."""
        with self._cv:
            self._done = True
            self._cv.notify_all()

    def get(self):
        """Next item; None when finished-and-drained.  A CLOSED queue
        (error/abort teardown) raises instead — the worker must not run
        its success-path sink closes over a torn-down pipeline."""
        with self._cv:
            while not self._items and not self._done and not self._closed:
                self._cv.wait()
            if self._closed:
                raise _Closed()
            if not self._items:
                return None
            item, nbytes = self._items.pop(0)
            self._bytes -= nbytes
            _queued_sub(nbytes)
            self._cv.notify_all()
            return item

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._items.clear()
            _queued_sub(self._bytes)
            self._bytes = 0
            self._cv.notify_all()


class AsyncShuffleWriter:
    """One write task's pipeline over its output-partition sinks.

    ``sink_factory(out_part)`` creates the partition's sink (file or
    memory store) — invoked lazily on the owning WORKER thread, so
    directory creation and file opens stay off the compute thread.  Every
    partition gets a sink even when no row hashed to it (readers need no
    existence probe), exactly like the synchronous path."""

    _OPEN = object()  # queue item: ensure the sink exists, write nothing

    def __init__(
        self,
        n_out: int,
        sink_factory: Callable[[int], object],
        policy: WritePolicy,
        metrics,
        cancel_event: Optional[threading.Event] = None,
        replicate_fn: Optional[Callable[[object], None]] = None,
    ) -> None:
        self._n_out = n_out
        self._sink_factory = sink_factory
        self._policy = policy
        # replication hook: invoked on the WORKER thread right after a
        # sink closes (the partition's bytes are final) — uploads the
        # external-store replica off the compute thread.  Must never
        # raise (a failed upload degrades to single copy).
        self._replicate_fn = replicate_fn
        self._metrics = _TeeMetrics(metrics, _WRITE_REGISTRY_NAMES)
        self._cancel = cancel_event
        self._slabs: List[list] = [[] for _ in range(n_out)]
        self._slab_rows = [0] * n_out
        self._slab_nbytes = [0] * n_out
        self._slab_total = 0  # est. bytes pinned across ALL slabs
        self._touched = [False] * n_out
        n_workers = max(1, min(policy.concurrency, n_out))
        self._queues = [
            _ByteQueue(
                max(1, policy.queue_bytes // n_workers),
                self._metrics,
                cancel_event=cancel_event,
            )
            for _ in range(n_workers)
        ]
        self._sinks: List[Optional[object]] = [None] * n_out
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._finished = False

    # ------------------------------------------------------------- compute
    def append(self, out_part: int, batch: pa.RecordBatch) -> None:
        """Buffer one whole batch for ``out_part``; a slab reaching the
        coalesce target ships to the writer pool."""
        if batch.num_rows == 0:
            return
        self._push(
            out_part,
            (batch, None),
            int(getattr(batch, "nbytes", 0) or 0),
            n_rows=batch.num_rows,
        )

    def append_rows(
        self, out_part: int, batch: pa.RecordBatch, indices
    ) -> None:
        """Buffer ``batch``'s rows at ``indices`` (a numpy index array)
        for ``out_part``.  The gather itself (``take``) runs on the
        WORKER when the slab flushes — the compute thread pays only the
        hash + permutation, never a row copy."""
        if len(indices) == 0:
            return
        est = int(
            getattr(batch, "nbytes", 0) * len(indices)
            // max(1, batch.num_rows)
        )
        self._push(out_part, (batch, indices), est, n_rows=len(indices))

    def _push(self, out_part: int, item, nbytes: int, n_rows=None) -> None:
        if self._cancel is not None and self._cancel.is_set():
            from ..errors import Cancelled

            raise Cancelled("task cancelled")
        self._raise_error()
        self._slabs[out_part].append((item, nbytes))
        self._slab_rows[out_part] += (
            n_rows if n_rows is not None else item[0].num_rows
        )
        self._slab_nbytes[out_part] += nbytes
        self._slab_total += nbytes
        if (
            self._policy.coalesce_rows < 0
            or self._slab_rows[out_part] >= self._policy.coalesce_rows
        ):
            self._flush_slab(out_part)
        if self._slab_total > self._policy.queue_bytes:
            # slab references pin their SOURCE batches (append_rows holds
            # indices, not copies), so slab memory must answer to the same
            # byte budget as the queues: under pressure every slab flushes
            # early — a few more fragments beats unbounded pinning at
            # high partition counts
            for p in range(self._n_out):
                self._flush_slab(p)

    def finish(self) -> List[object]:
        """Flush every slab, create sinks for untouched partitions, drain
        the pool and return the CLOSED sinks (one per output partition,
        each with ``path`` / ``num_batches`` / ``num_rows`` and its wire
        size in ``wire_bytes``)."""
        try:
            for p in range(self._n_out):
                self._flush_slab(p)
            for p in range(self._n_out):
                if not self._touched[p]:
                    self._enqueue(p, self._OPEN, 0)
            for q in self._queues:
                q.finish()
            self._start_workers()  # n_out == 0: nothing was ever enqueued
            for t in self._threads:
                t.join()
            # _finished only flips on SUCCESS: an error raised here must
            # leave abort() armed so the failing worker's still-open
            # sinks get their OS handles released.  A cancel that landed
            # during the drain made workers bail via _Closed WITHOUT
            # closing their sinks — that is not a success either.
            self._raise_error()
            if self._cancel is not None and self._cancel.is_set():
                from ..errors import Cancelled

                raise Cancelled("task cancelled")
            self._finished = True
            return [s for s in self._sinks]
        except BaseException:
            self.abort()
            raise

    def abort(self) -> None:
        """Tear the pipeline down (worker error, consumer error or task
        cancel): close every queue, wake blocked threads, then ABANDON
        the sinks that never closed — OS handles are released but
        nothing is published (a partial mem:// partition stored under
        the canonical key would shadow the retry's real one)."""
        if self._finished:
            return
        with self._error_lock:
            if self._error is None:
                self._error = ExecutionError("shuffle write aborted")
        for q in self._queues:
            q.close()
        for t in self._threads:
            t.join(timeout=5)
        for s in self._sinks:
            if s is not None and getattr(s, "wire_bytes", None) is None:
                try:
                    s.abandon()
                except Exception:  # noqa: BLE001 - best-effort cleanup
                    pass
        self._finished = True

    # ------------------------------------------------------------ internal
    def _flush_slab(self, p: int) -> None:
        items = self._slabs[p]
        if not items:
            return
        nbytes = sum(n for _, n in items)
        self._slabs[p] = []
        self._slab_rows[p] = 0
        self._slab_total -= self._slab_nbytes[p]
        self._slab_nbytes[p] = 0
        self._metrics.add("slab_flushes", 1)
        # gather + concat (the one copy this path pays) happen on the WORKER
        self._enqueue(p, [it for it, _ in items], nbytes)

    def _enqueue(self, p: int, item, nbytes: int) -> None:
        self._touched[p] = True
        self._start_workers()
        try:
            self._queues[p % len(self._queues)].put((p, item), nbytes)
        except _Closed:
            if self._cancel is not None and self._cancel.is_set():
                from ..errors import Cancelled

                raise Cancelled("task cancelled")
            self._raise_error()
            raise ExecutionError("shuffle write pipeline closed")

    def _start_workers(self) -> None:
        if self._threads:
            return
        for i, q in enumerate(self._queues):
            t = threading.Thread(
                target=self._worker,
                args=(i, q),
                name=f"shuffle-write-{i}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    def _raise_error(self) -> None:
        with self._error_lock:
            if self._error is not None:
                raise self._error

    def _fail(self, e: BaseException) -> None:
        with self._error_lock:
            if self._error is None:
                self._error = e
        for q in self._queues:
            q.close()

    def _worker(self, w: int, q: _ByteQueue) -> None:
        from ..testing.faults import fault_point

        try:
            while True:
                got = q.get()
                if got is None:
                    break
                if self._cancel is not None and self._cancel.is_set():
                    raise _Closed()  # stop writing; abort abandons sinks
                p, item = got
                t0 = time.monotonic_ns()
                sink = self._sinks[p]
                if sink is None:
                    sink = self._sinks[p] = self._sink_factory(p)
                if item is not self._OPEN:
                    parts = [
                        b if ix is None else b.take(pa.array(ix))
                        for b, ix in item
                    ]
                    batch = (
                        parts[0] if len(parts) == 1
                        else pa.concat_batches(parts)
                    )
                    fault_point(
                        "shuffle.write.sink",
                        path=getattr(sink, "path", ""),
                        partition=p,
                    )
                    sink.write(batch)
                    self._metrics.add(
                        "bytes_written_raw",
                        int(getattr(batch, "nbytes", 0) or 0),
                    )
                self._metrics.add("write_time_ns", time.monotonic_ns() - t0)
            # drain complete: close this worker's shard of sinks
            t0 = time.monotonic_ns()
            for p in range(w, self._n_out, len(self._queues)):
                s = self._sinks[p]
                if s is not None:
                    self._metrics.add("bytes_written_wire", s.close())
                    if self._replicate_fn is not None:
                        self._replicate_fn(s)
            self._metrics.add("write_time_ns", time.monotonic_ns() - t0)
        except _Closed:
            # teardown (error elsewhere, abort or cancel): leave this
            # shard's sinks to abort()'s abandon pass — closing them here
            # would PUBLISH partial partitions and inflate wire metrics
            pass
        except BaseException as e:  # first error wins; tears the pipe down
            self._fail(e)
