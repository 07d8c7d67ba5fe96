"""Concurrent pipelined shuffle fetch.

The reduce side of every multi-stage query reads N map-side
``PartitionLocation``s.  The original ``ShuffleReaderExec`` walked them one
at a time and fully materialized each location before yielding — a 64-map
stage paid 64 serial round trips with the device idle during every one.
This module rebuilds that data plane as a pipeline (PAPERS.md
"Benchmarking Apache Arrow Flight": wire speed needs multiple concurrent
DoGet streams):

* a per-reader pool of daemon threads fans out over the locations,
  claiming them from a shared cursor — local-file, memory-store and
  Flight sources stream through the same :func:`fetch_location` path;
* batches flow into a :class:`_PrefetchQueue` bounded by BYTES (not batch
  count — map fragments vary from KBs to tens of MBs), so a fast producer
  backpressures instead of buffering the whole stage in host memory;
* the consumer yields batches as they arrive, in whatever order the
  locations complete — merged-multiset semantics, same rows;
* each location gets retry with exponential backoff; a failed attempt
  drops the cached Flight connection (``BallistaClient.invalidate``) so
  the retry reconnects instead of reusing a dead channel, and a retry
  after a mid-stream failure skips the batches already delivered (per
  location the serving order is deterministic: IPC file order).

Metrics (into the owning operator's registry): ``bytes_fetched``,
``fetch_time_ns`` (summed per-location latency), ``locations_fetched``,
``fetch_retries``, ``fetch_queue_full_ns`` (producer backpressure time),
``fetch_wait_time_ns`` (consumer starvation time) and
``peak_locations_in_flight`` (peak concurrency per execute; sums across
executes of the same operator).

Queued-but-unconsumed bytes are tracked by this module's jax-free
staging counters; ``ops.device_cache.stats()`` surfaces them as
``staging_bytes`` next to pinned HBM.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import pyarrow as pa

from ..obs import trace as obs_trace

log = logging.getLogger(__name__)


class _TeeMetrics:
    """Forward operator-metric adds into the process-wide registry
    (obs/registry.py) so data-plane totals are scrapable per process,
    while the per-operator set keeps feeding stage metrics unchanged.
    ``names`` maps operator metric -> registry counter; the default map
    covers the fetch side, ``shuffle/writer.py`` passes the write map."""

    _FETCH_NAMES = {
        "bytes_fetched": "shuffle_bytes_fetched_total",
        "fetch_retries": "shuffle_fetch_retries_total",
        "locations_fetched": "shuffle_locations_fetched_total",
        "fetch_queue_full_ns": "shuffle_fetch_queue_full_ns_total",
        "fetch_wait_time_ns": "shuffle_fetch_wait_ns_total",
        "replica_fetches": "shuffle_replica_fetches_total",
        # locality-aware data plane: how many locations were served
        # zero-copy off the local filesystem/memory store vs over Flight,
        # how many local bytes never crossed the wire, and how many DoGet
        # round trips the remote legs actually paid (batched multi-
        # partition fetch collapses N per-partition calls into few)
        "local_fetches": "shuffle_local_fetches_total",
        "remote_fetches": "shuffle_remote_fetches_total",
        "local_bytes": "shuffle_local_bytes_total",
        "fetch_round_trips": "shuffle_fetch_round_trips_total",
    }
    _counters: dict = {}
    _counters_lock = threading.Lock()

    __slots__ = ("_inner", "_names")

    def __init__(self, inner, names: Optional[dict] = None):
        self._inner = inner
        self._names = names if names is not None else self._FETCH_NAMES

    @classmethod
    def _counter(cls, name: str):
        c = cls._counters.get(name)
        if c is None:
            from ..obs.registry import process_registry

            with cls._counters_lock:
                c = cls._counters.get(name)
                if c is None:
                    c = process_registry().counter(
                        name, "shuffle data-plane total"
                    )
                    cls._counters[name] = c
        return c

    def add(self, name: str, v: int) -> None:
        self._inner.add(name, v)
        reg_name = self._names.get(name)
        if reg_name is not None:
            self._counter(reg_name).inc(v)

# Host-side staging accounting: bytes sitting in prefetch queues (fetched
# but not yet consumed).  Lives HERE, jax-free — ops.device_cache.stats()
# surfaces it next to pinned HBM, but a CPU-only executor must not pay
# the ops-package jax import just to count queue bytes.
_staging_lock = threading.Lock()
_staging_bytes = 0


def staging_add(n_bytes: int) -> None:
    global _staging_bytes
    with _staging_lock:
        _staging_bytes += n_bytes


def staging_sub(n_bytes: int) -> None:
    global _staging_bytes
    with _staging_lock:
        _staging_bytes -= n_bytes
        if _staging_bytes < 0:  # defensive: never report negative pressure
            _staging_bytes = 0


def staging_bytes() -> int:
    with _staging_lock:
        return _staging_bytes


@dataclass(frozen=True)
class FetchPolicy:
    """Reader-side fetch knobs (see ``ballista.shuffle.fetch_*`` and
    ``ballista.shuffle.local_transport``)."""

    concurrency: int = 8
    prefetch_bytes: int = 64 << 20
    retries: int = 3
    backoff_s: float = 0.05
    # same-host zero-copy transport: "auto" (executor host-identity
    # gated) or "off" (always Flight — the forced-remote A/B leg)
    local_transport: str = "auto"
    # one multi-partition DoGet per (host, chunk) instead of one round
    # trip per location (ballista.shuffle.fetch_batched)
    batched: bool = True

    @staticmethod
    def from_config(config) -> "FetchPolicy":
        return FetchPolicy(
            concurrency=config.shuffle_fetch_concurrency,
            prefetch_bytes=config.shuffle_prefetch_bytes,
            retries=config.shuffle_fetch_retries,
            backoff_s=config.shuffle_fetch_backoff_ms / 1000.0,
            local_transport=config.shuffle_local_transport,
            batched=config.shuffle_fetch_batched,
        )


def _count(metrics, name: str, v: int = 1) -> None:
    if metrics is not None and v:
        metrics.add(name, v)


def _counted_local(batches, metrics) -> Iterator[pa.RecordBatch]:
    """Yield a local zero-copy stream, accounting the bytes that never
    crossed the wire.  Like the transport-split counters generally,
    ``local_bytes`` counts per fetch ATTEMPT (a rare mid-stream retry of
    a local read re-counts the prefix it re-reads) — ``bytes_fetched``
    remains the exact delivered-bytes number."""
    for b in batches:
        _count(metrics, "local_bytes", int(getattr(b, "nbytes", 0) or 0))
        yield b


def fetch_location(
    loc, policy: Optional[FetchPolicy] = None, metrics=None
) -> Iterator[pa.RecordBatch]:
    """Stream one map-side partition: external store, memory-store fast
    path, same-host zero-copy mmap, Arrow Flight otherwise — the single
    source-dispatch behind every shuffle read.

    The local-vs-Flight choice for file partitions is a DELIBERATE
    transport decision (``shuffle/transport.py``): executor host
    identity, not the old accidental ``os.path.exists`` probe — on a
    multi-host deployment a coincidentally-existing foreign path must
    never be read as shuffle input.  ``policy.local_transport="off"``
    forces Flight (the A/B baseline); ``metrics`` (optional) receives
    the ``local_fetches``/``remote_fetches``/``local_bytes``/
    ``fetch_round_trips`` accounting."""
    from . import memory_store, store, transport

    local_transport = policy.local_transport if policy is not None else "auto"
    if store.is_external_location(loc):
        # external-store partition (replica failover or store=external):
        # read the shared path directly; there is no Flight endpoint to
        # fall back to, so a missing file fails fast into the retry loop
        _count(metrics, "remote_fetches")
        yield from store.read_batches(loc.path)
        return
    if loc.path and loc.path.startswith(memory_store.SCHEME):
        buf = memory_store.get_buffer(loc.path)
        if buf is not None:
            # zero-copy: batches are views over the stored IPC buffer
            _count(metrics, "local_fetches")
            with pa.ipc.open_stream(buf) as reader:
                yield from _counted_local(reader, metrics)
            return
        # A miss here is either janitor eviction or a partition produced
        # by ANOTHER executor (whose Flight service serves mem:// paths
        # from its own store).  Never silent: recovery from a genuinely
        # lost partition starts from this line.
        log.warning(
            "memory shuffle partition %s not in the local store (evicted "
            "or remote); falling back to Flight from %s:%s",
            loc.path,
            loc.executor_meta.host,
            loc.executor_meta.flight_port,
        )
    elif loc.path and transport.decide(loc, local_transport) == transport.LOCAL:
        if os.path.exists(loc.path):
            _count(metrics, "local_fetches")
            yield from _counted_local(
                transport.read_local_batches(loc.path), metrics
            )
            return
        # identity said local but the file is not visible here: two
        # co-hosted executors may run on ISOLATED filesystems (separate
        # containers/volumes advertising one IP) — degrade to Flight,
        # which serves from the producer's own filesystem, exactly like
        # the mem:// miss above.  A genuinely lost partition fails over
        # Flight too and lands in the same retry/recovery machinery.
        log.warning(
            "host-matched shuffle partition %s is not visible on this "
            "filesystem; falling back to Flight from %s:%s",
            loc.path,
            loc.executor_meta.host,
            loc.executor_meta.flight_port,
        )
    from ..flight.client import BallistaClient

    client = BallistaClient.get(
        loc.executor_meta.host, loc.executor_meta.flight_port
    )
    # trace context crosses the Flight hop as gRPC metadata so the
    # SERVING executor's do_get span stitches into this job's trace;
    # the kwarg is only passed when tracing — client doubles without it
    # keep working untraced
    headers = obs_trace.propagation_headers() or None
    _count(metrics, "remote_fetches")
    _count(metrics, "fetch_round_trips")
    if headers:
        yield from client.fetch_partition(
            loc.partition_id.job_id,
            loc.partition_id.stage_id,
            loc.partition_id.partition_id,
            loc.path,
            headers=headers,
        )
    else:
        yield from client.fetch_partition(
            loc.partition_id.job_id,
            loc.partition_id.stage_id,
            loc.partition_id.partition_id,
            loc.path,
        )


def fetch_candidates(loc) -> list:
    """Every known copy of one map-side partition, in preference order:
    the executor-served primary first, the external-store replica second.
    The scheduler threads the full replica set through the location
    itself (``PartitionLocation.replica_path``), so each candidate gets
    an INDEPENDENT retry budget instead of the whole budget burning on a
    dead primary while a live copy waits."""
    candidates = [loc]
    replica = getattr(loc, "replica_path", "")
    if replica and replica != getattr(loc, "path", ""):
        candidates.append(_ReplicaCandidate(loc, replica))
    return candidates


class _ReplicaCandidate:
    """External-store copy of a location: duck-types the
    PartitionLocation surface the fetch path reads (path / executor_meta
    / partition_id) without requiring the caller's location to be the
    real dataclass — test doubles ride through unchanged."""

    __slots__ = ("partition_id", "executor_meta", "path", "replica_path")

    def __init__(self, loc, replica_path: str):
        from .store import EXTERNAL_EXECUTOR

        self.partition_id = getattr(loc, "partition_id", None)
        self.executor_meta = EXTERNAL_EXECUTOR
        self.path = replica_path
        self.replica_path = ""


def retrying_fetch(
    loc,
    policy: FetchPolicy,
    metrics,
    fetch_fn: Optional[Callable[[object], Iterator[pa.RecordBatch]]] = None,
    stop_event: Optional[threading.Event] = None,
    delivered_hint: int = 0,
) -> Iterator[pa.RecordBatch]:
    """Stream one location with retry + exponential backoff and replica
    failover.

    Candidates (executor-served primary, then the external-store replica
    when the location names one) each get an INDEPENDENT
    ``fetch_retries`` budget; only when every copy is exhausted does the
    structured :class:`ShuffleFetchFailed` surface.  A retry or failover
    after a mid-stream failure skips the batches already delivered (per
    partition the serving order is deterministic: IPC file order — the
    replica is a byte copy of the primary), so failures never duplicate
    rows.  ``stop_event`` cuts a backoff wait short (the original error
    re-raises).  ``delivered_hint`` pre-counts batches the CALLER already
    delivered for this location (the batched-fetch fallback hands a
    partially-streamed location here), so the first attempt skips them
    instead of duplicating.
    """
    from ..errors import Cancelled
    from ..testing.faults import fault_point

    if fetch_fn is not None:
        fetch = fetch_fn
    else:

        def fetch(l):
            # late-bound module global so monkeypatched doubles win; a
            # single-arg double raises TypeError at GENERATOR CREATION
            # (argument binding, before any body runs), so the fallback
            # call is safe and keeps the old fetch_location(loc) contract
            fl = fetch_location
            try:
                return fl(l, policy=policy, metrics=metrics)
            except TypeError:
                return fl(l)

    delivered = max(0, delivered_hint)
    last_error: Optional[BaseException] = None
    candidates = fetch_candidates(loc)
    for ci, cand in enumerate(candidates):
        attempt = 0
        while True:
            try:
                fault_point(
                    "shuffle.fetch",
                    path=getattr(cand, "path", ""),
                    attempt=attempt,
                )
                skip = delivered
                for batch in fetch(cand):
                    if skip > 0:
                        skip -= 1
                        continue
                    yield batch
                    delivered += 1
                if ci > 0:
                    metrics.add("replica_fetches", 1)
                return
            except Exception as e:
                if isinstance(e, Cancelled):
                    raise
                last_error = e
                attempt += 1
                if attempt > policy.retries:
                    break  # this copy is spent: fail over to the next
                metrics.add("fetch_retries", 1)
                delay = policy.backoff_s * (2 ** (attempt - 1))
                log.warning(
                    "shuffle fetch of %s failed (attempt %d/%d): %s; "
                    "retrying in %.0fms",
                    getattr(cand, "path", cand),
                    attempt,
                    policy.retries,
                    e,
                    delay * 1e3,
                )
                if stop_event is not None:
                    if stop_event.wait(delay):
                        raise
                else:
                    time.sleep(delay)
        if ci + 1 < len(candidates):
            log.warning(
                "shuffle fetch of %s exhausted its budget; failing over "
                "to replica %s",
                getattr(cand, "path", cand),
                getattr(candidates[ci + 1], "path", ""),
            )
    raise _exhausted(loc, last_error) from last_error


def _exhausted(loc, error: BaseException) -> BaseException:
    """Retry budget spent on one location: surface a structured
    :class:`ShuffleFetchFailed` naming the producer partition and serving
    executor, so the scheduler can recompute exactly the lost map output
    (``scheduler/failure.py``).  Cancellation and bare test doubles
    (locations without scheduler coordinates) re-raise unchanged."""
    from ..errors import Cancelled, ShuffleFetchFailed

    if isinstance(error, (Cancelled, ShuffleFetchFailed)):
        return error
    pid = getattr(loc, "partition_id", None)
    meta = getattr(loc, "executor_meta", None)
    if pid is None or meta is None:
        return error
    return ShuffleFetchFailed(
        pid.stage_id,
        pid.partition_id,
        getattr(meta, "id", ""),
        detail=f"{type(error).__name__}: {error}",
    )


def _classify_unit(loc, policy: FetchPolicy):
    """Batched-fetch grouping key for one location: ``"single"`` when it
    is served without a per-partition Flight call (external store, local
    memory-store hit, same-host zero-copy file), else the Flight
    endpoint ``(host, flight_port)`` it must be streamed from."""
    from . import memory_store, store, transport

    if store.is_external_location(loc):
        return "single"
    path = getattr(loc, "path", "") or ""
    meta = getattr(loc, "executor_meta", None)
    if path.startswith(memory_store.SCHEME):
        if memory_store.get_buffer(path) is not None:
            return "single"
    elif (
        transport.decide(loc, policy.local_transport) == transport.LOCAL
        and os.path.exists(path)
    ):
        # existence-checked: an identity-matched but filesystem-invisible
        # partition (isolated co-hosted executors) rides the Flight batch
        return "single"
    host = getattr(meta, "host", "") if meta is not None else ""
    port = getattr(meta, "flight_port", 0) if meta is not None else 0
    if not host or not port:
        return "single"  # nothing to dial: let the single path error out
    return (host, port)


def plan_fetch_units(
    locations: list, policy: FetchPolicy, allow_batched: bool = True
) -> list:
    """Partition a reader's locations into fetch units (each a list of
    locations a worker claims atomically).

    Local/external/memory locations stay one-per-unit.  Remote Flight
    locations group by serving endpoint, and each endpoint's group splits
    into at most ``concurrency // n_endpoints`` chunks — so a 64-location
    single-host stage pays ~``concurrency`` multi-partition round trips
    (streams still overlap) instead of 64 per-partition DoGets, and a
    many-host stage keeps one stream per host."""
    if not allow_batched or not policy.batched or len(locations) <= 1:
        return [[l] for l in locations]
    units: list = []
    groups: dict = {}
    order: list = []  # deterministic unit order: first-seen endpoint
    for l in locations:
        key = _classify_unit(l, policy)
        if key == "single":
            units.append([l])
            continue
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(l)
    n_hosts = max(1, len(groups))
    chunks_per_host = max(1, policy.concurrency // n_hosts)
    for key in order:
        group = groups[key]
        # at least 2 locations per chunk (else batching buys nothing):
        # round trips at most halve even when concurrency >> group size
        n_chunks = min(chunks_per_host, (len(group) + 1) // 2)
        n_chunks = max(1, n_chunks)
        size = (len(group) + n_chunks - 1) // n_chunks
        for lo in range(0, len(group), size):
            units.append(group[lo : lo + size])
    return units


class _Closed(Exception):
    """Internal: the pipeline was torn down (consumer gone or error)."""


class _PrefetchQueue:
    """Bounded-by-bytes handoff between fetch workers and the consumer.

    ``put`` blocks while the byte budget is exhausted — but always admits
    a batch when the queue is EMPTY, so a single batch larger than the
    whole budget cannot deadlock the pipeline.
    """

    def __init__(self, max_bytes: int, metrics) -> None:
        self._max = max(1, max_bytes)
        self._metrics = metrics
        self._dq: deque = deque()
        self._bytes = 0
        self._cv = threading.Condition()
        self._producers = 0
        self._closed = False

    def add_producer(self) -> None:
        with self._cv:
            self._producers += 1

    def producer_done(self) -> None:
        with self._cv:
            self._producers -= 1
            self._cv.notify_all()

    def put(self, batch: pa.RecordBatch, nbytes: int) -> None:
        with self._cv:
            t0 = None
            while self._bytes >= self._max and self._dq and not self._closed:
                if t0 is None:
                    t0 = time.monotonic_ns()
                self._cv.wait()
            if t0 is not None:
                self._metrics.add(
                    "fetch_queue_full_ns", time.monotonic_ns() - t0
                )
            if self._closed:
                raise _Closed()
            self._dq.append((batch, nbytes))
            self._bytes += nbytes
            staging_add(nbytes)
            self._cv.notify_all()

    def get(
        self, abort_event: Optional[threading.Event] = None
    ) -> Optional[pa.RecordBatch]:
        """Next batch, or None when every producer has finished, the
        queue was closed on error, or ``abort_event`` is set (nothing
        else can wake a consumer whose workers are all stuck inside a
        hung remote read — the caller re-checks the event on None)."""
        with self._cv:
            t0 = None
            while not self._dq and self._producers > 0 and not self._closed:
                if abort_event is not None and abort_event.is_set():
                    break
                if t0 is None:
                    t0 = time.monotonic_ns()
                self._cv.wait(0.25 if abort_event is not None else None)
            if t0 is not None:
                self._metrics.add(
                    "fetch_wait_time_ns", time.monotonic_ns() - t0
                )
            if not self._dq:
                return None
            batch, nbytes = self._dq.popleft()
            self._bytes -= nbytes
            staging_sub(nbytes)
            self._cv.notify_all()
            return batch

    def close(self) -> None:
        with self._cv:
            self._closed = True
            if self._bytes:
                staging_sub(self._bytes)
            self._dq.clear()
            self._bytes = 0
            self._cv.notify_all()


# Executor shutdown must be able to abort in-flight fetch pipelines (a
# worker blocked on a dead peer would otherwise pin its task thread):
# every live fetcher registers here with its owner token (the executing
# task's work_dir — unique per executor unless explicitly shared), so
# stopping ONE executor in a multi-executor process does not abort the
# others' fetches.
_active: "weakref.WeakSet[ShuffleFetcher]" = weakref.WeakSet()
_active_lock = threading.Lock()


def shutdown_active_fetchers(owner: Optional[str] = None) -> int:
    """Close in-flight fetch pipelines: those registered under ``owner``
    (an executor's work_dir), or every one in the process when None.
    Returns how many were closed (executor shutdown path)."""
    with _active_lock:
        fetchers = [
            f for f in _active if owner is None or f.owner == owner
        ]
    for f in fetchers:
        f.close(error=_aborted())
    return len(fetchers)


def _aborted():
    from ..errors import ExecutionError

    return ExecutionError("shuffle fetch aborted: executor shutting down")


class ShuffleFetcher:
    """One reader partition's fetch pipeline over its locations.

    ``fetch_fn`` is the per-location stream factory — injectable so tests
    can add deterministic latency or faults without a network.
    """

    def __init__(
        self,
        locations: list,
        policy: FetchPolicy,
        metrics,
        cancel_event: Optional[threading.Event] = None,
        fetch_fn: Optional[Callable[[object], Iterator[pa.RecordBatch]]] = None,
        owner: Optional[str] = None,
        trace_parent=None,
    ) -> None:
        self.owner = owner
        self._locations = list(locations)
        self._policy = policy
        self._metrics = _TeeMetrics(metrics)
        # batched multi-partition fetch only applies to the REAL location
        # dispatch: an injected fetch_fn is per-location by contract
        self._units = plan_fetch_units(
            self._locations, policy, allow_batched=fetch_fn is None
        )
        # explicit parent for per-location spans: fetch workers run on
        # their own threads, so thread-local context can't propagate
        self._trace_parent = trace_parent
        self._cancel = cancel_event
        # None → retrying_fetch builds the policy/metrics-aware
        # fetch_location default (transport decision + locality counters)
        self._fetch_fn = fetch_fn
        self._q = _PrefetchQueue(policy.prefetch_bytes, self._metrics)
        self._cursor = 0
        self._cursor_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._in_flight = 0
        self._peak_in_flight = 0
        self._peak_reported = False
        self._consumed = False

    # ------------------------------------------------------------ consumer
    def __iter__(self) -> Iterator[pa.RecordBatch]:
        # single-use: the location cursor is spent after one pass, so a
        # second iteration would silently yield nothing instead of rows
        if self._consumed:
            raise RuntimeError(
                "ShuffleFetcher is single-use; construct a new one to re-read"
            )
        self._consumed = True
        return self._iterate()

    def _iterate(self) -> Iterator[pa.RecordBatch]:
        n_workers = max(1, min(self._policy.concurrency, len(self._units)))
        with _active_lock:
            _active.add(self)
        try:
            for i in range(n_workers):
                self._q.add_producer()
                try:
                    t = threading.Thread(
                        target=self._worker,
                        name=f"shuffle-fetch-{i}",
                        daemon=True,
                    )
                    t.start()
                except BaseException:
                    # the slot was counted but its worker never ran
                    self._q.producer_done()
                    raise
        except BaseException:
            # a failed spawn (e.g. thread exhaustion) must not leak the
            # already-started workers into a queue nobody will drain
            self.close()
            raise
        try:
            while True:
                batch = self._q.get(abort_event=self._cancel)
                if batch is None:
                    if self._cancel is not None and self._cancel.is_set():
                        raise _cancelled()
                    break
                yield batch
            if self._error is not None:
                raise self._error
        finally:
            self.close()
            self._report_peak()

    def close(self, error: Optional[BaseException] = None) -> None:
        """Tear the pipeline down.  ``error`` (external aborts) surfaces
        to the consumer instead of silently truncating the stream; the
        consumer's own finally-close passes None and raises nothing."""
        if error is not None and self._error is None:
            self._error = error
        self._stop.set()
        self._q.close()

    # ------------------------------------------------------------ producers
    def _next_index(self) -> Optional[int]:
        with self._cursor_lock:
            if self._cursor >= len(self._units):
                return None
            i = self._cursor
            self._cursor += 1
            return i

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                idx = self._next_index()
                if idx is None:
                    break
                unit = self._units[idx]
                if len(unit) == 1:
                    self._fetch_one(unit[0])
                else:
                    self._fetch_unit(unit)
        except _Closed:
            pass
        except BaseException as e:  # first error wins; tears the pipe down
            if self._error is None:
                self._error = e
            self.close()
        finally:
            self._q.producer_done()

    def _enter_location(self) -> None:
        with self._cursor_lock:
            self._in_flight += 1
            self._peak_in_flight = max(self._peak_in_flight, self._in_flight)

    def _exit_location(self) -> None:
        with self._cursor_lock:
            self._in_flight -= 1

    def _report_peak(self) -> None:
        """Record peak concurrency once per pipeline — in the consumer's
        finally, so failed or aborted runs (where concurrency data
        matters most) still report it."""
        with self._cursor_lock:
            if self._peak_reported or self._peak_in_flight == 0:
                return
            self._peak_reported = True
            peak = self._peak_in_flight
        self._metrics.add("peak_locations_in_flight", peak)

    def _fetch_one(self, loc) -> None:
        """Stream one location into the queue via :func:`retrying_fetch`
        (retry/backoff + mid-stream resume shared with the sequential
        reader).  The location span (explicit parent — this is a worker
        thread) also installs the trace context this thread forwards over
        Flight metadata."""
        t0 = time.monotonic_ns()
        self._enter_location()
        try:
            if self._cancel is not None and self._cancel.is_set():
                raise _cancelled()
            span_cm = (
                obs_trace.span(
                    "shuffle.fetch.location",
                    parent=self._trace_parent,
                    path=getattr(loc, "path", ""),
                )
                if self._trace_parent is not None
                else obs_trace.NOOP
            )
            with span_cm as sp:
                total = 0
                for batch in retrying_fetch(
                    loc,
                    self._policy,
                    self._metrics,
                    fetch_fn=self._fetch_fn,
                    stop_event=self._stop,
                ):
                    nbytes = int(getattr(batch, "nbytes", 0) or 0)
                    self._q.put(batch, nbytes)
                    self._metrics.add("bytes_fetched", nbytes)
                    total += nbytes
                sp.set_attr("bytes", total)
            self._metrics.add("fetch_time_ns", time.monotonic_ns() - t0)
            self._metrics.add("locations_fetched", 1)
        finally:
            self._exit_location()

    def _fetch_unit(self, locs: list) -> None:
        """Stream one BATCHED unit (several same-endpoint locations) over
        a single multi-partition DoGet, with retry + mid-stream resume;
        a unit that exhausts its retry budget degrades to the
        per-location path (which adds replica failover) for whatever it
        had not finished."""
        from ..errors import Cancelled

        t0 = time.monotonic_ns()
        self._enter_location()
        try:
            if self._cancel is not None and self._cancel.is_set():
                raise _cancelled()
            span_cm = (
                obs_trace.span(
                    "shuffle.fetch.batched",
                    parent=self._trace_parent,
                    host=getattr(locs[0].executor_meta, "host", ""),
                    locations=len(locs),
                )
                if self._trace_parent is not None
                else obs_trace.NOOP
            )
            with span_cm as sp:
                delivered = [0] * len(locs)
                # frontier: locations BELOW it were fully streamed by
                # some attempt (serving order is deterministic — seeing
                # index j proves every i < j completed), so the fallback
                # never re-fetches their bytes
                frontier = [0]
                try:
                    total = self._stream_batched(locs, delivered, frontier)
                except (Cancelled, _Closed):
                    raise
                except Exception as e:  # noqa: BLE001 - degrade, see below
                    log.warning(
                        "batched fetch of %d partition(s) from %s failed "
                        "(%s); falling back to per-location fetch from "
                        "location %d",
                        len(locs),
                        getattr(locs[0].executor_meta, "host", ""),
                        e,
                        frontier[0],
                    )
                    total = self._fallback_per_location(
                        locs, delivered, frontier[0]
                    )
                sp.set_attr("bytes", total)
            self._metrics.add("fetch_time_ns", time.monotonic_ns() - t0)
        finally:
            self._exit_location()

    def _stream_batched(
        self, locs: list, delivered: list, frontier: list
    ) -> int:
        """One multi-partition stream with bounded retries; ``delivered``
        (per-location committed batch counts) persists across attempts so
        a mid-stream retry resumes without duplicating rows (the server's
        serving order is deterministic: ticket path order, IPC batch
        order within each partition).  ``frontier`` (1-elem list) records
        the highest partition index ever seen: every lower index is
        proven complete.  Protocol violations
        (:class:`BatchedFetchProtocolError`) are deterministic and skip
        the retry budget entirely — the caller degrades straight to
        per-location DoGets."""
        from ..errors import BatchedFetchProtocolError
        from ..flight.client import BallistaClient
        from ..testing.faults import fault_point

        meta = locs[0].executor_meta
        pid0 = locs[0].partition_id
        parts = [
            (getattr(l.partition_id, "partition_id", 0), l.path) for l in locs
        ]
        attempt = 0
        total = 0
        while True:
            try:
                fault_point(
                    "shuffle.fetch",
                    path=getattr(locs[0], "path", ""),
                    attempt=attempt,
                )
                client = BallistaClient.get(meta.host, meta.flight_port)
                headers = obs_trace.propagation_headers() or None
                self._metrics.add("fetch_round_trips", 1)
                _schema, stream = client.fetch_partitions(
                    pid0.job_id, pid0.stage_id, parts, headers=headers
                )
                seen = [0] * len(locs)
                n_streamed = 0
                for idx, batch in stream:
                    fault_point(
                        "shuffle.fetch.batched",
                        host=meta.host,
                        attempt=attempt,
                        batches=n_streamed,
                    )
                    n_streamed += 1
                    if not (0 <= idx < len(locs)):
                        raise _protocol_error(idx, len(locs))
                    frontier[0] = max(frontier[0], idx)
                    seen[idx] += 1
                    if seen[idx] <= delivered[idx]:
                        continue  # resume: already delivered pre-failure
                    nbytes = int(getattr(batch, "nbytes", 0) or 0)
                    self._q.put(batch, nbytes)
                    self._metrics.add("bytes_fetched", nbytes)
                    total += nbytes
                    delivered[idx] += 1
                self._metrics.add("remote_fetches", len(locs))
                self._metrics.add("locations_fetched", len(locs))
                return total
            except Exception as e:
                from ..errors import Cancelled

                if isinstance(
                    e, (Cancelled, _Closed, BatchedFetchProtocolError)
                ):
                    raise
                attempt += 1
                if attempt > self._policy.retries:
                    raise
                self._metrics.add("fetch_retries", 1)
                delay = self._policy.backoff_s * (2 ** (attempt - 1))
                log.warning(
                    "batched shuffle fetch from %s:%s failed "
                    "(attempt %d/%d): %s; retrying in %.0fms",
                    meta.host,
                    meta.flight_port,
                    attempt,
                    self._policy.retries,
                    e,
                    delay * 1e3,
                )
                if self._stop.wait(delay):
                    raise

    def _fallback_per_location(
        self, locs: list, delivered: list, frontier: int = 0
    ) -> int:
        """Finish a failed batched unit location by location: each gets a
        fresh per-copy retry budget PLUS external-replica failover, with
        ``delivered_hint`` skipping what the batched stream already
        committed.  Locations below ``frontier`` were FULLY streamed
        (deterministic serving order proved it) — they are not
        re-fetched at all, so a unit that died on its last partition
        never re-pays the wire cost of the completed ones."""
        total = 0
        for i, loc in enumerate(locs):
            if i < frontier:
                # these WERE wire-served (by the failed batched stream):
                # the transport split must still count them remote
                self._metrics.add("locations_fetched", 1)
                self._metrics.add("remote_fetches", 1)
                continue
            for batch in retrying_fetch(
                loc,
                self._policy,
                self._metrics,
                stop_event=self._stop,
                delivered_hint=delivered[i],
            ):
                nbytes = int(getattr(batch, "nbytes", 0) or 0)
                self._q.put(batch, nbytes)
                self._metrics.add("bytes_fetched", nbytes)
                total += nbytes
            self._metrics.add("locations_fetched", 1)
        return total


class TailingShuffleFetcher:
    """Streaming pipelined fetch: one reader partition's tail
    over a producer stage's shuffle-location feed.

    Unlike :class:`ShuffleFetcher` — whose location set is fixed at
    construction — this pipeline's locations ARRIVE over time: the
    executor-side delta store (``shuffle/delta_store.py``) mirrors the
    scheduler's per-producer feed (push notifications in push mode,
    ``GetShuffleLocationDelta`` polls in pull mode), and this fetcher
    streams each location the moment it lands, finishing when the feed
    reports complete.  A consumer keeping pace with its producers sees
    one location per feed drain and fetches it inline; a consumer that
    fell behind (slow first fetch, late start against an almost-complete
    feed) drains a multi-location BACKLOG and fans it out over the
    standard :class:`ShuffleFetcher` pool so the wire is never idle
    while queued locations wait their turn
    (``ballista.shuffle.fetch_concurrency=1`` pins the ordered
    sequential drain).  Either way each location gets the full
    :func:`retrying_fetch` treatment — retry/backoff, replica failover,
    mid-stream resume and the structured ``ShuffleFetchFailed`` that
    drives producer recovery.

    Stall-on-producer time lands in ``fetch_wait_time_ns`` (accounted by
    the delta store's tail), so the query doctor's attribution of a
    pipelined consumer stays exact.  Registered with the active-fetcher
    table like the static pipeline, so executor shutdown aborts it.
    """

    def __init__(
        self,
        job_id: str,
        stage_id: int,
        partition: int,
        policy: FetchPolicy,
        metrics,
        cancel_event: Optional[threading.Event] = None,
        owner: Optional[str] = None,
        trace_parent=None,
        fetch_fn: Optional[Callable[[object], Iterator[pa.RecordBatch]]] = None,
    ) -> None:
        self.owner = owner
        self._job_id = job_id
        self._stage_id = stage_id
        self._partition = partition
        self._policy = policy
        self._metrics = _TeeMetrics(metrics)
        self._cancel = cancel_event
        self._trace_parent = trace_parent
        self._fetch_fn = fetch_fn
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._consumed = False

    def close(self, error: Optional[BaseException] = None) -> None:
        if error is not None and self._error is None:
            self._error = error
        self._stop.set()

    def __iter__(self) -> Iterator[pa.RecordBatch]:
        if self._consumed:
            raise RuntimeError(
                "TailingShuffleFetcher is single-use; construct a new one"
            )
        self._consumed = True
        return self._iterate()

    def _iterate(self) -> Iterator[pa.RecordBatch]:
        from . import delta_store

        with _active_lock:
            _active.add(self)
        span_cm = (
            obs_trace.span(
                "shuffle.fetch.tail",
                parent=self._trace_parent,
                stage=self._stage_id,
                partition=self._partition,
            )
            if self._trace_parent is not None
            else obs_trace.NOOP
        )
        try:
            with span_cm as sp:
                total = 0
                n_locs = 0
                for chunk in delta_store.tail_location_batches(
                    self._job_id,
                    self._stage_id,
                    self._partition,
                    stop_event=self._stop,
                    cancel_event=self._cancel,
                    metrics=self._metrics,
                ):
                    if len(chunk) > 1 and self._policy.concurrency > 1:
                        # backlog drain: fan the queued locations out over
                        # the concurrent pool (it accounts bytes/locations/
                        # fetch_time/peak itself; pass the unwrapped
                        # metrics so the registry tee isn't paid twice)
                        pool = ShuffleFetcher(
                            chunk,
                            self._policy,
                            self._metrics._inner,
                            cancel_event=self._cancel,
                            fetch_fn=self._fetch_fn,
                            owner=self.owner,
                            trace_parent=self._trace_parent,
                        )
                        for batch in pool:
                            if self._error is not None:
                                raise self._error
                            yield batch
                            total += int(getattr(batch, "nbytes", 0) or 0)
                        n_locs += len(chunk)
                        continue
                    for loc in chunk:
                        t0 = time.monotonic_ns()
                        for batch in retrying_fetch(
                            loc,
                            self._policy,
                            self._metrics,
                            fetch_fn=self._fetch_fn,
                            stop_event=self._stop,
                        ):
                            if self._error is not None:
                                raise self._error
                            yield batch
                            nbytes = int(getattr(batch, "nbytes", 0) or 0)
                            self._metrics.add("bytes_fetched", nbytes)
                            total += nbytes
                        self._metrics.add(
                            "fetch_time_ns", time.monotonic_ns() - t0
                        )
                        self._metrics.add("locations_fetched", 1)
                        n_locs += 1
                if self._error is not None:
                    raise self._error
                sp.set_attr("bytes", total)
                sp.set_attr("locations", n_locs)
        finally:
            self.close()


def _cancelled():
    from ..errors import Cancelled

    return Cancelled("task cancelled")


def _protocol_error(idx, n):
    from ..errors import BatchedFetchProtocolError

    return BatchedFetchProtocolError(
        f"batched shuffle fetch: server sent partition index {idx} "
        f"outside the requested range [0, {n})"
    )
