"""Pluggable shuffle storage: the external (object-store-style) backend.

The shuffle data plane has three backends (``ballista.shuffle.store``):

* ``local`` — today's fast path, unchanged: Arrow IPC files under the
  producing executor's work_dir, served over Flight (and read directly
  when the consumer shares the filesystem);
* ``mem`` — the executor-memory store (:mod:`shuffle.memory_store`),
  equivalent to the pre-existing ``ballista.shuffle.to_memory``;
* ``external`` — a shared directory (``ballista.shuffle.external_path``)
  standing in for S3/GCS/a dedicated shuffle service: partitions written
  there survive their producer, so executors become disposable.

On top of the local/mem backends, ``ballista.shuffle.replication``
uploads a **replica** of each finished partition into the external
directory — ``sync`` before the task reports, ``async`` via the
process-wide :class:`Replicator` background uploader.  The replica path
is a pure function of the primary path (:func:`external_replica_path`),
so the write side, the executor's drain-time upload and the scheduler's
repoint-at-executor-loss all agree on where a copy lives without any
extra wire protocol.

Layout under the external root mirrors the work_dir layout exactly::

    <root>/<job>/<stage>/<out_partition>/data-<in>.arrow   (file primary)
    <root>/<job>/<stage>/<out_partition>/mem-<in>.arrow    (mem primary)

Uploads are atomic (tmp + rename) so a reader never sees half a replica,
and both directions carry fault points (``shuffle.store.upload`` /
``shuffle.store.download``) so the degradation paths are testable: a
replica-upload failure degrades to single-copy, never fails the task.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from typing import Iterator, List, Optional, Tuple

import pyarrow as pa

from ..serde.scheduler_types import ExecutorMetadata

log = logging.getLogger(__name__)

# Sentinel executor identity stamped on PartitionLocations that point at
# the external store: no Flight endpoint, never matches a lost executor,
# so ``reset_stages``/``remove_input_partitions`` can never strip it.
EXTERNAL_EXECUTOR_ID = "__external__"
EXTERNAL_EXECUTOR = ExecutorMetadata(EXTERNAL_EXECUTOR_ID, "", 0, 0)

_ARROW_FILE_MAGIC = b"ARROW1"


def is_external_location(loc) -> bool:
    meta = getattr(loc, "executor_meta", None)
    return getattr(meta, "id", "") == EXTERNAL_EXECUTOR_ID


def is_under_root(root: str, path: str) -> bool:
    """Is ``path`` inside the external root DIRECTORY?  A raw prefix test
    would let '/data/ext-work/...' pass for root '/data/ext' and make the
    scheduler mistake a dead executor's private file for a surviving
    external copy — normalize and require a separator boundary."""
    if not root or not path:
        return False
    root_n = os.path.normpath(root)
    path_n = os.path.normpath(path)
    return path_n == root_n or path_n.startswith(root_n + os.sep)


def external_replica_path(external_root: str, primary_path: str) -> Optional[str]:
    """The external-store path holding (or destined to hold) the replica
    of ``primary_path`` — a pure function so writer, drain upload and
    scheduler repoint agree without coordination.

    File primaries live at ``work_dir/<job>/<stage>/<out>/<name>``: the
    last four components relocate under the root.  Memory primaries
    (``mem://job/stage/out/in``) map to ``<job>/<stage>/<out>/mem-<in>.arrow``.
    Returns None when the path has no derivable key."""
    if not external_root or not primary_path:
        return None
    from . import memory_store

    key = memory_store.parse_path(primary_path)
    if key is not None:
        job, stage, out, in_part = key
        return os.path.join(
            external_root, job, str(stage), str(out), f"mem-{in_part}.arrow"
        )
    parts = [p for p in primary_path.replace("\\", "/").split("/") if p]
    if len(parts) < 4:
        return None
    return os.path.join(external_root, *parts[-4:])


# ------------------------------------------------------------------ uploads
def _atomic_write(dest: str, writer_fn) -> None:
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = f"{dest}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        writer_fn(tmp)
        os.replace(tmp, dest)  # atomic: a reader never sees half a replica
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def upload_file(src: str, dest: str) -> int:
    """Copy one finished partition file into the external store.
    Returns the bytes uploaded; raises on failure (callers degrade)."""
    from ..testing.faults import fault_point

    fault_point("shuffle.store.upload", src=src, dest=dest)
    _atomic_write(dest, lambda tmp: shutil.copyfile(src, tmp))
    _count_upload(os.path.getsize(dest))
    return os.path.getsize(dest)


def upload_buffer(buf, dest: str) -> int:
    """Write an already-serialized IPC buffer (a mem:// partition) into
    the external store."""
    from ..testing.faults import fault_point

    fault_point("shuffle.store.upload", src="<buffer>", dest=dest)

    def _write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            f.write(buf)

    _atomic_write(dest, _write)
    _count_upload(len(buf) if hasattr(buf, "__len__") else buf.size)
    return os.path.getsize(dest)


def read_batches(path: str) -> Iterator[pa.RecordBatch]:
    """Stream one external-store partition.  Sniffs the container format:
    file primaries replicate as Arrow IPC FILES, mem primaries as IPC
    STREAMS — the magic bytes disambiguate.  The download fault point
    lets tests fail/delay replica reads deterministically."""
    from ..testing.faults import fault_point

    fault_point("shuffle.store.download", path=path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such external shuffle partition {path!r}")
    with open(path, "rb") as probe:
        magic = probe.read(len(_ARROW_FILE_MAGIC))
    with pa.OSFile(path, "rb") as f:
        if magic == _ARROW_FILE_MAGIC:
            reader = pa.ipc.open_file(f)
            for i in range(reader.num_record_batches):
                yield reader.get_batch(i)
        else:
            with pa.ipc.open_stream(f) as reader:
                yield from reader


def read_schema(path: str) -> pa.Schema:
    """Schema of one external-store partition (same format sniff as
    :func:`read_batches`) — zero-row partitions still need one."""
    with open(path, "rb") as probe:
        magic = probe.read(len(_ARROW_FILE_MAGIC))
    with pa.OSFile(path, "rb") as f:
        if magic == _ARROW_FILE_MAGIC:
            return pa.ipc.open_file(f).schema
        with pa.ipc.open_stream(f) as reader:
            return reader.schema


def delete_job(external_root: str, job_id: str) -> None:
    """External-store analogue of the work-dir janitor's job sweep."""
    if not external_root or not job_id:
        return
    path = os.path.join(external_root, job_id)
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)


# ------------------------------------------------- process-wide bookkeeping
# The executor learns the external root from task props (session config)
# — drain-time uploads need it after the last task finished, so the most
# recent value is remembered process-wide.
_noted_lock = threading.Lock()
_noted_external_root = ""


def note_external_root(path: str) -> None:
    global _noted_external_root
    if path:
        with _noted_lock:
            _noted_external_root = path


def noted_external_root() -> str:
    with _noted_lock:
        return _noted_external_root


def _counter(name: str, desc: str):
    # process_registry().counter is idempotent (returns the existing
    # counter by name), so no extra caching layer is needed here — the
    # upload paths are not hot enough to warrant one
    from ..obs.registry import process_registry

    return process_registry().counter(name, desc)


def _count_upload(nbytes: int) -> None:
    _counter(
        "shuffle_replicas_written_total",
        "shuffle partition replicas uploaded to the external store",
    ).inc()
    _counter(
        "shuffle_replica_bytes_total",
        "bytes uploaded to the external shuffle store",
    ).inc(int(nbytes))


def count_upload_failure() -> None:
    _counter(
        "shuffle_replica_upload_failures_total",
        "replica uploads that failed (degraded to single copy)",
    ).inc()


# --------------------------------------------------------------- replicator
class Replicator:
    """Process-wide background uploader for ``replication=async``: the
    writer pool hands finished partitions here and task completion never
    waits on the external store.  Failures degrade to single copy (the
    scheduler's failover then falls back to recompute if the primary is
    also gone) — they are counted, logged and otherwise swallowed."""

    def __init__(self, max_queue: int = 1024):
        import queue

        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # in-flight accounting under a condition variable: flush() must
        # not return while ANY submitted upload is unfinished — an
        # Event-based "queue looked empty" check races submit and would
        # let a drain exit with an upload still pending
        self._pending = 0
        self._cv = threading.Condition(self._lock)

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="shuffle-replicator", daemon=True
            )
            self._thread.start()

    def _submit(self, item) -> None:
        with self._cv:
            self._pending += 1
            self._ensure_thread()
        self._q.put(item)

    def submit_file(self, src: str, dest: str) -> None:
        self._submit(("file", src, dest))

    def submit_buffer(self, buf, dest: str) -> None:
        self._submit(("buffer", buf, dest))

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every SUBMITTED upload finished (drain path).
        True when the backlog drained inside the timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def _run(self) -> None:
        import queue

        while True:
            try:
                kind, src, dest = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                if kind == "file":
                    upload_file(src, dest)
                else:
                    upload_buffer(src, dest)
            except Exception as e:  # noqa: BLE001 - degrade, never propagate
                count_upload_failure()
                log.warning("async replica upload to %s failed: %s", dest, e)
            finally:
                self._q.task_done()
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()


_replicator: Optional[Replicator] = None
_replicator_lock = threading.Lock()


def replicator() -> Replicator:
    global _replicator
    with _replicator_lock:
        if _replicator is None:
            _replicator = Replicator()
        return _replicator


def replicator_backlog() -> int:
    """Uploads submitted but unfinished, WITHOUT creating the replicator
    (the telemetry sampler reads this every heartbeat on executors that
    may never replicate anything)."""
    with _replicator_lock:
        rep = _replicator
    if rep is None:
        return 0
    with rep._cv:
        return rep._pending


# ------------------------------------------------------------- drain upload
def drain_upload(
    work_dir: str, external_root: str
) -> Tuple[int, List[str]]:
    """Decommission path: upload every shuffle partition still held by
    this executor — work_dir IPC files and mem:// store buffers — that
    the external store doesn't already have.  Returns
    ``(uploaded_count, failed_dests)``; failures degrade (the scheduler's
    recompute path covers whatever didn't make it)."""
    from . import memory_store

    uploaded = 0
    failed: List[str] = []
    if not external_root:
        return 0, []
    # 1) file partitions: work_dir/<job>/<stage>/<out>/<name>.arrow
    try:
        jobs = sorted(os.listdir(work_dir)) if work_dir else []
    except OSError:
        jobs = []
    for job in jobs:
        job_dir = os.path.join(work_dir, job)
        if job == ".memspool" or not os.path.isdir(job_dir):
            continue
        for root, _dirs, files in os.walk(job_dir):
            for name in files:
                if not name.endswith(".arrow"):
                    continue
                src = os.path.join(root, name)
                dest = external_replica_path(external_root, src)
                if dest is None or os.path.exists(dest):
                    continue
                try:
                    upload_file(src, dest)
                    uploaded += 1
                except Exception as e:  # noqa: BLE001 - degrade
                    count_upload_failure()
                    failed.append(dest)
                    log.warning("drain upload of %s failed: %s", src, e)
    # 2) memory partitions
    for job in memory_store.job_ids():
        for path, buf in memory_store.job_entries(job):
            dest = external_replica_path(external_root, path)
            if dest is None or os.path.exists(dest):
                continue
            try:
                upload_buffer(buf, dest)
                uploaded += 1
            except Exception as e:  # noqa: BLE001 - degrade
                count_upload_failure()
                failed.append(dest)
                log.warning("drain upload of %s failed: %s", path, e)
    return uploaded, failed
