"""In-process memory shuffle store: the TPU-first shuffle data plane.

The reference persists every shuffle partition as an Arrow IPC file and
serves it over Flight (``shuffle_writer.rs:142-292`` →
``flight_service.rs:80-118``).  On a TPU host the data either stays on the
mesh (gang stages exchange via ICI collectives) or — for stage outputs
that must cross a process/host boundary — can be held in RAM and streamed
straight out of the executor's Flight service without touching disk.

Paths use the scheme ``mem://<job>/<stage>/<out_partition>/<in_partition>``
so PartitionLocation / ShuffleWritePartition stats, the scheduler graph,
and fault recovery are completely unchanged: a lost executor loses its
memory partitions exactly like its local files, and ``reset_stages`` rolls
the producing stage back the same way.

Lifetime mirrors the shuffle janitor's job-directory GC: ``delete_job`` is
called wherever job work-dirs are removed.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import pyarrow as pa

SCHEME = "mem://"

# Spool mode (process-isolated task workers): the worker process cannot
# publish into the PARENT executor's in-memory store, so with a spool
# dir set its puts write compact IPC buffers to files under the shared
# work_dir instead (tmpfs-speed when work_dir is tmpfs) and the parent
# absorbs them into its own store when the task completes — mem://
# partitions stay served from executor memory while plan execution
# stays out of the executor's GIL (reference DedicatedExecutor,
# cpu_bound_executor.rs:37-131).
_spool_dir: Optional[str] = None

_lock = threading.Lock()
# values are compact Arrow IPC stream buffers, NOT RecordBatch lists: a
# stored batch slice would pin its parent batch's entire allocation (and
# overstate stats); serializing compacts to exactly the partition's bytes,
# and readers reopen the buffer zero-copy
_store: Dict[Tuple[str, int, int, int], pa.Buffer] = {}
_job_touched: Dict[str, float] = {}  # job_id -> last put() wall time


def make_path(job_id: str, stage_id: int, out_part: int, in_part: int) -> str:
    return f"{SCHEME}{job_id}/{stage_id}/{out_part}/{in_part}"


def parse_path(path: str) -> Optional[Tuple[str, int, int, int]]:
    if not path.startswith(SCHEME):
        return None
    parts = path[len(SCHEME):].split("/")
    if len(parts) != 4:
        return None
    return parts[0], int(parts[1]), int(parts[2]), int(parts[3])


def set_spool_dir(path: Optional[str]) -> None:
    """Divert puts in THIS process to spool files (task workers)."""
    global _spool_dir
    if path is not None:
        import os

        os.makedirs(path, exist_ok=True)
    _spool_dir = path


def spool_file(spool_dir: str, path: str) -> Optional[str]:
    key = parse_path(path)
    if key is None:
        return None
    import os

    return os.path.join(
        spool_dir, f"{key[0]}__{key[1]}__{key[2]}__{key[3]}.arrow"
    )


def absorb_spooled(spool_dir: str, path: str) -> bool:
    """Parent side: move a worker's spooled partition into this
    process's store (memory-map, copy into an owned buffer, unlink)."""
    import time

    key = parse_path(path)
    f = spool_file(spool_dir, path)
    if key is None or f is None:
        return False
    import os

    try:
        # no exists() pre-check: a janitor sweep or a duplicate task
        # completion can unlink between check and open (TOCTOU) — treat
        # any filesystem race as "not spooled" and let the caller warn
        with open(f, "rb") as fh:
            buf = pa.py_buffer(fh.read())
        os.unlink(f)
    except OSError:
        return False
    with _lock:
        _store[key] = buf
        _job_touched[key[0]] = time.monotonic()
    return True


def put(
    job_id: str,
    stage_id: int,
    out_part: int,
    in_part: int,
    schema: pa.Schema,
    batches: List[pa.RecordBatch],
) -> str:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, schema) as writer:
        for b in batches:
            writer.write_batch(b)
    return put_buffer(job_id, stage_id, out_part, in_part, sink.getvalue())


def put_buffer(
    job_id: str, stage_id: int, out_part: int, in_part: int, buf: pa.Buffer
) -> str:
    """Store an already-serialized IPC stream buffer.

    The write-side sink streams batches into its own IPC writer as they
    arrive (optionally compressed) and hands the finished buffer here, so
    the partition is never double-buffered as a Python batch list on top
    of its serialized bytes."""
    import time

    key = (job_id, stage_id, out_part, in_part)
    path = make_path(*key)
    if _spool_dir is not None:
        import os

        f = spool_file(_spool_dir, path)
        tmp = f + ".tmp.%d" % os.getpid()
        with open(tmp, "wb") as fh:
            fh.write(buf)
        os.replace(tmp, f)  # atomic: a retried task never sees half a file
        return path
    with _lock:
        _store[key] = buf
        _job_touched[job_id] = time.monotonic()
    return path


def put_size(path: str) -> int:
    if _spool_dir is not None:
        import os

        f = spool_file(_spool_dir, path)
        if f is not None and os.path.exists(f):
            return os.path.getsize(f)
    key = parse_path(path)
    with _lock:
        buf = _store.get(key) if key else None
    return buf.size if buf is not None else 0


def get_buffer(path: str) -> Optional[pa.Buffer]:
    """The stored partition's raw serialized IPC stream buffer (None on
    miss).  The zero-copy read path: consumers reopen it with
    ``pa.ipc.open_stream`` and every batch is a view over these bytes —
    and the Flight service hands the same buffer to the wire without
    materializing a batch list first."""
    key = parse_path(path)
    if key is None:
        return None
    with _lock:
        return _store.get(key)


def get(path: str) -> Optional[Tuple[pa.Schema, List[pa.RecordBatch]]]:
    buf = get_buffer(path)
    if buf is None:
        return None
    with pa.ipc.open_stream(buf) as reader:
        batches = list(reader)
        return reader.schema, batches


def delete_job(job_id: str) -> int:
    with _lock:
        keys = [k for k in _store if k[0] == job_id]
        for k in keys:
            del _store[k]
        _job_touched.pop(job_id, None)
    return len(keys)


def sweep(ttl_s: float) -> List[str]:
    """Drop jobs idle longer than ttl_s (the janitor's memory analogue of
    the work-dir sweep)."""
    import time

    # monotonic ages: a wall-clock jump must not mass-evict live jobs
    now = time.monotonic()
    with _lock:
        stale = [j for j, t in _job_touched.items() if now - t > ttl_s]
    for j in stale:
        delete_job(j)
    return stale


def job_ids() -> List[str]:
    with _lock:
        return sorted({k[0] for k in _store})


def job_entries(job_id: str) -> List[Tuple[str, pa.Buffer]]:
    """(path, serialized IPC stream buffer) for every stored partition of
    one job — the drain-time replica upload walks these."""
    with _lock:
        return [
            (make_path(*k), buf) for k, buf in _store.items() if k[0] == job_id
        ]


def stored_bytes() -> int:
    with _lock:
        return sum(buf.size for buf in _store.values())


def clear() -> None:
    with _lock:
        _store.clear()
        _job_touched.clear()
