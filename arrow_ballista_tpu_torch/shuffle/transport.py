"""Shuffle transport selection: a DELIBERATE local-vs-Flight decision.

The original reduce-side read picked its transport by accident: a bare
``os.path.exists(loc.path)`` probe decided "local".  On one host that is
usually right; on a multi-host deployment without a shared filesystem a
coincidentally-existing path silently reads the WRONG file (another
executor's work_dir laid out the same way, a stale previous run) as
shuffle input — a correctness bug, not just a slow path.

This module replaces the probe with executor HOST IDENTITY:

* every executor registers its ``(executor_id, host)`` here at
  construction (``Executor.__init__``) and unregisters at shutdown —
  including the process-isolated task-runner worker, which inherits the
  parent executor's advertised host;
* a location is served locally iff its ``executor_meta`` matches a
  registered local identity: same executor id, or same (normalized)
  host — two executors on one machine share a filesystem, so each can
  mmap the other's partition files directly;
* a process that never hosted an executor (a client collecting results,
  a test harness, a micro-benchmark) has no foreign shuffle inputs to
  alias against, so it keeps the existence-probe fallback.

Local reads go through :func:`read_local_batches` — ``pa.memory_map`` +
IPC file reader, so every yielded batch is a zero-copy view of the page
cache (the Zerrow property end to end: the bytes the map side wrote are
the bytes the reduce side consumes, no serialize→gRPC→deserialize hop
for data that never leaves the host).

``ballista.shuffle.local_transport`` (:class:`fetcher.FetchPolicy`)
selects the mode: ``auto`` (identity-gated, the default) or ``off``
(always Flight — the forced-remote leg of the locality A/B bench).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterator

import pyarrow as pa

# transport verdicts for one location
LOCAL = "local"
FLIGHT = "flight"

_LOOPBACK = {"localhost", "127.0.0.1", "::1", "[::1]"}

_lock = threading.Lock()
# executor_id -> normalized host; multiple executors may share a host
# (standalone clusters register several loopback executors per process)
_local_executors: Dict[str, str] = {}


def normalize_host(host: str) -> str:
    """Hostname normalization for identity matching: case-folded, with
    every loopback spelling collapsed to ``127.0.0.1`` so a location
    advertised as ``localhost`` matches an executor registered as
    ``127.0.0.1`` (they are the same filesystem)."""
    h = (host or "").strip().lower()
    return "127.0.0.1" if h in _LOOPBACK else h


def register_local_executor(executor_id: str, host: str) -> None:
    """Record that ``executor_id`` (advertising ``host``) runs in THIS
    process — its partitions, and any same-host executor's, are local."""
    if not executor_id:
        return
    with _lock:
        _local_executors[executor_id] = normalize_host(host)


def unregister_local_executor(executor_id: str) -> None:
    with _lock:
        _local_executors.pop(executor_id, None)


def clear_local_executors() -> None:
    """Test aid: forget every registered identity."""
    with _lock:
        _local_executors.clear()


def local_identities() -> Dict[str, str]:
    with _lock:
        return dict(_local_executors)


def has_local_identity() -> bool:
    with _lock:
        return bool(_local_executors)


def is_local_location(loc) -> bool:
    """Does ``loc``'s serving executor share this process's machine?
    True on executor-id match (same process / same executor) or on
    normalized-host match (different executor, same machine — shared
    filesystem).  False whenever no identity is registered: the caller
    decides what a bare process may probe."""
    meta = getattr(loc, "executor_meta", None)
    if meta is None:
        return False
    eid = getattr(meta, "id", "") or ""
    host = normalize_host(getattr(meta, "host", "") or "")
    with _lock:
        if eid and eid in _local_executors:
            return True
        return bool(host) and host in _local_executors.values()


def decide(loc, local_transport: str = "auto") -> str:
    """Transport verdict for one file-backed location: :data:`LOCAL` or
    :data:`FLIGHT`.  (mem:// and external-store locations are dispatched
    before this — they have their own stores.)

    ``auto``: local on identity match; a process with NO registered
    executor falls back to the existence probe (see module docstring).
    ``off``: always Flight — the forced-remote A/B leg.
    """
    if local_transport == "off":
        return FLIGHT
    if is_local_location(loc):
        return LOCAL
    if not has_local_identity():
        # bare client/test process: no identity to alias against
        path = getattr(loc, "path", "")
        if path and os.path.exists(path):
            return LOCAL
    return FLIGHT


def read_local_batches(path: str) -> Iterator[pa.RecordBatch]:
    """Zero-copy stream of one local partition file: every batch is a
    view over the memory-mapped file (page cache), not a copy — the
    same serving path the Flight server uses, minus the wire.  Falls
    back to buffered reads on filesystems without mmap.  Raises
    ``FileNotFoundError`` into the retry/replica/recovery machinery when
    the file vanished (janitor sweep, lost with its executor)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such local shuffle partition {path!r}")
    try:
        source = pa.memory_map(path, "rb")
    except Exception:  # pragma: no cover - mmap-less filesystems
        source = pa.OSFile(path, "rb")
    try:
        reader = pa.ipc.open_file(source)
    except BaseException:
        source.close()
        raise
    try:
        for i in range(reader.num_record_batches):
            yield reader.get_batch(i)
    finally:
        source.close()
