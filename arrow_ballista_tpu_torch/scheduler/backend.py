"""Pluggable scheduler state backend.

Counterpart of the reference's ``scheduler/src/state/backend/``:
``StateBackend`` (trait, `mod.rs:63-112`) over seven keyspaces with
get / get_from_prefix / scan / scan_keys / put / put_txn / mv / lock /
watch / delete; an in-memory implementation (the testing default) and a
SQLite implementation filling the embedded-sled role ("standalone.rs") —
scheduler state survives restarts in a single file.  An etcd-style remote
backend slot is left open behind the same ABC (the python etcd3 client is
not in this image; the class raises a clear error if selected).
"""

from __future__ import annotations

import sqlite3
import threading
from abc import ABC, abstractmethod
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple


class Keyspace(str, Enum):
    Executors = "executors"
    ActiveJobs = "active_jobs"
    CompletedJobs = "completed_jobs"
    FailedJobs = "failed_jobs"
    Slots = "slots"
    Sessions = "sessions"
    Heartbeats = "heartbeats"
    # scheduler liveness lives APART from executor heartbeats: the
    # executor-manager watches Heartbeats with an empty prefix and decodes
    # every event as ExecutorHeartbeat protobuf
    Schedulers = "schedulers"
    # durable admission-queue WAL: "q:"-prefixed entries keyed by submit
    # order (zero-padded sequence), "c:"-prefixed cancel intents and
    # "t:"-prefixed submit idempotency tokens (see queue_wal.py)
    QueueWal = "queue_wal"


class WatchEvent:
    PUT = "put"
    DELETE = "delete"

    def __init__(self, kind: str, key: str, value: Optional[bytes]):
        self.kind = kind
        self.key = key
        self.value = value

    def __repr__(self) -> str:
        return f"WatchEvent({self.kind}, {self.key!r})"


Watcher = Callable[[WatchEvent], None]


class StateBackend(ABC):
    """All methods are thread-safe."""

    @abstractmethod
    def get(self, keyspace: Keyspace, key: str) -> Optional[bytes]: ...

    @abstractmethod
    def get_from_prefix(
        self, keyspace: Keyspace, prefix: str
    ) -> List[Tuple[str, bytes]]: ...

    @abstractmethod
    def scan(self, keyspace: Keyspace) -> List[Tuple[str, bytes]]: ...

    @abstractmethod
    def put(self, keyspace: Keyspace, key: str, value: bytes) -> None: ...

    @abstractmethod
    def put_txn(
        self, ops: List[Tuple[Keyspace, str, bytes]], fence=None
    ) -> None:
        """Atomically apply several puts.  ``fence`` (optional) is the
        lock object guarding the write: remote lease backends reject the
        transaction if the lease lapsed (fencing token); local backends
        ignore it — in-process mutual exclusion is already total."""

    @abstractmethod
    def mv(
        self, from_keyspace: Keyspace, to_keyspace: Keyspace, key: str
    ) -> None: ...

    @abstractmethod
    def delete(self, keyspace: Keyspace, key: str) -> None: ...

    def scan_keys(self, keyspace: Keyspace) -> List[str]:
        return [k for k, _ in self.scan(keyspace)]

    # ---- locking ----
    @abstractmethod
    def lock(self, keyspace: Keyspace, key: str) -> threading.Lock:
        """A process-wide lock scoped to (keyspace, key); the reference uses
        this for atomic slot accounting (`executor_manager.rs:121-167`)."""

    # ---- watches ----
    @abstractmethod
    def watch(self, keyspace: Keyspace, prefix: str, watcher: Watcher) -> Callable:
        """Register a callback for put/delete events under a prefix; returns
        an unsubscribe function."""


class _WatchMixin:
    def _init_watches(self) -> None:
        self._watchers: Dict[Keyspace, List[Tuple[str, Watcher]]] = {}
        self._watch_lock = threading.Lock()

    def watch(self, keyspace: Keyspace, prefix: str, watcher: Watcher) -> Callable:
        entry = (prefix, watcher)
        with self._watch_lock:
            self._watchers.setdefault(keyspace, []).append(entry)

        def unsubscribe() -> None:
            with self._watch_lock:
                try:
                    self._watchers[keyspace].remove(entry)
                except ValueError:
                    pass

        return unsubscribe

    def _notify(self, keyspace: Keyspace, event: WatchEvent) -> None:
        with self._watch_lock:
            targets = [
                w
                for prefix, w in self._watchers.get(keyspace, [])
                if event.key.startswith(prefix)
            ]
        for w in targets:
            try:
                w(event)
            except Exception:  # noqa: BLE001 - watcher errors don't poison puts
                pass


class _LockMixin:
    def _init_locks(self) -> None:
        self._locks: Dict[Tuple[Keyspace, str], threading.Lock] = {}
        self._locks_guard = threading.Lock()

    def lock(self, keyspace: Keyspace, key: str) -> threading.Lock:
        with self._locks_guard:
            lk = self._locks.get((keyspace, key))
            if lk is None:
                lk = threading.Lock()
                self._locks[(keyspace, key)] = lk
            return lk


class MemoryBackend(_WatchMixin, _LockMixin, StateBackend):
    """Dict-backed backend — the in-proc default (standalone mode, tests)."""

    def __init__(self) -> None:
        self._data: Dict[Keyspace, Dict[str, bytes]] = {k: {} for k in Keyspace}
        self._guard = threading.RLock()
        self._init_watches()
        self._init_locks()

    def get(self, keyspace: Keyspace, key: str) -> Optional[bytes]:
        with self._guard:
            return self._data[keyspace].get(key)

    def get_from_prefix(self, keyspace, prefix):
        with self._guard:
            return [
                (k, v) for k, v in self._data[keyspace].items() if k.startswith(prefix)
            ]

    def scan(self, keyspace):
        with self._guard:
            return list(self._data[keyspace].items())

    def put(self, keyspace, key, value):
        with self._guard:
            self._data[keyspace][key] = value
        self._notify(keyspace, WatchEvent(WatchEvent.PUT, key, value))

    def put_txn(self, ops, fence=None):
        with self._guard:
            for ks, k, v in ops:
                self._data[ks][k] = v
        for ks, k, v in ops:
            self._notify(ks, WatchEvent(WatchEvent.PUT, k, v))

    def mv(self, from_keyspace, to_keyspace, key):
        with self._guard:
            v = self._data[from_keyspace].pop(key, None)
            if v is not None:
                self._data[to_keyspace][key] = v
        if v is not None:
            self._notify(from_keyspace, WatchEvent(WatchEvent.DELETE, key, None))
            self._notify(to_keyspace, WatchEvent(WatchEvent.PUT, key, v))

    def delete(self, keyspace, key):
        with self._guard:
            existed = self._data[keyspace].pop(key, None) is not None
        if existed:
            self._notify(keyspace, WatchEvent(WatchEvent.DELETE, key, None))


class SqliteBackend(_WatchMixin, _LockMixin, StateBackend):
    """Single-file durable backend (the sled 'standalone' counterpart)."""

    def __init__(self, path: str):
        self.path = path
        self._guard = threading.RLock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            " keyspace TEXT NOT NULL, key TEXT NOT NULL, value BLOB NOT NULL,"
            " PRIMARY KEY (keyspace, key))"
        )
        self._conn.commit()
        self._init_watches()
        self._init_locks()

    def get(self, keyspace, key):
        with self._guard:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE keyspace=? AND key=?",
                (keyspace.value, key),
            ).fetchone()
        return row[0] if row else None

    def get_from_prefix(self, keyspace, prefix):
        with self._guard:
            rows = self._conn.execute(
                "SELECT key, value FROM kv WHERE keyspace=? AND key GLOB ?",
                (keyspace.value, prefix + "*"),
            ).fetchall()
        return [(k, v) for k, v in rows]

    def scan(self, keyspace):
        with self._guard:
            rows = self._conn.execute(
                "SELECT key, value FROM kv WHERE keyspace=?", (keyspace.value,)
            ).fetchall()
        return [(k, v) for k, v in rows]

    def put(self, keyspace, key, value):
        with self._guard:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (keyspace, key, value) VALUES (?,?,?)",
                (keyspace.value, key, value),
            )
            self._conn.commit()
        self._notify(keyspace, WatchEvent(WatchEvent.PUT, key, value))

    def put_txn(self, ops, fence=None):
        with self._guard:
            for ks, k, v in ops:
                self._conn.execute(
                    "INSERT OR REPLACE INTO kv (keyspace, key, value) VALUES (?,?,?)",
                    (ks.value, k, v),
                )
            self._conn.commit()
        for ks, k, v in ops:
            self._notify(ks, WatchEvent(WatchEvent.PUT, k, v))

    def mv(self, from_keyspace, to_keyspace, key):
        with self._guard:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE keyspace=? AND key=?",
                (from_keyspace.value, key),
            ).fetchone()
            if row is None:
                return
            self._conn.execute(
                "DELETE FROM kv WHERE keyspace=? AND key=?",
                (from_keyspace.value, key),
            )
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (keyspace, key, value) VALUES (?,?,?)",
                (to_keyspace.value, key, row[0]),
            )
            self._conn.commit()
        self._notify(from_keyspace, WatchEvent(WatchEvent.DELETE, key, None))
        self._notify(to_keyspace, WatchEvent(WatchEvent.PUT, key, row[0]))

    def delete(self, keyspace, key):
        with self._guard:
            cur = self._conn.execute(
                "DELETE FROM kv WHERE keyspace=? AND key=?", (keyspace.value, key)
            )
            self._conn.commit()
            existed = cur.rowcount > 0
        if existed:
            self._notify(keyspace, WatchEvent(WatchEvent.DELETE, key, None))

    def close(self) -> None:
        with self._guard:
            self._conn.close()


def EtcdBackend(endpoints: str, namespace: str = "ballista"):
    """Remote HA backend (the reference's etcd slot, ``backend/etcd.rs``).

    This image has no etcd3 client, so the same semantics — shared remote
    store, transactional puts, lease locks with TTL expiry, prefix watches
    — are served by this repo's own KvStoreGrpc service
    (:mod:`.kvstore`): run ``python -m arrow_ballista_tpu_torch.scheduler.kvstore``
    (optionally over sqlite for durability) and point every scheduler's
    ``--state-backend etcd --etcd-urls host:port`` at it.
    """
    from .kvstore import RemoteBackend

    # comma lists are live failover spares: the client rotates to the
    # next endpoint on UNAVAILABLE (a backup kvstore refuses to serve
    # until it promotes, so rotation settles on the current primary)
    from .kvstore import parse_endpoint

    eps = [e.strip() for e in endpoints.split(",") if e.strip()]
    host, port = parse_endpoint(eps[0] if eps else "")
    return RemoteBackend(
        host, port, namespace=namespace,
        endpoints=eps if len(eps) > 1 else None,
    )


def create_backend(kind: str, path: Optional[str] = None) -> StateBackend:
    if kind in ("memory", "standalone"):
        return MemoryBackend()
    if kind == "sqlite":
        if not path:
            raise ValueError("sqlite backend needs a path")
        return SqliteBackend(path)
    if kind == "etcd":
        return EtcdBackend(path or "")
    raise ValueError(f"unknown state backend {kind!r}")
