"""Remote etcd-semantics state store: the HA substrate.

Counterpart of the reference's etcd backend
(``scheduler/src/state/backend/etcd.rs:37-345``): several schedulers share
ONE external store so any of them can take over a peer's jobs.  The python
etcd3 client isn't in this image, so the same semantics ride this repo's
own gRPC service (``KvStoreGrpc`` in ballista.proto):

* transactional multi-put (etcd Txn ↔ ``PutTxn`` over the local backend's
  ``put_txn``);
* distributed locks as LEASES with TTL auto-expiry (etcd lock + keep-alive
  ↔ ``Lock``/``Unlock`` with ``ttl_s``; a crashed holder's lease simply
  expires, `etcd.rs:333-345`);
* prefix watches as server streams (etcd watch ↔ ``Watch``).

``KvStoreServer`` wraps any local :class:`StateBackend` (sqlite for
durability); ``RemoteBackend`` implements the ``StateBackend`` ABC over
the stub so the whole scheduler state layer runs unchanged against the
shared store.  ``python -m arrow_ballista_tpu_torch.scheduler.kvstore`` runs a
standalone store; ``--replica-of`` starts an async primary/backup pair
(:class:`_Replicator` — the raft-replication slot) with client-side
endpoint rotation filling the failover path.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import grpc

from ..proto import pb
from ..proto.rpc import (
    GRPC_OPTIONS,
    KvStoreGrpcStub,
    add_kvstore_servicer,
    make_channel,
    make_server,
)
from .backend import Keyspace, StateBackend, WatchEvent, Watcher

log = logging.getLogger(__name__)

DEFAULT_LOCK_TTL_S = 30.0
DEFAULT_LOCK_WAIT_S = 20.0


def parse_endpoint(ep: str) -> Tuple[str, int]:
    """One "host:port" → (host, port) with the store's defaults."""
    h, _, pt = ep.strip().partition(":")
    return h or "127.0.0.1", int(pt or 50060)


class LeaseFenced(Exception):
    """A fenced transaction was rejected: the guarding lease expired or
    changed hands between the write's dispatch and its application."""


# ------------------------------------------------------------------ server
class _Lease:
    __slots__ = ("owner", "expires", "token")

    def __init__(self, owner: str, expires: float, token: int):
        self.owner = owner
        self.expires = expires
        self.token = token


class KvStoreService:
    """gRPC servicer over a local StateBackend + lease table.

    ``role``: a store started with ``replica_of`` serves NOTHING while
    its primary lives — every RPC aborts UNAVAILABLE so rotating clients
    bounce back to the primary — and self-promotes to ``primary`` when
    the health loop loses the primary for ``promote_after_s``.  The
    lease table is deliberately NOT replicated: an empty table after
    failover means every pre-failover fenced write is rejected
    (conservative — exactly the store-restart semantics
    ``tests/test_ha_failover.py`` proves the cluster converges through).
    """

    def __init__(self, backend: StateBackend, role: str = "primary"):
        self.backend = backend
        self.role = role
        self._leases: Dict[Tuple[str, str], _Lease] = {}
        self._lease_guard = threading.Lock()
        self._next_token = 0  # guarded by _lease_guard

    def promote(self) -> None:
        if self.role != "primary":
            log.warning("kvstore replica promoting to primary")
            self.role = "primary"

    def _serving(self, ctx) -> None:
        if self.role != "primary":
            ctx.abort(
                grpc.StatusCode.UNAVAILABLE,
                "replica: not serving while the primary is alive",
            )

    # ---- kv ----
    def Get(self, req: pb.KvGetParams, ctx) -> pb.KvGetResult:
        self._serving(ctx)
        v = self.backend.get(Keyspace(req.keyspace), req.key)
        return pb.KvGetResult(found=v is not None, value=v or b"")

    def GetFromPrefix(self, req: pb.KvScanParams, ctx) -> pb.KvScanResult:
        self._serving(ctx)
        pairs = self.backend.get_from_prefix(Keyspace(req.keyspace), req.prefix)
        return pb.KvScanResult(
            pairs=[pb.KvPair(key=k, value=v) for k, v in pairs]
        )

    def Scan(self, req: pb.KvScanParams, ctx) -> pb.KvScanResult:
        self._serving(ctx)
        pairs = self.backend.scan(Keyspace(req.keyspace))
        if req.prefix:
            pairs = [(k, v) for k, v in pairs if k.startswith(req.prefix)]
        return pb.KvScanResult(
            pairs=[pb.KvPair(key=k, value=v) for k, v in pairs]
        )

    def Put(self, req: pb.KvPutParams, ctx) -> pb.KvPutResult:
        self._serving(ctx)
        self.backend.put(Keyspace(req.keyspace), req.key, req.value)
        return pb.KvPutResult()

    def PutTxn(self, req: pb.KvTxnParams, ctx) -> pb.KvTxnResult:
        self._serving(ctx)
        if req.HasField("fence"):
            f = req.fence
            now = time.monotonic()
            with self._lease_guard:
                lease = self._leases.get((f.keyspace, f.key))
                ok = (
                    lease is not None
                    and lease.expires > now
                    and lease.owner == f.owner
                    and lease.token == f.token
                )
                if ok:
                    # apply under the guard: the lease cannot expire or
                    # be re-granted between the check and the write
                    self.backend.put_txn(
                        [
                            (Keyspace(op.keyspace), op.key, op.value)
                            for op in req.ops
                        ]
                    )
                    return pb.KvTxnResult()
            ctx.abort(
                grpc.StatusCode.ABORTED,
                f"fenced: lease {f.keyspace}/{f.key} no longer held by "
                f"{f.owner} with token {f.token}",
            )
        self.backend.put_txn(
            [(Keyspace(op.keyspace), op.key, op.value) for op in req.ops]
        )
        return pb.KvTxnResult()

    def Mv(self, req: pb.KvMvParams, ctx) -> pb.KvMvResult:
        self._serving(ctx)
        self.backend.mv(
            Keyspace(req.from_keyspace), Keyspace(req.to_keyspace), req.key
        )
        return pb.KvMvResult()

    def Delete(self, req: pb.KvDeleteParams, ctx) -> pb.KvDeleteResult:
        self._serving(ctx)
        self.backend.delete(Keyspace(req.keyspace), req.key)
        return pb.KvDeleteResult()

    # ---- leases ----
    def Lock(self, req: pb.KvLockParams, ctx) -> pb.KvLockResult:
        self._serving(ctx)
        ttl = req.ttl_s or DEFAULT_LOCK_TTL_S
        wait = req.wait_s if req.wait_s > 0 else DEFAULT_LOCK_WAIT_S
        key = (req.keyspace, req.key)
        deadline = time.monotonic() + wait
        while True:
            now = time.monotonic()
            with self._lease_guard:
                lease = self._leases.get(key)
                if lease is not None and lease.owner == req.owner and (
                    lease.expires > now
                ):
                    # keep-alive refresh of a LIVE lease: extend the
                    # expiry, keep the grant's fencing token
                    lease.expires = now + ttl
                    return pb.KvLockResult(acquired=True, token=lease.token)
                if lease is None or lease.expires <= now:
                    self._next_token += 1
                    self._leases[key] = _Lease(
                        req.owner, now + ttl, self._next_token
                    )
                    return pb.KvLockResult(
                        acquired=True, token=self._next_token
                    )
            if now >= deadline:
                return pb.KvLockResult(acquired=False)
            time.sleep(0.01)

    def Unlock(self, req: pb.KvUnlockParams, ctx) -> pb.KvUnlockResult:
        self._serving(ctx)
        key = (req.keyspace, req.key)
        with self._lease_guard:
            lease = self._leases.get(key)
            if lease is not None and lease.owner == req.owner:
                del self._leases[key]
        return pb.KvUnlockResult()

    # ---- watch ----
    def Watch(self, req: pb.KvWatchParams, ctx):
        self._serving(ctx)
        q: "queue.Queue[WatchEvent]" = queue.Queue()
        unsub = self.backend.watch(
            Keyspace(req.keyspace), req.prefix, q.put
        )
        try:
            while ctx.is_active():
                try:
                    ev = q.get(timeout=0.25)
                except queue.Empty:
                    continue
                yield pb.KvWatchEvent(
                    kind=ev.kind, key=ev.key, value=ev.value or b""
                )
        finally:
            unsub()


class _Replicator(threading.Thread):
    """Primary/backup replication (the raft-replication slot, kept
    deliberately simple): full-sync every keyspace from the primary,
    then follow its watch streams applying puts/deletes to the local
    backend; a health loop Gets a sentinel key every ``poll_s`` and
    PROMOTES the local service after ``promote_after_s`` without a
    successful round-trip.  Replication is asynchronous — a write the
    primary acknowledged in its final ``poll_s`` may be lost on
    failover, the standard async-replica contract; scheduler state is
    heartbeat/slot/graph churn that the cluster re-converges (fencing
    rejects every pre-failover lease, and restart-resume replays
    in-flight work)."""

    def __init__(
        self,
        service: KvStoreService,
        primary_host: str,
        primary_port: int,
        promote_after_s: float = 5.0,
        poll_s: float = 0.5,
    ):
        super().__init__(name="kv-replicator", daemon=True)
        self.service = service
        self.host = primary_host
        self.port = primary_port
        self.promote_after_s = promote_after_s
        self.poll_s = poll_s
        self._stop = threading.Event()
        self.synced = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def _full_sync(self, stub) -> None:
        backend = self.service.backend
        for ks in Keyspace:
            res = stub.Scan(pb.KvScanParams(keyspace=ks.value))
            remote = {p.key: p.value for p in res.pairs}
            # reconcile DELETIONS too: a resync after a stream outage
            # must not resurrect keys the primary removed in the gap
            for k in backend.scan_keys(ks):
                if k not in remote:
                    backend.delete(ks, k)
            ops = [(ks, k, v) for k, v in remote.items()]
            if ops:
                backend.put_txn(ops)

    def _follow(self, stub, ks: Keyspace) -> None:
        backend = self.service.backend
        try:
            for ev in stub.Watch(
                pb.KvWatchParams(keyspace=ks.value, prefix="")
            ):
                if self._stop.is_set() or self.service.role == "primary":
                    return
                if ev.kind == WatchEvent.PUT:
                    backend.put(ks, ev.key, ev.value)
                else:
                    backend.delete(ks, ev.key)
        except Exception:  # noqa: BLE001 - dead stream: health loop resyncs
            return

    def run(self) -> None:
        channel = make_channel(self.host, self.port)
        stub = KvStoreGrpcStub(channel)
        followers: List[threading.Thread] = []
        last_ok = time.monotonic()
        synced = False
        while not self._stop.is_set():
            # dead follower streams mean replication has stopped even if
            # health Gets succeed (e.g. the primary bounced fast):
            # resync on the next healthy tick, not only after a failure
            if synced and not all(t.is_alive() for t in followers):
                synced = False
            try:
                if not synced:
                    # watches before the scan so no event is missed; the
                    # converse race (the snapshot overwriting a newer
                    # concurrently-applied event) lasts one churn cycle
                    # of that key — acceptable for an ASYNC replica and
                    # bounded by the scheduler's constant heartbeat/slot
                    # rewrites
                    followers = [
                        threading.Thread(
                            target=self._follow, args=(stub, ks), daemon=True
                        )
                        for ks in Keyspace
                    ]
                    for t in followers:
                        t.start()
                    self._full_sync(stub)
                    synced = True
                    self.synced.set()
                stub.Get(
                    pb.KvGetParams(
                        keyspace=Keyspace.Sessions.value, key="__health__"
                    )
                )
                last_ok = time.monotonic()
            except Exception:  # noqa: BLE001 - primary unreachable
                if time.monotonic() - last_ok > self.promote_after_s:
                    if self.synced.is_set():
                        self.service.promote()
                        channel.close()
                        return
                    # NEVER promote a store that has not completed one
                    # sync this lifetime: a backup booted while the
                    # primary is down would otherwise serve an empty
                    # (or arbitrarily stale) store as the new truth
                    log.warning(
                        "kvstore replica: primary unreachable but no "
                        "sync completed yet — refusing to promote"
                    )
                    last_ok = time.monotonic()  # keep waiting
            if self._stop.wait(self.poll_s):
                break
        channel.close()


class KvStoreHandle:
    """Background KV store server with clean shutdown.

    ``replica_of`` starts the store as a follower of ``(host, port)`` —
    see :class:`_Replicator`.  ``peer`` (on the PRIMARY) closes the
    restart split-brain: before serving, the store probes its peer once
    and, if the peer is already serving as primary (a promoted backup),
    comes up as the peer's REPLICA instead — so a supervisor-restarted
    old primary demotes instead of fighting the promotion."""

    def __init__(
        self,
        backend: StateBackend,
        host: str = "127.0.0.1",
        port: int = 0,
        replica_of: Optional[Tuple[str, int]] = None,
        promote_after_s: float = 5.0,
        peer: Optional[Tuple[str, int]] = None,
    ):
        self.promote_after_s = promote_after_s
        self.service = KvStoreService(
            backend, role="replica" if replica_of else "primary"
        )
        self.server = make_server()
        add_kvstore_servicer(self.server, self.service)
        self.port = self.server.add_insecure_port(f"{host}:{port}")
        self.host = host
        self._peer = peer
        self.replicator: Optional[_Replicator] = None
        if replica_of:
            self.replicator = _Replicator(
                self.service, replica_of[0], replica_of[1],
                promote_after_s=promote_after_s,
            )

    def _peer_is_primary(self) -> bool:
        if self._peer is None:
            return False
        channel = make_channel(*self._peer)
        try:
            KvStoreGrpcStub(channel).Get(
                pb.KvGetParams(
                    keyspace=Keyspace.Sessions.value, key="__health__"
                ),
                timeout=2.0,
            )
            return True  # peer answered: it is serving as primary
        except Exception:  # noqa: BLE001 - unreachable or replica
            return False
        finally:
            channel.close()

    def start(self) -> "KvStoreHandle":
        if self.service.role == "primary" and self._peer_is_primary():
            # the peer promoted while this store was down: demote
            log.warning(
                "kvstore: peer %s:%d is serving as primary — starting "
                "as its replica", *self._peer
            )
            self.service.role = "replica"
            self.replicator = _Replicator(
                self.service, self._peer[0], self._peer[1],
                promote_after_s=self.promote_after_s,
            )
        self.server.start()
        if self.replicator is not None:
            self.replicator.start()
        return self

    def stop(self) -> None:
        if self.replicator is not None:
            self.replicator.stop()
        self.server.stop(grace=1.0)


# ------------------------------------------------------------------ client
class _RemoteLock:
    """Context-manager lock over the store's lease API (etcd lock shape:
    acquire with TTL, release explicitly, expire on crash).

    While held, a daemon refresher thread re-Locks every ``ttl/3`` —
    etcd's lease keep-alive (`etcd.rs:333-345`) — so an operation that
    outlives the TTL keeps its lease instead of silently losing it.  If a
    refresh ever comes back with a DIFFERENT token (the lease lapsed and
    was re-granted, i.e. another owner could have acted in the gap) the
    lock marks itself ``lost`` and stops refreshing; fenced writes
    carrying the original token are then rejected by the store.
    """

    def __init__(
        self, backend, keyspace: str, key: str, owner: str,
        ttl_s: float = DEFAULT_LOCK_TTL_S,
    ):
        # `backend` is the owning RemoteBackend: lock RPCs ride its
        # endpoint-rotating _call so leases survive a store failover
        # (acquired fresh on the promoted primary; fencing covers the gap)
        self._backend = backend
        self._keyspace = keyspace
        self._key = key
        self._owner = owner
        self._ttl = ttl_s
        self.token: Optional[int] = None
        self.lost = False
        self._stop: Optional[threading.Event] = None

    def acquire(self, timeout: Optional[float] = None) -> bool:
        res = self._backend._call("Lock",
            pb.KvLockParams(
                keyspace=self._keyspace,
                key=self._key,
                owner=self._owner,
                ttl_s=self._ttl,
                wait_s=timeout or 0.0,
            )
        )
        if res.acquired:
            self.token = res.token
            self.lost = False
            self._start_keepalive()
        return res.acquired

    def _start_keepalive(self) -> None:
        self._stop = stop = threading.Event()
        interval = max(0.05, self._ttl / 3.0)

        def refresh():
            while not stop.wait(interval):
                try:
                    res = self._backend._call("Lock",
                        pb.KvLockParams(
                            keyspace=self._keyspace,
                            key=self._key,
                            owner=self._owner,
                            ttl_s=self._ttl,
                            wait_s=0.001,
                        )
                    )
                except Exception:  # store away: next write gets fenced
                    continue
                if not res.acquired or res.token != self.token:
                    if res.acquired:
                        # we re-won a NEW grant after a gap: release it —
                        # the original critical section must not continue
                        # under a token its fenced writes don't carry
                        try:
                            self._unlock()
                        except Exception:
                            pass
                    self.lost = True
                    return

        t = threading.Thread(
            target=refresh,
            name=f"kv-lease-{self._keyspace}/{self._key}",
            daemon=True,
        )
        t.start()

    def _unlock(self) -> None:
        self._backend._call(
            "Unlock",
            pb.KvUnlockParams(
                keyspace=self._keyspace, key=self._key, owner=self._owner
            ),
        )

    def release(self) -> None:
        if self._stop is not None:
            self._stop.set()
            self._stop = None
        self._unlock()

    def fence(self) -> pb.KvFence:
        return pb.KvFence(
            keyspace=self._keyspace,
            key=self._key,
            owner=self._owner,
            token=self.token or 0,
        )

    def __enter__(self):
        if not self.acquire():
            raise TimeoutError(
                f"kv lock {self._keyspace}/{self._key} not acquired"
            )
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class RemoteBackend(StateBackend):
    """StateBackend over a shared KvStoreGrpc endpoint (the etcd slot).

    ``namespace`` prefixes every key (etcd's ``/ballista/{namespace}/``
    layout, `etcd.rs:49-60`): independent clusters can share one store
    without seeing each other's state.  ``endpoints`` (list of
    ``"host:port"``) enables primary/backup failover: an UNAVAILABLE
    response rotates to the next endpoint and retries — a replica
    refuses to serve while its primary lives, so rotation naturally
    settles on whichever store is currently primary.
    """

    def __init__(
        self, host: str, port: int, owner: str = "", namespace: str = "",
        endpoints: Optional[List[str]] = None,
    ):
        import uuid

        self._endpoints: List[Tuple[str, int]] = [(host, port)]
        if endpoints:
            self._endpoints = [parse_endpoint(ep) for ep in endpoints]
        self._idx = 0
        self._chan_guard = threading.Lock()
        self._channel = make_channel(*self._endpoints[0])
        self._stub = KvStoreGrpcStub(self._channel)
        self._owner = owner or uuid.uuid4().hex[:12]
        self._ns = f"{namespace}/" if namespace else ""
        self._watch_threads: List[threading.Thread] = []
        self._closed = threading.Event()

    def _rotate_from(self, stub) -> None:
        """Advance to the next endpoint — but only if ``stub`` is still
        current: when several threads hit UNAVAILABLE together, the
        first rotation wins and the rest retry the fresh endpoint
        instead of leap-frogging past the healthy store."""
        with self._chan_guard:
            if self._stub is not stub:
                return
            self._idx = (self._idx + 1) % len(self._endpoints)
            try:
                self._channel.close()
            except Exception:  # noqa: BLE001
                pass
            self._channel = make_channel(*self._endpoints[self._idx])
            self._stub = KvStoreGrpcStub(self._channel)

    def _call(self, name: str, req):
        """One RPC with endpoint failover: UNAVAILABLE rotates through
        the endpoint list (first failure wins); CANCELLED from a
        channel a concurrent rotation closed retries on the fresh stub.
        Callers retry above this layer."""
        last = None
        for _ in range(max(2, 2 * len(self._endpoints))):
            with self._chan_guard:
                stub = self._stub
            try:
                return getattr(stub, name)(req)
            except ValueError as e:
                # "Cannot invoke RPC on closed channel!": a concurrent
                # rotation closed the channel before the call started
                last = e
                with self._chan_guard:
                    fresh = self._stub is not stub
                if fresh:
                    continue
                raise
            except grpc.RpcError as e:
                last = e
                code = e.code()
                if code == grpc.StatusCode.CANCELLED:
                    with self._chan_guard:
                        fresh = self._stub is not stub
                    if fresh:
                        continue  # rotation closed it mid-call: retry
                    raise
                if (
                    code == grpc.StatusCode.UNAVAILABLE
                    and len(self._endpoints) > 1
                ):
                    self._rotate_from(stub)
                    continue
                raise
        raise last

    def _k(self, key: str) -> str:
        return self._ns + key

    def _strip(self, key: str) -> str:
        return key[len(self._ns):] if self._ns else key

    def get(self, keyspace: Keyspace, key: str) -> Optional[bytes]:
        r = self._call(
            "Get", pb.KvGetParams(keyspace=keyspace.value, key=self._k(key))
        )
        return r.value if r.found else None

    def get_from_prefix(self, keyspace, prefix):
        r = self._call(
            "GetFromPrefix",
            pb.KvScanParams(keyspace=keyspace.value, prefix=self._k(prefix)),
        )
        return [(self._strip(p.key), p.value) for p in r.pairs]

    def scan(self, keyspace):
        if self._ns:
            return self.get_from_prefix(keyspace, "")
        r = self._call("Scan", pb.KvScanParams(keyspace=keyspace.value))
        return [(p.key, p.value) for p in r.pairs]

    def put(self, keyspace, key, value):
        self._call(
            "Put",
            pb.KvPutParams(
                keyspace=keyspace.value, key=self._k(key), value=value
            ),
        )

    def put_txn(self, ops, fence=None):
        params = pb.KvTxnParams(
            ops=[
                pb.KvTxnOp(keyspace=ks.value, key=self._k(k), value=v)
                for ks, k, v in ops
            ]
        )
        # callers pass whatever backend.lock() gave them; only remote
        # leases carry a fencing token (a threading.Lock has none)
        if fence is not None and hasattr(fence, "fence"):
            params.fence.CopyFrom(fence.fence())
        try:
            self._call("PutTxn", params)
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.ABORTED:
                raise LeaseFenced(str(e.details())) from e
            raise

    def mv(self, from_keyspace, to_keyspace, key):
        self._call(
            "Mv",
            pb.KvMvParams(
                from_keyspace=from_keyspace.value,
                to_keyspace=to_keyspace.value,
                key=self._k(key),
            ),
        )

    def delete(self, keyspace, key):
        self._call(
            "Delete",
            pb.KvDeleteParams(keyspace=keyspace.value, key=self._k(key)),
        )

    def lock(
        self, keyspace: Keyspace, key: str,
        ttl_s: float = DEFAULT_LOCK_TTL_S,
    ):
        return _RemoteLock(
            self, keyspace.value, self._k(key),
            f"{self._owner}:{threading.get_ident()}",
            ttl_s=ttl_s,
        )

    def watch(self, keyspace: Keyspace, prefix: str, watcher: Watcher) -> Callable:
        stop = threading.Event()
        ns_prefix = self._k(prefix)

        def run():
            while not stop.is_set() and not self._closed.is_set():
                with self._chan_guard:
                    stub = self._stub
                try:
                    stream = stub.Watch(
                        pb.KvWatchParams(
                            keyspace=keyspace.value, prefix=ns_prefix
                        )
                    )
                    for ev in stream:
                        if stop.is_set():
                            break
                        watcher(
                            WatchEvent(
                                ev.kind, self._strip(ev.key), ev.value or None
                            )
                        )
                except Exception:  # noqa: BLE001 - incl. closed-channel ValueError
                    if stop.is_set() or self._closed.is_set():
                        return
                    if len(self._endpoints) > 1:
                        self._rotate_from(stub)  # maybe failed over
                    time.sleep(0.5)  # store restarting: retry the stream

        t = threading.Thread(target=run, name=f"kv-watch-{prefix}", daemon=True)
        t.start()
        self._watch_threads.append(t)
        return stop.set

    def close(self) -> None:
        self._closed.set()
        self._channel.close()


def main() -> None:  # pragma: no cover - thin binary wrapper
    import argparse

    from .backend import MemoryBackend, SqliteBackend

    p = argparse.ArgumentParser(prog="arrow_ballista_tpu_torch.scheduler.kvstore")
    p.add_argument("--bind-host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=50060)
    p.add_argument("--db", default="", help="sqlite path (default: memory)")
    p.add_argument(
        "--replica-of", default="",
        help="host:port of the primary store — start as an async backup "
             "that self-promotes when the primary stays unreachable",
    )
    p.add_argument(
        "--peer", default="",
        help="host:port of the backup (set on the PRIMARY): if the peer "
             "is already serving as primary at startup, this store "
             "demotes to its replica instead of split-braining",
    )
    p.add_argument(
        "--promote-after", type=float, default=5.0,
        help="seconds without a primary round-trip before promotion",
    )
    args = p.parse_args()

    logging.basicConfig(level=logging.INFO)
    backend = SqliteBackend(args.db) if args.db else MemoryBackend()
    handle = KvStoreHandle(
        backend, args.bind_host, args.port,
        replica_of=(
            parse_endpoint(args.replica_of) if args.replica_of else None
        ),
        promote_after_s=args.promote_after,
        peer=parse_endpoint(args.peer) if args.peer else None,
    ).start()
    log.info(
        "kv store serving on %s:%d (%s)", args.bind_host, handle.port,
        handle.service.role,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        handle.stop()


if __name__ == "__main__":
    main()
