"""Durable admission-queue WAL.

The admission queue holds submissions *pre-planning*: no
ExecutionGraph exists, nothing is persisted, and a scheduler crash
silently drops every queued job (and every buffered cancel intent).
This module closes that gap by journaling the queue through the state
backend — the same backend whose durability already carries active
jobs across restarts (sqlite single-file, or the replicated kvstore
for HA), so queued work inherits exactly the durability the operator
chose for running work.

Layout (one :class:`~.backend.Keyspace.QueueWal` keyspace, three
prefixes so a single prefix scan recovers each record class):

* ``q:{seq:016d}`` — one queued job, JSON: the serialized logical plan
  (base64 protobuf via :class:`~..serde.BallistaCodec`), pool/lane
  placement, pool parameters, enqueue wall-clock and expiry budget,
  plus the ``curator`` scheduler id that owns the entry.  The
  zero-padded sequence IS the submit order: replay sorts by key and
  re-enqueues in order, so fair-share positions survive (DRR deficits
  restart at zero — they are burst credit, not position).
* ``c:{job_id}`` — a buffered cancel intent (cancel raced the admit
  window); replay re-arms it so a cancel raced with a crash still
  wins.
* ``t:{token}`` — a client-minted submit idempotency token mapped to
  its job id, so a retried ExecuteQuery after failover re-attaches
  instead of double-running.  Token entries are written whenever a
  client sends one (independent of the WAL knob — they guard the
  retry path, not queue durability) and age out opportunistically.

Every write here is **best-effort**: a WAL failure must degrade
durability, never availability — the submit path proceeds and the job
simply behaves as pre-WAL (lost on crash).  With the WAL knob off
(the default) ``AdmissionController.wal`` stays ``None`` and every
hook is a no-op: the submit path is byte-identical to a scheduler
without this module.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .backend import Keyspace, StateBackend

logger = logging.getLogger(__name__)

QUEUE_PREFIX = "q:"
INTENT_PREFIX = "c:"
TOKEN_PREFIX = "t:"
# idempotency tokens only need to outlive the client's retry horizon;
# purge anything this old when the submit path happens to sweep
TOKEN_TTL_S = 3600.0


class AdmissionWal:
    """Write-ahead journal for the admission queue.

    ``curator_fn`` resolves the owning scheduler id lazily — the id is
    finalized after construction in ``__main__`` wiring, and takeover
    rewrites entries to the adopting scheduler.
    """

    def __init__(self, backend: StateBackend, curator_fn: Callable[[], str]):
        self.backend = backend
        self._curator_fn = curator_fn
        self._lock = threading.Lock()
        # job_id -> WAL key, so discard() needs no scan
        self._keys: Dict[str, str] = {}
        self._seq = self._init_seq()

    @property
    def curator(self) -> str:
        try:
            return str(self._curator_fn())
        except Exception:  # noqa: BLE001 - curator probe must not fail writes
            return ""

    def _init_seq(self) -> int:
        """Continue the sequence past every existing entry (any curator):
        submit order is global, and a takeover must not interleave new
        entries below adopted ones."""
        try:
            entries = self.backend.get_from_prefix(Keyspace.QueueWal, QUEUE_PREFIX)
            top = 0
            for key, _ in entries:
                try:
                    top = max(top, int(key[len(QUEUE_PREFIX):]))
                except ValueError:
                    continue
            return top
        except Exception:  # noqa: BLE001
            return 0

    # ------------------------------------------------------------- queue
    def append(self, qj, pool_weight: float, pool_max_running: int) -> None:
        """Journal one queued job (called under the admission lock,
        right after the in-memory enqueue)."""
        from ..serde import BallistaCodec

        with self._lock:
            self._seq += 1
            key = f"{QUEUE_PREFIX}{self._seq:016d}"
            self._keys[qj.job_id] = key
        try:
            rec = {
                "job_id": qj.job_id,
                "session_id": qj.session_id,
                "pool": qj.pool,
                "priority": qj.priority,
                "pool_weight": pool_weight,
                "pool_max_running": pool_max_running,
                "enqueued_unix": qj.enqueued_unix,
                "max_wait_s": qj.max_wait_s,
                "curator": self.curator,
                "plan": base64.b64encode(
                    BallistaCodec.encode_logical(qj.plan)
                ).decode("ascii"),
            }
            self.backend.put(
                Keyspace.QueueWal, key, json.dumps(rec).encode("utf-8")
            )
        except Exception:  # noqa: BLE001 - degrade durability, not availability
            logger.warning("admission WAL append failed for %s", qj.job_id,
                           exc_info=True)
            with self._lock:
                self._keys.pop(qj.job_id, None)

    def register(self, job_id: str, key: str) -> None:
        """Track an adopted/replayed entry so a later discard finds it."""
        with self._lock:
            self._keys[job_id] = key

    def discard(self, job_id: str) -> None:
        """The job left the queue *and* reached a durable downstream
        state (graph persisted, or terminal): drop its WAL entry."""
        with self._lock:
            key = self._keys.pop(job_id, None)
        if key is None:
            return
        try:
            self.backend.delete(Keyspace.QueueWal, key)
        except Exception:  # noqa: BLE001
            logger.warning("admission WAL discard failed for %s", job_id,
                           exc_info=True)

    def load(self, curator: str) -> List[Tuple[str, dict]]:
        """Every queued-job record owned by ``curator``, in submit
        order.  Undecodable entries are dropped (and deleted) rather
        than poisoning replay."""
        out: List[Tuple[str, dict]] = []
        try:
            entries = self.backend.get_from_prefix(Keyspace.QueueWal, QUEUE_PREFIX)
        except Exception:  # noqa: BLE001
            logger.warning("admission WAL scan failed", exc_info=True)
            return out
        for key, raw in sorted(entries):
            try:
                rec = json.loads(raw.decode("utf-8"))
            except Exception:  # noqa: BLE001
                logger.warning("dropping undecodable WAL entry %s", key)
                try:
                    self.backend.delete(Keyspace.QueueWal, key)
                except Exception:  # noqa: BLE001
                    pass
                continue
            if rec.get("curator") == curator:
                out.append((key, rec))
        return out

    def rewrite_curator(self, key: str, rec: dict, new_curator: str) -> dict:
        """Takeover: re-stamp an adopted entry to the new owner so a
        second failover replays it again."""
        rec = dict(rec, curator=new_curator)
        try:
            self.backend.put(
                Keyspace.QueueWal, key, json.dumps(rec).encode("utf-8")
            )
        except Exception:  # noqa: BLE001
            logger.warning("admission WAL curator rewrite failed for %s", key,
                           exc_info=True)
        return rec

    @staticmethod
    def decode_plan(rec: dict):
        from ..serde import BallistaCodec

        return BallistaCodec.decode_logical(base64.b64decode(rec["plan"]))

    # ----------------------------------------------------------- intents
    def put_intent(self, job_id: str) -> None:
        try:
            rec = {"curator": self.curator, "ts": time.time()}
            self.backend.put(
                Keyspace.QueueWal,
                f"{INTENT_PREFIX}{job_id}",
                json.dumps(rec).encode("utf-8"),
            )
        except Exception:  # noqa: BLE001
            logger.warning("cancel-intent WAL put failed for %s", job_id,
                           exc_info=True)

    def discard_intent(self, job_id: str) -> None:
        try:
            self.backend.delete(Keyspace.QueueWal, f"{INTENT_PREFIX}{job_id}")
        except Exception:  # noqa: BLE001
            logger.warning("cancel-intent WAL discard failed for %s", job_id,
                           exc_info=True)

    def load_intents(self, curator: str) -> List[str]:
        out: List[str] = []
        try:
            entries = self.backend.get_from_prefix(
                Keyspace.QueueWal, INTENT_PREFIX
            )
        except Exception:  # noqa: BLE001
            return out
        for key, raw in entries:
            try:
                rec = json.loads(raw.decode("utf-8"))
            except Exception:  # noqa: BLE001
                continue
            if rec.get("curator") == curator:
                out.append(key[len(INTENT_PREFIX):])
        return out


# --------------------------------------------------------------- tokens
# Idempotency-token helpers live at module level: grpc_service uses them
# whether or not the queue WAL is enabled (they guard the client retry
# path, which must work against a WAL-less scheduler too).

def token_key(token: str) -> str:
    return f"{TOKEN_PREFIX}{token}"


def lookup_token(backend: StateBackend, token: str) -> Optional[str]:
    """job_id previously minted for this token, if any."""
    try:
        raw = backend.get(Keyspace.QueueWal, token_key(token))
    except Exception:  # noqa: BLE001
        return None
    if raw is None:
        return None
    try:
        return raw.decode("utf-8").split(" ", 1)[0] or None
    except Exception:  # noqa: BLE001
        return None


def record_token(backend: StateBackend, token: str, job_id: str) -> None:
    try:
        backend.put(
            Keyspace.QueueWal,
            token_key(token),
            f"{job_id} {int(time.time())}".encode("utf-8"),
        )
    except Exception:  # noqa: BLE001
        logger.warning("idempotency token write failed", exc_info=True)


def purge_stale_tokens(backend: StateBackend, ttl_s: float = TOKEN_TTL_S) -> int:
    """Drop tokens older than ``ttl_s``; returns how many were removed.
    Called opportunistically from the submit path."""
    removed = 0
    cutoff = time.time() - ttl_s
    try:
        entries = backend.get_from_prefix(Keyspace.QueueWal, TOKEN_PREFIX)
    except Exception:  # noqa: BLE001
        return 0
    for key, raw in entries:
        try:
            ts = float(raw.decode("utf-8").split(" ", 1)[1])
        except Exception:  # noqa: BLE001
            ts = 0.0
        if ts < cutoff:
            try:
                backend.delete(Keyspace.QueueWal, key)
                removed += 1
            except Exception:  # noqa: BLE001
                pass
    return removed
