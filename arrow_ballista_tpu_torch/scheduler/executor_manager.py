"""Cluster membership + task-slot accounting.

Counterpart of the reference's ``scheduler/src/state/executor_manager.rs``:

* ``ExecutorReservation`` — a slot held for a specific upcoming task,
  invisible to other jobs, optionally job-affine (`:41-75`);
* ``reserve_slots`` / ``cancel_reservations`` — atomic under the global
  Slots lock with transactional writes (`:121-217`);
* registration / removal, persisted heartbeats with an in-memory map kept
  fresh by a backend watch (`:419-560`);
* liveness = heartbeat within ``liveness_window_s`` (60s in the reference,
  `:510-516`); expiry handled by the scheduler reaper.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

from ..errors import SchedulerError
from ..obs.registry import MetricsRegistry
from .kvstore import LeaseFenced
from ..proto import pb
from ..serde.scheduler_types import ExecutorMetadata
from .backend import Keyspace, StateBackend, WatchEvent

log = logging.getLogger(__name__)

DEFAULT_LIVENESS_WINDOW_S = 60.0
DEFAULT_EXECUTOR_TIMEOUT_S = 180.0
# Quarantine defaults (ballista.executor.quarantine_* knobs)
DEFAULT_QUARANTINE_THRESHOLD = 5
DEFAULT_QUARANTINE_WINDOW_S = 60.0
DEFAULT_QUARANTINE_BACKOFF_S = 30.0
# consecutive LaunchTask failures before an executor is declared lost
DEFAULT_LAUNCH_FAILURE_THRESHOLD = 3


@dataclass
class ExecutorReservation:
    executor_id: str
    job_id: Optional[str] = None

    def assign(self, job_id: str) -> "ExecutorReservation":
        return ExecutorReservation(self.executor_id, job_id)


@dataclass
class ExecutorHeartbeat:
    executor_id: str
    timestamp: float
    status: str = "active"  # active | dead

    def to_bytes(self) -> bytes:
        # stored in milliseconds: whole-second truncation would break
        # sub-second liveness windows (tests shrink the 60s default)
        msg = pb.ExecutorHeartbeat(
            executor_id=self.executor_id, timestamp=int(self.timestamp * 1000)
        )
        if self.status == "active":
            msg.status.active = ""
        else:
            msg.status.dead = ""
        return msg.SerializeToString()

    @staticmethod
    def from_bytes(b: bytes) -> "ExecutorHeartbeat":
        msg = pb.ExecutorHeartbeat.FromString(b)
        status = msg.status.WhichOneof("status") or "active"
        return ExecutorHeartbeat(msg.executor_id, msg.timestamp / 1000.0, status)


class ExecutorManager:
    def __init__(
        self,
        backend: StateBackend,
        liveness_window_s: float = DEFAULT_LIVENESS_WINDOW_S,
        quarantine_threshold: int = DEFAULT_QUARANTINE_THRESHOLD,
        quarantine_window_s: float = DEFAULT_QUARANTINE_WINDOW_S,
        quarantine_backoff_s: float = DEFAULT_QUARANTINE_BACKOFF_S,
        launch_failure_threshold: int = DEFAULT_LAUNCH_FAILURE_THRESHOLD,
        registry: Optional[MetricsRegistry] = None,
        events=None,
    ):
        from ..obs.events import EventJournal

        # structured event journal (obs/events.py): membership churn —
        # register/quarantine/drain/removal — is exactly what a
        # post-mortem needs when a job's slowdown traces to the cluster
        self.events = events if events is not None else EventJournal()
        self.backend = backend
        self.liveness_window_s = liveness_window_s
        self._heartbeats: Dict[str, ExecutorHeartbeat] = {}
        # monotonic receipt anchor per executor: ALL elapsed-time checks
        # (liveness, staleness, quarantine windows) run on time.monotonic
        # so a wall-clock jump can neither spuriously expire an executor
        # nor un-quarantine one.  The wall timestamp stays on the
        # persisted heartbeat for display / cross-process age estimates.
        self._hb_mono: Dict[str, float] = {}
        self._dead: Set[str] = set()
        self._hb_lock = threading.Lock()
        # ---- quarantine: sliding-window failure accounting per executor
        self.quarantine_threshold = quarantine_threshold
        self.quarantine_window_s = quarantine_window_s
        self.quarantine_backoff_s = quarantine_backoff_s
        self.launch_failure_threshold = launch_failure_threshold
        self._q_lock = threading.Lock()
        self._failure_times: Dict[str, deque] = {}
        self._quarantined_until: Dict[str, float] = {}
        self._launch_failures: Dict[str, int] = {}  # consecutive
        self._pending_expulsions: Set[str] = set()
        # ---- graceful decommission: executor -> monotonic drain deadline.
        # Draining executors take no NEW work (reserve_slots +
        # fill_reservations exclude them) but keep running/reporting what
        # they have; past the deadline (+grace) the reaper declares them
        # lost so a wedged drain can't hold its tasks hostage.
        self._draining: Dict[str, float] = {}
        self.registry = registry or MetricsRegistry()
        self._quarantines = self.registry.counter(
            "quarantines_total",
            "executors newly quarantined over scheduler lifetime",
        )
        self._drained = self.registry.counter(
            "executors_drained_total",
            "executors gracefully decommissioned (drain cycles concluded)",
        )
        self._task_failures_recorded = self.registry.counter(
            "executor_task_failures_total",
            "task/launch failures fed into quarantine windows",
        )
        self._unsubscribe = backend.watch(Keyspace.Heartbeats, "", self._on_hb_event)

    @property
    def quarantines_total(self) -> int:
        """Back-compat read surface for the old ad-hoc counter."""
        return int(self._quarantines.value)

    def close(self) -> None:
        self._unsubscribe()

    def _fenced_txn(self, lk, ops) -> None:
        """Apply a Slots transaction under its lease's fencing token.

        The reference's most carefully locked state is the slot accounting
        (``executor_manager.rs:121-217``).  With a remote lease the write
        carries the grant's token: if this holder's lease lapsed (stalled
        refresher past TTL) and another scheduler re-acquired, the store
        rejects the stale write (LeaseFenced) instead of letting it
        corrupt the slot counts.  Local backends ignore the fence —
        single-process mutual exclusion is already total."""
        self.backend.put_txn(ops, fence=lk)

    # ------------------------------------------------------- registration
    def register_executor(
        self,
        metadata: ExecutorMetadata,
        reserve: bool = False,
    ) -> List[ExecutorReservation]:
        """Persist metadata + heartbeat + slots; in push mode immediately
        reserve every slot for the offer cycle
        (reference: executor_manager.rs:308-417)."""
        slots = metadata.specification.task_slots
        lk = self.backend.lock(Keyspace.Slots, "global")
        with lk:
            self._fenced_txn(
                lk,
                [
                    (
                        Keyspace.Executors,
                        metadata.id,
                        metadata.to_proto().SerializeToString(),
                    ),
                    (
                        Keyspace.Slots,
                        metadata.id,
                        _slots_bytes(0 if reserve else slots),
                    ),
                ],
            )
        self.save_heartbeat(
            ExecutorHeartbeat(metadata.id, time.time(), "active")
        )
        with self._hb_lock:
            self._dead.discard(metadata.id)
        with self._q_lock:
            # a (re-)registering executor starts with a clean record
            self._failure_times.pop(metadata.id, None)
            self._quarantined_until.pop(metadata.id, None)
            self._launch_failures.pop(metadata.id, None)
            self._pending_expulsions.discard(metadata.id)
            self._draining.pop(metadata.id, None)
        self.events.emit(
            "executor_registered",
            executor=metadata.id,
            host=metadata.host,
            slots=slots,
        )
        if reserve:
            return [ExecutorReservation(metadata.id) for _ in range(slots)]
        return []

    def remove_executor(self, executor_id: str) -> None:
        """Mark dead and zero its slots."""
        lk = self.backend.lock(Keyspace.Slots, "global")
        with lk:
            self._fenced_txn(
                lk, [(Keyspace.Slots, executor_id, _slots_bytes(0))]
            )
        self.save_heartbeat(ExecutorHeartbeat(executor_id, time.time(), "dead"))
        with self._hb_lock:
            self._dead.add(executor_id)
        with self._q_lock:
            self._failure_times.pop(executor_id, None)
            self._quarantined_until.pop(executor_id, None)
            self._launch_failures.pop(executor_id, None)
            self._pending_expulsions.discard(executor_id)
            was_draining = executor_id in self._draining
            self._draining.pop(executor_id, None)
        if was_draining:
            # a drain cycle concluded (graceful stop OR deadline expiry):
            # the executor is out of the cluster with its locations
            # re-pointed by the accompanying rollback
            self._drained.inc()
        self.events.emit(
            "executor_removed", executor=executor_id, drained=was_draining
        )

    def get_executor_metadata(self, executor_id: str) -> ExecutorMetadata:
        raw = self.backend.get(Keyspace.Executors, executor_id)
        if raw is None:
            raise SchedulerError(f"unknown executor {executor_id!r}")
        return ExecutorMetadata.from_proto(pb.ExecutorMetadata.FromString(raw))

    def executors(self) -> List[ExecutorMetadata]:
        return [
            ExecutorMetadata.from_proto(pb.ExecutorMetadata.FromString(v))
            for _, v in self.backend.scan(Keyspace.Executors)
        ]

    def is_dead_executor(self, executor_id: str) -> bool:
        with self._hb_lock:
            return executor_id in self._dead

    # --------------------------------------------------------- heartbeats
    def save_heartbeat(self, hb: ExecutorHeartbeat) -> None:
        self.backend.put(Keyspace.Heartbeats, hb.executor_id, hb.to_bytes())

    def _on_hb_event(self, event: WatchEvent) -> None:
        if event.kind == WatchEvent.PUT and event.value is not None:
            hb = ExecutorHeartbeat.from_bytes(event.value)
            # anchor the monotonic receipt by the beat's wall age ONCE
            # (a replayed stale heartbeat — e.g. HA standby catching up —
            # must not look fresh); after this single wall read, liveness
            # math is purely monotonic and immune to clock jumps
            mono = time.monotonic() - max(0.0, time.time() - hb.timestamp)
            with self._hb_lock:
                self._heartbeats[hb.executor_id] = hb
                self._hb_mono[hb.executor_id] = mono
                if hb.status == "dead":
                    self._dead.add(hb.executor_id)

    def heartbeats(self) -> List["ExecutorHeartbeat"]:
        """Snapshot of the in-memory heartbeat map (observability/tests)."""
        with self._hb_lock:
            return list(self._heartbeats.values())

    def get_alive_executors(self, now: Optional[float] = None) -> Set[str]:
        """Executors whose last beat is inside the liveness window.
        ``now`` is in the time.monotonic domain (tests inject values)."""
        now = time.monotonic() if now is None else now
        cutoff = now - self.liveness_window_s
        with self._hb_lock:
            return {
                eid
                for eid, hb in self._heartbeats.items()
                if hb.status == "active"
                and self._hb_mono.get(eid, float("-inf")) >= cutoff
            }

    def get_expired_executors(
        self, timeout_s: float = DEFAULT_EXECUTOR_TIMEOUT_S
    ) -> List[ExecutorHeartbeat]:
        cutoff = time.monotonic() - timeout_s
        with self._hb_lock:
            return [
                hb
                for eid, hb in self._heartbeats.items()
                if hb.status == "active"
                and self._hb_mono.get(eid, float("-inf")) < cutoff
            ]

    def last_seen(self, executor_id: str) -> Optional[float]:
        with self._hb_lock:
            hb = self._heartbeats.get(executor_id)
        return hb.timestamp if hb else None

    # ---------------------------------------------------------- quarantine
    def record_task_failure(self, executor_id: str, now: Optional[float] = None) -> bool:
        """Count one failure into the executor's sliding window.  Returns
        True when this failure NEWLY quarantines the executor (the caller
        then resets its in-flight tasks)."""
        if self.quarantine_threshold <= 0 or not executor_id:
            return False
        # monotonic domain: a wall-clock jump must not age failures out of
        # the window (spuriously un-quarantining) or pile them in
        now = time.monotonic() if now is None else now
        self._task_failures_recorded.inc()
        with self._q_lock:
            dq = self._failure_times.setdefault(executor_id, deque())
            dq.append(now)
            cutoff = now - self.quarantine_window_s
            while dq and dq[0] < cutoff:
                dq.popleft()
            already = self._quarantined_until.get(executor_id, 0.0) > now
            if len(dq) < self.quarantine_threshold or already:
                return False
            quarantined = {
                eid
                for eid, until in self._quarantined_until.items()
                if until > now
            }
        # sidelining the ONLY live executor turns a sick cluster into a
        # dead one — keep it serving (its failures stay bounded by the
        # per-task attempt budget); checked outside _q_lock since
        # get_alive_executors takes its own lock
        others = self.get_alive_executors(now) - quarantined - {executor_id}
        if not others:
            log.warning(
                "executor %s crossed the quarantine threshold but is the "
                "only live executor; not quarantining",
                executor_id,
            )
            return False
        with self._q_lock:
            if self._quarantined_until.get(executor_id, 0.0) > now:
                return False  # raced: someone else quarantined it
            dq = self._failure_times.setdefault(executor_id, deque())
            self._quarantined_until[executor_id] = now + self.quarantine_backoff_s
            self._quarantines.inc()
            dq.clear()  # the window restarts after the backoff
        log.warning(
            "executor %s quarantined for %.0fs (%d failures in %.0fs window)",
            executor_id,
            self.quarantine_backoff_s,
            self.quarantine_threshold,
            self.quarantine_window_s,
        )
        self.events.emit(
            "executor_quarantined",
            executor=executor_id,
            backoff_s=self.quarantine_backoff_s,
            failures=self.quarantine_threshold,
        )
        return True

    def record_launch_failure(self, executor_id: str) -> bool:
        """Launch failures feed the quarantine window AND an escalation
        counter: after ``launch_failure_threshold`` CONSECUTIVE launch
        failures the executor is queued for expulsion (ExecutorLost) —
        the scheduler cannot even deliver tasks to it, so silently
        re-dispatching would black-hole the job.  Returns True when the
        expulsion threshold was just crossed."""
        self.record_task_failure(executor_id)
        with self._q_lock:
            n = self._launch_failures.get(executor_id, 0) + 1
            self._launch_failures[executor_id] = n
            if n < self.launch_failure_threshold:
                return False
            if executor_id in self._pending_expulsions:
                return False
            self._pending_expulsions.add(executor_id)
        log.warning(
            "executor %s failed %d consecutive launches; queueing expulsion",
            executor_id,
            n,
        )
        return True

    def record_launch_success(self, executor_id: str) -> None:
        with self._q_lock:
            self._launch_failures.pop(executor_id, None)

    def take_pending_expulsions(self) -> List[str]:
        """Drain executors whose repeated launch failures crossed the
        threshold; the caller posts ExecutorLost for each."""
        with self._q_lock:
            out = sorted(self._pending_expulsions)
            self._pending_expulsions.clear()
        return out

    # ------------------------------------------------------------ draining
    def mark_draining(self, executor_id: str, timeout_s: float) -> None:
        """Graceful decommission step 1: exclude the executor from every
        future reservation while it finishes/hands off its work."""
        with self._q_lock:
            self._draining[executor_id] = time.monotonic() + max(0.0, timeout_s)
        self.events.emit(
            "executor_drain_started", executor=executor_id, timeout_s=timeout_s
        )

    def is_draining(self, executor_id: str) -> bool:
        with self._q_lock:
            return executor_id in self._draining

    def draining_executors(self) -> List[str]:
        with self._q_lock:
            return sorted(self._draining)

    # the deadline only bounds TASK time; a draining executor then still
    # legitimately spends cancel grace + status flush + un-replicated
    # partition uploads + replicator flush (up to ~45s of bounded waits,
    # plus upload I/O) before ExecutorStopped — the watchdog grace must
    # cover that or a busy drain gets declared lost mid-upload and
    # triggers the recompute storm the drain exists to avoid
    DRAIN_GRACE_S = 60.0
    # upload I/O is unbounded (GBs to a slow shared store): a drain past
    # the grace whose executor STILL HEARTBEATS is deferred up to this
    # hard cap past its deadline — only a drain that is both overdue and
    # silent (or wedged beyond the cap) is declared lost
    DRAIN_HARD_CAP_S = 900.0

    def overdue_drains(
        self,
        grace_s: Optional[float] = None,
        alive: Optional[Set[str]] = None,
        hard_cap_s: Optional[float] = None,
    ) -> List[str]:
        """Draining executors past deadline + grace that never reported
        stopped: the reaper posts ExecutorLost for each so a wedged drain
        cannot strand its tasks.  ``alive`` (heartbeat-fresh executor
        ids) defers a live, still-uploading drain until ``hard_cap_s``
        past its deadline.  Entries stay in ``_draining`` until
        ``remove_executor`` concludes the cycle (and counts it)."""
        grace_s = self.DRAIN_GRACE_S if grace_s is None else grace_s
        hard_cap_s = self.DRAIN_HARD_CAP_S if hard_cap_s is None else hard_cap_s
        hard_cap_s = max(hard_cap_s, grace_s)
        alive = alive or set()
        now = time.monotonic()
        with self._q_lock:
            return sorted(
                eid
                for eid, deadline in self._draining.items()
                if now > deadline + grace_s
                and (eid not in alive or now > deadline + hard_cap_s)
            )

    def is_quarantined(self, executor_id: str, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._q_lock:
            return self._quarantined_until.get(executor_id, 0.0) > now

    def quarantined_executors(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        with self._q_lock:
            return sorted(
                eid
                for eid, until in self._quarantined_until.items()
                if until > now
            )

    # -------------------------------------------------------------- slots
    def _host_weights(
        self, preferred_hosts: Optional[Dict[str, int]]
    ) -> Optional[Dict[str, int]]:
        """executor id -> demand weight of its (normalized) host, for the
        reserve_slots locality ordering; None when no preference."""
        if not preferred_hosts:
            return None
        from ..shuffle.transport import normalize_host

        wanted = {normalize_host(h): w for h, w in preferred_hosts.items()}
        out: Dict[str, int] = {}
        for eid, raw in self.backend.scan(Keyspace.Executors):
            try:
                meta = pb.ExecutorMetadata.FromString(raw)
                out[eid] = wanted.get(normalize_host(meta.host), 0)
            except Exception:  # noqa: BLE001 - unparsable: no preference
                out[eid] = 0
        return out

    def reserve_slots(
        self,
        n: int,
        job_id: Optional[str] = None,
        preferred_hosts: Optional[Dict[str, int]] = None,
    ) -> List[ExecutorReservation]:
        """Atomically grab up to ``n`` slots across alive executors
        (reference: executor_manager.rs:121-167).

        ``preferred_hosts`` ({host: pending-task demand}, from
        locality-aware graphs) SOFT-orders the scan: slots on hosts that
        already hold the shuffle bytes are taken first, everything else
        fills the remainder — the reservation-side half of locality
        placement (pop_next_task's wait is the task-side half)."""
        if n <= 0:
            return []
        alive = self.get_alive_executors()
        # quarantined executors take no new work until their backoff
        # ends; draining executors take no new work EVER
        for eid in self.quarantined_executors():
            alive.discard(eid)
        for eid in self.draining_executors():
            alive.discard(eid)
        weights = self._host_weights(preferred_hosts)
        # on LeaseFenced nothing was applied: re-scan and retry once
        # under a fresh grant (the counts may have changed meanwhile)
        for attempt in (0, 1):
            reservations: List[ExecutorReservation] = []
            lk = self.backend.lock(Keyspace.Slots, "global")
            try:
                with lk:
                    txn = []
                    entries = list(self.backend.scan(Keyspace.Slots))
                    if weights is not None:
                        # stable: equal-weight executors keep scan order
                        entries.sort(
                            key=lambda kv: -weights.get(kv[0], 0)
                        )
                    for eid, raw in entries:
                        if eid not in alive:
                            continue
                        avail = _slots_from(raw)
                        take = min(avail, n - len(reservations))
                        if take <= 0:
                            continue
                        txn.append(
                            (Keyspace.Slots, eid, _slots_bytes(avail - take))
                        )
                        reservations.extend(
                            ExecutorReservation(eid, job_id)
                            for _ in range(take)
                        )
                        if len(reservations) >= n:
                            break
                    if txn:
                        self._fenced_txn(lk, txn)
                return reservations
            except LeaseFenced:
                if attempt:
                    raise
        return reservations

    def cancel_reservations(self, reservations: List[ExecutorReservation]) -> None:
        """Give slots back (reference: executor_manager.rs:169-217)."""
        if not reservations:
            return
        per: Dict[str, int] = {}
        for r in reservations:
            per[r.executor_id] = per.get(r.executor_id, 0) + 1
        # a fenced rejection must NOT leak the slots forever (the take
        # was already applied by an earlier reserve): the give-back is a
        # pure re-derive-and-add under whatever lease is current, so on
        # LeaseFenced retry once with a fresh grant
        for attempt in (0, 1):
            lk = self.backend.lock(Keyspace.Slots, "global")
            try:
                with lk:
                    txn = []
                    for eid, k in per.items():
                        raw = self.backend.get(Keyspace.Slots, eid)
                        avail = _slots_from(raw) if raw is not None else 0
                        txn.append(
                            (Keyspace.Slots, eid, _slots_bytes(avail + k))
                        )
                    self._fenced_txn(lk, txn)
                return
            except LeaseFenced:
                if attempt:
                    raise

    def available_slots(self) -> int:
        alive = self.get_alive_executors()
        return sum(
            _slots_from(raw)
            for eid, raw in self.backend.scan(Keyspace.Slots)
            if eid in alive
        )

    def reconcile_slots(self, running: Dict[str, int]) -> Dict[str, int]:
        """Rebuild the durable slot counts from ground truth: for every
        registered executor, available = task_slots − tasks actually
        running on it (``running``, from the persisted graphs of EVERY
        curator).  Slot counts outlive the scheduler process, so
        reservations held by a process that died (SIGKILL before the
        tasks launched, or whose re-armed tasks went back to pending on
        recovery) leak forever otherwise — on a small fleet that is a
        permanent dispatch deadlock.  Runs under the global Slots lock;
        a live peer's reserved-but-not-yet-launched slots are the one
        window this can momentarily overcount, which costs brief
        oversubscription rather than a wedge.  Returns {executor_id:
        reclaimed} for executors whose count changed."""
        changed: Dict[str, int] = {}
        lk = self.backend.lock(Keyspace.Slots, "global")
        with lk:
            txn = []
            for meta in self.executors():
                want = max(
                    0,
                    meta.specification.task_slots
                    - running.get(meta.id, 0),
                )
                raw = self.backend.get(Keyspace.Slots, meta.id)
                have = _slots_from(raw) if raw is not None else 0
                if have != want:
                    txn.append((Keyspace.Slots, meta.id, _slots_bytes(want)))
                    changed[meta.id] = want - have
            if txn:
                self._fenced_txn(lk, txn)
        return changed


def _slots_bytes(n: int) -> bytes:
    return json.dumps({"slots": n}).encode()


def _slots_from(raw: bytes) -> int:
    return json.loads(raw.decode())["slots"]
