"""Unified error hierarchy for the framework.

Counterpart of the reference's ``BallistaError`` enum
(``ballista/rust/core/src/error.rs:35-51`` in the reference), redesigned as a
Python exception tree instead of a Rust enum.
"""

from __future__ import annotations

from typing import Optional


class BallistaError(Exception):
    """Base class for all framework errors."""


class PlanError(BallistaError):
    """Logical/physical planning failed."""


class SqlError(PlanError):
    """SQL parse or analysis error."""


class NotImplementedYet(BallistaError):
    """Feature recognized but not supported yet."""


class ExecutionError(BallistaError):
    """Runtime failure while executing an operator."""


class SerdeError(BallistaError):
    """Plan (de)serialization failure."""


class BatchedFetchProtocolError(ExecutionError):
    """The multi-partition shuffle stream broke the batched-fetch
    protocol (partition index out of range, batch without an index tag —
    e.g. a mixed-version server ignoring ``FetchPartitionTicket.paths``).
    Deterministic: retrying the same stream cannot succeed, so the
    fetcher degrades straight to per-location DoGets instead of burning
    the retry/backoff budget first."""


class ShuffleFetchFailed(ExecutionError):
    """A shuffle reader exhausted its per-location fetch retries: the map
    output it needs is gone (wiped work_dir, evicted memory partition,
    dead serving process).  Carries the producer coordinates so the
    scheduler can re-run just the lost partitions instead of burning the
    consumer's attempt budget — the message embeds them in a stable
    ``stage=N partition=M executor=E`` form that survives the
    string-only TaskStatus wire format
    (``scheduler/failure.py parse_shuffle_fetch_failure``)."""

    def __init__(
        self,
        stage_id: int,
        map_partition: int,
        executor_id: str,
        detail: str = "",
    ):
        self.stage_id = stage_id
        self.map_partition = map_partition
        self.executor_id = executor_id
        msg = (
            "shuffle fetch exhausted retries for map output "
            f"stage={stage_id} partition={map_partition} "
            f"executor={executor_id or '<unknown>'}"
        )
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class SchedulerError(BallistaError):
    """Scheduler-side state machine failure."""


class ClusterSaturated(SchedulerError):
    """Admission-control backpressure: the cluster is saturated and this
    job was shed instead of queued (queue full, displaced by
    ``shed_policy=oldest``, or queued past ``max_queue_wait_seconds``).
    RETRYABLE by design — nothing about the job itself is wrong, and the
    running set was never touched.  The message keeps a stable
    ``ClusterSaturated:`` prefix with ``key=value`` coordinates so
    clients and benches can recognize sheds across the string-only
    status wire."""

    def __init__(
        self,
        reason: str,
        pool: str = "",
        queued: int = 0,
        policy: str = "",
        queue_wait_s: Optional[float] = None,
    ):
        self.pool = pool
        self.queued = queued
        self.policy = policy
        self.queue_wait_s = queue_wait_s
        parts = [f"pool={pool or '<none>'}", f"queued={queued}"]
        if policy:
            parts.append(f"policy={policy}")
        if queue_wait_s is not None:
            parts.append(f"queue_wait_s={queue_wait_s:.3f}")
        super().__init__(
            f"ClusterSaturated: {reason} ({' '.join(parts)}); "
            "backpressure — safe to retry later"
        )


class ConfigError(BallistaError):
    """Invalid configuration value."""


class Cancelled(BallistaError):
    """Task was cancelled."""


class InternalError(BallistaError):
    """Invariant violation — a bug in the framework."""
