"""TaskStatus proto ⇄ TaskInfo conversions, shared by scheduler + executor.

Counterpart of the reference's ``executor/src/lib.rs as_task_status`` (the
executor-side Result → protobuf mapping) and the scheduler-side decode in
``scheduler/src/state/task_manager.rs:132-170``.
"""

from __future__ import annotations

import json
import random
import time
from typing import List

from ..proto import pb
from ..serde.scheduler_types import PartitionId, ShuffleWritePartition
from .execution_stage import TaskInfo


def _spans_from_json(payload: bytes) -> List[dict]:
    if not payload:
        return []
    try:
        spans = json.loads(payload.decode())
        return spans if isinstance(spans, list) else []
    except Exception:  # noqa: BLE001 - malformed piggyback must not drop status
        return []


def task_info_to_proto(info: TaskInfo) -> pb.TaskStatus:
    msg = pb.TaskStatus()
    msg.task_id.CopyFrom(info.partition_id.to_proto())
    msg.attempt = info.attempt
    msg.fetch_retries = info.fetch_retries
    msg.speculative = info.speculative
    if info.spans:
        msg.spans_json = json.dumps(info.spans).encode()
    if info.state == "running":
        msg.running.executor_id = info.executor_id
    elif info.state == "failed":
        msg.failed.error = info.error or "task failed"
    elif info.state == "completed":
        msg.completed.executor_id = info.executor_id
        for p in info.partitions:
            msg.completed.partitions.append(p.to_proto())
    else:
        raise ValueError(f"unknown task state {info.state!r}")
    for op_name, values in info.metrics:
        m = msg.metrics.add()
        m.operator_name = op_name
        for k, v in values.items():
            m.values[k] = int(v)
    return msg


def task_info_from_proto(msg: pb.TaskStatus) -> TaskInfo:
    pid = PartitionId.from_proto(msg.task_id)
    which = msg.WhichOneof("status")
    metrics = [(m.operator_name, dict(m.values)) for m in msg.metrics]
    spans = _spans_from_json(msg.spans_json)
    if which == "running":
        return TaskInfo(
            pid,
            "running",
            msg.running.executor_id,
            metrics=metrics,
            attempt=msg.attempt,
            fetch_retries=msg.fetch_retries,
            spans=spans,
            speculative=msg.speculative,
        )
    if which == "failed":
        return TaskInfo(
            pid,
            "failed",
            error=msg.failed.error,
            metrics=metrics,
            attempt=msg.attempt,
            fetch_retries=msg.fetch_retries,
            spans=spans,
            speculative=msg.speculative,
        )
    if which == "completed":
        parts = [
            ShuffleWritePartition.from_proto(p) for p in msg.completed.partitions
        ]
        return TaskInfo(
            pid,
            "completed",
            msg.completed.executor_id,
            partitions=parts,
            metrics=metrics,
            attempt=msg.attempt,
            fetch_retries=msg.fetch_retries,
            spans=spans,
            speculative=msg.speculative,
        )
    raise ValueError(f"TaskStatus with no status set for {pid}")


def job_status_to_proto(status: dict) -> pb.JobStatus:
    """Scheduler-side status snapshot → wire JobStatus
    (reference: proto JobStatus oneof, ballista.proto)."""
    msg = pb.JobStatus()
    state = status.get("state")
    if state == "queued":
        msg.queued.SetInParent()
        # admission-queue coordinates (scheduler/admission.py): the
        # client poll loop distinguishes queued wait from running time
        if status.get("queue_position"):
            msg.queued.queue_position = int(status["queue_position"])
        if status.get("pool"):
            msg.queued.pool = status["pool"]
        if status.get("queued_seconds"):
            msg.queued.queued_seconds = float(status["queued_seconds"])
    elif state == "running":
        msg.running.SetInParent()
    elif state == "failed":
        msg.failed.error = status.get("error", "")
    elif state == "completed":
        for loc in status.get("locations", []):
            msg.completed.partition_location.append(loc.to_proto())
    else:
        msg.queued.SetInParent()
    return msg


def job_status_from_proto(msg: pb.JobStatus) -> dict:
    from ..serde.scheduler_types import PartitionLocation

    which = msg.WhichOneof("status")
    if which == "failed":
        return {"state": "failed", "error": msg.failed.error}
    if which == "completed":
        return {
            "state": "completed",
            "locations": [
                PartitionLocation.from_proto(p)
                for p in msg.completed.partition_location
            ],
        }
    if which == "queued":
        out = {"state": "queued"}
        if msg.queued.queue_position:
            out["queue_position"] = msg.queued.queue_position
        if msg.queued.pool:
            out["pool"] = msg.queued.pool
        if msg.queued.queued_seconds:
            out["queued_seconds"] = msg.queued.queued_seconds
        return out
    return {"state": which or "queued"}


class PollBackoff:
    """Jittered exponential poll-interval schedule, shared by the client
    ``wait_for_job`` loop and the FlightSQL front-end (the same module
    rule as :func:`poll_timeout_breakdown`): hundreds of concurrent
    waiting clients polling a fixed interval hit the scheduler in
    lockstep waves — backing each client off geometrically (x1.6 per
    poll, capped) with ±25% jitter spreads the load while keeping the
    first polls tight so short queries stay snappy.

    ``next_delay()`` returns the seconds to sleep before the next poll
    and advances the schedule; ``reset()`` snaps back to the base (used
    on a state transition — a job that just started running deserves
    tight polling again)."""

    GROWTH = 1.6
    JITTER = 0.25

    def __init__(self, base_s: float = 0.1, cap_s: float = 2.0):
        self.base_s = max(1e-3, float(base_s))
        self.cap_s = max(self.base_s, float(cap_s))
        self._current = self.base_s

    def reset(self) -> None:
        self._current = self.base_s

    def next_delay(self) -> float:
        jitter = 1.0 + self.JITTER * (2.0 * random.random() - 1.0)
        delay = self._current * jitter
        self._current = min(self._current * self.GROWTH, self.cap_s)
        return delay

    def sleep(self, deadline_mono: float) -> None:
        """Sleep the next backed-off interval, clamped to the remaining
        monotonic deadline (+10ms so the expiry check runs right after):
        a capped 2s+jitter interval must not make a timeout fire seconds
        late.  The one sleep rule for both poll loops."""
        time.sleep(
            min(
                self.next_delay(),
                max(0.0, deadline_mono - time.monotonic()) + 0.01,
            )
        )


def poll_timeout_breakdown(
    start_mono: float, running_since_mono, last_queued: dict
) -> str:
    """``(spent Xs queued in pool 'p' (last position n) and Ys
    running)`` — shared by the client poll loop and the FlightSQL
    front-end so an admission-starved job reads differently from a
    wedged one in both timeout messages."""
    now = time.monotonic()
    queued_s = (
        running_since_mono if running_since_mono is not None else now
    ) - start_mono
    running_s = (
        now - running_since_mono if running_since_mono is not None else 0.0
    )
    msg = f" (spent {queued_s:.1f}s queued"
    if last_queued.get("pool"):
        msg += f" in pool {last_queued['pool']!r}"
    if last_queued.get("queue_position"):
        msg += f" (last position {last_queued['queue_position']})"
    return msg + f" and {running_s:.1f}s running)"


def collect_plan_metrics(plan) -> List[tuple]:
    """Walk the operator tree gathering (operator_name, metric values)
    (reference: core/src/utils.rs:347-358 collect_plan_metrics)."""
    out: List[tuple] = []

    def walk(node):
        values = node.metrics.to_dict()
        if values:
            out.append((type(node).__name__, values))
        for child in node.children():
            walk(child)

    walk(plan)
    return out
