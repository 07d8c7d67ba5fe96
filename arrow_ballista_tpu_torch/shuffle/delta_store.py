"""Executor-side mirror of the scheduler's shuffle-location feeds.

Streaming pipelined execution: a consumer stage resolved on
PARTIAL map output executes with tailing ``ShuffleReaderExec``s that
carry no static locations — each tails the scheduler's append-only
per-(job, producer-stage) feed of committed map-output locations until
the feed reports complete.  This module is the executor-process mirror
of those feeds:

* push mode: the scheduler's ``UpdateShuffleLocations`` notification
  lands in :func:`apply_delta` as map tasks commit;
* pull mode (and as the push-mode catch-up): a starved tail polls the
  scheduler's ``GetShuffleLocationDelta`` RPC through the stub installed
  by :func:`configure_scheduler` (the poll loop / executor server set it
  at startup).

Feed entries are fenced by ``epoch``: executor-loss rollback invalidates
a feed scheduler-side and any recreated feed starts at the next epoch,
so a mirror RESETS when the epoch advances and ABORTS (raises) when the
scheduler reports the feed invalid — two generations of locations are
never merged.  Deltas apply only when contiguous (``from_index`` at or
below the mirror's length); gapped pushes are dropped and the poll
catches up.

Everything here is jax-free and cheap when unused: a barrier-scheduled
executor never touches this module.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

log = logging.getLogger(__name__)

# how long a starved tail waits on the condition variable before falling
# back to a scheduler poll (push mode normally wakes it long before)
DEFAULT_POLL_INTERVAL_S = 0.05
# bounded mirror: feeds of long-gone jobs must not accumulate forever
MAX_FEEDS = 64


class _Feed:
    __slots__ = ("locations", "complete", "valid", "epoch", "touched_mono")

    def __init__(self) -> None:
        self.locations: List[object] = []
        self.complete = False
        self.valid = True
        self.epoch = 0
        self.touched_mono = time.monotonic()


_cv = threading.Condition()
_feeds: Dict[Tuple[str, int], _Feed] = {}
# GetShuffleLocationDelta transport: a zero-arg callable returning the
# scheduler stub (installed by PollLoop / ExecutorServer at startup)
_scheduler_stub: Optional[Callable[[], object]] = None


def configure_scheduler(stub_fn: Callable[[], object]) -> None:
    """Install the scheduler-stub factory tailing fetches poll through.
    Last writer wins — one executor process talks to one scheduler (the
    HA fail-over re-registers and re-installs)."""
    global _scheduler_stub
    with _cv:
        _scheduler_stub = stub_fn


def reset() -> None:
    """Test aid: forget every mirrored feed and the stub."""
    global _scheduler_stub
    with _cv:
        _feeds.clear()
        _scheduler_stub = None
        _cv.notify_all()


def _feed(key: Tuple[str, int]) -> _Feed:
    f = _feeds.get(key)
    if f is None:
        if len(_feeds) >= MAX_FEEDS:
            oldest = min(_feeds, key=lambda k: _feeds[k].touched_mono)
            _feeds.pop(oldest, None)
        f = _Feed()
        _feeds[key] = f
    f.touched_mono = time.monotonic()
    return f


def apply_delta(
    job_id: str,
    stage_id: int,
    from_index: int,
    locations: list,
    complete: bool,
    valid: bool,
    epoch: int,
) -> None:
    """Merge one feed delta (push notification or poll response) into
    the mirror.  Epoch fencing: newer epoch resets the mirror, older is
    dropped; ``valid=False`` at the current-or-newer epoch — or at epoch
    0, the scheduler's "no such feed" answer after restart/job eviction
    — marks the feed dead and wakes every tail so it aborts."""
    with _cv:
        feed = _feed((job_id, stage_id))
        if not valid and (epoch == 0 or epoch >= feed.epoch):
            # epoch 0 is the scheduler saying "I don't know this feed at
            # all" (restart / job eviction — live feeds start at epoch 1):
            # authoritative, kills any generation.  A stale invalid from
            # an OLD generation (delayed push racing a recreation) still
            # drops below.
            feed.valid = False
            _cv.notify_all()
            return
        if epoch < feed.epoch:
            return  # stale generation (including its invalid tombstones)
        if epoch > feed.epoch:
            feed.locations = []
            feed.complete = False
            feed.valid = True
            feed.epoch = epoch
        if from_index > len(feed.locations):
            return  # gap (lost push): the poll catches up from our length
        fresh = locations[len(feed.locations) - from_index :]
        if fresh:
            feed.locations.extend(fresh)
        if complete:
            feed.complete = True
        if fresh or complete:
            _cv.notify_all()


def apply_delta_proto(delta) -> None:
    """``apply_delta`` from a ``pb.ShuffleLocationDelta``."""
    from ..serde.scheduler_types import PartitionLocation

    apply_delta(
        delta.job_id,
        delta.stage_id,
        delta.from_index,
        [PartitionLocation.from_proto(l) for l in delta.locations],
        bool(delta.complete),
        bool(delta.valid),
        delta.epoch,
    )


def _poll(job_id: str, stage_id: int) -> None:
    """One GetShuffleLocationDelta round trip (outside the lock); RPC
    errors are swallowed — the tail keeps waiting and retries on its
    next starvation tick (scheduler restart mid-job lands here until
    the task is cancelled or reaped)."""
    with _cv:
        stub_fn = _scheduler_stub
        feed = _feeds.get((job_id, stage_id))
        from_index = len(feed.locations) if feed is not None else 0
    if stub_fn is None:
        return
    try:
        from ..proto import pb

        stub = stub_fn()
        resp = stub.GetShuffleLocationDelta(
            pb.ShuffleLocationDeltaParams(
                job_id=job_id, stage_id=stage_id, from_index=from_index
            ),
            timeout=10,
        )
    except Exception as e:  # noqa: BLE001 - poll is best-effort
        log.debug(
            "GetShuffleLocationDelta(%s, %d) failed: %s", job_id, stage_id, e
        )
        return
    apply_delta_proto(resp)


def feed_snapshot(job_id: str, stage_id: int) -> dict:
    """Introspection/test surface: the mirror's current view."""
    with _cv:
        feed = _feeds.get((job_id, stage_id))
        if feed is None:
            return {"locations": 0, "complete": False, "valid": True, "epoch": 0}
        return {
            "locations": len(feed.locations),
            "complete": feed.complete,
            "valid": feed.valid,
            "epoch": feed.epoch,
        }


def tail_locations(
    job_id: str,
    stage_id: int,
    partition: int,
    stop_event: Optional[threading.Event] = None,
    cancel_event: Optional[threading.Event] = None,
    metrics=None,
    poll_interval_s: float = DEFAULT_POLL_INTERVAL_S,
) -> Iterator[object]:
    """Yield ``partition``'s map-side locations one by one as they land
    (flattening wrapper over :func:`tail_location_batches`)."""
    for chunk in tail_location_batches(
        job_id,
        stage_id,
        partition,
        stop_event=stop_event,
        cancel_event=cancel_event,
        metrics=metrics,
        poll_interval_s=poll_interval_s,
    ):
        yield from chunk


def tail_location_batches(
    job_id: str,
    stage_id: int,
    partition: int,
    stop_event: Optional[threading.Event] = None,
    cancel_event: Optional[threading.Event] = None,
    metrics=None,
    poll_interval_s: float = DEFAULT_POLL_INTERVAL_S,
) -> Iterator[list]:
    """Yield ``partition``'s map-side locations as they land in the feed,
    finishing when the feed is complete and drained.

    Each yielded item is one backlog DRAIN: every location that had
    accumulated in the feed since the previous drain, already filtered
    to ``partition``.  A consumer that kept pace sees singleton lists; a
    consumer that fell behind (slow first fetch, late start against an
    almost-complete feed) sees the whole backlog at once and can fan it
    out over a concurrent fetch pool instead of draining in feed order.

    Starvation (stall-on-producer) is accounted into the owning
    operator's ``fetch_wait_time_ns`` so the doctor's attribution stays
    exact — a pipelined consumer's wait shows up as fetch wait, not as
    an unattributed hole.  An invalidated feed raises ``ExecutionError``
    (transient: the scheduler has already rolled the consumer back and
    this task's late status is guarded).
    """
    from ..errors import Cancelled, ExecutionError

    cursor = 0
    epoch: Optional[int] = None  # the generation this tail is consuming
    while True:
        batch: list = []
        done = False
        still_starved = False
        with _cv:
            feed = _feed((job_id, stage_id))
            if not feed.valid:
                raise ExecutionError(
                    f"shuffle feed for stage {stage_id} was invalidated "
                    "(producer rollback in progress)"
                )
            # epoch pin: a tail consumes exactly ONE feed generation.  If
            # the mirror reset under us (the new attempt's seed landed
            # before our cancel did), our cursor indexes the DEAD
            # generation — abort instead of splicing two generations.
            if feed.epoch:
                if epoch is None:
                    epoch = feed.epoch
                elif feed.epoch != epoch:
                    raise ExecutionError(
                        f"shuffle feed for stage {stage_id} was superseded "
                        f"(epoch {epoch} -> {feed.epoch})"
                    )
            if cursor < len(feed.locations):
                batch = feed.locations[cursor:]
                cursor = len(feed.locations)
            elif feed.complete:
                done = True
            else:
                t0 = time.monotonic_ns()
                _cv.wait(poll_interval_s)
                if metrics is not None:
                    metrics.add(
                        "fetch_wait_time_ns", time.monotonic_ns() - t0
                    )
                still_starved = (
                    cursor >= len(feed.locations)
                    and not feed.complete
                    and feed.valid
                )
        if done:
            return
        for ev, exc in (
            (cancel_event, Cancelled("task cancelled")),
            (stop_event, ExecutionError("shuffle tail aborted: shutdown")),
        ):
            if ev is not None and ev.is_set():
                raise exc
        if batch:
            chunk = [
                loc
                for loc in batch
                if (pid := getattr(loc, "partition_id", None)) is None
                or pid.partition_id == partition
            ]
            if chunk:
                yield chunk
            continue
        if still_starved:
            # nothing arrived inside the wait window: fall back to a poll
            # (the pull-mode transport; push mode rarely gets here)
            t0 = time.monotonic_ns()
            _poll(job_id, stage_id)
            if metrics is not None:
                metrics.add("fetch_wait_time_ns", time.monotonic_ns() - t0)
