"""Finished-span buffers: per-process ring + scheduler-side trace store.

Two very different lifetimes:

* :class:`SpanRecorder` — every process has exactly one; finished spans
  land here and are **drained** by whatever ships them next (an
  executor's task-status report or heartbeat, the scheduler's forward
  hook).  Bounded ring: under backpressure the oldest spans drop —
  observability must never grow without bound or stall the data plane.
* :class:`TraceStore` — scheduler-only; spans arriving from executors
  (and the scheduler's own, via the forward hook) are routed by job id
  and kept for ``GET /api/jobs/{id}/trace``.  Bounded per job and across
  jobs (oldest job evicted), deduplicated by span id so status-report
  retries cannot double-draw a span on the timeline.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

DEFAULT_BUFFER_SPANS = 4096
DEFAULT_STORE_JOBS = 64
DEFAULT_STORE_SPANS_PER_JOB = 50_000


class SpanRecorder:
    def __init__(self, cap: int = DEFAULT_BUFFER_SPANS):
        self._lock = threading.Lock()
        self._dq: deque = deque(maxlen=max(1, cap))
        self._dropped = 0
        self._forward: Optional[Callable[[List[dict]], None]] = None

    def set_cap(self, cap: int) -> None:
        with self._lock:
            if cap != self._dq.maxlen:
                self._dq = deque(self._dq, maxlen=max(1, cap))

    def set_forward(self, fn: Optional[Callable[[List[dict]], None]]) -> None:
        """Route every recorded span straight into ``fn`` (the scheduler
        wires this to its TraceStore so its own spans need no transport)."""
        with self._lock:
            self._forward = fn

    def record(self, span: dict) -> None:
        with self._lock:
            fwd = self._forward
            if fwd is None:
                if len(self._dq) == self._dq.maxlen:
                    self._dropped += 1
                self._dq.append(span)
        if fwd is not None:
            try:
                fwd([span])
            except Exception:  # noqa: BLE001 - never break the traced path
                pass

    def drain(self, max_spans: Optional[int] = None) -> List[dict]:
        """Pop buffered spans for shipping (oldest first)."""
        out: List[dict] = []
        with self._lock:
            n = len(self._dq) if max_spans is None else min(max_spans, len(self._dq))
            for _ in range(n):
                out.append(self._dq.popleft())
        return out

    def drain_json(self, max_spans: Optional[int] = None) -> bytes:
        spans = self.drain(max_spans)
        return json.dumps(spans).encode() if spans else b""

    def requeue(self, spans: List[dict]) -> None:
        """Give drained spans back (the transport failed); they re-ship on
        the next drain.  Overflow beyond free capacity drops the OLDEST of
        the returned batch — newer spans matter more to a live trace."""
        if not spans:
            return
        with self._lock:
            free = (self._dq.maxlen or 0) - len(self._dq)
            if free < len(spans):
                self._dropped += len(spans) - free
                spans = spans[len(spans) - free:]
            for s in reversed(spans):
                self._dq.appendleft(s)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._dq)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped


class TraceStore:
    def __init__(
        self,
        max_jobs: int = DEFAULT_STORE_JOBS,
        max_spans_per_job: int = DEFAULT_STORE_SPANS_PER_JOB,
    ):
        self._lock = threading.Lock()
        self._jobs: "OrderedDict[str, Dict[str, dict]]" = OrderedDict()
        # trace id -> job id, learned from bind() at submit (and from any
        # span carrying a job attr): child spans (shuffle fetch, flight
        # serving) don't repeat the job attr but must route with their job
        self._trace_to_job: "OrderedDict[str, str]" = OrderedDict()
        self.max_jobs = max_jobs
        self.max_spans_per_job = max_spans_per_job

    def bind(self, trace_id: str, job_id: str) -> None:
        if not trace_id or not job_id:
            return
        with self._lock:
            self._trace_to_job[trace_id] = job_id
            while len(self._trace_to_job) > 4 * self.max_jobs:
                self._trace_to_job.popitem(last=False)

    def add(self, spans: List[dict]) -> int:
        """Route spans by their ``attrs.job``, the trace→job binding, or
        the trace id itself; returns how many were stored (duplicates and
        overflow excluded)."""
        stored = 0
        with self._lock:
            for s in spans:
                if not isinstance(s, dict) or "span" not in s:
                    continue
                trace_id = s.get("trace") or ""
                job = (s.get("attrs") or {}).get("job") or ""
                if job and trace_id and trace_id not in self._trace_to_job:
                    self._trace_to_job[trace_id] = job
                    while len(self._trace_to_job) > 4 * self.max_jobs:
                        self._trace_to_job.popitem(last=False)
                if not job:
                    job = self._trace_to_job.get(trace_id, "") or trace_id
                if not job:
                    continue
                per = self._jobs.get(job)
                if per is None:
                    per = self._jobs[job] = {}
                    while len(self._jobs) > self.max_jobs:
                        self._jobs.popitem(last=False)
                sid = s["span"]
                if sid in per or len(per) >= self.max_spans_per_job:
                    continue
                per[sid] = s
                stored += 1
        return stored

    def add_json(self, payload: bytes) -> int:
        if not payload:
            return 0
        try:
            spans = json.loads(payload.decode())
        except Exception:  # noqa: BLE001 - malformed piggyback is not fatal
            return 0
        return self.add(spans) if isinstance(spans, list) else 0

    def for_job(self, job_id: str) -> List[dict]:
        with self._lock:
            per = self._jobs.get(job_id)
            return sorted(per.values(), key=lambda s: s.get("ts", 0)) if per else []

    def jobs(self) -> List[str]:
        with self._lock:
            return list(self._jobs)

    def span_count(self) -> int:
        with self._lock:
            return sum(len(p) for p in self._jobs.values())


_recorder = SpanRecorder()
_store = TraceStore()


def get_recorder() -> SpanRecorder:
    return _recorder


def trace_store() -> TraceStore:
    return _store


def spans_for_job(job_id: str) -> list:
    """Every span recorded for ``job_id``: the scheduler-side TraceStore
    first, falling back to the process ring buffer (scheduler spans not
    yet forwarded — the forward hook installs on the first obs-enabled
    submit).  The ONE span-collection rule, shared by the REST trace/
    profile handlers and the gRPC ``include_profile`` path so every
    surface reads identical spans."""
    spans = _store.for_job(job_id)
    if not spans:
        spans = [
            s
            for s in _recorder.snapshot()
            if (s.get("attrs") or {}).get("job") == job_id
        ]
    return spans
