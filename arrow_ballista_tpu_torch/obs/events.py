"""Append-only structured event journal.

The scheduler's job cache is bounded: once ``complete_job``/``fail_job``
move a graph out and its keyspace entry ages away, the trace store and
job detail eventually forget it.  The journal is the durable post-mortem
surface: every job/stage/task lifecycle transition, retry, speculation
outcome, quarantine, drain and replica failover appends one JSON line —
correlated by ``job`` and ``trace`` ids — to a size-rotated segment file
on local disk.

Rotation: one ACTIVE segment (``events.jsonl``); when an append pushes
it past ``rotate_bytes`` it is renamed to ``events-<seq>.jsonl`` and a
fresh active segment opens.  At most ``keep_segments`` rotated files are
kept (oldest deleted), so total disk is bounded by roughly
``rotate_bytes * (keep_segments + 1)``.  The active segment is never
discarded by rotation — an event, once written, survives until its
segment ages out of the window.

Disabled (no directory configured) the journal is a near-zero-cost no-op:
``emit`` is one attribute check.  Queries (``tail``, ``for_job``) read
the segment files back tolerantly — a torn final line (crash mid-append)
is skipped, not fatal.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from typing import List, Optional

log = logging.getLogger(__name__)

DEFAULT_ROTATE_BYTES = 4 << 20
DEFAULT_KEEP_SEGMENTS = 4
ACTIVE_NAME = "events.jsonl"
_SEGMENT_RE = re.compile(r"^events-(\d+)\.jsonl$")


class EventJournal:
    """Thread-safe append-only journal of structured scheduler events."""

    def __init__(
        self,
        path: str = "",
        rotate_bytes: int = DEFAULT_ROTATE_BYTES,
        keep_segments: int = DEFAULT_KEEP_SEGMENTS,
    ):
        self.path = path
        self.rotate_bytes = max(4096, rotate_bytes)
        self.keep_segments = max(1, keep_segments)
        self._lock = threading.Lock()
        self._f = None
        self._size = 0
        self._seq = 0
        self._dropped = 0
        if path:
            try:
                os.makedirs(path, exist_ok=True)
                for name in os.listdir(path):
                    m = _SEGMENT_RE.match(name)
                    if m:
                        self._seq = max(self._seq, int(m.group(1)))
                active = os.path.join(path, ACTIVE_NAME)
                self._f = open(active, "a", encoding="utf-8")  # noqa: SIM115
                self._size = self._f.tell()
            except OSError as e:
                log.warning("event journal disabled (cannot open %s): %s", path, e)
                self._f = None

    @property
    def enabled(self) -> bool:
        return self._f is not None

    # --------------------------------------------------------------- write
    def _line(self, kind: str, job: str, trace: str, fields: dict) -> str:
        entry = {"ts": round(time.time(), 6), "kind": kind}
        if job:
            entry["job"] = job
        if trace:
            entry["trace"] = trace
        entry.update(fields)
        try:
            return json.dumps(entry, default=str, separators=(",", ":")) + "\n"
        except Exception:  # noqa: BLE001 - unserializable field
            return json.dumps(
                {"ts": entry["ts"], "kind": kind, "job": job, "trace": trace}
            ) + "\n"

    def _write_locked_lines(self, lines: List[str]) -> None:
        data = "".join(lines)
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.write(data)
                self._f.flush()
                self._size += len(data.encode("utf-8"))
                if self._size >= self.rotate_bytes:
                    self._rotate_locked()
            except (OSError, ValueError):
                self._dropped += len(lines)

    def emit(self, kind: str, job: str = "", trace: str = "", **fields) -> None:
        """Append one event.  Never raises; a failed write counts as a
        drop (observability must not take the scheduler down with a full
        disk)."""
        if self._f is None:
            return
        self._write_locked_lines([self._line(kind, job, trace, fields)])

    def emit_many(self, events: List[dict], job: str = "", trace: str = "") -> None:
        """Append a batch of events — each a field dict carrying its own
        ``kind`` — with ONE write+flush syscall pair.  The scheduler
        drains queued graph events while holding the job entry lock, so
        batching bounds the lock's I/O cost at one flush per drain."""
        if self._f is None or not events:
            return
        self._write_locked_lines(
            [self._line(ev.pop("kind", "event"), job, trace, ev) for ev in events]
        )

    def _rotate_locked(self) -> None:
        # Never leave ``self._f`` as a closed handle: a later emit would
        # hit ValueError (not OSError) and escape the never-raises
        # contract.  A failed rename keeps appending to the oversized
        # active segment (``_size`` stays past the bound, so the next
        # emit retries rotation); a failed reopen disables the journal.
        active = os.path.join(self.path, ACTIVE_NAME)
        self._f.close()
        self._f = None
        try:
            os.replace(
                active, os.path.join(self.path, f"events-{self._seq + 1}.jsonl")
            )
            self._seq += 1
            self._size = 0
        except OSError:
            pass
        try:
            self._f = open(active, "a", encoding="utf-8")  # noqa: SIM115
        except OSError as e:
            log.warning(
                "event journal disabled (cannot reopen %s): %s", active, e
            )
            self._dropped += 1
            return
        # prune segments beyond the keep window (oldest first)
        seqs = sorted(
            int(_SEGMENT_RE.match(n).group(1))
            for n in os.listdir(self.path)
            if _SEGMENT_RE.match(n)
        )
        for s in seqs[: max(0, len(seqs) - self.keep_segments)]:
            try:
                os.remove(os.path.join(self.path, f"events-{s}.jsonl"))
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                finally:
                    self._f = None

    # ---------------------------------------------------------------- read
    def segment_paths(self) -> List[str]:
        """Readable segments, oldest → active."""
        if not self.path:
            return []
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        seqs = sorted(
            int(_SEGMENT_RE.match(n).group(1))
            for n in names
            if _SEGMENT_RE.match(n)
        )
        out = [os.path.join(self.path, f"events-{s}.jsonl") for s in seqs]
        active = os.path.join(self.path, ACTIVE_NAME)
        if ACTIVE_NAME in names:
            out.append(active)
        return out

    def _iter_events(self):
        for path in self.segment_paths():
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        try:
                            ev = json.loads(line)
                        except Exception:  # noqa: BLE001 - torn tail line
                            continue
                        if isinstance(ev, dict):
                            yield ev
            except OSError:
                continue

    def tail(
        self, n: int = 100, kind: Optional[str] = None
    ) -> List[dict]:
        """Last ``n`` events (oldest → newest), optionally one kind."""
        from collections import deque

        dq: deque = deque(maxlen=max(1, n))
        for ev in self._iter_events():
            if kind is None or ev.get("kind") == kind:
                dq.append(ev)
        return list(dq)

    def for_job(self, job_id: str, limit: int = 10_000) -> List[dict]:
        """Every surviving event of one job, oldest → newest.  The whole
        journal is size-bounded, so a full scan is bounded too."""
        out: List[dict] = []
        for ev in self._iter_events():
            if ev.get("job") == job_id:
                out.append(ev)
                if len(out) >= limit:
                    break
        return out

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def stats(self) -> dict:
        with self._lock:
            size = self._size
        segs = self.segment_paths()
        return {
            "enabled": self.enabled,
            "path": self.path,
            "active_bytes": size,
            "segments": len(segs),
            "rotate_bytes": self.rotate_bytes,
            "keep_segments": self.keep_segments,
            "dropped": self._dropped,
        }
