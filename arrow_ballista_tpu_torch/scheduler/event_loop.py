"""Generic single-consumer event loop.

Counterpart of the reference's ``core/src/event_loop.rs:28-141``: a bounded
queue drained by one worker thread, an ``EventAction`` with
on_start/on_stop/on_receive/on_error hooks, and a re-entrant ``EventSender``
handed to anyone who needs to post events (including the handler itself).
All scheduler state mutations flow through this loop — the concurrency
discipline the reference relies on instead of fine-grained locking.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Generic, Optional, TypeVar

log = logging.getLogger(__name__)

E = TypeVar("E")

_STOP = object()


class EventAction(Generic[E]):
    def on_start(self) -> None:  # pragma: no cover - default no-op
        pass

    def on_stop(self) -> None:  # pragma: no cover - default no-op
        pass

    def on_receive(self, event: E, sender: "EventSender[E]") -> None:
        raise NotImplementedError

    def on_error(self, error: BaseException) -> None:
        log.error("event loop handler error: %s", error, exc_info=error)


class EventSender(Generic[E]):
    def __init__(self, q: "queue.Queue"):
        self._q = q

    def post(self, event: E) -> None:
        self._q.put(event)


class EventLoop(Generic[E]):
    def __init__(self, name: str, buffer_size: int, action: EventAction[E]):
        self.name = name
        self.action = action
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._processed = 0  # events fully handled (drain watches this)

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.action.on_start()
        self._thread = threading.Thread(
            target=self._run, name=f"event-loop-{self.name}", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        sender = EventSender(self._q)
        while True:
            event = self._q.get()
            if event is _STOP:
                break
            if isinstance(event, _Barrier):
                event.done.set()
                continue
            try:
                self.action.on_receive(event, sender)
            except BaseException as e:  # noqa: BLE001 - loop must survive
                self.action.on_error(e)
            finally:
                self._processed += 1
        self.action.on_stop()

    def stop(self, timeout: float = 5.0) -> None:
        if not self._started:
            return
        self._q.put(_STOP)
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._started = False

    def get_sender(self) -> EventSender[E]:
        if not self._started:
            raise RuntimeError(f"event loop {self.name!r} not started")
        return EventSender(self._q)

    def drain(self, timeout: float = 5.0) -> bool:
        """Block until the loop is quiescent: two consecutive barriers pass
        with no events processed between them and an empty queue.  Barriers
        run on the loop thread, so a passing barrier proves no handler is
        mid-flight — a bare queue-empty check would race with follow-up
        events a handler is about to post."""
        import time

        deadline = time.monotonic() + timeout
        prev = -1
        while time.monotonic() < deadline:
            b = _Barrier()
            self._q.put(b)
            if not b.done.wait(timeout=max(0.0, deadline - time.monotonic())):
                return False
            cur = self._processed
            if cur == prev and self._q.empty():
                return True
            prev = cur
        return False


class _Barrier:
    def __init__(self) -> None:
        self.done = threading.Event()
