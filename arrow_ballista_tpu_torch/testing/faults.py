"""Process-wide fault-injection harness.

The fault-tolerance machinery (bounded task retries, executor quarantine,
stage rollback) is only trustworthy if its failure paths can be exercised
deterministically.  This module plants named **injection points** on the
hot paths — task launch (``scheduler.launch_task``), task execution
(``executor.execute_task``), the process-isolated worker loop
(``executor.task_runner``), shuffle fetch (``shuffle.fetch``), the
executor heartbeat (``executor.heartbeat``) and the autoscaler's provider
launch (``executor.launch`` — ``raise`` models a fleet-API refusal,
``delay`` a slow cold-start that must trip the launch timeout without
hanging the tick) — that are free when disarmed
(one attribute read) and raise :class:`FaultInjected` (or kill the
process, for worker-crash simulation) when armed.

Arming is either programmatic::

    from arrow_ballista_tpu_torch.testing import faults
    faults.arm("executor.execute_task", times=2)          # next 2 hits fail
    faults.arm("shuffle.fetch", times=1,
               match=lambda path="", **_: "stage-1" in path)
    with faults.inject("executor.heartbeat", times=3):    # scoped
        ...

or via the ``BALLISTA_FAULTS`` environment variable (so task-runner
subprocesses, which inherit the environment, participate)::

    BALLISTA_FAULTS="executor.execute_task:2,executor.task_runner:1:exit"

Spec grammar: ``name[:times[:action]]`` comma-separated; ``times``
defaults to 1 (``-1`` = unlimited), ``action`` is ``raise`` (default),
``exit`` (``os._exit`` — a hard worker crash) or ``delay[=ms]`` (sleep at
the point instead of raising — a manufactured straggler/wedged task;
default 1000ms).  The variable is read once at import; production
processes never set it, so **injection defaults to off everywhere**.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..errors import ExecutionError


class FaultInjected(ExecutionError):
    """Raised by an armed injection point.  Classified transient by the
    scheduler (``scheduler/failure.py``) — an injected fault models an
    infrastructure failure, not a plan bug."""


@dataclass
class _Fault:
    name: str
    remaining: int  # -1 = unlimited
    action: str = "raise"  # "raise" | "exit" | "delay"
    message: str = ""
    match: Optional[Callable[..., bool]] = None
    hits: int = 0
    delay_ms: int = 0  # action="delay": sleep this long instead of raising


_lock = threading.Lock()
_faults: Dict[str, List[_Fault]] = {}
_hit_counts: Dict[str, int] = {}
# fast-path flag: fault_point() returns immediately while nothing is armed
_active = False


def _refresh_active() -> None:
    global _active
    _active = any(
        f.remaining != 0 for fl in _faults.values() for f in fl
    )


def arm(
    name: str,
    times: int = 1,
    action: str = "raise",
    message: str = "",
    match: Optional[Callable[..., bool]] = None,
    delay_ms: int = 0,
) -> None:
    """Arm ``name`` for the next ``times`` matching hits (-1 = unlimited).

    ``action="delay"`` sleeps ``delay_ms`` at the injection point instead
    of raising — a deterministic straggler/wedged-task factory for the
    speculation and deadline-reaper tests.  A delay at a site that passes
    a ``cancel_event`` in its context wakes early when the task is
    cancelled (the site's own cancellation check then fires)."""
    if action not in ("raise", "exit", "delay"):
        raise ValueError(f"unknown fault action {action!r}")
    with _lock:
        _faults.setdefault(name, []).append(
            _Fault(name, times, action, message, match, delay_ms=delay_ms)
        )
        _refresh_active()


def clear(name: Optional[str] = None) -> None:
    """Disarm one point (or, with no argument, everything)."""
    with _lock:
        if name is None:
            _faults.clear()
            _hit_counts.clear()
        else:
            _faults.pop(name, None)
            _hit_counts.pop(name, None)
        _refresh_active()


def hits(name: str) -> int:
    """How many times ``name`` actually fired (for test assertions)."""
    with _lock:
        return _hit_counts.get(name, 0)


class inject:
    """Context manager: arm on enter, disarm this arming on exit."""

    def __init__(self, name: str, **kwargs):
        self.name = name
        self.kwargs = kwargs

    def __enter__(self) -> "inject":
        arm(self.name, **self.kwargs)
        return self

    def __exit__(self, *exc) -> None:
        clear(self.name)


def fault_point(name: str, **ctx) -> None:
    """Injection point.  No-op while nothing is armed; when an armed fault
    matches, raises :class:`FaultInjected` (or hard-exits the process).

    ``ctx`` carries call-site context (executor_id, partition, path, …)
    for ``match`` predicates — predicates must accept ``**kwargs`` since
    each site passes different keys.
    """
    if not _active:
        return
    with _lock:
        for f in _faults.get(name, []):
            if f.remaining == 0:
                continue
            if f.match is not None:
                try:
                    if not f.match(**ctx):
                        continue
                except Exception:  # noqa: BLE001 - a bad predicate never fires
                    continue
            if f.remaining > 0:
                f.remaining -= 1
            f.hits += 1
            _hit_counts[name] = _hit_counts.get(name, 0) + 1
            _refresh_active()
            action, message, delay_ms = f.action, f.message, f.delay_ms
            break
        else:
            return
    if action == "exit":
        # hard crash (worker-kill simulation): no cleanup, no status reply
        os._exit(17)
    if action == "delay":
        # manufactured straggler: sleep instead of raising.  A site that
        # passes its cancel_event lets the sleep end early on abort (the
        # site's own cancellation check raises right after).
        cancel = ctx.get("cancel_event")
        delay_s = max(0, delay_ms) / 1000.0
        if cancel is not None and hasattr(cancel, "wait"):
            cancel.wait(delay_s)
        else:
            import time

            time.sleep(delay_s)
        return
    raise FaultInjected(
        message or f"fault injected at {name} ({ctx or 'no context'})"
    )


def _load_env(spec: str) -> None:
    """Parse ``BALLISTA_FAULTS``: comma-separated
    ``name[:times[:action[:key=value]]]``.  The optional ``key=value``
    gates the fault on an integer context field, e.g.
    ``executor.task_runner:-1:exit:attempt=0`` crashes the worker only on
    first attempts so retries can succeed."""
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        name = fields[0]
        try:
            times = int(fields[1]) if len(fields) > 1 else 1
        except ValueError:
            times = 1
        action = fields[2] if len(fields) > 2 else "raise"
        delay_ms = 0
        if action.startswith("delay"):
            # "delay=500" sleeps 500ms at the point (default 1000)
            _, _, ms = action.partition("=")
            try:
                delay_ms = int(ms) if ms else 1000
            except ValueError:
                delay_ms = 1000
            action = "delay"
        match = None
        if len(fields) > 3 and "=" in fields[3]:
            key, _, raw = fields[3].partition("=")

            def match(__key=key.strip(), __want=raw.strip(), **ctx):
                return str(ctx.get(__key)) == __want

        try:
            arm(name, times=times, action=action, match=match, delay_ms=delay_ms)
        except ValueError:
            arm(name, times=times, match=match)


_env_spec = os.environ.get("BALLISTA_FAULTS", "")
if _env_spec:
    _load_env(_env_spec)
