"""Span API: context-manager + decorator tracing with cross-process ids.

Design rules:

* **Disabled is free.**  ``span()`` costs one module attribute read and
  returns a shared no-op context manager when tracing is off — no
  allocation, no clock read.  Production processes that never call
  :func:`configure` pay nothing for the instrumentation points.
* **Durations are monotonic.**  A span's ``dur`` comes from
  ``time.monotonic_ns`` deltas; its ``ts`` anchor is wall-clock
  (``time.time_ns``) so spans from different processes line up on one
  Chrome-trace timeline.  Wall jumps can skew alignment between
  processes, never a measured duration.
* **Propagation is explicit.**  The scheduler mints a trace id per job
  (root span id == trace id) and ships it on ``TaskDefinition``;
  executors :func:`activate` it around task execution; the shuffle
  fetcher forwards it over Flight headers
  (``x-ballista-trace-id`` / ``x-ballista-parent-span``) so the serving
  executor's ``do_get`` span stitches into the same trace.

Spans are plain dicts (JSON-portable — they ride gRPC piggybacked on
task-status/heartbeat updates):
``{"name", "trace", "span", "parent", "proc", "tid", "ts", "dur",
"attrs"}`` with ``ts``/``dur`` in nanoseconds.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Callable, Optional

TRACE_HEADER = b"x-ballista-trace-id"
PARENT_HEADER = b"x-ballista-parent-span"

# Process-wide switch: the ONLY state the disabled fast path reads.
_enabled = False
_process = "proc"
_sample_rate = 1.0

_tls = threading.local()


def new_id() -> str:
    """16-hex-char random id (spans and traces share the format)."""
    return os.urandom(8).hex()


def is_enabled() -> bool:
    return _enabled


def configure(
    enabled: Optional[bool] = None,
    process: Optional[str] = None,
    sample_rate: Optional[float] = None,
    buffer_cap: Optional[int] = None,
) -> None:
    """Set process-level tracing state.  ``process`` names this process in
    exported traces (``scheduler`` / ``executor:<id>``); ``buffer_cap``
    resizes the finished-span ring buffer."""
    global _enabled, _process, _sample_rate
    if process is not None:
        _process = process
    if sample_rate is not None:
        _sample_rate = max(0.0, min(1.0, float(sample_rate)))
    if buffer_cap is not None:
        from .recorder import get_recorder

        get_recorder().set_cap(buffer_cap)
    if enabled is not None:
        _enabled = bool(enabled)


def enable_from_config(config, process: Optional[str] = None) -> bool:
    """Ratchet tracing ON when a session/task config asks for it (it never
    ratchets off: other sessions in the process may still be traced).
    Returns the resulting enabled state."""
    try:
        if config.obs_enabled:
            configure(
                enabled=True,
                process=process,
                sample_rate=config.obs_sample_rate,
                buffer_cap=config.obs_buffer_spans,
            )
    except Exception:  # noqa: BLE001 - observability must never break jobs
        pass
    return _enabled


def enable_from_props(props, process: Optional[str] = None) -> bool:
    """Executor-side ratchet from TaskDefinition.props (string map).
    Malformed values are ignored — observability must never fail a task
    (props are unvalidated forward-compat keys on older schedulers)."""
    if not props:
        return _enabled
    try:
        if str(props.get("ballista.obs.enabled", "false")).lower() in (
            "true", "1", "yes",
        ):
            cap = props.get("ballista.obs.buffer_spans")
            configure(
                enabled=True,
                process=process,
                buffer_cap=int(cap) if cap else None,
            )
    except Exception:  # noqa: BLE001
        pass
    return _enabled


def sampled() -> bool:
    """One sampling decision (made per trace, at the scheduler)."""
    if _sample_rate >= 1.0:
        return True
    if _sample_rate <= 0.0:
        return False
    return int.from_bytes(os.urandom(4), "big") / 2**32 < _sample_rate


# --------------------------------------------------------------- contexts
class _Ctx:
    """Thread-local trace position: (trace_id, span_id of current span)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


def current_context() -> Optional[_Ctx]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def _push(ctx: _Ctx) -> None:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(ctx)


def _pop() -> None:
    stack = getattr(_tls, "stack", None)
    if stack:
        stack.pop()


class _Activation:
    """Adopt a remote trace context (from TaskDefinition / Flight headers)
    as this thread's current position, so child spans stitch under it."""

    __slots__ = ("_ctx", "_active")

    def __init__(self, trace_id: str, parent_span_id: str):
        self._ctx = (
            _Ctx(trace_id, parent_span_id or trace_id) if trace_id else None
        )
        self._active = False

    def __enter__(self) -> "_Activation":
        if self._ctx is not None:
            self._push_now()
        return self

    def _push_now(self) -> None:
        _push(self._ctx)
        self._active = True

    def __exit__(self, *exc) -> None:
        if self._active:
            _pop()
            self._active = False


def activate(trace_id: str, parent_span_id: str = "") -> _Activation:
    """Context manager installing a propagated trace position.  An empty
    ``trace_id`` (unsampled or untraced job) activates nothing."""
    return _Activation(trace_id, parent_span_id)


def propagation_headers() -> list:
    """gRPC/Flight metadata for the current position ([] when untraced)."""
    ctx = current_context() if _enabled else None
    if ctx is None:
        return []
    return [
        (TRACE_HEADER, ctx.trace_id.encode()),
        (PARENT_HEADER, ctx.span_id.encode()),
    ]


# ------------------------------------------------------------------ spans
class _NoopSpan:
    """Shared do-nothing span: the disabled path and exception-safe
    fallback.  One instance serves the whole process."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def set_attr(self, key: str, value) -> None:
        pass


NOOP = _NoopSpan()


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "attrs",
        "_start_unix_ns", "_start_mono_ns", "_pushed",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        parent_id: str,
        attrs: dict,
        span_id: Optional[str] = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id or new_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self._pushed = False

    def __enter__(self) -> "Span":
        _push(_Ctx(self.trace_id, self.span_id))
        self._pushed = True
        self._start_unix_ns = time.time_ns()
        self._start_mono_ns = time.monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.monotonic_ns() - self._start_mono_ns
        if self._pushed:
            _pop()
            self._pushed = False
        if exc is not None:
            self.attrs["error"] = f"{getattr(exc_type, '__name__', exc_type)}: {exc}"
        from .recorder import get_recorder

        get_recorder().record(
            {
                "name": self.name,
                "trace": self.trace_id,
                "span": self.span_id,
                "parent": self.parent_id,
                "proc": _process,
                "tid": threading.get_ident() & 0xFFFFFFFF,
                "ts": self._start_unix_ns,
                "dur": dur,
                "attrs": self.attrs,
            }
        )

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value


def span(name: str, parent: Optional[_Ctx] = None, **attrs):
    """Start a span as a context manager.

    Disabled path: one global read, returns the shared no-op.  A span
    also needs a POSITION — an explicit ``parent`` or the thread's
    current context.  Without one it returns the no-op too: that is what
    makes per-job sampling propagate end to end (an unsampled job ships
    an empty trace id, ``activate("")`` installs nothing, and every
    child span call on that task collapses to the no-op instead of
    minting orphan local traces).  Roots are explicit: :func:`root_span`
    / :func:`activate`.
    """
    if not _enabled:
        return NOOP
    ctx = parent if parent is not None else current_context()
    if ctx is None:
        return NOOP
    return Span(name, ctx.trace_id, ctx.span_id, attrs)


class _NoopManualSpan:
    """Disabled-path manual span: exposes .ctx (None) for child-parenting
    and no-op set_attr/finish."""

    __slots__ = ()
    ctx = None

    def set_attr(self, key: str, value) -> None:
        pass

    def finish(self) -> None:
        pass


NOOP_MANUAL = _NoopManualSpan()


class ManualSpan:
    """A span that never touches the thread-local stack — for GENERATOR
    bodies, where a ``with span(...)`` around yields would leave this
    span as the thread's current context while the generator is
    suspended (mis-parenting whatever the consumer records between
    next() calls) and could pop a foreign context if the generator is
    finalized on another thread.  Children parent via ``.ctx``
    explicitly; call :meth:`finish` exactly once (idempotent)."""

    __slots__ = ("name", "ctx", "parent_id", "attrs", "_start_unix_ns",
                 "_start_mono_ns", "_done")

    def __init__(self, name: str, parent: Optional[_Ctx], attrs: dict):
        self.name = name
        span_id = new_id()
        trace_id = parent.trace_id if parent is not None else span_id
        self.ctx = _Ctx(trace_id, span_id)
        self.parent_id = parent.span_id if parent is not None else ""
        self.attrs = attrs
        self._start_unix_ns = time.time_ns()
        self._start_mono_ns = time.monotonic_ns()
        self._done = False

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        from .recorder import get_recorder

        get_recorder().record(
            {
                "name": self.name,
                "trace": self.ctx.trace_id,
                "span": self.ctx.span_id,
                "parent": self.parent_id,
                "proc": _process,
                "tid": threading.get_ident() & 0xFFFFFFFF,
                "ts": self._start_unix_ns,
                "dur": time.monotonic_ns() - self._start_mono_ns,
                "attrs": self.attrs,
            }
        )


def manual_span(name: str, parent: Optional[_Ctx] = None, **attrs):
    """Start a stack-free span (see :class:`ManualSpan`).  Inherits the
    CALLING thread's current context when ``parent`` is omitted; like
    :func:`span`, positionless calls collapse to the no-op (sampling)."""
    if not _enabled:
        return NOOP_MANUAL
    ctx = parent if parent is not None else current_context()
    if ctx is None:
        return NOOP_MANUAL
    return ManualSpan(name, ctx, attrs)


def root_span(name: str, trace_id: str, **attrs):
    """The trace's root: span id == trace id (the convention every child
    shipped to another process parents under)."""
    if not _enabled or not trace_id:
        return NOOP
    return Span(name, trace_id, "", attrs, span_id=trace_id)


def traced(name: Optional[str] = None, **attrs) -> Callable:
    """Decorator form of :func:`span`."""

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            with span(label, **attrs):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def record_raw(
    name: str,
    trace_id: str,
    span_id: str,
    parent_id: str,
    ts_unix_ns: int,
    dur_ns: int,
    **attrs,
) -> None:
    """Record an already-timed span (e.g. the job span emitted at
    completion from the graph's submit timestamps)."""
    if not _enabled or not trace_id:
        return
    from .recorder import get_recorder

    get_recorder().record(
        {
            "name": name,
            "trace": trace_id,
            "span": span_id,
            "parent": parent_id,
            "proc": _process,
            "tid": threading.get_ident() & 0xFFFFFFFF,
            "ts": ts_unix_ns,
            "dur": dur_ns,
            "attrs": attrs,
        }
    )
