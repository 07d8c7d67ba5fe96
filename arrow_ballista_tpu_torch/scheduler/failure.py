"""Task-failure classification: transient (retry) vs fatal (fail fast).

The executor reports failures as ``"ExceptionName: message"`` strings
(``executor.py`` formats ``f"{type(e).__name__}: {e}"``), so
classification is a prefix/marker match on that string — the scheduler
never needs the exception object, which may not even exist in this
process (worker crashes, dropped connections).

Policy (mirrors what production Ballista deployments converge on):

* **fatal** — deterministic errors that re-running cannot fix: plan /
  serde / SQL / config errors, invariant violations, explicit
  cancellation.  These fail the job on attempt 1.
* **transient** — everything else: IO, Flight/gRPC transport, worker
  crashes, injected faults, and *unknown* errors.  Unknown defaults to
  transient because retries are bounded (``ballista.task.max_attempts``):
  a deterministic bug misclassified as transient costs a few wasted
  attempts, while a transient failure misclassified as fatal burns the
  whole job.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

TRANSIENT = "transient"
FATAL = "fatal"

# Exception-name prefixes that mark a deterministic, non-retryable error.
_FATAL_PREFIXES = (
    "PlanError",
    "SqlError",
    "SerdeError",
    "ConfigError",
    "SchemaError",
    "NotImplementedYet",
    "NotImplementedError",
    "InternalError",
    "Cancelled",
    # plain-Python code bugs re-fail identically on every attempt
    "TypeError",
    "ImportError",
    "ModuleNotFoundError",
    "AttributeError",
    "NameError",
)

# Substrings anywhere in the error that force the transient class even if
# a fatal-looking exception wrapped them (e.g. an OSError str()'d into a
# SerdeError while reading a plan file off a dying disk is still IO).
_TRANSIENT_MARKERS = (
    "fault injected",
    "worker terminated",
    "connection reset",
    "connection refused",
    "unavailable",
    "deadline exceeded",
    "broken pipe",
    "timed out",
)


def classify_failure(error: str) -> str:
    """Map one task-failure string to ``"transient"`` or ``"fatal"``."""
    err = (error or "").strip()
    low = err.lower()
    for marker in _TRANSIENT_MARKERS:
        if marker in low:
            return TRANSIENT
    head = err.split(":", 1)[0].strip()
    if head in _FATAL_PREFIXES:
        return FATAL
    return TRANSIENT


def is_transient(error: str) -> bool:
    return classify_failure(error) == TRANSIENT


# ``errors.ShuffleFetchFailed.__str__`` embeds these fields; the executor
# wire-formats failures as "ExceptionName: message", so the scheduler
# recovers the structure with a match on that string (the exception object
# never crosses the process boundary).
_SHUFFLE_FETCH_RE = re.compile(
    r"stage=(\d+)\s+partition=(\d+)\s+executor=([^\s:]+)"
)


def parse_shuffle_fetch_failure(
    error: str,
) -> Optional[Tuple[int, int, str]]:
    """Decode a consumer task's structured lost-shuffle failure into
    ``(producer_stage_id, map_partition, executor_id)``; None for every
    other error.  Drives producer-partition recovery in
    ``ExecutionGraph._recover_lost_shuffle`` instead of burning the
    consumer's attempts on data that no longer exists."""
    err = (error or "").strip()
    if not err.startswith("ShuffleFetchFailed"):
        return None
    m = _SHUFFLE_FETCH_RE.search(err)
    if m is None:
        return None
    return int(m.group(1)), int(m.group(2)), m.group(3)


def indicts_reporter(error: str) -> bool:
    """Should this failure count against the REPORTING executor's
    quarantine window?  Transient infrastructure failures do; a lost
    map-output fetch does not — the consumer's host is healthy, the
    producer's data vanished."""
    return is_transient(error) and parse_shuffle_fetch_failure(error) is None
