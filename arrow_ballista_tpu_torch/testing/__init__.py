"""Test-support package: deterministic fault injection for the
scheduler/executor fault-tolerance paths (see ``faults.py``)."""

from .faults import (  # noqa: F401
    FaultInjected,
    arm,
    clear,
    fault_point,
    hits,
    inject,
)
