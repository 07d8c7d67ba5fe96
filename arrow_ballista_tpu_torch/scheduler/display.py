"""Stage plan + metrics rendering on the scheduler.

Counterpart of the reference's ``scheduler/src/display.rs:31-160``:
``print_stage_metrics`` logs a completed stage's plan annotated with the
combined per-operator MetricsSets the executors reported back;
``DisplayableBallistaExecutionPlan`` is the reusable renderer.
"""

from __future__ import annotations

import logging
from typing import Dict

log = logging.getLogger(__name__)


class DisplayableBallistaExecutionPlan:
    """Renders a stage plan with the stage's combined metrics attached to
    each operator line (metrics are keyed by operator display name)."""

    def __init__(self, plan, stage_metrics: Dict[str, Dict[str, int]]):
        self.plan = plan
        self.stage_metrics = stage_metrics

    def indent(self) -> str:
        lines: list[str] = []

        def walk(op, depth: int) -> None:
            name = str(op)
            # stage metrics are keyed by operator class (collect_plan_metrics
            # in task_status.py); metrics of same-class operators in one
            # stage arrive merged
            metrics = self.stage_metrics.get(type(op).__name__) or self.stage_metrics.get(name)
            suffix = f", metrics=[{_fmt_metrics(metrics)}]" if metrics else ""
            lines.append("  " * depth + name + suffix)
            for c in op.children():
                walk(c, depth + 1)

        walk(self.plan, 0)
        return "\n".join(lines)


def _fmt_metrics(m: Dict[str, int]) -> str:
    parts = []
    for k in sorted(m):
        v = m[k]
        if k.endswith("_ns"):
            parts.append(f"{k[:-3]}={v / 1e6:.3f}ms")
        else:
            parts.append(f"{k}={v}")
    return ", ".join(parts)


def print_stage_metrics(
    job_id: str, stage_id: int, plan, stage_metrics: Dict[str, Dict[str, int]]
) -> None:
    """Log the annotated plan when a stage completes
    (reference: display.rs:31-60, called from the stage-completion path)."""
    log.info(
        "=== [%s/%s] Stage finished, physical plan with metrics ===\n%s",
        job_id,
        stage_id,
        DisplayableBallistaExecutionPlan(plan, stage_metrics).indent(),
    )
