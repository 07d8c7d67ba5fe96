"""Critical-path attribution: where a job's wall-clock actually went.

Joins a job's stage DAG with the scheduler-side timeline anchors
(``__stage_timing__`` / ``__task_dispatch_us__`` / ``__task_finish_us__``
synthetic stage metrics, recorded by ``scheduler/execution_graph.py`` on
one clock) into:

* the **critical path** — the chain of stages whose last-committing
  tasks determined end-to-end latency (walk back from the final stage,
  always through the producer that finished last);
* a **time breakdown** that PARTITIONS the job's wall-clock into
  non-overlapping categories, so they sum to wall-clock by construction:

  - ``admission_queue_wait_ms`` — held in the admission queue before
    planning (journal ``job_admitted.queue_wait_s``);
  - ``planning_ms`` — distributed planning (graph build);
  - ``scheduling_delay_ms`` — Σ over critical stages of
    resolvable → first dispatch (event-loop + slot-wait latency);
  - ``fetch_wait_ms`` / ``tpu_compile_ms`` / ``tpu_execute_ms`` /
    ``shuffle_write_ms`` / ``compute_ms`` — the critical stage's active
    window, split in proportion to its summed per-task operator metrics
    (``fetch_wait_time_ns``, ``tpu_compile_ns``, ``tpu_execute_ns``,
    ``write_time_ns``; the residual is host/device compute);
  - ``barrier_wait_ms`` — for every NON-final critical stage, the tail
    between its first task commit and its last: partial output already
    existed but the stage barrier held every consumer back.  This is the
    exact window streaming/pipelined execution (ROADMAP item 4) would
    overlap, so it doubles as the ``pipelining_upside_ms`` estimate.

Degradation contract: every anchor may be missing (decoded pre-PR
graphs, scheduler restart mid-job, sampling off — the anchors are
scheduler-side and do NOT depend on span sampling).  Missing data
degrades the affected segments to zero and flags ``complete: false``;
nothing here ever raises on a well-formed job detail.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

_NS_PER_MS = 1e6
_US_PER_MS = 1e3

# Wall-clock partition categories, in render order.
CATEGORIES = (
    "admission_queue_wait_ms",
    "planning_ms",
    "scheduling_delay_ms",
    "fetch_wait_ms",
    "tpu_compile_ms",
    "tpu_execute_ms",
    "compute_ms",
    "shuffle_write_ms",
    "barrier_wait_ms",
    "other_ms",
)

# operator-metric key -> breakdown category for the proportional split
# of a critical stage's active window
_METRIC_CATEGORIES = (
    ("fetch_wait_time_ns", "fetch_wait_ms"),
    ("tpu_compile_ns", "tpu_compile_ms"),
    ("tpu_execute_ns", "tpu_execute_ms"),
    ("write_time_ns", "shuffle_write_ms"),
)


def stage_timing_of(stage) -> dict:
    """Extract the timing block from a LIVE scheduler stage object
    (Resolved/Running: direct attrs; Completed: the persisted synthetic
    metrics).  Returns {} when nothing was recorded.  Called by
    ``TaskManager._detail_of`` under the job entry lock."""
    from .export import STAGE_TIMING_OP, TASK_DISPATCH_OP, TASK_FINISH_OP

    out: dict = {}
    ready = getattr(stage, "ready_unix_ns", 0)
    disp = getattr(stage, "task_dispatch_unix_ns", None)
    fin = getattr(stage, "task_finish_unix_ns", None)
    if disp or fin or ready:
        if ready:
            out["ready_us"] = int(ready) // 1000
        if disp:
            out["dispatch_us"] = {int(p): int(v) // 1000 for p, v in disp.items()}
        if fin:
            out["finish_us"] = {int(p): int(v) // 1000 for p, v in fin.items()}
        return out
    metrics = getattr(stage, "stage_metrics", None) or {}
    summary = metrics.get(STAGE_TIMING_OP)
    if summary and summary.get("ready_us"):
        out["ready_us"] = int(summary["ready_us"])
    disp = metrics.get(TASK_DISPATCH_OP)
    if disp:
        out["dispatch_us"] = {int(p): int(v) for p, v in disp.items()}
    fin = metrics.get(TASK_FINISH_OP)
    if fin:
        out["finish_us"] = {int(p): int(v) for p, v in fin.items()}
    return out


def _metric_sums(row: dict) -> Dict[str, int]:
    """Sum the attribution-relevant operator metrics across a stage row's
    non-synthetic operators."""
    out = {k: 0 for k, _ in _METRIC_CATEGORIES}
    for op, vals in (row.get("metrics") or {}).items():
        if op.startswith("__"):
            continue
        for k in out:
            out[k] += int(vals.get(k, 0))
    return out


def _timing(row: dict) -> dict:
    return row.get("timing") or {}


def _task_time_us(tm: dict) -> int:
    """Summed per-task wall (dispatch → commit) over the partitions
    carrying both anchors — the ONE task-time rule, shared by the
    breakdown's proportional split and the doctor's per-stage rollup so
    the evidence always agrees with the attribution it annotates."""
    disp = tm.get("dispatch_us") or {}
    fin = tm.get("finish_us") or {}
    return sum(max(0, fin[p] - disp[p]) for p in fin if p in disp)


def _stage_end_us(row: dict) -> Optional[int]:
    fin = _timing(row).get("finish_us")
    return max(fin.values()) if fin else None


def admission_wait_ms(events: Optional[List[dict]]) -> float:
    """Queue wait from the journal (``job_admitted.queue_wait_s``); 0
    when the journal is disabled or the job was never queued."""
    for e in events or []:
        if e.get("kind") == "job_admitted":
            try:
                return max(0.0, float(e.get("queue_wait_s", 0.0))) * 1e3
            except (TypeError, ValueError):
                return 0.0
    return 0.0


def _final_stage_id(stages: Dict[int, dict]) -> Optional[int]:
    sinks = [
        sid
        for sid, row in stages.items()
        if not [c for c in row.get("output_links", []) if int(c) in stages]
    ]
    return max(sinks) if sinks else (max(stages) if stages else None)


def _producers(stages: Dict[int, dict]) -> Dict[int, List[int]]:
    preds: Dict[int, List[int]] = {sid: [] for sid in stages}
    for sid, row in stages.items():
        for consumer in row.get("output_links", []):
            if int(consumer) in preds:
                preds[int(consumer)].append(sid)
    return preds


def _chain(stages: Dict[int, dict]) -> List[int]:
    """Final stage ← always the producer whose last task committed last
    (the one that determined when the consumer became dispatchable)."""
    final = _final_stage_id(stages)
    if final is None:
        return []
    preds = _producers(stages)
    chain = [final]
    seen = {final}
    cur = final
    while True:
        best: Optional[Tuple[int, int]] = None  # (end_us, sid)
        for p in preds.get(cur, []):
            if p in seen:
                continue
            end = _stage_end_us(stages[p])
            if end is None:
                # no timing on this producer: deterministic fallback so
                # the chain still descends (degraded, flagged upstream)
                end = -1
            if best is None or (end, p) > best:
                best = (end, p)
        if best is None:
            break
        cur = best[1]
        seen.add(cur)
        chain.append(cur)
    chain.reverse()
    return chain


def _split_window(
    window_us: int, sums_ns: Dict[str, int], total_task_ns: int, out: Dict[str, float]
) -> None:
    """Attribute ``window_us`` of wall-clock across the metric categories
    in proportion to the stage's summed task time; residual → compute.
    Exact partition: the parts always sum to the window."""
    if window_us <= 0:
        return
    window_ms = window_us / _US_PER_MS
    if total_task_ns <= 0:
        out["compute_ms"] += window_ms
        return
    attributed = 0.0
    for key, cat in _METRIC_CATEGORIES:
        # never over-attribute past the window (task-time sums can exceed
        # wall when tasks run concurrently inside one stage)
        part = min(
            max(0.0, window_ms * sums_ns.get(key, 0) / total_task_ns),
            window_ms - attributed,
        )
        out[cat] += part
        attributed += part
    out["compute_ms"] += max(0.0, window_ms - attributed)


def stage_rollup(row: dict) -> dict:
    """Per-stage attribution totals over ALL of the stage's task attempts
    (not just the critical one) — the doctor's per-stage evidence."""
    tm = _timing(row)
    disp = tm.get("dispatch_us") or {}
    fin = tm.get("finish_us") or {}
    total_task_us = _task_time_us(tm)
    sums = _metric_sums(row)
    out = {
        "stage_id": row.get("stage_id"),
        "task_time_ms": round(total_task_us / _US_PER_MS, 3),
        "fetch_wait_ms": round(sums["fetch_wait_time_ns"] / _NS_PER_MS, 3),
        "tpu_compile_ms": round(sums["tpu_compile_ns"] / _NS_PER_MS, 3),
        "tpu_execute_ms": round(sums["tpu_execute_ns"] / _NS_PER_MS, 3),
        "shuffle_write_ms": round(sums["write_time_ns"] / _NS_PER_MS, 3),
    }
    ready = tm.get("ready_us")
    if ready and disp:
        out["scheduling_delay_ms"] = round(
            sum(max(0, d - ready) for d in disp.values()) / _US_PER_MS, 3
        )
    if fin:
        end = max(fin.values())
        first = min(fin.values())
        out["barrier_tail_ms"] = round(max(0, end - first) / _US_PER_MS, 3)
    return out


def compute_critical_path(
    detail: dict, events: Optional[List[dict]] = None
) -> dict:
    """The ``GET /api/jobs/{id}/critical_path`` payload.  ``detail`` is
    ``TaskManager.get_job_detail`` output (stage rows carrying
    ``timing`` blocks); ``events`` the job's journal slice (admission
    wait), or None."""
    stages = {
        int(r["stage_id"]): r for r in detail.get("stages", [])
    }
    breakdown: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
    admission_ms = admission_wait_ms(events)
    breakdown["admission_queue_wait_ms"] = admission_ms

    out = {
        "job_id": detail.get("job_id"),
        "state": detail.get("state"),
        "complete": False,
        "critical_path": [],
        "breakdown": breakdown,
        "stages": {
            sid: stage_rollup(row) for sid, row in sorted(stages.items())
        },
    }

    submitted_us = detail.get("submitted_us")
    planning_us = detail.get("planning_us") or 0
    chain = _chain(stages)
    if not chain or submitted_us is None:
        out["wall_clock_ms"] = round(admission_ms, 3)
        return out

    breakdown["planning_ms"] = planning_us / _US_PER_MS
    cursor = submitted_us + planning_us
    degraded = False
    skipped_gap = False
    path_rows = []
    for i, sid in enumerate(chain):
        row = stages[sid]
        tm = _timing(row)
        disp = tm.get("dispatch_us") or {}
        fin = tm.get("finish_us") or {}
        if not disp or not fin:
            # no anchors (pre-upgrade stage, restart mid-job): its
            # runtime must degrade to UNATTRIBUTED time, not leak into
            # the next stage's scheduling delay
            degraded = True
            skipped_gap = True
            continue
        final_link = i == len(chain) - 1
        ready = tm.get("ready_us") or cursor
        first_dispatch = min(disp.values())
        first_finish = min(fin.values())
        end = max(fin.values())
        crit_partition = max(fin, key=lambda p: fin[p])

        if skipped_gap:
            # the wall spent inside the skipped anchor-less stage(s)
            # ends where this stage became dispatchable (its ready
            # anchor; first dispatch when that too is missing) — charge
            # it to other_ms so scheduling_delay_ms stays honest
            anchor = tm.get("ready_us") or first_dispatch
            breakdown["other_ms"] += max(0, anchor - cursor) / _US_PER_MS
            cursor = max(cursor, anchor)
            skipped_gap = False

        # monotone cursor advance: every segment is max(point-cursor, 0),
        # so the segments partition [submit, end] exactly whatever the
        # anchors' small-scale disorder
        sched_us = max(0, first_dispatch - cursor)
        breakdown["scheduling_delay_ms"] += sched_us / _US_PER_MS
        cursor = max(cursor, first_dispatch)

        seg: Dict[str, float] = {c: 0.0 for c in CATEGORIES[2:]}
        seg["scheduling_delay_ms"] = round(sched_us / _US_PER_MS, 3)
        # active window: dispatch → first commit (final stage: → last
        # commit; it has no consumer a barrier could hold back)
        window_end = end if final_link else max(first_finish, cursor)
        window_us = max(0, window_end - cursor)
        sums = _metric_sums(row)
        total_task_ns = _task_time_us(tm) * 1000
        _split_window(window_us, sums, total_task_ns, seg)
        cursor = max(cursor, window_end)
        if not final_link:
            # barrier wait ends where the next critical stage STARTED: a
            # pipelined consumer dispatches before this stage's last
            # commit, and from that point the wall is the consumer's
            # active window (its fetch-wait metrics attribute the
            # stall-on-producer), not barrier.  Barrier-scheduled jobs
            # have next_dispatch >= end, so their numbers are unchanged;
            # a next stage without anchors degrades to the full tail.
            next_disp = _timing(stages[chain[i + 1]]).get("dispatch_us") or {}
            cap = (
                min(end, max(min(next_disp.values()), cursor))
                if next_disp
                else end
            )
            barrier_us = max(0, cap - cursor)
            seg["barrier_wait_ms"] = round(barrier_us / _US_PER_MS, 3)
            cursor = max(cursor, cap)
        for c in CATEGORIES[3:]:
            breakdown[c] += seg[c]
            seg[c] = round(seg[c], 3)

        path_rows.append(
            {
                "stage_id": sid,
                "partition": crit_partition,
                "ready_ms": round((ready - submitted_us) / _US_PER_MS, 3),
                "dispatch_ms": round(
                    (first_dispatch - submitted_us) / _US_PER_MS, 3
                ),
                "first_finish_ms": round(
                    (first_finish - submitted_us) / _US_PER_MS, 3
                ),
                "completed_ms": round((end - submitted_us) / _US_PER_MS, 3),
                "tasks": row.get("partitions"),
                "segments": seg,
            }
        )

    wall_ms = admission_ms + max(0, cursor - submitted_us) / _US_PER_MS
    for c in breakdown:
        breakdown[c] = round(breakdown[c], 3)
    total = sum(breakdown.values())
    out.update(
        {
            "critical_path": path_rows,
            "wall_clock_ms": round(wall_ms, 3),
            "breakdown_total_ms": round(total, 3),
            "coverage": round(total / wall_ms, 4) if wall_ms > 0 else None,
            "pipelining_upside_ms": breakdown["barrier_wait_ms"],
            "complete": (
                not degraded
                and detail.get("state") == "completed"
                and bool(path_rows)
            ),
        }
    )
    return out
