"""The query doctor: rule-based bottleneck diagnosis with evidence.

Takes what the observability stack already *records* — the job detail
(stage states, synthetic skew/timing metrics), the per-stage profile,
the critical-path breakdown and the journal slice — and *interprets*
them into structured findings an operator can act on without
hand-deriving where the wall-clock went.  Every finding carries
``evidence`` coordinates pointing at real stage ids and metric values,
so it can be re-verified against ``/api/jobs/{id}/profile`` directly.

Finding shape::

    {"code": "skewed_stage", "severity": "warn" | "info",
     "stage_id": 3,                      # absent for job-level findings
     "summary": "...",                   # one line
     "evidence": {...},                  # metric coordinates
     "suggestion": "..."}                # what to try next

Thresholds are module constants so tests (and adventurous operators)
can pin them.  The doctor never raises: missing inputs simply produce
fewer findings.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .critical_path import compute_critical_path
from .export import TASK_RUNTIME_OP, job_profile

# ------------------------------------------------------------ thresholds
# skew-dominated stage: runtime max/median at least this, and the
# straggler at least this much absolute wall beyond the median
SKEW_COEFFICIENT = 2.0
SKEW_MIN_EXCESS_MS = 50.0
# fetch-bound stage: shuffle-fetch wait at least this fraction of the
# stage's total task time (and a floor so trivial stages stay quiet)
FETCH_FRACTION = 0.35
FETCH_MIN_MS = 20.0
# compile-dominated TPU stage
COMPILE_MIN_MS = 50.0
# admission-queued job: queue wait at least this fraction of wall-clock
ADMISSION_FRACTION = 0.2
ADMISSION_MIN_MS = 200.0
# barrier-dominated job: barrier wait at least this fraction of wall
BARRIER_FRACTION = 0.25
BARRIER_MIN_MS = 50.0
# underprovisioned cluster: scheduling delay (tasks runnable, no slot)
# at least this much of wall-clock while work queued at admission and
# the cluster below its executor ceiling
UNDERPROVISIONED_FRACTION = 0.2
UNDERPROVISIONED_MIN_MS = 200.0
# locality-miss stage: at least this many tasks placed off their
# preferred host, and more misses than hits
LOCALITY_MIN_MISSES = 2

_SEVERITY_ORDER = {"warn": 0, "info": 1}


def _finding(code, severity, summary, suggestion, stage_id=None, **evidence):
    out = {
        "code": code,
        "severity": severity,
        "summary": summary,
        "evidence": evidence,
        "suggestion": suggestion,
    }
    if stage_id is not None:
        out["stage_id"] = stage_id
    return out


def _rule_skewed_stages(detail, profile, out: List[dict]) -> None:
    metrics_by_stage = {
        int(r["stage_id"]): (r.get("metrics") or {})
        for r in detail.get("stages", [])
    }
    for row in profile.get("stages", []):
        skew = (row.get("skew") or {}).get("runtime_ms")
        if not skew:
            continue
        coef = skew.get("max_over_median", 0.0)
        excess = skew.get("max", 0) - skew.get("p50", 0)
        if coef < SKEW_COEFFICIENT or excess < SKEW_MIN_EXCESS_MS:
            continue
        sid = row["stage_id"]
        ev = {
            "runtime_ms_p50": skew.get("p50", 0),
            "runtime_ms_p99": skew.get("p99", 0),
            "runtime_ms_max": skew.get("max", 0),
            "max_over_median": coef,
            "partitions": (row.get("skew") or {}).get("partitions", 0),
        }
        runtimes = metrics_by_stage.get(sid, {}).get(TASK_RUNTIME_OP)
        if runtimes:
            slowest = max(runtimes, key=lambda p: runtimes[p])
            ev["slowest_partition"] = int(slowest)
        out.append(
            _finding(
                "skewed_stage",
                "warn",
                f"stage {sid} is skew-dominated: slowest task "
                f"{skew.get('max', 0)} ms vs median {skew.get('p50', 0)} ms "
                f"({coef:.1f}x)",
                "enable AQE skew splitting (ballista.aqe.skew_enabled) or "
                "speculative execution (ballista.speculation.enabled); "
                "check the partition key's value distribution",
                stage_id=sid,
                **ev,
            )
        )


def _rule_fetch_bound(cp, out: List[dict]) -> None:
    for sid, roll in (cp.get("stages") or {}).items():
        fetch = roll.get("fetch_wait_ms", 0.0)
        task = roll.get("task_time_ms", 0.0)
        if fetch < FETCH_MIN_MS or task <= 0 or fetch < FETCH_FRACTION * task:
            continue
        out.append(
            _finding(
                "fetch_bound_stage",
                "warn",
                f"stage {sid} spent {fetch:.0f} ms ({100 * fetch / task:.0f}% "
                "of its task time) waiting on shuffle fetch",
                "raise ballista.shuffle.fetch_concurrency / prefetch_bytes, "
                "enable locality placement "
                "(ballista.shuffle.locality_enabled), or check the serving "
                "executors' load",
                stage_id=int(sid),
                fetch_wait_ms=fetch,
                task_time_ms=task,
            )
        )


def _rule_compile_dominated(cp, out: List[dict]) -> None:
    for sid, roll in (cp.get("stages") or {}).items():
        compile_ms = roll.get("tpu_compile_ms", 0.0)
        execute_ms = roll.get("tpu_execute_ms", 0.0)
        if compile_ms < COMPILE_MIN_MS or compile_ms <= execute_ms:
            continue
        out.append(
            _finding(
                "compile_dominated_stage",
                "info",
                f"stage {sid} spent {compile_ms:.0f} ms compiling XLA vs "
                f"{execute_ms:.0f} ms executing",
                "expected on first-run shapes; recurring compiles mean the "
                "signature cache is thrashing — pin batch sizes "
                "(ballista.batch.size) so shapes repeat",
                stage_id=int(sid),
                tpu_compile_ms=compile_ms,
                tpu_execute_ms=execute_ms,
            )
        )


def _rule_admission_queued(cp, events, cluster, out: List[dict]) -> None:
    wait = (cp.get("breakdown") or {}).get("admission_queue_wait_ms", 0.0)
    wall = cp.get("wall_clock_ms") or 0.0
    if wait < ADMISSION_MIN_MS or wait < ADMISSION_FRACTION * max(wall, 1.0):
        return
    ev = {"queue_wait_ms": wait, "wall_clock_ms": wall}
    for e in events or []:
        if e.get("kind") == "job_admitted":
            if e.get("pool"):
                ev["pool"] = e["pool"]
            break
    suggestion = (
        "the cluster was saturated: raise the pool's weight "
        "(ballista.tenant.weight), mark the session interactive "
        "(ballista.tenant.priority), or add executors"
    )
    if cluster and cluster.get("scale_out_in_flight"):
        # the autoscaler already reacted: launches are in flight, so the
        # right next step is to wait for the capacity, not re-tune pools
        ev["scale_out_in_flight"] = True
        ev["autoscaler_launching"] = cluster.get("autoscaler_launching", 0)
        suggestion += (
            "; note: an autoscaler scale-out is already in flight "
            f"({cluster.get('autoscaler_launching', 0)} executor(s) "
            "launching) — queue wait should fall once they register"
        )
    out.append(
        _finding(
            "admission_queued_job",
            "warn",
            f"job waited {wait:.0f} ms ({100 * wait / max(wall, 1.0):.0f}% "
            "of wall-clock) in the admission queue before planning",
            suggestion,
            **ev,
        )
    )


def _rule_underprovisioned(cp, cluster, out: List[dict]) -> None:
    """Sustained scheduling delay + work queued at the admission door
    while the cluster sits below its executor ceiling: the job was slow
    because capacity was missing, not because the plan was bad."""
    if not cluster:
        return
    delay = (cp.get("breakdown") or {}).get("scheduling_delay_ms", 0.0)
    wall = cp.get("wall_clock_ms") or 0.0
    if (
        delay < UNDERPROVISIONED_MIN_MS
        or delay < UNDERPROVISIONED_FRACTION * max(wall, 1.0)
    ):
        return
    queued = cluster.get("admission_queued_jobs", 0)
    alive = cluster.get("alive_executors", 0)
    max_executors = cluster.get("max_executors", 0)
    if not queued or not max_executors or alive >= max_executors:
        return
    if cluster.get("autoscaler_enabled"):
        suggestion = (
            "the autoscaler has headroom "
            f"({alive} alive < max_executors {max_executors}): check its "
            "journal (autoscale_decision events) for launch failures or "
            "backoff, or raise ballista.autoscaler.max_executors"
        )
    else:
        suggestion = (
            "enable ballista.autoscaler.enabled so the scheduler launches "
            "executors when scheduling delay sustains, or add executors "
            "manually"
        )
    out.append(
        _finding(
            "underprovisioned_cluster",
            "warn",
            f"job spent {delay:.0f} ms ({100 * delay / max(wall, 1.0):.0f}% "
            "of wall-clock) waiting for task slots while "
            f"{queued} job(s) queued at admission and only {alive} of "
            f"{max_executors} allowed executor(s) were alive",
            suggestion,
            scheduling_delay_ms=delay,
            wall_clock_ms=wall,
            admission_queued_jobs=queued,
            alive_executors=alive,
            max_executors=max_executors,
            autoscaler_enabled=bool(cluster.get("autoscaler_enabled")),
        )
    )


def _rule_barrier_dominated(cp, detail, out: List[dict]) -> None:
    barrier = (cp.get("breakdown") or {}).get("barrier_wait_ms", 0.0)
    wall = cp.get("wall_clock_ms") or 0.0
    if barrier < BARRIER_MIN_MS or barrier < BARRIER_FRACTION * max(wall, 1.0):
        return
    stages = [
        r["stage_id"]
        for r in cp.get("critical_path", [])
        if (r.get("segments") or {}).get("barrier_wait_ms", 0.0) > 0
    ]
    # streamable/pipeline-breaker classification of the barrier
    # producers' CONSUMERS (the scheduler's classify_shuffle_inputs walk,
    # carried on the job detail): the upside is only reachable where the
    # consumer can legally start on partial input
    rows = {
        int(r["stage_id"]): r for r in (detail or {}).get("stages", [])
    }
    consumers: Dict[str, str] = {}
    for sid in stages:
        for c in (rows.get(int(sid)) or {}).get("output_links", []):
            pl = (rows.get(int(c)) or {}).get("pipeline") or {}
            streamable = int(sid) in (pl.get("streamable_inputs") or [])
            consumers[str(c)] = (
                "streamable" if streamable else "pipeline_breaker"
            )
    reachable = any(v == "streamable" for v in consumers.values())
    if reachable or not consumers:
        suggestion = (
            "enable pipelined execution (ballista.shuffle.pipelined=true): "
            "streamable consumers start once ballista.shuffle."
            "pipelined_min_fraction of map output has committed — "
            f"estimated upside up to {barrier:.0f} ms"
        )
    else:
        suggestion = (
            "the consumers are pipeline breakers (sort / hash-join "
            "build), so ballista.shuffle.pipelined cannot overlap this "
            "window — AQE coalescing and speculation shrink the stage "
            "tails instead"
        )
    out.append(
        _finding(
            "barrier_dominated_job",
            "warn",
            f"{barrier:.0f} ms ({100 * barrier / max(wall, 1.0):.0f}% of "
            "wall-clock) was stage-barrier wait: partial map output "
            "existed while consumers sat idle",
            suggestion,
            barrier_wait_ms=barrier,
            wall_clock_ms=wall,
            pipelining_upside_ms=barrier,
            producer_stages=stages,
            consumer_classification=consumers,
            upside_reachable=reachable,
        )
    )


def _rule_locality_miss(profile, out: List[dict]) -> None:
    for row in profile.get("stages", []):
        placement = (row.get("locality") or {}).get("placement")
        if not placement:
            continue
        local = int(placement.get("local", 0))
        misses = int(placement.get("any", 0))
        if misses < LOCALITY_MIN_MISSES or misses <= local:
            continue
        sid = row["stage_id"]
        out.append(
            _finding(
                "locality_miss_stage",
                "info",
                f"stage {sid} placed {misses} of {misses + local} tasks off "
                "their preferred (most-input-bytes) host",
                "raise ballista.shuffle.locality_wait_seconds, or check "
                "whether the preferred hosts' slots were saturated",
                stage_id=sid,
                placed_local=local,
                placed_any=misses,
                remote_fetches=(row.get("locality") or {}).get(
                    "remote_fetches", 0
                ),
            )
        )


def _rule_speculation_saved(profile, out: List[dict]) -> None:
    for row in profile.get("stages", []):
        spec = row.get("speculation") or {}
        if not spec.get("wins"):
            continue
        sid = row["stage_id"]
        out.append(
            _finding(
                "speculation_saved_straggler",
                "info",
                f"stage {sid}: {spec['wins']} straggler(s) were beaten by "
                "speculative duplicates",
                "working as intended — if this recurs on the same stage, "
                "the underlying skew/host imbalance is worth fixing",
                stage_id=sid,
                wins=spec.get("wins", 0),
                launched=spec.get("launched", 0),
                wasted=spec.get("wasted", 0),
            )
        )


def diagnose(
    detail: dict,
    profile: dict,
    cp: dict,
    events: Optional[List[dict]] = None,
    cluster: Optional[dict] = None,
) -> List[dict]:
    """Run every rule; returns findings sorted warn-first, then by
    stage id (job-level findings first within a severity).  ``cluster``
    is the scheduler's live context (alive/max executors, admission
    queue depth, autoscaler state) for the capacity rules — REST/gRPC
    handlers pass it, offline replays may not."""
    out: List[dict] = []
    _rule_admission_queued(cp, events, cluster, out)
    _rule_underprovisioned(cp, cluster, out)
    _rule_barrier_dominated(cp, detail, out)
    _rule_skewed_stages(detail, profile, out)
    _rule_fetch_bound(cp, out)
    _rule_compile_dominated(cp, out)
    _rule_locality_miss(profile, out)
    _rule_speculation_saved(profile, out)
    out.sort(
        key=lambda f: (
            _SEVERITY_ORDER.get(f.get("severity"), 9),
            f.get("stage_id", -1),
            f.get("code", ""),
        )
    )
    return out


def job_report(
    detail: dict,
    spans: List[dict],
    events: Optional[List[dict]] = None,
    cluster: Optional[dict] = None,
) -> dict:
    """One-stop diagnosis bundle: profile + critical path + findings.
    Shared by the REST handlers and the gRPC ``include_profile`` path so
    every surface (dashboard, ``explain_analyze``) reads identical
    numbers."""
    profile = job_profile(detail, spans)
    cp = compute_critical_path(detail, events)
    findings = diagnose(detail, profile, cp, events, cluster)
    profile["doctor"] = findings
    profile["breakdown"] = cp.get("breakdown")
    return {"profile": profile, "critical_path": cp, "doctor": findings}


# ------------------------------------------------------ explain analyze
def _fmt_ms(v) -> str:
    if v is None:
        return "?"
    return f"{v:.1f}ms" if v < 10_000 else f"{v / 1e3:.2f}s"


def _pct(part, whole) -> str:
    if not whole:
        return ""
    return f" ({100.0 * part / whole:.0f}%)"


def render_explain_analyze(report: dict) -> str:
    """EXPLAIN-ANALYZE-style text tree of a job's diagnosis bundle
    (client surface: ``BallistaContext.explain_analyze(job_id)``)."""
    profile = report.get("profile") or {}
    cp = report.get("critical_path") or {}
    findings = report.get("doctor") or []
    wall = cp.get("wall_clock_ms")
    lines = [
        f"Job {profile.get('job_id', '?')} [{profile.get('state', '?')}] — "
        f"wall-clock {_fmt_ms(wall)}"
        + ("" if cp.get("complete") else " (timing incomplete)")
    ]
    breakdown = cp.get("breakdown") or {}
    nonzero = [(k, v) for k, v in breakdown.items() if v and v > 0.05]
    if nonzero:
        lines.append("├─ where it went:")
        for k, v in sorted(nonzero, key=lambda kv: -kv[1]):
            label = k[:-3].replace("_", " ")
            lines.append(f"│    {label:<22} {_fmt_ms(v):>10}{_pct(v, wall)}")
    path = cp.get("critical_path") or []
    if path:
        lines.append("├─ critical path:")
        for i, row in enumerate(path):
            seg = row.get("segments") or {}
            parts = [
                f"{k[:-3].replace('_', ' ')} {_fmt_ms(v)}"
                for k, v in seg.items()
                if v and v > 0.05
            ]
            arrow = "└▶" if i == len(path) - 1 else "├▶"
            lines.append(
                f"│  {arrow} stage {row['stage_id']} "
                f"(task {row.get('partition', '?')}/{row.get('tasks', '?')}) "
                f"+{_fmt_ms(row.get('dispatch_ms'))} → "
                f"{_fmt_ms(row.get('completed_ms'))}"
            )
            if parts:
                lines.append(f"│       {' · '.join(parts)}")
    if findings:
        lines.append("├─ doctor:")
        for f in findings:
            lines.append(f"│    [{f['severity']}] {f['code']}: {f['summary']}")
    else:
        lines.append("├─ doctor: no findings")
    lines.append("└─ stages:")
    for row in profile.get("stages", []):
        bits = [f"{row.get('partitions', '?')} task(s)"]
        if row.get("cache"):
            # plan-cache serve: output restored from a fingerprint-
            # matched prior run, no tasks dispatched for this stage
            bits.append(f"cache hit ({row['cache'].get('bytes', 0):,}B)")
        if row.get("task_retries"):
            bits.append(f"{row['task_retries']} retr.")
        if row.get("shuffle_bytes_fetched"):
            bits.append(f"read {row['shuffle_bytes_fetched']:,}B")
        sw = row.get("shuffle_write") or {}
        if sw.get("bytes_wire"):
            bits.append(f"wrote {sw['bytes_wire']:,}B")
        tpu = row.get("tpu") or {}
        if tpu:
            bits.append(
                f"tpu {_fmt_ms(tpu.get('compile_ms', 0))} compile / "
                f"{_fmt_ms(tpu.get('execute_ms', 0))} exec"
            )
        skew = (row.get("skew") or {}).get("runtime_ms")
        if skew and skew.get("max_over_median", 0) >= SKEW_COEFFICIENT:
            bits.append(f"skew {skew['max_over_median']:.1f}x")
        lines.append(
            f"     stage {row['stage_id']:<3} [{row.get('state', '?'):<10}] "
            + " · ".join(bits)
        )
    return "\n".join(lines)
