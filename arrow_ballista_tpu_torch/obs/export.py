"""Trace and profile exports.

* :func:`chrome_trace` — spans → Chrome Trace Event JSON (the "JSON array
  format with metadata"), loadable in Perfetto / chrome://tracing.  Each
  distinct recording process becomes a pid row with a process_name
  metadata event, so one job renders scheduler and executor lanes on a
  single wall-clock timeline.
* :func:`job_profile` — EXPLAIN-ANALYZE-style per-stage rollup joining
  the scheduler's job detail (stage states, attempts, merged operator
  metrics) with the job's spans: queue wait, attempt count, shuffle
  bytes/retries, TPU compile-vs-execute split and compile-cache
  hit/miss from ``ops/stage_compiler.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# ---------------------------------------------------------------------------
# stage skew analytics
#
# At stage completion the per-partition runtime and written-bytes
# distributions reduce to p50/p99/max and a max-over-median skew
# coefficient — the direct input for the ROADMAP's adaptive re-planning
# (coalesce partitions when bytes skew is low and counts are high; split
# when one partition dominates).  The reduction persists inside
# ``CompletedStage.stage_metrics`` under synthetic operator names (the
# stage-metrics proto already survives job-cache eviction), with ratios
# scaled x1000 to fit the int-valued metric map:
#
#   __stage_skew__        {runtime_ms_{p50,p99,max}, runtime_ms_skew_x1000,
#                          bytes_{raw,wire}_{p50,p99,max},
#                          bytes_{raw,wire}_skew_x1000, partitions}
#   __task_runtime_ms__   {str(partition): runtime_ms}   (raw distribution)
#   __task_bytes_wire__   {str(partition): bytes}
#   __task_bytes_raw__    {str(partition): bytes}
#
# ``job_profile`` lifts __stage_skew__ into a float-valued ``skew`` block
# per stage; the raw per-partition maps stay available for independent
# recomputation (tests do exactly that).
STAGE_SKEW_OP = "__stage_skew__"
TASK_RUNTIME_OP = "__task_runtime_ms__"
TASK_BYTES_WIRE_OP = "__task_bytes_wire__"
TASK_BYTES_RAW_OP = "__task_bytes_raw__"
# AQE replan summary (scheduler/adaptive.py): {tasks_before, tasks_after,
# coalesced_groups, skew_splits, broadcast} — persisted through the same
# stage-metrics proto path, lifted into row["aqe"] by job_profile
AQE_OP = "__aqe__"
# Locality placement rollup: {"local": tasks dispatched on
# their preferred host, "any": elsewhere} — lifted into row["locality"]
LOCALITY_OP = "__locality_placement__"
# Stage/task wall-clock anchors (query doctor): epoch
# MICROsecond timestamps recorded scheduler-side (one clock for the
# whole job, so critical-path segments subtract cleanly) and persisted
# through the same stage-metrics proto path as the skew analytics:
#
#   __stage_timing__      {ready_us, first_dispatch_us, first_finish_us,
#                          completed_us, partitions}
#   __task_dispatch_us__  {str(partition): epoch_us at dispatch}
#   __task_finish_us__    {str(partition): epoch_us at commit}
#
# obs/critical_path.py joins these (with the graph-level
# submitted_unix_us/planning_us proto fields) into the per-job time
# breakdown and the critical path; they survive cache eviction/restart
# like every other synthetic op.
STAGE_TIMING_OP = "__stage_timing__"
TASK_DISPATCH_OP = "__task_dispatch_us__"
TASK_FINISH_OP = "__task_finish_us__"
# Pipelined execution marker: {"tail_inputs": n, "partial_start":
# 1} on stages that STARTED on partial map output — the progress endpoint
# excludes their (stall-inflated) task runtimes from the ETA median and
# the doctor reports the run as pipelined
PIPELINED_OP = "__pipelined__"
# Plan-cache marker: {"cache_hit": 1, "bytes": n} on stages
# resolved straight from cached shuffle output — zero tasks dispatched;
# job detail/profile lift it into row["cache"] so a hit is visible
# everywhere the doctor's numbers are
CACHE_OP = "__cache__"
_SYNTHETIC_OPS = (
    STAGE_SKEW_OP, TASK_RUNTIME_OP, TASK_BYTES_WIRE_OP, TASK_BYTES_RAW_OP,
    AQE_OP, LOCALITY_OP, STAGE_TIMING_OP, TASK_DISPATCH_OP, TASK_FINISH_OP,
    PIPELINED_OP, CACHE_OP,
)


def stage_timing_metrics(
    ready_unix_ns: int,
    task_dispatch_unix_ns: Dict[int, int],
    task_finish_unix_ns: Dict[int, int],
) -> Dict[str, Dict[str, int]]:
    """Reduce a completing stage's timestamp anchors into the synthetic
    timing operators above; {} when nothing was recorded (decoded
    graphs, stages completed before this PR's scheduler)."""
    out: Dict[str, Dict[str, int]] = {}
    summary: Dict[str, int] = {}
    if ready_unix_ns:
        summary["ready_us"] = ready_unix_ns // 1000
    if task_dispatch_unix_ns:
        disp = {p: ns // 1000 for p, ns in task_dispatch_unix_ns.items()}
        summary["first_dispatch_us"] = min(disp.values())
        summary["partitions"] = len(disp)
        out[TASK_DISPATCH_OP] = {str(p): v for p, v in disp.items()}
    if task_finish_unix_ns:
        fin = {p: ns // 1000 for p, ns in task_finish_unix_ns.items()}
        summary["first_finish_us"] = min(fin.values())
        summary["completed_us"] = max(fin.values())
        summary.setdefault("partitions", len(fin))
        out[TASK_FINISH_OP] = {str(p): v for p, v in fin.items()}
    if summary:
        out[STAGE_TIMING_OP] = summary
    return out


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0,1]) on a non-empty list."""
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[idx]


def skew_coefficient(values: List[float]) -> float:
    """max-over-median: 1.0 = perfectly balanced, large = one straggler
    partition dominates.  0 when the distribution is degenerate."""
    if not values:
        return 0.0
    med = percentile(values, 0.5)
    return (max(values) / med) if med > 0 else 0.0


def _dist_metrics(prefix: str, values: List[float]) -> Dict[str, int]:
    return {
        f"{prefix}_p50": int(percentile(values, 0.5)),
        f"{prefix}_p99": int(percentile(values, 0.99)),
        f"{prefix}_max": int(max(values)),
        f"{prefix}_skew_x1000": int(round(skew_coefficient(values) * 1000)),
    }


def stage_skew_metrics(
    task_runtime_s: Dict[int, float],
    task_bytes: Dict[int, Dict[str, int]],
) -> Dict[str, Dict[str, int]]:
    """Reduce per-partition runtimes/bytes into the synthetic stage-metric
    operators described above; {} when nothing was recorded (decoded
    graphs, stages completed before this PR's scheduler)."""
    out: Dict[str, Dict[str, int]] = {}
    skew: Dict[str, int] = {}
    if task_runtime_s:
        # reduce over the SAME integer values published in the raw map,
        # so an independent consumer recomputing quantiles from
        # __task_runtime_ms__ lands on the exact stored coefficients
        ms = {p: int(max(0.0, v) * 1e3) for p, v in task_runtime_s.items()}
        skew.update(_dist_metrics("runtime_ms", list(ms.values())))
        skew["partitions"] = len(ms)
        out[TASK_RUNTIME_OP] = {str(p): v for p, v in ms.items()}
    if task_bytes:
        wire = {p: int(b.get("wire", 0)) for p, b in task_bytes.items()}
        raw = {p: int(b.get("raw", 0)) for p, b in task_bytes.items()}
        skew.update(_dist_metrics("bytes_wire", list(wire.values())))
        skew.update(_dist_metrics("bytes_raw", list(raw.values())))
        skew.setdefault("partitions", len(wire))
        out[TASK_BYTES_WIRE_OP] = {str(p): v for p, v in wire.items()}
        out[TASK_BYTES_RAW_OP] = {str(p): v for p, v in raw.items()}
    if skew:
        out[STAGE_SKEW_OP] = skew
    return out


def _skew_block(metrics: Dict[str, Dict[str, int]]) -> Optional[dict]:
    """__stage_skew__ → the float-valued profile block."""
    raw = metrics.get(STAGE_SKEW_OP)
    if not raw:
        return None

    def dist(prefix: str) -> Optional[dict]:
        if f"{prefix}_max" not in raw:
            return None
        return {
            "p50": raw.get(f"{prefix}_p50", 0),
            "p99": raw.get(f"{prefix}_p99", 0),
            "max": raw.get(f"{prefix}_max", 0),
            "max_over_median": raw.get(f"{prefix}_skew_x1000", 0) / 1000.0,
        }

    out = {"partitions": raw.get("partitions", 0)}
    for key, prefix in (
        ("runtime_ms", "runtime_ms"),
        ("bytes_wire", "bytes_wire"),
        ("bytes_raw", "bytes_raw"),
    ):
        d = dist(prefix)
        if d is not None:
            out[key] = d
    return out


# spans that get a Perfetto flow arrow from their parent slice — the
# shuffle-fetch → serving-side do_get stitch is the one the data plane
# produces (trace ctx forwarded over Flight gRPC metadata; obs/trace.py
# propagation_headers).  Emitted whenever the parent span is present:
# usually cross-process, but a loopback Flight fetch (standalone, or
# zero-copy off) still crosses threads and reads better linked.
_FLOW_SPAN_NAMES = ("flight.do_get",)


def chrome_trace(spans: List[dict], job_id: str = "") -> dict:
    """Spans (recorder dicts) → Chrome trace JSON object.

    Beyond the raw slices: per-process ``process_name`` and per-thread
    ``thread_name`` metadata (named after the first span recorded on the
    thread, so executor task workers read as "task.execute" lanes), and
    flow events (``ph: "s"``/``"f"``) linking a caller's
    ``shuffle.fetch`` span to the serving executor's ``flight.do_get``
    span — Perfetto then renders cross-process arrows instead of
    disconnected tracks."""
    pids: Dict[str, int] = {}
    thread_names: Dict[tuple, str] = {}
    by_span: Dict[str, dict] = {}
    events: List[dict] = []
    for s in spans:
        proc = s.get("proc", "proc")
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": proc},
                }
            )
        tid = s.get("tid", 0)
        if (pid, tid) not in thread_names:
            thread_names[(pid, tid)] = s.get("name", "span")
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": s.get("name", "span")},
                }
            )
        if s.get("span"):
            by_span[s["span"]] = s
        args = dict(s.get("attrs") or {})
        args["span_id"] = s.get("span", "")
        if s.get("parent"):
            args["parent_span_id"] = s["parent"]
        events.append(
            {
                "name": s.get("name", "span"),
                "cat": s.get("trace", ""),
                "ph": "X",
                "pid": pid,
                "tid": tid,
                # Chrome trace timestamps are MICROseconds
                "ts": s.get("ts", 0) / 1000.0,
                "dur": max(s.get("dur", 0), 1) / 1000.0,
                "args": args,
            }
        )
    # flow arrows: serving-side span linked back to its caller's slice
    for s in spans:
        if s.get("name") not in _FLOW_SPAN_NAMES:
            continue
        parent = by_span.get(s.get("parent", ""))
        if parent is None:
            continue
        flow = {
            "name": f"{parent.get('name', 'span')}→{s.get('name')}",
            "cat": "flow",
            "id": s.get("span", ""),
        }
        # the start step must sit INSIDE the parent slice for Perfetto
        # to bind the arrow; clamp to its window
        p_ts, p_dur = parent.get("ts", 0), parent.get("dur", 0)
        start_ts = min(max(s.get("ts", 0), p_ts), p_ts + p_dur)
        events.append(
            {
                **flow,
                "ph": "s",
                "pid": pids.get(parent.get("proc", "proc"), 0),
                "tid": parent.get("tid", 0),
                "ts": start_ts / 1000.0,
            }
        )
        events.append(
            {
                **flow,
                "ph": "f",
                "bp": "e",
                "pid": pids.get(s.get("proc", "proc"), 0),
                "tid": s.get("tid", 0),
                "ts": s.get("ts", 0) / 1000.0,
            }
        )
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if job_id:
        out["otherData"] = {"job_id": job_id}
    return out


def _stage_of(span: dict) -> Optional[int]:
    st = (span.get("attrs") or {}).get("stage")
    try:
        return int(st)
    except (TypeError, ValueError):
        return None


_NS_PER_MS = 1e6


def job_profile(detail: dict, spans: List[dict]) -> dict:
    """Join the scheduler's job detail with the job's spans into a
    per-stage profile.  ``detail`` is ``TaskManager.get_job_detail``
    output; missing spans degrade the timing columns to null, never the
    whole profile."""
    task_spans: Dict[int, List[dict]] = {}
    root_ts: Optional[int] = None
    for s in spans:
        if s.get("name") == "job" or s.get("span") == s.get("trace"):
            root_ts = s.get("ts") if root_ts is None else min(root_ts, s["ts"])
        if s.get("name") in ("task.execute", "task.run"):
            sid = _stage_of(s)
            if sid is not None:
                task_spans.setdefault(sid, []).append(s)
    if root_ts is None and spans:
        root_ts = min(s.get("ts", 0) for s in spans)

    stages_detail = detail.get("stages", [])
    preds: Dict[int, List[int]] = {int(r["stage_id"]): [] for r in stages_detail}
    for r in stages_detail:
        for consumer in r.get("output_links", []):
            if int(consumer) in preds:
                preds[int(consumer)].append(int(r["stage_id"]))

    def _stage_end(sid: int) -> Optional[int]:
        ss = task_spans.get(sid)
        if not ss:
            return None
        return max(s["ts"] + s.get("dur", 0) for s in ss)

    stages = []
    for r in stages_detail:
        sid = int(r["stage_id"])
        metrics = r.get("metrics") or {}
        tpu = {}
        shuffle_bytes = 0
        replica_fetches = 0
        write = {}
        fetch_locality = {
            "local_fetches": 0,
            "remote_fetches": 0,
            "local_bytes": 0,
            "fetch_round_trips": 0,
        }
        for op, vals in metrics.items():
            if op in _SYNTHETIC_OPS:
                continue  # skew analytics, surfaced as row["skew"] below
            if op.startswith("TorchStage") or op.startswith("TorchWindow"):
                for k, v in vals.items():
                    tpu[k] = tpu.get(k, 0) + v
            shuffle_bytes += vals.get("bytes_fetched", 0)
            replica_fetches += vals.get("replica_fetches", 0)
            for k in fetch_locality:
                fetch_locality[k] += vals.get(k, 0)
            for k in (
                "bytes_written_raw",
                "bytes_written_wire",
                "slab_flushes",
                "write_queue_full_ns",
                "device_pid_batches",
                "replicas_written",
                "replica_upload_failures",
            ):
                if k in vals:
                    write[k] = write.get(k, 0) + vals[k]

        row = {
            "stage_id": sid,
            "state": r.get("state"),
            "partitions": r.get("partitions"),
            "attempts": sum((r.get("task_attempts") or {}).values())
            + (r.get("partitions") or 0),
            "task_retries": r.get("task_retries", 0),
            "fetch_retries": r.get("fetch_retries", 0),
            "shuffle_bytes_fetched": shuffle_bytes,
        }
        if replica_fetches:
            # reads this stage served from an external-store replica
            # after its primary's executor went away
            row["replica_fetches"] = replica_fetches
        if any(fetch_locality.values()):
            # transport split of this stage's shuffle reads: zero-copy
            # local (bytes that never crossed the wire) vs Flight, plus
            # the DoGet round trips the remote legs actually paid
            row["locality"] = dict(fetch_locality)
        placement = metrics.get(LOCALITY_OP)
        if placement:
            # scheduler-side placement outcome: tasks that landed on
            # their preferred (most-input-bytes) host vs anywhere else
            row.setdefault("locality", {})["placement"] = dict(placement)
        skew = _skew_block(metrics)
        if skew is not None:
            # stage-completion partition skew (runtime + written bytes):
            # the coalesce/split signal for adaptive re-planning
            row["skew"] = skew
        aqe = metrics.get(AQE_OP) or r.get("aqe")
        if aqe:
            # adaptive re-planning outcome: how the observed shuffle
            # stats reshaped this stage's task layout
            row["aqe"] = dict(aqe)
        served = metrics.get(CACHE_OP) or r.get("cache")
        if served:
            # plan-cache serve outcome: this stage's output came from a
            # fingerprint-matched prior run — zero tasks dispatched
            row["cache"] = dict(served)
        spec = r.get("speculation")
        if spec:
            # straggler mitigation rollup: duplicates launched for this
            # stage, how many committed first, how many were wasted work
            row["speculation"] = {
                "launched": spec.get("launched", 0),
                "wins": spec.get("wins", 0),
                "wasted": spec.get("wasted", 0),
            }
        if write:
            wire = write.get("bytes_written_wire", 0)
            raw = write.get("bytes_written_raw", 0)
            row["shuffle_write"] = {
                "bytes_raw": raw,
                "bytes_wire": wire,
                # >1 means the IPC body compression paid for itself
                "compression_ratio": round(raw / wire, 3) if wire else None,
                "slab_flushes": write.get("slab_flushes", 0),
                "queue_full_ms": round(
                    write.get("write_queue_full_ns", 0) / _NS_PER_MS, 3
                ),
                "device_pid_batches": write.get("device_pid_batches", 0),
            }
            if write.get("replicas_written") or write.get(
                "replica_upload_failures"
            ):
                row["shuffle_write"]["replicas_written"] = write.get(
                    "replicas_written", 0
                )
                row["shuffle_write"]["replica_upload_failures"] = write.get(
                    "replica_upload_failures", 0
                )

        ss = task_spans.get(sid)
        if ss:
            first = min(s["ts"] for s in ss)
            last = max(s["ts"] + s.get("dur", 0) for s in ss)
            row["wall_ms"] = round((last - first) / _NS_PER_MS, 3)
            row["task_time_ms"] = round(
                sum(s.get("dur", 0) for s in ss) / _NS_PER_MS, 3
            )
            # queue wait: first task start minus when the stage COULD have
            # started (all producers done; job submit for leaf stages)
            ready = root_ts
            for p in preds.get(sid, []):
                pe = _stage_end(p)
                if pe is not None:
                    ready = pe if ready is None else max(ready, pe)
            if ready is not None:
                row["queue_wait_ms"] = round(max(first - ready, 0) / _NS_PER_MS, 3)
        else:
            row["wall_ms"] = None
            row["task_time_ms"] = None
            row["queue_wait_ms"] = None

        if tpu:
            row["tpu"] = {
                "compile_ms": round(tpu.get("tpu_compile_ns", 0) / _NS_PER_MS, 3),
                "execute_ms": round(tpu.get("tpu_execute_ns", 0) / _NS_PER_MS, 3),
                "compile_cache_hits": tpu.get("compile_cache_hits", 0),
                "compile_cache_misses": tpu.get("compile_cache_misses", 0),
            }
            # keyed device path: where the group encode ran and whether
            # the encode→sort→segment-reduce pipeline fused into single
            # dispatches — next to the host encode time it
            # eliminates
            keyed = {
                "key_encode_ms": round(
                    tpu.get("key_encode_time_ns", 0) / _NS_PER_MS, 3
                ),
                "device_encode_batches": tpu.get("device_encode_batches", 0),
                "fused_keyed_dispatches": tpu.get(
                    "fused_keyed_dispatches", 0
                ),
            }
            if any(keyed.values()):
                row["tpu"].update(keyed)
            # whole-stage fusion (ballista.tpu.whole_stage_fusion):
            # segments the planner produced and the widest fused run —
            # counters sum across a stage's tasks, so on a 1-partition
            # stage fused_segments == 1 pins compute + pid derivation
            # in ONE dispatch
            fusion = {
                "fused_segments": tpu.get("fused_segments", 0),
                "fused_ops_per_dispatch": tpu.get(
                    "fused_ops_per_dispatch", 0
                ),
                "fused_dispatches": tpu.get("fused_dispatches", 0),
                "fused_pid_in_kernel": tpu.get("fused_pid_in_kernel", 0),
                "fused_degraded": tpu.get("fused_degraded", 0),
            }
            if any(fusion.values()):
                row["tpu"].update(fusion)
        stages.append(row)

    out = {
        "job_id": detail.get("job_id"),
        "state": detail.get("state"),
        "task_retries": detail.get("task_retries", 0),
        "attempt_histogram": detail.get("attempt_histogram", {}),
        "stages": stages,
        "span_count": len(spans),
    }
    if detail.get("error"):
        out["error"] = detail["error"]
    return out
