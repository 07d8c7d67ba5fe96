"""Session configuration.

Counterpart of ``BallistaConfig`` (``ballista/rust/core/src/config.rs:30-187``
in the reference): validated string key/value settings with typed defaults,
shipped with every query and materialized into the per-session execution
context.  New TPU-specific knobs are added for the accelerated stage path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable

from .errors import ConfigError

# Settings keys (reference: core/src/config.rs:30-38)
SHUFFLE_PARTITIONS = "ballista.shuffle.partitions"
BATCH_SIZE = "ballista.batch.size"
REPARTITION_JOINS = "ballista.repartition.joins"
REPARTITION_AGGREGATIONS = "ballista.repartition.aggregations"
REPARTITION_WINDOWS = "ballista.repartition.windows"
PARQUET_PRUNING = "ballista.parquet.pruning"
WITH_INFORMATION_SCHEMA = "ballista.with_information_schema"
PLUGIN_DIR = "ballista.plugin_dir"
# TPU-native additions
TPU_ENABLE = "ballista.tpu.enable"
TPU_SEGMENT_CAPACITY = "ballista.tpu.segment_capacity"
TPU_MAX_CAPACITY = "ballista.tpu.max_capacity"
TPU_BATCH_ROWS = "ballista.tpu.batch_rows"
TPU_DTYPE = "ballista.tpu.dtype"
TPU_MIN_ROWS = "ballista.tpu.min_rows"
TPU_CACHE_COLUMNS = "ballista.tpu.cache_columns"
TPU_HIGHCARD_MODE = "ballista.tpu.highcard_mode"
TPU_DEVICE_ENCODE = "ballista.tpu.device_encode"
TPU_KEYED_BUFFER_MB = "ballista.tpu.keyed_buffer_mb"
TPU_READAHEAD = "ballista.tpu.readahead"
TPU_WHOLE_STAGE_FUSION = "ballista.tpu.whole_stage_fusion"
MESH_ENABLE = "ballista.mesh.enable"
MESH_DEVICES = "ballista.mesh.devices"
MESH_EXCHANGE_MAX_ROWS = "ballista.mesh.exchange_max_rows"
SHUFFLE_TO_MEMORY = "ballista.shuffle.to_memory"
SHUFFLE_FETCH_CONCURRENCY = "ballista.shuffle.fetch_concurrency"
SHUFFLE_PREFETCH_BYTES = "ballista.shuffle.prefetch_bytes"
SHUFFLE_FETCH_RETRIES = "ballista.shuffle.fetch_retries"
SHUFFLE_FETCH_BACKOFF_MS = "ballista.shuffle.fetch_backoff_ms"
SHUFFLE_COALESCE_ROWS = "ballista.shuffle.coalesce_rows"
SHUFFLE_WRITE_COALESCE_ROWS = "ballista.shuffle.write_coalesce_rows"
SHUFFLE_WRITE_QUEUE_BYTES = "ballista.shuffle.write_queue_bytes"
SHUFFLE_WRITE_CONCURRENCY = "ballista.shuffle.write_concurrency"
SHUFFLE_WRITE_PIPELINED = "ballista.shuffle.write_pipelined"
SHUFFLE_COMPRESSION = "ballista.shuffle.compression"
# Pluggable shuffle storage + replication (docs/user-guide/fault-tolerance.md)
SHUFFLE_STORE = "ballista.shuffle.store"
SHUFFLE_REPLICATION = "ballista.shuffle.replication"
SHUFFLE_EXTERNAL_PATH = "ballista.shuffle.external_path"
# Locality-aware data plane (docs/user-guide/shuffle.md "Data plane")
SHUFFLE_LOCAL_TRANSPORT = "ballista.shuffle.local_transport"
SHUFFLE_FETCH_BATCHED = "ballista.shuffle.fetch_batched"
SHUFFLE_LOCALITY_ENABLED = "ballista.shuffle.locality_enabled"
SHUFFLE_LOCALITY_WAIT_S = "ballista.shuffle.locality_wait_seconds"
# Streaming pipelined execution (docs/user-guide/shuffle.md
# "Pipelined execution")
SHUFFLE_PIPELINED = "ballista.shuffle.pipelined"
SHUFFLE_PIPELINED_MIN_FRACTION = "ballista.shuffle.pipelined_min_fraction"
# Adaptive query execution (see docs/user-guide/aqe.md)
AQE_ENABLED = "ballista.aqe.enabled"
AQE_COALESCE_ENABLED = "ballista.aqe.coalesce_enabled"
AQE_BROADCAST_ENABLED = "ballista.aqe.broadcast_enabled"
AQE_SKEW_ENABLED = "ballista.aqe.skew_enabled"
AQE_TARGET_PARTITION_BYTES = "ballista.aqe.target_partition_bytes"
AQE_BROADCAST_THRESHOLD_BYTES = "ballista.aqe.broadcast_threshold_bytes"
AQE_SKEW_FACTOR = "ballista.aqe.skew_factor"
AQE_MAX_SPLITS = "ballista.aqe.max_splits"
AQE_COALESCE_MIN_PARTITIONS = "ballista.aqe.coalesce_min_partitions"
# Fault tolerance (see docs/user-guide/fault-tolerance.md)
TASK_MAX_ATTEMPTS = "ballista.task.max_attempts"
TASK_TIMEOUT_S = "ballista.task.timeout_seconds"
STAGE_MAX_ATTEMPTS = "ballista.stage.max_attempts"
# Speculative execution (straggler mitigation; fault-tolerance.md)
SPECULATION_ENABLED = "ballista.speculation.enabled"
SPECULATION_INTERVAL_S = "ballista.speculation.interval_seconds"
SPECULATION_MULTIPLIER = "ballista.speculation.multiplier"
SPECULATION_MIN_COMPLETED_FRACTION = "ballista.speculation.min_completed_fraction"
SPECULATION_MIN_RUNTIME_S = "ballista.speculation.min_runtime_seconds"
SPECULATION_MAX_COPIES_PER_STAGE = "ballista.speculation.max_copies_per_stage"
EXECUTOR_DRAIN_TIMEOUT_S = "ballista.executor.drain_timeout_seconds"
EXECUTOR_QUARANTINE_THRESHOLD = "ballista.executor.quarantine_threshold"
EXECUTOR_QUARANTINE_WINDOW_S = "ballista.executor.quarantine_window_seconds"
EXECUTOR_QUARANTINE_BACKOFF_S = "ballista.executor.quarantine_backoff_seconds"
CLIENT_JOB_TIMEOUT_S = "ballista.client.job_timeout_seconds"
CLIENT_POLL_INTERVAL_S = "ballista.client.poll_interval_seconds"
CLIENT_POLL_MAX_INTERVAL_S = "ballista.client.poll_max_interval_seconds"
CLIENT_RPC_RETRIES = "ballista.client.rpc_retries"
# Multi-tenant admission control (see docs/user-guide/multi-tenancy.md)
TENANT_ID = "ballista.tenant.id"
TENANT_PRIORITY = "ballista.tenant.priority"
TENANT_WEIGHT = "ballista.tenant.weight"
TENANT_MAX_RUNNING_JOBS = "ballista.tenant.max_running_jobs"
ADMISSION_ENABLED = "ballista.admission.enabled"
ADMISSION_MAX_RUNNING_JOBS = "ballista.admission.max_running_jobs"
ADMISSION_MAX_QUEUED_JOBS = "ballista.admission.max_queued_jobs"
ADMISSION_MAX_QUEUE_WAIT_S = "ballista.admission.max_queue_wait_seconds"
ADMISSION_SHED_POLICY = "ballista.admission.shed_policy"
ADMISSION_MAX_INTERACTIVE_BYPASS = "ballista.admission.max_interactive_bypass"
ADMISSION_INTERACTIVE_HEADROOM = "ballista.admission.interactive_headroom"
# Observability (see docs/user-guide/observability.md)
OBS_ENABLED = "ballista.obs.enabled"
OBS_SAMPLE_RATE = "ballista.obs.sample_rate"
OBS_BUFFER_SPANS = "ballista.obs.buffer_spans"
# per-session job-latency SLO: completed jobs slower than this feed
# slo_breaches_total + the burn-rate gauge (0 = untracked)
OBS_SLO_JOB_LATENCY_S = "ballista.obs.slo.job_latency_seconds"
# Elastic executor lifecycle (see docs/user-guide/autoscaling.md)
AUTOSCALER_ENABLED = "ballista.autoscaler.enabled"
AUTOSCALER_MIN_EXECUTORS = "ballista.autoscaler.min_executors"
AUTOSCALER_MAX_EXECUTORS = "ballista.autoscaler.max_executors"
AUTOSCALER_SCALE_OUT_SUSTAIN_S = "ballista.autoscaler.scale_out_sustain_seconds"
AUTOSCALER_SCALE_IN_IDLE_S = "ballista.autoscaler.scale_in_idle_seconds"
AUTOSCALER_COOLDOWN_S = "ballista.autoscaler.cooldown_seconds"
AUTOSCALER_LAUNCH_TIMEOUT_S = "ballista.autoscaler.launch_timeout_seconds"
AUTOSCALER_SLO_BURN_THRESHOLD = "ballista.autoscaler.slo_burn_threshold"
# Plan-fingerprint result/shuffle cache + learned per-plan policy
# (see docs/user-guide/plan-cache.md)
CACHE_ENABLED = "ballista.cache.enabled"
CACHE_MAX_BYTES = "ballista.cache.max_bytes"
CACHE_TTL_S = "ballista.cache.ttl_seconds"
CACHE_POLICY_ENABLED = "ballista.cache.policy.enabled"
CACHE_POLICY_SHADOW_FRACTION = "ballista.cache.policy.shadow_fraction"


class TaskSchedulingPolicy(str, Enum):
    """Reference: core/src/config.rs (TaskSchedulingPolicy enum)."""

    PULL_STAGED = "pull-staged"
    PUSH_STAGED = "push-staged"


def _parse_bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise ValueError(f"not a boolean: {v!r}")


def _parse_compression(v: str) -> str:
    codec = v.lower()
    if codec not in ("none", "lz4", "zstd"):
        raise ValueError(f"compression must be none|lz4|zstd, got {v!r}")
    return codec


def _parse_shuffle_store(v: str) -> str:
    kind = v.lower()
    if kind not in ("local", "mem", "external"):
        raise ValueError(f"shuffle store must be local|mem|external, got {v!r}")
    return kind


def _parse_replication(v: str) -> str:
    mode = v.lower()
    if mode not in ("none", "async", "sync"):
        raise ValueError(f"replication must be none|async|sync, got {v!r}")
    return mode


def _parse_local_transport(v: str) -> str:
    mode = v.lower()
    if mode not in ("auto", "off"):
        raise ValueError(f"local_transport must be auto|off, got {v!r}")
    return mode


def _parse_min_fraction(v: str) -> float:
    f = float(v)
    if not (0.0 < f <= 1.0):
        raise ValueError(f"min fraction must be in (0, 1], got {v!r}")
    return f


def _parse_priority(v: str) -> str:
    lane = v.lower()
    if lane not in ("interactive", "batch"):
        raise ValueError(f"tenant priority must be interactive|batch, got {v!r}")
    return lane


def _parse_shed_policy(v: str) -> str:
    policy = v.lower()
    if policy not in ("reject", "oldest"):
        raise ValueError(f"shed policy must be reject|oldest, got {v!r}")
    return policy


def _parse_weight(v: str) -> float:
    w = float(v)
    if w <= 0:
        raise ValueError(f"tenant weight must be > 0, got {v!r}")
    return w


def _parse_highcard_mode(v: str) -> str:
    mode = v.lower()
    if mode not in ("auto", "device", "cpu", "gid"):
        raise ValueError(
            f"highcard_mode must be auto|cpu|device|gid, got {v!r}"
        )
    return mode


@dataclass(frozen=True)
class ConfigEntry:
    key: str
    description: str
    parse: Callable[[str], Any]
    default: str


_ENTRIES: dict[str, ConfigEntry] = {
    e.key: e
    for e in [
        ConfigEntry(
            SHUFFLE_PARTITIONS,
            "number of output partitions for shuffle stages",
            int,
            "2",
        ),
        ConfigEntry(BATCH_SIZE, "rows per record batch", int, "8192"),
        ConfigEntry(
            REPARTITION_JOINS, "repartition inputs of joins", _parse_bool, "true"
        ),
        ConfigEntry(
            REPARTITION_AGGREGATIONS,
            "repartition inputs of aggregations",
            _parse_bool,
            "true",
        ),
        ConfigEntry(
            REPARTITION_WINDOWS, "repartition inputs of windows", _parse_bool, "true"
        ),
        ConfigEntry(PARQUET_PRUNING, "enable parquet row-group pruning", _parse_bool, "true"),
        ConfigEntry(
            WITH_INFORMATION_SCHEMA,
            "provide information_schema tables (SHOW ...)",
            _parse_bool,
            "false",
        ),
        ConfigEntry(PLUGIN_DIR, "directory of UDF plugins", str, ""),
        ConfigEntry(
            TPU_ENABLE,
            "compile eligible stage subplans to fused XLA kernels on TPU",
            _parse_bool,
            "true",
        ),
        ConfigEntry(
            TPU_SEGMENT_CAPACITY,
            "initial group-table capacity for on-device hash aggregation "
            "(grows 4x, with state padding, up to tpu.max_capacity)",
            int,
            # matmul-path FLOPs scale with capacity (rows x cap x cols):
            # start small, let 4x growth track real cardinality
            "1024",
        ),
        ConfigEntry(
            TPU_MAX_CAPACITY,
            "group-table ceiling; cardinality beyond it falls back to the "
            "CPU operator path",
            int,
            str(1 << 21),
        ),
        ConfigEntry(
            TPU_BATCH_ROWS,
            "row count each fused device invocation is padded/bucketed to",
            int,
            "1048576",
        ),
        ConfigEntry(TPU_DTYPE, "accumulation dtype on device", str, "float64"),
        ConfigEntry(
            TPU_MIN_ROWS,
            "partitions with fewer input rows than this run the CPU operator "
            "path instead of launching a device kernel (kernel-launch and "
            "compile latency dominate below it); 0 disables the fallback",
            int,
            "16384",
        ),
        ConfigEntry(
            TPU_CACHE_COLUMNS,
            "pin prepared scan inputs (columns, masks, group ids) in device "
            "memory so repeated queries skip host→HBM transfer",
            _parse_bool,
            "true",
        ),
        ConfigEntry(
            TPU_HIGHCARD_MODE,
            "aggregate routing when the first batch shows groups ~ rows: "
            "'auto' resolves by platform — accelerator backends run the "
            "device-KEYED aggregation (group ids assigned by the device "
            "sort, no host hash encode), the cpu backend hands to the "
            "C++ hash aggregate (measured winner there: h2o q10 4x); "
            "'device' pins the keyed path anywhere, 'cpu' pins the hash "
            "handoff (A/B baseline), 'gid' pins the gid-table device "
            "path even at high cardinality (A/B: capacity must fit)",
            _parse_highcard_mode,
            "auto",
        ),
        ConfigEntry(
            TPU_DEVICE_ENCODE,
            "encode group keys ON DEVICE inside the fused keyed kernel "
            "(raw key columns cross the bridge once; codes derive "
            "bit-identically to the host encoders and the "
            "encode→packed-u64-sort→segment-reduce pipeline runs as one "
            "jitted dispatch); false pins the host-encode keyed path "
            "(A/B baseline).  Keys without a device encoding (strings) "
            "keep the host dictionary handoff either way",
            _parse_bool,
            "true",
        ),
        ConfigEntry(
            TPU_KEYED_BUFFER_MB,
            "HBM budget (MiB) for the keyed path's buffered scan columns; "
            "past it the buffered block reduces to [distinct]-sized keyed "
            "states and a host merge combines blocks (median/corr cannot "
            "chunk-merge and fall back to the CPU operator instead of "
            "risking device OOM); 0 disables chunking",
            int,
            # v5e has 16 GiB HBM; the sort's working set runs ~2-3x the
            # buffered bytes, so 2 GiB of buffer keeps peak well clear
            "2048",
        ),
        ConfigEntry(
            TPU_READAHEAD,
            "background source-batch prefetch depth for device stages "
            "(overlaps scan/decode IO with device compute); 0 disables",
            int,
            "2",
        ),
        ConfigEntry(
            TPU_WHOLE_STAGE_FUSION,
            "compile a fusion-eligible map stage (scan→filter→project→"
            "partial-agg, plus the shuffle partition-id column when a "
            "shuffle hint is installed) into ONE jitted dispatch instead "
            "of per-operator dispatches; segment boundaries come from the "
            "measured routing table (fusion_max_ops/fusion_min_rows) and "
            "any trace failure degrades segment-by-segment to the "
            "per-operator path; off keeps today's dispatch sequence "
            "byte-identical",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            MESH_ENABLE,
            "run eligible stages as single gang tasks over the device mesh, "
            "replacing the shuffle hop with ICI collectives",
            _parse_bool,
            "true",
        ),
        ConfigEntry(
            MESH_DEVICES,
            "mesh width for gang stages (0 = all visible devices)",
            int,
            "0",
        ),
        ConfigEntry(
            MESH_EXCHANGE_MAX_ROWS,
            "row ceiling for the ICI repartition exchange (it buffers the "
            "stage input in host memory); beyond it the writer falls back "
            "to the streaming hash-split path",
            int,
            str(1 << 26),
        ),
        ConfigEntry(
            SHUFFLE_TO_MEMORY,
            "hold shuffle partitions in executor memory (served via Flight) "
            "instead of Arrow IPC files on disk",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            SHUFFLE_FETCH_CONCURRENCY,
            "map-side locations each shuffle reader fetches concurrently "
            "(local file, memory store and Flight sources alike); 1 runs a "
            "single fetch worker that walks locations in order",
            int,
            "8",
        ),
        ConfigEntry(
            SHUFFLE_PREFETCH_BYTES,
            "byte budget of fetched-but-unconsumed shuffle batches per "
            "reader partition; fetch workers block (backpressure) once the "
            "queue holds this much",
            int,
            str(64 << 20),
        ),
        ConfigEntry(
            SHUFFLE_FETCH_RETRIES,
            "per-location fetch retries before the stage fails; each failed "
            "attempt drops the cached Flight connection so the retry "
            "reconnects",
            int,
            "3",
        ),
        ConfigEntry(
            SHUFFLE_FETCH_BACKOFF_MS,
            "base backoff between fetch retries (doubles per attempt)",
            int,
            "50",
        ),
        ConfigEntry(
            SHUFFLE_COALESCE_ROWS,
            "target row count for host-side coalescing of fetched shuffle "
            "batches before device transfer (small map fragments combine "
            "into one device dispatch); 0 follows ballista.batch.size, "
            "negative disables coalescing",
            int,
            "0",
        ),
        ConfigEntry(
            SHUFFLE_WRITE_COALESCE_ROWS,
            "target row count per slab flush on the shuffle WRITE side: "
            "hash-split row runs coalesce in per-output-partition slab "
            "buffers until this many rows, so IPC files hold few large "
            "batches instead of one fragment per (input batch, output "
            "partition); 0 follows 4 x ballista.batch.size, negative "
            "writes every split run straight through",
            int,
            "0",
        ),
        ConfigEntry(
            SHUFFLE_WRITE_QUEUE_BYTES,
            "byte budget of coalesced-but-unwritten shuffle batches per "
            "write task; the compute thread blocks (backpressure) once "
            "the writer pool's queues hold this much",
            int,
            str(32 << 20),
        ),
        ConfigEntry(
            SHUFFLE_WRITE_CONCURRENCY,
            "writer-pool threads per shuffle write task (output "
            "partitions are sharded across them, so per-sink batch order "
            "is deterministic); serialization and sink I/O run there "
            "instead of on the compute thread",
            int,
            "2",
        ),
        ConfigEntry(
            SHUFFLE_WRITE_PIPELINED,
            "false pins the pre-pipelining map-side path (argsort-based "
            "permutation, synchronous uncoalesced per-run sink writes, "
            "no compression — shuffle.compression only applies to the "
            "pipelined path) — the A/B baseline for "
            "benchmarks/shuffle_write.py",
            _parse_bool,
            "true",
        ),
        ConfigEntry(
            SHUFFLE_COMPRESSION,
            "IPC body compression for written shuffle partitions "
            "(none|lz4|zstd); pyarrow readers and the Flight server "
            "decompress transparently, so only the write side pays",
            _parse_compression,
            "none",
        ),
        ConfigEntry(
            SHUFFLE_STORE,
            "where written shuffle partitions live: 'local' (Arrow IPC "
            "files under the executor work_dir, served over Flight — the "
            "fast path), 'mem' (executor-memory store, equivalent to "
            "ballista.shuffle.to_memory=true), or 'external' (the shared "
            "directory at ballista.shuffle.external_path, standing in for "
            "an object store: partitions survive their producer, so "
            "executor loss never triggers recompute)",
            _parse_shuffle_store,
            "local",
        ),
        ConfigEntry(
            SHUFFLE_REPLICATION,
            "upload a replica of each finished local/mem shuffle partition "
            "to the external store: 'none' (off), 'async' (writer-pool "
            "thread hands the finished partition to a background uploader "
            "— task completion never waits), 'sync' (upload completes "
            "before the task reports; a failed upload degrades to single "
            "copy, never fails the task).  Requires "
            "ballista.shuffle.external_path; ignored when the store IS "
            "external",
            _parse_replication,
            "none",
        ),
        ConfigEntry(
            SHUFFLE_EXTERNAL_PATH,
            "shared directory (object-store stand-in) holding external "
            "shuffle partitions and replicas; must be reachable from "
            "every executor and the scheduler",
            str,
            "",
        ),
        ConfigEntry(
            SHUFFLE_LOCAL_TRANSPORT,
            "same-host zero-copy shuffle transport: 'auto' serves a "
            "partition via pa.memory_map (zero-copy, no gRPC) whenever "
            "the serving executor's HOST IDENTITY matches this process's "
            "registered executors (never a bare path-existence probe — "
            "on a multi-host cluster a coincidentally-existing path must "
            "not be read as shuffle input); 'off' forces every "
            "non-memory fetch over Flight (the forced-remote A/B leg of "
            "benchmarks/shuffle_locality.py)",
            _parse_local_transport,
            "auto",
        ),
        ConfigEntry(
            SHUFFLE_FETCH_BATCHED,
            "fetch many map partitions per Flight round trip: locations "
            "on one remote executor group into a single multi-partition "
            "DoGet (ticket lists the paths; the server interleaves "
            "mmap-backed streams, tagging batches with their partition "
            "index) instead of one round trip per location; false "
            "restores per-partition DoGets",
            _parse_bool,
            "true",
        ),
        ConfigEntry(
            SHUFFLE_LOCALITY_ENABLED,
            "locality-aware reduce-task placement: prefer executors on "
            "the hosts holding the most bytes of each reduce task's "
            "input partitions (exact per-partition sizes from the "
            "map-side write stats), waiting up to "
            "ballista.shuffle.locality_wait_seconds for a preferred "
            "slot before falling back to any host — makes the same-host "
            "zero-copy transport the common case on multi-executor "
            "clusters.  Off by default: placement is unchanged",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            SHUFFLE_LOCALITY_WAIT_S,
            "how long a reduce task may hold out for a slot on its "
            "preferred host before any executor may take it (the soft "
            "half of locality placement; 0 = prefer but never wait)",
            float,
            "1.0",
        ),
        ConfigEntry(
            SHUFFLE_PIPELINED,
            "streaming pipelined execution: a downstream stage whose "
            "shuffle inputs are all streamable (no sort / hash-join "
            "build between the shuffle read and the stage root) starts "
            "once ballista.shuffle.pipelined_min_fraction of each "
            "input's map tasks have COMMITTED, tailing the remaining "
            "map output as it lands instead of waiting for the stage "
            "barrier.  Committed-task granularity: only first-"
            "completion-wins winners are ever streamed from, so "
            "speculation/retry semantics are unchanged.  Off by "
            "default: stage transitions, dispatch order and wire "
            "traffic are byte-identical to the barrier scheduler",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            SHUFFLE_PIPELINED_MIN_FRACTION,
            "fraction of each input's map tasks that must have "
            "committed before a streamable consumer stage starts on "
            "partial input (pipelined execution); lower starts "
            "consumers earlier but holds their slots longer while they "
            "stall on producers",
            _parse_min_fraction,
            "0.25",
        ),
        ConfigEntry(
            AQE_ENABLED,
            "adaptive query execution: when a stage completes, its "
            "observed per-partition shuffle sizes re-plan not-yet-"
            "resolved consumer stages (partition coalescing, shuffle→"
            "broadcast join conversion, skew splitting — each with its "
            "own toggle below); false restores fully static plans",
            _parse_bool,
            "true",
        ),
        ConfigEntry(
            AQE_COALESCE_ENABLED,
            "AQE rewrite 1: pack adjacent tiny reduce partitions into "
            "fewer tasks until each reads ~aqe.target_partition_bytes",
            _parse_bool,
            "true",
        ),
        ConfigEntry(
            AQE_BROADCAST_ENABLED,
            "AQE rewrite 2: when one side of a partitioned inner join "
            "measures under aqe.broadcast_threshold_bytes before the "
            "probe side has started, convert to a collect-left "
            "broadcast join and strip the probe-side shuffle stage",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            AQE_SKEW_ENABLED,
            "AQE rewrite 3: split a reduce partition whose observed "
            "input exceeds aqe.skew_factor x median across several "
            "tasks, each reading a disjoint subset of the map-side "
            "fragments (joins duplicate the companion side's partition; "
            "final aggregates re-merge partial states downstream)",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            AQE_TARGET_PARTITION_BYTES,
            "coalescing packs reduce partitions up to this many "
            "observed wire bytes per task; skew splitting sizes its "
            "chunk count against it",
            int,
            str(16 << 20),
        ),
        ConfigEntry(
            AQE_BROADCAST_THRESHOLD_BYTES,
            "a completed build side smaller than this (total wire "
            "bytes) qualifies for shuffle→broadcast join conversion",
            int,
            str(10 << 20),
        ),
        ConfigEntry(
            AQE_SKEW_FACTOR,
            "a reduce partition is skewed when its observed bytes "
            "exceed this multiple of the stage's median partition "
            "(and aqe.target_partition_bytes)",
            float,
            "4.0",
        ),
        ConfigEntry(
            AQE_MAX_SPLITS,
            "ceiling on the tasks one skewed partition splits into "
            "(also bounded by its map-side fragment count)",
            int,
            "8",
        ),
        ConfigEntry(
            AQE_COALESCE_MIN_PARTITIONS,
            "shuffles with at most this many reduce partitions keep "
            "their static layout — scheduling a handful of tasks costs "
            "less than second-guessing them",
            int,
            "8",
        ),
        ConfigEntry(
            EXECUTOR_DRAIN_TIMEOUT_S,
            "graceful-decommission budget (seconds): a draining executor "
            "finishes its running tasks within this window (past it they "
            "are cancelled and handed off without consuming retry "
            "budget), uploads un-replicated shuffle partitions to the "
            "external store, then exits",
            float,
            "30",
        ),
        ConfigEntry(
            TASK_MAX_ATTEMPTS,
            "total attempts per task (first run + retries of transient "
            "failures) before the job fails with the accumulated error "
            "history; 1 disables retries",
            int,
            "4",
        ),
        ConfigEntry(
            TASK_TIMEOUT_S,
            "hard deadline (seconds) for one task attempt: a 'running' "
            "task older than this on a live-but-wedged executor is "
            "cancelled and re-queued through the normal transient path "
            "WITHOUT consuming its attempt budget; 0 disables",
            float,
            "0",
        ),
        ConfigEntry(
            STAGE_MAX_ATTEMPTS,
            "executor-loss rollbacks per stage before the job fails "
            "instead of looping against a flapping executor",
            int,
            "4",
        ),
        ConfigEntry(
            SPECULATION_ENABLED,
            "launch a duplicate attempt of a straggling task on a "
            "DIFFERENT executor once enough of its stage has finished; "
            "first completion wins, the loser is cancelled and its late "
            "status dropped as stale",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            SPECULATION_INTERVAL_S,
            "how often (seconds) the scheduler's speculation scan visits "
            "this job's running stages (the scan thread ticks at the "
            "scheduler-level speculation_interval_seconds; a larger "
            "per-session value skips intermediate ticks)",
            float,
            "1.0",
        ),
        ConfigEntry(
            SPECULATION_MULTIPLIER,
            "a running task becomes a speculation candidate once its "
            "elapsed time exceeds multiplier x median(completed task "
            "runtimes in its stage)",
            float,
            "1.5",
        ),
        ConfigEntry(
            SPECULATION_MIN_COMPLETED_FRACTION,
            "fraction of a stage's tasks that must have completed before "
            "the runtime median is trusted for speculation",
            float,
            "0.75",
        ),
        ConfigEntry(
            SPECULATION_MIN_RUNTIME_S,
            "floor (seconds) under which a task is never speculated, "
            "whatever the median says — duplicating sub-second tasks "
            "wastes slots",
            float,
            "1.0",
        ),
        ConfigEntry(
            SPECULATION_MAX_COPIES_PER_STAGE,
            "total speculative duplicates one stage may launch over its "
            "lifetime (bounds wasted work on a generally-slow cluster)",
            int,
            "2",
        ),
        ConfigEntry(
            EXECUTOR_QUARANTINE_THRESHOLD,
            "task/launch failures inside the sliding window that exclude "
            "an executor from new reservations; 0 disables quarantine",
            int,
            "5",
        ),
        ConfigEntry(
            EXECUTOR_QUARANTINE_WINDOW_S,
            "sliding-window length (seconds) for the per-executor "
            "failure count",
            float,
            "60",
        ),
        ConfigEntry(
            EXECUTOR_QUARANTINE_BACKOFF_S,
            "how long (seconds) a quarantined executor is excluded from "
            "slot reservations",
            float,
            "30",
        ),
        ConfigEntry(
            CLIENT_JOB_TIMEOUT_S,
            "FlightSQL front-end poll deadline (seconds) per statement",
            float,
            "300",
        ),
        ConfigEntry(
            CLIENT_POLL_INTERVAL_S,
            "initial GetJobStatus poll interval (seconds); subsequent "
            "polls back off exponentially with jitter so hundreds of "
            "concurrent waiting clients stop hammering the scheduler in "
            "lockstep",
            float,
            "0.1",
        ),
        ConfigEntry(
            CLIENT_POLL_MAX_INTERVAL_S,
            "cap (seconds) of the jittered exponential poll backoff — "
            "the worst-case extra latency a client adds to noticing its "
            "job finished",
            float,
            "2.0",
        ),
        ConfigEntry(
            CLIENT_RPC_RETRIES,
            "extra attempts for a transient (UNAVAILABLE / "
            "DEADLINE_EXCEEDED) scheduler RPC failure before the error "
            "surfaces; with multiple endpoints each retry also rotates "
            "to the next scheduler",
            int,
            "3",
        ),
        ConfigEntry(
            TENANT_ID,
            "tenant pool this session's jobs belong to for admission "
            "control and weighted fair scheduling; empty = the shared "
            "'default' pool",
            str,
            "",
        ),
        ConfigEntry(
            TENANT_PRIORITY,
            "admission lane for this session's jobs: 'interactive' jobs "
            "release ahead of batch work across every pool (bounded by "
            "ballista.admission.max_interactive_bypass so batch is "
            "delayed, never starved) and dispatch first among running "
            "jobs; 'batch' is the default lane",
            _parse_priority,
            "batch",
        ),
        ConfigEntry(
            TENANT_WEIGHT,
            "fair-share weight of this session's tenant pool: queued "
            "jobs release by deficit-weighted round robin, so pools "
            "with weights 2:1 admit 2:1 whenever both have work queued",
            _parse_weight,
            "1",
        ),
        ConfigEntry(
            TENANT_MAX_RUNNING_JOBS,
            "cap on concurrently admitted jobs of this tenant pool "
            "(0 = bounded only by the cluster-wide admission gate)",
            int,
            "0",
        ),
        ConfigEntry(
            ADMISSION_ENABLED,
            "multi-tenant admission control: jobs past the cluster's "
            "running-job capacity wait PRE-PLANNING in a bounded "
            "per-pool queue (no ExecutionGraph built, no memory "
            "pinned) and release by weighted fair share as capacity "
            "frees; past the queue bounds the scheduler sheds with a "
            "structured, retryable ClusterSaturated error.  false "
            "(default) keeps submit/dispatch byte-identical to the "
            "pre-admission scheduler",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            ADMISSION_MAX_RUNNING_JOBS,
            "cluster-wide cap on concurrently admitted jobs; 0 derives "
            "one admitted job per task slot across alive executors",
            int,
            "0",
        ),
        ConfigEntry(
            ADMISSION_MAX_QUEUED_JOBS,
            "admission queue bound across all pools; a submission past "
            "it sheds per ballista.admission.shed_policy (0 = "
            "unbounded — every admission transits the queue, so the "
            "bound can never mean 'no queue')",
            int,
            "100",
        ),
        ConfigEntry(
            ADMISSION_MAX_QUEUE_WAIT_S,
            "a job queued longer than this sheds with ClusterSaturated "
            "instead of waiting forever (0 = unbounded wait)",
            float,
            "0",
        ),
        ConfigEntry(
            ADMISSION_SHED_POLICY,
            "which job pays when the admission queue is full: 'reject' "
            "sheds the NEWEST submission (the one arriving now), "
            "'oldest' sheds the longest-queued job and queues the "
            "newcomer — both with the structured ClusterSaturated error",
            _parse_shed_policy,
            "reject",
        ),
        ConfigEntry(
            ADMISSION_MAX_INTERACTIVE_BYPASS,
            "consecutive interactive-lane releases allowed to jump a "
            "waiting batch job before the batch head must go (bounded "
            "bypass: interactive is fast, batch never starves)",
            int,
            "4",
        ),
        ConfigEntry(
            ADMISSION_INTERACTIVE_HEADROOM,
            "bounded express lane: up to this many interactive jobs may "
            "run ABOVE the cluster's admission cap, so a short "
            "interactive query never waits a whole long batch job's "
            "completion for its admission slot (job-granular admission "
            "would otherwise make it SLOWER than task-granular FIFO); "
            "their tasks then dispatch first among running jobs.  "
            "Running interactive jobs charge this headroom BEFORE they "
            "count against base capacity, so express traffic never "
            "consumes batch's share.  0 makes interactive queue like "
            "everything else",
            int,
            "2",
        ),
        ConfigEntry(
            OBS_ENABLED,
            "distributed tracing + span recording for this session's jobs "
            "(scheduler, executors and shuffle fetch stitch under one "
            "trace id); off = the span API is a near-zero-cost no-op",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            OBS_SAMPLE_RATE,
            "fraction of jobs that get a trace when obs is enabled "
            "(sampling decided once per job at submit)",
            float,
            "1.0",
        ),
        ConfigEntry(
            OBS_BUFFER_SPANS,
            "per-process finished-span ring-buffer capacity; overflow "
            "drops the oldest spans (observability never grows unbounded)",
            int,
            "4096",
        ),
        ConfigEntry(
            OBS_SLO_JOB_LATENCY_S,
            "job-latency SLO for this session (seconds): a completed job "
            "slower than this counts into slo_breaches_total and the "
            "slo_burn_rate gauge on the scheduler; 0 disables tracking",
            float,
            "0",
        ),
        ConfigEntry(
            AUTOSCALER_ENABLED,
            "closed-loop executor autoscaling on the scheduler: a policy "
            "engine on the timer cadence reads admission queue depth, "
            "slot deficit and SLO burn rate and launches/drains "
            "executors through an ExecutorProvider; off = the scheduler "
            "never manages capacity (the KEDA stub behavior)",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            AUTOSCALER_MIN_EXECUTORS,
            "floor for the autoscaler's total-alive-executor target; the "
            "loop launches up to this many at startup and never drains "
            "below it",
            int,
            "1",
        ),
        ConfigEntry(
            AUTOSCALER_MAX_EXECUTORS,
            "ceiling for the autoscaler's total-alive-executor target; "
            "scale-out decisions clamp here no matter the backlog",
            int,
            "4",
        ),
        ConfigEntry(
            AUTOSCALER_SCALE_OUT_SUSTAIN_S,
            "pressure (slot deficit / queued jobs / SLO burn) must "
            "persist this many seconds before a scale-out fires — "
            "hysteresis so a one-tick blip never launches an executor",
            float,
            "3",
        ),
        ConfigEntry(
            AUTOSCALER_SCALE_IN_IDLE_S,
            "the cluster must be completely idle (no running, pending or "
            "queued work) this many seconds before a scale-in drains one "
            "executor",
            float,
            "15",
        ),
        ConfigEntry(
            AUTOSCALER_COOLDOWN_S,
            "minimum seconds between successive scale-out decisions (and "
            "separately between scale-ins) so the loop never flaps",
            float,
            "10",
        ),
        ConfigEntry(
            AUTOSCALER_LAUNCH_TIMEOUT_S,
            "a provider launch that has not registered within this many "
            "seconds is abandoned, terminated, and counted against the "
            "consecutive-launch-failure window",
            float,
            "60",
        ),
        ConfigEntry(
            AUTOSCALER_SLO_BURN_THRESHOLD,
            "scale out when the SLO burn-rate gauge sustains at or above "
            "this value even without a slot deficit; 0 ignores burn rate",
            float,
            "0",
        ),
        ConfigEntry(
            CACHE_ENABLED,
            "scheduler-side plan-fingerprint result/shuffle cache: a "
            "stage whose producer subtree's canonical fingerprint (plus "
            "source snapshot identity) matches a cached entry resolves "
            "against the cached partitions in the external store and the "
            "producer subtree is never dispatched; off = planning and "
            "dispatch are byte-identical to a cache-less scheduler",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            CACHE_MAX_BYTES,
            "total bytes the plan cache may pin in the external store; "
            "exceeding it evicts least-recently-used entries until under "
            "budget (0 = unbounded)",
            int,
            "1073741824",
        ),
        ConfigEntry(
            CACHE_TTL_S,
            "seconds a plan-cache entry stays servable after its last "
            "store/hit; expired entries are evicted lazily at lookup and "
            "store time (0 = no TTL)",
            float,
            "3600",
        ),
        ConfigEntry(
            CACHE_POLICY_ENABLED,
            "self-tuning per-plan policy store: after each job the "
            "doctor's findings are recorded under the plan's shape "
            "fingerprint, and the next submit of a matching plan merges "
            "the learned knob overrides BENEATH explicit session "
            "settings; a shadow fraction stays at baseline and an "
            "override whose measured latency regresses vs the shadow "
            "population is rolled back automatically",
            _parse_bool,
            "false",
        ),
        ConfigEntry(
            CACHE_POLICY_SHADOW_FRACTION,
            "fraction of matching submits the policy store leaves at "
            "baseline (no overrides) to keep an unbiased comparison "
            "population for rollback decisions",
            float,
            "0.1",
        ),
    ]
}


@dataclass
class BallistaConfig:
    """Validated k/v session settings (reference: core/src/config.rs:96-130)."""

    settings: dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for k, v in self.settings.items():
            entry = _ENTRIES.get(k)
            if entry is None:
                # Unknown keys are preserved (forward compatibility) but not
                # validated, mirroring the reference's behavior for
                # extension settings.
                continue
            try:
                entry.parse(v)
            except Exception as e:  # noqa: BLE001
                raise ConfigError(f"invalid value for {k}: {v!r} ({e})") from e

    @staticmethod
    def builder() -> "BallistaConfigBuilder":
        return BallistaConfigBuilder()

    def _get(self, key: str) -> Any:
        entry = _ENTRIES[key]
        raw = self.settings.get(key, entry.default)
        return entry.parse(raw)

    # Typed accessors
    @property
    def shuffle_partitions(self) -> int:
        return self._get(SHUFFLE_PARTITIONS)

    @property
    def batch_size(self) -> int:
        return self._get(BATCH_SIZE)

    @property
    def repartition_joins(self) -> bool:
        return self._get(REPARTITION_JOINS)

    @property
    def repartition_aggregations(self) -> bool:
        return self._get(REPARTITION_AGGREGATIONS)

    @property
    def parquet_pruning(self) -> bool:
        return self._get(PARQUET_PRUNING)

    @property
    def with_information_schema(self) -> bool:
        return self._get(WITH_INFORMATION_SCHEMA)

    @property
    def tpu_enable(self) -> bool:
        return self._get(TPU_ENABLE)

    @property
    def tpu_segment_capacity(self) -> int:
        return self._get(TPU_SEGMENT_CAPACITY)

    @property
    def tpu_max_capacity(self) -> int:
        return self._get(TPU_MAX_CAPACITY)

    @property
    def tpu_batch_rows(self) -> int:
        return self._get(TPU_BATCH_ROWS)

    @property
    def tpu_cache_columns(self) -> bool:
        return self._get(TPU_CACHE_COLUMNS)

    @property
    def tpu_highcard_mode(self) -> str:
        return self._get(TPU_HIGHCARD_MODE)

    @property
    def tpu_device_encode(self) -> bool:
        return self._get(TPU_DEVICE_ENCODE)

    @property
    def tpu_keyed_buffer_mb(self) -> int:
        return self._get(TPU_KEYED_BUFFER_MB)

    @property
    def tpu_readahead(self) -> int:
        return self._get(TPU_READAHEAD)

    @property
    def tpu_whole_stage_fusion(self) -> bool:
        return self._get(TPU_WHOLE_STAGE_FUSION)

    @property
    def tpu_min_rows(self) -> int:
        return self._get(TPU_MIN_ROWS)

    @property
    def mesh_enable(self) -> bool:
        return self._get(MESH_ENABLE)

    @property
    def mesh_devices(self) -> int:
        return self._get(MESH_DEVICES)

    @property
    def mesh_exchange_max_rows(self) -> int:
        return self._get(MESH_EXCHANGE_MAX_ROWS)

    @property
    def shuffle_to_memory(self) -> bool:
        return self._get(SHUFFLE_TO_MEMORY)

    @property
    def shuffle_fetch_concurrency(self) -> int:
        return self._get(SHUFFLE_FETCH_CONCURRENCY)

    @property
    def shuffle_prefetch_bytes(self) -> int:
        return self._get(SHUFFLE_PREFETCH_BYTES)

    @property
    def shuffle_fetch_retries(self) -> int:
        return self._get(SHUFFLE_FETCH_RETRIES)

    @property
    def shuffle_fetch_backoff_ms(self) -> int:
        return self._get(SHUFFLE_FETCH_BACKOFF_MS)

    @property
    def shuffle_coalesce_rows(self) -> int:
        return self._get(SHUFFLE_COALESCE_ROWS)

    @property
    def shuffle_write_coalesce_rows(self) -> int:
        return self._get(SHUFFLE_WRITE_COALESCE_ROWS)

    @property
    def shuffle_write_queue_bytes(self) -> int:
        return self._get(SHUFFLE_WRITE_QUEUE_BYTES)

    @property
    def shuffle_write_concurrency(self) -> int:
        return self._get(SHUFFLE_WRITE_CONCURRENCY)

    @property
    def shuffle_write_pipelined(self) -> bool:
        return self._get(SHUFFLE_WRITE_PIPELINED)

    @property
    def shuffle_compression(self) -> str:
        return self._get(SHUFFLE_COMPRESSION)

    @property
    def shuffle_store(self) -> str:
        return self._get(SHUFFLE_STORE)

    @property
    def shuffle_replication(self) -> str:
        return self._get(SHUFFLE_REPLICATION)

    @property
    def shuffle_external_path(self) -> str:
        return self._get(SHUFFLE_EXTERNAL_PATH)

    @property
    def shuffle_local_transport(self) -> str:
        return self._get(SHUFFLE_LOCAL_TRANSPORT)

    @property
    def shuffle_fetch_batched(self) -> bool:
        return self._get(SHUFFLE_FETCH_BATCHED)

    @property
    def shuffle_locality_enabled(self) -> bool:
        return self._get(SHUFFLE_LOCALITY_ENABLED)

    @property
    def shuffle_locality_wait_seconds(self) -> float:
        return self._get(SHUFFLE_LOCALITY_WAIT_S)

    @property
    def shuffle_pipelined(self) -> bool:
        return self._get(SHUFFLE_PIPELINED)

    @property
    def shuffle_pipelined_min_fraction(self) -> float:
        return self._get(SHUFFLE_PIPELINED_MIN_FRACTION)

    @property
    def aqe_enabled(self) -> bool:
        return self._get(AQE_ENABLED)

    @property
    def aqe_coalesce_enabled(self) -> bool:
        return self._get(AQE_COALESCE_ENABLED)

    @property
    def aqe_broadcast_enabled(self) -> bool:
        return self._get(AQE_BROADCAST_ENABLED)

    @property
    def aqe_skew_enabled(self) -> bool:
        return self._get(AQE_SKEW_ENABLED)

    @property
    def aqe_target_partition_bytes(self) -> int:
        return self._get(AQE_TARGET_PARTITION_BYTES)

    @property
    def aqe_broadcast_threshold_bytes(self) -> int:
        return self._get(AQE_BROADCAST_THRESHOLD_BYTES)

    @property
    def aqe_skew_factor(self) -> float:
        return self._get(AQE_SKEW_FACTOR)

    @property
    def aqe_max_splits(self) -> int:
        return self._get(AQE_MAX_SPLITS)

    @property
    def aqe_coalesce_min_partitions(self) -> int:
        return self._get(AQE_COALESCE_MIN_PARTITIONS)

    @property
    def executor_drain_timeout_seconds(self) -> float:
        return self._get(EXECUTOR_DRAIN_TIMEOUT_S)

    @property
    def task_max_attempts(self) -> int:
        return self._get(TASK_MAX_ATTEMPTS)

    @property
    def task_timeout_seconds(self) -> float:
        return self._get(TASK_TIMEOUT_S)

    @property
    def speculation_enabled(self) -> bool:
        return self._get(SPECULATION_ENABLED)

    @property
    def speculation_interval_seconds(self) -> float:
        return self._get(SPECULATION_INTERVAL_S)

    @property
    def speculation_multiplier(self) -> float:
        return self._get(SPECULATION_MULTIPLIER)

    @property
    def speculation_min_completed_fraction(self) -> float:
        return self._get(SPECULATION_MIN_COMPLETED_FRACTION)

    @property
    def speculation_min_runtime_seconds(self) -> float:
        return self._get(SPECULATION_MIN_RUNTIME_S)

    @property
    def speculation_max_copies_per_stage(self) -> int:
        return self._get(SPECULATION_MAX_COPIES_PER_STAGE)

    @property
    def stage_max_attempts(self) -> int:
        return self._get(STAGE_MAX_ATTEMPTS)

    @property
    def executor_quarantine_threshold(self) -> int:
        return self._get(EXECUTOR_QUARANTINE_THRESHOLD)

    @property
    def executor_quarantine_window_s(self) -> float:
        return self._get(EXECUTOR_QUARANTINE_WINDOW_S)

    @property
    def executor_quarantine_backoff_s(self) -> float:
        return self._get(EXECUTOR_QUARANTINE_BACKOFF_S)

    @property
    def client_job_timeout_seconds(self) -> float:
        return self._get(CLIENT_JOB_TIMEOUT_S)

    @property
    def client_poll_interval_seconds(self) -> float:
        return self._get(CLIENT_POLL_INTERVAL_S)

    @property
    def client_poll_max_interval_seconds(self) -> float:
        return self._get(CLIENT_POLL_MAX_INTERVAL_S)

    @property
    def client_rpc_retries(self) -> int:
        return self._get(CLIENT_RPC_RETRIES)

    @property
    def tenant_id(self) -> str:
        return self._get(TENANT_ID)

    @property
    def tenant_priority(self) -> str:
        return self._get(TENANT_PRIORITY)

    @property
    def tenant_weight(self) -> float:
        return self._get(TENANT_WEIGHT)

    @property
    def tenant_max_running_jobs(self) -> int:
        return self._get(TENANT_MAX_RUNNING_JOBS)

    @property
    def admission_enabled(self) -> bool:
        return self._get(ADMISSION_ENABLED)

    @property
    def admission_max_running_jobs(self) -> int:
        return self._get(ADMISSION_MAX_RUNNING_JOBS)

    @property
    def admission_max_queued_jobs(self) -> int:
        return self._get(ADMISSION_MAX_QUEUED_JOBS)

    @property
    def admission_max_queue_wait_seconds(self) -> float:
        return self._get(ADMISSION_MAX_QUEUE_WAIT_S)

    @property
    def admission_shed_policy(self) -> str:
        return self._get(ADMISSION_SHED_POLICY)

    @property
    def admission_max_interactive_bypass(self) -> int:
        return self._get(ADMISSION_MAX_INTERACTIVE_BYPASS)

    @property
    def admission_interactive_headroom(self) -> int:
        return self._get(ADMISSION_INTERACTIVE_HEADROOM)

    @property
    def obs_enabled(self) -> bool:
        return self._get(OBS_ENABLED)

    @property
    def obs_sample_rate(self) -> float:
        return self._get(OBS_SAMPLE_RATE)

    @property
    def obs_buffer_spans(self) -> int:
        return self._get(OBS_BUFFER_SPANS)

    @property
    def obs_slo_job_latency_seconds(self) -> float:
        return self._get(OBS_SLO_JOB_LATENCY_S)

    @property
    def autoscaler_enabled(self) -> bool:
        return self._get(AUTOSCALER_ENABLED)

    @property
    def autoscaler_min_executors(self) -> int:
        return self._get(AUTOSCALER_MIN_EXECUTORS)

    @property
    def autoscaler_max_executors(self) -> int:
        return self._get(AUTOSCALER_MAX_EXECUTORS)

    @property
    def cache_enabled(self) -> bool:
        return self._get(CACHE_ENABLED)

    @property
    def cache_max_bytes(self) -> int:
        return self._get(CACHE_MAX_BYTES)

    @property
    def cache_ttl_seconds(self) -> float:
        return self._get(CACHE_TTL_S)

    @property
    def cache_policy_enabled(self) -> bool:
        return self._get(CACHE_POLICY_ENABLED)

    @property
    def cache_policy_shadow_fraction(self) -> float:
        return self._get(CACHE_POLICY_SHADOW_FRACTION)

    def to_dict(self) -> dict[str, str]:
        return dict(self.settings)

    @staticmethod
    def from_dict(d: dict[str, str]) -> "BallistaConfig":
        return BallistaConfig(dict(d))


class BallistaConfigBuilder:
    def __init__(self) -> None:
        self._settings: dict[str, str] = {}

    def set(self, key: str, value: str) -> "BallistaConfigBuilder":
        self._settings[key] = str(value)
        return self

    def build(self) -> BallistaConfig:
        return BallistaConfig(self._settings)
