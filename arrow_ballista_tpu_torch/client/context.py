"""BallistaContext: the user-facing distributed query entry point.

Counterpart of the reference's ``client/src/context.rs``:

* ``BallistaContext.remote(host, port, config)`` — calls ExecuteQuery with
  no query to mint a server-side session id (`:85-138`), then every
  DataFrame/SQL collect becomes a distributed job;
* ``BallistaContext.standalone(...)`` — spins up an in-proc scheduler +
  executor(s) (`:140-210`);
* ``read_/register_{csv,parquet}`` keep a client-side table registry
  (`:212-311`); ``sql()`` handles SHOW / CREATE EXTERNAL TABLE / SET
  client-side (`:313-460`).

The collect path is the counterpart of ``DistributedQueryExec``
(``core/src/execution_plans/distributed_query.rs:161-333``): serialize the
logical plan, ExecuteQuery, poll GetJobStatus every 100ms, then fetch the
completed partitions (local-file fast path, Arrow Flight otherwise).

In the port, ``device`` names where the device stages run: None means
``cuda`` and raises without a CUDA device; only ``device="cpu"`` runs
them on the kernels' plain twins.  ``standalone`` hands it to every
executor it starts.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time
from typing import List, Optional

import pyarrow as pa

from ..config import BallistaConfig, TaskSchedulingPolicy
from ..context import DataFrame, SessionContext, _unqualify
from ..errors import BallistaError, ExecutionError
from ..proto import pb
from ..proto.rpc import SchedulerGrpcStub, make_channel
from ..serde import BallistaCodec
from ..serde.scheduler_types import PartitionLocation

log = logging.getLogger(__name__)



class BallistaDataFrame(DataFrame):
    """DataFrame whose collect() runs on the cluster.  Transformations
    inherited from DataFrame stay lazy and preserve this type."""

    def collect(self) -> pa.Table:
        remote: BallistaContext = self.ctx.ballista_context
        return remote._collect_distributed(self.plan)


class BallistaContext:
    def __init__(
        self,
        host: str,
        port: int,
        config: Optional[BallistaConfig] = None,
        _standalone_handles: Optional[tuple] = None,
        endpoints: Optional[List] = None,
        device=None,
    ):
        self.config = config or BallistaConfig()
        # scheduler failover: `endpoints` lists BACKUP
        # schedulers ("host:port" strings or (host, port) pairs) sharing
        # the primary's state backend.  Idempotent RPCs rotate to the
        # next endpoint on a transient failure; with no extras the list
        # is just the primary and behavior matches a single-endpoint
        # client.
        eps: List[tuple] = [(host, int(port))]
        for ep in endpoints or []:
            if isinstance(ep, str):
                h, _, p = ep.rpartition(":")
                eps.append((h, int(p)))
            else:
                eps.append((str(ep[0]), int(ep[1])))
        self._endpoints: List[tuple] = []
        for ep in eps:
            if ep not in self._endpoints:
                self._endpoints.append(ep)
        self._endpoint_idx = 0
        self._stubs: dict = {}
        self.host, self.port = self._endpoints[0]
        self.stub = self._stub_for(self._endpoints[0])
        self._session = SessionContext(self.config, device=device)
        self.device = self._session.device
        self._session.ballista_context = self
        self._standalone_handles = _standalone_handles
        self._job_ids: set[str] = set()

        # mint a server-side session id (reference: context.rs:103-119);
        # an empty-query bootstrap is idempotent, so it rides the retry/
        # rotation path like every other session RPC
        result = self._call(
            "ExecuteQuery",
            pb.ExecuteQueryParams(settings=self._settings()),
            timeout=20,
        )
        self.session_id = result.session_id
        self._session.session_id = result.session_id

    # ------------------------------------------------------------- factory
    @staticmethod
    def remote(
        host: str,
        port: int,
        config: Optional[BallistaConfig] = None,
        endpoints: Optional[List] = None,
        device=None,
    ) -> "BallistaContext":
        return BallistaContext(
            host, port, config, endpoints=endpoints, device=device
        )

    @staticmethod
    def standalone(
        config: Optional[BallistaConfig] = None,
        num_executors: int = 1,
        concurrent_tasks: int = 4,
        policy: TaskSchedulingPolicy = TaskSchedulingPolicy.PULL_STAGED,
        work_dir: Optional[str] = None,
        heartbeat_interval_s: float = 5.0,
        task_isolation: str = "thread",
        plugin_dir: str = "",
        event_journal_dir: str = "",
        device=None,
    ) -> "BallistaContext":
        """In-proc cluster: scheduler + executors over real gRPC/Flight on
        random localhost ports (reference: context.rs:140-210), whose
        executors run the device stages on ``device``."""
        from ..context import _resolve_device
        from ..executor.standalone import new_standalone_executor
        from ..scheduler.standalone import new_standalone_scheduler

        device = _resolve_device(device)  # raises before anything starts

        # the scheduler's plan cache and policy store live in a directory
        # of this cluster's own under TMPDIR, removed by close()
        scheduler = new_standalone_scheduler(
            policy,
            event_journal_dir=event_journal_dir,
            work_dir=tempfile.mkdtemp(prefix="ballista-scheduler-"),
        )
        executors = [
            new_standalone_executor(
                scheduler.host,
                scheduler.port,
                concurrent_tasks=concurrent_tasks,
                policy=policy,
                work_dir=work_dir,
                heartbeat_interval_s=heartbeat_interval_s,
                task_isolation=task_isolation,
                plugin_dir=plugin_dir,
                device=device,
            )
            for _ in range(num_executors)
        ]
        return BallistaContext(
            scheduler.host,
            scheduler.port,
            config,
            _standalone_handles=(scheduler, executors),
            device=device,
        )

    def close(self) -> None:
        # release this client's memory-plane shuffle partitions (the
        # counterpart of the executor janitor's work-dir sweep for jobs
        # that ran with ballista.shuffle.to_memory / mesh gang stages)
        from ..shuffle import memory_store, store

        ext = self.config.shuffle_external_path
        for job_id in self._job_ids:
            memory_store.delete_job(job_id)
            # external partitions/replicas of this client's jobs go too
            # (the object-store analogue of the work-dir sweep)
            store.delete_job(ext, job_id)
        self._job_ids.clear()
        if self._standalone_handles is not None:
            scheduler, executors = self._standalone_handles
            for e in executors:
                e.shutdown()
            scheduler.shutdown()
            shutil.rmtree(
                scheduler.server.state.task_manager.work_dir, ignore_errors=True
            )
            self._standalone_handles = None

    def __enter__(self) -> "BallistaContext":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------- registration
    def register_parquet(self, name: str, path: str) -> None:
        self._session.register_parquet(name, path)

    def register_csv(self, name: str, path: str, **kw) -> None:
        self._session.register_csv(name, path, **kw)

    def register_avro(self, name: str, path: str) -> None:
        self._session.register_avro(name, path)

    def register_table(self, name: str, provider) -> None:
        self._session.register_table(name, provider)

    def read_parquet(self, path: str) -> BallistaDataFrame:
        return self._wrap(self._session.read_parquet(path))

    def read_csv(self, path: str, **kw) -> BallistaDataFrame:
        return self._wrap(self._session.read_csv(path, **kw))

    def read_avro(self, path: str) -> BallistaDataFrame:
        return self._wrap(self._session.read_avro(path))

    def table(self, name: str) -> BallistaDataFrame:
        return self._wrap(self._session.table(name))

    def tables(self) -> List[str]:
        return list(self._session.catalog.tables.keys())

    # ---------------------------------------------------------------- sql
    def sql(self, query: str) -> BallistaDataFrame:
        """SQL → lazy distributed DataFrame.  DDL (CREATE EXTERNAL TABLE),
        SHOW and SET are handled client-side by the wrapped SessionContext,
        like the reference (context.rs:313-460)."""
        df = self._session.sql(query)
        # SET ballista.* mutates the session config; keep ours in sync so
        # the next ExecuteQuery ships the updated settings
        self.config = self._session.config
        return self._wrap(df)

    def _wrap(self, df: DataFrame) -> DataFrame:
        """Distributed frame for real queries; client-side results (SHOW /
        SET / EXPLAIN produce small in-memory values tables) stay local like
        the reference (context.rs:313-460 handles them without a job)."""
        from ..catalog import MemoryTable
        from ..plan import logical as lp

        plan = df.plan
        if isinstance(plan, lp.TableScan) and isinstance(plan.provider, MemoryTable):
            return DataFrame(self._session, plan)
        return BallistaDataFrame(self._session, plan)

    # ------------------------------------------------------------ internal
    def _settings(self) -> List[pb.KeyValuePair]:
        return [
            pb.KeyValuePair(key=k, value=v)
            for k, v in self.config.to_dict().items()
        ]

    def _stub_for(self, endpoint: tuple) -> SchedulerGrpcStub:
        stub = self._stubs.get(endpoint)
        if stub is None:
            stub = SchedulerGrpcStub(make_channel(endpoint[0], endpoint[1]))
            self._stubs[endpoint] = stub
        return stub

    def _rotate_endpoint(self) -> None:
        self._endpoint_idx = (self._endpoint_idx + 1) % len(self._endpoints)
        self.host, self.port = self._endpoints[self._endpoint_idx]
        self.stub = self._stub_for(self._endpoints[self._endpoint_idx])
        log.warning(
            "rotating to scheduler endpoint %s:%d", self.host, self.port
        )

    @staticmethod
    def _retryable(e) -> bool:
        """Transient failures worth retrying: the scheduler is down/
        restarting (UNAVAILABLE) or wedged past the RPC deadline
        (DEADLINE_EXCEEDED).  Everything else — bad plan, unknown
        session, internal errors — surfaces immediately."""
        import grpc

        code = e.code() if hasattr(e, "code") else None
        return code in (
            grpc.StatusCode.UNAVAILABLE,
            grpc.StatusCode.DEADLINE_EXCEEDED,
        )

    def _call(self, method: str, request, timeout: float):
        """One scheduler RPC with bounded transient-failure retry
        (``ballista.client.rpc_retries``) and, with multiple endpoints,
        rotation to the next scheduler per retry — the client-session
        failover path.  Only idempotent RPCs go through here
        (status polls, session bootstrap, token-carrying submits).
        Sleeps ride the same jittered exponential backoff as the status
        poll so a mass failover doesn't thunder onto the survivor.
        ``rpc_retries=0`` with a single endpoint restores the old
        fail-fast behavior exactly (one attempt, error raised raw)."""
        import grpc

        retries = max(0, self.config.client_rpc_retries)
        attempts = retries + 1
        if len(self._endpoints) > 1:
            # enough attempts to visit every endpoint at least twice —
            # a takeover needs one failed dial to notice the primary
            # died and one rotation to land on the adopting backup
            attempts = max(attempts, 2 * len(self._endpoints))
        from ..scheduler.task_status import PollBackoff

        backoff = PollBackoff(
            self.config.client_poll_interval_seconds,
            self.config.client_poll_max_interval_seconds,
        )
        last: Optional[Exception] = None
        for attempt in range(attempts):
            try:
                return getattr(self.stub, method)(request, timeout=timeout)
            except grpc.RpcError as e:
                if not self._retryable(e):
                    raise
                last = e
                if attempt + 1 >= attempts:
                    break
                if len(self._endpoints) > 1:
                    self._rotate_endpoint()
                time.sleep(backoff.next_delay())
        raise last

    def _collect_distributed(self, plan) -> pa.Table:
        import os

        job_id = self.execute_logical_plan(plan)
        self._job_ids.add(job_id)
        # cold XLA compiles on a slow host can push a legitimate job past
        # the default 300s (observed: full-TPC-H sweeps on a 1-core box);
        # benchmarks/operators raise it via env without touching the API,
        # sessions via SET ballista.client.job_timeout_seconds
        timeout_s = float(
            os.environ.get(
                "BALLISTA_JOB_TIMEOUT_S",
                self.config.client_job_timeout_seconds,
            )
        )
        status = self.wait_for_job(job_id, timeout_s=timeout_s)
        return self.fetch_job_output(status)

    def execute_logical_plan(self, plan) -> str:
        import grpc

        params = pb.ExecuteQueryParams(
            logical_plan=BallistaCodec.encode_logical(plan),
            settings=self._settings(),
            session_id=self.session_id,
        )
        if max(0, self.config.client_rpc_retries) > 0 or len(self._endpoints) > 1:
            # a submit that may be RETRIED must not double-run: the
            # scheduler dedups on this client-minted token, so every
            # attempt of this call returns the same job id.  A
            # retry-disabled single-endpoint client sends no token and
            # its request bytes match the pre-failover client exactly.
            import uuid

            params.idempotency_token = uuid.uuid4().hex
        try:
            result = self._call("ExecuteQuery", params, timeout=60)
        except grpc.RpcError as e:
            raise ExecutionError(
                f"query submission failed: {e.details() if hasattr(e, 'details') else e}"
            ) from e
        return result.job_id

    def wait_for_job(
        self,
        job_id: str,
        timeout_s: float = 300.0,
        progress=None,
    ) -> dict:
        """Poll GetJobStatus until terminal (reference:
        distributed_query.rs:232-309).

        Polling starts at ``ballista.client.poll_interval_seconds`` and
        backs off exponentially with jitter (capped at
        ``ballista.client.poll_max_interval_seconds``), resetting on the
        queued→running transition — hundreds of concurrent waiting
        clients must not hammer the scheduler in lockstep.

        ``progress``, if given, is called with the live progress
        snapshot (per-stage done/running/pending task counts, bytes,
        ETA — the ``/api/jobs/{id}/progress`` shape) on every poll that
        returns one.

        Queue-aware: a job held by admission control reports QUEUED with
        its pool + queue position, and a timeout message splits the
        deadline into time-spent-queued vs time-spent-running — a job
        that starved in a saturated queue reads differently from one
        that wedged mid-execution.

        Failover-aware: GetJobStatus is idempotent, so a transient RPC
        failure (scheduler restarting, or mid-takeover by a backup) does
        NOT kill the wait — the poll keeps going, rotating endpoints
        when the context has spares, until the job resolves or the
        deadline passes.  An adopted job reports queued/running from the
        survivor and the wait reattaches transparently."""
        import json

        import grpc

        from ..scheduler.task_status import (
            PollBackoff,
            job_status_from_proto,
            poll_timeout_breakdown,
        )

        backoff = PollBackoff(
            self.config.client_poll_interval_seconds,
            self.config.client_poll_max_interval_seconds,
        )
        # monotonic deadline: immune to wall-clock jumps mid-poll
        start = time.monotonic()
        deadline = start + timeout_s
        running_since: Optional[float] = None
        last_queued: dict = {}
        while True:
            try:
                result = self._call(
                    "GetJobStatus",
                    pb.GetJobStatusParams(
                        job_id=job_id, include_progress=progress is not None
                    ),
                    timeout=20,
                )
            except grpc.RpcError as e:
                # _call exhausted its attempts on a TRANSIENT error (a
                # non-retryable one raised out of the except above): the
                # scheduler may still be coming back — keep polling
                # until the job deadline, not the RPC budget, expires
                if not self._retryable(e) or time.monotonic() > deadline:
                    raise
                log.warning(
                    "scheduler unreachable while waiting for job %s; "
                    "retrying until the %.0fs deadline", job_id, timeout_s,
                )
                backoff.sleep(deadline)
                continue
            status = job_status_from_proto(result.status)
            state = status["state"]
            if state == "queued":
                last_queued = status
            elif running_since is None:
                running_since = time.monotonic()
                # the job just left the queue: poll tightly again
                backoff.reset()
            if progress is not None and result.progress_json:
                try:
                    progress(json.loads(result.progress_json.decode()))
                except ExecutionError:
                    raise
                except Exception:  # noqa: BLE001 - observer must not kill the wait
                    log.debug("progress callback failed", exc_info=True)
            if state == "completed":
                return status
            if state == "failed":
                raise ExecutionError(
                    f"job {job_id} failed: {status.get('error', 'unknown error')}"
                )
            if time.monotonic() > deadline:
                raise ExecutionError(
                    f"job {job_id} timed out after {timeout_s}s"
                    + poll_timeout_breakdown(start, running_since, last_queued)
                )
            backoff.sleep(deadline)

    def job_report(self, job_id: str) -> dict:
        """The scheduler's diagnosis bundle for a job this session ran:
        ``{"profile", "critical_path", "doctor"}`` — the same numbers
        ``/api/jobs/{id}/profile`` and ``/critical_path`` serve."""
        import json

        result = self._call(
            "GetJobStatus",
            pb.GetJobStatusParams(job_id=job_id, include_profile=True),
            timeout=20,
        )
        if not result.profile_json:
            raise BallistaError(
                f"no profile available for job {job_id!r} (unknown job, "
                "or still queued)"
            )
        return json.loads(result.profile_json.decode())

    def explain_analyze(self, job_id: str) -> str:
        """EXPLAIN-ANALYZE-style text tree for a finished (or running)
        job: wall-clock breakdown, critical path, doctor findings and
        per-stage stats.  Print it."""
        from ..obs.doctor import render_explain_analyze

        return render_explain_analyze(self.job_report(job_id))

    def fetch_job_output(self, status: dict) -> pa.Table:
        """Fetch completed partitions (reference:
        distributed_query.rs:311-333).  The schema comes from the partition
        files themselves, so zero-row results collect cleanly."""
        locations: List[PartitionLocation] = status.get("locations", [])
        batches: List[pa.RecordBatch] = []
        schema: Optional[pa.Schema] = None
        for loc in locations:
            part_schema, part_batches = _fetch_partition(loc)
            schema = schema or part_schema
            for batch in part_batches:
                if batch.num_rows:
                    batches.append(batch)
        if schema is None:
            raise BallistaError("completed job returned no partitions")
        return _unqualify(pa.Table.from_batches(batches, schema=schema))


def _fetch_partition(loc: PartitionLocation):
    """Returns (schema, batches) for one completed partition.  A dead
    result-serving executor degrades to the external-store replica when
    the location names one instead of failing the collect."""
    # local fast path (standalone mode shares the filesystem)
    if loc.path and os.path.exists(loc.path):
        with pa.OSFile(loc.path, "rb") as f:
            reader = pa.ipc.open_file(f)
            batches = [
                reader.get_batch(i) for i in range(reader.num_record_batches)
            ]
        return reader.schema, batches
    try:
        from ..flight.client import BallistaClient

        client = BallistaClient.get(
            loc.executor_meta.host, loc.executor_meta.flight_port
        )
        return client.fetch_partition_with_schema(
            loc.partition_id.job_id,
            loc.partition_id.stage_id,
            loc.partition_id.partition_id,
            loc.path,
        )
    except Exception:
        # only fail over to a replica that actually EXISTS: async
        # replication stamps the path optimistically, and a dangling one
        # must not mask the original Flight error with FileNotFoundError
        if not loc.replica_path or not os.path.exists(loc.replica_path):
            raise
        from ..shuffle.store import read_batches, read_schema

        log.warning(
            "fetching job output %s from its replica %s (executor %s "
            "unreachable)", loc.path, loc.replica_path, loc.executor_meta.id,
        )
        batches = list(read_batches(loc.replica_path))
        if not batches:  # zero-row partitions still carry a schema
            return read_schema(loc.replica_path), []
        return batches[0].schema, batches
