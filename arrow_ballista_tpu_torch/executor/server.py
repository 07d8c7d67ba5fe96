"""Push-mode executor server.

Counterpart of the reference's ``executor/src/executor_server.rs``: starts
an ExecutorGrpc server, registers with the scheduler (`:162-178`), runs a
Heartbeater (60s, `:401-431`) and a TaskRunnerPool — a task-runner loop
draining the LaunchTask channel onto worker threads (`:538-592`) and a
status-reporter loop batching TaskStatus per curator scheduler
(`:446-536`).  RPC handlers: LaunchTask / StopExecutor / CancelTasks
(`:595-662`).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Dict, List, Optional

import grpc

from ..proto import pb
from ..proto.rpc import (
    SchedulerGrpcStub,
    add_executor_servicer,
    make_channel,
    make_server,
)
from ..serde.scheduler_types import PartitionId
from .executor import Executor

log = logging.getLogger(__name__)

HEARTBEAT_INTERVAL_S = 60.0  # reference: executor_server.rs:421


class ExecutorGrpcService:
    """The three ExecutorGrpc RPC handlers (reference: `:595-662`)."""

    def __init__(self, server: "ExecutorServer"):
        self.server = server

    def LaunchTask(self, request: pb.LaunchTaskParams, context) -> pb.LaunchTaskResult:
        for task in request.tasks:
            self.server.enqueue_task(task, request.scheduler_id)
        return pb.LaunchTaskResult(success=True)

    def StopExecutor(
        self, request: pb.StopExecutorParams, context
    ) -> pb.StopExecutorResult:
        log.info(
            "StopExecutor received (force=%s, drain=%s): %s",
            request.force, request.drain, request.reason,
        )
        if request.drain:
            # graceful decommission: drain on a detached thread — finish
            # running tasks inside the budget, upload un-replicated
            # shuffle partitions, report ExecutorStopped, then exit
            threading.Thread(
                target=self.server.drain,
                args=(request.reason, request.drain_timeout_seconds),
                name="executor-drain",
                daemon=True,
            ).start()
            return pb.StopExecutorResult()
        if request.force:
            self.server.executor.cancel_all()
        self.server.trigger_shutdown(request.reason)
        return pb.StopExecutorResult()

    def CancelTasks(
        self, request: pb.CancelTasksParams, context
    ) -> pb.CancelTasksResult:
        ok = True
        for p in request.partition_ids:
            pid = PartitionId.from_proto(p)
            if not self.server.executor.cancel_task(pid):
                ok = False
        return pb.CancelTasksResult(cancelled=ok)

    def UpdateShuffleLocations(
        self, request: pb.UpdateShuffleLocationsParams, context
    ) -> pb.UpdateShuffleLocationsResult:
        """Streaming pipelined execution: fresh map-output
        location deltas for feeds this executor's tailing consumer tasks
        are streaming; merged into the process-wide mirror."""
        from ..shuffle import delta_store

        for d in request.deltas:
            delta_store.apply_delta_proto(d)
        return pb.UpdateShuffleLocationsResult(success=True)


class Heartbeater:
    """Periodic HeartBeatFromExecutor (reference: `:401-431`).

    ``telemetry`` (an ``obs.telemetry.TelemetrySampler``) piggybacks a
    resource snapshot on every beat.  Unlike the span payload — which
    requeues when the RPC fails, so traces keep no gaps — a telemetry
    snapshot is latest-wins: a lost beat is simply superseded by the
    fresh sample taken for the next one."""

    def __init__(
        self,
        executor_id: str,
        scheduler: SchedulerGrpcStub,
        interval_s: float = HEARTBEAT_INTERVAL_S,
        telemetry=None,
        on_reregister: Optional[Callable[[], None]] = None,
    ):
        self.executor_id = executor_id
        self.scheduler = scheduler
        self.interval_s = interval_s
        self.telemetry = telemetry
        self.on_reregister = on_reregister
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Heartbeater":
        self._send()  # immediate first beat so liveness starts now
        self._thread = threading.Thread(
            target=self._run, name="heartbeater", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._send()

    def _send(self) -> None:
        from ..obs import trace
        from ..obs.recorder import get_recorder
        from ..testing.faults import FaultInjected, fault_point

        drained = None
        try:
            fault_point("executor.heartbeat", executor_id=self.executor_id)
            status = pb.ExecutorStatus()
            status.active = ""
            params = pb.HeartBeatParams(
                executor_id=self.executor_id, status=status
            )
            if self.telemetry is not None:
                snap = self.telemetry.sample()
                if snap is not None:
                    import json as _json

                    params.telemetry_json = _json.dumps(snap).encode()
            if trace.is_enabled():
                # spans finished between task reports (Flight serving,
                # cache activity) ride the heartbeat to the trace store
                drained = get_recorder().drain()
                if drained:
                    import json as _json

                    params.spans_json = _json.dumps(drained).encode()
            result = self.scheduler.HeartBeatFromExecutor(params, timeout=10)
            if getattr(result, "reregister", False) and self.on_reregister:
                # the scheduler restarted and lost our metadata (memory
                # backend) while this process survived — re-register so
                # slots/endpoints rebuild instead of heartbeating into
                # a registry that can never dispatch to us
                log.info("scheduler requested re-registration; re-registering")
                try:
                    self.on_reregister()
                except Exception:  # noqa: BLE001 - next beat retries
                    log.warning("re-registration failed", exc_info=True)
        except FaultInjected as e:
            # injected dropped beat: skip this interval, next one retries
            log.warning("heartbeat suppressed by fault injection: %s", e)
        except grpc.RpcError as e:
            # the beat (and its span payload) never arrived: give the
            # spans back so the next beat re-ships them instead of
            # leaving silent trace gaps exactly when the system limps
            if drained:
                get_recorder().requeue(drained)
            log.warning("heartbeat failed: %s", e.code())


class ExecutorServer:
    """Owns the gRPC server + task runner pool + status reporter."""

    def __init__(
        self,
        executor: Executor,
        scheduler_host: str,
        scheduler_port: int,
        heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S,
        on_shutdown: Optional[Callable[[str], None]] = None,
        bind_host: str = "0.0.0.0",
        telemetry_enabled: bool = True,
    ):
        from ..obs.telemetry import TelemetrySampler

        self.bind_host = bind_host
        self.executor = executor
        self.scheduler = SchedulerGrpcStub(
            make_channel(scheduler_host, scheduler_port)
        )
        self._scheduler_stubs: Dict[str, SchedulerGrpcStub] = {
            f"{scheduler_host}:{scheduler_port}": self.scheduler
        }
        # pipelined execution: tailing fetches poll the scheduler's
        # shuffle-location feed when a push notification hasn't arrived
        # yet (catch-up for the startup race and lost pushes)
        from ..shuffle import delta_store

        delta_store.configure_scheduler(lambda: self.scheduler)
        # the telemetry piggyback is the one obs piece on by default: the
        # sampler is O(1) per beat (the work-dir disk walk is throttled)
        self.telemetry = TelemetrySampler(
            work_dir=executor.work_dir,
            slots_total=executor.concurrent_tasks,
            active_tasks_fn=executor.active_task_count,
            enabled=telemetry_enabled,
        )
        self.heartbeater = Heartbeater(
            executor.id, self.scheduler, heartbeat_interval_s,
            telemetry=self.telemetry, on_reregister=self._register,
        )
        self._tasks: "queue.Queue" = queue.Queue()
        self._statuses: "queue.Queue" = queue.Queue()
        self._draining = False
        self._drain_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._grpc_server: Optional[grpc.Server] = None
        self.grpc_port: int = executor.metadata.grpc_port
        self.on_shutdown = on_shutdown

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "ExecutorServer":
        # 1. gRPC server first so the scheduler can push immediately
        self._grpc_server = make_server()
        add_executor_servicer(self._grpc_server, ExecutorGrpcService(self))
        # bind locally on all interfaces; metadata.host is the ADVERTISE
        # address (may be a DNS name that is not a local interface)
        bound = self._grpc_server.add_insecure_port(
            f"{self.bind_host}:{self.grpc_port}"
        )
        if self.grpc_port == 0:
            self.grpc_port = bound
            meta = self.executor.metadata
            object.__setattr__(meta, "grpc_port", bound)
        self._grpc_server.start()

        # 2. register with the scheduler (reference: `:162-178`)
        self._register()

        # 3. heartbeats + worker pool + status reporter
        self.heartbeater.start()
        for i in range(self.executor.concurrent_tasks):
            t = threading.Thread(
                target=self._task_runner, name=f"task-runner-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        reporter = threading.Thread(
            target=self._status_reporter, name="status-reporter", daemon=True
        )
        reporter.start()
        self._threads.append(reporter)
        return self

    def _register(self) -> None:
        """Send RegisterExecutor — on startup and again whenever a
        heartbeat answer carries ``reregister`` (a restarted scheduler
        adopted this surviving process but lost its metadata).  In push
        mode registration also re-mints the slot reservations."""
        meta = self.executor.metadata
        registration = pb.ExecutorRegistration(
            id=meta.id,
            host=meta.host,
            has_host=bool(meta.host),
            flight_port=meta.flight_port,
            grpc_port=self.grpc_port,
            specification=meta.specification.to_proto(),
        )
        result = self.scheduler.RegisterExecutor(
            pb.RegisterExecutorParams(metadata=registration), timeout=20
        )
        if not result.success:
            raise RuntimeError("scheduler refused executor registration")

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self.heartbeater.stop()
        # abort this executor's in-flight shuffle fetch pipelines (the
        # push-mode analogue of PollLoop.stop's cleanup)
        from ..shuffle.fetcher import shutdown_active_fetchers

        shutdown_active_fetchers(owner=self.executor.work_dir)
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=1)

    def trigger_shutdown(self, reason: str) -> None:
        if self.on_shutdown is not None:
            # shutdown must not run on the gRPC handler thread
            threading.Thread(
                target=self.on_shutdown, args=(reason,), daemon=True
            ).start()

    # ---------------------------------------------------------------- drain
    def drain(self, reason: str, timeout_s: float = 0.0) -> int:
        """Graceful decommission: finish running tasks within
        ``timeout_s`` (the scheduler has already stopped sending new
        ones), cancel-and-hand-off whatever outlives the budget, flush
        reported statuses, upload every un-replicated shuffle partition
        to the external store, report ExecutorStopped, then shut down.
        Returns the number of partitions uploaded."""
        import time as _time

        from ..shuffle import store as shuffle_store

        with self._drain_lock:
            # concurrent drain RPCs (operator REST + scheduler, or a gRPC
            # retry) must collapse to ONE drain cycle
            if self._draining:
                return 0
            self._draining = True
        timeout = timeout_s if timeout_s > 0 else 30.0
        deadline = _time.monotonic() + timeout
        log.info("draining executor %s (budget %.0fs)", self.executor.id, timeout)
        while (
            _time.monotonic() < deadline
            and (self.executor.active_task_count() > 0 or not self._tasks.empty())
        ):
            _time.sleep(0.05)
        if self.executor.active_task_count() > 0:
            # past the budget: cancel the stragglers — the scheduler's
            # draining-handoff guard re-queues them budget-free
            n = self.executor.cancel_all()
            log.warning(
                "drain budget exhausted with %d task(s) running; cancelled",
                n,
            )
            grace = _time.monotonic() + 5.0
            while _time.monotonic() < grace and self.executor.active_task_count() > 0:
                _time.sleep(0.05)
        # let the status reporter flush: a completed status that never
        # reaches the scheduler before ExecutorStopped would be dropped
        # by the dead-executor guard and strand its partition
        flush_deadline = _time.monotonic() + 5.0
        while _time.monotonic() < flush_deadline and not self._statuses.empty():
            _time.sleep(0.05)
        _time.sleep(0.25)  # in-flight UpdateTaskStatus RPC tail
        # upload whatever has no external copy yet, then flush the async
        # replicator so nothing queued is lost with this process
        uploaded, failed = shuffle_store.drain_upload(
            self.executor.work_dir, shuffle_store.noted_external_root()
        )
        shuffle_store.replicator().flush(timeout=30.0)
        if failed:
            log.warning("drain: %d upload(s) failed (degraded)", len(failed))
        log.info(
            "drain complete: %d partition(s) uploaded; reporting stopped",
            uploaded,
        )
        try:
            self.scheduler.ExecutorStopped(
                pb.ExecutorStoppedParams(
                    executor_id=self.executor.id,
                    reason=f"drained: {reason} ({uploaded} partition(s) uploaded)",
                ),
                timeout=10,
            )
        except grpc.RpcError as e:
            log.warning("ExecutorStopped after drain failed: %s", e.code())
        self.trigger_shutdown(f"drained: {reason}")
        return uploaded

    # ------------------------------------------------------------- running
    def enqueue_task(self, task: pb.TaskDefinition, scheduler_id: str) -> None:
        self._tasks.put((task, scheduler_id))

    def _task_runner(self) -> None:
        while not self._stop.is_set():
            try:
                task, scheduler_id = self._tasks.get(timeout=0.2)
            except queue.Empty:
                continue
            status = self.executor.execute_task(task)
            self._statuses.put((scheduler_id, status))

    def _status_reporter(self) -> None:
        """Batch statuses per curator scheduler (reference: `:446-536`)."""
        while not self._stop.is_set():
            try:
                scheduler_id, status = self._statuses.get(timeout=0.2)
            except queue.Empty:
                continue
            batch: Dict[str, List[pb.TaskStatus]] = {scheduler_id: [status]}
            while True:
                try:
                    sid, s = self._statuses.get_nowait()
                    batch.setdefault(sid, []).append(s)
                except queue.Empty:
                    break
            for sid, statuses in batch.items():
                stub = self._stub_for(sid)
                try:
                    stub.UpdateTaskStatus(
                        pb.UpdateTaskStatusParams(
                            executor_id=self.executor.id, task_status=statuses
                        ),
                        timeout=20,
                    )
                except grpc.RpcError as e:
                    log.warning(
                        "UpdateTaskStatus to %s failed (%s); retrying", sid, e.code()
                    )
                    for s in statuses:
                        self._statuses.put((sid, s))
                    # back off so a dead scheduler doesn't spin this thread
                    self._stop.wait(0.5)

    def _stub_for(self, scheduler_id: str) -> SchedulerGrpcStub:
        """Curator scheduler ids are host:port strings; fall back to the
        registration scheduler (reference: `:222-245` multi-scheduler cache)."""
        stub = self._scheduler_stubs.get(scheduler_id)
        if stub is not None:
            return stub
        if ":" in scheduler_id:
            host, _, port = scheduler_id.rpartition(":")
            try:
                stub = SchedulerGrpcStub(make_channel(host, int(port)))
                self._scheduler_stubs[scheduler_id] = stub
                return stub
            except Exception:  # noqa: BLE001
                pass
        return self.scheduler
