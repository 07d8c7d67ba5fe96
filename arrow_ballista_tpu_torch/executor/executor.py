"""Executor core object: runs shuffle-write tasks, tracks abort handles.

Counterpart of the reference's ``executor/src/executor.rs:44-179``: holds
registration metadata, the local ``work_dir`` and concurrency budget;
``execute_task`` decodes the stage plan, rebuilds the ShuffleWriterExec
against the local work_dir (`:137-161` new_shuffle_writer), wraps execution
with a cancellation handle keyed by PartitionId (`:97-134` abortable), and
maps the outcome to a protobuf TaskStatus (``executor/src/lib.rs``
as_task_status).  Panics/exceptions become Failed statuses like the
reference's catch_unwind (``execution_loop.rs:120-130``).

The port's executor carries the torch device its device stages run on
(None means ``cuda`` and raises without a CUDA device, as the port's
``SessionContext`` does) and re-applies the port's ``maybe_accelerate``
on it.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional

from ..config import BallistaConfig
from ..exec.operators import TaskContext
from ..obs import trace
from ..obs.recorder import get_recorder
from ..proto import pb
from ..scheduler.execution_stage import TaskInfo
from ..scheduler.task_status import collect_plan_metrics, task_info_to_proto
from ..serde import BallistaCodec, partitioning_from_proto
from ..serde.scheduler_types import ExecutorMetadata, PartitionId
from ..shuffle.execution_plans import ShuffleWriterExec

log = logging.getLogger(__name__)


def _sum_metric(metrics, key: str) -> int:
    """Total one named counter across the per-operator metric sets (used
    to lift shuffle ``fetch_retries`` into TaskStatus for the scheduler)."""
    return sum(int(values.get(key, 0)) for _, values in metrics)


def _has_tailing_reader(msg) -> bool:
    """Reflection walk over a plan proto: does any ShuffleReaderExecNode
    carry ``tail=True`` (pipelined execution)?  Generic over node shapes
    so new operators never need to register here."""
    if isinstance(msg, pb.ShuffleReaderExecNode):
        return bool(msg.tail)
    for fd, value in msg.ListFields():
        if fd.type != fd.TYPE_MESSAGE:
            continue
        # singular sub-message vs repeated container, told apart by the
        # message surface itself (fd.label is deprecated); map fields
        # iterate KEYS (scalars), which the hasattr guard skips
        children = [value] if hasattr(value, "ListFields") else value
        if any(
            hasattr(v, "ListFields") and _has_tailing_reader(v)
            for v in children
        ):
            return True
    return False


class LoggingMetricsCollector:
    """Prints the per-partition stage plan with metrics (reference:
    executor/src/metrics/mod.rs:28-60)."""

    def record_stage(
        self, job_id: str, stage_id: int, partition: int, plan, metrics
    ) -> None:
        log.info(
            "=== [%s/%s/%s] stage completed: %s metrics=%s ===",
            job_id,
            stage_id,
            partition,
            plan,
            metrics,
        )


class _ProcessWorker:
    """One persistent task-runner subprocess (see ``task_runner.py``)."""

    def __init__(
        self,
        executor_id: str,
        work_dir: str,
        plugin_dir: str = "",
        host: str = "",
    ):
        import os
        import subprocess
        import sys

        args = [
            sys.executable, "-m", "arrow_ballista_tpu_torch.executor.task_runner",
            "--executor-id", executor_id, "--work-dir", work_dir,
        ]
        if host:
            # the worker inherits the parent's advertised host so its
            # local-transport identity matches (shuffle/transport.py)
            args += ["--host", host]
        if plugin_dir:
            args += ["--plugin-dir", plugin_dir]
        repo_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        self._proc = subprocess.Popen(
            args, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        )

    def alive(self) -> bool:
        return self._proc.poll() is None

    def run(self, task_bytes: bytes) -> Optional[bytes]:
        """Execute one task; returns TaskStatus bytes or None if the
        worker died mid-task (killed by cancel, or crashed)."""
        import struct

        try:
            self._proc.stdin.write(struct.pack(">I", len(task_bytes)))
            self._proc.stdin.write(task_bytes)
            self._proc.stdin.flush()
            hdr = self._proc.stdout.read(4)
            if len(hdr) < 4:
                return None
            n = struct.unpack(">I", hdr)[0]
            out = b""
            while len(out) < n:
                chunk = self._proc.stdout.read(n - len(out))
                if not chunk:
                    return None
                out += chunk
            return out
        except (BrokenPipeError, ValueError, OSError):
            return None

    def kill(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()

    def close(self) -> None:
        """Ask for a clean exit; kill if it doesn't comply."""
        import struct

        try:
            self._proc.stdin.write(struct.pack(">I", 0))
            self._proc.stdin.flush()
            self._proc.wait(timeout=3)
        except Exception:
            self.kill()


class _WorkerAbort:
    """Duck-types threading.Event.set() for the abort-handle table: a
    cancelled process-isolated task dies by worker kill.  ``cancelled``
    records that the kill was deliberate — the scheduler must see
    Cancelled (fatal, no retry), not a transient worker crash."""

    def __init__(self, worker: _ProcessWorker):
        self._worker = worker
        self.cancelled = False

    def set(self) -> None:
        self.cancelled = True
        self._worker.kill()


class Executor:
    def __init__(
        self,
        metadata: ExecutorMetadata,
        work_dir: str,
        concurrent_tasks: int = 4,
        metrics_collector: Optional[LoggingMetricsCollector] = None,
        task_isolation: str = "thread",
        plugin_dir: str = "",
        device=None,
    ):
        from ..context import _resolve_device

        self.metadata = metadata
        self.device = _resolve_device(device)
        self.work_dir = work_dir
        self.concurrent_tasks = concurrent_tasks
        # local-transport identity (shuffle/transport.py): fetches of
        # partitions served by THIS executor — or any executor advertising
        # the same host — go zero-copy through the filesystem instead of
        # Flight.  Registered here so every executor shape (push, pull,
        # standalone, process-isolated task runner) participates.
        from ..shuffle import transport

        transport.register_local_executor(metadata.id, metadata.host)
        self.metrics_collector = metrics_collector or LoggingMetricsCollector()
        self.task_isolation = task_isolation
        self.plugin_dir = plugin_dir
        # pid -> {attempt: handle}: two attempts of one partition can
        # coexist on this executor (a deadline-reaped task re-dispatched
        # here while the wedged copy still runs), so the table must not
        # let the re-dispatch clobber the old handle — or the old task's
        # cleanup pop the new task's handle
        self._abort_handles: Dict[PartitionId, Dict[int, threading.Event]] = {}
        self._abort_lock = threading.Lock()
        self._idle_workers: List[_ProcessWorker] = []
        self._worker_lock = threading.Lock()

    @property
    def id(self) -> str:
        return self.metadata.id

    # ---------------------------------------------------------------- run
    def execute_task(self, task: pb.TaskDefinition) -> pb.TaskStatus:
        """Run one shuffle-write task to completion; never raises — any
        error becomes a Failed TaskStatus."""
        if self.task_isolation == "process" and self._worker_eligible(task):
            return self._execute_in_worker(task)
        from ..testing.faults import fault_point

        # observability ratchets on with the first traced task and the
        # task's trace context (minted at the scheduler) adopts on this
        # thread so every child span stitches under the job's trace
        trace.enable_from_props(task.props, process=f"executor:{self.id}")
        self._note_external_root(task)
        pid = PartitionId.from_proto(task.task_id)
        cancel_event = threading.Event()
        with self._abort_lock:
            self._abort_handles.setdefault(pid, {})[task.attempt] = cancel_event
        try:
            with trace.activate(task.trace_id, task.parent_span_id), trace.span(
                "task.execute",
                job=pid.job_id,
                stage=pid.stage_id,
                partition=pid.partition_id,
                attempt=task.attempt,
                executor=self.id,
                speculative=bool(task.speculative),
            ):
                fault_point(
                    "executor.execute_task",
                    executor_id=self.id,
                    job_id=pid.job_id,
                    stage_id=pid.stage_id,
                    partition_id=pid.partition_id,
                    attempt=task.attempt,
                )
                # delay-friendly point (faults action="delay"): manufactures
                # deterministic stragglers/wedged tasks for the speculation
                # and deadline-reaper tests; cancel_event cuts the sleep
                # short so CancelTasks still aborts a "wedged" task promptly
                fault_point(
                    "task.run",
                    executor_id=self.id,
                    job_id=pid.job_id,
                    stage_id=pid.stage_id,
                    partition_id=pid.partition_id,
                    attempt=task.attempt,
                    speculative=bool(task.speculative),
                    cancel_event=cancel_event,
                )
                with trace.span("task.prepare"):
                    plan = BallistaCodec.decode_physical(task.plan, self.work_dir)
                    config = BallistaConfig(dict(task.props))
                    writer = self._new_shuffle_writer(pid, plan, task, config)
                ctx = TaskContext(
                    session_id=task.session_id or "default",
                    config=config,
                    work_dir=self.work_dir,
                    job_id=pid.job_id,
                    stage_id=pid.stage_id,
                    cancel_event=cancel_event,
                )
                with trace.span("shuffle.write") as wspan:
                    partitions = writer.execute_shuffle_write(
                        pid.partition_id, ctx
                    )
                    wspan.set_attr(
                        "bytes", sum(p.num_bytes for p in partitions)
                    )
                    wspan.set_attr("partitions", len(partitions))
                    wspan.set_attr(
                        "compression", config.shuffle_compression
                    )
                    wvals = writer.metrics.to_dict()
                    for k in (
                        "bytes_written_raw",
                        "bytes_written_wire",
                        "slab_flushes",
                        "write_queue_full_ns",
                        "device_pid_batches",
                    ):
                        if k in wvals:
                            wspan.set_attr(k, wvals[k])
                metrics = collect_plan_metrics(writer)
                self.metrics_collector.record_stage(
                    pid.job_id, pid.stage_id, pid.partition_id, writer, metrics
                )
                info = TaskInfo(
                    pid,
                    "completed",
                    executor_id=self.id,
                    partitions=partitions,
                    metrics=metrics,
                    attempt=task.attempt,
                    fetch_retries=_sum_metric(metrics, "fetch_retries"),
                    speculative=bool(task.speculative),
                )
        except Exception as e:  # noqa: BLE001 - every failure must report
            log.warning("task %s failed: %s", pid, e, exc_info=True)
            info = TaskInfo(
                pid,
                "failed",
                executor_id=self.id,
                error=f"{type(e).__name__}: {e}",
                attempt=task.attempt,
                speculative=bool(task.speculative),
            )
        finally:
            self._drop_abort_handle(pid, task.attempt)
        if trace.is_enabled():
            # piggyback every span finished in this process (this task's
            # and any stragglers) onto the status report
            info.spans = get_recorder().drain()
        return task_info_to_proto(info)

    @staticmethod
    def _note_external_root(task: pb.TaskDefinition) -> None:
        """Remember the session's external shuffle root process-wide: the
        drain-time replica upload needs it after the last task finished,
        when no session config is in scope."""
        from ..config import SHUFFLE_EXTERNAL_PATH

        ext = task.props.get(SHUFFLE_EXTERNAL_PATH, "")
        if ext:
            from ..shuffle import store as shuffle_store

            shuffle_store.note_external_root(ext)

    def _new_shuffle_writer(
        self, pid: PartitionId, plan, task: pb.TaskDefinition, config: BallistaConfig
    ) -> ShuffleWriterExec:
        """Rebuild the stage root against the local work_dir (reference:
        executor.rs:137-161), re-applying the device acceleration pass to
        the stage subplan under this task's session config, on this
        executor's device — acceleration is an executor-local
        physical-optimizer rule, so plans travel unaccelerated."""
        from ..ops.stage_compiler import maybe_accelerate

        partitioning = None
        if task.has_output_partitioning:
            partitioning = partitioning_from_proto(task.output_partitioning)
        if isinstance(plan, ShuffleWriterExec):
            inner = plan.input
            partitioning = partitioning or plan.shuffle_output_partitioning
        else:
            inner = plan
        inner = maybe_accelerate(inner, config, self.device)
        return ShuffleWriterExec(
            pid.job_id, pid.stage_id, inner, self.work_dir, partitioning
        )

    # ---------------------------------------------------- process isolation
    def _worker_eligible(self, task: pb.TaskDefinition) -> bool:
        """Process isolation runs tasks whose outputs OUTLIVE the worker:
        file shuffle (shared work_dir) and memory shuffle (the worker
        SPOOLS mem:// partitions to the shared work_dir and this process
        absorbs them into its store on completion).  Device stages need
        this process's CUDA context and keep the thread path on a cuda
        executor — the measured residual risk
        (tests/test_executor_isolation.py device-stage latency test).
        Pipelined TAILING tasks also keep the thread path: they stream
        the scheduler's shuffle-location feed through THIS process's
        delta-store mirror, which a task-runner subprocess (no scheduler
        stub, no push notifications) cannot reach.  The plan walk is
        gated on the session's pipelined knob (which the scheduler
        stamps into the props whenever it could have produced a tailing
        plan), so the default-off dispatch path never pays a second
        plan parse."""
        if task.props.get("ballista.shuffle.pipelined", "").lower() in (
            "true", "1", "yes",
        ):
            try:
                if _has_tailing_reader(
                    pb.PhysicalPlanNode.FromString(task.plan)
                ):
                    return False
            except Exception:  # noqa: BLE001 - undecodable: fail in-thread
                return False
        props = dict(task.props)
        if props.get("ballista.tpu.enable", "true").lower() in (
            "true", "1", "yes",
        ):
            # device="cpu": the stages run the kernels' plain twins —
            # safe in a worker.  The card belongs to THIS process only.
            if self.device.type != "cpu":
                return False
        return True

    def _execute_in_worker(self, task: pb.TaskDefinition) -> pb.TaskStatus:
        """Run the task in a pooled task-runner subprocess (reference
        DedicatedExecutor property: plan execution cannot starve Flight
        serving / CancelTasks / heartbeats in this process)."""
        pid = PartitionId.from_proto(task.task_id)
        # the worker records its own spans (they ride back inside the
        # TaskStatus bytes); the parent still ratchets obs on so ITS
        # heartbeat piggyback and Flight-serving spans flow too
        trace.enable_from_props(task.props, process=f"executor:{self.id}")
        self._note_external_root(task)
        with self._worker_lock:
            worker = (
                self._idle_workers.pop() if self._idle_workers else None
            )
        if worker is None or not worker.alive():
            worker = _ProcessWorker(
                self.id, self.work_dir, self.plugin_dir,
                host=self.metadata.host,
            )
        abort = _WorkerAbort(worker)
        with self._abort_lock:
            self._abort_handles.setdefault(pid, {})[task.attempt] = abort
        try:
            out = worker.run(task.SerializeToString())
        finally:
            self._drop_abort_handle(pid, task.attempt)
        if out is None:
            worker.kill()
            # a deliberate cancel is fatal (no retry); an unexplained
            # worker death is a transient infrastructure failure
            error = (
                "Cancelled: task cancelled (worker killed)"
                if abort.cancelled
                else "ExecutionError: task worker terminated (crashed)"
            )
            info = TaskInfo(
                pid, "failed",
                executor_id=self.id,
                error=error,
                attempt=task.attempt,
                speculative=bool(task.speculative),
            )
            return task_info_to_proto(info)
        with self._worker_lock:
            self._idle_workers.append(worker)
        status = pb.TaskStatus()
        status.ParseFromString(out)
        self._absorb_spooled(status)
        return status

    def _absorb_spooled(self, status: pb.TaskStatus) -> None:
        """Move a worker's spooled mem:// partitions into THIS process's
        memory store (the Flight service serves from here)."""
        if status.WhichOneof("status") != "completed":
            return
        from ..shuffle import memory_store

        spool = os.path.join(self.work_dir, ".memspool")
        for part in status.completed.partitions:
            if part.path.startswith(memory_store.SCHEME):
                if not memory_store.absorb_spooled(spool, part.path):
                    log.warning(
                        "spooled memory partition missing: %s", part.path
                    )

    def shutdown_workers(self) -> None:
        # worker-pool teardown ONLY — full executor teardown is close(),
        # which also drops the local-transport identity.  A caller that
        # stops here leaves the identity registered; later fetches then
        # warn and fall back to Flight per miss instead of going zero-copy
        # (self-healing, but noisy — prefer close()).
        with self._worker_lock:
            workers, self._idle_workers = self._idle_workers, []
        for w in workers:
            w.close()

    def close(self) -> None:
        """Full teardown: drop this executor's local-transport identity
        (a later fetch in this process must not treat its dead work_dir
        as servable) and stop the worker pool."""
        from ..shuffle import transport

        transport.unregister_local_executor(self.metadata.id)
        self.shutdown_workers()

    # --------------------------------------------------------------- abort
    def _drop_abort_handle(self, pid: PartitionId, attempt: int) -> None:
        with self._abort_lock:
            per = self._abort_handles.get(pid)
            if per is not None:
                per.pop(attempt, None)
                if not per:
                    self._abort_handles.pop(pid, None)

    def cancel_task(self, pid: PartitionId) -> bool:
        """Abort the OLDEST live attempt of ``pid`` — CancelTasks is
        pid-addressed and always targets a superseded copy (losing
        duplicate, reaped straggler, cancelled job), so when two attempts
        coexist here the newer one must survive the cancel."""
        with self._abort_lock:
            per = self._abort_handles.get(pid)
            ev = per[min(per)] if per else None
        if ev is None:
            return False
        ev.set()
        return True

    def active_task_count(self) -> int:
        with self._abort_lock:
            return sum(len(per) for per in self._abort_handles.values())

    def cancel_all(self) -> int:
        with self._abort_lock:
            handles = [
                ev for per in self._abort_handles.values()
                for ev in per.values()
            ]
        for ev in handles:
            ev.set()
        return len(handles)
