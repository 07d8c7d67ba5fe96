"""Pull-mode executor poll loop.

Counterpart of the reference's ``executor/src/execution_loop.rs:46-255``:
loop { PollWork(metadata, can_accept_task, drained statuses) }; a returned
TaskDefinition decrements the local slot counter and runs on a worker
thread; finished statuses queue up and piggyback on the next poll; idle
polls sleep 100ms (`:114`).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional

import grpc

from ..proto import pb
from ..proto.rpc import SchedulerGrpcStub
from .executor import Executor

log = logging.getLogger(__name__)

IDLE_POLL_INTERVAL_S = 0.1  # reference: execution_loop.rs:114


class PollLoop:
    def __init__(
        self,
        executor: Executor,
        scheduler: SchedulerGrpcStub,
        poll_interval_s: float = IDLE_POLL_INTERVAL_S,
    ):
        self.executor = executor
        self.scheduler = scheduler
        self.poll_interval_s = poll_interval_s
        # pipelined execution: pull-mode tailing fetches read
        # the scheduler's shuffle-location feed by polling
        # GetShuffleLocationDelta through this loop's stub
        from ..shuffle import delta_store

        delta_store.configure_scheduler(lambda: self.scheduler)
        self._statuses: "queue.Queue[pb.TaskStatus]" = queue.Queue()
        self._free_count = executor.concurrent_tasks
        self._count_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "PollLoop":
        # bootstrap poll: register metadata synchronously (can_accept_task
        # False so no task is handed out before the loop thread exists).
        # Without it the first real poll races anything that looks the
        # executor up right after start() — decommission, REST state, tests.
        try:
            self.scheduler.PollWork(
                pb.PollWorkParams(
                    metadata=self._registration(),
                    can_accept_task=False,
                    task_status=[],
                ),
                timeout=20,
            )
        except grpc.RpcError as e:
            # scheduler unreachable at start is tolerated in pull mode —
            # the loop below keeps retrying
            log.debug("bootstrap PollWork failed (%s); loop will retry", e.code())
        self._thread = threading.Thread(
            target=self._run, name=f"poll-loop-{self.executor.id}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        # abort THIS executor's in-flight shuffle fetch pipelines (scoped
        # by work_dir): a fetch worker blocked on a dead peer would
        # otherwise pin its task thread past shutdown
        from ..shuffle.fetcher import shutdown_active_fetchers

        shutdown_active_fetchers(owner=self.executor.work_dir)
        if self._thread is not None:
            self._thread.join(timeout)

    def _registration(self) -> pb.ExecutorRegistration:
        return pb.ExecutorRegistration(
            id=self.executor.metadata.id,
            host=self.executor.metadata.host,
            has_host=bool(self.executor.metadata.host),
            flight_port=self.executor.metadata.flight_port,
            grpc_port=self.executor.metadata.grpc_port,
            specification=self.executor.metadata.specification.to_proto(),
        )

    # ---------------------------------------------------------------- loop
    def _run(self) -> None:
        registration = self._registration()
        while not self._stop.is_set():
            statuses = self._drain_statuses()
            with self._count_lock:
                can_accept = self._free_count > 0
            try:
                result: pb.PollWorkResult = self.scheduler.PollWork(
                    pb.PollWorkParams(
                        metadata=registration,
                        can_accept_task=can_accept,
                        task_status=statuses,
                    ),
                    timeout=20,
                )
            except grpc.RpcError as e:
                # scheduler unreachable: requeue statuses and retry
                for s in statuses:
                    self._statuses.put(s)
                log.debug("PollWork failed (%s); retrying", e.code())
                if self._stop.wait(self.poll_interval_s):
                    break
                continue

            if result.has_task:
                self._spawn(result.task)
                continue  # poll again immediately while work may remain
            if self._stop.wait(self.poll_interval_s):
                break

    def _drain_statuses(self) -> list:
        out = []
        while True:
            try:
                out.append(self._statuses.get_nowait())
            except queue.Empty:
                return out

    def _spawn(self, task: pb.TaskDefinition) -> None:
        with self._count_lock:
            self._free_count -= 1
        t = threading.Thread(
            target=self._run_task, args=(task,), name="task-runner", daemon=True
        )
        t.start()

    def _run_task(self, task: pb.TaskDefinition) -> None:
        try:
            status = self.executor.execute_task(task)
        finally:
            with self._count_lock:
                self._free_count += 1
        self._statuses.put(status)
