"""In-process executor for standalone mode.

Counterpart of the reference's ``executor/src/standalone.rs:39-97``: spins
up a Flight server on a random port, a temp work dir, and either the
pull-mode poll loop or the push-mode executor server, all inside the
current process.  The executor's device stages run on ``device`` (None
means ``cuda``; see :class:`Executor`).
"""

from __future__ import annotations

import logging
import tempfile
import uuid
from typing import Optional

from ..config import TaskSchedulingPolicy
from ..flight.server import FlightServerHandle
from ..proto.rpc import SchedulerGrpcStub, make_channel
from ..serde.scheduler_types import ExecutorMetadata, ExecutorSpecification
from .execution_loop import PollLoop
from .executor import Executor
from .server import ExecutorServer

log = logging.getLogger(__name__)


class StandaloneExecutor:
    """Handle owning the in-proc executor's threads + resources."""

    def __init__(
        self,
        executor: Executor,
        flight: FlightServerHandle,
        poll_loop: Optional[PollLoop] = None,
        server: Optional[ExecutorServer] = None,
    ):
        self.executor = executor
        self.flight = flight
        self.poll_loop = poll_loop
        self.server = server

    @property
    def id(self) -> str:
        return self.executor.id

    def shutdown(self) -> None:
        if self.poll_loop is not None:
            self.poll_loop.stop()
        if self.server is not None:
            self.server.stop()
        self.executor.close()
        self.flight.shutdown()


def new_standalone_executor(
    scheduler_host: str,
    scheduler_port: int,
    concurrent_tasks: int = 4,
    work_dir: Optional[str] = None,
    policy: TaskSchedulingPolicy = TaskSchedulingPolicy.PULL_STAGED,
    poll_interval_s: float = 0.02,
    heartbeat_interval_s: float = 5.0,
    task_isolation: str = "thread",
    plugin_dir: str = "",
    device=None,
) -> StandaloneExecutor:
    """Start an in-proc executor registered with the given scheduler.

    Poll/heartbeat intervals default much tighter than production (100ms /
    60s) because standalone mode exists for tests and local runs.
    """
    work_dir = work_dir or tempfile.mkdtemp(prefix="ballista-executor-")
    flight = FlightServerHandle(work_dir, host="127.0.0.1", port=0).start()
    metadata = ExecutorMetadata(
        id=uuid.uuid4().hex[:12],
        host="127.0.0.1",
        flight_port=flight.port,
        grpc_port=0,
        specification=ExecutorSpecification(task_slots=concurrent_tasks),
    )
    executor = Executor(
        metadata, work_dir, concurrent_tasks,
        task_isolation=task_isolation, plugin_dir=plugin_dir, device=device,
    )

    if policy == TaskSchedulingPolicy.PUSH_STAGED:
        server = ExecutorServer(
            executor,
            scheduler_host,
            scheduler_port,
            heartbeat_interval_s=heartbeat_interval_s,
        ).start()
        log.info(
            "standalone executor %s up (push mode, grpc :%d, flight :%d)",
            executor.id,
            server.grpc_port,
            flight.port,
        )
        handle = StandaloneExecutor(executor, flight, server=server)
        # a drained (or stopped) executor must stop SERVING too — wire
        # the server's shutdown hook to the whole handle so decommission
        # takes the Flight endpoint down exactly like a real process exit
        server.on_shutdown = lambda reason: handle.shutdown()
        return handle

    stub = SchedulerGrpcStub(make_channel(scheduler_host, scheduler_port))
    loop = PollLoop(executor, stub, poll_interval_s).start()
    log.info(
        "standalone executor %s up (pull mode, flight :%d)",
        executor.id,
        flight.port,
    )
    return StandaloneExecutor(executor, flight, poll_loop=loop)
