"""In-process scheduler for standalone mode.

Counterpart of the reference's ``scheduler/src/standalone.rs:33-60``: a
scheduler on a random localhost port over an in-memory state backend.
"""

from __future__ import annotations

import logging
import uuid
from typing import Optional, Tuple

import grpc

from ..config import TaskSchedulingPolicy
from ..proto.rpc import add_scheduler_servicer, make_server
from .backend import MemoryBackend, StateBackend
from .grpc_service import SchedulerGrpcService
from .server import SchedulerServer

log = logging.getLogger(__name__)


class StandaloneScheduler:
    def __init__(self, server: SchedulerServer, grpc_server: grpc.Server, port: int):
        self.server = server
        self.grpc_server = grpc_server
        self.port = port
        self.host = "127.0.0.1"

    def shutdown(self) -> None:
        self.grpc_server.stop(grace=1)
        self.server.stop()


def new_standalone_scheduler(
    policy: TaskSchedulingPolicy = TaskSchedulingPolicy.PULL_STAGED,
    backend: Optional[StateBackend] = None,
    liveness_window_s: float = 60.0,
    executor_timeout_s: float = 180.0,
    event_journal_dir: str = "",
    telemetry_sample_s: float = 1.0,
    autoscaler_settings: Optional[dict] = None,
    executor_provider_factory=None,
    **server_kwargs,
) -> StandaloneScheduler:
    """``executor_provider_factory`` is ``(host, port) -> ExecutorProvider``
    — a factory because the scheduler's port doesn't exist until the gRPC
    server binds, and a subprocess provider needs that address to hand to
    the executors it launches.  ``None`` with autoscaling enabled builds a
    :class:`LocalProcessProvider` against the bound port."""
    backend = backend or MemoryBackend()
    scheduler_id = f"localhost:{uuid.uuid4().hex[:6]}"
    server = SchedulerServer(
        scheduler_id,
        backend,
        policy,
        liveness_window_s=liveness_window_s,
        executor_timeout_s=executor_timeout_s,
        event_journal_dir=event_journal_dir,
        # standalone exists for tests/local runs: sample the cluster
        # aggregates tightly so short-lived clusters still get history
        telemetry_sample_s=telemetry_sample_s,
        **server_kwargs,
    ).init()
    grpc_server = make_server()
    add_scheduler_servicer(grpc_server, SchedulerGrpcService(server))
    # the KEDA scaler rides the same gRPC server, like the reference's mux
    from .external_scaler import ExternalScalerService, add_external_scaler_servicer

    add_external_scaler_servicer(grpc_server, ExternalScalerService(server))
    port = grpc_server.add_insecure_port("127.0.0.1:0")
    grpc_server.start()
    # the scheduler id doubles as the curator address executors report to
    server.scheduler_id = f"127.0.0.1:{port}"
    server.state.task_manager.scheduler_id = server.scheduler_id
    from .autoscaler import AutoscalerPolicy

    if AutoscalerPolicy.enabled_in(autoscaler_settings):
        if executor_provider_factory is None:
            from .autoscaler import LocalProcessProvider

            provider = LocalProcessProvider("127.0.0.1", port)
        else:
            provider = executor_provider_factory("127.0.0.1", port)
        server.attach_autoscaler(provider, autoscaler_settings)
    log.info("standalone scheduler up at 127.0.0.1:%d (%s)", port, policy.value)
    return StandaloneScheduler(server, grpc_server, port)
