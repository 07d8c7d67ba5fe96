"""Task/liveness isolation (counterpart of the reference's
DedicatedExecutor, ``executor/src/cpu_bound_executor.rs:37-131``).

The reference moves CPU-bound plan execution onto a separate prioritized
tokio runtime so it cannot starve heartbeat/RPC I/O.  A TPU executor
inverts that: the DEVICE handle must live in the main process (XLA client
state is per-process), so the liveness I/O is what gets its own OS
process — a :class:`HeartbeatSidecar` child that keeps
``HeartBeatFromExecutor`` flowing no matter what the parent's GIL is
doing (a pure-Python UDF pegging every task thread, a long native call
that forgot to release the GIL, a stop-the-world pause).

The in-process threaded Heartbeater stays as the primary (it carries
executor status); the sidecar is the liveness backstop.  It exits on its
own when the parent process dies, so it can never keep a dead executor
looking alive: the scheduler's 60s liveness window starts from the last
beat, exactly as for the reference's 60s heartbeats.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time
from typing import Optional

log = logging.getLogger(__name__)


class HeartbeatSidecar:
    """Child process beating on behalf of an executor."""

    def __init__(
        self,
        executor_id: str,
        scheduler_host: str,
        scheduler_port: int,
        interval_s: float = 15.0,
    ):
        self.executor_id = executor_id
        self._proc: Optional[subprocess.Popen] = None
        self._args = [
            sys.executable,
            "-m",
            "arrow_ballista_tpu_torch.executor.isolation",
            "--executor-id",
            executor_id,
            "--scheduler",
            f"{scheduler_host}:{scheduler_port}",
            "--interval",
            str(interval_s),
            "--parent-pid",
            str(os.getpid()),
        ]

    def start(self) -> "HeartbeatSidecar":
        repo_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        # the sidecar must never initialize a device backend
        env["JAX_PLATFORMS"] = "cpu"
        self._proc = subprocess.Popen(
            self._args,
            env=env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        return self

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc else None

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def stop(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:  # pragma: no cover
                self._proc.kill()


def _parent_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def main() -> None:
    """Sidecar entry: beat until stopped or the parent dies."""
    import argparse

    import grpc

    parser = argparse.ArgumentParser(
        prog="arrow_ballista_tpu_torch.executor.isolation"
    )
    parser.add_argument("--executor-id", required=True)
    parser.add_argument("--scheduler", required=True, help="host:port")
    parser.add_argument("--interval", type=float, default=15.0)
    parser.add_argument("--parent-pid", type=int, required=True)
    args = parser.parse_args()

    from ..proto import pb
    from ..proto.rpc import SchedulerGrpcStub, make_channel

    host, _, port = args.scheduler.partition(":")
    stub = SchedulerGrpcStub(make_channel(host, int(port)))
    while _parent_alive(args.parent_pid):
        try:
            status = pb.ExecutorStatus()
            status.active = ""
            stub.HeartBeatFromExecutor(
                pb.HeartBeatParams(executor_id=args.executor_id, status=status),
                timeout=10,
            )
        except grpc.RpcError:
            pass  # scheduler restarting: keep trying while the parent lives
        # short sleep slices so parent death is noticed within ~1s
        deadline = time.monotonic() + args.interval
        while time.monotonic() < deadline:
            if not _parent_alive(args.parent_pid):
                return
            time.sleep(min(1.0, max(0.05, deadline - time.monotonic())))


if __name__ == "__main__":
    main()
