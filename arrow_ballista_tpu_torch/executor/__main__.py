"""Executor process binary: ``python -m arrow_ballista_tpu_torch.executor``.

Counterpart of the reference's ``executor/src/main.rs:74-301`` +
``executor_config_spec.toml:27-121``: scheduler host/port, bind/external
host, Flight port (default 50051) and gRPC port (50052), work_dir,
concurrent_tasks (default 4), scheduling policy, and the shuffle-data
janitor (delete job dirs older than the TTL every cleanup interval;
reference ``main.rs:186-214,320-474``).  Graceful shutdown notifies the
scheduler via ExecutorStopped (``main.rs:252-299``).

The port's executor runs its device stages on the torch device named by
``--device`` (default ``cuda``, which raises at start without a CUDA
device, as the port's ``SessionContext`` does; ``cpu`` runs the kernels'
plain twins).
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import signal
import threading
import time
import uuid

CONFIG_KEYS = {
    "executor_id": (
        str, "",
        "pre-assigned executor id (default: random).  Launch controllers "
        "(the autoscaler's ExecutorProvider) set this so their handle and "
        "the registration correlate",
    ),
    "scheduler_host": (str, "localhost", "scheduler hostname"),
    "scheduler_port": (int, 50050, "scheduler gRPC port"),
    "bind_host": (str, "0.0.0.0", "local bind address"),
    "external_host": (str, "", "address advertised to the scheduler"),
    "bind_port": (int, 50051, "Arrow Flight (shuffle) port"),
    "bind_grpc_port": (int, 50052, "executor gRPC port (push mode)"),
    "work_dir": (str, "", "shuffle data dir (default: tmp)"),
    "concurrent_tasks": (int, 4, "task slots"),
    "task_scheduling_policy": (str, "pull-staged", "pull-staged | push-staged"),
    "task_isolation": (
        str, "process",
        "process | thread: 'process' (default) runs shuffle tasks — file "
        "AND memory data plane (mem:// partitions spool through the "
        "shared work_dir and the executor absorbs them) — in pooled "
        "worker subprocesses so plan execution (e.g. a GIL-pegging UDF) "
        "cannot starve Flight serving/CancelTasks/heartbeats (reference "
        "DedicatedExecutor); device stages stay in-process on a cuda "
        "executor (the CUDA context is per-process)",
    ),
    "plugin_dir": (str, "", "directory of UDF plugin .py modules"),
    "device": (
        str, "cuda",
        "torch device of the device stages: cuda (raises at start without "
        "a CUDA device) or cpu (the kernels' plain twins)",
    ),
    "job_data_clean_up_interval_seconds": (int, 0, "janitor period (0=off)"),
    "job_data_ttl_seconds": (int, 604800, "delete job dirs older than this"),
    "heartbeat_sidecar": (int, 1, "process-isolated liveness backstop (0=off)"),
    "heartbeat_interval_seconds": (
        float, 0.0,
        "push-mode heartbeat cadence (0 = built-in default); autoscaled "
        "executors beat faster so liveness tracks launches",
    ),
    "telemetry_enabled": (int, 1, "piggyback a resource snapshot (CPU%, RSS, shuffle disk, queue occupancy, slots) on every heartbeat; 0 disables (push mode only)"),
    "log_level_setting": (str, "INFO", "log filter"),
    "log_dir": (str, "", "write logs to a file here instead of stdout"),
    "log_file_name_prefix": (str, "executor", "log file prefix"),
}


def load_config(argv=None) -> dict:
    cfg = {k: v[1] for k, v in CONFIG_KEYS.items()}
    ap = argparse.ArgumentParser("ballista-tpu executor")
    ap.add_argument("--config-file", default=None, help="TOML config file")
    for k, (typ, default, hlp) in CONFIG_KEYS.items():
        ap.add_argument(f"--{k.replace('_', '-')}", type=typ, default=None, help=hlp)
    args = ap.parse_args(argv)
    if args.config_file:
        import tomllib

        with open(args.config_file, "rb") as f:
            for k, v in tomllib.load(f).items():
                k = k.replace("-", "_")
                if k in cfg:
                    cfg[k] = CONFIG_KEYS[k][0](v)
    for k in CONFIG_KEYS:
        env = os.environ.get(f"BALLISTA_EXECUTOR_{k.upper()}")
        if env is not None:
            cfg[k] = CONFIG_KEYS[k][0](env)
    for k in CONFIG_KEYS:
        v = getattr(args, k, None)
        if v is not None:
            cfg[k] = v
    return cfg


class ShuffleJanitor(threading.Thread):
    """Periodic shuffle-data GC (reference: executor/src/main.rs:320-474):
    removes ``work_dir/<job>`` trees whose newest file is older than the
    TTL; a full sweep runs on shutdown."""

    def __init__(self, work_dir: str, interval_s: float, ttl_s: float):
        super().__init__(name="shuffle-janitor", daemon=True)
        self.work_dir = work_dir
        self.interval_s = interval_s
        self.ttl_s = ttl_s
        self._stop = threading.Event()

    def run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sweep(self.ttl_s)

    def stop(self, final_sweep: bool = False) -> None:
        self._stop.set()
        if final_sweep:
            self.sweep(0)

    def sweep(self, ttl_s: float) -> None:
        from ..shuffle import memory_store

        memory_store.sweep(ttl_s)
        now = time.time()
        try:
            entries = os.listdir(self.work_dir)
        except OSError:
            return
        for job in entries:
            path = os.path.join(self.work_dir, job)
            if job == ".memspool" and os.path.isdir(path):
                # orphaned worker spool files (a failed/cancelled task's
                # mem:// partitions were never absorbed): age per file
                for f in os.listdir(path):
                    fp = os.path.join(path, f)
                    try:
                        if now - os.path.getmtime(fp) > ttl_s:
                            os.unlink(fp)
                    except OSError:
                        pass
                continue
            if not os.path.isdir(path):
                continue
            newest = 0.0
            for root, _dirs, files in os.walk(path):
                for f in files:
                    try:
                        newest = max(newest, os.path.getmtime(os.path.join(root, f)))
                    except OSError:
                        pass
            if newest == 0.0:
                # no files yet (a task may have just created the dir) —
                # age by the directory's own mtime, not the epoch
                try:
                    newest = os.path.getmtime(path)
                except OSError:
                    continue
            if now - newest > ttl_s:
                logging.getLogger("ballista.executor").info(
                    "janitor: removing job dir %s", path
                )
                shutil.rmtree(path, ignore_errors=True)


def main(argv=None) -> None:
    cfg = load_config(argv)
    from ..context import _resolve_device

    # refuse a missing card before any port is bound or thread started
    device = _resolve_device(cfg["device"])
    from ..scheduler.__main__ import init_logging

    init_logging(cfg)
    log = logging.getLogger("ballista.executor")

    import tempfile

    from ..config import TaskSchedulingPolicy
    from ..flight.server import FlightServerHandle
    from ..proto import pb
    from ..proto.rpc import SchedulerGrpcStub, make_channel
    from ..serde.scheduler_types import ExecutorMetadata, ExecutorSpecification
    from .execution_loop import PollLoop
    from .executor import Executor
    from .server import ExecutorServer

    work_dir = cfg["work_dir"] or tempfile.mkdtemp(prefix="ballista-executor-")
    os.makedirs(work_dir, exist_ok=True)

    # populate the process-global UDF registry BEFORE any task arrives —
    # plans reference UDFs by name only (reference: executors load .so
    # plugins from plugin_dir at startup)
    if cfg["plugin_dir"]:
        from ..udf import load_udf_plugins

        n = load_udf_plugins(cfg["plugin_dir"])
        log.info("loaded %d UDF plugin(s) from %s", n, cfg["plugin_dir"])
    external = cfg["external_host"] or cfg["bind_host"]
    if external == "0.0.0.0":
        external = "127.0.0.1"

    flight = FlightServerHandle(
        work_dir, host=cfg["bind_host"], port=cfg["bind_port"]
    ).start()
    policy = (
        TaskSchedulingPolicy.PUSH_STAGED
        if cfg["task_scheduling_policy"] == "push-staged"
        else TaskSchedulingPolicy.PULL_STAGED
    )
    metadata = ExecutorMetadata(
        id=cfg["executor_id"] or uuid.uuid4().hex[:12],
        host=external,
        flight_port=flight.port,
        grpc_port=cfg["bind_grpc_port"] if policy == TaskSchedulingPolicy.PUSH_STAGED else 0,
        specification=ExecutorSpecification(task_slots=cfg["concurrent_tasks"]),
    )
    executor = Executor(
        metadata, work_dir, cfg["concurrent_tasks"],
        task_isolation=cfg["task_isolation"], plugin_dir=cfg["plugin_dir"],
        device=device,
    )
    log.info(
        "executor %s starting: flight :%d, policy=%s, work_dir=%s, device=%s",
        executor.id, flight.port, policy.value, work_dir, device,
    )

    janitor = None
    if cfg["job_data_clean_up_interval_seconds"] > 0:
        janitor = ShuffleJanitor(
            work_dir,
            cfg["job_data_clean_up_interval_seconds"],
            cfg["job_data_ttl_seconds"],
        )
        janitor.start()

    stop = {"flag": False}

    def on_signal(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)

    stub = SchedulerGrpcStub(
        make_channel(cfg["scheduler_host"], cfg["scheduler_port"])
    )
    sidecar = None
    if cfg["heartbeat_sidecar"]:
        # liveness survives anything the main process's GIL is doing (the
        # answer to the reference's DedicatedExecutor isolation)
        from .isolation import HeartbeatSidecar

        sidecar = HeartbeatSidecar(
            executor.id, cfg["scheduler_host"], cfg["scheduler_port"]
        ).start()
    server = None
    loop = None
    if policy == TaskSchedulingPolicy.PUSH_STAGED:
        server_kwargs = {}
        if cfg["heartbeat_interval_seconds"] > 0:
            server_kwargs["heartbeat_interval_s"] = cfg[
                "heartbeat_interval_seconds"
            ]
        server = ExecutorServer(
            executor,
            cfg["scheduler_host"],
            cfg["scheduler_port"],
            on_shutdown=lambda reason: stop.update(flag=True),
            bind_host=cfg["bind_host"],
            telemetry_enabled=bool(cfg["telemetry_enabled"]),
            **server_kwargs,
        ).start()
    else:
        loop = PollLoop(executor, stub).start()

    try:
        while not stop["flag"]:
            time.sleep(0.5)
    finally:
        log.info("executor %s shutting down", executor.id)
        try:
            stub.ExecutorStopped(
                pb.ExecutorStoppedParams(
                    executor_id=executor.id, reason="shutdown"
                ),
                timeout=5,
            )
        except Exception:
            pass
        if sidecar is not None:
            sidecar.stop()
        if loop is not None:
            loop.stop()
        if server is not None:
            server.stop()
        if janitor is not None:
            janitor.stop(final_sweep=True)
        executor.close()
        flight.shutdown()


if __name__ == "__main__":
    main()
