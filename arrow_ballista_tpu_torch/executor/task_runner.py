"""Process-isolated task worker (the DedicatedExecutor slot).

Counterpart of the reference's ``executor/src/cpu_bound_executor.rs:37-131``:
CPU-bound plan execution must not be able to starve the executor's service
plane — Flight shuffle serving, CancelTasks, heartbeats.  The reference
isolates with a second prioritized tokio runtime; a Python executor
isolates with a second PROCESS: the worker executes the (protobuf) task
plan against the shared ``work_dir`` and the parent's GIL never runs plan
code, so a pure-Python UDF pegging every worker cannot slow a downstream
stage's shuffle fetch.

Protocol (stdin/stdout, length-prefixed): the parent writes
``[u32 BE len][TaskDefinition]``; the worker replies
``[u32 BE len][TaskStatus]``.  ``len == 0`` → clean exit; stdin EOF (the
parent died) → exit.  The worker's executor runs on ``device="cpu"`` —
device stages on the card belong to the PARENT process (the CUDA context
is per-process), which keeps the in-thread path for them; the executor
routes a task here only when its own device is the CPU.
"""

from __future__ import annotations

import struct
import sys


def _read_exact(f, n: int):
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(
        prog="arrow_ballista_tpu_torch.executor.task_runner"
    )
    parser.add_argument("--executor-id", required=True)
    parser.add_argument("--work-dir", required=True)
    parser.add_argument("--plugin-dir", default="")
    # the parent executor's advertised host: the worker shares its
    # filesystem, so it inherits the local-transport identity
    parser.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args()

    from ..proto import pb
    from ..serde.scheduler_types import ExecutorMetadata, ExecutorSpecification
    from ..shuffle import memory_store
    from ..udf import load_udf_plugins
    from .executor import Executor

    # mem:// puts in this process spool to the shared work_dir; the
    # parent absorbs them into its store when the task completes
    import os

    memory_store.set_spool_dir(os.path.join(args.work_dir, ".memspool"))

    if args.plugin_dir:
        load_udf_plugins(args.plugin_dir)
    metadata = ExecutorMetadata(
        args.executor_id, args.host, 0, 0, ExecutorSpecification(1)
    )
    # never the card: a second process must not claim it
    ex = Executor(metadata, args.work_dir, concurrent_tasks=1, device="cpu")

    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    while True:
        hdr = _read_exact(stdin, 4)
        if hdr is None:
            return  # parent died or closed us
        n = struct.unpack(">I", hdr)[0]
        if n == 0:
            return  # clean shutdown
        payload = _read_exact(stdin, n)
        if payload is None:
            return
        task = pb.TaskDefinition()
        task.ParseFromString(payload)
        # worker-crash injection (BALLISTA_FAULTS is inherited through the
        # environment): "exit" hard-kills this process mid-task, "raise"
        # propagates out of main() — either way the parent sees EOF and
        # reports a transient "task worker terminated" failure
        from ..testing.faults import fault_point

        fault_point(
            "executor.task_runner",
            executor_id=args.executor_id,
            attempt=task.attempt,
        )
        status = ex.execute_task(task)  # never raises
        out = status.SerializeToString()
        stdout.write(struct.pack(">I", len(out)))
        stdout.write(out)
        stdout.flush()


if __name__ == "__main__":
    main()
