"""The PyTorch port's process entry points: ``python -m
arrow_ballista_tpu_torch.scheduler`` and ``python -m
arrow_ballista_tpu_torch.executor``.

Twin of ``tests/test_autoscaler.py::test_subprocess_breathe_cycle_and_
telemetry_hygiene``: the port's autoscaler launches real executor children
of the port (``LocalProcessProvider`` → ``python -m
arrow_ballista_tpu_torch.executor --device cpu``), which register, serve
queries, drain and retire.  Also: both binaries run a query as separate
processes, and an executor asked for no device (``cuda``, the default)
refuses to start without a CUDA device.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pyarrow as pa
import pytest

from arrow_ballista_tpu_torch.config import BallistaConfig, TaskSchedulingPolicy
from arrow_ballista_tpu_torch.scheduler.standalone import new_standalone_scheduler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_CONFIG = {
    "ballista.mesh.enable": "false",
    "ballista.tpu.min_rows": "0",
    "ballista.shuffle.partitions": "2",
}


def _rows(table: pa.Table):
    cols = sorted(table.column_names)
    d = table.to_pydict()
    return sorted(zip(*(d[c] for c in cols)))


def _events_of(srv, kind):
    return [e for e in srv.state.events.tail(1000) if e.get("kind") == kind]


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_subprocess_breathe_cycle_and_telemetry_hygiene(tmp_path):
    """launch → register → drain → retire with real children of the port,
    then the hygiene sweep: the retired executor leaves no timeseries
    rings, no labeled gauges, and the health block reconciles with the
    provider."""
    from arrow_ballista_tpu_torch.catalog import MemoryTable
    from arrow_ballista_tpu_torch.client.context import BallistaContext
    from arrow_ballista_tpu_torch.scheduler.autoscaler import LocalProcessProvider

    settings = {
        "ballista.autoscaler.enabled": "true",
        "ballista.autoscaler.min_executors": "1",
        "ballista.autoscaler.max_executors": "2",
        "ballista.autoscaler.scale_out_sustain_seconds": "0.4",
        "ballista.autoscaler.scale_in_idle_seconds": "1.5",
        "ballista.autoscaler.cooldown_seconds": "0.5",
    }
    handle = new_standalone_scheduler(
        TaskSchedulingPolicy.PUSH_STAGED,
        speculation_interval_s=0.2,
        event_journal_dir=str(tmp_path / "journal"),
        autoscaler_settings=settings,
        executor_provider_factory=lambda host, port: LocalProcessProvider(
            host, port, task_slots=2,
            work_dir_root=str(tmp_path / "work"),
            heartbeat_interval_s=1.0,
            extra_args=["--task-isolation", "thread", "--device", "cpu"],
            env={"BALLISTA_FAULTS": "task.run:-1:delay=250"},
        ),
    )
    srv = handle.server
    em = srv.state.executor_manager
    ctx = None
    try:
        asc = srv.autoscaler
        assert asc is not None
        _wait(lambda: len(em.get_alive_executors()) >= 1, 60, "min executor")
        ctx = BallistaContext.remote(
            "127.0.0.1", handle.port, BallistaConfig(dict(CPU_CONFIG)), device="cpu"
        )
        table = pa.table({
            "g": pa.array([f"g{i % 7}" for i in range(4000)]),
            "x": pa.array([float(i % 97) for i in range(4000)]),
        })
        ctx.register_table("t", MemoryTable.from_table(table, 2))
        sql = "select g, sum(x) as s from t group by g"
        results = []

        def run():
            results.append(_rows(ctx.sql(sql).collect()))

        threads = [threading.Thread(target=run) for _ in range(4)]
        for th in threads:
            th.start()
        _wait(lambda: len(em.get_alive_executors()) >= 2, 60, "scale-out under burst")
        for th in threads:
            th.join(120)
        assert len(results) == 4
        assert all(r == results[0] for r in results)
        want = {f"g{k}": 0.0 for k in range(7)}
        for i in range(4000):
            want[f"g{i % 7}"] += float(i % 97)
        assert results[0] == sorted(want.items())
        # the children are the port's executor binary on the CPU device
        launched = _events_of(srv, "executor_launched")
        assert launched
        for eid in {e["executor"] for e in launched}:
            log = (tmp_path / "work" / eid / "launch.log").read_text()
            assert "device=cpu" in log, log[-2000:]
        # breathe back in: drain-based retire to min_executors
        _wait(
            lambda: len(em.get_alive_executors()) <= 1
            and len(_events_of(srv, "executor_retired")) >= 1,
            90, "drain-based scale-in",
        )
        retired = {e["executor"] for e in _events_of(srv, "executor_retired")}
        assert retired
        assert any(e.get("action") == "scale_out"
                   for e in _events_of(srv, "autoscale_decision"))
        for job_id in sorted(ctx._job_ids):
            detail = srv.state.task_manager.get_job_detail(job_id)
            assert detail and detail.get("task_retries", 0) == 0
        # telemetry hygiene: the retired executor's rings and labeled
        # gauges are gone; surviving series belong to live executors
        _wait(
            lambda: not (retired & set(srv.state.telemetry.metric_names()["executors"])),
            20, "telemetry rings forgotten",
        )
        snap = srv.state.metrics.snapshot()
        for name, val in snap.items():
            if isinstance(val, dict) and name.startswith("executor_"):
                for label in val:
                    for eid in retired:
                        assert eid not in label, (name, label)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            health = asc.snapshot()
            polled = asc.provider.poll()
            if (
                health["alive"] == 1
                and health["launching"] == 0
                and health["draining"] == 0
                and len(polled) == 1
                and set(health["managed"].get("alive", [])) == set(polled)
            ):
                break
            time.sleep(0.2)
        else:
            raise AssertionError(
                f"health {asc.snapshot()} never reconciled with "
                f"provider {asc.provider.poll()}"
            )
        assert health["alive"] == len(em.get_alive_executors())
    finally:
        if ctx is not None:
            ctx.close()
        handle.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _stop(proc) -> str:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)
    return proc.stdout.read().decode(errors="replace") if proc.stdout else ""


def test_scheduler_and_executor_binaries_run_a_query(tmp_path):
    """The port's two binaries as separate processes: the executor
    (``--device cpu``) registers with the scheduler and a remote session's
    query runs through it, equal to the CPU operators; SIGTERM stops
    both."""
    from arrow_ballista_tpu_torch.catalog import MemoryTable
    from arrow_ballista_tpu_torch.client.context import BallistaContext
    from arrow_ballista_tpu_torch.context import SessionContext

    port = _free_port()
    sched = subprocess.Popen(
        [sys.executable, "-m", "arrow_ballista_tpu_torch.scheduler",
         "--bind-host", "127.0.0.1", "--bind-port", str(port),
         "--work-dir", str(tmp_path / "sched")],
        env=_env(), cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    execu = None
    ctx = None
    try:
        execu = subprocess.Popen(
            [sys.executable, "-m", "arrow_ballista_tpu_torch.executor",
             "--scheduler-host", "127.0.0.1", "--scheduler-port", str(port),
             "--bind-host", "127.0.0.1", "--bind-port", "0", "--bind-grpc-port", "0",
             "--device", "cpu", "--task-isolation", "thread", "--heartbeat-sidecar", "0",
             "--work-dir", str(tmp_path / "exec"), "--concurrent-tasks", "2"],
            env=_env(), cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        deadline = time.monotonic() + 60
        while True:
            try:
                ctx = BallistaContext.remote(
                    "127.0.0.1", port, BallistaConfig(dict(CPU_CONFIG)), device="cpu")
                break
            except Exception:
                if time.monotonic() > deadline or sched.poll() is not None:
                    raise
                time.sleep(0.5)
        table = pa.table({"g": pa.array([i % 5 for i in range(3000)]),
                          "x": pa.array([float(i % 31) for i in range(3000)])})
        ctx.register_table("t", MemoryTable.from_table(table, 2))
        sql = "select g, sum(x) as s, count(*) as c from t group by g"
        got = ctx.sql(sql).collect()
        local = SessionContext(BallistaConfig({"ballista.tpu.enable": "false"}),
                               device="cpu")
        local.register_arrow_table("t", table)
        assert _rows(got) == _rows(local.sql(sql).collect())
    finally:
        if ctx is not None:
            ctx.close()
        exec_log = _stop(execu) if execu is not None else ""
        sched_log = _stop(sched)
    assert execu.returncode == 0, exec_log[-3000:]
    assert sched.returncode == 0, sched_log[-3000:]
    assert "device=cpu" in exec_log, exec_log[-3000:]


def test_executor_without_device_raises_without_cuda(monkeypatch, tmp_path):
    """``--device`` defaults to cuda: without a CUDA device the executor
    raises at start, before it binds a port or registers, in process and
    as a binary."""
    import torch

    from arrow_ballista_tpu_torch.errors import ExecutionError
    from arrow_ballista_tpu_torch.executor.__main__ import load_config, main

    assert load_config([])["device"] == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ExecutionError, match="no CUDA device"):
        main(["--scheduler-port", "1", "--work-dir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()

    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the machine has
    r = subprocess.run(
        [sys.executable, "-m", "arrow_ballista_tpu_torch.executor",
         "--scheduler-port", "1", "--work-dir", str(tmp_path / "w2")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr, r.stderr[-3000:]
    assert not (tmp_path / "w2").exists()


def test_scheduler_binary_refuses_unported_front_ends(tmp_path):
    """The port has no REST API or FlightSQL yet: asking for either exits
    with an error instead of starting without it."""
    from arrow_ballista_tpu_torch.scheduler.__main__ import load_config, main

    assert load_config([])["rest_port"] == 0
    for flag in ("--rest-port", "--flight-sql-port"):
        with pytest.raises(SystemExit, match="not ported"):
            main([flag, "8080", "--work-dir", str(tmp_path)])
