"""Closed-loop executor autoscaler.

The reference ships only a KEDA *stub* (``external_scaler.rs:29-65``
pins inflight at 1,000,000 so the HPA saturates); nothing in the system
ever launches or retires an executor.  This module closes the loop: a
policy engine ticking on the scheduler's existing 1s timer cadence
(``SchedulerServer._speculation_loop``) reads the signals the stack
already measures —

* admission queue depth (the front door, ``admission.queued_count``),
* live slot deficit (``task_manager.task_counts`` pending vs
  ``executor_manager.available_slots`` — the live spelling of the
  per-stage ``scheduling_delay_ms``: tasks runnable with nowhere to go),
* SLO burn rate (the ``SloTracker``),

and drives an :class:`ExecutorProvider` — ``launch(spec) -> handle`` /
``terminate(handle)`` / ``poll()``.  Real deployments implement the ABC
against their fleet API; :class:`LocalProcessProvider` (subprocess-backed
``python -m arrow_ballista_tpu_torch.executor`` children) serves tests, benches
and single-host deployments.

Policy shape:

* **Scale-out** fires only after the pressure signal SUSTAINS for
  ``scale_out_sustain_seconds`` (hysteresis: a one-tick blip never
  launches) and outside the cooldown, sized by the slot deficit and
  clamped to ``ballista.autoscaler.max_executors``.
* **Scale-in** fires only after the cluster is COMPLETELY idle for
  ``scale_in_idle_seconds``, one executor per decision, never below
  ``min_executors``.  The victim is the managed executor holding the
  fewest un-replicated shuffle bytes (cheapest to move) and retires
  through the graceful-drain path (``decommission_executor``):
  zero recompute, zero failed tasks.
* **Healing**: a crashed child detected by ``poll()`` is capacity loss —
  the scheduler is told (``ExecutorLost``) and the next actuation
  relaunches toward ``desired``.
* **Robustness**: provider exceptions and launch timeouts are caught,
  journaled (``autoscale_decision``), fed into the ExecutorManager's
  consecutive-launch-failure window, and suspend further launches for a
  backoff — they never take down the scheduler, and a slow/wedged
  ``launch()`` (the ``executor.launch`` delay fault) runs on a detached
  thread so the tick never blocks on it.

Everything is off by default: a scheduler without
``ballista.autoscaler.enabled=true`` never constructs this object, so
the knob-off event flow is byte-identical.
"""

from __future__ import annotations

import abc
import logging
import math
import os
import subprocess
import sys
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..config import (
    AUTOSCALER_COOLDOWN_S,
    AUTOSCALER_ENABLED,
    AUTOSCALER_LAUNCH_TIMEOUT_S,
    AUTOSCALER_MAX_EXECUTORS,
    AUTOSCALER_MIN_EXECUTORS,
    AUTOSCALER_SCALE_IN_IDLE_S,
    AUTOSCALER_SCALE_OUT_SUSTAIN_S,
    AUTOSCALER_SLO_BURN_THRESHOLD,
    BallistaConfig,
)
from ..testing.faults import fault_point

log = logging.getLogger(__name__)

# grace past the drain budget before a draining child that neither
# exited nor was declared lost gets terminated outright (the scheduler's
# reaper has its own, longer watchdog; this only reaps the process)
DRAIN_KILL_GRACE_S = 60.0
# SIGTERM -> SIGKILL escalation for terminate()
TERMINATE_GRACE_S = 5.0


# --------------------------------------------------------------- provider
@dataclass
class ExecutorSpec:
    """What the policy asks a provider to launch.  The provider fills in
    deployment details (scheduler address, image, work dir); the spec
    carries only what the policy decides."""

    executor_id: str
    task_slots: int = 2
    env: Dict[str, str] = field(default_factory=dict)


@dataclass
class ExecutorHandle:
    """Opaque provider-side handle for one launched executor."""

    executor_id: str
    backend: object = None  # provider-private (e.g. subprocess.Popen)


class ExecutorProvider(abc.ABC):
    """The actuator ABC real deployments implement (k8s, GCE MIGs, …).

    ``launch`` may block (cold starts are real) — the autoscaler always
    calls it from a detached thread and enforces its own timeout.
    ``poll`` must be cheap: it runs every tick."""

    #: slots each launched executor offers (sizes the slot-deficit math)
    task_slots: int = 2

    @abc.abstractmethod
    def launch(self, spec: ExecutorSpec) -> ExecutorHandle:
        """Start one executor; returns once the process/VM exists (not
        necessarily registered).  Raises on failure."""

    @abc.abstractmethod
    def terminate(self, handle: ExecutorHandle) -> None:
        """Hard-stop one executor (best effort, idempotent)."""

    @abc.abstractmethod
    def poll(self) -> Dict[str, Optional[int]]:
        """Liveness of every launched-and-not-terminated executor:
        ``{executor_id: None}`` while running, exit code once dead."""


PID_FILE = "executor.pid"


class _AdoptedProcess:
    """Popen-shaped wrapper around a pid this scheduler did not spawn:
    a child that survived its parent's crash.
    ``os.waitpid`` cannot reap a non-child, so ``poll`` uses signal-0
    liveness and reports a synthetic ``-1`` exit code once dead."""

    def __init__(self, pid: int):
        self.pid = pid
        self._returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self._returncode is not None:
            return self._returncode
        try:
            os.kill(self.pid, 0)
        except OSError:
            self._returncode = -1  # exit code unknowable for a non-child
            return self._returncode
        return None

    def terminate(self) -> None:
        import signal

        os.kill(self.pid, signal.SIGTERM)

    def kill(self) -> None:
        import signal

        os.kill(self.pid, signal.SIGKILL)

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = time.monotonic() + (timeout if timeout is not None else 0)
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            if timeout is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired(
                    cmd=f"adopted pid {self.pid}", timeout=timeout
                )
            time.sleep(0.05)


class LocalProcessProvider(ExecutorProvider):
    """Subprocess-backed provider: each ``launch`` spawns
    ``python -m arrow_ballista_tpu_torch.executor`` in push mode on random
    ports, pre-assigned its executor id (``--executor-id``) so the
    scheduler-side handle and the registration correlate.  Child stdout
    goes to ``<work_dir>/<executor_id>/launch.log``.

    Every launch persists ``<work_dir>/<executor_id>/executor.pid`` so a
    scheduler restarted over the same ``work_dir_root`` ADOPTS surviving
    children instead of launching a duplicate fleet: the
    constructor scans for pid files, verifies liveness (and, where /proc
    exists, that the pid still runs *this* executor id — a pid-reuse
    guard), wraps live ones in :class:`_AdoptedProcess`, and reaps stale
    files for dead ones."""

    def __init__(
        self,
        scheduler_host: str,
        scheduler_port: int,
        task_slots: int = 2,
        work_dir_root: str = "",
        heartbeat_interval_s: float = 5.0,
        extra_args: Optional[List[str]] = None,
        env: Optional[Dict[str, str]] = None,
    ):
        import tempfile

        self.scheduler_host = scheduler_host
        self.scheduler_port = scheduler_port
        self.task_slots = task_slots
        self.work_dir_root = work_dir_root or tempfile.mkdtemp(
            prefix="ballista-autoscale-"
        )
        self.heartbeat_interval_s = heartbeat_interval_s
        self.extra_args = list(extra_args or [])
        self.env = dict(env or {})
        self._lock = threading.Lock()
        self._procs: Dict[str, subprocess.Popen] = {}
        self._adopted: List[str] = []
        self._adopt_orphans()

    # -------------------------------------------------- orphan adoption
    def _pid_path(self, executor_id: str) -> str:
        return os.path.join(self.work_dir_root, executor_id, PID_FILE)

    def _remove_pid_file(self, executor_id: str) -> None:
        try:
            os.unlink(self._pid_path(executor_id))
        except OSError:
            pass

    @staticmethod
    def _pid_runs_executor(pid: int, executor_id: str) -> bool:
        """True when ``pid`` is alive AND (where verifiable) still runs
        the executor module with this id — a recycled pid must not be
        adopted as a fleet member."""
        try:
            os.kill(pid, 0)
        except OSError:
            return False
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            return True  # no /proc (or raced an exit): liveness-only
        return (
            b"--executor-id" in argv
            and executor_id.encode() in argv
        )

    def _adopt_orphans(self) -> None:
        """Scan ``work_dir_root`` for pid files left by a previous
        scheduler process; adopt live children, reap dead ones."""
        try:
            entries = sorted(os.listdir(self.work_dir_root))
        except OSError:
            return
        for eid in entries:
            path = os.path.join(self.work_dir_root, eid, PID_FILE)
            try:
                with open(path, encoding="utf-8") as f:
                    pid = int(f.read().split()[0])
            except (OSError, ValueError, IndexError):
                continue
            if self._pid_runs_executor(pid, eid):
                with self._lock:
                    self._procs[eid] = _AdoptedProcess(pid)
                    self._adopted.append(eid)
                log.info("adopted orphan executor %s (pid %d)", eid, pid)
            else:
                self._remove_pid_file(eid)
                log.info(
                    "reaped stale pid file for dead executor %s (pid %d)",
                    eid, pid,
                )

    def adopted_ids(self) -> List[str]:
        """Executor ids adopted from a previous scheduler's fleet (the
        autoscaler folds these into its managed set and desired count)."""
        with self._lock:
            return list(self._adopted)

    def launch(self, spec: ExecutorSpec) -> ExecutorHandle:
        # deterministic failure/cold-start testing:
        # error faults model a fleet API refusal, delay faults a slow
        # provision — both exercised without a flaky real fleet
        fault_point("executor.launch", executor_id=spec.executor_id)
        work_dir = os.path.join(self.work_dir_root, spec.executor_id)
        os.makedirs(work_dir, exist_ok=True)
        args = [
            sys.executable,
            "-m",
            "arrow_ballista_tpu_torch.executor",
            "--scheduler-host", self.scheduler_host,
            "--scheduler-port", str(self.scheduler_port),
            "--bind-host", "127.0.0.1",
            "--bind-port", "0",
            "--bind-grpc-port", "0",
            "--executor-id", spec.executor_id,
            "--concurrent-tasks", str(spec.task_slots or self.task_slots),
            "--task-scheduling-policy", "push-staged",
            "--work-dir", work_dir,
            "--heartbeat-interval-seconds", str(self.heartbeat_interval_s),
            "--heartbeat-sidecar", "0",
            *self.extra_args,
        ]
        env = {**os.environ, **self.env, **spec.env}
        # the parent may import the package via a sys.path edit (notebook,
        # scratch-dir driver); the child's -m lookup only sees PYTHONPATH,
        # so pin the package root or launches fail rc=1 outside the repo
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        existing = env.get("PYTHONPATH", "")
        if pkg_root not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (
                pkg_root + (os.pathsep + existing if existing else "")
            )
        log_path = os.path.join(work_dir, "launch.log")
        with open(log_path, "ab") as sink:
            proc = subprocess.Popen(  # noqa: S603 - our own binary
                args, stdout=sink, stderr=subprocess.STDOUT, env=env
            )
        with self._lock:
            self._procs[spec.executor_id] = proc
        try:
            # handle persistence: lets a restarted scheduler
            # adopt this child instead of double-launching its capacity
            with open(self._pid_path(spec.executor_id), "w",
                      encoding="utf-8") as f:
                f.write(f"{proc.pid}\n")
        except OSError:
            log.warning("could not persist pid file for %s", spec.executor_id)
        log.info(
            "launched executor %s (pid %d, slots %d)",
            spec.executor_id, proc.pid, spec.task_slots or self.task_slots,
        )
        return ExecutorHandle(spec.executor_id, proc)

    def terminate(self, handle: ExecutorHandle) -> None:
        with self._lock:
            proc = self._procs.pop(handle.executor_id, None)
        self._remove_pid_file(handle.executor_id)
        proc = proc or handle.backend
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.terminate()
        except OSError:
            return

        def _escalate() -> None:
            try:
                proc.wait(TERMINATE_GRACE_S)
            except subprocess.TimeoutExpired:
                try:
                    proc.kill()
                except OSError:
                    pass
            # reap the zombie either way
            try:
                proc.wait(TERMINATE_GRACE_S)
            except Exception:  # noqa: BLE001
                pass

        threading.Thread(
            target=_escalate, name=f"terminate-{handle.executor_id}",
            daemon=True,
        ).start()

    def poll(self) -> Dict[str, Optional[int]]:
        with self._lock:
            procs = dict(self._procs)
        out: Dict[str, Optional[int]] = {}
        for eid, proc in procs.items():
            rc = proc.poll()
            out[eid] = rc
            if rc is not None:
                with self._lock:
                    self._procs.pop(eid, None)
                self._remove_pid_file(eid)
        return out

    def close(self) -> None:
        """Terminate every child still running (scheduler shutdown)."""
        with self._lock:
            procs = dict(self._procs)
            self._procs.clear()
        for eid in procs:
            self._remove_pid_file(eid)
        for proc in procs.values():
            try:
                proc.terminate()
            except OSError:
                continue
        for proc in procs.values():
            try:
                proc.wait(TERMINATE_GRACE_S)
            except Exception:  # noqa: BLE001
                try:
                    proc.kill()
                except OSError:
                    pass


# ----------------------------------------------------------------- policy
@dataclass
class AutoscalerPolicy:
    """The knobs (``ballista.autoscaler.*``), validated through the same
    :class:`BallistaConfig` registry as every other setting."""

    min_executors: int = 1
    max_executors: int = 4
    scale_out_sustain_s: float = 3.0
    scale_in_idle_s: float = 15.0
    cooldown_s: float = 10.0
    launch_timeout_s: float = 60.0
    slo_burn_threshold: float = 0.0  # 0 = burn rate ignored

    @staticmethod
    def from_settings(settings: Dict[str, str]) -> "AutoscalerPolicy":
        cfg = BallistaConfig(dict(settings))  # fail fast on a bad knob
        return AutoscalerPolicy(
            min_executors=cfg._get(AUTOSCALER_MIN_EXECUTORS),
            max_executors=cfg._get(AUTOSCALER_MAX_EXECUTORS),
            scale_out_sustain_s=cfg._get(AUTOSCALER_SCALE_OUT_SUSTAIN_S),
            scale_in_idle_s=cfg._get(AUTOSCALER_SCALE_IN_IDLE_S),
            cooldown_s=cfg._get(AUTOSCALER_COOLDOWN_S),
            launch_timeout_s=cfg._get(AUTOSCALER_LAUNCH_TIMEOUT_S),
            slo_burn_threshold=cfg._get(AUTOSCALER_SLO_BURN_THRESHOLD),
        )

    @staticmethod
    def enabled_in(settings: Optional[Dict[str, str]]) -> bool:
        if not settings:
            return False
        cfg = BallistaConfig(dict(settings))
        return bool(cfg._get(AUTOSCALER_ENABLED))


# phases of one managed executor
LAUNCHING = "launching"
ALIVE = "alive"
DRAINING = "draining"


@dataclass
class _Managed:
    executor_id: str
    phase: str = LAUNCHING
    started_mono: float = 0.0
    drain_started_mono: float = 0.0
    drain_timeout_s: float = 0.0
    handle: Optional[ExecutorHandle] = None
    error: str = ""
    cancelled: bool = False  # timed out before launch() returned
    adopted: bool = False  # orphan re-adopted after a scheduler restart


class Autoscaler:
    """The closed loop.  ``tick()`` rides the scheduler's speculation
    timer thread; provider launches run on detached threads; everything
    that mutates scheduler state goes through the same front doors the
    operator uses (``decommission_executor``, ``executor_lost``)."""

    def __init__(
        self,
        server,  # SchedulerServer (not typed: import cycle)
        provider: ExecutorProvider,
        policy: Optional[AutoscalerPolicy] = None,
    ):
        self.server = server
        self.state = server.state
        self.provider = provider
        self.policy = policy or AutoscalerPolicy()
        self.slots_per_executor = max(1, int(getattr(provider, "task_slots", 1)))
        self._lock = threading.Lock()
        self._managed: Dict[str, _Managed] = {}
        self.desired = max(0, self.policy.min_executors)
        # orphan adoption: children that survived a scheduler
        # crash re-enter the managed set as LAUNCHING — they count
        # against actuation immediately (no double-launch storm while
        # they re-register) and flip ALIVE on their next heartbeat/
        # registration exactly like a fresh launch.  ``desired`` is
        # re-derived from the adopted fleet so the first tick neither
        # drains nor duplicates surviving capacity.
        adopted = []
        getter = getattr(provider, "adopted_ids", None)
        if callable(getter):
            try:
                adopted = list(getter())
            except Exception:  # noqa: BLE001 - provider may be sick
                log.exception("adopted_ids() failed; adopting nothing")
        if adopted:
            now = time.monotonic()
            for eid in adopted:
                self._managed[eid] = _Managed(
                    executor_id=eid,
                    phase=LAUNCHING,
                    started_mono=now,
                    handle=ExecutorHandle(eid),
                    adopted=True,
                )
            self.desired = min(
                self.policy.max_executors,
                max(self.policy.min_executors, len(adopted)),
            )
            log.info(
                "adopted %d surviving executor(s) %s; desired=%d",
                len(adopted), sorted(adopted), self.desired,
            )
            self.state.events.emit(
                "autoscale_decision",
                action="adopt",
                executors=sorted(adopted),
                desired=self.desired,
            )
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_scale_out = float("-inf")
        self._last_scale_in = float("-inf")
        self._consecutive_launch_failures = 0
        self._backoff_until = 0.0
        self._closed = False
        self._register_gauges()

    # ------------------------------------------------------------- gauges
    def _register_gauges(self) -> None:
        m = self.state.metrics
        m.gauge(
            "autoscaler_desired_executors",
            "the policy's current total-alive-executor target",
            fn=lambda: self.desired,
        )
        m.gauge(
            "autoscaler_alive_executors",
            "provider-managed executors registered and heartbeating",
            fn=lambda: self._count_phase(ALIVE),
        )
        m.gauge(
            "autoscaler_launching_executors",
            "provider launches started but not yet registered",
            fn=lambda: self._count_phase(LAUNCHING),
        )
        m.gauge(
            "autoscaler_draining_executors",
            "managed executors retiring through the drain path",
            fn=lambda: self._count_phase(DRAINING),
        )

    def _count_phase(self, phase: str) -> int:
        with self._lock:
            return sum(1 for r in self._managed.values() if r.phase == phase)

    # ----------------------------------------------------------- the tick
    def tick(self, now: Optional[float] = None) -> None:
        """One control-loop iteration.  Exceptions are contained (the
        timer thread wraps us too): a sick provider degrades the loop to
        a no-op, never the scheduler."""
        if self._closed:
            return
        now = time.monotonic() if now is None else now
        try:
            self._reconcile(now)
        except Exception:  # noqa: BLE001 - loop robustness over precision
            log.exception("autoscaler reconcile failed")
        try:
            self._decide(now)
        except Exception:  # noqa: BLE001
            log.exception("autoscaler decision failed")
        try:
            self._actuate(now)
        except Exception:  # noqa: BLE001
            log.exception("autoscaler actuation failed")

    # -------------------------------------------------------- reconcile
    def _reconcile(self, now: float) -> None:
        em = self.state.executor_manager
        alive = em.get_alive_executors()
        with self._lock:
            records = list(self._managed.values())

        for rec in records:
            if rec.phase != LAUNCHING:
                continue
            if rec.error:
                self._launch_failed(rec, rec.error)
                continue
            if rec.executor_id in alive:
                with self._lock:
                    rec.phase = ALIVE
                self._consecutive_launch_failures = 0
                em.record_launch_success(rec.executor_id)
                self.state.events.emit(
                    "executor_launched",
                    executor=rec.executor_id,
                    wait_s=round(now - rec.started_mono, 3),
                    adopted=rec.adopted,
                )
                log.info(
                    "executor %s registered %.1fs after launch",
                    rec.executor_id, now - rec.started_mono,
                )
                continue
            if now - rec.started_mono > self.policy.launch_timeout_s:
                rec.cancelled = True
                if rec.handle is not None:
                    self._safe_terminate(rec.handle)
                self._launch_failed(
                    rec,
                    f"launch timed out after {self.policy.launch_timeout_s:.0f}s",
                )

        # child process liveness: a crash is capacity loss; a draining
        # child's exit concludes its retirement
        try:
            statuses = self.provider.poll()
        except Exception as e:  # noqa: BLE001 - provider may be sick
            log.warning("provider poll failed: %s", e)
            statuses = {}
        for eid, rc in statuses.items():
            if rc is None:
                continue
            with self._lock:
                rec = self._managed.get(eid)
            if rec is None or rec.phase == LAUNCHING:
                # LAUNCHING exits are handled by the timeout/registration
                # race above next tick (the registration can still be in
                # flight when a fast child dies)
                if rec is not None:
                    rec.error = rec.error or f"process exited rc={rc}"
                continue
            if rec.phase == DRAINING or em.is_dead_executor(eid):
                self._retire(rec, rc, now)
            else:
                self._crashed(rec, rc)

        # a draining child that neither exited nor was declared lost gets
        # its process reaped once well past the drain budget
        for rec in records:
            if rec.phase != DRAINING or rec.handle is None:
                continue
            overdue = rec.drain_timeout_s + DRAIN_KILL_GRACE_S
            if now - rec.drain_started_mono > overdue:
                log.warning(
                    "draining executor %s still running %.0fs past its "
                    "budget; terminating the process", rec.executor_id,
                    now - rec.drain_started_mono - rec.drain_timeout_s,
                )
                self._safe_terminate(rec.handle)

    def _launch_failed(self, rec: _Managed, error: str) -> None:
        with self._lock:
            self._managed.pop(rec.executor_id, None)
        self._consecutive_launch_failures += 1
        # the existing consecutive-launch-failure machinery sees provider
        # failures exactly like LaunchTask failures (journal + quarantine
        # accounting); expulsion is moot for a never-registered id
        em = self.state.executor_manager
        em.record_launch_failure(rec.executor_id)
        em.take_pending_expulsions()  # never-registered: nothing to expel
        threshold = max(1, em.launch_failure_threshold)
        self.state.events.emit(
            "autoscale_decision",
            action="launch_failed",
            executor=rec.executor_id,
            error=error[:300],
            consecutive_failures=self._consecutive_launch_failures,
        )
        log.warning(
            "executor launch %s failed (%d consecutive): %s",
            rec.executor_id, self._consecutive_launch_failures, error,
        )
        if self._consecutive_launch_failures >= threshold:
            backoff = em.quarantine_backoff_s
            self._backoff_until = time.monotonic() + backoff
            self.state.events.emit(
                "autoscale_decision",
                action="launch_backoff",
                backoff_s=backoff,
                consecutive_failures=self._consecutive_launch_failures,
            )
            log.warning(
                "%d consecutive launch failures; suspending launches %.0fs",
                self._consecutive_launch_failures, backoff,
            )

    def _retire(self, rec: _Managed, rc: Optional[int], now: float) -> None:
        with self._lock:
            self._managed.pop(rec.executor_id, None)
        self.state.events.emit(
            "executor_retired",
            executor=rec.executor_id,
            drain_s=round(now - rec.drain_started_mono, 3)
            if rec.drain_started_mono else None,
            exit_code=rc,
        )
        log.info("executor %s retired (rc=%s)", rec.executor_id, rc)

    def _crashed(self, rec: _Managed, rc: Optional[int]) -> None:
        with self._lock:
            self._managed.pop(rec.executor_id, None)
        self.state.events.emit(
            "autoscale_decision",
            action="capacity_lost",
            executor=rec.executor_id,
            exit_code=rc,
        )
        log.warning(
            "managed executor %s exited unexpectedly (rc=%s); reporting "
            "loss and healing", rec.executor_id, rc,
        )
        # same front door as heartbeat expiry: rollback/re-point runs on
        # the event loop; the next actuation relaunches toward desired
        self.server.executor_lost(
            rec.executor_id, "executor process exited (autoscaler poll)"
        )

    def _safe_terminate(self, handle: ExecutorHandle) -> None:
        try:
            self.provider.terminate(handle)
        except Exception as e:  # noqa: BLE001
            log.warning("provider terminate(%s) failed: %s",
                        handle.executor_id, e)

    # ----------------------------------------------------------- decision
    def signals(self) -> Dict[str, float]:
        """The measured inputs, one read per tick (also the /api surface)."""
        state = self.state
        pending, running = state.task_manager.task_counts()
        em = state.executor_manager
        alive = em.get_alive_executors()
        draining = set(em.draining_executors())
        return {
            "queued_jobs": state.admission.queued_count(),
            "pending_tasks": pending,
            "running_tasks": running,
            "available_slots": em.available_slots(),
            "alive_total": len(alive),
            "alive_effective": len(alive - draining),
            "slo_burn_rate": state.slo.burn_rate(),
        }

    def _decide(self, now: float) -> None:
        p = self.policy
        sig = self.signals()
        deficit_slots = (
            max(0, sig["pending_tasks"] - sig["available_slots"])
            + sig["queued_jobs"]
        )
        burning = (
            p.slo_burn_threshold > 0
            and sig["slo_burn_rate"] >= p.slo_burn_threshold
        )
        pressure = deficit_slots > 0 or burning
        effective = int(sig["alive_effective"])
        launching = self._count_phase(LAUNCHING)

        if pressure:
            self._idle_since = None
            if self._pressure_since is None:
                self._pressure_since = now
            sustained_s = now - self._pressure_since
            if (
                sustained_s >= p.scale_out_sustain_s
                and now - self._last_scale_out >= p.cooldown_s
                and effective + launching < p.max_executors
            ):
                want = effective + launching + max(
                    1, math.ceil(deficit_slots / self.slots_per_executor)
                )
                target = min(p.max_executors, max(want, p.min_executors))
                if target > self.desired:
                    self._last_scale_out = now
                    self.desired = target
                    self.state.events.emit(
                        "autoscale_decision",
                        action="scale_out",
                        desired=self.desired,
                        scheduling_delay_s=round(sustained_s, 3),
                        deficit_slots=deficit_slots,
                        queued_jobs=sig["queued_jobs"],
                        slo_burn_rate=round(sig["slo_burn_rate"], 4),
                    )
                    log.info(
                        "scale-out: desired=%d (deficit %d slots, pressure "
                        "sustained %.1fs, burn %.2f)", self.desired,
                        deficit_slots, sustained_s, sig["slo_burn_rate"],
                    )
            return

        self._pressure_since = None
        idle = (
            sig["running_tasks"] == 0
            and sig["pending_tasks"] == 0
            and sig["queued_jobs"] == 0
        )
        if not idle:
            self._idle_since = None
            return
        if self._idle_since is None:
            self._idle_since = now
        idle_s = now - self._idle_since
        if (
            idle_s >= p.scale_in_idle_s
            and now - self._last_scale_in >= p.cooldown_s
            and effective > p.min_executors
            and self.desired > p.min_executors
        ):
            victim, unreplicated = self._pick_victim()
            if victim is None:
                return
            self._last_scale_in = now
            self.desired = max(p.min_executors, self.desired - 1)
            timeout = self.server.drain_timeout_s
            with self._lock:
                rec = self._managed.get(victim)
                if rec is not None:
                    rec.phase = DRAINING
                    rec.drain_started_mono = now
                    rec.drain_timeout_s = timeout
            self.state.events.emit(
                "autoscale_decision",
                action="scale_in",
                desired=self.desired,
                victim=victim,
                idle_s=round(idle_s, 3),
                unreplicated_bytes=unreplicated,
            )
            log.info(
                "scale-in: desired=%d, draining %s (%d un-replicated "
                "bytes, idle %.1fs)", self.desired, victim, unreplicated,
                idle_s,
            )
            self.server.decommission_executor(
                victim, reason="autoscaler scale-in", timeout_s=timeout
            )

    def _pick_victim(self) -> "tuple[Optional[str], int]":
        """Cheapest managed executor to retire: fewest un-replicated
        shuffle bytes still referenced by active jobs (those are what a
        drain must upload); ties break toward the newest launch so
        long-lived executors keep their warm caches."""
        em = self.state.executor_manager
        alive = em.get_alive_executors()
        with self._lock:
            candidates = [
                r for r in self._managed.values()
                if r.phase == ALIVE and r.executor_id in alive
                and not em.is_draining(r.executor_id)
            ]
        if not candidates:
            return None, 0
        by_executor = self.state.task_manager.unreplicated_shuffle_bytes()
        rec = min(
            candidates,
            key=lambda r: (by_executor.get(r.executor_id, 0), -r.started_mono),
        )
        return rec.executor_id, by_executor.get(rec.executor_id, 0)

    # ---------------------------------------------------------- actuation
    def _actuate(self, now: float) -> None:
        if now < self._backoff_until:
            return
        em = self.state.executor_manager
        alive = em.get_alive_executors()
        draining = set(em.draining_executors())
        effective = len(alive - draining)
        launching = self._count_phase(LAUNCHING)
        want = max(self.desired, self.policy.min_executors)
        while effective + launching < want:
            self._begin_launch(now)
            launching += 1

    def _begin_launch(self, now: float) -> None:
        eid = f"scale-{uuid.uuid4().hex[:10]}"
        rec = _Managed(executor_id=eid, started_mono=now)
        with self._lock:
            self._managed[eid] = rec
        spec = ExecutorSpec(
            executor_id=eid, task_slots=self.slots_per_executor
        )

        def _run() -> None:
            try:
                handle = self.provider.launch(spec)
            except Exception as e:  # noqa: BLE001 - journaled next tick
                rec.error = str(e) or repr(e)
                return
            late = False
            with self._lock:
                rec.handle = handle
                late = rec.cancelled
            if late:
                # launch() returned after the tick timed this attempt
                # out: the capacity was already re-requested, kill the
                # straggling process rather than double-launch
                self._safe_terminate(handle)

        threading.Thread(
            target=_run, name=f"autoscale-launch-{eid}", daemon=True
        ).start()
        log.info("launching executor %s (desired=%d)", eid, self.desired)

    # ------------------------------------------------------------ surface
    def snapshot(self) -> dict:
        """The /api/cluster/health autoscaler block: the provider's view
        (managed handles by phase) next to the policy state, so health
        counts reconcile against what is actually running."""
        with self._lock:
            phases: Dict[str, List[str]] = {}
            for rec in self._managed.values():
                phases.setdefault(rec.phase, []).append(rec.executor_id)
        return {
            "enabled": True,
            "desired": self.desired,
            "alive": len(phases.get(ALIVE, [])),
            "launching": len(phases.get(LAUNCHING, [])),
            "draining": len(phases.get(DRAINING, [])),
            "managed": {k: sorted(v) for k, v in phases.items()},
            "min_executors": self.policy.min_executors,
            "max_executors": self.policy.max_executors,
            "consecutive_launch_failures": self._consecutive_launch_failures,
            "launch_backoff_remaining_s": round(
                max(0.0, self._backoff_until - time.monotonic()), 3
            ),
        }

    def managed_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._managed)

    def scale_out_in_flight(self) -> bool:
        return self._count_phase(LAUNCHING) > 0

    def close(self) -> None:
        """Scheduler shutdown: stop ticking and reap every child (a
        LocalProcessProvider would otherwise leak subprocesses)."""
        self._closed = True
        with self._lock:
            handles = [
                r.handle for r in self._managed.values() if r.handle is not None
            ]
            self._managed.clear()
        for handle in handles:
            self._safe_terminate(handle)
        closer = getattr(self.provider, "close", None)
        if callable(closer):
            try:
                closer()
            except Exception:  # noqa: BLE001
                log.exception("provider close failed")
