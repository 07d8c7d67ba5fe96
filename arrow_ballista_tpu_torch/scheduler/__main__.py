"""Scheduler process binary: ``python -m arrow_ballista_tpu_torch.scheduler``.

Counterpart of the reference's ``scheduler/src/main.rs:70-243`` +
``scheduler_config_spec.toml:23-102``.  Config precedence mirrors
configure_me: defaults < ``--config-file`` (TOML) < ``BALLISTA_SCHEDULER_*``
env vars < CLI flags.  One gRPC server carries both the SchedulerGrpc and
the KEDA ExternalScaler services (the reference muxes them on one hyper
server); REST serves on its own port (grpcio owns its socket, so
Accept-header muxing isn't possible — documented divergence), and the
FlightSQL front-end is opt-in like the reference's ``flight-sql`` feature.

The port's scheduler only plans, so it needs no CUDA device.  Its REST
API and FlightSQL front-end are not ported yet: ``--rest-port`` defaults
to 0 (off) here, and asking for either exits with an error.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import time


CONFIG_KEYS = {
    # key: (type, default, help)
    "bind_host": (str, "0.0.0.0", "local address to bind"),
    "external_host": (str, "", "address advertised to executors as curator"),
    "bind_port": (int, 50050, "scheduler gRPC port"),
    "rest_port": (int, 0, "REST API port (0 = disabled; the port has no REST API yet)"),
    "flight_sql_port": (int, 0, "FlightSQL port (0 = disabled; the port has no FlightSQL yet)"),
    "scheduler_policy": (str, "pull-staged", "pull-staged | push-staged"),
    "config_backend": (str, "memory", "memory | sqlite | etcd"),
    "db_path": (str, "", "sqlite db path (config_backend=sqlite)"),
    "etcd_urls": (str, "localhost:2379", "etcd endpoints (config_backend=etcd)"),
    "namespace": (str, "ballista", "state key namespace"),
    "work_dir": (str, "", "scratch dir for plans (default: a fresh directory under TMPDIR)"),
    "plugin_dir": (str, "", "directory of UDF plugin .py modules"),
    "executor_timeout_seconds": (int, 180, "expire executors after this"),
    "quarantine_threshold": (int, 5, "failures in-window that quarantine an executor; 0 disables"),
    "quarantine_window_seconds": (float, 60.0, "sliding window for the per-executor failure count"),
    "quarantine_backoff_seconds": (float, 30.0, "reservation exclusion period for quarantined executors"),
    "speculation_enabled": (int, 0, "1 = speculatively re-run stragglers for every session (sessions can also opt in via ballista.speculation.enabled)"),
    "speculation_interval_seconds": (float, 1.0, "period of the straggler/deadline scan on the event loop"),
    "task_timeout_seconds": (float, 0.0, "reap running tasks older than this for every session (0 = off; sessions can set ballista.task.timeout_seconds)"),
    "drain_timeout_seconds": (float, 30.0, "graceful-decommission budget handed to a draining executor (DecommissionExecutor RPC / POST /api/executors/{id}/decommission)"),
    "aqe_enabled": (int, 0, "1 = adaptive query execution (re-plan stages from observed shuffle stats) as the cluster-wide default; an explicit session ballista.aqe.* setting wins"),
    "admission_enabled": (int, 0, "1 = multi-tenant admission control (queue, weighted fair release, ClusterSaturated shed) as the cluster-wide default; an explicit session ballista.admission.* setting wins unless pinned via --admission-defaults"),
    "admission_defaults": (str, "", "comma-separated ballista.admission.* key=value pairs PINNED cluster-wide (e.g. 'ballista.admission.max_queued_jobs=200,ballista.admission.shed_policy=oldest'); pinned limits ignore session settings so no tenant can rewrite another tenant's gates"),
    "admission_wal_enabled": (int, 0, "1 = journal queued admission jobs + cancel intents through the state backend so a restarted (or adopting) scheduler re-enqueues them in submit order; durability follows the backend (sqlite/etcd survive process death)"),
    "cache_enabled": (int, 0, "1 = plan-fingerprint result/shuffle cache (serve repeat subplans from the external store without re-running their stages) as the cluster-wide default; an explicit session ballista.cache.* setting wins"),
    "cache_policy_enabled": (int, 0, "1 = learned per-plan policy (merge measured knob overrides beneath explicit session settings on repeat submissions) as the cluster-wide default"),
    "cache_settings": (str, "", "comma-separated ballista.cache.* key=value pairs seeded cluster-wide (e.g. 'ballista.cache.max_bytes=268435456,ballista.cache.ttl_seconds=600')"),
    "obs_enabled": (int, 0, "1 = trace every session's jobs even without ballista.obs.enabled"),
    "event_journal_dir": (str, "", "directory for the append-only structured event journal (empty = disabled; see /api/jobs/{id}/events and /api/events/tail)"),
    "event_journal_rotate_bytes": (int, 4 << 20, "rotate the active journal segment past this size"),
    "event_journal_segments": (int, 4, "rotated journal segments kept before the oldest is deleted"),
    "telemetry_sample_seconds": (float, 5.0, "period of the cluster-aggregate telemetry sample (queue depth, slots, shuffle backlog) feeding /api/cluster/timeseries"),
    "autoscaler_enabled": (int, 0, "1 = closed-loop executor autoscaling: launch on sustained slot deficit / queued jobs / SLO burn, drain on sustained idle, heal crashed children (see docs/user-guide/autoscaling.md)"),
    "autoscaler_settings": (str, "", "comma-separated ballista.autoscaler.* key=value pairs for the policy (e.g. 'ballista.autoscaler.min_executors=1,ballista.autoscaler.max_executors=8')"),
    "autoscaler_executor_slots": (int, 2, "task slots per autoscaler-launched executor (sizes the slot-deficit math)"),
    "autoscaler_work_dir": (str, "", "work-dir root for autoscaler-launched executors (default: a fresh temp dir); a RESTARTED scheduler pointed at the same directory adopts surviving children via their persisted pid files instead of launching a duplicate fleet"),
    "autoscaler_heartbeat_seconds": (float, 5.0, "heartbeat interval passed to autoscaler-launched executors (must be comfortably below --executor-timeout-seconds)"),
    "log_level_setting": (str, "INFO", "log filter"),
    "log_dir": (str, "", "write logs to a file here instead of stdout"),
    "log_file_name_prefix": (str, "scheduler", "log file prefix"),
}


def load_config(argv=None) -> dict:
    cfg = {k: v[1] for k, v in CONFIG_KEYS.items()}

    ap = argparse.ArgumentParser("ballista-tpu scheduler")
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
        env = os.environ.get(f"BALLISTA_SCHEDULER_{k.upper()}")
        if env is not None:
            cfg[k] = CONFIG_KEYS[k][0](env)
    for k in CONFIG_KEYS:
        v = getattr(args, k, None)
        if v is not None:
            cfg[k] = v
    return cfg


def init_logging(cfg: dict, prefix_key: str = "log_file_name_prefix") -> None:
    """Mirror of both binaries' tracing init (scheduler main.rs:173-194)."""
    level = getattr(logging, cfg["log_level_setting"].upper(), logging.INFO)
    handlers = None
    if cfg["log_dir"]:
        os.makedirs(cfg["log_dir"], exist_ok=True)
        stamp = time.strftime("%Y-%m-%d")
        path = os.path.join(cfg["log_dir"], f"{cfg[prefix_key]}.{stamp}.log")
        handlers = [logging.FileHandler(path)]
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(threadName)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )


def _parse_admission_defaults(raw: str) -> dict:
    """``k=v,k=v`` → dict of operator-pinned ballista.admission.* keys;
    validation (key names, value types) happens in SchedulerState."""
    out = {}
    for pair in (raw or "").split(","):
        pair = pair.strip()
        if not pair:
            continue
        key, sep, value = pair.partition("=")
        if not sep:
            raise SystemExit(
                f"--admission-defaults entry {pair!r} is not key=value"
            )
        out[key.strip()] = value.strip()
    return out


def make_backend(cfg: dict):
    from .backend import EtcdBackend, MemoryBackend, SqliteBackend

    kind = cfg["config_backend"].lower()
    if kind == "memory":
        return MemoryBackend()
    if kind == "sqlite":
        path = cfg["db_path"] or os.path.join(cfg["work_dir"], "scheduler.db")
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        return SqliteBackend(path)
    if kind == "etcd":
        return EtcdBackend(cfg["etcd_urls"], cfg["namespace"])
    raise SystemExit(f"unknown config backend {kind!r}")


def main(argv=None) -> None:
    cfg = load_config(argv)
    for key in ("rest_port", "flight_sql_port"):
        if cfg[key]:
            raise SystemExit(f"--{key.replace('_', '-')}: not ported to this package yet")
    if not cfg["work_dir"]:
        import tempfile

        cfg["work_dir"] = tempfile.mkdtemp(prefix="ballista-scheduler-")
    init_logging(cfg)
    log = logging.getLogger("ballista.scheduler")

    from ..config import TaskSchedulingPolicy
    from ..proto.rpc import add_scheduler_servicer, make_server
    from .external_scaler import ExternalScalerService, add_external_scaler_servicer
    from .grpc_service import SchedulerGrpcService
    from .server import SchedulerServer

    if cfg["plugin_dir"]:
        from ..udf import load_udf_plugins

        n = load_udf_plugins(cfg["plugin_dir"])
        log.info("loaded %d UDF plugin(s) from %s", n, cfg["plugin_dir"])

    policy = (
        TaskSchedulingPolicy.PUSH_STAGED
        if cfg["scheduler_policy"] == "push-staged"
        else TaskSchedulingPolicy.PULL_STAGED
    )
    if cfg["obs_enabled"]:
        from ..obs import get_recorder, trace, trace_store

        trace.configure(enabled=True, process="scheduler")
        get_recorder().set_forward(trace_store().add)
        log.info("observability forced on (--obs-enabled)")

    backend = make_backend(cfg)
    # the curator address executors dial back: must be reachable, never
    # the 0.0.0.0 wildcard.  It is also the STABLE scheduler identity —
    # fixed before init() so the first liveness heartbeat, active-job
    # recovery and admission-WAL replay all run under the same id a
    # previous incarnation used (a uuid-suffixed id would strand its
    # heartbeats and WAL entries every restart).
    external = cfg["external_host"] or cfg["bind_host"]
    if external == "0.0.0.0":
        external = "127.0.0.1"
    scheduler_id = f"{external}:{cfg['bind_port']}"
    server = SchedulerServer(
        scheduler_id,
        backend,
        policy,
        work_dir=cfg["work_dir"],
        executor_timeout_s=cfg["executor_timeout_seconds"],
        quarantine_threshold=cfg["quarantine_threshold"],
        quarantine_window_s=cfg["quarantine_window_seconds"],
        quarantine_backoff_s=cfg["quarantine_backoff_seconds"],
        speculation_interval_s=cfg["speculation_interval_seconds"],
        speculation_force_enabled=bool(cfg["speculation_enabled"]),
        task_timeout_force_s=cfg["task_timeout_seconds"],
        aqe_force_enabled=bool(cfg["aqe_enabled"]),
        admission_force_enabled=bool(cfg["admission_enabled"]),
        admission_defaults=_parse_admission_defaults(cfg["admission_defaults"]),
        admission_wal_enabled=bool(cfg["admission_wal_enabled"]),
        cache_force_enabled=bool(cfg["cache_enabled"]),
        cache_policy_force_enabled=bool(cfg["cache_policy_enabled"]),
        cache_settings=_parse_admission_defaults(cfg["cache_settings"]),
        drain_timeout_s=cfg["drain_timeout_seconds"],
        telemetry_sample_s=cfg["telemetry_sample_seconds"],
        event_journal_dir=cfg["event_journal_dir"],
        event_journal_rotate_bytes=cfg["event_journal_rotate_bytes"],
        event_journal_segments=cfg["event_journal_segments"],
    ).init()

    # elastic lifecycle: the flag (or an explicit settings key) turns the
    # loop on; the subprocess provider launches executors that dial the
    # advertised curator address
    autoscaler_settings = _parse_admission_defaults(cfg["autoscaler_settings"])
    if cfg["autoscaler_enabled"]:
        autoscaler_settings.setdefault("ballista.autoscaler.enabled", "true")
    from .autoscaler import AutoscalerPolicy

    if AutoscalerPolicy.enabled_in(autoscaler_settings):
        from .autoscaler import LocalProcessProvider

        provider = LocalProcessProvider(
            external,
            cfg["bind_port"],
            task_slots=cfg["autoscaler_executor_slots"],
            work_dir_root=cfg["autoscaler_work_dir"],
            heartbeat_interval_s=cfg["autoscaler_heartbeat_seconds"],
        )
        server.attach_autoscaler(provider, autoscaler_settings)
        log.info(
            "autoscaler enabled: %s", server.autoscaler.snapshot(),
        )

    grpc_server = make_server()
    add_scheduler_servicer(grpc_server, SchedulerGrpcService(server))
    add_external_scaler_servicer(grpc_server, ExternalScalerService(server))
    bound = grpc_server.add_insecure_port(f"{cfg['bind_host']}:{cfg['bind_port']}")
    if bound == 0:
        raise SystemExit(f"cannot bind {cfg['bind_host']}:{cfg['bind_port']}")
    grpc_server.start()
    log.info("scheduler gRPC (+KEDA scaler) on %s:%d, policy=%s, backend=%s",
             cfg["bind_host"], bound, policy.value, cfg["config_backend"])

    stop = {"flag": False}

    def on_signal(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    try:
        while not stop["flag"]:
            time.sleep(0.5)
    finally:
        log.info("shutting down")
        grpc_server.stop(grace=2)
        server.stop()


if __name__ == "__main__":
    main()
