"""SchedulerGrpc servicer: the nine RPC handlers.

Counterpart of the reference's ``scheduler/src/scheduler_server/grpc.rs``:

* ``PollWork`` (pull mode, `:56-175`) — heartbeat + piggybacked statuses +
  at most one task filled into the polling executor's slot;
* ``RegisterExecutor`` (`:177-233`) — push mode reserves every slot and
  offers them immediately;
* ``HeartBeatFromExecutor`` / ``UpdateTaskStatus`` / ``ExecutorStopped`` /
  ``CancelJob`` (`:235-292`, tail);
* ``GetFileMetadata`` (`:294-345`) — schema inference for parquet/csv;
* ``ExecuteQuery`` (`:347-460`) — session create/update, plan decode, job
  id mint, submit; an empty query only mints a session id (how
  ``BallistaContext::remote`` bootstraps);
* ``GetJobStatus``.
"""

from __future__ import annotations

import json
import logging

import grpc
import pyarrow as pa

from ..config import TaskSchedulingPolicy
from ..proto import pb
from ..serde import BallistaCodec, schema_to_bytes
from ..serde.scheduler_types import ExecutorMetadata, ExecutorSpecification
from .server import SchedulerServer
from .task_status import job_status_to_proto, task_info_from_proto

log = logging.getLogger(__name__)


def _registration_to_metadata(reg: pb.ExecutorRegistration, peer: str) -> ExecutorMetadata:
    """The executor may omit its host; fall back to the connection peer
    (reference: grpc.rs optional_host handling)."""
    host = reg.host if reg.has_host else (peer or "127.0.0.1")
    return ExecutorMetadata(
        id=reg.id,
        host=host,
        flight_port=reg.flight_port,
        grpc_port=reg.grpc_port,
        specification=ExecutorSpecification.from_proto(reg.specification),
    )


def _peer_host(context) -> str:
    try:
        peer = context.peer()  # e.g. "ipv4:127.0.0.1:53210"
        if peer.startswith(("ipv4:", "ipv6:")):
            hostport = peer.split(":", 1)[1]
            return hostport.rsplit(":", 1)[0].strip("[]")
    except Exception:  # noqa: BLE001
        pass
    return ""


class SchedulerGrpcService:
    """Bound to a grpc.Server via proto.rpc.add_scheduler_servicer."""

    def __init__(self, server: SchedulerServer):
        self.server = server

    # ------------------------------------------------------------ pull mode
    def PollWork(self, request: pb.PollWorkParams, context) -> pb.PollWorkResult:
        meta = _registration_to_metadata(request.metadata, _peer_host(context))
        statuses = [task_info_from_proto(s) for s in request.task_status]
        task = self.server.poll_work(meta, request.can_accept_task, statuses)
        result = pb.PollWorkResult()
        if task is not None:
            result.task.CopyFrom(task)
            result.has_task = True
        return result

    # ------------------------------------------------------------ push mode
    def RegisterExecutor(
        self, request: pb.RegisterExecutorParams, context
    ) -> pb.RegisterExecutorResult:
        meta = _registration_to_metadata(request.metadata, _peer_host(context))
        reserve = self.server.policy == TaskSchedulingPolicy.PUSH_STAGED
        reservations = self.server.state.executor_manager.register_executor(
            meta, reserve
        )
        if reservations:
            self.server.offer_reservation(reservations)
        log.info(
            "registered executor %s at %s:%d (%d slots, policy=%s)",
            meta.id,
            meta.host,
            meta.grpc_port or meta.flight_port,
            meta.specification.task_slots,
            self.server.policy.value,
        )
        return pb.RegisterExecutorResult(success=True)

    def HeartBeatFromExecutor(
        self, request: pb.HeartBeatParams, context
    ) -> pb.HeartBeatResult:
        import time

        from .executor_manager import ExecutorHeartbeat

        em = self.server.state.executor_manager
        # a scheduler restarted on a memory backend has heartbeats but no
        # metadata for surviving (adopted) executors: tell them to
        # re-register so slots/endpoints rebuild, instead of silently
        # heartbeating into a registry that can never dispatch to them
        reregister = False
        try:
            em.get_executor_metadata(request.executor_id)
        except Exception:  # noqa: BLE001 - unknown executor
            reregister = True
        em.save_heartbeat(
            ExecutorHeartbeat(request.executor_id, time.time(), "active")
        )
        if request.spans_json:
            from ..obs.recorder import trace_store

            trace_store().add_json(request.spans_json)
        if request.telemetry_json and not em.is_dead_executor(request.executor_id):
            # tolerant: an old executor ships nothing, a broken one may
            # ship garbage — the store counts a parse error and moves on.
            # A removed executor's last beats are dropped: recording them
            # would re-create the rings forget_executor just dropped
            self.server.state.telemetry.record_executor(
                request.executor_id, request.telemetry_json
            )
        return pb.HeartBeatResult(reregister=reregister)

    def UpdateTaskStatus(
        self, request: pb.UpdateTaskStatusParams, context
    ) -> pb.UpdateTaskStatusResult:
        statuses = [task_info_from_proto(s) for s in request.task_status]
        self.server.update_task_status(request.executor_id, statuses)
        return pb.UpdateTaskStatusResult(success=True)

    # ------------------------------------------------------------- queries
    def GetFileMetadata(
        self, request: pb.GetFileMetadataParams, context
    ) -> pb.GetFileMetadataResult:
        ft = (request.file_type or "parquet").lower()
        if ft == "parquet":
            import pyarrow.parquet as pq

            schema = pq.read_schema(request.path)
        elif ft == "csv":
            import pyarrow.csv as pcsv

            reader = pcsv.open_csv(request.path)
            schema = reader.schema
        else:
            context.abort(
                __import__("grpc").StatusCode.INVALID_ARGUMENT,
                f"unsupported file type {ft!r}",
            )
            return pb.GetFileMetadataResult()
        return pb.GetFileMetadataResult(schema=schema_to_bytes(schema))

    def ExecuteQuery(
        self, request: pb.ExecuteQueryParams, context
    ) -> pb.ExecuteQueryResult:
        settings = {kv.key: kv.value for kv in request.settings}
        sm = self.server.state.session_manager
        if request.session_id:
            session_ctx = sm.update_session(request.session_id, settings)
        else:
            session_ctx = sm.create_session(settings)

        which = request.WhichOneof("query")
        if which is None:
            # session-bootstrap call (reference: client context.rs:103-119)
            return pb.ExecuteQueryResult(
                job_id="", session_id=session_ctx.session_id
            )
        if which == "logical_plan":
            plan = BallistaCodec.decode_logical(request.logical_plan)
        else:
            plan = session_ctx.sql(request.sql).logical_plan()

        token = request.idempotency_token
        if token:
            # a retried submit (client failover) re-attaches to
            # the job its first attempt already created instead of
            # double-running it; the check-then-mint runs under a token-
            # scoped backend lock so two racing retries agree on one id
            from .backend import Keyspace
            from .queue_wal import lookup_token, record_token, token_key

            backend = self.server.state.backend
            with backend.lock(Keyspace.QueueWal, token_key(token)):
                prior = lookup_token(backend, token)
                if prior is not None:
                    log.info(
                        "deduplicated resubmit of job %s (token %s)",
                        prior, token,
                    )
                    return pb.ExecuteQueryResult(
                        job_id=prior, session_id=session_ctx.session_id
                    )
                job_id = self.server.state.task_manager.generate_job_id()
                record_token(backend, token, job_id)
            self._maybe_purge_tokens()
        else:
            job_id = self.server.state.task_manager.generate_job_id()
        self.server.submit_job(job_id, session_ctx.session_id, plan)
        log.info("queued job %s (session %s)", job_id, session_ctx.session_id)
        return pb.ExecuteQueryResult(
            job_id=job_id, session_id=session_ctx.session_id
        )

    _token_submits = 0

    def _maybe_purge_tokens(self) -> None:
        """Opportunistic TTL sweep of idempotency tokens — every ~100
        tokened submits, so the keyspace cannot grow unbounded."""
        self._token_submits += 1
        if self._token_submits % 100:
            return
        from .queue_wal import purge_stale_tokens

        try:
            purge_stale_tokens(self.server.state.backend)
        except Exception:  # noqa: BLE001 - sweep must not fail a submit
            log.warning("idempotency-token purge failed", exc_info=True)

    def GetShuffleLocationDelta(
        self, request: pb.ShuffleLocationDeltaParams, context
    ) -> pb.ShuffleLocationDelta:
        """Streaming pipelined execution: pull-mode executors
        poll the per-producer shuffle-location feed for their tailing
        consumer tasks (push mode gets the same deltas proactively via
        UpdateShuffleLocations)."""
        d = self.server.state.task_manager.get_shuffle_location_delta(
            request.job_id, request.stage_id, request.from_index
        )
        resp = pb.ShuffleLocationDelta(
            job_id=request.job_id,
            stage_id=request.stage_id,
            from_index=d["from_index"],
            complete=d["complete"],
            valid=d["valid"],
            epoch=d["epoch"],
        )
        for loc in d["locations"]:
            resp.locations.add().CopyFrom(loc.to_proto())
        return resp

    def GetJobStatus(
        self, request: pb.GetJobStatusParams, context
    ) -> pb.GetJobStatusResult:
        tm = self.server.state.task_manager
        status = tm.get_job_status(request.job_id)
        result = pb.GetJobStatusResult()
        if status is None:
            # unknown job: surface as queued (it may still be planning)
            result.status.queued.SetInParent()
        else:
            result.status.CopyFrom(job_status_to_proto(status))
        if request.include_progress and status is not None:
            # live progress piggybacks on the poll the client already
            # pays for (query doctor)
            progress = tm.get_job_progress(request.job_id)
            if progress is not None:
                result.progress_json = json.dumps(
                    progress, default=str
                ).encode()
        if request.include_profile and status is not None:
            report = self._job_report(request.job_id)
            if report is not None:
                result.profile_json = json.dumps(
                    report, default=str
                ).encode()
        return result

    def _job_report(self, job_id: str) -> dict | None:
        """Diagnosis bundle for ``include_profile`` — the same
        ``obs.doctor.job_report`` the REST profile/critical_path routes
        serve, so explain_analyze reads identical numbers."""
        from ..obs.doctor import job_report
        from ..obs.recorder import spans_for_job

        detail = self.server.state.task_manager.get_job_detail(job_id)
        if detail is None or "stages" not in detail:
            return None
        journal = self.server.state.events
        events = journal.for_job(job_id) if journal.enabled else []
        return job_report(
            detail, spans_for_job(job_id), events,
            cluster=self.server.doctor_cluster_context(),
        )

    # ------------------------------------------------------------ lifecycle
    def ExecutorStopped(
        self, request: pb.ExecutorStoppedParams, context
    ) -> pb.ExecutorStoppedResult:
        log.info(
            "executor %s stopped: %s", request.executor_id, request.reason
        )
        self.server.executor_lost(request.executor_id, request.reason)
        return pb.ExecutorStoppedResult()

    def CancelJob(self, request: pb.CancelJobParams, context) -> pb.CancelJobResult:
        self.server.cancel_job(request.job_id)
        return pb.CancelJobResult(cancelled=True)

    def DecommissionExecutor(
        self, request: pb.ExecutorStoppedParams, context
    ) -> pb.ExecutorStoppedResult:
        """Graceful decommission: operator-initiated drain —
        reuses the ExecutorStopped message shapes on the wire."""
        ok = self.server.decommission_executor(
            request.executor_id,
            request.reason or "decommissioned by operator",
        )
        if not ok:
            # an unknown id must not look like a successful drain: the
            # operator would terminate the instance believing its shuffle
            # data was uploaded
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"unknown executor {request.executor_id!r}",
            )
        return pb.ExecutorStoppedResult()
