"""KEDA external-scaler gRPC service.

Counterpart of the reference's ``scheduler/src/scheduler_server/external_scaler.rs:29-65``:
kubernetes' KEDA operator polls this service to decide how many executor
replicas to run.  Like the reference stub, ``IsActive`` always reports
active and ``GetMetrics`` reports the ``inflight_tasks`` metric pinned high
enough to saturate the HPA (`:47-58` hardcodes 1,000,000); the metric spec
target is 10 per replica.  The one improvement over the stub: when the
scheduler has no active jobs, inflight is reported as 0 so idle clusters
can scale to the minimum.

With the built-in autoscaler enabled (``ballista.autoscaler.enabled``), ``GetMetrics`` instead reports the policy's desired-replica
demand — ``desired × target-per-replica``, so the HPA's division lands
exactly on ``desired`` — and KEDA becomes a mirror of the same decision
the built-in loop is executing rather than a second, competing
controller.  The saturate-the-HPA stub is preserved verbatim when the
autoscaler is off (the KEDA-only deployment mode).
"""

from __future__ import annotations

import grpc

from ..proto import keda_pb

INFLIGHT_TASKS_METRIC_NAME = "inflight_tasks"
MAX_INFLIGHT = 1_000_000
TARGET_PER_REPLICA = 10

_EXTERNAL_SCALER_METHODS = {
    "IsActive": (keda_pb.ScaledObjectRef, keda_pb.IsActiveResponse),
    "GetMetricSpec": (keda_pb.ScaledObjectRef, keda_pb.GetMetricSpecResponse),
    "GetMetrics": (keda_pb.GetMetricsRequest, keda_pb.GetMetricsResponse),
}


class ExternalScalerService:
    def __init__(self, scheduler):
        self.scheduler = scheduler

    def IsActive(self, request, context) -> keda_pb.IsActiveResponse:
        return keda_pb.IsActiveResponse(result=True)

    def GetMetricSpec(self, request, context) -> keda_pb.GetMetricSpecResponse:
        return keda_pb.GetMetricSpecResponse(
            metricSpecs=[
                keda_pb.MetricSpec(
                    metricName=INFLIGHT_TASKS_METRIC_NAME,
                    targetSize=TARGET_PER_REPLICA,
                )
            ]
        )

    def GetMetrics(self, request, context) -> keda_pb.GetMetricsResponse:
        autoscaler = getattr(self.scheduler, "autoscaler", None)
        if autoscaler is not None:
            # built-in loop on: report ITS desired-replica demand so the
            # HPA (value / target) resolves to exactly `desired` — KEDA
            # mirrors the policy instead of fighting it with the
            # saturate-the-HPA stub below
            value = autoscaler.desired * TARGET_PER_REPLICA
        else:
            # jobs held in the admission queue are demand the cluster
            # could not absorb — exactly what an autoscaler must see as
            # inflight (ROADMAP item 2 pairs with the admission front
            # door here)
            active = self.scheduler.state.task_manager.active_job_ids()
            queued = self.scheduler.state.admission.queued_count()
            value = MAX_INFLIGHT if (active or queued) else 0
        return keda_pb.GetMetricsResponse(
            metricValues=[
                keda_pb.MetricValue(
                    metricName=INFLIGHT_TASKS_METRIC_NAME, metricValue=value
                )
            ]
        )


def add_external_scaler_servicer(server: grpc.Server, servicer) -> None:
    handlers = {}
    for name, (req_t, resp_t) in _EXTERNAL_SCALER_METHODS.items():
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (
            grpc.method_handlers_generic_handler(
                "externalscaler.ExternalScaler", handlers
            ),
        )
    )


class ExternalScalerStub:
    """Client stub (for tests / local ops tooling)."""

    def __init__(self, channel: grpc.Channel):
        for name, (req_t, resp_t) in _EXTERNAL_SCALER_METHODS.items():
            setattr(
                self,
                name,
                channel.unary_unary(
                    f"/externalscaler.ExternalScaler/{name}",
                    request_serializer=req_t.SerializeToString,
                    response_deserializer=resp_t.FromString,
                ),
            )
