"""Hand-written gRPC bindings for the two services.

The environment has grpcio but not grpcio-tools, so the client stubs and
server registration helpers the protoc grpc plugin would emit are written
by hand here.  Service/method paths follow proto conventions
(``/ballista_tpu.SchedulerGrpc/PollWork`` etc.), so the wire format is
exactly what generated stubs would produce.

Reference service definitions: ``core/proto/ballista.proto:852-882``
(SchedulerGrpc 9 RPCs, ExecutorGrpc 3 RPCs).
"""

from __future__ import annotations

import threading

import grpc

from . import pb

_SCHEDULER_METHODS = {
    "PollWork": (pb.PollWorkParams, pb.PollWorkResult),
    "RegisterExecutor": (pb.RegisterExecutorParams, pb.RegisterExecutorResult),
    "HeartBeatFromExecutor": (pb.HeartBeatParams, pb.HeartBeatResult),
    "UpdateTaskStatus": (pb.UpdateTaskStatusParams, pb.UpdateTaskStatusResult),
    "GetFileMetadata": (pb.GetFileMetadataParams, pb.GetFileMetadataResult),
    "ExecuteQuery": (pb.ExecuteQueryParams, pb.ExecuteQueryResult),
    "GetJobStatus": (pb.GetJobStatusParams, pb.GetJobStatusResult),
    "ExecutorStopped": (pb.ExecutorStoppedParams, pb.ExecutorStoppedResult),
    "CancelJob": (pb.CancelJobParams, pb.CancelJobResult),
    # graceful decommission: same message shapes as
    # ExecutorStopped — executor_id + reason in, empty ack out
    "DecommissionExecutor": (pb.ExecutorStoppedParams, pb.ExecutorStoppedResult),
    # streaming pipelined execution: pull-mode executors poll
    # the scheduler's shuffle-location feed for their tailing tasks
    "GetShuffleLocationDelta": (
        pb.ShuffleLocationDeltaParams, pb.ShuffleLocationDelta,
    ),
}

_EXECUTOR_METHODS = {
    "LaunchTask": (pb.LaunchTaskParams, pb.LaunchTaskResult),
    "StopExecutor": (pb.StopExecutorParams, pb.StopExecutorResult),
    "CancelTasks": (pb.CancelTasksParams, pb.CancelTasksResult),
    # streaming pipelined execution: push-mode feed deltas
    "UpdateShuffleLocations": (
        pb.UpdateShuffleLocationsParams, pb.UpdateShuffleLocationsResult,
    ),
}

_KV_METHODS = {
    "Get": (pb.KvGetParams, pb.KvGetResult),
    "GetFromPrefix": (pb.KvScanParams, pb.KvScanResult),
    "Scan": (pb.KvScanParams, pb.KvScanResult),
    "Put": (pb.KvPutParams, pb.KvPutResult),
    "PutTxn": (pb.KvTxnParams, pb.KvTxnResult),
    "Mv": (pb.KvMvParams, pb.KvMvResult),
    "Delete": (pb.KvDeleteParams, pb.KvDeleteResult),
    "Lock": (pb.KvLockParams, pb.KvLockResult),
    "Unlock": (pb.KvUnlockParams, pb.KvUnlockResult),
}
# server-streaming: handled separately from the unary table
_KV_STREAM_METHODS = {
    "Watch": (pb.KvWatchParams, pb.KvWatchEvent),
}

# Tuned channel options (reference: core/src/utils.rs:318-345 keepalive /
# nodelay / 20s connect timeout).
GRPC_OPTIONS = [
    ("grpc.keepalive_time_ms", 10_000),
    ("grpc.keepalive_timeout_ms", 20_000),
    ("grpc.keepalive_permit_without_calls", 1),
    ("grpc.http2.max_pings_without_data", 0),
    ("grpc.max_receive_message_length", 256 * 1024 * 1024),
    ("grpc.max_send_message_length", 256 * 1024 * 1024),
]


class _Stub:
    """Builds a unary-unary callable per method on a channel."""

    def __init__(self, channel: grpc.Channel, service: str, methods: dict):
        for name, (req_t, resp_t) in methods.items():
            setattr(
                self,
                name,
                channel.unary_unary(
                    f"/ballista_tpu.{service}/{name}",
                    request_serializer=req_t.SerializeToString,
                    response_deserializer=resp_t.FromString,
                ),
            )


class SchedulerGrpcStub(_Stub):
    def __init__(self, channel: grpc.Channel):
        super().__init__(channel, "SchedulerGrpc", _SCHEDULER_METHODS)


class ExecutorGrpcStub(_Stub):
    def __init__(self, channel: grpc.Channel):
        super().__init__(channel, "ExecutorGrpc", _EXECUTOR_METHODS)


def _generic_handler(service: str, methods: dict, servicer) -> grpc.GenericRpcHandler:
    handlers = {}
    for name, (req_t, resp_t) in methods.items():
        fn = getattr(servicer, name, None)
        if fn is None:
            continue
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
    return grpc.method_handlers_generic_handler(f"ballista_tpu.{service}", handlers)


def add_scheduler_servicer(server: grpc.Server, servicer) -> None:
    server.add_generic_rpc_handlers(
        (_generic_handler("SchedulerGrpc", _SCHEDULER_METHODS, servicer),)
    )


def add_executor_servicer(server: grpc.Server, servicer) -> None:
    server.add_generic_rpc_handlers(
        (_generic_handler("ExecutorGrpc", _EXECUTOR_METHODS, servicer),)
    )


class KvStoreGrpcStub(_Stub):
    def __init__(self, channel: grpc.Channel):
        super().__init__(channel, "KvStoreGrpc", _KV_METHODS)
        for name, (req_t, resp_t) in _KV_STREAM_METHODS.items():
            setattr(
                self,
                name,
                channel.unary_stream(
                    f"/ballista_tpu.KvStoreGrpc/{name}",
                    request_serializer=req_t.SerializeToString,
                    response_deserializer=resp_t.FromString,
                ),
            )


def add_kvstore_servicer(server: grpc.Server, servicer) -> None:
    handlers = {}
    for name, (req_t, resp_t) in _KV_METHODS.items():
        fn = getattr(servicer, name, None)
        if fn is None:
            continue
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
    for name, (req_t, resp_t) in _KV_STREAM_METHODS.items():
        fn = getattr(servicer, name, None)
        if fn is None:
            continue
        handlers[name] = grpc.unary_stream_rpc_method_handler(
            fn,
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (
            grpc.method_handlers_generic_handler(
                "ballista_tpu.KvStoreGrpc", handlers
            ),
        )
    )


def make_channel(host: str, port: int) -> grpc.Channel:
    return grpc.insecure_channel(f"{host}:{port}", options=GRPC_OPTIONS)


# Process-wide executor-stub pool: every scheduler-side control-plane call
# to an executor (LaunchTask, CancelTasks, StopExecutor) reuses one cached
# channel per host:port instead of paying a fresh gRPC channel handshake
# per fan-out (the pre-existing GrpcLauncher cache, generalized).
_executor_stubs: dict = {}
_executor_stubs_lock = threading.Lock()


def executor_stub(host: str, port: int) -> ExecutorGrpcStub:
    key = f"{host}:{port}"
    with _executor_stubs_lock:
        stub = _executor_stubs.get(key)
        if stub is None:
            stub = ExecutorGrpcStub(make_channel(host, port))
            _executor_stubs[key] = stub
        return stub


def make_server(executor_workers: int = 16) -> grpc.Server:
    from concurrent.futures import ThreadPoolExecutor

    return grpc.server(
        ThreadPoolExecutor(max_workers=executor_workers), options=GRPC_OPTIONS
    )
