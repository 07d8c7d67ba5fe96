"""Scheduler-domain value types + proto conversions.

Counterpart of the reference's ``core/src/serde/scheduler/{mod,from_proto,
to_proto}.rs``: the plain-data types shared between scheduler, executor and
client (executor identity, partition identity/locations, shuffle-write
stats), each with bidirectional protobuf conversion.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..proto import pb


@dataclass(frozen=True)
class ExecutorSpecification:
    task_slots: int = 4

    def to_proto(self) -> pb.ExecutorSpecification:
        return pb.ExecutorSpecification(task_slots=self.task_slots)

    @staticmethod
    def from_proto(p: pb.ExecutorSpecification) -> "ExecutorSpecification":
        return ExecutorSpecification(task_slots=p.task_slots or 4)


@dataclass(frozen=True)
class ExecutorMetadata:
    """Where an executor can be reached (Flight data port + gRPC port)."""

    id: str
    host: str
    flight_port: int
    grpc_port: int = 0
    specification: ExecutorSpecification = field(default_factory=ExecutorSpecification)

    def to_proto(self) -> pb.ExecutorMetadata:
        return pb.ExecutorMetadata(
            id=self.id,
            host=self.host,
            flight_port=self.flight_port,
            grpc_port=self.grpc_port,
            specification=self.specification.to_proto(),
        )

    @staticmethod
    def from_proto(p: pb.ExecutorMetadata) -> "ExecutorMetadata":
        return ExecutorMetadata(
            id=p.id,
            host=p.host,
            flight_port=p.flight_port,
            grpc_port=p.grpc_port,
            specification=ExecutorSpecification.from_proto(p.specification),
        )


@dataclass(frozen=True)
class PartitionId:
    """(job, stage, partition) task identity (reference:
    core/src/serde/scheduler/mod.rs PartitionId)."""

    job_id: str
    stage_id: int
    partition_id: int

    def to_proto(self) -> pb.PartitionId:
        return pb.PartitionId(
            job_id=self.job_id,
            stage_id=self.stage_id,
            partition_id=self.partition_id,
        )

    @staticmethod
    def from_proto(p: pb.PartitionId) -> "PartitionId":
        return PartitionId(p.job_id, p.stage_id, p.partition_id)

    def __str__(self) -> str:
        return f"{self.job_id}/{self.stage_id}/{self.partition_id}"


@dataclass(frozen=True)
class PartitionStats:
    num_rows: int = -1
    num_batches: int = -1
    num_bytes: int = -1

    def to_proto(self) -> pb.PartitionStats:
        return pb.PartitionStats(
            num_rows=self.num_rows,
            num_batches=self.num_batches,
            num_bytes=self.num_bytes,
        )

    @staticmethod
    def from_proto(p: pb.PartitionStats) -> "PartitionStats":
        return PartitionStats(p.num_rows, p.num_batches, p.num_bytes)


@dataclass(frozen=True)
class PartitionLocation:
    """A completed map-side shuffle partition an executor can serve.

    ``replica_path`` ("" = single copy) names an external-store copy the
    fetch path fails over to when the serving executor is unreachable;
    the scheduler re-points whole locations at it on executor loss."""

    partition_id: PartitionId
    executor_meta: ExecutorMetadata
    partition_stats: PartitionStats
    path: str
    replica_path: str = ""

    def to_proto(self) -> pb.PartitionLocation:
        return pb.PartitionLocation(
            partition_id=self.partition_id.to_proto(),
            executor_meta=self.executor_meta.to_proto(),
            partition_stats=self.partition_stats.to_proto(),
            path=self.path,
            replica_path=self.replica_path,
        )

    @staticmethod
    def from_proto(p: pb.PartitionLocation) -> "PartitionLocation":
        return PartitionLocation(
            PartitionId.from_proto(p.partition_id),
            ExecutorMetadata.from_proto(p.executor_meta),
            PartitionStats.from_proto(p.partition_stats),
            p.path,
            p.replica_path,
        )


@dataclass(frozen=True)
class ShuffleWritePartition:
    """Stats for one output partition written by a shuffle-write task
    (reference: shuffle_writer.rs ShuffleWritePartition).
    ``replica_path`` carries the external-store copy's path ("" = single
    copy)."""

    partition_id: int
    path: str
    num_batches: int
    num_rows: int
    num_bytes: int
    replica_path: str = ""

    def to_proto(self) -> pb.ShuffleWritePartition:
        return pb.ShuffleWritePartition(
            partition_id=self.partition_id,
            path=self.path,
            num_batches=self.num_batches,
            num_rows=self.num_rows,
            num_bytes=self.num_bytes,
            replica_path=self.replica_path,
        )

    @staticmethod
    def from_proto(p: pb.ShuffleWritePartition) -> "ShuffleWritePartition":
        return ShuffleWritePartition(
            p.partition_id, p.path, p.num_batches, p.num_rows, p.num_bytes,
            p.replica_path,
        )
