"""Plan + domain-type serde (protobuf wire format).

``BallistaCodec`` bundles the logical and physical codecs the way the
reference's ``BallistaCodec`` does (``core/src/serde/mod.rs:124-164``).
"""

from .arrow_utils import (
    dtype_from_bytes,
    dtype_to_bytes,
    schema_from_bytes,
    schema_to_bytes,
)
from .expressions import (
    logical_expr_from_proto,
    logical_expr_to_proto,
    physical_expr_from_proto,
    physical_expr_to_proto,
)
from .logical_plan import logical_plan_from_proto, logical_plan_to_proto
from .physical_plan import (
    partitioning_from_proto,
    partitioning_to_proto,
    physical_plan_from_proto,
    physical_plan_to_proto,
)
from .scheduler_types import (
    ExecutorMetadata,
    ExecutorSpecification,
    PartitionId,
    PartitionLocation,
    PartitionStats,
    ShuffleWritePartition,
)


class BallistaCodec:
    """Logical + physical codec bundle."""

    @staticmethod
    def encode_logical(plan) -> bytes:
        return logical_plan_to_proto(plan).SerializeToString()

    @staticmethod
    def decode_logical(data: bytes):
        from ..proto import pb

        return logical_plan_from_proto(pb.LogicalPlanNode.FromString(data))

    @staticmethod
    def encode_physical(plan) -> bytes:
        return physical_plan_to_proto(plan).SerializeToString()

    @staticmethod
    def decode_physical(data: bytes, work_dir: str = "/tmp/ballista-tpu"):
        from ..proto import pb

        return physical_plan_from_proto(pb.PhysicalPlanNode.FromString(data), work_dir)


__all__ = [
    "BallistaCodec",
    "ExecutorMetadata",
    "ExecutorSpecification",
    "PartitionId",
    "PartitionLocation",
    "PartitionStats",
    "ShuffleWritePartition",
    "dtype_from_bytes",
    "dtype_to_bytes",
    "logical_expr_from_proto",
    "logical_expr_to_proto",
    "logical_plan_from_proto",
    "logical_plan_to_proto",
    "partitioning_from_proto",
    "partitioning_to_proto",
    "physical_expr_from_proto",
    "physical_expr_to_proto",
    "physical_plan_from_proto",
    "physical_plan_to_proto",
    "schema_from_bytes",
    "schema_to_bytes",
]
