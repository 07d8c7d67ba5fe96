"""arrow-ballista-tpu on PyTorch: the engine's device plane for CUDA.

A second package beside ``arrow_ballista_tpu`` (the JAX reference, which
it never imports): the same SQL front end, planner and CPU operators, kept
as its own copies, with eligible partial aggregates running as
hand-written CUDA kernels on an NVIDIA H100 (``ops/cuda/``).  Sessions
run on ``cuda`` unless the caller asks for ``device="cpu"``, locally
(``SessionContext``) or through the port's own scheduler, executors,
shuffle and Flight (``BallistaContext``).
"""

__version__ = "0.1.0"

from .config import BallistaConfig, TaskSchedulingPolicy
from .context import DataFrame, SessionContext
from .client import BallistaContext
from .errors import BallistaError
from .plan.expressions import col, lit

__all__ = [
    "BallistaConfig",
    "TaskSchedulingPolicy",
    "SessionContext",
    "BallistaContext",
    "DataFrame",
    "BallistaError",
    "col",
    "lit",
]
