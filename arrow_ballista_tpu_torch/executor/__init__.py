from .executor import Executor, LoggingMetricsCollector
from .standalone import StandaloneExecutor, new_standalone_executor

__all__ = [
    "Executor",
    "LoggingMetricsCollector",
    "StandaloneExecutor",
    "new_standalone_executor",
]
