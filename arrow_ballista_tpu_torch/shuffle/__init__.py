from .execution_plans import (
    WRITE_STATS_SCHEMA,
    ShuffleReaderExec,
    ShuffleWriterExec,
    UnresolvedShuffleExec,
    partition_indices,
)
from .fetcher import FetchPolicy, ShuffleFetcher, fetch_location

__all__ = [
    "FetchPolicy",
    "ShuffleFetcher",
    "ShuffleReaderExec",
    "ShuffleWriterExec",
    "UnresolvedShuffleExec",
    "WRITE_STATS_SCHEMA",
    "fetch_location",
    "partition_indices",
]
