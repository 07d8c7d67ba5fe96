"""Table providers and catalog.

Counterpart of DataFusion's ``TableProvider`` + the reference client's table
registry (``client/src/context.rs:212-311``).  Providers expose a schema and
partitioned batch streams; file-backed providers treat each file (or
row-group chunk) as one partition so scans parallelize across tasks.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Iterator, Optional

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq

from .errors import PlanError


class TableProvider:
    """A registered table: schema + partitioned scan."""

    @property
    def schema(self) -> pa.Schema:
        raise NotImplementedError

    def num_partitions(self) -> int:
        raise NotImplementedError

    def scan_partition(
        self, partition: int, projection: Optional[list[str]], batch_size: int = 8192
    ) -> Iterator[pa.RecordBatch]:
        raise NotImplementedError

    def describe(self) -> dict:
        """Serializable description for plan serde; see serde/plans.py."""
        raise NotImplementedError


def _expand_path(path: str, suffix: str) -> list[str]:
    if os.path.isdir(path):
        files = sorted(
            _glob.glob(os.path.join(path, f"**/*{suffix}"), recursive=True)
        )
        if not files:
            files = sorted(_glob.glob(os.path.join(path, "**/*"), recursive=True))
            files = [f for f in files if os.path.isfile(f)]
    else:
        files = sorted(_glob.glob(path)) if any(c in path for c in "*?[") else [path]
    if not files:
        raise PlanError(f"no files found at {path!r}")
    return files


class ParquetTable(TableProvider):
    def __init__(self, path: str, schema: Optional[pa.Schema] = None):
        self.path = path
        self.files = _expand_path(path, ".parquet")
        self._schema = schema or pq.read_schema(self.files[0])

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return len(self.files)

    def scan_partition(
        self, partition: int, projection: Optional[list[str]], batch_size: int = 8192
    ) -> Iterator[pa.RecordBatch]:
        f = pq.ParquetFile(self.files[partition])
        yield from f.iter_batches(batch_size=batch_size, columns=projection)

    def describe(self) -> dict:
        return {"kind": "parquet", "path": self.path}


class AvroTable(TableProvider):
    """Avro object-container files (reference: register_avro / read_avro,
    client/src/context.rs:212-311); decoded by the built-in pure-python
    reader (avro.py) — no external avro library required."""

    def __init__(self, path: str):
        from .avro import AvroFile

        self.path = path
        self.files = _expand_path(path, ".avro")
        self._readers = [AvroFile(f) for f in self.files]
        self._schema = self._readers[0].schema

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return len(self.files)

    def scan_partition(
        self, partition: int, projection: Optional[list[str]], batch_size: int = 8192
    ) -> Iterator[pa.RecordBatch]:
        yield from self._readers[partition].read_batches(projection, batch_size)

    def describe(self) -> dict:
        return {"kind": "avro", "path": self.path}


class CsvTable(TableProvider):
    def __init__(
        self,
        path: str,
        schema: Optional[pa.Schema] = None,
        has_header: bool = True,
        delimiter: str = ",",
    ):
        self.path = path
        self.has_header = has_header
        self.delimiter = delimiter
        self.files = _expand_path(path, ".csv")
        if schema is not None:
            self._schema = schema
        else:
            ropts = pacsv.ReadOptions(
                autogenerate_column_names=not has_header, block_size=1 << 20
            )
            popts = pacsv.ParseOptions(delimiter=delimiter)
            with pacsv.open_csv(self.files[0], read_options=ropts, parse_options=popts) as r:
                self._schema = r.schema

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return len(self.files)

    def scan_partition(
        self, partition: int, projection: Optional[list[str]], batch_size: int = 8192
    ) -> Iterator[pa.RecordBatch]:
        names = self._schema.names
        ropts = pacsv.ReadOptions(
            column_names=names if not self.has_header else None,
            block_size=max(batch_size * 128, 1 << 20),
        )
        popts = pacsv.ParseOptions(delimiter=self.delimiter)
        copts = pacsv.ConvertOptions(
            column_types={f.name: f.type for f in self._schema},
            include_columns=projection,
        )
        with pacsv.open_csv(
            self.files[partition], read_options=ropts, parse_options=popts,
            convert_options=copts,
        ) as reader:
            for batch in reader:
                yield batch

    def describe(self) -> dict:
        return {
            "kind": "csv",
            "path": self.path,
            "has_header": self.has_header,
            "delimiter": self.delimiter,
            "schema": self._schema.serialize().to_pybytes().hex(),
        }


class MemoryTable(TableProvider):
    def __init__(self, partitions: list[list[pa.RecordBatch]], schema: Optional[pa.Schema] = None):
        if schema is None:
            if not partitions or not partitions[0]:
                raise PlanError("MemoryTable needs a schema or at least one batch")
            schema = partitions[0][0].schema
        self._schema = schema
        self.partitions = partitions

    @classmethod
    def from_table(cls, table: pa.Table, partitions: int = 1) -> "MemoryTable":
        n = max(1, partitions)
        rows = table.num_rows
        per = (rows + n - 1) // n if rows else 0
        parts: list[list[pa.RecordBatch]] = []
        for i in range(n):
            chunk = table.slice(i * per, per) if rows else table
            parts.append(chunk.combine_chunks().to_batches())
        return cls(parts, table.schema)

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return max(1, len(self.partitions))

    def scan_partition(
        self, partition: int, projection: Optional[list[str]], batch_size: int = 8192
    ) -> Iterator[pa.RecordBatch]:
        batches = self.partitions[partition] if partition < len(self.partitions) else []
        for b in batches:
            if projection is not None:
                b = b.select(projection)
            yield b

    def describe(self) -> dict:
        # Memory tables are serialized inline (small tables only: Values, test fixtures)
        sink = pa.BufferOutputStream()
        part_batches = []  # batches per partition, to rebuild partitioning
        with pa.ipc.new_stream(sink, self._schema) as w:
            for part in self.partitions:
                part_batches.append(len(part))
                for b in part:
                    w.write_batch(b)
        return {
            "kind": "memory",
            "partition_batches": part_batches,
            "data": sink.getvalue().to_pybytes().hex(),
        }


def provider_from_description(d: dict) -> TableProvider:
    kind = d["kind"]
    if kind == "parquet":
        return ParquetTable(d["path"])
    if kind == "avro":
        return AvroTable(d["path"])
    if kind == "csv":
        schema = None
        if "schema" in d:
            schema = pa.ipc.read_schema(pa.py_buffer(bytes.fromhex(d["schema"])))
        return CsvTable(d["path"], schema, d.get("has_header", True), d.get("delimiter", ","))
    if kind == "memory":
        buf = pa.py_buffer(bytes.fromhex(d["data"]))
        with pa.ipc.open_stream(buf) as r:
            batches = [b for b in r]
            schema = r.schema
        counts = d.get("partition_batches")
        if counts:
            parts: list[list[pa.RecordBatch]] = []
            i = 0
            for c in counts:
                parts.append(batches[i : i + c])
                i += c
        else:
            parts = [batches] if batches else [[]]
        return MemoryTable(parts, schema)
    raise PlanError(f"unknown provider kind {kind!r}")


class Catalog:
    """Named table registry (one per session)."""

    def __init__(self) -> None:
        self.tables: dict[str, TableProvider] = {}

    def register(self, name: str, provider: TableProvider) -> None:
        self.tables[name.lower()] = provider

    def deregister(self, name: str) -> None:
        self.tables.pop(name.lower(), None)

    def get(self, name: str) -> TableProvider:
        p = self.tables.get(name.lower())
        if p is None:
            raise PlanError(f"table {name!r} not found; registered: {sorted(self.tables)}")
        return p

    def names(self) -> list[str]:
        return sorted(self.tables)
